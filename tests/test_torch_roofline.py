"""The port's roofline (`repro_torch.launch.roofline`) held to the
reference's: the HLO collective parser rerun on the port's copy, `analyze`
and `model_flops_for` for every arch x shape, and the torch counterpart
(`RankCounter`) on known products and redistributions, counted on one
rank of a fake process group (in a subprocess: it joins a group)."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.launch import roofline as j_roof  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.launch import roofline as t_roof  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_roofline_collective_parser():
    hlo = '''
  %ar = f32[1024,512]{1,0} all-reduce(f32[1024,512]{1,0} %x), replica_groups={}
  %ag = bf16[8,128]{1,0} all-gather(bf16[4,128]{1,0} %y), dimensions={0}
  %rs = f32[256]{0} reduce-scatter(f32[2048]{0} %z), dimensions={0}
  %cp = (f32[64]{0}, f32[64]{0}) collective-permute(f32[64]{0} %w), source_target_pairs={{0,1}}
  %other = f32[10]{0} add(f32[10]{0} %a, f32[10]{0} %b)
'''
    out = t_roof.collective_bytes(hlo)
    assert out["all-reduce_bytes"] == 1024 * 512 * 4 * 2  # ring 2x
    assert out["all-gather_bytes"] == 8 * 128 * 2
    assert out["reduce-scatter_bytes"] == 256 * 4
    assert out["collective-permute_bytes"] == 64 * 4 * 2  # tuple result
    assert out["total_bytes"] > 0
    assert out == j_roof.collective_bytes(hlo)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_analyze_match_reference(arch):
    cost = {"flops": 3.1e14, "bytes accessed": 2.2e12}
    coll = {"total_bytes": 4.4e10}
    for shape in SHAPES.values():
        mf = t_roof.model_flops_for(t_config(arch), shape)
        assert mf == j_roof.model_flops_for(j_config(arch), shape)
        got = t_roof.analyze(cost, coll, 256, model_flops=mf)
        want = j_roof.analyze(cost, coll, 256, model_flops=mf)
        for k in ("compute_s", "memory_s", "collective_s", "flops_per_chip",
                  "bytes_per_chip", "coll_bytes_per_chip", "model_flops",
                  "chips", "dominant", "step_time_s",
                  "useful_flops_fraction", "roofline_fraction"):
            assert getattr(got, k) == getattr(want, k), (arch, k)


def test_analyze_takes_the_h100_rates():
    terms = t_roof.analyze({"flops": 989e12, "bytes accessed": 6.7e12},
                           {"total_bytes": 450e9}, 8, model_flops=989e12 * 8,
                           **t_roof.H100)
    assert (terms.compute_s, terms.memory_s, terms.collective_s) == (
        1.0, 2.0, 1.0)
    assert terms.dominant == "memory" and terms.step_time_s == 2.0
    assert terms.roofline_fraction == 0.5
    assert t_roof.PEAK_FLOPS == j_roof.PEAK_FLOPS == 197e12


_COUNTS = textwrap.dedent(r"""
    import json, sys
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import RankCounter
    dryrun.join_fake_group(256)
    out = {}
    mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                      mesh_dim_names=("data", "model"))
    x = DTensor.from_local(torch.empty(256, 1024, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(1024, 256, device="meta"), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    out["global_shape"] = list((x @ w).shape)
    flops = []
    for _ in range(2):
        with RankCounter() as c:
            torch.mm(x, w)
        flops.append(c.flops)
    out["mm_flops"] = flops
    line = DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("x",))

    def count(t, place):
        with RankCounter() as c:
            t.redistribute(line, place)
        return c.collectives()

    a = DTensor.from_local(torch.empty(1, 128, dtype=torch.bfloat16,
                                       device="meta"), line, [Shard(0)],
                           run_check=False)
    out["gather"] = count(a, [Replicate()])
    p = DTensor.from_local(torch.empty(1024, 512, device="meta"), line,
                           [Partial()], run_check=False)
    out["reduce"] = count(p, [Replicate()])
    out["scatter"] = count(p, [Shard(0)])
    # plain local work: a [4, 8] @ [8, 3] product and a view of it; then
    # the factory of a [4, 8] tensor, which writes its output
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    with RankCounter() as c:
        torch.mm(a, b).view(12)
    with RankCounter() as f:
        torch.ones(4, 8)
    out["plain"] = [c.flops, c.bytes, f.flops, f.bytes]
    print("COUNTS", json.dumps(out))
""")


@pytest.fixture(scope="module")
def counts():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _COUNTS], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("COUNTS ", 1)[1])


def test_per_rank_flops_of_a_sharded_product(counts):
    """x [4096, 1024] (Shard(0), Replicate) @ w [1024, 4096] (Replicate,
    Shard(1)) on a (16, 16) fake mesh: each rank multiplies [256, 1024] by
    [1024, 256], 2 * 256 * 1024 * 256 FLOPs (the global product is 256
    times that), the same on a second call, whose sharding propagation
    DTensor takes from its cache."""
    assert counts["global_shape"] == [4096, 4096]
    assert counts["mm_flops"] == [134_217_728, 134_217_728]


def test_counter_counts_collective_result_bytes(counts):
    g, r, s = counts["gather"], counts["reduce"], counts["scatter"]
    # Shard(0) -> Replicate of a bf16 [8, 128]: one all-gather of the whole
    assert g["all-gather_bytes"] == 8 * 128 * 2 and g["all-gather_count"] == 1
    assert g["total_bytes"] == 8 * 128 * 2
    # Partial -> Replicate: an all-reduce, ring factor 2
    assert r["all-reduce_bytes"] == 1024 * 512 * 4 * 2
    # Partial -> Shard(0): a reduce-scatter to this rank's [128, 512]
    assert s["reduce-scatter_bytes"] == 128 * 512 * 4
    assert sorted(k for k in g if k.endswith("_bytes")) == sorted(
        f"{k}_bytes" for k in t_roof._COLLECTIVE_FACTORS) + ["total_bytes"]


def test_counter_counts_plain_products_and_unfused_bytes(counts):
    flops, nbytes, f_flops, f_bytes = counts["plain"]
    assert flops == 2 * 4 * 8 * 3
    # the mm reads 32 + 24 floats and writes 12; the view moves nothing
    assert nbytes == (32 + 24 + 12) * 4
    assert (f_flops, f_bytes) == (0, 32 * 4)
