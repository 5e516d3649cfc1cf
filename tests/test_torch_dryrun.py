"""The port's dry run (`repro_torch.launch.dryrun`) held to the
reference's: `input_specs` for every arch x shape; the fits check
(`state_bytes_per_device`) and the param counts of every supported (arch,
shape, mesh) cell at full size against the reference's
`build_lowerable(...)[4]` (the reference in one subprocess with 512 forced
host devices, building shardings only; the port in another, on a fake
process group of 512 ranks); per-rank FLOPs of a dense train step on a
(2, 2, 2) fake mesh against the same step without a mesh, under the
step's own hints and with the activations pinned; `run_cell` on
one cell per block kind on both production meshes at smoke size;
`calibrate_cell` against the direct count; and the CLI on one cell. Every
run that joins a process group runs in a subprocess."""
import functools
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
from repro.models import input_specs as j_input_specs  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.models import input_specs as t_input_specs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **extra)
    return env


def _run(code: str, tag: str, timeout: float = 240, **env):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=_env(**env), capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return json.loads(out.stdout.split(tag + " ", 1)[1].splitlines()[0])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    for shape in SHAPES.values():
        want = _flat(j_input_specs(j_config(arch), shape))
        got = _flat(t_input_specs(t_config(arch), shape))
        assert got == want, (arch, shape.name)
        assert all(str(t.device) == "meta" for t in _leaves(
            t_input_specs(t_config(arch), shape)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


_CELLS = """
    from {pkg}.configs import ARCH_IDS, SHAPES, get_config
    out = {{}}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for arch in ARCH_IDS:
            for shape in SHAPES:
                if get_config(arch).supports_shape(SHAPES[shape])[0]:
                    meta = d.build_lowerable(arch, shape, mesh)[4]
                    out[f"{{arch}}|{{shape}}|{{mp}}"] = {{
                        k: meta[k] for k in ("state_bytes_per_device",
                                             "param_count",
                                             "param_count_active")}}
    print("META", json.dumps(out))
"""
_REF_META = """
    import json
    from repro.launch import dryrun as d  # sets the forced device count
    from repro.launch.mesh import make_production_mesh
""" + _CELLS.format(pkg="repro")
_PORT_META = """
    import json
    from repro_torch.launch import dryrun as d
    from repro_torch.launch.mesh import make_production_mesh
    d.join_fake_group()
""" + _CELLS.format(pkg="repro_torch")


def test_fits_check_matches_reference_at_full_size():
    procs = {}
    for tag, code, extra in (("ref", _REF_META, {"JAX_PLATFORMS": "cpu"}),
                             ("port", _PORT_META, {})):
        procs[tag] = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)], env=_env(**extra),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = {}
    for tag, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        assert proc.returncode == 0, stderr[-3000:]
        outs[tag] = json.loads(stdout.split("META ", 1)[1].splitlines()[0])
    ref, port = outs["ref"], outs["port"]
    # 10 archs x 4 shapes, less the full-attention long_500k cells, x 2
    assert len(ref) == 2 * sum(
        get_ok for get_ok in (j_config(a).supports_shape(s)[0]
                              for a in ARCH_IDS for s in SHAPES.values()))
    assert port == ref


_FLOPS = """
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.act_sharding import Hints, use_hints
    from repro_torch.launch import dryrun as d
    from repro_torch.launch.roofline import RankCounter
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import (make_train_step,
                                              train_state_shardings)
    d.join_fake_group(8)
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    cfg = get_smoke_config("glm4-9b").replace(sharding_plan="fsdp_tp",
                                              remat_policy="none")
    model = build_model(cfg)
    opt = d.make_opt(cfg)
    meta = lambda shp: torch.empty(shp, dtype=torch.int32, device="meta")
    batch = {"tokens": meta((8, 16)), "targets": meta((8, 16))}
    shard, params, opt_state = train_state_shardings(model, opt, mesh)
    state = {"params": params, "opt": opt_state, "step": meta(())}
    with RankCounter() as plain:
        make_train_step(model, opt)(state, batch)
    out = [plain.flops]
    pinned = Hints(mesh, ("pod", "data"), "model", zero3_gather=True,
                   constrain_activations=True)
    for hints in (None, pinned):
        placed = sh.distribute(state, shard)
        with use_hints(hints), RankCounter() as rank:
            make_train_step(model, opt, mesh=mesh)(placed, batch)
        out += [rank.flops, rank.collectives()["total_bytes"]]
    print("FLOPS", json.dumps(out))
"""


@functools.lru_cache(maxsize=1)
def _flops():
    return tuple(_run(_FLOPS, "FLOPS"))


def test_per_rank_flops_split_a_dense_train_step():
    """glm4-9b smoke (fsdp_tp: 2 kv heads, every sharded dim divides 2) on
    the (2, 2, 2) mesh, batch 8 x 16, counted from each rank's local calls
    against the same step without a mesh, under the step's own hints (the
    activations left to propagation). The split is exact: every product
    with a weight runs on this rank's shard of it (`LayoutOps.project_in`
    and `project_out`; k and v on the rank's own kv heads) and on its
    batch shard, and every attention body on its heads, so the eight
    ranks together do the unsharded step's FLOPs, each an eighth."""
    plain, rank, coll = _flops()[:3]
    assert coll > 0
    assert (plain, rank) == (283_115_520, 35_389_440)
    assert 8 * rank == plain


def test_per_rank_flops_split_the_same_with_pinned_activations():
    """The same step with the activations pinned at the blocks' boundaries
    (`Hints(constrain_activations=True)`): the pins move collectives, not
    work, so each rank counts the same FLOPs."""
    plain, rank, _, pinned, coll = _flops()
    assert coll > 0
    assert pinned == rank and 8 * pinned == plain


# one cell per block kind: attention (glm4), MLA + MoE (deepseek-v3),
# expert-parallel MoE (dbrx, 16 experts: the reference asserts E % 16 == 0
# on the 16-way model axis, and the smoke config has 4), RG-LRU
# (recurrentgemma), xLSTM, cross attention (the VLM), encoder-decoder
# (whisper)
SMOKE_CELLS = (("glm4-9b", "train_4k", "none"),
               ("deepseek-v3-671b", "train_4k", "none"),
               ("dbrx-132b", "train_4k", "act,epmoe"),
               ("recurrentgemma-2b", "prefill_32k", "none"),
               ("xlstm-350m", "long_500k", "none"),
               ("llama-3.2-vision-90b", "train_4k", "none"),
               ("whisper-tiny", "decode_32k", "none"))

_CELL = """
    import dataclasses, json
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun as d
    d.join_fake_group()
    cfg = get_smoke_config({arch!r})
    if cfg.moe is not None and "epmoe" in {opt!r}:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=16))
    recs = [d.run_cell({arch!r}, {shape!r}, mp, save=False, opt={opt!r},
                       cfg_override=cfg) for mp in (False, True)]
    for r in recs:
        r.pop("traceback", None)
    print("CELLS", json.dumps(recs))
"""


@pytest.mark.parametrize("arch,shape,opt", SMOKE_CELLS,
                         ids=[c[0] for c in SMOKE_CELLS])
def test_run_cell_at_smoke_size_on_both_meshes(arch, shape, opt):
    recs = _run(_CELL.format(arch=arch, shape=shape, opt=opt), "CELLS",
                timeout=280)
    assert [r["mesh"] for r in recs] == ["single_pod_16x16",
                                         "multi_pod_2x16x16"]
    for r in recs:
        assert r["status"] == "ok", r
        assert r["chips"] == (256 if r["mesh"].startswith("single") else 512)
        assert r["cost_analysis"]["flops"] > 0
        assert r["cost_analysis"]["unfused_bytes"] > 0
        assert r["rates"]["peak_flops"] == 989e12
        assert r["roofline"]["step_time_bound_s"] > 0
        assert r["memory_analysis"]["argument_bytes"] >= \
            r["state_bytes_per_device"] > 0
        assert "error" in r["memory_analysis"]["peak_bytes"]
    # the multi-pod mesh halves the data shards' batch: fewer FLOPs a rank
    # (the same where the batch, 1 at long_500k, is not sharded)
    single, multi = (r["cost_analysis"]["flops"] for r in recs)
    assert multi < single or (multi == single and shape == "long_500k")


_CAL = """
    import json
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun as d
    d.join_fake_group()
    cfg = get_smoke_config("glm4-9b").replace(scan_layers=True)
    cal = d.calibrate_cell("glm4-9b", "train_4k", cfg_override=cfg)
    direct = d.run_cell("glm4-9b", "train_4k", False, save=False,
                        cfg_override=cfg)
    unrolled = d.run_cell("glm4-9b", "train_4k", False, save=False,
                          cfg_override=cfg.replace(scan_layers=False))
    print("CAL", json.dumps([cal, direct, unrolled], default=str))
"""


def test_calibrate_cell_reproduces_the_direct_count():
    cal, direct, unrolled = _run(_CAL, "CAL")
    assert cal["g_full"] == 2.0  # glm4-9b smoke: 2 layers
    assert cal["flops_per_chip"] == direct["cost_analysis"]["flops"] == \
        unrolled["cost_analysis"]["flops"]
    assert cal["samples"]["1"]["flops"] < cal["samples"]["2"]["flops"]
    assert cal["bytes_per_chip"] == unrolled["cost_analysis"][
        "unfused_bytes"]
    assert cal["collective_bytes_per_chip"] == unrolled["collectives"][
        "total_bytes"]
    assert cal["roofline"]["compute_s"] == unrolled["roofline"]["compute_s"]


def test_cli_runs_one_cell(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "long_500k", "--mesh", "single"],
        env=_env(REPRO_TORCH_DRYRUN_DIR=str(tmp_path)), capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "done: ok=1 skip=0 err=0" in out.stdout
    rec = json.loads((tmp_path / "xlstm-350m__long_500k__single_pod_16x16"
                      ".json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256


def test_importing_the_dry_run_joins_no_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun\n"
            "assert not dist.is_initialized()\nprint('NO_GROUP [1]')\n")
    assert _run(code, "NO_GROUP") == [1]
