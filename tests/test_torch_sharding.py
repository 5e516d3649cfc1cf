"""The port's sharding rules (`repro_torch.distributed.sharding`) against
the reference's, and the mesh and hint helpers, in one process on the CPU.

Specs are compared entry for entry with the reference's `PartitionSpec`
for every param leaf of all ten configs (abstract: nothing is allocated)
under each plan, and for every decode-state leaf, on the production
shapes (16, 16) and (2, 16, 16) and the tests' (2, 2, 2). The reference
takes a `jax.sharding.AbstractMesh`, the port a plain {axis: size}
mapping (its rules read only axis names and sizes)."""
import functools
import os
import pathlib
import subprocess
import sys
import types

import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.distributed import act_sharding as t_act  # noqa: E402
from repro_torch.distributed import sharding as t_sh  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
PLANS = ("fsdp_tp", "tp", "dp")


def _abstract_mesh(sizes: dict) -> AbstractMesh:
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _axes_flat(tree, prefix=""):
    # axes leaves are tuples, not nodes
    return flat(tree, prefix)


@functools.lru_cache(maxsize=None)
def _abstract(arch: str):
    jp, ja = j_build(j_config(arch)).abstract_params_and_axes()
    tp, ta = t_build(t_config(arch)).abstract_params_and_axes()
    return jp, ja, tp, ta


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, plan, mesh):
    jp, ja, tp, ta = _abstract(arch)
    sizes = MESHES[mesh]
    want = flat(j_sh.param_shardings(jp, ja, _abstract_mesh(sizes), plan))
    got = flat(t_sh.param_shardings(tp, ta, sizes, plan))
    assert sorted(got) == sorted(want)
    for path, s in got.items():
        assert s.spec == tuple(want[path].spec), (path, s.spec,
                                                   want[path].spec)
    # every sharded dim divides its mesh extent
    rules = t_sh.make_rules(plan, sizes)
    shapes, axes = flat(tp), _axes_flat(ta)
    for path, s in got.items():
        assert s.spec == t_sh.spec_for(shapes[path].shape, axes[path],
                                       rules, sizes)
        for dim, entry in zip(shapes[path].shape, s.spec):
            names = (entry,) if isinstance(entry, str) else entry or ()
            ext = 1
            for a in names:
                ext *= sizes[a]
            assert dim % ext == 0, (path, dim, entry)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_specs_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    j_specs = j_build(j_config(arch)).init_decode_state_specs(16, 32768)
    t_specs = t_build(t_config(arch)).init_decode_state_specs(16, 32768)
    jf, tf = flat(j_specs), flat(t_specs)
    assert sorted(jf) == sorted(tf)
    for path, leaf in tf.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(jf[path].shape), path
        assert str(leaf.dtype).removeprefix("torch.") == str(
            jf[path].dtype), path
    for thr in (8192, 512):
        want = flat(j_sh.decode_state_shardings(
            j_specs, _abstract_mesh(sizes), 16, seq_shard_threshold=thr))
        got = flat(t_sh.decode_state_shardings(t_specs, sizes, 16,
                                               seq_shard_threshold=thr))
        assert sorted(got) == sorted(want)
        for path, s in got.items():
            assert s.spec == tuple(want[path].spec), (path, thr)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_data_axes_match_reference(mesh):
    sizes = MESHES[mesh]
    am = _abstract_mesh(sizes)
    assert t_sh.data_axes(sizes) == j_sh.data_axes(am)
    for plan in PLANS:
        assert t_sh.batch_axes_for_plan(sizes, plan) == \
            j_sh.batch_axes_for_plan(am, plan)
        axes = j_sh.batch_axes_for_plan(am, plan)
        for batch in (1, 2, 4, 8, 16, 256, 512, 6):
            for ndim in (1, 2, 3):
                got = t_sh.batch_sharding(sizes, ndim, batch_size=batch,
                                          axes=axes)
                want = j_sh.batch_sharding(am, ndim, batch_size=batch,
                                           axes=axes)
                assert got.spec == tuple(want.spec), (plan, batch, ndim)


def test_to_placements_shards_in_mesh_dim_order():
    sizes = MESHES["2x2x2"]
    assert t_sh.to_placements((("pod", "data"), None, "model"), sizes) == (
        Shard(0), Shard(0), Shard(2))
    assert t_sh.to_placements((None, None), sizes) == (Replicate(),) * 3
    assert t_sh.to_placements(("data",), sizes) == (
        Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh-dim order"):
        t_sh.to_placements((("data", "pod"),), sizes)


def test_make_rules_rejects_unknown_plan():
    with pytest.raises(ValueError):
        t_sh.make_rules("zero", MESHES["16x16"])


def test_helpers_without_hints_return_their_input():
    x = torch.randn(2, 3, 4)
    tree = {"a": {"w": torch.randn(4, 4)}, "b": torch.randn(3)}
    axes = {"a": {"w": ("embed", "mlp")}, "b": ("embed",)}
    assert t_act.current() is None
    assert t_act.constrain(x, "dp", None, "tp") is x
    assert t_act.gather_weight(tree["b"], ("embed",)) is tree["b"]
    assert t_act.gather_params(tree, axes) is tree
    # with hints, a plain tensor still passes through
    hints = t_act.Hints(MESHES["2x2x2"], ("pod", "data"), "model")
    with t_act.use_hints(hints):
        assert t_act.current() is hints
        assert t_act.constrain(x, "dp", None, "tp") is x
        g = t_act.gather_params(tree, axes)
        assert g["a"]["w"] is tree["a"]["w"] and g["b"] is tree["b"]
    assert t_act.current() is None
    assert (hints.dp, hints.tp) == (("pod", "data"), "model")
    assert hints.axis_size("dp") == 4 and hints.axis_size("tp") == 2


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recomputes_under_the_forward_layout_and_hints(policy):
    """A remat region's recomputation sees the layout ops and hints of its
    forward pass even when the backward pass runs outside them, as it does
    on the card (the CUDA autograd engine runs it on its own thread)."""
    from repro_torch.models import common, transformer
    ops = common.LayoutOps(whole_dim=lambda x, dim: x)
    hints = t_act.Hints(MESHES["2x2x2"], ("pod", "data"), "model")
    seen = []

    def f(x):
        seen.append((common.layout() is ops, t_act.current() is hints))
        return torch.sin(x @ x).sum()

    g = transformer._remat(f, types.SimpleNamespace(remat_policy=policy))
    x = torch.randn(3, 3, requires_grad=True)
    with common.use_layout(ops), t_act.use_hints(hints):
        y = g(x)
    assert common.layout() is common.PLAIN_OPS and t_act.current() is None
    y.backward()
    assert seen == [(True, True), (True, True)]  # forward, recomputation


_MESH_SCRIPT = r"""
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh as M

def world(n):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

world(512)
m = M.make_production_mesh(multi_pod=True)
assert m.mesh_dim_names == ("pod", "data", "model"), m
assert tuple(m.shape) == (2, 16, 16) and m.device_type == "cpu", m
world(256)
m = M.make_production_mesh()
assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (16, 16)
m = M.make_host_mesh(4)
assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (64, 4)
world(8)
for multi in (False, True):
    try:
        M.make_production_mesh(multi_pod=multi)
    except RuntimeError as e:
        assert "needs" in str(e) and "found 8" in str(e), e
    else:
        raise AssertionError("a world of 8 made a production mesh")
try:
    M.make_host_mesh(3)
except ValueError:
    pass
else:
    raise AssertionError("3 does not divide 8")
dist.destroy_process_group()
try:
    M.make_host_mesh(1)
except RuntimeError:
    pass
else:
    raise AssertionError("a host mesh without a process group")
assert M.backend_for("cuda") == "nccl" and M.backend_for("cpu") == "gloo"
print("MESH_OK")
"""


def test_production_mesh_under_a_fake_process_group():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _MESH_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MESH_OK" in out.stdout
