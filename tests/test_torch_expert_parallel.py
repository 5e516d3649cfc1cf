"""Expert-parallel MoE of the port held to the JAX package: the reference's
TestExpertParallelMoE case (tests/test_distributed.py) on 8 gloo ranks.

One module fixture saves the reference's MoE params (dbrx-132b smoke at
float32, E = 4, top_k = 2, cf = 8.0, from the JAX init) and tokens x [4,
16, d] from a numpy seed, computes the JAX dense oracle
(`moe_forward(impl="dense_mask")`) and `jax.grad` of sum(y^2) + aux with
it, then starts 8 worker processes (tests/_torch_ep_worker.py; a
`file://` rendezvous under tmp_path) on the (2, 2, 2) ("pod", "data",
"model") mesh. The workers run the port's `moe_forward` under
`Hints(moe_impl="expert_parallel")` with plain tensors (the smoke plan,
"tp") and with DTensors of the "fsdp_tp" plan, whose expert weights the
body all-gathers over the data axes (a path the reference's own case, at
the smoke plan, never reaches). At cf = 8 no token drops, so expert
parallelism equals the dense oracle: the output within 2e-4 (the
reference's bound), the gradients within 1e-4 * max|ref| + 1e-4 * |ref|.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.distributed import expert_parallel as j_ep  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.common import ParamBuilder as JParamBuilder  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.distributed import expert_parallel as t_ep  # noqa: E402
from repro_torch.distributed.act_sharding import Hints  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_ep_worker.py"
WORLD = 8
PLANS = ("tp", "fsdp_tp")


def _cfg(get):
    cfg = get("dbrx-132b").replace(activation_dtype="float32")
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, num_experts=4, top_k=2, capacity_factor=8.0))


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return env


def _close(got, ref, what):
    """|got - ref| <= 1e-4 * max|ref| + 1e-4 * |ref|, elementwise."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref)
    tol = 1e-4 * np.abs(ref).max() + 1e-4 * np.abs(ref)
    assert (err <= tol).all(), f"{what}: max err {err.max()}"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's oracle and gradients, then the 8 ranks' results."""
    work = tmp_path_factory.mktemp("ep")
    cfg = _cfg(j_smoke)
    b = JParamBuilder(jax.random.PRNGKey(0), "float32")
    j_moe.init_moe(b, cfg)
    p = {k: np.asarray(v) for k, v in b.params["moe"].items()}
    x = (np.random.RandomState(1).randn(4, 16, cfg.d_model) * 0.5).astype(
        np.float32)
    # tokens that share a direction pick the same experts and overflow
    # their capacity at cf 1.25
    rng = np.random.RandomState(3)
    x_drop = (rng.randn(1, 1, cfg.d_model) * 2
              + rng.randn(4, 16, cfg.d_model) * 0.1).astype(np.float32)
    np.savez(work / "inputs.npz", x=x, x_drop=x_drop,
             **{f"p_{k}": v for k, v in p.items()})
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y, aux = j_moe.moe_forward(jp, cfg, jnp.asarray(x), impl="dense_mask")

    def loss(p_, x_):
        y_, aux_ = j_moe.moe_forward(p_, cfg, x_, impl="dense_mask")
        return jnp.sum(y_ ** 2) + aux_

    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    drop = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    y_drop, aux_drop = j_moe.moe_forward(jp, drop, jnp.asarray(x_drop),
                                         impl="scatter")
    y_drop_dense, _ = j_moe.moe_forward(jp, drop, jnp.asarray(x_drop),
                                        impl="dense_mask")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD),
         str(work / "rendezvous"), str(work)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=240)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    codes = [proc.returncode for proc in procs]
    assert codes == [0] * WORLD, "\n".join(
        f"rank {r} rc {c}:\n{log[-3000:]}" for r, (c, log)
        in enumerate(zip(codes, logs)) if c)
    return {"y": np.asarray(y), "aux": float(aux), "grad_x": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gp.items()},
            "params": p, "x": x, "y_drop": np.asarray(y_drop),
            "aux_drop": float(aux_drop),
            "y_drop_dense": np.asarray(y_drop_dense),
            "port": dict(np.load(work / "results.npz"))}


@pytest.mark.parametrize("plan", PLANS)
def test_expert_parallel_matches_dense_oracle(run, plan):
    port = run["port"]
    err = float(np.abs(port[f"{plan}_y"] - run["y"]).max())
    assert err < 2e-4, err
    np.testing.assert_allclose(float(port[f"{plan}_aux"]), run["aux"],
                               rtol=1e-5)


@pytest.mark.parametrize("plan", PLANS)
def test_expert_parallel_gradients_match_jax(run, plan):
    port = run["port"]
    _close(port[f"{plan}_grad_x"], run["grad_x"], f"{plan} grad x")
    assert sorted(run["grads"]) == ["router", "wg", "wi", "wo"]
    for k, want in run["grads"].items():
        _close(port[f"{plan}_grad_{k}"], want, f"{plan} grad {k}")


def test_fsdp_tp_shards_the_expert_weights_over_the_data_axes(run):
    # wi [E, d, f]: experts on "model", the embed dim over ("pod", "data"),
    # which the body gathers (the reference's all_gather at
    # expert_parallel.py:110-113)
    assert str(run["port"]["fsdp_wi_spec"]) == "('model', ('pod', 'data'), None)"


def test_scatter_on_the_mesh_keeps_the_global_capacity(run):
    """The scatter path's mesh form (each rank's tokens and experts, its
    capacity positions offset by the earlier token blocks' counts) drops
    exactly the tokens the reference's global scatter drops."""
    port = run["port"]
    want, dense = run["y_drop"], run["y_drop_dense"]
    # tokens do drop here: scatter departs from the dense oracle
    assert np.abs(want - dense).max() > 1e-2 * np.abs(dense).max()
    _close(port["scatter_mesh_y"], want, "scatter on the mesh")
    np.testing.assert_allclose(float(port["scatter_mesh_aux"]),
                               run["aux_drop"], rtol=1e-5)
    assert str(port["scatter_mesh_wi"]) == "('model', None, None)"


@pytest.mark.parametrize("shard_id", [0, 1])
def test_local_dispatch_ffn_matches_reference(shard_id):
    cfg = _cfg(j_smoke)
    rng = np.random.RandomState(2 + shard_id)
    T, d, k, E_loc, C_loc = 24, cfg.d_model, 2, 2, 9
    ff = cfg.moe.d_ff_expert
    xf = rng.randn(T, d).astype(np.float32)
    weights = rng.rand(T, k).astype(np.float32)
    idx = np.stack([rng.permutation(4)[:k] for _ in range(T)]).astype(
        np.int32)
    wi, wg = (rng.randn(E_loc, d, ff).astype(np.float32) / 8
              for _ in range(2))
    wo = rng.randn(E_loc, ff, d).astype(np.float32) / 8
    want = j_ep._local_dispatch_ffn(cfg, *(jnp.asarray(a) for a in (
        xf, weights, idx, wi, wg, wo)), shard_id, E_loc, C_loc)
    got = t_ep._local_dispatch_ffn(_cfg(t_smoke), *(torch.as_tensor(a) for a in (
        xf, weights, idx.astype(np.int64), wi, wg, wo)), shard_id, E_loc, C_loc)
    _close(got.numpy(), np.asarray(want), f"shard {shard_id}")
    # the shard's experts only: the rows routed elsewhere stay 0
    mine = ((idx >= shard_id * E_loc) & (idx < (shard_id + 1) * E_loc)).any(1)
    assert np.abs(got.numpy()[~mine]).max() == 0.0 and mine.any()


def test_hints_carry_the_reference_knobs():
    mesh = {"data": 1, "model": 1}
    h = Hints(mesh, ("data",), "model")
    assert (h.moe_expert_parallel, h.moe_impl) == (False, None)
    h = Hints(mesh, ("data",), "model", moe_expert_parallel=True,
              moe_impl="expert_parallel")
    assert (h.moe_expert_parallel, h.moe_impl) == (True, "expert_parallel")


_ONE_RANK = textwrap.dedent(r"""
    import dataclasses, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.act_sharding import Hints, use_hints
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models import build_model, moe
    init_process_group("cpu", init_method="file://" + sys.argv[1], rank=0,
                       world_size=1)
    mesh = make_host_mesh(1)
    for arch in ("dbrx-132b", "deepseek-v3-671b"):
        cfg = get_smoke_config(arch).replace(activation_dtype="float32")
        p = build_model(cfg).init(0, "cpu")["stack"]
        p = (p["suffix"] if "l0" in p.get("suffix", {}) else p["prefix"])
        p = [v for v in p.values() if "moe" in v][0]["moe"]
        x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator()
                        .manual_seed(0))
        hints = Hints(mesh, ("data",), "model", moe_impl="expert_parallel")
        with use_hints(hints):
            ep = moe.moe_forward(p, cfg, x)
        sc = moe.moe_forward_scatter(p, cfg, x)
        assert torch.equal(ep[0], sc[0]) and torch.equal(ep[1], sc[1]), arch
    print("ONE_RANK_OK")
""")


def test_one_rank_expert_parallel_equals_scatter_bit_for_bit(tmp_path):
    """On a one-rank gloo group with the (1, 1) mesh, C_loc = C and the
    all-reduce is the identity: the expert-parallel path gives scatter's
    output and aux exactly."""
    out = subprocess.run(
        [sys.executable, "-c", _ONE_RANK, str(tmp_path / "rdzv")],
        env=_env(), capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ONE_RANK_OK" in out.stdout


def test_expert_parallel_without_hints_is_scatter():
    cfg = _cfg(t_smoke)
    rng = np.random.RandomState(4)
    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    p = {"router": torch.as_tensor(rng.randn(d, 4).astype(np.float32)),
         "wi": torch.as_tensor(rng.randn(4, d, ff).astype(np.float32) / 8),
         "wg": torch.as_tensor(rng.randn(4, d, ff).astype(np.float32) / 8),
         "wo": torch.as_tensor(rng.randn(4, ff, d).astype(np.float32) / 8)}
    x = torch.as_tensor(rng.randn(2, 7, d).astype(np.float32))
    ep = t_moe.moe_forward(p, cfg, x, impl="expert_parallel")
    sc = t_moe.moe_forward(p, cfg, x, impl="scatter")
    assert torch.equal(ep[0], sc[0]) and torch.equal(ep[1], sc[1])
