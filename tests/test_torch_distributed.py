"""The port's distribution layer across processes: the reference's
multi-device cases (tests/test_distributed.py, tests/test_train.py) rerun
on gloo ranks on the CPU.

One module fixture starts 8 worker processes (tests/_torch_dist_worker.py;
a `file://` rendezvous under tmp_path, no fixed port) on the (2, 2, 2)
("pod", "data", "model") mesh with glm4-9b smoke (fsdp_tp, 4 layers
as one stacked group, float32 activations) and the reference's params, which they restore from
the reference's own checkpoint. The tests read what they measured: the
train step's loss against the JAX package's single-device loss on the same
params and batch (1e-4 * |ref| + 1e-4 * |ref|), its metrics (the grad norm
among them) and the state it leaves (moments, count, params) against the
JAX package's train step, so a wrong reduction of the gradients across
ranks or a wrong update shows; the checkpoint's host copies made on the
writing rank only; sequence-sharded decode
against plain decode (err < 1e-4), `compressed_psum` against the exact
mean (within scale * 1.01) and the simulation, and the checkpoint written
on this mesh restored onto a (2, 4) mesh bit for bit. The launcher runs
under `torch.distributed.run` on two ranks."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.distributed import compression as j_comp  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_loop as j_loop  # noqa: E402
from repro_torch.distributed import compression as t_comp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_dist_worker.py"
WORLD = 8


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return env


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's loss, then the 8 ranks' results."""
    work = tmp_path_factory.mktemp("dist")
    cfg = j_smoke("glm4-9b").replace(sharding_plan="fsdp_tp", num_layers=4,
                                     activation_dtype="float32",
                                     scan_layers=True)
    model = j_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    batch = {k: rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    np.savez(work / "batch.npz", **batch)
    jbatch = jax.tree.map(jnp.asarray, batch)
    loss, _ = jax.jit(model.loss)(params, jbatch)
    j_ckpt.CheckpointManager(str(work / "ref_ckpt")).save(
        0, {"params": params})
    # the reference's train step (the workers' AdamW) on the same state
    opt = j_opt.AdamW(j_opt.AdamWConfig(lr=1e-3))
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    after, metrics = j_loop.make_train_step(model, opt, mesh, donate=False)(
        state, jbatch)
    grads = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(params,
                                                                 jbatch)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD),
         str(work / "rendezvous"), str(work)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=270)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, "\n".join(
        f"rank {r} rc {c}:\n{log[-3000:]}" for r, (c, log)
        in enumerate(zip(codes, logs)) if c)
    with open(work / "results.json") as f:
        out = json.load(f)
    return {"ref_loss": float(loss), "work": work, "ref_state": state,
            "ref_after": after, "ref_grads": grads,
            "ref_metrics": {k: float(v) for k, v in metrics.items()}, **out}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, ref, what):
    """|got - ref| <= 1e-4 * max|ref| + 1e-4 * |ref|, elementwise."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref)
    tol = 1e-4 * np.abs(ref).max() + 1e-4 * np.abs(ref)
    assert (err <= tol).all(), f"{what}: max err {err.max()}"


def test_fsdp_tp_train_step_matches_jax_loss(run):
    ref = run["ref_loss"]
    loss = run["metrics"]["loss"]
    assert np.isfinite(loss) and np.isfinite(run["metrics"]["grad_norm"])
    assert abs(loss - ref) <= 1e-4 * abs(ref) + 1e-4 * abs(ref), (loss, ref)
    assert run["step"] == 1 and run["state_is_dtensor"]
    # embed [vocab, d]: vocab on "model", d over ("pod", "data")
    assert run["embed_placements"] == ["S1", "S1", "S0"]


def test_fsdp_tp_train_step_matches_jax_update(run):
    """The step's metrics (loss, grad norm, learning rate) and the state
    it leaves, which the ranks saved: the moments of every leaf (the first
    is 0.1 x the clipped gradient, reduced across the ranks), the count
    and step, and each param's update where the reference's gradient is
    above its tolerance (Adam moves a weight by about lr whatever its
    gradient's size, so a gradient of rounding noise may step either
    way)."""
    assert sorted(run["metrics"]) == sorted(run["ref_metrics"])
    for k, ref in run["ref_metrics"].items():
        _close(run["metrics"][k], ref, k)
    want = run["ref_after"]
    got = j_ckpt.CheckpointManager(str(run["work"] / "port_ckpt")).restore(
        1, want)
    assert int(got["step"]) == 1 == int(got["opt"]["count"])
    for part in ("m", "v"):
        g, w = _flat(got["opt"][part]), _flat(want["opt"][part])
        assert sorted(g) == sorted(w)
        for k in w:
            _close(g[k], w[k], f"{part} {k}")
    before = _flat(run["ref_state"]["params"])
    grads = _flat(run["ref_grads"])
    g, w = _flat(got["params"]), _flat(want["params"])
    for k, grad in grads.items():
        a = np.abs(grad)
        mask = a > 1e-4 * a.max() + 1e-4 * a
        assert mask.any(), k
        _close((g[k] - before[k])[mask], (w[k] - before[k])[mask],
               f"update {k}")


def test_checkpoint_gathers_to_the_writer_only(run):
    # rank 0 copies every gathered leaf to the host; the others none
    n = run["state_leaves"]
    assert run["host_copies_by_rank"] == [n] + [0] * (WORLD - 1)


def test_embedding_lookup_on_the_mesh(run):
    # values exact; the table's gradient reduced back onto its shards
    val_err, grad_err, grad_placements = run["embedding_lookup"]
    assert val_err == 0.0 and grad_err < 1e-5, (val_err, grad_err)
    assert grad_placements == ["S0", "S0", "S1"]


def test_distributed_decode_matches_plain_decode(run):
    assert run["decode_err"] < 1e-4, run["decode_err"]
    # the stacked cache [layers, B, Sc, G, D]: batch over ("pod", "data"),
    # the sequence dim over "model", before and after the step's slot write
    want = ["S1", "S1", "S2"]
    assert run["cache_placements"] == want
    assert run["decoded_cache_placements"] == want


def test_compressed_psum_is_within_a_quantization_step(run):
    x = np.random.RandomState(0).randn(8, 32).astype(np.float32)
    exact = x.mean(axis=0)
    err = np.abs(np.asarray(run["psum_mean"], np.float32) - exact).max()
    scale = np.abs(x).max() / 127
    assert err <= scale * 1.01, (err, scale)
    assert run["psum_equals_simulation"]


def test_elastic_restore_onto_another_mesh(run):
    assert run["restore_identical"]
    assert run["restored_on"] == [2, 4]
    # the ("data", "model") mesh: d over "data", vocab over "model"
    assert run["restored_placements"] == ["S1", "S0"]
    # the reference restores what the ranks wrote
    like = {"params": j_build(j_smoke("glm4-9b").replace(
        num_layers=4, scan_layers=True)).abstract_params_and_axes()[0]}
    ckpt = j_ckpt.CheckpointManager(str(run["work"] / "port_ckpt"))
    assert ckpt.all_steps() == [1]
    got = ckpt.restore(1, like)
    assert got["params"]["embed"].shape == like["params"]["embed"].shape


@pytest.mark.parametrize("seed", range(3))
def test_compression_matches_reference(seed):
    rng = np.random.RandomState(seed)
    shards = [rng.randn(64).astype(np.float32) for _ in range(4)]
    errors = [rng.randn(64).astype(np.float32) * 0.01 for _ in range(4)]
    jm, je = j_comp.simulate_compressed_allreduce(
        [jnp.asarray(s) for s in shards], [jnp.asarray(e) for e in errors])
    tm, te = t_comp.simulate_compressed_allreduce(
        [torch.as_tensor(s) for s in shards],
        [torch.as_tensor(e) for e in errors])
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for a, b in zip(te, je):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jq, js = j_comp.quantize_int8(jnp.asarray(shards[0]))
    tq, ts = t_comp.quantize_int8(torch.as_tensor(shards[0]))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        t_comp.dequantize_int8(tq, ts).numpy(),
        np.asarray(j_comp.dequantize_int8(jq, js)))


def test_int8_error_feedback_converges():
    # the reference's TestCompression case on the port
    rng = np.random.RandomState(0)
    shards = [torch.as_tensor(rng.randn(64).astype(np.float32))
              for _ in range(4)]
    exact = np.mean([s.numpy() for s in shards], axis=0)
    errors = [torch.zeros(64) for _ in range(4)]
    acc_comp = np.zeros(64)
    acc_exact = np.zeros(64)
    for _ in range(50):
        mean, errors = t_comp.simulate_compressed_allreduce(shards, errors)
        acc_comp += mean.numpy()
        acc_exact += exact
    rel = np.abs(acc_comp - acc_exact).max() / np.abs(acc_exact).max()
    assert rel < 5e-3, rel


def test_launch_train_model_parallel_under_torchrun(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--smoke", "--arch", "glm4-9b", "--model-parallel", "2",
           "--torch-device", "cpu", "--steps", "2", "--checkpoint-dir",
           str(tmp_path / "ckpt")]
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.count("final loss:") == 2, out.stdout
    # rank 0 wrote the one checkpoint
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002"]


_REHEARSAL = r"""
import json, os, sys, tempfile
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import chip_smoke
from repro_torch.kernels import flash_attention, matmul, rg_lru
with tempfile.TemporaryDirectory() as tmp:
    os.environ["REPRO_TORCH_TUNING_REGISTRY"] = os.path.join(tmp, "r.json")
    out = chip_smoke.drive_dist_path("cpu", (matmul, flash_attention,
                                             rg_lru), tmp, smoke=True)
print("DIST_PATH", json.dumps(out, default=str))
"""


def test_chip_smoke_dist_path_rehearses_on_cpu():
    """chip_smoke.py's dist_path at glm4-9b's (and, for the ep leg,
    dbrx-132b's) smoke size on a one-rank gloo group (a subprocess: the
    phase joins and leaves a process group); on one rank every leg matches
    the same work without the mesh; the dryrun leg runs its smoke cell."""
    code = _REHEARSAL.format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.split("DIST_PATH ", 1)[1])
    assert (line["world"], line["backend"], line["mesh"]) == (
        1, "gloo", {"data": 1, "model": 1})
    train, decode = line["train"], line["decode"]
    assert train["loss_diff"] == 0.0 and train["grad_norm_diff"] == 0.0
    assert train["leaf_max_abs_err"] < 1e-6
    assert [len(v) for v in train["step_s"].values()] == [2, 2]
    assert len(train["loop_losses"]) == 2
    assert decode["step_logits_max_abs_err"] < 1e-4
    assert len(decode["step_s"]["distributed_cache"]) == decode["steps"]
    assert line["compress"]["equal_to_simulation"]
    # the expert-parallel leg: on one rank, C_loc = C and the all-reduce
    # is the identity, so the block and its gradients equal scatter's
    ep = line["ep"]
    assert set(ep["block"]["max_abs_err"].values()) == {0.0}
    assert max(ep["block"]["vs_dense_mask"].values()) < 1e-4
    assert ep["serve"]["step_logits_max_abs_err"] == 0.0
    assert line["pipeline"]["max_abs_err"] == 0.0
    assert line["pipeline"]["bubble_fraction"] == 0.0
    [cell] = line["dryrun"]["cells"]
    assert cell["status"] == "ok" and cell["chips"] == 256
