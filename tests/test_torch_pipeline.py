"""The GPipe schedule of the port held to the JAX package: the reference's
TestPipeline case (tests/test_distributed.py) on 4 gloo ranks.

One module fixture draws W [4, 8, 8] * 0.3 and x [6, 2, 8] from a numpy
seed, applies the 4 stages tanh(x @ W[s]) in order with jax (the
sequential reference) and starts 4 worker processes
(tests/_torch_pipeline_worker.py; a `file://` rendezvous under tmp_path)
on a ("pod",) mesh of 4 stages, which run `pipeline_apply` with
point-to-point hand-offs on the pod group. Every rank's result must be
within 1e-5 of the sequential stages (the reference's bound)."""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed import pipeline as j_pipe  # noqa: E402
from repro_torch.distributed import pipeline as t_pipe  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_pipeline_worker.py"
WORLD = 4


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return env


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipe")
    rng = np.random.RandomState(0)
    W = (rng.randn(4, 8, 8) * 0.3).astype(np.float32)
    x = rng.randn(6, 2, 8).astype(np.float32)
    np.savez(work / "inputs.npz", W=W, x=x)
    ref = jnp.asarray(x)
    for s in range(4):
        ref = jnp.tanh(ref @ jnp.asarray(W[s]))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD),
         str(work / "rendezvous"), str(work)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=180)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    codes = [proc.returncode for proc in procs]
    assert codes == [0] * WORLD, "\n".join(
        f"rank {r} rc {c}:\n{log[-3000:]}" for r, (c, log)
        in enumerate(zip(codes, logs)) if c)
    return {"ref": np.asarray(ref),
            "outs": [np.load(work / f"out_{r}.npy") for r in range(WORLD)]}


@pytest.mark.parametrize("rank", range(WORLD))
def test_gpipe_matches_sequential(run, rank):
    out = run["outs"][rank]
    assert out.shape == (6, 2, 8)
    err = float(np.abs(out - run["ref"]).max())
    assert err < 1e-5, err


@pytest.mark.parametrize("num_stages", [1, 2, 4, 16])
@pytest.mark.parametrize("num_micro", [1, 4, 6, 32])
def test_bubble_fraction_matches_reference(num_stages, num_micro):
    assert t_pipe.bubble_fraction(num_stages, num_micro) == \
        j_pipe.bubble_fraction(num_stages, num_micro)


def test_num_stages_must_match_the_axis():
    mesh = type("M", (), {"mesh_dim_names": ("pod", "data"),
                          "shape": (2, 4),
                          "size": lambda self, i: (2, 4)[i]})()
    with pytest.raises(ValueError, match="num_stages"):
        t_pipe.pipeline_apply(lambda s, x: x, torch.zeros(3, 1), mesh, 4)
