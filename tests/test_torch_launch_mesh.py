"""The launchers' mesh flags on the port: `launch.train --opt act,epmoe`
under `torch.distributed.run` on 2 CPU processes (gloo, --model-parallel
2) against the same run with --opt act, and `--production-mesh` [`--multi-
pod`] in `launch.train` and `launch.serve`, which raise the reference's
RuntimeError in a group smaller than the mesh."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return env


def _final_losses(opt: str, ckpt) -> list:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--smoke", "--arch", "dbrx-132b", "--model-parallel", "2",
           "--torch-device", "cpu", "--steps", "2", "--opt", opt,
           "--checkpoint-dir", str(ckpt)]
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return [float(x) for x in re.findall(r"final loss: (\S+) over 2 steps",
                                         out.stdout)]


def test_epmoe_trains_as_scatter_with_one_data_shard(tmp_path):
    """With data = 1 the expert-parallel C_loc is the global C, so the two
    steps give the scatter path's loss (the launcher prints 4 decimals:
    the tolerance 1e-4 * |x| + 1e-4 * |x| plus the rounding)."""
    ep = _final_losses("act,epmoe", tmp_path / "ep")
    sc = _final_losses("act", tmp_path / "sc")
    assert len(ep) == len(sc) == 2
    for a, b in zip(ep, sc):
        assert abs(a - b) <= 2e-4 * abs(b) + 1e-4, (ep, sc)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_production_mesh_raises_runtime_error(multi_pod):
    argv = ["--arch", "glm4-9b", "--smoke", "--torch-device", "cpu",
            "--production-mesh"] + (["--multi-pod"] if multi_pod else [])
    args = t_train.parser().parse_args(argv)
    need = 512 if multi_pod else 256
    with pytest.raises(RuntimeError, match=f"needs {need} devices"):
        t_train.build_training(args)


def test_serve_production_mesh_raises_runtime_error():
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        t_serve.main(["--arch", "glm4-9b", "--smoke", "--torch-device",
                      "cpu", "--production-mesh"])


def test_epmoe_hints_without_a_mesh_train_plainly():
    """One process and --model-parallel 1: no mesh, so no hints (the
    reference's --opt epmoe needs a mesh too)."""
    args = t_train.parser().parse_args(
        ["--arch", "dbrx-132b", "--smoke", "--torch-device", "cpu",
         "--opt", "act,epmoe"])
    run = t_train.build_training(args)
    assert run.mesh is None and run.hints is None
