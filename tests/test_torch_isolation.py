"""The PyTorch port imports neither jax nor anything of `repro`.

Checked in a subprocess, because this test process already imported jax
(tests/conftest.py)."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.matmul" in mods and len(mods) > 15
    assert {"repro_torch.obs", "repro_torch.models", "repro_torch.train",
            "repro_torch.serve", "repro_torch.launch.serve",
            "repro_torch.kernels.profile"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_jax_or_repro_import_statement(path):
    text = path.read_text()
    # `\b` does not fall between "repro" and "_torch"
    bad = re.findall(r"^\s*(?:import|from)\s+(?:jax|repro)\b.*$", text, re.M)
    assert not bad, f"{path}: {bad}"
