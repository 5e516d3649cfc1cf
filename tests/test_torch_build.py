"""The kernel build path (`repro_torch.kernels.build`), driven with a stand-in
for nvcc: this box has no CUDA toolkit, so the real compile only happens on
the card (chip_smoke.py)."""
import os
import stat

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{calls}"
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "ptxas info    : Used 80 registers, 16512 bytes smem"
{fail}
printf 'lib' > "$out"
"""


def _fake_nvcc(tmp_path, fail=False):
    calls = tmp_path / "calls.txt"
    path = tmp_path / "nvcc"
    path.write_text(FAKE_NVCC.format(
        calls=calls, fail='echo "error: broken" >&2; exit 1' if fail else ""))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path), calls


def test_builds_once_per_source_content(tmp_path, monkeypatch):
    nvcc, calls = _fake_nvcc(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    lib = build.build("matmul")
    assert lib == build.library_path("matmul") and lib.read_text() == "lib"
    assert "Used 80 registers" in lib.with_suffix(".so.log").read_text()
    line = calls.read_text()
    assert "arch=compute_90a,code=sm_90a" in line and "-shared" in line
    assert line.rstrip().endswith("matmul.cu")
    build.build("matmul")  # cached: nvcc is not run again
    assert len(calls.read_text().splitlines()) == 1
    assert not [p for p in os.listdir(tmp_path / "build") if ".tmp" in p]


def test_failed_build_raises_and_leaves_nothing(tmp_path, monkeypatch):
    nvcc, _ = _fake_nvcc(tmp_path, fail=True)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="broken"):
        build.build("matmul")
    assert os.listdir(tmp_path / "build") == []


def test_library_path_follows_source_content(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// one")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k")
    (tmp_path / "k.cu").write_text("// two")
    assert build.library_path("k") != first
    assert first.parent == build.BUILD_DIR and first.name.startswith("k-")


def test_library_path_follows_headers_and_flags(tmp_path, monkeypatch):
    """A changed `csrc/*.cuh` header or a changed flag builds anew, so a
    stale library is never reused."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"')
    (tmp_path / "common.cuh").write_text("// one")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k")
    (tmp_path / "common.cuh").write_text("// two")
    second = build.library_path("k")
    assert second != first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lcuda",))
    assert build.library_path("k") not in (first, second)


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


@pytest.mark.parametrize("name", ["matmul", "matmul_wgmma", "flash_attention",
                                  "rg_lru"])
def test_ctypes_binding_matches_the_c_entry_point(name, monkeypatch):
    """Each wrapper declares ctypes argtypes that match its C entry point
    parameter by parameter (a pointer passed as a 32-bit int would be cut).
    Both matmul sources are bound in `kernels/matmul.py`."""
    import ctypes
    import importlib
    import re
    import types

    src = (build.CSRC_DIR / f"{name}.cu").read_text()
    sig = re.search(r'extern "C" cudaError_t repro_(\w+)\(([^)]*)\)', src,
                    re.S)
    assert sig and sig.group(1) == name
    want = []
    for param in sig.group(2).split(","):
        ctype = param.rsplit(None, 1)[0].replace("const ", "").strip()
        want.append({"void*": ctypes.c_void_p, "int": ctypes.c_int,
                     "float": ctypes.c_float}[ctype])
    fn = types.SimpleNamespace()
    monkeypatch.setattr(build, "load", lambda n: types.SimpleNamespace(
        **{f"repro_{n}": fn}))
    if name == "matmul_wgmma":
        module = importlib.import_module("repro_torch.kernels.matmul")
        bound = module._wgmma_kernel
    else:
        module = importlib.import_module(f"repro_torch.kernels.{name}")
        bound = module._kernel
    assert bound.__wrapped__() is fn
    assert fn.argtypes == want and fn.restype is ctypes.c_int
