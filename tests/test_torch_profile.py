"""The port's kernel probes (`repro_torch.kernels.profile`), the `ops`
profiling hook and the copied metrics registry, against the reference's,
on the CPU (where the wrappers take their plain versions)."""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import profile as j_profile  # noqa: E402
from repro_torch.autotune.registry import Registry  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import profile as t_profile  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def tmp_registry(tmp_path):
    old = ops.get_registry()
    reg = Registry(str(tmp_path / "tuned.json"))
    ops.set_registry(reg)
    yield reg
    ops.set_registry(old)


def test_metrics_module_is_a_verbatim_copy():
    ref = (ROOT / "src" / "repro" / "obs" / "metrics.py").read_text()
    port = (ROOT / "src" / "repro_torch" / "obs" / "metrics.py").read_text()
    assert port == ref


def test_profile_kernels_fills_tuned_and_default_histograms(tmp_registry):
    reg = MetricsRegistry()
    res = t_profile.profile_kernels(
        device="tpu_v5e",
        workloads=t_profile.default_workloads(seq=32, width=32, head_dim=16),
        metrics_registry=reg, torch_device="cpu")
    assert set(res) == set(t_profile.KERNELS)
    hists = reg.snapshot()["histograms"]
    for kernel in t_profile.KERNELS:
        for source in ("default", "tuned"):
            key = (f"kernel.seconds{{config={source},"
                   f"device=tpu_v5e,kernel={kernel}}}")
            assert key in hists, sorted(hists)
            assert hists[key]["count"] >= 1
        assert res[kernel]["tuned"] > 0 and res[kernel]["default"] > 0


def test_profile_kernels_defaults_to_the_card(monkeypatch, tmp_registry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_profile.profile_kernels(metrics_registry=MetricsRegistry())


def test_ops_dispatch_profiling_opt_in(monkeypatch, tmp_registry):
    monkeypatch.delenv("REPRO_KERNEL_PROFILE", raising=False)
    ops.reset_profiling()
    reg = MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        a = torch.ones((32, 32))
        ops.tuned_matmul(a, a)  # profiling off: silent
        assert not reg.snapshot()["histograms"]
        ops.enable_profiling()
        ops.tuned_matmul(a, a)
        q = torch.ones((1, 16, 8))
        ops.tuned_flash_attention(q, q, q)
        ops.tuned_rg_lru(q * 0.5, q)
        ops.enable_profiling(False)
        ops.tuned_matmul(a, a)
    finally:
        ops.reset_profiling()
        obs_metrics.pop_registry(reg)
    hists = reg.snapshot()["histograms"]
    for kernel in ("matmul", "attention", "scan"):
        key = f"kernel.seconds{{config=tuned,device=tpu_v5e,kernel={kernel}}}"
        assert key in hists and hists[key]["count"] == 1, sorted(hists)


@pytest.mark.parametrize("value,on", [("1", True), ("true", True),
                                      ("yes", True), ("0", False),
                                      ("", False)])
def test_profiling_env_var(monkeypatch, value, on):
    monkeypatch.setenv("REPRO_KERNEL_PROFILE", value)
    ops.reset_profiling()
    assert ops.profiling_enabled() is on
    ops.enable_profiling(not on)
    assert ops.profiling_enabled() is (not on)
    ops.reset_profiling()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "h2o-danube-1.8b",
                                  "deepseek-67b"])
def test_model_workloads_match_reference(arch):
    want = j_profile.model_workloads(j_get_config(arch))
    got = t_profile.model_workloads(t_get_config(arch))
    assert {k: (w.kind, w.dims) for k, w in got.items()} == \
        {k: (w.kind, w.dims) for k, w in want.items()}
    assert got["matmul"].dims == (64, 128, 128)


def test_probe_inputs_match_reference():
    """The same RandomState draws, in the same order, as the reference."""
    wls = t_profile.default_workloads(seq=16, width=8, head_dim=4)
    jwls = j_profile.default_workloads(seq=16, width=8, head_dim=4)
    jrng, trng = np.random.RandomState(0), np.random.RandomState(0)
    for kernel in t_profile.KERNELS:
        want = j_profile._probe_args(kernel, jwls[kernel], jrng)
        got = t_profile._probe_args(kernel, wls[kernel], trng,
                                    torch.device("cpu"))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(w, np.float32))
