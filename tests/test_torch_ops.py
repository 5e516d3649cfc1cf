"""Registry dispatch of the attention and scan kernels: one registry file
with one tuned entry per workload, read by both packages, and both
packages' tuned wrappers agree on the same inputs (the analogue of
tests/test_kernels.py::test_tuned_ops_use_registry). Tolerances are the
reference's: 1e-4 for float32 attention, rtol 1e-4 / atol 1e-5 for the
scan."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.autotune.registry import Registry as JRegistry  # noqa: E402
from repro.autotune.space import ProgramConfig, Workload  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.autotune.registry import Registry as TRegistry  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import rg_lru as lru  # noqa: E402


@pytest.fixture
def registries(tmp_path):
    """A registry file holding a non-default config for attention (S=96,
    D=32) and scan (S=80, W=48), installed in both packages' ops."""
    path = str(tmp_path / "reg.json")
    reg = JRegistry(path=path)
    reg.put("tpu_v5e", Workload("attention", (96, 32)), ProgramConfig.make(
        block_q=64, block_kv=32, stages=1, unroll=1), 100.0)
    reg.put("tpu_v5e", Workload("scan", (80, 48)), ProgramConfig.make(
        chunk=16, block_w=32, unroll=1), 100.0)
    reg.save()
    old_j, old_t = j_ops._registry, t_ops._registry
    j_ops.set_registry(JRegistry(path=path))
    t_ops.set_registry(TRegistry(path=path))
    yield
    j_ops.set_registry(old_j)
    t_ops.set_registry(old_t)


def _spy(monkeypatch, module, name):
    """Record the keyword arguments of each call to module.name."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kw):
        seen.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16)])
def test_tuned_flash_attention(registries, monkeypatch, causal, window):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 96, 32).astype(np.float32) for _ in range(3))
    seen = _spy(monkeypatch, fa, "flash_attention")
    want = j_ops.tuned_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, device="tpu_v5e", interpret=True)
    got = t_ops.tuned_flash_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        causal=causal, window=window, device="tpu_v5e")
    assert seen[0]["block_q"] == 64 and seen[0]["block_kv"] == 32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_tuned_rg_lru(registries, monkeypatch):
    rng = np.random.RandomState(1)
    a = (1.0 / (1.0 + np.exp(-rng.randn(2, 80, 48))) * 0.98).astype(
        np.float32)
    x = rng.randn(2, 80, 48).astype(np.float32)
    seen = _spy(monkeypatch, lru, "rg_lru")
    want = j_ops.tuned_rg_lru(jnp.asarray(a), jnp.asarray(x),
                              device="tpu_v5e", interpret=True)
    got = t_ops.tuned_rg_lru(torch.as_tensor(a), torch.as_tensor(x),
                             device="tpu_v5e")
    assert seen[0] == {"chunk": 16, "block_w": 32}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_untuned_workload_takes_the_default(registries, monkeypatch):
    """A miss dispatches the vendor default (128 x 128 blocks) in both."""
    seen = _spy(monkeypatch, fa, "flash_attention")
    q = torch.zeros(1, 40, 8)
    t_ops.tuned_flash_attention(q, q, q, device="tpu_v5e")
    assert seen[0]["block_q"] == 128 and seen[0]["block_kv"] == 128
