"""The port's RG-LRU scan against the Pallas TPU kernel.

On the CPU the port's `rg_lru` takes its plain version (`rg_lru_plain`),
which does the kernel's arithmetic; the reference runs in interpret mode as
tests/test_kernels.py runs it. The CUDA kernel itself is held against
`rg_lru_plain` on the card (chip_smoke.py, and the `cuda` test below).

Tolerance: rtol 1e-4, atol 1e-5, the reference's own. Both carry h in
float32 through the same sequence of steps; they may differ only where
one side fuses a_t * h + x_t into one rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.rg_lru import rg_lru as j_rg_lru  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rg_lru as lru  # noqa: E402


def _inputs(B, S, W, bf16, seed=0):
    """Decays in (0, 0.98) and standard normal inputs, as float32 numpy;
    with bf16, values already on the bf16 grid."""
    rng = np.random.RandomState(seed)
    a = (1.0 / (1.0 + np.exp(-rng.randn(B, S, W))) * 0.98).astype(np.float32)
    x = rng.randn(B, S, W).astype(np.float32)
    if bf16:
        a, x = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)
                for t in (a, x))
    return a, x


def _both(a, x, bf16, **kw):
    jd = jnp.bfloat16 if bf16 else jnp.float32
    td = torch.bfloat16 if bf16 else torch.float32
    want = j_rg_lru(jnp.asarray(a, jd), jnp.asarray(x, jd), interpret=True,
                    **kw)
    got = lru.rg_lru(torch.as_tensor(a).to(td), torch.as_tensor(x).to(td),
                     **kw)
    assert got.dtype == torch.float32 and got.shape == a.shape
    return got.numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 50, 100), (3, 33, 17)])
@pytest.mark.parametrize("chunk,block_w", [(16, 32), (64, 64), (8, 128)])
def test_sweep_matches_pallas(shape, chunk, block_w):
    a, x = _inputs(*shape, False)
    got, want = _both(a, x, False, chunk=chunk, block_w=block_w)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 33, 17)])
def test_bf16_inputs(shape):
    a, x = _inputs(*shape, True, seed=1)
    got, want = _both(a, x, True, chunk=16, block_w=32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_matches_oracles():
    """The port's sequential oracle against the reference's associative
    scan, and the port's scan against the port's oracle."""
    a, x = _inputs(2, 70, 40, False, seed=2)
    want = np.asarray(j_ref.rg_lru_ref(jnp.asarray(a), jnp.asarray(x)))
    ta, tx = torch.as_tensor(a), torch.as_tensor(x)
    np.testing.assert_allclose(ref.rg_lru_ref(ta, tx).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        lru.rg_lru(ta, tx, chunk=16, block_w=32).numpy(),
        ref.rg_lru_ref(ta, tx).numpy(), rtol=0, atol=0)


def test_reference_sweep_inputs():
    """The reference's own sweep inputs (jax.random), handed over as
    numpy."""
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    a = np.array(jax.nn.sigmoid(jax.random.normal(k1, (1, 50, 100))) * 0.98)
    x = np.array(jax.random.normal(k2, (1, 50, 100)))
    got, want = _both(a, x, False, chunk=16, block_w=32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype_mix", "int", "shape", "rank",
                                 "chunk"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = x = torch.zeros(2, 8, 16)
    kw = {}
    if bad == "dtype_mix":
        x = x.to(torch.bfloat16)
    elif bad == "int":
        a = x = a.int()
    elif bad == "shape":
        x = torch.zeros(2, 9, 16)
    elif bad == "rank":
        a = x = torch.zeros(8, 16)
    else:
        kw = {"chunk": 0}
    with pytest.raises((TypeError, ValueError)):
        lru.rg_lru(a, x, **kw)


def test_cpu_tensors_never_launch():
    before = lru.rg_lru.launches
    lru.rg_lru(torch.ones(1, 4, 8), torch.ones(1, 4, 8))
    assert lru.rg_lru.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain(bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    td = torch.bfloat16 if bf16 else torch.float32
    a, x = (torch.as_tensor(t).to("cuda", td)
            for t in _inputs(3, 100, 300, bf16, seed=3))
    before = lru.rg_lru.launches
    got = lru.rg_lru(a, x, chunk=16, block_w=128)
    torch.cuda.synchronize()
    assert lru.rg_lru.launches == before + 1
    want = lru.rg_lru_plain(a, x)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
