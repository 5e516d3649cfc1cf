"""The port's flash attention against the Pallas TPU kernel.

On the CPU the port's `flash_attention` takes its plain version
(`flash_attention_plain`), which does the kernel's arithmetic; the
reference runs in interpret mode as tests/test_kernels.py runs it. The CUDA
kernel itself is held against `flash_attention_plain` on the card
(chip_smoke.py, and the `cuda` test below).

Tolerances are the reference's own (tests/test_kernels.py):
  * float32 inputs: rtol = atol = 1e-4. Both run the same online softmax
    over the same block_kv blocks; they differ in the float32 summation
    order and in exp's last bits.
  * bf16 inputs: rtol = atol = 3e-2. Both round P to bf16 against the same
    running max, so a p whose float32 value differs in its last bits may
    round to the neighbouring bf16 value: the output moves by up to a bf16
    ulp of p times |v|.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash_attention  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = {False: 1e-4, True: 3e-2}


def _inputs(B, S, D, bf16, seed=0):
    """q, k, v as float32 numpy arrays; with bf16, values already on the
    bf16 grid so that both packages get the same bf16 inputs."""
    rng = np.random.RandomState(seed)
    qkv = [rng.randn(B, S, D).astype(np.float32) for _ in range(3)]
    if bf16:
        qkv = [np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)
               for t in qkv]
    return qkv


def _both(qkv, bf16, **kw):
    jd = jnp.bfloat16 if bf16 else jnp.float32
    td = torch.bfloat16 if bf16 else torch.float32
    want = j_flash_attention(*(jnp.asarray(t, jd) for t in qkv),
                             interpret=True, **kw)
    got = fa.flash_attention(*(torch.as_tensor(t).to(td) for t in qkv), **kw)
    assert got.dtype == torch.float32 and got.shape == tuple(qkv[0].shape)
    return got.numpy(), np.asarray(want, np.float32)


def _close(got, want, bf16):
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL[bf16], atol=TOL[bf16])


@pytest.mark.parametrize("S", [64, 100, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0),
                                           (False, 16)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_sweep_matches_pallas(S, causal, window, bf16):
    """The reference's sweep, plus (causal=False, window=16): the window
    cuts only the left side when the attention is not causal."""
    qkv = _inputs(2, S, 32, bf16)
    got, want = _both(qkv, bf16, causal=causal, window=window, block_q=32,
                      block_kv=32)
    _close(got, want, bf16)


@pytest.mark.parametrize("D", [80, 120, 192, 256])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_head_dims_of_the_lm_zoo(D, bf16):
    qkv = _inputs(2, 64, D, bf16, seed=1)
    got, want = _both(qkv, bf16, block_q=32, block_kv=32)
    _close(got, want, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_uneven_blocks(bf16):
    qkv = _inputs(2, 100, 32, bf16, seed=2)
    got, want = _both(qkv, bf16, block_q=64, block_kv=32)
    _close(got, want, bf16)


def test_explicit_scale():
    qkv = _inputs(2, 100, 32, False, seed=3)
    got, want = _both(qkv, False, window=16, block_q=32, block_kv=32,
                      scale=0.3)
    _close(got, want, False)
    default, _ = _both(qkv, False, window=16, block_q=32, block_kv=32)
    assert np.abs(got - default).max() > 1e-2  # the scale was used


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0),
                                           (False, 16)])
def test_matches_oracles(causal, window):
    """The full masked softmax: the port's oracle against the reference's
    oracle, and the port's flash attention against the port's oracle."""
    qkv = _inputs(2, 100, 32, False, seed=4)
    tq = [torch.as_tensor(t) for t in qkv]
    want = np.asarray(j_ref.flash_attention_ref(
        *(jnp.asarray(t) for t in qkv), causal=causal, window=window))
    oracle = ref.flash_attention_ref(*tq, causal=causal, window=window)
    np.testing.assert_allclose(oracle.numpy(), want, rtol=1e-5, atol=1e-6)
    got = fa.flash_attention(*tq, causal=causal, window=window, block_q=32,
                             block_kv=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_fully_masked_first_block_adds_nothing():
    """With window 4 and 16-wide blocks, rows from 20 on see a first block
    whose logits are all masked: the row's max stays -1e30 and the guard
    keeps exp(0) = 1 out of the sum."""
    q, k, v = (torch.as_tensor(t) for t in _inputs(1, 64, 16, False, 5))
    out = fa.flash_attention(q, k, v, causal=True, window=4, block_q=16,
                             block_kv=16)
    assert torch.isfinite(out).all()
    want = ref.flash_attention_ref(q, k, v, causal=True, window=4)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype_mix", "int", "shape", "rank", "block",
                                 "window", "head_dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = k = v = torch.zeros(2, 8, 16)
    kw = {}
    if bad == "dtype_mix":
        v = v.to(torch.bfloat16)
    elif bad == "int":
        q = k = v = q.int()
    elif bad == "shape":
        k = torch.zeros(2, 9, 16)
    elif bad == "rank":
        q = k = v = torch.zeros(8, 16)
    elif bad == "block":
        kw = {"block_kv": 0}
    elif bad == "window":
        kw = {"window": -1}
    else:
        q = k = v = torch.zeros(2, 8, 257)
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(q, k, v, **kw)


def test_cpu_tensors_never_launch():
    before = fa.flash_attention.launches
    fa.flash_attention(*(torch.ones(1, 4, 8) for _ in range(3)))
    assert fa.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain(bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    td = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.as_tensor(t).to("cuda", td)
               for t in _inputs(2, 100, 80, bf16, seed=6))
    kw = dict(causal=True, window=16, block_q=64, block_kv=32)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, **kw)
    _close(got.cpu().numpy(), want.cpu().numpy(), bf16)
