"""The port's matmul against the Pallas TPU kernel.

On the CPU the port's `matmul` takes its plain version (`matmul_plain`),
which does the kernel's arithmetic; the reference runs in interpret mode as
tests/test_kernels.py runs it. The CUDA kernel itself is held against
`matmul_plain` on the card (chip_smoke.py, and the `cuda` test below).

Tolerances:
  * float32 output: rtol 1e-5 and atol 1e-5 * max|want|, the reference's
    own tolerance; the two differ only in the float32 summation order.
  * bf16 output: one bf16 ulp at the output's largest magnitude. Both round
    at the same points (once at the end, or with k_inner=0 at every
    block_k boundary), so they differ only where a float32 value that
    differs in its last bits falls on the other side of a bf16 rounding
    boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.matmul import matmul as j_matmul  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(x, 1e-30))) - 7)


def assert_matmul_close(got: np.ndarray, want: np.ndarray, out_bf16: bool):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    top = float(np.abs(want).max())
    if out_bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=bf16_ulp(top))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * top)


def _inputs(M, N, K, bf16, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(M, K).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    if bf16:  # round once, then hand both packages the same bf16 values
        a = np.asarray(jnp.asarray(a, jnp.bfloat16))
        b = np.asarray(jnp.asarray(b, jnp.bfloat16))
    return a, b


def _both(a, b, bf16, **knobs):
    jd = jnp.bfloat16 if bf16 else jnp.float32
    td = torch.bfloat16 if bf16 else torch.float32
    want = j_matmul(jnp.asarray(a, jd), jnp.asarray(b, jd), interpret=True,
                    **knobs)
    got = mm.matmul(torch.as_tensor(np.asarray(a, np.float32)).to(td),
                    torch.as_tensor(np.asarray(b, np.float32)).to(td),
                    **knobs)
    assert got.dtype == (torch.bfloat16 if knobs["out_bf16"]
                         else torch.float32)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("shape", [(64, 64, 64), (128, 96, 32), (100, 60, 36),
                                   (33, 17, 9), (256, 128, 64)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("k_inner", [True, False], ids=["kin", "kout"])
@pytest.mark.parametrize("out_bf16", [False, True], ids=["o32", "obf16"])
def test_matmul_sweep_matches_pallas(shape, bf16, k_inner, out_bf16):
    M, N, K = shape
    a, b = _inputs(M, N, K, bf16)
    got, want = _both(a, b, bf16, block_m=32, block_n=32, block_k=16,
                      k_inner=k_inner, out_bf16=out_bf16)
    assert_matmul_close(got, want, out_bf16)


@pytest.mark.parametrize("k_inner", [True, False], ids=["kin", "kout"])
@pytest.mark.parametrize("out_bf16", [False, True], ids=["o32", "obf16"])
def test_odd_block_k_splits_k_unevenly(k_inner, out_bf16):
    a, b = _inputs(70, 50, 100, True, seed=1)
    got, want = _both(a, b, True, block_m=64, block_n=16, block_k=24,
                      k_inner=k_inner, out_bf16=out_bf16)
    assert_matmul_close(got, want, out_bf16)


def test_kouter_bf16_rounds_at_block_boundaries():
    """k_inner=0 with a bf16 output rounds at every block_k boundary: the
    port agrees with the reference to about one ulp, while a single final
    rounding (k_inner=1) lands measurably elsewhere."""
    a, b = _inputs(64, 64, 512, False, seed=2)
    got, want = _both(a, b, False, block_m=32, block_n=32, block_k=8,
                      k_inner=False, out_bf16=True)
    assert_matmul_close(got, want, True)
    once = mm.matmul(torch.as_tensor(a), torch.as_tensor(b), block_k=8,
                     k_inner=True, out_bf16=True).float().numpy()
    assert np.abs(once - want).max() > 2 * bf16_ulp(np.abs(want).max())


@pytest.mark.parametrize("tiles", [(1024, 1024, 2048), (8, 8, 8), (1, 8, 512)])
def test_knob_space_corners(tiles):
    """Tiles far larger than the dims clamp to them; tiny tiles and M=1
    (the ResNet-18 fc GEMM's shape class) work."""
    bm, bn, bk = tiles
    a, b = _inputs(1 if bm == 1 else 40, 72, 96, True, seed=3)
    got, want = _both(a, b, True, block_m=bm, block_n=bn, block_k=bk,
                      k_inner=False, out_bf16=False)
    assert_matmul_close(got, want, False)


def test_matches_plain_oracle():
    a, b = _inputs(48, 40, 80, False, seed=4)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    np.testing.assert_allclose(
        mm.matmul(ta, tb, block_k=32).numpy(), ref.matmul_ref(ta, tb).numpy(),
        rtol=1e-5, atol=1e-5 * float(np.abs(a @ b).max()))


@pytest.mark.parametrize("bad", ["dtype_mix", "int", "shape", "rank", "block"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros(4, 8)
    b = torch.zeros(8, 3)
    kw = {}
    if bad == "dtype_mix":
        b = b.to(torch.bfloat16)
    elif bad == "int":
        a, b = a.int(), b.int()
    elif bad == "shape":
        b = torch.zeros(7, 3)
    elif bad == "rank":
        a = torch.zeros(2, 4, 8)
    else:
        kw = {"block_k": 0}
    with pytest.raises((TypeError, ValueError)):
        mm.matmul(a, b, **kw)


def test_cpu_tensors_never_launch():
    before = mm.matmul.launches
    mm.matmul(torch.ones(3, 4), torch.ones(4, 5))
    assert mm.matmul.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("k_inner", [True, False], ids=["kin", "kout"])
@pytest.mark.parametrize("out_bf16", [False, True], ids=["o32", "obf16"])
def test_cuda_kernel_matches_plain(k_inner, out_bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _inputs(100, 60, 36, True, seed=5)
    ta = torch.as_tensor(np.asarray(a, np.float32)).to("cuda", torch.bfloat16)
    tb = torch.as_tensor(np.asarray(b, np.float32)).to("cuda", torch.bfloat16)
    knobs = dict(block_m=32, block_n=32, block_k=16, k_inner=k_inner,
                 out_bf16=out_bf16)
    before = mm.matmul.launches
    got = mm.matmul(ta, tb, **knobs)
    torch.cuda.synchronize()
    assert mm.matmul.launches == before + 1
    want = mm.matmul_plain(ta, tb, **knobs)
    assert_matmul_close(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), out_bf16)
