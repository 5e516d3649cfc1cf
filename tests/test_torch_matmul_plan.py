"""The matmul launch plan (`repro_torch.kernels.matmul.plan`) on the CPU.

The plan decides, before any launch, which kernel runs (the wgmma variant
for bf16 inputs, the simt variant for float32 inputs and for rounding
boundaries inside a 16-deep wgmma step), the CTA tile, the raster group,
the k splits and the padding. The CUDA kernels run only on a card: the
`cuda` test at the end holds the wgmma variant against `matmul_plain`
there and skips here.

Tolerances: the padded-K check is exact (bit for bit), since its inputs
are small integers whose every partial sum is exact in float32, so the
summation order cannot matter and only the padding and the rounding points
can. The card test uses the matmul tests' own tolerances.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.matmul import matmul as j_matmul  # noqa: E402
from repro_torch.autotune.tasks import arch_tasks, resnet18_tasks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402

BF16 = torch.bfloat16


def _main_path_gemms():
    lm = [wl for wl in arch_tasks(get_config("recurrentgemma-2b"))
          if wl.kind == "matmul"]
    return resnet18_tasks() + lm


GEMMS = _main_path_gemms()
# (block_m, block_n, block_k, k_inner, out_bf16): the default config, the
# LM GEMMs' tuned tiles, small tiles, the knob corner, and k_inner=0 with
# both outputs
KNOBS = [(128, 128, 128, 1, 1), (512, 512, 512, 1, 1), (8, 8, 8, 1, 0),
         (1024, 1024, 2048, 1, 1), (64, 128, 128, 0, 1), (512, 1024, 64, 0, 0)]


def test_main_paths_have_nineteen_gemms():
    assert len(GEMMS) == 19
    assert len({wl.name for wl in GEMMS}) == 19


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(map(str, k)))
@pytest.mark.parametrize("wl", GEMMS, ids=lambda wl: wl.name)
def test_main_path_gemms_plan_wgmma(wl, knobs):
    """Every GEMM of both paths runs the wgmma variant; only the stem pads;
    split points fall on multiples of bk (and of the 64-deep stage); no
    split when the bf16 output rounds at every block."""
    M, N, K = wl.dims
    bm, bn, bk, k_inner, out_bf16 = knobs
    p = mm.plan(M, N, K, BF16, bm, bn, bk, bool(k_inner), bool(out_bf16))
    assert p.variant == "wgmma"
    assert p.bk == min(bk, K)
    assert (p.pad_bytes > 0) == (wl.name == "stem7x7")
    assert p.lda % 8 == 0 and p.ldb % 8 == 0
    assert p.splits * p.split_k >= K > (p.splits - 1) * p.split_k
    for point in range(p.split_k, p.splits * p.split_k, p.split_k):
        assert point % p.bk == 0 and point % mm.STAGE_K == 0
    if p.round_each_block:
        assert p.splits == 1 and p.cta_n == 128
    if p.splits > 1:
        assert p.tiles_m * p.tiles_n * p.splits <= mm.SMS
    assert p.ctas == p.tiles_m * p.tiles_n * p.splits
    assert p.cta_m == 128 and p.cta_n in (128, 256)


def test_stem_pads_k_to_eight_with_bk_from_the_unpadded_k():
    p = mm.plan(12544, 64, 147, BF16, 128, 64, 256, True, True)
    assert (p.lda, p.ldb, p.bk) == (152, 64, 147)
    assert p.pad_bytes == 12544 * 152 * 2 + 152 * 64 * 2


def test_too_few_tiles_split_k_and_enough_do_not():
    small = mm.plan(49, 512, 4608, BF16, 64, 128, 128, True, True)
    assert small.splits > 1 and small.ctas > 4 * 8
    lm_head = mm.plan(512, 256000, 2560, BF16, 512, 512, 1024, True, True)
    assert lm_head.splits == 1 and lm_head.cta_n == 256
    assert lm_head.ctas == 4 * 1000


@pytest.mark.parametrize("case,variant", [
    ((torch.float32, 64, 1, 1), "simt"),   # float32 in: no tensor-core path
    ((torch.float32, 64, 0, 1), "simt"),
    ((BF16, 8, 0, 1), "simt"),             # boundary inside a k16 step
    ((BF16, 24, 0, 1), "simt"),
    ((BF16, 8, 1, 1), "wgmma"),            # one final rounding
    ((BF16, 8, 0, 0), "wgmma"),            # float32 output
    ((BF16, 16, 0, 1), "wgmma"),
    ((BF16, 48, 0, 1), "wgmma"),
    ((BF16, 1024, 0, 1), "wgmma"),         # bk = K: one block
], ids=lambda c: str(c))
def test_simt_rule_corners(case, variant):
    dtype, bk, k_inner, out_bf16 = case
    p = mm.plan(100, 60, 200 if bk != 1024 else 36, dtype, 64, 32, bk,
                bool(k_inner), bool(out_bf16))
    assert p.variant == variant
    if variant == "simt":
        assert p.splits == 1 and p.pad_bytes == 0


@pytest.mark.parametrize("dims,tile", [
    ((512, 256000, 2560), (512, 512)), ((1100, 1030, 2100), (1024, 1024)),
    ((300, 700, 100), (256, 512)), ((49, 512, 4608), (64, 128)),
    ((12544, 64, 147), (8, 8)), ((1000, 3000, 64), (384, 768))])
def test_raster_groups_cover_each_cta_tile_once(dims, tile):
    """The linear grid maps onto the CTA tiles one to one, and the CTA tiles
    of one tuned tile (a raster group) get consecutive indices."""
    M, N, K = dims
    p = mm.plan(M, N, K, BF16, tile[0], tile[1], 64, True, False)
    order = mm.cta_tiles(p)
    assert len(order) == len(set(order)) == p.tiles_m * p.tiles_n
    assert set(order) == {(i, j) for i in range(p.tiles_m)
                          for j in range(p.tiles_n)}
    where = {}
    for k, (i, j) in enumerate(order):
        where.setdefault((i // p.group_m, j // p.group_n), []).append(k)
    for group, idx in where.items():
        assert idx == list(range(idx[0], idx[0] + len(idx))), group


def _int_inputs(M, N, K, seed):
    """Small integers: every product and partial sum is exact in float32."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-3, 4, (M, K)).astype(np.float32),
            rng.randint(-3, 4, (K, N)).astype(np.float32))


@pytest.mark.parametrize("block_k", [64, 256])
@pytest.mark.parametrize("k_inner", [True, False], ids=["kin", "kout"])
@pytest.mark.parametrize("out_bf16", [False, True], ids=["o32", "obf16"])
def test_padded_k_matches_pallas_bit_for_bit(block_k, k_inner, out_bf16):
    """K = 147 padded to 152 as the wrapper pads it for TMA, with bk clamped
    by the unpadded K, gives the Pallas kernel's result exactly."""
    M, N, K = 64, 64, 147
    a, b = _int_inputs(M, N, K, seed=7)
    want = np.asarray(j_matmul(jnp.asarray(a, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16), block_m=32,
                               block_n=32, block_k=block_k, k_inner=k_inner,
                               out_bf16=out_bf16, interpret=True), np.float32)
    p = mm.plan(M, N, K, BF16, 32, 32, block_k, k_inner, out_bf16)
    assert p.variant == "wgmma" and p.lda == 152 and p.bk == min(block_k, K)
    ta, tb = torch.as_tensor(a).to(BF16), torch.as_tensor(b).to(BF16)
    pa, pb = mm.pad_operands(ta, tb, p)
    assert pa.shape == (M, 152) and pb.shape == (152, p.ldb)
    assert not pa[:, K:].any() and not pb[K:].any()
    got = mm.matmul_plain(pa, pb[:, :N], block_m=32, block_n=32,
                          block_k=p.bk, k_inner=k_inner, out_bf16=out_bf16)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_wgmma_launch_error_raises_with_the_plan(monkeypatch):
    """No fallback: a refused wgmma launch raises, naming the plan."""
    calls = []

    def refuse(*args):
        calls.append(args)
        return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(mm, "_wgmma_kernel", lambda: refuse)
    monkeypatch.setattr(mm.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    a, b = torch.ones(49, 147, dtype=BF16), torch.ones(147, 512, dtype=BF16)
    p = mm.plan(49, 512, 147, BF16, 64, 64, 64, True, True)
    out = torch.empty(49, 512, dtype=BF16)
    with pytest.raises(RuntimeError, match="wgmma kernel launch failed.*"
                       "variant='wgmma'"):
        mm._launch_wgmma(a, b, out, p)
    assert len(calls) == 1 and calls[0][7] == 152  # lda, padded


def test_cpu_tensors_count_no_variant():
    before = dict(mm.matmul.launches_by_variant)
    mm.matmul(torch.ones(3, 4, dtype=BF16), torch.ones(4, 5, dtype=BF16))
    assert mm.matmul.launches_by_variant == before


@pytest.mark.cuda
@pytest.mark.parametrize("k_inner", [True, False], ids=["kin", "kout"])
@pytest.mark.parametrize("out_bf16", [False, True], ids=["o32", "obf16"])
def test_cuda_wgmma_variant_matches_plain(k_inner, out_bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(8)
    ta = torch.as_tensor(rng.randn(49, 147).astype(np.float32)).to(
        "cuda", BF16)
    tb = torch.as_tensor(rng.randn(147, 1000).astype(np.float32)).to(
        "cuda", BF16)
    knobs = dict(block_m=64, block_n=128, block_k=32, k_inner=k_inner,
                 out_bf16=out_bf16)
    before = mm.matmul.launches_by_variant["wgmma"]
    got = mm.matmul(ta, tb, **knobs)
    torch.cuda.synchronize()
    assert mm.matmul.launches_by_variant["wgmma"] == before + 1
    want = mm.matmul_plain(ta, tb, **knobs).float()
    err = (got.float() - want).abs()
    top = float(want.abs().max())
    if out_bf16:
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert float(err.max()) <= ulp
    else:
        assert bool((err <= 1e-5 * top + 1e-5 * want.abs()).all())
