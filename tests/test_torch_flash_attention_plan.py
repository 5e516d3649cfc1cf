"""The flash attention launch plan (`repro_torch.kernels.flash_attention.plan`)
on the CPU.

The plan decides, before any launch, which kernel runs (the wgmma variant
for bf16 inputs whose head dim TMA can read, the simt variant for float32
inputs and any other head dim), the q and kv tiles, the CTAs, the K/V ring
stages and the shared memory. The CUDA kernels run only on a card: the
`cuda` test at the end holds the wgmma variant against
`flash_attention_plain` there and skips here.

The rounding-point test: the wgmma kernel moves its running max once per
64-row kv tile, not once per tuned block_kv, so with bf16 inputs P rounds
against another max than the Pallas kernel's. `flash_attention_plain` with
block_kv = plan.kv_tile does the wgmma kernel's arithmetic; it is held
against the Pallas kernel (interpret mode) at the tuned blocks within 3e-2,
the reference's own bf16 tolerance between its kernel and the full softmax
(tests/test_kernels.py).
"""
import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import \
    flash_attention as j_flash_attention  # noqa: E402
from repro_torch.autotune.space import Workload, knob_space  # noqa: E402
from repro_torch.autotune.tasks import arch_tasks  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
BF16_TOL = 3e-2


def _zoo_head_dims():
    return sorted({wl.dims[1] for name in ARCH_IDS
                   for wl in arch_tasks(get_config(name))
                   if wl.kind == "attention"})


ZOO_D = _zoo_head_dims()


def test_zoo_head_dims():
    assert ZOO_D == [64, 80, 120, 128, 192, 256]


@pytest.mark.parametrize("dtype,D,variant", [
    (BF16, 64, "wgmma"), (BF16, 80, "wgmma"), (BF16, 120, "wgmma"),
    (BF16, 256, "wgmma"), (BF16, 8, "wgmma"),
    (BF16, 36, "simt"), (BF16, 17, "simt"), (BF16, 250, "simt"),
    (F32, 64, "simt"), (F32, 256, "simt"), (F32, 17, "simt"),
], ids=str)
def test_variant_rule(dtype, D, variant):
    """wgmma for bf16 with D % 8 == 0 (TMA's 16-byte rows), simt for
    float32 (no exact float32 wgmma) and for any other D."""
    p = fa.plan(2, 100, D, dtype, 128, 128, True, 0)
    assert p.variant == variant
    if variant == "wgmma":
        assert p.kv_tile == fa.KV_TILE and p.d_pad == -(-D // 64) * 64
        assert 2 <= p.stages <= fa.MAX_STAGES
    else:
        assert p.stages == 0 and p.d_pad == D


def test_self_attn_runs_wgmma_on_80_ctas():
    """RecurrentGemma-2B's self_attn (B = 10 heads, S = 512, D = 256): 64-row
    q tiles, 10 x 8 = 80 CTAs whatever the tuned blocks (20 at block_q 256
    before); the longest causal CTA visits all 8 kv tiles."""
    for bq, bkv in itertools.product((64, 256, 1024), (64, 512)):
        p = fa.plan(10, 512, 256, BF16, bq, bkv, True, 0)
        assert (p.variant, p.q_tile, p.kv_tile, p.ctas) == \
            ("wgmma", 64, 64, 80)
        assert p.max_kv_tiles == 8
        assert p.smem_bytes <= fa.SMEM_LIMIT


@pytest.mark.parametrize("B,S,q_tile", [
    (10, 512, 64), (33, 512, 128), (32, 512, 64), (40, 512, 128),
    (1, 16896, 128), (1, 16768, 64), (132, 1, 128), (131, 128, 64)])
def test_q_tile_rule(B, S, q_tile):
    """128 rows (two consumer warpgroups) when B * ceil(S / 128) >= 132,
    else 64 (one consumer)."""
    p = fa.plan(B, S, 128, BF16, 128, 128, False, 0)
    assert p.q_tile == q_tile
    assert p.ctas == B * -(-S // q_tile)


@pytest.mark.parametrize("D", ZOO_D)
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_smem_fits_at_every_knob_corner(D, dtype):
    """Every (block_q, block_kv) of the attention knob space, both q tiles,
    causal or not: one CTA's shared memory fits the 232,448 bytes a block
    may use, and the wgmma ring keeps at least 2 stages."""
    ks = knob_space(Workload("attention", (512, D)))
    for bq, bkv, B, causal in itertools.product(
            ks["block_q"], ks["block_kv"], (1, 40), (True, False)):
        p = fa.plan(B, 512, D, dtype, bq, bkv, causal, 0)
        assert 0 < p.smem_bytes <= fa.SMEM_LIMIT, (p, bq, bkv)
        if p.variant == "wgmma":
            assert p.stages >= 2
            assert p.smem_bytes == fa._wgmma_smem(p.d_pad, p.q_tile,
                                                  p.stages)


def test_d256_stages():
    """At D = 256: a 128-row tile leaves room for 2 stages, a 64-row tile
    for 3 (Q 64 KB or 32 KB, each stage 64 KB)."""
    assert fa.plan(40, 512, 256, BF16, 128, 128, True, 0).stages == 2
    assert fa.plan(10, 512, 256, BF16, 128, 128, True, 0).stages == 3
    assert fa.plan(10, 512, 64, BF16, 128, 128, True, 0).stages == 4


def _kept_tiles(S, q0, q1, kv_tile, causal, window):
    """kv tiles that hold a position some row of [q0, q1) keeps (brute
    force)."""
    tiles = set()
    for q in range(q0, q1):
        for k in range(S):
            if (not causal or k <= q) and (window == 0 or k > q - window):
                tiles.add(k // kv_tile)
    return tiles


@pytest.mark.parametrize("S,causal,window", [
    (512, True, 0), (512, False, 0), (300, True, 100), (300, False, 100),
    (200, True, 1), (130, False, 0)])
def test_skipped_kv_tiles_hold_nothing_kept(S, causal, window):
    """The kv tiles the kernels visit for a q tile form one run, and it
    covers every tile that holds a kept position; max_kv_tiles is the
    longest such run."""
    p = fa.plan(2, S, 64, BF16, 128, 128, causal, window)
    most = 0
    for q0 in range(0, S, p.q_tile):
        q1 = min(q0 + p.q_tile, S)
        kept = _kept_tiles(S, q0, q1, p.kv_tile, causal, window)
        assert kept == set(range(min(kept), max(kept) + 1))
        most = max(most, len(kept))
    assert p.max_kv_tiles == most


def _reference_inputs(B, S, D, seed):
    """q, k, v on the bf16 grid, as float32 numpy."""
    rng = np.random.RandomState(seed)
    return [np.asarray(jnp.asarray(rng.randn(B, S, D).astype(np.float32),
                                   jnp.bfloat16), np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal,window,bq,bkv", [
    (True, 0, 256, 256), (True, 100, 256, 256), (False, 64, 128, 256)],
    ids=["causal", "causal-window", "window"])
def test_moved_max_update_stays_within_reference_tolerance(causal, window,
                                                           bq, bkv):
    """plain at block_kv = plan.kv_tile (the wgmma kernel's rounding point)
    against the Pallas kernel at the tuned blocks, bf16, within 3e-2."""
    B, S, D = 2, 256, 256
    qkv = _reference_inputs(B, S, D, seed=7)
    p = fa.plan(B, S, D, BF16, bq, bkv, causal, window)
    assert p.variant == "wgmma" and p.kv_tile == 64 < bkv
    want = np.asarray(j_flash_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in qkv), causal=causal,
        window=window, block_q=bq, block_kv=bkv, interpret=True), np.float32)
    got = fa.flash_attention_plain(
        *(torch.as_tensor(t).to(BF16) for t in qkv), causal=causal,
        window=window, block_q=bq, block_kv=p.kv_tile).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def test_wgmma_launch_error_raises_with_the_plan(monkeypatch):
    """No fallback: a refused wgmma launch raises, naming the plan."""
    calls = []

    def refuse(*args):
        calls.append(args)
        return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(fa, "_wgmma_kernel", lambda: refuse)
    monkeypatch.setattr(fa, "_kernel", lambda: pytest.fail("simt launched"))
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    q, k, v = (torch.ones(10, 512, 256, dtype=BF16) for _ in range(3))
    p = fa.plan(10, 512, 256, BF16, 256, 256, True, 0)
    out = torch.empty(10, 512, 256)
    with pytest.raises(RuntimeError, match="wgmma kernel launch failed.*"
                       "variant='wgmma'.*ctas=80"):
        fa._launch_wgmma(q, k, v, out, p, True, 0, 0.0625)
    assert len(calls) == 1
    # B, S, D, q_tile, stages, causal, window as the plan says
    assert calls[0][4:11] == (10, 512, 256, 64, 3, 1, 0)


def test_cpu_tensors_count_no_variant():
    before = dict(fa.flash_attention.launches_by_variant)
    fa.flash_attention(*(torch.ones(1, 4, 8, dtype=BF16) for _ in range(3)))
    fa.flash_attention(*(torch.ones(1, 4, 8) for _ in range(3)))
    assert fa.flash_attention.launches_by_variant == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,causal,window", [
    (10, 512, 256, True, 0), (40, 512, 80, True, 100), (3, 100, 64, False, 16)],
    ids=["self_attn", "two-consumers", "window"])
def test_cuda_wgmma_variant_matches_plain(B, S, D, causal, window):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.as_tensor(t).to("cuda", BF16)
               for t in _reference_inputs(B, S, D, seed=9))
    kw = dict(causal=causal, window=window, block_q=256, block_kv=256)
    before = dict(fa.flash_attention.launches_by_variant)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_variant == {
        "wgmma": before["wgmma"] + 1, "simt": before["simt"]}
    want = fa.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)
