"""The prefill attention entry (`repro_torch.kernels.flash_attention.
prefill_attention`) and the models' route to it, on the CPU.

`attention_prefill` takes the hand-written Hopper kernel for CUDA bf16
inputs with D == Dv and a shape `prefill_plan` accepts, and the chunk loop
(`_blocked_attention`) for everything else. The kernel runs only on a card:
its plain version, `prefill_attention_plain`, does its arithmetic (a
float32 online softmax whose running max moves once per kv tile of the
plan, P rounded to bf16 against it), and CPU tensors take it. Here it is
held against the chunk loop, whose running max moves once per 512-row
chunk:
  * float32 inputs within rtol = atol = 1e-4: the two differ in summation
    order and exp's last bits only;
  * bf16 inputs within rtol = atol = 3e-2, the reference's own bf16
    tolerance (tests/test_kernels.py): P rounds to bf16 against another
    running max, and the bf16 output rounds once more.
The route predicate is asked about a card's tensors by their device type,
dtype and shapes alone. The `cuda` test at the end holds the kernel to the
plain version on a card and skips here.
"""
import ctypes
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402,E501
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import ParamBuilder  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
TOL = {F32: 1e-4, BF16: 3e-2}


def _inputs(B, S, H, G, D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g).to(dtype)
    k = torch.randn(B, S, G, D, generator=g).to(dtype)
    v = torch.randn(B, S, G, D, generator=g).to(dtype)
    return q, k, v


def _loop(q, k, v, kind, window):
    return attn._blocked_attention(q, k, v, kind, window, 0, 512, 512, None,
                                   None)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kind,window", [("causal", 0), ("sliding", 48)],
                         ids=["causal", "sliding"])
@pytest.mark.parametrize("S", [1, 63, 130, 600])
@pytest.mark.parametrize("R", [1, 4, 16])
def test_plain_matches_the_chunk_loop(R, S, kind, window, D, dtype):
    """q head h against kv head h // R, S not a multiple of 64 or of the kv
    tile: the plain version (what CPU tensors take) equals the chunk loop
    within the tolerance of its dtype, and keeps q's dtype and layout."""
    G = 2
    q, k, v = _inputs(1 if S == 600 else 2, S, R * G, G, D, dtype, seed=S)
    got = fa.prefill_attention(q, k, v, causal=True,
                               window=window if kind == "sliding" else 0)
    want = _loop(q, k, v, kind, window)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,window", [("causal", 0), ("sliding", 48)],
                         ids=["causal", "sliding"])
@pytest.mark.parametrize("R", [1, 4, 16])
def test_plain_matches_the_jax_reference(R, kind, window, dtype):
    """The plain version against the reference package's blocked attention
    (`repro.models.attention.blocked_attention`) on the same numpy inputs:
    float32 within 1e-4, bf16 within the reference's 3e-2."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models import attention as j_attn
    G, S, D = 2, 130, 64
    rng = np.random.RandomState(R)
    q, k, v = (rng.randn(2, S, n, D).astype(np.float32)
               for n in (R * G, G, G))
    jd, td = jnp.dtype(dtype), {"float32": F32, "bfloat16": BF16}[dtype]
    want = j_attn.blocked_attention(*(jnp.asarray(t, jd) for t in (q, k, v)),
                                    kind=kind, window=window)
    got = fa.prefill_attention_plain(
        *(torch.from_numpy(t).to(td) for t in (q, k, v)), causal=True,
        window=window if kind == "sliding" else 0)
    assert got.dtype == td and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[td], atol=TOL[td])


@pytest.mark.parametrize("kv_tile", [16, 64, 128])
def test_plain_full_attention_and_kv_tile(kv_tile, monkeypatch):
    """No causal mask ("full"), and any kv tile of the online softmax: the
    same function within the float32 tolerance."""
    q, k, v = _inputs(2, 150, 8, 2, 64, F32, seed=3)
    monkeypatch.setattr(fa, "prefill_kv_tile", lambda D: kv_tile)
    got = fa.prefill_attention_plain(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(), _loop(q, k, v, "full", 0).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_plain_kv_tile_is_the_plans():
    """By default the plain version moves its max once per the plan's kv
    tile: 128 rows where D pads to at most 128, else 64."""
    assert [fa.prefill_kv_tile(D) for D in (64, 80, 120, 128, 192, 256)] == \
        [128, 128, 128, 128, 64, 64]
    for D in (64, 192):
        p = fa.prefill_plan(2, 300, 8, 2, D, BF16, True, 0)
        assert p.kv_tile == fa.prefill_kv_tile(D)


def test_plain_rounds_p_like_the_kernel(monkeypatch):
    """bf16 inputs: the plain version at its default kv tile equals the
    same loop with the tile of 128 rows set outright, bit for bit, and
    moves from the loop at 512-row tiles only within the bf16 tolerance."""
    q, k, v = _inputs(1, 700, 4, 1, 128, BF16, seed=5)
    a = fa.prefill_attention_plain(q, k, v)
    monkeypatch.setattr(fa, "prefill_kv_tile", lambda D: 128)
    b = fa.prefill_attention_plain(q, k, v)
    assert torch.equal(a, b)
    monkeypatch.setattr(fa, "prefill_kv_tile", lambda D: 512)
    c = fa.prefill_attention_plain(q, k, v)
    np.testing.assert_allclose(a.float().numpy(), c.float().numpy(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v: (q[0], k, v), "q \\[B, S, H, D\\]"),
    (lambda q, k, v: (q, k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1]
                      .expand(-1, -1, 3, -1)), "G dividing H"),
    (lambda q, k, v: (q, k, v[..., :32]), "q \\[B, S, H, D\\]"),
    (lambda q, k, v: (q, k.half(), v), "float32 or three bfloat16"),
])
def test_entry_checks_its_inputs(bad, match):
    q, k, v = _inputs(1, 8, 4, 2, 64, F32)
    with pytest.raises((ValueError, TypeError), match=match):
        fa.prefill_attention(*bad(q, k, v))


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------


def _shapes(B, S, H, G, D, Dv=None):
    return (B, S, H, D), (B, S, G, D), (B, S, G, D if Dv is None else Dv)


@pytest.mark.parametrize("device,dtype,shapes,route", [
    ("cuda", BF16, _shapes(16, 4070, 32, 2, 128), "kernel"),  # longprompt
    ("cuda", BF16, _shapes(64, 1018, 32, 2, 128), "kernel"),  # chat
    ("cuda", BF16, _shapes(1, 1, 8, 8, 64), "kernel"),        # MHA, S = 1
    ("cuda", BF16, _shapes(2, 300, 16, 1, 256), "kernel"),    # MQA, D 256
    ("cpu", BF16, _shapes(16, 4070, 32, 2, 128), "loop"),     # CPU tensors
    ("cuda", F32, _shapes(16, 4070, 32, 2, 128), "loop"),     # float32
    ("cuda", None, _shapes(2, 64, 8, 2, 128), "loop"),        # mixed dtypes
    ("cuda", BF16, _shapes(2, 64, 128, 128, 192, 128), "loop"),  # MLA
    ("cuda", BF16, _shapes(2, 64, 8, 2, 36), "loop"),         # D % 8 != 0
    ("cuda", BF16, _shapes(2, 64, 8, 2, 264), "loop"),        # D > 256
    ("cuda", BF16, _shapes(2, 64, 6, 4, 64), "loop"),         # G !| H
    ("meta", BF16, _shapes(2, 64, 8, 2, 64), "loop"),
], ids=["longprompt", "chat", "mha-s1", "mqa-d256", "cpu", "f32", "mixed",
        "mla", "d36", "d264", "g-not-dividing", "meta"])
def test_route_predicate(device, dtype, shapes, route):
    assert attn.prefill_route(device, dtype, *shapes) == route


def test_route_predicate_needs_q_and_kv_of_one_length():
    q, k, v = _shapes(2, 64, 8, 2, 64)
    assert attn.prefill_route("cuda", BF16, q, (2, 65, 2, 64), v) == "loop"
    assert attn.prefill_route("cuda", BF16, q, (2, 64, 2, 32), v) == "loop"


def _zoo_prefill_shapes():
    """(arch, q shape, k shape, v shape) of every config whose prefill runs
    `attention_prefill` or MLA, at B = 2, S = 512."""
    out = []
    for name in ARCH_IDS:
        cfg = get_config(name)
        if cfg.mla is not None:
            m = cfg.mla
            d = m.qk_nope_head_dim + m.qk_rope_head_dim
            out.append((name, (2, 512, cfg.num_heads, d),
                        (2, 512, cfg.num_heads, d),
                        (2, 512, cfg.num_heads, m.v_head_dim)))
        elif cfg.num_heads:
            hd = cfg.resolved_head_dim
            out.append((name, (2, 512, cfg.num_heads, hd),
                        (2, 512, cfg.num_kv_heads, hd),
                        (2, 512, cfg.num_kv_heads, hd)))
    return out


def test_every_zoo_prefill_but_mla_takes_the_kernel_on_a_card():
    """Every zoo head dim is a multiple of 8 and at most 256, and every
    kv-head count divides its head count, so every dense, GQA, sliding and
    local prefill takes the kernel at bf16 on a card; MLA (D != Dv) takes
    the loop."""
    seen = _zoo_prefill_shapes()
    assert len(seen) >= 6
    for name, q, k, v in seen:
        want = "loop" if get_config(name).mla is not None else "kernel"
        assert attn.prefill_route("cuda", BF16, q, k, v) == want, name


def _attention_params(cfg, seed=0):
    b = ParamBuilder(torch.Generator().manual_seed(seed), "float32")
    attn.init_attention(b.child("attn"), cfg)
    return b.params["attn"]


def _mla_params(cfg, seed=0):
    b = ParamBuilder(torch.Generator().manual_seed(seed), "float32")
    attn.init_mla(b.child("attn"), cfg)
    return b.params["attn"]


@pytest.fixture()
def kernel_spy(monkeypatch):
    """Every route picks the kernel, and the kernel is the loop on the
    CPU, recording each call: what a card would route, without a card."""
    calls = []

    def fake_kernel(q, k, v, causal=True, window=0):
        calls.append((tuple(q.shape), causal, window))
        kind = "sliding" if window else ("causal" if causal else "full")
        return _loop(q, k, v, kind, window)

    monkeypatch.setattr(attn, "prefill_route", lambda *a, **k: "kernel")
    monkeypatch.setattr(fa, "prefill_attention", fake_kernel)
    return calls


def test_attention_forward_and_mla_never_take_the_kernel(kernel_spy):
    """With the route set to the kernel, `attention_prefill` calls it once,
    with the config's mask; `attention_forward` (training, cross
    attention) and MLA's forward and prefill (`_mla_attend`) do not."""
    x = torch.randn(2, 24, get_smoke_config("glm4-9b").d_model)
    pos = torch.arange(24, dtype=torch.int32)
    cfg = get_smoke_config("glm4-9b")
    p = _attention_params(cfg)
    y, _ = attn.attention_prefill(p, cfg, x, pos, cache_len=32)
    assert kernel_spy == [((2, 24, cfg.num_heads, cfg.resolved_head_dim),
                           True, 0)]
    attn.attention_forward(p, cfg, x, pos)
    assert len(kernel_spy) == 1
    ds = get_smoke_config("deepseek-v3-671b")
    xd = torch.randn(2, 24, ds.d_model)
    pm = _mla_params(ds)
    attn.mla_forward(pm, ds, xd, pos)
    attn.mla_prefill(pm, ds, xd, pos, cache_len=32)
    assert len(kernel_spy) == 1


def test_sliding_prefill_passes_its_window(kernel_spy):
    cfg = get_smoke_config("glm4-9b")
    x = torch.randn(1, 20, cfg.d_model)
    pos = torch.arange(20, dtype=torch.int32)
    attn.attention_prefill(_attention_params(cfg), cfg, x, pos, 32,
                           kind="sliding", window=7)
    attn.attention_prefill(_attention_params(cfg), cfg, x, pos, 32,
                           kind="full", window=7)
    assert [c[1:] for c in kernel_spy] == [(True, 7), (False, 0)]


def test_prefill_attend_equals_the_loop_on_cpu():
    q, k, v = _inputs(2, 70, 8, 2, 64, F32, seed=2)
    for kind, window in (("causal", 0), ("sliding", 9), ("full", 0)):
        assert torch.equal(attn.prefill_attend(q, k, v, kind, window),
                           attn.blocked_attention(q, k, v, kind=kind,
                                                  window=window))


def _routes(reg):
    return {r: reg.counter("attn.prefill_route", route=r).value
            for r in ("kernel", "loop")}


def test_route_counter_counts_one_loop_a_call_on_cpu():
    cfg = get_smoke_config("glm4-9b")
    p = _attention_params(cfg)
    x = torch.randn(2, 16, cfg.d_model).to(BF16)
    pos = torch.arange(16, dtype=torch.int32)
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        for n in range(1, 4):
            attn.attention_prefill(p, cfg, x, pos, cache_len=16)
            assert _routes(reg) == {"kernel": 0.0, "loop": float(n)}
    finally:
        obs_metrics.pop_registry(reg)


@pytest.mark.parametrize("arch", ["glm4-9b", "deepseek-v3-671b"])
def test_route_counter_over_a_model_prefill(arch):
    """One `Model.prefill` on the CPU counts one `loop` for each
    `attention_prefill` layer, and none for MLA's."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 12), dtype=torch.int32)
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        model.prefill(params, {"tokens": tokens})
    finally:
        obs_metrics.pop_registry(reg)
    want = 0 if cfg.mla is not None else cfg.num_layers
    assert _routes(reg) == {"kernel": 0.0, "loop": float(want)}


# ---------------------------------------------------------------------------
# The plan, the binding and the launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S", [(16, 4070), (64, 1018)],
                         ids=["longprompt", "chat"])
def test_plan_at_the_benchmark_prefills(B, S):
    """glm4-9b's prefills: 128-row q and kv tiles, 3 stages in the 232,448
    bytes, one persistent CTA an SM, 32 or 8 kv tiles for the longest q
    tile."""
    p = fa.prefill_plan(B, S, 32, 2, 128, BF16, True, 0)
    assert (p.variant, p.q_tile, p.kv_tile, p.stages, p.ctas) == \
        ("wgmma", 128, 128, 3, fa.SMS)
    assert p.smem_bytes == fa._wgmma_smem(128, 128, 3, 128) <= fa.SMEM_LIMIT
    assert p.max_kv_tiles == -(-S // 128)


@pytest.mark.parametrize("D", [64, 80, 120, 128, 192, 256])
@pytest.mark.parametrize("B,H", [(1, 2), (16, 32)])
def test_plan_fits_every_zoo_head_dim(D, B, H):
    p = fa.prefill_plan(B, 1000, H, 2, D, BF16, True, 0)
    assert 2 <= p.stages <= fa.MAX_STAGES
    assert p.smem_bytes <= fa.SMEM_LIMIT
    assert p.ctas == min(B * H * -(-1000 // p.q_tile), fa.SMS)
    assert p.q_tile == (128 if B * H * -(-1000 // 128) >= fa.SMS else 64)


@pytest.mark.parametrize("args,match", [
    ((2, 64, 8, 2, 64, 64, F32), "reads bf16"),
    ((2, 64, 8, 2, 192, 128, BF16), "D == Dv"),
    ((2, 64, 8, 2, 36, 36, BF16), "D % 8"),
    ((2, 64, 8, 3, 64, 64, BF16), "G dividing"),
    ((0, 64, 8, 2, 64, 64, BF16), "B, S, H, G >= 1"),
])
def test_refusal_names_the_reason(args, match):
    assert re.search(match, fa.prefill_refusal(*args))
    B, S, H, G, D, _, dtype = args
    if args[4] == args[5]:
        with pytest.raises(ValueError, match=match):
            fa.prefill_plan(B, S, H, G, D, dtype, True, 0)


def test_binding_matches_the_c_entry_point(monkeypatch):
    """The ctypes argtypes of the prefill entry match its C parameters one
    by one (a pointer or a 64-bit stride passed as a 32-bit int would be
    cut)."""
    src = (build.CSRC_DIR / "flash_attention_wgmma.cu").read_text()
    sig = re.search(r'extern "C" cudaError_t repro_prefill_attention_wgmma'
                    r'\(([^)]*)\)', src, re.S)
    assert sig
    types_of = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
                "float": ctypes.c_float, "long long": ctypes.c_longlong}
    want = [types_of[p.rsplit(None, 1)[0].replace("const ", "").strip()]
            for p in sig.group(1).split(",")]
    fn = types.SimpleNamespace()
    monkeypatch.setattr(build, "load", lambda n: types.SimpleNamespace(
        repro_prefill_attention_wgmma=fn))
    assert fa._prefill_kernel.__wrapped__() is fn
    assert fn.argtypes == want and fn.restype is ctypes.c_int


def _fake_stream(monkeypatch):
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))


def test_launch_passes_the_strides_and_the_plan(monkeypatch):
    """q, k and v are read in place: the launch passes each one's (batch,
    row, head) strides in elements, then the plan's tiles, stages and
    CTAs, the mask and the scale."""
    calls = []
    monkeypatch.setattr(fa, "_prefill_kernel",
                        lambda: lambda *a: calls.append(a) or 0)
    _fake_stream(monkeypatch)
    q = torch.zeros(2, 300, 16, 128, dtype=BF16)
    kv = torch.zeros(2, 300, 2, 2, 128, dtype=BF16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    p = fa.prefill_plan(2, 300, 16, 2, 128, BF16, True, 64)
    fa._launch_prefill(q, k, v, torch.empty_like(q), p, True, 64, 0.125)
    (args,) = calls
    assert args[4:9] == (2, 300, 16, 2, 128)
    assert args[9:12] == (300 * 16 * 128, 16 * 128, 128)
    assert args[12:15] == args[15:18] == (300 * 512, 512, 128)
    assert args[18:] == (p.q_tile, p.kv_tile, p.stages, p.ctas, 1, 64,
                         0.125, 0)


def test_launch_error_raises_with_the_plan(monkeypatch):
    """No fallback: a refused launch raises, naming the plan."""
    monkeypatch.setattr(fa, "_prefill_kernel", lambda: lambda *a: 1)
    _fake_stream(monkeypatch)
    q, k, v = _inputs(1, 64, 4, 2, 64, BF16)
    p = fa.prefill_plan(1, 64, 4, 2, 64, BF16, True, 0)
    with pytest.raises(RuntimeError, match="prefill attention kernel launch "
                       "failed.*variant='wgmma'"):
        fa._launch_prefill(q, k, v, torch.empty_like(q), p, True, 0, 0.125)


def test_tma_ready_reads_views_in_place_and_copies_the_rest():
    kv = torch.zeros(2, 10, 2, 4, 64, dtype=BF16)
    k = kv[:, :, 0]
    assert fa._tma_ready(k) is k                    # strides of 8 elements
    odd = torch.zeros(2, 10, 4, 68, dtype=BF16)[..., :60]
    assert not odd.is_contiguous()
    fixed = fa._tma_ready(odd)                       # strides of 68
    assert fixed.is_contiguous() and torch.equal(fixed, odd)
    t = torch.zeros(2, 10, 4, 64, dtype=BF16).transpose(1, 2)
    assert fa._tma_ready(t) is t                     # any order of dims
    last = torch.zeros(2, 10, 64, 4, dtype=BF16).transpose(2, 3)
    assert fa._tma_ready(last).is_contiguous()       # D not contiguous
    flat = torch.zeros(2 * 10 * 4 * 64 + 1, dtype=BF16)[1:]
    shifted = flat.view(2, 10, 4, 64)                # a 2-byte offset
    assert shifted.data_ptr() % 16 != 0
    assert fa._tma_ready(shifted).data_ptr() % 16 == 0


def test_cpu_tensors_count_no_launch():
    before = fa.prefill_attention.launches
    fa.prefill_attention(*_inputs(1, 8, 4, 2, 64, BF16))
    assert fa.prefill_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,G,D,causal,window", [
    (2, 600, 16, 4, 128, True, 0), (2, 257, 8, 2, 256, True, 100),
    (3, 130, 4, 4, 64, False, 0)], ids=["gqa", "d256-window", "mha-full"])
def test_cuda_kernel_matches_plain(B, S, H, G, D, causal, window):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (t.to("cuda") for t in _inputs(B, S, H, G, D, BF16, seed=9))
    before = fa.prefill_attention.launches
    got = fa.prefill_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.prefill_attention.launches == before + 1
    want = fa.prefill_attention_plain(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=3e-2,
                               atol=3e-2)


def test_chip_smoke_prefill_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's prefill phases on the CPU, where the entry takes its
    plain version (no launch) and the route is the loop: the check's 29
    cases run and agree, and one prefill of glm4-9b's smoke config counts
    one `loop` a layer."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    import repro_torch.configs as configs
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    out = chip_smoke.prefill_attention_check(fa, "cpu")
    assert (out["cases"], out["launches"], out["max_abs_err"]) == (29, 0, 0.0)
    monkeypatch.setattr(configs, "get_config", get_smoke_config)
    route = chip_smoke.prefill_route_share("cpu", batch=2, prompt=16)
    layers = get_smoke_config("glm4-9b").num_layers
    assert route["routes"] == {"kernel": 0.0, "loop": float(layers)}
    assert route["launches"] == 0 and route["finite"]


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_band_check_sits_between_sound_and_a_dropped_tile():
    """chip_smoke.py's band check of the prefill kernel: 0 for the plain
    version against itself, well under its limit for the same attention
    with P left unrounded (another rounding of a sound kernel), and far
    above it where one kv tile is dropped from half the rows of two heads
    (`planted_fault`), which `check_prefill` refuses."""
    cs = _chip_smoke()
    q, k, v = _inputs(1, 700, 4, 2, 64, BF16, seed=11)
    want = fa.prefill_attention_plain(q, k, v)
    assert cs.band_rel_err(want, want) == 0.0
    S, pos = 700, torch.arange(700)
    dense = want.clone()
    for h in range(4):
        s = q[0, :, h].float() @ k[0, :, h // 2].float().T / 8.0
        p = torch.softmax(s.masked_fill(pos[None] > pos[:, None],
                                        float("-inf")), dim=-1)
        dense[0, :, h] = (p @ v[0, :, h // 2].float()).to(BF16)
    sound = cs.band_rel_err(dense, want)
    fault = cs.band_rel_err(cs.planted_fault(q, k, v, want), want)
    assert 0 < sound < cs.PREFILL_REL_TOL / 2 < 5 * cs.PREFILL_REL_TOL < fault
    cs.check_prefill(dense, want, "sound")
    with pytest.raises(AssertionError, match="fault"):
        cs.check_prefill(cs.planted_fault(q, k, v, want), want, "fault")


def test_chip_smoke_band_check_flags_a_zero_band_made_nonzero():
    cs = _chip_smoke()
    want = torch.zeros(1, 200, 2, 8)
    got = want.clone()
    assert cs.band_rel_err(got, want) == 0.0
    got[0, 150, 1, 3] = 1e-3
    assert cs.band_rel_err(got, want) == float("inf")


def _dist_env():
    import os
    from pathlib import Path
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"),
               OMP_NUM_THREADS="1")
    return env


def test_prefill_entry_on_four_ranks_shards(tmp_path):
    """`sharding.on_shards` runs the prefill entry on each of four gloo
    ranks' shards (tests/_torch_prefill_mesh_worker.py), as `prefill_attend`
    does under a mesh: with 2 kv heads each rank takes its one group of k
    and v, with 4 its own kv head, with 1 the one; the gathered output
    equals the entry on the whole inputs (within the float32 sums' order,
    a bf16 rounding at most)."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    worker = Path(__file__).resolve().parent / "_torch_prefill_mesh_worker.py"
    init, out = tmp_path / "rendezvous", tmp_path / "out.json"
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), "4",
                               str(init), str(out)], env=_dist_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errs[0][-3000:]
    got = json.loads(out.read_text())
    assert set(got) == {"group_of_2", "heads_sharded", "one_kv_head"}
    for name, case in got.items():
        assert case["band_rel_err"] < 1e-2, (name, case)
        assert case["launches"] == 0, (name, case)


_MESH_REHEARSAL = r"""
import json, sys, tempfile
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import chip_smoke
import repro_torch.configs as configs
from repro_torch.models import attention
configs.get_config = configs.get_smoke_config
attention.prefill_route = lambda *a: "kernel"
with tempfile.TemporaryDirectory() as tmp:
    out = chip_smoke.prefill_mesh("cpu", tmp, prompt=40)
print("PREFILL_MESH", json.dumps(out, default=str))
"""


def test_chip_smoke_prefill_mesh_rehearses_on_cpu():
    """chip_smoke.py's `prefill_mesh` at glm4-9b's smoke size on a one-rank
    gloo group (a subprocess: the phase joins and leaves a process group),
    with the route set to the kernel as on a card: both prefills call the
    entry (its plain version on the CPU) once a layer, the meshed one on
    the DTensors' local shards, and their logits agree."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c",
                          _MESH_REHEARSAL.format(root=str(root))],
                         env=_dist_env(), capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.split("PREFILL_MESH ", 1)[1])
    layers = get_smoke_config("glm4-9b").num_layers
    assert (line["backend"], line["mesh"]) == ("gloo",
                                               {"data": 1, "model": 1})
    for side in ("plain", "meshed"):
        assert line[f"{side}_routes"] == {"kernel": float(layers),
                                          "loop": 0.0}
        assert line[f"{side}_launches"] == 0
    assert line["logits_row_rel_err"] <= 1e-2
