"""The port's LM zoo (`repro_torch.models`) against the reference's
(`repro.models`) on the CPU: the same numpy inputs, and the reference's
params carried over with `convert.model_params`.

Tolerances:
  * float32 activations: |err| <= 1e-4 * max|ref| + 1e-4 * |ref|; the two
    differ only in summation order (blocked attention's einsums, the log-
    step scan vs `associative_scan`, the conv taps);
  * bf16 activations: |err| <= 3e-2 * max|ref|, the reference's own bf16
    tolerance: the frameworks round bf16 products and GELU at other points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import recurrent as j_rec  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import recurrent as t_rec  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

PORTED = ("recurrentgemma-2b", "h2o-danube-1.8b", "h2o-danube-3-4b",
          "glm4-9b", "deepseek-67b")
UNPORTED = tuple(a for a in ARCH_IDS if a not in PORTED)


def close(got, ref, dtype="float32", what=""):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    top = float(np.abs(ref).max())
    err = np.abs(got - ref)
    if dtype == "float32":
        ok = err <= 1e-4 * top + 1e-4 * np.abs(ref)
    else:
        ok = err <= 3e-2 * top
    assert ok.all(), f"{what}: max err {err.max()} at max|ref| {top}"


def tt(x, dtype=None):
    t = torch.as_tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def jt(x, dtype=None):
    a = jnp.asarray(np.asarray(x))
    return a if dtype is None else a.astype(dtype)


def flat(tree, prefix=""):
    """{key path: leaf} of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,window,q_offset,kv_len,chunk,H,G", [
    ("causal", 0, 0, None, 512, 4, 4),      # one chunk, MHA
    ("causal", 0, 0, None, 8, 4, 1),        # chunk padding (20 = 2x8 + 4), MQA
    ("sliding", 6, 0, None, 8, 4, 2),       # window skips chunk pairs, GQA
    ("full", 0, 0, 15, 8, 6, 2),            # padded kv masked by kv_len
    ("causal", 0, 12, None, 8, 4, 2),       # q_offset: queries after kv start
    ("sliding", 5, 12, 18, 4, 4, 1),
])
def test_blocked_attention(kind, window, q_offset, kv_len, chunk, H, G):
    rng = np.random.RandomState(0)
    B, S, D = 2, 20, 16
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, G, D).astype(np.float32)
    v = rng.randn(B, S, G, D).astype(np.float32)
    kw = dict(kind=kind, window=window, q_offset=q_offset, chunk_q=chunk,
              chunk_kv=chunk, kv_len=kv_len)
    for dtype in ("float32", "bfloat16"):
        ref = j_attn.blocked_attention(jt(q, dtype), jt(k, dtype),
                                       jt(v, dtype), **kw)
        got = t_attn.blocked_attention(
            tt(q, t_common.dtype_of(dtype)), tt(k, t_common.dtype_of(dtype)),
            tt(v, t_common.dtype_of(dtype)), **kw)
        assert got.dtype == t_common.dtype_of(dtype)
        close(got, ref.astype(jnp.float32), dtype, f"{kw} {dtype}")


@pytest.mark.parametrize("nq,nkv,cq,ckv,kind,window,q_offset", [
    (4, 4, 8, 8, "causal", 0, 0), (5, 5, 4, 4, "sliding", 6, 0),
    (3, 6, 8, 4, "full", 0, 0), (2, 5, 8, 8, "sliding", 9, 16),
    (1, 1, 1, 1, "causal", 0, 0)])
def test_chunk_pairs(nq, nkv, cq, ckv, kind, window, q_offset):
    got = t_attn.chunk_pairs(nq, nkv, cq, ckv, kind, window, q_offset)
    want = j_attn.chunk_pairs(nq, nkv, cq, ckv, kind, window, q_offset)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attend(window):
    rng = np.random.RandomState(1)
    B, Sc, H, G, D = 3, 10, 4, 2, 16
    q = rng.randn(B, H, D).astype(np.float32)
    kc = rng.randn(B, Sc, G, D).astype(np.float32)
    vc = rng.randn(B, Sc, G, D).astype(np.float32)
    pos = np.tile(np.arange(Sc, dtype=np.int32), (B, 1))
    pos[0, 7:] = -1                      # empty slots
    pos[2] = np.roll(pos[2] + 10, 3)     # a wrapped ring
    cur = np.array([6, 9, 19], np.int32)
    for dtype in ("float32", "bfloat16"):
        td = t_common.dtype_of(dtype)
        ref = j_attn.decode_attend(jt(q, dtype), jt(kc, dtype), jt(vc, dtype),
                                   jt(pos), jt(cur), window=window)
        got = t_attn.decode_attend(tt(q, td), tt(kc, td), tt(vc, td), tt(pos),
                                   tt(cur), window=window)
        close(got, ref.astype(jnp.float32), dtype, f"decode {dtype}")


def test_apply_rope():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    for positions in (np.arange(7, dtype=np.int32),
                      np.array([[5], [9]], np.int32)):
        xx = x if positions.ndim == 1 else x[:, :1]
        ref = j_common.apply_rope(jt(xx), jt(positions), 10000.0)
        got = t_common.apply_rope(tt(xx), tt(positions), 10000.0)
        close(got, ref, "float32", "rope")


def test_sinusoidal_positions():
    ref = j_common.sinusoidal_positions(9, 16)
    got = t_common.sinusoidal_positions(9, 16)
    close(got, ref, "float32", "sinusoidal positions")


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(kind, dtype):
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 32) * 3).astype(np.float32)
    p = {"scale": rng.rand(32).astype(np.float32) + 0.5,
         "bias": rng.randn(32).astype(np.float32)}
    ref = j_common.apply_norm({k: jt(v) for k, v in p.items()},
                              jt(x, dtype), kind)
    got = t_common.apply_norm({k: tt(v) for k, v in p.items()},
                              tt(x, t_common.dtype_of(dtype)), kind)
    assert got.dtype == t_common.dtype_of(dtype)
    close(got, ref.astype(jnp.float32), dtype, f"{kind} {dtype}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_causal_and_decode(dtype):
    rng = np.random.RandomState(4)
    B, S, C, W = 2, 9, 12, 4
    x = rng.randn(B, S, C).astype(np.float32)
    p = {"w": rng.randn(W, C).astype(np.float32) / W,
         "bias": rng.randn(C).astype(np.float32)}
    jp = {k: jt(v) for k, v in p.items()}
    tp = {k: tt(v) for k, v in p.items()}
    td = t_common.dtype_of(dtype)
    ref = j_rec.conv1d_causal(jp, jt(x, dtype))
    got = t_rec.conv1d_causal(tp, tt(x, td))
    close(got, ref.astype(jnp.float32), dtype, "conv1d_causal")
    state = rng.randn(B, W - 1, C).astype(np.float32)
    ry, rs = j_rec.conv1d_decode(jp, jt(x[:, 0], dtype), jt(state, dtype))
    gy, gs = t_rec.conv1d_decode(tp, tt(x[:, 0], td), tt(state, td))
    close(gy, ry.astype(jnp.float32), dtype, "conv1d_decode")
    close(gs, rs.astype(jnp.float32), dtype, "conv1d_decode state")
    # decode, step by step from a zero state, is the causal conv
    st = torch.zeros((B, W - 1, C), dtype=td)
    for t in range(S):
        y, st = t_rec.conv1d_decode(tp, tt(x[:, t], td), st)
        assert torch.equal(y, got[:, t])


def _lru_params(rng, C):
    return {"w_a": rng.randn(C, C).astype(np.float32) / np.sqrt(C),
            "b_a": rng.randn(C).astype(np.float32) * 0.1,
            "w_x": rng.randn(C, C).astype(np.float32) / np.sqrt(C),
            "b_x": rng.randn(C).astype(np.float32) * 0.1,
            "lambda_raw": rng.randn(C).astype(np.float32) * 0.5 + 1.0}


def test_rg_lru_forward_matches_reference_and_step_loop():
    rng = np.random.RandomState(5)
    B, S, C = 2, 37, 16
    p = _lru_params(rng, C)
    y = rng.randn(B, S, C).astype(np.float32)
    h0 = rng.randn(B, C).astype(np.float32)
    tp = {k: tt(v) for k, v in p.items()}
    ref = j_rec.rg_lru_forward({k: jt(v) for k, v in p.items()}, jt(y),
                               h0=jt(h0))
    got = t_rec.rg_lru_forward(tp, tt(y), h0=tt(h0))
    close(got, ref, "float32", "rg_lru_forward")
    h = tt(h0)
    for t in range(S):
        out, h = t_rec.rg_lru_step(tp, tt(y[:, t]), h)
        close(out, got[:, t].numpy(), "float32", f"step {t}")


def test_linear_scan_matches_sequential():
    rng = np.random.RandomState(6)
    for S in (1, 2, 5, 64, 100):
        a = torch.as_tensor(rng.rand(2, S, 8).astype(np.float32) * 0.98)
        x = torch.as_tensor(rng.randn(2, S, 8).astype(np.float32))
        a_c, h = t_rec.linear_scan(a, x)
        hs, acc, prod = [], torch.zeros(2, 8), torch.ones(2, 8)
        for t in range(S):
            acc = a[:, t] * acc + x[:, t]
            prod = prod * a[:, t]
            hs.append(acc)
        close(h, torch.stack(hs, 1).numpy(), "float32", f"h S={S}")
        close(a_c, torch.stack([torch.cumprod(a, 1)[:, t]
                                for t in range(S)], 1).numpy(),
              "float32", f"prod S={S}")


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

# (arch, scan_layers, num_layers or None for the smoke config's): 5
# RecurrentGemma layers stack one group and leave a suffix of 2
MODEL_CASES = [(arch, scan, None) for arch in ("recurrentgemma-2b",
                                               "h2o-danube-1.8b")
               for scan in (False, True)] + [("recurrentgemma-2b", True, 5)]


def _smoke(get, arch, scan, layers=None, **kw):
    cfg = get(arch).replace(scan_layers=scan, **kw)
    return cfg if layers is None else cfg.replace(num_layers=layers)


@pytest.fixture(scope="module")
def jax_params():
    """Reference params per (arch, scan_layers, num_layers), built once."""
    cache = {}

    def get(arch, scan, layers=None):
        if (arch, scan, layers) not in cache:
            cfg = _smoke(j_smoke, arch, scan, layers)
            cache[arch, scan, layers] = jax.tree.map(
                np.asarray, j_build(cfg).init(jax.random.PRNGKey(0)))
        return cache[arch, scan, layers]
    return get


class Jitted:
    """The reference model's entry points under jax.jit (eager dispatch of
    its scans is many times slower on the CPU)."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.forward = jax.jit(model.forward)
        self.prefill = jax.jit(model.prefill, static_argnames="max_len")
        self.decode_step = jax.jit(model.decode_step)


def _models(arch, scan, dtype, layers=None):
    jcfg = _smoke(j_smoke, arch, scan, layers, activation_dtype=dtype)
    tcfg = _smoke(t_smoke, arch, scan, layers, activation_dtype=dtype)
    return Jitted(j_build(jcfg)), t_build(tcfg)


@pytest.mark.parametrize("arch,scan,layers", MODEL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_parity(jax_params, arch, scan, layers, dtype):
    """forward, prefill (state and logits) and 4 decode steps."""
    jm, tm = _models(arch, scan, dtype, layers)
    jp = jax_params(arch, scan, layers)
    tp = convert.model_params(jp, "cpu")
    B, S, P = 2, 12, 8
    toks = np.random.RandomState(7).randint(
        0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    ref, _ = jm.forward(jp, {"tokens": jt(toks)})
    got, aux = tm.forward(tp, {"tokens": tt(toks)})
    close(got, ref, dtype, "forward")
    assert float(aux) == 0.0
    js, jl = jm.prefill(jp, {"tokens": jt(toks[:, :P])}, max_len=S)
    ts, tl = tm.prefill(tp, {"tokens": tt(toks[:, :P])}, max_len=S)
    close(tl, jl, dtype, "prefill logits")
    jflat, tflat = flat(js), flat(ts)
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        if key.endswith("pos") or key.endswith("cur"):
            np.testing.assert_array_equal(tflat[key].numpy(), want)
        else:
            close(tflat[key], jnp.asarray(want).astype(jnp.float32),
                  dtype, f"prefill state {key}")
    for s in range(P, S):
        js, jl = jm.decode_step(jp, js, jt(toks[:, s]))
        ts, tl = tm.decode_step(tp, ts, tt(toks[:, s]))
        close(tl, jl, dtype, f"decode step at {s}")
    np.testing.assert_array_equal(ts["cur"].numpy(), np.asarray(js["cur"]))


def test_ring_cache_diverges_alike_in_both_packages(jax_params):
    """A reference property, reproduced: with S > Sc and S % Sc != 0 the
    prefill leaves positions S-Sc .. S-1 at slots 0 .. Sc-1, but decode
    writes position S at slot S % Sc, overwriting position S-Sc+S%Sc, which
    is still in the window. So decode's logits are not forward's, in both
    packages, and by the same amount."""
    jm, tm = _models("recurrentgemma-2b", False, "float32")
    assert jm.cfg.local_window == 16
    jp = jax_params("recurrentgemma-2b", False)
    tp = convert.model_params(jp, "cpu")
    S = 20  # > Sc = 16, S % Sc = 4
    toks = np.random.RandomState(8).randint(
        0, jm.cfg.vocab_size, (1, S + 1)).astype(np.int32)
    jfwd, _ = jm.forward(jp, {"tokens": jt(toks)})
    tfwd, _ = tm.forward(tp, {"tokens": tt(toks)})
    js, _ = jm.prefill(jp, {"tokens": jt(toks[:, :S])}, max_len=S + 1)
    ts, _ = tm.prefill(tp, {"tokens": tt(toks[:, :S])}, max_len=S + 1)
    assert js["layers"]["prefix"]["l2"]["k"].shape[1] == 16
    _, jl = jm.decode_step(jp, js, jt(toks[:, S]))
    _, tl = tm.decode_step(tp, ts, tt(toks[:, S]))
    top = float(np.abs(np.asarray(jfwd[:, S])).max())
    j_gap = float(np.abs(np.asarray(jl) - np.asarray(jfwd[:, S])).max())
    t_gap = float(np.abs(tl.numpy() - tfwd[:, S].numpy()).max())
    # ten times the 1e-4 * max|ref| of the agreement tolerance
    assert j_gap > 1e-3 * top and t_gap > 1e-3 * top, (j_gap, t_gap, top)
    close(tl, jl, "float32", "decode after the ring wraps")


def test_ring_cache_exact_when_prompt_fills_it(jax_params):
    """S == Sc: decode overwrites slot 0, position 0, which has just left
    the window, so decode's logits are forward's."""
    _, tm = _models("recurrentgemma-2b", False, "float32")
    tp = convert.model_params(jax_params("recurrentgemma-2b", False), "cpu")
    S = 16
    toks = tt(np.random.RandomState(9).randint(
        0, tm.cfg.vocab_size, (1, S + 3)).astype(np.int32))
    fwd, _ = tm.forward(tp, {"tokens": toks})
    st, lg = tm.prefill(tp, {"tokens": toks[:, :S]}, max_len=S + 3)
    close(lg, fwd[:, S - 1].numpy(), "float32", "prefill")
    for s in range(S, S + 3):
        st, lg = tm.decode_step(tp, st, toks[:, s])
        close(lg, fwd[:, s].numpy(), "float32", f"decode at {s}")


def test_cast_params_gives_identical_results(jax_params):
    """The engine's cast-once tree computes the same bits as casting on
    every call; norm params and lambda_raw stay float32."""
    _, tm = _models("recurrentgemma-2b", True, "bfloat16")
    tp = convert.model_params(jax_params("recurrentgemma-2b", True), "cpu")
    cast = tm.cast_params(tp)
    assert cast["embed"].dtype == torch.bfloat16
    grp = cast["stack"]["groups"]
    assert grp["b0"]["ln_rec"]["scale"].dtype == torch.float32
    assert grp["b0"]["rec"]["lru"]["lambda_raw"].dtype == torch.float32
    assert grp["b2"]["attn"]["wq"].dtype == torch.bfloat16
    assert cast["final_norm"]["scale"] is tp["final_norm"]["scale"]
    toks = tt(np.random.RandomState(10).randint(
        0, tm.cfg.vocab_size, (2, 9)).astype(np.int32))
    a, _ = tm.forward(tp, {"tokens": toks})
    b, _ = tm.forward(cast, {"tokens": toks})
    assert torch.equal(a, b)
    sa, la = tm.prefill(tp, {"tokens": toks[:, :6]})
    sb, lb = tm.prefill(cast, {"tokens": toks[:, :6]})
    assert torch.equal(la, lb)
    _, la = tm.decode_step(tp, sa, toks[:, 6])
    _, lb = tm.decode_step(cast, sb, toks[:, 6])
    assert torch.equal(la, lb)
    # float32 activations: nothing is copied
    _, tm32 = _models("recurrentgemma-2b", True, "float32")
    assert tm32.cast_params(tp)["embed"] is tp["embed"]


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("scan", [False, True])
def test_param_tree_matches_reference_at_full_size(arch, scan):
    """Key paths, shapes and dtypes of the full-size params (meta tensors,
    nothing allocated) equal the reference's abstract tree, stacked groups
    included."""
    jabs, jaxes = j_build(j_get_config(arch).replace(
        scan_layers=scan)).abstract_params_and_axes()
    tcfg = t_get_config(arch).replace(scan_layers=scan)
    tabs, taxes = t_build(tcfg).abstract_params_and_axes()
    jflat, tflat = flat(jabs), flat(tabs)
    # (jax.tree.map, which stacks the reference's groups, sorts dict keys)
    assert sorted(jflat) == sorted(tflat)
    for key, leaf in jflat.items():
        assert tflat[key].device.type == "meta"
        assert tuple(tflat[key].shape) == tuple(leaf.shape), key
        assert str(tflat[key].dtype).split(".")[1] == str(leaf.dtype), key
    assert sum(t.numel() for t in tree_leaves(tabs)) == sum(
        int(np.prod(leaf.shape)) for leaf in jflat.values())
    jax_axes = jax.tree_util.tree_flatten_with_path(
        jaxes, is_leaf=lambda x: isinstance(x, tuple))[0]
    assert len(jax_axes) == len(flat(taxes))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "h2o-danube-1.8b"])
def test_init_is_seeded_and_fan_in_scaled(arch):
    cfg = t_smoke(arch)
    m = t_build(cfg)
    a, b = m.init(3, "cpu"), m.init(3, "cpu")
    c = m.init(4, "cpu")
    fa, fb, fc = flat(a), flat(b), flat(c)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert any(not torch.equal(fa[k], fc[k]) for k in fa)
    wq = fa["/stack/prefix/l0/attn/wq"] if arch != "recurrentgemma-2b" \
        else fa["/stack/prefix/l2/attn/wq"]
    d, H, _ = wq.shape
    # fan-in of a [d, H, hd] kernel is d * H, as in the reference
    assert abs(float(wq.std()) * np.sqrt(d * H) - 1.0) < 0.1


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_configs_raise(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        t_build(t_smoke(arch))


@pytest.mark.parametrize("kind", ["moe_attention", "cross_attention",
                                  "encdec_attention", "encoder_attention",
                                  "mlstm", "slstm"])
def test_unported_block_kinds_raise(kind):
    cfg = t_smoke("h2o-danube-1.8b")
    b = t_common.ParamBuilder(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        t_tfm.init_block(b, cfg, kind)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        t_tfm.block_forward({}, cfg, kind, torch.zeros(1, 1, 8),
                            torch.arange(1))
