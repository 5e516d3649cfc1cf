"""The rest of the port's LM zoo (MoE, MLA, xLSTM, cross attention, the
whisper encoder) against the reference on the CPU: the same numpy inputs,
and the reference's params carried over with `convert.model_params`.

Tolerances, as in tests/test_torch_models.py:
  * float32 activations: |err| <= 1e-4 * max|ref| + 1e-4 * |ref|;
  * bf16 activations: |err| <= 3e-2 * max|ref|.
MoE configs run at capacity_factor 8, as the reference's own decode test
does, so no token drops; one float32 model case keeps dbrx's default 1.25,
and test_default_capacity_drops_the_same_tokens makes the tokens overflow
their experts at 1.25, where both packages must drop the same ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import xlstm as j_xl  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import xlstm as t_xl  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

NEW_ARCHS = ("xlstm-350m", "whisper-tiny", "dbrx-132b", "deepseek-v3-671b",
             "llama-3.2-vision-90b")


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
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _cfg(get, arch, scan=False, dtype="float32", cf=8.0):
    cfg = get(arch).replace(scan_layers=scan, activation_dtype=dtype)
    if cfg.moe is not None and cf is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
    return cfg


def _extra_batch(cfg, B, seed=7):
    """The stub frontend's inputs, as `launch.serve` draws them."""
    return t_launch.extra_batch(cfg, B, np.random.RandomState(seed))


class Jitted:
    """The reference model's entry points under jax.jit."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.forward = jax.jit(model.forward)
        self.prefill = jax.jit(model.prefill, static_argnames="max_len")
        self.decode_step = jax.jit(model.decode_step)


@pytest.fixture(scope="module")
def jax_params():
    """Reference params per (arch, scan_layers), built once."""
    cache = {}

    def get(arch, scan):
        if (arch, scan) not in cache:
            cache[arch, scan] = jax.tree.map(np.asarray, j_build(
                _cfg(j_smoke, arch, scan)).init(jax.random.PRNGKey(0)))
        return cache[arch, scan]
    return get


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

# (arch, scan_layers, capacity factor, activation dtype)
MODEL_CASES = ([(a, scan, 8.0, dt) for a in NEW_ARCHS for scan in (False, True)
                for dt in ("float32", "bfloat16")]
               + [("dbrx-132b", False, 1.25, "float32")])


@pytest.mark.parametrize("arch,scan,cf,dtype", MODEL_CASES)
def test_model_parity(jax_params, arch, scan, cf, dtype):
    """forward (logits and aux), prefill (state and logits) and 4 decode
    steps."""
    jm = Jitted(j_build(_cfg(j_smoke, arch, scan, dtype, cf)))
    tm = t_build(_cfg(t_smoke, arch, scan, dtype, cf))
    jp = jax_params(arch, scan)
    tp = convert.model_params(jp, "cpu")
    B, S, P = 2, 12, 8
    toks = np.random.RandomState(7).randint(
        0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    extra = _extra_batch(tm.cfg, B)

    def jbatch(t):
        return {"tokens": jt(t), **{k: jt(v) for k, v in extra.items()}}

    def tbatch(t):
        return {"tokens": tt(t), **{k: tt(v) for k, v in extra.items()}}

    ref, jaux = jm.forward(jp, jbatch(toks))
    got, taux = tm.forward(tp, tbatch(toks))
    close(got, ref, dtype, "forward")
    assert taux.dtype == torch.float32 and taux.shape == ()
    if tm.cfg.moe is None:
        assert float(taux) == 0.0 == float(jaux)
    else:
        # the router runs in float32 on inputs that agree within the
        # activation dtype's tolerance
        assert float(jaux) > 0.0
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5
                                   if dtype == "float32" else 3e-2)
    js, jl = jm.prefill(jp, jbatch(toks[:, :P]), max_len=S)
    ts, tl = tm.prefill(tp, tbatch(toks[:, :P]), max_len=S)
    close(tl, jl, dtype, "prefill logits")
    jflat, tflat = flat(js), flat(ts)
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        if key.endswith("pos") or key.endswith("cur"):
            np.testing.assert_array_equal(tflat[key].numpy(), want)
        else:
            assert tflat[key].dtype == getattr(
                torch, str(want.dtype)), key
            close(tflat[key], jnp.asarray(want).astype(jnp.float32),
                  dtype, f"prefill state {key}")
    for s in range(P, S):
        js, jl = jm.decode_step(jp, js, jt(toks[:, s]))
        ts, tl = tm.decode_step(tp, ts, tt(toks[:, s]))
        close(tl, jl, dtype, f"decode step at {s}")
    np.testing.assert_array_equal(ts["cur"].numpy(), np.asarray(js["cur"]))


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_default_capacity_drops_the_same_tokens(arch):
    """At the default capacity factor (1.25) tokens that share a direction
    all pick the same experts, overflow their C rows and drop: the scatter
    path then departs from the dense oracle, by the same amount in both
    packages."""
    p = _moe_params(arch)
    tcfg = _cfg(t_smoke, arch, cf=1.25)
    rng = np.random.RandomState(3)
    x = (rng.randn(1, 1, tcfg.d_model) * 2
         + rng.randn(2, 12, tcfg.d_model) * 0.1).astype(np.float32)
    tp = {k: tt(v) for k, v in p.items()}
    _, idx, _ = t_moe._router(tp, tcfg, tt(x).reshape(24, -1))
    assert int(torch.bincount(idx.reshape(-1)).max()) > t_moe.capacity(
        tcfg, 24)
    ys, aux = t_moe.moe_forward(tp, tcfg, tt(x), "scatter")
    yd, _ = t_moe.moe_forward(tp, tcfg, tt(x), "dense_mask")
    assert float((ys - yd).abs().max()) > 1e-2 * float(yd.abs().max())
    ref, jaux = j_moe.moe_forward({k: jt(v) for k, v in p.items()},
                                  _cfg(j_smoke, arch, cf=1.25), jt(x),
                                  "scatter")
    close(ys, ref, "float32", "scatter with drops")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_decode_step_drops_extras(jax_params):
    """The blocks read `state["extras"]` (here the mLSTM chunk and the MoE
    dispatch) and the returned state drops it, as the reference's does."""
    extras = {"moe_impl": "dense_mask", "chunk": 4}
    for arch in ("dbrx-132b", "xlstm-350m"):
        jm = j_build(_cfg(j_smoke, arch))
        tm = t_build(_cfg(t_smoke, arch))
        jp = jax_params(arch, False)
        tp = convert.model_params(jp, "cpu")
        toks = np.arange(1, 7, dtype=np.int32)[None]
        js, _ = jax.jit(jm.prefill)(jp, {"tokens": jt(toks)})
        ts, _ = tm.prefill(tp, {"tokens": tt(toks)})
        # the extras are closed over: jit takes no strings
        js2, jl = jax.jit(lambda p, s, t: jm.decode_step(
            p, {**s, "extras": extras}, t))(jp, js, jt(toks[:, 0]))
        ts2, tl = tm.decode_step(tp, {**ts, "extras": extras},
                                 tt(toks[:, 0]))
        assert "extras" not in js2 and "extras" not in ts2
        assert sorted(ts2) == sorted(js2) == ["cur", "layers"]
        close(tl, jl, "float32", f"{arch} decode with extras")


def test_moe_impl_expert_parallel_raises():
    """moe_impl="expert_parallel" no longer raises: without hints (no
    mesh) it falls to the scatter path, as in the reference, bit for bit;
    an unknown impl still raises."""
    cfg = _cfg(t_smoke, "dbrx-132b")
    p = t_build(cfg).init(0, "cpu")["stack"]["prefix"]["l0"]["moe"]
    x = torch.randn(2, 5, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    ep, ep_aux = t_moe.moe_forward(p, cfg, x, "expert_parallel")
    sc, sc_aux = t_moe.moe_forward(p, cfg, x, "scatter")
    assert torch.equal(ep, sc) and torch.equal(ep_aux, sc_aux)
    with pytest.raises(ValueError):
        t_moe.moe_forward(p, cfg, x, "no_such_impl")


def test_whisper_positions_are_sinusoidal_and_xlstm_has_none():
    for arch, moves in (("whisper-tiny", True), ("xlstm-350m", False)):
        m = t_build(_cfg(t_smoke, arch))
        p = m.init(0, "cpu")
        tok = torch.tensor([[5, 5]])
        x = m._embed(p, tok)
        assert (not torch.equal(x[0, 0], x[0, 1])) == moves, arch
        # decode's [B, 1] positions give the row forward gives position 1
        x1 = m._embed(p, tok[:, :1], positions=torch.tensor([[1]]))
        assert torch.equal(x1[0, 0], x[0, 1])


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _moe_params(arch, seed=0):
    cfg = _cfg(j_smoke, arch)
    rng = np.random.RandomState(seed)
    mo, d = cfg.moe, cfg.d_model
    ff, E = mo.d_ff_expert, mo.num_experts
    p = {"router": rng.randn(d, E) / np.sqrt(d),
         "wi": rng.randn(E, d, ff) / np.sqrt(d),
         "wg": rng.randn(E, d, ff) / np.sqrt(d),
         "wo": rng.randn(E, ff, d) / np.sqrt(ff)}
    if mo.num_shared_experts:
        fs = (mo.d_ff_shared or ff) * mo.num_shared_experts
        p.update(shared_wi=rng.randn(d, fs) / np.sqrt(d),
                 shared_wg=rng.randn(d, fs) / np.sqrt(d),
                 shared_wo=rng.randn(fs, d) / np.sqrt(fs))
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_scatter_matches_dense_oracle_and_reference(arch, dtype):
    """The mirror of tests/test_models.py's scatter-vs-dense test, and each
    of the two, with its aux, against the reference's."""
    p = _moe_params(arch)
    cfg = _cfg(t_smoke, arch, dtype=dtype)
    x = (np.random.RandomState(1).randn(2, 16, cfg.d_model) * 0.5).astype(
        np.float32)
    td = getattr(torch, dtype)
    tp = {k: tt(v) for k, v in p.items()}
    jp = {k: jt(v) for k, v in p.items()}
    ys, aux_s = t_moe.moe_forward(tp, cfg, tt(x, td), "scatter")
    yd, aux_d = t_moe.moe_forward(tp, cfg, tt(x, td), "dense_mask")
    assert ys.dtype == td and aux_s.dtype == torch.float32
    close(ys, yd.float().numpy(), dtype, "scatter vs dense")
    assert float(aux_s) == float(aux_d)
    jcfg = _cfg(j_smoke, arch, dtype=dtype)
    for impl, got, aux in (("scatter", ys, aux_s), ("dense_mask", yd, aux_d)):
        ref, jaux = j_moe.moe_forward(jp, jcfg, jt(x, dtype), impl)
        close(got, ref.astype(jnp.float32), dtype, impl)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def _mla_setup(seed=2):
    cfg = _cfg(t_smoke, "deepseek-v3-671b")
    m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    rng = np.random.RandomState(seed)
    p = {"wq_a": rng.randn(d, m.q_lora_rank) / np.sqrt(d),
         "q_norm": rng.rand(m.q_lora_rank) + 0.5,
         "wq_b": rng.randn(m.q_lora_rank, H, dn + dr) / np.sqrt(m.q_lora_rank),
         "wkv_a": rng.randn(d, m.kv_lora_rank + dr) / np.sqrt(d),
         "kv_norm": rng.rand(m.kv_lora_rank) + 0.5,
         "wk_b": rng.randn(m.kv_lora_rank, H, dn) / np.sqrt(m.kv_lora_rank),
         "wv_b": rng.randn(m.kv_lora_rank, H, dv) / np.sqrt(m.kv_lora_rank),
         "wo": rng.randn(H, dv, d) / np.sqrt(H * dv)}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_prefill_and_decode(dtype):
    p = _mla_setup()
    tcfg = _cfg(t_smoke, "deepseek-v3-671b", dtype=dtype)
    jcfg = _cfg(j_smoke, "deepseek-v3-671b", dtype=dtype)
    td = getattr(torch, dtype)
    tp = {k: tt(v) for k, v in p.items()}
    jp = {k: jt(v) for k, v in p.items()}
    B, S, P = 2, 10, 6
    x = np.random.RandomState(3).randn(B, S, tcfg.d_model).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    ref = j_attn.mla_forward(jp, jcfg, jt(x, dtype), jt(pos))
    got = t_attn.mla_forward(tp, tcfg, tt(x, td), tt(pos))
    close(got, ref.astype(jnp.float32), dtype, "mla_forward")
    jy, jc = j_attn.mla_prefill(jp, jcfg, jt(x[:, :P], dtype), jt(pos[:P]), S)
    ty, tc = t_attn.mla_prefill(tp, tcfg, tt(x[:, :P], td), tt(pos[:P]), S)
    close(ty, jy.astype(jnp.float32), dtype, "mla_prefill")
    assert sorted(tc) == ["c_kv", "k_rope", "pos"]
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for s in range(P, S):
        cur = np.full((B,), s, np.int32)
        jy, jc = j_attn.mla_decode(jp, jcfg, jt(x[:, s:s + 1], dtype), jc,
                                   jt(cur))
        ty, tc = t_attn.mla_decode(tp, tcfg, tt(x[:, s:s + 1], td), tc,
                                   tt(cur))
        close(ty, jy.astype(jnp.float32), dtype, f"mla_decode at {s}")
        for key in ("c_kv", "k_rope"):
            close(tc[key], jc[key].astype(jnp.float32), dtype, key)
        # the absorbed decode is the non-absorbed forward at that position
        close(ty[:, 0], got[:, s].float().numpy(), dtype,
              f"decode vs forward at {s}")


def _mlstm_inputs(seed=0, B=2, S=37, H=2, D=8):
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(B, S, H, D).astype(f), rng.randn(B, S, H, D).astype(f),
            rng.randn(B, S, H, D).astype(f), rng.randn(B, S, H).astype(f),
            (rng.randn(B, S, H) * 2).astype(f))


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunkwise_matches_recurrent_and_reference(chunk):
    """S = 37: every chunk leaves a padded tail."""
    ins = _mlstm_inputs()
    h_rec, st_rec = t_xl.mlstm_recurrent(*map(tt, ins))
    h, st = t_xl.mlstm_chunkwise(*map(tt, ins), chunk=chunk)
    np.testing.assert_allclose(h.numpy(), h_rec.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(st[0].numpy(), st_rec[0].numpy(), rtol=1e-4,
                               atol=1e-5)
    jh_rec, jst_rec = j_xl.mlstm_recurrent(*map(jt, ins))
    jh, jst = j_xl.mlstm_chunkwise(*map(jt, ins), chunk=chunk)
    close(h_rec, jh_rec, "float32", "recurrent")
    close(h, jh, "float32", "chunkwise")
    for name, g, w in zip("Cnm", st, jst):
        close(g, w, "float32", f"chunkwise state {name}")
    for name, g, w in zip("Cnm", st_rec, jst_rec):
        close(g, w, "float32", f"recurrent state {name}")


def test_mlstm_step_continues_the_chunkwise_state():
    """Prefill by chunks, then step: the recurrent form over the whole
    sequence."""
    q, k, v, ig, fg = map(tt, _mlstm_inputs(seed=1, S=20))
    h_all, _ = t_xl.mlstm_recurrent(q, k, v, ig, fg)
    _, st = t_xl.mlstm_chunkwise(q[:, :16], k[:, :16], v[:, :16],
                                 ig[:, :16], fg[:, :16], chunk=8)
    for t in range(16, 20):
        h, st = t_xl.mlstm_step(q[:, t], k[:, t], v[:, t], ig[:, t],
                                fg[:, t], st)
        close(h, h_all[:, t].numpy(), "float32", f"step {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_scan_matches_reference(dtype):
    cfg = _cfg(t_smoke, "xlstm-350m", dtype=dtype)
    d, nh = cfg.d_model, cfg.num_heads
    dh = d // nh
    rng = np.random.RandomState(4)
    p = {}
    for g in "zifo":
        p[f"w_{g}"] = rng.randn(d, d) / np.sqrt(d)
        p[f"r_{g}"] = rng.randn(nh, dh, dh) / np.sqrt(dh)
        p[f"b_{g}"] = rng.randn(d) * 0.1
    p = {k: v.astype(np.float32) for k, v in p.items()}
    xc = rng.randn(2, 23, d).astype(np.float32)
    xr = rng.randn(2, 23, d).astype(np.float32)
    td = getattr(torch, dtype)
    h, st = t_xl.slstm_scan({k: tt(v) for k, v in p.items()}, cfg,
                            tt(xc, td), tt(xr, td))
    jh, jst = j_xl.slstm_scan({k: jt(v) for k, v in p.items()},
                              _cfg(j_smoke, "xlstm-350m", dtype=dtype),
                              jt(xc, dtype), jt(xr, dtype))
    assert h.dtype == td
    close(h, jh.astype(jnp.float32), dtype, "slstm h")
    for name, g, w in zip("cnhm", st, jst):
        assert g.dtype == torch.float32
        close(g, w, dtype, f"slstm state {name}")


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_cross_attention_decode_matches_forward(arch):
    """Decode against the cross cache built at prefill is attention_forward
    with kv_src at each query row (no mask, no RoPE on the source)."""
    cfg = _cfg(t_smoke, arch)
    blocks = t_build(cfg).init(0, "cpu")["stack"]["prefix"]
    blk = blocks["l0"] if arch == "whisper-tiny" else blocks["l4"]
    p = blk["cross_attn" if arch == "whisper-tiny" else "attn"]
    p = {k: v + 0.3 if k.startswith("gate") or k[0] == "b" else v
         for k, v in p.items()}  # gates and biases off zero
    rng = np.random.RandomState(5)
    Sc = cfg.encoder_seq_len or cfg.num_frontend_tokens
    kv = tt(rng.randn(2, Sc, cfg.frontend_dim or cfg.d_model).astype(
        np.float32))
    x = tt(rng.randn(2, 5, cfg.d_model).astype(np.float32))
    fwd = t_attn.attention_forward(p, cfg, x, torch.arange(5), kind="full",
                                   kv_src=kv)
    cache = t_attn.cross_attention_build_cache(p, cfg, kv)
    for s in range(5):
        y = t_attn.cross_attention_decode(p, cfg, x[:, s:s + 1], cache)
        close(y[:, 0], fwd[:, s].numpy(), "float32", f"row {s}")
    jp = {k: jt(v.numpy()) for k, v in p.items()}
    jcfg = _cfg(j_smoke, arch)
    ref = j_attn.attention_forward(jp, jcfg, jt(x.numpy()), jnp.arange(5),
                                   kind="full", kv_src=jt(kv.numpy()))
    close(fwd, ref, "float32", "cross attention_forward")
    jcache = j_attn.cross_attention_build_cache(jp, jcfg, jt(kv.numpy()))
    ref = j_attn.cross_attention_decode(jp, jcfg, jt(x[:, :1].numpy()),
                                        jcache)
    close(t_attn.cross_attention_decode(p, cfg, x[:, :1], cache), ref,
          "float32", "cross_attention_decode")


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def _mesh():
    try:
        return jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    except (AttributeError, TypeError):  # older jax: no axis_types
        return jax.make_mesh((1, 1), ("data", "model"))


class RecordingEngine(JEngine):
    """The reference engine, keeping the logits of every sampling call."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def _sample(self, logits, temps):
        self.seen.append(np.asarray(logits, np.float32))
        return super()._sample(logits, temps)


def _requests(cls, vocab, n=4):
    rng = np.random.RandomState(11)
    return [cls(prompt=rng.randint(0, vocab, size=7).astype(np.int32),
                max_new_tokens=5) for _ in range(n)]


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_engine_greedy_tokens_match_reference_with_extra_batch(
        jax_params, arch):
    """Two full waves of two slots, the stub frontend's inputs in
    `extra_batch`. A token must match wherever the reference's top-2
    margin exceeds twice the float32 tolerance (tests/test_torch_serve.py);
    after the first that does not, the request is not compared further."""
    jcfg = _cfg(j_smoke, arch)
    tcfg = _cfg(t_smoke, arch)
    jp = jax_params(arch, False)
    tp = convert.model_params(jp, "cpu")
    extra = _extra_batch(tcfg, 2)
    jeng = RecordingEngine(j_build(jcfg), jax.tree.map(jnp.asarray, jp),
                           _mesh(), max_len=20, batch_slots=2,
                           extra_batch={k: jt(v) for k, v in extra.items()})
    teng = Engine(t_build(tcfg), tp, max_len=20, batch_slots=2,
                  extra_batch=extra)
    jreqs = jeng.generate(_requests(JRequest, jcfg.vocab_size))
    treqs = teng.generate(_requests(Request, tcfg.vocab_size))
    assert [len(r.out_tokens) for r in treqs] == [5] * 4
    calls, compared = iter(jeng.seen), 0
    for w in (0, 2):
        logits = [next(calls) for _ in range(5)]
        for i, (jr, tr) in enumerate(zip(jreqs[w:w + 2], treqs[w:w + 2])):
            for k, tok in enumerate(jr.out_tokens):
                row = np.sort(logits[k][i])
                tol = 1e-4 * np.abs(logits[k][i]).max() + 1e-4 * abs(row[-1])
                if row[-1] - row[-2] <= 2 * tol:
                    break
                assert tr.out_tokens[k] == tok, (w + i, k)
                compared += 1
    assert compared >= 15, compared  # of 20 tokens


def test_partial_wave_with_extra_batch_fails_in_both_packages(jax_params):
    """A reference property the port keeps: `extra_batch` has batch_slots
    rows, so a wave of fewer requests than slots does not run."""
    arch = "whisper-tiny"
    jcfg, tcfg = _cfg(j_smoke, arch), _cfg(t_smoke, arch)
    jp = jax_params(arch, False)
    extra = _extra_batch(tcfg, 2)
    jeng = JEngine(j_build(jcfg), jax.tree.map(jnp.asarray, jp), _mesh(),
                   max_len=20, batch_slots=2,
                   extra_batch={k: jt(v) for k, v in extra.items()})
    teng = Engine(t_build(tcfg), convert.model_params(jp, "cpu"), max_len=20,
                  batch_slots=2, extra_batch=extra)
    with pytest.raises(Exception):
        jeng.generate(_requests(JRequest, jcfg.vocab_size, n=3))
    with pytest.raises(RuntimeError):
        teng.generate(_requests(Request, tcfg.vocab_size, n=3))
