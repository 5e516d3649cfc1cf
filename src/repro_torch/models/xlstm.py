"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory); port of
`repro.models.xlstm`.

arXiv:2405.04517. mLSTM recurrent form (per head, keys scaled by 1/sqrt(d)):
  m_t = max(log f_t + m_{t-1}, i~_t)
  i'  = exp(i~_t - m_t);  f' = exp(log f_t + m_{t-1} - m_t)
  C_t = f' C_{t-1} + i' v_t k_t^T ;  n_t = f' n_{t-1} + i' k_t
  h~_t = C_t q_t / max(|n_t . q_t|, exp(-m_t))

Prefill uses the chunkwise-parallel form (intra-chunk quadratic, inter-chunk
recurrence: a Python loop over the chunks where the reference has
`lax.scan`); decode uses the exact recurrent step. All the recurrent
arithmetic runs in float32. The sLSTM is a strictly sequential scalar
recurrence, a Python loop over the sequence, with exponential gating and a
stabilizer.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.act_sharding import constrain
from repro_torch.models.common import (ParamBuilder, apply_norm, dtype_of,
                                       gelu, layout, meta, silu)
from repro_torch.models.recurrent import (conv1d_causal, conv1d_decode,
                                          init_conv1d)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mLSTM core
# ---------------------------------------------------------------------------


def mlstm_recurrent(q, k, v, i_gate, f_gate, state=None):
    """Exact sequential reference / decode path.

    q,k,v: [B, S, H, D]; i_gate,f_gate: [B, S, H] (pre-activation).
    state: (C [B,H,D,D], n [B,H,D], m [B,H]) or None.
    Returns (h [B,S,H,D], state).
    """
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    if state is None:
        f32 = dict(dtype=torch.float32, device=q.device)
        state = (torch.zeros((B, H, D, D), **f32),
                 torch.zeros((B, H, D), **f32),
                 torch.full((B, H), -math.inf, **f32))
    C, n, m = state
    hs = []
    for t in range(S):
        kt = k[:, t].float() * scale
        vt = v[:, t].float()
        qt = q[:, t].float()
        it = i_gate[:, t].float()
        logf = F.logsigmoid(f_gate[:, t].float())
        m_new = torch.maximum(logf + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(logf + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])
        n = f_p[..., None] * n + i_p[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.abs(torch.einsum("bhk,bhk->bh", n, qt))
        den = torch.maximum(den, torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), (C, n, m)


def mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk: int = 256, state=None):
    """Chunkwise-parallel mLSTM. Same I/O contract as mlstm_recurrent."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    pad = (-S) % chunk
    if pad:
        def zpad(x):
            return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
        q, k, v = zpad(q), zpad(k), zpad(v)
        # padded forget gates -> large positive (f=1, carries state through);
        # padded input gates -> very negative (no contribution)
        f_gate = F.pad(f_gate, (0, 0, 0, pad), value=30.0)
        i_gate = F.pad(i_gate, (0, 0, 0, pad), value=NEG_INF)
    L = chunk
    NC = q.shape[1] // L

    if state is None:
        f32 = dict(dtype=torch.float32, device=q.device)
        state = (torch.zeros((B, H, D, D), **f32),
                 torch.zeros((B, H, D), **f32),
                 torch.full((B, H), -1e30, **f32))
    C, n, m_c = state

    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    hs = []
    for c in range(NC):
        sl = slice(c * L, (c + 1) * L)
        qt = q[:, sl].float()
        kt = k[:, sl].float() * scale
        vt = v[:, sl].float()
        it = i_gate[:, sl].float()             # [B, L, H]
        logf = F.logsigmoid(f_gate[:, sl].float())
        b = torch.cumsum(logf, dim=1)          # inclusive cumsum [B, L, H]
        B_tot = b[:, -1]                       # [B, H]

        # per-query stabilizers
        # intra: max_{s<=t} (b_t - b_s + i_s)  (s=t term: i_t)
        g = it - b                             # [B, L, H] (i_s - b_s)
        g_run = torch.cummax(g, dim=1).values  # running max over s <= t
        m_intra = b + g_run
        m_inter = b + m_c[:, None, :]
        m_q = torch.maximum(m_intra, m_inter)

        # inter-chunk contribution (state carries implicit exp(-m_c))
        q_h = qt.transpose(1, 2)               # [B, H, L, D]
        inter_scale = torch.exp(m_inter - m_q).transpose(1, 2)  # [B, H, L]
        # C is [B,H,Dv,Dk]; contract q over Dk: num = C q
        num_inter = torch.einsum("bhvk,bhlk->bhlv", C, q_h) * \
            inter_scale[..., None]
        den_inter = torch.einsum("bhk,bhlk->bhl", n, q_h) * inter_scale

        # intra-chunk quadratic part
        # D~_ts = b_t - b_s + i_s for s <= t, else -inf; weight exp(D~ - m_q)
        dmat = b[:, :, None, :] - b[:, None, :, :] + it[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, NEG_INF)
        w = torch.exp(dmat - m_q[:, :, None, :])        # [B, T, S, H]
        scores = torch.einsum("bthd,bshd->btsh", qt, kt) * w
        num_intra = torch.einsum("btsh,bshv->bthv", scores, vt)
        den_intra = scores.sum(dim=2)                   # [B, L, H]

        num = num_inter.permute(0, 2, 1, 3) + num_intra
        den = den_inter.permute(0, 2, 1) + den_intra
        den = torch.maximum(torch.abs(den), torch.exp(-m_q))
        hs.append(num / den[..., None])

        # state update to end of chunk
        m_next = torch.maximum(
            B_tot + m_c,
            (B_tot[:, :, None] + g.transpose(1, 2)).amax(dim=-1))
        # decay of each source position s: exp(B_tot - b_s + i_s - m_next)
        s_decay = torch.exp(B_tot[:, None, :] - b + it
                            - m_next[:, None, :]).transpose(1, 2)
        k_h = kt.permute(0, 2, 1, 3)           # [B, H, L, D]
        v_h = vt.permute(0, 2, 1, 3)
        carry = torch.exp(B_tot + m_c - m_next)
        C = C * carry[..., None, None] + torch.einsum(
            "bhl,bhlv,bhlk->bhvk", s_decay, v_h, k_h)
        n = n * carry[..., None] + torch.einsum("bhl,bhlk->bhk", s_decay, k_h)
        m_c = m_next
    h = torch.cat(hs, dim=1)[:, :S]
    return h.to(q.dtype), (C, n, m_c)


def _mlstm_cells(q, k, v, i_gate, f_gate, *state, chunk=None):
    """The mLSTM cell as a flat body for `layout().on_heads`: chunkwise
    over the sequence with `chunk`, else one decode step
    (`mlstm_step`). Returns (h, C, n, m)."""
    if chunk is None:
        h, (C, n, m) = mlstm_step(q, k, v, i_gate, f_gate, state)
    else:
        h, (C, n, m) = mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk=chunk)
    return h, C, n, m


def mlstm_step(q1, k1, v1, i1, f1, state):
    """Single-token decode. q1..: [B, H, D], gates [B, H]."""
    h, state = mlstm_recurrent(q1[:, None], k1[:, None], v1[:, None],
                               i1[:, None], f1[:, None], state)
    return h[:, 0], state


# ---------------------------------------------------------------------------
# mLSTM block (pre-LN, up-proj x2, conv4, heads, output gate via silu branch)
# ---------------------------------------------------------------------------


def init_mlstm_block(b: ParamBuilder, cfg):
    d = cfg.d_model
    inner = 2 * d
    nh = cfg.num_heads
    b.param("w_up", (d, inner), ("embed", "mlp"))
    b.param("w_gate", (d, inner), ("embed", "mlp"))
    init_conv1d(b, "conv", cfg.conv_width, inner)
    for name in ("wq", "wk", "wv"):
        b.param(name, (inner, inner), ("mlp", "mlp2"),
                scale=1.0 / math.sqrt(inner))
    b.param("w_if", (inner, 2 * nh), ("mlp", None),
            scale=1.0 / math.sqrt(inner))
    b.param("b_if", (2 * nh,), (None,), init="zeros")
    b.param("skip_scale", (inner,), ("mlp",), init="ones")
    b.param("w_down", (inner, d), ("mlp", "embed"))


def _mlstm_proj(p, c_act, u):
    """q, k from the conv branch, v from u, the gates (i then f) with
    their bias; each a product at u's dtype."""
    dt = u.dtype
    # wq, wk, wv [inner ("mlp"), inner ("mlp2")] and w_if [inner ("mlp"),
    # 2H]: row-parallel on the inner dim's shard
    project = layout().project_out
    q = project(c_act, p["wq"].to(dt))
    k = project(c_act, p["wk"].to(dt))
    v = project(u, p["wv"].to(dt))
    gates = project(c_act, p["w_if"].to(dt)) + p["b_if"].to(dt)
    return q, k, v, gates


def _mlstm_qkvif(p, cfg, u):
    """u: [B, S, inner] (post-up-proj). Returns q,k,v [B,S,H,D], gates
    [B,S,H] and the activated conv branch."""
    nh = cfg.num_heads
    c_act = silu(conv1d_causal(p["conv"], u))
    q, k, v, gates = _mlstm_proj(p, c_act, u)
    B, S, inner = u.shape
    D = inner // nh
    q = q.reshape(B, S, nh, D)
    k = k.reshape(B, S, nh, D)
    v = v.reshape(B, S, nh, D)
    return q, k, v, gates[..., :nh], gates[..., nh:], c_act


def _mlstm_out(p, h, c_act, g):
    """(h + skip * conv branch) * silu(gate branch), projected down."""
    dt = g.dtype
    y = (h + p["skip_scale"].to(dt) * c_act) * silu(g)
    return layout().project_out(y, p["w_down"].to(dt))


def _up(p, x):
    project = layout().project_in
    u = project(x, p["w_up"].to(x.dtype))
    g = project(x, p["w_gate"].to(x.dtype))
    return constrain(u, "dp", None, "tp"), constrain(g, "dp", None, "tp")


def mlstm_block_forward(p, cfg, x, chunk: int = 256):
    return mlstm_block_prefill(p, cfg, x, chunk)[0]


def mlstm_block_prefill(p, cfg, x, chunk: int = 256):
    B, S, d = x.shape
    u, g = _up(p, x)
    q, k, v, ig, fg, c_act = _mlstm_qkvif(p, cfg, u)
    # heads at dim 2 of q, k, v [B, S, H, D] and the gates [B, S, H], of h;
    # at dim 1 of the state C [B, H, D, D], n [B, H, D], m [B, H]
    h, *state = layout().on_heads(
        functools.partial(_mlstm_cells, chunk=chunk), [q, k, v, ig, fg], [],
        cfg.num_heads, (2,) * 5, (2, 1, 1, 1))
    out = _mlstm_out(p, h.reshape(B, S, -1), c_act, g)
    cw = cfg.conv_width
    # a copy, so the state does not hold the whole sequence's tensor
    conv_state = u[:, S - (cw - 1):].clone() if cw > 1 else u[:, :0]
    return out, {"C": state[0], "n": state[1], "m": state[2],
                 "conv": conv_state}


def mlstm_block_cache_spec(cfg, batch: int, context: int):
    """`mlstm_block_prefill`'s state as meta tensors (any context)."""
    inner, nh = 2 * cfg.d_model, cfg.num_heads
    D = inner // nh
    f32 = torch.float32
    return {"C": meta((batch, nh, D, D), f32), "n": meta((batch, nh, D), f32),
            "m": meta((batch, nh), f32),
            "conv": meta((batch, cfg.conv_width - 1, inner),
                         dtype_of(cfg.activation_dtype))}


def mlstm_block_decode(p, cfg, x_t, st):
    """x_t: [B, 1, d]."""
    nh = cfg.num_heads
    u, g = _up(p, x_t[:, 0])
    c, conv_state = conv1d_decode(p["conv"], u, st["conv"])
    c_act = silu(c)
    q, k, v, gates = _mlstm_proj(p, c_act, u)
    B, inner = u.shape
    D = inner // nh
    # heads at dim 1 of every input ([B, H, D], [B, H] and the state) and
    # output
    h, *state = layout().on_heads(
        _mlstm_cells, [q.reshape(B, nh, D), k.reshape(B, nh, D),
                       v.reshape(B, nh, D), gates[..., :nh], gates[..., nh:],
                       st["C"], st["n"], st["m"]], [], nh, (1,) * 8, (1,) * 4)
    out = _mlstm_out(p, h.reshape(B, -1), c_act, g)
    return out[:, None], {"C": state[0], "n": state[1], "m": state[2],
                          "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, block-diagonal per-head recurrence)
# ---------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


def init_slstm_block(b: ParamBuilder, cfg):
    d = cfg.d_model
    nh = cfg.num_heads
    dh = d // nh
    init_conv1d(b, "conv", cfg.conv_width, d)
    for gate in GATES:
        b.param(f"w_{gate}", (d, d), ("embed", "mlp"),
                scale=1.0 / math.sqrt(d))
        # read in float32 by the recurrence
        b.param(f"r_{gate}", (nh, dh, dh), ("heads", None, None),
                scale=1.0 / math.sqrt(dh), reads_float32=True)
        b.param(f"b_{gate}", (d,), ("mlp",), init="zeros")
    # post-up-projection FFN (factor 4/3, GeGLU per paper)
    ff = int(d * 4 / 3)
    b.param("ffn_norm_scale", (d,), ("embed",), init="ones",
            dtype=torch.float32)
    b.param("ffn_wi", (d, ff), ("embed", "mlp"))
    b.param("ffn_wg", (d, ff), ("embed", "mlp"))
    b.param("ffn_wo", (ff, d), ("mlp", "embed"))


def slstm_scan(p, cfg, x_conv, x_raw, state=None):
    """x_conv: conv-smoothed input (for i/f gates), x_raw for z/o. [B,S,d].
    state: (c, n, h, m), each [B, d] float32, or None (n starts at 1).
    The recurrence runs through `layout().on_heads`: under a mesh, on each
    rank's batch shard and heads (the heads do not mix)."""
    B, S, d = x_raw.shape
    dt = x_raw.dtype
    # input contributions precomputed for the whole sequence
    pre = []
    project = layout().project_in
    for gate in GATES:
        src = x_conv if gate in ("i", "f") else x_raw
        pre.append((project(src, p[f"w_{gate}"].to(dt))
                    + p[f"b_{gate}"].to(dt)).float())

    if state is None:
        f32 = dict(dtype=torch.float32, device=x_raw.device)
        state = (torch.zeros((B, d), **f32), torch.ones((B, d), **f32),
                 torch.zeros((B, d), **f32), torch.zeros((B, d), **f32))
    r = [p[f"r_{gate}"].float() for gate in GATES]
    hs, *state = layout().on_heads(_slstm_cells, [*pre, *state], r,
                                   cfg.num_heads)
    return hs.to(dt), tuple(state)


def _slstm_cells(pre_z, pre_i, pre_f, pre_o, c, n, h, m, r_z, r_i, r_f,
                 r_o):
    """The sLSTM recurrence over the heads of r_* [nh, dh, dh]: the input
    contributions pre_* [B, S, nh * dh] and the state (c, n, h, m) [B, nh
    * dh], float32. Returns (h at every step [B, S, nh * dh], c, n, h, m)."""
    B, S, d = pre_z.shape
    nh = r_z.shape[0]
    dh = d // nh

    def rec(r, h):
        hh = h.reshape(B, nh, dh)
        return torch.einsum("bhk,hkj->bhj", hh, r).reshape(B, d)

    hs = []
    for t in range(S):
        z = torch.tanh(pre_z[:, t] + rec(r_z, h))
        i_t = pre_i[:, t] + rec(r_i, h)
        f_t = pre_f[:, t] + rec(r_f, h)
        o = torch.sigmoid(pre_o[:, t] + rec(r_o, h))
        logf = F.logsigmoid(f_t)
        m_new = torch.maximum(logf + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(logf + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        h = o * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), c, n, h, m


def _slstm_ffn(p, cfg, h):
    hn = apply_norm({"scale": p["ffn_norm_scale"]}, h, "rmsnorm")
    project = layout().project_in
    f = gelu(project(hn, p["ffn_wi"].to(h.dtype)))
    f = f * project(hn, p["ffn_wg"].to(h.dtype))
    return h + layout().project_out(f, p["ffn_wo"].to(h.dtype))


def slstm_block_forward(p, cfg, x):
    return slstm_block_prefill(p, cfg, x)[0]


def slstm_block_prefill(p, cfg, x):
    xc = silu(conv1d_causal(p["conv"], x))
    h, state = slstm_scan(p, cfg, xc, x)
    out = _slstm_ffn(p, cfg, h)
    cw = cfg.conv_width
    S = x.shape[1]
    conv_state = x[:, S - (cw - 1):].clone() if cw > 1 else x[:, :0]
    return out, {"c": state[0], "n": state[1], "h": state[2], "m": state[3],
                 "conv": conv_state}


def slstm_block_cache_spec(cfg, batch: int, context: int):
    """`slstm_block_prefill`'s state as meta tensors (any context)."""
    d = cfg.d_model
    state = {k: meta((batch, d), torch.float32) for k in ("c", "n", "h", "m")}
    state["conv"] = meta((batch, cfg.conv_width - 1, d),
                         dtype_of(cfg.activation_dtype))
    return state


def slstm_block_decode(p, cfg, x_t, st):
    xt = x_t[:, 0]
    xc_t, conv_state = conv1d_decode(p["conv"], xt, st["conv"])
    xc_t = silu(xc_t)
    h, state = slstm_scan(p, cfg, xc_t[:, None], xt[:, None],
                          (st["c"], st["n"], st["h"], st["m"]))
    out = _slstm_ffn(p, cfg, h)
    return out, {"c": state[0], "n": state[1], "h": state[2], "m": state[3],
                 "conv": conv_state}
