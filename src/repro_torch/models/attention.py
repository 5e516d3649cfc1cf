"""Attention for the model zoo (port of `repro.models.attention`).

Blocked (flash-style) attention in plain tensor code over an exact static
chunk-pair schedule: for causal / sliding-window masks only the (q-chunk,
kv-chunk) pairs that can hold unmasked entries are visited, in the
reference's order, with its online softmax and its rounding point (P is
cast to V's dtype against the running max). Products take float32 inputs
where the reference asks for a float32 result (`preferred_element_type`):
the product of two bf16 values is exact in float32, so the result is the
same. Also: GQA grouping, RoPE, and single-step decode attention against a
KV cache.

Not ported yet (ROADMAP Queue 1 item 11): MLA and cross attention; the
partial decode and its LSE combine belong to the distribution layer (item
12).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamBuilder, apply_rope

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Static chunk-pair schedule
# ---------------------------------------------------------------------------


def chunk_pairs(
    nq: int,
    nkv: int,
    cq: int,
    ckv: int,
    kind: str,
    window: int = 0,
    q_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return static (i, j) chunk-pair arrays that may contain unmasked work.

    kind: "full" | "causal" | "sliding". q_offset shifts absolute q positions
    (kv positions always start at 0).
    """
    pairs = []
    for i in range(nq):
        q_lo = q_offset + i * cq
        q_hi = q_offset + (i + 1) * cq - 1
        for j in range(nkv):
            k_lo = j * ckv
            k_hi = (j + 1) * ckv - 1
            if kind == "full":
                pairs.append((i, j))
                continue
            if k_lo > q_hi:  # strictly future chunk
                continue
            if kind == "sliding" and window > 0 and k_hi < q_lo - window + 1:
                continue  # entirely outside the window of every q in chunk
            pairs.append((i, j))
    if not pairs:
        pairs = [(0, 0)]
    arr = np.asarray(pairs, dtype=np.int32)
    return arr[:, 0], arr[:, 1]


# ---------------------------------------------------------------------------
# Blocked attention (train / prefill)
# ---------------------------------------------------------------------------


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of [B, S, G, D] at the end."""
    return F.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def blocked_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, G, D]
    v: torch.Tensor,  # [B, Skv, G, Dv]
    kind: str = "causal",
    window: int = 0,
    q_offset: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 512,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Flash-style blocked attention with online softmax. Returns [B, Sq, H, Dv].

    kind="sliding" attends to positions (t-window, t] (Mistral semantics).
    kv_len masks out padded kv positions >= kv_len.
    """
    B, Sq, H, D = q.shape
    _, Skv, G, _ = k.shape
    Dv = v.shape[-1]
    assert H % G == 0, (H, G)
    R = H // G
    if scale is None:
        scale = 1.0 / math.sqrt(D)

    cq = min(chunk_q, Sq)
    ckv = min(chunk_kv, Skv)
    qp = _pad_seq(q, (-Sq) % cq)
    kp = _pad_seq(k, (-Skv) % ckv)
    vp = _pad_seq(v, (-Skv) % ckv)
    nq, nkv = qp.shape[1] // cq, kp.shape[1] // ckv
    valid_kv = kv_len if kv_len is not None else Skv

    # grouped layouts
    qg = qp.reshape(B, nq, cq, G, R, D)
    kg = kp.reshape(B, nkv, ckv, G, D)
    vg = vp.reshape(B, nkv, ckv, G, Dv)

    dev = q.device
    f32 = torch.float32
    m: List[torch.Tensor] = [torch.full((B, cq, G, R), NEG_INF, dtype=f32,
                                        device=dev) for _ in range(nq)]
    l: List[torch.Tensor] = [torch.zeros((B, cq, G, R), dtype=f32, device=dev)
                             for _ in range(nq)]
    o: List[torch.Tensor] = [torch.zeros((B, cq, G, R, Dv), dtype=f32,
                                         device=dev) for _ in range(nq)]
    ii, jj = chunk_pairs(nq, nkv, cq, ckv, kind, window, q_offset)
    for i, j in zip(ii.tolist(), jj.tolist()):
        qi, kj, vj = qg[:, i], kg[:, j], vg[:, j]
        # logits [B, cq, G, R, ckv], float32 products and sums
        logits = torch.einsum("bqgrd,bkgd->bqgrk", qi.float(),
                              kj.float()) * scale
        qpos = q_offset + i * cq + torch.arange(cq, device=dev)
        kpos = j * ckv + torch.arange(ckv, device=dev)
        mask = kpos[None, :] < valid_kv
        if kind in ("causal", "sliding"):
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if kind == "sliding" and window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(mask[None, :, None, None, :], logits, NEG_INF)

        m_new = torch.maximum(m[i], logits.amax(dim=-1))
        corr = torch.exp(m[i] - m_new)
        p = torch.exp(logits - m_new[..., None])
        # guard rows where everything is masked
        p = torch.where((m_new == NEG_INF)[..., None], 0.0, p)
        l[i] = l[i] * corr + p.sum(dim=-1)
        pv = torch.einsum("bqgrk,bkgd->bqgrd", p.to(vj.dtype).float(),
                          vj.float())
        o[i] = o[i] * corr[..., None] + pv
        m[i] = m_new

    ls, os_ = torch.stack(l), torch.stack(o)  # [nq, B, cq, G, R(, Dv)]
    denom = torch.where(ls == 0.0, 1.0, ls)
    out = (os_ / denom[..., None]).to(q.dtype)
    out = out.transpose(0, 1).reshape(B, nq * cq, H, Dv)
    return out[:, :Sq]


# ---------------------------------------------------------------------------
# Decode attention against a KV cache (single step, local math)
# ---------------------------------------------------------------------------


def decode_attend(
    q: torch.Tensor,             # [B, H, D]
    k_cache: torch.Tensor,       # [B, Sc, G, D]
    v_cache: torch.Tensor,       # [B, Sc, G, Dv]
    kv_positions: torch.Tensor,  # [B, Sc] int32; -1 marks empty slots
    cur_pos: torch.Tensor,       # [B] int32 position of the query token
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns [B, H, Dv]."""
    B, H, D = q.shape
    G = k_cache.shape[2]
    R = H // G
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, G, R, D)
    logits = torch.einsum("bgrd,bkgd->bgrk", qg.float(),
                          k_cache.float()) * scale
    valid = (kv_positions >= 0) & (kv_positions <= cur_pos[:, None])
    if window > 0:
        valid = valid & (kv_positions > cur_pos[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(m == NEG_INF, 0.0, p)
    l = p.sum(dim=-1)
    pv = torch.einsum("bgrk,bkgd->bgrd", p.to(v_cache.dtype).float(),
                      v_cache.float())
    out = pv / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(B, H, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# Standard GQA attention module
# ---------------------------------------------------------------------------


def init_attention(b: ParamBuilder, cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, G = cfg.num_heads, cfg.num_kv_heads
    b.param("wq", (d, H, hd), ("embed", "heads", "head_dim"))
    b.param("wk", (d, G, hd), ("embed", "kv_heads", "head_dim"))
    b.param("wv", (d, G, hd), ("embed", "kv_heads", "head_dim"))
    b.param("wo", (H, hd, d), ("heads", "head_dim", "embed"),
            scale=1.0 / math.sqrt(H * hd))
    if getattr(cfg, "use_bias", False):
        b.param("bq", (H, hd), ("heads", "head_dim"), init="zeros")
        b.param("bv", (G, hd), ("kv_heads", "head_dim"), init="zeros")
        b.param("bo", (d,), ("embed",), init="zeros")
    if cfg.qk_norm:
        b.param("q_norm_scale", (hd,), ("head_dim",), init="ones",
                dtype=torch.float32)
        b.param("k_norm_scale", (hd,), ("head_dim",), init="ones",
                dtype=torch.float32)


def _qkv(p, cfg, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = _rms_head(q, p["q_norm_scale"])
        k = _rms_head(k, p["k_norm_scale"])
    return q, k, v


def _rms_head(x, scale, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _out_proj(p, o):
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
    if "bo" in p:
        y = y + p["bo"].to(o.dtype)
    return y


def _mask_of(cfg, kind: Optional[str], window: Optional[int]):
    """The config's (kind, window) where the caller gives none."""
    if kind is None:
        kind = {"full": "causal", "sliding": "sliding", "local": "sliding"}[
            cfg.attention_kind]
        window = _config_window(cfg)
    return kind, window or 0


def _config_window(cfg) -> int:
    return cfg.sliding_window if cfg.attention_kind == "sliding" else (
        cfg.local_window if cfg.attention_kind == "local" else 0)


def attention_forward(
    p,
    cfg,
    x: torch.Tensor,          # [B, S, d]
    positions: torch.Tensor,  # [S] absolute positions
    kind: Optional[str] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    q, k, v = _qkv(p, cfg, x)
    if cfg.use_rope:
        # q,k are [B,S,H,D]: rope over S with head axis trailing
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kind, window = _mask_of(cfg, kind, window)
    o = blocked_attention(q, k, v, kind=kind, window=window)
    return _out_proj(p, o)


def attention_prefill(p, cfg, x, positions, cache_len: int,
                      kind: Optional[str] = None,
                      window: Optional[int] = None):
    """Forward + return (output, cache dict) holding the last cache_len
    tokens at slots 0 .. take-1 (the ring's base state)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kind, window = _mask_of(cfg, kind, window)
    o = blocked_attention(q, k, v, kind=kind, window=window)
    y = _out_proj(p, o)
    take = min(cache_len, S)
    pad = cache_len - take
    k_c = _pad_seq(k[:, S - take:], pad)
    v_c = _pad_seq(v[:, S - take:], pad)
    pos_c = F.pad(positions[S - take:], (0, pad), value=-1)
    pos_c = pos_c.to(torch.int32).expand(B, cache_len).contiguous()
    return y, {"k": k_c, "v": v_c, "pos": pos_c}


def attention_decode(p, cfg, x, cache, cur_pos,
                     window: Optional[int] = None):
    """One-token decode. x: [B, 1, d]; cache k/v: [B, Sc, G, D], pos [B, Sc];
    cur_pos [B]. Writes the new token at slot cur_pos % Sc (ring semantics)
    into copies of the cache tensors; the given cache is left as it was."""
    B = x.shape[0]
    Sc = cache["k"].shape[1]
    q, k, v = _qkv(p, cfg, x)
    if cfg.use_rope:
        pos2 = cur_pos[:, None]  # [B,1]
        q = apply_rope(q, pos2, cfg.rope_theta)
        k = apply_rope(k, pos2, cfg.rope_theta)
    slot = (cur_pos % Sc).long()
    bidx = torch.arange(B, device=x.device)
    k_cache = cache["k"].clone()
    v_cache = cache["v"].clone()
    pos_cache = cache["pos"].clone()
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    pos_cache[bidx, slot] = cur_pos.to(torch.int32)
    if window is None:
        window = _config_window(cfg)
    o = decode_attend(q[:, 0], k_cache, v_cache, pos_cache, cur_pos,
                      window=window)
    y = _out_proj(p, o[:, None])
    return y, {"k": k_cache, "v": v_cache, "pos": pos_cache}
