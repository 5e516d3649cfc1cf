"""Attention for the model zoo (port of `repro.models.attention`).

Which prefill runs where: `attention_prefill` (the dense, GQA, sliding and
local prefill of the zoo, encoder-decoder self-attention included) runs
the hand-written Hopper kernel `kernels.flash_attention.prefill_attention`
for CUDA bf16 inputs with D == Dv and a shape its `prefill_plan` accepts
(`prefill_route` decides from the inputs alone), reading q [B, S, H, D]
and k, v [B, S, G, D] in place and writing bf16; it counts each call's
route in the metrics counter `attn.prefill_route{route=kernel|loop}`.
Everything else runs the chunk loop below: CPU tensors, float32 inputs,
MLA's prefill (`_mla_attend`: D 192 != Dv 128; also the training path),
and `attention_forward` (training and cross attention: the kernel has no
backward).

Which decode runs where: `decode_attend` (the GQA, MQA, sliding and local
decode of the zoo, and `cross_attention_decode` over encoder positions)
runs the hand-written Hopper kernel `kernels.decode_attention.
decode_attention` for CUDA bf16 inputs that `decode_route` accepts (D ==
Dv, D % 8 == 0, D <= 256, G dividing H), reading q [B, H, D] and the k, v
caches [B, Sc, G, D] in place and writing bf16, one launch a call; it
counts each call's route in the metrics counter
`attn.decode_route{route=kernel|loop}`. Everything else runs
`decode_attend_partial` below: CPU tensors, float32 caches, and the
sequence-sharded mesh decode (`distributed/decode_attention.py`, whose LSE
combine needs the partials). MLA decodes in latent space (`mla_decode`)
and takes neither.

Blocked (flash-style) attention in plain tensor code over an exact static
chunk-pair schedule: for causal / sliding-window masks only the (q-chunk,
kv-chunk) pairs that can hold unmasked entries are visited, in the
reference's order, with its online softmax and its rounding point (P is
cast to V's dtype against the running max). Products take float32 inputs
where the reference asks for a float32 result (`preferred_element_type`):
the product of two bf16 values is exact in float32, so the result is the
same. Also: GQA grouping, RoPE, single-step decode attention against a
KV cache, cross attention (its K/V from an encoder or a frontend, built
once at prefill, with the Llama-3.2-Vision tanh gate) and DeepSeek's MLA
(a compressed latent KV cache, absorbed-form decode).

Also the partial decode and its LSE combine across a process group, the
per-rank body of the sequence-sharded decode
(`repro_torch.distributed.decode_attention`): `attention_decode` takes an
`attend_fn` in place of `decode_attend`. The attention bodies and the
cache's slot write go through `common.layout()`, whose forms a mesh's step
sets. MLA decodes in latent space without an `attend_fn`, in both
packages. Every product with a weight runs through `layout().project_in`
(q, k, v; MLA's up-projections and absorbed products) or `project_out`
(the output projection): under a mesh, on this rank's shard of the
weight. A decode step's cache writes (`attention_decode`, `mla_decode`)
run under the span `attn.cache_write` (`obs.trace`; a no-op with no
tracer).
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.act_sharding import constrain
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.common import (ParamBuilder, apply_rope, dtype_of,
                                       layout, meta)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

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
    kv_len masks out padded kv positions >= kv_len. The body runs through
    `layout().on_shards` (under a mesh, on each rank's shards).
    """
    return layout().on_shards(_blocked_attention, q, k, v, kind=kind,
                              window=window, q_offset=q_offset,
                              chunk_q=chunk_q, chunk_kv=chunk_kv,
                              scale=scale, kv_len=kv_len)


def _blocked_attention(q, k, v, kind, window, q_offset, chunk_q, chunk_kv,
                       scale, kv_len):
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
# Prefill attention: the Hopper kernel where it takes the inputs, else the loop
# ---------------------------------------------------------------------------


def prefill_route(device_type: str, dtype, q_shape, k_shape,
                  v_shape) -> str:
    """"kernel" where `kernels.flash_attention.prefill_attention` takes a
    prefill's inputs: CUDA tensors, bf16 (`dtype` is the one dtype of q, k
    and v, None where they differ), q [B, S, H, D] against k [B, S, G, D]
    of q's length and head dim, v's head dim D too, and a shape
    `prefill_plan` accepts; "loop" otherwise. It reads only what it is
    given, so a test can ask it about a card's tensors on the CPU."""
    B, S, H, D = q_shape
    _, Skv, G, Dk = k_shape
    if device_type != "cuda" or Skv != S or Dk != D:
        return "loop"
    return ("kernel" if fa.prefill_refusal(B, S, H, G, D, v_shape[-1], dtype)
            is None else "loop")


def prefill_attend(q, k, v, kind: str = "causal", window: int = 0):
    """A prefill's attention, [B, S, H, Dv]: the Hopper kernel where
    `prefill_route` picks it (under a mesh on each rank's shards, through
    `layout().on_shards`), else `blocked_attention`. Counts the route in
    `attn.prefill_route`."""
    dtype = q.dtype if q.dtype == k.dtype == v.dtype else None
    route = prefill_route(q.device.type, dtype, tuple(q.shape),
                          tuple(k.shape), tuple(v.shape))
    obs_metrics.current().counter("attn.prefill_route", route=route).inc()
    if route == "loop":
        return blocked_attention(q, k, v, kind=kind, window=window)
    return layout().on_shards(
        fa.prefill_attention, q, k, v, causal=kind != "full",
        window=window if kind == "sliding" else 0)


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
    """Returns [B, H, Dv]. The body runs through `layout().on_shards`
    (under a mesh, on each rank's shards): the decode kernel where
    `decode_route` picks it, else `decode_attend_partial`."""
    return layout().on_shards(_decode_attend, q, k_cache, v_cache,
                              (kv_positions, cur_pos), q_heads=1,
                              window=window, scale=scale)


@functools.lru_cache(maxsize=1024)
def decode_route(device_type: str, dtype, q_shape, k_shape,
                 v_shape) -> str:
    """"kernel" where `kernels.decode_attention.decode_attention` takes a
    decode's inputs: CUDA tensors, bf16 (`dtype` is the one dtype of q, k
    and v, None where they differ), q [B, H, D] against k [B, Sc, G, D] of
    q's batch and head dim, v's head dim D too, and a shape
    `decode_refusal` accepts; "loop" otherwise. It reads only what it is
    given, so a test can ask it about a card's tensors on the CPU; cached,
    as the decode step asks it once a layer."""
    B, H, D = q_shape
    Bk, Sc, G, Dk = k_shape
    if device_type != "cuda" or Bk != B or Dk != D:
        return "loop"
    return ("kernel" if da.decode_refusal(B, Sc, H, G, D, v_shape[-1], dtype)
            is None else "loop")


def _decode_attend(q, k_cache, v_cache, kv_positions, cur_pos, window,
                   scale):
    """The kernel where `decode_route` picks it, else `decode_attend_loop`;
    counts the route in `attn.decode_route`."""
    dtype = q.dtype if q.dtype == k_cache.dtype == v_cache.dtype else None
    route = decode_route(q.device.type, dtype, q.shape, k_cache.shape,
                         v_cache.shape)
    obs_metrics.current().counter("attn.decode_route", route=route).inc()
    if route == "kernel":
        return da.decode_attention(q, k_cache, v_cache, kv_positions,
                                   cur_pos, window=window, scale=scale)
    return decode_attend_loop(q, k_cache, v_cache, kv_positions, cur_pos,
                              window=window, scale=scale)


def decode_attend_loop(q, k_cache, v_cache, kv_positions, cur_pos,
                       window: int = 0, scale: Optional[float] = None):
    """`decode_attend_partial` divided out, [B, H, Dv] in q's dtype (0 for a
    row with no kept slot): the decode of every input `decode_route` leaves
    to the loop, and the decode kernel's plain version."""
    o, _, l = decode_attend_partial(q, k_cache, v_cache, kv_positions,
                                    cur_pos, window=window, scale=scale)
    return (o / torch.where(l == 0.0, 1.0, l)[..., None]).to(q.dtype)


def decode_attend_partial(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_positions: torch.Tensor,
    cur_pos: torch.Tensor,
    window: int = 0,
    scale: Optional[float] = None,
):
    """Partial (un-normalized) decode attention for LSE combining across
    sequence shards: returns (o_partial [B,H,Dv], m [B,H], l [B,H]), all
    float32. Also the decode of every input `decode_route` leaves to the
    loop (the CPU, float32 caches)."""
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
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    p = torch.where((m == NEG_INF)[..., None], 0.0, p)
    l = p.sum(dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, H, -1), m.reshape(B, H), l.reshape(B, H)


def combine_partials(o, m, l, group):
    """LSE-combine flash-decoding partials across the ranks of `group` (the
    "model" axis's process group): all_reduce MAX of the running max, then
    all_reduce SUM of the rescaled sums and outputs."""
    import torch.distributed as dist
    g_max = m.clone()
    dist.all_reduce(g_max, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - g_max)
    l_sum = l * corr
    dist.all_reduce(l_sum, op=dist.ReduceOp.SUM, group=group)
    o_sum = o * corr[..., None]
    dist.all_reduce(o_sum, op=dist.ReduceOp.SUM, group=group)
    denom = torch.where(l_sum == 0.0, 1.0, l_sum)
    return o_sum / denom[..., None]


# ---------------------------------------------------------------------------
# Standard GQA attention module
# ---------------------------------------------------------------------------


def init_attention(b: ParamBuilder, cfg, cross: bool = False):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, G = cfg.num_heads, cfg.num_kv_heads
    b.param("wq", (d, H, hd), ("embed", "heads", "head_dim"))
    kv_in_dim = (cfg.frontend_dim or d) if cross else d
    b.param("wk", (kv_in_dim, G, hd), ("embed", "kv_heads", "head_dim"))
    b.param("wv", (kv_in_dim, G, hd), ("embed", "kv_heads", "head_dim"))
    b.param("wo", (H, hd, d), ("heads", "head_dim", "embed"),
            scale=1.0 / math.sqrt(H * hd))
    if getattr(cfg, "use_bias", False):
        b.param("bq", (H, hd), ("heads", "head_dim"), init="zeros")
        b.param("bv", (G, hd), ("kv_heads", "head_dim"), init="zeros")
        b.param("bo", (d,), ("embed",), init="zeros")
    if cross:
        # Llama-3.2-Vision style tanh gates on cross-attn output
        b.param("gate_attn", (1,), (None,), init="zeros", dtype=torch.float32)
    if cfg.qk_norm:
        b.param("q_norm_scale", (hd,), ("head_dim",), init="ones",
                dtype=torch.float32)
        b.param("k_norm_scale", (hd,), ("head_dim",), init="ones",
                dtype=torch.float32)


def _kv(p, kv_src, dtype):
    """k and v of kv_src. The rules map no mesh axis to wk's and wv's kv
    heads, so under a mesh each model rank computes its own kv heads
    where they divide the model axis (the ones the attention body reads
    on that rank); where they do not (glm4-9b's 2 kv heads on a 16-way
    axis), each computes its share of the batch, and k and v are gathered
    whole on every model rank, as the reference's `constrain` of k and v
    asks."""
    project = layout().project_in
    return (project(kv_src, p["wk"].to(dtype), "bsd,dgk->bsgk", split="g"),
            project(kv_src, p["wv"].to(dtype), "bsd,dgk->bsgk", split="g"))


def _qkv(p, cfg, x, kv_src=None):
    kv_src = x if kv_src is None else kv_src
    q = layout().project_in(x, p["wq"].to(x.dtype), "bsd,dhk->bshk")
    k, v = _kv(p, kv_src, x.dtype)
    q = constrain(q, "dp", None, "tp", None)
    k = constrain(k, "dp", None, None, None)
    v = constrain(v, "dp", None, None, None)
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
    y = layout().project_out(o, p["wo"].to(o.dtype), "bshk,hkd->bsd")
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


def _gate(p, y):
    """y * tanh(gate_attn), the tanh in float32 and cast to y's dtype."""
    return y * torch.tanh(p["gate_attn"]).to(y.dtype)


def attention_forward(
    p,
    cfg,
    x: torch.Tensor,          # [B, S, d]
    positions: torch.Tensor,  # [S] absolute positions
    kind: Optional[str] = None,
    window: Optional[int] = None,
    kv_src: Optional[torch.Tensor] = None,  # cross-attention source
) -> torch.Tensor:
    cross = kv_src is not None
    q, k, v = _qkv(p, cfg, x, kv_src)
    if cfg.use_rope and not cross:
        # q,k are [B,S,H,D]: rope over S with head axis trailing
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kind, window = _mask_of(cfg, kind, window)
    o = blocked_attention(q, k, v, kind=kind, window=window)
    y = _out_proj(p, o)
    if cross and "gate_attn" in p:
        y = _gate(p, y)
    return y


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
    o = prefill_attend(q, k, v, kind=kind, window=window)
    y = _out_proj(p, o)
    take = min(cache_len, S)
    pad = cache_len - take
    k_c = _pad_seq(k[:, S - take:], pad)
    v_c = _pad_seq(v[:, S - take:], pad)
    pos_c = F.pad(positions[S - take:], (0, pad), value=-1)
    pos_c = pos_c.to(torch.int32).expand(B, cache_len).contiguous()
    return y, {"k": k_c, "v": v_c, "pos": pos_c}


def cache_length(cfg, context_len: int) -> int:
    """KV-cache capacity for a decode shape with `context_len` of context."""
    if cfg.attention_kind == "sliding" and cfg.sliding_window > 0:
        return min(context_len, cfg.sliding_window)
    if cfg.attention_kind == "local" and cfg.local_window > 0:
        return min(context_len, cfg.local_window)
    return context_len


def attention_cache_spec(cfg, batch: int, context: int):
    """`attention_prefill`'s cache for `context` positions, as meta
    tensors: k, v [B, cache_length, G, D] and pos [B, cache_length]."""
    clen = cache_length(cfg, context)
    kv, adt = (batch, clen, cfg.num_kv_heads, cfg.resolved_head_dim), \
        dtype_of(cfg.activation_dtype)
    return {"k": meta(kv, adt), "v": meta(kv, adt),
            "pos": meta((batch, clen), torch.int32)}


def attention_decode(p, cfg, x, cache, cur_pos,
                     window: Optional[int] = None, attend_fn=None):
    """One-token decode. x: [B, 1, d]; cache k/v: [B, Sc, G, D], pos [B, Sc];
    cur_pos [B]. Writes the new token at slot cur_pos % Sc (ring semantics)
    into copies of the cache tensors; the given cache is left as it was.
    attend_fn lets the distributed runtime substitute seq-sharded
    attention."""
    Sc = cache["k"].shape[1]
    q, k, v = _qkv(p, cfg, x)
    if cfg.use_rope:
        pos2 = cur_pos[:, None]  # [B,1]
        q = apply_rope(q, pos2, cfg.rope_theta)
        k = apply_rope(k, pos2, cfg.rope_theta)
    slot = (cur_pos % Sc).long()
    write = layout().write_slot
    with obs_trace.span("attn.cache_write"):
        k_cache = write(cache["k"], slot, k[:, 0])
        v_cache = write(cache["v"], slot, v[:, 0])
        pos_cache = write(cache["pos"], slot, cur_pos)
    if window is None:
        window = _config_window(cfg)
    fn = attend_fn or decode_attend
    o = fn(q[:, 0], k_cache, v_cache, pos_cache, cur_pos, window=window)
    y = _out_proj(p, o[:, None])
    return y, {"k": k_cache, "v": v_cache, "pos": pos_cache}


def cross_attention_decode(p, cfg, x, cache):
    """Decode-time cross attention against the static cross K/V built at
    prefill: every one of the Sc source rows is visible."""
    q = layout().project_in(x, p["wq"].to(x.dtype), "bsd,dhk->bshk")
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    B = x.shape[0]
    Sc = cache["k"].shape[1]
    pos = torch.arange(Sc, dtype=torch.int32, device=x.device).expand(B, Sc)
    o = decode_attend(q[:, 0], cache["k"], cache["v"], pos,
                      torch.full((B,), Sc, dtype=torch.int32,
                                 device=x.device))
    y = _out_proj(p, o[:, None])
    if "gate_attn" in p:
        y = _gate(p, y)
    return y


def cross_attention_build_cache(p, cfg, kv_src):
    k, v = _kv(p, kv_src, kv_src.dtype)
    if "bv" in p:
        v = v + p["bv"].to(kv_src.dtype)
    return {"k": k, "v": v}


def cross_attention_cache_spec(cfg, batch: int, context: int):
    """`cross_attention_build_cache`'s cache as meta tensors: k, v [B, n,
    G, D] over the encoder's or the frontend's n positions."""
    n = cfg.encoder_seq_len or cfg.num_frontend_tokens
    kv, adt = (batch, n, cfg.num_kv_heads, cfg.resolved_head_dim), \
        dtype_of(cfg.activation_dtype)
    return {"k": meta(kv, adt), "v": meta(kv, adt)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 Multi-head Latent Attention)
# ---------------------------------------------------------------------------


def init_mla(b: ParamBuilder, cfg):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    b.param("wq_a", (d, m.q_lora_rank), ("embed", None))
    b.param("q_norm", (m.q_lora_rank,), (None,), init="ones",
            dtype=torch.float32)
    b.param("wq_b", (m.q_lora_rank, H, dn + dr), (None, "heads", "head_dim"))
    b.param("wkv_a", (d, m.kv_lora_rank + dr), ("embed", None))
    b.param("kv_norm", (m.kv_lora_rank,), (None,), init="ones",
            dtype=torch.float32)
    b.param("wk_b", (m.kv_lora_rank, H, dn), (None, "heads", "head_dim"))
    b.param("wv_b", (m.kv_lora_rank, H, dv), (None, "heads", "head_dim"))
    b.param("wo", (H, dv, d), ("heads", "head_dim", "embed"),
            scale=1.0 / math.sqrt(H * dv))


def mla_latents(p, cfg, x, positions):
    """q (nope and rope parts), the compressed kv latent and the rope key
    shared by every head ([B, S, 1, dr]). The down-projections wq_a and
    wkv_a have no TP dim: under a mesh every model rank computes them
    whole, as the reference's shardings leave them."""
    m = cfg.mla
    dn = m.qk_nope_head_dim
    project = layout().project_in
    q_lat = _rms_head(project(x, p["wq_a"].to(x.dtype)), p["q_norm"])
    q = project(q_lat, p["wq_b"].to(x.dtype), "bsr,rhk->bshk")
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = project(x, p["wkv_a"].to(x.dtype))
    c_kv = _rms_head(kv[..., : m.kv_lora_rank], p["kv_norm"])
    k_rope = kv[..., m.kv_lora_rank:][:, :, None, :]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(m) -> float:
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def mla_forward(p, cfg, x, positions):
    """Train/prefill path: per-head K, V rebuilt from the latent (the
    non-absorbed form, cheaper for long sequences), then blocked
    attention."""
    return _mla_attend(p, cfg, x, mla_latents(p, cfg, x, positions))


def _mla_attend(p, cfg, x, latents):
    m = cfg.mla
    q_nope, q_rope, c_kv, k_rope = latents
    project = layout().project_in
    k_nope = project(c_kv, p["wk_b"].to(x.dtype), "bsr,rhk->bshk")
    v = project(c_kv, p["wv_b"].to(x.dtype), "bsr,rhk->bshk")
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat(
        [k_nope, k_rope.expand(*k_nope.shape[:3], m.qk_rope_head_dim)],
        dim=-1)
    o = blocked_attention(q_full, k_full, v, kind="causal",
                          scale=_mla_scale(m))
    return layout().project_out(o, p["wo"].to(o.dtype), "bshk,hkd->bsd")


def mla_prefill(p, cfg, x, positions, cache_len: int):
    """Forward + the latent cache {c_kv, k_rope, pos} of the last cache_len
    tokens (kv_lora_rank + qk_rope_head_dim values a token)."""
    latents = mla_latents(p, cfg, x, positions)
    y = _mla_attend(p, cfg, x, latents)
    c_kv, k_rope = latents[2:]
    B, S = x.shape[:2]
    take = min(cache_len, S)
    pad = cache_len - take
    c = F.pad(c_kv[:, S - take:], (0, 0, 0, pad))
    kr = F.pad(k_rope[:, S - take:, 0], (0, 0, 0, pad))
    pos_c = F.pad(positions[S - take:], (0, pad), value=-1)
    pos_c = pos_c.to(torch.int32).expand(B, cache_len).contiguous()
    return y, {"c_kv": c, "k_rope": kr, "pos": pos_c}


def mla_cache_spec(cfg, batch: int, context: int):
    """`mla_prefill`'s latent cache for `context` positions, as meta
    tensors: c_kv [B, cache_length, kv_lora_rank], k_rope [B, cache_length,
    qk_rope_head_dim], pos [B, cache_length]."""
    m, clen = cfg.mla, cache_length(cfg, context)
    adt = dtype_of(cfg.activation_dtype)
    return {"c_kv": meta((batch, clen, m.kv_lora_rank), adt),
            "k_rope": meta((batch, clen, m.qk_rope_head_dim), adt),
            "pos": meta((batch, clen), torch.int32)}


def mla_decode(p, cfg, x, cache, cur_pos):
    """Absorbed-form decode: q_nope folded through wk_b scores against the
    latent cache directly; the latent context goes through wv_b. Writes the
    new token at slot cur_pos % Sc into copies of the cache tensors."""
    m = cfg.mla
    Sc = cache["c_kv"].shape[1]
    q_nope, q_rope, c_kv_new, k_rope_new = mla_latents(
        p, cfg, x, cur_pos[:, None])
    slot = (cur_pos % Sc).long()
    write = layout().write_slot
    with obs_trace.span("attn.cache_write"):
        c_cache = write(cache["c_kv"], slot, c_kv_new[:, 0])
        r_cache = write(cache["k_rope"], slot, k_rope_new[:, 0, 0])
        pos_cache = write(cache["pos"], slot, cur_pos)

    # absorb: q_eff[b,h,r] = q_nope . wk_b -> score against the latent
    q_abs = layout().project_in(q_nope[:, 0], p["wk_b"].to(x.dtype),
                                "bhk,rhk->bhr")
    logits = (
        torch.einsum("bhr,bsr->bhs", q_abs.float(), c_cache.float())
        + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(), r_cache.float())
    ) * _mla_scale(m)
    valid = (pos_cache >= 0) & (pos_cache <= cur_pos[:, None])
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    mmax = logits.amax(dim=-1, keepdim=True)
    pr = torch.exp(logits - mmax)
    pr = pr / pr.sum(dim=-1, keepdim=True)
    ctx_lat = torch.einsum("bhs,bsr->bhr", pr.to(c_cache.dtype).float(),
                           c_cache.float()).to(x.dtype)
    o = layout().project_in(ctx_lat, p["wv_b"].to(x.dtype), "bhr,rhk->bhk")
    y = layout().project_out(o, p["wo"].to(o.dtype), "bhk,hkd->bd")[:, None]
    return y, {"c_kv": c_cache, "k_rope": r_cache, "pos": pos_cache}
