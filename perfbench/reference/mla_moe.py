"""Plain float32 reference of a decoder with DeepSeek's multi-head latent
attention (MLA) and a capacity-dispatched mixture of experts, as the
port's model files define them (`models/attention.py` MLA,
`models/moe.py` and its dispatch body `_local_dispatch_ffn`,
`models/transformer.py`).

MLA: q = RMSNorm(x wq_a) wq_b, split into a nope part and a RoPE part;
the latent c = RMSNorm((x wkv_a)[:kv_lora]) and one RoPE key shared by
the heads, (x wkv_a)[kv_lora:]; per head k = [c wk_b, k_rope] and
v = c wv_b; causal softmax at scale 1/sqrt(nope + rope); the output
projection wo. Prefill computes k and v per head; decode uses the
absorbed identity (q_nope wk_b scored against the latent, the latent
context through wv_b), the same sums in another order.

MoE: a float32 router (softmax over the experts, the top k in descending
order, weights renormalised to sum 1), then each expert's SwiGLU, plus
the shared expert on every token. The experts' capacity is the port's:
C = max(1, ceil(k * T * capacity_factor / E)) rows an expert over the T
tokens of one call, assignments taking rows in token-major order (token,
then rank), the ones past C dropped. The engine calls the model once
for a wave's prefill (T = batch * padded prompt, row-major) and once a
decode step (T = batch), so the drops depend on the whole wave: this
reference replays the wave in lockstep, every row, each step fed the
tokens the engine fed it (`wave["fed"]`, recorded at `Model.decode_step`
by the harness): a row's served tokens, and where a row has finished and
the engine keeps decoding it, the tokens the engine sampled for it. An
active row's served token is read from `served` (the tokens judged).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference.common import (FLOAT32, Precision, act, blocks,
                                        proj, rms, rope, silu, weight)

ROWS_INDEPENDENT = False

# float32 bytes of expert weights upcast at once
EXPERT_CHUNK_BYTES = 6 << 30


def _latents(a, run, x, pos, prec):
    """x [..., d] at positions pos (broadcast to x's leading dims but the
    last): (q_nope, q_rope, c, k_rope)."""
    m = run["mla"]
    eps = run["norm_eps"]
    dn = m["qk_nope_head_dim"]
    q = proj(rms(proj(x, a["wq_a"], prec), a["q_norm"], eps), a["wq_b"],
             prec)
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], pos, run["rope_theta"])
    kv = proj(x, a["wkv_a"], prec)
    r = m["kv_lora_rank"]
    c = rms(kv[..., :r], a["kv_norm"], eps)
    k_rope = rope(kv[..., r:][..., None, :], pos, run["rope_theta"])[..., 0, :]
    return q_nope, q_rope, c, k_rope


def _scale(run) -> float:
    m = run["mla"]
    return 1.0 / math.sqrt(m["qk_nope_head_dim"] + m["qk_rope_head_dim"])


def _prefill_attention(a, run, x, prec, cache):
    """x [B, S, d]: causal MLA over each row; fills cache[:, :S]."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q_nope, q_rope, c, k_rope = _latents(a, run, x, pos, prec)
    cache["c"][:, :S] = c
    cache["k_rope"][:, :S] = k_rope
    out = []
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for b in range(B):
        k_nope = proj(c[b], a["wk_b"], prec)           # [S, H, dn]
        v = proj(c[b], a["wv_b"], prec)                # [S, H, dv]
        sc = (torch.einsum("qhd,khd->hqk", q_nope[b], k_nope)
              + torch.einsum("qhd,kd->hqk", q_rope[b], k_rope[b]))
        sc = (sc * _scale(run)).masked_fill(~mask, float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), v)
        out.append(proj(o.reshape(S, -1), a["wo"], prec, n_in=2))
    return torch.stack(out)


def _decode_attention(a, run, x, p, prec, cache):
    """x [B, d], the token at position p of every row (the wave is
    left-padded, so all rows share it)."""
    pos = torch.tensor(p, device=x.device)
    q_nope, q_rope, c, k_rope = _latents(a, run, x[:, None], pos[None],
                                         prec)
    cache["c"][:, p] = c[:, 0]
    cache["k_rope"][:, p] = k_rope[:, 0]
    C, KR = cache["c"][:, : p + 1], cache["k_rope"][:, : p + 1]
    wk_b = weight(a["wk_b"], prec)                     # [r, H, dn]
    q_abs = torch.einsum("bhk,rhk->bhr", act(q_nope[:, 0], prec), wk_b)
    sc = (torch.einsum("bhr,bsr->bhs", q_abs, C)
          + torch.einsum("bhk,bsk->bhs", q_rope[:, 0], KR)) * _scale(run)
    ctx = torch.einsum("bhs,bsr->bhr", torch.softmax(sc, -1), C)
    wv_b = weight(a["wv_b"], prec)                     # [r, H, dv]
    o = torch.einsum("bhr,rhk->bhk", act(ctx, prec), wv_b)
    return proj(o.reshape(o.shape[0], -1), a["wo"], prec, n_in=2)


def _ffn(p, x, prec):
    return proj(silu(proj(x, p["wi"], prec)) * proj(x, p["wg"], prec),
                p["wo"], prec)


def route(router, run, X):
    """(weights [T, k], experts [T, k], kept [T, k]) of the T tokens of one
    call, in the port's capacity order."""
    mo = run["moe"]
    E, k = mo["num_experts"], mo["top_k"]
    probs = torch.softmax(X @ router.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1, sorted=True)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    T = X.shape[0]
    C = max(1, math.ceil(k * T * mo["capacity_factor"] / E))
    flat = idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, E).to(torch.int32)
    before = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])
    kept = (before[:, 0] < C).reshape(T, k)
    return w, idx, kept


def _experts(m, X, w, idx, kept, prec):
    """sum over each token's kept assignments of weight * expert(x)."""
    T, k = idx.shape
    tok = torch.arange(T, device=X.device)[:, None].expand(T, k)[kept]
    ex, wt = idx[kept], w[kept]
    order = torch.argsort(ex, stable=True)
    tok, ex, wt = tok[order], ex[order], wt[order]
    experts, counts = torch.unique_consecutive(ex, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    d, ff = m["wi"].shape[1], m["wi"].shape[2]
    chunk = max(1, EXPERT_CHUNK_BYTES // (3 * d * ff * 4))
    y = torch.zeros_like(X)
    experts_l, counts_l = experts.tolist(), counts.tolist()
    starts_l = starts.tolist()
    for c0 in range(0, len(experts_l), chunk):
        es = experts_l[c0: c0 + chunk]
        cn = counts[c0: c0 + chunk]
        a0 = starts_l[c0]
        a1 = starts_l[c0 + len(es) - 1] + counts_l[c0 + len(es) - 1]
        le = torch.repeat_interleave(torch.arange(len(es), device=X.device),
                                     cn)
        pos = torch.arange(a1 - a0, device=X.device) - torch.repeat_interleave(
            starts[c0: c0 + len(es)] - a0, cn)
        buf = torch.zeros(len(es), int(cn.max()), d, device=X.device)
        buf[le, pos] = X[tok[a0:a1]]
        sel = torch.as_tensor(es, device=X.device)
        buf = act(buf, prec)
        h = silu(buf @ weight(m["wi"][sel], prec)) * (
            buf @ weight(m["wg"][sel], prec))
        out = act(h, prec) @ weight(m["wo"][sel], prec)
        y.index_add_(0, tok[a0:a1], out[le, pos] * wt[a0:a1, None])
    return y


def _moe(m, run, X, prec):
    """X [T, d], the tokens of one engine call in its order."""
    w, idx, kept = route(m["router"], run, X)
    y = _experts(m, X, w, idx, kept, prec)
    if "shared_wi" in m:
        y = y + proj(silu(proj(X, m["shared_wi"], prec))
                     * proj(X, m["shared_wg"], prec), m["shared_wo"], prec)
    return y


def _ffn_block(blk, run, h, prec):
    if "moe" in blk:
        return _moe(blk["moe"], run, h.reshape(-1, h.shape[-1]),
                    prec).reshape(h.shape)
    return _ffn(blk["mlp"], h, prec)


def _logits(params, run, x, prec):
    return proj(rms(x, params["final_norm"]["scale"], run["norm_eps"]),
                params["lm_head"], prec)


@torch.no_grad()
def served_logits(params, run: dict, wave: dict, rows: List[int],
                  prec: Precision = FLOAT32) -> Dict[int, torch.Tensor]:
    """{row: float32 logits [n, V]} at the positions that produced row's
    served tokens, from a lockstep replay of the whole wave: the prefill
    over the padded [B, S] prompts, then max(served lengths) - 1 decode
    steps of every row, fed `wave["fed"]` [steps, B] where a row has no
    served token left."""
    dev = params["embed"].device
    eps = run["norm_eps"]
    toks = torch.as_tensor(wave["tokens"], dtype=torch.long, device=dev)
    served = [list(s) for s in wave["served"]]
    B, S = toks.shape
    steps = max(len(s) for s in served) - 1
    blks = blocks(params)
    m = run["mla"]
    caches = [{"c": torch.zeros(B, S + steps, m["kv_lora_rank"],
                                device=dev),
               "k_rope": torch.zeros(B, S + steps, m["qk_rope_head_dim"],
                                     device=dev)} for _ in blks]
    x = params["embed"][toks].float()
    for blk, cache in zip(blks, caches):
        x = x + _prefill_attention(blk["attn"], run,
                                   rms(x, blk["ln_attn"]["scale"], eps),
                                   prec, cache)
        x = x + _ffn_block(blk, run, rms(x, blk["ln_mlp"]["scale"], eps),
                           prec)
    logits = [_logits(params, run, x[:, -1], prec)]    # [B, V] each step
    for i in range(1, steps + 1):
        recorded = torch.as_tensor(wave["fed"][i - 1], dtype=torch.long,
                                   device=dev)
        fed = torch.as_tensor([s[i - 1] if i - 1 < len(s) else -1
                               for s in served], device=dev)
        fed = torch.where(fed >= 0, fed, recorded)
        x = params["embed"][fed].float()
        for blk, cache in zip(blks, caches):
            x = x + _decode_attention(blk["attn"], run,
                                      rms(x, blk["ln_attn"]["scale"], eps),
                                      S + i - 1, prec, cache)
            x = x + _ffn_block(blk, run, rms(x, blk["ln_mlp"]["scale"], eps),
                               prec)
        logits.append(_logits(params, run, x, prec))
    return {r: torch.stack([logits[i][r] for i in range(len(served[r]))])
            for r in rows}
