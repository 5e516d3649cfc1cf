"""Mixture-of-Experts layer (DBRX-style top-k, DeepSeek-V3 shared + routed);
port of `repro.models.moe`.

Two implementations:
  - "scatter" (default): capacity-based dispatch. Each (token, rank)
    assignment takes the next free row of its expert's C-row buffer, or the
    drop slot once the expert is full; every expert then runs on its whole
    buffer, and the rows are gathered back and weighted.
  - "dense_mask": every expert computes every token, masked combine. The
    correctness oracle of the tests (no capacity drops when cf is large).

The reference's "expert_parallel" path (a local dispatch with an
all-to-all over the "model" group) and its pin of the dispatch buffer to
experts on the "model" axis (under hints with `moe_expert_parallel`) are
not ported yet (ROADMAP Queue 1 item 12b: expert parallelism).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamBuilder, activation


def init_moe(b: ParamBuilder, cfg):
    mo = cfg.moe
    d = cfg.d_model
    c = b.child("moe")
    c.param("router", (d, mo.num_experts), ("embed", "experts"),
            scale=1.0 / math.sqrt(d), reads_float32=True)
    ff = mo.d_ff_expert
    c.param("wi", (mo.num_experts, d, ff), ("experts", "embed", "expert_mlp"))
    if cfg.use_glu:
        c.param("wg", (mo.num_experts, d, ff),
                ("experts", "embed", "expert_mlp"))
    c.param("wo", (mo.num_experts, ff, d), ("experts", "expert_mlp", "embed"))
    if mo.num_shared_experts > 0:
        ffs = (mo.d_ff_shared or ff) * mo.num_shared_experts
        c.param("shared_wi", (d, ffs), ("embed", "mlp"))
        if cfg.use_glu:
            c.param("shared_wg", (d, ffs), ("embed", "mlp"))
        c.param("shared_wo", (ffs, d), ("mlp", "embed"))


def _router(p, cfg, x_flat):
    """Top-k routing in float32. Returns (weights [T,k], idx [T,k],
    aux_loss scalar)."""
    mo = cfg.moe
    logits = torch.matmul(x_flat.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    # sorted=True: descending, as jax.lax.top_k
    weights, idx = torch.topk(probs, mo.top_k, dim=-1, sorted=True)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing auxiliary loss: E * sum_e f_e * P_e
    E = mo.num_experts
    f = torch.bincount(idx.reshape(-1), minlength=E).float()
    f = f / torch.clamp(f.sum(), min=1.0)
    P = probs.mean(dim=0)
    aux = E * torch.sum(f * P) * mo.aux_loss_coef
    return weights, idx, aux


def _expert_ffn(p, cfg, h_in):
    """h_in: [E, C, d] -> [E, C, d]."""
    act = activation(cfg.act)
    h = torch.bmm(h_in, p["wi"].to(h_in.dtype))
    if cfg.use_glu:
        h = act(h) * torch.bmm(h_in, p["wg"].to(h_in.dtype))
    else:
        h = act(h)
    return torch.bmm(h, p["wo"].to(h_in.dtype))


def _shared_ffn(p, cfg, x):
    act = activation(cfg.act)
    h = torch.matmul(x, p["shared_wi"].to(x.dtype))
    if cfg.use_glu:
        h = act(h) * torch.matmul(x, p["shared_wg"].to(x.dtype))
    else:
        h = act(h)
    return torch.matmul(h, p["shared_wo"].to(x.dtype))


def capacity(cfg, tokens: int) -> int:
    """Rows per expert buffer: ceil(k * T * cf / E), at least 1."""
    mo = cfg.moe
    return max(1, int(math.ceil(mo.top_k * tokens * mo.capacity_factor
                                / mo.num_experts)))


def moe_forward_scatter(p, cfg, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss). Capacity-based scatter dispatch."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    weights, idx, aux = _router(p, cfg, xf)

    E, k = mo.num_experts, mo.top_k
    C = capacity(cfg, T)
    # assignment-major order: token t rank r -> row t*k + r
    a = idx.reshape(T * k)
    onehot = F.one_hot(a, E).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - onehot  # exclusive cumsum
    pos_in_expert = pos.gather(1, a[:, None])[:, 0]
    keep = pos_in_expert < C
    dest = torch.where(keep, a * C + pos_in_expert,
                       torch.full_like(a, E * C))  # E*C = drop slot
    keep_x = keep[:, None].to(x.dtype)

    x_rep = xf.repeat_interleave(k, dim=0)  # [T*k, d] token-major
    # a kept row's dest is unique, so its sum has one term; only the drop
    # slot, which is thrown away, takes several
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, dest, x_rep * keep_x)
    expert_in = buf[: E * C].reshape(E, C, d)
    expert_out = _expert_ffn(p, cfg, expert_in).reshape(E * C, d)
    expert_out = torch.cat(
        [expert_out, torch.zeros((1, d), dtype=expert_out.dtype,
                                 device=x.device)], dim=0)

    gathered = expert_out[dest] * (
        weights.reshape(T * k, 1).to(x.dtype) * keep_x)
    y = gathered.reshape(T, k, d).sum(dim=1)
    if mo.num_shared_experts > 0:
        y = y + _shared_ffn(p, cfg, xf)
    return y.reshape(B, S, d), aux


def moe_forward_dense(p, cfg, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: all experts compute all tokens; combine with routing
    weights."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    weights, idx, aux = _router(p, cfg, xf)
    # combine weights as dense [T, E]
    w_dense = torch.zeros((T, mo.num_experts), dtype=x.dtype,
                          device=x.device)
    w_dense.scatter_(1, idx, weights.to(x.dtype))
    all_in = xf[None].expand(mo.num_experts, T, d)
    all_out = _expert_ffn(p, cfg, all_in)  # [E, T, d]
    y = torch.einsum("etd,te->td", all_out, w_dense)
    if mo.num_shared_experts > 0:
        y = y + _shared_ffn(p, cfg, xf)
    return y.reshape(B, S, d), aux


def moe_forward(p, cfg, x, impl: str = "scatter"):
    if impl == "scatter":
        return moe_forward_scatter(p, cfg, x)
    if impl == "dense_mask":
        return moe_forward_dense(p, cfg, x)
    if impl == "expert_parallel":
        raise NotImplementedError(
            "moe_impl='expert_parallel' is not ported yet (ROADMAP Queue 1 "
            "item 12b: expert parallelism)")
    raise ValueError(impl)
