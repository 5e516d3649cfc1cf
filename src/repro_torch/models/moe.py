"""Mixture-of-Experts layer (DBRX-style top-k, DeepSeek-V3 shared + routed);
port of `repro.models.moe`.

Implementations:
  - "scatter" (default): capacity-based dispatch. Each (token, rank)
    assignment takes the next free row of its expert's C-row buffer, or the
    drop slot once the expert is full; every expert then runs on its whole
    buffer, and the rows are gathered back and weighted.
  - "dense_mask": every expert computes every token, masked combine. The
    correctness oracle of the tests (no capacity drops when cf is large).
  - "expert_parallel" under hints whose mesh it runs on
    (`repro_torch.distributed.expert_parallel`): a local capacity dispatch
    over each model shard's own experts and one all-reduce over "model";
    hints with `moe_impl="expert_parallel"` turn "scatter" into it. Without
    hints it falls to "scatter", as in the reference.

The dispatch body is `distributed.expert_parallel._local_dispatch_ffn`, and
the router's count of assignments per expert and the body run through
`common.layout()`: on one device over every token and expert, under a
mesh's step on each rank's tokens and experts, the capacity positions
still counted in the global token order. That buffer is already the
placement the reference's `moe_expert_parallel` pin asks for (experts on
"model"); the hint pins it there even where the weights are replicated.

The body's expert FFN runs on the card as the routed-only kernel pair
`kernels.moe_experts` (only the experts the dispatch gave rows) where
`distributed.expert_parallel.expert_route` picks it: CUDA, bf16, no
gradient, gated SiLU, at most 16 capacity rows (a decode); elsewhere as
three `torch.bmm` over every expert's buffer (prefill, training, float32,
the CPU).

Under an active `obs.trace.Tracer`, the scatter sets its routing counts
(`_count_routing`) on the open `block.moe` span, from the router's own
count of assignments per expert, and the body the experts its FFN read;
with no tracer it computes nothing more.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.distributed.act_sharding import current
from repro_torch.models.common import ParamBuilder, activation, layout
from repro_torch.obs import trace as obs_trace


def init_moe(b: ParamBuilder, cfg):
    """The MoE layer's params under b's child "moe"."""
    init_moe_params(b.child("moe"), cfg)


def init_moe_params(c: ParamBuilder, cfg):
    mo = cfg.moe
    d = cfg.d_model
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
    return _route(p, cfg, x_flat)[:3]


def _route(p, cfg, x_flat):
    """`_router`'s (weights, idx, aux) and the assignments each expert
    got, float32 [E]."""
    mo = cfg.moe
    # column-parallel on the router's experts dim, as the reference's
    # shardings lay it out; the softmax and top-k read every expert's logit
    logits = layout().project_in(x_flat.float(), p["router"].float())
    probs = torch.softmax(layout().whole_dim(logits, 1), dim=-1)
    # sorted=True: descending, as jax.lax.top_k
    weights, idx = torch.topk(probs, mo.top_k, dim=-1, sorted=True)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing auxiliary loss: E * sum_e f_e * P_e
    E = mo.num_experts
    counts = layout().bincount(idx.reshape(-1), E)
    f = counts / torch.clamp(counts.sum(), min=1.0)
    P = probs.mean(dim=0)
    aux = E * torch.sum(f * P) * mo.aux_loss_coef
    return weights, idx, aux, counts


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
    project = layout().project_in
    h = project(x, p["shared_wi"].to(x.dtype))
    if cfg.use_glu:
        h = act(h) * project(x, p["shared_wg"].to(x.dtype))
    else:
        h = act(h)
    return layout().project_out(h, p["shared_wo"].to(x.dtype))


def capacity(cfg, tokens: int) -> int:
    """Rows per expert buffer: ceil(k * T * cf / E), at least 1."""
    mo = cfg.moe
    return max(1, int(math.ceil(mo.top_k * tokens * mo.capacity_factor
                                / mo.num_experts)))


def _count_routing(s, counts: torch.Tensor, assignments: int,
                   C: int) -> None:
    """The capacity dispatch's routing as attrs of span `s` where it is
    the open `block.moe`: `assignments` (T * k), `dropped` (those past
    their expert's C rows: sum over experts of max(0, count - C)) and
    `experts_used` (experts given an assignment). The dispatch body adds
    `experts_run`, the experts whose weights its FFN read (all E on the
    bmm route, those given a row on the kernel route). The counts stay
    device scalars until the trace is read."""
    if s is None or s.name != "block.moe":
        return
    s.set_attr(assignments=assignments,
               dropped=torch.clamp(counts - C, min=0).sum().to(torch.int64),
               experts_used=(counts > 0).sum())


def moe_forward_scatter(p, cfg, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss). Capacity-based scatter dispatch."""
    from repro_torch.distributed.expert_parallel import _local_dispatch_ffn
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    weights, idx, aux, counts = _route(p, cfg, xf)
    C = capacity(cfg, T)
    tracer = obs_trace.current_tracer()
    if tracer is not None:
        _count_routing(tracer.current_span(), counts, T * mo.top_k, C)

    def body(xf_, w_, i_, wi_, wg_, wo_, shard_id, E_loc, offset):
        return _local_dispatch_ffn(cfg, xf_, w_, i_, wi_, wg_, wo_, shard_id,
                                   E_loc, C, offset)

    h = current()
    pin = h is not None and getattr(h, "moe_expert_parallel", False)
    y = layout().experts(body, xf, weights, idx, p["wi"], p.get("wg"),
                         p["wo"], in_order=True,
                         expert_axes=(h.tp,) if pin and h.tp else None)
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
    h = current()
    if impl == "scatter" and h is not None and \
            getattr(h, "moe_impl", None) == "expert_parallel":
        impl = "expert_parallel"
    if impl == "expert_parallel" and h is not None:
        from repro_torch.distributed.expert_parallel import \
            moe_forward_expert_parallel
        return moe_forward_expert_parallel(p, cfg, x, h)
    if impl in ("scatter", "expert_parallel"):
        return moe_forward_scatter(p, cfg, x)
    if impl == "dense_mask":
        return moe_forward_dense(p, cfg, x)
    raise ValueError(impl)
