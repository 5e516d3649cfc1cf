"""Expert-parallel MoE over a `DeviceMesh` (port of
`repro.distributed.expert_parallel`; the DeepSpeed-MoE / GShard EP
pattern).

The parallelism is explicit:

  - tokens stay sharded over the data axes (every model shard sees the same
    local tokens);
  - each model shard owns E/tp experts and K-selects ITS tokens for ITS
    experts with a LOCAL capacity buffer (no global cumsum, no cross-shard
    scatter);
  - one all-reduce over the model axis combines expert outputs (each
    token's top-k experts live on different shards): the same wire cost as
    a Megatron row-parallel matmul. There is no all-to-all.

Expert weights may additionally be fsdp-sharded on their embed dim; each
rank gathers them just in time (ZeRO-3 semantics), unless the train step's
ZeRO-3 hook already did.

The reference's `shard_map` is `sharding.experts_on_shards` here: every
input is redistributed to the reference's in_specs (tokens, routing
weights and ids on the data axes; wi/wg/wo on "model" along the experts
dim, their fsdp dims gathered over the data axes) and handed to the body
as this rank's local tensors; the body's [T_loc, d] partial sum leaves as
a DTensor `Partial` on "model" and becomes `Replicate`, one all-reduce
whose backward autograd derives. Plain tensors are taken as replicated
(the same values on every rank) and the result comes back plain.

Capacity note: capacity is per (token-shard, expert): C_loc =
ceil(T_local * top_k * cf / E), statistically equivalent to the global
capacity for shuffled tokens, but a token that the global capacity keeps
may drop here when dp > 1 (and the reverse), exactly as in the reference;
correctness against the dense oracle is tested with a generous capacity
factor.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import moe_experts as me
from repro_torch.models.common import activation
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@functools.lru_cache(maxsize=1024)
def expert_route(device_type: str, dtype, E: int, C: int, d: int, f: int,
                 needs_grad: bool, act: Optional[str]) -> str:
    """"kernel" where `kernels.moe_experts.moe_experts` takes a dispatch's
    expert FFN: CUDA tensors, bf16 (`dtype` is the one dtype of the
    buffers and the three weights, None where they differ), no gradient
    needed, gated SiLU experts (`act` is the gated activation, None
    without a gate), and E experts of C rows, d and f that
    `experts_refusal` accepts (C <= 16: a decode's capacity); "bmm"
    otherwise. It reads only what it is given, so a test can ask it about
    a card's tensors on the CPU; cached, as the decode step asks it once an
    MoE layer."""
    if device_type != "cuda" or needs_grad or act != "silu":
        return "bmm"
    return "kernel" if me.experts_refusal(E, C, d, f, dtype) is None \
        else "bmm"


def _fills(counted, offset, e0: int, E_loc: int, C_loc: int):
    """Each local expert's rows that may hold a token, int32 [E_loc], from
    the inclusive cumsum of the one-hot assignments: its count, capped at
    C_loc; where `offset` places an expert's rows after those of earlier
    tokens, the rows up to its last kept one (0 for an expert with no
    assignment here)."""
    n = counted[-1]
    if offset is None:
        return torch.clamp(n, max=C_loc).to(torch.int32)
    end = torch.clamp(n + offset[e0:e0 + E_loc], max=C_loc)
    return torch.where(n > 0, end, 0).to(torch.int32)


def _note_experts_run(E_loc: int, fill=None) -> None:
    """`experts_run` of the open `block.moe` span, under a tracer: the
    experts whose weights the dispatch's FFN read, E_loc on the bmm route
    (`fill` None), those with fill > 0 on the kernel route (a device
    scalar). Computes nothing without a tracer."""
    tracer = obs_trace.current_tracer()
    if tracer is None:
        return
    s = tracer.current_span()
    if s is not None and s.name == "block.moe":
        s.set_attr(experts_run=E_loc if fill is None else (fill > 0).sum())


def _local_dispatch_ffn(cfg, xf, weights, idx, wi, wg, wo, shard_id, E_loc,
                        C_loc, offset: Optional[torch.Tensor] = None):
    """Per shard: xf [T_loc, d]; wi/wg/wo local expert weights [E_loc, ...];
    idx/weights [T_loc, k] global routing. Returns [T_loc, d] partial output
    (sum over THIS shard's experts only). `offset` [E] (the port's
    addition; None in the reference's path) counts each expert's
    assignments from tokens before xf's: a capacity over the global token
    order, which the mesh form of the scatter path uses. The experts' FFN
    runs on the routed-only kernel pair (`kernels.moe_experts`, reading
    only the experts given a row) where `expert_route` picks it, else as
    three `torch.bmm` over every expert's buffer; `moe.expert_route`
    counts each call's route."""
    T_loc, d = xf.shape
    k = idx.shape[1]
    e0 = shard_id * E_loc
    local = (idx >= e0) & (idx < e0 + E_loc)          # [T, k]
    lidx = torch.clamp(idx - e0, 0, E_loc - 1)

    a = lidx.reshape(T_loc * k)
    valid = local.reshape(T_loc * k)
    onehot = F.one_hot(a, E_loc).to(torch.int32) * valid[:, None]
    counted = torch.cumsum(onehot, dim=0)
    pos = counted - onehot                            # exclusive cumsum
    pos_in_e = pos.gather(1, a[:, None])[:, 0]
    if offset is not None:
        pos_in_e = pos_in_e + offset[e0:e0 + E_loc][a]
    keep = valid & (pos_in_e < C_loc)
    dest = torch.where(keep, a * C_loc + pos_in_e,
                       torch.full_like(a, E_loc * C_loc))  # the drop slot
    keep_x = keep[:, None].to(xf.dtype)

    x_rep = xf.repeat_interleave(k, dim=0)            # [T*k, d] token-major
    # a kept row's dest is unique, so its sum has one term; only the drop
    # slot, which is thrown away, takes several
    buf = torch.zeros((E_loc * C_loc + 1, d), dtype=xf.dtype,
                      device=xf.device)
    buf.index_add_(0, dest, x_rep * keep_x)
    expert_in = buf[: E_loc * C_loc].reshape(E_loc, C_loc, d)

    dt = xf.dtype
    mats = (wi, wo) if wg is None else (wi, wg, wo)
    needs_grad = torch.is_grad_enabled() and (
        xf.requires_grad or any(w.requires_grad for w in mats))
    route = expert_route(
        xf.device.type, dt if all(w.dtype == dt for w in mats) else None,
        E_loc, C_loc, d, wi.shape[-1], needs_grad,
        None if wg is None else cfg.act)
    obs_metrics.current().counter("moe.expert_route", route=route).inc()
    if route == "kernel":
        fill = _fills(counted, offset, e0, E_loc, C_loc)
        _note_experts_run(E_loc, fill)
        out = me.moe_experts(expert_in, fill, wi, wg, wo)
    else:
        _note_experts_run(E_loc)
        act = activation(cfg.act)
        h = torch.bmm(expert_in, wi.to(dt))
        if wg is not None:
            h = act(h) * torch.bmm(expert_in, wg.to(dt))
        else:
            h = act(h)
        out = torch.bmm(h, wo.to(dt))
    out = out.reshape(E_loc * C_loc, d)
    out = torch.cat([out, torch.zeros((1, d), dtype=out.dtype,
                                      device=out.device)], dim=0)
    gathered = out[dest] * (weights.reshape(T_loc * k, 1).to(xf.dtype)
                            * keep_x)
    return gathered.reshape(T_loc, k, d).sum(dim=1)


def moe_forward_expert_parallel(p, cfg, x: torch.Tensor, hints
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d]. Requires act_sharding hints (mesh + axes)."""
    from repro_torch.distributed.sharding import (MESH_OPS, axis_sizes,
                                                  experts_on_shards)
    from repro_torch.models.common import use_layout
    from repro_torch.models.moe import _router, _shared_ffn

    mo = cfg.moe
    mesh = hints.mesh
    tp = hints.tp
    E = mo.num_experts
    tp_size = axis_sizes(mesh)[tp] if tp else 1
    assert E % tp_size == 0, (E, tp_size)
    E_loc = E // tp_size

    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    with use_layout(MESH_OPS):  # the router's count on DTensor tokens
        weights, idx, aux = _router(p, cfg, xf)

    dp_size = hints.axis_size("dp")
    T_loc = T // max(dp_size, 1)
    C_loc = max(1, int(math.ceil(T_loc * mo.top_k * mo.capacity_factor / E)))

    use_glu = "wg" in p
    assert use_glu, ("expert-parallel path expects GLU experts (all our MoE "
                     "archs)")

    def body(xf_, w_, i_, wi_, wg_, wo_, sid, e_loc, offset):
        assert e_loc == E_loc, (e_loc, E_loc)
        return _local_dispatch_ffn(cfg, xf_, w_, i_, wi_, wg_, wo_, sid,
                                   E_loc, C_loc)

    y = experts_on_shards(body, xf, weights, idx, p["wi"], p["wg"], p["wo"],
                          mesh=mesh, token_axes=hints.dp,
                          expert_axes=(tp,) if tp else (), in_order=False)
    if mo.num_shared_experts > 0:
        y = y + _shared_ffn(p, cfg, xf)
    return y.reshape(B, S, d), aux
