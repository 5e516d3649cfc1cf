"""Block composition and stacks of repeated groups (port of
`repro.models.transformer`).

A stack is factored as (prefix, repeated group, suffix):
  dense:           ([], (attention,), L, [])
  deepseek-v3:     ([attention]*3, (moe_attention,), 58, [])
  dbrx:            ([], (moe_attention,), 40, [])
  recurrentgemma:  ([], (recurrent, recurrent, attention), 8, [recurrent]*2)
  xlstm:           ([], (mlstm, slstm), 12, [])
  vision-90b:      ([], (attention x4, cross_attention), 20, [])
  whisper decoder: ([], (encdec_attention,), 4, [])

With scan_layers the repeated group's params are stacked along a leading
axis (`groups`), as the reference stacks them for `jax.lax.scan`; here a
Python loop walks the group index, and the per-group caches are stacked
the same way. `kinds_override` gives a plain list of block kinds in place
of the config's plan (the whisper encoder).

`stack_forward` runs each prefix and suffix block, and each group, under
`cfg.remat_policy` (torch.utils.checkpoint in place of jax.checkpoint).
Under hints with `zero3_gather` it first redistributes the block's DTensor
params to their TP-only placements (`act_sharding.gather_params` over
`stack_axes(cfg)`); without hints the params go in as they are.

Blocks read `extras`, as the reference's do: `kv_src` (the cross-attention
source), `chunk` (the mLSTM chunk, default `cfg.scan_chunk`) and `moe_impl`
(default "scatter"). `stack_forward` returns the blocks' summed aux loss.

Spans (`obs.trace`; no-ops with no tracer): in `block_prefill` and
`block_decode`, an (moe_)attention block opens `block.attention` (the
pre-norm, the attention sub-layer with its cache write, the residual add)
and then `block.mlp` or `block.moe` (the pre-norm and the feed-forward
half); `stack_decode` opens `stack.restack` around the stacking of the
groups' new caches. The other block kinds and `block_forward` (training)
open none.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import functools

import torch

from repro_torch.distributed import act_sharding
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (ParamBuilder, apply_mlp, apply_norm,
                                       init_mlp, init_norm, layout, map_axes,
                                       stack_axes as _stack_axes_tree,
                                       stack_params, use_layout)
from repro_torch.obs import trace as obs_trace

PyTree = Any


# ---------------------------------------------------------------------------
# Stack plan
# ---------------------------------------------------------------------------


def layer_kinds(cfg) -> List[str]:
    if cfg.is_encoder_decoder:
        return ["encdec_attention"] * cfg.num_layers
    if cfg.block_pattern:
        pat = cfg.block_pattern
        return [pat[i % len(pat)] for i in range(cfg.num_layers)]
    if cfg.cross_attn_every > 0:
        kinds = []
        while len(kinds) < cfg.num_layers:
            for _ in range(cfg.cross_attn_every):
                if len(kinds) < cfg.num_layers:
                    kinds.append("attention")
            if len(kinds) < cfg.num_layers:
                kinds.append("cross_attention")
        return kinds
    if cfg.moe is not None:
        nd = cfg.moe.first_dense_layers
        return ["attention"] * nd + ["moe_attention"] * (cfg.num_layers - nd)
    return ["attention"] * cfg.num_layers


def stack_plan(cfg) -> Tuple[List[str], Tuple[str, ...], int, List[str]]:
    """Returns (prefix_kinds, group_kinds, n_groups, suffix_kinds)."""
    kinds = layer_kinds(cfg)
    if not cfg.scan_layers:
        return kinds, (), 0, []
    # choose the repeating unit
    if cfg.is_encoder_decoder:
        unit: Tuple[str, ...] = ("encdec_attention",)
    elif cfg.block_pattern:
        unit = tuple(cfg.block_pattern)
    elif cfg.cross_attn_every > 0:
        unit = tuple(["attention"] * cfg.cross_attn_every + ["cross_attention"])
    elif cfg.moe is not None:
        unit = ("moe_attention",)
    else:
        unit = ("attention",)
    # strip non-matching prefix (e.g. dsv3 leading dense layers)
    prefix: List[str] = []
    i = 0
    while i < len(kinds) and kinds[i] != unit[0]:
        prefix.append(kinds[i])
        i += 1
    rest = kinds[i:]
    n_groups = 0
    j = 0
    while j + len(unit) <= len(rest) and tuple(rest[j: j + len(unit)]) == unit:
        n_groups += 1
        j += len(unit)
    suffix = rest[j:]
    if n_groups == 0:
        return kinds, (), 0, []
    return prefix, unit, n_groups, suffix


# ---------------------------------------------------------------------------
# Single block init / forward / prefill / decode
# ---------------------------------------------------------------------------


def init_block(b: ParamBuilder, cfg, kind: str):
    if kind in ("attention", "moe_attention"):
        init_norm(b, "ln_attn", cfg.d_model, cfg.norm)
        a = b.child("attn")
        if cfg.mla is not None:
            attn.init_mla(a, cfg)
        else:
            attn.init_attention(a, cfg)
        init_norm(b, "ln_mlp", cfg.d_model, cfg.norm)
        if kind == "moe_attention":
            moe_mod.init_moe(b, cfg)
        else:
            init_mlp(b, cfg.d_model, cfg.d_ff, cfg.use_glu)
    elif kind == "cross_attention":
        init_norm(b, "ln_attn", cfg.d_model, cfg.norm)
        attn.init_attention(b.child("attn"), cfg, cross=True)
        init_norm(b, "ln_mlp", cfg.d_model, cfg.norm)
        init_mlp(b, cfg.d_model, cfg.d_ff, cfg.use_glu)
        b.param("gate_mlp", (1,), (None,), init="zeros", dtype=torch.float32)
    elif kind == "encdec_attention":
        init_norm(b, "ln_self", cfg.d_model, cfg.norm)
        attn.init_attention(b.child("self_attn"), cfg)
        init_norm(b, "ln_cross", cfg.d_model, cfg.norm)
        attn.init_attention(b.child("cross_attn"), cfg, cross=True)
        init_norm(b, "ln_mlp", cfg.d_model, cfg.norm)
        init_mlp(b, cfg.d_model, cfg.d_ff, cfg.use_glu)
    elif kind == "encoder_attention":
        init_norm(b, "ln_attn", cfg.d_model, cfg.norm)
        attn.init_attention(b.child("attn"), cfg)
        init_norm(b, "ln_mlp", cfg.d_model, cfg.norm)
        init_mlp(b, cfg.d_model, cfg.d_ff, cfg.use_glu)
    elif kind == "recurrent":
        init_norm(b, "ln_rec", cfg.d_model, cfg.norm)
        rec_mod.init_recurrent_block(b.child("rec"), cfg)
        init_norm(b, "ln_mlp", cfg.d_model, cfg.norm)
        init_mlp(b, cfg.d_model, cfg.d_ff, cfg.use_glu)
    elif kind == "mlstm":
        init_norm(b, "ln", cfg.d_model, cfg.norm)
        xlstm_mod.init_mlstm_block(b.child("cell"), cfg)
    elif kind == "slstm":
        init_norm(b, "ln", cfg.d_model, cfg.norm)
        xlstm_mod.init_slstm_block(b.child("cell"), cfg)
    else:
        raise ValueError(kind)


# the span of an (moe_)attention block's feed-forward half
FFN_SPAN = {"attention": "block.mlp", "moe_attention": "block.moe"}


def _mlp(p, cfg, x):
    return apply_mlp(p["mlp"], apply_norm(p["ln_mlp"], x, cfg.norm), cfg.act,
                     cfg.use_glu)


def _ffn(p, cfg, kind: str, x, extras):
    """The feed-forward half of an (moe_)attention block: (y, aux)."""
    h = apply_norm(p["ln_mlp"], x, cfg.norm)
    if kind == "moe_attention":
        return moe_mod.moe_forward(p["moe"], cfg, h,
                                   extras.get("moe_impl", "scatter"))
    return apply_mlp(p["mlp"], h, cfg.act, cfg.use_glu), None


def _gated_mlp(p, cfg, x):
    """The cross_attention block's MLP residual, tanh-gated (the tanh in
    float32, cast to x's dtype)."""
    return x + _mlp(p, cfg, x) * torch.tanh(p["gate_mlp"]).to(x.dtype)


def _chunk(cfg, extras) -> int:
    return extras.get("chunk", cfg.scan_chunk)


def block_forward(p, cfg, kind: str, x, positions, extras
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, aux_loss); aux is None for a block without one."""
    aux = None
    if kind in ("attention", "moe_attention"):
        h = apply_norm(p["ln_attn"], x, cfg.norm)
        if cfg.mla is not None:
            y = attn.mla_forward(p["attn"], cfg, h, positions)
        else:
            y = attn.attention_forward(p["attn"], cfg, h, positions)
        x = x + y
        y, aux = _ffn(p, cfg, kind, x, extras)
        x = x + y
    elif kind == "cross_attention":
        h = apply_norm(p["ln_attn"], x, cfg.norm)
        x = x + attn.attention_forward(p["attn"], cfg, h, positions,
                                       kind="full", kv_src=extras["kv_src"])
        x = _gated_mlp(p, cfg, x)
    elif kind == "encdec_attention":
        h = apply_norm(p["ln_self"], x, cfg.norm)
        x = x + attn.attention_forward(p["self_attn"], cfg, h, positions,
                                       kind="causal")
        h = apply_norm(p["ln_cross"], x, cfg.norm)
        x = x + attn.attention_forward(p["cross_attn"], cfg, h, positions,
                                       kind="full", kv_src=extras["kv_src"])
        x = x + _mlp(p, cfg, x)
    elif kind == "encoder_attention":
        h = apply_norm(p["ln_attn"], x, cfg.norm)
        x = x + attn.attention_forward(p["attn"], cfg, h, positions,
                                       kind="full")
        x = x + _mlp(p, cfg, x)
    elif kind == "recurrent":
        h = apply_norm(p["ln_rec"], x, cfg.norm)
        x = x + rec_mod.recurrent_block_forward(p["rec"], cfg, h)
        x = x + _mlp(p, cfg, x)
    elif kind == "mlstm":
        h = apply_norm(p["ln"], x, cfg.norm)
        x = x + xlstm_mod.mlstm_block_forward(p["cell"], cfg, h,
                                              _chunk(cfg, extras))
    elif kind == "slstm":
        h = apply_norm(p["ln"], x, cfg.norm)
        x = x + xlstm_mod.slstm_block_forward(p["cell"], cfg, h)
    else:
        raise ValueError(kind)
    return x, aux


def block_prefill(p, cfg, kind: str, x, positions, cache_len: int, extras):
    """Returns (x, cache)."""
    if kind in ("attention", "moe_attention"):
        with obs_trace.span("block.attention"):
            h = apply_norm(p["ln_attn"], x, cfg.norm)
            if cfg.mla is not None:
                y, cache = attn.mla_prefill(p["attn"], cfg, h, positions,
                                            cache_len)
            else:
                y, cache = attn.attention_prefill(p["attn"], cfg, h,
                                                  positions, cache_len)
            x = x + y
        with obs_trace.span(FFN_SPAN[kind]):
            return x + _ffn(p, cfg, kind, x, extras)[0], cache
    if kind == "cross_attention":
        cache = attn.cross_attention_build_cache(p["attn"], cfg,
                                                 extras["kv_src"])
        h = apply_norm(p["ln_attn"], x, cfg.norm)
        x = x + attn.attention_forward(p["attn"], cfg, h, positions,
                                       kind="full", kv_src=extras["kv_src"])
        return _gated_mlp(p, cfg, x), cache
    if kind == "encdec_attention":
        h = apply_norm(p["ln_self"], x, cfg.norm)
        y, self_cache = attn.attention_prefill(p["self_attn"], cfg, h,
                                               positions, cache_len,
                                               kind="causal")
        x = x + y
        cross_cache = attn.cross_attention_build_cache(
            p["cross_attn"], cfg, extras["kv_src"])
        h = apply_norm(p["ln_cross"], x, cfg.norm)
        x = x + attn.attention_forward(p["cross_attn"], cfg, h, positions,
                                       kind="full", kv_src=extras["kv_src"])
        return x + _mlp(p, cfg, x), {"self": self_cache, "cross": cross_cache}
    if kind == "recurrent":
        h = apply_norm(p["ln_rec"], x, cfg.norm)
        y, state = rec_mod.recurrent_block_prefill(p["rec"], cfg, h)
        x = x + y
        return x + _mlp(p, cfg, x), state
    if kind == "mlstm":
        h = apply_norm(p["ln"], x, cfg.norm)
        y, state = xlstm_mod.mlstm_block_prefill(p["cell"], cfg, h,
                                                 _chunk(cfg, extras))
        return x + y, state
    if kind == "slstm":
        h = apply_norm(p["ln"], x, cfg.norm)
        y, state = xlstm_mod.slstm_block_prefill(p["cell"], cfg, h)
        return x + y, state
    raise ValueError(kind)


def block_decode(p, cfg, kind: str, x_t, cache, cur_pos, extras):
    """x_t: [B, 1, d]. Returns (x_t, new_cache). extras["attend_fn"], where
    given, replaces the decode attention of the self-attention blocks (the
    sequence-sharded decode, `distributed.decode_attention`)."""
    attend_fn = extras.get("attend_fn")
    if kind in ("attention", "moe_attention"):
        with obs_trace.span("block.attention"):
            h = apply_norm(p["ln_attn"], x_t, cfg.norm)
            if cfg.mla is not None:
                y, cache = attn.mla_decode(p["attn"], cfg, h, cache,
                                           cur_pos)
            else:
                y, cache = attn.attention_decode(p["attn"], cfg, h, cache,
                                                 cur_pos,
                                                 attend_fn=attend_fn)
            x_t = x_t + y
        with obs_trace.span(FFN_SPAN[kind]):
            return x_t + _ffn(p, cfg, kind, x_t, extras)[0], cache
    if kind == "cross_attention":
        h = apply_norm(p["ln_attn"], x_t, cfg.norm)
        x_t = x_t + attn.cross_attention_decode(p["attn"], cfg, h, cache)
        return _gated_mlp(p, cfg, x_t), cache
    if kind == "encdec_attention":
        h = apply_norm(p["ln_self"], x_t, cfg.norm)
        y, self_cache = attn.attention_decode(p["self_attn"], cfg, h,
                                              cache["self"], cur_pos,
                                              attend_fn=attend_fn)
        x_t = x_t + y
        h = apply_norm(p["ln_cross"], x_t, cfg.norm)
        x_t = x_t + attn.cross_attention_decode(p["cross_attn"], cfg, h,
                                                cache["cross"])
        return x_t + _mlp(p, cfg, x_t), {"self": self_cache,
                                         "cross": cache["cross"]}
    if kind == "recurrent":
        h = apply_norm(p["ln_rec"], x_t, cfg.norm)
        y, state = rec_mod.recurrent_block_decode(p["rec"], cfg, h, cache)
        x_t = x_t + y
        return x_t + _mlp(p, cfg, x_t), state
    if kind == "mlstm":
        h = apply_norm(p["ln"], x_t, cfg.norm)
        y, state = xlstm_mod.mlstm_block_decode(p["cell"], cfg, h, cache)
        return x_t + y, state
    if kind == "slstm":
        h = apply_norm(p["ln"], x_t, cfg.norm)
        y, state = xlstm_mod.slstm_block_decode(p["cell"], cfg, h, cache)
        return x_t + y, state
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Stack init / forward / prefill / decode (a loop over repeated groups)
# ---------------------------------------------------------------------------


def _plan(cfg, kinds_override: Optional[List[str]]):
    if kinds_override is not None:
        return list(kinds_override), (), 0, []
    return stack_plan(cfg)


def init_stack(b: ParamBuilder, cfg,
               kinds_override: Optional[List[str]] = None):
    """Initializes {'prefix': {...}, 'groups': stacked, 'suffix': {...}}."""
    prefix, unit, n_groups, suffix = _plan(cfg, kinds_override)
    s = b.child("stack")
    pfx = s.child("prefix")
    for i, kind in enumerate(prefix):
        init_block(pfx.child(f"l{i}"), cfg, kind)
    if n_groups:
        group_trees = []
        gb = None
        n_build = 1 if b.abstract else n_groups
        for _ in range(n_build):
            gb = ParamBuilder(s.generator, "float32", abstract=b.abstract)
            gb.dtype = s.dtype
            for pos, kind in enumerate(unit):
                init_block(gb.child(f"b{pos}"), cfg, kind)
            group_trees.append(gb.params)
        if b.abstract:
            group_trees = group_trees * n_groups
        s.params["groups"] = stack_params(group_trees)
        s.axes["groups"] = _stack_axes_tree(gb.axes)
        s.float32_read["groups"] = gb.float32_read
    sfx = s.child("suffix")
    for i, kind in enumerate(suffix):
        init_block(sfx.child(f"l{i}"), cfg, kind)


@functools.lru_cache(maxsize=64)
def stack_axes(cfg) -> Dict[str, Any]:
    """Logical-axes trees for the stack's prefix / group-slice / suffix params
    (group axes have the leading 'layers' dim stripped). Used by the ZeRO-3
    just-in-time weight-gather (distributed.act_sharding)."""
    b = ParamBuilder(None, cfg.param_dtype, abstract=True)
    init_stack(b, cfg)
    axes = b.axes["stack"]
    out = {"prefix": axes.get("prefix", {}), "suffix": axes.get("suffix", {})}
    if "groups" in axes:
        out["groups"] = map_axes(lambda a: tuple(a[1:]), axes["groups"])
    return out


def _dots_policy(ctx, func, *args, **kwargs):
    """Save the outputs of products without batch dims (2-D `mm`,
    `addmm`), recompute everything else: jax's
    `dots_with_no_batch_dims_saveable`, which also recomputes the batched
    products (attention's einsums, the MoE experts' bmm)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """`fn` under the config's rematerialisation policy (the reference's
    `_remat`): "none" as is; "full" saves only its inputs and recomputes
    the rest in the backward pass; "dots" also saves the matmul outputs.
    Memory changes, values do not: the recomputation repeats the same ops
    on the same inputs, under the layout ops and hints of the forward
    pass (the backward pass may run on another thread, the CUDA autograd
    engine's, which does not see the caller's thread-local contexts)."""
    if cfg.remat_policy == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _dots_policy)

    def wrapped(*args):
        ops, hints = layout(), act_sharding.current()

        def in_context(*a):
            with use_layout(ops), act_sharding.use_hints(hints):
                return fn(*a)
        return checkpoint(in_context, *args, use_reentrant=False, **kw)
    return wrapped


def _groups(tree: PyTree, n: int) -> List[PyTree]:
    """The n groups' slices of a tree stacked along axis 0, through one
    `unbind` per leaf: its backward stacks the n gradients once, where n
    selects would each add a zero-filled gradient of the whole stack."""
    if isinstance(tree, dict):
        per_key = {k: _groups(v, n) for k, v in tree.items()}
        return [{k: v[g] for k, v in per_key.items()} for g in range(n)]
    return list(tree.unbind(0))


def stack_forward(params, cfg, x, positions, extras,
                  kinds_override: Optional[List[str]] = None):
    """Returns (x, aux): aux is the blocks' summed aux loss, a float32
    scalar (0 without MoE blocks). Each prefix and suffix block, and each
    group of the repeated unit, runs under `cfg.remat_policy`."""
    prefix, unit, n_groups, suffix = _plan(cfg, kinds_override)
    sp = params["stack"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    # under hints, each block's (each group's) params are gathered inside
    # its remat region, so the backward pass gathers them again rather than
    # keeping them (the encoder's stack is gathered whole by the model)
    saxes = (stack_axes(cfg) if kinds_override is None
             and act_sharding.current() is not None else None)

    def one_block(kind, section, i):
        def f(p_blk, x, aux):
            if saxes is not None:
                p_blk = act_sharding.gather_params(p_blk,
                                                   saxes[section][f"l{i}"])
            x, a = block_forward(p_blk, cfg, kind, x, positions, extras)
            return x, aux if a is None else aux + a
        return _remat(f, cfg)

    def group_body(gp, x, aux):
        if saxes is not None:
            gp = act_sharding.gather_params(gp, saxes["groups"])
        for pos, kind in enumerate(unit):
            x, a = block_forward(gp[f"b{pos}"], cfg, kind, x, positions,
                                 extras)
            aux = aux if a is None else aux + a
        return x, aux

    for i, kind in enumerate(prefix):
        x, aux = one_block(kind, "prefix", i)(sp["prefix"][f"l{i}"], x, aux)
    if n_groups:
        body = _remat(group_body, cfg)
        for gp in _groups(sp["groups"], n_groups):
            x, aux = body(gp, x, aux)
    for i, kind in enumerate(suffix):
        x, aux = one_block(kind, "suffix", i)(sp["suffix"][f"l{i}"], x, aux)
    return x, aux


def stack_prefill(params, cfg, x, positions, cache_len, extras,
                  kinds_override: Optional[List[str]] = None):
    prefix, unit, n_groups, suffix = _plan(cfg, kinds_override)
    sp = params["stack"]
    caches: Dict[str, Any] = {"prefix": {}, "suffix": {}}
    for i, kind in enumerate(prefix):
        x, caches["prefix"][f"l{i}"] = block_prefill(
            sp["prefix"][f"l{i}"], cfg, kind, x, positions, cache_len, extras)
    if n_groups:
        per_group = []
        for gp in _groups(sp["groups"], n_groups):
            gcaches = {}
            for pos, kind in enumerate(unit):
                x, gcaches[f"b{pos}"] = block_prefill(
                    gp[f"b{pos}"], cfg, kind, x, positions, cache_len, extras)
            per_group.append(gcaches)
        caches["groups"] = stack_params(per_group)
    for i, kind in enumerate(suffix):
        x, caches["suffix"][f"l{i}"] = block_prefill(
            sp["suffix"][f"l{i}"], cfg, kind, x, positions, cache_len, extras)
    return x, caches


def stack_decode(params, cfg, x_t, caches, cur_pos, extras,
                 kinds_override: Optional[List[str]] = None):
    prefix, unit, n_groups, suffix = _plan(cfg, kinds_override)
    sp = params["stack"]
    new_caches: Dict[str, Any] = {"prefix": {}, "suffix": {}}
    for i, kind in enumerate(prefix):
        x_t, new_caches["prefix"][f"l{i}"] = block_decode(
            sp["prefix"][f"l{i}"], cfg, kind, x_t,
            caches["prefix"][f"l{i}"], cur_pos, extras)
    if n_groups:
        per_group = []
        for gp, gc in zip(_groups(sp["groups"], n_groups),
                          _groups(caches["groups"], n_groups)):
            ngc = {}
            for pos, kind in enumerate(unit):
                x_t, ngc[f"b{pos}"] = block_decode(
                    gp[f"b{pos}"], cfg, kind, x_t, gc[f"b{pos}"], cur_pos,
                    extras)
            per_group.append(ngc)
        with obs_trace.span("stack.restack"):
            new_caches["groups"] = stack_params(per_group)
    for i, kind in enumerate(suffix):
        x_t, new_caches["suffix"][f"l{i}"] = block_decode(
            sp["suffix"][f"l{i}"], cfg, kind, x_t,
            caches["suffix"][f"l{i}"], cur_pos, extras)
    return x_t, new_caches
