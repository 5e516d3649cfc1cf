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
the same way (`walk_stack`, the walk `stack_prefill`, `stack_decode` and
the decode-state specs share). `kinds_override` gives `init_stack` and
`stack_forward` a plain list of block kinds in place of the config's plan
(the whisper encoder).

`BLOCKS` defines each block kind once, as residual steps (`Step`): a
pre-norm, a sub-layer (`SubLayer`) and a residual add.

`stack_forward` runs each prefix and suffix block, and each group, under
`cfg.remat_policy` (torch.utils.checkpoint in place of jax.checkpoint).
Under hints with `zero3_gather` it first redistributes the block's DTensor
params to their TP-only placements (`act_sharding.gather_params` over
`stack_axes(cfg)`); without hints the params go in as they are.

Blocks read `extras`, as the reference's do: `kv_src` (the cross-attention
source), `chunk` (the mLSTM chunk, default `cfg.scan_chunk`) and `moe_impl`
(default "scatter"). `stack_forward` returns the blocks' summed aux loss.

Spans (`obs.trace`; no-ops with no tracer): in `block_prefill` and
`block_decode`, an (moe_)attention block's steps open `block.attention`
(the pre-norm, the attention sub-layer with its cache write, the residual
add) and then `block.mlp` or `block.moe` (the pre-norm and the feed-forward
half); `walk_stack` opens `stack.restack` around the stacking of a decode
step's new group caches. The other block kinds and `block_forward`
(training) open none.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

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
# Block kinds: residual steps over sub-layers
# ---------------------------------------------------------------------------


class SubLayer(NamedTuple):
    """What a residual step runs on its normed input h. init(b, cfg) puts
    its params in b; forward(p, cfg, h, positions, extras) -> (y, aux or
    None); prefill(p, cfg, h, positions, cache_len, extras) -> (y, cache);
    decode(p, cfg, h, cache, cur_pos, extras) -> (y, new cache);
    cache_spec(cfg, batch, context) -> its cache as meta tensors (beside
    the prefill that writes it), None where it keeps no cache."""
    init: Callable
    forward: Callable
    prefill: Callable
    decode: Callable
    cache_spec: Optional[Callable]


def _self_attention(mask: Optional[str]) -> SubLayer:
    """GQA self-attention (MLA under `cfg.mla`) under the config's mask
    (mask None) or `mask`."""
    def init(b, cfg):
        (attn.init_attention if cfg.mla is None else attn.init_mla)(b, cfg)

    def forward(p, cfg, h, positions, extras):
        if cfg.mla is not None:
            return attn.mla_forward(p, cfg, h, positions), None
        return attn.attention_forward(p, cfg, h, positions, kind=mask), None

    def prefill(p, cfg, h, positions, cache_len, extras):
        if cfg.mla is not None:
            return attn.mla_prefill(p, cfg, h, positions, cache_len)
        return attn.attention_prefill(p, cfg, h, positions, cache_len,
                                      kind=mask)

    def decode(p, cfg, h, cache, cur_pos, extras):
        if cfg.mla is not None:
            return attn.mla_decode(p, cfg, h, cache, cur_pos)
        return attn.attention_decode(p, cfg, h, cache, cur_pos,
                                     attend_fn=extras.get("attend_fn"))

    def cache_spec(cfg, batch, context):
        return (attn.attention_cache_spec if cfg.mla is None
                else attn.mla_cache_spec)(cfg, batch, context)
    return SubLayer(init, forward, prefill, decode, cache_spec)


def _cross_forward(p, cfg, h, positions, extras):
    return attn.attention_forward(p, cfg, h, positions, kind="full",
                                  kv_src=extras["kv_src"]), None


def _cross_prefill(p, cfg, h, positions, cache_len, extras):
    cache = attn.cross_attention_build_cache(p, cfg, extras["kv_src"])
    return _cross_forward(p, cfg, h, positions, extras)[0], cache


def _mlp(p, cfg, h, *_):
    return apply_mlp(p, h, cfg.act, cfg.use_glu), None


def _moe(p, cfg, h, *args):
    """The MoE layer at any of the three calls (extras come last)."""
    return moe_mod.moe_forward(p, cfg, h, args[-1].get("moe_impl", "scatter"))


def _chunk(cfg, extras) -> int:
    return extras.get("chunk", cfg.scan_chunk)


ATTENTION = _self_attention(None)
CROSS_ATTENTION = SubLayer(
    lambda b, cfg: attn.init_attention(b, cfg, cross=True), _cross_forward,
    _cross_prefill,
    lambda p, cfg, h, c, *_: (attn.cross_attention_decode(p, cfg, h, c), c),
    attn.cross_attention_cache_spec)
RECURRENT = SubLayer(
    rec_mod.init_recurrent_block,
    lambda p, cfg, h, *_: (rec_mod.recurrent_block_forward(p, cfg, h), None),
    lambda p, cfg, h, *_: rec_mod.recurrent_block_prefill(p, cfg, h),
    lambda p, cfg, h, c, *_: rec_mod.recurrent_block_decode(p, cfg, h, c),
    rec_mod.recurrent_block_cache_spec)
MLSTM = SubLayer(
    xlstm_mod.init_mlstm_block,
    lambda p, cfg, h, positions, extras:
        (xlstm_mod.mlstm_block_forward(p, cfg, h, _chunk(cfg, extras)), None),
    lambda p, cfg, h, positions, cache_len, extras:
        xlstm_mod.mlstm_block_prefill(p, cfg, h, _chunk(cfg, extras)),
    lambda p, cfg, h, c, *_: xlstm_mod.mlstm_block_decode(p, cfg, h, c),
    xlstm_mod.mlstm_block_cache_spec)
SLSTM = SubLayer(
    xlstm_mod.init_slstm_block,
    lambda p, cfg, h, *_: (xlstm_mod.slstm_block_forward(p, cfg, h), None),
    lambda p, cfg, h, *_: xlstm_mod.slstm_block_prefill(p, cfg, h),
    lambda p, cfg, h, c, *_: xlstm_mod.slstm_block_decode(p, cfg, h, c),
    xlstm_mod.slstm_block_cache_spec)
MLP = SubLayer(lambda b, cfg: init_mlp(b, cfg.d_model, cfg.d_ff, cfg.use_glu),
               _mlp, _mlp, _mlp, None)
MOE = SubLayer(moe_mod.init_moe_params, _moe, _moe, _moe, None)


class Step(NamedTuple):
    """One residual step of a block: x + sub(norm(x)), its output scaled
    by tanh(p[gate]) (in float32, cast to x's dtype) where a gate is
    named. `norm` and `key` name the block's children holding the
    pre-norm's and the sub-layer's params; `span` the span the step runs
    under (None: none); `cache` the step's entry in the block's cache,
    None where the sub-layer's cache is the block's whole cache."""
    norm: str
    key: str
    sub: SubLayer
    span: Optional[str] = None
    gate: Optional[str] = None
    cache: Optional[str] = None


BLOCKS: Dict[str, Tuple[Step, ...]] = {
    "attention": (Step("ln_attn", "attn", ATTENTION, "block.attention"),
                  Step("ln_mlp", "mlp", MLP, "block.mlp")),
    "moe_attention": (Step("ln_attn", "attn", ATTENTION, "block.attention"),
                      Step("ln_mlp", "moe", MOE, "block.moe")),
    "cross_attention": (Step("ln_attn", "attn", CROSS_ATTENTION),
                        Step("ln_mlp", "mlp", MLP, gate="gate_mlp")),
    "encdec_attention": (
        Step("ln_self", "self_attn", _self_attention("causal"),
             cache="self"),
        Step("ln_cross", "cross_attn", CROSS_ATTENTION, cache="cross"),
        Step("ln_mlp", "mlp", MLP)),
    "encoder_attention": (Step("ln_attn", "attn", _self_attention("full")),
                          Step("ln_mlp", "mlp", MLP)),
    "recurrent": (Step("ln_rec", "rec", RECURRENT),
                  Step("ln_mlp", "mlp", MLP)),
    "mlstm": (Step("ln", "cell", MLSTM),),
    "slstm": (Step("ln", "cell", SLSTM),),
}


def _gated(gate, y, x):
    """y scaled by tanh(gate), the tanh in float32 cast to x's dtype."""
    return y * torch.tanh(gate).to(x.dtype)


def _with_cache(cache, slot: Optional[str], c):
    """The block's cache with a stateful step's cache c in it at `slot`
    (`Step.cache`; None: c is the block's whole cache)."""
    return c if slot is None else {**(cache or {}), slot: c}


def init_block(b: ParamBuilder, cfg, kind: str):
    for norm, key, sub, _, gate, _ in BLOCKS[kind]:
        init_norm(b, norm, cfg.d_model, cfg.norm)
        sub.init(b.child(key), cfg)
        if gate is not None:
            b.param(gate, (1,), (None,), init="zeros", dtype=torch.float32)


def block_forward(p, cfg, kind: str, x, positions, extras
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, aux_loss); aux is None for a block without one."""
    aux = None
    for norm, key, sub, _, gate, _ in BLOCKS[kind]:
        y, a = sub.forward(p[key], cfg, apply_norm(p[norm], x, cfg.norm),
                           positions, extras)
        x = x + (y if gate is None else _gated(p[gate], y, x))
        aux = aux if a is None else a
    return x, aux


def block_prefill(p, cfg, kind: str, x, positions, cache_len: int, extras):
    """Returns (x, cache)."""
    cache = None
    for norm, key, sub, span, gate, slot in BLOCKS[kind]:
        with obs_trace.span(span) if span else obs_trace.NOOP_SPAN:
            y, c = sub.prefill(p[key], cfg, apply_norm(p[norm], x, cfg.norm),
                               positions, cache_len, extras)
            x = x + (y if gate is None else _gated(p[gate], y, x))
        if sub.cache_spec is not None:
            cache = _with_cache(cache, slot, c)
    return x, cache


def block_decode(p, cfg, kind: str, x_t, cache, cur_pos, extras):
    """x_t: [B, 1, d]. Returns (x_t, new_cache). extras["attend_fn"], where
    given, replaces the decode attention of the self-attention blocks (the
    sequence-sharded decode, `distributed.decode_attention`)."""
    new = cache
    for norm, key, sub, span, gate, slot in BLOCKS[kind]:
        with obs_trace.span(span) if span else obs_trace.NOOP_SPAN:
            y, c = sub.decode(p[key], cfg, apply_norm(p[norm], x_t, cfg.norm),
                              cache if slot is None else cache[slot],
                              cur_pos, extras)
            x_t = x_t + (y if gate is None else _gated(p[gate], y, x_t))
        if sub.cache_spec is not None:
            new = _with_cache(new, slot, c)
    return x_t, new


def block_cache_spec(cfg, kind: str, batch: int, context: int):
    """The cache `block_prefill` returns for `context` positions, as meta
    tensors."""
    spec = None
    for _, _, sub, _, _, slot in BLOCKS[kind]:
        if sub.cache_spec is not None:
            spec = _with_cache(spec, slot, sub.cache_spec(cfg, batch,
                                                          context))
    return spec


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


def _group_slices(tree, n: int) -> List[PyTree]:
    return [None] * n if tree is None else _groups(tree["groups"], n)


def walk_stack(cfg, fn, sp=None, caches=None) -> Dict[str, Any]:
    """The stack's new caches, {'prefix', 'suffix'(, 'groups')}: fn(kind,
    params, cache) gives each block's, called on the blocks in order (the
    prefix, each group's blocks, the suffix) with the block's slices of the
    stack's params `sp` and of `caches` (None where not given). The
    groups' caches are stacked along axis 0, under the span
    `stack.restack` where they replace given ones (a decode step)."""
    prefix, unit, n_groups, suffix = stack_plan(cfg)

    def blocks(kinds, name, ps, cs):  # ps, cs: dicts, or None
        new = {}
        for i, kind in enumerate(kinds):
            k = f"{name}{i}"
            new[k] = fn(kind, ps and ps[k], cs and cs[k])
        return new

    out = {"prefix": blocks(prefix, "l", sp and sp["prefix"],
                            caches and caches["prefix"])}
    stacked = None
    if n_groups:
        gps = _group_slices(sp, n_groups)
        per_group = [blocks(unit, "b", gp, gc)
                     for gp, gc in zip(gps, _group_slices(caches, n_groups))]
        with (obs_trace.NOOP_SPAN if caches is None
              else obs_trace.span("stack.restack")):
            stacked = stack_params(per_group)
    out["suffix"] = blocks(suffix, "l", sp and sp["suffix"],
                           caches and caches["suffix"])
    if stacked is not None:
        out["groups"] = stacked
    return out


def stack_prefill(params, cfg, x, positions, cache_len, extras):
    """Returns (x, caches)."""
    def block(kind, p, _):
        nonlocal x
        x, cache = block_prefill(p, cfg, kind, x, positions, cache_len,
                                 extras)
        return cache
    caches = walk_stack(cfg, block, params["stack"])
    return x, caches


def stack_decode(params, cfg, x_t, caches, cur_pos, extras):
    """Returns (x_t, new_caches)."""
    def block(kind, p, cache):
        nonlocal x_t
        x_t, cache = block_decode(p, cfg, kind, x_t, cache, cur_pos, extras)
        return cache
    new_caches = walk_stack(cfg, block, params["stack"], caches)
    return x_t, new_caches
