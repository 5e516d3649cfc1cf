"""Block composition and stacks of repeated groups (port of
`repro.models.transformer`).

A stack is factored as (prefix, repeated group, suffix):
  dense:           ([], (attention,), L, [])
  recurrentgemma:  ([], (recurrent, recurrent, attention), 8, [recurrent]*2)

With scan_layers the repeated group's params are stacked along a leading
axis (`groups`), as the reference stacks them for `jax.lax.scan`; here a
Python loop walks the group index, and the per-group caches are stacked
the same way.

Ported block kinds: `attention` and `recurrent`. The others, and MLA,
raise NotImplementedError (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.common import (ParamBuilder, apply_mlp, apply_norm,
                                       init_mlp, init_norm, stack_params,
                                       tree_map)

PyTree = Any

PORTED_KINDS = ("attention", "recurrent")


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item 11: the rest of the LM zoo)")


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a config that needs an unported part:
    a block kind other than attention and recurrent, MLA, an encoder, a
    cross-attention frontend or absolute positions in place of RoPE."""
    if cfg.is_encoder_decoder:
        raise unported(f"{cfg.name}: the encoder-decoder stack")
    if cfg.cross_attn_every > 0:
        raise unported(f"{cfg.name}: cross attention")
    if cfg.mla is not None:
        raise unported(f"{cfg.name}: MLA attention")
    other = sorted(set(layer_kinds(cfg)) - set(PORTED_KINDS))
    if other:
        raise unported(f"{cfg.name}: block kinds {other}")
    if not cfg.use_rope:
        raise unported(f"{cfg.name}: absolute (sinusoidal) positions")


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


def _check_block(cfg, kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise unported(f"block kind {kind!r}")
    if kind == "attention" and cfg.mla is not None:
        raise unported("MLA attention")


def init_block(b: ParamBuilder, cfg, kind: str):
    _check_block(cfg, kind)
    if kind == "attention":
        init_norm(b, "ln_attn", cfg.d_model, cfg.norm)
        attn.init_attention(b.child("attn"), cfg)
    else:
        init_norm(b, "ln_rec", cfg.d_model, cfg.norm)
        rec_mod.init_recurrent_block(b.child("rec"), cfg)
    init_norm(b, "ln_mlp", cfg.d_model, cfg.norm)
    init_mlp(b, cfg.d_model, cfg.d_ff, cfg.use_glu)


def _mlp_residual(p, cfg, x):
    h = apply_norm(p["ln_mlp"], x, cfg.norm)
    return x + apply_mlp(p["mlp"], h, cfg.act, cfg.use_glu)


def block_forward(p, cfg, kind: str, x, positions):
    """Returns x after the block."""
    _check_block(cfg, kind)
    if kind == "attention":
        h = apply_norm(p["ln_attn"], x, cfg.norm)
        x = x + attn.attention_forward(p["attn"], cfg, h, positions)
    else:
        h = apply_norm(p["ln_rec"], x, cfg.norm)
        x = x + rec_mod.recurrent_block_forward(p["rec"], cfg, h)
    return _mlp_residual(p, cfg, x)


def block_prefill(p, cfg, kind: str, x, positions, cache_len: int):
    """Returns (x, cache)."""
    _check_block(cfg, kind)
    if kind == "attention":
        h = apply_norm(p["ln_attn"], x, cfg.norm)
        y, cache = attn.attention_prefill(p["attn"], cfg, h, positions,
                                          cache_len)
    else:
        h = apply_norm(p["ln_rec"], x, cfg.norm)
        y, cache = rec_mod.recurrent_block_prefill(p["rec"], cfg, h)
    return _mlp_residual(p, cfg, x + y), cache


def block_decode(p, cfg, kind: str, x_t, cache, cur_pos):
    """x_t: [B, 1, d]. Returns (x_t, new_cache)."""
    _check_block(cfg, kind)
    if kind == "attention":
        h = apply_norm(p["ln_attn"], x_t, cfg.norm)
        y, cache = attn.attention_decode(p["attn"], cfg, h, cache, cur_pos)
    else:
        h = apply_norm(p["ln_rec"], x_t, cfg.norm)
        y, cache = rec_mod.recurrent_block_decode(p["rec"], cfg, h, cache)
    return _mlp_residual(p, cfg, x_t + y), cache


# ---------------------------------------------------------------------------
# Stack init / forward / prefill / decode (a loop over repeated groups)
# ---------------------------------------------------------------------------


def _group(tree: PyTree, g: int) -> PyTree:
    """Group g's slice of a tree stacked along axis 0 (views)."""
    return tree_map(lambda t: t[g], tree)


def init_stack(b: ParamBuilder, cfg):
    """Initializes {'prefix': {...}, 'groups': stacked, 'suffix': {...}}."""
    prefix, unit, n_groups, suffix = stack_plan(cfg)
    s = b.child("stack")
    pfx = s.child("prefix")
    for i, kind in enumerate(prefix):
        init_block(pfx.child(f"l{i}"), cfg, kind)
    if n_groups:
        group_trees = []
        axes_tree = None
        n_build = 1 if b.abstract else n_groups
        for _ in range(n_build):
            gb = ParamBuilder(s.generator, "float32", abstract=b.abstract)
            gb.dtype = s.dtype
            for pos, kind in enumerate(unit):
                init_block(gb.child(f"b{pos}"), cfg, kind)
            group_trees.append(gb.params)
            axes_tree = gb.axes
        if b.abstract:
            group_trees = group_trees * n_groups
        s.params["groups"] = stack_params(group_trees)
        s.axes["groups"] = _prepend_layers(axes_tree)
    sfx = s.child("suffix")
    for i, kind in enumerate(suffix):
        init_block(sfx.child(f"l{i}"), cfg, kind)


def _prepend_layers(axes_tree):
    if isinstance(axes_tree, dict):
        return {k: _prepend_layers(v) for k, v in axes_tree.items()}
    return ("layers",) + tuple(axes_tree)


def stack_forward(params, cfg, x, positions):
    prefix, unit, n_groups, suffix = stack_plan(cfg)
    sp = params["stack"]
    for i, kind in enumerate(prefix):
        x = block_forward(sp["prefix"][f"l{i}"], cfg, kind, x, positions)
    for g in range(n_groups):
        gp = _group(sp["groups"], g)
        for pos, kind in enumerate(unit):
            x = block_forward(gp[f"b{pos}"], cfg, kind, x, positions)
    for i, kind in enumerate(suffix):
        x = block_forward(sp["suffix"][f"l{i}"], cfg, kind, x, positions)
    return x


def stack_prefill(params, cfg, x, positions, cache_len):
    prefix, unit, n_groups, suffix = stack_plan(cfg)
    sp = params["stack"]
    caches: Dict[str, Any] = {"prefix": {}, "suffix": {}}
    for i, kind in enumerate(prefix):
        x, caches["prefix"][f"l{i}"] = block_prefill(
            sp["prefix"][f"l{i}"], cfg, kind, x, positions, cache_len)
    if n_groups:
        per_group = []
        for g in range(n_groups):
            gp = _group(sp["groups"], g)
            gcaches = {}
            for pos, kind in enumerate(unit):
                x, gcaches[f"b{pos}"] = block_prefill(
                    gp[f"b{pos}"], cfg, kind, x, positions, cache_len)
            per_group.append(gcaches)
        caches["groups"] = stack_params(per_group)
    for i, kind in enumerate(suffix):
        x, caches["suffix"][f"l{i}"] = block_prefill(
            sp["suffix"][f"l{i}"], cfg, kind, x, positions, cache_len)
    return x, caches


def stack_decode(params, cfg, x_t, caches, cur_pos):
    prefix, unit, n_groups, suffix = stack_plan(cfg)
    sp = params["stack"]
    new_caches: Dict[str, Any] = {"prefix": {}, "suffix": {}}
    for i, kind in enumerate(prefix):
        x_t, new_caches["prefix"][f"l{i}"] = block_decode(
            sp["prefix"][f"l{i}"], cfg, kind, x_t,
            caches["prefix"][f"l{i}"], cur_pos)
    if n_groups:
        per_group = []
        for g in range(n_groups):
            gp, gc = _group(sp["groups"], g), _group(caches["groups"], g)
            ngc = {}
            for pos, kind in enumerate(unit):
                x_t, ngc[f"b{pos}"] = block_decode(
                    gp[f"b{pos}"], cfg, kind, x_t, gc[f"b{pos}"], cur_pos)
            per_group.append(ngc)
        new_caches["groups"] = stack_params(per_group)
    for i, kind in enumerate(suffix):
        x_t, new_caches["suffix"][f"l{i}"] = block_decode(
            sp["suffix"][f"l{i}"], cfg, kind, x_t,
            caches["suffix"][f"l{i}"], cur_pos)
    return x_t, new_caches
