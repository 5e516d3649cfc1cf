"""Activation and weight sharding hints (port of
`repro.distributed.act_sharding`).

Under the fsdp_tp plan, sharding propagation may contract products over
the data-sharded `embed` weight dim, giving activation-sized reductions per
layer, or lay activations out arbitrarily. The classical fixes:

  1. ZeRO-3 just-in-time weight gathering: redistribute each block's params
     to their TP-only placements (data dims dropped) right before use, so
     the weights are all-gathered (small) instead of the activations
     reduced (large); autograd turns the gather into a reduce-scatter.
  2. Explicit activation placements at block boundaries (batch -> data
     axes, heads/mlp -> model), so propagation never invents bad layouts.

Models stay mesh-agnostic: hints live in a context set by the launcher, or
by a mesh's train step when the launcher set none (`train_loop.
make_train_step`: the just-in-time gather on, the activations left to
propagation); with no context, or on a plain tensor, every helper returns
its input as it is. The models call these helpers on every block, so this
module imports `torch.distributed.tensor` (about a second) only once hints
are set. `moe_impl="expert_parallel"` routes the MoE blocks through
`distributed.expert_parallel` (the dry run's and the launcher's `--opt
epmoe`); `moe_expert_parallel` pins the scatter path's dispatch buffer to
experts on the model axis (`--opt moe`).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Optional, Sequence, Tuple

import torch

_TLS = threading.local()


class Hints:
    def __init__(self, mesh, dp_axes: Tuple[str, ...],
                 tp_axis: Optional[str] = "model",
                 zero3_gather: bool = True,
                 constrain_activations: bool = True,
                 moe_expert_parallel: bool = False,
                 moe_impl: Optional[str] = None):
        from repro_torch.distributed.sharding import axis_sizes
        names = axis_sizes(mesh)
        self.mesh = mesh
        self.dp = tuple(a for a in dp_axes if a in names)
        self.tp = tp_axis if tp_axis in names else None
        self.zero3_gather = zero3_gather
        self.constrain_activations = constrain_activations
        self.moe_expert_parallel = moe_expert_parallel
        self.moe_impl = moe_impl

    def axis_size(self, kind: str) -> int:
        from repro_torch.distributed.sharding import axis_sizes
        sizes = axis_sizes(self.mesh)
        if kind == "dp":
            return math.prod(sizes[a] for a in self.dp) if self.dp else 1
        return sizes.get(self.tp, 1) if self.tp else 1


def current() -> Optional[Hints]:
    return getattr(_TLS, "hints", None)


@contextlib.contextmanager
def use_hints(hints: Optional[Hints]):
    prev = getattr(_TLS, "hints", None)
    _TLS.hints = hints
    try:
        yield
    finally:
        _TLS.hints = prev


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """dims: per-dimension 'dp' | 'tp' | None. A DTensor is redistributed to
    those placements (a dim that does not divide its axes, or None, is
    replicated); without hints, or on a plain tensor, x as it is."""
    h = current()
    if h is None or not h.constrain_activations or not is_dtensor(x):
        return x
    from repro_torch.distributed.sharding import to_placements
    assert len(dims) == x.ndim, (dims, x.shape)
    entries = []
    for d, kind in zip(x.shape, dims):
        if kind is None:
            entries.append(None)
            continue
        if kind == "dp":
            ax: Any = h.dp if len(h.dp) > 1 else (h.dp[0] if h.dp else None)
        else:
            ax = h.tp
        size = h.axis_size(kind)
        if ax is None or size <= 1 or d % size != 0:
            entries.append(None)
        else:
            entries.append(ax)
    return x.redistribute(h.mesh, to_placements(entries, h.mesh))


def tp_only(w: torch.Tensor, axes: Sequence[Optional[str]], mesh,
            tp: Optional[str] = "model") -> torch.Tensor:
    """The DTensor `w` redistributed to its TP-only placements: its
    tensor-parallel logical dims (vocab, mlp, heads, experts) on the `tp`
    axis where they divide it, every other dim whole (an all-gather over
    the data axes, whose backward is a reduce-scatter)."""
    from repro_torch.distributed.sharding import axis_sizes, to_placements
    tp_logical = {"vocab", "mlp", "heads", "experts"}
    tp_size = axis_sizes(mesh)[tp] if tp else 1
    entries = []
    for d, name in zip(w.shape, axes):
        if name in tp_logical and tp and d % tp_size == 0:
            entries.append(tp)
        else:
            entries.append(None)
    return w.redistribute(mesh, to_placements(entries, mesh))


def gather_weight(w: torch.Tensor,
                  axes: Sequence[Optional[str]]) -> torch.Tensor:
    """ZeRO-3 JIT gather: a DTensor weight redistributed to its TP-only
    placements (data dims dropped) right before use. `axes` are the logical
    axis names of w's dims."""
    h = current()
    if h is None or not h.zero3_gather or not is_dtensor(w):
        return w
    return tp_only(w, axes, h.mesh, h.tp)


def gather_params(tree, axes_tree):
    """gather_weight over a whole (layer) param subtree."""
    h = current()
    if h is None or not h.zero3_gather:
        return tree
    from repro_torch.models.common import tree_map
    return tree_map(gather_weight, tree, axes_tree)
