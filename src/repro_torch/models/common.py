"""Shared model-building utilities (port of `repro.models.common`).

Every parameter is created through ParamBuilder, which records a parallel
tree of logical axis names beside the params, with the reference's key
paths and fan-in scaling, and a second parallel tree that marks each leaf
the model reads in float32 arithmetic (`Model.cast_params` leaves those as
given). Params are nested dicts of tensors; a
`torch.Generator` on an explicit device takes the place of `jax.random`
keys, so the values differ from the reference's for the same seed (the
parity tests carry the reference's params over with
`repro_torch.core.convert.model_params`).

Under a mesh the leaves are DTensors, and `apply_mlp` pins its
activations' placements when the launcher set hints
(`repro_torch.distributed.act_sharding.constrain`; without hints, or on a
plain tensor, the identity). The axes trees (`is_axes_leaf`, `map_axes`,
`stack_axes`) feed the sharding rules.

`LayoutOps` holds the few operations whose form depends on where the
tensors live: the embedding gather, the decode cache's slot write, the
stacking of per-layer trees, the attention body, a recurrence over
independent heads (the xLSTM cells), the gathering of a sharded dim,
every product of an activation with a weight (its column-parallel and
row-parallel forms), the count of routed assignments per expert and the
MoE experts' dispatch body. The models call them through `layout()`.
Their defaults are the one-device forms; a mesh's step installs the
DTensor forms of `repro_torch.distributed.sharding` for its duration
(`use_layout`), so the models hold no knowledge of how a mesh lays
tensors out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.distributed.act_sharding import constrain

PyTree = Any

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int8": torch.int8,
}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """`fn` over the leaves of nested dicts (and over the matching leaves
    of `rest`, which share the structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def meta(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """A meta tensor: a shape and a dtype, nothing allocated."""
    return torch.empty(shape, dtype=dtype, device="meta")


def tree_leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Parameter builder with logical-axis tracking
# ---------------------------------------------------------------------------


class ParamBuilder:
    """Accumulates params and their logical axes into parallel nested dicts.

    Draws come from `generator`, on the generator's device, in the order
    the params are built. abstract=True records meta-device tensors instead
    of sampling (shapes and dtypes without allocating anything).

    `float32_read` is a third parallel tree of booleans: True for a leaf
    declared with `dtype=torch.float32` (norm scales, gates, `lambda_raw`)
    or with `reads_float32=True` (a weight of the param dtype that the
    model upcasts before use: the MoE router, the sLSTM's recurrent
    matrices)."""

    def __init__(self, generator: Optional[torch.Generator],
                 param_dtype: str = "float32", abstract: bool = False):
        if generator is None and not abstract:
            raise ValueError("a concrete ParamBuilder needs a generator")
        self.generator = generator
        self.abstract = abstract
        self.dtype = dtype_of(param_dtype)
        self.params: dict = {}
        self.axes: dict = {}
        self.float32_read: dict = {}

    @property
    def device(self) -> torch.device:
        return (torch.device("meta") if self.abstract
                else self.generator.device)

    def child(self, name: str) -> "ParamBuilder":
        sub = ParamBuilder(self.generator, "float32", abstract=self.abstract)
        sub.dtype = self.dtype
        self.params[name] = sub.params
        self.axes[name] = sub.axes
        self.float32_read[name] = sub.float32_read
        return sub

    def param(
        self,
        name: str,
        shape: Sequence[int],
        axes: Sequence[Optional[str]],
        init: str = "normal",
        scale: Optional[float] = None,
        dtype: Optional[torch.dtype] = None,
        reads_float32: bool = False,
    ) -> torch.Tensor:
        assert len(shape) == len(axes), (name, shape, axes)
        self.float32_read[name] = reads_float32 or dtype == torch.float32
        dtype = dtype or self.dtype
        shape = tuple(shape)
        if self.abstract:
            leaf = torch.empty(shape, dtype=dtype, device="meta")
            self.params[name] = leaf
            self.axes[name] = tuple(axes)
            return leaf
        if init == "normal":
            if scale is None:  # fan-in scaling
                fan_in = shape[0] if len(shape) == 1 else int(
                    math.prod(shape[:-1]) if len(shape) == 2 else math.prod(shape) / shape[-1])
                fan_in = max(1, fan_in)
                scale = 1.0 / math.sqrt(fan_in)
            arr = torch.randn(shape, generator=self.generator,
                              device=self.device, dtype=torch.float32)
            arr.mul_(scale)
        elif init == "zeros":
            arr = torch.zeros(shape, dtype=torch.float32, device=self.device)
        elif init == "ones":
            arr = torch.ones(shape, dtype=torch.float32, device=self.device)
        else:
            raise ValueError(init)
        arr = arr.to(dtype)
        self.params[name] = arr
        self.axes[name] = tuple(axes)
        return arr


def is_axes_leaf(x) -> bool:
    """Leaves of an *axes tree* are tuples of axis names (str | None)."""
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def map_axes(fn: Callable, tree: PyTree) -> PyTree:
    """`fn` over the leaves (tuples of axis names) of an axes tree."""
    return tree_map(fn, tree)


def stack_axes(axes_tree: PyTree) -> PyTree:
    """Prepend the 'layers' logical axis to every leaf of an axes tree."""
    return map_axes(lambda a: ("layers",) + tuple(a), axes_tree)


def stack_params(trees: Sequence[PyTree]) -> PyTree:
    """Stack a list of identically-structured param trees along a new axis
    0 (meta tensors stack to meta tensors), by `layout().stack`."""
    stack = layout().stack
    return tree_map(lambda *xs: stack(xs), *trees)


# ---------------------------------------------------------------------------
# Layout-dependent operations
# ---------------------------------------------------------------------------


def _take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def _write_slot(cache: torch.Tensor, slot: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
    out = cache.clone()
    bidx = torch.arange(cache.shape[0], device=cache.device)
    out[bidx, slot] = value.to(out.dtype)
    return out


def _stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(xs, dim=0)


def _on_shards(fn: Callable, q, k, v, rows=(), q_heads: int = 2, **kw):
    return fn(q, k, v, *rows, **kw)


def _on_heads(fn: Callable, acts, weights, n_heads: int, head_dims=None,
              out_head_dims=None):
    return fn(*acts, *weights)


def _whole_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x


def _product(x: torch.Tensor, w: torch.Tensor, eq: Optional[str] = None,
             split: Optional[str] = None) -> torch.Tensor:
    return torch.matmul(x, w) if eq is None else torch.einsum(eq, x, w)


def _bincount(ids: torch.Tensor, n: int) -> torch.Tensor:
    # an index_add of ones, not torch.bincount, whose output size depends
    # on the data: it has no meta kernel, and the dry run runs on meta
    flat = ids.reshape(-1)
    return torch.zeros(n, dtype=torch.float32, device=ids.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=ids.device))


def _experts(fn: Callable, xf, weights, idx, wi, wg, wo, **kw):
    return fn(xf, weights, idx, wi, wg, wo, 0, wi.shape[0], None)


@dataclasses.dataclass(frozen=True)
class LayoutOps:
    """take_rows(table, ids): table[ids] (the embedding gather).
    write_slot(cache, slot, value): a copy of cache [B, Sc, ...] with row
        b's slot[b] set to value[b] (a decode step's cache write).
    stack(xs): the tensors xs stacked along a new dim 0.
    on_shards(fn, q, k, v, rows=(), q_heads=2, **kw): an attention body
        fn(q, k, v, *rows, **kw) -> [B, ..., H, Dv]; q [B, ..., H, D] has
        its heads at dim `q_heads`, k and v [B, S, G, D], rows [B, ...].
    on_heads(fn, acts, weights, n_heads, head_dims=None,
        out_head_dims=None): fn(*acts, *weights) -> a tuple of tensors, a
        body whose n_heads heads do not mix: acts [B, ...] with their
        heads at dim head_dims[i] (default: the last, which may fold the
        heads with a trailing dim, heads outer), weights [n_heads, ...],
        and each output's heads at out_head_dims[j] (default: the last).
        Under a mesh each rank runs it on its batch shard and its heads.
    whole_dim(x, dim): x with dim `dim` whole (the vocab dim of the
        logits before the gold-logit gather).
    project_in(x, w, eq=None, split=None): torch.matmul(x, w), or
        torch.einsum(eq, x, w), for a weight whose tensor-parallel dim
        (heads, mlp, vocab, experts) stays in the output: a
        column-parallel product, or one batched over that dim. Under a
        mesh each rank multiplies by its own shard of w and keeps its
        shard of the output; `split` names a label of w (the kv heads)
        that is cut so where the weight is whole and the label's size
        divides the axis, and where it does not, each rank multiplies its
        share of x's rows and the output is gathered whole.
    project_out(x, w, eq=None): the same product for a weight whose
        tensor-parallel dim is contracted (row-parallel). Under a mesh
        each rank multiplies its shard of x by its shard of w, and the
        partial sums are added up (one all-reduce) before it returns.
    bincount(ids, n): float32 [n], how often each of 0..n-1 occurs in ids.
    experts(fn, xf, weights, idx, wi, wg, wo, in_order=True,
        expert_axes=None): the MoE dispatch body fn(xf, weights, idx, wi,
        wg, wo, shard_id, E_loc, offset) -> [T, d] over tokens xf [T, d]
        with their routing [T, k] and the expert weights [E, ...]; one
        device runs it as fn(..., 0, E, None). Under a mesh each rank runs
        it on its tokens and its experts, `offset` [E] counting the
        assignments of the tokens before its own when `in_order` (a global
        capacity), and `expert_axes` pins the experts to those mesh
        axes."""
    take_rows: Callable = _take_rows
    write_slot: Callable = _write_slot
    stack: Callable = _stack
    on_shards: Callable = _on_shards
    on_heads: Callable = _on_heads
    whole_dim: Callable = _whole_dim
    project_in: Callable = _product
    project_out: Callable = _product
    bincount: Callable = _bincount
    experts: Callable = _experts


PLAIN_OPS = LayoutOps()
_LAYOUT = threading.local()


def layout() -> LayoutOps:
    """The layout operations in force: the one-device forms unless a step
    set others (`use_layout`)."""
    return getattr(_LAYOUT, "ops", PLAIN_OPS)


@contextlib.contextmanager
def use_layout(ops: LayoutOps):
    prev = layout()
    _LAYOUT.ops = ops
    try:
        yield
    finally:
        _LAYOUT.ops = prev


# ---------------------------------------------------------------------------
# Norms / activations / embeddings
# ---------------------------------------------------------------------------


def init_norm(b: ParamBuilder, name: str, dim: int, kind: str):
    c = b.child(name)
    c.param("scale", (dim,), ("embed",), init="ones", dtype=torch.float32)
    if kind == "layernorm":
        c.param("bias", (dim,), ("embed",), init="zeros", dtype=torch.float32)


def apply_norm(p: PyTree, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    orig_dtype = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        var = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + eps) * p["scale"]
    elif kind == "layernorm":
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        y = (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        raise ValueError(kind)
    return y.to(orig_dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`'s rounding points: the sigmoid rounded to x's dtype,
    then the product (`F.silu` rounds once, which at bf16 moves the
    gradients of the weights before it by a few percent)."""
    return x * torch.sigmoid(x)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return silu
    if name == "gelu":
        return gelu
    raise ValueError(name)


def sinusoid_at(positions: torch.Tensor, dim: int,
                dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal embeddings at integer positions [...] -> [..., dim]."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def sinusoidal_positions(seq_len: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    return sinusoid_at(torch.arange(seq_len, device=device), dim, dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D] (or [..., H, D] w/ scalar-per-row positions [..., S])."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    ang = positions[..., None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]  # broadcast over head dim
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense helpers
# ---------------------------------------------------------------------------


def init_dense(b: ParamBuilder, name: str, in_dim: int, out_dim: int,
               in_axis: Optional[str], out_axis: Optional[str],
               init: str = "normal", scale: Optional[float] = None):
    b.param(name, (in_dim, out_dim), (in_axis, out_axis), init=init, scale=scale)


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ w for a column-parallel w (its output dim on the TP axis)."""
    return layout().project_in(x, w.to(x.dtype))


def init_mlp(b: ParamBuilder, d_model: int, d_ff: int, use_glu: bool,
             in_axis: str = "embed", hidden_axis: str = "mlp"):
    """The MLP's params (wi, wg with GLU, wo) in `b`."""
    init_dense(b, "wi", d_model, d_ff, in_axis, hidden_axis)
    if use_glu:
        init_dense(b, "wg", d_model, d_ff, in_axis, hidden_axis)
    init_dense(b, "wo", d_ff, d_model, hidden_axis, in_axis)


def apply_mlp(p: PyTree, x: torch.Tensor, act_name: str,
              use_glu: bool) -> torch.Tensor:
    act = activation(act_name)
    h = dense(p["wi"], x)
    h = constrain(h, *(("dp",) + (None,) * (h.dim() - 2) + ("tp",)))
    if use_glu:
        h = act(h) * dense(p["wg"], x)
    else:
        h = act(h)
    y = layout().project_out(h, p["wo"].to(h.dtype))
    return constrain(y, *(("dp",) + (None,) * (y.dim() - 1)))
