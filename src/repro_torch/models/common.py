"""Shared model-building utilities (port of `repro.models.common`).

Every parameter is created through ParamBuilder, which records a parallel
tree of logical axis names beside the params, with the reference's key
paths and fan-in scaling. Params are nested dicts of tensors; a
`torch.Generator` on an explicit device takes the place of `jax.random`
keys, so the values differ from the reference's for the same seed (the
parity tests carry the reference's params over with
`repro_torch.core.convert.model_params`).

The reference's `constrain` (activation sharding) is the identity on one
card and is not ported.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn.functional as F

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
    of sampling (shapes and dtypes without allocating anything)."""

    def __init__(self, generator: Optional[torch.Generator],
                 param_dtype: str = "float32", abstract: bool = False):
        if generator is None and not abstract:
            raise ValueError("a concrete ParamBuilder needs a generator")
        self.generator = generator
        self.abstract = abstract
        self.dtype = dtype_of(param_dtype)
        self.params: dict = {}
        self.axes: dict = {}

    @property
    def device(self) -> torch.device:
        return (torch.device("meta") if self.abstract
                else self.generator.device)

    def child(self, name: str) -> "ParamBuilder":
        sub = ParamBuilder(self.generator, "float32", abstract=self.abstract)
        sub.dtype = self.dtype
        self.params[name] = sub.params
        self.axes[name] = sub.axes
        return sub

    def param(
        self,
        name: str,
        shape: Sequence[int],
        axes: Sequence[Optional[str]],
        init: str = "normal",
        scale: Optional[float] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        assert len(shape) == len(axes), (name, shape, axes)
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


def stack_params(trees: Sequence[PyTree]) -> PyTree:
    """Stack a list of identically-structured param trees along a new axis
    0 (meta tensors stack to meta tensors)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


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


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return gelu
    raise ValueError(name)


def sinusoidal_positions(seq_len: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


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
    return torch.matmul(x, w.to(x.dtype))


def init_mlp(b: ParamBuilder, d_model: int, d_ff: int, use_glu: bool,
             in_axis: str = "embed", hidden_axis: str = "mlp"):
    c = b.child("mlp")
    init_dense(c, "wi", d_model, d_ff, in_axis, hidden_axis)
    if use_glu:
        init_dense(c, "wg", d_model, d_ff, in_axis, hidden_axis)
    init_dense(c, "wo", d_ff, d_model, hidden_axis, in_axis)


def apply_mlp(p: PyTree, x: torch.Tensor, act_name: str,
              use_glu: bool) -> torch.Tensor:
    act = activation(act_name)
    h = dense(p["wi"], x)
    if use_glu:
        h = act(h) * dense(p["wg"], x)
    else:
        h = act(h)
    return dense(p["wo"], h)
