"""The benchmark's weights, made on the device from the seed.

The tree's structure (key paths, shapes, dtypes) is the program's
interface, read from `Model.abstract_params_and_axes()` (meta tensors,
nothing allocated). The values are the benchmark's own: one
`torch.Generator` on the device, one in-place draw a leaf, in the
served dtype (no float32 staging), so the program and the reference get
the same tensors.

Values: norm scales N(1, 0.1); the embedding N(0, 1); every other leaf
N(0, 1/fan_in), its fan-in the size of the dims a product contracts
(attention's `wo` [H, hd, d]: H*hd; an expert's `wi`/`wg` [E, d, ff]: d,
its `wo` [E, ff, d]: ff; else the first dim), so activations keep their
scale through the depth.
"""
from __future__ import annotations

import math

import torch

NORMS = ("scale", "q_norm", "kv_norm")


def fan_in(path: tuple, shape: tuple) -> int:
    """The contracted size of a leaf's product, `shape` without the
    stacked-layers dim."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if parent == "moe" and name in ("wi", "wg", "wo"):
        return shape[1]
    if parent == "attn" and name == "wo":
        return shape[0] * shape[1]
    return shape[0]


def _stacked(path: tuple) -> bool:
    return "groups" in path


def make(abstract: dict, seed: int, device) -> dict:
    """A tree like `abstract` (meta tensors) with the seed's values on
    `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(tree, path):
        if isinstance(tree, dict):
            return {k: fill(v, path + (k,)) for k, v in tree.items()}
        t = torch.empty(tree.shape, dtype=tree.dtype, device=device)
        shape = tuple(tree.shape[1:] if _stacked(path) else tree.shape)
        if path[-1] in NORMS:
            return t.normal_(1.0, 0.1, generator=gen)
        if path[-1] == "embed":
            return t.normal_(0.0, 1.0, generator=gen)
        return t.normal_(0.0, 1.0 / math.sqrt(fan_in(path, shape)),
                         generator=gen)

    return fill(abstract, ())
