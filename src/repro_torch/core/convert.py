"""Weight carry-over from the JAX package.

`repro` keeps cost-model and discriminator parameters as flat dicts of
arrays; `np.asarray` over that pytree, or the `.npz` that
`repro.core.cost_model.save_params` writes, gives plain numpy arrays that
these functions turn into the port's float32 tensors on a given device. The
keys stay as they are, because lottery masks act on params by name.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.cost_model import Params, load_params
from repro_torch.core.placement import TorchDevice, resolve_torch_device

_DISC_KEYS = ("b0", "b1", "w0", "w1")


def _to_tensors(tree: Mapping, torch_device: TorchDevice) -> Params:
    dev = resolve_torch_device(torch_device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in tree.items()}


def _check_mlp_layers(tree: Mapping, where: str) -> None:
    keys = set(tree)
    n = len([k for k in keys if re.fullmatch(r"w\d+", k)])
    want = {f"{p}{i}" for i in range(n) for p in "wb"}
    if n == 0 or keys != want:
        raise ValueError(f"{where}: expected keys {sorted(want)}, "
                         f"got {sorted(keys)}")
    for i in range(n):
        w, b = np.shape(tree[f"w{i}"]), np.shape(tree[f"b{i}"])
        if len(w) != 2 or b != (w[1],):
            raise ValueError(f"{where}: layer {i} has w{w} and b{b}")
        if i and np.shape(tree[f"w{i - 1}"])[1] != w[0]:
            raise ValueError(f"{where}: layer {i} does not chain")


def _check_residual_layers(tree: Mapping, where: str) -> None:
    """`w_in, b_in, w0, b0, ..., w_out, b_out` of `ResidualMLPCostModel`:
    square blocks of the input projection's width and a one-column head."""
    keys = set(tree)
    n = len([k for k in keys if re.fullmatch(r"w\d+", k)])
    want = ({"w_in", "b_in", "w_out", "b_out"}
            | {f"{p}{i}" for i in range(n) for p in "wb"})
    if keys != want:
        raise ValueError(f"{where}: expected keys {sorted(want)}, "
                         f"got {sorted(keys)}")
    width = np.shape(tree["w_in"])[1]
    shapes = {"b_in": (width,), "w_out": (width, 1), "b_out": (1,),
              **{f"w{i}": (width, width) for i in range(n)},
              **{f"b{i}": (width,) for i in range(n)}}
    for k, shape in shapes.items():
        if np.shape(tree[k]) != shape:
            raise ValueError(f"{where}: {k} has shape {np.shape(tree[k])}, "
                             f"expected {shape}")


def _check_cost_model(tree: Mapping, where: str) -> None:
    if "w_in" in tree:
        _check_residual_layers(tree, where)
    else:
        _check_mlp_layers(tree, where)


def cost_model_params(tree: Mapping, torch_device: TorchDevice = "cuda"
                      ) -> Params:
    """The reference's cost-model params as tensors on `torch_device`: the
    MLP's (`w0, b0, ..., wL, bL`) or the residual MLP's (`w_in, b_in, w0,
    b0, ..., w_out, b_out`)."""
    _check_cost_model(tree, "cost-model params")
    return _to_tensors(tree, torch_device)


def discriminator_params(tree: Mapping, torch_device: TorchDevice = "cuda"
                         ) -> Params:
    """The reference's domain discriminator (`w0, b0, w1, b1`, output width
    1) as tensors on `torch_device`."""
    if tuple(sorted(tree)) != _DISC_KEYS:
        raise ValueError(f"discriminator params: expected keys "
                         f"{list(_DISC_KEYS)}, got {sorted(tree)}")
    _check_mlp_layers(tree, "discriminator params")
    if np.shape(tree["w1"])[1] != 1:
        raise ValueError("discriminator params: w1 must have one column")
    return _to_tensors(tree, torch_device)


def cost_model_params_from_npz(path: str, torch_device: TorchDevice = "cuda"
                               ) -> Params:
    """Cost-model params from a `.npz` either package wrote."""
    params, _ = load_params(path, torch_device)
    _check_cost_model(params, path)
    return params


def _leaf_tensor(x, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        return torch.tensor(arr.astype(np.float32), device=dev).to(
            torch.bfloat16)
    return torch.tensor(arr, device=dev)


def model_params(tree: Mapping, torch_device: TorchDevice = "cuda") -> dict:
    """The reference LM's param pytree (nested dicts of arrays, stacked
    `groups` included) as the port's tree of tensors on `torch_device`,
    with identical key paths and each leaf's dtype."""
    dev = resolve_torch_device(torch_device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return _leaf_tensor(node, dev)

    return walk(tree)
