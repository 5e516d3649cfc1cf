"""Checkpoint manager: atomic, keep-N, async-capable (port of
`repro.train.checkpoint`).

Layout, the reference's exactly, so that each package restores what the
other wrote:
  <dir>/step_<N>/
      meta.json            {step, paths, shapes, dtypes}
      arr_<i>.npy          one file per leaf (path-sorted)
  <dir>/step_<N>.tmp       staging dir, atomically renamed on completion

Leaves are ordered, and their paths spelled, as `jax.tree_util.
tree_flatten_with_path` does over nested dicts: keys sorted at every level,
each key written `['key']`, joined by "/" ("['params']/['embed']"). bf16
(and the float8 types) are stored as an unsigned-integer view with the true
dtype in meta.

The copy to host memory is synchronous; with async_save only the file
writes go to a thread. A DTensor leaf (a mesh's train state) is gathered
whole one leaf at a time, and only rank 0 of the process group copies it
to the host and writes; `wait` holds every rank until the write is done. `restore` takes a tree of
shardings (`distributed.sharding`) to place each leaf on a mesh, which may
differ from the one that saved it: the reference's elastic restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.placement import TorchDevice, resolve_torch_device

PyTree = Any

# numpy can't represent bf16 natively; store as uint16 view + true dtype in
# meta (the reference's _VIEW_AS); torch views the same bits either way
_VIEW_AS = {torch.bfloat16: torch.uint16, torch.float8_e4m3fn: torch.uint8,
            torch.float8_e5m2: torch.uint8}


def flatten_with_paths(tree: PyTree) -> Tuple[List[str], list]:
    """(paths, leaves) in jax's order for nested dicts: sorted keys, each
    key as `['key']`, joined by "/"."""
    paths: List[str] = []
    leaves: list = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + [f"[{k!r}]"])
        else:
            paths.append("/".join(prefix))
            leaves.append(node)

    walk(tree, [])
    return paths, leaves


def _unflatten_like(like: PyTree, leaves: list) -> PyTree:
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            built = {k: walk(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}  # like's own key order
        return next(it)

    return walk(like)


def _multi_rank() -> bool:
    import torch.distributed as dist
    return dist.is_initialized() and dist.get_world_size() > 1


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of the group, or a
    process outside one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t` for np.save, bf16 and float8 as their bits. A
    copy even of a CPU tensor: the optimizer writes params in place while
    an async save may still be writing them."""
    t = t.detach().to("cpu", copy=True)
    return t.view(_VIEW_AS.get(t.dtype, t.dtype)).numpy()


def _host_leaves(leaves: list) -> Optional[list]:
    """The writer's host copies of `leaves`; None on the other ranks. A
    DTensor is gathered whole, leaf by leaf (a collective: every rank
    calls it), and only the writer copies it to host memory, so another
    rank holds one gathered leaf at a time on its device and none on the
    host."""
    from repro_torch.distributed.act_sharding import is_dtensor
    writes = _writes()
    host = []
    for t in leaves:
        if is_dtensor(t):
            t = t.full_tensor()
        if writes:
            host.append(_to_host(t))
    return host if writes else None


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    return torch.from_numpy(arr).view(getattr(torch, dtype_name))


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: PyTree) -> str:
        if self._thread is not None:
            self._thread.join()  # one outstanding async save at a time
            self._thread = None
        # materialize to host memory synchronously, write async
        paths, leaves = flatten_with_paths(tree)
        host = _host_leaves(leaves)
        dtypes = [str(x.dtype).removeprefix("torch.") for x in leaves]
        path = os.path.join(self.directory, f"step_{step:08d}")
        if host is None:
            return path

        def _write():
            final = path
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            meta = {"step": step, "paths": paths,
                    "shapes": [list(x.shape) for x in host],
                    "dtypes": dtypes}
            for i, arr in enumerate(host):
                np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
        return path

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _multi_rank():
            import torch.distributed as dist
            dist.barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: PyTree,
                torch_device: TorchDevice = "cuda",
                shardings: Optional[PyTree] = None) -> PyTree:
        """Restore into the structure of `like` (any tree of that shape:
        tensors, meta tensors), each leaf with its stored dtype, on
        `torch_device`; with `shardings` (a tree of
        `distributed.sharding.NamedSharding` matching `like`), each leaf
        as a DTensor with its sharding's placements, every rank keeping
        its shards of what it read."""
        dev = resolve_torch_device(torch_device)
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        paths, _ = flatten_with_paths(like)
        stored = {p: i for i, p in enumerate(meta["paths"])}
        leaves = []
        for p in paths:
            if p not in stored:
                raise KeyError(f"checkpoint missing leaf {p}")
            i = stored[p]
            arr = np.load(os.path.join(d, f"arr_{i}.npy"))
            leaves.append(_from_saved(arr, meta["dtypes"][i]).to(dev))
        tree = _unflatten_like(like, leaves)
        if shardings is None:
            return tree
        from repro_torch.distributed.sharding import distribute
        return distribute(tree, shardings)
