"""Device meshes over `torch.distributed` (port of `repro.launch.mesh`).

Functions, not module-level constants, so importing this module touches no
process group. A mesh spans the ranks of the current default process
group, one device a rank; its device type follows the group's backend:
NCCL meshes are on `cuda`, gloo (and the fake group of a dry run) on the
CPU. `init_process_group` picks the backend from the device the same way.
Nothing here switches backend or device when one fails.

Single pod = 16x16 (256 ranks); multi-pod = 2 pods x 256 = 512 ranks with
a leading "pod" axis.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.placement import TorchDevice, resolve_torch_device


def backend_for(torch_device: TorchDevice) -> str:
    """The collective backend of a device: NCCL for cuda, gloo for cpu."""
    return "nccl" if torch.device(torch_device).type == "cuda" else "gloo"


def init_process_group(torch_device: TorchDevice = "cuda",
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None) -> None:
    """Join the default process group with the device's backend
    (`backend_for`); a no-op when this process has joined one already.
    Without arguments the rendezvous comes from the environment that
    `torch.distributed.run` sets (RANK, WORLD_SIZE, MASTER_ADDR, ...). On
    cuda, each rank takes the card of its LOCAL_RANK (default: its
    rank)."""
    if dist.is_initialized():
        return
    dev = resolve_torch_device(torch_device)
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend_for(dev), init_method=init_method or
                            "env://", rank=rank, world_size=world_size)


def group_device_type() -> str:
    """The device type of the default group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if _world() < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, found {_world()} — run it "
            f"in a process group of {need} ranks (a fake process group "
            f"gives a dry run without cards)")
    return DeviceMesh(group_device_type(),
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the current group:
    data = world // model_parallel."""
    world = _world()
    if world == 0:
        raise RuntimeError("make_host_mesh needs a process group: call "
                           "init_process_group first")
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the {world} ranks of the process group")
    return DeviceMesh(group_device_type(),
                      torch.arange(world).reshape(
                          world // model_parallel, model_parallel),
                      mesh_dim_names=("data", "model"))
