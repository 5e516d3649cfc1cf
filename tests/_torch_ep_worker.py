"""One gloo rank of tests/test_torch_expert_parallel.py (run as a script,
not collected): the port only, no jax.

    python tests/_torch_ep_worker.py RANK WORLD INIT_FILE WORKDIR

On the (2, 2, 2) ("pod", "data", "model") mesh over WORLD = 8 ranks, with
the MoE params and tokens the test saved to WORKDIR/inputs.npz (dbrx-132b
smoke, E = 4, top_k = 2, cf = 8.0, float32): `moe_forward` under
`Hints(moe_impl="expert_parallel")`, then the gradients of sum(y^2) + aux,
twice: with plain tensors (the same on every rank; the smoke plan "tp") and
with DTensors placed by the "fsdp_tp" plan (the expert weights' embed dim
over ("pod", "data"), which the body all-gathers) and the tokens over
("pod", "data"); then the scatter path on DTensors at cf 1.25, where
tokens drop (the "tp" plan's experts over "model", the tokens of
inputs.npz's x_drop over ("pod", "data")). Rank 0 writes
WORKDIR/results.npz.
"""
import dataclasses
import os
import sys

import numpy as np
import torch

rank, world = int(sys.argv[1]), int(sys.argv[2])
init_file, work = sys.argv[3], sys.argv[4]
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.act_sharding import Hints, use_hints  # noqa: E402
from repro_torch.launch.mesh import init_process_group  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import ParamBuilder, use_layout  # noqa: E402
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication)
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

init_process_group("cpu", init_method=f"file://{init_file}", rank=rank,
                   world_size=world)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                  mesh_dim_names=("pod", "data", "model"))
base = get_smoke_config("dbrx-132b").replace(activation_dtype="float32")
base = base.replace(moe=dataclasses.replace(
    base.moe, num_experts=4, top_k=2, capacity_factor=8.0))
inputs = dict(np.load(os.path.join(work, "inputs.npz")))
hints = Hints(mesh, ("pod", "data"), "model", moe_impl="expert_parallel")
out = {}


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def run(cfg, p, x, tag):
    with use_hints(hints):
        y, aux = moe.moe_forward(p, cfg, x, impl="expert_parallel")
        loss = (y ** 2).sum() + aux
    loss.backward()
    out[f"{tag}_y"] = full(y).detach().numpy()
    out[f"{tag}_aux"] = np.float32(float(full(aux)))
    out[f"{tag}_grad_x"] = full(x.grad).numpy()
    for k, v in p.items():
        out[f"{tag}_grad_{k}"] = full(v.grad).numpy()


# plain tensors, the same on every rank (the smoke plan, "tp")
p = {k[2:]: torch.tensor(v).requires_grad_() for k, v in inputs.items()
     if k.startswith("p_")}
run(base, p, torch.tensor(inputs["x"]).requires_grad_(), "tp")

# the fsdp_tp plan's placements: DTensor params and tokens
cfg = base.replace(sharding_plan="fsdp_tp")
b = ParamBuilder(None, "float32", abstract=True)
moe.init_moe(b, cfg)
shard = sh.param_shardings(b.params["moe"], b.axes["moe"], mesh,
                           cfg.sharding_plan)
out["fsdp_wi_spec"] = np.array(repr(shard["wi"].spec))
p = {k: sh.distribute(torch.tensor(inputs[f"p_{k}"]), shard[k])
     .detach().requires_grad_() for k in shard}
x = sh.distribute(torch.tensor(inputs["x"]),
                  sh.NamedSharding(mesh, (("pod", "data"), None, None)))
run(cfg, p, x.detach().requires_grad_(), "fsdp_tp")

# the scatter path's mesh form at cf 1.25, where tokens drop: DTensor
# tokens over ("pod", "data") and the experts over "model" (the "tp"
# plan), under the mesh's layout ops, keep the global capacity
drop = base.replace(moe=dataclasses.replace(base.moe, capacity_factor=1.25))
b = ParamBuilder(None, "float32", abstract=True)
moe.init_moe(b, drop)
shard = sh.param_shardings(b.params["moe"], b.axes["moe"], mesh, "tp")
p = {k: sh.distribute(torch.tensor(inputs[f"p_{k}"]), shard[k])
     for k in shard}
x = sh.distribute(torch.tensor(inputs["x_drop"]),
                  sh.NamedSharding(mesh, (("pod", "data"), None, None)))
with torch.no_grad(), implicit_replication(), use_layout(sh.MESH_OPS):
    y, aux = moe.moe_forward_scatter(p, drop, x)
out["scatter_mesh_y"] = full(y).numpy()
out["scatter_mesh_aux"] = np.float32(float(full(aux)))
out["scatter_mesh_wi"] = np.array(repr(shard["wi"].spec))

if rank == 0:
    np.savez(os.path.join(work, "results.npz"), **out)
torch.distributed.destroy_process_group()
