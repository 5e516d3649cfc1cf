"""One gloo rank of tests/test_torch_distributed.py (run as a script, not
collected): the port only, no jax.

    python tests/_torch_dist_worker.py RANK WORLD INIT_FILE WORKDIR

On the (2, 2, 2) ("pod", "data", "model") mesh over WORLD = 8 ranks, with
glm4-9b smoke (fsdp_tp, 4 layers as one
stacked group, float32 activations) and the params the
reference saved to WORKDIR/ref_ckpt: one train step, plain and
sequence-sharded decode, `compressed_psum` over the whole group, and the
state after the step saved to WORKDIR/port_ckpt on this mesh (counting
each rank's host copies) and restored onto a (2, 4) host mesh. Rank 0
writes what it measured to WORKDIR/results.json.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

rank, world = int(sys.argv[1]), int(sys.argv[2])
init_file, work = sys.argv[3], sys.argv[4]
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compressed_psum, simulate_compressed_allreduce)
from repro_torch.launch.mesh import (init_process_group,  # noqa: E402
                                     make_host_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.train.train_loop import (  # noqa: E402
    abstract_train_state, make_serve_prefill, make_serve_step,
    make_train_step, train_state_shardings)
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import DTensor, Shard  # noqa: E402


def placements(x: DTensor) -> list:
    """x's placements, each "S<dim>" (a shard), "R" or "P" (partial)."""
    return [f"S{p.dim}" if isinstance(p, Shard) else
            "P" if p.is_partial() else "R" for p in x.placements]


init_process_group("cpu", init_method=f"file://{init_file}", rank=rank,
                   world_size=world)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                  mesh_dim_names=("pod", "data", "model"))
out = {}

# -- one train step from the reference's params ---------------------------
cfg = get_smoke_config("glm4-9b").replace(
    sharding_plan="fsdp_tp", num_layers=4, activation_dtype="float32",
    scan_layers=True)
model = build_model(cfg)
opt = AdamW(AdamWConfig(lr=1e-3))
like = {"params": model.abstract_params_and_axes()[0]}
params = CheckpointManager(os.path.join(work, "ref_ckpt")).restore(
    0, like, "cpu")["params"]
shardings = train_state_shardings(model, opt, mesh)[0]
state = sh.distribute({"params": params, "opt": opt.init(params),
                       "step": torch.zeros((), dtype=torch.int32)},
                      shardings)
emb = state["params"]["embed"]
assert isinstance(emb, DTensor)
assert tuple(emb.placements) == shardings["params"]["embed"].placements
out["embed_placements"] = placements(emb)
batch = dict(np.load(os.path.join(work, "batch.npz")))
state, m = make_train_step(model, opt, mesh=mesh)(state, batch)
out["metrics"] = {k: float(v) for k, v in m.items()}
out["step"] = int(state["step"].full_tensor())
out["state_is_dtensor"] = all(isinstance(x, DTensor)
                              for x in tree_leaves(state))

# -- the mesh's embedding lookup: values and table gradient ---------------
table = torch.randn(64, 16, generator=torch.Generator().manual_seed(5))
ids = torch.randint(0, 64, (8, 6), generator=torch.Generator().manual_seed(6))
want = table.clone().requires_grad_()
(want[ids] ** 2).sum().backward()
dt = sh.distribute(table, sh.NamedSharding(mesh, (("pod", "data"), "model"))
                   ).detach().requires_grad_()
got = sh.embedding_lookup(dt, sh.distribute(
    ids, sh.NamedSharding(mesh, (("pod", "data"), None))))
(got ** 2).sum().backward()
out["embedding_lookup"] = [
    float((got.full_tensor() - table[ids]).abs().max()),
    float((dt.grad.full_tensor() - want.grad).abs().max()),
    placements(dt.grad)]

# -- plain and sequence-sharded decode on the trained params ---------------
B = 8
params = state["params"]
toks = torch.as_tensor(np.random.RandomState(1).randint(
    0, cfg.vocab_size, (B, 15)).astype(np.int32))
nxt = torch.ones((B,), dtype=torch.int32)
with torch.no_grad():
    st, _ = make_serve_prefill(model, max_len=32, mesh=mesh)(
        params, {"tokens": toks})
    _, l1 = make_serve_step(model, mesh=mesh)(params, dict(st), nxt)
    specs = model.init_decode_state_specs(B, 32)
    st2 = sh.distribute(st, sh.decode_state_shardings(
        specs, mesh, B, seq_shard_threshold=8))
    out["cache_placements"] = placements(st2["layers"]["groups"]["b0"]["k"])
    new2, l2 = make_serve_step(model, distributed_cache=True, mesh=mesh)(
        params, dict(st2), nxt)
    out["decode_err"] = float((l1.full_tensor() - l2.full_tensor())
                              .abs().max())
    out["decoded_cache_placements"] = placements(
        new2["layers"]["groups"]["b0"]["k"])

# -- compressed all-reduce over the whole group ----------------------------
x = np.random.RandomState(0).randn(8, 32).astype(np.float32)
mean, err = compressed_psum(torch.as_tensor(x[rank]), torch.zeros(32))
sim_mean, sim_err = simulate_compressed_allreduce(
    [torch.as_tensor(r) for r in x], [torch.zeros(32)] * 8)
errs = [torch.zeros(32) for _ in range(world)]
dist.all_gather(errs, err)
out["psum_mean"] = mean.tolist()
out["psum_equals_simulation"] = bool(
    torch.equal(mean, sim_mean)
    and all(torch.equal(a, b) for a, b in zip(errs, sim_err)))

# -- the state after the step, saved on this mesh; elastic restore --------
# (only the writer, rank 0, may copy the gathered leaves to the host)
host_copies = 0
to_host = checkpoint._to_host


def counting_to_host(t):
    global host_copies
    host_copies += 1
    return to_host(t)


checkpoint._to_host = counting_to_host
ckpt = CheckpointManager(os.path.join(work, "port_ckpt"), async_save=False)
ckpt.save(out["step"], state)
ckpt.wait()
checkpoint._to_host = to_host
copies = [None] * world
dist.all_gather_object(copies, host_copies)
out["host_copies_by_rank"] = copies
out["state_leaves"] = len(tree_leaves(state))
mesh2 = make_host_mesh(4)
restored = ckpt.restore(out["step"], abstract_train_state(model, opt), "cpu",
                        shardings=train_state_shardings(model, opt,
                                                        mesh2)[0])
pairs = list(zip(tree_leaves(state), tree_leaves(restored)))
out["restored_on"] = list(mesh2.shape)
out["restored_placements"] = placements(restored["params"]["embed"])
out["restore_identical"] = all(
    b.device_mesh is mesh2 and torch.equal(a.full_tensor(), b.full_tensor())
    for a, b in pairs)

if rank == 0:
    with open(os.path.join(work, "results.json"), "w") as f:
        json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
