"""One rank of tests/test_torch_decode_attention.py's mesh check (run as a
script, not collected): the port only, no jax.

    python tests/_torch_decode_mesh_worker.py RANK WORLD INIT_FILE OUT_JSON [DEVICE]

On the (1, WORLD) ("data", "model") mesh (gloo on the CPU, NCCL on cards,
rank r on card r), `sharding.on_shards` runs the decode entry
`kernels.decode_attention.decode_attention` on each rank's shards of
DTensor q [B, H, D] (its heads sharded on "model") against replicated
bf16 caches k, v [B, Sc, G, D] and positions, as
`models/attention.py:decode_attend` does under a mesh, for three layouts
of kv heads over the 4 ranks: 2 (each rank's q heads in one group: k and v
sliced to it), 4 (kv heads sharded alike) and 1 (every rank in the one
group). Rank 0 writes, per case, the largest relative error over each
(row, q head) of the gathered output against the entry on the whole
inputs, and the launches of the rank (0 on the CPU, where the entry takes
its plain version).
"""
import json
import sys

import torch
import torch.distributed as dist

rank, world = int(sys.argv[1]), int(sys.argv[2])
init_file, out_path = sys.argv[3], sys.argv[4]
device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
torch.set_num_threads(1)

from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.launch.mesh import init_process_group  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

# (B, Sc, H, G, D, kept, window)
CASES = {"group_of_2": (3, 300, 32, 2, 128, 250, 0),
         "heads_sharded": (2, 200, 16, 4, 64, 200, 90),
         "one_kv_head": (2, 130, 8, 1, 256, 100, 0)}


def row_rel_err(got, want) -> float:
    """max over (row, q head) of ||got - want|| / ||want||."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


init_process_group(device, init_method="file://" + init_file, rank=rank,
                   world_size=world)
mesh = DeviceMesh(device, torch.arange(world).reshape(1, world),
                  mesh_dim_names=("data", "model"))
dev = f"cuda:{rank}" if device == "cuda" else "cpu"
out = {}
for name, (B, Sc, H, G, D, kept, window) in CASES.items():
    gen = torch.Generator().manual_seed(B * Sc + H * G + D)
    q = torch.randn(B, H, D, generator=gen).to(torch.bfloat16).to(dev)
    k, v = (torch.randn(B, Sc, G, D, generator=gen).to(torch.bfloat16)
            .to(dev) for _ in range(2))
    slot = torch.arange(Sc, dtype=torch.int32)
    n = torch.clamp(kept - torch.arange(B, dtype=torch.int32), min=1)
    pos = torch.where(slot[None, :] < n[:, None], slot[None, :], -1).to(
        torch.int32).to(dev)
    cur = (n - 1).to(dev)
    qd = DTensor.from_local(q, mesh, [Replicate(), Replicate()],
                            run_check=False).redistribute(
        mesh, [Replicate(), Shard(1)])
    kd, vd, pd, cd = (DTensor.from_local(t, mesh, [Replicate(), Replicate()],
                                         run_check=False)
                      for t in (k, v, pos, cur))
    before = da.decode_attention.launches
    got = sh.on_shards(da.decode_attention, qd, kd, vd, (pd, cd), q_heads=1,
                       window=window)
    assert got.placements == qd.placements, got.placements
    got = got.full_tensor()
    launches = da.decode_attention.launches - before
    want = da.decode_attention(q, k, v, pos, cur, window=window)
    out[name] = {"row_rel_err": row_rel_err(got, want),
                 "launches": launches, "local_heads": H // world}
dist.barrier()
dist.destroy_process_group()
if rank == 0:
    with open(out_path, "w") as f:
        json.dump(out, f)
    print("DECODE_MESH", json.dumps(out), flush=True)
