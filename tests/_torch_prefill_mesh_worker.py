"""One rank of tests/test_torch_prefill_attention.py's mesh check (run as a
script, not collected): the port only, no jax.

    python tests/_torch_prefill_mesh_worker.py RANK WORLD INIT_FILE OUT_JSON [DEVICE]

On the (1, WORLD) ("data", "model") mesh (gloo on the CPU, NCCL on cards,
rank r on card r), `sharding.on_shards` runs the prefill entry
`kernels.flash_attention.prefill_attention` on each rank's shards of
DTensor q [B, S, H, D] (its heads sharded on "model") against replicated
k, v [B, S, G, D], as `models/attention.py:prefill_attend` does under a
mesh, for three layouts of kv heads over the 4 ranks: 2 (each rank's q
heads in one group: k and v sliced to it), 4 (kv heads sharded alike) and
1 (every rank in the one group). Rank 0 writes, per case, the largest
relative error over each (batch, q head, 128-row band) of the gathered
output against the entry on the whole inputs, and the launches of the
rank (0 on the CPU, where the entry takes its plain version).
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.mesh import init_process_group  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

# (B, S, H, G, D, causal, window)
CASES = {"group_of_2": (2, 300, 16, 2, 128, True, 0),
         "heads_sharded": (2, 300, 16, 4, 64, True, 100),
         "one_kv_head": (2, 130, 8, 1, 64, False, 0)}


def band_rel_err(got, want, band=128) -> float:
    """max over (batch, q head, band of rows) of ||got - want|| /
    ||want||."""
    got, want = got.float(), want.float()
    B, S, H, _ = want.shape
    pad = -S % band

    def per_band(x):
        x = torch.nn.functional.pad(x.square().sum(dim=-1), (0, 0, 0, pad))
        return x.reshape(B, (S + pad) // band, band, H).sum(dim=2)
    return float((per_band(got - want) / per_band(want)).sqrt().max())


init_process_group(device, init_method="file://" + init_file, rank=rank,
                   world_size=world)
mesh = DeviceMesh(device, torch.arange(world).reshape(1, world),
                  mesh_dim_names=("data", "model"))
dev = f"cuda:{rank}" if device == "cuda" else "cpu"
out = {}
for name, (B, S, H, G, D, causal, window) in CASES.items():
    gen = torch.Generator().manual_seed(B * S + H * G + D)
    q, k, v = (torch.randn(B, S, n, D, generator=gen).to(torch.bfloat16)
               .to(dev) for n in (H, G, G))
    qd = DTensor.from_local(q, mesh, [Replicate(), Replicate()],
                            run_check=False).redistribute(
        mesh, [Replicate(), Shard(2)])
    kd, vd = (DTensor.from_local(t, mesh, [Replicate(), Replicate()],
                                 run_check=False) for t in (k, v))
    before = fa.prefill_attention.launches
    got = sh.on_shards(fa.prefill_attention, qd, kd, vd, causal=causal,
                       window=window)
    assert got.placements == qd.placements, got.placements
    got = got.full_tensor()
    launches = fa.prefill_attention.launches - before
    want = fa.prefill_attention(q, k, v, causal=causal, window=window)
    out[name] = {"band_rel_err": band_rel_err(got, want),
                 "launches": launches, "local_heads": H // world}
dist.barrier()
dist.destroy_process_group()
if rank == 0:
    with open(out_path, "w") as f:
        json.dump(out, f)
    print("PREFILL_MESH", json.dumps(out), flush=True)
