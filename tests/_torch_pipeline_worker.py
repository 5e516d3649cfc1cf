"""One gloo rank of tests/test_torch_pipeline.py (run as a script, not
collected): the port only, no jax.

    python tests/_torch_pipeline_worker.py RANK WORLD INIT_FILE WORKDIR

The reference's TestPipeline case on WORLD = 4 ranks: a ("pod",) mesh of
4 stages, stage_fn(s, x) = tanh(x @ W[s]) with W [4, 8, 8] and x [6, 2,
8] from WORKDIR/inputs.npz. Every rank writes its result to
WORKDIR/out_<rank>.npy.
"""
import os
import sys

import numpy as np
import torch

rank, world = int(sys.argv[1]), int(sys.argv[2])
init_file, work = sys.argv[3], sys.argv[4]
torch.set_num_threads(1)

from repro_torch.distributed.pipeline import pipeline_apply  # noqa: E402
from repro_torch.launch.mesh import init_process_group  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402

init_process_group("cpu", init_method=f"file://{init_file}", rank=rank,
                   world_size=world)
mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("pod",))
inputs = np.load(os.path.join(work, "inputs.npz"))
W, x = torch.as_tensor(inputs["W"]), torch.as_tensor(inputs["x"])
calls = []


def stage_fn(stage, h):
    calls.append(stage)
    return torch.tanh(h @ W[stage])


out = pipeline_apply(stage_fn, x, mesh, num_stages=world)
# each stage ran once a microbatch, and only its own stage
assert calls == [rank] * x.shape[0], calls
np.save(os.path.join(work, f"out_{rank}.npy"), out.numpy())
torch.distributed.destroy_process_group()
