"""One gloo rank of tests/test_torch_tp_products.py's value checks (run as
a script, not collected): the port only, no jax.

    python tests/_torch_tp_worker.py RANK WORLD INIT_FILE OUT_JSON

On the (2, 2) ("data", "model") mesh over WORLD = 4 ranks, for each
architecture at smoke size under the fsdp_tp plan with float32
activations: one train step and a prefill with two decode steps, on the
mesh and without it, from the same params, batch, decode tokens and
optimizer. The archs reach the product forms' other paths: recurrentgemma-2b's one
kv head (k and v split by rows and gathered; each rank's query heads in
that one group), xlstm-350m's cells on each rank's heads
(`LayoutOps.on_heads`), deepseek-v3-671b's column-parallel router and
shared experts, and llama-3.2-vision-90b's cross attention. Rank 0
writes, per arch, the largest difference of the loss, the grad norm, each
first moment (0.1 x the clipped gradient) and the logits, each beside the
largest magnitude of its plain value.
"""
import json
import sys

import torch
import torch.distributed as dist

rank, world = int(sys.argv[1]), int(sys.argv[2])
init_file, out_path = sys.argv[3], sys.argv[4]
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import init_process_group  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.train.train_loop import (  # noqa: E402
    init_train_state, make_serve_prefill, make_serve_step, make_train_step)
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

ARCHS = ("recurrentgemma-2b", "xlstm-350m", "deepseek-v3-671b",
         "llama-3.2-vision-90b")
B, S, STEPS = 4, 16, 2


def whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def diff(got, want) -> list:
    """[max |got - want|, max |want|]."""
    got, want = whole(got).float(), whole(want).float()
    assert got.shape == want.shape, (got.shape, want.shape)
    return [float((got - want).abs().max()), float(want.abs().max())]


def serve(model, params, batch, tokens, mesh) -> list:
    """The prefill's logits, then each decode step's on `tokens` [STEPS,
    B]."""
    state, logits = make_serve_prefill(model, max_len=S + STEPS, mesh=mesh)(
        params, batch)
    step = make_serve_step(model, mesh=mesh)
    out = [whole(logits)]
    for t in tokens:
        state, logits = step(params, state, t)
        out.append(whole(logits))
    return out


init_process_group("cpu", init_method=f"file://{init_file}", rank=rank,
                   world_size=world)
mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, 2),
                  mesh_dim_names=("data", "model"))
gen = torch.Generator().manual_seed(0)
results = {}
for arch in ARCHS:
    cfg = get_smoke_config(arch).replace(sharding_plan="fsdp_tp",
                                         activation_dtype="float32")
    model = build_model(cfg)
    opt = AdamW(AdamWConfig(lr=1e-3))
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                              dtype=torch.int32)
             for k in ("tokens", "targets")}
    if cfg.cross_attn_every:
        batch["frontend_embeddings"] = torch.randn(
            (B, cfg.num_frontend_tokens, cfg.frontend_dim), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (STEPS, B), generator=gen,
                           dtype=torch.int32)
    plain = init_train_state(model, opt, 0, "cpu")
    placed = init_train_state(model, opt, 0, "cpu", mesh=mesh)
    serve_batch = {k: v for k, v in batch.items() if k != "targets"}
    logits_plain = serve(model, plain["params"], serve_batch, tokens, None)
    logits_mesh = serve(model, placed["params"], serve_batch, tokens, mesh)
    _, m_plain = make_train_step(model, opt)(plain, batch)
    _, m_mesh = make_train_step(model, opt, mesh=mesh)(placed, batch)
    results[arch] = {
        "loss": diff(m_mesh["loss"], m_plain["loss"]),
        "grad_norm": diff(m_mesh["grad_norm"], m_plain["grad_norm"]),
        "moments": [diff(g, w) for g, w in zip(
            tree_leaves(placed["opt"]["m"]), tree_leaves(plain["opt"]["m"]))],
        "logits": [diff(g, w) for g, w in zip(logits_mesh, logits_plain)]}
if rank == 0:
    with open(out_path, "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
