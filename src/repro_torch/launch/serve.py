"""Serving launcher: batched generation with the Engine (port of
`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --smoke --torch-device cpu \
        --requests 8 --prompt-len 32 --max-new 16

Every architecture of `ARCH_IDS` serves. The model is initialised from
--seed on --torch-device (default cuda, which raises without a card) and
serves on it. Whisper's encoder frames and the VLM's frontend embeddings
(stub frontends) are drawn from the same `RandomState(seed)` before the
prompts, as the reference draws them, so both packages get the same
inputs. --production-mesh serves over the (16, 16) mesh
(`launch.mesh.make_production_mesh`: each of 256 ranks, under
`torch.distributed.run`, holds its shards of the params, placed per the
config's sharding plan); in a smaller group it raises RuntimeError, as the
reference does with fewer devices. `--trace PATH` serves under an
`obs.trace.Tracer` and writes its events (the engine's and the model's
spans, `serve.generate` at the root) to PATH as a Chrome trace, which
chrome://tracing, https://ui.perfetto.dev and `launch.obs` read.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import Engine, Request


def extra_batch(cfg, batch_slots: int, rng: np.random.RandomState) -> dict:
    """The stub frontends' inputs, one row per slot, float32 from `rng`:
    whisper's encoder frames or the VLM's frontend embeddings ({} for the
    other configs)."""
    width = cfg.frontend_dim or cfg.d_model
    if cfg.is_encoder_decoder:
        return {"encoder_embeddings": rng.randn(
            batch_slots, cfg.encoder_seq_len, width).astype(np.float32) * 0.1}
    if cfg.cross_attn_every > 0:
        return {"frontend_embeddings": rng.randn(
            batch_slots, cfg.num_frontend_tokens, width).astype(
                np.float32) * 0.1}
    return {}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh: 256 ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--trace", metavar="PATH",
                    help="write the serving spans to PATH (Chrome trace)")
    args = ap.parse_args(argv)
    mesh = None
    if args.production_mesh:
        import os

        from repro_torch.launch.mesh import (init_process_group,
                                             make_production_mesh)
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            init_process_group(args.torch_device)
        mesh = make_production_mesh()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(args.seed, torch_device=args.torch_device)
    if mesh is not None:
        from repro_torch.distributed import sharding as sh
        params = sh.distribute(params, sh.param_shardings(
            params, model.abstract_params_and_axes()[1], mesh,
            cfg.sharding_plan))

    rng = np.random.RandomState(args.seed)
    engine = Engine(model, params,
                    max_len=args.prompt_len + args.max_new + 8,
                    batch_slots=args.batch_slots,
                    extra_batch=extra_batch(cfg, args.batch_slots, rng),
                    seed=args.seed, mesh=mesh)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size,
                                       size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for _ in range(args.requests)]
    tracer = obs_trace.Tracer() if args.trace else None
    if tracer is not None:
        obs_trace.activate(tracer)
    t0 = time.time()
    try:
        engine.generate(reqs)
    finally:
        if tracer is not None:
            obs_trace.deactivate(tracer)
    dt = time.time() - t0
    if tracer is not None:
        with open(args.trace, "w") as f:
            json.dump(obs_trace.to_chrome_trace(tracer.events), f)
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s)")
    for i, r in enumerate(reqs[:4]):
        print(f"  req{i}: {r.out_tokens[:12]}...")
    return reqs


if __name__ == "__main__":
    main()
