"""Serving launcher: batched generation with the Engine (port of
`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --smoke --torch-device cpu \
        --requests 8 --prompt-len 32 --max-new 16

The model is initialised from --seed on --torch-device (default cuda, which
raises without a card) and serves on it. --production-mesh (a multi-device
mesh) raises NotImplementedError: the distribution layer is not ported yet
(ROADMAP Queue 1 item 12). Architectures whose blocks are not ported raise
too (item 11).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request


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
                    help="not ported yet (the distribution layer)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh is not ported yet (ROADMAP Queue 1 item 12: "
            "the distribution layer); the port serves on one card")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(args.seed, torch_device=args.torch_device)

    rng = np.random.RandomState(args.seed)
    engine = Engine(model, params,
                    max_len=args.prompt_len + args.max_new + 8,
                    batch_slots=args.batch_slots, seed=args.seed)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size,
                                       size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for _ in range(args.requests)]
    t0 = time.time()
    engine.generate(reqs)
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s)")
    for i, r in enumerate(reqs[:4]):
        print(f"  req{i}: {r.out_tokens[:12]}...")
    return reqs


if __name__ == "__main__":
    main()
