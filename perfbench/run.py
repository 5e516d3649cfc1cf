"""The benchmark of the PyTorch port (`repro_torch`) on NVIDIA GPUs.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Prints the run's facts and the numbers
its check compared on standard error, and one JSON object as the last
line of standard output: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` `breakdown`, and last `check`. Exits non-zero
with no result without enough CUDA devices, when the program cannot be
imported, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Build and kernel caches inside the checkout, at fixed paths; no
    library loads JAX on the port's behalf."""
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    import repro_torch  # noqa: F401  (the system under test)
    from perfbench import harness, spec

    bench = spec.benchmark(ROOT)
    wl = spec.workload(bench, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(wl["chips"]):
        print(f"perfbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    out = harness.run_cell(
        spec.config_file(bench, wl["config"], ROOT),
        spec.traffic(wl["traffic"]),
        spec.cell(args.workload),
        spec.metrics_of(bench, args.workload, bool(args.trace)),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device="cuda:0", t_start=T_START, chips=int(wl["chips"]))
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: loaded {loaded}; the benchmark runs the port "
              f"alone", file=sys.stderr)
        return 3
    print("perfbench: " + json.dumps(out["info"]), file=sys.stderr)
    for name, c in out["result"]["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
