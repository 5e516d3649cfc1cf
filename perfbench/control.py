"""Readings that the check's limits are set from, at a cell's own size.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        [--control 1]

For each seed, in one process: the cell's weights and one wave of its
traffic served by the program (the window closes after the first wave),
then the numbers the check compares; with `--control 1` also the
control's (the plain reference at fp8 in the program's place, read at
the same positions against the float32 reference), put through the
cell's own limits by the harness's comparison. One JSON line a seed on
standard output. Exits 1 where the control came out correct on a seed:
the limits then do not separate it from the program. Not part of a
benchmark run.
"""
from __future__ import annotations

import json
import sys
import time

from run import ROOT, _environment


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from perfbench import harness, spec

    if not torch.cuda.is_available():
        print("perfbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark(ROOT)
    wl = spec.workload(bench, args.workload)
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        out = harness.run_cell(
            spec.config_file(bench, wl["config"], ROOT),
            spec.traffic(wl["traffic"]), spec.cell(args.workload), [],
            seed=seed, seconds=0.0, trace=False, device="cuda:0",
            t_start=time.perf_counter(), control=bool(args.control))
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["result"]["correct"],
                          "memory_peak_bytes":
                          out["result"]["device"]["memory_peak_bytes"],
                          **out["info"]}), flush=True)
        if args.control and out["info"]["control"]["correct"]:
            passed.append(seed)
    if passed:
        print(f"perfbench.control: the control came out correct on seeds "
              f"{passed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
