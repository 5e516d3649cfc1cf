"""Finds a cell's files by the names in `BENCHMARK.json`: its
configuration (the entry's `file`), its traffic mix
(`perfbench/traffic/<traffic>.json`), its own settings
(`perfbench/cells/<workload>.json`) and a reader for each metric it
reports (`perfbench/metrics/<metric>.py`, a `read(observed)` that returns
a number or None, and optionally `NEEDS`, the readings beyond the window
and the trace that it reads, such as "split": `harness.step_split`).

A cell's file: `batch_slots` (requests a wave), `trace_decode_steps`
(decode steps of the traced slice) and `check`: `tokens` (served tokens
the sample of a dense model reaches) and `limits` (each number compared
and its limit, `perfbench/check.py`)."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    return load_json(HERE / "cells" / f"{name}.json")


def _reports(metric: dict, cell_name: str, e2e_of_cell: List[str]) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_of_cell


def metrics_of(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell_name, [])]
    if not trace:
        return e2e
    names = [m["name"] for m in e2e]
    return [m for m in bench["per_layer"] if _reports(m, cell_name, names)]


def _metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str) -> Callable:
    return _metric(name).read


def needs(name: str) -> Tuple[str, ...]:
    """What the metric reads beyond the window and the trace."""
    return tuple(getattr(_metric(name), "NEEDS", ()))

