"""Puts a profiled `generate`'s device work and device idle time down to
the program's own spans (`repro_torch.obs.trace`).

With `program_tracer()` active around the profiled call, every program
span is also a range of the profiler, on the profiler's own clock. The
harness's traced slice does not activate it yet (PERF.md, Open
questions), so no metric reads this module. Each kernel, memcpy and
memset event is joined to the `cuda_runtime` or `cuda_driver` event that
launched it by `args.correlation`, and put down to the chain of program ranges open on
the launching thread at the launch: the innermost one owns it ("self"),
and every range of the chain contains it ("in"). The parts are the
chains' own: work launched under `serve.prefill` is prefill's, under
`serve.decode_step` decode's, under other spans "other", and work
launched under none is unattributed. Each idle gap of the device inside
a part, the parts and gaps as `perfbench.trace.reduce` splits them (the
prefill from the window's start to the first device-to-host copy, the
decode to the last), goes to the program ranges open at the gap's
midpoint on the thread that ran `serve.generate` (`(no span)` where none
is). The MoE counts are the attrs of the tracer's own
`block.moe` events whose parent chain reaches `serve.decode_step`.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from perfbench.trace import DEVICE_CATS, _is_dtoh, _union

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# a program range: `record_function`'s, or `_RecordFunctionFast`'s
RANGE_CATS = ("user_annotation", "cpu_op")
PARTS = (("prefill", "serve.prefill"), ("decode", "serve.decode_step"))
ROOT = "serve.generate"
MOE_SPAN = "block.moe"
MOE_COUNTS = ("assignments", "dropped", "experts_used", "experts_run")
NONE = "(no span)"

Range = Tuple[float, float, str]


def program_tracer():
    """A tracer whose spans are profiler ranges, or None where the
    program's `Tracer` takes no `annotate` (it has no such spans).

    The ranges are `torch._C._profiler._RecordFunctionFast`'s (`cpu_op`
    events) where torch has it, else `torch.profiler.record_function`'s
    (`user_annotation`). On an H100's host (torch 2.11) a
    `record_function` costs 12.6 us under the profiler and the fast range
    1.9 us, and glm4-9b.chat's profiled decode step read 25-30 ms slower
    with the former (PERF.md, Findings)."""
    import torch
    from repro_torch.obs import trace as obs_trace
    annotate = getattr(torch._C._profiler, "_RecordFunctionFast",
                       torch.profiler.record_function)
    try:
        return obs_trace.Tracer(annotate=annotate)
    except TypeError:
        return None


def split(events: List[dict], program_events: List[dict]
          ) -> Tuple[List[dict], List[dict]]:
    """(the program's ranges, the other events): `perfbench.trace` reads
    the others, which are what the trace held before the spans."""
    names = {e["name"] for e in program_events}
    ranges, rest = [], []
    for ev in events:
        is_range = ev.get("cat") in RANGE_CATS and ev.get("name") in names
        (ranges if is_range else rest).append(ev)
    return ranges, rest


def _chains(ranges: List[Range], times: Sequence[float]
            ) -> List[Tuple[str, ...]]:
    """For each of the sorted `times`, the names of `ranges` (one
    thread's, nested) that cover it, outermost first."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][1]:  # not its parent
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(r[2] for r in stack))
    return out


def _part(chain: Tuple[str, ...]) -> Optional[str]:
    """The part whose span the chain holds; "other" for a chain under
    neither, None for no chain."""
    for part, span in PARTS:
        if span in chain:
            return part
    return "other" if chain else None


def _new_part() -> Dict:
    return {"device_s": 0.0, "device_self": defaultdict(float),
            "device_in": defaultdict(float), "idle_s": 0.0,
            "idle_self": defaultdict(float), "idle_in": defaultdict(float)}


def _add(part: Dict, kind: str, chain: Tuple[str, ...], s: float) -> None:
    part[kind + "_s"] += s
    part[kind + "_self"][chain[-1] if chain else NONE] += s
    for name in set(chain):
        part[kind + "_in"][name] += s


def _gaps(merged, a: float, b: float) -> List[Tuple[float, float]]:
    """The device's idle intervals inside [a, b]."""
    out, t = [], a
    for s, e in merged:
        if e <= a:
            continue
        if s >= b:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < b:
        out.append((t, b))
    return out


def _moe(program_events: List[dict]) -> Optional[Dict[str, float]]:
    by_id = {e["args"]["span_id"]: e for e in program_events}
    total = dict.fromkeys(MOE_COUNTS, 0)
    seen = False
    for e in program_events:
        args = e["args"]
        if e["name"] != MOE_SPAN or "experts_run" not in args:
            continue
        p = by_id.get(args.get("parent_id"))
        while p is not None and p["name"] != PARTS[1][1]:
            p = by_id.get(p["args"].get("parent_id"))
        if p is None:
            continue
        seen = True
        for k in MOE_COUNTS:
            total[k] += args[k]
    return total if seen else None


def reduce(program_events: List[dict], events: List[dict]) -> Optional[Dict]:
    """program_events: the tracer's events; events: the profiler trace's
    `traceEvents`. Seconds by span name for each part; None where the
    trace holds no program range or no device work."""
    names = {e["name"] for e in program_events}
    ranges: Dict[tuple, List[Range]] = defaultdict(list)
    launches: Dict[object, tuple] = {}
    dev, dtoh = [], []
    lo = float("inf")
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat")
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        if cat in RANGE_CATS and ev.get("name") in names:
            ranges[(ev.get("pid"), ev.get("tid"))].append(
                (s, e, ev["name"]))
            continue  # not one of the events trace.reduce reads
        if cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev.get("pid"), ev.get("tid"), s)
        elif cat in DEVICE_CATS:
            dev.append((s, e, ev.get("args", {}).get("correlation")))
            if _is_dtoh(ev):
                dtoh.append(e)
        if cat in DEVICE_CATS or cat == "cpu_op":
            lo = min(lo, s)
    if not ranges or not dev:
        return None
    parts = {p: _new_part() for p in ("prefill", "decode", "other")}
    unattributed = 0.0
    # device work, by the chain open at its launch on the launching thread
    queries: Dict[tuple, List[Tuple[float, float]]] = defaultdict(list)
    for s, e, corr in dev:
        launch = launches.get(corr)
        if launch is None:
            unattributed += (e - s) * 1e-6
            continue
        queries[launch[:2]].append((launch[2], (e - s) * 1e-6))
    for thread, qs in queries.items():
        qs.sort()
        for chain, (_, secs) in zip(
                _chains(ranges.get(thread, []), [t for t, _ in qs]), qs):
            part = _part(chain)
            if part is None:
                unattributed += secs
            else:
                _add(parts[part], "device", chain, secs)
    # the idle gaps of trace.reduce's parts, by the chain open at each
    # gap's midpoint on the serving thread
    main = next((k for k, rs in ranges.items()
                 if any(r[2] == ROOT for r in rs)), None)
    if dtoh and main is not None:
        dtoh.sort()
        merged = _union([(s, e) for s, e, _ in dev])
        for part, a, b in (("prefill", lo, dtoh[0]),
                           ("decode", dtoh[0], dtoh[-1])):
            mids = sorted(((g0 + g1) / 2, (g1 - g0) * 1e-6)
                          for g0, g1 in _gaps(merged, a, b))
            for chain, (_, secs) in zip(
                    _chains(ranges[main], [m for m, _ in mids]), mids):
                _add(parts[part], "idle", chain, secs)
    out = {p: {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in d.items()} for p, d in parts.items()}
    out["unattributed_device_s"] = unattributed
    out["moe"] = _moe(program_events)
    return out
