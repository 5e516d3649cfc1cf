"""Reduces one torch.profiler trace (its Chrome-trace JSON) to the device's
busy and idle time.

Device intervals are the kernel, memcpy and memset events; their union is
the busy time. The engine copies each step's sampled tokens to the host,
so the first device-to-host copy ends the prefill and the last ends the
decode steps: `parts` splits the traced window there. The breakdown
lists the device operations that took most time, and the idle time
grouped by the host operation that was running at each gap's midpoint
(the innermost `cpu_op`, else "host (between ops)").
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10

Interval = Tuple[float, float]


def _union(iv: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _busy_in(merged: List[Interval], lo: float, hi: float) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def _is_dtoh(ev: dict) -> bool:
    return ev.get("cat") == "gpu_memcpy" and "DtoH" in ev.get("name", "")


def reduce(events: List[dict]) -> Optional[Dict]:
    """events: the trace's `traceEvents`. Times in seconds; None when the
    trace holds no device work."""
    dev, cpu, dtoh = [], [], []
    lo, hi = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        cat = ev.get("cat")
        if cat in DEVICE_CATS:
            dev.append((s, e, ev.get("name", "?")))
            if _is_dtoh(ev):
                dtoh.append(e)
        elif cat == "cpu_op":
            cpu.append((s, e, ev.get("name", "?")))
        else:
            continue
        lo, hi = min(lo, s), max(hi, e)
    if not dev:
        return None
    merged = _union([(s, e) for s, e, _ in dev])
    by_op: Dict[str, float] = defaultdict(float)
    for s, e, name in dev:
        by_op[name] += (e - s) * 1e-6
    gaps = defaultdict(float)
    cpu.sort()
    starts = [c[0] for c in cpu]
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        gaps[_host_at(cpu, starts, (g0 + g1) / 2)] += (g1 - g0) * 1e-6
    out = {"window_s": (hi - lo) * 1e-6,
           "busy_s": _busy_in(merged, lo, hi) * 1e-6,
           "device_ops": _top(by_op), "idle_gaps": _top(gaps), "parts": {}}
    if dtoh:
        dtoh.sort()
        for name, a, b in (("prefill", lo, dtoh[0]),
                           ("decode", dtoh[0], dtoh[-1])):
            if b > a:
                busy = _busy_in(merged, a, b)
                out["parts"][name] = {"span_s": (b - a) * 1e-6,
                                      "busy_s": busy * 1e-6,
                                      "idle_pct": 100.0 * (1 - busy / (b - a))}
    return out


def _host_at(cpu, starts, t: float) -> str:
    """The innermost cpu_op running at time t (the latest-starting one
    that covers it)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 4096), -1):
        s, e, name = cpu[j]
        if e >= t:
            return name
    return "host (between ops)"


def _top(d: Dict[str, float]) -> List[list]:
    return [[k[:160], v] for k, v in sorted(d.items(),
                                            key=lambda kv: -kv[1])[:TOP]]
