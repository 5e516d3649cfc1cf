"""Campaign flight recorder: events.jsonl + campaign.trace.json per run
(port of `repro.obs.recorder`; imports repointed, nothing else changed).

`FlightRecorder` binds the three telemetry pieces together for one
campaign: a campaign-scoped `MetricsRegistry` (pushed onto the process
registry stack so every layer's `metrics.current()` lands here while the
recorder runs), an active `Tracer` (so `trace.span(...)` sites emit), and
two artifacts under `root`:

  * ``events.jsonl`` — append-only, one JSON object per line, written as
    events happen (a crashed campaign still leaves its decision log):
    grant decisions, refresh outcomes, warning+ log lines, and a final
    metrics snapshot;
  * ``campaign.trace.json`` — the Chrome-trace/Perfetto span timeline,
    written on `stop()` (merged across farm workers and serving readers).

`summarize_trace()` attributes the root span's wall time to the span
taxonomy (measure / update / search / finish / overhead) — the
`CampaignResult.obs_summary` the launcher logs and the >=95%-attribution
acceptance gate. The whole module is torch-free.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

from repro_torch.obs import logging as obs_logging
from repro_torch.obs import metrics, trace

EVENTS_NAME = "events.jsonl"
TRACE_NAME = "campaign.trace.json"


class FlightRecorder:
    """Record one campaign. Use as a context manager, or rely on
    `run_campaign(obs=...)` to own start/stop. `start()`/`stop()` are
    idempotent, so a caller-constructed recorder passed into
    `run_campaign` survives the campaign's own lifecycle calls."""

    def __init__(self, root: Optional[str] = None,
                 registry: Optional[metrics.MetricsRegistry] = None,
                 tracer: Optional[trace.Tracer] = None):
        self.root = root
        self.registry = registry if registry is not None \
            else metrics.MetricsRegistry()
        self.tracer = tracer if tracer is not None else trace.Tracer()
        self._events_f = None
        self._started = False
        self._stopped = False
        self._log_events: List[Dict] = []

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "FlightRecorder":
        if self._started:
            return self
        self._started = True
        if self.root is not None:
            os.makedirs(self.root, exist_ok=True)
            self._events_f = open(os.path.join(self.root, EVENTS_NAME), "a")
        metrics.push_registry(self.registry)
        trace.activate(self.tracer)
        obs_logging.add_sink(self._log_sink)
        self.event("recorder_start", trace_id=self.tracer.trace_id)
        return self

    def stop(self) -> None:
        if not self._started or self._stopped:
            return
        self._stopped = True
        obs_logging.remove_sink(self._log_sink)
        trace.deactivate(self.tracer)
        metrics.pop_registry(self.registry)
        self.event("metrics", snapshot=self.registry.snapshot())
        self.event("recorder_stop")
        if self._events_f is not None:
            self._events_f.close()
            self._events_f = None
        if self.root is not None:
            path = os.path.join(self.root, TRACE_NAME)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.tracer.to_chrome(), f)
            os.replace(tmp, path)

    def __enter__(self) -> "FlightRecorder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- event log --------------------------------------------------------
    def event(self, kind: str, **fields) -> None:
        """Append one structured event; flushed immediately so a dead
        campaign still leaves every decision it made on disk."""
        rec = {"t": round(time.time(), 6), "kind": kind}
        rec.update(fields)
        self._log_events.append(rec)
        if self._events_f is not None:
            self._events_f.write(json.dumps(rec) + "\n")
            self._events_f.flush()

    def _log_sink(self, level: str, name: str, msg: str,
                  fields: Dict[str, object]) -> None:
        self.event("log", level=level, logger=name, msg=msg,
                   **{k: (v if isinstance(v, (str, int, float, bool,
                                              type(None))) else str(v))
                      for k, v in fields.items()})

    @property
    def events(self) -> List[Dict]:
        return list(self._log_events)

    def summary(self) -> Dict[str, object]:
        return summarize_trace(self.tracer.events,
                               registry_json=self.registry.to_json())


# --- analysis --------------------------------------------------------------

# span name -> summary category; anything else under the root is "other"
_CATEGORIES = {
    "round.measure": "measure",
    "round.update": "update",
    "round.search": "search",
    "tune.finish": "finish",
}


def summarize_trace(events: List[Dict],
                    registry_json: Optional[Dict] = None) -> Dict[str, object]:
    """Attribute the root span's wall time to the span taxonomy.

    Category seconds sum leaf-level work spans (round.measure /
    round.update / round.search / tune.finish); `overhead` is the root
    minus its DIRECT children (scheduler bookkeeping between grants), and
    `attributed_pct` is the fraction of root wall time covered by the
    named categories + per-grant overhead — >= 95% on a well-formed
    trace. Queue-wait comes from the registry's
    `exec.queue_wait_seconds` histogram (it overlaps measure wall time,
    so it is reported alongside, not added to, the attribution)."""
    spans = [e for e in events if e.get("ph") == "X"]
    out: Dict[str, object] = {"n_spans": len(spans)}
    if not spans:
        out["problems"] = ["no span events"]
        return out
    by_id = {e["args"]["span_id"]: e for e in spans
             if e.get("args", {}).get("span_id")}
    roots = [e for e in spans if e["args"].get("parent_id") is None]
    out["problems"] = trace.validate_events(events)
    root = max(roots, key=lambda e: e.get("dur", 0)) if roots else None
    total_s = (root.get("dur", 0) / 1e6) if root is not None else 0.0
    out["root"] = root.get("name") if root is not None else None
    out["total_wall_s"] = total_s

    cat_s: Dict[str, float] = defaultdict(float)
    name_s: Dict[str, float] = defaultdict(float)
    name_n: Dict[str, int] = defaultdict(int)
    errors = 0
    for e in spans:
        name = e.get("name", "?")
        dur_s = e.get("dur", 0) / 1e6
        name_s[name] += dur_s
        name_n[name] += 1
        if e["args"].get("status") == "error":
            errors += 1
        cat = _CATEGORIES.get(name)
        if cat is not None:
            cat_s[cat] += dur_s

    # per-grant overhead: each tune.round minus ITS children; campaign
    # overhead: root minus its direct children
    child_sum: Dict[str, float] = defaultdict(float)
    for e in spans:
        pid = e["args"].get("parent_id")
        if pid is not None:
            child_sum[pid] += e.get("dur", 0) / 1e6
    if root is not None:
        rid = root["args"]["span_id"]
        cat_s["overhead"] += max(0.0, total_s - child_sum.get(rid, 0.0))
    for e in spans:
        if e.get("name") == "tune.round":
            sid = e["args"].get("span_id")
            dur_s = e.get("dur", 0) / 1e6
            cat_s["overhead"] += max(0.0, dur_s - child_sum.get(sid, 0.0))

    out["categories_s"] = {k: round(v, 6) for k, v in sorted(cat_s.items())}
    out["by_name"] = {k: {"n": name_n[k], "seconds": round(v, 6)}
                      for k, v in sorted(name_s.items())}
    out["error_spans"] = errors
    attributed = sum(cat_s.values())
    out["attributed_pct"] = round(100.0 * attributed / total_s, 2) \
        if total_s > 0 else 0.0
    _ = by_id    # id map retained for future drill-down surfaces

    if registry_json is not None:
        qw = None
        for key, h in registry_json.get("histograms", {}).items():
            if key.startswith("exec.queue_wait_seconds"):
                qw = h
                break
        if qw is not None and qw["count"]:
            out["queue_wait"] = {"n": qw["count"],
                                 "total_s": round(qw["sum"], 6),
                                 "p50_ms": round((qw["p50"] or 0) * 1e3, 3),
                                 "p99_ms": round((qw["p99"] or 0) * 1e3, 3)}
        meas = registry_json.get("counters", {}).get(
            "exec.measure_seconds_total")
        if meas is not None:
            out["measure_seconds_simulated"] = round(meas, 3)
    return out


def load_events(path_or_dir: str) -> List[Dict]:
    """Read an ``events.jsonl`` (given the file, its directory, or a
    directory containing an ``obs/`` subdirectory)."""
    path = _resolve(path_or_dir, EVENTS_NAME)
    out: List[Dict] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: torn event line "
                                 f"({e})") from e
    return out


def load_trace(path_or_dir: str) -> List[Dict]:
    path = _resolve(path_or_dir, TRACE_NAME)
    with open(path) as f:
        data = json.load(f)
    return data.get("traceEvents", [])


def _resolve(path_or_dir: str, name: str) -> str:
    if os.path.isfile(path_or_dir):
        return path_or_dir
    for cand in (os.path.join(path_or_dir, name),
                 os.path.join(path_or_dir, "obs", name)):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"no {name} under {path_or_dir!r}")
