"""Observability CLI: flight records, live serving watch, bench history
(port of `repro.launch.obs`).

    PYTHONPATH=src python -m repro_torch.launch.obs --summarize DIR
    PYTHONPATH=src python -m repro_torch.launch.obs --check DIR
    PYTHONPATH=src python -m repro_torch.launch.obs --export DIR [--out PATH]
    PYTHONPATH=src python -m repro_torch.launch.obs --diff DIR_A DIR_B
    PYTHONPATH=src python -m repro_torch.launch.obs --watch [--root DIR]
    PYTHONPATH=src python -m repro_torch.launch.obs --watch --once [--check]
    PYTHONPATH=src python -m repro_torch.launch.obs --diff   (bench history)
    PYTHONPATH=src python -m repro_torch.launch.obs --explain DEVICE WORKLOAD
    PYTHONPATH=src python -m repro_torch.launch.obs --report DIR

`DIR` is a flight-recorder artifact directory (containing `events.jsonl` +
`campaign.trace.json`, e.g. the path passed to `run_campaign(obs=...)` or
`launch.train --obs`), or any directory with an `obs/` subdirectory.

--summarize   attribute campaign wall time to the span taxonomy (measure /
              update / search / finish / overhead), report queue-wait
              percentiles and top counters.
--check DIR   validate flight-record artifacts (every events.jsonl line
              parses, the span tree is non-empty, single-rooted,
              orphan-free, every span closed ok|error); exit non-zero on
              any problem — the CI obs smoke gate.
--export      rewrite the merged span timeline as a standalone Chrome-trace
              JSON (open in chrome://tracing or https://ui.perfetto.dev).
--diff A B    compare two flight records side by side.
--diff        with no operands: compare the latest two entries per suite in
              the bench history (``artifacts/bench_history.jsonl``, written
              by ``benchmarks.run``) and flag metric regressions.
--explain     the full story behind one served winner: its transfer
              provenance (source devices + fingerprint similarities +
              mixing weights, params lineage, lottery-ticket overlap,
              measurement budget, live calibration at tuning time) joined
              with the registry entry. Asks a running farm's writer first
              (`explain` op), falls back to the on-disk provenance shards
              under `--root`. WORKLOAD is a workload key
              ("matmul:256x256x128") or any unique substring of one.
--report DIR  render a campaign report (markdown + JSON) from a
              flight-recorder artifact directory: wall-time attribution,
              budget-grant trace, calibration curves, SLO/alert history,
              and (when `--root` points at a hub) refresh decisions and
              per-winner provenance. Validates the artifacts first
              (`validate_events`-grade checks); exit non-zero on problems.
--watch       live terminal view of a `launch.hub --serve` farm: polls the
              writer's `metrics`/`health` ops every --interval seconds and
              renders QPS, latency percentiles, cache hit rate, SLO status,
              and recent alerts. `--once` prints a single frame; adding
              bare `--check` turns that frame into a gate (well-formed
              exposition, >=1 reader alive, zero firing SLOs) that retries
              until the farm answers or --timeout expires — the CI
              monitoring smoke leg.

Torch-free, as the reference is jax-free: runs anywhere the artifacts (or
the serving sockets) are reachable, and reads what either package wrote —
flight records, hub roots and `endpoints.json` have one format. Bare
`--diff` reads the history file directly; it imports nothing of
`benchmarks/`.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import socket
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs import MetricsRegistry, to_chrome_trace, validate_events
from repro_torch.obs.metrics import hist_percentile
from repro_torch.obs.recorder import (load_events, load_trace, summarize_trace)
from repro_torch.obs.timeseries import _key_matches, merge_hist_states


def _final_metrics(events: List[Dict]) -> Optional[Dict]:
    """The last metrics snapshot event in an events.jsonl stream."""
    for e in reversed(events):
        if e.get("kind") == "metrics" and "snapshot" in e:
            return e["snapshot"]
    return None


def _load(path: str) -> Tuple[List[Dict], List[Dict]]:
    return load_events(path), load_trace(path)


def summarize(path: str) -> Dict:
    events, spans = _load(path)
    snap = _final_metrics(events)
    reg_json = None
    if snap is not None:
        # summarize_trace reads percentiles off exposition-shaped dicts;
        # rebuild one from the snapshot so merged runs work too
        from repro_torch.obs import MetricsRegistry
        reg = MetricsRegistry()
        reg.merge(snap)
        reg_json = reg.to_json()
    return summarize_trace(spans, registry_json=reg_json)


def print_summary(path: str) -> int:
    s = summarize(path)
    events, _ = _load(path)
    print(f"flight record: {path}")
    print(f"  spans={s.get('n_spans', 0)} events={len(events)} "
          f"root={s.get('root')} error-spans={s.get('error_spans', 0)}")
    total = s.get("total_wall_s", 0.0)
    print(f"  campaign wall: {total:.3f}s; attribution "
          f"{s.get('attributed_pct', 0.0):.1f}% across:")
    cats = s.get("categories_s", {})
    for cat in ("measure", "update", "search", "finish", "overhead"):
        if cat in cats:
            sec = cats[cat]
            pct = 100.0 * sec / total if total > 0 else 0.0
            print(f"    {cat:10s} {sec:10.3f}s {pct:6.1f}%")
    qw = s.get("queue_wait")
    if qw:
        print(f"  queue-wait: n={qw['n']} total={qw['total_s']:.3f}s "
              f"p50={qw['p50_ms']:.2f}ms p99={qw['p99_ms']:.2f}ms")
    ms = s.get("measure_seconds_simulated")
    if ms is not None:
        print(f"  simulated measure seconds: {ms:.1f}")
    grants = [e for e in events if e.get("kind") == "grant"]
    if grants:
        by_reason: Dict[str, int] = {}
        for g in grants:
            by_reason[g.get("reason", "?")] = \
                by_reason.get(g.get("reason", "?"), 0) + 1
        print(f"  grants: {len(grants)} "
              f"({', '.join(f'{k}={v}' for k, v in sorted(by_reason.items()))})")
    for name, row in sorted(s.get("by_name", {}).items()):
        print(f"    span {name:16s} n={row['n']:5d} {row['seconds']:.3f}s")
    return 0


def check(path: str) -> int:
    """The CI gate: artifacts present, parseable, span tree well-formed."""
    problems: List[str] = []
    try:
        events = load_events(path)
    except (OSError, ValueError) as e:
        print(f"[obs] CHECK FAIL: events.jsonl: {e}", file=sys.stderr)
        return 1
    if not events:
        problems.append("events.jsonl is empty")
    for i, e in enumerate(events):
        if "t" not in e or "kind" not in e:
            problems.append(f"event {i} missing t/kind: {e}")
    try:
        spans = load_trace(path)
    except (OSError, json.JSONDecodeError) as e:
        print(f"[obs] CHECK FAIL: campaign.trace.json: {e}",
              file=sys.stderr)
        return 1
    problems.extend(validate_events(spans))
    if problems:
        for p in problems:
            print(f"[obs] CHECK FAIL: {p}", file=sys.stderr)
        return 1
    n_spans = len([e for e in spans if e.get("ph") == "X"])
    print(f"[obs] check OK: {len(events)} event(s), {n_spans} span(s), "
          f"single-rooted tree")
    return 0


def export(path: str, out: Optional[str]) -> int:
    spans = load_trace(path)
    out = out or os.path.join(
        path if os.path.isdir(path) else os.path.dirname(path),
        "trace.export.json")
    with open(out, "w") as f:
        json.dump(to_chrome_trace(spans), f)
    print(f"[obs] wrote {out} ({len(spans)} event(s)); open in "
          f"chrome://tracing or https://ui.perfetto.dev")
    return 0


def diff(path_a: str, path_b: str) -> int:
    sa, sb = summarize(path_a), summarize(path_b)
    ea, eb = load_events(path_a), load_events(path_b)
    print(f"{'':12s} {'A':>12s} {'B':>12s} {'delta':>12s}")
    print(f"{'A':3s}= {path_a}")
    print(f"{'B':3s}= {path_b}")

    def row(label: str, va, vb, fmt: str = "{:.3f}") -> None:
        da = fmt.format(va) if va is not None else "-"
        db = fmt.format(vb) if vb is not None else "-"
        dd = (fmt.format(vb - va)
              if va is not None and vb is not None else "-")
        print(f"  {label:12s} {da:>12s} {db:>12s} {dd:>12s}")

    row("wall_s", sa.get("total_wall_s"), sb.get("total_wall_s"))
    cats = sorted(set(sa.get("categories_s", {}))
                  | set(sb.get("categories_s", {})))
    for c in cats:
        row(c + "_s", sa.get("categories_s", {}).get(c),
            sb.get("categories_s", {}).get(c))
    qa, qb = sa.get("queue_wait") or {}, sb.get("queue_wait") or {}
    row("qwait_p99_ms", qa.get("p99_ms"), qb.get("p99_ms"), "{:.2f}")
    row("measure_sim_s", sa.get("measure_seconds_simulated"),
        sb.get("measure_seconds_simulated"), "{:.1f}")
    ma, mb = _final_metrics(ea) or {}, _final_metrics(eb) or {}
    keys = sorted(set(ma.get("counters", {})) | set(mb.get("counters", {})))
    for k in keys:
        row(k, ma.get("counters", {}).get(k),
            mb.get("counters", {}).get(k), "{:.0f}")
    return 0


# ---------------------------------------------------------------------------
# Live serving watch (scrapes the writer's metrics/health ops)
# ---------------------------------------------------------------------------


def _writer_call(root: str, op: str, timeout_s: float = 5.0,
                 **fields) -> Dict[str, Any]:
    """One framed request to the serving parent's writer socket."""
    from repro_torch.hub.serving import protocol
    from repro_torch.hub.serving.server import endpoints_path
    with open(endpoints_path(root)) as f:
        data = json.load(f)
    port = data.get("writer_port")
    if not port:
        raise ConnectionError(f"no writer_port in {endpoints_path(root)}")
    with socket.create_connection((data.get("host", "127.0.0.1"), int(port)),
                                  timeout=timeout_s) as s:
        protocol.send_frame(s, {"op": op, **fields})
        reply = protocol.recv_frame(s)
    if not reply:
        raise ConnectionError(f"writer hung up on op={op}")
    return reply


def scrape(root: str, timeout_s: float = 5.0) -> Tuple[Dict, Dict]:
    """(metrics reply, health reply) from a running serving farm."""
    return (_writer_call(root, "metrics", timeout_s),
            _writer_call(root, "health", timeout_s))


def _snapshot_percentile(snap: Dict, prefix: str, p: float) -> float:
    states = [st for key, st in snap.get("histograms", {}).items()
              if _key_matches(key, prefix)]
    merged = merge_hist_states(states)
    if merged is None or not merged.get("count"):
        return float("nan")
    return hist_percentile(merged, p)


def _counter_sum(snap: Dict, prefix: str) -> float:
    return sum(v for key, v in snap.get("counters", {}).items()
               if _key_matches(key, prefix))


def _fmt_ms(v: float) -> str:
    return "-" if v != v else f"{v * 1e3:.2f}ms"


def render_watch(metrics: Dict, health: Dict) -> str:
    """One text frame of farm state from the two scrape payloads."""
    snap = metrics.get("snapshot", {})
    lines: List[str] = []
    lines.append(
        f"hub serving  uptime={health.get('uptime_s', 0.0):.1f}s  "
        f"readers={health.get('alive', 0)}/{health.get('total', 0)} alive  "
        f"respawns={health.get('respawns', 0)}  "
        f"monitor={'on' if health.get('monitor') else 'off'}")
    qps = (metrics.get("rates") or {}).get("qps_30s")
    hits = sum(v for k, v in snap.get("counters", {}).items()
               if k.startswith("serve.cache_lookups") and "result=hit" in k)
    misses = sum(v for k, v in snap.get("counters", {}).items()
                 if k.startswith("serve.cache_lookups") and "result=miss" in k)
    total_lk = hits + misses
    hit_rate = f"{100.0 * hits / total_lk:.1f}%" if total_lk else "-"
    lines.append(
        f"  qps(30s)={qps:.2f}  " if isinstance(qps, (int, float))
        else "  qps(30s)=-  ")
    lines[-1] += (
        f"requests={_counter_sum(snap, 'serve.requests'):.0f}  "
        f"errors={_counter_sum(snap, 'serve.errors'):.0f}  "
        f"cache_hit={hit_rate}")
    p50 = _snapshot_percentile(snap, "serve.latency_seconds", 50)
    p99 = _snapshot_percentile(snap, "serve.latency_seconds", 99)
    lines.append(f"  latency p50={_fmt_ms(p50)} p99={_fmt_ms(p99)}")
    slo_rows = metrics.get("slo") or []
    if slo_rows:
        cells = []
        for st in slo_rows:
            mark = {"ok": "ok", "firing": "FIRING",
                    "no_data": "no-data"}.get(st.get("state"), "?")
            cells.append(f"{st.get('name')}={mark}")
        lines.append("  SLO: " + "  ".join(cells))
    alerts = metrics.get("alerts") or []
    for a in alerts[-3:]:
        lines.append(f"  alert: {a.get('slo')} -> {a.get('state')} "
                     f"(fast={a.get('value_fast')}, "
                     f"slow={a.get('value_slow')}, "
                     f"threshold={a.get('threshold')})")
    for rrow in health.get("readers", []):
        lines.append(
            f"  reader rid={rrow.get('rid')} port={rrow.get('port')} "
            f"alive={rrow.get('alive')} "
            f"beat_age={rrow.get('last_beat_age_s')}s")
    return "\n".join(lines)


def check_serving(metrics: Dict, health: Dict) -> List[str]:
    """Gate conditions for `--watch --once --check`."""
    problems: List[str] = []
    if not metrics.get("ok"):
        problems.append(f"metrics op not ok: {metrics.get('error')}")
    if not health.get("ok"):
        problems.append(f"health op not ok: {health.get('error')}")
    snap = metrics.get("snapshot")
    if not isinstance(snap, dict):
        problems.append("metrics reply carries no snapshot")
    else:
        try:
            reg = MetricsRegistry()
            reg.merge(snap)
            text = reg.to_text()
            if not text.strip():
                problems.append("text exposition is empty")
            for line in text.splitlines():
                if len(line.rsplit(" ", 1)) != 2:
                    problems.append(f"malformed exposition line: {line!r}")
        except Exception as e:  # merge must round-trip cleanly
            problems.append(f"snapshot does not merge: {e!r}")
    if not (metrics.get("text") or "").strip():
        problems.append("metrics reply carries no text exposition")
    if health.get("alive", 0) < 1:
        problems.append("no reader alive")
    firing = [st for st in metrics.get("slo") or []
              if st.get("state") == "firing"]
    for st in firing:
        problems.append(f"SLO firing: {st.get('name')} "
                        f"(fast={st.get('value_fast')}, "
                        f"threshold={st.get('threshold')})")
    return problems


def watch(root: str, interval: float = 2.0, once: bool = False,
          gate: bool = False, timeout: float = 30.0) -> int:
    """Poll the farm and render frames; with once+gate, retry until the
    first successful scrape (or timeout), then exit 0/1 on the gate."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            metrics, health = scrape(root)
        except (OSError, ValueError, ConnectionError) as e:
            if once and time.monotonic() < deadline:
                time.sleep(0.5)
                continue
            print(f"[obs] watch: cannot scrape {root}: {e}",
                  file=sys.stderr)
            return 1
        print(render_watch(metrics, health), flush=True)
        if gate:
            problems = check_serving(metrics, health)
            if problems:
                for p in problems:
                    print(f"[obs] WATCH CHECK FAIL: {p}", file=sys.stderr)
                return 1
            print("[obs] watch check OK")
            return 0
        if once:
            return 0
        time.sleep(interval)


# ---------------------------------------------------------------------------
# Explain: transfer provenance behind one served winner
# ---------------------------------------------------------------------------


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Tolerant JSONL reader (torn trailing line dropped)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        lines = f.read().splitlines()
    out: List[Dict[str, Any]] = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                continue
            raise
    return out


def _provenance_by_task(root: str, device: str) -> Dict[str, Dict[str, Any]]:
    """All provenance records for a device from the on-disk shard (newest
    per task wins). Raw-file read: no torch, no hub import."""
    path = os.path.join(root, "store", "provenance",
                        _sanitize(device) + ".jsonl")
    by_task: Dict[str, Dict[str, Any]] = {}
    for rec in _read_jsonl(path):
        if rec.get("task"):
            by_task[rec["task"]] = rec
    return by_task


def _registry_entry(root: str, device: str,
                    task_key: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(root, "tuned_configs.json")
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return data.get(device, {}).get(task_key)


def _match_task(candidates: List[str], query: str) -> Tuple[Optional[str],
                                                            List[str]]:
    """Resolve a workload-key query: exact match, else unique substring.
    Returns (resolved key or None, the ambiguous matches if any)."""
    if query in candidates:
        return query, []
    matches = [k for k in candidates if query in k]
    if len(matches) == 1:
        return matches[0], []
    return None, matches


def explain(root: str, device: str, task: str) -> int:
    """Print the provenance + registry story for one (device, workload)."""
    by_task = _provenance_by_task(root, device)
    key, ambiguous = _match_task(sorted(by_task), task)
    if key is None and ambiguous:
        print(f"[obs] explain: {task!r} is ambiguous among {ambiguous}",
              file=sys.stderr)
        return 1
    record: Optional[Dict[str, Any]] = None
    # a running farm answers authoritatively (its store may be ahead of
    # the shard this process can see); fall back to the on-disk shard
    try:
        reply = _writer_call(root, "explain", device=device,
                             task=key or task)
        if reply.get("ok"):
            record = reply.get("provenance")
            entry = reply.get("registry")
            key = reply.get("task", key)
        else:
            record = None
    except (OSError, ValueError, ConnectionError):
        record = by_task.get(key) if key is not None else None
        entry = (_registry_entry(root, device, key)
                 if key is not None else None)
    if record is None:
        known = sorted(by_task)
        print(f"[obs] explain: no provenance for ({device!r}, {task!r})"
              + (f"; known tasks: {known}" if known else
                 f"; no provenance shard under {root}"), file=sys.stderr)
        return 1
    print(render_explain(device, key or task, record, entry))
    return 0


def render_explain(device: str, task: str, prov: Dict[str, Any],
                   entry: Optional[Dict[str, Any]]) -> str:
    """One winner's story as markdown (the --explain stdout and the
    per-winner section of --report)."""
    lines = [f"## explain {device} {task}", ""]
    thr = prov.get("throughput_gflops")
    knobs = prov.get("knobs") or {}
    lines.append(f"- winner: `{json.dumps(knobs, sort_keys=True)}` at "
                 f"{thr:.2f} GFLOP/s" if isinstance(thr, (int, float))
                 else f"- winner: `{json.dumps(knobs, sort_keys=True)}`")
    if entry is not None and entry.get("throughput_gflops") is not None:
        lines.append(f"- registry serves: {entry['throughput_gflops']:.2f} "
                     f"GFLOP/s")
    lines.append(f"- strategy: {prov.get('strategy') or '?'}"
                 + (f", {prov['trials_per_task']} trials/task"
                    if prov.get("trials_per_task") else ""))
    sources = prov.get("sources") or []
    if sources:
        lines.append("- sources (fingerprint similarity -> mixing weight):")
        for s in sources:
            sim = s.get("similarity")
            lines.append(f"    - {s.get('device')}: "
                         + (f"sim={sim:.4f} " if isinstance(sim, float)
                            else "")
                         + f"weight={s.get('weight')}")
    else:
        lines.append("- sources: none (cold universe / from-scratch)")
    if prov.get("params_device") is not None:
        ver = prov.get("params_version")
        lines.append(f"- warm-started from {prov['params_device']} params"
                     + (f" v{ver}" if ver is not None else ""))
    lineage = prov.get("lineage") or []
    if lineage:
        chain = " -> ".join(
            f"v{e.get('version')}({e.get('trigger')})" for e in lineage)
        lines.append(f"- params lineage: {chain}")
    if prov.get("mask_overlap") is not None:
        lines.append(f"- lottery-ticket overlap (source ticket vs final "
                     f"params): {prov['mask_overlap']:.3f}")
    lines.append(f"- budget: {prov.get('measurements', 0)} measurements, "
                 f"{prov.get('search_seconds', 0.0):.2f} simulated s, "
                 f"{prov.get('poisoned', 0)} poisoned")
    calib = prov.get("calibration")
    if calib:
        ra = calib.get("rank_accuracy")
        parts = [f"{calib.get('rounds', 0)} rounds",
                 f"{calib.get('n_points', 0)} points"]
        if ra is not None:
            parts.append(f"rank_accuracy={ra:.3f}")
        if calib.get("mean_abs_residual") is not None:
            parts.append(f"mean|z-residual|={calib['mean_abs_residual']:.3f}")
        hits = calib.get("topk_hits", 0)
        misses = calib.get("topk_misses", 0)
        if hits + misses:
            parts.append(f"top-k hits={hits}/{hits + misses}")
        if calib.get("mean_topk_regret") is not None:
            parts.append(f"mean_regret={calib['mean_topk_regret']:.4f}")
        if calib.get("draft_acceptance") is not None:
            parts.append(f"draft_acceptance={calib['draft_acceptance']:.3f}")
        lines.append("- calibration while tuning: " + ", ".join(parts))
    else:
        lines.append("- calibration while tuning: not tracked")
    if prov.get("created_at"):
        lines.append(f"- tuned at: {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(prov['created_at']))}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Report: one campaign, end to end
# ---------------------------------------------------------------------------


def _events_of_kind(events: List[Dict], kind: str) -> List[Dict]:
    return [e for e in events if e.get("kind") == kind]


def build_report(path: str, hub_root: Optional[str] = None) -> Dict[str, Any]:
    """Assemble the per-campaign report payload from flight-recorder
    artifacts (plus hub-side provenance / refresh logs when available)."""
    events, spans = _load(path)
    problems: List[str] = []
    if not events:
        problems.append("events.jsonl is empty")
    for i, e in enumerate(events):
        if "t" not in e or "kind" not in e:
            problems.append(f"event {i} missing t/kind")
    problems.extend(validate_events(spans))
    snap = _final_metrics(events) or {}

    summary = summarize(path)
    grants = _events_of_kind(events, "grant")
    calib_events = _events_of_kind(events, "calibration")
    calibration = calib_events[-1].get("summary", {}) if calib_events else {}
    result_events = _events_of_kind(events, "campaign_result")
    warnings = [e for e in _events_of_kind(events, "log")
                if e.get("level") in ("warning", "error")]

    residual_p50 = _snapshot_percentile(snap, "calib.residual", 50)
    residual_p90 = _snapshot_percentile(snap, "calib.residual", 90)
    topk_hits = sum(v for k, v in snap.get("counters", {}).items()
                    if k.startswith("calib.topk{") and "result=hit" in k)
    topk_total = _counter_sum(snap, "calib.topk")

    refresh_log: List[Dict[str, Any]] = []
    provenance: Dict[str, Dict[str, Any]] = {}
    if hub_root:
        refresh_log = _read_jsonl(
            os.path.join(hub_root, "store", "refresh_log.jsonl"))
        pdir = os.path.join(hub_root, "store", "provenance")
        if os.path.isdir(pdir):
            for fname in sorted(os.listdir(pdir)):
                if not fname.endswith(".jsonl"):
                    continue
                dev = fname[:-len(".jsonl")]
                for task, rec in sorted(
                        _provenance_by_task(hub_root, dev).items()):
                    provenance[f"{dev}|{task}"] = rec

    return {
        "artifacts": path,
        "hub_root": hub_root,
        "problems": problems,
        "n_events": len(events),
        "summary": summary,
        "grants": grants,
        "calibration": calibration,
        "calibration_rollup": {
            "residual_p50": None if residual_p50 != residual_p50
            else residual_p50,
            "residual_p90": None if residual_p90 != residual_p90
            else residual_p90,
            "topk_hit_rate": (topk_hits / topk_total) if topk_total else None,
        },
        "campaign_result": result_events[-1] if result_events else None,
        "alerts": warnings,
        "refresh_log": refresh_log,
        "provenance": provenance,
    }


def render_report_md(rep: Dict[str, Any]) -> str:
    s = rep["summary"]
    lines = [f"# Campaign report: {rep['artifacts']}", ""]
    if rep["problems"]:
        lines.append("## PROBLEMS")
        lines.extend(f"- {p}" for p in rep["problems"])
        lines.append("")
    total = s.get("total_wall_s", 0.0)
    lines.append("## Campaign")
    lines.append(f"- spans: {s.get('n_spans', 0)}, events: "
                 f"{rep['n_events']}, errors: {s.get('error_spans', 0)}")
    lines.append(f"- wall: {total:.3f}s "
                 f"({s.get('attributed_pct', 0.0):.1f}% attributed)")
    for cat, sec in sorted((s.get("categories_s") or {}).items()):
        pct = 100.0 * sec / total if total > 0 else 0.0
        lines.append(f"    - {cat}: {sec:.3f}s ({pct:.1f}%)")
    res = rep.get("campaign_result")
    if res:
        for k in sorted(res):
            if k not in ("t", "kind"):
                lines.append(f"- {k}: {res[k]}")
    lines.append("")

    if rep["grants"]:
        lines.append("## Budget grants")
        lines.append("| step | task | reason | measured | spent s |")
        lines.append("|---|---|---|---|---|")
        for g in rep["grants"]:
            spent = g.get("spent_seconds")
            spent_s = (f"{spent:.1f}" if isinstance(spent, (int, float))
                       else "?")
            key = str(g.get("key", "?")).replace("|", r"\|")
            lines.append(
                f"| {g.get('step', '?')} | {key} | {g.get('reason', '?')} | "
                f"{g.get('measured', '?')} | {spent_s} |")
        lines.append("")

    lines.append("## Calibration")
    roll = rep["calibration_rollup"]
    if roll.get("residual_p50") is not None:
        lines.append(f"- |z(pred) - z(meas)| residual: "
                     f"p50={roll['residual_p50']:.3f} "
                     f"p90={roll['residual_p90']:.3f}")
    if roll.get("topk_hit_rate") is not None:
        lines.append(f"- top-k hit rate: {roll['topk_hit_rate']:.2f}")
    if rep["calibration"]:
        lines.append("")
        lines.append(r"| device\|task | rounds | points | rank acc | "
                     "mean residual | top-k hits | regret | acceptance |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for raw_key in sorted(rep["calibration"]):
            c = rep["calibration"][raw_key]
            key = raw_key.replace("|", r"\|")
            def _f(v, fmt="{:.3f}"):
                return fmt.format(v) if isinstance(v, (int, float)) else "-"
            lines.append(
                f"| {key} | {c.get('rounds', 0)} | {c.get('n_points', 0)} | "
                f"{_f(c.get('rank_accuracy'))} | "
                f"{_f(c.get('mean_abs_residual'))} | "
                f"{c.get('topk_hits', 0)}/"
                f"{c.get('topk_hits', 0) + c.get('topk_misses', 0)} | "
                f"{_f(c.get('mean_topk_regret'), '{:.4f}')} | "
                f"{_f(c.get('draft_acceptance'))} |")
    elif roll.get("residual_p50") is None:
        lines.append("- no calibration data in this record (run with "
                     "calibration tracking on — the campaign default)")
    lines.append("")

    if rep["alerts"]:
        lines.append("## Warnings & alerts")
        for e in rep["alerts"][-20:]:
            lines.append(f"- [{e.get('level')}] {e.get('logger')}: "
                         f"{e.get('msg')}")
        lines.append("")

    if rep["refresh_log"]:
        lines.append("## Refresh decisions (continual lifecycle)")
        for r in rep["refresh_log"][-20:]:
            if r.get("kind") == "drift_decision":
                ev = ", ".join(
                    f"{d.get('kind')}={d.get('value')}"
                    f" (thr {d.get('threshold')}"
                    f"{', DRIFTED' if d.get('drifted') else ''})"
                    for d in r.get("evidence", []))
                lines.append(f"- {r.get('device')}: decision="
                             f"{r.get('decision')} on [{ev}]")
            else:
                acc = ("accepted" if r.get("accepted") else
                       f"rejected ({r.get('reason')})")
                ho = (f", held-out {r.get('holdout_accuracy_old')} -> "
                      f"{r.get('holdout_accuracy_new')}"
                      if r.get("holdout_accuracy_new") is not None else "")
                lines.append(f"- {r.get('device')}: refresh {acc}, trigger="
                             f"{r.get('trigger')}{ho}")
        lines.append("")

    if rep["provenance"]:
        lines.append("## Winner provenance")
        for key in sorted(rep["provenance"]):
            rec = rep["provenance"][key]
            dev = rec.get("device", key.split("|")[0])
            lines.append("")
            lines.append(render_explain(dev, rec.get("task", "?"), rec,
                                        None))
    return "\n".join(lines) + "\n"


def report(path: str, hub_root: Optional[str] = None) -> int:
    """Build, persist (report.md + report.json next to the artifacts), and
    summarize a campaign report; exit non-zero on validation problems."""
    try:
        rep = build_report(path, hub_root=hub_root)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"[obs] REPORT FAIL: {path}: {e}", file=sys.stderr)
        return 1
    out_dir = path if os.path.isdir(path) else os.path.dirname(path) or "."
    md = render_report_md(rep)
    with open(os.path.join(out_dir, "report.md"), "w") as f:
        f.write(md)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(rep, f, indent=1, sort_keys=True, default=str)
    print(md)
    print(f"[obs] wrote {os.path.join(out_dir, 'report.md')} and "
          f"report.json")
    if rep["problems"]:
        for p in rep["problems"]:
            print(f"[obs] REPORT FAIL: {p}", file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------
# Bench-history diff
# ---------------------------------------------------------------------------

_LOWER_IS_BETTER = ("_us", "_ms", "p50", "p99", "latency", "seconds",
                    "errors", "rejects", "overhead")


def _metric_direction(name: str) -> int:
    """-1 if lower is better, +1 if higher is better (QPS, hit rates)."""
    low = name.lower()
    return -1 if any(tok in low for tok in _LOWER_IS_BETTER) else 1


def diff_bench_history(history: str, suite: Optional[str] = None,
                       tolerance_pct: float = 5.0) -> int:
    """Compare the latest two history entries per suite; flag any metric
    more than `tolerance_pct` worse (direction from the metric name)."""
    try:
        with open(history) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    except OSError as e:
        print(f"[obs] no bench history at {history}: {e}", file=sys.stderr)
        return 1
    by_suite: Dict[str, List[Dict]] = {}
    for r in rows:
        by_suite.setdefault(r.get("suite", "?"), []).append(r)
    suites = [suite] if suite else sorted(by_suite)
    rc = 0
    for s in suites:
        entries = by_suite.get(s, [])
        if len(entries) < 2:
            print(f"# {s}: {len(entries)} history entr"
                  f"{'y' if len(entries) == 1 else 'ies'} — nothing to diff")
            continue
        prev, cur = entries[-2], entries[-1]
        pm = {m["metric"]: m["value"] for m in prev.get("metrics", [])}
        cm = {m["metric"]: m["value"] for m in cur.get("metrics", [])}

        def _name(entry: Dict, fallback: str) -> str:
            """Name a history entry by the commit that produced it (entries
            carry `git_sha` since benchmarks.run started stamping it),
            falling back to the timestamp for older entries."""
            sha = entry.get("git_sha")
            stamp = entry.get("timestamp") or fallback
            return f"{stamp} ({sha[:12]})" if sha else str(stamp)

        print(f"# {s}: {_name(prev, 'prev')} -> {_name(cur, 'latest')}")
        for name in sorted(set(pm) | set(cm)):
            a, b = pm.get(name), cm.get(name)
            if not isinstance(a, (int, float)) or \
                    not isinstance(b, (int, float)):
                continue
            delta_pct = (100.0 * (b - a) / abs(a)) if a else 0.0
            worse = -_metric_direction(name) * delta_pct > tolerance_pct
            flag = "  REGRESSION" if worse else ""
            print(f"  {name:40s} {a:>12.4g} {b:>12.4g} "
                  f"{delta_pct:+8.1f}%{flag}")
            if worse:
                rc = 1
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--summarize", metavar="DIR",
                    help="print the wall-time attribution summary")
    ap.add_argument("--check", nargs="?", const=True, metavar="DIR",
                    help="validate flight-record artifacts (with DIR), or "
                         "gate a --watch frame (bare, with --watch)")
    ap.add_argument("--export", metavar="DIR",
                    help="write a standalone Chrome-trace JSON")
    ap.add_argument("--out", default=None,
                    help="output path for --export")
    ap.add_argument("--diff", nargs="*", metavar="DIR",
                    help="compare two flight records (two operands) or the "
                         "latest two bench-history entries (no operands)")
    ap.add_argument("--watch", action="store_true",
                    help="live view of a running `launch.hub --serve` farm")
    ap.add_argument("--once", action="store_true",
                    help="render a single --watch frame and exit")
    ap.add_argument("--root", default="artifacts/hub",
                    help="hub root for --watch (endpoints.json lives under "
                         "<root>/serving/)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--watch poll interval, seconds")
    ap.add_argument("--timeout", type=float, default=30.0,
                    help="--watch --once: wait up to this long for the "
                         "farm's first successful scrape")
    ap.add_argument("--history", default="artifacts/bench_history.jsonl",
                    help="bench history file for bare --diff")
    ap.add_argument("--suite", default=None,
                    help="restrict bare --diff to one suite")
    ap.add_argument("--explain", nargs=2, metavar=("DEVICE", "WORKLOAD"),
                    default=None,
                    help="print the transfer-provenance story behind one "
                         "served winner (WORKLOAD: key or unique substring; "
                         "hub located via --root)")
    ap.add_argument("--report", metavar="DIR", default=None,
                    help="render a campaign report (markdown + JSON) from a "
                         "flight-record DIR; hub-side provenance/refresh "
                         "logs joined in when --root has them")
    args = ap.parse_args(argv)

    flight_check = args.check if isinstance(args.check, str) else None
    watch_gate = args.check is True
    if watch_gate and not args.watch:
        ap.error("bare --check gates a --watch frame; pass --watch "
                 "(or give --check a flight-record DIR)")
    if not any((args.summarize, flight_check, args.export,
                args.diff is not None, args.watch,
                args.explain, args.report)):
        ap.error("pass --summarize, --check, --export, --diff, --watch, "
                 "--explain, or --report")
    rc = 0
    if flight_check:
        rc = max(rc, check(flight_check))
    if args.summarize:
        rc = max(rc, print_summary(args.summarize))
    if args.export:
        rc = max(rc, export(args.export, args.out))
    if args.diff is not None:
        if len(args.diff) == 2:
            rc = max(rc, diff(args.diff[0], args.diff[1]))
        elif len(args.diff) == 0:
            rc = max(rc, diff_bench_history(args.history, suite=args.suite))
        else:
            ap.error("--diff takes two flight-record DIRs or no operands "
                     "(bench history)")
    if args.explain:
        rc = max(rc, explain(args.root, args.explain[0], args.explain[1]))
    if args.report:
        hub_root = args.root if os.path.isdir(
            os.path.join(args.root, "store")) else None
        rc = max(rc, report(args.report, hub_root=hub_root))
    if args.watch:
        rc = max(rc, watch(args.root, interval=args.interval,
                           once=args.once or watch_gate, gate=watch_gate,
                           timeout=args.timeout))
    return rc


if __name__ == "__main__":
    sys.exit(main())
