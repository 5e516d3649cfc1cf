"""Transfer-hub launcher (port of `repro.launch.hub`): serve, inspect and
smoke-test the TuningHub, and tune a device through it.

    PYTHONPATH=src python -m repro_torch.launch.hub --smoke [--refresh] \
        [--root DIR] [--torch-device cpu]
    PYTHONPATH=src python -m repro_torch.launch.hub --smoke --serve \
        [--readers N] [--torch-device cpu]
    PYTHONPATH=src python -m repro_torch.launch.hub --serve [--readers N] \
        [--clients N] [--serve-seconds S] [--torch-device cpu]
    PYTHONPATH=src python -m repro_torch.launch.hub --stats [--root DIR]
    PYTHONPATH=src python -m repro_torch.launch.hub --lineage [--device DEV]
    PYTHONPATH=src python -m repro_torch.launch.hub --compact
    PYTHONPATH=src python -m repro_torch.launch.hub --device tpu_lite \
        --dnn squeezenet --trials 32 [--bootstrap tpu_v5e,tpu_edge] [--refresh]

--smoke is the CI leg: a tiny-budget end-to-end pass — bootstrap a two-device
store, fingerprint a device *absent* from it, warm-start Moses from the
auto-selected nearest source, then prove the second `get_config` for the same
(device, workload) is a registry hit with zero new measurements. It tolerates
a warm (cached) hub root: with everything already tuned, the first call is
simply a hit too. Exits non-zero if any serving invariant fails.

--smoke --refresh additionally exercises the continual-learning path on the
same tiny store: background auto-refresh after the serving job, then a
forced lifecycle refresh whose accepted version must land in the store's
lineage (and whose held-out rank-accuracy guard must hold).

--smoke --serve is the hub-serving CI leg: the same tiny store, fronted by
the multi-process `HubServer` — a client's first query funnels tune-on-miss
to the writer hub, the repeat query must be a reader cache hit serving
identical knobs, and a second client on another reader must see the same
winner from the registry. --serve alone runs a long-lived server (with
`--clients N`, N spawned load-generator processes hammer it first and
report QPS).

The cost model, its pre-training and every refresh run on --torch-device
(default cuda, which raises without a card), in this process only: the
server's reader processes and the load-generator clients load no torch,
and neither does importing this module.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

from typing import TYPE_CHECKING

from repro_torch.autotune.space import Workload
from repro_torch.configs.moses import DEFAULT as MOSES_CFG
from repro_torch.obs import get_logger

if TYPE_CHECKING:   # placement imports torch: spawned clients must not
    from repro_torch.core.placement import TorchDevice

log = get_logger("hub")


def _smoke_cfg():
    """Tiny-budget Moses hyperparameters: the full pipeline, CI-sized."""
    return dataclasses.replace(
        MOSES_CFG, online_epochs=4, adaptation_epochs=4, population_size=32,
        evolution_rounds=2, top_k_measure=8)


def _smoke_tasks():
    return [Workload("matmul", (256, 256, 128), name="smoke_a"),
            Workload("matmul", (512, 256, 128), name="smoke_b")]


def _smoke_lifecycle_cfg():
    from repro_torch.continual import LifecycleConfig, ReplayConfig
    return LifecycleConfig(window=8, min_fresh=4, refresh_epochs=3,
                           replay=ReplayConfig(per_task=16))


def run_smoke(root: str, refresh: bool = False,
              torch_device: "TorchDevice" = "cuda") -> int:
    from repro_torch.hub import TuningHub, bootstrap_store

    t0 = time.time()
    hub = TuningHub(root, moses_cfg=_smoke_cfg(), trials_per_task=16,
                    pretrain_epochs=4,
                    refresh="auto" if refresh else "off",
                    lifecycle_cfg=_smoke_lifecycle_cfg() if refresh
                    else None, torch_device=torch_device)
    boot = bootstrap_store(hub.store, ("tpu_v5e", "tpu_edge"),
                           _smoke_tasks(), programs_per_task=16)
    print(f"[hub-smoke] store at {hub.store.root}: "
          f"{boot} new bootstrap records; devices={hub.store.devices()}")

    target = "tpu_v5e_pro"   # absent from the bootstrap set
    wl = _smoke_tasks()[0]
    r1 = hub.get_config(target, wl)
    print(f"[hub-smoke] first  get_config({target}, {wl.key()}): "
          f"hit={r1.cache_hit} new_measurements={r1.new_measurements} "
          f"sources={[(d, round(w, 3)) for d, w in r1.sources]}")
    sel = hub.selection(target)
    if not r1.cache_hit:
        assert sel is not None and sel.best_source == "tpu_v5e", (
            f"nearest-source selection picked {sel and sel.best_source!r}, "
            "expected the near-class tpu_v5e")
        assert r1.new_measurements > 0, "miss path made no measurements"

    r2 = hub.get_config(target, wl)
    print(f"[hub-smoke] second get_config: hit={r2.cache_hit} "
          f"new_measurements={r2.new_measurements}")
    assert r2.cache_hit, "second query must be a registry hit"
    assert r2.new_measurements == 0, "a hit must cost zero measurements"
    assert r2.config.knobs == r1.config.knobs, "hit must serve the winner"
    assert hub.store.get_fingerprint(target) is not None, (
        "target fingerprint was not persisted")

    # introspection invariant: every winner tuned THIS run is fully
    # explainable — provenance + calibration evidence, zero misses. (A warm
    # root skips: its cached winners were tuned by an earlier process whose
    # store may predate provenance.)
    if not r1.cache_hit:
        keys = hub.registry.task_keys(target)
        assert keys, "tuned run landed no registry winners"
        for key in keys:
            exp = hub.explain(target, key)
            assert exp is not None, f"no explain record for {target}|{key}"
            prov = exp["provenance"]
            assert prov.get("sources"), (
                f"{key}: provenance lost its transfer sources")
            assert prov.get("calibration"), (
                f"{key}: winner carries no calibration evidence")
            assert exp["registry"] is not None and \
                prov["knobs"] == exp["registry"]["knobs"], (
                f"{key}: provenance knobs diverge from the served winner")
        print(f"[hub-smoke] explain: {len(keys)} winner(s) fully "
              f"explainable (provenance + calibration, zero misses)")

    if refresh:
        rc = run_refresh_smoke(hub, target)
        if rc:
            return rc
    print(f"[hub-smoke] OK in {time.time() - t0:.1f}s — stats: {hub.stats}")
    return 0


def run_refresh_smoke(hub, target: str) -> int:
    """The continual-learning leg of the smoke: background auto-refresh has
    run (or been skipped as 'keep' — both are valid on an undrifted store),
    and a forced refresh must version the serving model under the guard."""
    hub.join_refreshes()
    lc = hub.lifecycle
    print(f"[hub-smoke] post-serve refresh stats: "
          f"refreshes={hub.stats.refreshes} "
          f"rejects={hub.stats.refresh_rejects}")
    # the device measured most recently has fresh records: force one
    # refresh so both the cold (initial) and warm (anchored) paths are
    # exercised regardless of cache warmth
    dev = target if hub.store.count(target) > 0 else "tpu_v5e"
    before = hub.store.latest_model_version(dev)
    res = lc.refresh(dev, trigger="smoke", force=True)
    print(f"[hub-smoke] forced refresh({dev}): accepted={res.accepted} "
          f"reason={res.reason!r} version={res.version} "
          f"acc {res.holdout_accuracy_old:.3f}->"
          f"{res.holdout_accuracy_new:.3f}")
    if res.accepted:
        assert res.version is not None and res.version != before, (
            "accepted refresh must create a new lineage version")
        assert hub.store.latest_model_version(dev) == res.version
        lineage = hub.store.model_lineage(dev)
        assert lineage and lineage[-1]["trigger"] in ("smoke", "initial")
        assert hub.store.load_model_params(
            dev, model_name=hub.cost_model_name,
            torch_device=hub.torch_device) is not None, (
            "newest version must be loadable for serving")
    else:
        assert "regress" in res.reason or "refreshing" in res.reason, (
            f"forced refresh refused for an unexpected reason: {res.reason}")
    # the guard invariant: an accepted refresh never regresses held-out
    # rank accuracy beyond the configured tolerance
    if (res.accepted and not math.isnan(res.holdout_accuracy_new)
            and not math.isnan(res.holdout_accuracy_old)):
        assert (res.holdout_accuracy_new
                >= res.holdout_accuracy_old - lc.cfg.guard_eps), (
            "guard violated: accepted refresh regressed rank accuracy")
    status = lc.status(dev)
    assert status in ("fresh", "stale"), f"unexpected lifecycle {status=}"
    print(f"[hub-smoke] lifecycle({dev}) status={status} "
          f"lineage={[e['version'] for e in hub.store.model_lineage(dev)]}")
    return 0


def run_serve_smoke(root: str, readers: int = 2,
                    torch_device: "TorchDevice" = "cuda") -> int:
    """The hub-serving CI leg: boot the multi-process front end over a tiny
    store and prove the serving invariants end to end — tune-on-miss funnels
    to the one writer hub (its cost model on `torch_device`), repeat queries
    are reader cache hits, and every reader serves the same winner."""
    from repro_torch.hub import HubClient, HubServer, TuningHub, bootstrap_store

    t0 = time.time()
    hub = TuningHub(root, moses_cfg=_smoke_cfg(), trials_per_task=16,
                    pretrain_epochs=4, torch_device=torch_device)
    boot = bootstrap_store(hub.store, ("tpu_v5e", "tpu_edge"),
                           _smoke_tasks(), programs_per_task=16)
    print(f"[serve-smoke] store at {hub.store.root}: {boot} new bootstrap "
          f"records; devices={hub.store.devices()}")

    target = "tpu_v5e_pro"
    wl = _smoke_tasks()[0]
    with HubServer(root, hub=hub, readers=readers) as srv:
        print(f"[serve-smoke] {readers} reader(s) up: {srv.endpoints()}; "
              f"writer port {srv.writer_port}")
        with HubClient(root=root) as c:
            assert c.ping(), "reader did not answer ping"
            r1 = c.get_config(target, wl)
            print(f"[serve-smoke] first  get_config({target}, {wl.key()}): "
                  f"source={r1.source} rid={r1.rid} "
                  f"{r1.latency_s * 1e3:.1f}ms")
            assert r1.source in ("tuned", "registry", "cache"), (
                f"first query served from {r1.source!r}; the miss funnel "
                "should have tuned it (or a warm root should hit)")
            r2 = c.get_config(target, wl)
            print(f"[serve-smoke] second get_config: source={r2.source} "
                  f"rid={r2.rid} {r2.latency_s * 1e3:.1f}ms")
            assert r2.source == "cache" and r2.cache_hit, (
                f"repeat query on the same reader must be a cache hit, "
                f"got {r2.source!r}")
            assert r2.config.knobs == r1.config.knobs, (
                "cache hit served different knobs than the tuned winner")
            if r1.source == "tuned":
                # the RPC introspection path: a freshly tuned winner must
                # be explainable over the writer socket
                exp = c.explain(target, wl.key())
                assert exp.get("provenance", {}).get("calibration"), (
                    "explain op returned no calibration evidence for a "
                    "winner tuned this run")
                print(f"[serve-smoke] explain({target}, {wl.key()}): "
                      f"{len(exp['provenance'].get('sources', []))} "
                      f"source(s), calibration present")
        # a client on ANOTHER reader: fresh LRU, must still see the same
        # winner via the shared registry file
        with HubClient(root=root, offset=1) as c2:
            r3 = c2.get_config(target, wl)
            print(f"[serve-smoke] other-reader get_config: "
                  f"source={r3.source} rid={r3.rid}")
            assert r3.config.knobs == r1.config.knobs, (
                "second reader served a different winner")
            if readers > 1 and r3.rid != r1.rid:
                assert r3.source in ("registry", "cache"), (
                    f"warm registry should hit, got {r3.source!r}")
        agg = srv.stats()
        served = sum(r.get("served", 0) for r in agg["readers"])
        print(f"[serve-smoke] writer stats: {agg['writer']}; "
              f"readers served {served} request(s); "
              f"respawns={agg['respawns']}")
        assert served >= 3, f"readers report only {served} served requests"
    print(f"[serve-smoke] OK in {time.time() - t0:.1f}s")
    return 0


def _default_pairs(root: str) -> list:
    """Every known device of the store x the smoke tasks, on the wire."""
    from repro_torch.hub.serving import protocol
    from repro_torch.hub.store import RecordStore
    devices = RecordStore(os.path.join(root, "store")).devices() \
        or ["tpu_v5e"]
    return [[dev, protocol.workload_to_wire(wl)]
            for dev in devices for wl in _smoke_tasks()]


def _serve_client_main(root: str, cid: int, seconds: float, out_q,
                       pairs=None, expect=None) -> None:
    """Load-generator process for `--serve --clients N` (spawn target; loads
    no torch): hammer the read path (tune=False) over `pairs` — [device,
    workload wire] items, by default every known device x smoke task — for
    `seconds`, and report the requests completed, the errors, and the
    replies whose knobs differ from `expect` ("device|key" -> knobs)."""
    import sys

    from repro_torch.hub.serving import protocol
    from repro_torch.hub.serving.client import HubClient
    work = [(dev, protocol.workload_from_wire(w))
            for dev, w in (pairs or _default_pairs(root))]
    n = errors = wrong = 0
    deadline = time.time() + seconds
    with HubClient(root=root, offset=cid) as c:
        while time.time() < deadline:
            for dev, wl in work:
                try:
                    r = c.get_config(dev, wl, tune=False)
                    n += 1
                except (ConnectionError, RuntimeError):
                    errors += 1
                    continue
                want = (expect or {}).get(f"{dev}|{wl.key()}")
                if want is not None and dict(r.config.knobs) != want:
                    wrong += 1
    out_q.put({"cid": cid, "requests": n, "errors": errors, "wrong": wrong,
               "seconds": seconds, "torch_loaded": "torch" in sys.modules})


def _tune_client_main(root: str, cid: int, pairs, out_q) -> None:
    """A client process (spawn target; loads no torch) that asks for every
    [device, workload wire] of `pairs` at once, one thread and connection
    each, with tune=True, and reports every answer: knobs, source, the
    reader that answered and the seconds it waited."""
    import sys
    import threading

    from repro_torch.hub.serving import protocol
    from repro_torch.hub.serving.client import HubClient
    answers, errors = [], []

    def ask(i, dev, wire):
        wl = protocol.workload_from_wire(wire)
        try:
            with HubClient(root=root, offset=cid + i) as c:
                r = c.get_config(dev, wl, tune=True)
        except (ConnectionError, RuntimeError) as e:
            errors.append(f"{dev}|{wl.key()}: {e!r}")
            return
        answers.append({"device": dev, "key": wl.key(), "name": wl.name,
                        "knobs": dict(r.config.knobs), "source": r.source,
                        "rid": r.rid, "latency_s": r.latency_s})

    threads = [threading.Thread(target=ask, args=(i, dev, wire))
               for i, (dev, wire) in enumerate(pairs)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out_q.put({"cid": cid, "answers": answers, "errors": errors,
               "seconds": time.perf_counter() - t0,
               "torch_loaded": "torch" in sys.modules})


def run_serve(root: str, readers: int = 2, clients: int = 0,
              seconds: float = 10.0,
              torch_device: "TorchDevice" = "cuda") -> int:
    """Run the serving front end (the writer hub's cost model on
    `torch_device`): forever (Ctrl-C to stop) when `clients == 0`, else for
    `seconds` while `clients` spawned load generators hammer it, reporting
    aggregate QPS."""
    import multiprocessing as mp

    from repro_torch.hub import HubServer
    from repro_torch.hub.serving.server import endpoints_path

    with HubServer(root, readers=readers, torch_device=torch_device) as srv:
        print(f"[serve] {readers} reader(s) up: {srv.endpoints()}")
        print(f"[serve] endpoints file: {endpoints_path(root)}")
        if clients <= 0:
            print("[serve] serving until interrupted (Ctrl-C)")
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                print("[serve] interrupted; shutting down")
                return 0
        ctx = mp.get_context("spawn")
        out_q = ctx.Queue()
        procs = [ctx.Process(target=_serve_client_main,
                             args=(root, cid, seconds, out_q), daemon=True)
                 for cid in range(clients)]
        t0 = time.time()
        for p in procs:
            p.start()
        total = errors = 0
        for _ in procs:
            rep = out_q.get(timeout=seconds + 120)
            total += rep["requests"]
            errors += rep["errors"]
            print(f"[serve] client {rep['cid']}: {rep['requests']} "
                  f"request(s), {rep['errors']} error(s)")
        for p in procs:
            p.join(10.0)
        elapsed = time.time() - t0
        agg = srv.stats()
        for r in agg["readers"]:
            hit, miss = r.get("hit", {}), r.get("miss", {})
            print(f"[serve] reader {r.get('rid')}: served={r.get('served')} "
                  f"hit p50={hit.get('p50_ms', float('nan')):.2f}ms "
                  f"p99={hit.get('p99_ms', float('nan')):.2f}ms "
                  f"miss p50={miss.get('p50_ms', float('nan')):.2f}ms "
                  f"p99={miss.get('p99_ms', float('nan')):.2f}ms")
        print(f"[serve] {clients} client(s) x {seconds:.0f}s: {total} "
              f"request(s), {errors} error(s), "
              f"{total / max(elapsed, 1e-9):.0f} QPS")
        return 1 if errors else 0


def print_stats(root: str, hub=None, drift: bool = True,
                metrics: bool = False,
                torch_device: "TorchDevice" = "cuda") -> int:
    """Store statistics + the serving queue + per-device drift columns.

    `hub` defaults to a fresh `TuningHub` over `root` on `torch_device` — a
    new process has an empty in-memory queue, but long-lived callers (tests,
    embedding servers) pass their live hub to see real depths. `drift=True`
    adds the continual-learning columns: fingerprint shift vs the persisted
    vector, rank accuracy of the serving model on the newest records,
    lineage version, and lifecycle status (each fingerprint shift re-runs
    the 16-probe suite — cheap, but not free on real hardware)."""
    from repro_torch.hub import TuningHub
    if hub is None:
        hub = TuningHub(root, torch_device=torch_device)
    store = hub.store
    devs = store.devices()
    print(f"store {store.root}: {len(devs)} device(s)")
    if drift:
        print(f"  {'device':14s} {'records':>7s} {'tasks':>5s} "
              f"{'fp-shift':>8s} {'rank-acc':>8s} {'ver':>4s} status")
    for d in devs:
        if not drift:
            print(f"  {d:14s} {store.count(d):6d} records, "
                  f"{len(store.task_keys(d)):4d} tasks")
            continue
        row = hub.lifecycle.drift_summary(d)
        acc = row["rank_accuracy"]
        acc_s = "-" if math.isnan(acc) else f"{acc:.3f}"
        ver = "-" if row["version"] is None else str(row["version"])
        print(f"  {d:14s} {store.count(d):7d} {len(store.task_keys(d)):5d} "
              f"{row['fingerprint_shift']:8.4f} {acc_s:>8s} {ver:>4s} "
              f"{row['status']}")
    fps = store.fingerprints()
    if fps:
        print(f"fingerprints: {sorted(fps)}")
    per_dev = hub.pending_by_device()
    print(f"queue: depth={hub.pending()} inflight={hub.inflight()} "
          f"scheduler={hub.scheduler} refresh={hub.refresh}")
    for d, n in per_dev.items():
        print(f"  {d:14s} {n:6d} pending")
    _print_serving_stats(root, hub)
    if metrics:
        print("hub metrics exposition:")
        text = hub.metrics.to_text()
        print("\n".join("  " + line for line in text.splitlines())
              if text else "  (empty)")
    return 0


def _fmt_ms(v) -> str:
    return "-" if v is None or math.isnan(v) else f"{v:.2f}"


def _print_serving_stats(root: str, hub) -> None:
    """The serving columns of `--stats`: this hub's cache hit-rate and
    hit/miss latency percentiles, plus — when a live server has published
    `endpoints.json` under `root` — the same columns per reader process,
    queried over the serving RPC."""
    cc = hub.config_cache.counters()
    rate = cc["hit_rate"]
    print(f"serving cache: size={cc['size']} hits={cc['hits']} "
          f"misses={cc['misses']} "
          f"hit-rate={'-' if math.isnan(rate) else format(rate, '.3f')} "
          f"(cache-hits served: {hub.stats.cache_hits})")
    hs, ms = hub.hit_latency.summary(), hub.miss_latency.summary()
    print(f"  {'path':8s} {'n':>6s} {'p50-ms':>8s} {'p99-ms':>8s}")
    print(f"  {'hit':8s} {hs['n']:6d} {_fmt_ms(hs['p50_ms']):>8s} "
          f"{_fmt_ms(hs['p99_ms']):>8s}")
    print(f"  {'miss':8s} {ms['n']:6d} {_fmt_ms(ms['p50_ms']):>8s} "
          f"{_fmt_ms(ms['p99_ms']):>8s}")
    from repro_torch.hub.serving.server import endpoints_path
    if not os.path.exists(endpoints_path(root)):
        return
    try:
        from repro_torch.launch.obs import _writer_call
        health = _writer_call(root, "health", timeout_s=2.0)
    except (OSError, ValueError, ConnectionError):
        health = None
    if health and health.get("ok"):
        by_reader = health.get("respawns_by_reader") or {}
        detail = (" (" + ", ".join(f"rid {k}: {v}"
                                   for k, v in sorted(by_reader.items()))
                  + ")") if by_reader else ""
        print(f"farm health: {health.get('alive')}/{health.get('total')} "
              f"alive, respawns={health.get('respawns', 0)}{detail}, "
              f"monitor={'on' if health.get('monitor') else 'off'}, "
              f"slo-firing={health.get('slo_firing') or 'none'}")
    from repro_torch.hub import HubClient
    try:
        with HubClient(root=root) as c:
            eps = list(c._endpoints)
    except (OSError, ValueError):
        return
    print(f"live readers ({len(eps)} endpoint(s)):")
    print(f"  {'rid':>4s} {'served':>7s} {'hit-rate':>8s} "
          f"{'hit-p50':>8s} {'hit-p99':>8s} {'miss-p50':>9s} "
          f"{'miss-p99':>9s}")
    for ep in eps:
        try:
            with HubClient(root=root, endpoints=[ep], offset=0) as c:
                st = c.stats()
        except (ConnectionError, OSError):
            print(f"  {ep.get('rid', '?'):>4} unreachable")
            continue
        cache, hit, miss = st["cache"], st["hit"], st["miss"]
        r = cache["hit_rate"]
        print(f"  {st['rid']:4d} {st['served']:7d} "
              f"{'-' if math.isnan(r) else format(r, '.3f'):>8s} "
              f"{_fmt_ms(hit['p50_ms']):>8s} {_fmt_ms(hit['p99_ms']):>8s} "
              f"{_fmt_ms(miss['p50_ms']):>9s} "
              f"{_fmt_ms(miss['p99_ms']):>9s}")


def print_lineage(root: str, device=None) -> int:
    """Model lineage per device: version chain, triggers, watermarks."""
    from repro_torch.hub import RecordStore
    store = RecordStore(os.path.join(root, "store"))
    devices = [device] if device else store.devices()
    shown = 0
    for dev in devices:
        entries = store.model_lineage(dev)
        if not entries:
            continue
        shown += 1
        print(f"{dev}: {len(entries)} version(s), serving="
              f"{store.latest_model_version(dev)}")
        print(f"  {'ver':>4s} {'parent':>6s} {'status':8s} {'model':12s} "
              f"{'records':>7s} {'rank-acc':>8s} {'dist':>9s} trigger")
        for e in entries:
            acc = e.get("rank_accuracy")
            dist = e.get("param_distance")
            print(f"  {e['version']:4d} "
                  f"{'-' if e.get('parent') is None else e['parent']:>6} "
                  f"{e.get('status', '?'):8s} {str(e.get('model')):12s} "
                  f"{'-' if e.get('records_seen') is None else e['records_seen']:>7} "
                  f"{'-' if acc is None else format(acc, '.3f'):>8} "
                  f"{'-' if dist is None else format(dist, '.2e'):>9} "
                  f"{e.get('trigger', '')}")
    if not shown:
        print("no model lineage recorded"
              + (f" for {device}" if device else ""))
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default="artifacts/hub",
                    help="hub root (store + registry + params)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny-budget end-to-end serving check (CI leg)")
    ap.add_argument("--serve", action="store_true",
                    help="run the multi-process serving front end (with "
                         "--smoke: the hub-serving CI leg)")
    ap.add_argument("--readers", type=int, default=2,
                    help="reader processes for --serve (default 2)")
    ap.add_argument("--clients", type=int, default=0,
                    help="with --serve: spawn N load-generator client "
                         "processes, report QPS, and exit")
    ap.add_argument("--serve-seconds", type=float, default=10.0,
                    help="with --serve --clients: hammer duration")
    ap.add_argument("--stats", action="store_true",
                    help="print record-store statistics (+ drift columns) "
                         "and exit")
    ap.add_argument("--metrics", action="store_true",
                    help="with --stats: also print the hub's metrics "
                         "registry in text exposition format")
    ap.add_argument("--lineage", action="store_true",
                    help="print model lineage (all devices, or --device)")
    ap.add_argument("--compact", action="store_true",
                    help="rewrite store shards dropping duplicate "
                         "(task, knobs, trial) rows, then exit")
    ap.add_argument("--refresh", action="store_true",
                    help="enable continual-learning auto-refresh of saved "
                         "cost models after tuning jobs (with --smoke: run "
                         "the refresh smoke leg)")
    ap.add_argument("--device", default=None,
                    help="serve/tune configs for this device")
    ap.add_argument("--dnn", default=None,
                    help="tune a paper DNN task suite (e.g. squeezenet)")
    ap.add_argument("--arch", default=None,
                    help="tune an LM architecture's task suite")
    ap.add_argument("--trials", type=int, default=48)
    ap.add_argument("--strategy", default="moses")
    ap.add_argument("--bootstrap", default=None,
                    help="comma-separated devices to seed the store with "
                         "before serving (skips devices that have records)")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the cost model runs: cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    if args.smoke and args.serve:
        return run_serve_smoke(args.root, readers=args.readers,
                               torch_device=args.torch_device)
    if args.smoke:
        return run_smoke(args.root, refresh=args.refresh,
                         torch_device=args.torch_device)
    if args.serve:
        return run_serve(args.root, readers=args.readers,
                         clients=args.clients, seconds=args.serve_seconds,
                         torch_device=args.torch_device)
    if args.stats:
        return print_stats(args.root, metrics=args.metrics,
                           torch_device=args.torch_device)
    if args.lineage:
        return print_lineage(args.root, args.device)
    if args.compact:
        from repro_torch.hub import RecordStore
        store = RecordStore(os.path.join(args.root, "store"))
        dropped = store.compact()
        print(f"[hub] compacted {store.root}: {dropped} duplicate/torn "
              f"row(s) dropped")
        return 0
    if not args.device:
        print("nothing to do: pass --smoke, --stats, --lineage, --compact, "
              "or --device (see --help)", file=sys.stderr)
        return 2

    from repro_torch.autotune.tasks import arch_tasks, paper_dnn_tasks
    from repro_torch.hub import TuningHub, bootstrap_store
    if args.dnn:
        tasks = paper_dnn_tasks(args.dnn)
    elif args.arch:
        from repro_torch.configs import get_config
        tasks = arch_tasks(get_config(args.arch))
    else:
        print("--device needs a task suite: --dnn or --arch",
              file=sys.stderr)
        return 2

    hub = TuningHub(args.root, trials_per_task=args.trials,
                    strategy=args.strategy,
                    refresh="auto" if args.refresh else "off",
                    torch_device=args.torch_device)
    if args.bootstrap:
        n = bootstrap_store(hub.store, args.bootstrap.split(","), tasks)
        log.info("bootstrapped store", records=n)
    queued = sum(hub.request(args.device, wl) for wl in tasks)
    log.info("tasks queued", device=args.device, queued=queued,
             already_served=len(tasks) - queued)
    results = hub.flush(args.device)
    sel = hub.selection(args.device)
    if sel is not None:
        log.info("transfer sources",
                 device=args.device,
                 sources=[(d, round(w, 3)) for d, w in sel.sources],
                 ranked=[(d, round(s, 3)) for d, s in sel.ranked])
    for r in results:
        log.info("tuning job done", tasks=len(r.tasks),
                 measurements=r.total_measurements,
                 simulated_search_s=round(r.total_search_seconds, 1))
    hub.join_refreshes()
    if args.refresh:
        log.info("continual refresh summary",
                 accepted=hub.stats.refreshes,
                 rejected=hub.stats.refresh_rejects)
    print(f"[hub] registry -> {hub.registry.path}; stats: {hub.stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
