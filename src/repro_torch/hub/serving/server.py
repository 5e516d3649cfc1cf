"""Multi-process hub serving front end: N readers, one writer, one corpus
(port of `repro.hub.serving.server`).

Process layout (the farm's begin-ack/heartbeat idiom from `sched/farm.py`,
applied to serving):

  parent (HubServer)                      reader process x N (spawn)
    writer hub: the ONE TuningHub           bind 127.0.0.1:0 -> ("ready",
      that tunes + writes registry/store      rid, port) ack up the pipe
    writer socket: accepts tune-on-miss     heartbeat thread pulses the pipe
      funnel connections from readers       accept loop, thread per client:
    manager thread: drains heartbeats,        LRU cache -> registry
      missed-beat or dead reader ->           (mtime-checked) -> tune funnel
      HARD KILL + respawn + endpoints         to the writer | store
      rewrite                                 best-record fallback
    endpoints.json: atomic discovery
      file clients poll for failover

Readers never write: they open the record store and the tuned-config
registry read-only, so a reader crash (or kill -9) cannot tear a shard or
the registry — that is the writer hub's job alone, and it already writes
atomically. A miss that needs measurements is FORWARDED to the writer over
the same framed RPC, so concurrent clients asking for the same un-tuned
workload collapse into one batched tuning job (the hub's in-flight dedup)
and every client sees the same winner.

Cross-process cache invalidation needs no extra channel: each reader's LRU
only answers keys it has seen; every miss re-checks the registry file's
mtime (`Registry.maybe_reload`), and when the writer has landed new winners
the reload drops the reader's entire LRU — registry writes invalidate
reader caches exactly as in-process writes invalidate the hub's own cache.

Only the parent holds torch: its writer hub runs the cost model, its
pre-training and refreshes on `torch_device` (the card by default). Reader
processes load no torch — `_reader_main` and everything it imports (the
store, the registry, the config space, the cache, the protocol and
`repro_torch.obs`) stay torch-free at module scope, the contract the
`sched` farm's workers keep. `endpoints.json` has the reference's format,
so `launch.obs` and the clients of either package find either farm.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.autotune.registry import Registry
from repro_torch.autotune.space import default_config
from repro_torch.hub.serving import protocol
from repro_torch.hub.serving.cache import LatencyWindow, TunedConfigCache
from repro_torch.hub.store import RecordStore
from repro_torch.obs import get_logger
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import remote_event

ENDPOINTS_NAME = "endpoints.json"

log = get_logger("serve")


def endpoints_path(root: str) -> str:
    return os.path.join(root, "serving", ENDPOINTS_NAME)


def _write_endpoints(root: str, writer_port: int,
                     readers: List[Dict[str, int]]) -> str:
    """Atomically publish the current topology for client discovery."""
    path = endpoints_path(root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"host": "127.0.0.1", "writer_port": writer_port,
                   "readers": readers}, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


# --- reader process -------------------------------------------------------

class _ReaderState:
    """Everything one reader process serves from. Read-only against the
    shared corpus; all mutable state (LRU, latency windows, counters) is
    process-local."""

    def __init__(self, rid: int, store_root: str, registry_path: str,
                 writer_port: Optional[int], cache_size: int):
        self.rid = rid
        self.store = RecordStore(store_root)
        self.registry = Registry(path=registry_path)
        self.writer_port = writer_port
        self.cache = TunedConfigCache(cache_size)
        # per-reader registry: the RPC `stats` op and the latency summary
        # columns read the same histogram samples
        self.metrics = MetricsRegistry()
        self.hit_latency = LatencyWindow(histogram=self.metrics.histogram(
            "serve.latency_seconds", path="hit"))
        self.miss_latency = LatencyWindow(histogram=self.metrics.histogram(
            "serve.latency_seconds", path="miss"))
        self._requests = self.metrics.counter("serve.requests")
        self._errors = self.metrics.counter("serve.errors")
        self._cache_hits = self.metrics.counter("serve.cache_lookups",
                                                result="hit")
        self._cache_misses = self.metrics.counter("serve.cache_lookups",
                                                  result="miss")
        self.served = 0
        self.tunes_forwarded = 0
        self._lock = threading.Lock()       # counters only

    def _forward_tune(self, req: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Funnel a miss that wants measurements to the single writer hub.
        None when there is no writer (read-only serving) or it refused."""
        if self.writer_port is None:
            return None
        try:
            with socket.create_connection(("127.0.0.1", self.writer_port),
                                          timeout=600.0) as s:
                protocol.send_frame(s, {"op": "tune",
                                        "device": req["device"],
                                        "workload": req["workload"]})
                reply = protocol.recv_frame(s)
        except (OSError, protocol.ProtocolError):
            return None
        if not reply or not reply.get("ok"):
            return None
        with self._lock:
            self.tunes_forwarded += 1
        return reply

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Serve one request; when it carries a `trace` context (a client
        running under a campaign tracer), return a `serve.handle` span
        event with the reply for the client to merge into its timeline."""
        ctx = req.get("trace")
        if ctx is None:
            return self._handle(req)
        t0_wall, t0 = time.time(), time.perf_counter()
        reply = self._handle(req)
        reply["span_events"] = [remote_event(
            "serve.handle", (ctx[0], ctx[1]), t0_wall,
            time.perf_counter() - t0,
            status="ok" if reply.get("ok") else "error",
            rid=self.rid, op=req.get("op"), source=reply.get("source"))]
        return reply

    def _handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "op": "pong", "rid": self.rid}
        if op == "stats":
            return {"ok": True, "rid": self.rid, "served": self.served,
                    "tunes_forwarded": self.tunes_forwarded,
                    "cache": self.cache.counters(),
                    "hit": self.hit_latency.summary(),
                    "miss": self.miss_latency.summary(),
                    "metrics": self.metrics.to_json(),
                    # the reader contract: no torch in this process
                    "torch_loaded": "torch" in sys.modules}
        if op == "metrics":
            # the scrape op: the raw mergeable snapshot, so the parent
            # folds every reader into ONE exposition (exact histograms).
            # The handling cost (CPU, not wall — the connection may queue
            # behind client traffic, which is serving time, not scraping
            # time) is observed AFTER the snapshot, so it rides the NEXT
            # scrape; the bench's overhead gate sums these totals.
            c0 = time.thread_time()
            snap = self.metrics.snapshot()
            self.metrics.histogram("serve.scrape_seconds",
                                   side="reader").observe(
                time.thread_time() - c0)
            return {"ok": True, "rid": self.rid, "snapshot": snap}
        if op != "get_config":
            self._errors.inc()
            return {"ok": False, "error": f"unknown op {op!r}"}

        t0 = time.perf_counter()
        device = req["device"]
        wl = protocol.workload_from_wire(req["workload"])
        key = wl.key()
        self._requests.inc()
        with self._lock:
            self.served += 1

        cached = self.cache.get(device, key)
        if cached is not None:
            cfg, thr = cached
            self._cache_hits.inc()
            self.hit_latency.record(time.perf_counter() - t0)
            return {"ok": True, "rid": self.rid, "cache_hit": True,
                    "source": "cache", "knobs": protocol.config_to_wire(cfg),
                    "throughput_gflops": thr}

        self._cache_misses.inc()
        # a registry file that moved on disk means the writer landed new
        # winners: reload AND drop the local LRU (the cross-process
        # equivalent of the hub's registry-write invalidation hook)
        if self.registry.maybe_reload():
            self.cache.clear()
        entry = self.registry.lookup(device, wl)
        if entry is not None:
            cfg = self.registry.get(device, wl)
            thr = entry.get("throughput_gflops")
            self.cache.put(device, key, cfg, thr)
            self.hit_latency.record(time.perf_counter() - t0)
            return {"ok": True, "rid": self.rid, "cache_hit": False,
                    "source": "registry",
                    "knobs": protocol.config_to_wire(cfg),
                    "throughput_gflops": thr}

        if req.get("tune", True):
            reply = self._forward_tune(req)
            if reply is not None:
                # the winner IS the registry entry now; safe to cache
                cfg = protocol.config_from_wire(reply["knobs"])
                thr = reply.get("throughput_gflops")
                self.cache.put(device, key, cfg, thr)
                self.miss_latency.record(time.perf_counter() - t0)
                return {"ok": True, "rid": self.rid, "cache_hit": False,
                        "source": "tuned",
                        "knobs": protocol.config_to_wire(cfg),
                        "throughput_gflops": thr}

        # no writer (or tune declined): serve the best measured record from
        # the indexed store, falling back to the vendor default. NOT cached:
        # it is not a registry winner, and staying uncached keeps every such
        # request re-checking the registry mtime until a real winner lands.
        best = self.store.best_record(device, key)
        if best is not None:
            cfg = protocol.config_from_wire(best["knobs"])
            self.miss_latency.record(time.perf_counter() - t0)
            return {"ok": True, "rid": self.rid, "cache_hit": False,
                    "source": "store",
                    "knobs": protocol.config_to_wire(cfg),
                    "throughput_gflops": best.get("throughput_gflops")}
        self.miss_latency.record(time.perf_counter() - t0)
        return {"ok": True, "rid": self.rid, "cache_hit": False,
                "source": "default",
                "knobs": protocol.config_to_wire(default_config(wl)),
                "throughput_gflops": None}


def _serve_conn(state: _ReaderState, client: socket.socket) -> None:
    """One client connection: framed request -> framed reply, until the
    client hangs up. A torn frame closes the connection (the client
    retries elsewhere); it never kills the reader."""
    with client:
        while True:
            try:
                req = protocol.recv_frame(client)
            except protocol.ProtocolError:
                return
            if req is None:
                return
            try:
                reply = state.handle(req)
            except Exception as e:  # noqa: BLE001 — a bad request must not
                reply = {"ok": False,           # take the reader down
                         "error": f"{type(e).__name__}: {e}"}
                state.metrics.counter("serve.errors").inc()
            try:
                protocol.send_frame(client, reply)
            except OSError:
                return


def _reader_main(rid: int, store_root: str, registry_path: str,
                 writer_port: Optional[int], conn,
                 heartbeat_s: float) -> None:
    """Reader process entry (spawn target). Begin-ack + heartbeat exactly
    like a farm worker: bind first, ack ("ready", rid, port) up the pipe,
    then pulse liveness from a daemon thread while the accept loop runs."""
    state = _ReaderState(rid, store_root, registry_path, writer_port,
                         cache_size=4096)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(64)
    srv.settimeout(0.2)
    port = srv.getsockname()[1]

    stop = threading.Event()
    send_lock = threading.Lock()
    conn.send(("ready", rid, port))

    def _pulse():
        while not stop.wait(heartbeat_s):
            try:
                with send_lock:
                    conn.send(("hb", rid, state.served))
            except (OSError, BrokenPipeError):
                stop.set()              # parent died: orphan shuts down

    def _sentinel():
        try:
            conn.recv()                 # anything from the parent = shutdown
        except (EOFError, OSError):
            pass
        stop.set()

    threading.Thread(target=_pulse, name="serve-heartbeat",
                     daemon=True).start()
    threading.Thread(target=_sentinel, name="serve-sentinel",
                     daemon=True).start()

    with srv:
        while not stop.is_set():
            try:
                client, _addr = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=_serve_conn, args=(state, client),
                             daemon=True).start()


# --- parent: the writer + the farm of readers -----------------------------

@dataclasses.dataclass
class _Reader:
    rid: int
    proc: Any
    conn: Any
    port: int
    last_beat: float


class HubServer:
    """Spawn-based serving front end over one TuningHub.

    The parent owns the ONLY hub that tunes and writes; `readers` spawn
    processes serve the read path and funnel misses back here. Liveness is
    the farm contract: begin-ack on boot, heartbeats after, and the manager
    thread hard-kills + respawns a reader that stops pulsing — clients
    re-discover the replacement through `endpoints.json`.
    """

    def __init__(self, root: str, hub=None, readers: int = 2,
                 tune_on_miss: bool = True,
                 heartbeat_s: float = 0.2, hb_grace_s: float = 5.0,
                 boot_timeout_s: float = 60.0,
                 monitor: bool = True, monitor_interval_s: float = 1.0,
                 slos=None, torch_device="cuda"):
        self.root = root
        if hub is None:
            # the writer hub's cost model runs on `torch_device`: without a
            # card this raises unless "cpu" was asked for
            from repro_torch.hub.service import TuningHub
            hub = TuningHub(root, torch_device=torch_device)
        self.hub = hub
        self.n_readers = int(readers)
        if self.n_readers < 1:
            raise ValueError(f"readers must be >= 1, got {readers}")
        self.tune_on_miss = tune_on_miss
        self.heartbeat_s = heartbeat_s
        self.hb_grace_s = hb_grace_s
        self.boot_timeout_s = boot_timeout_s
        self.respawns = 0
        self._respawns_by_reader: Dict[str, int] = {}
        # parent-side registry: respawn counters, liveness gauges, scrape
        # cost. Shares the hub's registry when it has one (so hub.* and
        # serve.* land in one exposition); a bare serve-only shim gets a
        # private one.
        self.metrics = getattr(hub, "metrics", None)
        if not isinstance(self.metrics, MetricsRegistry):
            self.metrics = MetricsRegistry()
        self.monitor = bool(monitor)
        self.monitor_interval_s = float(monitor_interval_s)
        self._slos = slos
        self.sampler = None                 # TimeSeriesSampler when started
        self.slo = None                     # SLOEvaluator when started
        self._t0_wall = time.time()
        self._ctx = mp.get_context("spawn")
        self._readers: List[_Reader] = []
        self._next_rid = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._writer_srv: Optional[socket.socket] = None
        self.writer_port: Optional[int] = None
        self._threads: List[threading.Thread] = []
        self._started = False

    # --- writer side ------------------------------------------------------
    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _addr = self._writer_srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._writer_conn, args=(client,),
                             daemon=True).start()

    def _writer_conn(self, client: socket.socket) -> None:
        """One connection on the writer socket. Readers funnel `tune`
        requests here (queue -> batched tune -> registry write; the hub's
        device locks + in-flight dedup collapse concurrent identical
        requests into one job); monitoring clients hit the same socket
        with `metrics` (the merged reader+writer exposition), `health`
        (liveness + respawn payload from the heartbeat watchdog), and
        `explain` (one winner's transfer provenance + registry entry)."""
        with client:
            while True:
                try:
                    req = protocol.recv_frame(client)
                except protocol.ProtocolError:
                    return
                if req is None:
                    return
                try:
                    op = req.get("op")
                    if op == "metrics":
                        reply = self._metrics_reply()
                    elif op == "health":
                        reply = self._health_reply()
                    elif op == "explain":
                        # introspection: the provenance + registry story
                        # behind one served winner. Task is the raw
                        # workload-key string (no Workload on the wire).
                        record = None
                        if hasattr(self.hub, "explain"):
                            record = self.hub.explain(req.get("device", ""),
                                                      req.get("task", ""))
                        if record is None:
                            reply = {"ok": False,
                                     "error": "no provenance for "
                                     f"({req.get('device')!r}, "
                                     f"{req.get('task')!r})"}
                        else:
                            reply = {"ok": True, **record}
                    elif op != "tune":
                        reply = {"ok": False,
                                 "error": f"writer got {op!r}"}
                    else:
                        wl = protocol.workload_from_wire(req["workload"])
                        resp = self.hub.get_config(req["device"], wl)
                        reply = {"ok": True,
                                 "knobs": protocol.config_to_wire(
                                     resp.config),
                                 "throughput_gflops":
                                     resp.throughput_gflops,
                                 "source": resp.source}
                except Exception as e:  # noqa: BLE001 — reader must get an
                    reply = {"ok": False,               # answer, not a hang
                             "error": f"{type(e).__name__}: {e}"}
                try:
                    protocol.send_frame(client, reply)
                except OSError:
                    return

    # --- monitoring: scrape + health -------------------------------------
    def _scrape_snapshot(self) -> Dict[str, Any]:
        """One merged snapshot of everything observable from the parent:
        the process registry (drift gauges et al.), the parent/hub
        registry (hub.* counters, respawns, scrape cost), and every live
        reader's registry fetched over its own RPC `metrics` op. Readers
        stay torch-free; the parent does the merging."""
        from repro_torch.obs import metrics as obs_metrics
        t0 = time.perf_counter()
        c0 = time.thread_time()
        with self._lock:
            readers = [(r.rid, r.port, r.proc.is_alive())
                       for r in self._readers]
        self.metrics.gauge("serve.readers_alive").set(
            sum(1 for _, _, alive in readers if alive))
        self.metrics.gauge("serve.readers_total").set(len(readers))
        reg = MetricsRegistry()
        default = obs_metrics.default_registry()
        reg.merge(default.snapshot())
        if self.metrics is not default:
            reg.merge(self.metrics.snapshot())
        for rid, port, alive in readers:
            if not alive:
                continue
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=2.0) as s:
                    protocol.send_frame(s, {"op": "metrics"})
                    reply = protocol.recv_frame(s)
            except (OSError, protocol.ProtocolError):
                reply = None
            if reply and reply.get("ok"):
                reg.merge(reply["snapshot"])
            else:
                self.metrics.counter("serve.scrape_errors",
                                     reader=str(rid)).inc()
        # the cost of THIS scrape lands in the registry for the next one.
        # `serve.scrape_seconds` is CPU (thread time): what monitoring
        # actually consumes — the bench's overhead gate sums its totals
        # (side=parent here + side=reader shipped in reader snapshots).
        # Wall time (which under load is mostly waiting behind client
        # traffic for a reader to answer) lands separately.
        self.metrics.histogram("serve.scrape_seconds",
                               side="parent").observe(
            time.thread_time() - c0)
        self.metrics.histogram("serve.scrape_wall_seconds").observe(
            time.perf_counter() - t0)
        return reg.snapshot()

    def _metrics_reply(self) -> Dict[str, Any]:
        snap = self._scrape_snapshot()
        reg = MetricsRegistry()
        reg.merge(snap)
        reply: Dict[str, Any] = {"ok": True, "snapshot": snap,
                                 "text": reg.to_text(),
                                 "uptime_s": time.time() - self._t0_wall,
                                 "slo": [], "alerts": [], "rates": {}}
        if self.slo is not None:
            reply["slo"] = [st.to_dict() for st in self.slo.statuses]
            reply["alerts"] = list(self.slo.alerts[-10:])
        if self.sampler is not None:
            qps = self.sampler.rate("serve.requests", 30.0)
            reply["rates"] = {"qps_30s": None if qps != qps else qps,
                              "window_s": 30.0}
        return reply

    def _health_reply(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            rows = [{"rid": r.rid, "port": r.port,
                     "alive": r.proc.is_alive(),
                     "last_beat_age_s": round(now - r.last_beat, 3)}
                    for r in self._readers]
            respawns_by = dict(self._respawns_by_reader)
        return {"ok": True, "uptime_s": time.time() - self._t0_wall,
                "writer_port": self.writer_port,
                "readers": rows,
                "alive": sum(1 for r in rows if r["alive"]),
                "total": len(rows),
                "respawns": self.respawns,
                "respawns_by_reader": respawns_by,
                "monitor": self.sampler is not None,
                "slo_firing": self.slo.firing() if self.slo else []}

    # --- reader farm ------------------------------------------------------
    def _spawn_reader(self) -> _Reader:
        rid = self._next_rid
        self._next_rid += 1
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_reader_main,
            args=(rid, self.hub.store.root, self.hub.registry.path,
                  self.writer_port if self.tune_on_miss else None,
                  child_conn, self.heartbeat_s),
            name=f"hub-reader-{rid}", daemon=True)
        proc.start()
        child_conn.close()
        # begin-ack: the reader binds its port before acking, so a ready
        # reader is an addressable reader
        deadline = time.monotonic() + self.boot_timeout_s
        port = None
        while time.monotonic() < deadline:
            try:
                if parent_conn.poll(0.1):
                    msg = parent_conn.recv()
                    if msg[0] == "ready" and msg[1] == rid:
                        port = msg[2]
                        break
            except (EOFError, OSError):
                break                   # child died before acking
            if not proc.is_alive():
                break
        if port is None:
            proc.kill()
            proc.join(5.0)
            raise RuntimeError(f"reader {rid} failed to boot within "
                               f"{self.boot_timeout_s}s")
        return _Reader(rid=rid, proc=proc, conn=parent_conn, port=port,
                       last_beat=time.monotonic())

    def _publish(self) -> None:
        with self._lock:
            readers = [{"rid": r.rid, "port": r.port} for r in self._readers]
        _write_endpoints(self.root, self.writer_port or 0, readers)

    def _manage(self) -> None:
        """Watchdog: drain heartbeats; a reader that died or stopped
        pulsing for `hb_grace_s` gets hard-killed and replaced, and the
        endpoints file is republished so clients fail over."""
        while not self._stop.wait(self.heartbeat_s):
            now = time.monotonic()
            replaced = False
            with self._lock:
                for i, r in enumerate(list(self._readers)):
                    while r.conn.poll(0):
                        try:
                            r.conn.recv()
                            r.last_beat = now
                        except (EOFError, OSError):
                            break
                    dead = (not r.proc.is_alive()
                            or now - r.last_beat > self.hb_grace_s)
                    if not dead:
                        continue
                    r.proc.kill()
                    r.proc.join(5.0)
                    r.conn.close()
                    log.warning("reader died; respawning", rid=r.rid)
                    self.respawns += 1
                    rid = str(r.rid)
                    self._respawns_by_reader[rid] = \
                        self._respawns_by_reader.get(rid, 0) + 1
                    self.metrics.counter("serve.reader_respawns",
                                         reader=rid).inc()
                    self._readers[i] = self._spawn_reader()
                    replaced = True
            if replaced:
                self._publish()

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "HubServer":
        if self._started:
            return self
        # writer socket first: readers need its port at spawn time
        self._writer_srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._writer_srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._writer_srv.bind(("127.0.0.1", 0))
        self._writer_srv.listen(32)
        self._writer_srv.settimeout(0.2)
        self.writer_port = self._writer_srv.getsockname()[1]
        # flush any buffered records so readers see the full corpus, and
        # persist the registry so they can open it
        self.hub.store.flush()
        self.hub.registry.save()
        with self._lock:
            self._readers = [self._spawn_reader()
                             for _ in range(self.n_readers)]
        self._publish()
        for target, name in ((self._writer_loop, "serve-writer"),
                             (self._manage, "serve-manager")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        if self.monitor:
            from repro_torch.obs.slo import SLOEvaluator, default_serving_slos
            from repro_torch.obs.timeseries import TimeSeriesSampler
            self.sampler = TimeSeriesSampler(
                source=self._scrape_snapshot,
                interval_s=self.monitor_interval_s,
                on_sample=lambda t_, snap: (
                    self.slo.evaluate(now=t_) if self.slo else None))
            self.slo = SLOEvaluator(
                self._slos if self._slos is not None
                else default_serving_slos(),
                self.sampler, logger=log, registry=self.metrics)
            self.sampler.start()
        self._started = True
        return self

    def endpoints(self) -> List[Dict[str, int]]:
        with self._lock:
            return [{"rid": r.rid, "port": r.port} for r in self._readers]

    def stats(self) -> Dict[str, Any]:
        """Aggregate view: the writer hub's stats + every live reader's
        cache/latency counters (queried over the same RPC clients use)."""
        from repro_torch.hub.serving.client import HubClient
        stats = getattr(self.hub, "stats", None)
        cache = getattr(self.hub, "config_cache", None)
        hit = getattr(self.hub, "hit_latency", None)
        miss = getattr(self.hub, "miss_latency", None)
        out: Dict[str, Any] = {
            "writer": (stats.to_dict() if hasattr(stats, "to_dict")
                       else dataclasses.asdict(stats)
                       if dataclasses.is_dataclass(stats) else {}),
            "writer_cache": cache.counters() if cache is not None else {},
            "writer_hit": hit.summary() if hit is not None else {},
            "writer_miss": miss.summary() if miss is not None else {},
            "respawns": self.respawns,
            "readers": [],
        }
        for ep in self.endpoints():
            try:
                with HubClient(endpoints=[ep], root=self.root) as c:
                    out["readers"].append(c.stats())
            except (OSError, protocol.ProtocolError):
                out["readers"].append({"rid": ep["rid"], "ok": False})
        return out

    def shutdown(self) -> None:
        if not self._started:
            return
        if self.sampler is not None:
            self.sampler.stop()
        self._stop.set()
        for t in self._threads:
            t.join(5.0)
        with self._lock:
            readers, self._readers = self._readers, []
        for r in readers:
            try:
                r.conn.send(None)       # sentinel: orderly stop
            except (OSError, BrokenPipeError):
                pass
        for r in readers:
            r.proc.join(2.0)
            if r.proc.is_alive():
                r.proc.kill()
                r.proc.join(5.0)
            r.conn.close()
        if self._writer_srv is not None:
            self._writer_srv.close()
        self._started = False

    def __enter__(self) -> "HubServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
