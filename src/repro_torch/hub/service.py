"""TuningHub: tune-on-miss serving of best configs per (device, workload)
(port of `repro.hub.service`; the cost model, its pre-training and every
continual refresh run on the hub's `torch_device`, the card by default).

The query layer the ROADMAP's "serve heavy traffic" direction needs: callers
ask `get_config(device, workload)` and the hub answers from the tuned-config
`Registry` when it can (a hit costs a dict lookup, zero measurements). On a
miss the workload is queued; `flush()` runs ONE batched `TuneSession` job per
device over everything pending for it, warm-started through
`transfer.select_sources` (fingerprint -> nearest known sources -> mixed
pool + pretrained params). Winners go to the registry, every new measurement
goes back into the record store, and the target's fingerprint + freshly
adapted params are persisted — so the *next* unseen device has one more
neighbor to learn from.

In-flight dedup: a (device, task) that is already pending or being tuned is
never queued twice; concurrent `get_config` calls for it block on the
serving lock and return the registry hit once the first job lands.

Continual learning (`refresh="sync"|"auto"`): after every tuning job lands
new records, the hub's `ModelLifecycle` checks the device for drift and
refreshes (or retires) its serving cost model — replay-mixed, mask-anchored,
guarded against rank-accuracy regression (see `repro.continual`). Serving
always loads the newest non-retired version from the store's lineage.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.autotune.registry import Registry
from repro_torch.autotune.session import TuneSession
from repro_torch.autotune.space import ProgramConfig, Workload
from repro_torch.autotune.strategies import Strategy, resolve_strategy
from repro_torch.configs.moses import DEFAULT as DEFAULT_CFG
from repro_torch.configs.moses import MosesConfig
from repro_torch.core.cost_model import resolve_cost_model
from repro_torch.core.placement import TorchDevice, resolve_torch_device
from repro_torch.hub.fingerprint import device_fingerprint
from repro_torch.hub.provenance import build_provenance, ticket_overlap
from repro_torch.hub.serving.cache import LatencyWindow, TunedConfigCache
from repro_torch.hub.store import RecordStore
from repro_torch.hub.transfer import SourceSelection, select_sources
from repro_torch.obs import get_logger
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.calibration import CalibrationTracker
from repro_torch.obs.metrics import MetricsRegistry

log = get_logger("hub")


class HubStats:
    """Counter view over a hub's `MetricsRegistry` (`hub.<field>` keys).

    Keeps the old dataclass surface — `stats.hits`, `stats.jobs += 1`,
    dataclass-style repr — while the counts themselves live in the
    registry, so `--obs` exposition and the `--stats` columns can never
    disagree. Each hub owns a private registry: two hubs in one process
    never share counters."""

    FIELDS = ("hits",           # registry/cache answers
              "cache_hits",     # hits answered by the LRU (zero I/O; subset)
              "misses",
              "jobs",           # batched TuneSession jobs run
              "dedup_skips",    # requests already pending/in-flight
              "measurements",   # total new on-device measurements
              "poisoned",       # measurements crashed/timed out/quarantined
              "refreshes",      # accepted continual-refresh versions
              "refresh_rejects")   # attempts the guard (or floor) refused

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        object.__setattr__(self, "registry",
                           registry if registry is not None
                           else MetricsRegistry())

    def _counter(self, field: str):
        return self.registry.counter(f"hub.{field}")

    def inc(self, field: str, n: int = 1) -> None:
        self._counter(field).inc(n)

    def __getattr__(self, name: str) -> int:
        if name in self.FIELDS:
            return int(self._counter(name).value)
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name in self.FIELDS:        # stats.jobs += 1 (tests do this)
            c = self._counter(name)
            c.inc(value - c.value)
            return
        object.__setattr__(self, name, value)

    def to_dict(self) -> Dict[str, int]:
        return {f: getattr(self, f) for f in self.FIELDS}

    def __repr__(self) -> str:
        body = ", ".join(f"{f}={getattr(self, f)}" for f in self.FIELDS)
        return f"HubStats({body})"


@dataclasses.dataclass
class HubResponse:
    """What a `get_config` query returns."""
    device: str
    workload: Workload
    config: ProgramConfig
    cache_hit: bool
    throughput_gflops: Optional[float]       # registry's recorded winner
    new_measurements: int                    # 0 on a hit
    sources: List[Tuple[str, float]]         # (source device, weight); [] hit
    source: str = ""                         # "cache"|"registry"|"tuned"|...


class TuningHub:
    """Facade over store + fingerprint + transfer + session + registry.

    Layout under `root`: the record store at `<root>/store`, the served
    registry at `<root>/tuned_configs.json` (override via `registry=` to
    serve into an existing registry, e.g. the kernels' default one). The
    cost model runs on `torch_device` (raises without a card unless "cpu"
    is asked for); every job and refresh draws from its own seeded
    generators, so a background refresh on the shared card stays
    reproducible.
    """

    def __init__(self, root: str,
                 moses_cfg: MosesConfig = DEFAULT_CFG,
                 registry: Optional[Registry] = None,
                 store: Optional[RecordStore] = None,
                 strategy: Union[str, Strategy] = "moses",
                 cost_model: str = "mlp",
                 trials_per_task: Optional[int] = None,
                 top_k_sources: int = 2,
                 pretrain_epochs: int = 6,
                 seed: int = 0,
                 scheduler: str = "serial",
                 speculative: bool = False,
                 executor=None,
                 refresh: str = "off",
                 lifecycle=None,
                 lifecycle_cfg=None,
                 cache_size: int = 512,
                 torch_device: TorchDevice = "cuda"):
        self.root = root
        self.torch_device = resolve_torch_device(torch_device)
        self.moses_cfg = moses_cfg
        self.store = store if store is not None else RecordStore(
            os.path.join(root, "store"))
        self.registry = registry if registry is not None else Registry(
            path=os.path.join(root, "tuned_configs.json"))
        self.strategy = strategy
        self.cost_model_name = cost_model
        self.trials_per_task = trials_per_task
        self.top_k_sources = top_k_sources
        self.pretrain_epochs = pretrain_epochs
        self.seed = seed
        if scheduler not in ("serial", "gradient"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.scheduler = scheduler
        self.speculative = speculative
        # measurement backend for gradient-scheduled jobs: a
        # MeasurementExecutor instance, "thread" | "process", or None
        # (campaign default). The serial path has no executor seam.
        if executor is not None and scheduler != "gradient":
            raise ValueError("executor= requires scheduler='gradient'")
        self.executor = executor
        if refresh not in ("off", "sync", "auto"):
            raise ValueError(f"unknown refresh mode {refresh!r}; expected "
                             "'off', 'sync', or 'auto'")
        self.refresh = refresh
        self._lifecycle = lifecycle
        self._lifecycle_cfg = lifecycle_cfg
        # per-hub telemetry: counters AND latency windows live in one
        # private registry (`hub.metrics`), so `--stats` columns and the
        # `--obs` exposition read the same instruments
        self.metrics = MetricsRegistry()
        self.stats = HubStats(self.metrics)
        # served-winner LRU + latency windows: the fine-grained read path.
        # A hit touches ONLY these (each has its own lock) — never the hub
        # lock, the device job locks, or the store — so reads cannot
        # serialize behind an in-flight tuning job (regression-tested).
        self.config_cache = TunedConfigCache(cache_size)
        self.hit_latency = LatencyWindow(histogram=self.metrics.histogram(
            "hub.latency_seconds", path="hit"))
        self.miss_latency = LatencyWindow(histogram=self.metrics.histogram(
            "hub.latency_seconds", path="miss"))
        self._stats_lock = threading.Lock()     # HubStats counters only
        self._lock = threading.RLock()          # hub state (queues)
        self._dev_locks: Dict[str, threading.Lock] = {}  # one job per device
        self._pending: Dict[str, Dict[str, Workload]] = {}
        self._inflight: Set[Tuple[str, str]] = set()
        self._selections: Dict[str, SourceSelection] = {}
        self._refresh_threads: List[threading.Thread] = []
        # device -> fingerprint probed THIS session (safe to hand the drift
        # detector as "current" — persisted vectors may be stale baselines)
        self._fresh_fps: Dict[str, Any] = {}

    # --- queueing ---------------------------------------------------------
    def request(self, device: str, wl: Workload) -> bool:
        """Queue (device, workload) for the next `flush()` unless it is
        already served, pending, or in flight. Returns True iff queued."""
        with self._lock:
            if self.registry.lookup(device, wl) is not None:
                return False
            key = wl.key()
            if (key in self._pending.get(device, {})
                    or (device, key) in self._inflight):
                with self._stats_lock:
                    self.stats.dedup_skips += 1
                return False
            self._pending.setdefault(device, {})[key] = wl
            return True

    def pending(self, device: Optional[str] = None) -> int:
        with self._lock:
            if device is not None:
                return len(self._pending.get(device, {}))
            return sum(len(v) for v in self._pending.values())

    def pending_by_device(self) -> Dict[str, int]:
        """Queue depth per device (the `launch.hub --stats` surface)."""
        with self._lock:
            return {d: len(v) for d, v in sorted(self._pending.items()) if v}

    def inflight(self) -> int:
        """Number of (device, task) keys currently being tuned."""
        with self._lock:
            return len(self._inflight)

    # --- serving ----------------------------------------------------------
    def get_config(self, device: str, wl: Workload,
                   flush: bool = True) -> HubResponse:
        """Serve the best known config for (device, workload).

        Hit path (LRU cache, then registry): answered immediately, zero
        measurements — and WITHOUT the hub lock. The cache and the stats
        counters each have their own fine-grained lock, so a slow tuning
        job in flight for the same device never serializes pure reads
        behind it (regression-tested). Miss: the workload is queued and
        (with `flush=True`, the default) tuned now in one batched job
        together with everything else pending for the device;
        `flush=False` just queues (prefetch) and serves the vendor default
        until a later flush lands."""
        t0 = time.perf_counter()
        key = wl.key()
        cached = self.config_cache.get(device, key)
        if cached is not None:
            cfg, thr = cached
            with self._stats_lock:
                self.stats.hits += 1
                self.stats.cache_hits += 1
            self.hit_latency.record(time.perf_counter() - t0)
            return HubResponse(device, wl, cfg, True, thr, 0, [],
                               source="cache")
        entry = self.registry.lookup(device, wl)
        if entry is not None:
            cfg = self.registry.get(device, wl)
            thr = entry.get("throughput_gflops")
            self.config_cache.put(device, key, cfg, thr)
            with self._stats_lock:
                self.stats.hits += 1
            self.hit_latency.record(time.perf_counter() - t0)
            return HubResponse(device, wl, cfg, True, thr, 0, [],
                               source="registry")
        with self._stats_lock:
            self.stats.misses += 1
        self.request(device, wl)
        if not flush:
            self.miss_latency.record(time.perf_counter() - t0)
            return HubResponse(device, wl, self.registry.get(device, wl),
                               False, None, 0, [], source="default")
        # tune outside the hub lock: hits for other (device, workload)s keep
        # being served while this job runs. If another thread is already
        # tuning this key (it was in flight above), flush() blocks on the
        # device job lock and the re-lookup below serves that job's winner
        # (with zero measurements attributed to THIS call).
        results = self.flush(device)
        with self._lock:
            entry = self.registry.lookup(device, wl) or {}
            sel = self._selections.get(device)
            self.miss_latency.record(time.perf_counter() - t0)
            return HubResponse(device, wl, self.registry.get(device, wl),
                               False, entry.get("throughput_gflops"),
                               sum(r.total_measurements for r in results),
                               sel.sources if sel is not None else [],
                               source="tuned")

    def _device_lock(self, device: str) -> threading.Lock:
        with self._lock:
            return self._dev_locks.setdefault(device, threading.Lock())

    def flush(self, device: Optional[str] = None) -> List:
        """Run one batched TuneSession job per device with pending work.
        Returns the TuneResults. Jobs serialize per device (a second caller
        blocks, then finds nothing pending and hits the registry); the hub
        lock is only held to move keys between pending and in-flight, so
        serving other devices' hits is never blocked by a running job.

        Drain order is deterministic regardless of request arrival order:
        devices sort lexically and each device's tasks sort by workload key
        before tuning, so two hubs fed the same work in different orders run
        identical jobs (task order feeds the tuner's shared RNG stream) and
        land identical registries."""
        results = []
        with self._lock:
            devices = ([device] if device is not None
                       else sorted(self._pending))
        for dev in devices:
            with self._device_lock(dev):
                with self._lock:
                    tasks = sorted(self._pending.pop(dev, {}).values(),
                                   key=lambda wl: wl.key())
                    keys = {(dev, wl.key()) for wl in tasks}
                    self._inflight |= keys
                if not tasks:
                    continue
                try:
                    results.append(self._tune_batch(dev, tasks))
                finally:
                    # registry write hook: whatever the job landed (or
                    # failed to land), cached winners for this device are
                    # suspect — drop them; the next read repopulates from
                    # the registry
                    self.config_cache.invalidate(dev)
                    with self._lock:
                        self._inflight -= keys
        return results

    def selection(self, device: str) -> Optional[SourceSelection]:
        """The source selection used for `device`'s jobs, if one was made."""
        return self._selections.get(device)

    # --- the miss path ----------------------------------------------------
    def _selection_for(self, device: str) -> SourceSelection:
        """Fingerprint-driven source selection, computed once per device and
        persisted (fingerprint + any freshly pretrained params) so later
        misses — and later hub processes — warm-start instantly."""
        sel = self._selections.get(device)
        if sel is not None:
            return sel
        fp = self.store.get_fingerprint(device)
        if fp is None:
            t0 = time.perf_counter()
            fp = device_fingerprint(device)
            self.metrics.histogram("hub.fingerprint_seconds").observe(
                time.perf_counter() - t0)
            self.store.put_fingerprint(device, fp)
            with self._lock:
                self._fresh_fps[device] = fp
        sel = select_sources(self.store, device, top_k=self.top_k_sources,
                             model_name=self.cost_model_name,
                             target_fingerprint=fp, seed=self.seed,
                             torch_device=self.torch_device)
        if sel.pretrained_params is None and sel.pool is not None:
            t0 = time.perf_counter()
            model = resolve_cost_model(self.cost_model_name,
                                       self.moses_cfg.cost_model,
                                       self.torch_device)
            params = model.init(self.seed)
            params, _ = model.train(params, sel.pool,
                                    epochs=self.pretrain_epochs,
                                    seed=self.seed)
            self.metrics.histogram("hub.pretrain_seconds").observe(
                time.perf_counter() - t0)
            sel.pretrained_params = params
            sel.params_device = sel.best_source
            # keyed by the source device: its corpus trained these params
            self.store.save_model_params(
                sel.best_source, params, self.cost_model_name,
                lineage={"trigger": "pretrain",
                         "records_seen": self.store.count(sel.best_source)})
        self._selections[device] = sel
        return sel

    # --- continual learning ----------------------------------------------
    @property
    def lifecycle(self):
        """The `ModelLifecycle` manager over this hub's store (lazy; always
        available for inspection — `--lineage`, `--stats` — even when
        auto-refresh is off). Refresh jobs run through a TuneSession wired
        to the hub's config, seed, and cost-model family, so a background
        refresh is as reproducible as a serving job."""
        with self._lock:
            if self._lifecycle is None:
                from repro_torch.autotune.session import TuneSession
                from repro_torch.continual.lifecycle import ModelLifecycle
                self._lifecycle = ModelLifecycle(
                    self.store, model_name=self.cost_model_name,
                    moses_cfg=self.moses_cfg, cfg=self._lifecycle_cfg,
                    seed=self.seed,
                    session=TuneSession(moses_cfg=self.moses_cfg,
                                        seed=self.seed,
                                        cost_model=self.cost_model_name,
                                        torch_device=self.torch_device),
                    torch_device=self.torch_device)
            return self._lifecycle

    def _run_refresh(self, device: str) -> None:
        try:
            lc = self.lifecycle
            if (lc.serving_params(device) is None
                    and self.store.count(device) > 0):
                # the device just gained its first corpus but has no serving
                # model of its own (pre-training keys its params by the
                # SOURCE): bootstrap its lineage so the next similar device
                # warm-starts from params trained on this exact chip
                result = lc.refresh(device, trigger="post-job")
            else:
                # reuse a probe vector measured this session (the miss path
                # fingerprints new devices) instead of re-probing per job
                with self._lock:
                    fp = self._fresh_fps.pop(device, None)
                result = lc.maybe_refresh(device, current_fingerprint=fp)
        except Exception as e:  # noqa: BLE001 — a daemon thread must not
            # die silently: surface the failure in the stats the smoke and
            # --stats read, not just a stderr traceback
            with self._stats_lock:
                self.stats.refresh_rejects += 1
            log.warning("continual refresh failed", device=device,
                        error=repr(e))
            return
        with self._lock:
            if result is None:
                return
            if result.accepted:
                with self._stats_lock:
                    self.stats.refreshes += 1
                # lifecycle hook: a refreshed serving model can change what
                # future jobs land, so cached winners for the device go too
                self.config_cache.invalidate(device)
                # selections that warm-started from this device's params now
                # point at a superseded version; recompute on next miss
                for target in [t for t, sel in self._selections.items()
                               if sel.params_device == device]:
                    del self._selections[target]
            else:
                with self._stats_lock:
                    self.stats.refresh_rejects += 1

    def _schedule_refresh(self, device: str) -> None:
        """Post-job continual-learning hook: check drift on the device that
        just gained records and refresh/retire its serving model. "sync"
        runs inline (deterministic — the CI smoke), "auto" as a background
        job so serving latency never pays for model maintenance."""
        if self.refresh == "sync":
            self._run_refresh(device)
            return
        t = threading.Thread(target=self._run_refresh, args=(device,),
                             name=f"hub-refresh-{device}", daemon=True)
        with self._lock:
            self._refresh_threads = [x for x in self._refresh_threads
                                     if x.is_alive()]
            self._refresh_threads.append(t)
        t.start()

    def join_refreshes(self, timeout: Optional[float] = None) -> None:
        """Block until in-flight background refreshes finish (tests, smoke,
        orderly shutdown)."""
        with self._lock:
            threads = list(self._refresh_threads)
        for t in threads:
            t.join(timeout)

    def _tune_batch(self, device: str, tasks: Sequence[Workload]):
        t0 = time.perf_counter()
        with obs_trace.span("hub.tune_batch", device=device,
                            n_tasks=len(tasks)):
            result = self._tune_batch_inner(device, tasks)
        self.metrics.histogram("hub.tune_batch_seconds").observe(
            time.perf_counter() - t0)
        return result

    def _tune_batch_inner(self, device: str, tasks: Sequence[Workload]):
        sel = self._selection_for(device)
        # resolved fresh per job: Strategy instances carry per-job state
        strategy: Union[str, Strategy] = resolve_strategy(self.strategy)
        if sel.pretrained_params is None and strategy.requires_pretrained:
            # cold universe: nothing to transfer from — fall back to the
            # from-scratch online baseline rather than failing the job
            strategy = "ansor-random"
        session = TuneSession(
            moses_cfg=self.moses_cfg,
            pretrained_params=sel.pretrained_params,
            source_pool=sel.pool,
            seed=self.seed,
            trials_per_task=self.trials_per_task,
            registry=self.registry,
            store=self.store,
            cost_model=self.cost_model_name,
            torch_device=self.torch_device)
        # introspection: this tracker observes the job's predicted-vs-
        # measured calibration into the hub's own metrics registry (pure
        # observer — results are bit-for-bit identical with it off), and its
        # per-task summary rides along in each winner's provenance record
        calib = CalibrationTracker(registry=self.metrics)
        if self.scheduler == "gradient":
            # several misses for one device become ONE scheduled campaign:
            # measurement rounds flow to whichever pending workload still
            # improves, instead of a fixed per-task budget
            result = session.run_many([(device, tasks)], strategy=strategy,
                                      scheduler="gradient",
                                      speculative=self.speculative,
                                      executor=self.executor,
                                      calibration=calib)[0]
        else:
            result = session.run(tasks, device, strategy, calibration=calib)
        with self._stats_lock:
            self.stats.jobs += 1
            self.stats.measurements += result.total_measurements
            self.stats.poisoned += sum(len(t.poisoned or [])
                                       for t in result.tasks)
        self._record_provenance(device, sel, result, calib)
        self.registry.save()
        self.store.flush()
        if self.refresh != "off":
            self._schedule_refresh(device)
        return result

    def _record_provenance(self, device: str, sel: SourceSelection,
                           result, calib: CalibrationTracker) -> None:
        """Persist a `TransferProvenance` record for every task this job
        tuned — the hub's half of the `explain` contract: any winner the
        registry serves can name its sources, params lineage, ticket
        overlap, budget, and live calibration."""
        lineage_dev = sel.params_device or device
        try:
            lineage = self.store.model_lineage(lineage_dev)
        except Exception:  # noqa: BLE001 — provenance must not fail the job
            lineage = []
        params_version = None
        if sel.params_device is not None:
            try:
                params_version = self.store.latest_model_version(
                    sel.params_device, model_name=self.cost_model_name)
            except Exception:  # noqa: BLE001
                params_version = None
        overlap = ticket_overlap(sel.pretrained_params,
                                 getattr(result, "final_params", None),
                                 ratio=self.moses_cfg.transferable_ratio)
        for t in result.tasks:
            prov = build_provenance(
                t, device, result.strategy, sel=sel,
                params_version=params_version,
                lineage=lineage, mask_overlap=overlap,
                trials_per_task=self.trials_per_task,
                calibration=calib.per_task(device, t.workload.key()))
            self.store.put_provenance(device, prov.to_dict())

    # --- introspection ----------------------------------------------------
    def explain(self, device: str, task_key: str) -> Optional[Dict[str, Any]]:
        """The full story behind one served winner: its provenance record
        (sources, lineage, ticket overlap, budget, calibration at tuning
        time) joined with the registry entry it produced. None when the hub
        never tuned (device, task). The serving writer answers its RPC
        `explain` op with it, and `launch.obs --explain` renders it."""
        prov = self.store.get_provenance(device, task_key)
        if prov is None:
            return None
        entry = self.registry.entry(device, task_key)
        return {"device": device, "task": task_key,
                "provenance": prov, "registry": entry}
