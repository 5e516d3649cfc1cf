"""Async measurement service: thread-pool and process-farm backends (port
of `repro.sched.executor`; imports repointed, nothing else changed).

On real hardware the measurement phase dominates tuning wall time (Chen et
al., *Learning to Optimize Tensor Programs*): compile + transfer + run is
hundreds of milliseconds to seconds per candidate, and a hostile candidate
can segfault the runtime or wedge a board. This module gives the tuning
stack a measurement *service* with the failure semantics a production fleet
needs, behind one API with two interchangeable backends:

  * ``backend="thread"`` — workers are threads in this process. Cheap to
    spin up and able to run arbitrary (even unpicklable) measure functions,
    but a measurement that wedges can only be *abandoned* (CPython cannot
    preempt a thread) and a measurement that segfaults takes the whole
    process down. A watchdog retires wedged workers and tops the pool back
    up, so N consecutive timeouts can never starve ``measure_batch``.
  * ``backend="process"`` — spawn-context worker processes fed one
    instruction at a time over a pipe (`repro_torch.sched.farm`). A per-worker
    heartbeat plus a per-measurement timer lets the parent HARD KILL a
    wedged worker and respawn it, and a worker that dies mid-measurement
    (segfault, OOM kill) fails only its own request. This is the backend
    that survives hostile candidates and sidesteps the GIL.

Shared contracts, identical across backends (the scheduler and
`TuneSession` run unchanged against both):

  * bounded submission queue — producers block instead of growing an
    unbounded backlog when measurement is the bottleneck;
  * fault isolation — a config whose measurement raises, wedges, or kills
    its worker fails *its own* outcome (`MeasureOutcome.error`), never the
    pool or the batch;
  * crash quarantine — a config that poisoned a worker (crash, timeout, or
    retries exhausted) is recorded under its (workload, config, trial)
    identity; resubmitting it returns a pre-poisoned outcome instead of
    feeding the same grenade to a fresh worker;
  * retry with exponential backoff — transient failures get `retries` more
    attempts before the config is declared poisoned;
  * deterministic ordering — `measure_batch` returns outcomes in submission
    order regardless of worker interleaving, and the simulated device's
    noise is keyed on (config, trial), not execution order, so a parallel
    campaign replays bit-identically to a serial one — spawn workers
    included (`PYTHONHASHSEED` never leaks in).

The executor measures; it does not account time. Workers return the
simulated `measurement_seconds` cost per outcome (failed attempts still pay
— the board was occupied until it fell over) and `batch_wall_seconds`
estimates the parallel makespan, so the scheduler charges simulated seconds
(its budget currency) while real threads or processes provide the
concurrency.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.autotune import devices as dev_mod
from repro_torch.autotune.space import ProgramConfig, Workload
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class MeasureRequest:
    """One measurement to run: identity is (workload, config, trial)."""
    seq: int                    # submission index (result ordering key)
    device: str
    workload: Workload
    config: ProgramConfig
    trial: int = 0


@dataclasses.dataclass
class MeasureOutcome:
    """What came back. `throughput` is None iff the measurement failed
    (poisoned config, timeout, worker death, repeated errors); `seconds` is
    the simulated on-device cost that was still paid for the attempt."""
    request: MeasureRequest
    throughput: Optional[float]
    seconds: float
    attempts: int
    error: Optional[str] = None
    worker: Optional[str] = None    # which worker measured (process backend)

    @property
    def ok(self) -> bool:
        return self.throughput is not None


@dataclasses.dataclass(frozen=True)
class QuarantinedConfig:
    """One (workload, config, trial) the pool refuses to run again, and why.
    The record the campaign's retry machinery consults: a retry of the same
    identity resolves instantly as poisoned instead of being resubmitted."""
    device: str
    workload_key: str
    knobs: Tuple[Tuple[str, int], ...]
    trial: int
    error: str
    worker: Optional[str] = None


class _Slot:
    """Single-result rendezvous between one worker and one waiter. First
    writer wins: a result landing after the waiter timed out (or after the
    watchdog retired the worker) is dropped, so a stale (wedged, then
    recovered) measurement can never be attributed to a later request."""

    def __init__(self, request: MeasureRequest, timeout_cost: float = 0.0,
                 on_timeout: Optional[Callable[["_Slot"], None]] = None):
        self.request = request
        # simulated seconds a timeout is charged — the board was occupied
        # even though no result came back. Charging 0 would CHEAPEN wedged
        # tasks in the scheduler's gain/cost priority and attract grants to
        # exactly the tasks that produce nothing.
        self.timeout_cost = timeout_cost
        self.on_timeout = on_timeout
        # trace propagation: captured at submission, in the caller's
        # thread — the worker-side measure span parents to the caller's
        # open span (round.measure) even across the farm pipe, and the
        # queue-wait histogram measures submit -> begin
        self.ctx = obs_trace.current_context()
        self.tracer = obs_trace.current_tracer()
        self.t_submit = time.monotonic()
        self.t_submit_wall = time.time()
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._outcome: Optional[MeasureOutcome] = None

    @property
    def resolved(self) -> bool:
        return self._event.is_set()

    def offer(self, outcome: MeasureOutcome) -> bool:
        """Install `outcome` unless one already won; returns True iff won."""
        with self._lock:
            if self._outcome is None:
                self._outcome = outcome
                self._event.set()
                return True
            return False

    def wait(self, timeout: Optional[float]) -> MeasureOutcome:
        if self._event.wait(timeout):
            return self._outcome
        timed_out = MeasureOutcome(
            self.request, None, self.timeout_cost, attempts=0,
            error=f"timeout after {timeout:.3f}s")
        if self.offer(timed_out) and self.on_timeout is not None:
            self.on_timeout(self)       # quarantine the wedged identity
        return self._outcome


class MeasurementExecutor:
    """Measurement service facade: construct with ``backend="thread"``
    (default) or ``backend="process"`` and get the matching implementation;
    both are `MeasurementExecutor` subclasses, so isinstance checks and the
    whole caller surface (`submit`, `measure_batch`, `shutdown`, context
    manager, `quarantined()`) are backend-agnostic.

    `measure_fn(wl, cfg, device, trial=)` and `seconds_fn(wl, cfg, device)`
    default to the simulated device zoo; tests inject slow / flaky /
    poisoned variants (see `devices.FaultInjector` — the process backend
    requires picklable callables, which the injector is).
    """

    backend = "thread"

    def __new__(cls, *args, **kwargs):
        if cls is MeasurementExecutor:
            name = kwargs.get("backend", "thread")
            return super().__new__(_backend_class(name))
        return super().__new__(cls)

    def __init__(self, workers: int = 4, queue_size: int = 128,
                 timeout_s: Optional[float] = None, retries: int = 1,
                 backoff_s: float = 0.0,
                 measure_fn: Optional[Callable] = None,
                 seconds_fn: Optional[Callable] = None,
                 backend: Optional[str] = None):
        assert workers >= 1 and queue_size >= 1
        self.workers = workers
        self.queue_size = queue_size
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.measure_fn = measure_fn or dev_mod.measure
        self.seconds_fn = seconds_fn or dev_mod.measurement_seconds
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._shutdown = False
        self._qlock = threading.Lock()
        self._quarantine: Dict[Tuple[str, Tuple, int], QuarantinedConfig] = {}
        self.respawns = 0           # workers retired/killed and replaced

    # --- quarantine -------------------------------------------------------
    @staticmethod
    def _qkey(req: MeasureRequest) -> Tuple[str, Tuple, int]:
        return (req.workload.key(), req.config.knobs, req.trial)

    def _quarantine_add(self, req: MeasureRequest, error: str,
                        worker: Optional[str] = None) -> None:
        with self._qlock:
            self._quarantine.setdefault(self._qkey(req), QuarantinedConfig(
                req.device, req.workload.key(), req.config.knobs, req.trial,
                error, worker))

    def is_quarantined(self, wl: Workload, cfg: ProgramConfig,
                       trial: int = 0) -> bool:
        with self._qlock:
            return (wl.key(), cfg.knobs, trial) in self._quarantine

    def quarantined(self) -> List[QuarantinedConfig]:
        """Every poisoned (workload, config, trial), oldest first."""
        with self._qlock:
            return list(self._quarantine.values())

    def _on_slot_timeout(self, slot: _Slot) -> None:
        self._quarantine_add(slot.request,
                             f"timeout after {self.timeout_s}s")

    def _finalize(self, slot: _Slot, outcome: MeasureOutcome) -> None:
        """Deliver a worker's outcome; a failed one quarantines its
        identity so retries never resubmit it."""
        if not outcome.ok:
            self._quarantine_add(slot.request, outcome.error or "failed",
                                 worker=outcome.worker)
        reg = obs_metrics.current()
        reg.counter("exec.outcomes", backend=self.backend,
                    ok=str(outcome.ok).lower()).inc()
        reg.counter("exec.measure_seconds_total").inc(outcome.seconds)
        slot.offer(outcome)

    # --- worker side (thread backend; the farm mirrors this loop) ---------
    def _attempt(self, req: MeasureRequest) -> MeasureOutcome:
        attempts = 0
        spent = 0.0     # every attempt occupies the board and is charged
        while True:
            attempts += 1
            spent += self._cost_of(req)
            try:
                thr = float(self.measure_fn(req.workload, req.config,
                                            req.device, trial=req.trial))
                return MeasureOutcome(req, thr, spent, attempts)
            except Exception as e:  # fault isolation: poison fails only itself
                if attempts > self.retries:
                    return MeasureOutcome(req, None, spent, attempts,
                                          error=f"{type(e).__name__}: {e}")
                if self.backoff_s > 0:
                    time.sleep(self.backoff_s * (2 ** (attempts - 1)))

    def _cost_of(self, req: MeasureRequest) -> float:
        """Simulated seconds the attempt cost; a failure still pays (the
        board was busy until it fell over)."""
        try:
            return float(self.seconds_fn(req.workload, req.config,
                                         req.device))
        except Exception:
            return 0.0

    # --- caller side ------------------------------------------------------
    def _slot_timeout_cost(self, req: MeasureRequest) -> float:
        return self._cost_of(req) if self.timeout_s is not None else 0.0

    def _waiter_timeout(self) -> Optional[float]:
        """How long `measure_batch` waits per slot; the thread backend
        enforces timeouts at the waiter, the farm at the watchdog."""
        return self.timeout_s

    def submit(self, wl: Workload, cfg: ProgramConfig, device: str,
               trial: int = 0) -> _Slot:
        """Enqueue one measurement; blocks when the bounded queue is full.
        A quarantined identity resolves immediately as poisoned (zero
        simulated seconds — the board was never touched)."""
        if self._shutdown:
            raise RuntimeError("executor is shut down")
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        req = MeasureRequest(seq, device, wl, cfg, trial)
        slot = _Slot(req, timeout_cost=self._slot_timeout_cost(req),
                     on_timeout=self._on_slot_timeout)
        with self._qlock:
            entry = self._quarantine.get(self._qkey(req))
        if entry is not None:
            obs_metrics.current().counter("exec.quarantine_hits").inc()
            slot.offer(MeasureOutcome(
                req, None, 0.0, 0, error=f"quarantined: {entry.error}"))
            return slot
        self._dispatch(slot)
        return slot

    def _dispatch(self, slot: _Slot) -> None:
        raise NotImplementedError

    def measure_batch(self, wl: Workload, cfgs: Sequence[ProgramConfig],
                      device: str, trial: int = 0) -> List[MeasureOutcome]:
        """Measure a candidate batch; outcomes come back in input order, so
        downstream bookkeeping (records, trajectories, RNG) is independent
        of worker interleaving."""
        slots = [self.submit(wl, c, device, trial=trial) for c in cfgs]
        timeout = self._waiter_timeout()
        return [s.wait(timeout) for s in slots]

    def shutdown(self, wait: bool = True) -> None:
        raise NotImplementedError

    def __enter__(self) -> "MeasurementExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class _ThreadWorker:
    """One pool thread plus the watchdog-visible bits of its state.
    `busy` is written atomically (one attribute) so the watchdog can
    snapshot (slot, started_at) without a lock."""
    __slots__ = ("thread", "busy", "retired")

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.busy: Optional[Tuple[_Slot, float]] = None
        self.retired = False


class ThreadMeasurementExecutor(MeasurementExecutor):
    """Thread-pool backend: bounded queue, retries, waiter-side timeouts.

    A wedged worker thread cannot be killed (CPython), so the watchdog
    *retires* it — its slot is resolved as timed out and quarantined, the
    thread is flagged to exit whenever its measurement finally returns (its
    stale result is dropped by first-writer-wins), and a replacement thread
    is started so the pool never shrinks. Without the watchdog a timed-out
    measurement leaked its pool slot forever: `workers` consecutive wedges
    would deadlock every later `measure_batch`.
    """

    backend = "thread"

    def __init__(self, workers: int = 4, queue_size: int = 128,
                 timeout_s: Optional[float] = None, retries: int = 1,
                 backoff_s: float = 0.0,
                 measure_fn: Optional[Callable] = None,
                 seconds_fn: Optional[Callable] = None,
                 backend: Optional[str] = None,
                 watchdog_poll_s: Optional[float] = None):
        super().__init__(workers=workers, queue_size=queue_size,
                         timeout_s=timeout_s, retries=retries,
                         backoff_s=backoff_s, measure_fn=measure_fn,
                         seconds_fn=seconds_fn)
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._pool_lock = threading.Lock()
        self._spawned = 0
        self._workers: List[_ThreadWorker] = [
            self._spawn_worker() for _ in range(workers)]
        self._watchdog: Optional[threading.Thread] = None
        if timeout_s is not None:
            self._watchdog_poll_s = (
                watchdog_poll_s if watchdog_poll_s is not None
                else min(max(timeout_s / 5.0, 0.005), 0.1))
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="measure-watchdog",
                daemon=True)
            self._watchdog.start()

    def _spawn_worker(self) -> _ThreadWorker:
        w = _ThreadWorker()
        w.thread = threading.Thread(target=self._worker_loop, args=(w,),
                                    name=f"measure-{self._spawned}",
                                    daemon=True)
        self._spawned += 1
        w.thread.start()
        return w

    def _worker_loop(self, w: _ThreadWorker) -> None:
        while True:
            item = self._queue.get()
            if item is None:            # shutdown sentinel
                self._queue.task_done()
                return
            slot: _Slot = item
            if slot.resolved:           # timed out while still queued
                self._queue.task_done()
                continue
            w.busy = (slot, time.monotonic())
            obs_metrics.current().histogram(
                "exec.queue_wait_seconds", backend="thread").observe(
                max(0.0, time.monotonic() - slot.t_submit))
            t0_wall, t0 = time.time(), time.perf_counter()
            try:
                out = self._attempt(slot.request)
            finally:
                w.busy = None
                self._queue.task_done()
            if slot.tracer is not None:
                # same span name as the farm workers emit, so the
                # taxonomy (and the fault tests) are backend-agnostic
                slot.tracer.add_events([obs_trace.remote_event(
                    "exec.measure",
                    slot.ctx or (slot.tracer.trace_id, None),
                    t0_wall, time.perf_counter() - t0,
                    status="ok" if out.ok else "error",
                    worker=threading.current_thread().name,
                    device=slot.request.device, seq=slot.request.seq,
                    attempts=out.attempts, error=out.error)])
            self._finalize(slot, out)
            if w.retired:
                # a replacement already took this slot's place in the pool;
                # exiting (instead of looping) keeps the pool at `workers`
                return

    def _watchdog_loop(self) -> None:
        while not self._shutdown:
            time.sleep(self._watchdog_poll_s)
            now = time.monotonic()
            stale: List[Tuple[_ThreadWorker, _Slot]] = []
            with self._pool_lock:
                for w in list(self._workers):
                    busy = w.busy       # atomic snapshot
                    if (busy is None or w.retired
                            or now - busy[1] <= self.timeout_s):
                        continue
                    w.retired = True
                    self._workers.remove(w)
                    self._workers.append(self._spawn_worker())
                    self.respawns += 1
                    obs_metrics.current().counter(
                        "exec.respawns", backend="thread").inc()
                    stale.append((w, busy[0]))
            for w, slot in stale:
                self._finalize(slot, MeasureOutcome(
                    slot.request, None, slot.timeout_cost, 0,
                    error=f"timeout after {self.timeout_s:.3f}s "
                          "(worker retired)"))

    def _dispatch(self, slot: _Slot) -> None:
        self._queue.put(slot)

    def shutdown(self, wait: bool = True) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        with self._pool_lock:
            live = [w for w in self._workers if not w.retired]
        for _ in live:
            self._queue.put(None)
        if wait:
            for w in live:
                w.thread.join(timeout=5.0)


def _backend_class(name: str):
    if name == "thread":
        return ThreadMeasurementExecutor
    if name == "process":
        from repro_torch.sched.farm import ProcessMeasurementExecutor
        return ProcessMeasurementExecutor
    raise ValueError(f"unknown executor backend {name!r}; "
                     "expected 'thread' or 'process'")


def resolve_executor(spec, workers: int = 4) -> Tuple[MeasurementExecutor,
                                                      bool]:
    """Turn an executor spec into an instance: None -> default thread pool,
    a backend name -> a fresh pool of that backend, an instance -> itself.
    Returns (executor, owned) — owned pools are shut down by the caller
    that resolved them (run_campaign), passed-in instances are not."""
    if spec is None:
        return MeasurementExecutor(workers=workers), True
    if isinstance(spec, str):
        return MeasurementExecutor(workers=workers, backend=spec), True
    return spec, False


def batch_wall_seconds(costs: Sequence[float], workers: int) -> float:
    """Deterministic parallel-makespan estimate for a measured batch: LPT
    greedy assignment of per-measurement simulated costs onto `workers`
    boards. Used by the scheduler to report wall-clock speedup separately
    from the (worker-count-independent) device-seconds budget."""
    if not costs:
        return 0.0
    loads = [0.0] * max(1, workers)
    for c in sorted(costs, reverse=True):
        loads[loads.index(min(loads))] += c
    return max(loads)
