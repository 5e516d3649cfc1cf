"""Process-isolated measurement farm: the ``backend="process"`` executor
(port of `repro.sched.farm`; imports repointed, code unchanged).

The thread backend shares one CPython process with the tuner: a candidate
that segfaults the runtime takes the whole campaign down, a wedged one can
only be abandoned, and throughput is capped by the GIL. The farm promotes
workers to ``spawn``-context processes (the `TorchParallel`
instruction-queue idiom: the parent feeds each rank one instruction at a
time over a duplex pipe and collects results as they land):

  parent                                 worker process (spawn)
  ------                                 ----------------------
  submit() -> bounded pending deque      recv (seq, wl, cfg, device, trial)
  manager thread:                        retry loop around measure_fn
    dispatch to idle pin-matching worker heartbeat thread pulses the pipe
    collect results -> resolve slots     send ("done", seq, ...)
    watchdog: heartbeat + per-measure
      timer -> HARD KILL + respawn

Failure semantics (what the thread pool cannot give):

  * worker death mid-measurement (segfault, OOM kill, injected crash) —
    the parent notices the dead process, fails ONLY the in-flight request,
    quarantines its (workload, config, trial), and respawns the worker on
    the same pipe position; the campaign never sees the pool shrink;
  * hard kill on timeout — a measurement that exceeds `timeout_s` gets its
    worker SIGKILLed, not abandoned: a wedged C extension holds no pool
    slot and leaks no memory here;
  * heartbeat — each worker pulses its pipe every `heartbeat_s` from a
    side thread, so a process that is alive-but-frozen (stopped, swapped,
    deadlocked before reaching measure) is detected and replaced even when
    no measurement timer is armed;
  * per-worker device pinning — `device_pins` assigns each worker a device
    (round-robin); requests dispatch to a worker pinned to their device
    (exported to the child as ``REPRO_WORKER_DEVICE`` — on real fleets
    that is the visible-accelerator env var), falling back to any worker
    only for devices outside the pin set.

Dispatch sends ONE instruction per worker at a time: a killed worker can
never take queued work down with it, and the parent-side deque preserves
the bounded-queue backpressure contract. Results resolve per-submission
slots, so `measure_batch` keeps its submission-order determinism — a spawn
campaign replays bit-identically to a serial in-process one (the simulated
noise keys on (config, trial); `PYTHONHASHSEED` never enters).

Everything sent over the pipe — including `measure_fn` at spawn time — must
be picklable; construction fails fast with the offending callable named
(module-level functions and `devices.FaultInjector` qualify, test closures
do not: those belong on the thread backend).

A worker never touches torch: what it unpickles (`_farm_worker_main`,
`devices.measure`, `devices.FaultInjector`) lives in this module,
`sched.executor`, `autotune.devices`, `autotune.space` and `obs`, none of
which imports torch, and `repro_torch.sched` imports its submodules lazily.
So a spawn worker next to a parent that holds the card starts in well under
a second and never creates a CUDA context of its own.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import threading
import time
from collections import deque
from multiprocessing import connection as mp_conn
from typing import Callable, Deque, List, Optional, Sequence, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import remote_event
from repro_torch.sched.executor import (MeasureOutcome, MeasurementExecutor,
                                  _Slot)


def _farm_worker_main(wid: int, pin: Optional[str], conn,
                      measure_fn: Callable, seconds_fn: Callable,
                      retries: int, backoff_s: float,
                      heartbeat_s: float) -> None:
    """Worker-process entry point: serve measurement instructions until the
    pipe closes or a ``None`` sentinel arrives. Runs in a spawn child."""
    if pin is not None:
        # the fleet convention: a pinned worker sees one board. The
        # simulator reads the request's device, but real measure_fns key
        # their accelerator visibility off this.
        os.environ["REPRO_WORKER_DEVICE"] = pin
    send_lock = threading.Lock()        # pipe writes: heartbeat vs results
    stop = threading.Event()

    def _pulse() -> None:
        while not stop.wait(heartbeat_s):
            try:
                with send_lock:
                    conn.send(("hb", wid))
            except (OSError, BrokenPipeError, ValueError):
                return

    threading.Thread(target=_pulse, name="farm-heartbeat",
                     daemon=True).start()
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg is None:
            break
        seq, wl, cfg, device, trial, ctx = msg
        # per-measurement heartbeat: the parent arms the kill timer on this
        # ack, so a still-booting worker can't eat into the timeout budget
        try:
            with send_lock:
                conn.send(("begin", seq))
        except (OSError, BrokenPipeError):
            break
        attempts = 0
        spent = 0.0     # every attempt occupies the board and is charged
        thr: Optional[float] = None
        err: Optional[str] = None
        t0_wall, t0 = time.time(), time.perf_counter()
        while True:
            attempts += 1
            try:
                spent += float(seconds_fn(wl, cfg, device))
            except Exception:
                pass
            try:
                thr = float(measure_fn(wl, cfg, device, trial=trial))
                err = None
                break
            except Exception as e:      # a crash-kind fault never gets here:
                err = f"{type(e).__name__}: {e}"    # it killed the process
                if attempts > retries:
                    break
                if backoff_s > 0:
                    time.sleep(backoff_s * (2 ** (attempts - 1)))
        # span context shipped by value with the instruction; the worker
        # builds plain event dicts (no Tracer in the child) and returns
        # them with the result for the parent to merge into the timeline
        events = [] if ctx is None else [remote_event(
            "exec.measure", ctx, t0_wall, time.perf_counter() - t0,
            status="ok" if err is None else "error",
            worker=f"p{wid}", device=device, seq=seq,
            attempts=attempts, error=err)]
        try:
            with send_lock:
                conn.send(("done", seq, thr, spent, attempts, err, events))
        except (OSError, BrokenPipeError):
            break
    stop.set()


# a spawn child pays interpreter start + imports before its first pulse;
# the heartbeat watchdog must not count that window as missed beats
_BOOT_GRACE_S = 10.0


class _FarmWorker:
    """Parent-side view of one worker process: its pipe, its pin, and the
    single in-flight (slot, dispatched_at) instruction, if any."""
    __slots__ = ("wid", "pin", "proc", "conn", "inflight", "last_hb")

    def __init__(self, wid: int, pin: Optional[str], proc, conn):
        self.wid = wid
        self.pin = pin
        self.proc = proc
        self.conn = conn
        # (slot, began_at): began_at is None until the worker acks "begin" —
        # the measurement timer never runs while an instruction is merely
        # buffered behind a booting worker
        self.inflight: Optional[Tuple[_Slot, Optional[float]]] = None
        self.last_hb = time.monotonic() + _BOOT_GRACE_S

    @property
    def name(self) -> str:
        return f"p{self.wid}" + (f"@{self.pin}" if self.pin else "")


class ProcessMeasurementExecutor(MeasurementExecutor):
    """Spawn-context measurement farm; see the module docstring for the
    worker lifecycle. Extra knobs over the thread backend:

    `device_pins`   worker i serves device_pins[i % len] (None: unpinned);
    `heartbeat_s`   worker liveness pulse period;
    `hb_grace_s`    heartbeats missed for this long mark the process frozen
                    and trigger a kill + respawn even with no timeout set;
    `poll_s`        manager wake period (dispatch/watchdog granularity).
    """

    backend = "process"

    def __init__(self, workers: int = 4, queue_size: int = 128,
                 timeout_s: Optional[float] = None, retries: int = 1,
                 backoff_s: float = 0.0,
                 measure_fn: Optional[Callable] = None,
                 seconds_fn: Optional[Callable] = None,
                 backend: Optional[str] = None,
                 device_pins: Optional[Sequence[str]] = None,
                 heartbeat_s: float = 0.05,
                 hb_grace_s: float = 5.0,
                 poll_s: Optional[float] = None):
        super().__init__(workers=workers, queue_size=queue_size,
                         timeout_s=timeout_s, retries=retries,
                         backoff_s=backoff_s, measure_fn=measure_fn,
                         seconds_fn=seconds_fn)
        try:
            pickle.dumps((self.measure_fn, self.seconds_fn))
        except Exception as e:
            raise TypeError(
                "backend='process' ships measure_fn/seconds_fn to spawn "
                f"workers; {self.measure_fn!r} / {self.seconds_fn!r} did "
                f"not pickle ({e}). Use module-level callables (e.g. "
                "devices.FaultInjector) or backend='thread'.") from e
        self.device_pins = list(device_pins) if device_pins else None
        self.heartbeat_s = heartbeat_s
        self.hb_grace_s = hb_grace_s
        self.poll_s = (poll_s if poll_s is not None
                       else min(0.02, timeout_s / 5.0)
                       if timeout_s is not None else 0.02)
        self._ctx = mp.get_context("spawn")
        self._pending: Deque[_Slot] = deque()
        self._pending_cv = threading.Condition()
        self._farm: List[_FarmWorker] = [self._spawn(i)
                                         for i in range(workers)]
        self._manager = threading.Thread(target=self._manage,
                                         name="farm-manager", daemon=True)
        self._manager.start()

    # --- lifecycle --------------------------------------------------------
    def _spawn(self, wid: int) -> _FarmWorker:
        pin = (self.device_pins[wid % len(self.device_pins)]
               if self.device_pins else None)
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_farm_worker_main,
            args=(wid, pin, child_conn, self.measure_fn, self.seconds_fn,
                  self.retries, self.backoff_s, self.heartbeat_s),
            name=f"measure-farm-{wid}", daemon=True)
        proc.start()
        child_conn.close()
        return _FarmWorker(wid, pin, proc, parent_conn)

    def _replace(self, w: _FarmWorker, error: str) -> None:
        """Hard-kill `w`, fail + quarantine its in-flight request (if any),
        and respawn a worker on the same position/pin. Manager thread only."""
        self._farm.remove(w)
        inflight, w.inflight = w.inflight, None
        try:
            w.conn.close()
        except OSError:
            pass
        if w.proc.is_alive():
            w.proc.kill()
        w.proc.join(timeout=2.0)
        if inflight is not None:
            slot, _ = inflight
            if slot.tracer is not None:
                # the killed worker's span event died with it; synthesize
                # one from the parent-side submission record so the trace
                # still closes every in-flight measurement with `error`
                slot.tracer.add_events([remote_event(
                    "exec.measure",
                    slot.ctx or (slot.tracer.trace_id, None),
                    slot.t_submit_wall,
                    max(0.0, time.time() - slot.t_submit_wall),
                    status="error", worker=w.name,
                    device=slot.request.device, seq=slot.request.seq,
                    attempts=0, error=error)])
            self._finalize(slot, MeasureOutcome(
                slot.request, None, slot.timeout_cost, 0, error=error,
                worker=w.name))
        self.respawns += 1
        obs_metrics.current().counter("exec.respawns",
                                      backend="process").inc()
        if not self._shutdown:
            self._farm.append(self._spawn(w.wid))

    # --- manager thread ---------------------------------------------------
    def _manage(self) -> None:
        while not self._shutdown:
            conns = [w.conn for w in self._farm]
            try:
                ready = mp_conn.wait(conns, timeout=self.poll_s)
            except OSError:
                ready = []
            now = time.monotonic()
            broken: List[Tuple[_FarmWorker, str]] = []
            for w in list(self._farm):
                if w.conn in ready and not self._drain(w, now):
                    # EOF on the pipe nearly always means the process died
                    # (segfault / os._exit); name the failure accordingly
                    w.proc.join(timeout=0.5)
                    broken.append((w, "worker pipe closed"
                                   if w.proc.is_alive()
                                   else "worker process died (pipe closed)"))
            for w, why in broken:
                if w in self._farm:
                    self._replace(w, why)
            for w in list(self._farm):
                if not w.proc.is_alive():
                    # one last drain: a result can land in the pipe in the
                    # same instant the process exits — don't lose it
                    self._drain(w, now)
                    self._replace(w, "worker process died")
                elif (w.inflight is not None and w.inflight[1] is not None
                      and self.timeout_s is not None
                      and now - w.inflight[1] > self.timeout_s):
                    self._replace(
                        w, f"timeout after {self.timeout_s:.3f}s "
                           "(worker killed)")
                elif now - w.last_hb > max(self.hb_grace_s,
                                           4 * self.heartbeat_s):
                    self._replace(w, "worker heartbeat lost")
            self._dispatch_pending()

    def _drain(self, w: _FarmWorker, now: float) -> bool:
        """Pull every buffered message off `w`'s pipe; False if the pipe
        broke (the worker died mid-write)."""
        try:
            while w.conn.poll():
                msg = w.conn.recv()
                w.last_hb = now
                if msg[0] == "begin":
                    if (w.inflight is not None
                            and w.inflight[0].request.seq == msg[1]):
                        slot = w.inflight[0]
                        w.inflight = (slot, now)            # arm the timer
                        obs_metrics.current().histogram(
                            "exec.queue_wait_seconds",
                            backend="process").observe(
                            max(0.0, now - slot.t_submit))
                    continue
                if msg[0] != "done":
                    continue            # heartbeat
                _, seq, thr, spent, attempts, err, events = msg
                inflight, w.inflight = w.inflight, None
                if inflight is not None and inflight[0].request.seq == seq:
                    slot = inflight[0]
                    if slot.tracer is not None:
                        slot.tracer.add_events(events)
                    self._finalize(slot, MeasureOutcome(
                        slot.request, thr, spent, attempts, error=err,
                        worker=w.name))
        except (EOFError, OSError):
            return False
        return True

    def _pick_worker(self, idle: List[_FarmWorker],
                     device: str) -> Optional[_FarmWorker]:
        for w in idle:
            if w.pin == device:
                return w
        for w in idle:
            if w.pin is None:
                return w
        if self.device_pins and device not in self.device_pins:
            return idle[0] if idle else None
        return None     # this device's pinned workers are all busy: wait

    def _dispatch_pending(self) -> None:
        with self._pending_cv:
            idle = [w for w in self._farm
                    if w.inflight is None and w.proc.is_alive()]
            i = 0
            while i < len(self._pending) and idle:
                slot = self._pending[i]
                if slot.resolved:       # e.g. shutdown already failed it
                    del self._pending[i]
                    continue
                w = self._pick_worker(idle, slot.request.device)
                if w is None:           # pinned + busy: try the next item
                    i += 1
                    continue
                del self._pending[i]
                idle.remove(w)
                req = slot.request
                try:
                    w.conn.send((req.seq, req.workload, req.config,
                                 req.device, req.trial, slot.ctx))
                    w.inflight = (slot, None)   # timer arms on "begin" ack
                except (OSError, BrokenPipeError):
                    self._pending.appendleft(slot)      # retry elsewhere
                    w.last_hb = 0.0     # flag: heartbeat-lost replaces it
            self._pending_cv.notify_all()

    # --- caller side ------------------------------------------------------
    def _slot_timeout_cost(self, req) -> float:
        # crashes must charge simulated seconds even with no timeout set
        return self._cost_of(req)

    def _waiter_timeout(self) -> Optional[float]:
        return None     # the watchdog resolves every dispatched slot

    def _dispatch(self, slot: _Slot) -> None:
        with self._pending_cv:
            while (len(self._pending) >= self.queue_size
                   and not self._shutdown):
                self._pending_cv.wait(0.05)
            if self._shutdown:
                slot.offer(MeasureOutcome(slot.request, None, 0.0, 0,
                                          error="executor is shut down"))
                return
            self._pending.append(slot)

    def shutdown(self, wait: bool = True) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        with self._pending_cv:
            dropped = list(self._pending)
            self._pending.clear()
            self._pending_cv.notify_all()
        for slot in dropped:
            slot.offer(MeasureOutcome(slot.request, None, 0.0, 0,
                                      error="executor is shut down"))
        if wait:
            self._manager.join(timeout=5.0)
        for w in self._farm:
            inflight, w.inflight = w.inflight, None
            if inflight is not None:
                inflight[0].offer(MeasureOutcome(
                    inflight[0].request, None, 0.0, 0,
                    error="executor is shut down", worker=w.name))
            try:
                w.conn.send(None)
            except (OSError, BrokenPipeError):
                pass
        for w in self._farm:
            w.proc.join(timeout=2.0 if wait else 0.1)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=1.0)
            try:
                w.conn.close()
            except OSError:
                pass
