"""The fault-injection contract of tests/test_executor_faults.py, rerun on
the port's measurement farm (`repro_torch.sched`).

The failure semantics the executor claims — fault isolation, crash
quarantine, timeout-kill-and-respawn, pool-starvation immunity, bit-exact
serial/parallel replay — proven against deterministic injected faults
(`devices.FaultInjector`). The shared contracts run parametrized over BOTH
backends; process-only lifecycle tests (hard kill, heartbeat, pinning), the
thread watchdog, and campaign replay across backends and PYTHONHASHSEED
follow, with the campaigns' cost model on the CPU. Beyond the reference's
cases: a spawn worker of the port never loads torch, so next to a parent
that holds the card it cannot create a CUDA context.

Everything here must stay picklable where the process backend is involved:
fault functions live at module level, and the injector itself is a
picklable dataclass (each spawn worker gets its own copy — per-worker
transient state, like a power-cycled board).
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.autotune import devices as dev_mod  # noqa: E402
from repro_torch.autotune.devices import (FaultInjector,  # noqa: E402
                                          InjectedCrash)
from repro_torch.autotune.space import (Workload, default_config,  # noqa: E402
                                        random_config)
from repro_torch.sched import (MeasurementExecutor,  # noqa: E402
                               ProcessMeasurementExecutor,
                               ThreadMeasurementExecutor, resolve_executor,
                               run_campaign)

WL = Workload("matmul", (256, 256, 128), name="wl")
BACKENDS = ["thread", "process"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    machine's cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(n, seed=0):
    rng = np.random.RandomState(seed)
    out, seen = [], set()
    while len(out) < n:
        c = random_config(WL, rng)
        if c.knobs not in seen:
            seen.add(c.knobs)
            out.append(c)
    return out


def _split_by_fault(injector, cfgs, kind, trial=0):
    """(configs drawing `kind`, configs drawing no fault)."""
    hit = [c for c in cfgs if injector.fault_for(WL, c, trial) == kind]
    clean = [c for c in cfgs if injector.fault_for(WL, c, trial) is None]
    return hit, clean


def _injector(backend, **kw):
    """Crash mode per backend: the process farm takes real worker death
    (`os._exit`), the thread pool its in-process stand-in (InjectedCrash).
    Same seed => same fault map, so cross-backend replays stay comparable."""
    return FaultInjector(kill_process=(backend == "process"), **kw)


def _pin_enforcing_measure(wl, cfg, device, trial=0):
    """Module-level (picklable) measure_fn that fails unless the worker's
    exported device pin matches the request — proves dispatch affinity."""
    pin = os.environ.get("REPRO_WORKER_DEVICE")
    if pin is not None and pin != device:
        raise AssertionError(f"request for {device} ran on worker "
                             f"pinned to {pin}")
    return dev_mod.measure(wl, cfg, device, trial=trial)


# ---------------------------------------------------------------------------
# shared contracts, both backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
class TestBackendContracts:
    def test_isinstance_dispatch(self, backend):
        with MeasurementExecutor(workers=1, backend=backend) as ex:
            assert isinstance(ex, MeasurementExecutor)
            assert isinstance(ex, ThreadMeasurementExecutor
                              if backend == "thread"
                              else ProcessMeasurementExecutor)
            assert ex.backend == backend

    def test_submission_order_and_serial_identity(self, backend):
        cfgs = _configs(12)
        with MeasurementExecutor(workers=4, backend=backend) as ex:
            outs = ex.measure_batch(WL, cfgs, "tpu_v5e", trial=3)
        assert [o.request.config for o in outs] == cfgs
        serial = [dev_mod.measure(WL, c, "tpu_v5e", trial=3) for c in cfgs]
        # bit-identical, not allclose: parallel replay == serial replay
        assert [o.throughput for o in outs] == serial

    def test_crash_poisons_exactly_one_config(self, backend):
        """One injected crash fails one config; every other result is
        bit-identical to the fault-free serial run."""
        fi = _injector(backend, crash=0.2, seed=7)
        hit, clean = _split_by_fault(fi, _configs(16), "crash")
        cfgs = hit[:1] + clean[:11]     # exactly one hostile config
        with MeasurementExecutor(workers=3, backend=backend, retries=0,
                                 measure_fn=fi) as ex:
            outs = ex.measure_batch(WL, cfgs, "tpu_v5p")
            assert not outs[0].ok and outs[0].error
            assert outs[0].seconds > 0      # the dead board still cost time
            serial = [dev_mod.measure(WL, c, "tpu_v5p") for c in cfgs[1:]]
            assert [o.throughput for o in outs[1:]] == serial
            q = ex.quarantined()
            assert len(q) == 1
            assert q[0].knobs == cfgs[0].knobs and q[0].trial == 0
            assert ex.is_quarantined(WL, cfgs[0], 0)
            assert not ex.is_quarantined(WL, cfgs[1], 0)

    def test_quarantine_blocks_resubmission(self, backend):
        fi = _injector(backend, crash=0.2, seed=7)
        hit, clean = _split_by_fault(fi, _configs(16), "crash")
        cfgs = hit[:2] + clean[:4]
        with MeasurementExecutor(workers=2, backend=backend, retries=0,
                                 measure_fn=fi) as ex:
            first = ex.measure_batch(WL, cfgs, "tpu_v5p")
            assert [not o.ok for o in first[:2]] == [True, True]
            spawned = ex.respawns
            again = ex.measure_batch(WL, cfgs, "tpu_v5p")
            for o in again[:2]:
                # resolved from the quarantine record: the grenade was never
                # handed to a fresh worker, so nothing was paid or respawned
                assert o.error.startswith("quarantined:")
                assert o.seconds == 0.0 and o.attempts == 0
            assert [o.throughput for o in again[2:]] == \
                [o.throughput for o in first[2:]]
            assert ex.respawns == spawned
            assert len(ex.quarantined()) == 2

    def test_quarantine_persists_across_retry_rounds(self, backend):
        """A campaign-style retry loop can resubmit failures every round;
        the poisoned identity must short-circuit each time, forever."""
        fi = _injector(backend, crash=0.2, seed=7)
        hit, _ = _split_by_fault(fi, _configs(16), "crash")
        bad = hit[0]
        with MeasurementExecutor(workers=1, backend=backend, retries=0,
                                 measure_fn=fi) as ex:
            errors = [ex.measure_batch(WL, [bad], "tpu_v5p")[0].error
                      for _ in range(4)]
        assert not errors[0].startswith("quarantined:")
        assert all(e.startswith("quarantined:") for e in errors[1:])

    def test_flaky_transient_recovers_with_retry(self, backend):
        fi = _injector(backend, flaky=0.99, seed=11)
        cfgs = _configs(6)
        assert all(fi.fault_for(WL, c, 0) == "flaky" for c in cfgs)
        with MeasurementExecutor(workers=2, backend=backend, retries=2,
                                 backoff_s=0.001, measure_fn=fi) as ex:
            outs = ex.measure_batch(WL, cfgs, "tpu_v5e")
        serial = [dev_mod.measure(WL, c, "tpu_v5e") for c in cfgs]
        assert [o.throughput for o in outs] == serial
        assert all(o.attempts == 2 for o in outs)       # failed, then passed
        assert all(o.seconds > 0 for o in outs)

    def test_slow_degrade_is_not_quarantined(self, backend):
        """A degraded-but-healthy board answers late and correctly; with a
        timeout above its latency it must never be treated as poisoned."""
        fi = _injector(backend, slow=0.99, slow_s=0.05, seed=5)
        cfgs = _configs(4)
        with MeasurementExecutor(workers=2, backend=backend, timeout_s=30.0,
                                 measure_fn=fi) as ex:
            outs = ex.measure_batch(WL, cfgs, "tpu_v5e")
            assert all(o.ok for o in outs)
            assert ex.quarantined() == []

    def test_timeout_is_quarantined_and_charged(self, backend):
        fi = _injector(backend, hang=0.2, seed=3, hang_s=30.0)
        hit, clean = _split_by_fault(fi, _configs(16), "hang")
        cfgs = hit[:1] + clean[:3]
        with MeasurementExecutor(workers=2, backend=backend, retries=0,
                                 timeout_s=0.5, measure_fn=fi) as ex:
            outs = ex.measure_batch(WL, cfgs, "tpu_v5p")
            assert not outs[0].ok and "timeout" in outs[0].error
            # a wedged task must not look CHEAP to the scheduler's
            # gain/cost priority: the occupied board is still charged
            assert outs[0].seconds > 0
            assert all(o.ok for o in outs[1:])
            assert ex.is_quarantined(WL, cfgs[0], 0)

    def test_bounded_queue_backpressure(self, backend):
        with MeasurementExecutor(workers=2, queue_size=2,
                                 backend=backend) as ex:
            outs = ex.measure_batch(WL, _configs(12), "tpu_v5e")
        assert all(o.ok for o in outs)

    def test_submit_after_shutdown_raises(self, backend):
        ex = MeasurementExecutor(workers=1, backend=backend)
        ex.shutdown()
        with pytest.raises(RuntimeError):
            ex.submit(WL, default_config(WL), "tpu_v5e")

    def test_trial_keys_fault_identity(self, backend):
        """Faults key on (config, trial): the trial that crashed stays
        quarantined while another trial of the same config still runs."""
        fi = _injector(backend, crash=0.2, seed=7)
        bad = _split_by_fault(fi, _configs(16), "crash")[0][0]
        other = next(t for t in range(1, 50)
                     if fi.fault_for(WL, bad, t) is None)
        with MeasurementExecutor(workers=1, backend=backend, retries=0,
                                 measure_fn=fi) as ex:
            assert not ex.measure_batch(WL, [bad], "tpu_v5p", trial=0)[0].ok
            ok = ex.measure_batch(WL, [bad], "tpu_v5p", trial=other)[0]
            assert ok.ok
            assert ex.is_quarantined(WL, bad, 0)
            assert not ex.is_quarantined(WL, bad, other)


# ---------------------------------------------------------------------------
# process farm lifecycle
# ---------------------------------------------------------------------------


class TestProcessFarm:
    def test_workers_never_load_torch(self):
        """What a spawn worker unpickles (`_farm_worker_main`, the
        injector, `devices.measure`) imports no torch: no worker maps a
        torch library, so none can hold a CUDA context next to a parent
        on the card."""
        fi = _injector("process", seed=7)   # no faults: no respawns
        with MeasurementExecutor(workers=2, backend="process", retries=0,
                                 measure_fn=fi) as ex:
            outs = ex.measure_batch(WL, _configs(6), "tpu_v5e")
            assert all(o.ok for o in outs)
            assert {o.worker for o in outs} == {"p0", "p1"}
            pids = [w.proc.pid for w in ex._farm]
            maps = {pid: open(f"/proc/{pid}/maps").read() for pid in pids}
        assert len(pids) == 2
        for pid, text in maps.items():
            assert "libtorch" not in text and "libc10" not in text, pid
            assert "numpy" in text, pid     # the worker did import its deps

    def test_worker_death_respawns_and_pool_keeps_serving(self):
        fi = _injector("process", crash=0.2, seed=7)
        hit, clean = _split_by_fault(fi, _configs(20), "crash")
        with MeasurementExecutor(workers=2, backend="process", retries=0,
                                 measure_fn=fi) as ex:
            outs = ex.measure_batch(WL, hit[:2] + clean[:4], "tpu_v5p")
            assert sum(not o.ok for o in outs) == 2
            assert ex.respawns >= 2
            assert len(ex._farm) == 2       # the pool never shrank
            # clean follow-up batch proves the respawned workers serve
            outs2 = ex.measure_batch(WL, clean[4:8], "tpu_v5p")
            assert all(o.ok for o in outs2)

    def test_timeout_hard_kills_and_respawns(self):
        fi = _injector("process", hang=0.25, seed=3, hang_s=60.0)
        hit, clean = _split_by_fault(fi, _configs(20), "hang")
        with MeasurementExecutor(workers=2, backend="process", retries=0,
                                 timeout_s=0.4, measure_fn=fi) as ex:
            t0 = time.monotonic()
            outs = ex.measure_batch(WL, hit[:2] + clean[:2], "tpu_v5p")
            # the wedge was KILLED, not waited out (hang_s=60)
            assert time.monotonic() - t0 < 30.0
            assert [not o.ok for o in outs[:2]] == [True, True]
            assert all("timeout" in o.error for o in outs[:2])
            assert all(o.ok for o in outs[2:])
            assert ex.respawns >= 2

    def test_pool_starvation_under_repeated_hangs(self):
        """Every candidate wedges: the farm must keep killing/respawning and
        measure_batch must return — starvation can never deadlock it."""
        fi = _injector("process", hang=1.0, seed=1, hang_s=60.0)
        cfgs = _configs(6)
        with MeasurementExecutor(workers=2, backend="process", retries=0,
                                 timeout_s=0.4, measure_fn=fi) as ex:
            outs = ex.measure_batch(WL, cfgs, "tpu_v5p")
            assert all(not o.ok for o in outs)
            assert ex.respawns >= len(cfgs)
            # and the pool is still alive for honest work afterwards
            ok = ex.measure_batch(WL, [default_config(WL)], "tpu_v5p",
                                  trial=1)[0]
            assert ok.ok or "quarantined" not in (ok.error or "")

    def test_heartbeat_detects_frozen_worker(self):
        """A SIGSTOPped process is alive but frozen — no timeout timer is
        armed (it is idle), so only the heartbeat can catch it."""
        with MeasurementExecutor(workers=1, backend="process",
                                 heartbeat_s=0.05, hb_grace_s=0.5) as ex:
            assert ex.measure_batch(WL, _configs(1), "tpu_v5e")[0].ok
            victim = ex._farm[0].proc
            os.kill(victim.pid, signal.SIGSTOP)
            deadline = time.monotonic() + 15.0
            while ex.respawns < 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert ex.respawns >= 1, "frozen worker never detected"
            assert all(o.ok for o in
                       ex.measure_batch(WL, _configs(2, seed=2), "tpu_v5e"))
            assert not victim.is_alive()

    def test_device_pinning_routes_requests(self):
        pins = ["tpu_v5p", "tpu_v5e"]
        with MeasurementExecutor(workers=2, backend="process",
                                 device_pins=pins,
                                 measure_fn=_pin_enforcing_measure) as ex:
            assert {w.pin for w in ex._farm} == set(pins)
            for dev in pins:        # the enforcing fn raises on a mis-route
                outs = ex.measure_batch(WL, _configs(4), dev)
                assert all(o.ok for o in outs), [o.error for o in outs]
                assert all(o.worker.endswith(dev) for o in outs)
            # a device outside the pin set still gets served (any worker)
            with MeasurementExecutor(workers=2, backend="process",
                                     device_pins=pins) as ex2:
                assert ex2.measure_batch(WL, _configs(1), "tpu_edge")[0].ok

    def test_unpicklable_measure_fn_fails_fast(self):
        with pytest.raises(TypeError, match="pickle"):
            MeasurementExecutor(backend="process",
                                measure_fn=lambda wl, cfg, d, trial=0: 1.0)

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError, match="unknown executor backend"):
            MeasurementExecutor(backend="fiber")

    def test_resolve_executor_specs(self):
        ex, owned = resolve_executor(None)
        assert isinstance(ex, ThreadMeasurementExecutor) and owned
        ex.shutdown()
        ex, owned = resolve_executor("process", workers=1)
        assert isinstance(ex, ProcessMeasurementExecutor) and owned
        ex.shutdown()
        with MeasurementExecutor(workers=1) as mine:
            got, owned = resolve_executor(mine)
            assert got is mine and not owned
        with pytest.raises(ValueError):
            resolve_executor("fiber")


# ---------------------------------------------------------------------------
# thread watchdog (satellite: the stale-slot leak)
# ---------------------------------------------------------------------------


class TestThreadWatchdog:
    def test_consecutive_timeouts_cannot_deadlock_measure_batch(self):
        """Regression for the stale-slot leak: pre-watchdog, `workers`
        wedged measurements occupied their pool slots forever and every
        later batch deadlocked. N > workers consecutive timeouts must now
        finish AND leave a serving pool behind."""
        import threading
        release = threading.Event()

        def wedge_all(wl, cfg, device, trial=0):
            release.wait(20.0)
            return dev_mod.measure(wl, cfg, device, trial=trial)

        try:
            with MeasurementExecutor(workers=2, timeout_s=0.15,
                                     measure_fn=wedge_all) as ex:
                for round_i in range(2):    # two full batches of wedges
                    outs = ex.measure_batch(WL, _configs(4, seed=round_i),
                                            "tpu_v5e", trial=round_i)
                    assert all(not o.ok and "timeout" in o.error
                               for o in outs)
                assert ex.respawns >= 4     # retired + topped back up
        finally:
            release.set()                   # let retired threads exit

    def test_retired_worker_stale_result_is_dropped(self):
        import threading
        release = threading.Event()
        wedged_knobs = _configs(1, seed=9)[0].knobs

        def wedge_one(wl, cfg, device, trial=0):
            if cfg.knobs == wedged_knobs:
                release.wait(20.0)
            return dev_mod.measure(wl, cfg, device, trial=trial)

        with MeasurementExecutor(workers=2, timeout_s=0.15,
                                 measure_fn=wedge_one) as ex:
            out = ex.measure_batch(WL, _configs(1, seed=9), "tpu_v5e")[0]
            assert not out.ok and "timeout" in out.error
            release.set()                   # the wedge now "recovers"...
            time.sleep(0.1)
            # ...but its identity stays quarantined and its late result
            # was dropped (first-writer-wins), never resurrected
            again = ex.measure_batch(WL, _configs(1, seed=9), "tpu_v5e")[0]
            assert again.error.startswith("quarantined:")

    def test_pool_tops_up_to_constant_size(self):
        import threading
        release = threading.Event()

        def wedge_all(wl, cfg, device, trial=0):
            release.wait(20.0)
            return dev_mod.measure(wl, cfg, device, trial=trial)

        try:
            with MeasurementExecutor(workers=3, timeout_s=0.1,
                                     measure_fn=wedge_all) as ex:
                ex.measure_batch(WL, _configs(3), "tpu_v5e")
                live = [w for w in ex._workers if not w.retired]
                assert len(live) == 3
        finally:
            release.set()


# ---------------------------------------------------------------------------
# campaign replay under faults + spawn determinism
# ---------------------------------------------------------------------------


def _tiny_cfg():
    import dataclasses

    from repro_torch.configs.moses import DEFAULT as MCFG
    return dataclasses.replace(MCFG, online_epochs=2, adaptation_epochs=2,
                               population_size=32, evolution_rounds=2,
                               top_k_measure=8)


CAMPAIGN_JOBS = [("tpu_v5e", [Workload("matmul", (256, 256, 128), name="a"),
                              Workload("scan", (1024, 512), name="s")])]


class TestCampaignReplay:
    def test_process_campaign_matches_thread_campaign(self):
        """The whole gradient campaign, measured through spawn workers,
        lands bit-identical results to the in-process thread pool."""
        base = run_campaign(CAMPAIGN_JOBS, _tiny_cfg(),
                            strategy="ansor-random", trials_per_task=16,
                            torch_device="cpu")
        farm = run_campaign(CAMPAIGN_JOBS, _tiny_cfg(),
                            strategy="ansor-random", trials_per_task=16,
                            executor="process", torch_device="cpu")
        assert farm.curve() == base.curve()
        for r1, r2 in zip(base.results, farm.results):
            for t1, t2 in zip(r1.tasks, r2.tasks):
                assert t1.best_config.knobs == t2.best_config.knobs
                assert t1.best_latency == t2.best_latency
                assert t1.measured == t2.measured

    def test_faulted_campaign_replays_identically_across_backends(self):
        """Under the SAME injected fault map, a campaign measured serially
        (1 thread worker, in-process crashes) and one measured by the farm
        (4 spawn workers, real worker deaths) agree bit-exactly — worker
        death is semantically an exception, and the quarantine keeps both
        sides' retry behavior aligned."""
        runs = []
        for backend, workers in (("thread", 1), ("process", 4)):
            fi = _injector(backend, crash=0.08, seed=13)
            ex = MeasurementExecutor(workers=workers, backend=backend,
                                     retries=0, measure_fn=fi)
            try:
                runs.append(run_campaign(
                    CAMPAIGN_JOBS, _tiny_cfg(), strategy="ansor-random",
                    trials_per_task=16, executor=ex, torch_device="cpu"))
            finally:
                ex.shutdown()
        serial, farm = runs
        assert farm.curve() == serial.curve()
        poisoned = [[(c.knobs, t) for c, t, _ in (tk.poisoned or [])]
                    for r in farm.results for tk in r.tasks]
        assert poisoned == [[(c.knobs, t) for c, t, _ in (tk.poisoned or [])]
                            for r in serial.results for tk in r.tasks]
        assert any(poisoned), "fault map never fired; raise crash= or reseed"
        for r1, r2 in zip(serial.results, farm.results):
            for t1, t2 in zip(r1.tasks, r2.tasks):
                assert t1.measured == t2.measured

    def test_spawn_campaign_immune_to_pythonhashseed(self):
        """The same campaign in-process and via spawn workers under
        PYTHONHASHSEED variation yields a bit-identical curve()."""
        in_process = run_campaign(CAMPAIGN_JOBS, _tiny_cfg(),
                                  strategy="ansor-random",
                                  trials_per_task=8,
                                  torch_device="cpu").curve()
        code = (
            "import dataclasses\n"
            "from repro_torch.autotune.space import Workload\n"
            "from repro_torch.configs.moses import DEFAULT as MCFG\n"
            "from repro_torch.sched import run_campaign\n"
            "cfg = dataclasses.replace(MCFG, online_epochs=2,"
            " adaptation_epochs=2, population_size=32, evolution_rounds=2,"
            " top_k_measure=8)\n"
            "jobs = [('tpu_v5e', [Workload('matmul', (256, 256, 128),"
            " name='a'), Workload('scan', (1024, 512), name='s')])]\n"
            "print(repr(run_campaign(jobs, cfg, strategy='ansor-random',"
            " trials_per_task=8, executor='process',"
            " torch_device='cpu').curve()))\n")
        curves = []
        for hashseed in ("0", "31337"):
            out = subprocess.run(
                [sys.executable, "-c", code], capture_output=True,
                text=True, check=True,
                env={"PYTHONHASHSEED": hashseed, "PYTHONPATH": "src",
                     "PATH": os.environ["PATH"],
                     "HOME": os.environ.get("HOME", "/tmp")},
                cwd=os.path.join(os.path.dirname(__file__), ".."))
            curves.append(eval(out.stdout.strip().splitlines()[-1]))
        assert curves[0] == curves[1]
        assert curves[0] == in_process


# ---------------------------------------------------------------------------
# the injector itself
# ---------------------------------------------------------------------------


class TestFaultInjector:
    def test_fault_map_is_deterministic_and_disjoint(self):
        fi = FaultInjector(crash=0.1, hang=0.1, flaky=0.1, slow=0.1, seed=2)
        cfgs = _configs(64)
        m1 = [fi.fault_for(WL, c, 0) for c in cfgs]
        m2 = [FaultInjector(crash=0.1, hang=0.1, flaky=0.1, slow=0.1,
                            seed=2).fault_for(WL, c, 0) for c in cfgs]
        assert m1 == m2
        kinds = set(m1)
        assert kinds <= {None, "crash", "hang", "flaky", "slow"}
        assert len(kinds - {None}) >= 3     # rates actually draw faults
        # a different seed reshuffles the map
        m3 = [FaultInjector(crash=0.1, hang=0.1, flaky=0.1, slow=0.1,
                            seed=3).fault_for(WL, c, 0) for c in cfgs]
        assert m3 != m1

    def test_healthy_identities_measure_exactly(self):
        fi = FaultInjector(crash=0.3, seed=7)
        clean = _split_by_fault(fi, _configs(16), "crash")[1][:4]
        for c in clean:     # fault identity keys on trial too: stay on 0
            assert fi(WL, c, "tpu_v5e", trial=0) == \
                dev_mod.measure(WL, c, "tpu_v5e", trial=0)

    def test_crash_raises_in_process(self):
        fi = FaultInjector(crash=0.3, seed=7)      # kill_process=False
        bad = _split_by_fault(fi, _configs(16), "crash")[0][0]
        with pytest.raises(InjectedCrash):
            fi(WL, bad, "tpu_v5e")

    def test_flaky_fails_once_then_recovers(self):
        fi = FaultInjector(flaky=0.99, seed=11)
        cfg = _configs(1)[0]
        assert fi.fault_for(WL, cfg, 0) == "flaky"
        with pytest.raises(OSError):
            fi(WL, cfg, "tpu_v5e")
        assert fi(WL, cfg, "tpu_v5e") == dev_mod.measure(WL, cfg, "tpu_v5e")


# ---------------------------------------------------------------------------
# cross-process span propagation under faults
# ---------------------------------------------------------------------------


class TestCampaignTelemetryUnderFaults:
    def test_farm_trace_single_rooted_with_error_spans(self, tmp_path):
        """A farm campaign with tracing enabled, under FaultInjector
        worker kills, yields ONE well-formed trace — every
        worker's exec.measure spans parent into the campaign tree (no
        orphans), and killed workers' in-flight spans are closed with
        status=error instead of dropped."""
        from repro_torch.obs import FlightRecorder, validate_events

        fi = _injector("process", crash=0.08, seed=13)
        ex = MeasurementExecutor(workers=4, backend="process", retries=0,
                                 measure_fn=fi)
        rec = FlightRecorder(str(tmp_path / "obs"))
        try:
            result = run_campaign(CAMPAIGN_JOBS, _tiny_cfg(),
                                  strategy="ansor-random",
                                  trials_per_task=16, executor=ex, obs=rec,
                                  torch_device="cpu")
        finally:
            ex.shutdown()
        events = rec.tracer.events
        assert validate_events(events, expect_root="campaign") == []

        meas = [e for e in events if e.get("name") == "exec.measure"]
        assert meas, "no exec.measure spans came back over the farm pipes"
        # spans were built IN the worker processes, not synthesized locally
        worker_pids = {e["pid"] for e in meas} - {os.getpid()}
        assert worker_pids, "all exec.measure spans carry the parent pid"

        poisoned = sum(len(tk.poisoned or [])
                       for r in result.results for tk in r.tasks)
        assert poisoned > 0, "fault map never fired; raise crash= or reseed"
        errors = [e for e in meas if e["args"]["status"] == "error"]
        assert len(errors) >= poisoned
        # the killed workers' spans were synthesized by the parent at
        # respawn time (the worker died before it could answer)
        killed = [e for e in errors if e["pid"] == os.getpid()]
        assert killed, "no parent-synthesized span for a killed worker"
        assert all("died" in str(e["args"].get("error", ""))
                   for e in killed)

        # every measure span parents to a live round.measure/tune.finish
        ids = {e["args"]["span_id"] for e in events if e.get("ph") == "X"}
        assert all(e["args"]["parent_id"] in ids for e in meas)

        summary = result.obs_summary
        assert summary["problems"] == []
        assert summary["attributed_pct"] >= 95.0
        assert summary["error_spans"] >= poisoned

    def test_telemetry_does_not_perturb_faulted_replay(self, tmp_path):
        """The instrumented farm campaign lands bit-identical results to
        the uninstrumented one under the same fault map — observability
        must never change what was measured."""
        curves = []
        for obs in (None, str(tmp_path / "obs")):
            fi = _injector("process", crash=0.08, seed=13)
            ex = MeasurementExecutor(workers=4, backend="process",
                                     retries=0, measure_fn=fi)
            try:
                curves.append(run_campaign(
                    CAMPAIGN_JOBS, _tiny_cfg(), strategy="ansor-random",
                    trials_per_task=16, executor=ex, obs=obs,
                    torch_device="cpu").curve())
            finally:
                ex.shutdown()
        assert curves[0] == curves[1]


# ---------------------------------------------------------------------------
# chip_smoke.py's farm phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_sched_farm_rehearses_on_cpu():
    """chip_smoke.py's `sched_farm` at a small cost model on the CPU: the
    thread and the process campaign under one fault map grant, measure,
    pick and poison identically, and no farm worker maps torch (the
    nvidia-smi read needs the card)."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro_torch.configs.moses import CostModelConfig, MosesConfig

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(
        MosesConfig(cost_model=CostModelConfig(hidden_dims=(32, 32),
                                               batch_size=64,
                                               rank_pairs_per_batch=256)),
        population_size=16, evolution_rounds=2, online_epochs=2,
        adaptation_epochs=2)
    out = smoke.sched_farm("cpu", cfg, programs_per_task=2, epochs=1,
                           timeout_s=0.5)
    assert out["poisoned"] > 0 and out["process"]["respawns"] > 0
    assert out["thread"]["grants"] == out["process"]["grants"]
    assert out["grants_by_reason"]["warmup"] > 0
    assert len(out["process"]["worker_pids"]) == 4
    assert "compute_apps" not in out["process"]
