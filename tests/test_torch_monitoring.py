"""Continuous monitoring on the port (`repro_torch.obs.timeseries`,
`repro_torch.obs.slo`, `repro_torch.launch.obs`), on the CPU.

  * The reference's own cases (`tests/test_monitoring.py`:
    `TestTimeSeriesSampler`, `TestSLOEvaluator`, `TestBenchHistory`,
    `TestServingMonitoringE2E`) run on the port; the bench history is
    written by the reference's `benchmarks.run`, which the port does not
    import, and read by the port's `launch.obs`.
  * Across packages: one sequence of snapshots through both packages'
    sampler and evaluator gives the same values and the same alert
    transitions; `launch.obs --summarize`, `--check`, `--export`,
    `--diff`, `--report` and `--explain` print what the reference prints on
    the same artifacts (flight records, a hub root, a bench history), and
    `launch.obs` loads no torch.
"""
import json
import math
import os
import subprocess
import sys
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.slo import (SLOEvaluator, SLOSpec,  # noqa: E402
                                 default_serving_slos)
from repro_torch.obs.timeseries import (TimeSeriesSampler,  # noqa: E402
                                        merge_hist_states, reset_safe_delta)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


class Clock:
    """Manual monotonic clock for deterministic sampler tests."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _sampler_over(reg: MetricsRegistry, clock: Clock,
                  **kw) -> TimeSeriesSampler:
    return TimeSeriesSampler(source=reg, clock=clock, **kw)



def _sampler_over(reg: MetricsRegistry, clock: Clock,
                  **kw) -> TimeSeriesSampler:
    return TimeSeriesSampler(source=reg, clock=clock, **kw)


class TestTimeSeriesSampler:
    def test_windowed_rate_and_percentile_exact(self):
        reg = MetricsRegistry()
        clock = Clock()
        s = _sampler_over(reg, clock)
        s.sample_now()
        c = reg.counter("serve.requests")
        h = reg.histogram("serve.latency_seconds")
        for ms in range(1, 101):
            c.inc()
            h.observe(ms / 1e3)
        clock.advance(10.0)
        s.sample_now()
        assert s.rate("serve.requests", 30.0) == pytest.approx(10.0)
        assert s.percentile("serve.latency_seconds", 50,
                            30.0) == pytest.approx(0.050)
        assert s.percentile("serve.latency_seconds", 99,
                            30.0) == pytest.approx(0.099)

    def test_window_selects_trailing_seconds(self):
        reg = MetricsRegistry()
        clock = Clock()
        s = _sampler_over(reg, clock)
        c = reg.counter("x")
        s.sample_now()                      # t=0
        for _ in range(12):                 # samples every 10s up to t=120
            if clock.t < 50:
                c.inc(10)                   # burst: 50 events before t=50
            clock.advance(10.0)
            s.sample_now()
        # a 30s window is past the burst entirely: zero rate
        assert s.rate("x", 30.0) == 0.0
        # the full window sees everything
        assert s.rate("x", 1000.0) == pytest.approx(50.0 / 120.0)

    def test_empty_window_is_none_and_nan(self):
        reg = MetricsRegistry()
        s = _sampler_over(reg, Clock())
        assert s.window(30.0) is None
        assert math.isnan(s.rate("x", 30.0))
        assert math.isnan(s.percentile("x", 99, 30.0))
        s.sample_now()                      # one sample: still no delta
        assert s.window(30.0) is None

    def test_counter_reset_never_negative(self):
        # a respawned reader restarts its counters: the merged snapshot
        # dips from 10 to 3 — the delta must clamp to zero, not go to -7
        before = {"counters": {"serve.requests": 10.0}, "gauges": {},
                  "histograms": {}}
        after = {"counters": {"serve.requests": 3.0}, "gauges": {},
                 "histograms": {}}
        d = reset_safe_delta(before, after)
        assert d["counters"].get("serve.requests", 0.0) == 0.0
        # and through the sampler: the windowed rate is 0, never negative
        snaps = iter([before, after])
        clock = Clock()
        s = TimeSeriesSampler(source=lambda: next(snaps), clock=clock)
        s.sample_now()
        clock.advance(5.0)
        s.sample_now()
        assert s.rate("serve.requests", 30.0) == 0.0

    def test_histogram_reset_clamped_per_bucket(self):
        big, small = MetricsRegistry(), MetricsRegistry()
        for ms in (1, 2, 3, 4, 5):
            big.histogram("lat").observe(ms / 1e3)
        for ms in (1, 2):
            small.histogram("lat").observe(ms / 1e3)
        d = reset_safe_delta(big.snapshot(), small.snapshot())
        st = d["histograms"].get("lat")
        # every bucket went backwards -> all clamp to zero -> dropped
        assert st is None
        # partial reset: one reader restarted, another kept going
        merged = MetricsRegistry()
        merged.merge(small.snapshot())
        for ms in (50, 60):                 # survivor's new samples
            merged.histogram("lat").observe(ms / 1e3)
        d = reset_safe_delta(big.snapshot(), merged.snapshot())
        st = d["histograms"]["lat"]
        assert st["count"] == 2
        assert all(c >= 0 for c in st["counts"])

    def test_merge_hist_states_exact(self):
        a, b = MetricsRegistry(), MetricsRegistry()
        for v in (0.01, 0.02):
            a.histogram("h").observe(v)
        for v in (0.03, 0.04):
            b.histogram("h").observe(v)
        st = merge_hist_states([a.snapshot()["histograms"]["h"],
                                b.snapshot()["histograms"]["h"]])
        assert st["count"] == 4
        assert st["total"] == pytest.approx(0.10)
        assert st["min"] == pytest.approx(0.01)
        assert st["max"] == pytest.approx(0.04)

    def test_ring_is_bounded(self):
        reg = MetricsRegistry()
        clock = Clock()
        s = _sampler_over(reg, clock, capacity=3)
        for _ in range(10):
            clock.advance(1.0)
            s.sample_now()
        assert len(s) == 3

    def test_thread_shutdown_leaves_nothing_dangling(self):
        reg = MetricsRegistry()
        s = TimeSeriesSampler(source=reg, interval_s=0.01)
        s.start()
        assert s.running
        deadline = time.monotonic() + 5.0
        while len(s) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(s) >= 2, "sampler thread never sampled"
        s.stop()
        assert not s.running
        assert not any(t.name == "obs-sampler" and t.is_alive()
                       for t in threading.enumerate()), (
            "sampler thread still alive after stop()")
        s.stop()                            # idempotent

    def test_sampler_survives_broken_source(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) == 1:
                raise OSError("scrape failed")
            return {"counters": {}, "gauges": {}, "histograms": {}}

        s = TimeSeriesSampler(source=flaky, interval_s=0.01)
        s.start()
        deadline = time.monotonic() + 5.0
        while len(s) < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        s.stop()
        assert len(s) >= 1, "one bad scrape killed the sampler"



class TestSLOEvaluator:
    def _latency_setup(self, threshold=0.1):
        reg = MetricsRegistry()
        clock = Clock()
        sampler = _sampler_over(reg, clock)
        spec = SLOSpec("p99", "latency_p", "lat", threshold, p=99.0,
                       fast_window_s=10.0, slow_window_s=20.0)
        ev = SLOEvaluator([spec], sampler, registry=reg)
        return reg, clock, sampler, ev

    def test_fires_once_and_resolves_once(self):
        reg, clock, sampler, ev = self._latency_setup()
        sampler.sample_now()
        for _ in range(20):
            reg.histogram("lat").observe(0.5)       # way over 0.1s
        clock.advance(5.0)
        sampler.sample_now()
        ev.evaluate(now=clock())
        assert ev.firing() == ["p99"]
        assert len(ev.alerts) == 1 and ev.alerts[0]["state"] == "firing"
        # more bad data, more evaluations: NO additional alert
        for _ in range(3):
            reg.histogram("lat").observe(0.5)
            clock.advance(2.0)
            sampler.sample_now()
            ev.evaluate(now=clock())
        assert len(ev.alerts) == 1
        # age the bad samples out of both windows, then serve good traffic
        clock.advance(30.0)
        sampler.sample_now()
        for _ in range(20):
            reg.histogram("lat").observe(0.01)
        clock.advance(5.0)
        sampler.sample_now()
        ev.evaluate(now=clock())
        assert ev.firing() == []
        assert len(ev.alerts) == 2 and ev.alerts[1]["state"] == "ok"
        assert [st.state for st in ev.statuses] == ["ok"]

    def test_hysteresis_band_does_not_flap(self):
        # after firing, values inside (threshold*clear_ratio, threshold]
        # are neither a violation nor a clear: state holds, no transitions
        reg, clock, sampler, ev = self._latency_setup(threshold=0.1)
        sampler.sample_now()
        for _ in range(20):
            reg.histogram("lat").observe(0.5)
        clock.advance(5.0)
        sampler.sample_now()
        ev.evaluate(now=clock())
        assert len(ev.alerts) == 1
        for _ in range(5):                  # hover in the hysteresis band
            clock.advance(30.0)             # old samples age out each round
            sampler.sample_now()
            for _ in range(20):
                reg.histogram("lat").observe(0.095)     # 0.09 < v <= 0.1
            clock.advance(5.0)
            sampler.sample_now()
            ev.evaluate(now=clock())
        assert ev.firing() == ["p99"], "hysteresis band cleared the alert"
        assert len(ev.alerts) == 1, "alert flapped inside the band"

    def test_fast_window_alone_does_not_fire(self):
        # a blip that violates only the fast window must not page
        reg = MetricsRegistry()
        clock = Clock()
        sampler = _sampler_over(reg, clock)
        spec = SLOSpec("p99", "latency_p", "lat", 0.1, p=50.0,
                       fast_window_s=10.0, slow_window_s=60.0)
        ev = SLOEvaluator([spec], sampler)
        sampler.sample_now()
        for _ in range(100):
            reg.histogram("lat").observe(0.01)      # long good history
        clock.advance(50.0)
        sampler.sample_now()                        # t=50
        for _ in range(3):
            reg.histogram("lat").observe(0.5)       # short blip after t=50
        clock.advance(10.0)
        sampler.sample_now()                        # t=60
        ev.evaluate(now=clock())
        # fast window (50..60) is all blip and violates; slow window
        # (0..60) p50 is still good — multi-window must NOT fire
        assert ev.firing() == []
        assert not ev.alerts

    def test_events_kind_counts_window_delta(self):
        reg = MetricsRegistry()
        clock = Clock()
        sampler = _sampler_over(reg, clock)
        spec = SLOSpec("respawns", "events", "serve.reader_respawns", 0.0,
                       fast_window_s=5.0, slow_window_s=10.0)
        ev = SLOEvaluator([spec], sampler, registry=reg)
        sampler.sample_now()
        clock.advance(1.0)
        sampler.sample_now()
        ev.evaluate(now=clock())
        assert ev.firing() == []
        reg.counter("serve.reader_respawns", reader="0").inc()
        clock.advance(1.0)
        sampler.sample_now()
        ev.evaluate(now=clock())
        assert ev.firing() == ["respawns"]
        firing_alerts = [a for a in ev.alerts if a["state"] == "firing"]
        assert len(firing_alerts) == 1
        # once the respawn leaves both windows the spec clears (0 <= 0*0.9)
        clock.advance(15.0)
        sampler.sample_now()
        clock.advance(1.0)
        sampler.sample_now()
        ev.evaluate(now=clock())
        assert ev.firing() == []
        assert [a["state"] for a in ev.alerts] == ["firing", "ok"]
        snap = reg.snapshot()["counters"]
        assert snap.get(
            "slo.transitions{slo=respawns,state=firing}") == 1.0

    def test_no_data_neither_fires_nor_clears(self):
        reg = MetricsRegistry()
        sampler = _sampler_over(reg, Clock())
        ev = SLOEvaluator(default_serving_slos(), sampler)
        statuses = ev.evaluate()
        assert {st.state for st in statuses} == {"no_data"}
        assert not ev.alerts and ev.firing() == []
        # to_dict maps NaN to None (JSON-safe for the scrape reply)
        d = statuses[0].to_dict()
        assert d["value_fast"] is None and d["value_slow"] is None
        json.dumps([st.to_dict() for st in statuses])

    def test_ratio_with_zero_denominator(self):
        reg = MetricsRegistry()
        clock = Clock()
        sampler = _sampler_over(reg, clock)
        spec = SLOSpec("errs", "ratio", "serve.errors", 0.5,
                       denominator="serve.requests",
                       fast_window_s=5.0, slow_window_s=10.0)
        ev = SLOEvaluator([spec], sampler)
        sampler.sample_now()
        reg.counter("serve.errors").inc(3)          # errors, zero requests
        clock.advance(1.0)
        sampler.sample_now()
        ev.evaluate(now=clock())
        assert ev.firing() == ["errs"], "errors without requests must fire"

    def test_bad_spec_rejected(self):
        with pytest.raises(ValueError):
            SLOSpec("x", "bogus_kind", "k", 1.0)
        with pytest.raises(ValueError):
            SLOSpec("x", "ratio", "k", 1.0)          # no denominator



class TestBenchHistory:
    def _write(self, monkeypatch, tmp_path, suite, metrics):
        import benchmarks.run as bench_run
        monkeypatch.setattr(bench_run, "REPO_ROOT", str(tmp_path))
        bench_run.write_bench_json(suite, metrics)

    def test_history_appends_one_line_per_run(self, monkeypatch, tmp_path,
                                              capsys):
        self._write(monkeypatch, tmp_path, "hub", {"qps": 100.0})
        self._write(monkeypatch, tmp_path, "hub", {"qps": 120.0})
        capsys.readouterr()
        hist = tmp_path / "artifacts" / "bench_history.jsonl"
        rows = [json.loads(ln) for ln in
                hist.read_text().strip().splitlines()]
        assert len(rows) == 2
        assert all(r["suite"] == "hub" and "recorded_at" in r for r in rows)
        assert rows[1]["metrics"] == [{"metric": "qps", "value": 120.0}]

    def test_diff_flags_regressions_by_direction(self, monkeypatch,
                                                 tmp_path, capsys):
        from repro_torch.launch.obs import diff_bench_history
        good = {"qps": 100.0, "hit_p99_ms": 10.0}
        bad = {"qps": 50.0, "hit_p99_ms": 20.0}      # both directions worse
        self._write(monkeypatch, tmp_path, "hub", good)
        self._write(monkeypatch, tmp_path, "hub", bad)
        capsys.readouterr()
        hist = str(tmp_path / "artifacts" / "bench_history.jsonl")
        assert diff_bench_history(hist) == 1
        out = capsys.readouterr().out
        assert out.count("REGRESSION") == 2

        # improvement (or noise inside tolerance) passes
        self._write(monkeypatch, tmp_path, "hub", good)
        capsys.readouterr()
        assert diff_bench_history(hist) == 0
        # single entry for a fresh suite: nothing to diff, not a failure
        self._write(monkeypatch, tmp_path, "sched", {"x": 1.0})
        capsys.readouterr()
        assert diff_bench_history(hist, suite="sched") == 0

    def test_diff_missing_history_fails(self, tmp_path, capsys):
        from repro_torch.launch.obs import diff_bench_history
        assert diff_bench_history(str(tmp_path / "none.jsonl")) == 1
        capsys.readouterr()



class TestServingMonitoringE2E:
    def test_scrape_health_kill_and_single_alert(self, tmp_path, capsys):
        """Server under client load + injected reader kill: the merged
        scrape exposition's p50/p99 match the loaded reader's own stats,
        the health payload shows the respawn, exactly one de-flapped SLO
        alert fires, and the --watch --once --check gate flips 0 -> 1 ->
        0 around the violation."""
        from repro_torch.autotune.registry import Registry
        from repro_torch.autotune.space import (ProgramConfig, Workload,
                                          default_config)
        from repro_torch.hub.serving.client import HubClient
        from repro_torch.hub.serving.server import HubServer
        from repro_torch.hub.store import RecordStore
        from repro_torch.launch import obs as obs_cli
        from repro_torch.obs.metrics import hist_percentile
        from repro_torch.obs.timeseries import merge_hist_states

        wl = Workload("matmul", (256, 256, 128), name="a")
        cfg = default_config(wl)
        root = str(tmp_path / "hub")
        store = RecordStore(root + "/store")
        store.put("tpu_v5e", wl,
                  ProgramConfig.make(block_m=64, block_n=128, block_k=128,
                                     k_inner=0, unroll=1, out_bf16=1),
                  50.0)
        store.flush()
        reg = Registry(path=root + "/tuned_configs.json")
        reg.put("tpu_v5e", wl, cfg, 100.0)
        shim = types.SimpleNamespace(store=store, registry=reg)
        specs = [SLOSpec("reader-respawns", "events",
                         "serve.reader_respawns", 0.0,
                         fast_window_s=2.0, slow_window_s=4.0)]

        with HubServer(root, hub=shim, readers=2, tune_on_miss=False,
                       heartbeat_s=0.05, hb_grace_s=0.5,
                       monitor_interval_s=0.1, slos=specs) as srv:
            # client load against reader index 1 only, so killing reader 0
            # later cannot lose the latency samples we compare against
            eps = srv.endpoints()
            with HubClient(root=root, endpoints=[eps[1]]) as c:
                for _ in range(40):
                    r = c.get_config("tpu_v5e", wl, tune=False)
                    assert r.source in ("registry", "cache")
                loaded_stats = c.stats()

            # wait for a post-load scrape so the merged view is current
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                snap = srv.sampler.latest()
                if snap and any(
                        k.startswith("serve.latency_seconds")
                        for k in snap.get("histograms", {})):
                    break
                time.sleep(0.05)

            metrics_reply = obs_cli._writer_call(root, "metrics")
            health = obs_cli._writer_call(root, "health")
            assert metrics_reply["ok"] and health["ok"]
            assert health["alive"] == 2 and health["respawns"] == 0
            assert "serve.latency_seconds" in metrics_reply["text"]

            # merged scrape percentiles == the loaded reader's own stats
            # (the idle reader contributes empty histograms)
            states = [st for k, st in
                      metrics_reply["snapshot"]["histograms"].items()
                      if k.startswith("serve.latency_seconds")]
            merged = merge_hist_states(states)
            assert merged["count"] == loaded_stats["hit"]["n"]
            assert hist_percentile(merged, 50) * 1e3 == pytest.approx(
                loaded_stats["hit"]["p50_ms"])
            assert hist_percentile(merged, 99) * 1e3 == pytest.approx(
                loaded_stats["hit"]["p99_ms"])

            # gate passes while healthy
            rc = obs_cli.main(["--watch", "--once", "--check",
                               "--root", root])
            capsys.readouterr()
            assert rc == 0

            # inject the reader kill
            victim = srv._readers[0]
            victim.proc.kill()
            deadline = time.monotonic() + 30
            while srv.respawns < 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert srv.respawns == 1, "watchdog never respawned the reader"

            health = obs_cli._writer_call(root, "health")
            assert health["respawns"] == 1
            assert health["respawns_by_reader"] == {"0": 1}

            # exactly ONE firing alert, held across many monitor ticks
            deadline = time.monotonic() + 15
            while not srv.slo.firing() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert srv.slo.firing() == ["reader-respawns"]
            time.sleep(0.5)                 # several more evaluations
            firing_alerts = [a for a in srv.slo.alerts
                             if a["state"] == "firing"]
            assert len(firing_alerts) == 1, srv.slo.alerts
            assert firing_alerts[0]["slo"] == "reader-respawns"

            # the gate fails while the SLO fires...
            rc = obs_cli.main(["--watch", "--once", "--check",
                               "--root", root])
            err = capsys.readouterr().err
            assert rc == 1 and "SLO firing: reader-respawns" in err

            # ...and recovers once the respawn ages out of both windows
            deadline = time.monotonic() + 30
            while srv.slo.firing() and time.monotonic() < deadline:
                time.sleep(0.1)
            assert srv.slo.firing() == [], "respawn alert never cleared"
            assert [a["state"] for a in srv.slo.alerts] == ["firing", "ok"]
            rc = obs_cli.main(["--watch", "--once", "--check",
                               "--root", root])
            capsys.readouterr()
            assert rc == 0

            # --stats surfaces the same respawn count via the health op
            from repro_torch.hub.service import TuningHub
            from repro_torch.launch.hub import print_stats
            print_stats(root, hub=TuningHub(root, torch_device="cpu"),
                        drift=False)
            out = capsys.readouterr().out
            assert "farm health: 2/2 alive, respawns=1 (rid 0: 1)" in out

        # shutdown stopped the monitor thread
        assert not any(t.name == "obs-sampler" and t.is_alive()
                       for t in threading.enumerate())

    def test_watch_once_renders_a_frame(self, tmp_path, capsys):
        from repro_torch.autotune.registry import Registry
        from repro_torch.hub.serving.server import HubServer
        from repro_torch.hub.store import RecordStore
        from repro_torch.launch import obs as obs_cli

        root = str(tmp_path / "hub")
        shim = types.SimpleNamespace(
            store=RecordStore(root + "/store"),
            registry=Registry(path=root + "/tuned_configs.json"))
        with HubServer(root, hub=shim, readers=1, tune_on_miss=False,
                       monitor_interval_s=0.1) as srv:
            deadline = time.monotonic() + 10
            while not srv.slo.statuses and time.monotonic() < deadline:
                time.sleep(0.05)
            rc = obs_cli.main(["--watch", "--once", "--root", root])
            out = capsys.readouterr().out
        assert rc == 0
        assert "hub serving" in out and "readers=1/1 alive" in out
        assert "latency p50" in out and "SLO:" in out


# --- across packages -------------------------------------------------------


def _snapshot_sequence():
    """Twelve merged-farm snapshots: steady hits, a burst of slow misses,
    a respawn (counters dip), then recovery."""
    reg = MetricsRegistry()
    snaps = []
    for step in range(12):
        n = 20 if step != 5 else 3            # step 5: a reader restarted
        for i in range(n):
            reg.counter("serve.requests").inc()
            reg.histogram("serve.latency_seconds",
                          path="hit").observe(0.0005 * (1 + i % 7))
        if 3 <= step <= 6:
            for _ in range(4):
                reg.histogram("serve.latency_seconds",
                              path="miss").observe(2.0)
        if step == 5:
            reg.counter("serve.reader_respawns", reader="0").inc()
            reg.counter("serve.errors").inc(2)
        snap = reg.snapshot()
        if step == 5:                          # the respawned reader's dip
            snap = json.loads(json.dumps(snap))
            snap["counters"]["serve.requests"] -= 50
        snaps.append(json.loads(json.dumps(snap)))
    return snaps


def test_sampler_and_slos_agree_across_packages():
    from repro.obs.slo import SLOEvaluator as JEvaluator
    from repro.obs.slo import default_serving_slos as j_slos
    from repro.obs.timeseries import TimeSeriesSampler as JSampler

    snaps = _snapshot_sequence()
    sides = []
    for sampler_cls, evaluator_cls, slos in (
            (TimeSeriesSampler, SLOEvaluator, default_serving_slos),
            (JSampler, JEvaluator, j_slos)):
        clock = Clock()
        it = iter(snaps)
        sampler = sampler_cls(source=lambda: next(it), clock=clock)
        ev = evaluator_cls(slos(p99_ceiling_s=0.5, fast_window_s=10.0,
                                slow_window_s=20.0), sampler)
        rows = []
        for _ in snaps:
            clock.advance(5.0)
            sampler.sample_now()
            statuses = ev.evaluate(now=clock())
            rows.append({
                "rate": sampler.rate("serve.requests", 10.0),
                "p50": sampler.percentile("serve.latency_seconds", 50, 20.0),
                "p99": sampler.percentile("serve.latency_seconds", 99, 20.0),
                "statuses": [st.to_dict() for st in statuses]})
        sides.append((json.loads(json.dumps(rows)), list(ev.alerts),
                      ev.firing()))
    (mine, mine_alerts, mine_firing), (ref, ref_alerts, ref_firing) = sides
    assert mine == ref
    assert mine_alerts == ref_alerts and mine_firing == ref_firing
    # the sequence exercised transitions both ways
    assert {a["state"] for a in ref_alerts} == {"firing", "ok"}
    assert {a["slo"] for a in ref_alerts} >= {"serve-p99", "reader-respawns"}


def _flight_record(path: str, scale: float) -> None:
    """A campaign's artifacts written by the port's FlightRecorder: spans
    over the taxonomy, grants, calibration, a result and a warning."""
    from repro_torch.obs import FlightRecorder, get_logger, span
    from repro_torch.obs import metrics as obs_metrics
    key = "tpu_v5e|matmul:256x256x128"
    with FlightRecorder(path) as rec:
        with span("campaign", device="tpu_v5e"):
            for step in range(3):
                with span("tune.round", step=step):
                    with span("round.search"):
                        time.sleep(0.002 * scale)
                    with span("round.measure"):
                        time.sleep(0.003 * scale)
                    with span("round.update"):
                        time.sleep(0.001)
                rec.event("grant", step=step, key=key, reason="gradient",
                          measured=8, spent_seconds=1.5 * (step + 1))
            reg = obs_metrics.current()
            for i in range(10):
                reg.histogram("calib.residual").observe(0.1 * (i + 1))
            reg.counter("calib.topk", result="hit").inc(3)
            reg.counter("calib.topk", result="miss").inc(1)
            reg.counter("tune.measurements").inc(int(24 * scale))
            get_logger("sched").warning("slow worker", worker=2)
            rec.event("calibration", summary={key: {
                "rounds": 3, "n_points": 24, "rank_accuracy": 0.75,
                "mean_abs_residual": 0.31, "topk_hits": 3, "topk_misses": 1,
                "mean_topk_regret": 0.0125, "draft_acceptance": 0.5}})
            rec.event("campaign_result", measurements=int(24 * scale),
                      best_latency_s=0.00123)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Two flight records, a hub root the port's `launch.hub --smoke
    --refresh` tuned (provenance and refresh log), and a bench history."""
    from repro_torch.launch import hub as launch_hub
    base = tmp_path_factory.mktemp("obs")
    a, b = str(base / "run_a"), str(base / "run_b")
    _flight_record(a, 1.0)
    _flight_record(b, 2.0)
    root = str(base / "hub")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert launch_hub.run_smoke(root, refresh=True,
                                    torch_device="cpu") == 0
    finally:
        torch.set_num_threads(n)
    history = str(base / "bench_history.jsonl")
    with open(history, "w") as f:
        for sha, qps, p99 in (("a" * 40, 100.0, 10.0), ("b" * 40, 80.0, 9.0)):
            f.write(json.dumps({"suite": "hub", "git_sha": sha,
                                "timestamp": "2026-01-01T00:00:00",
                                "metrics": [
                                    {"metric": "qps", "value": qps},
                                    {"metric": "hit_p99_ms", "value": p99}]})
                    + "\n")
    return {"a": a, "b": b, "root": root, "history": history}


def _both(argv, capsys):
    """(rc, stdout, stderr) of the port's and the reference's CLI."""
    from repro.launch import obs as j_obs
    from repro_torch.launch import obs as t_obs
    out = []
    for cli in (t_obs, j_obs):
        rc = cli.main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


@pytest.mark.parametrize("flag", ["summarize", "check", "export", "diff",
                                  "diff-history", "report", "explain"])
def test_launch_obs_prints_what_the_reference_prints(flag, artifacts,
                                                     capsys):
    a, b, root = artifacts["a"], artifacts["b"], artifacts["root"]
    argv = {"summarize": ["--summarize", a], "check": ["--check", a],
            "export": ["--export", a, "--out",
                       os.path.join(a, "export.json")],
            "diff": ["--diff", a, b],
            "diff-history": ["--diff", "--history", artifacts["history"]],
            "report": ["--report", a, "--root", root],
            "explain": ["--explain", "tpu_v5e_pro", "256x256",
                        "--root", root]}[flag]
    if flag == "report":
        # both write report.md / report.json next to the artifacts
        (mine, ref) = _both(argv, capsys)
        assert mine == ref
        assert "## Refresh decisions" in mine[1]
        assert "## Winner provenance" in mine[1]
        assert mine[0] == 0
        return
    mine, ref = _both(argv, capsys)
    assert mine == ref
    want_rc = 1 if flag == "diff-history" else 0     # qps fell by 20%
    assert mine[0] == want_rc, mine
    assert mine[1].strip()


def test_launch_obs_explain_asks_a_live_writer(artifacts, capsys):
    """With a farm up, both CLIs take the writer's answer; after shutdown
    both fall back to the shards and the registry file, and tell the same
    story."""
    from repro_torch.hub.serving.server import HubServer
    from repro_torch.hub.service import TuningHub
    root = artifacts["root"]
    argv = ["--explain", "tpu_v5e_pro", "256x256", "--root", root]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        hub = TuningHub(root, torch_device="cpu")
        with HubServer(root, hub=hub, readers=1, monitor=False):
            live = _both(argv, capsys)
    finally:
        torch.set_num_threads(n)
    disk = _both(argv, capsys)
    assert live[0] == live[1] and live[0][0] == 0
    assert "- registry serves:" in live[0][1]
    assert disk[0] == disk[1] == live[0]


def test_launch_obs_loads_no_torch(artifacts):
    """`python -m repro_torch.launch.obs` imports no torch (read off
    `-X importtime`, which lists every module a run imports)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.launch.obs",
         "--check", artifacts["a"]], env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "check OK" in proc.stdout
    imported = [ln.rsplit("|", 1)[-1].strip()
                for ln in proc.stderr.splitlines()
                if ln.startswith("import time:")]
    assert {"repro_torch.launch", "repro_torch.obs.recorder"} <= set(imported)
    assert "torch" not in imported and "numpy" in imported
