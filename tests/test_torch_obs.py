"""The port's telemetry (`repro_torch.obs`: trace, recorder, logger,
calibration) against the reference's, from the inputs of tests/test_obs.py
and tests/test_calibration.py.

  * The same span script in both packages gives the same event names and
    the same parent/child tree, and both `validate_events` accept either
    package's events.
  * `summarize_trace` and the calibration tracker give equal summaries and
    equal registry snapshots on the same inputs.
  * The port's `run_campaign(obs=...)` leaves the flight recorder's two
    artifacts, a single-rooted trace attributing >= 95% of its wall time,
    and the same tuning result as an uninstrumented run.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import FlightRecorder as JRecorder  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import summarize_trace as j_summarize  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro.obs import validate_events as j_validate  # noqa: E402
from repro.obs.calibration import CalibrationTracker as JTracker  # noqa: E402
from repro.obs.calibration import pair_concordance as j_pairs  # noqa: E402
from repro_torch.autotune.space import Workload  # noqa: E402
from repro_torch.configs.moses import DEFAULT as MCFG  # noqa: E402
from repro_torch.obs import (FlightRecorder, MetricsRegistry,  # noqa: E402
                             Tracer, get_logger, remote_event,
                             summarize_trace, validate_events)
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.calibration import (CalibrationTracker,  # noqa: E402
                                         pair_concordance)
from repro_torch.sched import run_campaign  # noqa: E402

TINY_CFG = dataclasses.replace(
    MCFG, online_epochs=2, adaptation_epochs=2, population_size=32,
    evolution_rounds=2, top_k_measure=8)
JOBS = [("tpu_v5e", [Workload("matmul", (256, 256, 128), name="a"),
                     Workload("scan", (1024, 512), name="s")])]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    machine's cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# trace spans
# ---------------------------------------------------------------------------


def _span_script(trace_mod, tracer_cls, fail: bool = False):
    """The campaign-shaped span tree of tests/test_obs.py, plus a remote
    (farm-worker) event under each round.measure; `fail` raises inside the
    second round. Returns the tracer's events."""
    tr = tracer_cls()
    trace_mod.activate(tr)
    try:
        with trace_mod.span("campaign", strategy="s"):
            for i in range(2):
                with trace_mod.span("tune.round", step=i + 1):
                    with trace_mod.span("round.search"):
                        pass
                    with trace_mod.span("round.measure", n=4):
                        ctx = trace_mod.current_context()
                        tr.add_events([trace_mod.remote_event(
                            "exec.measure", ctx, 0.0, 0.001, worker="p1",
                            seq=i)])
                        if fail and i == 1:
                            raise ValueError("boom")
                    with trace_mod.span("round.update"):
                        pass
    except ValueError:
        pass
    finally:
        trace_mod.deactivate(tr)
    return tr.events


def _tree(events):
    """Sorted (name, parent name, status) triples: the span tree without
    its ids and times."""
    by_id = {e["args"]["span_id"]: e["name"] for e in events}
    return sorted((e["name"], by_id.get(e["args"]["parent_id"]),
                   e["args"]["status"]) for e in events)


@pytest.mark.parametrize("fail", [False, True], ids=["ok", "raises"])
def test_span_script_gives_the_same_tree(fail):
    mine = _span_script(obs_trace, Tracer, fail)
    ref = _span_script(j_trace, JTracer, fail)
    assert _tree(mine) == _tree(ref)
    assert [e["name"] for e in mine] == [e["name"] for e in ref]
    for events in (mine, ref):
        assert validate_events(events, expect_root="campaign") == []
        assert j_validate(events, expect_root="campaign") == []
    assert set(mine[0]) == set(ref[0])
    assert set(mine[0]["args"]) == set(ref[0]["args"])
    if fail:
        errors = {e["name"] for e in mine if e["args"]["status"] == "error"}
        assert errors == {"campaign", "tune.round", "round.measure"}


def test_noop_span_without_tracer():
    assert obs_trace.current_tracer() is None
    s = obs_trace.span("tune.round", device="d")
    assert s is obs_trace.NOOP_SPAN
    with s:
        assert obs_trace.current_context() is None


def test_validate_catches_orphans_and_double_roots():
    events = _span_script(obs_trace, Tracer)
    orphan = remote_event("x", (events[0]["args"]["trace_id"], "missing"),
                          0.0, 0.0)
    second_root = remote_event("y", None, 0.0, 0.0)
    for validate in (validate_events, j_validate):
        assert any("orphan" in p for p in validate(events + [orphan]))
        assert any("1 root" in p for p in validate(events + [second_root]))
        assert validate([]) == ["no span events"]
    assert validate_events(events + [orphan]) == j_validate(events + [orphan])


def test_summarize_trace_matches_the_reference():
    events = _span_script(obs_trace, Tracer)
    reg = MetricsRegistry()
    reg.histogram("exec.queue_wait_seconds", backend="thread").observe(0.002)
    reg.counter("exec.measure_seconds_total").inc(1.25)
    mine = summarize_trace(events, registry_json=reg.to_json())
    ref = j_summarize(events, registry_json=reg.to_json())
    assert mine == ref
    assert mine["problems"] == [] and mine["root"] == "campaign"
    assert set(mine["categories_s"]) >= {"measure", "search", "update",
                                         "overhead"}
    assert summarize_trace([]) == j_summarize([])


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_recorder_artifacts_and_log_sink(tmp_path):
    root = str(tmp_path / "obs")
    with FlightRecorder(root) as rec:
        assert obs_metrics.current() is rec.registry
        with obs_trace.span("campaign"):
            obs_metrics.current().counter("sched.grants",
                                          reason="warmup").inc()
        rec.event("grant", step=1, key="d|t")
        get_logger("test-torch-obs").warning("something odd", code=7)
    lines = [json.loads(ln) for ln in
             open(os.path.join(root, "events.jsonl"))]
    kinds = [e["kind"] for e in lines]
    assert kinds[0] == "recorder_start" and kinds[-1] == "recorder_stop"
    assert "grant" in kinds
    assert any(e["kind"] == "log" and e["msg"] == "something odd"
               and e["code"] == 7 for e in lines)
    snap = next(e for e in lines if e["kind"] == "metrics")["snapshot"]
    assert snap["counters"]["sched.grants{reason=warmup}"] == 1
    doc = json.load(open(os.path.join(root, "campaign.trace.json")))
    assert validate_events(doc["traceEvents"], expect_root="campaign") == []
    assert j_validate(doc["traceEvents"], expect_root="campaign") == []
    assert obs_metrics.current() is not rec.registry
    assert obs_trace.current_tracer() is None


def test_recorders_write_the_same_event_kinds(tmp_path):
    """One scripted session through each package's recorder: the same
    event kinds in the same order, and the same metrics snapshot."""
    out = {}
    for name, rec_cls, trace_mod, metrics_mod in (
            ("mine", FlightRecorder, obs_trace, obs_metrics),
            ("ref", JRecorder, j_trace, j_metrics)):
        root = str(tmp_path / name)
        with rec_cls(root):
            with trace_mod.span("campaign"):
                metrics_mod.current().counter("sched.grants",
                                              reason="gradient").inc(3)
                metrics_mod.current().histogram(
                    "exec.queue_wait_seconds", backend="thread").observe(0.01)
        lines = [json.loads(ln) for ln in
                 open(os.path.join(root, "events.jsonl"))]
        out[name] = ([e["kind"] for e in lines],
                     next(e for e in lines if e["kind"] == "metrics")[
                         "snapshot"])
    assert out["mine"] == out["ref"]


# ---------------------------------------------------------------------------
# logger
# ---------------------------------------------------------------------------


def test_logger_level_control_via_env(monkeypatch, capsys):
    lg = get_logger("test-torch-obs-log")
    monkeypatch.setenv("REPRO_LOG_LEVEL", "warning")
    lg.info("hidden", a=1)
    lg.warning("shown", path="/x y", n=0.5)
    err = capsys.readouterr().err
    assert "hidden" not in err
    assert "[test-torch-obs-log] WARNING: shown" in err
    assert "path='/x y'" in err and "n=0.5" in err
    monkeypatch.setenv("REPRO_LOG_JSON", "1")
    lg.error("as json", k="v")
    rec = json.loads(capsys.readouterr().err.strip())
    assert rec["level"] == "error" and rec["msg"] == "as json"
    assert rec["k"] == "v" and rec["logger"] == "test-torch-obs-log"
    monkeypatch.setenv("REPRO_LOG_LEVEL", "off")
    lg.error("muted")
    assert capsys.readouterr().err == ""


def test_logger_quiet_under_pytest_and_cached(monkeypatch, capsys):
    monkeypatch.delenv("REPRO_LOG_LEVEL", raising=False)
    get_logger("test-torch-obs-log").info("invisible in tests")
    assert capsys.readouterr().err == ""
    assert get_logger("same") is get_logger("same")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pred,meas", [
    ([1.0, 2.0, 3.0], [10.0, 20.0, 30.0]),
    ([-1.0, -2.0, -3.0], [10.0, 20.0, 30.0]),
    ([1.0, 2.0, 3.0], [5.0, 5.0, 9.0]),
    ([1.0, 1.0], [5.0, 9.0])])
def test_pair_concordance_matches_the_reference(pred, meas):
    pred, meas = np.array(pred), np.array(meas)
    assert pair_concordance(pred, meas) == j_pairs(pred, meas)


def _calibration_script(tracker):
    recs = [tracker.observe_round("tpu_v5e", "matmul:256x256x128", 0,
                                  [0.1, 0.9, 0.5], [10.0, 30.0, 20.0]),
            tracker.observe_round("d", "t", 0, [0.9, 0.1, 0.2],
                                  [10.0, 40.0, 20.0]),
            tracker.observe_round("d", "t", 1, [], []),
            tracker.observe_round("d", "t", 1, [1.0], [1.0, 2.0]),
            tracker.observe_round("dev{x=1},bad", "task\nnewline", 0,
                                  [0.1, 0.9], [1.0, 2.0])]
    rng = np.random.RandomState(3)
    for i in range(4):
        recs.append(tracker.observe_round("d", "t", 2 + i, rng.rand(8),
                                          rng.rand(8) * 100))
    for a in (1.0, float("nan"), 0.5):
        tracker.observe_acceptance("d", "t", a)
    return recs


def test_calibration_tracker_matches_the_reference():
    reg, jreg = MetricsRegistry(), j_metrics.MetricsRegistry()
    mine = CalibrationTracker(registry=reg, top_k=2)
    ref = JTracker(registry=jreg, top_k=2)
    assert _calibration_script(mine) == _calibration_script(ref)
    assert mine.summary() == ref.summary()
    assert len(mine) == len(ref) == 3
    assert reg.snapshot() == jreg.snapshot()
    d = mine.per_task("tpu_v5e", "matmul:256x256x128")
    assert d["rank_accuracy"] == pytest.approx(1.0)
    assert d["topk_hits"] == 1 and d["draft_acceptance"] is None
    assert mine.per_task("d", "t")["draft_batches"] == 2
    for key in reg.snapshot()["counters"]:
        assert "\n" not in key


# ---------------------------------------------------------------------------
# the port's campaign under the recorder
# ---------------------------------------------------------------------------


def test_campaign_obs_end_to_end(tmp_path):
    root = str(tmp_path / "obs")
    result = run_campaign(JOBS, TINY_CFG, strategy="ansor-random",
                          trials_per_task=8, obs=root, torch_device="cpu")
    s = result.obs_summary
    assert s is not None and s["problems"] == []
    assert s["root"] == "campaign"
    assert s["attributed_pct"] >= 95.0
    assert s["error_spans"] == 0
    assert s["by_name"]["exec.measure"]["n"] == result.total_measurements
    assert s["queue_wait"]["n"] == result.total_measurements
    assert s["measure_seconds_simulated"] == \
        pytest.approx(result.measured_seconds, abs=5e-4)
    events = [json.loads(ln) for ln in
              open(os.path.join(root, "events.jsonl"))]
    grants = [e for e in events if e["kind"] == "grant"]
    assert len(grants) == len(result.trace)
    assert any(e["kind"] == "campaign_result" for e in events)
    doc = json.load(open(os.path.join(root, "campaign.trace.json")))
    assert j_validate(doc["traceEvents"], expect_root="campaign") == []
    bare = run_campaign(JOBS, TINY_CFG, strategy="ansor-random",
                        trials_per_task=8, torch_device="cpu")
    assert bare.curve() == result.curve()


def test_recorder_ownership_semantics(tmp_path):
    """A caller-started recorder survives the campaigns it is passed to;
    two campaigns put two roots in its one timeline."""
    jobs = [("tpu_v5e", [Workload("matmul", (256, 256, 128), name="a")])]
    rec = FlightRecorder(str(tmp_path / "mine")).start()
    try:
        for _ in range(2):
            run_campaign(jobs, TINY_CFG, strategy="ansor-random",
                         trials_per_task=8, obs=rec, torch_device="cpu")
            assert not rec._stopped
        assert len([e for e in rec.tracer.events
                    if e["name"] == "campaign"]) == 2
    finally:
        rec.stop()
    assert rec._stopped
