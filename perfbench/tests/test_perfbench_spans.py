"""`perfbench.spans` against a hand-built Kineto-style trace and
hand-worked numbers, and the tracer it makes for a profiled run."""
import pytest
import torch

from perfbench import spans, trace

DTOH = "Memcpy DtoH (Device -> Pageable)"
MAIN, STREAM = (1, 1), (1, 7)


def _range(name, ts, dur, thread=MAIN, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": thread[0], "tid": thread[1]}


def _launch(corr, ts, cat="cuda_runtime", name="cudaLaunchKernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 0.2,
            "pid": MAIN[0], "tid": MAIN[1], "args": {"correlation": corr}}


def _device(corr, ts, dur, name="kernel", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": STREAM[0], "tid": STREAM[1],
            "args": {"correlation": corr}}


# (name, start, end, span id, parent id) of the program's spans: one
# wave, its prefill and one decode step
SPANS = [
    ("serve.generate", 0, 100, "s1", None),
    ("serve.wave", 1, 99, "s2", "s1"),
    ("serve.prefill", 2, 40, "s3", "s2"),
    ("model.prefill", 3, 35, "s4", "s3"),
    ("block.attention", 4, 20, "s5", "s4"),
    ("block.mlp", 20, 30, "s6", "s4"),
    ("serve.sample", 36, 39, "s7", "s3"),
    ("serve.decode_step", 44, 95, "s8", "s2"),
    ("model.decode_step", 46, 80, "s9", "s8"),
    ("block.attention", 47, 64, "s10", "s9"),
    ("attn.cache_write", 48, 57, "s11", "s10"),
    ("block.moe", 66, 78, "s12", "s9"),
    ("stack.restack", 78.5, 79.5, "s13", "s9"),
    ("serve.sample", 82, 90, "s14", "s8"),
]
MOE_ATTRS = {"s12": dict(assignments=128, dropped=30, experts_used=100,
                         experts_run=256)}


def _program_events():
    out = []
    for name, s, e, sid, parent in SPANS:
        args = dict(MOE_ATTRS.get(sid, {}), span_id=sid, parent_id=parent,
                    trace_id="t", status="ok")
        out.append({"name": name, "cat": "repro", "ph": "X", "ts": s,
                    "dur": e - s, "pid": 1, "tid": 1, "args": args})
    # a block.moe under the prefill: not a decode step's
    out.append({"name": "block.moe", "cat": "repro", "ph": "X", "ts": 0,
                "dur": 0, "pid": 1, "tid": 1,
                "args": dict(assignments=9, dropped=9, experts_used=9,
                             experts_run=9, span_id="s99", parent_id="s3",
                             trace_id="t", status="ok")})
    return out


EVENTS = [_range(name, s, e - s) for name, s, e, _, _ in SPANS] + [
    # not the program's: a profiler range, the device-side copy of a range
    _range("ProfilerStep#0", 0, 100),
    _range("block.attention", 4, 16, thread=STREAM,
           cat="gpu_user_annotation"),
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 2, "dur": 1,
     "pid": 1, "tid": 1},
    # prefill: attention, the MLP, the sampled tokens' copy
    _launch(1, 5), _device(1, 6, 10, "attn"),
    _launch(2, 21), _device(2, 22, 6, "gemm"),
    _launch(3, 37, name="cudaMemcpyAsync"),
    _device(3, 38, 2, DTOH, "gpu_memcpy"),
    # decode: the cache write, attention, an expert launched through the
    # driver, the restack, the sampled tokens' copy
    _launch(4, 49), _device(4, 50, 4, "copy"),
    _launch(5, 57.5), _device(5, 58, 2, "attn"),
    _launch(6, 67, cat="cuda_driver", name="cuLaunchKernel"),
    _device(6, 70, 6, "bmm"),
    _launch(7, 79), _device(7, 79, 1, "stack"),
    _launch(8, 83, name="cudaMemcpyAsync"),
    _device(8, 86, 2, DTOH, "gpu_memcpy"),
    # under serve.generate alone, and with no launch in the trace
    _launch(9, 99.5), _device(9, 99.6, 0.2, "tail"),
    _device(10, 1, 0.5, "orphan"),
]


def _reduced():
    return spans.reduce(_program_events(), EVENTS)


def test_device_time_goes_to_the_span_that_launched_it():
    r = _reduced()
    pre, dec = r["prefill"], r["decode"]
    assert pre["device_s"] == pytest.approx(18e-6)
    assert pre["device_self"] == pytest.approx(
        {"block.attention": 10e-6, "block.mlp": 6e-6, "serve.sample": 2e-6})
    assert pre["device_in"] == pytest.approx(
        {"serve.generate": 18e-6, "serve.wave": 18e-6,
         "serve.prefill": 18e-6, "model.prefill": 16e-6,
         "block.attention": 10e-6, "block.mlp": 6e-6,
         "serve.sample": 2e-6})
    assert dec["device_s"] == pytest.approx(15e-6)
    assert dec["device_self"] == pytest.approx(
        {"attn.cache_write": 4e-6, "block.attention": 2e-6,
         "block.moe": 6e-6, "stack.restack": 1e-6, "serve.sample": 2e-6})
    assert dec["device_in"]["block.attention"] == pytest.approx(6e-6)
    assert r["other"]["device_self"] == pytest.approx({"serve.generate":
                                                       0.2e-6})
    assert r["unattributed_device_s"] == pytest.approx(0.5e-6)


def test_idle_gaps_go_to_the_span_open_at_their_midpoint():
    r = _reduced()
    whole = trace.reduce(EVENTS)["parts"]
    for part, secs in (("prefill", 20.5e-6), ("decode", 33e-6)):
        p = whole[part]
        assert r[part]["idle_s"] == pytest.approx(secs)
        assert r[part]["idle_s"] == pytest.approx(
            p["span_s"] * p["idle_pct"] / 100)
    assert r["prefill"]["idle_self"] == pytest.approx(
        {"model.prefill": 14.5e-6, "block.attention": 6e-6})
    # gaps at 45 (the step's own loop), 56 (inside the cache write),
    # 65 (the model step), 77.5 (the MoE), 83 (sampling)
    assert r["decode"]["idle_self"] == pytest.approx(
        {"serve.decode_step": 10e-6, "attn.cache_write": 4e-6,
         "model.decode_step": 10e-6, "block.moe": 3e-6,
         "serve.sample": 6e-6})
    assert r["decode"]["idle_in"]["block.attention"] == pytest.approx(4e-6)


def test_fast_ranges_read_the_same_and_leave_the_trace_reduction_as_it_was():
    """`_RecordFunctionFast` ranges are `cpu_op` events: `split` takes
    them out of what `perfbench.trace` reads, and they put the work down
    as `record_function`'s `user_annotation` ranges do."""
    program = _program_events()
    names = {e["name"] for e in program}
    fast = [dict(e, cat="cpu_op") if e["cat"] == "user_annotation"
            and e["name"] in names else e for e in EVENTS]
    ranges, rest = spans.split(fast, program)
    assert len(ranges) == len(SPANS)
    assert trace.reduce(rest) == trace.reduce(EVENTS)
    assert spans.reduce(program, fast) == _reduced()
    assert spans.split(fast, []) == ([], fast)


def test_moe_counts_are_the_decode_steps_own():
    assert _reduced()["moe"] == {"assignments": 128, "dropped": 30,
                                 "experts_used": 100, "experts_run": 256}


def test_nothing_to_put_down_without_ranges_or_device_work():
    program = _program_events()
    assert spans.reduce(program, [e for e in EVENTS
                                  if e["cat"] != "user_annotation"]) is None
    assert spans.reduce(program, [e for e in EVENTS
                                  if e["cat"] == "user_annotation"]) is None
    assert spans.reduce([], EVENTS) is None
    no_moe = [e for e in program if e["name"] != "block.moe"]
    assert spans.reduce(no_moe, EVENTS)["moe"] is None


def test_no_tracer_for_a_program_whose_spans_cannot_reach_the_profiler(
        monkeypatch):
    from repro_torch.obs import trace as obs_trace

    class Plain:  # a Tracer without `annotate`
        def __init__(self, trace_id=None):
            pass
    assert spans.program_tracer().annotate is \
        torch._C._profiler._RecordFunctionFast
    monkeypatch.setattr(obs_trace, "Tracer", Plain)
    assert spans.program_tracer() is None


def test_a_profiled_generate_exports_every_span_as_a_range(tmp_path):
    """A tiny model served under torch.profiler with `program_tracer()`
    active: the exported trace holds one range for every span the tracer
    recorded, and `split` takes exactly those out."""
    import collections
    import json

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from perfbench import harness, weights
    from perfbench.tests import tiny
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.engine import Engine, Request

    model = harness.build(tiny.glm())
    params = weights.make(model.abstract_params_and_axes()[0], 3,
                          torch.device("cpu"))
    engine = Engine(model, params, max_len=16, batch_slots=2,
                    profile_kernels=False)
    reqs = [Request(prompt=np.arange(1, 9, dtype=np.int32),
                    max_new_tokens=3, temperature=0.0) for _ in range(2)]
    tracer = spans.program_tracer()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            obs_trace.activate(tracer)
            try:
                engine.generate(reqs)
            finally:
                obs_trace.deactivate(tracer)
    finally:
        torch.set_num_threads(n)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    program = tracer.events
    ranges, rest = spans.split(events, program)
    assert collections.Counter(e["name"] for e in ranges) == \
        collections.Counter(e["name"] for e in program)
    assert {"serve.generate", "serve.prefill", "serve.decode_step",
            "block.attention", "attn.cache_write"} <= {e["name"]
                                                       for e in program}
    assert len(ranges) + len(rest) == len(events)
    assert obs_trace.current_tracer() is None
