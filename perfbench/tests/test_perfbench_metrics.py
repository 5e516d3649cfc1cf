"""The metric readers and the trace reduction against a recorded fake
trace and hand-worked numbers."""
import numpy as np
import pytest

from perfbench import counts, harness, peaks, spec, trace

DTOH = "Memcpy DtoH (Device -> Pageable)"
EVENTS = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 5, "dur": 20},
    {"ph": "X", "cat": "gpu_memcpy", "name": DTOH, "ts": 30, "dur": 2},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 33, "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "attn", "ts": 40, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 55, "dur": 3},
    {"ph": "X", "cat": "gpu_memcpy", "name": DTOH, "ts": 60, "dur": 2},
    {"ph": "i", "cat": "cpu_instant_event", "name": "x", "ts": 70},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "ts": 1, "dur": 1},
]


def test_trace_reduction():
    r = trace.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(62e-6)
    assert r["busy_s"] == pytest.approx(37e-6)
    assert r["parts"]["prefill"]["idle_pct"] == pytest.approx(
        100 * (1 - 22 / 32))
    assert r["parts"]["decode"]["idle_pct"] == pytest.approx(50.0)
    ops = dict((k, v) for k, v in r["device_ops"])
    assert ops["gemm"] == pytest.approx(23e-6)
    assert ops[DTOH] == pytest.approx(4e-6)
    gaps = dict((k, v) for k, v in r["idle_gaps"])
    assert gaps == pytest.approx({"aten::copy_": 13e-6, "aten::mm": 5e-6,
                                  "host (between ops)": 7e-6})
    assert trace.reduce([e for e in EVENTS if e["cat"] == "cpu_op"]) is None


RUN = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
       "head_dim": 4, "d_ff": 16, "vocab_size": 10}


def _observed():
    p = [np.ones(3, np.int32), np.ones(5, np.int32)]
    waves = [harness.Wave(p, [4, 2], [[1, 2, 3, 4], [5, 6]], 2.0),
             harness.Wave(p, [4, 2], [[1, 2, 3, 4], [5, 6]], 3.0)]
    return harness.Observed(
        run=RUN, batch_slots=2, setup_s=7.5, window_s=5.0, waves=waves,
        step_seconds={"count": 6, "total": 0.6},
        prefill_seconds={"count": 2, "total": 0.4},
        split={"enqueue": [0.09, 0.08, 0.1], "wall": [0.1, 0.1, 0.2]},
        trace=trace.reduce(EVENTS))


def test_readers_on_hand_worked_numbers():
    o = _observed()
    read = lambda name: spec.reader(name)(o)  # noqa: E731
    assert read("setup_s") == 7.5
    assert read("output_tokens_per_s") == pytest.approx(12 / 5.0)
    assert read("request_latency_p95_s") == 3.0
    # decode tokens (3 + 1) a wave over 6 steps * 2 slots
    assert read("slot_occupancy_pct.decode") == pytest.approx(100 * 8 / 12)
    assert read("decode_step_ms.decode") == pytest.approx(100.0)
    assert read("prefill_s.prefill") == pytest.approx(0.2)
    assert read("decode_enqueue_pct.decode") == pytest.approx(90.0)
    # request (3 prompt, 3 decode tokens): contexts 4, 5, 6; (5, 1): 6
    flops = 2 * sum(counts.decode_token_flops(RUN, c) for c in (4, 5, 6, 6))
    assert read("decode_mfu_pct.decode") == pytest.approx(
        100 * flops / 0.6 / peaks.BF16_FLOPS)
    least = 6 * counts.decode_step_bytes(RUN, 2, []) + 2 * 21 * \
        counts.kv_bytes_per_position(RUN)
    assert read("decode_hbm_roofline_pct.dense") == pytest.approx(
        100 * least / peaks.HBM_BYTES_PER_S / 0.6)
    pf = 2 * (counts.prefill_flops(RUN, 3) + counts.prefill_flops(RUN, 5))
    assert read("prefill_mfu_pct.prefill") == pytest.approx(
        100 * pf / 0.4 / peaks.BF16_FLOPS)
    assert read("device_idle_pct.decode") == pytest.approx(50.0)
    assert read("device_idle_pct.prefill") == pytest.approx(
        100 * (1 - 22 / 32))


def test_the_step_split_runs_where_a_cells_metric_needs_it():
    """The harness times the step split in a traced run of a cell whose
    per-layer metrics need it (`NEEDS`), and only there."""
    b = spec.benchmark()
    split = {w["name"]: any("split" in spec.needs(m["name"])
                            for m in spec.metrics_of(b, w["name"], True))
             for w in b["workloads"]}
    assert split == {"glm4-9b.chat": True, "deepseek-v3-671b.chat": True,
                     "glm4-9b.longprompt": False}
    assert spec.needs("decode_step_ms.decode") == ()


def test_readers_without_their_inputs_report_nothing():
    o = _observed()
    o.split, o.trace = None, None
    o.step_seconds = {"count": 0, "total": 0.0}
    for name in ("decode_enqueue_pct.decode", "device_idle_pct.decode",
                 "device_idle_pct.prefill", "decode_mfu_pct.decode",
                 "slot_occupancy_pct.decode", "decode_step_ms.decode"):
        assert spec.reader(name)(o) is None
    o.run = dict(RUN, moe={"num_experts": 4})
    assert spec.reader("decode_hbm_roofline_pct.dense")(o) is None
