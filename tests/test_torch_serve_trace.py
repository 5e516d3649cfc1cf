"""Spans inside the port's serving path (`repro_torch.obs.trace` in
`serve/engine.py`, `models/model.py`, `transformer.py`, `attention.py`,
`moe.py`), the engine's first-token histogram and the serve launcher's
`--trace`, on the CPU at smoke size.

  * Served under an active `Tracer`, a dense and an MoE model leave one
    well-formed span tree rooted at `serve.generate`, every span under
    the parent the engine and the model give it.
  * The MoE block's routing counts equal a hand count from the router's
    `idx` and `capacity()`, and a decode step at C = 1 drops.
  * Served tokens are the same with the tracer on and off; with none, no
    span is made and no annotation entered.
  * With no tracer, `attention_decode`, `mla_decode` and
    `moe_forward_scatter` dispatch exactly the ops they did before the
    spans (the counts below), so tracing off adds no kernel, reduction or
    host synchronisation.
"""
import collections
import contextlib
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import Engine, Request

# The ops (aten names, every level) one call dispatches with no tracer,
# counted on the code before it had spans: a dense GQA decode step, an
# MLA decode step and the MoE capacity scatter, at smoke size (B = 2).
ATTENTION_DECODE = {
    "__and__": 1, "_index_put_impl_": 3, "_to_copy": 24, "_unsafe_view": 2,
    "add": 2, "amax": 1, "arange": 10, "as_strided": 75, "bitwise_and": 1,
    "bmm": 6, "cat": 2, "chunk": 2, "clone": 5, "copy_": 29, "cos": 2,
    "div": 3, "einsum": 6, "empty": 10, "empty_like": 2, "empty_strided": 27,
    "eq": 2, "exp": 1, "fill_": 2, "ge": 1, "index_put_": 3, "le": 1,
    "mul": 13, "narrow": 4, "permute": 30, "pow": 4, "reciprocal": 2,
    "remainder": 1, "reshape": 22, "resize_": 5, "resolve_conj": 12,
    "result_type": 2, "scalar_tensor": 3, "select": 3, "sin": 2, "slice": 4,
    "split": 2, "sub": 3, "sum": 1, "to": 34, "unsqueeze": 33, "view": 32,
    "where": 6}
MLA_DECODE = {
    "__and__": 1, "_index_put_impl_": 3, "_reshape_alias": 7, "_to_copy": 32,
    "_unsafe_view": 3, "add": 5, "amax": 1, "arange": 10, "as_strided": 102,
    "bitwise_and": 1, "bmm": 7, "cat": 2, "chunk": 2, "clone": 4,
    "copy_": 36, "cos": 2, "div": 3, "div_": 2, "einsum": 7, "empty": 7,
    "empty_like": 1, "empty_strided": 35, "exp": 1, "fill_": 4, "ge": 1,
    "index_put_": 3, "le": 1, "matmul": 2, "mean": 2, "mm": 2, "mul": 17,
    "narrow": 4, "permute": 35, "pow": 6, "reciprocal": 2, "remainder": 1,
    "reshape": 22, "resize_": 5, "resolve_conj": 40, "result_type": 4,
    "rsqrt": 2, "scalar_tensor": 1, "select": 29, "sin": 2, "slice": 8,
    "split": 2, "square": 2, "sub": 3, "sum": 3, "to": 44, "unsqueeze": 27,
    "view": 28, "where": 2}
MOE_SCATTER = {
    "__and__": 2, "_local_scalar_dense": 2, "_softmax": 1, "_to_copy": 10,
    "add": 2, "aminmax": 1, "as_strided": 14, "bitwise_and": 2, "bmm": 3,
    "cat": 1, "clamp": 3, "clone": 1, "copy_": 11, "cumsum": 1, "div": 2,
    "div_": 1, "empty": 8, "empty_like": 2, "empty_strided": 11, "expand": 1,
    "fill_": 9, "flatten": 1, "full_like": 1, "gather": 1, "ge": 1,
    "index": 1, "index_add_": 2, "item": 2, "lt": 2, "matmul": 4, "mean": 1,
    "mm": 4, "mul": 12, "one_hot": 1, "ones": 1, "repeat_interleave": 1,
    "reshape": 11, "resolve_conj": 18, "scatter_": 1, "scatter_add_": 1,
    "select": 1, "sigmoid": 2, "slice": 1, "softmax": 1, "sub": 2, "sum": 5,
    "to": 22, "topk": 1, "unsqueeze": 5, "view": 12, "where": 1, "zero_": 5,
    "zeros": 5}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(kind: str):
    """Both scan their layers, so the decode restacks the groups' caches;
    the MoE routes at capacity factor 1, so a 4-row decode step has C =
    1 (2 of 8 experts a token)."""
    if kind == "dense":
        return get_smoke_config("glm4-9b").replace(scan_layers=True)
    cfg = get_smoke_config("deepseek-v3-671b")
    return cfg.replace(scan_layers=True, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))


@functools.lru_cache(maxsize=None)
def _model(kind: str):
    model = build_model(_config(kind))
    return model, model.init(0, "cpu")


def _requests(vocab: int):
    """Five requests: a wave of four and a wave of one."""
    rng = np.random.RandomState(3)
    lens, budgets = (5, 8, 3, 6, 4), (4, 3, 5, 4, 3)
    return [Request(prompt=rng.randint(1, vocab, size=n).astype(np.int32),
                    max_new_tokens=m) for n, m in zip(lens, budgets)]


def _serve(kind: str, tracer=None):
    model, params = _model(kind)
    engine = Engine(model, params, max_len=16, batch_slots=4)
    reqs = _requests(model.cfg.vocab_size)
    if tracer is not None:
        obs_trace.activate(tracer)
    try:
        engine.generate(reqs)
    finally:
        if tracer is not None:
            obs_trace.deactivate(tracer)
    return reqs


PARENT = {"serve.wave": {"serve.generate"},
          "serve.prefill": {"serve.wave"},
          "serve.decode_step": {"serve.wave"},
          "serve.sample": {"serve.prefill", "serve.decode_step"},
          "model.prefill": {"serve.prefill"},
          "model.decode_step": {"serve.decode_step"},
          "attn.cache_write": {"block.attention"},
          "stack.restack": {"model.decode_step"}}
for _name in ("model.embed", "model.logits", "block.attention", "block.mlp",
              "block.moe"):
    PARENT[_name] = {"model.prefill", "model.decode_step"}


def _ancestors(e, by_id):
    out = []
    while e["args"]["parent_id"] is not None:
        e = by_id[e["args"]["parent_id"]]
        out.append(e["name"])
    return out


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_served_spans_form_one_tree(kind):
    tracer = obs_trace.Tracer()
    reqs = _serve(kind, tracer)
    events = tracer.events
    assert obs_trace.validate_events(events, expect_root="serve.generate") \
        == []
    by_id = {e["args"]["span_id"]: e for e in events}
    names = collections.Counter(e["name"] for e in events)
    want = set(PARENT) | {"serve.generate"}
    assert set(names) == (want - {"block.moe"} if kind == "dense" else want)
    for e in events:
        if e["name"] != "serve.generate":
            assert by_id[e["args"]["parent_id"]]["name"] in PARENT[e["name"]]
    cfg = _config(kind)
    steps = [max(r.max_new_tokens for r in w) - 1
             for w in (reqs[:4], reqs[4:])]
    n_model = 2 + sum(steps)
    assert names["serve.wave"] == names["serve.prefill"] == 2
    assert names["serve.decode_step"] == names["model.decode_step"] \
        == names["stack.restack"] == sum(steps)
    assert names["serve.sample"] == names["model.embed"] == n_model
    assert names["block.attention"] == cfg.num_layers * n_model
    assert names["attn.cache_write"] == cfg.num_layers * sum(steps)
    assert all("serve.decode_step" in _ancestors(e, by_id)
               for e in events if e["name"] == "attn.cache_write")
    root = next(e for e in events if e["name"] == "serve.generate")
    assert root["args"]["requests"] == 5
    waves = [e["args"] for e in events if e["name"] == "serve.wave"]
    assert [(w["batch"], w["prompt_len"]) for w in waves] == [(4, 8), (1, 4)]
    decode = [e["args"] for e in events if e["name"] == "serve.decode_step"]
    assert [d["step"] for d in decode] == list(range(1, steps[0] + 1)) + \
        list(range(1, steps[1] + 1))
    assert decode[0]["active"] == 4 and decode[-1]["active"] == 1


def test_moe_counts_equal_a_hand_count(monkeypatch):
    routed = []
    route = moe_mod._route

    def recorded(p, cfg, x_flat):
        out = route(p, cfg, x_flat)
        routed.append(out[1].clone())
        return out
    monkeypatch.setattr(moe_mod, "_route", recorded)
    tracer = obs_trace.Tracer()
    _serve("moe", tracer)
    cfg = _config("moe")
    moes = [e["args"] for e in tracer.events if e["name"] == "block.moe"]
    assert len(moes) == len(routed) > 0
    at_one = []
    for args, idx in zip(moes, routed):
        T, k = idx.shape
        C = moe_mod.capacity(cfg, T)
        seen, dropped = collections.Counter(), 0
        for e in idx.reshape(-1).tolist():  # the scatter's token-major order
            dropped += seen[e] >= C
            seen[e] += 1
        hand = {"assignments": T * k, "dropped": dropped,
                "experts_used": len(seen),
                "experts_run": cfg.moe.num_experts}
        assert {key: args[key] for key in hand} == hand
        assert all(type(args[key]) is int for key in hand)
        if C == 1:
            at_one.append(dropped)
    assert at_one and sum(at_one) > 0


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_served_tokens_are_the_same_with_the_tracer_on(kind):
    off = _serve(kind)
    on = _serve(kind, obs_trace.Tracer())
    assert [r.out_tokens for r in on] == [r.out_tokens for r in off]


def test_no_tracer_makes_no_span_and_enters_no_annotation(monkeypatch):
    made, entered = [], []
    init = obs_trace.Span.__init__

    def counted(self, *a, **kw):
        made.append(a[1])
        init(self, *a, **kw)
    monkeypatch.setattr(obs_trace.Span, "__init__", counted)

    def annotate(name):
        entered.append(name)
        return contextlib.nullcontext()
    idle = obs_trace.Tracer(annotate=annotate)  # never activated
    assert obs_trace.current_tracer() is None
    _serve("moe")
    assert made == [] and entered == [] and idle.events == []
    active = obs_trace.Tracer(annotate=annotate)
    _serve("moe", active)
    assert sorted(entered) == sorted(made) == sorted(
        e["name"] for e in active.events)


def test_spans_become_profiler_ranges():
    tracer = obs_trace.Tracer(annotate=torch.profiler.record_function)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve("dense", tracer)
    ranges = collections.Counter(
        e.name for e in prof.events() if e.name in PARENT
        or e.name == "serve.generate")
    assert ranges == collections.Counter(e["name"] for e in tracer.events)


def test_device_scalar_attrs_become_numbers_when_read():
    tracer = obs_trace.Tracer()
    obs_trace.activate(tracer)
    try:
        with obs_trace.span("x", n=torch.tensor(3), f=np.float32(0.5),
                            v=torch.arange(2), s="a") as s:
            s.set_attr(m=torch.tensor([7]))
    finally:
        obs_trace.deactivate(tracer)
    args = tracer.events[0]["args"]
    assert (args["n"], args["f"], args["m"], args["s"]) == (3, 0.5, 7, "a")
    assert args["v"] == str(torch.arange(2))
    json.dumps(tracer.to_chrome())


def test_first_token_is_observed_once_a_request():
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        _serve("dense")
    finally:
        obs_metrics.pop_registry(reg)
    h = reg.histogram("serve.engine.first_token_seconds")
    assert h.count == 5
    ring = list(h._window)
    # the first wave's four at one time, the second wave's later
    assert len(set(ring[:4])) == 1 and ring[4] > ring[0] > 0
    assert h.percentile(95) == ring[4]


def _profiled_ops(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {n[len("aten::"):]: c for n, c in collections.Counter(
        e.name for e in prof.events()).items()}


def _decode_inputs(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    p = model.cast_params(model.init(0, "cpu"))
    toks = torch.randint(1, cfg.vocab_size, (2, 6), dtype=torch.int32)
    state, _ = model.prefill(p, {"tokens": toks}, max_len=12)
    x = torch.randn(2, 1, cfg.d_model).to(p["embed"].dtype)
    return cfg, p["stack"]["prefix"], state, x


@pytest.mark.parametrize("case", ["attention_decode", "mla_decode",
                                  "moe_forward_scatter"])
def test_no_tracer_dispatches_the_same_ops(case):
    arch = "glm4-9b" if case == "attention_decode" else "deepseek-v3-671b"
    with torch.inference_mode():
        cfg, blocks, state, x = _decode_inputs(arch)
        cache, cur = state["layers"]["prefix"]["l0"], state["cur"]
        assert obs_trace.current_tracer() is None
        if case == "moe_forward_scatter":
            p = next(b["moe"] for b in blocks.values() if "moe" in b)
            got = _profiled_ops(lambda: moe_mod.moe_forward_scatter(
                p, cfg, x))
            want = MOE_SCATTER
        elif case == "mla_decode":
            got = _profiled_ops(lambda: attn.mla_decode(
                blocks["l0"]["attn"], cfg, x, cache, cur))
            want = MLA_DECODE
        else:
            got = _profiled_ops(lambda: attn.attention_decode(
                blocks["l0"]["attn"], cfg, x, cache, cur))
            want = ATTENTION_DECODE
    assert got == want


def test_the_moe_counts_cost_ops_only_under_a_tracer():
    with torch.inference_mode():
        cfg, blocks, _, x = _decode_inputs("deepseek-v3-671b")
        p = next(b["moe"] for b in blocks.values() if "moe" in b)
        tracer = obs_trace.Tracer()
        obs_trace.activate(tracer)
        try:
            with obs_trace.span("block.moe"):
                got = _profiled_ops(lambda: moe_mod.moe_forward_scatter(
                    p, cfg, x))
        finally:
            obs_trace.deactivate(tracer)
    assert sum(got.values()) > sum(MOE_SCATTER.values())
    assert tracer.events[0]["args"]["experts_run"] == cfg.moe.num_experts


def test_launch_serve_writes_the_spans(tmp_path, capsys):
    path = tmp_path / "serve.trace.json"
    reqs = launch_serve.main(["--arch", "deepseek-v3-671b", "--smoke",
                              "--torch-device", "cpu", "--requests", "4",
                              "--max-new", "4", "--trace", str(path)])
    assert "served 4 requests" in capsys.readouterr().out
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert obs_trace.validate_events(events, expect_root="serve.generate") \
        == []
    assert sum(e["name"] == "serve.decode_step" for e in events) == \
        max(r.max_new_tokens for r in reqs) - 1
    assert any("experts_used" in e["args"] for e in events)
