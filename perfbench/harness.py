"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the result.

The system under test is `repro_torch.serve.engine.Engine.generate`,
driven in a closed loop of waves: each wave is `batch_slots` requests of
the cell's mix, drawn from the seed, handed to one `generate` call; the
next wave is drawn when it returns. The window opens at the first
measured wave; waves start until `seconds` have passed, the last runs to
its end, and the window closes there.
"""
from __future__ import annotations

import dataclasses
import gc
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from perfbench import check, spec, traffic, weights

SEED_MASK = 2 ** 63 - 1


@dataclasses.dataclass
class Wave:
    """One `generate` call of the window: its requests' prompts (as drawn,
    unpadded), budgets and served tokens, and its host-clock seconds."""
    prompts: List[np.ndarray]
    max_new: List[int]
    served: List[List[int]]
    seconds: float
    fed: Optional[np.ndarray] = None  # [steps, B] tokens fed to decode


    def padded(self) -> np.ndarray:
        """The prompts as the engine batches them: left-padded with 0."""
        S = max(len(p) for p in self.prompts)
        out = np.zeros((len(self.prompts), S), np.int32)
        for i, p in enumerate(self.prompts):
            out[i, S - len(p):] = p
        return out


@dataclasses.dataclass
class Observed:
    """What the metric readers read (`perfbench/metrics/*.py`)."""
    run: dict                        # the configuration's sizes
    batch_slots: int
    setup_s: float
    window_s: float
    waves: List[Wave]
    step_seconds: Dict[str, float]   # the engine's histogram: count, total
    prefill_seconds: Dict[str, float]
    split: Optional[Dict[str, List[float]]] = None
    trace: Optional[Dict] = None


def build(cfg_file: dict):
    """The program's model for a configuration file: `get_config(arch)`
    with the file's overrides; its sizes checked against the file's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.configs.base import MLAConfig, MoEConfig
    over = dict(cfg_file.get("overrides", {}))
    base = get_config(cfg_file["arch"])
    if "mla" in over:
        over["mla"] = MLAConfig(**over["mla"])
    if "moe" in over:
        over["moe"] = MoEConfig(**over["moe"])
    cfg = base.replace(**over)
    check_sizes(cfg, cfg_file["run"])
    return build_model(cfg)


def check_sizes(cfg, run: dict) -> None:
    """Refuse to run a program whose model differs from the file's."""
    got = {"num_layers": cfg.num_layers, "d_model": cfg.d_model,
           "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
           "param_dtype": cfg.param_dtype,
           "activation_dtype": cfg.activation_dtype,
           "tie_embeddings": cfg.tie_embeddings, "use_bias": cfg.use_bias,
           "mla": dataclasses.asdict(cfg.mla) if cfg.mla else None,
           "moe": ({k: v for k, v in dataclasses.asdict(cfg.moe).items()
                    if k in (run.get("moe") or {})} if cfg.moe else None)}
    bad = {k: (got[k], run.get(k)) for k in got
           if k in run and got[k] != run[k]}
    if bad:
        raise ValueError(f"the program's model differs from the "
                         f"configuration file: {bad}")


def tap_decode_tokens(model):
    """Records the tokens each `Model.decode_step` call is fed (every
    row's, the finished rows' too), for a reference whose rows interact.
    Returns (log, remove); the log holds the device tensors as given, so
    the tap adds no synchronisation to the step."""
    log = []
    step = model.decode_step

    def recorded(params, state, tokens):
        log.append(tokens)
        return step(params, state, tokens)
    object.__setattr__(model, "decode_step", recorded)
    return log, lambda: object.__delattr__(model, "decode_step")


def _requests(draws):
    """The engine's requests for the draws, every one greedy."""
    from repro_torch.serve.engine import Request
    return [Request(prompt=d.prompt, max_new_tokens=d.max_new_tokens,
                    temperature=0.0) for d in draws]


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fixed_wave(n, vocab, seed, stream, new_tokens, S):
    """n requests of prompt length S (the warm-up's and the traced
    slice's), ids uniform over [1, vocab)."""
    rng = traffic.rng_for(seed, stream)
    return [traffic.Draw(rng.integers(1, vocab, size=S).astype(np.int32),
                         new_tokens) for _ in range(n)]


def check_tap(fed: int, engine_steps: int, served: List[List[int]]) -> None:
    """The lockstep replay needs one recorded input for every decode step
    the engine ran, and a step for every served token after the first."""
    need = max(len(s) for s in served) - 1
    if fed != engine_steps or fed < need:
        raise RuntimeError(
            f"the tap on Model.decode_step recorded {fed} calls for the "
            f"engine's {engine_steps} decode steps ({need} needed): the "
            f"engine's decode no longer runs through Model.decode_step, "
            f"so the reference cannot replay this wave in lockstep; a "
            f"change to the decode entry needs a benchmark change that "
            f"replays the engine's own batches")


def serve_window(engine, model, mix, B, vocab, seed, seconds,
                 record_fed: bool):
    """The measured window: waves of B requests of the mix, one
    `generate` each, until `seconds` have passed; the last wave runs to
    its end. Returns (waves, window seconds, the engine's metrics
    registry for the window)."""
    from repro_torch.obs import metrics as obs_metrics
    fed, untap = tap_decode_tokens(model) if record_fed else ([], None)
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    steps = reg.histogram("serve.engine.step_seconds")
    waves: List[Wave] = []
    t_open = time.perf_counter()
    try:
        while True:
            draws = traffic.wave(mix, B, vocab, seed, len(waves))
            reqs = _requests(draws)
            fed.clear()
            n_steps = steps.count
            t0 = time.perf_counter()
            engine.generate(reqs)
            t1 = time.perf_counter()
            served = [list(r.out_tokens) for r in reqs]
            if record_fed:
                check_tap(len(fed), steps.count - n_steps, served)
            waves.append(Wave([d.prompt for d in draws],
                              [d.max_new_tokens for d in draws],
                              served, t1 - t0, list(fed) or None))
            if t1 - t_open >= seconds:
                break
    finally:
        obs_metrics.pop_registry(reg)
        if untap is not None:
            untap()
    for w in waves:
        if w.fed is not None:
            w.fed = np.stack([t.cpu().numpy() for t in w.fed])
    return waves, t1 - t_open, reg


def run_cell(cfg_file: dict, mix: dict, cell: dict, metrics: List[dict],
             seed: int, seconds: float, trace: bool, device: str,
             t_start: float, chips: int = 1, faults=None,
             control: bool = False) -> dict:
    """One run: {"result": the result line's object, "info": the run's
    facts}. `faults` (tests only) breaks the timed path underneath: a
    callable given the engine before the window. `control` also reads the
    fp8 control on the same sample (`perfbench/control.py`)."""
    import torch
    from repro_torch.serve.engine import Engine

    from perfbench.reference.common import no_tf32

    no_tf32()
    dev = torch.device(device)
    seed = int(seed) & SEED_MASK
    run = cfg_file["run"]
    B = int(cell["batch_slots"])
    vocab = int(run["vocab_size"])
    model = build(cfg_file)
    params = weights.make(model.abstract_params_and_axes()[0], seed, dev)
    max_len = traffic.max_len(mix)
    engine = Engine(model, params, max_len=max_len, batch_slots=B,
                    profile_kernels=False)
    S_max = traffic.longest_prompt(mix, B)
    # warm-up: the window's prefill shape and a few decode steps
    engine.generate(_requests(_fixed_wave(B, vocab, seed, 2, 4, S_max)))
    if faults is not None:
        faults(engine)
    _sync(dev)
    gc.collect()
    t_open = time.perf_counter()
    waves, window_s, reg = serve_window(
        engine, model, mix, B, vocab, seed, seconds,
        record_fed=not check.reference(cfg_file).ROWS_INDEPENDENT)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    def hist(name):
        h = reg.histogram(name)
        return {"count": h.count, "total": h.total}

    obs = Observed(run=run, batch_slots=B, setup_s=t_open - t_start,
                   window_s=window_s, waves=waves,
                   step_seconds=hist("serve.engine.step_seconds"),
                   prefill_seconds=hist("serve.engine.prefill_seconds"))
    if trace and any("split" in spec.needs(m["name"]) for m in metrics):
        obs.split = step_split(model, engine.params, dev, B, S_max, max_len,
                               vocab, seed)
    if trace:
        obs.trace = traced_slice(engine, cell, dev, B, S_max, vocab, seed)
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(params, cfg_file, cell, waves, seed,
                            control=control)
    attempted = sum(len(w.prompts) for w in waves)
    failed = sum(len(s) != m for w in waves
                 for s, m in zip(w.served, w.max_new))
    limits = cell["check"]["limits"]
    compared, within = check.verdict(numbers, limits)
    compared["failed"] = {"value": failed, "limit": 0}
    correct = attempted > 0 and within and failed == 0
    values = {}
    for m in metrics:
        v = spec.reader(m["name"])(obs)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": values,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": kind, "count": chips,
                         "memory_peak_bytes": int(peak)}}
    if obs.trace is not None:
        result["device"]["busy_s"] = obs.trace["busy_s"]
        result["device"]["window_s"] = obs.trace["window_s"]
        result["breakdown"] = {"device_ops": obs.trace["device_ops"],
                               "idle_gaps": obs.trace["idle_gaps"]}
    result["check"] = compared
    info = {"waves": len(waves), "requests": attempted,
            "served_tokens": sum(len(s) for w in waves for s in w.served),
            "wave_s": [w.seconds for w in waves],
            "window_s": window_s, "setup_s": obs.setup_s,
            "compared_tokens": numbers["tokens"],
            "reference_s": numbers["seconds"],
            "program": {k: numbers[k] for k in ("max_gap", "mean_gap")}}
    if control:
        ctl, ctl_within = check.verdict(numbers["control"], limits)
        info["control"] = dict(numbers["control"], check=ctl,
                               correct=ctl_within)
    if obs.trace is not None:
        info["trace_bytes"] = obs.trace["trace_bytes"]
    return {"result": result, "info": info}


def step_split(model, params, dev, B, S, max_len, vocab, seed,
               steps: int = 8) -> Dict[str, List[float]]:
    """`Model.decode_step` on a state prefilled at the cell's batch and
    longest prompt: the host's time to its return (the enqueue) and its
    wall time to a synchronise, per step (after one step of warm-up)."""
    import torch
    rng = traffic.rng_for(seed, 5)
    toks = torch.as_tensor(rng.integers(1, vocab, size=(B, S)).astype(
        np.int32), device=dev)
    enqueue, wall = [], []
    with torch.inference_mode():
        state, logits = model.prefill(params, {"tokens": toks},
                                      max_len=max_len)
        nxt = logits.argmax(-1).to(torch.int32)
        state, _ = model.decode_step(params, state, nxt)
        _sync(dev)
        for _ in range(steps):
            t0 = time.perf_counter()
            state, _ = model.decode_step(params, state, nxt)
            t1 = time.perf_counter()
            _sync(dev)
            enqueue.append(t1 - t0)
            wall.append(time.perf_counter() - t0)
        del state
    return {"enqueue": enqueue, "wall": wall}


def traced_slice(engine, cell, dev, B, S, vocab, seed) -> Optional[Dict]:
    """One `generate` of B requests at the longest prompt and
    `trace_decode_steps` decode steps under torch.profiler, reduced by
    `perfbench.trace`. The trace file lives in a temporary directory
    (under TMPDIR) until it is read."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import trace as trace_mod
    n = int(cell.get("trace_decode_steps", 8))
    reqs = _requests(_fixed_wave(B, vocab, seed, 4, n + 1, S))
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        engine.generate(reqs)
        _sync(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        size = path.stat().st_size
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = trace_mod.reduce(events)
    if out is not None:
        out["trace_bytes"] = size
    return out

