"""Batched serving engine: prefill + decode with KV cache (port of
`repro.serve.engine`).

Static waves: `generate` takes its requests `batch_slots` at a time, in
order; each wave is one prefill and then decode steps over all its rows
until every request of the wave has finished (EOS or budget). A finished
request's slot keeps decoding, its tokens thrown away, until the wave
ends; the next wave starts after that. Prompts of a wave are left-padded
with token 0 to a common length, with no mask, as in the reference.

Without a mesh the engine runs where its params lie. With `mesh` (a
`DeviceMesh`; every rank makes its own engine with the same requests) the
params may be DTensors, prefill and decode run under the mesh
(`train_loop.make_serve_prefill`/`make_serve_step`), and
`distributed_cache=True` decodes against a KV cache sequence-sharded on
the "model" axis; it needs the mesh. The engine casts the params once, at
construction, to what the model reads (`Model.cast_params`: the
projections, the embedding and the tied logits at the activation dtype),
where the reference casts each weight on every call; the values are the
same.

`extra_batch` (numpy arrays: whisper's `encoder_embeddings`, the VLM's
`frontend_embeddings`) goes onto the params' device once, at construction,
and joins every wave's batch. Its rows are `batch_slots`, so a wave with
fewer requests than slots fails, in the reference as here (ROADMAP Queue 3,
"Properties").

Observability: every wave records prefill and per-step decode wall time
into the active metrics registry (`serve.engine.prefill_seconds`,
`serve.engine.step_seconds`, `serve.engine.tokens`); each is timed to the
sampled tokens' copy to the host, which waits for the card.
`serve.engine.first_token_seconds` takes one observation a request: from
`generate`'s entry to its first token on the host, so a request of a later
wave counts its wait behind the earlier ones. Under an active
`obs.trace.Tracer` the engine opens the spans `serve.generate` (the root;
`requests`), `serve.wave` (`batch`, `prompt_len`), `serve.prefill`, and
`serve.decode_step` (`step`, `active`; the per-request update loop is its
self time), each of the last two with a `serve.sample` around the
argmax and the tokens' copy to the host; the model's own spans
(`models/model.py`, `transformer.py`, `attention.py`, `moe.py`) nest
below. With no tracer each span is a shared no-op. With
`profile_kernels=True` the first `generate()` also runs the tuned-vs-default
kernel probe (`kernels.profile`) at the engine's model shapes on the
params' device, so one decode run leaves per-kernel timing histograms for
all three kernels.

Sampling draws from a `torch.Generator` seeded with `seed`;
`jax.random.categorical`'s draws cannot be reproduced, so only greedy
decoding (temperature 0) gives the reference's tokens.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.train.train_loop import make_serve_prefill, make_serve_step


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0     # 0 = greedy
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, model: Model, params, max_len: int = 512,
                 batch_slots: int = 8, distributed_cache: bool = False,
                 extra_batch: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device: str = "tpu_v5e", profile_kernels: bool = False,
                 mesh=None):
        self.model = model
        self.mesh = mesh
        self.params = model.cast_params(params)
        self.torch_device = (torch.device(mesh.device_type) if mesh
                             is not None else params["embed"].device)
        self.max_len = max_len
        self.batch_slots = batch_slots
        self.extra_batch = {k: torch.as_tensor(np.asarray(v),
                                               device=self.torch_device)
                            for k, v in (extra_batch or {}).items()}
        self.device = device
        self.profile_kernels = profile_kernels
        self._profiled = False
        self._prefill = make_serve_prefill(model, max_len=max_len, mesh=mesh)
        self._step = make_serve_step(model,
                                     distributed_cache=distributed_cache,
                                     mesh=mesh)
        self._gen = torch.Generator(device=self.torch_device).manual_seed(
            seed)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        from repro_torch.distributed.act_sharding import is_dtensor
        with obs_trace.span("serve.sample"):
            if is_dtensor(logits):  # a mesh's logits, whole on every rank
                logits = logits.full_tensor()
            pick = torch.argmax(logits, dim=-1)
            if (temps > 0).any():
                t = torch.as_tensor(np.maximum(temps, 1e-6),
                                    device=logits.device)[:, None]
                probs = torch.softmax(logits.float() / t, dim=-1)
                sampled = torch.multinomial(probs, 1,
                                            generator=self._gen)[:, 0]
                hot = torch.as_tensor(temps > 0, device=logits.device)
                pick = torch.where(hot, sampled, pick)
            return pick.to(torch.int32).cpu().numpy()

    def generate(self, requests: Sequence[Request]) -> List[Request]:
        """Serves all requests (batched waves of up to batch_slots)."""
        t_entry = time.perf_counter()
        if self.profile_kernels and not self._profiled:
            self._profiled = True
            from repro_torch.kernels.profile import (model_workloads,
                                                     profile_kernels)
            profile_kernels(device=self.device,
                            workloads=model_workloads(self.model.cfg),
                            torch_device=self.torch_device)
        queue = list(requests)
        # a mesh's DTensors under no_grad: in torch 2.11, inference mode
        # fails on a DTensor's views ("Cannot set version_counter for
        # inference tensor", the stacked groups' unbind)
        with obs_trace.span("serve.generate", requests=len(queue)), \
                (torch.no_grad() if self.mesh is not None
                 else torch.inference_mode()):
            while queue:
                wave = queue[: self.batch_slots]
                queue = queue[self.batch_slots:]
                self._run_wave(wave, t_entry)
        return list(requests)

    def _run_wave(self, wave: List[Request], t_entry: float):
        """One wave; `t_entry` is the `generate` call's entry, from which
        each request's first token is timed."""
        reg = obs_metrics.current()
        prefill_hist = reg.histogram("serve.engine.prefill_seconds")
        step_hist = reg.histogram("serve.engine.step_seconds")
        first_hist = reg.histogram("serve.engine.first_token_seconds")
        tokens = reg.counter("serve.engine.tokens")
        B = len(wave)
        S = max(len(r.prompt) for r in wave)
        with obs_trace.span("serve.wave", batch=B, prompt_len=S):
            toks = np.zeros((B, S), np.int32)
            for i, r in enumerate(wave):  # left-pad to a common length
                toks[i, S - len(r.prompt):] = r.prompt
            temps = np.array([r.temperature for r in wave], np.float32)
            with obs_trace.span("serve.prefill"):
                batch = {"tokens": torch.as_tensor(
                    toks, device=self.torch_device), **self.extra_batch}
                t0 = time.perf_counter()
                state, logits = self._prefill(self.params, batch)
                next_tok = self._sample(logits, temps)
                t1 = time.perf_counter()
            prefill_hist.observe(t1 - t0)
            for _ in wave:
                first_hist.observe(t1 - t_entry)
            active = np.ones(B, bool)
            budget = np.array([r.max_new_tokens for r in wave])
            for i, r in enumerate(wave):
                r.out_tokens.append(int(next_tok[i]))
            tokens.inc(B)
            n = 1
            while active.any() and n < budget.max():
                with obs_trace.span("serve.decode_step", step=n,
                                    active=int(active.sum())):
                    t0 = time.perf_counter()
                    state, logits = self._step(
                        self.params, state,
                        torch.as_tensor(next_tok, device=self.torch_device))
                    next_tok = self._sample(logits, temps)
                    step_hist.observe(time.perf_counter() - t0)
                    tokens.inc(int(active.sum()))
                    n += 1
                    _take(wave, active, next_tok, n)
        for r in wave:
            r.done = True


def _take(wave: List[Request], active: np.ndarray, next_tok: np.ndarray,
          n: int) -> None:
    """Hands each active request its token of step `n` (within its
    budget) and retires the requests that finished (EOS or budget)."""
    for i, r in enumerate(wave):
        if not active[i]:
            continue
        tok = int(next_tok[i])
        if n <= r.max_new_tokens:
            r.out_tokens.append(tok)
        if (r.eos_id is not None and tok == r.eos_id) or \
                len(r.out_tokens) >= r.max_new_tokens:
            active[i] = False
            r.done = True
