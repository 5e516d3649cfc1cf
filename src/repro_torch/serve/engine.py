"""Batched serving engine: prefill + decode with KV cache (port of
`repro.serve.engine`).

Continuous-batching-lite: a fixed pool of batch slots; finished sequences
(EOS or budget) free their slot and queued requests are admitted at the next
prefill boundary. Per-slot positions (`cur` is per-sequence) make mixed-age
batches correct. Prompts of a wave are left-padded with token 0 to a common
length, with no mask, as in the reference.

One card: there is no mesh argument, and the engine runs where its params
lie. It casts the params once, at construction, to what the model reads
(`Model.cast_params`: the projections, the embedding and the tied logits at
the activation dtype), where the reference casts each weight on every call;
the values are the same.

Observability: every wave records prefill and per-step decode wall time
into the active metrics registry (`serve.engine.prefill_seconds`,
`serve.engine.step_seconds`, `serve.engine.tokens`); each is timed to the
sampled tokens' copy to the host, which waits for the card. With
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
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.obs import metrics as obs_metrics
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
                 seed: int = 0, device: str = "tpu_v5e",
                 profile_kernels: bool = False):
        self.model = model
        self.params = model.cast_params(params)
        self.torch_device = params["embed"].device
        self.max_len = max_len
        self.batch_slots = batch_slots
        self.device = device
        self.profile_kernels = profile_kernels
        self._profiled = False
        self._prefill = make_serve_prefill(model, max_len=max_len)
        self._step = make_serve_step(model,
                                     distributed_cache=distributed_cache)
        self._gen = torch.Generator(device=self.torch_device).manual_seed(
            seed)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        pick = torch.argmax(logits, dim=-1)
        if (temps > 0).any():
            t = torch.as_tensor(np.maximum(temps, 1e-6),
                                device=logits.device)[:, None]
            probs = torch.softmax(logits.float() / t, dim=-1)
            sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            hot = torch.as_tensor(temps > 0, device=logits.device)
            pick = torch.where(hot, sampled, pick)
        return pick.to(torch.int32).cpu().numpy()

    def generate(self, requests: Sequence[Request]) -> List[Request]:
        """Serves all requests (batched waves of up to batch_slots)."""
        if self.profile_kernels and not self._profiled:
            self._profiled = True
            from repro_torch.kernels.profile import (model_workloads,
                                                     profile_kernels)
            profile_kernels(device=self.device,
                            workloads=model_workloads(self.model.cfg),
                            torch_device=self.torch_device)
        queue = list(requests)
        with torch.inference_mode():
            while queue:
                wave = queue[: self.batch_slots]
                queue = queue[self.batch_slots:]
                self._run_wave(wave)
        return list(requests)

    def _run_wave(self, wave: List[Request]):
        reg = obs_metrics.current()
        prefill_hist = reg.histogram("serve.engine.prefill_seconds")
        step_hist = reg.histogram("serve.engine.step_seconds")
        tokens = reg.counter("serve.engine.tokens")
        B = len(wave)
        S = max(len(r.prompt) for r in wave)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(wave):  # left-pad to a common length
            toks[i, S - len(r.prompt):] = r.prompt
        batch = {"tokens": torch.as_tensor(toks, device=self.torch_device)}
        t0 = time.perf_counter()
        state, logits = self._prefill(self.params, batch)
        temps = np.array([r.temperature for r in wave], np.float32)
        next_tok = self._sample(logits, temps)
        prefill_hist.observe(time.perf_counter() - t0)
        active = np.ones(B, bool)
        budget = np.array([r.max_new_tokens for r in wave])
        for i, r in enumerate(wave):
            r.out_tokens.append(int(next_tok[i]))
        tokens.inc(B)
        n = 1
        while active.any() and n < budget.max():
            t0 = time.perf_counter()
            state, logits = self._step(
                self.params, state,
                torch.as_tensor(next_tok, device=self.torch_device))
            next_tok = self._sample(logits, temps)
            step_hist.observe(time.perf_counter() - t0)
            tokens.inc(int(active.sum()))
            n += 1
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
        for r in wave:
            r.done = True
