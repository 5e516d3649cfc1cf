"""Serving steps (port of the serving half of `repro.train.train_loop`).

The reference jits each step over a mesh; PyTorch runs eagerly on one
card, so a step is the model's own function with `max_len` bound. The
training loop waits (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.model import Model


def make_serve_prefill(model: Model, max_len: Optional[int] = None):
    def fn(params, batch):
        return model.prefill(params, batch, max_len=max_len)
    return fn


def make_serve_step(model: Model, distributed_cache: bool = False):
    if distributed_cache:
        raise NotImplementedError(
            "distributed_cache (sequence-sharded decode attention) is not "
            "ported yet (ROADMAP Queue 1 item 12: the distribution layer)")

    def fn(params, state, tokens):
        return model.decode_step(params, state, tokens)
    return fn
