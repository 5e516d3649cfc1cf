"""The one traffic generator: reads a mix's parameters (a file under
`perfbench/traffic/`) and draws closed-loop waves of greedy requests
from the seed.

A mix gives `prompt_tokens` and `output_tokens` as {"low", "high"}
bounds (inclusive), drawn stratified: a wave of n requests holds the
n midpoints of n equal bins of [low, high], in an order drawn from the
seed (prompts and outputs permuted apart), so every seed serves the same
lengths and the seed changes only their pairing and the token ids.
Token ids are uniform over [1, vocab). Every request is greedy: the
check compares served tokens with the reference's best.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Draw:
    prompt: np.ndarray        # int32 [S]
    max_new_tokens: int


def _lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = int(spec["low"]), int(spec["high"])
    return rng.permutation(
        lo + ((np.arange(n) + 0.5) * (hi - lo + 1) / n).astype(np.int64))


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *stream])


def wave(mix: dict, n: int, vocab: int, seed: int, index: int
         ) -> List[Draw]:
    """The `index`-th wave of n requests of the mix under `seed`."""
    rng = rng_for(seed, 1, index)
    prompts = _lengths(mix["prompt_tokens"], n, rng)
    outputs = _lengths(mix["output_tokens"], n, rng)
    return [Draw(rng.integers(1, vocab, size=int(p)).astype(np.int32),
                 int(o)) for p, o in zip(prompts, outputs)]


def longest_prompt(mix: dict, n: int) -> int:
    """The longest prompt a wave of n holds (the warm-up's padded
    length)."""
    return int(_lengths(mix["prompt_tokens"], n,
                        np.random.default_rng(0)).max())


def max_len(mix: dict) -> int:
    """The engine's cache length: the longest prompt and output the mix
    can draw, and 8 spare."""
    return int(mix["prompt_tokens"]["high"]) + int(
        mix["output_tokens"]["high"]) + 8
