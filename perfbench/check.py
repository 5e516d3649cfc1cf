"""The comparison that decides `correct`.

Once the window has closed and the engine is gone, a sample of the
window's finished requests, drawn from the seed, is replayed through the
plain float32 reference (`perfbench/reference/<reference>.py`, named by
the configuration file) over its padded prompt and its served tokens.
For each served token the reference gives the gap by which that token's
logit lies below its best logit (0 where the reference picks it too).
The numbers: the widest gap (`max_gap`) and the mean gap (`mean_gap`)
over the compared tokens; a cell compares those its `check.limits`
names. A cell whose control's smallest widest gap lies under three times
the program's largest compares the mean alone: deepseek-v3-671b.chat (a
near-tie in its router flips between bf16 and float32, so its widest gap
swings as far in the program as in the control) and glm4-9b.longprompt.

The sample: where the reference says rows are independent (a dense
model), the request with the longest output and others drawn from the
seed until the cell's `check.tokens` served tokens are reached; where
rows interact (capacity-dispatched experts), one whole wave drawn from
the seed, every row.
"""
from __future__ import annotations

import importlib
import time
from typing import Dict, List, Tuple

import torch

from perfbench import traffic
from perfbench.reference.common import FLOAT32, FP8, Precision, gaps


def reference(cfg_file: dict):
    return importlib.import_module(
        f"perfbench.reference.{cfg_file['reference']}")


def sample(ref, waves, cell: dict, seed: int) -> List[Tuple[int, List[int]]]:
    """[(wave index, rows)] to compare."""
    rng = traffic.rng_for(seed, 3)
    if not ref.ROWS_INDEPENDENT:
        w = int(rng.integers(len(waves)))
        return [(w, list(range(len(waves[w].prompts))))]
    reqs = [(wi, r) for wi, w in enumerate(waves)
            for r in range(len(w.prompts))]
    longest = max(reqs, key=lambda a: len(waves[a[0]].served[a[1]]))
    chosen, tokens = [longest], len(waves[longest[0]].served[longest[1]])
    for i in rng.permutation(len(reqs)):
        if tokens >= cell["check"]["tokens"]:
            break
        if reqs[i] != longest:
            chosen.append(reqs[i])
            tokens += len(waves[reqs[i][0]].served[reqs[i][1]])
    by_wave: Dict[int, List[int]] = {}
    for wi, r in chosen:
        by_wave.setdefault(wi, []).append(r)
    return sorted((wi, sorted(rs)) for wi, rs in by_wave.items())


def logits_of(params, cfg_file, waves, picked, prec: Precision):
    """[(served tokens, float32 logits [n, V])] of each picked row."""
    ref = reference(cfg_file)
    out = []
    for wi, rows in picked:
        w = waves[wi]
        wave = {"tokens": w.padded(), "served": w.served, "fed": w.fed}
        got = ref.served_logits(params, cfg_file["run"], wave, rows, prec)
        out += [(w.served[r], got[r]) for r in rows]
    return out


def verdict(numbers: dict, limits: dict) -> Tuple[dict, bool]:
    """Each number a cell's `check.limits` names beside its limit, and
    whether every one is within it: the program's numbers and the
    control's go through this one comparison."""
    compared = {k: {"value": numbers[k], "limit": lim}
                for k, lim in limits.items()}
    return compared, all(c["value"] <= c["limit"]
                         for c in compared.values())


def _numbers(g: torch.Tensor) -> dict:
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean())}


@torch.no_grad()
def compare(params, cfg_file: dict, cell: dict, waves, seed: int,
            control: bool = False) -> dict:
    """The numbers compared for the served tokens of the sample. With
    `control`, also the control's: the reference at fp8 put in the
    program's place, its first choice at each of the same positions read
    against the float32 reference (`control` key)."""
    t0 = time.perf_counter()
    picked = sample(reference(cfg_file), waves, cell, seed)
    ref = logits_of(params, cfg_file, waves, picked, FLOAT32)
    g = torch.cat([gaps(lg, toks) for toks, lg in ref])
    out = dict(_numbers(g), tokens=int(g.numel()),
               seconds=time.perf_counter() - t0)
    if control:
        ctl = logits_of(params, cfg_file, waves, picked, FP8)
        out["control"] = _numbers(torch.cat([
            gaps(lg, c.argmax(-1)) for (_, lg), (_, c) in zip(ref, ctl)]))
    return out
