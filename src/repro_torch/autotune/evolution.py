"""Evolutionary search over program configs, guided by the cost model
(Ansor-style: sample -> mutate/crossover -> rank by C() -> epsilon-greedy).
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Set, Tuple

import numpy as np

from repro_torch.autotune.space import (ProgramConfig, Workload, crossover,
                                  enumerate_space_size, mutate_config,
                                  random_config)
from repro_torch.core.features import FeatureCache, extract_features


def evolutionary_search(
    wl: Workload,
    score_fn: Callable[[np.ndarray], np.ndarray],  # features [N,F] -> scores
    rng: np.random.RandomState,
    population: int = 128,
    rounds: int = 4,
    mutation_prob: float = 0.85,
    top_k: int = 16,
    eps_greedy: float = 0.05,
    seen: Set[Tuple] = None,
    seed_configs: Sequence[ProgramConfig] = (),
    feature_cache: FeatureCache = None,
    cost_model=None,
    params=None,
) -> List[ProgramConfig]:
    """Returns top_k candidate configs (deduped against `seen`). May return
    fewer than top_k when the space is (nearly) exhausted.

    Scoring: pass a raw `score_fn`, or pass `score_fn=None` with
    `cost_model` (+ its `params`) — any registered `CostModel` — and
    candidates are ranked through `cost_model.batched_predict`. The search
    itself never sees model internals either way.

    When `feature_cache` is given, per-config features are memoized through
    it — survivors re-scored across rounds (and re-visited in later tuner
    rounds sharing the cache) are extracted once.
    """
    if score_fn is None:
        assert cost_model is not None, "need score_fn or cost_model"
        model_params = params

        def score_fn(feats):
            return cost_model.batched_predict(model_params, feats)

    seen = seen if seen is not None else set()
    space_size = enumerate_space_size(wl)
    top_k = min(top_k, max(space_size - len(seen), 0))
    if top_k == 0:
        return []
    pop = list(seed_configs)[:population]
    while len(pop) < population:
        pop.append(random_config(wl, rng))

    def scores_of(cfgs):
        if feature_cache is not None:
            feats = feature_cache.features_batch(wl, cfgs)
        else:
            feats = np.stack([extract_features(wl, c) for c in cfgs])
        return score_fn(feats)

    for _ in range(rounds):
        s = scores_of(pop)
        order = np.argsort(-s)
        elite = [pop[i] for i in order[: max(2, population // 4)]]
        children = []
        while len(children) < population - len(elite):
            if rng.rand() < mutation_prob:
                parent = elite[rng.randint(len(elite))]
                children.append(mutate_config(wl, parent, rng,
                                              n_mut=1 + rng.randint(2)))
            else:
                a = elite[rng.randint(len(elite))]
                b = elite[rng.randint(len(elite))]
                children.append(crossover(a, b, rng))
        pop = elite + children

    s = scores_of(pop)
    order = np.argsort(-s)
    picked: List[ProgramConfig] = []
    for i in order:
        c = pop[i]
        if c.knobs in seen:
            continue
        if picked and rng.rand() < eps_greedy:
            c = random_config(wl, rng)  # epsilon-greedy exploration
            if c.knobs in seen:
                continue
        seen.add(c.knobs)
        picked.append(c)
        if len(picked) >= top_k:
            break
    attempts = 0
    while len(picked) < top_k and attempts < 50 * top_k:
        attempts += 1
        c = random_config(wl, rng)
        if c.knobs not in seen:
            seen.add(c.knobs)
            picked.append(c)
    return picked
