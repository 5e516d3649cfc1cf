"""Lottery-ticket-based transferable-parameter identification (paper §3.4),
PyTorch port of `repro.core.lottery`.

Distilling boundary criterion (Eq. 5):     xi(w) = |w * grad_w|
Parameters with large xi carry hardware-independent ("winning ticket")
knowledge and are fine-tuned on the target device; the rest are
domain-variant and are decayed toward zero (Eq. 7):

    w_v(ph+1) <- w_v(ph) - alpha * wd(w_v(ph))

Two selection modes (both in the paper):
  - threshold: xi normalized to [0,1] per-model; transferable iff xi > theta
  - ratio ranking: users set the transferable ratio rho; the top-rho fraction
    of parameters by xi are transferable (the Fig. 6 ablation knob).

Params, grads, scores and masks are flat mappings of tensors keyed like the
cost-model params.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


def _flat(tree: Tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree.values()])


def xi_scores(params: Tree, grads: Tree) -> Tree:
    """Eq. 5: elementwise |w * grad_w|."""
    return {k: torch.abs(w * grads[k]) for k, w in params.items()}


def normalize_scores(scores: Tree) -> Tree:
    """Normalize xi to [0, 1] across the whole model (for the theta mode).

    When every xi is equal there is no ranking signal to threshold, so every
    parameter counts as transferable: all-ones normalized scores give an
    all-ones mask for any theta < 1 (as in the reference)."""
    flat = _flat(scores)
    lo, hi = flat.min(), flat.max()
    span = torch.clamp(hi - lo, min=1e-30)
    degenerate = (hi - lo) <= 0.0
    return {k: torch.where(degenerate, torch.ones_like(s), (s - lo) / span)
            for k, s in scores.items()}


def mask_by_threshold(scores: Tree, theta: float) -> Tree:
    norm = normalize_scores(scores)
    return {k: (s > theta).to(torch.float32) for k, s in norm.items()}


def mask_by_ratio(scores: Tree, ratio: float) -> Tree:
    """Top-`ratio` fraction of ALL parameters by xi ranking -> mask=1.

    k is rounded half-to-even in float32, as `jnp.round` does in the
    reference, and the threshold is the global k-th largest score with a
    `>=` test, so ties at the threshold are all kept."""
    flat = _flat(scores)
    n = flat.shape[0]
    k = int(np.clip(np.round(np.float32(ratio) * np.float32(n)), 1, n))
    thresh = torch.sort(flat).values[n - k]
    return {k_: (s >= thresh).to(torch.float32) for k_, s in scores.items()}


def transferable_mask(params: Tree, grads: Tree, *, ratio: float = 0.5,
                      theta: float = 0.5, use_ratio: bool = True) -> Tree:
    scores = xi_scores(params, grads)
    if use_ratio:
        return mask_by_ratio(scores, ratio)
    return mask_by_threshold(scores, theta)


def mask_fraction(mask: Tree) -> torch.Tensor:
    """Fraction of parameters marked transferable, as a 0-d tensor."""
    return sum(m.sum() for m in mask.values()) / sum(
        m.numel() for m in mask.values())


def masked_update(params: Tree, updates: Tree, mask: Tree,
                  variant_decay: float, lr: float) -> Tree:
    """Invariant params take the optimizer update; variant params decay to 0
    (Eq. 7 with wd(w) = w, i.e. w <- w - alpha*wd_strength*w)."""
    # the reference traces lr and the decay as float32 values
    keep = float(np.float32(1.0) - np.float32(lr) * np.float32(variant_decay))
    out = {}
    for k, w in params.items():
        m = mask[k]
        invariant = w + updates[k]  # optimizer already folded the lr in
        variant = w * keep
        out[k] = m * invariant + (1 - m) * variant
    return out


def prune_variant(params: Tree, mask: Tree) -> Tree:
    """Hard-prune the domain-variant parameters (winning-ticket extraction,
    used by the reference's ablation in benchmarks/fig6)."""
    return {k: w * mask[k] for k, w in params.items()}
