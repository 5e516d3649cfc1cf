"""Moses online cost-model adaptation (paper §3.4 + §3.6 Step 4), PyTorch
port of `repro.core.adaptation`.

Per tuning phase ph:
  1. grads of the ranking loss on the target records T-hat (+ adversarial
     invariant term, Eq. 6, weight beta with a gradient-reversal domain
     discriminator b() on the hidden representation);
  2. xi = |w * grad_w| (Eq. 5) -> transferable mask (threshold theta or
     top-rho ranking — Fig. 6 knob);
  3. invariant parameters: Adam step; variant parameters: weight-decay toward
     zero (Eq. 7).

The mask is re-estimated every phase ("we iteratively update the boundary of
domain-invariant parameters ... during each online training epoch").
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.moses import MosesConfig
from repro_torch.core import lottery
from repro_torch.core.cost_model import (AdamState, Batch, CostModel, Pairs,
                                         Params, Records, adam_init,
                                         adam_moments, adam_update,
                                         as_generator, mlp_forward,
                                         pairwise_rank_loss, params_device)


def init_discriminator(rng: Union[int, torch.Generator], hidden_dim: int = 512,
                       width: int = 64,
                       torch_device: torch.device = torch.device("cpu")
                       ) -> Params:
    """Discriminator params (keys w0, b0, w1, b1), drawn on a CPU generator
    and moved to `torch_device`."""
    gen = as_generator(rng)
    w0 = torch.randn((hidden_dim, width), generator=gen) / np.sqrt(hidden_dim)
    w1 = torch.randn((width, 1), generator=gen) / np.sqrt(width)
    return {"w0": w0.to(torch_device),
            "b0": torch.zeros((width,), device=torch_device),
            "w1": w1.to(torch_device),
            "b1": torch.zeros((1,), device=torch_device)}


def discriminator_logit(dp: Params, h: torch.Tensor) -> torch.Tensor:
    z = torch.relu(h @ dp["w0"] + dp["b0"])
    return (z @ dp["w1"] + dp["b1"])[..., 0]


class _GradReverse(torch.autograd.Function):
    """Identity forward, negated gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def grad_reverse(x: torch.Tensor) -> torch.Tensor:
    return _GradReverse.apply(x)


def _masked_mean(vals: torch.Tensor, valid: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if valid is None:
        return vals.mean()
    return (vals * valid).sum() / valid.sum().clamp_min(1.0)


def _adaptation_loss(params: Params, disc: Params, batch_t: Batch,
                     batch_s: Optional[Batch], generator, beta: float,
                     n_pairs: int, forward: Optional[Callable] = None,
                     pairs: Optional[Pairs] = None):
    """Ranking loss on target records + adversarial invariant loss (Eq. 6).

    The discriminator is trained to tell source-hidden from target-hidden;
    the cost model sees the REVERSED gradient so its surviving (invariant)
    parameters learn representations the discriminator cannot separate.
    Padded target rows (mask under key "m") contribute to neither term.
    """
    fwd = forward if forward is not None else mlp_forward
    scores_t, hidden_t = fwd(params, batch_t["x"], return_hidden=True)
    m_t = batch_t.get("m")
    rank = pairwise_rank_loss(scores_t, batch_t["y"], batch_t["g"], generator,
                              n_pairs, valid=m_t, pairs=pairs)
    adv = torch.zeros((), device=scores_t.device)
    if batch_s is not None and beta > 0:
        _, hidden_s = fwd(params, batch_s["x"], return_hidden=True)
        logit_s = discriminator_logit(disc, grad_reverse(hidden_s))
        logit_t = discriminator_logit(disc, grad_reverse(hidden_t))
        # labeling black-box b(): source=1, target=0 (Eq. 6 with entropy
        # coefficient beta on the target branch)
        l_s = _masked_mean(F.softplus(-logit_s), batch_s.get("m"))
        l_t = _masked_mean(F.softplus(logit_t), m_t)
        adv = l_s + beta * l_t
    return rank + adv, rank, adv


def _adapt_phase(params: Params, disc: Params, opt: AdamState,
                 disc_opt: AdamState, batch_t: Batch, batch_s: Optional[Batch],
                 generator, lr: float, ratio: float, theta: float,
                 variant_decay: float, beta: float, n_pairs: int,
                 use_ratio: bool, forward: Optional[Callable] = None,
                 pairs: Optional[Pairs] = None):
    """One adaptation phase: one Adam over all params applied through this
    phase's lottery mask, plus the discriminator's own Adam step. Returns
    (params, disc, opt, disc_opt, loss, rank, adv, mask_frac) with the
    scalars as 0-d tensors."""
    p_leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    d_leaves = {k: v.detach().requires_grad_(True) for k, v in disc.items()}
    loss, rank, adv = _adaptation_loss(p_leaves, d_leaves, batch_t, batch_s,
                                       generator, beta, n_pairs, forward,
                                       pairs)
    leaves = [*p_leaves.values(), *d_leaves.values()]
    # the discriminator is off the graph without a source batch: its
    # gradient is then zero, as jax.grad reports it
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    g_params = dict(zip(p_leaves, grads[:len(p_leaves)]))
    g_disc = dict(zip(d_leaves, grads[len(p_leaves):]))

    with torch.no_grad():
        # Eq. 5 mask from this phase's gradient flow
        mask = lottery.transferable_mask(params, g_params, ratio=ratio,
                                         theta=theta, use_ratio=use_ratio)
        eps = 1e-8
        opt, bc1, bc2 = adam_moments(g_params, opt)
        updates = {k: -lr * (opt.m[k] / bc1)
                   / (torch.sqrt(opt.v[k] / bc2) + eps) for k in params}
        new_params = lottery.masked_update(params, updates, mask,
                                           variant_decay, lr)
        # the discriminator trains normally (its own Adam)
        new_disc, disc_opt = adam_update(g_disc, disc_opt, disc, lr=lr,
                                         eps=eps)
        frac = lottery.mask_fraction(mask)
    return (new_params, new_disc, opt, disc_opt, loss.detach(),
            rank.detach(), adv.detach(), frac)


@dataclasses.dataclass
class MosesAdapter:
    """Stateful wrapper used inside the tuning loop (one per target device).

    `cost_model` selects the scoring network the adaptation phases run
    through (any `CostModel`); None keeps the paper MLP. The discriminator
    is sized to the model's exposed hidden dimension either way, and every
    tensor lives where `params` lives. `rng` is a generator on that device
    for the ranking loss's pair indices; the numpy streams (source batches,
    target shuffles) are seeded exactly as in the reference.
    """
    cfg: MosesConfig
    params: Params
    disc: Params = None
    opt: AdamState = None
    disc_opt: AdamState = None
    source_pool: Optional[Records] = None
    rng: torch.Generator = None
    history: List[dict] = dataclasses.field(default_factory=list)
    ratio_override: Optional[float] = None
    cost_model: Optional[CostModel] = None

    def __post_init__(self):
        self._device = params_device(self.params)
        self._forward = (self.cost_model.forward
                         if self.cost_model is not None else None)
        if self.rng is None:
            self.rng = torch.Generator(device=self._device).manual_seed(
                self.cfg.seed)
        if self.disc is None:
            hidden = (self.cost_model.hidden_dim
                      if self.cost_model is not None
                      else self.cfg.cost_model.hidden_dims[-1])
            self.disc = init_discriminator(self.cfg.seed, hidden,
                                           torch_device=self._device)
        if self.opt is None:
            self.opt = adam_init(self.params)
        if self.disc_opt is None:
            self.disc_opt = adam_init(self.disc)

    def _source_batch(self, size: int) -> Optional[Batch]:
        if self.source_pool is None or len(self.source_pool) == 0:
            return None
        rng = np.random.RandomState(len(self.history))
        idx = rng.randint(0, len(self.source_pool), size=size)
        return {k: torch.as_tensor(getattr(self.source_pool, k)[idx],
                                   device=self._device) for k in "xyg"}

    def adapt(self, target_records: Records, epochs: Optional[int] = None,
              pad: bool = True) -> Params:
        """Run lottery-ticket adaptation phases on the target records.

        pad=True (default) bucket-pads target minibatches as the reference
        does; padded rows are masked out of every loss term."""
        cfg = self.cfg
        n_epochs = epochs if epochs is not None else cfg.adaptation_epochs
        bs = cfg.cost_model.batch_size
        rng_np = np.random.RandomState(1234 + len(self.history))
        ratio = (self.ratio_override if self.ratio_override is not None
                 else cfg.transferable_ratio)
        for _ in range(n_epochs):
            for batch_t in target_records.batches(bs, rng_np, pad=pad,
                                                  torch_device=self._device):
                batch_s = self._source_batch(len(batch_t["x"]))
                (self.params, self.disc, self.opt, self.disc_opt, loss, rank,
                 adv, frac) = _adapt_phase(
                    self.params, self.disc, self.opt, self.disc_opt,
                    batch_t, batch_s, self.rng,
                    cfg.adaptation_lr, ratio, cfg.distill_threshold,
                    cfg.variant_weight_decay, cfg.adversarial_beta,
                    cfg.cost_model.rank_pairs_per_batch,
                    cfg.use_ratio_ranking, self._forward)
                loss, rank, adv, frac = torch.stack(
                    [loss, rank, adv, frac.to(loss.dtype)]).tolist()
                self.history.append({"loss": loss, "rank": rank, "adv": adv,
                                     "mask_frac": frac})
        return self.params
