"""Drift-aware continual update: lottery-mask-anchored L2 (EWC-lite), PyTorch
port of `repro.continual.regularize`.

EWC penalizes parameter movement weighted by Fisher importance; Moses
already computes an importance structure every adaptation phase — the
lottery mask (Eq. 5) separating transferable (hardware-independent) from
domain-variant parameters. The continual refresh reuses that mask as the
importance prior:

  * transferable parameters are *anchored* to the serving version with an
    L2 pull — they encode the cross-device winning ticket the hub transfers,
    and letting them drift would silently invalidate every sibling device's
    warm start;
  * variant parameters fit the new data freely — they are exactly the
    hardware-response weights that distribution drift invalidates.

So the refreshed model stays close to the transferable ticket while its
hardware-facing capacity re-fits the newest records. The anchor term is
0.5 * sum(weights * (w - w_anchor)^2) added to the ranking loss; `weights`
is `strength * mask` from one gradient evaluation at the anchor point.

Both entry points run on the cost model's `torch_device` (the card unless
the caller asks for "cpu"), with autograd in place of `jax.grad` and an
explicit `torch.Generator` per job in place of the PRNG key: ranking pairs
are drawn with `torch.randint`, so they differ from JAX's, and `pairs=`
hands a test the indices JAX drew. Matmuls stay in full float32 (PyTorch's
default: TF32 off).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lottery
from repro_torch.core.cost_model import (AdamState, Batch, CostModel, Pairs,
                                         Params, Records, adam_init,
                                         adam_update, bucket_size,
                                         loss_and_grad, model_loss, pad_rows,
                                         resolve_cost_model)
from repro_torch.core.placement import TorchDevice


def _full_batch(records: Records, torch_device: torch.device,
                pad: bool = True) -> Batch:
    """The whole record set as one (optionally bucket-padded) batch."""
    x, y, g = records.x, records.y, records.g
    m = np.ones(len(x), np.float32)
    if pad:
        b = bucket_size(len(x))
        x, y, m = pad_rows(x, b), pad_rows(y, b), pad_rows(m, b)
        g = np.concatenate([g, np.full(b - len(records), -1, g.dtype)])
    return {k: torch.as_tensor(v, device=torch_device)
            for k, v in (("x", x), ("y", y), ("g", g), ("m", m))}


def anchor_weights(model: CostModel, params: Params, records: Records, *,
                   ratio: float = 0.5, strength: float = 1e-2,
                   seed: int = 0, pairs: Optional[Pairs] = None,
                   torch_device: TorchDevice = "cuda") -> Params:
    """The EWC-lite importance prior: `strength * lottery_mask`.

    One gradient evaluation of the ranking loss at `params` over the whole
    bucket-padded record set (padded rows never enter a pair) -> xi =
    |w * grad_w| (Eq. 5) -> top-`ratio` mask. Parameters the ticket marks
    transferable get anchor weight `strength`; the rest 0. The pairs come
    from a generator seeded with `seed` unless `pairs` gives them."""
    model = resolve_cost_model(model, torch_device=torch_device)
    params = model.clone_params(params)
    dev = model.torch_device
    batch = _full_batch(records, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # same objective anchored_train optimizes — a mask computed from a
    # different loss would misidentify which parameters are transferable
    _, grads = loss_and_grad(
        lambda p: model_loss(p, batch, gen, model.cfg.loss,
                             model.cfg.rank_pairs_per_batch, model.forward,
                             pairs), params)
    mask = lottery.transferable_mask(params, grads, ratio=ratio,
                                     use_ratio=True)
    return {k: strength * m for k, m in mask.items()}


def anchored_step(model: CostModel, params: Params, opt: AdamState,
                  batch: Batch, anchor: Params, weights: Params, lr: float,
                  generator: Optional[torch.Generator] = None,
                  pairs: Optional[Pairs] = None
                  ) -> Tuple[Params, AdamState, torch.Tensor]:
    """Loss (ranking loss + anchor penalty), gradient and one Adam step on
    one batch. The penalty sums in sorted-key order, the reference's leaf
    order."""
    cfg = model.cfg

    def total(p: Params) -> torch.Tensor:
        base = model_loss(p, batch, generator, cfg.loss,
                          cfg.rank_pairs_per_batch, model.forward, pairs)
        pen = sum(0.5 * torch.sum(weights[k] * torch.square(p[k] - anchor[k]))
                  for k in sorted(p))
        return base + pen

    loss, grads = loss_and_grad(total, params)
    params, opt = adam_update(grads, opt, params, lr=lr)
    return params, opt, loss


def anchored_train(model: CostModel, params: Params, records: Records, *,
                   anchor: Optional[Params] = None,
                   weights: Optional[Params] = None,
                   epochs: int = 8, lr: Optional[float] = None,
                   seed: int = 0, pad: bool = True,
                   torch_device: TorchDevice = "cuda"
                   ) -> Tuple[Params, List[float]]:
    """Adam + ranking loss + anchored-L2 over `records`.

    `anchor` defaults to the starting `params` (the serving version being
    refreshed); `weights` defaults to zero everywhere, i.e. plain training —
    pass `anchor_weights(...)` output for the masked EWC-lite pull. Returns
    (new params, per-epoch mean losses). Batches are the reference's
    shuffled, bucket-padded ones (`Records.batches(pad=True)`); the model
    runs on `torch_device`, which must be the one `model` lives on."""
    model = resolve_cost_model(model, torch_device=torch_device)
    dev = model.torch_device
    params = model.clone_params(params)
    anchor = model.clone_params(anchor if anchor is not None else params)
    if weights is None:
        weights = {k: torch.zeros_like(p) for k, p in params.items()}
    else:
        weights = model.clone_params(weights)
    lr = lr if lr is not None else model.cfg.lr
    rng_np = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    opt = adam_init(params)
    losses: List[float] = []
    for _ in range(epochs):
        ep_loss = torch.zeros((), device=dev)
        nb = 0
        for batch in records.batches(model.cfg.batch_size, rng_np, pad=pad,
                                     torch_device=dev):
            params, opt, loss = anchored_step(model, params, opt, batch,
                                              anchor, weights, lr, gen)
            ep_loss += loss
            nb += 1
        losses.append(float(ep_loss) / max(nb, 1))
    return params, losses
