"""AdamW from scratch (port of `repro.train.optimizer`).

Supports, as the reference does:
  - configurable moment dtype (bf16 moments for >100B archs, fp32 default)
  - fp32 master weights when params are bf16 (the master lives in the
    optimizer state)
  - global-norm gradient clipping
  - cosine schedule with linear warmup

The arithmetic and its rounding points are the reference's: gradients cast
to float32 and clipped by min(1, clip / max(gnorm, 1e-9)); the learning rate
taken at the count after its increment; bias corrections 1 - b**count in
float32; weight decay added to the step, not to the gradient; moments
stored in `moment_dtype`. The step count, the learning rate and the
metrics stay 0-d tensors on the params' device, so an update never waits
for the card.

`update` writes in place into the tensors it was given (params, moments,
master, count) and returns them: the port's counterpart of the reference
jit's `donate_argnums=(0,)`. An update that returned new tensors would hold
a second copy of the params and moments, which full RecurrentGemma-2B's
float32 state (46 GB with its gradients) leaves no room for on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models.common import dtype_of, tree_leaves, tree_map

PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Schedule:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant_schedule(base_lr: float) -> Schedule:
    return lambda step: torch.tensor(base_lr, dtype=torch.float32,
                                     device=step.device)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Schedule | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0
    moment_dtype: str = "float32"
    master_fp32: bool = False  # keep fp32 master copy when params are low-prec


def _device(params: PyTree) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


class AdamW:
    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg
        self._lr = cfg.lr if callable(cfg.lr) else constant_schedule(cfg.lr)

    def init(self, params: PyTree) -> PyTree:
        mdt = dtype_of(self.cfg.moment_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)

        state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                 "count": torch.zeros((), dtype=torch.int32,
                                      device=_device(params))}
        if self.cfg.master_fp32:
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    @torch.no_grad()
    def update(self, grads: PyTree, state: PyTree, params: PyTree):
        """One AdamW step: writes the new params, moments, master and count
        into the given tensors and returns (params, state, {"grad_norm",
        "lr"}), the metrics as 0-d float32 tensors."""
        cfg = self.cfg
        count = state["count"]
        count.add_(1)
        gnorm = global_norm(grads)
        scale = None
        if cfg.grad_clip_norm > 0:
            scale = torch.clamp(cfg.grad_clip_norm
                                / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = self._lr(count)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - torch.pow(b1, count.float())
        bc2 = 1 - torch.pow(b2, count.float())
        base = state["master"] if cfg.master_fp32 else params

        def upd(g, m, v, p, q):
            # every temporary is one leaf's size; `m32`/`v32`/`p32` alias
            # a float32 leaf (`.float()` returns it), so the in-place ops
            # below write it, each op at the reference's rounding point
            g32 = (g.float() * scale if scale is not None
                   else g.to(torch.float32, copy=True))
            m32 = m.float().mul_(b1).add_(g32 * (1 - b1))
            v32 = v.float().mul_(b2).add_(g32.square_().mul_(1 - b2))
            del g32
            step = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
            for moment, new in ((m, m32), (v, v32)):
                if new is not moment:
                    moment.copy_(new)
            del m32, v32
            p32 = p.float()
            if cfg.weight_decay > 0:
                step.add_(cfg.weight_decay * p32)
            p32.sub_(step.mul_(lr))
            if p32 is not p:
                p.copy_(p32)
            if q is not p:
                q.copy_(p32)

        tree_map(upd, grads, state["m"], state["v"], base, params)
        return params, state, {"grad_norm": gnorm, "lr": lr}


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)
