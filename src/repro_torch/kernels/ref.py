"""Plain-torch oracles for the port's kernels (the allclose ground truth),
port of `repro.kernels.ref`."""
from __future__ import annotations

import math

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_bf16: bool = False) -> torch.Tensor:
    """A @ B accumulated in float32, stored in bf16 or float32. Call with
    `torch.backends.cuda.matmul.allow_tf32 = False` on a card."""
    out = a.to(torch.float32) @ b.to(torch.float32)
    return out.to(torch.bfloat16 if out_bf16 else torch.float32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale=None) -> torch.Tensor:
    """q, k, v: [B, S, D] (single head). Returns [B, S, D] float32: the full
    masked softmax, with masked logits at -1e30."""
    B, S, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[None], logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float())


def rg_lru_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear recurrence h_t = a_t * h_{t-1} + x_t, h_0 = 0. a, x:
    [B, S, W]; a sequential float32 loop."""
    a, x = a.float(), x.float()
    h = torch.zeros_like(a[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        out.append(h)
    return torch.stack(out, dim=1)
