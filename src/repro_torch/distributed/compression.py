"""Gradient compression: int8 all-reduce with error feedback (port of
`repro.distributed.compression`).

Quantize (g + e) to int8 with a per-tensor scale, all-reduce the int8
payload (as int32 accumulators, to avoid overflow across >= 512 ranks),
dequantize, and keep the local quantization error e for the next step
(error feedback — Seide et al. 2014 / Karimireddy et al. 2019 guarantees
convergence).

Exposed both as a collective over a process group (compressed_psum) and a
pure single-process simulator (simulate_compressed_allreduce) used by
tests.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, error: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None):
    """Returns (mean-reduced x_hat, new local error) over `group` (default:
    the default process group).

    Two-phase: (1) all_reduce MAX of the per-rank scale so all ranks
    quantize onto the same grid; (2) all_reduce SUM of the int8 payload
    (int32 accumulators). Wire bytes of the payload are those of int32
    (gloo and NCCL reduce no int8 into int32); the scale's reduction is
    O(1).
    """
    v = x.float() + error
    scale = torch.clamp(v.abs().max() / 127.0, min=1e-12)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    new_error = v - q.float() * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return total.float() * scale / n, new_error


def simulate_compressed_allreduce(shards: Sequence[torch.Tensor],
                                  errors: Sequence[torch.Tensor]):
    """Single-process simulation of compressed_psum over per-worker
    shards."""
    vs = [x.float() + e for x, e in zip(shards, errors)]
    scale = torch.clamp(torch.stack([v.abs().max() for v in vs]).max()
                        / 127.0, min=1e-12)
    qs = [torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
          for v in vs]
    new_errors = [v - q.float() * scale for v, q in zip(vs, qs)]
    total = sum(q.to(torch.int32) for q in qs)
    mean = total.float() * scale / len(shards)
    return mean, new_errors
