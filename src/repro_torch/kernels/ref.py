"""Plain-torch oracles for the port's kernels (the allclose ground truth),
port of `repro.kernels.ref`."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_bf16: bool = False) -> torch.Tensor:
    """A @ B accumulated in float32, stored in bf16 or float32. Call with
    `torch.backends.cuda.matmul.allow_tf32 = False` on a card."""
    out = a.to(torch.float32) @ b.to(torch.float32)
    return out.to(torch.bfloat16 if out_bf16 else torch.float32)
