"""Flash attention (causal / sliding-window): a CUDA C++ kernel for Hopper
(`csrc/flash_attention.cu`) and its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py:
flash_attention` (body `_fa_kernel`). The Moses knobs keep their meaning:
  block_q  : q rows of one CTA's unit of work, clamped to S
  block_kv : kv columns per online-softmax step (the running max is updated
             once per block, so P rounds against the same max as on the
             TPU), clamped to S
`stages` and `unroll` are tuned but read by no kernel, as in the reference.

q, k, v are [B, S, D] with B = batch * heads, all float32 or all bf16, and
D <= 256; the output is float32 [B, S, D]. Masks are the reference's: causal
keeps k <= q, and `window > 0` keeps k > q - window, also when `causal` is
false. Masked logits are -1e30, a row with nothing kept gives 0.

Bound on an H100 SXM: the larger of 4 * B * S^2 * D (halved when causal)
FLOPs over 989 TFLOP/s for bf16 (67 TFLOP/s for float32 without TF32), and
3 * B * S * D * in_bytes + B * S * D * 4 bytes over 3.35 TB/s. The first
design is simple and right (float32 FMA on CUDA cores, 16-row sub-tiles and
32-row K/V slabs through shared memory); it does not approach the bound
yet. See the note at the top of `csrc/flash_attention.cu`.

`flash_attention` launches the kernel for CUDA tensors, or raises; it takes
the plain version only for tensors on the CPU, which is how the CPU tests
reach the same arithmetic. `flash_attention.launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           block_q: int, block_kv: int):
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes three tensors")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention needs q, k, v of one shape "
                         f"[B, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes three float32 or three "
                        f"bfloat16 tensors, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device} and "
                         f"{v.device}")
    if min(q.shape) < 1:
        raise ValueError("flash_attention needs B, S and D of at least 1")
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[2]} is above the kernel's "
                         f"{MAX_HEAD_DIM}")
    if min(block_q, block_kv) < 1:
        raise ValueError("block sizes must be at least 1")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          block_q: int = 128, block_kv: int = 128,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: a float32 online-softmax
    loop over block_kv blocks with the kernel's guards and its cast of P.
    block_q does not change the result and is only checked. On a card,
    call it with TF32 off."""
    _check(q, k, v, window, block_q, block_kv)
    B, S, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bkv = min(block_kv, S)
    qf, kf, vf = q.float(), k.float(), v.float()
    q_pos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, bkv):
        k1 = min(k0 + bkv, S)
        s = (qf @ kf[:, k0:k1].transpose(1, 2)) * scale
        k_pos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = torch.ones((S, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window > 0:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where((m_new == NEG_INF)[..., None], torch.zeros_like(p), p)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(v.dtype).float() @ vf[:, k0:k1]
        m = m_new
    return acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/flash_attention.cu, built and loaded at
    first use."""
    fn = build.load("flash_attention").repro_flash_attention
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, block_q: int = 128,
                    block_kv: int = 128,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with the tuned blocks; `scale` defaults to
    1/sqrt(D). CUDA tensors launch the kernel on the current stream (no
    synchronisation); CPU tensors take `flash_attention_plain`."""
    _check(q, k, v, window, block_q, block_kv)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_kv=block_kv,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention's kernel needs contiguous q, k, v")
    B, S, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bq, bkv = min(block_q, S), min(block_kv, S)
    if -(-S // bq) > 65535:
        raise ValueError(f"S={S} with block_q={bq} needs more than 65535 "
                         f"q tiles")
    if B > 2 ** 31 - 1:
        raise ValueError(f"B={B} is above the grid's 2**31 - 1")
    out = torch.empty((B, S, D), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, S, D, bq, bkv, int(causal),
                        int(window), float(scale),
                        int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed with CUDA "
                           f"error {err} (B={B} S={S} D={D} "
                           f"blocks={bq}x{bkv})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
