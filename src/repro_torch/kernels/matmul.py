"""Tiled matmul, the primary auto-tuning target: a CUDA C++ kernel for
Hopper (`csrc/matmul.cu`) and its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/matmul.py:matmul` (bodies
`_matmul_kernel_kinner` and `_matmul_kernel_kouter`). The Moses knobs keep
their meaning:
  block_m/n/k : the tuned tile, clamped to the dims as the TPU kernel does;
                one CTA per (block_m, block_n) output tile, K in block_k
                blocks
  k_inner     : 1 -> float32 accumulation, one store in the output dtype;
                0 -> the output tile accumulates the blocks' partials, so a
                     bf16 output rounds at every block_k boundary, exactly
                     where the TPU kernel's output revisits round
  out_bf16    : output dtype (bf16 or float32)

Bound on an H100 SXM: the larger of 2MNK over the input type's peak (989
TFLOP/s bf16, 67 TFLOP/s float32 without TF32) and (MK + KN) * in_bytes +
MN * out_bytes over 3.35 TB/s. The first design is simple and right
(float32 FMA on CUDA cores, 64 x 64 sub-tiles through static shared memory,
masked edges, no padded copies); it does not approach the bound yet. See
the note at the top of `csrc/matmul.cu`.

`matmul` launches the kernel for CUDA tensors, or raises; it takes the
plain version only for tensors on the CPU, which is how the CPU tests reach
the same arithmetic. `matmul.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


def _check(a: torch.Tensor, b: torch.Tensor, block_m: int, block_n: int,
           block_k: int):
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError("matmul takes two tensors")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul needs A [M, K] and B [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPES or a.dtype != b.dtype:
        raise TypeError(f"matmul takes two float32 or two bfloat16 tensors, "
                        f"got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"A is on {a.device}, B on {b.device}")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError("matmul needs M, N and K of at least 1")
    if min(block_m, block_n, block_k) < 1:
        raise ValueError("block sizes must be at least 1")


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
                 block_n: int = 128, block_k: int = 128, k_inner: bool = True,
                 out_bf16: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel: a float32 loop over k blocks
    that rounds where the kernel rounds. block_m/block_n do not change the
    result and are only checked. On a card, call it with TF32 off."""
    _check(a, b, block_m, block_n, block_k)
    M, K = a.shape
    bk = min(block_k, K)
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    round_each_block = (not k_inner) and out_bf16
    acc = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, bk):
        part = a32[:, k0:k0 + bk] @ b32[k0:k0 + bk]
        if round_each_block:
            acc = (acc + part.to(torch.bfloat16).float()).to(
                torch.bfloat16).float()
        else:
            acc = acc + part
    return acc.to(torch.bfloat16 if out_bf16 else torch.float32)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/matmul.cu, built and loaded at first use."""
    fn = build.load("matmul").repro_matmul
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    return fn


def _launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, bm: int,
            bn: int, bk: int, round_each_block: bool) -> None:
    fn = _kernel()
    M, K = a.shape
    N = b.shape[1]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, bm, bn,
                 bk, int(a.dtype == torch.bfloat16),
                 int(out.dtype == torch.bfloat16), int(round_each_block),
                 stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed with CUDA error "
                           f"{err} (M={M} N={N} K={K} tile={bm}x{bn}x{bk})")


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
           block_n: int = 128, block_k: int = 128, k_inner: bool = True,
           out_bf16: bool = False) -> torch.Tensor:
    """C = A @ B with the tuned tile. CUDA tensors launch the kernel on the
    current stream (no synchronisation); CPU tensors take `matmul_plain`."""
    _check(a, b, block_m, block_n, block_k)
    if a.device.type == "cpu":
        return matmul_plain(a, b, block_m=block_m, block_n=block_n,
                            block_k=block_k, k_inner=k_inner,
                            out_bf16=out_bf16)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on CUDA or CPU tensors, not "
                         f"{a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul's kernel needs contiguous row-major A and B")
    M, K = a.shape
    N = b.shape[1]
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    if -(-N // bn) > 65535:
        raise ValueError(f"N={N} with block_n={bn} needs more than 65535 "
                         f"column tiles")
    out = torch.empty((M, N), device=a.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    _launch(a, b, out, bm, bn, bk, (not k_inner) and out_bf16)
    matmul.launches += 1
    return out


matmul.launches = 0
