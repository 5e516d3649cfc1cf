"""RG-LRU linear scan h_t = a_t * h_{t-1} + x_t: a CUDA C++ kernel for
Hopper (`csrc/rg_lru.cu`) and its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/rg_lru.py:rg_lru` (body
`_lru_kernel`). The Moses knobs keep their meaning:
  chunk   : sequence steps per tuned chunk, clamped to S
  block_w : width lanes per CTA, one thread each, clamped to W (at most
            1024, a CTA's most threads)
`unroll` is tuned but read by no kernel, as in the reference.

a and x are [B, S, W], both float32 or both bf16; the output is float32
[B, S, W], with h_0 = 0 and a float32 carry.

Bound on an H100 SXM: 2 * B * S * W * in_bytes + B * S * W * 4 bytes over
3.35 TB/s. The first design keeps each lane's carry in a register and
walks the S dependent steps in turn, so with few lanes it is bound by the
dependence, not by bytes. See the note at the top of `csrc/rg_lru.cu`.

`rg_lru` launches the kernel for CUDA tensors, or raises; it takes the plain
version only for tensors on the CPU, which is how the CPU tests reach the
same arithmetic. `rg_lru.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_BLOCK_W = 1024
_DTYPES = (torch.float32, torch.bfloat16)


def _check(a: torch.Tensor, x: torch.Tensor, chunk: int, block_w: int):
    if not (isinstance(a, torch.Tensor) and isinstance(x, torch.Tensor)):
        raise TypeError("rg_lru takes two tensors")
    if a.dim() != 3 or x.shape != a.shape:
        raise ValueError(f"rg_lru needs a and x of one shape [B, S, W], got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    if a.dtype not in _DTYPES or x.dtype != a.dtype:
        raise TypeError(f"rg_lru takes two float32 or two bfloat16 tensors, "
                        f"got {a.dtype} and {x.dtype}")
    if a.device != x.device:
        raise ValueError(f"a is on {a.device}, x on {x.device}")
    if min(a.shape) < 1:
        raise ValueError("rg_lru needs B, S and W of at least 1")
    if min(chunk, block_w) < 1:
        raise ValueError("chunk and block_w must be at least 1")


def rg_lru_plain(a: torch.Tensor, x: torch.Tensor, *, chunk: int = 256,
                 block_w: int = 256) -> torch.Tensor:
    """The plain PyTorch version of the kernel: a float32 loop over t,
    vectorised over [B, W]. chunk and block_w do not change the result and
    are only checked."""
    _check(a, x, chunk, block_w)
    B, S, W = a.shape
    af, xf = a.float(), x.float()
    out = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = af[:, t] * h + xf[:, t]
        out[:, t] = h
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/rg_lru.cu, built and loaded at first
    use."""
    fn = build.load("rg_lru").repro_rg_lru
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    return fn


def rg_lru(a: torch.Tensor, x: torch.Tensor, *, chunk: int = 256,
           block_w: int = 256) -> torch.Tensor:
    """The scan with the tuned (chunk, block_w). CUDA tensors launch the
    kernel on the current stream (no synchronisation); CPU tensors take
    `rg_lru_plain`."""
    _check(a, x, chunk, block_w)
    if a.device.type == "cpu":
        return rg_lru_plain(a, x, chunk=chunk, block_w=block_w)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru runs on CUDA or CPU tensors, not "
                         f"{a.device}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("rg_lru's kernel needs contiguous a and x")
    B, S, W = a.shape
    ck, bw = min(chunk, S), min(block_w, W)
    if bw > MAX_BLOCK_W:
        raise ValueError(f"block_w={bw} is above a CTA's {MAX_BLOCK_W} "
                         f"threads")
    if B * -(-W // bw) > 2 ** 31 - 1:
        raise ValueError(f"B={B}, W={W} with block_w={bw} needs more than "
                         f"2**31 - 1 CTAs")
    out = torch.empty((B, S, W), device=a.device, dtype=torch.float32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel()(a.data_ptr(), x.data_ptr(), out.data_ptr(), B, S, W,
                        ck, bw, int(a.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rg_lru kernel launch failed with CUDA error "
                           f"{err} (B={B} S={S} W={W} chunk={ck} "
                           f"block_w={bw})")
    rg_lru.launches += 1
    return out


rg_lru.launches = 0
