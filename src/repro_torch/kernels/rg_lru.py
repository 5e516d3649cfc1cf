"""RG-LRU linear scan h_t = a_t * h_{t-1} + x_t: a CUDA C++ kernel for
Hopper (`csrc/rg_lru.cu`) and its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/rg_lru.py:rg_lru` (body
`_lru_kernel`). How the kernel launches follows from `plan` alone:
  lanes  : width lanes of one CTA, 32, or 16 where B * ceil(W / 32) < 132,
           so that the CTAs spread over the SMs (160 at B = 1, W = 2560)
  stages : ring stages of 64 steps x lanes of a and x in shared memory, as
           many as the sequence needs up to 8 and 64 KB
  route  : "tma" where a row of W elements is a multiple of 16 bytes (TMA
           boxes), else "ldg" (the producer warp's plain loads)
The Moses knobs `chunk` and `block_w` mean nothing on Hopper: they are
checked and passed to `plan`, but no launch and no result depends on them.
`unroll` is tuned but read by no kernel, as in the reference.

a and x are [B, S, W], both float32 or both bf16; the output is float32
[B, S, W], with h_0 = 0 and a float32 carry. Kernel and plain version
multiply then add, each rounded, so they agree bit for bit.

Bound on an H100 SXM: 2 * B * S * W * in_bytes + B * S * W * 4 bytes over
3.35 TB/s. See the note at the top of `csrc/rg_lru.cu`.

`rg_lru` launches the kernel for CUDA tensors, or raises; it takes the plain
version only for tensors on the CPU, which is how the CPU tests reach the
same arithmetic. `rg_lru.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
SMS = 132                  # streaming multiprocessors of an H100 SXM
STAGE_STEPS = 64           # sequence steps of one ring stage
MAX_STAGES = 8
MAX_RING_BYTES = 64 * 1024


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


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one scan call launches."""
    lanes: int        # width lanes of one CTA
    ctas: int
    stage_steps: int  # sequence steps of one ring stage
    stages: int       # ring stages
    route: str        # "tma" or "ldg"
    smem_bytes: int   # dynamic shared memory of one CTA


@functools.lru_cache(maxsize=4096)
def plan(B: int, S: int, W: int, dtype, chunk: int, block_w: int) -> Plan:
    """The launch plan of one call (rules in the module docstring). chunk
    and block_w are only checked. A pure function of its arguments,
    cached: the wrapper asks it on every call."""
    if min(B, S, W, chunk, block_w) < 1:
        raise ValueError("rg_lru needs B, S, W, chunk and block_w of at "
                         "least 1")
    in_bytes = 2 if dtype in (torch.bfloat16, "bfloat16") else 4
    lanes = 32 if B * -(-W // 32) >= SMS else 16
    ctas = B * -(-W // lanes)
    if ctas > 2 ** 31 - 1:
        raise ValueError(f"B={B}, W={W} needs more than 2**31 - 1 CTAs")
    stage_bytes = 2 * STAGE_STEPS * lanes * in_bytes
    stages = max(1, min(MAX_STAGES, -(-S // STAGE_STEPS),
                        MAX_RING_BYTES // stage_bytes))
    route = "tma" if W * in_bytes % 16 == 0 else "ldg"
    # csrc/rg_lru.cu:smem_bytes: 128 bytes of alignment slack, the ring and
    # a full and an empty mbarrier per stage
    return Plan(lanes, ctas, STAGE_STEPS, stages, route,
                128 + stages * stage_bytes + 2 * stages * 8)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/rg_lru.cu, built and loaded at first
    use."""
    fn = build.load("rg_lru").repro_rg_lru
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return fn


def rg_lru(a: torch.Tensor, x: torch.Tensor, *, chunk: int = 256,
           block_w: int = 256) -> torch.Tensor:
    """The scan; (chunk, block_w) are the tuned knobs, which no launch
    reads. CUDA tensors launch the kernel as `plan` says on the current
    stream (no synchronisation); CPU tensors take `rg_lru_plain`."""
    _check(a, x, chunk, block_w)
    if a.device.type == "cpu":
        return rg_lru_plain(a, x, chunk=chunk, block_w=block_w)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru runs on CUDA or CPU tensors, not "
                         f"{a.device}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("rg_lru's kernel needs contiguous a and x")
    B, S, W = a.shape
    p = plan(B, S, W, a.dtype, chunk, block_w)
    if p.route == "tma":
        # TMA reads from 16-byte aligned bases: a fresh copy is
        a, x = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, x))
    out = torch.empty((B, S, W), device=a.device, dtype=torch.float32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel()(a.data_ptr(), x.data_ptr(), out.data_ptr(), B, S, W,
                        p.lanes, p.stages, int(p.route == "tma"),
                        int(a.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rg_lru kernel launch failed with CUDA error "
                           f"{err} (B={B} S={S} W={W}): {p}")
    rg_lru.launches += 1
    return out


rg_lru.launches = 0
