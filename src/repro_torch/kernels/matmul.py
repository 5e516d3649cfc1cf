"""Tiled matmul, the primary auto-tuning target: two CUDA C++ kernels for
Hopper and their plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/matmul.py:matmul` (bodies
`_matmul_kernel_kinner` and `_matmul_kernel_kouter`). Which kernel runs
follows from `plan` alone, before any launch:

  wgmma : `csrc/matmul_wgmma.cu`, bf16 inputs. Tensor cores (wgmma) fed by
          TMA through a ring of shared-memory stages, a CTA tile of the
          kernel's own (128 x 128 or 128 x 256) and a grid that fills the
          card, with split-K where the output tiles are too few.
  simt  : `csrc/matmul.cu`, CUDA-core float32 FMA, for what the tensor cores
          cannot take: float32 inputs (no TF32: it would break the float32
          tolerance), and k_inner=0 with a bf16 output where a rounding
          boundary falls inside a 16-deep wgmma step (bk % 16 != 0, bk < K).

The Moses knobs on Hopper (bk = min(block_k, K), with the unpadded K):
  block_m/n : wgmma: the raster group. The CTA tiles that cover one tuned
              block_m x block_n tile get consecutive indices, so they run
              together and share A and B panels in L2. simt: one CTA per
              tuned tile. Neither changes the result.
  block_k   : bk is the rounding unit (k_inner=0, bf16 output) and the
              split unit: split-K points fall on multiples of bk, so each
              split sums whole TPU k blocks in float32.
  k_inner   : 1 -> float32 accumulation, one store in the output dtype;
              0 -> the output accumulates the blocks' partials, so a bf16
                   output rounds at every bk boundary, exactly where the TPU
                   kernel's output revisits round
  out_bf16  : output dtype (bf16 or float32)
  unroll    : read by no kernel, as in the reference

wgmma's CTA tile: 128 x 128 with round_each_block; otherwise 128 x 256 when
the 128 x 256 tiles alone number at least 132 (one per SM), else 128 x 128.
Split-K (only when the output accumulates in float32, i.e. not
round_each_block): when the output tiles number fewer than 132, K is cut
into at most 132 // tiles splits of whole units, a unit being lcm(bk, 64)
elements, each split as short as that allows; the float32 partials go to a
workspace [splits, M, N] and a second kernel adds them in split order.
TMA needs 16-byte rows, so K (A's columns and B's rows) and B's N are
zero-padded to multiples of 8 where they are not; zeros add exactly 0.

Bound on an H100 SXM: the larger of 2MNK over the input type's peak (989
TFLOP/s bf16, 67 TFLOP/s float32 without TF32) and (MK + KN) * in_bytes +
MN * out_bytes over 3.35 TB/s.

`matmul` launches a kernel for CUDA tensors, or raises; it takes the plain
version only for tensors on the CPU, which is how the CPU tests reach the
same arithmetic. `matmul.launches` counts kernel launches and
`matmul.launches_by_variant` splits them by variant.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
SMS = 132      # streaming multiprocessors of an H100 SXM
CTA_M = 128    # rows of a wgmma CTA tile (two consumer warpgroups)
STAGE_K = 64   # k depth of one wgmma pipeline stage


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


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one matmul call launches. Tiles and groups count CTA tiles."""
    variant: str            # "wgmma" or "simt"
    M: int
    N: int
    K: int
    bk: int                 # min(block_k, K): rounding and split unit
    round_each_block: bool  # k_inner=0 with a bf16 output
    out_bf16: bool
    cta_m: int
    cta_n: int
    tiles_m: int
    tiles_n: int
    group_m: int            # raster group (wgmma)
    group_n: int
    splits: int
    split_k: int            # k elements per split
    ctas: int
    lda: int                # row length of A as launched (K padded to 8)
    ldb: int                # row length of B as launched (N padded to 8)
    pad_bytes: int          # bytes of the zero-padded copies of A and B


def _round8(x: int) -> int:
    return -(-x // 8) * 8


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int, dtype, block_m: int, block_n: int,
         block_k: int, k_inner: bool, out_bf16: bool) -> Plan:
    """The launch plan of one call: variant, CTA tile, raster group, k
    splits, grid size and padding (rules in the module docstring). A pure
    function of its arguments, cached: the wrapper asks it on every call."""
    if min(M, N, K) < 1 or min(block_m, block_n, block_k) < 1:
        raise ValueError("matmul needs M, N, K and block sizes of at least 1")
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    rnd = (not k_inner) and out_bf16
    in_bf16 = dtype in (torch.bfloat16, "bfloat16")
    if not in_bf16 or (rnd and bk % 16 != 0 and bk < K):
        tiles_m, tiles_n = -(-M // bm), -(-N // bn)
        if tiles_n > 65535:
            raise ValueError(f"N={N} with block_n={bn} needs more than 65535 "
                             f"column tiles")
        return Plan("simt", M, N, K, bk, rnd, out_bf16, bm, bn, tiles_m,
                    tiles_n, 1, 1, 1, K, tiles_m * tiles_n, K, N, 0)
    tiles_m = -(-M // CTA_M)
    cta_n = 256 if not rnd and tiles_m * -(-N // 256) >= SMS else 128
    tiles_n = -(-N // cta_n)
    tiles = tiles_m * tiles_n
    splits, split_k = 1, K
    if not rnd and tiles < SMS:
        unit = bk * STAGE_K // math.gcd(bk, STAGE_K)
        units = -(-K // unit)
        most = min(units, SMS // tiles)
        if most > 1:
            per = -(-units // most)
            splits, split_k = -(-units // per), per * unit
    lda, ldb = _round8(K), _round8(N)
    pad = 0
    if lda != K:
        pad += M * lda * 2
    if lda != K or ldb != N:
        pad += lda * ldb * 2
    return Plan("wgmma", M, N, K, bk, rnd, out_bf16, CTA_M, cta_n, tiles_m,
                tiles_n, min(tiles_m, max(1, -(-bm // CTA_M))),
                min(tiles_n, max(1, -(-bn // cta_n))), splits, split_k,
                tiles * splits, lda, ldb, pad)


def cta_tiles(p: Plan) -> List[Tuple[int, int]]:
    """(tile row, tile column) of each CTA of one k split, in launch order:
    the kernel's `raster`. Bands of group_m tile rows at full width; in a
    band, groups of group_n tile columns; in a group, column by column."""
    out = []
    for t in range(p.tiles_m * p.tiles_n):
        band = t // (p.group_m * p.tiles_n)
        rows = min(p.group_m, p.tiles_m - band * p.group_m)
        local = t - band * p.group_m * p.tiles_n
        gcol = local // (rows * p.group_n)
        off = local - gcol * rows * p.group_n
        out.append((band * p.group_m + off % rows, gcol * p.group_n + off // rows))
    return out


def _padded(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """x zero-padded to [rows, cols] in fresh, so 16-byte aligned, memory."""
    out = F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))
    return out.clone() if out.data_ptr() == x.data_ptr() else out


def pad_operands(a: torch.Tensor, b: torch.Tensor, p: Plan):
    """A [M, lda] and B [K, ldb] as the wgmma kernel reads them: zero-padded
    copies where the plan pads, or where a base is not 16-byte aligned."""
    K, N = b.shape
    if p.lda != K or a.data_ptr() % 16:
        a = _padded(a, a.shape[0], p.lda)
    if p.lda != K or p.ldb != N or b.data_ptr() % 16:
        b = _padded(b, p.lda, p.ldb)
    return a, b


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/matmul.cu (simt), built and loaded at first
    use."""
    fn = build.load("matmul").repro_matmul
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _wgmma_kernel():
    """The C entry point of csrc/matmul_wgmma.cu, built and loaded at first
    use."""
    fn = build.load("matmul_wgmma").repro_matmul_wgmma
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    return fn


def _launch_simt(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                 p: Plan) -> None:
    fn = _kernel()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), p.M, p.N, p.K,
             p.cta_m, p.cta_n, p.bk, int(a.dtype == torch.bfloat16),
             int(p.out_bf16), int(p.round_each_block), stream)
    if err != 0:
        raise RuntimeError(f"matmul simt kernel launch failed with CUDA "
                           f"error {err}: {p}")


def _launch_wgmma(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                  p: Plan) -> None:
    fn = _wgmma_kernel()
    a, b = pad_operands(a, b, p)
    ws = (torch.empty((p.splits, p.M, p.N), device=a.device,
                      dtype=torch.float32) if p.splits > 1 else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), p.M, p.N, p.K, p.lda,
             p.ldb, p.bk, p.cta_n, p.group_m, p.group_n, p.splits, p.split_k,
             int(p.round_each_block), int(p.out_bf16), stream)
    if err != 0:
        raise RuntimeError(f"matmul wgmma kernel launch failed with CUDA "
                           f"error {err}: {p}")


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
           block_n: int = 128, block_k: int = 128, k_inner: bool = True,
           out_bf16: bool = False) -> torch.Tensor:
    """C = A @ B with the tuned knobs. CUDA tensors launch the kernel that
    `plan` names on the current stream (no synchronisation); CPU tensors
    take `matmul_plain`."""
    _check(a, b, block_m, block_n, block_k)
    if a.device.type == "cpu":
        return matmul_plain(a, b, block_m=block_m, block_n=block_n,
                            block_k=block_k, k_inner=k_inner,
                            out_bf16=out_bf16)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on CUDA or CPU tensors, not "
                         f"{a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul's kernels need contiguous row-major A and B")
    M, K = a.shape
    N = b.shape[1]
    p = plan(M, N, K, a.dtype, block_m, block_n, block_k, bool(k_inner),
             bool(out_bf16))
    out = torch.empty((M, N), device=a.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    with torch.cuda.device(a.device):
        if p.variant == "wgmma":
            _launch_wgmma(a, b, out, p)
        else:
            _launch_simt(a, b, out, p)
    matmul.launches += 1
    matmul.launches_by_variant[p.variant] += 1
    return out


matmul.launches = 0
matmul.launches_by_variant = {"wgmma": 0, "simt": 0}
