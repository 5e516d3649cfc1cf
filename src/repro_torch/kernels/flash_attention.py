"""Flash attention (causal / sliding-window): two CUDA C++ kernels for
Hopper and their plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py:
flash_attention` (body `_fa_kernel`). Which kernel runs follows from `plan`
alone, before any launch, with no fallback:

  wgmma : `csrc/flash_attention_wgmma.cu`, bf16 q, k, v with D % 8 == 0
          (TMA reads 16-byte rows; every head dim of the LM zoo qualifies).
          Tensor cores (wgmma) fed by TMA, a q tile of the kernel's own (128
          rows when B * ceil(S / 128) >= 132, else 64) and kv tiles of 64
          rows through a ring of 2 to 4 shared-memory stages.
  simt  : `csrc/flash_attention.cu`, CUDA-core float32 FMA, for float32
          inputs (wgmma has no exact float32, and TF32 would break the
          float32 tolerance of 1e-4) and for any D that TMA cannot read.

The Moses knobs on Hopper:
  block_q  : simt: q rows of one CTA's unit of work, clamped to S. wgmma:
             nothing; the q tile is the kernel's own.
  block_kv : simt: kv columns per online-softmax step (the running max is
             updated once per block, so P rounds against the same max as on
             the TPU), clamped to S. wgmma: nothing; the running max moves
             once per 64-row kv tile, so with bf16 inputs P rounds against
             a different max than at the tuned block_kv. The reference's own
             bf16 tolerance (3e-2, between the Pallas kernel and the full
             softmax) covers that.
`stages` and `unroll` are tuned but read by no kernel, as in the reference.

q, k, v are [B, S, D] with B = batch * heads, all float32 or all bf16, and
D <= 256; the output is float32 [B, S, D]. Masks are the reference's: causal
keeps k <= q, and `window > 0` keeps k > q - window, also when `causal` is
false. Masked logits are -1e30, a row with nothing kept gives 0.

Bound on an H100 SXM: the larger of 4 * B * S^2 * D (halved when causal)
FLOPs over 989 TFLOP/s for bf16 (67 TFLOP/s for float32 without TF32), and
3 * B * S * D * in_bytes + B * S * D * 4 bytes over 3.35 TB/s. See the
notes at the top of both sources.

`flash_attention` launches a kernel for CUDA tensors, or raises; it takes
the plain version only for tensors on the CPU, which is how the CPU tests
reach the same arithmetic. `flash_attention.launches` counts kernel
launches and `flash_attention.launches_by_variant` splits them by variant.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)
SMS = 132                # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448      # shared memory a block may use
KV_TILE = 64             # wgmma: kv rows per stage and online-softmax step
MAX_STAGES = 4           # wgmma: K/V ring stages at most
SIMT_SLAB = 32           # simt: kv rows staged per slab
SIMT_MAX_ROWS = 16       # simt: q rows of one sub-tile


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


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one flash attention call launches."""
    variant: str       # "wgmma" or "simt"
    q_tile: int        # q rows of one CTA
    kv_tile: int       # kv rows per online-softmax step
    ctas: int
    smem_bytes: int    # dynamic shared memory of one CTA
    stages: int        # K/V ring stages (wgmma; 0 for simt)
    d_pad: int         # D as laid out in shared memory
    max_kv_tiles: int  # kv tiles the longest CTA visits


def _wgmma_smem(d_pad: int, q_tile: int, stages: int) -> int:
    """csrc/flash_attention_wgmma.cu:smem_bytes: 1 KB of alignment slack,
    Q, the K/V stages and 2 * stages + 1 mbarriers."""
    return (1024 + q_tile * d_pad * 2 + stages * 2 * KV_TILE * d_pad * 2
            + (2 * stages + 1) * 8)


def _simt_smem(D: int, bkv: int) -> int:
    """csrc/flash_attention.cu:launch: one kv slab and three row statistics,
    then as many q rows (up to 16) of Q and logits as fit."""
    fixed = SIMT_SLAB * (D + 1) * 4 + 3 * SIMT_MAX_ROWS * 4
    per_row = (D + bkv) * 4
    rows = min(SIMT_MAX_ROWS, (SMEM_LIMIT - fixed) // per_row)
    return fixed + rows * per_row


def _max_kv_tiles(S: int, q_tile: int, kv_tile: int, causal: bool,
                  window: int) -> int:
    """kv tiles the longest CTA visits: those some row of its q tile keeps
    (the kernels skip the others)."""
    most = 0
    for q0 in range(0, S, q_tile):
        q1 = min(q0 + q_tile, S)
        hi = q1 if causal else S
        lo = max(0, q0 - window + 1) if window > 0 else 0
        most = max(most, -(-hi // kv_tile) - lo // kv_tile)
    return most


@functools.lru_cache(maxsize=4096)
def plan(B: int, S: int, D: int, dtype, block_q: int, block_kv: int,
         causal: bool, window: int) -> Plan:
    """The launch plan of one call: variant, q and kv tiles, CTAs, shared
    memory and stages (rules in the module docstring). A pure function of
    its arguments, cached: the wrapper asks it on every call."""
    if min(B, S, D, block_q, block_kv) < 1 or window < 0:
        raise ValueError("flash_attention needs B, S, D and block sizes of "
                         "at least 1 and window >= 0")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} is above the kernel's "
                         f"{MAX_HEAD_DIM}")
    if dtype in (torch.bfloat16, "bfloat16") and D % 8 == 0:
        q_tile = 128 if B * -(-S // 128) >= SMS else 64
        d_pad = -(-D // 64) * 64
        stages = MAX_STAGES
        while _wgmma_smem(d_pad, q_tile, stages) > SMEM_LIMIT:
            stages -= 1
        assert stages >= 2, (D, q_tile)
        return Plan("wgmma", q_tile, KV_TILE, B * -(-S // q_tile),
                    _wgmma_smem(d_pad, q_tile, stages), stages, d_pad,
                    _max_kv_tiles(S, q_tile, KV_TILE, causal, window))
    bq, bkv = min(block_q, S), min(block_kv, S)
    if -(-S // bq) > 65535:
        raise ValueError(f"S={S} with block_q={bq} needs more than 65535 "
                         f"q tiles")
    return Plan("simt", bq, bkv, B * -(-S // bq), _simt_smem(D, bkv), 0, D,
                _max_kv_tiles(S, bq, bkv, causal, window))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/flash_attention.cu (simt), built and
    loaded at first use."""
    fn = build.load("flash_attention").repro_flash_attention
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _wgmma_kernel():
    """The C entry point of csrc/flash_attention_wgmma.cu, built and loaded
    at first use."""
    fn = build.load("flash_attention_wgmma").repro_flash_attention_wgmma
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh (so 16-byte aligned) copy where TMA cannot read it."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_wgmma(q, k, v, out, p: Plan, causal: bool, window: int,
                  scale: float) -> None:
    B, S, D = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _wgmma_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, S, D, p.q_tile, p.stages,
                          int(causal), int(window), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention wgmma kernel launch failed "
                           f"with CUDA error {err} (B={B} S={S} D={D}): "
                           f"{p}")


def _launch_simt(q, k, v, out, p: Plan, causal: bool, window: int,
                 scale: float) -> None:
    B, S, D = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, D, p.q_tile, p.kv_tile, int(causal), int(window),
                    float(scale), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash attention simt kernel launch failed with "
                           f"CUDA error {err} (B={B} S={S} D={D}): {p}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, block_q: int = 128,
                    block_kv: int = 128,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with the tuned blocks; `scale` defaults to
    1/sqrt(D). CUDA tensors launch the kernel that `plan` names on the
    current stream (no synchronisation); CPU tensors take
    `flash_attention_plain`."""
    _check(q, k, v, window, block_q, block_kv)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_kv=block_kv,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention's kernels need contiguous q, k, v")
    B, S, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if B > 2 ** 31 - 1:
        raise ValueError(f"B={B} is above the grid's 2**31 - 1")
    p = plan(B, S, D, q.dtype, block_q, block_kv, bool(causal), int(window))
    out = torch.empty((B, S, D), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        launch = _launch_wgmma if p.variant == "wgmma" else _launch_simt
        launch(q, k, v, out, p, causal, window, scale)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[p.variant] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_variant = {"wgmma": 0, "simt": 0}
