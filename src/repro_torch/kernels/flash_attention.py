"""Flash attention (causal / sliding-window): two CUDA C++ kernels for
Hopper and their plain PyTorch versions, behind two entries.

`flash_attention` is the tuning path's (the Moses search,
`ops.tuned_flash_attention`, `chip_smoke.py`): q, k, v [B, S, D] with B =
batch * heads, a float32 output. `prefill_attention` is the model zoo's
prefill (`models/attention.py:attention_prefill` takes it for CUDA bf16
inputs): q [B, S, H, D] and k, v [B, S, G, D] as the projections and RoPE
leave them, q head h reading kv head h // (H // G), a bf16 output [B, S, H,
D]. Every other attention of the models (training, cross attention, MLA,
float32, the CPU) runs the chunk loop of `models/attention.py`.

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py:
flash_attention` (body `_fa_kernel`). Which kernel runs follows from `plan`
(or `prefill_plan`) alone, before any launch, with no fallback:

  wgmma : `csrc/flash_attention_wgmma.cu`, bf16 q, k, v with D % 8 == 0
          (TMA reads 16-byte rows; every head dim of the LM zoo qualifies).
          Tensor cores (wgmma) fed by TMA, a q tile of the kernel's own (128
          rows, two consumer warpgroups, when there are at least 132 tiles
          of 128 rows, else 64) and kv tiles through a ring of 2 to 4
          shared-memory stages: 64 rows on the tuning path, 128 on the
          prefill path where D <= 128; the prefill path runs one
          persistent CTA an SM. Each warpgroup's softmax of one kv tile
          runs while its P V of the tile before is in flight. One
          kernel template serves both entries, parametrised by the
          tensors' strides, the group ratio H / G and the output type.
          The prefill entry is wgmma alone: `prefill_plan` refuses what
          it cannot take, and the models route those to their loop.
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

`flash_attention`: q, k, v are [B, S, D] with B = batch * heads, all
float32 or all bf16, and D <= 256; the output is float32 [B, S, D].
`prefill_attention`: q [B, S, H, D], k and v [B, S, G, D] with G dividing
H, all bf16 on the card (its plain version also takes float32), and the
output [B, S, H, D] in q's dtype; its kv tile, where the running max moves,
is 128 rows for D <= 128 and 64 above (`prefill_plan.kv_tile`). Masks are
the reference's: causal keeps k <= q, and `window > 0` keeps k > q -
window, also when `causal` is false. Masked logits are -1e30, a row with
nothing kept gives 0.

Bound on an H100 SXM: the larger of 4 * B * H * S^2 * D (halved when
causal; H = 1 on the tuning path) FLOPs over 989 TFLOP/s for bf16 (67
TFLOP/s for float32 without TF32), and the bytes of q, k, v and the output
over 3.35 TB/s. See the notes at the top of both sources.

Both entries launch a kernel for CUDA tensors, or raise; they take their
plain versions only for tensors on the CPU, which is how the CPU tests
reach the same arithmetic. `flash_attention.launches` counts kernel
launches and `flash_attention.launches_by_variant` splits them by variant;
`prefill_attention.launches` counts the prefill entry's.
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
    ctas: int          # CTAs launched (the prefill's: at most one an SM)
    smem_bytes: int    # dynamic shared memory of one CTA
    stages: int        # K/V ring stages (wgmma; 0 for simt)
    d_pad: int         # D as laid out in shared memory
    max_kv_tiles: int  # kv tiles the longest CTA visits


def _wgmma_smem(d_pad: int, q_tile: int, stages: int,
                kv_tile: int = KV_TILE) -> int:
    """csrc/flash_attention_wgmma.cu:smem_bytes: 1 KB of alignment slack,
    Q, the K/V stages and 2 * stages + 2 mbarriers."""
    return (1024 + q_tile * d_pad * 2 + stages * 2 * kv_tile * d_pad * 2
            + (2 * stages + 2) * 8)


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
    if p.variant == "wgmma" and not scale > 0:
        raise ValueError(f"the wgmma kernel takes a scale > 0, got {scale}")
    out = torch.empty((B, S, D), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        launch = _launch_wgmma if p.variant == "wgmma" else _launch_simt
        launch(q, k, v, out, p, causal, window, scale)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[p.variant] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_variant = {"wgmma": 0, "simt": 0}


# ---------------------------------------------------------------------------
# The prefill entry: the models' [B, S, H, D] / [B, S, G, D] layout
# ---------------------------------------------------------------------------


def prefill_refusal(B: int, S: int, H: int, G: int, D: int, Dv: int,
                    dtype) -> Optional[str]:
    """Why the prefill kernel does not take these inputs, or None where it
    does: bf16, D == Dv, D % 8 == 0 and D <= 256, G dividing H, and a grid
    of at most 2**31 - 1 CTAs."""
    if dtype not in (torch.bfloat16, "bfloat16"):
        return f"the prefill kernel reads bf16, not {dtype}"
    if Dv != D:
        return f"the prefill kernel needs D == Dv, got {D} and {Dv}"
    if D % 8 or not 1 <= D <= MAX_HEAD_DIM:
        return (f"the prefill kernel needs D % 8 == 0 and D <= "
                f"{MAX_HEAD_DIM} (TMA's 16-byte rows), got {D}")
    if min(B, S, H, G) < 1 or H % G:
        return (f"the prefill kernel needs B, S, H, G >= 1 and G dividing "
                f"H, got B={B} S={S} H={H} G={G}")
    if B * H * -(-S // 64) > 2 ** 31 - 1:
        return "B * H * ceil(S / 64) is above the grid's 2**31 - 1"
    return None


def prefill_kv_tile(D: int) -> int:
    """kv rows per online-softmax step of the prefill kernel: 128 where the
    S, O and P registers fit (D padded to at most 128), else 64."""
    return 128 if -(-D // 64) * 64 <= 128 else 64


@functools.lru_cache(maxsize=4096)
def prefill_plan(B: int, S: int, H: int, G: int, D: int, dtype, causal: bool,
                 window: int) -> Plan:
    """The launch plan of one prefill call (always `wgmma`): a q tile of
    128 rows where B * H * ceil(S / 128) >= 132, else 64; kv tiles of
    `prefill_kv_tile(D)` rows; as many K/V stages as fit, up to 4; one
    persistent CTA an SM (`ctas`; fewer where there are fewer tiles),
    each walking its share of the tiles. Raises ValueError with
    `prefill_refusal`'s reason where the kernel does not take the inputs,
    or for window < 0."""
    reason = prefill_refusal(B, S, H, G, D, D, dtype)
    if reason is not None:
        raise ValueError(reason)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    q_tile = 128 if B * H * -(-S // 128) >= SMS else 64
    kv_tile = prefill_kv_tile(D)
    d_pad = -(-D // 64) * 64
    stages = MAX_STAGES
    while _wgmma_smem(d_pad, q_tile, stages, kv_tile) > SMEM_LIMIT:
        stages -= 1
    assert stages >= 2, (D, q_tile)
    return Plan("wgmma", q_tile, kv_tile, min(B * H * -(-S // q_tile), SMS),
                _wgmma_smem(d_pad, q_tile, stages, kv_tile), stages, d_pad,
                _max_kv_tiles(S, q_tile, kv_tile, causal, window))


def _check_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int):
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        raise TypeError("prefill_attention takes three tensors")
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]):
        raise ValueError(f"prefill_attention needs q [B, S, H, D] and k, v "
                         f"[B, S, G, D] with G dividing H, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"prefill_attention takes three float32 or three "
                        f"bfloat16 tensors, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device} and "
                         f"{v.device}")
    if min(q.shape) < 1:
        raise ValueError("prefill_attention needs B, S, H and D of at "
                         "least 1")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def prefill_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the prefill kernel: a float32
    online-softmax loop over kv blocks of the kernel's kv tile
    (`prefill_kv_tile(D)` rows) with the kernel's guards and its cast of P,
    each q head against its kv head, scale 1/sqrt(D); the output in q's
    dtype. On a card, call it with TF32 off."""
    _check_prefill(q, k, v, window)
    B, S, H, D = q.shape
    G = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    bkv = min(prefill_kv_tile(D), S)
    qf = q.float().reshape(B, S, G, H // G, D)
    kf, vf = k.float(), v.float()
    dev = q.device
    q_pos = torch.arange(S, device=dev)[:, None]
    m = torch.full((B, S, G, H // G), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, S, G, H // G, D), dtype=torch.float32, device=dev)
    for k0 in range(0, S, bkv):
        k1 = min(k0 + bkv, S)
        s = torch.einsum("bqgrd,bkgd->bqgrk", qf, kf[:, k0:k1]) * scale
        k_pos = torch.arange(k0, k1, device=dev)[None, :]
        mask = torch.ones((S, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window > 0:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where((m_new == NEG_INF)[..., None], torch.zeros_like(p), p)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqgrk,bkgd->bqgrd", p.to(v.dtype).float(), vf[:, k0:k1])
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return out.reshape(B, S, H, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _prefill_kernel():
    """The prefill C entry point of csrc/flash_attention_wgmma.cu, built
    and loaded at first use."""
    fn = build.load("flash_attention_wgmma").repro_prefill_attention_wgmma
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """t where TMA can read it in place (a 16-byte aligned base, the last
    dim contiguous, every other stride a multiple of 8 elements), else a
    fresh contiguous copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % 8 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch_prefill(q, k, v, out, p: Plan, causal: bool, window: int,
                    scale: float) -> None:
    B, S, H, D = q.shape
    G = k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _prefill_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, G,
        D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], p.q_tile,
        p.kv_tile, p.stages, p.ctas, int(causal), int(window), float(scale),
        stream)
    if err != 0:
        raise RuntimeError(f"prefill attention kernel launch failed with "
                           f"CUDA error {err} (B={B} S={S} H={H} G={G} "
                           f"D={D}): {p}")


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v of a prefill in the models' layout: q [B,
    S, H, D], k and v [B, S, G, D], q head h reading kv head h // (H // G);
    returns [B, S, H, D] in q's dtype. CUDA tensors launch the kernel `prefill_plan` describes on the current
    stream (no synchronisation), reading q, k and v in place where their
    strides allow; CPU tensors take `prefill_attention_plain`."""
    _check_prefill(q, k, v, window)
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    B, S, H, D = q.shape
    p = prefill_plan(B, S, H, k.shape[2], D, q.dtype, bool(causal),
                     int(window))
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    out = torch.empty((B, S, H, D), device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        _launch_prefill(q, k, v, out, p, causal, window, 1.0 / math.sqrt(D))
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
