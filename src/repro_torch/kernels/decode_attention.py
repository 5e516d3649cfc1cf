"""GQA decode attention: a CUDA C++ kernel for Hopper and its plain PyTorch
version, behind one entry.

`decode_attention` is the models' single-step decode against a KV cache
(`models/attention.py:_decode_attend` takes it for CUDA bf16 inputs that
`decode_route` accepts): q [B, H, D] against k, v [B, Sc, G, D] read in
place, q head h reading kv head h // (H // G); kv_positions [B, Sc] int32
(-1 marks an empty slot, the ring may wrap), cur_pos [B] int32; slot j of
row b is kept where its position is >= 0, <= cur_pos[b] and, for window >
0, > cur_pos[b] - window; out [B, H, D] bf16, 0 for a row with no kept
slot. It replaces no TPU kernel (the reference's `decode_attend` is plain
jnp); on the card it replaces the float32 eager chain of
`models/attention.py:decode_attend_partial`, which stays for the CPU,
float32 caches and the sequence-sharded mesh decode.

The kernel is `csrc/decode_attention.cuh`, built into the library of
`csrc/flash_attention_wgmma.cu` (one nvcc for the models' attention). What
a call launches follows from `decode_plan` alone:

  d_pad    : D padded to a multiple of 64 in shared memory (64 to 256).
  warps    : streams of one CTA: 8 where d_pad <= 128, else 4.
  kv_tile  : kv slots of one tile, where a stream's running max moves: 16.
  stages   : each warp's ring (K and V rows by TMA bulk copies), as many
             stages as fit (2 to 4).
  splits   : the kv range of each (row, kv head, 16 q heads) is cut into
             `splits` ranges of `tiles_per_split` tiles (at most 128, the
             kernel's positions buffer), one CTA each, as few as fill the
             card's CTA slots (`_splits`). Inside a CTA warp w takes the
             range's tiles w, w + warps, ..., skipping (neither loading nor
             computing) those with no kept slot. The CTA merges its
             streams, and the last CTA of a unit to finish merges the
             splits, in the same launch.

Rounding points of the kernel: logits are q . k of the bf16 operands in
float32, times `scale`; each stream's running max moves once per tile; P
is rounded to bf16 against it before P V (the reference's
`p.astype(v.dtype)`); l sums the unrounded p in float32; O = O * corr + P
V in float32; the streams and splits are merged in float32 (the LSE
combine); O / l (1 where l == 0) is cast to bf16. The plain version is the
models' loop (`models/attention.py:decode_attend_loop`), which takes one
max over the whole cache, as the reference does, so P rounds against
another max: the bf16 tolerance, 3e-2, covers that, as it does for the
prefill kernel.

Bound on an H100 SXM: the bytes of q, of the kept K and V rows and of the
output over 3.35 TB/s (`decode_bytes`).

The entry launches the kernel for CUDA tensors, or raises; it takes the
plain version only for CPU tensors. `decode_attention.launches` counts
launches. The wrapper is on the host-paced decode step's path: the plan is
cached by shape, a call allocates its output with `torch.empty` alone (a
split launch's workspace and counters are allocated once a device and
reused: the kernel leaves the counters 0), never synchronises and launches
once.
"""
from __future__ import annotations

import array
import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
SMS = 132                # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448      # shared memory a block may use
SMEM_PER_SM = 233472     # shared memory of an SM; each block reserves 1 KB
KV_TILE = 16             # kv slots of one tile
ROWS = 16                # q heads of one CTA (mma.sync's 16 rows)
MAX_STAGES = 4
MAX_SPLITS = 64
MAX_SPLIT_TILES = 128    # tiles of one split (the kernel's positions buffer)
SPLIT_COST_TILES = 4     # a CTA's fixed cost (positions, Q, the ring's
                         # first loads, the merges) in tiles of one stream
HBM_BYTES_PER_S = 3.35e12
_DTYPES = (torch.float32, torch.bfloat16)


def decode_refusal(B: int, Sc: int, H: int, G: int, D: int, Dv: int,
                   dtype) -> Optional[str]:
    """Why the decode kernel does not take these inputs, or None where it
    does: bf16, D == Dv, D % 8 == 0 and D <= 256, G dividing H, at most
    131072 cache slots, and a grid of at most 2**31 - 1 CTAs."""
    if dtype not in (torch.bfloat16, "bfloat16"):
        return f"the decode kernel reads bf16, not {dtype}"
    if Dv != D:
        return f"the decode kernel needs D == Dv, got {D} and {Dv}"
    if D % 8 or not 1 <= D <= MAX_HEAD_DIM:
        return (f"the decode kernel needs D % 8 == 0 and D <= "
                f"{MAX_HEAD_DIM} (16-byte rows), got {D}")
    if min(B, Sc, H, G) < 1 or H % G:
        return (f"the decode kernel needs B, Sc, H, G >= 1 and G dividing "
                f"H, got B={B} Sc={Sc} H={H} G={G}")
    if -(-Sc // KV_TILE) > MAX_SPLITS * MAX_SPLIT_TILES:
        return (f"the decode kernel takes at most "
                f"{MAX_SPLITS * MAX_SPLIT_TILES * KV_TILE} cache slots, got "
                f"Sc={Sc}")
    if B * G * -(-(H // G) // ROWS) * MAX_SPLITS > 2 ** 31 - 1:
        return "B * G * ceil(H / G / 16) * 64 is above the grid's 2**31 - 1"
    return None


def decode_warps(d_pad: int) -> int:
    """Streams (warps) of one CTA: 8 where d_pad <= 128, else 4."""
    return 8 if d_pad <= 128 else 4


def _smem(d_pad: int, stages: int) -> int:
    """csrc/decode_attention.cuh:smem_bytes: Q's 16 padded rows, a flag,
    the rings' mbarriers and a split's positions, then each warp's ring of
    K and V (padded rows)."""
    w = decode_warps(d_pad)
    header = (ROWS * (d_pad + 8) * 2 + 16 + w * MAX_STAGES * 8
              + MAX_SPLIT_TILES * KV_TILE * 4)
    return header + w * stages * 2 * KV_TILE * (d_pad + 8) * 2


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """What one decode attention call launches."""
    d_pad: int            # D as laid out in shared memory
    warps: int            # streams of one CTA
    kv_tile: int          # kv slots of a tile (where a running max moves)
    stages: int           # each warp's cp.async ring
    splits: int           # kv splits of each unit, one CTA each
    tiles_per_split: int  # kv tiles of one split
    units: int            # (row, kv head, 16 q heads) units
    ctas: int             # units * splits
    ctas_per_sm: int      # by shared memory
    smem_bytes: int       # dynamic shared memory of one CTA
    ws_floats: int        # float32 workspace of a split launch (0: none)


def _splits(units: int, tiles: int, slots: int, warps: int) -> int:
    """The fewest splits whose slowest wave is shortest: a CTA's time is
    its longest stream, ceil(tiles_per_split / warps) tiles, plus
    SPLIT_COST_TILES, and the CTAs run in ceil(ctas / slots) waves; a
    split holds at most MAX_SPLIT_TILES tiles."""
    best, best_cost = None, None
    for s in range(-(-tiles // MAX_SPLIT_TILES), min(tiles, MAX_SPLITS) + 1):
        per = -(-tiles // s)
        s_eff = -(-tiles // per)
        if s_eff != s:
            continue
        cost = -(-units * s // slots) * (-(-per // warps)
                                         + SPLIT_COST_TILES)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


@functools.lru_cache(maxsize=4096)
def decode_plan(B: int, Sc: int, H: int, G: int, D: int) -> DecodePlan:
    """The launch plan of one bf16 decode call (rules in the module
    docstring). A pure function of the shapes, cached: the wrapper asks it
    on every call. Raises ValueError with `decode_refusal`'s reason where
    the kernel does not take the shapes."""
    reason = decode_refusal(B, Sc, H, G, D, D, torch.bfloat16)
    if reason is not None:
        raise ValueError(reason)
    d_pad = -(-D // 64) * 64
    w = decode_warps(d_pad)
    stages = MAX_STAGES
    while _smem(d_pad, stages) > SMEM_LIMIT:
        stages -= 1
    assert stages >= 2, (D, stages)
    smem = _smem(d_pad, stages)
    per_sm = min(SMEM_PER_SM // (smem + 1024), 16)
    units = B * G * -(-(H // G) // ROWS)
    tiles = -(-Sc // KV_TILE)
    splits = _splits(units, tiles, SMS * per_sm, w)
    per = -(-tiles // splits)
    return DecodePlan(d_pad, w, KV_TILE, stages, splits, per, units,
                      units * splits,
                      per_sm, smem,
                      units * splits * ROWS * (D + 4) if splits > 1 else 0)


def decode_bytes(B: int, H: int, G: int, D: int, kept_rows: int) -> int:
    """Bytes a decode call needs at the least: q, the kept K and V rows
    (`kept_rows` summed over the batch, each of G heads) and the output, in
    bf16, each read or written once."""
    return (2 * B * H * D + 2 * kept_rows * G * D) * 2


def _check(q, k, v, kv_positions, cur_pos, window: int):
    """Raises on what neither version takes. Lean: the decode step calls
    it once a layer."""
    qs, ks = q.shape, k.shape
    if (len(qs) != 3 or len(ks) != 4 or v.shape != ks or ks[0] != qs[0]
            or ks[3] != qs[2] or ks[2] < 1 or qs[1] % ks[2]):
        raise ValueError(f"decode_attention needs q [B, H, D] and k, v "
                         f"[B, Sc, G, D] with G dividing H, got "
                         f"{tuple(qs)}, {tuple(ks)} and {tuple(v.shape)}")
    if kv_positions.shape != ks[:2] or cur_pos.shape != qs[:1]:
        raise ValueError(f"decode_attention needs kv_positions [B, Sc] and "
                         f"cur_pos [B], got {tuple(kv_positions.shape)} and "
                         f"{tuple(cur_pos.shape)}")
    dt = q.dtype
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"decode_attention takes three float32 or three "
                        f"bfloat16 tensors, got {dt}, {k.dtype} and "
                        f"{v.dtype}")
    dev = q.get_device()
    if not (k.get_device() == v.get_device() == kv_positions.get_device()
            == cur_pos.get_device() == dev):
        raise ValueError("decode_attention's tensors lie on more than one "
                         "device")
    if min(qs) < 1 or ks[1] < 1:
        raise ValueError("decode_attention needs B, H, D and Sc of at "
                         "least 1")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_positions: torch.Tensor,
                           cur_pos: torch.Tensor, *, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version: the models' loop
    (`models.attention.decode_attend_loop`: one max over the whole cache, P
    rounded to v's dtype, float32 sums, the output in q's dtype) on checked
    inputs. CPU tensors take it; on a card it is the kernel's reference
    (call it with TF32 off)."""
    _check(q, k_cache, v_cache, kv_positions, cur_pos, window)
    from repro_torch.models.attention import decode_attend_loop
    return decode_attend_loop(q, k_cache, v_cache, kv_positions, cur_pos,
                              window=window, scale=scale)


# the C entry's packed arguments (csrc/flash_attention_wgmma.cu:
# repro_decode_attention), in order
ARGS = ("q", "k", "v", "kv_positions", "cur_pos", "out", "ws", "counters",
        "B", "Sc", "H", "G", "D", "q_b", "q_h", "k_b", "k_s", "k_h", "v_b",
        "v_s", "v_h", "p_b", "p_s", "d_pad", "stages", "splits",
        "tiles_per_split", "window")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point `repro_decode_attention`, in the library of
    csrc/flash_attention_wgmma.cu, built and loaded at first use: the
    address of the int64 array of ARGS, the scale and the stream."""
    fn = build.load("flash_attention_wgmma").repro_decode_attention
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    return fn


def _raw_stream():
    """The current CUDA stream's handle: torch's own getter where it has
    one (what its compiled kernels launch on; `current_stream()` builds a
    Stream object each call, several microseconds of the decode step's
    host time a layer)."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


_scratch = {}


def _scratch_of(device: torch.device, p: DecodePlan):
    """A split launch's float32 workspace and its counters on `device`:
    allocated once (the counters zeroed) and grown only for a larger plan.
    The kernel's last CTA of each unit sets its counter back to 0, so
    launches in one stream's order reuse both (a CUDA graph keeps their
    addresses); launches on two streams at once must not share them."""
    have = _scratch.get(device)
    if have is None or have[0].numel() < p.ws_floats or \
            have[1].numel() < p.units:
        n_ws = max(p.ws_floats, have[0].numel() if have else 0)
        n_units = max(p.units, have[1].numel() if have else 0)
        have = (torch.empty(n_ws, dtype=torch.float32, device=device),
                torch.zeros(n_units, dtype=torch.int32, device=device))
        _scratch[device] = have
    return have


def _rows_ready(t: torch.Tensor):
    """(t, its strides, its address) where the kernel reads t in place (a
    16-byte aligned base, the last dim contiguous, every other stride a
    multiple of 8 elements), else the same of a fresh contiguous copy. For
    3-d and 4-d tensors."""
    st, ptr = t.stride(), t.data_ptr()
    if st[-1] == 1 and not ptr & 15 and not (st[0] | st[1] | st[-2]) & 7:
        return t, st, ptr
    t = t.clone(memory_format=torch.contiguous_format)
    return t, t.stride(), t.data_ptr()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     cur_pos: torch.Tensor, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v of one decode step over the cache's kept
    slots, [B, H, D] in q's dtype; `scale` defaults to 1/sqrt(D). CUDA
    tensors (bf16) launch the kernel `decode_plan` describes on the current
    stream (no synchronisation), reading q, k and v in place where their
    strides allow; CPU tensors take `decode_attention_plain`."""
    _check(q, k_cache, v_cache, kv_positions, cur_pos, window)
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_positions,
                                      cur_pos, window=window, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, "
                         f"not {dev}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the decode kernel reads bf16, not {q.dtype}")
    return _launch(q, k_cache, v_cache, kv_positions, cur_pos, window=window,
                   scale=scale)


def _launch(q, k_cache, v_cache, kv_positions, cur_pos, *, window: int,
            scale: Optional[float]) -> torch.Tensor:
    """The CUDA branch of `decode_attention` on checked inputs: the plan,
    the operands as the kernel reads them, the output and one launch on
    the current stream."""
    dev = q.device
    B, H, D = q.shape
    Sc, G = k_cache.shape[1], k_cache.shape[2]
    p = decode_plan(B, Sc, H, G, D)
    q, qst, qp = _rows_ready(q)
    k, kst, kp = _rows_ready(k_cache)
    v, vst, vp = _rows_ready(v_cache)
    pos = kv_positions if kv_positions.dtype == torch.int32 else \
        kv_positions.to(torch.int32)
    cur = cur_pos if cur_pos.dtype == torch.int32 and \
        cur_pos.is_contiguous() else cur_pos.to(torch.int32).contiguous()
    pst = pos.stride()
    out = torch.empty((B, H, D), device=dev, dtype=q.dtype)
    ws = counters = 0
    if p.splits > 1:
        ws, counters = (t.data_ptr() for t in _scratch_of(dev, p))
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    args = array.array("q", (
        qp, kp, vp, pos.data_ptr(), cur.data_ptr(), out.data_ptr(), ws,
        counters, B, Sc, H, G, D, qst[0], qst[1], kst[0], kst[1], kst[2],
        vst[0], vst[1], vst[2], pst[0], pst[1], p.d_pad, p.stages, p.splits,
        p.tiles_per_split, window))
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = _kernel()(args.buffer_info()[0], scale, _raw_stream())
    else:
        with torch.cuda.device(dev.index):
            err = _kernel()(args.buffer_info()[0], scale, _raw_stream())
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed with "
                           f"CUDA error {err} (B={B} Sc={Sc} H={H} G={G} "
                           f"D={D}): {p}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
