"""The routed-only expert FFN of an MoE layer: a CUDA C++ kernel pair for
Hopper and its plain PyTorch version, behind one entry.

`moe_experts` runs the gated SiLU experts of the capacity dispatch
(`distributed/expert_parallel.py:_local_dispatch_ffn` takes it on the card
where `expert_route` picks it): expert_in [E, C, d] (each expert's C
capacity rows), fill [E] int32 (each expert's rows that may hold a token:
rows at or past it are zero in expert_in), wi and wg [E, d, f], wo [E, f,
d]; out [E, C, d] in expert_in's dtype, what `models/moe.py:_expert_ffn`
returns, with rows at or past fill 0 (as the bmm chain gives on zero rows).
It replaces no TPU kernel (the reference's `_local_dispatch_ffn` is plain
einsum); on the card it replaces the three `torch.bmm` over every expert's
buffer, which read every expert's weights whether a token reached it or
not.

The kernels are `csrc/moe_experts.cu`: a gate/up launch that writes h =
silu(x wi) * (x wg) [E, C, f] for the filled rows, and a down launch that
writes out = h wo, both reading only the experts with fill > 0. Each CTA
of a persistent grid lists the filled experts, then walks (filled expert,
64-column tile) items; the 4 warps of a CTA split an item's rows and
stream the weights into registers, 16 bytes a load, `mma.sync` with the
tokens as the 8-wide (or two 8-wide, C > 8) side. Rounding points are the
bmm chain's: float32 sums, each product rounded to bf16, `common.silu`'s
sigmoid rounded and then its product, the gated product rounded.

Bound on an H100 SXM: the filled experts' weights, 3 * d * f * 2 bytes
each, with the filled rows of expert_in and the output, over 3.35 TB/s
(`experts_bytes`).

The entry launches the kernel pair for CUDA tensors, or raises; it takes
the plain version only for CPU tensors. `moe_experts.launches` counts calls
that launched (two kernels each). The wrapper is on the host-paced decode
step's path: it checks lean, keeps h as a scratch reused call to call
(grown only for a larger shape), packs its arguments in one int64 array
and launches on torch's raw current stream.
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da

MAX_ROWS = 16         # capacity rows an expert (two 8-wide mma tiles)
MAX_EXPERTS = 1024    # experts a call (the CTA's lists in shared memory)
ROW_STEP = 64         # d and f are multiples of it: 4 warps x 16 rows
HBM_BYTES_PER_S = 3.35e12


def experts_refusal(E: int, C: int, d: int, f: int, dtype) -> Optional[str]:
    """Why the kernel pair does not take these inputs, or None where it
    does: bf16, 1 <= C <= 16, 1 <= E <= 1024, d and f multiples of 64."""
    if dtype not in (torch.bfloat16, "bfloat16"):
        return f"the experts kernel reads bf16, not {dtype}"
    if not 1 <= C <= MAX_ROWS:
        return f"the experts kernel takes 1 to {MAX_ROWS} rows, got C={C}"
    if not 1 <= E <= MAX_EXPERTS:
        return (f"the experts kernel takes 1 to {MAX_EXPERTS} experts, got "
                f"E={E}")
    if d < 1 or f < 1 or d % ROW_STEP or f % ROW_STEP:
        return (f"the experts kernel needs d and f multiples of {ROW_STEP}, "
                f"got d={d} f={f}")
    return None


def experts_bytes(filled: int, rows: int, E: int, C: int, d: int,
                  f: int) -> int:
    """Bytes a call needs at the least, in bf16: the weights of the
    `filled` experts (wi, wg and wo), the `rows` filled rows of expert_in
    read and the output [E, C, d] written."""
    return 2 * (3 * filled * d * f + rows * d + E * C * d)


def _check(expert_in, fill, wi, wg, wo):
    """Raises on what neither version takes. Lean: the decode step calls
    it once an MoE layer."""
    xs, ws = expert_in.shape, wi.shape
    if (len(xs) != 3 or len(ws) != 3 or wg.shape != ws or ws[0] != xs[0]
            or ws[1] != xs[2] or tuple(wo.shape) != (ws[0], ws[2], ws[1])
            or tuple(fill.shape) != (xs[0],)):
        raise ValueError(
            f"moe_experts needs expert_in [E, C, d], fill [E], wi and wg "
            f"[E, d, f] and wo [E, f, d], got {tuple(xs)}, "
            f"{tuple(fill.shape)}, {tuple(ws)}, {tuple(wg.shape)} and "
            f"{tuple(wo.shape)}")
    dt = expert_in.dtype
    if not dt.is_floating_point or wi.dtype != dt or wg.dtype != dt or \
            wo.dtype != dt:
        raise TypeError(f"moe_experts takes four tensors of one floating "
                        f"dtype, got {dt}, {wi.dtype}, {wg.dtype} and "
                        f"{wo.dtype}")
    if fill.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"fill is int32 or int64, not {fill.dtype}")
    dev = expert_in.get_device()
    if not (fill.get_device() == wi.get_device() == wg.get_device()
            == wo.get_device() == dev):
        raise ValueError("moe_experts' tensors lie on more than one device")
    if min(xs) < 1 or ws[2] < 1:
        raise ValueError("moe_experts needs E, C, d and f of at least 1")


def moe_experts_plain(expert_in: torch.Tensor, fill: torch.Tensor,
                      wi: torch.Tensor, wg: torch.Tensor,
                      wo: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: `_expert_ffn`'s bmm chain (gated SiLU,
    `common.silu`'s rounding points) on every row, then rows at or past
    each expert's fill set to 0. CPU tensors take it; on a card it is the
    kernel's reference (call it with TF32 off)."""
    _check(expert_in, fill, wi, wg, wo)
    from repro_torch.models.common import silu
    h = silu(torch.bmm(expert_in, wi)) * torch.bmm(expert_in, wg)
    out = torch.bmm(h, wo)
    rows = torch.arange(out.shape[1], device=out.device)
    keep = rows[None, :] < fill[:, None]
    return torch.where(keep[..., None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))


# the C entry's packed arguments (csrc/moe_experts.cu: repro_moe_experts),
# in order
ARGS = ("x", "fill", "wi", "wg", "wo", "h", "out", "E", "C", "d", "f",
        "wi_e", "wi_k", "wg_e", "wg_k", "wo_e", "wo_k")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point `repro_moe_experts` of csrc/moe_experts.cu, built
    and loaded at first use: the address of the int64 array of ARGS and
    the stream."""
    fn = build.load("moe_experts").repro_moe_experts
    fn.restype = ctypes.c_int  # cudaError_t
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return fn


_scratch = {}


def _h_of(device: torch.device, n: int) -> torch.Tensor:
    """The bf16 scratch for h (n elements or more) on `device`: allocated
    once and grown only for a larger call. Launches in one stream's order
    reuse it (a CUDA graph keeps its address); launches on two streams at
    once must not share it."""
    have = _scratch.get(device)
    if have is None or have.numel() < n:
        have = torch.empty(n, dtype=torch.bfloat16, device=device)
        _scratch[device] = have
    return have


def _weights_ready(t: torch.Tensor):
    """(t, its strides) where the kernel reads t in place (the rows
    contiguous, a 16-byte aligned base, the other strides multiples of 8
    elements), else the same of a contiguous copy."""
    st = t.stride()
    if st[2] == 1 and not t.data_ptr() & 15 and not (st[0] | st[1]) & 7:
        return t, st
    t = t.contiguous()
    return t, t.stride()


def moe_experts(expert_in: torch.Tensor, fill: torch.Tensor,
                wi: torch.Tensor, wg: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """The gated SiLU experts on their capacity rows, [E, C, d] in
    expert_in's dtype, rows at or past fill 0. CUDA tensors (bf16, shapes
    `experts_refusal` accepts) launch the kernel pair on the current stream
    (no synchronisation), reading only the experts with fill > 0; CPU
    tensors take `moe_experts_plain`."""
    _check(expert_in, fill, wi, wg, wo)
    dev = expert_in.device
    if dev.type == "cpu":
        return moe_experts_plain(expert_in, fill, wi, wg, wo)
    if dev.type != "cuda":
        raise ValueError(f"moe_experts runs on CUDA or CPU tensors, not "
                         f"{dev}")
    E, C, d = expert_in.shape
    f = wi.shape[2]
    reason = experts_refusal(E, C, d, f, expert_in.dtype)
    if reason is not None:
        raise ValueError(reason)
    return _launch(expert_in, fill, wi, wg, wo)


def _launch(expert_in, fill, wi, wg, wo) -> torch.Tensor:
    """The CUDA branch of `moe_experts` on checked inputs: the operands as
    the kernels read them, the output and the two launches on the current
    stream."""
    dev = expert_in.device
    E, C, d = expert_in.shape
    f = wi.shape[2]
    x = expert_in if expert_in.is_contiguous() else expert_in.contiguous()
    fl = fill if fill.dtype == torch.int32 and fill.is_contiguous() else \
        fill.to(torch.int32).contiguous()
    wi, (wi_e, wi_k, _) = _weights_ready(wi)
    wg, (wg_e, wg_k, _) = _weights_ready(wg)
    wo, (wo_e, wo_k, _) = _weights_ready(wo)
    out = torch.empty((E, C, d), device=dev, dtype=x.dtype)
    h = _h_of(dev, E * C * f)
    args = array.array("q", (
        x.data_ptr(), fl.data_ptr(), wi.data_ptr(), wg.data_ptr(),
        wo.data_ptr(), h.data_ptr(), out.data_ptr(), E, C, d, f, wi_e, wi_k,
        wg_e, wg_k, wo_e, wo_k))
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = _kernel()(args.buffer_info()[0], da._raw_stream())
    else:
        with torch.cuda.device(dev.index):
            err = _kernel()(args.buffer_info()[0], da._raw_stream())
    if err != 0:
        raise RuntimeError(f"moe experts kernel launch failed with CUDA "
                           f"error {err} (E={E} C={C} d={d} f={f})")
    moe_experts.launches += 1
    return out


moe_experts.launches = 0
