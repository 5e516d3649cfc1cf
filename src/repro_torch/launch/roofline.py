"""Roofline analysis of dry-run cells (port of `repro.launch.roofline`).

Three terms per (arch, shape, mesh), in seconds:

  compute    = FLOPs_per_rank / peak_FLOPs
  memory     = bytes_per_rank / HBM_bw
  collective = collective_bytes_per_rank / link_bw

The module constants are the reference's TPU v5e numbers (197 TFLOP/s
bf16, 819 GB/s, ~50 GB/s a link) and stay the defaults of `analyze`; it
and `RooflineTerms` take other rates as keyword arguments. The H100 SXM
data-sheet rates are `H100_PEAK_FLOPS` and `H100_HBM_BW` (989e12 bf16
dense, 3.35e12 B/s; `chip_smoke.py` uses the same), and `H100_LINK_BW`
(NVLink 4, 450e9 B/s a direction).

`collective_bytes` parses XLA HLO text, as the reference does (kept for
the reference's artifacts). The port's counterpart is `RankCounter`, a
dispatch mode over one rank's local calls: it sums FLOPs
(`torch.utils.flop_counter`'s formulas), the input and output bytes of
each local aten op (an unfused count, not XLA's fused "bytes accessed"),
and the result bytes of every `_c10d_functional` collective and
point-to-point send, with the same ring factors and output keys as
`collective_bytes`. DTensor's own calls are passed to DTensor, so only the
per-rank local calls count (`FlopCounterMode` counts a DTensor's global
product), and DTensor's sharding propagation, which runs the op on global
fake tensors, is skipped.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

PEAK_FLOPS = 197e12         # bf16 / chip (given)
HBM_BW = 819e9              # bytes/s / chip (given)
LINK_BW = 50e9              # bytes/s / ICI link (given)
HBM_PER_CHIP = 16 * 2**30   # v5e

H100_PEAK_FLOPS = 989e12    # bf16 dense, H100 SXM data sheet
H100_HBM_BW = 3.35e12       # bytes/s, H100 SXM data sheet
H100_LINK_BW = 450e9        # bytes/s a direction, NVLink 4 (18 links)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_COLLECTIVE_FACTORS = {
    "all-reduce": 2.0,          # ring: reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(.*?)\s+(all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(")


def _shape_bytes(shapes_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shapes_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-op-kind wire bytes (per chip) from optimized HLO text."""
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVE_FACTORS}
    count: Dict[str, int] = {k: 0 for k in _COLLECTIVE_FACTORS}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        result_shapes, op = m.group(1), m.group(2)
        if "-done" in line.split("=")[1][:40]:
            continue
        b = _shape_bytes(result_shapes)
        out[op] += b * _COLLECTIVE_FACTORS[op]
        count[op] += 1
    out_total = {f"{k}_bytes": v for k, v in out.items()}
    out_total.update({f"{k}_count": float(c) for k, c in count.items()})
    out_total["total_bytes"] = sum(out.values())
    return out_total


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    model_flops: float = 0.0
    chips: int = 1
    peak_flops: float = PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap bound: the max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU bound at the analyzed step time."""
        if self.step_time_s <= 0:
            return 0.0
        return (self.model_flops / self.chips / self.step_time_s) / \
            self.peak_flops


def analyze(cost: Dict[str, float], coll: Dict[str, float], chips: int,
            model_flops: float = 0.0, *, peak_flops: float = PEAK_FLOPS,
            hbm_bw: float = HBM_BW, link_bw: float = LINK_BW
            ) -> RooflineTerms:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.get("total_bytes", 0.0))
    return RooflineTerms(
        compute_s=flops / peak_flops,
        memory_s=byts / hbm_bw,
        collective_s=cb / link_bw,
        flops_per_chip=flops,
        bytes_per_chip=byts,
        coll_bytes_per_chip=cb,
        model_flops=model_flops,
        chips=chips,
        peak_flops=peak_flops,
    )


H100 = {"peak_flops": H100_PEAK_FLOPS, "hbm_bw": H100_HBM_BW,
        "link_bw": H100_LINK_BW}


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# The torch counterpart of cost_analysis() and collective_bytes
# ---------------------------------------------------------------------------

# _c10d_functional (and c10d point-to-point) ops -> the HLO kind they count
# as, and which tensor is the "result" whose bytes are summed
_TORCH_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
}


def _tensor_bytes(x) -> int:
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


class RankCounter:
    """Counts one rank's work while active (a context manager over a
    `TorchDispatchMode`): `flops`, `bytes` (input plus output bytes of every
    local aten op that is not a view: unfused) and the collectives, whose
    `collectives()` has `collective_bytes`' keys. Reusable: counts add up
    over several `with` blocks."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self._coll = {k: 0.0 for k in _COLLECTIVE_FACTORS}
        self._count = {k: 0 for k in _COLLECTIVE_FACTORS}
        self._mode = None

    def collectives(self) -> Dict[str, float]:
        out = {f"{k}_bytes": v for k, v in self._coll.items()}
        out.update({f"{k}_count": float(c) for k, c in self._count.items()})
        out["total_bytes"] = sum(self._coll.values())
        return out

    def _record(self, func, args, kwargs, out) -> None:
        import torch
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns in ("_c10d_functional", "c10d") and name in _TORCH_COLLECTIVES:
            kind = _TORCH_COLLECTIVES[name]
            res = args[0] if name in ("send", "all_reduce_") else out
            self._coll[kind] += _tensor_bytes(res) * _COLLECTIVE_FACTORS[kind]
            self._count[kind] += 1
            return
        if ns in ("_c10d_functional", "c10d"):
            return  # wait_tensor, recv, barriers: no bytes of their own
        if name.startswith("empty"):
            return  # allocates, writes nothing
        if func.overloadpacket in flop_registry:
            self.flops += int(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += sum(_tensor_bytes(t) for t in tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor))

    def __enter__(self):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented  # DTensor's local calls come back
                out = func(*args, **kwargs)
                if not any(isinstance(t, FakeTensor)
                           for t in tree_leaves((args, kwargs))):
                    counter._record(func, args, kwargs, out)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        return False
