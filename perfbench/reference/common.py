"""Plain float32 arithmetic shared by the references, and the control's
lower precision.

Imports torch alone. Every product with a weight goes through `proj`,
which at `Precision("float32")` is a float32 matmul (TF32 off) and at
`Precision("fp8")` first rounds the weight (a scale per output column)
and the activation (a scale per row) to float8 e4m3: the control, the
precision a later change would be tempted to serve in.
"""
from __future__ import annotations

import dataclasses
import math

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str = "float32"  # "float32" | "fp8"

    @property
    def fp8(self) -> bool:
        return self.name == "fp8"


FLOAT32 = Precision("float32")
FP8 = Precision("fp8")


def _fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`'s
    complement: amax over `dim` maps to the format's largest value."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def weight(w: torch.Tensor, prec: Precision) -> torch.Tensor:
    """A weight [..., in, out] at float32, rounded to fp8 with a scale per
    output column under the control."""
    w = w.float()
    return _fp8_round(w, dim=-2) if prec.fp8 else w


def act(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return _fp8_round(x, dim=-1) if prec.fp8 else x


def proj(x: torch.Tensor, w: torch.Tensor, prec: Precision,
         n_in: int = 1) -> torch.Tensor:
    """x [..., in] @ w: w's first `n_in` dims are contracted (their product
    is `in`), its other dims are the output's trailing dims."""
    in_size = math.prod(w.shape[:n_in])
    y = act(x, prec) @ weight(w.reshape(in_size, -1), prec)
    return y.reshape(*x.shape[:-1], *w.shape[n_in:])


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over x's last dim. x [..., L, H, D] with pos [L]
    (or [..., L] broadcast against x's leading dims)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = pos.float()[..., None] * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale: float, q_chunk: int = 1024):
    """q [L, H, D], k [L, G, D], v [L, G, Dv] of one sequence; H a multiple
    of G (query head h reads kv group h // (H // G)). Causal, float32,
    in chunks of query rows. Returns [L, H, Dv]."""
    L, H, _ = q.shape
    G = k.shape[1]
    R = H // G
    qg = q.reshape(L, G, R, -1).permute(1, 2, 0, 3)      # [G, R, L, D]
    kg = k.permute(1, 0, 2)                               # [G, L, D]
    vg = v.permute(1, 0, 2)                               # [G, L, Dv]
    out = torch.empty(G, R, L, v.shape[-1], dtype=torch.float32,
                      device=q.device)
    kpos = torch.arange(L, device=q.device)
    for s0 in range(0, L, q_chunk):
        s1 = min(L, s0 + q_chunk)
        sc = torch.einsum("grqd,gkd->grqk", qg[:, :, s0:s1], kg[:, :s1])
        sc = sc * scale
        rows = torch.arange(s0, s1, device=q.device)
        sc = sc.masked_fill(kpos[None, :s1] > rows[:, None], float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out[:, :, s0:s1] = torch.einsum("grqk,gkd->grqd", p, vg[:, :s1])
    return out.permute(2, 0, 1, 3).reshape(L, H, -1)


def blocks(params: dict):
    """The decoder's blocks in order, one dict of a layer's leaves each:
    the stack's prefix layers, then each group of the repeated unit (its
    stacked leaves sliced at the group), then the suffix layers."""
    sp = params["stack"]
    out = [sp["prefix"][k] for k in sorted(sp.get("prefix", {}),
                                           key=lambda s: int(s[1:]))]
    groups = sp.get("groups")
    if groups:
        unit = sorted(groups, key=lambda s: int(s[1:]))
        n = _leading(groups)
        for g in range(n):
            for pos in unit:
                out.append(_slice(groups[pos], g))
    out += [sp["suffix"][k] for k in sorted(sp.get("suffix", {}),
                                            key=lambda s: int(s[1:]))]
    return out


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _slice(tree, g: int):
    if isinstance(tree, dict):
        return {k: _slice(v, g) for k, v in tree.items()}
    return tree[g]


def gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """float32 [n]: how far each token's logit lies below the row's best."""
    t = torch.as_tensor(tokens, dtype=torch.long, device=logits.device)
    return logits.max(dim=-1).values - logits.gather(1, t[:, None])[:, 0]
