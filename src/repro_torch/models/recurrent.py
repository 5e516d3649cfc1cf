"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427);
port of `repro.models.recurrent`.

Block: x -> [branch1: linear+GeLU] and [branch2: linear -> causal depthwise
conv(width 4) -> RG-LRU]; merge = branch1 * lru_out -> out projection.

RG-LRU:
  r_t = sigmoid(W_a y_t + b_a)          (recurrence gate)
  i_t = sigmoid(W_x y_t + b_x)          (input gate)
  log a_t = -c * softplus(Lambda) * r_t  (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

Train/prefill runs the recurrence as a log-step (Hillis-Steele) scan on
float32 tensors, where the reference has `jax.lax.associative_scan`: log2(S)
rounds of whole-tensor products and sums, which run on the card far faster
than S sequential steps in eager PyTorch (`chip_smoke.py`'s `serve_path`
line times both). Decode is a single-step update.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.act_sharding import constrain
from repro_torch.models.common import (ParamBuilder, dtype_of, gelu, layout,
                                       meta)

LRU_C = 8.0


def init_conv1d(b: ParamBuilder, name: str, width: int, channels: int):
    c = b.child(name)
    c.param("w", (width, channels), ("conv", "mlp"), scale=1.0 / width)
    c.param("bias", (channels,), ("mlp",), init="zeros")


def _conv_taps(window: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               steps: int) -> torch.Tensor:
    """sum_k window[:, k:k+steps] * w[k] in float32 (the reference's conv
    accumulates in float32), stored in window's dtype, plus the bias."""
    dtype = window.dtype
    w32 = w.to(dtype).float()
    acc = window[:, 0:steps].float() * w32[0]
    for k in range(1, w.shape[0]):
        acc = acc + window[:, k:k + steps].float() * w32[k]
    return acc.to(dtype) + bias.to(dtype)


def conv1d_causal(p, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, C]."""
    width = p["w"].shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return _conv_taps(xp, p["w"], p["bias"], x.shape[1])


def conv1d_decode(p, x_t: torch.Tensor, conv_state: torch.Tensor):
    """x_t: [B, C]; conv_state: [B, width-1, C] (oldest first)."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # [B, W, C]
    y = _conv_taps(full, p["w"], p["bias"], 1)[:, 0]
    return y, full[:, 1:]


def init_rg_lru(b: ParamBuilder, width: int):
    c = b.child("lru")
    c.param("w_a", (width, width), ("mlp", "mlp2"), scale=1.0 / width ** 0.5)
    c.param("b_a", (width,), ("mlp",), init="zeros")
    c.param("w_x", (width, width), ("mlp", "mlp2"), scale=1.0 / width ** 0.5)
    c.param("b_x", (width,), ("mlp",), init="zeros")
    # Lambda init so that a ~ [0.9, 0.999] at r=1 (standard Griffin init range)
    c.param("lambda_raw", (width,), ("mlp",), init="ones",
            dtype=torch.float32)


def _gates(p, y):
    # w_a, w_x: [width ("mlp"), width ("mlp2")], row-parallel on y's shard
    project = layout().project_out
    r = torch.sigmoid(project(y, p["w_a"].to(y.dtype))
                      + p["b_a"].to(y.dtype))
    i = torch.sigmoid(project(y, p["w_x"].to(y.dtype))
                      + p["b_x"].to(y.dtype))
    log_a = -LRU_C * F.softplus(p["lambda_raw"]) * r.float()
    return log_a, i


def _decay_and_input(p, y):
    """(a, sqrt(1 - a^2) * i * y) in float32 for the recurrence."""
    log_a, i = _gates(p, y)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) * (
        i.float() * y.float())
    return a, gated


def linear_scan(a: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t * h_{t-1} + x_t (h_{-1} = 0) along axis 1
    in log2(S) rounds. Returns (prod_{s<=t} a_s, h_t), both [B, S, W]."""
    S = a.shape[1]
    d = 1
    while d < S:
        x = torch.cat([x[:, :d], a[:, d:] * x[:, :-d] + x[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, x


def rg_lru_forward(p, y: torch.Tensor, h0=None) -> torch.Tensor:
    """y: [B, S, C] -> [B, S, C] via the log-step scan."""
    a, gated = _decay_and_input(p, y)
    a_c, h = linear_scan(a, gated)
    if h0 is not None:
        h = h + a_c * h0[:, None, :].float()
    return h.to(y.dtype)


def rg_lru_step(p, y_t: torch.Tensor, h_prev: torch.Tensor):
    """y_t: [B, C], h_prev: [B, C] (fp32)."""
    a, gated = _decay_and_input(p, y_t)
    h = a * h_prev + gated
    return h.to(y_t.dtype), h


def init_recurrent_block(b: ParamBuilder, cfg):
    d = cfg.d_model
    w = cfg.lru_width or d
    b.param("w_branch1", (d, w), ("embed", "mlp"))
    b.param("w_branch2", (d, w), ("embed", "mlp"))
    init_conv1d(b, "conv", cfg.conv_width, w)
    init_rg_lru(b, w)
    b.param("w_out", (w, d), ("mlp", "embed"))


def _branches(p, x):
    project = layout().project_in
    b1 = gelu(project(x, p["w_branch1"].to(x.dtype)))
    u = project(x, p["w_branch2"].to(x.dtype))
    return constrain(b1, "dp", None, "tp"), constrain(u, "dp", None, "tp")


def recurrent_block_forward(p, cfg, x: torch.Tensor) -> torch.Tensor:
    b1, u = _branches(p, x)
    u = conv1d_causal(p["conv"], u)
    lru_out = rg_lru_forward(p["lru"], u)
    return layout().project_out(b1 * lru_out, p["w_out"].to(x.dtype))


def recurrent_block_prefill(p, cfg, x: torch.Tensor):
    """Returns (y, state) where state = {'h': [B,W] fp32, 'conv': [B,cw-1,W]}."""
    b1, u = _branches(p, x)
    uc = conv1d_causal(p["conv"], u)
    a, gated = _decay_and_input(p["lru"], uc)
    _, h_all = linear_scan(a, gated)
    lru_out = h_all.to(x.dtype)
    y = layout().project_out(b1 * lru_out, p["w_out"].to(x.dtype))
    cw = cfg.conv_width
    state = {
        # copies, so the state does not hold the whole sequence's tensors
        "h": h_all[:, -1].clone(),             # [B, W] fp32
        "conv": u[:, -(cw - 1):].clone() if cw > 1 else
                torch.zeros((x.shape[0], 0, u.shape[-1]), dtype=x.dtype,
                            device=x.device),
    }
    return y, state


def recurrent_block_cache_spec(cfg, batch: int, context: int):
    """`recurrent_block_prefill`'s state as meta tensors (any context)."""
    w = cfg.lru_width or cfg.d_model
    return {"h": meta((batch, w), torch.float32),
            "conv": meta((batch, cfg.conv_width - 1, w),
                         dtype_of(cfg.activation_dtype))}


def recurrent_block_decode(p, cfg, x_t: torch.Tensor, state):
    """x_t: [B, 1, d] -> (y [B,1,d], new_state)."""
    b1, u = _branches(p, x_t[:, 0])
    uc, conv_state = conv1d_decode(p["conv"], u, state["conv"])
    lru_out, h = rg_lru_step(p["lru"], uc, state["h"])
    y = layout().project_out(b1 * lru_out, p["w_out"].to(x_t.dtype))
    return y[:, None], {"h": h, "conv": conv_state}
