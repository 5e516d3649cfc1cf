"""Plain float32 reference of a dense decoder with grouped-query attention,
as the port's model files define it (`models/attention.py`,
`models/common.py`, `models/transformer.py`): pre-norm blocks of RMSNorm
(eps from the run's sizes), q/k/v projections without bias, rotate-half
RoPE over the whole head dimension, causal softmax attention with kv
group h // (H / G) for query head h, the output projection, and a SwiGLU
MLP (silu of `wi`'s product times `wg`'s, then `wo`); a final RMSNorm and
an untied `lm_head`.

Rows do not interact, so each served request is replayed on its own: the
wave's left-padded prompt (the pad token attends and is attended to, as
in the engine) followed by its served tokens, one forward pass over the
whole sequence, at float32 with TF32 off. Weights are upcast one layer
at a time.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference.common import (FLOAT32, Precision, blocks,
                                        causal_attention, proj, rms, rope,
                                        silu)

ROWS_INDEPENDENT = True


def _attention(blk, run, x, pos, prec):
    a = blk["attn"]
    hd = run["head_dim"]
    q = proj(x, a["wq"], prec)                      # [L, H, hd]
    k = proj(x, a["wk"], prec)                      # [L, G, hd]
    v = proj(x, a["wv"], prec)
    q = rope(q, pos, run["rope_theta"])
    k = rope(k, pos, run["rope_theta"])
    o = causal_attention(q, k, v, 1.0 / math.sqrt(hd))
    return proj(o.reshape(o.shape[0], -1), a["wo"], prec, n_in=2)


def _mlp(p, x, prec):
    return proj(silu(proj(x, p["wi"], prec)) * proj(x, p["wg"], prec),
                p["wo"], prec)


def sequence_logits(params, run: dict, tokens: torch.Tensor, first: int,
                    prec: Precision = FLOAT32) -> torch.Tensor:
    """float32 logits [L - first, V] at positions first..L-1 of one
    sequence `tokens` [L] (positions 0..L-1)."""
    eps = run["norm_eps"]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens].float()
    for blk in blocks(params):
        x = x + _attention(blk, run, rms(x, blk["ln_attn"]["scale"], eps),
                           pos, prec)
        x = x + _mlp(blk["mlp"], rms(x, blk["ln_mlp"]["scale"], eps), prec)
    h = rms(x[first:], params["final_norm"]["scale"], eps)
    return proj(h, params["lm_head"], prec)


def served_logits(params, run: dict, wave: dict, rows: List[int],
                  prec: Precision = FLOAT32) -> Dict[int, torch.Tensor]:
    """{row: float32 logits [n, V]} at the n positions that produced row's
    served tokens: the last padded-prompt position, then one after each
    served token but the last."""
    dev = params["embed"].device
    S = wave["tokens"].shape[1]
    out = {}
    for r in rows:
        served = list(wave["served"][r])
        seq = list(wave["tokens"][r]) + served[:-1]
        toks = torch.as_tensor(seq, dtype=torch.long, device=dev)
        out[r] = sequence_logits(params, run, toks, S - 1, prec)
    return out
