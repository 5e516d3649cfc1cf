"""Operations and bytes that the served work needs, counted from the sizes
in a configuration file's `run` section, never from the program's tree or
the kernels that ran: a roofline then reads the same work whatever
implements it.

FLOPs: 2 per weight a token runs (an MoE token runs its top_k experts,
the shared experts and the router; the output head runs where a token's
logits are needed), plus attention over the positions the token attends
(GQA: 4 * H * head_dim a position, QK^T and PV; MLA: 2 * H * (nope +
rope) + 2 * H * v_head_dim). Bytes of a decode step: every weight once at
its dtype (bf16 matrices, float32 norm scales), of the embedding only
the batch's rows, and the keys and values the active requests hold.
"""
from __future__ import annotations

from typing import Iterable

BF16 = 2
F32 = 4


def _glu(d: int, ff: int) -> int:
    return 3 * d * ff


def attention_params(run: dict) -> int:
    d, H = run["d_model"], run["num_heads"]
    m = run.get("mla")
    if m:
        q = d * m["q_lora_rank"] + m["q_lora_rank"] * H * (
            m["qk_nope_head_dim"] + m["qk_rope_head_dim"])
        kv = d * (m["kv_lora_rank"] + m["qk_rope_head_dim"]) + m[
            "kv_lora_rank"] * H * (m["qk_nope_head_dim"] + m["v_head_dim"])
        return q + kv + H * m["v_head_dim"] * d
    hd, G = run["head_dim"], run["num_kv_heads"]
    return d * H * hd + 2 * d * G * hd + H * hd * d


def _moe_layer(run: dict, layer: int) -> bool:
    mo = run.get("moe")
    return bool(mo) and layer >= mo["first_dense_layers"]


def ffn_params(run: dict, layer: int, active: bool) -> int:
    """The layer's feed-forward weights: those a token runs (`active`) or
    all of them."""
    d = run["d_model"]
    if not _moe_layer(run, layer):
        return _glu(d, run["d_ff"])
    mo = run["moe"]
    n = mo["top_k"] if active else mo["num_experts"]
    return (n * _glu(d, mo["d_ff_expert"])
            + mo["num_shared_experts"] * _glu(d, mo["d_ff_shared"])
            + d * mo["num_experts"])


def norm_params(run: dict) -> int:
    """float32 norm scales: two a layer (plus MLA's q and kv norms) and
    the final one."""
    d = run["d_model"]
    per = 2 * d
    if run.get("mla"):
        per += run["mla"]["q_lora_rank"] + run["mla"]["kv_lora_rank"]
    return run["num_layers"] * per + d


def token_weight_flops(run: dict) -> float:
    """2 per weight a token runs through the stack, without the head."""
    return 2.0 * sum(attention_params(run) + ffn_params(run, i, True)
                     for i in range(run["num_layers"]))


def head_flops(run: dict) -> float:
    return 2.0 * run["d_model"] * run["vocab_size"]


def attention_flops_per_position(run: dict) -> float:
    """Summed over the layers: one query attending one position."""
    H = run["num_heads"]
    m = run.get("mla")
    if m:
        per = 2.0 * H * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) \
            + 2.0 * H * m["v_head_dim"]
    else:
        per = 4.0 * H * run["head_dim"]
    return per * run["num_layers"]


def prefill_flops(run: dict, prompt: int) -> float:
    """One request's own prompt: every token through the stack, causal
    pairs within the prompt (p (p + 1) / 2), the head at its last
    position. No padding."""
    pairs = prompt * (prompt + 1) / 2.0
    return (prompt * token_weight_flops(run)
            + pairs * attention_flops_per_position(run) + head_flops(run))


def decode_token_flops(run: dict, context: int) -> float:
    """One decode token of a request whose own context (prompt and tokens
    so far, this one included) is `context` positions."""
    return (token_weight_flops(run) + head_flops(run)
            + context * attention_flops_per_position(run))


def kv_bytes_per_position(run: dict) -> int:
    """Cache bytes one position holds over all layers (bf16)."""
    m = run.get("mla")
    if m:
        per = (m["kv_lora_rank"] + m["qk_rope_head_dim"]) * BF16
    else:
        per = 2 * run["num_kv_heads"] * run["head_dim"] * BF16
    return per * run["num_layers"]


def decode_step_bytes(run: dict, batch: int, contexts: Iterable[int]
                      ) -> float:
    """Least bytes one decode step of a dense model moves: every weight
    once (of the embedding the batch's rows), the active requests' own
    keys and values."""
    if run.get("moe"):
        raise ValueError("an MoE step's least bytes need the routed experts")
    d = run["d_model"]
    weights = sum(attention_params(run) + ffn_params(run, i, False)
                  for i in range(run["num_layers"]))
    weights += d * run["vocab_size"]                  # lm_head
    return (weights * BF16 + norm_params(run) * F32 + batch * d * BF16
            + sum(contexts) * kv_bytes_per_position(run))
