"""Small stand-ins for the benchmark's configurations, mixes and cells,
for the CPU tests: the real files' entries with the widths cut."""
from __future__ import annotations

import copy

from perfbench import spec

GLM_SMALL = {"num_layers": 2, "d_model": 128, "num_heads": 4,
             "num_kv_heads": 2, "d_ff": 256, "vocab_size": 512}
DS_MLA = {"q_lora_rank": 48, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
          "qk_rope_head_dim": 8, "v_head_dim": 16}
MIX = {"prompt_tokens": {"low": 8, "high": 24},
       "output_tokens": {"low": 3, "high": 8}}
# The tiny cells' limits, set as the real cells' are: on seeds 1-12 the
# program reads max_gap <= 0.0183 and mean_gap <= 0.00083 (glm) and
# <= 0.0262 and <= 0.0020 (deepseek); the fp8 control on seeds 1-4 reads
# max_gap >= 0.0513 and mean_gap >= 0.0028 (glm) and >= 0.171 and
# >= 0.0155 (deepseek). deepseek's real cell compares its mean alone.
LIMITS = {"glm": {"max_gap": 0.035, "mean_gap": 0.0016},
          "deepseek": {"mean_gap": 0.006}}


def glm(dtype: str = "bfloat16") -> dict:
    f = copy.deepcopy(spec.config_file(spec.benchmark(), "glm4-9b"))
    small = dict(GLM_SMALL, param_dtype=dtype, activation_dtype=dtype)
    f["overrides"] = dict(small)
    f["run"].update(small, head_dim=32)
    return f


def deepseek(dtype: str = "bfloat16", capacity_factor: float = 1.25,
             experts: int = 8) -> dict:
    f = copy.deepcopy(spec.config_file(spec.benchmark(), "deepseek-v3-671b"))
    moe = {"num_experts": experts, "top_k": 2, "d_ff_expert": 64,
           "num_shared_experts": 1, "d_ff_shared": 64,
           "capacity_factor": capacity_factor, "first_dense_layers": 1}
    small = {"num_layers": 3, "d_model": 128, "num_heads": 4,
             "num_kv_heads": 4, "d_ff": 256, "vocab_size": 512,
             "param_dtype": dtype, "activation_dtype": dtype}
    f["overrides"] = dict(small, mla=dict(DS_MLA), moe=dict(moe))
    f["run"].update(small, head_dim=32, mla=dict(DS_MLA), moe=dict(moe))
    return f


def cell(cfg: str = "glm", batch: int = 4) -> dict:
    return {"batch_slots": batch, "trace_decode_steps": 3,
            "check": {"tokens": 20, "limits": dict(LIMITS[cfg])}}
