"""Configuration system for the repro framework.

ModelConfig captures every architectural knob needed by the 10 assigned
architectures; ShapeConfig captures the 4 assigned input shapes. The registry
maps --arch ids to configs. Nothing in this module touches jax device state at
import time.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shape configs (assigned input shapes; shared by all LM-family archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape.

    kind:
      train   -> lowers train_step(tokens[B,S], targets[B,S])
      prefill -> lowers serve_prefill(tokens[B,S])
      decode  -> lowers serve_step (one new token, KV cache of seq_len)
    """

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int          # per-expert hidden size
    num_shared_experts: int = 0
    d_ff_shared: int = 0      # hidden size of the shared expert(s)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    first_dense_layers: int = 0   # leading dense layers (DeepSeek-V3 has 3)
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class ModelConfig:
    # identity ----------------------------------------------------------------
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | encdec | vlm
    # core dims ---------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    d_ff: int = 512
    vocab_size: int = 256
    head_dim: int = 0  # 0 -> d_model // num_heads
    # attention ---------------------------------------------------------------
    attention_kind: str = "full"  # full | sliding | local
    sliding_window: int = 0       # 0 = unbounded
    use_rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    mla: Optional[MLAConfig] = None
    # MoE ---------------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    # cross-attention VLM (Llama-3.2-Vision style) ------------------------------
    cross_attn_every: int = 0       # insert 1 cross-attn layer after every N self layers
    num_frontend_tokens: int = 0    # stub frontend sequence length
    frontend_dim: int = 0           # stub frontend embedding dim (0 -> d_model)
    # encoder-decoder (Whisper style) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0        # fixed encoder length (whisper: 1500 frames)
    # hybrid / ssm block pattern -------------------------------------------------
    # e.g. ("recurrent","recurrent","attention") for RecurrentGemma,
    #      ("mlstm","slstm") for xLSTM. Empty -> homogeneous transformer blocks.
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0              # RG-LRU hidden width (0 -> d_model)
    conv_width: int = 4             # temporal conv width for recurrent blocks
    local_window: int = 2048        # local attention window for hybrid archs
    # norms / activations ----------------------------------------------------
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # silu | gelu
    use_glu: bool = True            # gated MLP (SwiGLU/GeGLU) vs plain
    use_bias: bool = False          # biases on attention/MLP projections
    tie_embeddings: bool = False
    # numerics ----------------------------------------------------------------
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    moment_dtype: str = "float32"   # Adam moment dtype (bf16 for >100B archs)
    logits_dtype: str = "float32"
    # distribution ------------------------------------------------------------
    sharding_plan: str = "tp"       # tp | fsdp_tp | dp (batch-only)
    remat_policy: str = "none"      # none | dots | full
    scan_layers: bool = True
    scan_chunk: int = 256           # chunk length for recurrent-scan kernels
                                    # (the Moses "scan" workload knob)
    vocab_pad_multiple: int = 128
    # misc ---------------------------------------------------------------------
    max_seq_len: int = 1 << 20
    notes: str = ""

    # -- derived ---------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_subquadratic_decode(self) -> bool:
        """True if decode memory/compute per token is bounded (not O(context))."""
        if self.block_pattern:  # hybrid/ssm: recurrent state + local windows
            return True
        return self.attention_kind == "sliding" and self.sliding_window > 0

    def supports_shape(self, shape: ShapeConfig) -> tuple[bool, str]:
        if shape.name == "long_500k" and not self.is_subquadratic_decode:
            return False, "full-attention arch: long_500k requires sub-quadratic decode"
        return True, ""

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for roofline MODEL_FLOPS = 6*N*D) -----------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count. active_only -> MoE counts only routed top-k."""
        d, hd = self.d_model, self.resolved_head_dim
        nh, nkv = self.num_heads, self.num_kv_heads
        V = self.padded_vocab_size

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                q = d * m.q_lora_rank + m.q_lora_rank * nh * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank * nh * (
                    m.qk_nope_head_dim + m.v_head_dim)
                o = nh * m.v_head_dim * d
                return q + kv + o
            return d * nh * hd + 2 * d * nkv * hd + nh * hd * d

        def mlp_params(ff: int) -> int:
            mult = 3 if self.use_glu else 2
            return mult * d * ff

        def moe_layer_params(active: bool) -> int:
            assert self.moe is not None
            mo = self.moe
            n_routed = mo.top_k if active else mo.num_experts
            routed = n_routed * mlp_params(mo.d_ff_expert)
            shared = mo.num_shared_experts * mlp_params(mo.d_ff_shared or mo.d_ff_expert)
            router = d * mo.num_experts
            return routed + shared + router

        def block_params(kind: str, active: bool) -> int:
            if kind == "attention":
                return attn_params() + mlp_params(self.d_ff) + 2 * d
            if kind == "recurrent":
                w = self.lru_width or d
                # in/out proj + gates + conv
                rec = 2 * d * w + 2 * w * w + self.conv_width * w + w * d
                return rec + mlp_params(self.d_ff) + 2 * d
            if kind == "mlstm":
                up = 2 * d  # up-proj factor 2
                # qkv from conv'd half, gates, out
                core = d * 2 * up + up * 3 * up // 2 + up * d
                return core + 2 * d
            if kind == "slstm":
                # 4 gates: dense input proj + block-diagonal (per-head) recurrence,
                # plus post-up-projection FFN with factor 4/3 (xLSTM paper).
                n_heads = 4
                core = 4 * d * d + 4 * (d * d // n_heads)
                ffn = int(2 * d * (4 * d / 3))
                return core + ffn + 2 * d
            if kind == "cross_attention":
                return attn_params() + mlp_params(self.d_ff) + 2 * d
            if kind == "moe_attention":
                return attn_params() + moe_layer_params(active) + 2 * d
            raise ValueError(kind)

        # decoder stack
        if self.block_pattern:
            pattern = self.block_pattern
            total = 0
            for i in range(self.num_layers):
                total += block_params(pattern[i % len(pattern)], active_only)
        elif self.moe is not None:
            total = 0
            for i in range(self.num_layers):
                if i < self.moe.first_dense_layers:
                    total += block_params("attention", active_only)
                else:
                    total += block_params("moe_attention", active_only)
        else:
            total = self.num_layers * block_params("attention", active_only)

        # cross-attn layers (vision): num_layers already counts them
        if self.cross_attn_every > 0:
            pass  # accounted: we treat every layer as attention-ish; close enough
        # encoder stack
        if self.is_encoder_decoder:
            total += self.encoder_layers * block_params("attention", active_only)
            total += self.num_layers * block_params("attention", active_only) // (
                self.num_layers or 1) * 0  # decoder already counted
            # cross attention in each decoder layer
            total += self.num_layers * attn_params()

        total += V * d  # embeddings
        if not self.tie_embeddings:
            total += V * d  # lm head
        total += d  # final norm
        return int(total)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "whisper-tiny",
    "h2o-danube-1.8b",
    "glm4-9b",
    "h2o-danube-3-4b",
    "deepseek-67b",
    "llama-3.2-vision-90b",
    "deepseek-v3-671b",
    "dbrx-132b",
    "recurrentgemma-2b",
    "xlstm-350m",
]

_MODULE_FOR_ARCH = {
    "whisper-tiny": "whisper_tiny",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "glm4-9b": "glm4_9b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "deepseek-67b": "deepseek_67b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "dbrx-132b": "dbrx_132b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-350m": "xlstm_350m",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULE_FOR_ARCH:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULE_FOR_ARCH)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[arch_id]}")
    return mod.SMOKE_CONFIG


def all_cells():
    """Yield every (arch_id, shape_name, runnable, reason) cell of the matrix."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape_name, shape in SHAPES.items():
            ok, reason = cfg.supports_shape(shape)
            yield arch_id, shape_name, ok, reason
