"""dbrx-132b [moe]: 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752(expert) vocab=100352
[hf:databricks/dbrx-base]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    attention_kind="full",
    use_rope=True,
    rope_theta=500000.0,
    moe=MoEConfig(
        num_experts=16,
        top_k=4,
        d_ff_expert=10752,
        num_shared_experts=0,
        capacity_factor=1.25,
    ),
    norm="layernorm",
    act="silu",
    use_glu=True,
    param_dtype="bfloat16",
    moment_dtype="bfloat16",
    sharding_plan="fsdp_tp",
    remat_policy="full",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
    param_dtype="float32",
    moment_dtype="float32",
    sharding_plan="tp",
    remat_policy="none",
    scan_layers=False,
)
