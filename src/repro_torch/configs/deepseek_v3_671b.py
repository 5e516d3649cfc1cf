"""deepseek-v3-671b [moe]: MLA + fine-grained MoE (1 shared + 256 routed, top-8).

61L d_model=7168 128H d_ff=2048(expert) vocab=129280  [arXiv:2412.19437]
MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128.
Dense d_ff (first 3 layers and shared expert) = 18432.
MTP (multi-token prediction) head is optional and off for the assigned shapes.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # MLA: per-head KV reconstructed from latent
    d_ff=18432,                # dense-layer / shared-expert hidden size
    vocab_size=129280,
    attention_kind="full",
    use_rope=True,
    rope_theta=10000.0,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        d_ff_shared=2048,
        capacity_factor=1.25,
        first_dense_layers=3,
    ),
    norm="rmsnorm",
    act="silu",
    use_glu=True,
    param_dtype="bfloat16",
    moment_dtype="bfloat16",   # >100B: bf16 moments + fp32 master to fit 16GB/chip
    sharding_plan="fsdp_tp",
    remat_policy="full",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, num_shared_experts=1,
                  d_ff_shared=64, first_dense_layers=1),
    param_dtype="float32",
    moment_dtype="float32",
    sharding_plan="tp",
    remat_policy="none",
    scan_layers=False,
)
