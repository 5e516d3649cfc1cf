"""glm4-9b [dense]: RoPE + aggressive GQA.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552  [hf:THUDM/glm-4-9b]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    attention_kind="full",
    use_rope=True,
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    use_glu=True,
    param_dtype="bfloat16",
    sharding_plan="fsdp_tp",
    remat_policy="dots",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    param_dtype="float32",
    sharding_plan="tp",
    scan_layers=False,
)
