"""deepseek-67b [dense]: llama-architecture at depth.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400  [arXiv:2401.02954]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    attention_kind="full",
    use_rope=True,
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    use_glu=True,
    param_dtype="bfloat16",
    moment_dtype="float32",
    sharding_plan="fsdp_tp",
    remat_policy="full",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    param_dtype="float32",
    sharding_plan="tp",
    remat_policy="none",
    scan_layers=False,
)
