"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent.

26L d_model=2560 10H (GQA kv=1 -> MQA) d_ff=7680 vocab=256000  [arXiv:2402.19427]
Block pattern (recurrent, recurrent, attention) x 8 + 2 trailing recurrent.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,              # griffin uses head_dim 256
    attention_kind="local",
    use_rope=True,
    rope_theta=10000.0,
    block_pattern=("recurrent", "recurrent", "attention"),
    lru_width=2560,
    conv_width=4,
    local_window=2048,
    norm="rmsnorm",
    act="gelu",
    use_glu=True,              # GeGLU
    tie_embeddings=True,
    param_dtype="float32",
    sharding_plan="tp",
    remat_policy="dots",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    lru_width=128,
    local_window=16,
    scan_layers=False,
)
