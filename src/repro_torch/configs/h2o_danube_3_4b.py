"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000  [arXiv:2401.16818]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    attention_kind="sliding",
    sliding_window=4096,
    use_rope=True,
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    use_glu=True,
    param_dtype="float32",
    sharding_plan="tp",
    remat_policy="dots",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    sliding_window=32,
    scan_layers=False,
)
