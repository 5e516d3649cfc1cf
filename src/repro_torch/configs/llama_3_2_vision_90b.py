"""llama-3.2-vision-90b [vlm]: dense decoder with interleaved cross-attn image layers.

100L total = 80 self-attn + 20 cross-attn (1 cross after every 4 self).
d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision scaled per assignment]
Vision frontend is a STUB: input_specs() provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,            # counts self + cross layers
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    attention_kind="full",
    use_rope=True,
    rope_theta=500000.0,
    cross_attn_every=4,        # (4 self, 1 cross) x 20 groups
    num_frontend_tokens=2048,  # stub: precomputed vision tokens
    frontend_dim=8192,
    norm="rmsnorm",
    act="silu",
    use_glu=True,
    param_dtype="bfloat16",
    moment_dtype="float32",
    sharding_plan="fsdp_tp",
    remat_policy="full",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=5,              # (4 self, 1 cross) x 1
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    num_frontend_tokens=8,
    frontend_dim=128,
    param_dtype="float32",
    sharding_plan="tp",
    remat_policy="none",
    scan_layers=False,
)
