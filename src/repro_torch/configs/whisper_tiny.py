"""whisper-tiny [audio]: enc-dec transformer backbone, conv frontend STUB.

4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865  [arXiv:2212.04356]
Encoder operates on precomputed 1500-frame embeddings (frontend stub per spec).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,              # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,          # padded to 51968 (multiple of 128) internally
    attention_kind="full",
    use_rope=False,            # whisper uses learned/sinusoidal positions
    is_encoder_decoder=True,
    encoder_layers=4,
    encoder_seq_len=1500,      # 30s audio -> 1500 frames after conv stub
    num_frontend_tokens=1500,
    frontend_dim=384,
    norm="layernorm",
    act="gelu",
    use_glu=False,
    use_bias=True,
    tie_embeddings=True,
    param_dtype="float32",
    sharding_plan="tp",
    remat_policy="none",
    notes="enc-dec; conv frontend is a stub (input_specs provides frame embeddings)",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    encoder_seq_len=16,
    num_frontend_tokens=16,
    frontend_dim=64,
    scan_layers=False,
)
