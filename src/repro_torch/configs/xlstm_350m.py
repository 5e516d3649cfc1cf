"""xlstm-350m [ssm]: alternating sLSTM + mLSTM blocks.

24L d_model=1024 4H d_ff=0 (blocks carry their own projections) vocab=50304
[arXiv:2405.04517]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                    # no separate FFN; blocks have internal projections
    vocab_size=50304,
    attention_kind="full",     # unused (no attention blocks)
    use_rope=False,
    block_pattern=("mlstm", "slstm"),
    norm="layernorm",
    act="gelu",
    use_glu=False,
    tie_embeddings=True,
    param_dtype="float32",
    # pure data-parallel: the §Perf hillclimb measured 16.2x over the tp plan
    # for this 0.3B arch (TP activation collectives dominate otherwise);
    # batch shards over (pod, data, model) via batch_axes_for_plan.
    sharding_plan="dp",
    remat_policy="none",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    vocab_size=512,
    scan_layers=False,
)
