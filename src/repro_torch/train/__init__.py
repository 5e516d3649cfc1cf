"""Training and serving steps (port of `repro.train`): the AdamW
optimizer, the synthetic data pipeline, checkpoints in the reference's
on-disk layout, the train step and the fault-tolerant loop, and the
serving steps."""
from repro_torch.train import checkpoint, data, optimizer, train_loop

__all__ = ["checkpoint", "data", "optimizer", "train_loop"]
