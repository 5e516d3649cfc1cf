"""The LM zoo (port of `repro.models`): attention and RG-LRU blocks, stacks
and the top-level Model. Five of the ten configurations build here
(recurrentgemma-2b, h2o-danube-1.8b, h2o-danube-3-4b, glm4-9b,
deepseek-67b); the rest wait (ROADMAP Queue 1 item 11)."""
from repro_torch.models.model import Model, build_model, cache_length

__all__ = ["Model", "build_model", "cache_length"]
