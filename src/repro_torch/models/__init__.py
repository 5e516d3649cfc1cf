"""The LM zoo (port of `repro.models`): attention (GQA, MLA, cross),
RG-LRU, MoE and xLSTM blocks, stacks, the whisper encoder and the
top-level Model. All ten configurations build and serve; training waits
(ROADMAP Queue 1 item 11)."""
from repro_torch.models.model import Model, build_model, cache_length

__all__ = ["Model", "build_model", "cache_length"]
