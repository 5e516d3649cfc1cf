"""The LM zoo (port of `repro.models`): attention (GQA, MLA, cross),
RG-LRU, MoE and xLSTM blocks, stacks, the whisper encoder, the top-level
Model and the dry run's `input_specs`. All ten configurations build, serve
and train."""
from repro_torch.models.model import (Model, build_model, cache_length,
                                      input_specs)

__all__ = ["Model", "build_model", "cache_length", "input_specs"]
