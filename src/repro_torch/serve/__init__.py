"""Serving (port of `repro.serve`): the batched prefill + decode engine."""
from repro_torch.serve.engine import Engine, Request

__all__ = ["Engine", "Request"]
