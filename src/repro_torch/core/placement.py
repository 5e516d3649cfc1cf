"""Where the port's tensors live.

In `repro`, "device" names the *simulated* tuning target ("tpu_v5e"); the
PyTorch device is therefore always spelled `torch_device` in the port.
"""
from __future__ import annotations

from typing import Union

import torch

TorchDevice = Union[str, torch.device]


def resolve_torch_device(torch_device: TorchDevice = "cuda") -> torch.device:
    """The `torch.device` for an entry point's `torch_device` argument.

    Entry points default to "cuda"; without a card they raise instead of
    falling back to the CPU, which a caller must ask for by name."""
    dev = torch.device(torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torch_device='cuda' but CUDA is not available; pass "
            "torch_device='cpu' to run on the CPU")
    return dev
