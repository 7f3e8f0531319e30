"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """The requested device; a CUDA request without a card is an error."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (device='cpu') "
            "to run on the CPU (the kernels' plain versions)")
    return device
