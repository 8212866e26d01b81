"""The device rule of the port's entry points: CUDA unless the caller names
another device; with no device named and no CUDA available, raise rather than
run on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)
