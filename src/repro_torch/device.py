"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device, name: str) -> torch.device:
    """``None`` means the GPU: raises where there is none, naming the
    ``device="cpu"`` escape to the plain PyTorch versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{name}: no CUDA device; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)
