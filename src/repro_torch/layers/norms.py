"""Normalization layers (float32 inside, cast back to the input's type)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, cast back to the input's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def gated_rms_norm(params: dict, x: torch.Tensor, z: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's output norm: RMSNorm(x * silu(z))."""
    return rms_norm(params, x * F.silu(z.float()).to(x.dtype), eps=eps)
