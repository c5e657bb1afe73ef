"""Rotary position embeddings: float32 cos/sin, rotation of the two halves.

Qwen2-VL's 3-axis M-RoPE (``apply_mrope``) belongs to the VLM slice and
raises until it is ported (ROADMAP.md Queue 1 item 14).
"""
from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, rot_half: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin of shape (..., S, rot_half), float32."""
    exponent = torch.arange(0, rot_half, dtype=torch.float32,
                            device=positions.device) / rot_half
    # a Python base: no host-to-device copy (which would wait for the
    # device's queue) on every call
    freqs = 1.0 / torch.pow(theta, exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """x (B, S, H, D): rotate the pairs (x[:D/2], x[D/2:])."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Standard RoPE. x (B, S, H, D); positions (B, S)."""
    cos, sin = rope_angles(positions, x.shape[-1] // 2, theta)
    return _apply(x, cos, sin)


def apply_mrope(x, positions3, theta: float = 10_000.0):
    raise NotImplementedError("M-RoPE belongs to the VLM slice, not ported "
                              "yet (ROADMAP.md Queue 1 item 14)")
