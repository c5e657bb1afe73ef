"""Dense MLP block: SwiGLU (3 matrices) or GELU (2 matrices).

The activation runs in float32 and is cast back before the product with
the up projection, as in the JAX package.  Weights are ``w_up (D, F)``,
``w_gate (D, F)``, ``w_down (F, D)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def mlp_init(d_model: int, d_ff: int, *, dtype=torch.bfloat16,
             variant: str = "swiglu", device=None,
             generator: torch.Generator | None = None) -> dict:
    """Normal weights at the JAX init's scales (1/sqrt(fan-in))."""
    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device)
        return (w * scale).to(dtype)

    p = {"w_up": normal((d_model, d_ff), 1.0 / math.sqrt(d_model)),
         "w_down": normal((d_ff, d_model), 1.0 / math.sqrt(d_ff))}
    if variant == "swiglu":
        p["w_gate"] = normal((d_model, d_ff), 1.0 / math.sqrt(d_model))
    return p


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU if ``w_gate`` is present, else the 2-matrix GELU MLP (tanh
    form, the default of ``jax.nn.gelu``)."""
    u = x @ params["w_up"]
    if "w_gate" in params:
        g = x @ params["w_gate"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return h @ params["w_down"]
