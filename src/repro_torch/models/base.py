"""Shared model plumbing: parallel context, embeddings, float32 logits."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """Mesh context threaded through models.  The port runs on one device:
    there is no mesh, and ``constrain`` is the identity."""

    mesh: Optional[object] = None

    def constrain(self, x: torch.Tensor, spec=None) -> torch.Tensor:
        if self.mesh is not None:
            raise NotImplementedError("the port runs on one device; sharded "
                                      "models are ROADMAP.md Queue 1 item 14")
        return x


def embed_init(vocab: int, d_model: int, dtype=torch.bfloat16, device=None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    w = torch.randn(vocab, d_model, generator=generator, device=device)
    return (w * (1.0 / math.sqrt(d_model))).to(dtype)


def lm_head_init(d_model: int, vocab: int, dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    w = torch.randn(d_model, vocab, generator=generator, device=device)
    return (w * (1.0 / math.sqrt(d_model))).to(dtype)


def logits_for_tokens(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """Decode-time logits (small T): x (B, T, D) · lm_head (D, V) with
    float32 products and sums and a float32 result, as the JAX package's
    ``preferred_element_type=float32``.  On the card a bf16 product asks
    the matmul for a float32 output instead of widening the weights."""
    if x.is_cuda and x.dtype == torch.bfloat16 == lm_head.dtype:
        out = torch.mm(x.reshape(-1, x.shape[-1]), lm_head,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], lm_head.shape[-1])
    return x.float() @ lm_head.float()
