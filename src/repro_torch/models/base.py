"""Shared model plumbing: parallel context, embeddings, float32 logits,
the sequence-chunked cross-entropy."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn


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


class ParamTree(nn.Module):
    """A nested dict of tensors held as parameters that take no gradient
    (the port serves and scores; it does not train yet), read back as a
    dict: ``tree["attn"]["wq"]``, ``"bq" in tree["attn"]``.  Its state-dict
    keys are the dotted paths of the dict (``attn.wq``, ``ssm.norm.scale``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


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


def cross_entropy_chunked(x: torch.Tensor, lm_head: torch.Tensor,
                          targets: torch.Tensor, *, num_chunks: int = 16,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Sequence-chunked mean cross-entropy, never holding the full (B, S, V)
    logits: x (B, S, D); lm_head (D, V); targets (B, S) -> a float32
    scalar.  The chunk count is the JAX package's: at most ``num_chunks``
    and S, lowered until it divides S.  Each chunk's logits are float32
    (:func:`logits_for_tokens`); the loss is Σ mask·(logsumexp − gold)
    over max(Σ mask, 1).  Forward only: the port takes no gradient yet."""
    B, S, _ = x.shape
    mask_full = (torch.ones(B, S, device=x.device) if mask is None
                 else mask.float())
    num_chunks = max(1, min(num_chunks, S))
    while S % num_chunks:
        num_chunks -= 1
    C = S // num_chunks
    total = torch.zeros((), device=x.device)
    for i in range(num_chunks):
        sl = slice(i * C, (i + 1) * C)
        logits = logits_for_tokens(x[:, sl], lm_head)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 2, targets[:, sl, None].long())[..., 0]
        total = total + torch.sum((lse - gold) * mask_full[:, sl])
    return total / torch.clamp(mask_full.sum(), min=1.0)
