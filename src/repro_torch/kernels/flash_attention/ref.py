"""Plain PyTorch version of the flash-attention kernel: tile-free, float32.

The whole score matrix at once: ``s = q·kᵀ/√D``, masked to -1e30 where a
key is past ``sk_valid`` or (causal) in a row's future, a softmax over the
keys, then ``p·v``, cast to the input's type.  The CPU tests hold it to
the JAX package's Pallas kernel, and ``chip_smoke.py`` holds the CUDA
kernel to it on the card.  A row whose keys are all masked (``sk_valid``
<= 0) gets the mean of every value row here, and of the visited tiles'
rows in the tiled kernels.

``p_dtype=torch.bfloat16`` gives the rounding twin of the tensor-core
kernel: ``p = exp(s - m)`` rounded to bf16 before ``p·v``, ``l`` summed
from the float32 ``p``, where the kernel rounds.  :func:`tc_tolerance`
holds a tensor-core output to the float32 plain version with a floor of
twice the twin's distance from it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
#: a bf16 output against a float32-inside plain version: one bf16 ulp, and
#: at least this absolute floor near zero
BF16_RTOL, F32_ATOL = 2.0**-7, 1e-6


def to_groups(q, k, v):
    """(B, Sq, H, D), (B, Sk, KH, D) -> the kernel's (B·KH, g, Sq, D) and
    (B·KH, Sk, D): the query heads of one KV head side by side."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    g = H // KH
    qr = q.reshape(B, Sq, KH, g, D).permute(0, 2, 3, 1, 4)
    qr = qr.reshape(B * KH, g, Sq, D).contiguous()
    kr = k.transpose(1, 2).reshape(B * KH, Sk, D).contiguous()
    vr = v.transpose(1, 2).reshape(B * KH, Sk, D).contiguous()
    return qr, kr, vr


def from_groups(o: torch.Tensor, batch: int) -> torch.Tensor:
    """(B·KH, g, Sq, D) -> (B, Sq, H, D)."""
    BH, g, Sq, D = o.shape
    KH = BH // batch
    o = o.reshape(batch, KH, g, Sq, D).permute(0, 3, 1, 2, 4)
    return o.reshape(batch, Sq, KH * g, D)


def flash_attention_bh_ref(q, k, v, *, causal: bool = True,
                           q_offset: int = 0,
                           sk_valid: Optional[int] = None,
                           p_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """q (BH, g, Sq, D); k/v (BH, Sk, D) -> (BH, g, Sq, D); ``p_dtype``
    rounds the probabilities before ``p·v`` (None: float32 throughout)."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[1]
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) / math.sqrt(D)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask &= qpos[:, None] >= kpos[None, :]
    if sk_valid is not None:
        mask &= kpos[None, :] < sk_valid
    s = torch.where(mask, s, NEG_INF)
    if p_dtype is None:
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bgqk,bkd->bgqd", p, v.float()).to(q.dtype)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bgqk,bkd->bgqd", p.to(p_dtype).float(), v.float())
    return (o / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def tc_tolerance(plain: torch.Tensor, twin: torch.Tensor
                 ) -> tuple[dict, float]:
    """The tolerance of a tensor-core output against ``plain`` (the float32
    plain version): ``rtol`` one bf16 ulp, ``atol`` the larger of F32_ATOL
    and twice the floor, the largest distance between ``twin`` (the plain
    version rounding P to bf16 where the kernel does) and ``plain`` on the
    same inputs.  Returns (``assert_allclose`` keywords, the floor)."""
    floor = float((twin.float() - plain.float()).abs().max())
    return dict(rtol=BF16_RTOL, atol=max(F32_ATOL, 2 * floor)), floor


def attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                  sk_valid: Optional[int] = None,
                  p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, KH, D) -> (B, Sq, H, D), float32 math
    (``p_dtype`` as in :func:`flash_attention_bh_ref`)."""
    o = flash_attention_bh_ref(*to_groups(q, k, v), causal=causal,
                               q_offset=q_offset, sk_valid=sk_valid,
                               p_dtype=p_dtype)
    return from_groups(o, q.shape[0])
