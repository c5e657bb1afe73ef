"""Plain PyTorch version of the decode-attention kernel: tile-free, float32.

One query token per (batch·KV head) against the whole cache at once: the
scores of keys at or past ``kv_len`` are masked to -1e30, a softmax over
the keys, then ``p·v``.  An empty cache (``kv_len`` <= 0) gives zeros, as
the tiled kernels do: they skip every tile and divide a zero accumulator
by the clamped ``l``.  The CPU tests hold it to the JAX package's Pallas
kernel, and ``chip_smoke.py`` holds the CUDA kernel to it on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_bh_ref(q, k, v, kv_len) -> torch.Tensor:
    """q (BH, g, D); k/v (BH, S, D); kv_len a scalar -> (BH, g, D)."""
    S, D = k.shape[1], k.shape[2]
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(())
    s = torch.einsum("bgd,bsd->bgs", q.float(), k.float()) / math.sqrt(D)
    valid = torch.arange(S, device=q.device) < kv_len
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    y = torch.einsum("bgs,bsd->bgd", p, v.float())
    return torch.where(kv_len > 0, y, 0.0).to(q.dtype)


def to_groups(q, k, v):
    """q (B, 1, H, D), k/v (B, S, KH, D) -> the kernel's (B·KH, g, D) and
    (B·KH, S, D): the query heads of one KV head side by side."""
    B, _, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    qr = q.reshape(B * KH, H // KH, D).contiguous()
    kr = k.transpose(1, 2).reshape(B * KH, S, D).contiguous()
    vr = v.transpose(1, 2).reshape(B * KH, S, D).contiguous()
    return qr, kr, vr


def decode_attention_ref(q, k, v, kv_len) -> torch.Tensor:
    """q (B, 1, H, D); k/v (B, S, KH, D); kv_len scalar -> (B, 1, H, D)."""
    return decode_attention_bh_ref(*to_groups(q, k, v), kv_len).reshape(
        q.shape)
