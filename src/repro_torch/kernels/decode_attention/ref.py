"""Plain PyTorch version of the decode-attention kernel: tile-free, float32.

One query token per (batch·KV head) against the whole cache at once: the
scores of keys at or past ``kv_len`` are masked to -1e30, a softmax over
the keys, then ``p·v``.  An empty cache (``kv_len`` <= 0) gives zeros, as
the tiled kernels do: they skip every tile and divide a zero accumulator
by the clamped ``l``.  The CPU tests hold it to the JAX package's Pallas
kernel, and ``chip_smoke.py`` holds the CUDA kernel to it on the card.

``decode_attention_split_ref`` is the CUDA kernel's arithmetic, split over
the cache: float32 partials (m, l, acc) for each split of whole
``SPLIT_KEYS``-key chunks, over the keys of the visited ``block_k`` tiles
(those with ``k_first < kv_len``) with the same -1e30 mask, then the
combine.  The unsplit version stays the oracle.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
#: keys of one chunk of the CUDA kernel (one key a lane of a warp); a split
#: is a run of whole chunks
SPLIT_KEYS = 32


def decode_attention_bh_ref(q, k, v, kv_len) -> torch.Tensor:
    """q (BH, g, D); k/v (BH, S, D); kv_len a scalar -> (BH, g, D)."""
    S, D = k.shape[1], k.shape[2]
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(())
    s = torch.einsum("bgd,bsd->bgs", q.float(), k.float()) / math.sqrt(D)
    valid = torch.arange(S, device=q.device) < kv_len
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    y = torch.einsum("bgs,bsd->bgd", p, v.float())
    return torch.where(kv_len > 0, y, 0.0).to(q.dtype)


def split_keys(s: int, n_split: int) -> int:
    """Keys of each split of a cache of ``s`` slots in ``n_split`` splits:
    whole chunks, the chunks spread as evenly as ceil allows (the last
    splits may be short or empty)."""
    chunks = -(-s // SPLIT_KEYS)
    return -(-chunks // n_split) * SPLIT_KEYS


def visited_keys(s: int, kv_len: int, block_k: int) -> int:
    """Keys of the ``block_k`` tiles with ``k_first < kv_len``."""
    bk = min(block_k, s)
    return 0 if kv_len <= 0 else min(s, -(-kv_len // bk) * bk)


def decode_split_partials(q, k, v, kv_len, n_split: int, *,
                          block_k: int = 512):
    """The kernel's float32 partials, one a split: m, l (BH, n_split, g)
    and acc (BH, n_split, g, D).  A split's keys are those of its chunks
    that lie in the visited tiles; keys at or past ``kv_len`` score -1e30;
    m starts at -1e30.  A split that starts at or past ``kv_len`` is
    (-1e30, 0, 0)."""
    BH, g, D = q.shape
    S = k.shape[1]
    kv_len = int(kv_len)
    kps = split_keys(S, n_split)
    pos = torch.arange(n_split * kps, device=q.device)
    visited = pos < visited_keys(S, kv_len, block_k)
    pad = n_split * kps - S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    s = torch.einsum("bgd,bsd->bgs", q.float(), kf) / math.sqrt(D)
    s = torch.where(pos < kv_len, s, NEG_INF)
    s = s.reshape(BH, g, n_split, kps)
    vis = visited.reshape(n_split, kps)
    m = torch.where(vis, s, -math.inf).amax(-1).clamp(min=NEG_INF)
    p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
    live = (torch.arange(n_split, device=q.device) * kps < kv_len)
    m = torch.where(live, m, NEG_INF).transpose(1, 2)
    p = torch.where(live[:, None], p, 0.0)
    l = p.sum(-1).transpose(1, 2)
    acc = torch.einsum("bgnk,bnkd->bngd", p,
                       vf.reshape(BH, n_split, kps, D))
    return m.contiguous(), l.contiguous(), acc


def decode_attention_split_ref(q, k, v, kv_len, n_split: int, *,
                               block_k: int = 512) -> torch.Tensor:
    """q (BH, g, D); k/v (BH, S, D); kv_len a scalar -> (BH, g, D): the
    split kernel's arithmetic in plain PyTorch.  The combine rescales each
    split's (l, acc) by exp(m - max m), divides the summed acc by the summed
    l clamped at 1e-30 and casts once."""
    m, l, acc = decode_split_partials(q, k, v, kv_len, n_split,
                                      block_k=block_k)
    w = torch.exp(m - m.amax(1, keepdim=True))
    lsum = (l * w).sum(1)
    o = (acc * w[..., None]).sum(1) / lsum.clamp(min=1e-30)[..., None]
    return o.to(q.dtype)


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
