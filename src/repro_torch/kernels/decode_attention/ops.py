"""Public entry of the decode-attention kernel: GQA layout and dispatch.

``decode_attention`` takes the model's layout, q (B, 1, H, D) against a
cache k/v (B, S, KH, D), groups the query heads of each KV head as the
kernel's (B·KH, g, D), and sends CUDA tensors to the hand-written kernel
(:mod:`.decode_attention`, which launches or raises) and CPU tensors to
its plain version (``ref.py``).  As in the JAX package, no model calls
it: the models' decode step runs the plain
:func:`repro_torch.layers.attention.decode_attention`.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention_bh, tile)
from repro_torch.kernels.decode_attention.ref import (decode_attention_bh_ref,
                                                      to_groups)


def decode_attention(q, k, v, kv_len, *, block_k: int = 512):
    """q (B, 1, H, D); k/v (B, S, KH, D); kv_len scalar -> (B, 1, H, D)."""
    tile(k.shape[1], block_k)
    qr, kr, vr = to_groups(q, k, v)
    if q.device.type == "cpu":
        o = decode_attention_bh_ref(qr, kr, vr, kv_len)
    else:
        o = decode_attention_bh(qr, kr, vr, kv_len, block_k=block_k)
    return o.reshape(q.shape)
