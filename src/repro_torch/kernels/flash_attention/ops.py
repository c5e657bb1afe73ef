"""Public entry of the flash-attention kernel: GQA layout and dispatch.

``flash_attention`` takes the model's (B, S, H, D) layout, groups the
query heads of each KV head as the kernel's (B·KH, g, S, D), and sends
CUDA tensors to the hand-written kernels (:mod:`.flash_attention`, which
picks the tensor-core or CUDA-core route and launches or raises) and CPU
tensors to the plain version (``ref.py``).
The tiling contract is the JAX wrapper's on both: Sq and Sk must be at
most a block or a multiple of it, else ``ValueError``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bh, tiles)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bh_ref,
                                                     from_groups, to_groups)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, q_offset: int = 0,
                    sk_valid: Optional[int] = None):
    """GQA flash attention.  q (B,Sq,H,D); k/v (B,Sk,KH,D) -> (B,Sq,H,D)."""
    tiles(q.shape[1], k.shape[1], block_q, block_k)
    qr, kr, vr = to_groups(q, k, v)
    if q.device.type == "cpu":
        o = flash_attention_bh_ref(qr, kr, vr, causal=causal,
                                   q_offset=q_offset, sk_valid=sk_valid)
    else:
        o = flash_attention_bh(qr, kr, vr, causal=causal, block_q=block_q,
                               block_k=block_k, q_offset=q_offset,
                               sk_valid=sk_valid)
    return from_groups(o, q.shape[0])
