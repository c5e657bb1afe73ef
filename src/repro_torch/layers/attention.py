"""Attention: GQA projections and the sequence-mixing implementations.

``chunked``  — flash-style online softmax over (Q, KV) blocks, in plain
               PyTorch; never materialises the S×S score matrix.
``naive``    — the full score matrix (the flash kernel's plain version).
``pallas``   — the hand-written CUDA flash-attention kernel
               (:mod:`repro_torch.kernels.flash_attention`), the port of the
               JAX package's Pallas kernel; selected via ``cfg.attn_impl``.

Decode (q_len == 1) runs :func:`decode_attention`, an online softmax over
the KV cache in plain PyTorch, as the JAX package computes it outside any
Pallas kernel.  Layouts are the JAX package's: ``wq (D, H, hd)``,
``wk``/``wv (D, KH, hd)``, ``wo (H, hd, D)``, activations (B, S, H, hd).
Products the JAX package asks in float32 (``preferred_element_type``) take
float32 operands here; a bf16 product keeps bf16 operands and output.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

NEG_INF = -1e30


def attention_init(d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, *, qkv_bias: bool = False,
                   qk_norm: bool = False, dtype=torch.bfloat16, device=None,
                   generator: torch.Generator | None = None) -> dict:
    """Normal weights at the JAX init's scales; zero biases, unit norms."""
    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device)
        return (w * scale).to(dtype)

    s_in = 1.0 / math.sqrt(d_model)
    p = {"wq": normal((d_model, num_heads, head_dim), s_in),
         "wk": normal((d_model, num_kv_heads, head_dim), s_in),
         "wv": normal((d_model, num_kv_heads, head_dim), s_in),
         "wo": normal((num_heads, head_dim, d_model),
                      1.0 / math.sqrt(num_heads * head_dim))}
    if qkv_bias:
        p["bq"] = torch.zeros(num_heads, head_dim, dtype=dtype, device=device)
        p["bk"] = torch.zeros(num_kv_heads, head_dim, dtype=dtype,
                              device=device)
        p["bv"] = torch.zeros(num_kv_heads, head_dim, dtype=dtype,
                              device=device)
    if qk_norm:
        p["q_norm"] = torch.ones(head_dim, device=device)
        p["k_norm"] = torch.ones(head_dim, device=device)
    return p


def _head_rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) · w (D, H, hd) -> (B, S, H, hd)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def qkv_project(params: dict, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if "q_norm" in params:
        q = _head_rms(q, params["q_norm"])
        k = _head_rms(k, params["k_norm"])
    return q, k, v


def out_project(params: dict, y: torch.Tensor) -> torch.Tensor:
    """y (B, S, H, hd) · wo (H, hd, D) -> (B, S, D)."""
    wo = params["wo"]
    return y.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


# ---------------------------------------------------------------------------
# Sequence mixing
# ---------------------------------------------------------------------------


def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    kv_len=None) -> torch.Tensor:
    """Oracle: full (Sq, Sk) scores. q (B,Sq,H,D); k/v (B,Sk,KH,D)."""
    return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                         sk_valid=kv_len)


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      k_chunk: int = 1024, q_offset: int = 0,
                      kv_len=None, block_skip: bool = False) -> torch.Tensor:
    """Flash-style online-softmax attention over (Q, KV) blocks."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    g = H // KH
    q_chunk, k_chunk = min(q_chunk, Sq), min(k_chunk, Sk)
    nq, nk = -(-Sq // q_chunk), -(-Sk // k_chunk)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - Sq))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * k_chunk - Sk))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * k_chunk - Sk))
    kv_valid = Sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    out = []
    for i in range(nq):
        qg = q[:, i * q_chunk:(i + 1) * q_chunk].reshape(
            B, q_chunk, KH, g, D).float()
        qpos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, q_chunk, KH, g), NEG_INF, device=dev)
        l = torch.zeros(B, q_chunk, KH, g, device=dev)
        acc = torch.zeros(B, q_chunk, KH, g, D, device=dev)
        n_blocks = nk
        if block_skip and causal:
            last_q = q_offset + (i + 1) * q_chunk - 1
            n_blocks = min(last_q // k_chunk + 1, nk)
        for j in range(n_blocks):
            kb = k[:, j * k_chunk:(j + 1) * k_chunk]
            vb = v[:, j * k_chunk:(j + 1) * k_chunk]
            kpos = j * k_chunk + torch.arange(k_chunk, device=dev)
            s = torch.einsum("bqngd,bsnd->bqngs", qg, kb.float()) * scale
            mask = kpos[None, :] < kv_valid
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bqngs,bsnd->bqngd", p.to(v.dtype).float(),
                              vb.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        y = acc / torch.clamp(l, min=1e-30)[..., None]
        out.append(y.reshape(B, q_chunk, H, D).to(q.dtype))
    return torch.cat(out, dim=1)[:, :Sq]


def decode_attention(q, k_cache, v_cache, kv_len, *, chunk: int = 4096,
                     self_kv=None) -> torch.Tensor:
    """Single-token decode: q (B,1,H,D) vs cache (B,S,KH,D); kv_len an int
    or a (B,) tensor.  Online softmax over KV chunks.

    ``self_kv=(k_new, v_new)`` each (B,1,KH,D): the new token's own K/V,
    merged into the online softmax at the model's dtype, so the cache is
    read before the token's own K/V are written back."""
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    g = H // KH
    qg = q.reshape(B, KH, g, D).float()
    if isinstance(kv_len, torch.Tensor):  # a Python int stays on the host
        kv_len = kv_len.reshape(-1, 1)
    ck = min(chunk, S)
    if S % ck:
        ck = S  # irregular sizes: single pass
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    m = torch.full((B, KH, g), NEG_INF, device=dev)
    l = torch.zeros(B, KH, g, device=dev)
    acc = torch.zeros(B, KH, g, D, device=dev)
    for j in range(S // ck):
        kb = k_cache[:, j * ck:(j + 1) * ck]
        vb = v_cache[:, j * ck:(j + 1) * ck]
        kpos = j * ck + torch.arange(ck, device=dev)
        s = torch.einsum("bngd,bsnd->bngs", qg, kb.float()) * scale
        valid = kpos[None, :] < kv_len
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bngs,bsnd->bngd", p.to(v_cache.dtype).float(),
                          vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    if self_kv is not None:
        k_new, v_new = self_kv  # (B, 1, KH, D)
        s_self = torch.einsum("bngd,bnd->bng", qg, k_new[:, 0].float()) * scale
        m_new = torch.maximum(m, s_self)
        p_self = torch.exp(s_self - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p_self
        acc = (acc * corr[..., None]
               + p_self[..., None] * v_new[:, 0][:, :, None, :].float())
    y = acc / torch.clamp(l, min=1e-30)[..., None]
    return y.reshape(B, 1, H, D).to(q.dtype)


def mix_sequence(cfg, q, k, v, *, causal: bool, q_offset: int = 0,
                 kv_len=None) -> torch.Tensor:
    """Dispatch on ``cfg.attn_impl``."""
    if cfg.attn_impl == "naive":
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
    if cfg.attn_impl == "pallas":
        return fa_ops.flash_attention(q, k, v, causal=causal)
    return chunked_attention(
        q, k, v, causal=causal, q_chunk=cfg.attn_chunk_q,
        k_chunk=cfg.attn_chunk_k, q_offset=q_offset, kv_len=kv_len,
        block_skip=cfg.causal_block_skip)
