"""Decoder-only transformer LM, dense family: qwen1.5-4b and its kin.

The port of the JAX package's ``models/lm.py`` for ``family="dense"``: an
``nn.Module`` holding an ``nn.ModuleList`` of layers, each a dict of
parameters with the JAX package's names and layouts (``ln1``, ``ln2``,
``attn``, ``mlp``), so that :func:`repro_torch.convert.lm_params_from_jax`
carries a JAX parameter tree across.  The MoE and VLM branches raise until
they are ported (ROADMAP.md Queue 1 item 14).

Serving: ``prefill`` runs the prompt through every layer (the flash
kernel under ``attn_impl="pallas"``) and fills a KV cache; ``decode_step``
adds one token per sequence.  The cache holds bf16 K/V, the values the
JAX package keeps as uint16 bits of bf16.  ``decode_step`` reads the
cache, folds the new token's own K/V into the online softmax at the
model's dtype (``self_kv``), and writes them back rounded to bf16, as the
JAX package does; the write is in place, so the returned cache shares the
given one's storage.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.layers.attention import (attention_init, decode_attention,
                                          mix_sequence, out_project,
                                          qkv_project)
from repro_torch.layers.mlp import mlp, mlp_init
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rotary import apply_rope
from repro_torch.device import resolve_device
from repro_torch.models.base import (ParallelContext, ParamTree,
                                     embed_init, lm_head_init,
                                     logits_for_tokens)
from repro_torch.models.config import ModelConfig

CACHE_DTYPE = torch.bfloat16


class KVCache(NamedTuple):
    """Layer-stacked KV cache."""

    k: torch.Tensor  # (L, B, S, KH, hd) bfloat16
    v: torch.Tensor
    index: int  # next write slot == number of valid tokens


class TransformerLM(nn.Module):
    """Weights are drawn at construction at the JAX init's scales, from
    ``generator`` (seeded by the caller), on ``device`` (``None``: the
    GPU)."""

    def __init__(self, cfg: ModelConfig, ctx: Optional[ParallelContext] = None,
                 *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet "
                "(ROADMAP.md Queue 1 item 14); the port runs 'dense'")
        if cfg.input_mode != "tokens" or cfg.mrope:
            raise NotImplementedError(
                f"{cfg.name}: embedding inputs and M-RoPE belong to the VLM "
                "slice, not ported yet (ROADMAP.md Queue 1 item 14)")
        self.cfg = cfg
        self.ctx = ctx or ParallelContext()
        self.dtype = cfg.torch_dtype
        device = resolve_device(device, "TransformerLM")
        init = dict(dtype=self.dtype, device=device, generator=generator)
        d = cfg.d_model

        def ones():
            return {"scale": torch.ones(d, device=device)}

        self.layers = nn.ModuleList(ParamTree({
            "ln1": ones(), "ln2": ones(),
            "attn": attention_init(d, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.resolved_head_dim,
                                   qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                                   **init),
            "mlp": mlp_init(d, cfg.d_ff, variant=cfg.mlp_variant, **init),
        }) for _ in range(cfg.num_layers))
        self.final_norm = ParamTree({"scale": torch.ones(d, device=device)})
        self.lm_head = nn.Parameter(
            lm_head_init(d, cfg.vocab_size, **init), requires_grad=False)
        self.embed = nn.Parameter(
            embed_init(cfg.vocab_size, d, **init), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----------------------------------------------------------- core block
    def _block_seq(self, layer, x, positions):
        """Full-sequence block (prefill). Returns (x, (k, v))."""
        cfg = self.cfg
        h = rms_norm(layer["ln1"], x, cfg.norm_eps)
        q, k, v = qkv_project(layer["attn"], h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        y = out_project(layer["attn"], mix_sequence(cfg, q, k, v, causal=True))
        x = self.ctx.constrain(x + y)
        h = rms_norm(layer["ln2"], x, cfg.norm_eps)
        return self.ctx.constrain(x + mlp(layer["mlp"], h)), (k, v)

    # -------------------------------------------------------------- serving
    def init_cache(self, batch_size: int, max_len: int) -> KVCache:
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=CACHE_DTYPE, device=self.device),
            v=torch.zeros(shape, dtype=CACHE_DTYPE, device=self.device),
            index=0)

    def prefill(self, batch: dict, max_len: Optional[int] = None
                ) -> tuple[torch.Tensor, KVCache]:
        """batch {"tokens": (B, S)} -> (float32 logits (B, 1, V) of the last
        token, a cache of capacity ``max(max_len, S)`` holding S tokens)."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device, torch.long)
        B, S = tokens.shape
        x = self.ctx.constrain(self.embed[tokens])
        positions = torch.arange(S, device=self.device).expand(B, S)
        cache = self.init_cache(B, max(max_len or S, S))
        for i, layer in enumerate(self.layers):
            x, (k, v) = self._block_seq(layer, x, positions)
            cache.k[i, :, :S] = k
            cache.v[i, :, :S] = v
        x = rms_norm(self.final_norm, x, cfg.norm_eps)
        logits = logits_for_tokens(x[:, -1:], self.lm_head)
        return logits, cache._replace(index=S)

    def decode_step(self, batch: dict, cache: KVCache
                    ) -> tuple[torch.Tensor, KVCache]:
        """One token for every sequence: batch {"tokens": (B, 1)} ->
        (float32 logits (B, 1, V), the cache one token longer)."""
        cfg = self.cfg
        idx = cache.index
        if idx >= cache.k.shape[2]:
            raise ValueError(f"decode_step: the cache holds {idx} tokens, "
                             "its capacity")
        tokens = batch["tokens"].to(self.device, torch.long)
        B = tokens.shape[0]
        x = self.embed[tokens]
        positions = torch.full((B, 1), idx, device=self.device)
        for i, layer in enumerate(self.layers):
            h = rms_norm(layer["ln1"], x, cfg.norm_eps)
            q, k, v = qkv_project(layer["attn"], h)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            y = decode_attention(q, cache.k[i], cache.v[i], idx,
                                 self_kv=(k, v))
            cache.k[i, :, idx] = k[:, 0]
            cache.v[i, :, idx] = v[:, 0]
            x = x + out_project(layer["attn"], y)
            h = rms_norm(layer["ln2"], x, cfg.norm_eps)
            x = x + mlp(layer["mlp"], h)
        x = rms_norm(self.final_norm, x, cfg.norm_eps)
        logits = logits_for_tokens(x, self.lm_head)
        return logits, cache._replace(index=idx + 1)
