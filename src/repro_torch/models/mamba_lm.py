"""Mamba2 (attention-free SSM) language model — mamba2-780m.

The port of the JAX package's ``models/mamba_lm.py``: an ``nn.Module``
whose layers hold the JAX package's parameter names and layouts
(``ln.scale``, ``ssm.*`` with the nested ``ssm.norm.scale``), so that
:func:`repro_torch.convert.lm_params_from_jax` carries a JAX tree
across.

``loss`` scores a token batch: every layer's scan is the hand-written CUDA
SSD kernel under ``attn_impl="pallas"`` and the plain chunked scan under
``"chunked"``.  Serving has ``TransformerLM``'s signatures, so
``BatchedServer`` serves either model: ``prefill`` runs the chunked scan
with its final state (never the kernel, as in the JAX package) and keeps
each layer's terminal state and conv window as the O(1) decode cache;
``decode_step`` advances the recurrence one token and writes the cache
in place, so the returned cache shares the given one's storage.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.ssm import (SSMCache, dims_from_cfg, mamba_block,
                                    mamba_block_decode, ssm_init,
                                    ssm_init_cache)
from repro_torch.models.base import (ParallelContext, ParamTree,
                                     cross_entropy_chunked, embed_init,
                                     lm_head_init, logits_for_tokens)
from repro_torch.models.config import ModelConfig


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (L, B, W-1, C), the model's type
    state: torch.Tensor  # (L, B, H, P, N) float32
    index: int  # tokens seen (the recurrence itself is O(1))


class MambaLM(nn.Module):
    """Weights are drawn at construction at the JAX init's scales, from
    ``generator`` (seeded by the caller), on ``device`` (``None``: the
    GPU)."""

    def __init__(self, cfg: ModelConfig, ctx: Optional[ParallelContext] = None,
                 *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: MambaLM runs the ssm family, not "
                             f"{cfg.family}")
        self.cfg = cfg
        self.ctx = ctx or ParallelContext()
        self.dims = dims_from_cfg(cfg)
        self.dtype = cfg.torch_dtype
        device = resolve_device(device, "MambaLM")
        init = dict(dtype=self.dtype, device=device, generator=generator)
        d = cfg.d_model
        self.layers = nn.ModuleList(ParamTree({
            "ln": {"scale": torch.ones(d, device=device)},
            "ssm": ssm_init(self.dims, **init),
        }) for _ in range(cfg.num_layers))
        self.final_norm = ParamTree({"scale": torch.ones(d, device=device)})
        self.lm_head = nn.Parameter(
            lm_head_init(d, cfg.vocab_size, **init), requires_grad=False)
        self.embed = nn.Parameter(
            embed_init(cfg.vocab_size, d, **init), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _tokens(self, batch: dict) -> torch.Tensor:
        return batch["tokens"].to(self.device, torch.long)

    def _run_layers(self, x, *, collect_cache: bool = False):
        cfg = self.cfg
        impl = "pallas" if cfg.attn_impl == "pallas" else "chunked"
        caches = []
        for layer in self.layers:
            h = rms_norm(layer["ln"], x, cfg.norm_eps)
            y = mamba_block(layer["ssm"], self.dims, h, norm_eps=cfg.norm_eps,
                            impl=impl, return_cache=collect_cache)
            if collect_cache:
                y, cache = y
                caches.append(cache)
            x = self.ctx.constrain(x + y)
        return (x, caches) if collect_cache else x

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch {"tokens", "targets"} (B, S) -> (mean cross-entropy, a dict
        of its parts), float32 scalars."""
        cfg = self.cfg
        x = self.ctx.constrain(self.embed[self._tokens(batch)])
        x = self._run_layers(x)
        x = rms_norm(self.final_norm, x, cfg.norm_eps)
        ce = cross_entropy_chunked(x, self.lm_head,
                                   batch["targets"].to(self.device))
        return ce, {"ce": ce, "aux": torch.zeros((), device=self.device)}

    # -------------------------------------------------------------- serving
    def init_cache(self, batch_size: int, max_len: int = 0) -> MambaCache:
        del max_len  # O(1) state
        c = ssm_init_cache(self.dims, batch_size, self.dtype, self.device)
        L = self.cfg.num_layers
        return MambaCache(conv=c.conv.expand(L, *c.conv.shape).clone(),
                          state=c.state.expand(L, *c.state.shape).clone(),
                          index=0)

    def prefill(self, batch: dict, max_len: Optional[int] = None
                ) -> tuple[torch.Tensor, MambaCache]:
        """batch {"tokens": (B, S)} -> (float32 logits (B, 1, V) of the last
        token, the decode cache after S tokens; ``max_len`` is ignored)."""
        del max_len
        tokens = self._tokens(batch)
        x, caches = self._run_layers(self.embed[tokens], collect_cache=True)
        x = rms_norm(self.final_norm, x, self.cfg.norm_eps)
        logits = logits_for_tokens(x[:, -1:], self.lm_head)
        return logits, MambaCache(
            conv=torch.stack([c.conv for c in caches]),
            state=torch.stack([c.state for c in caches]),
            index=tokens.shape[1])

    def decode_step(self, batch: dict, cache: MambaCache
                    ) -> tuple[torch.Tensor, MambaCache]:
        """One token for every sequence: batch {"tokens": (B, 1)} ->
        (float32 logits (B, 1, V), the cache one token on)."""
        cfg = self.cfg
        x = self.embed[self._tokens(batch)]  # (B, 1, D)
        for i, layer in enumerate(self.layers):
            h = rms_norm(layer["ln"], x, cfg.norm_eps)
            y, new = mamba_block_decode(
                layer["ssm"], self.dims, h,
                SSMCache(conv=cache.conv[i], state=cache.state[i]),
                norm_eps=cfg.norm_eps)
            cache.conv[i] = new.conv
            cache.state[i] = new.state
            x = x + y
        x = rms_norm(self.final_norm, x, cfg.norm_eps)
        logits = logits_for_tokens(x, self.lm_head)
        return logits, cache._replace(index=cache.index + 1)
