"""Model factory.  The port builds the ``dense`` and ``ssm`` families."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.base import ParallelContext
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import TransformerLM
from repro_torch.models.mamba_lm import MambaLM

_FAMILY_CLS = {"dense": TransformerLM, "ssm": MambaLM}


def build_model(cfg: ModelConfig, ctx: Optional[ParallelContext] = None, *,
                device=None, generator: torch.Generator | None = None):
    """The model of ``cfg`` with weights drawn from ``generator`` on
    ``device`` (``None``: the GPU)."""
    if cfg.family not in _FAMILY_CLS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP.md Queue 1 item 14); the port builds "
            f"{sorted(_FAMILY_CLS)}")
    return _FAMILY_CLS[cfg.family](cfg, ctx, device=device,
                                   generator=generator)
