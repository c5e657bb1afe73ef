"""Architecture registry of the port.

``get_config(name)`` returns the exact published config and
``get_config(name, smoke=True)`` the reduced same-family config the CPU
tests use, as in the JAX package.  The port carries the dense LM
qwen1.5-4b and the SSM LM mamba2-780m; the other eight raise until their
families are ported (ROADMAP.md Queue 1 item 14).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell

_MODULES = {
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
}

#: the JAX package's architectures the port does not carry yet
NOT_PORTED = ("granite-20b", "qwen3-32b", "internlm2-20b", "qwen2-moe-a2.7b",
              "arctic-480b", "whisper-small", "zamba2-1.2b", "qwen2-vl-72b")

ARCH_NAMES = list(_MODULES)

__all__ = ["ARCH_NAMES", "SHAPES", "ModelConfig", "ShapeCell", "get_config"]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet: the port carries {ARCH_NAMES} "
            "(ROADMAP.md Queue 1 item 14)")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG
