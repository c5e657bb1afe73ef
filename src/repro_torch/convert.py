"""Carry state of the JAX package into the port's tensors, from numpy.

The analogue of loading weights: the parity tests build a state (raw
threefry key words, ``EngineState`` leaves, params dicts) in the JAX
package, convert it with ``np.asarray`` and hand it here.  Nothing in this
module imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import EngineState


def key_words(raw, device=None) -> torch.Tensor:
    """uint32 key words ``(..., 2)`` -> the port's int64 key tensor."""
    return torch.from_numpy(np.asarray(raw, np.uint32).astype(np.int64)).to(
        device)


def engine_state(leaves, device=None) -> EngineState:
    """An ``EngineState`` whose fields are numpy arrays (any object with
    the field names as attributes) -> the port's ``EngineState``."""
    def arr(name, dtype):
        return torch.from_numpy(
            np.array(getattr(leaves, name), dtype)).to(device)

    return EngineState(
        key=key_words(leaves.key, device),
        next_job=arr("next_job", np.float32),
        next_spot=arr("next_spot", np.float32),
        ages=arr("ages", np.float32),
        budgets=arr("budgets", np.float32),
        occ=arr("occ", np.bool_),
        order=arr("order", np.int32),
        next_seq=arr("next_seq", np.int32),
        qlen=arr("qlen", np.int32),
    )


def params(tree: dict, device=None) -> dict:
    """A (nested) params dict of arrays -> float32 tensors."""
    return {name: params(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(device)
            for name, v in tree.items()}
