"""Carry state of the JAX package into the port's tensors, from numpy.

The analogue of loading weights: the parity tests build a state (raw
threefry key words, ``EngineState`` leaves, params dicts, an LM's
parameter tree and KV cache) in the JAX package, convert it with
``np.asarray`` and hand it here.  Nothing in this module imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import EngineState
from repro_torch.models.lm import KVCache


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


def _tensor(arr, device=None) -> torch.Tensor:
    """A numpy array -> a tensor of the same dtype; bfloat16 (the JAX
    package's ``ml_dtypes`` type) travels as its 16-bit words."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        words = torch.from_numpy(np.array(arr).view(np.int16))
        return words.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def lm_params_from_jax(tree: dict, device=None) -> dict:
    """A JAX ``TransformerLM`` parameter tree with numpy leaves -> the state
    dict of :class:`repro_torch.models.lm.TransformerLM`: the leading layer
    axis of ``tree["layers"]`` is unstacked into ``layers.<i>.``."""
    state = {}
    for block, leaves in tree["layers"].items():
        for name, stacked in leaves.items():
            stacked = _tensor(stacked, device)
            for i, leaf in enumerate(stacked):
                state[f"layers.{i}.{block}.{name}"] = leaf
    state["final_norm.scale"] = _tensor(tree["final_norm"]["scale"], device)
    state["lm_head"] = _tensor(tree["lm_head"], device)
    state["embed"] = _tensor(tree["embed"], device)
    return state


def kv_cache_from_jax(cache, device=None):
    """A JAX ``KVCache`` (uint16 bits of bf16, numpy leaves) -> the port's
    bf16 :class:`repro_torch.models.lm.KVCache`."""
    def bits(x):
        return torch.from_numpy(np.array(x, np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)

    return KVCache(k=bits(cache.k), v=bits(cache.v), index=int(cache.index))
