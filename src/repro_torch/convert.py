"""Carry state of the JAX package into the port's tensors, from numpy.

The analogue of loading weights: the parity tests build a state (raw
threefry key words, ``EngineState`` leaves, params dicts, an LM's
parameter tree, its KV cache or Mamba cache) in the JAX package, convert
it with ``np.asarray`` and hand it here.  Nothing in this module imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import EngineState
from repro_torch.models.lm import KVCache
from repro_torch.models.mamba_lm import MambaCache


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


def tree_from_jax(tree: dict, device=None) -> dict:
    """A (nested) JAX params dict with numpy leaves -> the same dict of
    tensors, each of its leaf's type (bf16 included)."""
    return {name: tree_from_jax(v, device) if isinstance(v, dict)
            else _tensor(v, device) for name, v in tree.items()}


def _unstack(prefix: str, tree: dict, state: dict, device) -> None:
    """Leaves of a layer-stacked (nested) tree -> ``layers.<i>.<path>``."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _unstack(f"{prefix}{name}.", leaf, state, device)
            continue
        for i, layer in enumerate(_tensor(leaf, device)):
            state[f"layers.{i}.{prefix}{name}"] = layer


def lm_params_from_jax(tree: dict, device=None) -> dict:
    """A JAX LM parameter tree with numpy leaves (``TransformerLM`` or
    ``MambaLM``) -> the state dict of the port's model of the same name:
    the leading layer axis of ``tree["layers"]`` is unstacked into
    ``layers.<i>.``, nested blocks included (a Mamba layer's
    ``ssm.norm.scale``)."""
    state = {}
    _unstack("", tree["layers"], state, device)
    state["final_norm.scale"] = _tensor(tree["final_norm"]["scale"], device)
    state["lm_head"] = _tensor(tree["lm_head"], device)
    state["embed"] = _tensor(tree["embed"], device)
    return state


def mamba_cache_from_jax(cache, device=None) -> MambaCache:
    """A JAX ``MambaCache`` with numpy leaves -> the port's
    :class:`repro_torch.models.mamba_lm.MambaCache`: ``conv`` in the
    model's type, ``state`` float32."""
    return MambaCache(conv=_tensor(cache.conv, device),
                      state=_tensor(np.asarray(cache.state, np.float32),
                                    device),
                      index=int(cache.index))


def kv_cache_from_jax(cache, device=None):
    """A JAX ``KVCache`` (uint16 bits of bf16, numpy leaves) -> the port's
    bf16 :class:`repro_torch.models.lm.KVCache`."""
    def bits(x):
        return torch.from_numpy(np.array(x, np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)

    return KVCache(k=bits(cache.k), v=bits(cache.v), index=int(cache.index))
