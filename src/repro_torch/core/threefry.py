"""Threefry-2x32, the counter-based generator behind the engine's randomness.

The port's counterpart of the parts of ``jax.random`` the engine uses, bitwise
the JAX stream under ``jax_threefry_partitionable=True`` (the JAX 0.9
default):

* a key is two 32-bit words, an int64 tensor of shape ``(..., 2)``;
  :func:`key` makes ``[seed >> 32, seed & 0xFFFFFFFF]``;
* :func:`split` is the fold-like split: subkey ``i`` is both words of
  ``threefry2x32(key, (0, i))``; :func:`fold_in` of ``data`` is the same
  hash of ``(0, data)``, so it equals subkey ``data`` of a split;
* :func:`bits32` hashes the flat element index ``(hi, lo)`` and returns
  ``x0 ^ x1`` (a scalar shape uses counter ``(0, 0)``);
* :func:`uniform` puts the top 23 bits under the exponent of 1.0 and
  subtracts 1; :func:`exponential` is ``-log1p(-uniform)``.  The uniforms
  are bitwise JAX's; the exponentials are within one ulp of them, because
  ``log1p`` itself rounds differently in XLA and in PyTorch;
* :func:`randint` (``jax.random.randint`` at shape ``()``, int32) and
  :func:`gumbel` (``jax.random.gumbel``, float32, its default mode): the
  integers bitwise, the Gumbel draws up to the rounding of ``log``.

Every word lives in an int64 tensor masked to 32 bits, because PyTorch on
the CPU has no uint32 add or shift.  Leading key dimensions batch: a
``(lanes, 2)`` key gives one independent stream per lane.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, c0, c1
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counters ``(c0, c1)`` under key
    words ``(k0, k1)``; all four broadcast.  Returns the two output words.

    ``x0`` is masked only at the end: it is only ever added to and xor-ed
    into ``x1``, whose low 32 bits do not depend on its higher ones (it
    stays below 2^38), and ``x1`` is masked before every rotation."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = c0 + ks[0]
    x1 = (c1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & MASK
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0 & MASK, x1


def key(seed: int, device=None) -> torch.Tensor:
    """Raw key of an integer seed, as ``jax.random.key(seed)`` holds it."""
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``(..., 2)`` key -> ``(..., n, 2)`` subkeys (``jax.random.split``)."""
    hi, lo = _counters(n, key.device)
    x0, x1 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack([x0, x1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``(..., 2)`` key -> ``(..., 2)`` key folded with the 32-bit integer
    ``data`` (``jax.random.fold_in``: the hash of counter ``(0, data)``);
    a sequence of ``n`` integers folds each, ``(..., n, 2)``, in one
    hash."""
    if isinstance(data, (tuple, list)):
        data = torch.tensor([int(d) & MASK for d in data], dtype=torch.int64,
                            device=key.device)
        x0, x1 = threefry2x32(key[..., None, 0], key[..., None, 1], 0, data)
    else:
        data = torch.as_tensor(int(data) & MASK, dtype=torch.int64,
                               device=key.device)
        x0, x1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([x0, x1], dim=-1)


def bits32(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """``(..., 2)`` key -> ``(..., *shape)`` raw 32-bit words
    (``jax.random.bits(key, shape, uint32)``)."""
    shape = tuple(shape)
    hi, lo = _counters(math.prod(shape), key.device)
    x0, x1 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return (x0 ^ x1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms on ``[minval, maxval)`` (``jax.random.uniform``)."""
    bits = bits32(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # JAX's CPU backend fuses ``floats * (hi - lo) + lo`` into one rounding
    # (an FMA); the float64 product of two float32 values is exact, so one
    # float64 add and the cast back round the same way.
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def exponential(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """Unit-rate float32 exponentials (``jax.random.exponential``)."""
    return -torch.log1p(-uniform(key, shape))


def randint(key: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """One int32 draw on ``[minval, maxval)`` per ``(..., 2)`` key
    (``jax.random.randint(key, (), minval, maxval)``): the key splits in
    two, each half gives a 32-bit word, and the pair reduces modulo the
    span in uint32 arithmetic, ``((hi % n) * m + lo % n) % n`` with ``m =
    2^32 % n`` computed as ``(2^16 % n)^2 % n``."""
    span = max(int(maxval) - int(minval), 1)
    ks = split(key, 2)
    hi, lo = bits32(ks[..., 0, :]), bits32(ks[..., 1, :])
    m = (2**16 % span) ** 2 % span
    off = ((hi % span) * m + lo % span) % span
    return (off + int(minval)).to(torch.int32)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., n)`` standard Gumbel float32 draws per ``(..., 2)`` key
    (``jax.random.gumbel(key, (n,))``): ``-log(-log(u))`` of the uniforms
    on ``[tiny, 1)``, whose words follow :func:`bits32`'s counters."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(key, (n,), tiny, 1.0)))
