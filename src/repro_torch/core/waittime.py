"""Maximal wait-time distributions and their paper-optimal constructors.

Theorem 3 reduces the choice of the single-slot policy to the choice of the
*maximal wait time* distribution f_X.  The corollaries give closed forms:

  * Corollary 1 (finite-support spot, S ∈ [0, L]): optimal X puts mass only
    at {0} and [L, ∞) with P(X ≥ L) = μδ/(1 − λδ)  →  :func:`optimal_two_point`.
  * Corollary 3 (exponential spot): any f_X with Laplace transform
    L{f_X}(μ) = (1 − (λ+μ)δ)/(1 − λδ) is optimal → :func:`laplace_target`.
  * Remark 2: within the exponential family X ~ Exp(φ), φ = 1/δ − (μ + λ)
    →  :func:`optimal_exp_rate`.
  * Corollary 4 (min-max wait): the unique deterministic optimum
    X = (1/μ)·log[(1−λδ)/(1−(λ+μ)δ)]  →  :func:`optimal_deterministic`.

A family's parameters (:meth:`WaitTime.params`, host floats) become
per-lane float32 tensors in the engine, so a family can be swept across a
grid; :meth:`WaitTime.sample_from_u` reads them from that dict and turns
``u_dim`` slab uniforms into one draw of X per lane (the slab stream), and
:meth:`WaitTime.sample_from` draws from a threefry key (the split stream).
A family that is not swept samples at its own constants
(:meth:`WaitTime.sample_u`, :meth:`WaitTime.sample`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.clocks import exp_from_u

#: the engine's "never": a wait budget or clock that does not fire
INF = 3e38


@dataclasses.dataclass(frozen=True)
class WaitTime:
    """Static descriptor of the maximal-wait distribution X."""

    #: uniform draws :meth:`sample_from_u` consumes (slab stream)
    u_dim: ClassVar[int] = 0

    def params(self) -> dict:
        """This instance's parameters, the keys :meth:`sample_from_u` reads."""
        return {}

    def sample_from_u(self, params: dict, u: torch.Tensor) -> torch.Tensor:
        """One draw of X per lane from ``u[..., :u_dim]`` float32 uniforms,
        with parameters from ``params`` (float32 tensors, one per lane)."""
        raise NotImplementedError

    def sample_from(self, params: dict, key: torch.Tensor) -> torch.Tensor:
        """One draw of X per ``(..., 2)`` threefry key, with parameters
        from ``params`` (float32 tensors, one per lane)."""
        raise NotImplementedError

    def _own(self, like: torch.Tensor) -> dict:
        return {name: torch.tensor(np.float32(v), device=like.device)
                for name, v in self.params().items()}

    def sample_u(self, u: torch.Tensor) -> torch.Tensor:
        """:meth:`sample_from_u` at this instance's own parameters."""
        return self.sample_from_u(self._own(u), u)

    def sample(self, key: torch.Tensor) -> torch.Tensor:
        """:meth:`sample_from` at this instance's own parameters."""
        return self.sample_from(self._own(key), key)

    def mean(self) -> float:
        raise NotImplementedError

    def laplace(self, s: float) -> float:
        """E[e^{-sX}] where defined (used to check Corollary 3)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class InfiniteWait(WaitTime):
    """X = ∞ — wait indefinitely for a spot slot (Theorem 4 phases 1-2)."""

    def sample_from_u(self, params, u):
        del params
        return torch.full(u.shape[:-1], INF, dtype=torch.float32,
                          device=u.device)

    def sample_from(self, params, key):
        del params
        return torch.full(key.shape[:-1], INF, dtype=torch.float32,
                          device=key.device)

    def mean(self):
        return math.inf

    def laplace(self, s):
        return 0.0


@dataclasses.dataclass(frozen=True)
class TwoPointWait(WaitTime):
    """X = ``value`` w.p. ``p`` else 0 (Corollary 1 / Remark 1)."""

    p: float
    value: float

    u_dim: ClassVar[int] = 1

    def params(self):
        return {"p": self.p, "value": self.value}

    def sample_from_u(self, params, u):
        return torch.where(u[..., 0] < params["p"], params["value"], 0.0)

    def sample_from(self, params, key):
        return torch.where(threefry.uniform(key) < params["p"],
                           params["value"], 0.0)

    def mean(self):
        return self.p * self.value

    def laplace(self, s):
        return (1.0 - self.p) + self.p * math.exp(-s * self.value)


@dataclasses.dataclass(frozen=True)
class ExponentialWait(WaitTime):
    rate_: float

    u_dim: ClassVar[int] = 1

    def params(self):
        return {"rate": self.rate_}

    def sample_from_u(self, params, u):
        return exp_from_u(u[..., 0]) / params["rate"]

    def sample_from(self, params, key):
        return threefry.exponential(key) / params["rate"]

    # at its own rate the JAX package divides by a constant, which XLA
    # compiles as a product with the float32 reciprocal; a swept rate
    # (sample_from, sample_from_u) is a true division on both sides
    def _by_own_rate(self, e: torch.Tensor) -> torch.Tensor:
        return e * torch.tensor(1 / np.float32(self.rate_), device=e.device)

    def sample_u(self, u):
        return self._by_own_rate(exp_from_u(u[..., 0]))

    def sample(self, key):
        return self._by_own_rate(threefry.exponential(key))

    def mean(self):
        return 1.0 / self.rate_

    def laplace(self, s):
        return self.rate_ / (self.rate_ + s)


@dataclasses.dataclass(frozen=True)
class DeterministicWait(WaitTime):
    value: float

    def params(self):
        return {"value": self.value}

    def sample_from_u(self, params, u):
        return params["value"].expand(u.shape[:-1])

    def sample_from(self, params, key):
        return params["value"].expand(key.shape[:-1])

    def mean(self):
        return self.value

    def laplace(self, s):
        return math.exp(-s * self.value)


# ---------------------------------------------------------------------------
# Paper-optimal constructors
# ---------------------------------------------------------------------------


def strong_delay_bound(p_A_le_S: float, lam: float) -> float:
    """Theorem 2's regime boundary: δ ≤ P(A ≤ S_μ)/λ."""
    return p_A_le_S / lam


def optimal_two_point(lam: float, mu: float, delta: float, L: float) -> TwoPointWait:
    """Corollary 1 + Remark 1: mass p at L (min-max choice), 1-p at 0."""
    p = mu * delta / (1.0 - lam * delta)
    if not 0.0 <= p <= 1.0:
        raise ValueError(
            f"infeasible two-point mass p={p:.4f} (λ={lam}, μ={mu}, δ={delta})"
        )
    return TwoPointWait(p=p, value=L)


def laplace_target(lam: float, mu: float, delta: float) -> float:
    """Corollary 3: required L{f_X}(μ) for optimality under Exp(μ) spot."""
    return (1.0 - (lam + mu) * delta) / (1.0 - lam * delta)


def optimal_exp_rate(lam: float, mu: float, delta: float) -> ExponentialWait:
    """Remark 2: X ~ Exp(φ) with φ = 1/δ − (μ + λ)."""
    phi = 1.0 / delta - (mu + lam)
    if phi <= 0:
        raise ValueError(f"δ={delta} too large for exponential wait (φ={phi:.4f})")
    return ExponentialWait(rate_=phi)


def optimal_deterministic(lam: float, mu: float, delta: float) -> DeterministicWait:
    """Corollary 4: unique min-max-wait optimum (deterministic)."""
    num = 1.0 - lam * delta
    den = 1.0 - (lam + mu) * delta
    if den <= 0:
        raise ValueError(f"δ={delta} outside the strong-delay regime")
    return DeterministicWait(value=math.log(num / den) / mu)
