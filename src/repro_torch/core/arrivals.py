"""Renewal arrival processes for jobs and spot instances.

The paper models both the job stream and the spot-slot stream as renewal
processes with IID inter-arrival times.  Each process is a small frozen
descriptor; the event body calls :meth:`ArrivalProcess.sample_u`, which
turns ``u_dim`` float32 uniforms (slab columns, last axis of ``u``) into
one draw per lane.  :meth:`ArrivalProcess.sample` draws from a threefry
key and is used only for the initial clocks.

Implemented families (paper §V):
  * ``Exponential(rate)``           — Poisson process.
  * ``Gamma(shape, scale)``         — paper's Gamma(1/λ, 1) job arrivals
    (integer shapes, as a sum of exponentials).
  * ``Uniform(low, high)``          — finite-support spot model (Corollary 1/2).
  * ``Deterministic(value)``        — degenerate renewal process.
  * ``BathtubGCP(A, tau1, tau2, b)``— Kadupitige et al. [27] preemptible-GCP
    spot availability: a fraction ``A`` of slots arrive almost immediately
    (Exp(tau1) head) and ``1-A`` arrive near the ~24 h preemption deadline
    (reversed-Exp(tau2) spike at ``b``).

The bathtub CDF is the mixture form of [27],

    F_S(t) = A (1 - e^{-t/τ1}) + (1 - A) e^{(t-b)/τ2},   t in [0, b],

whose density is the intended bathtub (the paper's printed formula is
degenerate as written) and whose mean with the paper's parameters is ≈12 h.

The float32 arithmetic rounds as the JAX package's compiled samplers do
on the CPU, and as the CUDA kernel does: XLA divides by a constant rate as
a product with its float32 reciprocal, and fuses ``low + u * width`` and
``b - e * tau2`` into one rounding (:func:`fma32`).  Constants enter as
float32 tensors on the sample's device: dividing a CUDA tensor by a Python
number multiplies by its reciprocal, which can round differently.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import numpy as np
import scipy.special
import torch

from repro_torch.core import threefry
from repro_torch.core.clocks import exp_from_u


def f32(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device (rounded as ``np.float32``)."""
    return torch.tensor(np.float32(value), device=like.device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add: the
    float64 product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base renewal process; subclasses define sampling and moments."""

    #: uniform draws :meth:`sample_u` consumes (None = no slab sampler)
    u_dim: ClassVar[int | None] = None

    def sample(self, key: torch.Tensor) -> torch.Tensor:
        """One float32 inter-arrival time per ``(..., 2)`` key."""
        raise NotImplementedError

    def sample_u(self, u: torch.Tensor) -> torch.Tensor:
        """Transform ``u[..., :u_dim]`` float32 uniforms into one draw."""
        raise NotImplementedError

    def mean(self) -> float:
        raise NotImplementedError

    def rate(self) -> float:
        return 1.0 / self.mean()

    def cdf(self, t: np.ndarray) -> np.ndarray:
        """Numpy CDF on a grid (used for analytics)."""
        raise NotImplementedError

    def support_upper(self) -> float:
        """Finite upper support L if any, else +inf."""
        return math.inf


@dataclasses.dataclass(frozen=True)
class Exponential(ArrivalProcess):
    rate_: float

    u_dim: ClassVar[int] = 1

    def sample(self, key):
        e = threefry.exponential(key)
        return e * f32(1 / np.float32(self.rate_), e)

    def sample_u(self, u):
        return exp_from_u(u[..., 0]) * f32(1 / np.float32(self.rate_), u)

    def mean(self):
        return 1.0 / self.rate_

    def cdf(self, t):
        t = np.asarray(t, np.float64)
        return np.where(t >= 0, 1.0 - np.exp(-self.rate_ * t), 0.0)


@dataclasses.dataclass(frozen=True)
class Gamma(ArrivalProcess):
    shape: float
    scale: float = 1.0

    @property
    def u_dim(self):
        # Gamma(n, scale) with integer n is a sum of n unit exponentials;
        # other shapes need a rejection sampler (unbounded draws)
        n = round(self.shape)
        return n if (n > 0 and math.isclose(n, self.shape)) else None

    def sample(self, key):
        raise NotImplementedError(
            "Gamma.sample needs a rejection sampler, which is not ported "
            "yet (ROADMAP.md Queue 1 item 7)")

    def sample_u(self, u):
        # left to right, one column at a time: the order the CUDA kernel sums
        s = torch.log1p(-u[..., 0])
        for i in range(1, self.u_dim):
            s = s + torch.log1p(-u[..., i])
        return -s * f32(self.scale, u)

    def mean(self):
        return self.shape * self.scale

    def cdf(self, t):
        t = np.asarray(t, np.float64)
        return scipy.special.gammainc(self.shape,
                                      np.maximum(t, 0.0) / self.scale)


@dataclasses.dataclass(frozen=True)
class Uniform(ArrivalProcess):
    low: float
    high: float

    u_dim: ClassVar[int] = 1

    def sample(self, key):
        return threefry.uniform(key, (), self.low, self.high)

    def sample_u(self, u):
        return fma32(u[..., 0], f32(self.high - self.low, u), f32(self.low, u))

    def mean(self):
        return 0.5 * (self.low + self.high)

    def cdf(self, t):
        t = np.asarray(t, np.float64)
        return np.clip((t - self.low) / (self.high - self.low), 0.0, 1.0)

    def support_upper(self):
        return self.high


@dataclasses.dataclass(frozen=True)
class Deterministic(ArrivalProcess):
    value: float

    u_dim: ClassVar[int] = 0

    def sample(self, key):
        return f32(self.value, key).expand(key.shape[:-1]).clone()

    def sample_u(self, u):
        return f32(self.value, u).expand(u.shape[:-1]).clone()

    def mean(self):
        return self.value

    def cdf(self, t):
        t = np.asarray(t, np.float64)
        return (t >= self.value).astype(np.float64)

    def support_upper(self):
        return self.value


@dataclasses.dataclass(frozen=True)
class BathtubGCP(ArrivalProcess):
    """Kadupitige-et-al. bathtub model of preemptible-GCP spot availability."""

    A: float = 0.5
    tau1: float = 1.0
    tau2: float = 0.8
    b: float = 24.0

    u_dim: ClassVar[int] = 3

    def sample(self, key):
        ks = threefry.split(key, 3)
        pick_head = threefry.uniform(ks[..., 0, :]) < f32(self.A, key)
        e2 = threefry.exponential(ks[..., 1, :])
        e3 = threefry.exponential(ks[..., 2, :])
        head = torch.minimum(e2 * f32(self.tau1, e2), f32(self.b, e2))
        tail = torch.maximum(fma32(-e3, f32(self.tau2, e3), f32(self.b, e3)),
                             f32(0.0, e3))
        return torch.where(pick_head, head, tail)

    def sample_u(self, u):
        pick_head = u[..., 0] < f32(self.A, u)
        head = torch.minimum(exp_from_u(u[..., 1]) * f32(self.tau1, u),
                             f32(self.b, u))
        tail = torch.maximum(
            fma32(-exp_from_u(u[..., 2]), f32(self.tau2, u), f32(self.b, u)),
            f32(0.0, u))
        return torch.where(pick_head, head, tail)

    def mean(self):
        # E[min(Exp(tau1), b)] = tau1 (1 - e^{-b/tau1}); E[max(b - Exp(tau2), 0)]
        # = b - tau2 (1 - e^{-b/tau2}).
        head = self.tau1 * (1.0 - math.exp(-self.b / self.tau1))
        tail = self.b - self.tau2 * (1.0 - math.exp(-self.b / self.tau2))
        return self.A * head + (1.0 - self.A) * tail

    def cdf(self, t):
        t = np.asarray(t, np.float64)
        head = np.where(t >= self.b, 1.0, 1.0 - np.exp(-np.maximum(t, 0) / self.tau1))
        tail = np.where(
            t >= self.b, 1.0, np.exp(np.minimum(t - self.b, 0.0) / self.tau2)
        )
        out = self.A * head + (1.0 - self.A) * tail
        return np.where(t < 0, 0.0, out)

    def support_upper(self):
        return self.b


def prob_A_le_S(
    job: ArrivalProcess, spot: ArrivalProcess, grid_points: int = 200_000
) -> float:
    """P(A <= S) via numeric integration: ∫ P(S >= t) dF_A(t).

    Used for the Theorem-2 regime boundary δ <= P(A <= S_μ)/λ.
    """
    upper = min(
        max(job.mean(), spot.mean()) * 40.0,
        max(
            job.support_upper() if math.isfinite(job.support_upper()) else math.inf,
            spot.support_upper() if math.isfinite(spot.support_upper()) else math.inf,
        )
        if (math.isfinite(job.support_upper()) or math.isfinite(spot.support_upper()))
        else max(job.mean(), spot.mean()) * 40.0,
    )
    if not math.isfinite(upper):
        upper = max(job.mean(), spot.mean()) * 40.0
    t = np.linspace(0.0, upper, grid_points)
    fa = np.gradient(job.cdf(t), t)  # density of A on the grid
    gs = 1.0 - spot.cdf(t)  # survival of S
    return float(np.trapezoid(fa * gs, t))


def int_G_mu(spot: ArrivalProcess, w: np.ndarray) -> np.ndarray:
    """H(w) = ∫_0^w G_μ(y) dy on a grid (Theorem-3 constraint weight)."""
    w = np.asarray(w, np.float64)
    hi = float(np.max(w)) if w.size else 1.0
    grid = np.linspace(0.0, max(hi, 1e-9), 200_000)
    g = 1.0 - spot.cdf(grid)
    cum = np.concatenate([[0.0], np.cumsum((g[1:] + g[:-1]) * 0.5 * np.diff(grid))])
    return np.interp(w, grid, cum)
