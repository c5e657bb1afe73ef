"""Closed-form results: Theorem 2 (strong-delay optimum) and Theorem 5
(M/M/1/N cost & delay), plus the M/M/1/N stationary distribution used to
cross-validate the event simulator.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.arrivals import ArrivalProcess, prob_A_le_S


def theorem2_cost(k: float, mu: float, delta: float) -> float:
    """Optimal cost in the strong-delay regime: E[C*] = k − (k−1)·μ·δ."""
    return k - (k - 1.0) * mu * delta


def theorem2_delta_max(job: ArrivalProcess, spot: ArrivalProcess) -> float:
    """Upper edge of the strong-delay regime: P(A ≤ S_μ)/λ."""
    return prob_A_le_S(job, spot) / job.rate()


def mm1n_pi(lam: float, mu: float, n_max: int) -> np.ndarray:
    """Stationary distribution of the M/M/1/N spot queue (birth-death).

    Arrivals Poisson(λ) join while queue < N; spot slots Poisson(μ) serve the
    head.  π_n ∝ ρ^n with ρ = λ/μ, truncated at N.
    """
    rho = lam / mu
    pis = np.array([rho**n for n in range(n_max + 1)], np.float64)
    return pis / pis.sum()


def theorem5_cost(k: float, lam: float, mu: float, n_max: int) -> float:
    """E[C_N] = k − (k−1)(μ/λ)(1 − (λ/μ − 1)/((λ/μ)^{N+1} − 1))."""
    rho = lam / mu
    if abs(rho - 1.0) < 1e-12:
        # limit ρ→1: 1−π₀ = N/(N+1)
        util = n_max / (n_max + 1.0)
    else:
        util = 1.0 - (rho - 1.0) / (rho ** (n_max + 1) - 1.0)
    return k - (k - 1.0) * (mu / lam) * util


def theorem5_delta(lam: float, mu: float, n_max: int) -> float:
    """δ_N lower bound: (1/λ)·Σ n·ρⁿ / (1 + Σ ρⁿ) = E[N]/λ (Little)."""
    rho = lam / mu
    num = sum(n * rho**n for n in range(1, n_max + 1))
    den = 1.0 + sum(rho**n for n in range(1, n_max + 1))
    return num / den / lam


def mm1n_expected_queue(lam: float, mu: float, n_max: int) -> float:
    pis = mm1n_pi(lam, mu, n_max)
    return float(np.dot(np.arange(n_max + 1), pis))


def mm1n_cost_from_pi(k: float, lam: float, mu: float, n_max: int) -> float:
    """Theorem 1 applied to the M/M/1/N chain — must equal theorem5_cost."""
    pis = mm1n_pi(lam, mu, n_max)
    return k - (k - 1.0) * (mu / lam) * (1.0 - float(pis[0]))
