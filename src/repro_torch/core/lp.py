"""LP oracles for the paper's two optimization problems (+ market extension).

1. :func:`knapsack_lp` — the abstract steady-state LP (eqs. 9-11):
       max Σ π_n   s.t.  Σ n·π_n ≤ λδ,  Σ π_n ≤ 1,  π ≥ 0.
   The knapsack structure (all objective coefficients equal, constraint
   coefficients increasing in n) makes the greedy fill lowest-n-first
   optimal; we also solve it exactly by enumeration to *prove* the greedy.

2. :func:`waittime_lp` — the discretized Theorem-3 LP over the maximal-wait
   density:
       max Σ f_i F_μ(w_i)  s.t.  Σ f_i = 1,  Σ f_i H(w_i) = δ/(1−λδ),  f ≥ 0
   with H(w) = ∫₀ʷ G_μ.  An LP with two equality constraints has a basic
   optimal solution supported on ≤ 2 grid points, so exact enumeration over
   support pairs is the (scipy-free) solver.

3. :func:`market_knapsack_lp` — the heterogeneous-pool generalization.
   With pool utilizations u_p = P(a pool-p slot finds an eligible job)
   (per-pool 1 − π₀), the market Theorem-1 identity gives

       E[C] = k − Σ_p (k − c_p) (μ_p/λ) u_p,

   the per-pool occupancy bound u_p = P(N_p ≥ 1) ≤ E[N_p] plus Little's
   law Σ_p E[N_p] ≤ λδ gives Σ_p u_p ≤ λδ, and u_p ≤ 1.  Relaxing the
   shared-queue coupling (a relaxation only loosens a lower bound) leaves a
   fractional knapsack,

       max Σ_p s_p u_p,  s_p = (k − c_p)(μ_p/λ),  Σ u_p ≤ λδ,  0 ≤ u_p ≤ 1,

   whose greedy best-savings-first fill is exactly optimal.  With one unit
   pool this is the paper's min(1, λδ) bound.  ``include_preemption``
   prices in revocation: a pool with hazard h_p completes a leg with
   probability μ_p/(μ_p+h_p), so each completion pays for (μ_p+h_p)/μ_p
   legs — effective price c_p (1 + h_p/μ_p).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.arrivals import ArrivalProcess, int_G_mu


def knapsack_lp(lam: float, delta: float, n_max: int = 64) -> dict:
    """Solve eqs. (9)-(11) exactly; return greedy and enumerated optima."""
    budget = lam * delta
    # Greedy: fill π_1 first (cheapest per unit of objective), then π_2, ...
    pis = np.zeros(n_max + 1)
    remaining_mass, remaining_budget = 1.0, budget
    for n in range(1, n_max + 1):
        take = min(remaining_mass, remaining_budget / n)
        pis[n] = take
        remaining_mass -= take
        remaining_budget -= take * n
        if remaining_mass <= 1e-15 or remaining_budget <= 1e-15:
            break
    greedy_obj = float(pis.sum())
    # For this LP the optimum is min(1, λδ) and is achieved entirely at n=1.
    analytic_obj = min(1.0, budget)
    return {
        "pi": pis,
        "objective": greedy_obj,
        "analytic_objective": analytic_obj,
        "support": np.nonzero(pis)[0].tolist(),
    }


def market_knapsack_lp(k: float, lam: float, delta: float, market, *,
                       include_preemption: bool = False) -> dict:
    """Greedy-optimal fractional knapsack over heterogeneous spot pools.

    ``market`` is any object with ``rates()``/``prices()``/``hazards()``
    (any object with ``rates()``, ``prices()`` and ``hazards()``).  Returns per-pool
    utilizations ``u`` (bound on per-pool 1−π₀), job fractions ``sigma``
    (= (μ_p/λ)·u_p), the implied cost lower bound ``objective``, the fill
    order, and the effective prices used.
    """
    rates = np.asarray(market.rates(), np.float64)
    prices = np.asarray(market.prices(), np.float64)
    hazards = np.asarray(market.hazards(), np.float64)
    eff = prices * (1.0 + hazards / rates) if include_preemption else prices
    savings = (k - eff) * rates / lam  # objective coefficient of u_p
    budget = lam * delta
    u = np.zeros_like(rates)
    order = np.argsort(-savings, kind="stable")
    support = []
    for p in order:
        if savings[p] <= 0.0 or budget <= 1e-15:
            break  # a pool pricier than on-demand is never worth filling
        u[p] = min(1.0, budget)
        budget -= u[p]
        support.append(int(p))
    sigma = rates / lam * u
    return {
        "u": u,
        "sigma": sigma,
        "objective": float(k - np.sum(savings * u)),
        "support": support,
        "effective_prices": eff,
    }


def region_knapsack_lp(k: float, delta: float, topology, *,
                       include_preemption: bool = False) -> dict:
    """Pooled multi-region knapsack: the cost floor WITH cross-region routing.

    With routing at admission, any job can be served by any region's spot
    supply, so the supply side of a region topology
    is formally a pool market over the *total* demand rate λ = Σ_r λ_r:
    region r's slot rate μ_r, price c_r, and hazard h_r fill the
    :func:`market_knapsack_lp` greedy exactly (the topology's host views
    ``rates()``/``prices()``/``hazards()`` are deliberately pool-shaped).
    The home-only counterpart — each region its own closed single-queue
    problem — is :func:`repro_torch.core.cost.region_cost_lower_bound` with
    ``routed=False``; the gap between the two is the value of routing.
    """
    lam_total = float(topology.total_job_rate())
    return market_knapsack_lp(k, lam_total, delta, topology,
                              include_preemption=include_preemption)


@dataclasses.dataclass
class WaitTimeLPResult:
    support: np.ndarray  # (≤2,) wait values
    masses: np.ndarray  # (≤2,) probabilities
    objective: float  # P(X > S_μ) attained
    grid: np.ndarray
    f_weights: np.ndarray  # F_μ on the grid
    h_weights: np.ndarray  # H on the grid


def waittime_lp(
    spot: ArrivalProcess,
    lam: float,
    delta: float,
    *,
    grid_points: int = 1200,
    w_max: float | None = None,
) -> WaitTimeLPResult:
    """Exact discretized Theorem-3 LP via ≤2-point support enumeration."""
    target = delta / (1.0 - lam * delta)
    if w_max is None:
        su = spot.support_upper()
        w_max = su * 1.5 if np.isfinite(su) else spot.mean() * 20.0
    w = np.linspace(0.0, w_max, grid_points)
    F = spot.cdf(w)  # objective weights
    H = int_G_mu(spot, w)  # constraint weights

    # Single-point solutions: H_i == target.
    best_obj, best_support, best_masses = -np.inf, None, None
    close = np.abs(H - target) < 1e-12
    if close.any():
        i = int(np.argmax(np.where(close, F, -np.inf)))
        best_obj, best_support, best_masses = (
            float(F[i]),
            np.array([w[i]]),
            np.array([1.0]),
        )

    # Two-point solutions: fi·Hi + fj·Hj = target, fi + fj = 1, 0 ≤ fi ≤ 1.
    Hi = H[:, None]
    Hj = H[None, :]
    denom = Hi - Hj
    with np.errstate(divide="ignore", invalid="ignore"):
        fi = (target - Hj) / denom
        valid = np.isfinite(fi) & (fi >= 0.0) & (fi <= 1.0)
        obj = np.where(
            valid,
            np.nan_to_num(fi) * F[:, None]
            + (1.0 - np.nan_to_num(fi)) * F[None, :],
            -np.inf,
        )
    ij = np.unravel_index(np.argmax(obj), obj.shape)
    if obj[ij] > best_obj:
        i, j = int(ij[0]), int(ij[1])
        best_obj = float(obj[ij])
        best_support = np.array([w[i], w[j]])
        best_masses = np.array([float(fi[i, j]), 1.0 - float(fi[i, j])])

    if best_support is None:
        raise ValueError("wait-time LP infeasible on the given grid")
    order = np.argsort(best_support)
    return WaitTimeLPResult(
        support=best_support[order],
        masses=best_masses[order],
        objective=best_obj,
        grid=w,
        f_weights=F,
        h_weights=H,
    )


def waittime_lp_cost(k: float, lam: float, delta: float,
                     result: WaitTimeLPResult) -> float:
    """E[C] implied by an LP solution via eq. (2):
    E[C] = k − (k−1)(1−λδ)·P(X > S_μ)."""
    return k - (k - 1.0) * (1.0 - lam * delta) * result.objective
