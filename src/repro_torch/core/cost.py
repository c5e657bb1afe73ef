"""Cost laws (Theorem 1) and empirical cost accounting.

Theorem 1: for *any* scheduling policy over a G/G/1 spot queue in steady
state,

    E[C] = k − (k−1) · (E[A]/E[S_μ]) · (1 − π₀) = k − (k−1) · (μ/λ) · (1 − π₀)

where π₀ is the steady-state probability that a spot arrival finds the queue
empty.  The whole optimization therefore reduces to maximizing spot-slot
utilization (1 − π₀) subject to the delay constraint.
"""
from __future__ import annotations


def theorem1_cost(k: float, lam: float, mu: float, pi0: float) -> float:
    """E[C] from the empty-queue probability (Theorem 1)."""
    return k - (k - 1.0) * (mu / lam) * (1.0 - pi0)


def pi0_from_cost(k: float, lam: float, mu: float, cost: float) -> float:
    """Invert Theorem 1: recover π₀ implied by an observed average cost."""
    return 1.0 - (k - cost) / ((k - 1.0) * (mu / lam))


def spot_utilization_bound(lam: float, mu: float, delta: float) -> float:
    """Knapsack-LP bound on (1−π₀): min(1, λδ) (Section IV, eqs. 9-11).

    With Little's law E[N] = λ·E[T] ≤ λδ and π_n ≤ coefficients increasing
    in n, the abstract LP's optimum is Σπ_n = min(1, λδ).
    """
    return min(1.0, lam * delta)


def cost_lower_bound(k: float, lam: float, mu: float, delta: float) -> float:
    """Policy-independent lower bound on E[C] from Theorem 1 + the LP bound."""
    return k - (k - 1.0) * (mu / lam) * spot_utilization_bound(lam, mu, delta)


# ---------------------------------------------------------------------------
# Work-structured jobs (the work axis, still to be ported)
# ---------------------------------------------------------------------------


def all_ondemand_cost(k: float, jobs: float, total_work: float = 1.0) -> float:
    """The all-on-demand cost floor for work-structured jobs.

    Sending every one of ``jobs`` jobs straight to on-demand costs
    ``k × total_work`` each — no spot savings, no preemption risk, and (by
    construction, for any feasible deadline ``total_work·od_time ≤ D``)
    zero deadline misses.  This is the safety baseline every
    checkpoint/safety-net kernel must beat on cost while matching on
    misses: the can't-be-late acceptance bar
    (``tests/test_work.py``, EXPERIMENTS.md §Checkpoint-priced recovery).
    """
    return float(k) * float(jobs) * float(total_work)


# ---------------------------------------------------------------------------
# Heterogeneous-pool market generalization (the market loop, still to be ported)
# ---------------------------------------------------------------------------


def theorem1_market_cost(k: float, lam: float, rates, prices, utils) -> float:
    """Market Theorem 1: E[C] from per-pool slot utilizations.

    With pool slot rates μ_p, prices c_p, and utilizations
    u_p = P(a pool-p slot finds an eligible job) — the per-pool 1 − π₀ the
    engine reports as ``pool_utilization`` — the fraction of jobs served by
    pool p is (μ_p/λ)·u_p, so

        E[C] = k − Σ_p (k − c_p) (μ_p/λ) u_p.

    Preemption-free identity: revoked legs pay extra spot cost on top (the
    engine's ``spot_cost`` tracks it), so under preemption this is the cost
    of the *completed-leg* flow only.  One unit-price pool recovers
    :func:`theorem1_cost` exactly.
    """
    import numpy as np

    rates = np.asarray(rates, np.float64)
    prices = np.asarray(prices, np.float64)
    utils = np.asarray(utils, np.float64)
    return float(k - np.sum((k - prices) * rates / lam * utils))


def market_cost_lower_bound(k: float, lam: float, delta: float, market, *,
                            include_preemption: bool = False) -> float:
    """Policy-independent market bound: Theorem 1 + the multi-pool LP
    (:func:`repro_torch.core.lp.market_knapsack_lp`)."""
    from repro_torch.core.lp import market_knapsack_lp

    return market_knapsack_lp(k, lam, delta, market,
                              include_preemption=include_preemption)[
                                  "objective"]


# ---------------------------------------------------------------------------
# Multi-region generalization (the region loop, still to be ported)
# ---------------------------------------------------------------------------


def theorem1_region_cost(k: float, lam: float, rates, prices, utils) -> float:
    """Region Theorem 1: E[C] from per-region slot utilizations.

    Identical algebra to :func:`theorem1_market_cost` — under routing, a
    region's spot supply is a pool serving the pooled job stream:
    ``E[C] = k − Σ_r (k − c_r)(μ_r/λ)u_r`` with ``u_r`` the per-region slot
    utilization the engine reports as ``region_utilization`` and ``λ`` the
    *total* (all-region) job arrival rate.  Preemption-free identity, like
    its market twin.
    """
    return theorem1_market_cost(k, lam, rates, prices, utils)


def region_cost_lower_bound(k: float, delta: float, topology, *,
                            routed: bool = True,
                            include_preemption: bool = False) -> float:
    """Policy-independent multi-region bound on E[C].

    ``routed=True`` (default): cross-region routing pools all demand against
    all supply — the :func:`repro_torch.core.lp.region_knapsack_lp` floor.
    ``routed=False``: no routing; region r is a closed single-queue problem
    at its own ``λ_r``, and the bound is the λ-weighted average of the
    per-region floors.  Pooling relaxes the per-region constraints, so
    routed ≤ home-only always; the gap is the value routing can capture
    (tested in tests/test_core_regions.py).
    """
    from repro_torch.core.lp import market_knapsack_lp, region_knapsack_lp

    if routed:
        return region_knapsack_lp(k, delta, topology,
                                  include_preemption=include_preemption)[
                                      "objective"]
    lams = topology.job_rates()
    lam_total = float(lams.sum())
    total = 0.0
    for r, lam_r in zip(topology.regions, lams):
        view = _SingleRegionSupply(r)
        obj = market_knapsack_lp(k, float(lam_r), delta, view,
                                 include_preemption=include_preemption)[
                                     "objective"]
        total += (lam_r / lam_total) * obj
    return float(total)


class _SingleRegionSupply:
    """One region's supply as a 1-pool market view for the knapsack LP."""

    def __init__(self, region):
        self._r = region

    def rates(self):
        import numpy as np

        return np.array([self._r.spot_rate()], np.float64)

    def prices(self):
        import numpy as np

        return np.array([self._r.price], np.float64)

    def hazards(self):
        import numpy as np

        return np.array([self._r.hazard], np.float64)
