"""Plain PyTorch versions of the batched-event sweep kernel's three traversals.

Same contracts as :func:`repro_torch.kernels.sweep.sweep.batched_event_windows`
(the single queue),
:func:`~repro_torch.kernels.sweep.sweep.market_event_windows` (the P-pool
market) and :func:`~repro_torch.kernels.sweep.sweep.region_event_windows`
(N-region routing): every lane runs through the windows of ``plan``; each
window
builds the lanes' slab with :func:`~repro_torch.core.clocks.window_slab`,
runs its events with the engine's event body on ``(lanes, slots)``
tensors, and ends with the order rebase.  On the split stream
(``rng="split"``, the single queue and the market) a window builds no
slab: each event walks the lanes' key ladder itself.  With a
:class:`~repro_torch.obs.Telemetry` (``tel``) each event is also folded
into a telemetry block a window and the stats come back as a ``(base,
telemetry)`` pair.  With an environment timeline (``ep``,
:meth:`~repro_torch.core.env.EnvTimeline.params`) the state is an
``(engine state, EnvState)`` pair and the stats an outermost ``(...,
EnvWindowStats)`` pair, as in the JAX package.  With a work model
(``work``, ``wk`` its :meth:`~repro_torch.core.work.WorkModel.params`) the
state is wrapped outermost in a ``(..., WorkState)`` pair and the stats in
a ``(..., SurvivalWindowStats)`` pair.  They are the kernels' oracles in
the tests and on the card, and the executors the engine uses for tensors
on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.clocks import window_slab
from repro_torch.core.engine import (EngineState, MarketState,
                                     MarketWindowStats, RegionState,
                                     RegionWindowStats, WindowStats,
                                     _engine_event, _engine_layout,
                                     _market_event, _market_layout,
                                     _rebase_order, _region_event,
                                     _region_layout)
from repro_torch.obs.shocks import env_zeros, stack_env_windows
from repro_torch.obs.stats import stack_windows, telemetry_zeros
from repro_torch.obs.survival import stack_survival_windows, survival_zeros


def _zeros(base, tel, n_locs: int, lanes: int, device, env: bool = False,
           work: bool = False):
    """A window's zero stats: the base block, paired with the telemetry
    block when ``tel`` is on, then with the shock counters when ``env``
    is, then (outermost) with the survival ledger when ``work`` is."""
    zeros = base
    if tel is not None:
        zeros = base, telemetry_zeros(tel, n_locs, lanes, device)
    if env:
        zeros = zeros, env_zeros(lanes, device)
    if work:
        zeros = zeros, survival_zeros(lanes, device)
    return zeros


def _stacked(cls, windows: list, tel, env: bool = False, work: bool = False):
    """Per-window stats stacked on a window axis after the lane axis."""
    if work:
        return (_stacked(cls, [w[0] for w in windows], tel, env),
                stack_survival_windows([w[1] for w in windows]))
    if env:
        return (_stacked(cls, [w[0] for w in windows], tel),
                stack_env_windows([w[1] for w in windows]))
    if tel is None:
        return cls(*(torch.stack(leaves, dim=1) for leaves in zip(*windows)))
    return (_stacked(cls, [w[0] for w in windows], None),
            stack_windows([w[1] for w in windows]))


def _base(state):
    """The engine state inside the env and work pairs of a carry."""
    while not hasattr(state, "key"):
        state = state[0]
    return state


def _map_base(state, fn):
    """``state`` with ``fn`` applied to the engine state inside its env and
    work pairs."""
    if hasattr(state, "key"):
        return fn(state)
    return (_map_base(state[0], fn),) + tuple(state[1:])


def _windows(plan, layout, state, zeros, event, rebase):
    """Run ``plan``'s windows: each draws the lanes' slab (none where
    ``layout`` is None: the split stream), runs its events from ``zeros()``
    and rebases the join order (the timeline cursor and the work state
    cross windows untouched); returns the final state and the per-window
    stats."""
    windows = []
    for n_ev in plan:
        slab = None
        if layout is not None:
            key, slab = window_slab(_base(state).key, n_ev, layout.n_cols)
            state = _map_base(state, lambda b: b._replace(key=key))
        stats = zeros()
        for e in range(n_ev):
            state, stats = event(state, stats,
                                 None if slab is None else slab[:, e])
        state = _map_base(state, rebase)
        windows.append(stats)
    return state, windows


def batched_event_windows_ref(job, spot, kernel, rmax: int,
                              state: EngineState, params: dict,
                              k_cost: torch.Tensor, plan: tuple[int, ...],
                              tel=None, ep=None, work=None, wk=None,
                              rng: str = "slab"
                              ) -> tuple[EngineState, WindowStats]:
    """Reference: ``(final_state, stats)`` with stats leaves ``(lanes, W)``,
    one float32/int32 window of sums per entry of ``plan`` (with ``tel``
    a ``(base, telemetry)`` pair, the telemetry leaves ``(lanes, W,
    ...)``; with ``ep`` the state and the stats in env pairs, with
    ``work`` in work pairs outermost), on the ``rng`` stream."""
    layout = _engine_layout(job, spot, kernel, rng)
    env, on = ep is not None, work is not None
    base = _base(state)
    lanes, device = base.key.shape[0], base.ages.device
    state, windows = _windows(
        plan, layout, state,
        lambda: _zeros(WindowStats.zeros(lanes, device), tel, 1, lanes,
                       device, env, on),
        lambda c, s, x: _engine_event(job, spot, kernel, rmax, layout, c, s,
                                      params, k_cost, x, tel, ep, work, wk),
        _rebase_order)
    return state, _stacked(WindowStats, windows, tel, env, on)


def market_event_windows_ref(job, market, kernel, rmax: int,
                             preempt_on: bool, state: MarketState,
                             params: dict, mp: dict, k_cost: torch.Tensor,
                             plan: tuple[int, ...], tel=None, ep=None,
                             work=None, wk=None, rng: str = "slab"
                             ) -> tuple[MarketState, MarketWindowStats]:
    """Reference of the market traversal: ``(final_state, stats)`` with
    stats leaves ``(lanes, W)`` and ``(lanes, W, P)`` for the pool fields
    (with ``tel`` a ``(base, telemetry)`` pair, the pools as the
    telemetry's locations; with ``ep`` the state and the stats in env
    pairs, with ``work`` in work pairs outermost).  ``mp`` is the per-lane
    pools config (``(lanes, P)`` leaves); on the ``rng="split"`` stream
    the state's preemption clocks are ``(lanes, P)``."""
    layout = _market_layout(job, market, kernel, preempt_on, rng)
    env, on = ep is not None, work is not None
    base = _base(state)
    lanes, device = base.key.shape[0], base.ages.device
    n = market.n_pools
    state, windows = _windows(
        plan, layout, state,
        lambda: _zeros(MarketWindowStats.zeros(lanes, n, device), tel, n,
                       lanes, device, env, on),
        lambda c, s, x: _market_event(job, market, kernel, rmax, preempt_on,
                                      layout, c, s, params, mp, k_cost, x,
                                      tel, ep, work, wk),
        _rebase_order)
    return state, _stacked(MarketWindowStats, windows, tel, env, on)


def region_event_windows_ref(topo, kernel, preempt_on: bool,
                             state: RegionState, params: dict, rp: dict,
                             k_cost: torch.Tensor, plan: tuple[int, ...],
                             tel=None, ep=None, work=None, wk=None
                             ) -> tuple[RegionState, RegionWindowStats]:
    """Reference of the region traversal: ``(final_state, stats)`` with
    stats leaves ``(lanes, W)`` and ``(lanes, W, R)`` for the region
    fields (with ``tel`` a ``(base, telemetry)`` pair, the regions as the
    telemetry's locations; with ``ep`` the state and the stats in env
    pairs, with ``work`` in work pairs outermost).  ``rp`` is the per-lane
    regions config (``(lanes, R)`` leaves)."""
    layout = _region_layout(topo, kernel, preempt_on)
    env, on = ep is not None, work is not None
    base = _base(state)
    lanes, device = base.key.shape[0], base.ages.device
    n = topo.n_regions
    state, windows = _windows(
        plan, layout, state,
        lambda: _zeros(RegionWindowStats.zeros(lanes, n, device), tel, n,
                       lanes, device, env, on),
        lambda c, s, x: _region_event(topo, kernel, preempt_on, layout, c, s,
                                      params, rp, k_cost, x, tel, ep, work,
                                      wk),
        _rebase_order)
    return state, _stacked(RegionWindowStats, windows, tel, env, on)
