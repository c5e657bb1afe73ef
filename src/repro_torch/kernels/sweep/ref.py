"""Plain PyTorch versions of the batched-event sweep kernel's three traversals.

Same contracts as :func:`repro_torch.kernels.sweep.sweep.batched_event_windows`
(the single queue),
:func:`~repro_torch.kernels.sweep.sweep.market_event_windows` (the P-pool
market) and :func:`~repro_torch.kernels.sweep.sweep.region_event_windows`
(N-region routing): every lane runs through the windows of ``plan``; each
window
builds the lanes' slab with :func:`~repro_torch.core.clocks.window_slab`,
runs its events with the engine's event body on ``(lanes, slots)``
tensors, and ends with the order rebase.  With a
:class:`~repro_torch.obs.Telemetry` (``tel``) each event is also folded
into a telemetry block a window and the stats come back as a ``(base,
telemetry)`` pair.  They are the kernels' oracles in the tests and on the
card, and the executors the engine uses for tensors on the CPU.
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
from repro_torch.obs.stats import stack_windows, telemetry_zeros


def _zeros(base, tel, n_locs: int, lanes: int, device):
    """A window's zero stats: the base block, paired with the telemetry
    block when ``tel`` is on."""
    if tel is None:
        return base
    return base, telemetry_zeros(tel, n_locs, lanes, device)


def _stacked(cls, windows: list, tel):
    """Per-window stats stacked on a window axis after the lane axis."""
    if tel is None:
        return cls(*(torch.stack(leaves, dim=1) for leaves in zip(*windows)))
    return (_stacked(cls, [w[0] for w in windows], None),
            stack_windows([w[1] for w in windows]))


def batched_event_windows_ref(job, spot, kernel, rmax: int,
                              state: EngineState, params: dict,
                              k_cost: torch.Tensor, plan: tuple[int, ...],
                              tel=None) -> tuple[EngineState, WindowStats]:
    """Reference: ``(final_state, stats)`` with stats leaves ``(lanes, W)``,
    one float32/int32 window of sums per entry of ``plan`` (with ``tel``
    a ``(base, telemetry)`` pair, the telemetry leaves ``(lanes, W,
    ...)``)."""
    layout = _engine_layout(job, spot, kernel)
    lanes, device = state.key.shape[0], state.ages.device
    windows = []
    for n_ev in plan:
        key, slab = window_slab(state.key, n_ev, layout.n_cols)
        state = state._replace(key=key)
        stats = _zeros(WindowStats.zeros(lanes, device), tel, 1, lanes,
                       device)
        for e in range(n_ev):
            state, stats = _engine_event(job, spot, kernel, rmax, layout,
                                         state, stats, params, k_cost,
                                         slab[:, e], tel)
        state = _rebase_order(state)
        windows.append(stats)
    return state, _stacked(WindowStats, windows, tel)


def market_event_windows_ref(job, market, kernel, rmax: int,
                             preempt_on: bool, state: MarketState,
                             params: dict, mp: dict, k_cost: torch.Tensor,
                             plan: tuple[int, ...], tel=None
                             ) -> tuple[MarketState, MarketWindowStats]:
    """Reference of the market traversal: ``(final_state, stats)`` with
    stats leaves ``(lanes, W)`` and ``(lanes, W, P)`` for the pool fields
    (with ``tel`` a ``(base, telemetry)`` pair, the pools as the
    telemetry's locations).  ``mp`` is the per-lane pools config
    (``(lanes, P)`` leaves)."""
    layout = _market_layout(job, market, kernel, preempt_on)
    lanes, device = state.key.shape[0], state.ages.device
    windows = []
    for n_ev in plan:
        key, slab = window_slab(state.key, n_ev, layout.n_cols)
        state = state._replace(key=key)
        stats = _zeros(MarketWindowStats.zeros(lanes, market.n_pools,
                                               device),
                       tel, market.n_pools, lanes, device)
        for e in range(n_ev):
            state, stats = _market_event(job, market, kernel, rmax,
                                         preempt_on, layout, state, stats,
                                         params, mp, k_cost, slab[:, e], tel)
        state = _rebase_order(state)
        windows.append(stats)
    return state, _stacked(MarketWindowStats, windows, tel)


def region_event_windows_ref(topo, kernel, preempt_on: bool,
                             state: RegionState, params: dict, rp: dict,
                             k_cost: torch.Tensor, plan: tuple[int, ...],
                             tel=None
                             ) -> tuple[RegionState, RegionWindowStats]:
    """Reference of the region traversal: ``(final_state, stats)`` with
    stats leaves ``(lanes, W)`` and ``(lanes, W, R)`` for the region
    fields (with ``tel`` a ``(base, telemetry)`` pair, the regions as the
    telemetry's locations).  ``rp`` is the per-lane regions config
    (``(lanes, R)`` leaves)."""
    layout = _region_layout(topo, kernel, preempt_on)
    lanes, device = state.key.shape[0], state.ages.device
    windows = []
    for n_ev in plan:
        key, slab = window_slab(state.key, n_ev, layout.n_cols)
        state = state._replace(key=key)
        stats = _zeros(RegionWindowStats.zeros(lanes, topo.n_regions,
                                               device),
                       tel, topo.n_regions, lanes, device)
        for e in range(n_ev):
            state, stats = _region_event(topo, kernel, preempt_on, layout,
                                         state, stats, params, rp, k_cost,
                                         slab[:, e], tel)
        state = _rebase_order(state)
        windows.append(stats)
    return state, _stacked(RegionWindowStats, windows, tel)
