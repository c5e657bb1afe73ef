"""Plain PyTorch versions of the batched-event sweep kernel's three traversals.

Same contracts as :func:`repro_torch.kernels.sweep.sweep.batched_event_windows`
(the single queue),
:func:`~repro_torch.kernels.sweep.sweep.market_event_windows` (the P-pool
market) and :func:`~repro_torch.kernels.sweep.sweep.region_event_windows`
(N-region routing): every lane runs through the windows of ``plan``; each
window
builds the lanes' slab with :func:`~repro_torch.core.clocks.window_slab`,
runs its events with the engine's event body on ``(lanes, slots)``
tensors, and ends with the order rebase.  They are the kernels' oracles in the tests
and on the card, and the executors the engine uses for tensors on the CPU.
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


def batched_event_windows_ref(job, spot, kernel, rmax: int,
                              state: EngineState, params: dict,
                              k_cost: torch.Tensor, plan: tuple[int, ...]
                              ) -> tuple[EngineState, WindowStats]:
    """Reference: ``(final_state, stats)`` with stats leaves ``(lanes, W)``,
    one float32/int32 window of sums per entry of ``plan``."""
    layout = _engine_layout(job, spot, kernel)
    lanes = state.key.shape[0]
    windows = []
    for n_ev in plan:
        key, slab = window_slab(state.key, n_ev, layout.n_cols)
        state = state._replace(key=key)
        stats = WindowStats.zeros(lanes, state.ages.device)
        for e in range(n_ev):
            state, stats = _engine_event(job, spot, kernel, rmax, layout,
                                         state, stats, params, k_cost,
                                         slab[:, e])
        state = _rebase_order(state)
        windows.append(stats)
    return state, WindowStats(*(torch.stack(leaves, dim=1)
                                for leaves in zip(*windows)))


def market_event_windows_ref(job, market, kernel, rmax: int,
                             preempt_on: bool, state: MarketState,
                             params: dict, mp: dict, k_cost: torch.Tensor,
                             plan: tuple[int, ...]
                             ) -> tuple[MarketState, MarketWindowStats]:
    """Reference of the market traversal: ``(final_state, stats)`` with
    stats leaves ``(lanes, W)`` and ``(lanes, W, P)`` for the pool fields.
    ``mp`` is the per-lane pools config (``(lanes, P)`` leaves)."""
    layout = _market_layout(job, market, kernel, preempt_on)
    lanes = state.key.shape[0]
    windows = []
    for n_ev in plan:
        key, slab = window_slab(state.key, n_ev, layout.n_cols)
        state = state._replace(key=key)
        stats = MarketWindowStats.zeros(lanes, market.n_pools,
                                        state.ages.device)
        for e in range(n_ev):
            state, stats = _market_event(job, market, kernel, rmax,
                                         preempt_on, layout, state, stats,
                                         params, mp, k_cost, slab[:, e])
        state = _rebase_order(state)
        windows.append(stats)
    return state, MarketWindowStats(*(torch.stack(leaves, dim=1)
                                      for leaves in zip(*windows)))


def region_event_windows_ref(topo, kernel, preempt_on: bool,
                             state: RegionState, params: dict, rp: dict,
                             k_cost: torch.Tensor, plan: tuple[int, ...]
                             ) -> tuple[RegionState, RegionWindowStats]:
    """Reference of the region traversal: ``(final_state, stats)`` with
    stats leaves ``(lanes, W)`` and ``(lanes, W, R)`` for the region
    fields.  ``rp`` is the per-lane regions config (``(lanes, R)``
    leaves)."""
    layout = _region_layout(topo, kernel, preempt_on)
    lanes = state.key.shape[0]
    windows = []
    for n_ev in plan:
        key, slab = window_slab(state.key, n_ev, layout.n_cols)
        state = state._replace(key=key)
        stats = RegionWindowStats.zeros(lanes, topo.n_regions,
                                        state.ages.device)
        for e in range(n_ev):
            state, stats = _region_event(topo, kernel, preempt_on, layout,
                                         state, stats, params, rp, k_cost,
                                         slab[:, e])
        state = _rebase_order(state)
        windows.append(stats)
    return state, RegionWindowStats(*(torch.stack(leaves, dim=1)
                                      for leaves in zip(*windows)))
