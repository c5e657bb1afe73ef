"""Plain PyTorch version of the batched-event sweep kernel.

Same contract as :func:`repro_torch.kernels.sweep.sweep.batched_event_windows`:
every lane runs through the windows of ``plan``; each window builds the
lanes' slab with :func:`~repro_torch.core.clocks.window_slab`, runs its
events with the engine's event body on ``(lanes, rmax)`` tensors, and ends
with the order rebase.  It is the kernel's oracle in the tests and on the
card, and the executor the engine uses for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.clocks import window_slab
from repro_torch.core.engine import (EngineState, WindowStats, _engine_event,
                                     _engine_layout, _rebase_order)


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
