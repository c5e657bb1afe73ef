"""Public entry of the batched-event sweep kernel: dispatch by device.

A fleet whose state lies on a CUDA device goes to the hand-written kernel
(:mod:`repro_torch.kernels.sweep.sweep`), which launches or raises; a fleet
on the CPU goes to the kernel's plain PyTorch version (``ref.py``).
"""
from __future__ import annotations

from repro_torch.kernels.sweep.ref import (batched_event_windows_ref,
                                           market_event_windows_ref,
                                           region_event_windows_ref)
from repro_torch.kernels.sweep.sweep import (batched_event_windows,
                                             market_event_windows,
                                             region_event_windows)


def _on_cpu(state) -> bool:
    """Does the fleet (its engine state, inside any env and work pairs) lie
    on the CPU?"""
    while not hasattr(state, "key"):
        state = state[0]
    return state.key.device.type == "cpu"


def batched_events(job, spot, kernel, rmax, state, params, k_cost, plan,
                   tel=None, ep=None, work=None, wk=None, rng="slab"):
    """Run stacked event windows; see ``batched_event_windows``."""
    run = batched_event_windows_ref if _on_cpu(state) \
        else batched_event_windows
    return run(job, spot, kernel, rmax, state, params, k_cost, plan, tel, ep,
               work, wk, rng)


def market_events(job, market, kernel, rmax, preempt_on, state, params, mp,
                  k_cost, plan, tel=None, ep=None, work=None, wk=None,
                  rng="slab"):
    """Run stacked market event windows; see ``market_event_windows``."""
    run = market_event_windows_ref if _on_cpu(state) \
        else market_event_windows
    return run(job, market, kernel, rmax, preempt_on, state, params, mp,
               k_cost, plan, tel, ep, work, wk, rng)


def region_events(topo, kernel, preempt_on, state, params, rp, k_cost, plan,
                  tel=None, ep=None, work=None, wk=None):
    """Run stacked region event windows; see ``region_event_windows``."""
    run = region_event_windows_ref if _on_cpu(state) \
        else region_event_windows
    return run(topo, kernel, preempt_on, state, params, rp, k_cost, plan,
               tel, ep, work, wk)
