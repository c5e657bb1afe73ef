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


def _on_cpu(state, ep) -> bool:
    """Does the fleet (its state, or the env pair's engine state) lie on
    the CPU?"""
    base = state if ep is None else state[0]
    return base.key.device.type == "cpu"


def batched_events(job, spot, kernel, rmax, state, params, k_cost, plan,
                   tel=None, ep=None):
    """Run stacked event windows; see ``batched_event_windows``."""
    if _on_cpu(state, ep):
        return batched_event_windows_ref(job, spot, kernel, rmax, state,
                                         params, k_cost, plan, tel, ep)
    return batched_event_windows(job, spot, kernel, rmax, state, params,
                                 k_cost, plan, tel, ep)


def market_events(job, market, kernel, rmax, preempt_on, state, params, mp,
                  k_cost, plan, tel=None, ep=None):
    """Run stacked market event windows; see ``market_event_windows``."""
    if _on_cpu(state, ep):
        return market_event_windows_ref(job, market, kernel, rmax,
                                        preempt_on, state, params, mp,
                                        k_cost, plan, tel, ep)
    return market_event_windows(job, market, kernel, rmax, preempt_on, state,
                                params, mp, k_cost, plan, tel, ep)


def region_events(topo, kernel, preempt_on, state, params, rp, k_cost, plan,
                  tel=None, ep=None):
    """Run stacked region event windows; see ``region_event_windows``."""
    if _on_cpu(state, ep):
        return region_event_windows_ref(topo, kernel, preempt_on, state,
                                        params, rp, k_cost, plan, tel, ep)
    return region_event_windows(topo, kernel, preempt_on, state, params, rp,
                                k_cost, plan, tel, ep)
