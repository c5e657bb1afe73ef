"""Batched-event sweep kernel for the engine's (grid × slot) hot loop.

House layout: ``csrc/sweep.cu`` is the hand-written CUDA kernel and
``sweep.py`` its ctypes wrapper, ``ref.py`` the plain PyTorch version the
kernel must match, ``ops.py`` the device dispatch.  Consumed by
:mod:`repro_torch.core.engine`: ``run_sweep`` (the single queue),
``run_market_sweep`` (the P-pool market) and ``run_region_sweep``
(N-region routing) on a CUDA device.
"""
from repro_torch.kernels.sweep.ops import (batched_events, market_events,
                                           region_events)
from repro_torch.kernels.sweep.ref import (batched_event_windows_ref,
                                           market_event_windows_ref,
                                           region_event_windows_ref)
from repro_torch.kernels.sweep.sweep import (batched_event_windows,
                                             market_event_windows,
                                             region_event_windows)

__all__ = ["batched_events", "batched_event_windows",
           "batched_event_windows_ref", "market_event_windows",
           "market_event_windows_ref", "market_events",
           "region_event_windows", "region_event_windows_ref",
           "region_events"]
