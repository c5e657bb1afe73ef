"""The seed-compatible simulator entry points, thin wrappers over the engine.

  * :func:`run_queue_sim` — the Theorem-4 three-phase policy at fixed ``r``
    (:class:`~repro_torch.core.policies.ThreePhaseKernel`); admitted jobs
    wait indefinitely.
  * :func:`run_single_slot_sim` — the queue-length-≤-1 system of Theorems
    2/3 (:class:`~repro_torch.core.policies.SingleSlotKernel`), where the
    waiting job defects to on-demand when its sampled maximal wait X
    expires.

Both run the split stream (``rng="split"``), the per-event key ladder the
JAX package's seed simulators are pinned to, so a seed gives the JAX
package's statistics.  ``device`` as in :func:`repro_torch.core.engine.run_sim`:
``None`` means the GPU.  For parameter grids use
:func:`repro_torch.core.engine.run_sweep`, which runs the whole
(grid × seeds) fleet in one launch.
"""
from __future__ import annotations

import torch

from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.engine import DEFAULT_CHUNK_EVENTS, run_sim
from repro_torch.core.policies import SingleSlotKernel, ThreePhaseKernel
from repro_torch.core.waittime import WaitTime


def run_queue_sim(job: ArrivalProcess, spot: ArrivalProcess, *,
                  k: float = 10.0, r: float, n_events: int,
                  key: torch.Tensor, rmax: int = 64, burn_in: int = 0,
                  chunk_events: int | None = DEFAULT_CHUNK_EVENTS,
                  device=None) -> dict:
    """Simulate the Theorem-4 policy at fixed ``r``; return long-run stats."""
    return run_sim(job, spot, ThreePhaseKernel(), {"r": r}, k=k,
                   n_events=n_events, key=key, rmax=rmax, burn_in=burn_in,
                   chunk_events=chunk_events, rng="split", device=device)


def run_single_slot_sim(job: ArrivalProcess, spot: ArrivalProcess,
                        wait: WaitTime, *, k: float = 10.0, n_events: int,
                        key: torch.Tensor,
                        chunk_events: int | None = DEFAULT_CHUNK_EVENTS,
                        device=None) -> dict:
    """Simulate the single-slot (queue ≤ 1) policy with maximal wait X."""
    return run_sim(job, spot, SingleSlotKernel(wait=wait), {}, k=k,
                   n_events=n_events, key=key, rmax=1,
                   chunk_events=chunk_events, rng="split", device=device)
