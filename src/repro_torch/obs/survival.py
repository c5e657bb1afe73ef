"""Survival ledger: job-level work and deadline accounting for the work axis.

The port of the JAX package's ``obs/survival.py``.  The engine's base
statistics count *legs* (every serve, defection and resume closes one).
With a work model on a run (``work=``,
:class:`repro_torch.core.work.WorkModel`), the job-level truth lives here:
a job is *finished* when its last unit of work is served or it migrates to
on-demand, and a finished job either met its deadline or *missed* it.
The ledger also prices recovery: work lost to rollbacks, work recomputed
(lost progress + restart overhead), checkpoints taken, and panic entries
(the safety-net defections of
:class:`~repro_torch.core.work.CantBeLateKernel`).

Counter identities:

- ``jobs_ontime + deadline_misses == jobs_finished``;
- ``jobs_admitted - jobs_finished == jobs_in_flight >= 0`` from a cold
  start;
- ``work_lost == work_recomputed`` under zero restart overhead.

The block rides outermost of the engine's stats, ``(((base, telemetry?),
env?), SurvivalWindowStats)``, in the same float32 windows; leaves lead
with the lane axis.  :func:`summarize_survival` reduces the window axis in
float64 on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: summary keys reported as integers (absent from a work=None summary)
SURVIVAL_INT_STATS = (
    "jobs_admitted",
    "jobs_finished",
    "deadline_misses",
    "jobs_ontime",
    "checkpoints_taken",
    "panic_entries",
    "jobs_in_flight",
)


class SurvivalWindowStats(NamedTuple):
    """One window of job-level survival counters (int32) and work sums
    (float32)."""

    admitted: torch.Tensor  # job arrivals (admitted or sent on-demand)
    finished: torch.Tensor  # jobs that reached their last unit
    misses: torch.Tensor  # finished jobs past their deadline
    ontime: torch.Tensor  # finished jobs within their deadline
    checkpoints: torch.Tensor  # checkpoints taken (periodic + notice)
    panics: torch.Tensor  # safety-net defections
    work_done: torch.Tensor  # units of real progress served
    work_lost: torch.Tensor  # progress rolled back on a resume
    work_recomputed: torch.Tensor  # lost progress + restart overhead
    overhead_paid: torch.Tensor  # restart-overhead units charged


def survival_zeros(lanes: int, device) -> SurvivalWindowStats:
    """Zero accumulators of one window for ``lanes`` lanes."""
    zi = torch.zeros(lanes, dtype=torch.int32, device=device)
    zf = torch.zeros(lanes, dtype=torch.float32, device=device)
    return SurvivalWindowStats(zi, zi, zi, zi, zi, zi, zf, zf, zf, zf)


def survival_update(ws: SurvivalWindowStats, *, admitted, finished, missed,
                    checkpoint, panic, work_done, work_lost,
                    work_recomputed, overhead_paid) -> SurvivalWindowStats:
    """Fold one merged event into the ledger.  ``missed`` counts only for a
    finished job; the on-time twin is derived here, so the classification
    identity holds by construction."""
    fin = torch.as_tensor(finished).to(torch.bool)
    miss = fin & torch.as_tensor(missed).to(torch.bool)

    def i32(b):
        return torch.as_tensor(b).to(torch.int32)

    return SurvivalWindowStats(
        admitted=ws.admitted + i32(admitted),
        finished=ws.finished + i32(fin),
        misses=ws.misses + i32(miss),
        ontime=ws.ontime + i32(fin & (~miss)),
        checkpoints=ws.checkpoints + i32(checkpoint),
        panics=ws.panics + i32(panic),
        work_done=ws.work_done + work_done,
        work_lost=ws.work_lost + work_lost,
        work_recomputed=ws.work_recomputed + work_recomputed,
        overhead_paid=ws.overhead_paid + overhead_paid,
    )


def survival_merge(a: SurvivalWindowStats,
                   b: SurvivalWindowStats) -> SurvivalWindowStats:
    """Merge two ledgers across a lane, shard or window partition (exact
    for the counters).  Works on tensors and numpy arrays."""
    return SurvivalWindowStats(*(x + y for x, y in zip(a, b)))


def survival_reduce(ws: SurvivalWindowStats,
                    axis: int = 0) -> SurvivalWindowStats:
    """Sum the ledger along one axis (lanes, shards, seeds or windows)."""
    return SurvivalWindowStats(*(x.sum(axis) for x in ws))


def stack_survival_windows(windows: list) -> SurvivalWindowStats:
    """Per-window blocks stacked on a window axis after the lane axis."""
    return SurvivalWindowStats(*(torch.stack(leaves, dim=1)
                                 for leaves in zip(*windows)))


def summarize_survival(wstats: SurvivalWindowStats) -> dict:
    """Float64 window reduction (window axis last; leading lane or grid
    axes pass through) and the derived job-level statistics.  Counter keys
    come back as exact integers."""
    def red(name):
        x = getattr(wstats, name)
        x = x.cpu() if isinstance(x, torch.Tensor) else x
        return np.asarray(x, np.float64).sum(axis=-1)

    def as_int(x):
        arr = x.astype(np.int64)
        return int(arr) if arr.ndim == 0 else arr

    admitted = red("admitted")
    finished = red("finished")
    misses = red("misses")
    return {
        "jobs_admitted": as_int(admitted),
        "jobs_finished": as_int(finished),
        "deadline_misses": as_int(misses),
        "jobs_ontime": as_int(red("ontime")),
        "checkpoints_taken": as_int(red("checkpoints")),
        "panic_entries": as_int(red("panics")),
        "jobs_in_flight": as_int(admitted - finished),
        "deadline_miss_rate": misses / np.maximum(finished, 1.0),
        "work_done": red("work_done"),
        "work_lost": red("work_lost"),
        "work_recomputed": red("work_recomputed"),
        "restart_overhead_paid": red("overhead_paid"),
    }
