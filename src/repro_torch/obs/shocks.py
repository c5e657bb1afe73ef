"""Shock accounting for the environment-timeline axis.

The port of the JAX package's ``obs/shocks.py``.  With an
:class:`repro_torch.core.env.EnvTimeline` on a run (``env=``), every event
loop also folds one :class:`EnvWindowStats` a window: boundary crossings,
shock segments entered (storms / blackouts / spikes), time spent inside
storms and blackouts, and the degradation ledger: arrivals during a shock
segment, how many of those went to on-demand at once, spot serves and
preemption resumes inside a shock.  The block rides outermost of the
engine's stats, ``((base, telemetry?), env)``, in the same float32
windows, and is absent when ``env=None``.  Leaves lead with the lane axis
(``(lanes,)`` a window), as the engine's :class:`WindowStats`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: summary keys reported as integers (counter identities are exact)
ENV_INT_STATS = ("env_boundaries", "storms_observed", "blackouts_observed",
                 "spikes_observed", "shock_arrivals", "degraded_admits",
                 "shock_served", "shock_resumed")


class EnvWindowStats(NamedTuple):
    """Per-window shock counters (int32) and shock dwell times (float32)."""

    boundaries: torch.Tensor  # segment boundary crossings
    storms_entered: torch.Tensor  # boundaries that entered a SEG_STORM
    blackouts_entered: torch.Tensor
    spikes_entered: torch.Tensor
    shock_arrivals: torch.Tensor  # job arrivals inside any shock segment
    degraded_admits: torch.Tensor  # of those, sent to on-demand at once
    shock_served: torch.Tensor  # spot serves inside a shock segment
    shock_resumed: torch.Tensor  # preemption resumes inside a shock
    storm_time: torch.Tensor  # time spent inside SEG_STORM segments
    blackout_time: torch.Tensor  # time spent inside SEG_BLACKOUT


def env_zeros(lanes: int, device) -> EnvWindowStats:
    """Zero accumulators of one window for ``lanes`` lanes."""
    z = torch.zeros(lanes, dtype=torch.int32, device=device)
    f = torch.zeros(lanes, dtype=torch.float32, device=device)
    return EnvWindowStats(z, z, z, z, z, z, z, z, f, f)


def env_update(es: EnvWindowStats, *, is_boundary, kind_prev, kind_next,
               dt, is_job, od_now, served, resumed) -> EnvWindowStats:
    """Fold one merged event.  ``kind_prev`` is the segment the event's
    ``dt`` elapsed in, ``kind_next`` the one in effect afterwards (they
    differ only on boundary events).  The boundary joins the clock race, so
    ``dt`` never spans segments and the dwell times are exact."""
    # deferred: repro_torch.core.env starts the repro_torch.core package,
    # whose engine imports this module
    from repro_torch.core.env import (SEG_BLACKOUT, SEG_NORMAL, SEG_SPIKE,
                                      SEG_STORM)

    def i32(b):
        return b.to(torch.int32)

    shock = kind_prev != SEG_NORMAL

    def entered(k):
        return i32(is_boundary & (kind_next == k))

    return EnvWindowStats(
        boundaries=es.boundaries + i32(is_boundary),
        storms_entered=es.storms_entered + entered(SEG_STORM),
        blackouts_entered=es.blackouts_entered + entered(SEG_BLACKOUT),
        spikes_entered=es.spikes_entered + entered(SEG_SPIKE),
        shock_arrivals=es.shock_arrivals + i32(is_job & shock),
        degraded_admits=es.degraded_admits + i32(od_now & shock),
        shock_served=es.shock_served + i32(served & shock),
        shock_resumed=es.shock_resumed + i32(resumed & shock),
        storm_time=es.storm_time + torch.where(kind_prev == SEG_STORM, dt,
                                               0.0),
        blackout_time=es.blackout_time
        + torch.where(kind_prev == SEG_BLACKOUT, dt, 0.0),
    )


def env_merge(a: EnvWindowStats, b: EnvWindowStats) -> EnvWindowStats:
    """Merge two blocks across a lane or shard partition.  The counters
    are int32, so the merge is exact; the two dwell times are float sums
    (merge those in float64, as :func:`summarize_env` does, where exact
    partition invariance matters).  Works on tensors and numpy arrays."""
    return EnvWindowStats(*(x + y for x, y in zip(a, b)))


def env_reduce(es: EnvWindowStats, axis: int = 0) -> EnvWindowStats:
    """Collapse one batch axis (lanes, shards, seeds or windows) by
    summation: :func:`env_merge` n ways."""
    return EnvWindowStats(*(x.sum(axis) for x in es))


def stack_env_windows(windows: list) -> EnvWindowStats:
    """Per-window blocks stacked on a window axis after the lane axis."""
    return EnvWindowStats(*(torch.stack(leaves, dim=1)
                            for leaves in zip(*windows)))


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def summarize_env(estats: EnvWindowStats) -> dict:
    """Reduce stacked env windows (window axis last, as
    :func:`repro_torch.core.engine.summarize`); leading lane or grid axes
    pass through.  Counter keys come back as exact integers."""
    def red(name):
        return _host(getattr(estats, name)).sum(axis=-1)

    def as_int(x):
        arr = x.astype(np.int64)
        return int(arr) if arr.ndim == 0 else arr

    return {
        "env_boundaries": as_int(red("boundaries")),
        "storms_observed": as_int(red("storms_entered")),
        "blackouts_observed": as_int(red("blackouts_entered")),
        "spikes_observed": as_int(red("spikes_entered")),
        "shock_arrivals": as_int(red("shock_arrivals")),
        "degraded_admits": as_int(red("degraded_admits")),
        "shock_served": as_int(red("shock_served")),
        "shock_resumed": as_int(red("shock_resumed")),
        "storm_time": red("storm_time"),
        "blackout_time": red("blackout_time"),
    }
