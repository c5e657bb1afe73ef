"""Streaming telemetry of the event loops: quantile sketches and counters.

The port of the JAX package's ``repro.obs.stats`` (the accumulator layer of
the ``telemetry=`` engine axis).  The base window stats say what a policy
costs on average; the paper's delay constraint, and any service level a
real service quotes, needs the tail: P50/P90/P99 wait, per-pool and
per-region defect and resume counts.

A :class:`Telemetry` descriptor turns the axis on.  Each event loop then
folds every merged event into a :class:`TelemetryWindowStats` block that
rides beside its base window stats as a ``(base, telemetry)`` pair,
re-zeroed every window and stacked on the host, exactly as the base sums
are.  ``telemetry=None`` never builds any of this: the base stats are
untouched, the CUDA kernels launch the instantiation without the fold.

Quantile sketch.  Waits and costs go into log-spaced histograms: bin ``i``
covers ``[lo·γ^(i-1), lo·γ^i)`` with ``γ = (hi/lo)^(1/(n_bins-2))``, bin 0
is the underflow ``[0, lo)`` and the last bin the overflow.  A quantile
read off the cumulative counts lies in the bin of the exact one, so within
a factor ``γ`` of it (``γ − 1`` = 25% at the default 64 bins over six
decades of waits, ``Telemetry.rel_error``; the JAX package's docstring
says 9%), and merging windows, lanes or shards is integer addition.

Counters.  ``events`` counts merged events by type (job, spot, preempt,
deadline); ``preempts_fired`` the hazard clock's firings (the base
``preemptions`` counts only hits on occupied pools); ``rejects`` splits
admission rejections out of ``ondemand``, ``deadline_defects`` the
budget expiries; ``notices_honored`` revoked legs that resumed;
``loc_defects``/``loc_resumed`` the last two per pool or region.

Event trace.  With ``trace_cap > 0`` a bounded ring a lane and a window
records each merged event as ``(t, type, loc, qlen, val)``: the time
within the window after the event, the type code, the pool or region,
the queue length after the event, and the wait sample (−1 where the event
observed none).  Records wrap at ``trace_cap``; ``n`` keeps the true
count, so the exporter (:mod:`repro_torch.obs.trace`) reports the drops.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

#: Merged-event type codes (the ``events`` counter axis and the trace
#: ``type`` field), in the order of the engine's tie-break priority.
EVENT_TYPES = ("job", "spot", "preempt", "deadline")
EV_JOB, EV_SPOT, EV_PREEMPT, EV_DEADLINE = range(4)


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """The ``telemetry=`` axis of the engine entry points.

    ``n_bins`` log-spaced bins span ``[lo, hi)`` for each histogram (the
    first bin is the underflow, the last the overflow); the relative
    quantile error is ``γ − 1`` with ``γ = (hi/lo)^(1/(n_bins-2))``.
    ``trace_cap > 0`` also records the bounded event ring a lane and a
    window (module docstring); 0 records none.  The same fields and
    defaults as the JAX package's ``repro.obs.Telemetry``.
    """

    n_bins: int = 64
    wait_lo: float = 1e-2
    wait_hi: float = 1e4
    cost_lo: float = 1e-2
    cost_hi: float = 1e3
    trace_cap: int = 0

    def wait_edges(self) -> np.ndarray:
        return _edges(self.wait_lo, self.wait_hi, self.n_bins)

    def cost_edges(self) -> np.ndarray:
        return _edges(self.cost_lo, self.cost_hi, self.n_bins)

    def rel_error(self) -> float:
        """The sketch's worst-case relative quantile error (γ − 1)."""
        gamma = (self.wait_hi / self.wait_lo) ** (1.0 / (self.n_bins - 2))
        return gamma - 1.0


class TelemetryWindowStats(NamedTuple):
    """Per-window telemetry accumulators of every lane (int32 counts,
    float32 ring times and waits); the ring fields are ``None`` where the
    trace is off."""

    wait_hist: torch.Tensor  # (lanes, n_bins) wait samples, log-binned
    cost_hist: torch.Tensor  # (lanes, n_bins) cost increments, log-binned
    events: torch.Tensor  # (lanes, 4) merged events by type code
    spot_starts: torch.Tensor  # (lanes,) spot legs started (= served)
    preempts_fired: torch.Tensor  # (lanes,) hazard clock firings
    notices_honored: torch.Tensor  # (lanes,) revoked legs that resumed
    deadline_defects: torch.Tensor  # (lanes,) wait-budget expiries
    rejects: torch.Tensor  # (lanes,) admission rejections
    loc_defects: torch.Tensor  # (lanes, n_locs) deadline defects a loc
    loc_resumed: torch.Tensor  # (lanes, n_locs) resumed legs a loc
    ring_t: torch.Tensor | None  # (lanes, cap) f32 time within the window
    ring_type: torch.Tensor | None  # (lanes, cap) event-type code
    ring_loc: torch.Tensor | None  # (lanes, cap) pool or region
    ring_qlen: torch.Tensor | None  # (lanes, cap) queue length after
    ring_val: torch.Tensor | None  # (lanes, cap) f32 wait sample (-1 none)
    ring_n: torch.Tensor | None  # (lanes,) true record count (ring wraps)


_TRACE_FIELDS = ("ring_t", "ring_type", "ring_loc", "ring_qlen", "ring_val",
                 "ring_n")
_COUNTER_FIELDS = tuple(f for f in TelemetryWindowStats._fields
                        if f not in _TRACE_FIELDS)
#: Telemetry statistics with a trailing per-bin, per-type or per-location
#: axis in summaries (every other one is a scalar a lane).
TEL_VECTOR_STATS = frozenset({"wait_hist", "cost_hist", "events",
                              "loc_defects", "loc_resumed"})
#: Integer telemetry statistics that count event decisions: bitwise
#: between the port and the JAX package.  The histograms are left out: a
#: wait an ulp apart can fall on the other side of a bin edge.
TEL_INT_STATS = ("events", "spot_starts", "preempts_fired",
                 "notices_honored", "deadline_defects", "rejects",
                 "loc_defects", "loc_resumed")


def telemetry_zeros(tel: Telemetry, n_locs: int, lanes: int,
                    device) -> TelemetryWindowStats:
    """Zero accumulators of one window for ``lanes`` lanes.  The rings are
    zeros too (not a sentinel): unwritten slots are never exported."""
    def z(*shape, dtype=torch.int32):
        return torch.zeros((lanes,) + shape, dtype=dtype, device=device)

    if tel.trace_cap:
        cap = tel.trace_cap
        ring = (z(cap, dtype=torch.float32), z(cap), z(cap), z(cap),
                z(cap, dtype=torch.float32), z())
    else:
        ring = (None,) * len(_TRACE_FIELDS)
    return TelemetryWindowStats(z(tel.n_bins), z(tel.n_bins), z(4), z(), z(),
                                z(), z(), z(), z(n_locs), z(n_locs), *ring)


def _edges(lo: float, hi: float, n_bins: int) -> np.ndarray:
    """Host-side bin edges: [0, lo·γ⁰, …, lo·γ^(n_bins-2), inf]."""
    interior = lo * ((hi / lo) ** (np.arange(n_bins - 1)
                                   / (n_bins - 2))).astype(np.float64)
    return np.concatenate([[0.0], interior, [np.inf]])


def bin_constants(lo: float, hi: float, n_bins: int
                  ) -> tuple[np.float32, np.float32]:
    """(log lo, (n_bins - 2) / log(hi / lo)) rounded once to float32, as
    the JAX package's ``hist_bin`` takes them; the CUDA kernels receive
    these two values."""
    return (np.float32(np.log(lo)),
            np.float32((n_bins - 2) / np.log(hi / lo)))


def hist_bin(x: torch.Tensor, lo: float, hi: float,
             n_bins: int) -> torch.Tensor:
    """Log-spaced bin index of each ``x`` (bin 0 the underflow, bin
    ``n_bins - 1`` the overflow): ``floor((log(max(x, 1e-30)) - log lo) ·
    inv) + 1`` clamped, in float32 and in the JAX package's order."""
    log_lo, inv_log_gamma = bin_constants(lo, hi, n_bins)
    safe = torch.clamp_min(x, np.float32(1e-30))
    raw = (torch.log(safe) - log_lo) * inv_log_gamma
    idx = torch.floor(raw).to(torch.int32) + 1
    return torch.clamp(idx, 0, n_bins - 1)


def _hist_add(hist: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
              lo: float, hi: float, n_bins: int) -> torch.Tensor:
    """One-hot histogram increment of each lane's ``x`` where ``valid``."""
    b = hist_bin(x, lo, hi, n_bins)
    iota = torch.arange(n_bins, device=hist.device)
    return hist + ((iota == b[:, None]) & valid[:, None]).to(torch.int32)


def telemetry_update(tel: Telemetry, ts: TelemetryWindowStats, *,
                     t: torch.Tensor, is_job: torch.Tensor,
                     is_spot: torch.Tensor, is_pre: torch.Tensor,
                     is_deadline: torch.Tensor, served: torch.Tensor,
                     resume: torch.Tensor, defected: torch.Tensor,
                     od_now: torch.Tensor, wait_sample: torch.Tensor,
                     wait_valid: torch.Tensor, cost_inc: torch.Tensor,
                     cost_valid: torch.Tensor, loc: torch.Tensor,
                     n_locs: int, qlen: torch.Tensor
                     ) -> TelemetryWindowStats:
    """Fold one merged event of every lane into the accumulators.

    Every argument is a ``(lanes,)`` value the event body already computed
    (``loc`` the event's pool or region, ``t`` the time within the window
    after the event, ``qlen`` the total queue length after it), so the
    fold is a pure appendage: the base stats are untouched.
    """
    i32 = torch.int32
    device = t.device
    ev_type = torch.where(
        is_spot, EV_SPOT, torch.where(is_pre, EV_PREEMPT, torch.where(
            is_deadline, EV_DEADLINE, EV_JOB))).to(i32)
    loc = loc.to(i32)
    loc_hit = torch.arange(n_locs, device=device) == loc[:, None]
    out = ts._replace(
        wait_hist=_hist_add(ts.wait_hist, wait_sample, wait_valid,
                            tel.wait_lo, tel.wait_hi, tel.n_bins),
        cost_hist=_hist_add(ts.cost_hist, cost_inc, cost_valid,
                            tel.cost_lo, tel.cost_hi, tel.n_bins),
        events=ts.events + (torch.arange(4, device=device)
                            == ev_type[:, None]).to(i32),
        spot_starts=ts.spot_starts + served.to(i32),
        preempts_fired=ts.preempts_fired + is_pre.to(i32),
        notices_honored=ts.notices_honored + resume.to(i32),
        deadline_defects=ts.deadline_defects + defected.to(i32),
        rejects=ts.rejects + od_now.to(i32),
        loc_defects=ts.loc_defects + (defected[:, None] & loc_hit).to(i32),
        loc_resumed=ts.loc_resumed + (resume[:, None] & loc_hit).to(i32),
    )
    if not tel.trace_cap:
        return out
    cap = tel.trace_cap
    hit = torch.arange(cap, device=device) == (ts.ring_n % cap)[:, None]
    val = torch.where(wait_valid, wait_sample, np.float32(-1.0))
    return out._replace(
        ring_t=torch.where(hit, t[:, None], ts.ring_t),
        ring_type=torch.where(hit, ev_type[:, None], ts.ring_type),
        ring_loc=torch.where(hit, loc[:, None], ts.ring_loc),
        ring_qlen=torch.where(hit, qlen.to(i32)[:, None], ts.ring_qlen),
        ring_val=torch.where(hit, val[:, None], ts.ring_val),
        ring_n=ts.ring_n + 1,
    )


def stack_windows(windows: list) -> TelemetryWindowStats:
    """Per-window blocks stacked on a window axis after the lane axis
    (``None`` ring fields stay ``None``)."""
    return TelemetryWindowStats(*(
        None if leaves[0] is None else torch.stack(leaves, dim=1)
        for leaves in zip(*windows)))


def drop_windows(ts: TelemetryWindowStats, first: int
                 ) -> TelemetryWindowStats:
    """The windows from ``first`` on (the burn-in window dropped)."""
    return TelemetryWindowStats(*(None if x is None else x[:, first:]
                                  for x in ts))


def lane(ts: TelemetryWindowStats, i: int) -> TelemetryWindowStats:
    """Lane ``i``'s block (the lane axis dropped)."""
    return TelemetryWindowStats(*(None if x is None else x[i] for x in ts))


def _check_no_rings(name: str, *blocks: TelemetryWindowStats) -> None:
    for ts in blocks:
        if any(getattr(ts, f) is not None for f in _TRACE_FIELDS):
            raise ValueError(
                f"{name}: trace rings are per-lane drains, not additive — "
                f"export them first (repro_torch.obs.trace) and merge only "
                f"the histogram/counter block (ring fields must be None)")


def telemetry_merge(a: TelemetryWindowStats,
                    b: TelemetryWindowStats) -> TelemetryWindowStats:
    """Merge two accumulator blocks by integer addition: exact,
    associative and commutative over lanes, shards or windows.  Works on
    tensors and numpy arrays alike; blocks that carry rings are refused."""
    _check_no_rings("telemetry_merge", a, b)
    return TelemetryWindowStats(
        *(getattr(a, f) + getattr(b, f) for f in _COUNTER_FIELDS),
        *(None,) * len(_TRACE_FIELDS))


def telemetry_reduce(ts: TelemetryWindowStats,
                     axis: int = 0) -> TelemetryWindowStats:
    """Collapse one batch axis (lanes, shards, seeds or windows) by integer
    addition: :func:`telemetry_merge` n ways, e.g. a fleet-wide sketch
    before a :func:`sketch_quantile` read."""
    _check_no_rings("telemetry_reduce", ts)
    return TelemetryWindowStats(
        *(getattr(ts, f).sum(axis) for f in _COUNTER_FIELDS),
        *(None,) * len(_TRACE_FIELDS))


def sketch_quantile(hist: np.ndarray, edges: np.ndarray,
                    q: float) -> np.ndarray:
    """Quantile estimate from ``(..., n_bins)`` log-binned counts: the bin
    that holds rank ``q · total``, interpolated linearly inside it; so
    within one bin of the exact quantile (relative error ≤ γ − 1).  Empty
    histograms give 0.0."""
    h = np.asarray(hist, np.float64)
    total = h.sum(axis=-1, keepdims=True)
    cum = np.cumsum(h, axis=-1)
    target = np.maximum(q * total, 1.0)
    idx = np.minimum((cum < target).sum(axis=-1), h.shape[-1] - 1)
    lo = edges[idx]
    hi = np.where(np.isfinite(edges[idx + 1]), edges[idx + 1], edges[idx])
    lo = np.where(idx == 0, 0.0, lo)
    in_bin = np.take_along_axis(h, idx[..., None], -1)[..., 0]
    below = np.take_along_axis(cum, idx[..., None], -1)[..., 0] - in_bin
    frac = np.where(in_bin > 0,
                    (target[..., 0] - below) / np.maximum(in_bin, 1.0), 0.0)
    est = lo + np.clip(frac, 0.0, 1.0) * (hi - lo)
    return np.where(total[..., 0] > 0, est, 0.0)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def summarize_telemetry(tel: Telemetry, ts: TelemetryWindowStats) -> dict:
    """Reduce stacked windows on the host and read the quantiles.

    The window axis is the last for scalar counters and the one before it
    for vector fields; leading batch axes pass through.  The rings are not
    reduced: they come back under ``"trace"`` (per-window drains with
    their true counts) for :mod:`repro_torch.obs.trace`.
    """
    def red(name):
        axis = -2 if name in TEL_VECTOR_STATS else -1
        return _host(getattr(ts, name)).astype(np.float64).sum(axis=axis)

    wait_hist = red("wait_hist")
    cost_hist = red("cost_hist")
    we, ce = tel.wait_edges(), tel.cost_edges()
    out = {
        "p50_wait": sketch_quantile(wait_hist, we, 0.50),
        "p90_wait": sketch_quantile(wait_hist, we, 0.90),
        "p99_wait": sketch_quantile(wait_hist, we, 0.99),
        "p50_cost": sketch_quantile(cost_hist, ce, 0.50),
        "p99_cost": sketch_quantile(cost_hist, ce, 0.99),
        "wait_hist": wait_hist,
        "cost_hist": cost_hist,
        **{name: red(name) for name in TEL_INT_STATS},
    }
    if tel.trace_cap:
        out["trace"] = {name[len("ring_"):]: _host(getattr(ts, name))
                        for name in _TRACE_FIELDS}
    return out
