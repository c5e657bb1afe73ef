"""Environment timelines: piecewise-constant non-stationary supply.

The port of the JAX package's ``core/env.py``.  A host-side descriptor
(:class:`EnvTimeline`) of piecewise-constant segments (per-pool or
per-region price multipliers, hazard multipliers and availability), a
Markov-modulated regime generator (:func:`markov_timeline`), a trace replay
(:func:`timeline_from_trace`) and chaos injectors (:func:`inject_storm`,
:func:`inject_blackout`, :func:`inject_price_spike`).  The host side is
plain numpy and builds the same timelines as the JAX package from the same
arguments (``markov_timeline`` draws the same ``np.random.default_rng``
numbers).

How the engine consumes a timeline: ``EnvTimeline.params(n_locs, device)``
lowers it to a small dict of tensors (``ep``), one table for every lane.
The per-lane cursor is :class:`EnvState`: a countdown ``next_boundary`` in
the engine's relative time and the current segment index.

**Boundary-as-event.**  Segment boundaries join the merged-renewal race as
the highest-priority clock: when ``next_boundary`` wins the ``dt`` race
the event is a pure crossing (no queue activity, clocks age by ``dt``),
the segment index advances and the survived exponential clocks are
rescaled by the old/new rate ratio (exact by memorylessness).  So ``dt``
never spans a boundary and storm and blackout time are exact.  A
single-segment timeline has ``next_boundary = 3e38``: the boundary never
wins and every multiplier is exactly 1.0, so it reproduces ``env=None``
bitwise.

Blackouts keep arithmetic finite: availability 0 maps to a
``BLACKOUT_SCALE``-inflated clock, not ``inf``, so recovery at the next
boundary is a well-defined rescale.  Storms are multiplicative on the base
hazard: a pool whose base hazard is 0 stays un-preemptible through one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

INF = np.float32(3e38)

#: availability 0 inflates (not infinitizes) the spot clock: finite, so the
#: next boundary's rescale is exact; 1e15 × any draw never wins a dt race
BLACKOUT_SCALE = np.float32(1e15)

SEG_NORMAL = 0
SEG_STORM = 1
SEG_BLACKOUT = 2
SEG_SPIKE = 3

_KINDS = (SEG_NORMAL, SEG_STORM, SEG_BLACKOUT, SEG_SPIKE)


def _norm_value(v, field, si):
    """Normalize one segment's value to a float scalar or per-loc tuple."""
    if isinstance(v, (list, tuple, np.ndarray)):
        vals = tuple(float(x) for x in np.asarray(v).reshape(-1))
        if not vals:
            raise ValueError(f"EnvTimeline.{field}[{si}] is empty")
        bad = [x for x in vals if not math.isfinite(x) or x < 0]
        if bad:
            raise ValueError(
                f"EnvTimeline.{field}[{si}] must be finite and >= 0, "
                f"got {bad}")
        return vals
    v = float(v)
    if not math.isfinite(v) or v < 0:
        raise ValueError(
            f"EnvTimeline.{field}[{si}] must be finite and >= 0, got {v}")
    return v


@dataclasses.dataclass(frozen=True)
class EnvTimeline:
    """Piecewise-constant environment: segment ``i`` covers
    ``[t_end[i-1], t_end[i])`` (``t_end[-1]`` open-ended at 3e38).

    ``price_mult`` / ``hazard_mult`` / ``avail`` hold one entry per
    segment, each a scalar (every pool or region) or a per-loc tuple;
    ``kind`` tags each segment ``SEG_NORMAL`` / ``SEG_STORM`` /
    ``SEG_BLACKOUT`` / ``SEG_SPIKE`` for the shock counters
    (:mod:`repro_torch.obs.shocks`).  Hashable; the engine consumes only
    :meth:`params`.
    """

    t_end: tuple
    price_mult: tuple = (1.0,)
    hazard_mult: tuple = (1.0,)
    avail: tuple = (1.0,)
    kind: tuple = (SEG_NORMAL,)

    def __post_init__(self):
        t_end = tuple(float(t) for t in self.t_end)
        if not t_end:
            raise ValueError("EnvTimeline needs at least one segment")
        if not (math.isinf(t_end[-1]) or t_end[-1] >= float(INF)):
            raise ValueError(
                "EnvTimeline's last segment must be open-ended: pass "
                f"t_end[-1]=float('inf'), got {t_end[-1]} (append a "
                "trailing segment holding the final regime)")
        t_end = t_end[:-1] + (float(INF),)
        for a, b in zip(t_end, t_end[1:]):
            if not a < b:
                raise ValueError(
                    f"EnvTimeline.t_end must be strictly increasing, "
                    f"got {a} before {b}")
        if t_end[0] <= 0:
            raise ValueError(
                f"EnvTimeline.t_end[0] must be > 0, got {t_end[0]}")
        s = len(t_end)
        fields = {}
        for name in ("price_mult", "hazard_mult", "avail"):
            vals = getattr(self, name)
            if not isinstance(vals, (list, tuple)):
                vals = (vals,) * s
            if len(vals) != s:
                raise ValueError(
                    f"EnvTimeline.{name} has {len(vals)} entries for "
                    f"{s} segments")
            fields[name] = tuple(
                _norm_value(v, name, i) for i, v in enumerate(vals))
        kind = self.kind
        if not isinstance(kind, (list, tuple)):
            kind = (kind,) * s
        if len(kind) != s:
            raise ValueError(
                f"EnvTimeline.kind has {len(kind)} entries for {s} segments")
        kind = tuple(int(k) for k in kind)
        bad = [k for k in kind if k not in _KINDS]
        if bad:
            raise ValueError(
                f"EnvTimeline.kind entries must be in {_KINDS} "
                f"(normal/storm/blackout/spike), got {bad}")
        object.__setattr__(self, "t_end", t_end)
        object.__setattr__(self, "kind", kind)
        for name, vals in fields.items():
            object.__setattr__(self, name, vals)

    # ---------------------------------------------------------------- host

    @property
    def n_segments(self) -> int:
        return len(self.t_end)

    @staticmethod
    def constant(price_mult=1.0, hazard_mult=1.0, avail=1.0) -> "EnvTimeline":
        """One open-ended segment (the stationary world)."""
        return EnvTimeline(t_end=(float("inf"),), price_mult=(price_mult,),
                           hazard_mult=(hazard_mult,), avail=(avail,))

    def span(self) -> float:
        """Time of the last finite boundary (0.0 for a single segment)."""
        return 0.0 if self.n_segments == 1 else self.t_end[-2]

    def count(self, kind: int) -> int:
        return sum(1 for k in self.kind if k == kind)

    def count_storms(self) -> int:
        return self.count(SEG_STORM)

    def count_blackouts(self) -> int:
        return self.count(SEG_BLACKOUT)

    def count_spikes(self) -> int:
        return self.count(SEG_SPIKE)

    def segments(self):
        """Host iterator of (t_start, t_end, price, hazard, avail, kind)."""
        t0 = 0.0
        for i, t1 in enumerate(self.t_end):
            yield (t0, t1, self.price_mult[i], self.hazard_mult[i],
                   self.avail[i], self.kind[i])
            t0 = t1

    # -------------------------------------------------------------- device

    def params(self, n_locs: int, device="cpu") -> dict:
        """Lower to the ``ep`` dict the event loops read, tensors on
        ``device`` (one table for every lane): ``t_end (S,) f32``, ``kind
        (S,) i32`` and ``(S, n_locs) f32`` grids for price / hazard / avail
        (scalars broadcast across locs)."""
        def grid(vals, name):
            rows = []
            for si, v in enumerate(vals):
                if isinstance(v, tuple):
                    if len(v) != n_locs:
                        raise ValueError(
                            f"EnvTimeline.{name}[{si}] has {len(v)} "
                            f"per-loc entries but the scenario has "
                            f"{n_locs} pools/regions")
                    rows.append(np.asarray(v, np.float32))
                else:
                    rows.append(np.full((n_locs,), v, np.float32))
            return np.stack(rows)

        arrays = {
            "t_end": np.asarray(self.t_end, np.float32),
            "price": grid(self.price_mult, "price_mult"),
            "hazard": grid(self.hazard_mult, "hazard_mult"),
            "avail": grid(self.avail, "avail"),
            "kind": np.asarray(self.kind, np.int32),
        }
        return {name: torch.from_numpy(a).to(device)
                for name, a in arrays.items()}


class EnvState(NamedTuple):
    """Per-lane timeline cursor: countdown to the next boundary (relative
    time, as the engine's clocks) and the current segment index; leaves
    lead with the lane axis."""

    next_boundary: torch.Tensor  # f32, counts down with every dt
    seg: torch.Tensor  # i32 segment index


def init_env_state(ep: dict, lanes: int) -> EnvState:
    """Every lane at segment 0, ``t_end[0]`` before its first boundary."""
    t0 = ep["t_end"][0]
    return EnvState(next_boundary=t0.expand(lanes).clone(),
                    seg=torch.zeros(lanes, dtype=torch.int32,
                                    device=t0.device))


def env_row(arr: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Each lane's segment row: ``arr[seg]`` for a per-lane ``seg``
    (``(lanes,)`` of an ``(S,)`` table, ``(lanes, n_locs)`` of an ``(S,
    n_locs)`` one).  The JAX package sums a one-hot mask because Pallas
    has no gather; the entries are >= 0, so indexing selects the same
    value bitwise."""
    return arr[seg.long()]


def inv_avail(avail_row: torch.Tensor) -> torch.Tensor:
    """1/avail with a blackout (avail == 0) mapped to ``BLACKOUT_SCALE``:
    avail 1 is exactly ×1.0, avail 0 a finite clock too large to win a
    race, so the boundary rescale back is exact."""
    safe = torch.where(avail_row > 0, avail_row, 1.0)
    return torch.where(avail_row > 0, 1.0 / safe, BLACKOUT_SCALE)


def clock_rescale(old_rate_mult: torch.Tensor,
                  new_rate_mult: torch.Tensor) -> torch.Tensor:
    """Exponential-clock ratio of a crossing: a survived Exp(r_old)
    residual under r_new is t·(r_old/r_new); a zero rate on either side
    leaves the clock as it is."""
    both = (old_rate_mult > 0) & (new_rate_mult > 0)
    safe_new = torch.where(both, new_rate_mult, 1.0)
    return torch.where(both, old_rate_mult / safe_new, 1.0)


# --------------------------------------------------------------------------
# generators + chaos injectors (host-side; compose before .params())
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Regime:
    """One state of the Markov modulator."""

    price_mult: float = 1.0
    hazard_mult: float = 1.0
    avail: float = 1.0
    kind: int = SEG_NORMAL
    mean_hold: float = 1.0


def markov_timeline(regimes, *, horizon, seed=0, transition=None,
                    start=0) -> EnvTimeline:
    """Markov-modulated regime switching: exponential holding times per
    regime, jump matrix ``transition`` (row-stochastic; default uniform
    over the *other* regimes), truncated at ``horizon`` with the regime
    then active held open-ended."""
    regs = tuple(regimes)
    if len(regs) < 2:
        raise ValueError("markov_timeline needs >= 2 regimes")
    r = len(regs)
    if transition is None:
        transition = (np.ones((r, r)) - np.eye(r)) / (r - 1)
    transition = np.asarray(transition, float)
    if transition.shape != (r, r) or not np.allclose(
            transition.sum(axis=1), 1.0):
        raise ValueError(
            f"transition must be a row-stochastic ({r}, {r}) matrix")
    if horizon <= 0:
        raise ValueError(f"horizon must be > 0, got {horizon}")
    rng = np.random.default_rng(seed)
    t, cur = 0.0, int(start)
    t_end, pm, hm, av, kd = [], [], [], [], []
    while t < horizon:
        g = regs[cur]
        t = t + rng.exponential(g.mean_hold)
        t_end.append(min(t, float(horizon)) if t < horizon else float("inf"))
        pm.append(g.price_mult)
        hm.append(g.hazard_mult)
        av.append(g.avail)
        kd.append(g.kind)
        cur = int(rng.choice(r, p=transition[cur]))
    if not math.isinf(t_end[-1]):     # pragma: no cover - defensive
        t_end[-1] = float("inf")
    return EnvTimeline(t_end=tuple(t_end), price_mult=tuple(pm),
                       hazard_mult=tuple(hm), avail=tuple(av),
                       kind=tuple(kd))


def _edit_loc(value, loc, n_locs, fn):
    """Apply ``fn`` at one loc (expanding scalars) or everywhere."""
    if loc is None:
        if isinstance(value, tuple):
            return tuple(fn(v) for v in value)
        return fn(value)
    if not isinstance(value, tuple):
        if n_locs is None:
            raise ValueError(
                "loc-targeted injection on a scalar-valued timeline "
                "needs n_locs= to expand it to per-loc values")
        value = (value,) * n_locs
    if not 0 <= loc < len(value):
        raise ValueError(f"loc {loc} out of range for {len(value)} locs")
    return tuple(fn(v) if i == loc else v for i, v in enumerate(value))


def _splice(tl: EnvTimeline, t0: float, t1: float, kind: int,
            edit) -> EnvTimeline:
    """Cut ``[t0, t1)`` into the timeline and apply ``edit`` inside it."""
    if not (0 <= t0 < t1):
        raise ValueError(f"need 0 <= t0 < t1, got t0={t0}, t1={t1}")
    if not math.isfinite(t1):
        raise ValueError("injection windows must be finite (t1 < inf)")
    t_end, pm, hm, av, kd = [], [], [], [], []

    def emit(end, p, h, a, k):
        t_end.append(end)
        pm.append(p)
        hm.append(h)
        av.append(a)
        kd.append(k)

    for s0, s1, p, h, a, k in tl.segments():
        cuts = sorted({s1, *(c for c in (t0, t1) if s0 < c < s1)})
        lo = s0
        for hi in cuts:
            if t0 <= lo and hi <= t1:
                emit(hi, *edit(p, h, a), kind)
            else:
                emit(hi, p, h, a, k)
            lo = hi
    return EnvTimeline(t_end=tuple(t_end), price_mult=tuple(pm),
                       hazard_mult=tuple(hm), avail=tuple(av),
                       kind=tuple(kd))


def timeline_from_trace(times, avail, *, price=None, hazard=None
                        ) -> EnvTimeline:
    """Replay a recorded availability trace as an :class:`EnvTimeline`.

    ``times`` are segment END times (strictly increasing; the final
    segment is held open-ended past ``times[-1]``); ``avail`` holds one
    availability row per segment, a scalar or a per-pool/region tuple, 0
    marking a blackout as :func:`inject_blackout` would.  Optional
    ``price`` / ``hazard`` rows ride along as multipliers.  Segments whose
    availability is zero in every location are tagged ``SEG_BLACKOUT``, all
    others ``SEG_NORMAL``.
    """
    times = [float(t) for t in times]
    avail = list(avail)
    if len(times) != len(avail):
        raise ValueError(
            f"timeline_from_trace: {len(times)} times for "
            f"{len(avail)} avail rows")
    if not times:
        raise ValueError("timeline_from_trace needs at least one segment")

    def _row(v):
        return tuple(float(x) for x in v) if isinstance(
            v, (list, tuple, np.ndarray)) else float(v)

    def _opt(rows, name):
        if rows is None:
            return (1.0,) * (len(times) + 1)
        rows = list(rows)
        if len(rows) != len(times):
            raise ValueError(
                f"timeline_from_trace: {len(rows)} {name} rows for "
                f"{len(times)} segments")
        return tuple(_row(v) for v in rows) + (_row(rows[-1]),)

    av = tuple(_row(v) for v in avail)
    kind = tuple(
        SEG_BLACKOUT if (all(x == 0.0 for x in v) if isinstance(v, tuple)
                         else v == 0.0) else SEG_NORMAL
        for v in av)
    # hold the last recorded regime open-ended
    return EnvTimeline(
        t_end=tuple(times) + (float("inf"),),
        price_mult=_opt(price, "price"),
        hazard_mult=_opt(hazard, "hazard"),
        avail=av + (av[-1],),
        kind=kind + (kind[-1],),
    )


def inject_storm(tl: EnvTimeline, t0: float, t1: float, *,
                 hazard_mult: float = 10.0, loc=None,
                 n_locs=None) -> EnvTimeline:
    """Preemption storm: multiply the hazard by ``hazard_mult`` over
    ``[t0, t1)`` (at one loc, or everywhere) and tag it SEG_STORM.
    Multiplicative: a pool with base hazard 0 stays un-preemptible."""
    if hazard_mult <= 0:
        raise ValueError(f"hazard_mult must be > 0, got {hazard_mult}")
    return _splice(
        tl, t0, t1, SEG_STORM,
        lambda p, h, a: (p, _edit_loc(h, loc, n_locs,
                                      lambda v: v * hazard_mult), a))


def inject_blackout(tl: EnvTimeline, t0: float, t1: float, *, loc=None,
                    n_locs=None) -> EnvTimeline:
    """Capacity blackout: availability 0 over ``[t0, t1)`` (at one loc,
    or everywhere), tagged SEG_BLACKOUT."""
    return _splice(
        tl, t0, t1, SEG_BLACKOUT,
        lambda p, h, a: (p, h, _edit_loc(a, loc, n_locs, lambda v: 0.0)))


def inject_price_spike(tl: EnvTimeline, t0: float, t1: float, *,
                       price_mult: float = 3.0, loc=None,
                       n_locs=None) -> EnvTimeline:
    """Price spike: multiply spot price by ``price_mult`` over
    ``[t0, t1)``, tagged SEG_SPIKE."""
    if price_mult <= 0:
        raise ValueError(f"price_mult must be > 0, got {price_mult}")
    return _splice(
        tl, t0, t1, SEG_SPIKE,
        lambda p, h, a: (_edit_loc(p, loc, n_locs,
                                   lambda v: v * price_mult), h, a))
