"""The engine's two random streams: the split ladder and the slab.

``rng="split"`` (the JAX package's default): every event splits the lane
key into a 4/5/6-way ladder (:func:`split_event_keys`); the next key is
subkey 0 and each draw samples from its own subkey
(:meth:`ArrivalProcess.sample`, the kernels' keyed ``admit``).  The lane key
advances once per event.

``rng="slab"``: one counter-based :func:`~repro_torch.core.threefry.bits32`
call generates a ``(window_events, n_cols)`` slab of 32-bit words per
float32 window (:func:`window_slab`); the event body reads its draws by
static column
index (:class:`SlabLayout`) and turns bits into uniforms and exponentials
with plain arithmetic (:func:`u01`, :func:`exp_from_u`).  The lane key
advances once per window, not per event.  Words are int64 tensors holding
32-bit values (see :mod:`repro_torch.core.threefry`).

The market loop's clock helpers live here too: its initial clocks are drawn
from tag-folded keys (:func:`tagged_keys`, :func:`sample_clock_vector`,
:func:`sample_hazard_clocks`), and on the slab stream its per-pool
preemption clocks are one superposed clock (:func:`hazard_clock`) with a
thinned pick of the firing pool (:func:`thinning_pick`).  Sums over pools
run left to right, the order XLA's CPU backend gives ``jnp.sum`` and
``jnp.cumsum`` at these widths, on every device.

The port runs the split stream on the single queue and the market (whose
preemption clocks are then a vector of one a pool, the earliest firing);
the regions' 6-way ladder is not ported yet (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import threefry

#: uint32 slab columns reserved when a kernel hook is *not* slab-aware: two
#: raw key words stand in for a legacy PRNG key.
KEY_SYNTH_COLS = 2
#: the engine's "never" (waittime.INF), for clocks that cannot fire
_INF = 3e38


def u01(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> float32 uniforms on [0, 1) (24-bit resolution)."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def exp_from_u(u: torch.Tensor) -> torch.Tensor:
    """Unit-rate exponential via inverse CDF (the sampler's ``-log1p(-U)``)."""
    return -torch.log1p(-u)


def gumbel_from_u(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel via inverse CDF, guarded at u = 0."""
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-12)))


def split_event_keys(key: torch.Tensor, preempt_on: bool = False,
                     has_route: bool = False):
    """The per-event split ladder of ``(..., 2)`` lane keys: ``(key, k_job,
    k_spot, k_pol, k_pre, k_rt)``, the subkeys of one ``split`` into 4, 5
    or 6 in that order; ``k_pre`` and ``k_rt`` are None unless their flag
    is set.  ``key`` is the next lane key."""
    n = 4 + int(preempt_on) + int(has_route)
    ks = threefry.split(key, n)
    k_pre = ks[..., 4, :] if preempt_on else None
    k_rt = ks[..., 4 + int(preempt_on), :] if has_route else None
    return (ks[..., 0, :], ks[..., 1, :], ks[..., 2, :], ks[..., 3, :],
            k_pre, k_rt)


def tagged_keys(tags: tuple, k: torch.Tensor) -> torch.Tensor:
    """``(..., P, 2)`` per-tag sampling keys, ``fold_in(k, tag)``; a single
    tag uses ``k`` itself, so the 1-pool market draws as the single queue
    does."""
    if len(tags) == 1:
        return k[..., None, :]
    return threefry.fold_in(k, tags)


def sample_clock_vector(procs: tuple, tags: tuple, k: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """``(..., P)`` renewal samples, one per tag-keyed process, × a
    ``(..., P)`` scale.  Equal processes draw in one call on their keys
    (the same words as one call a process)."""
    keys = tagged_keys(tags, k)
    cols = [None] * len(procs)
    for proc in dict.fromkeys(procs):
        at = [i for i, p in enumerate(procs) if p == proc]
        drawn = proc.sample(keys[..., at, :])
        for j, i in enumerate(at):
            cols[i] = drawn[..., j]
    return torch.stack(cols, dim=-1) * scale


def hazard_units(tags: tuple, k: torch.Tensor) -> torch.Tensor:
    """``(..., P)`` unit exponentials of the revocation clocks, one per tag
    (always tag-folded, even for one tag)."""
    return threefry.exponential(threefry.fold_in(k, tuple(tags)))


def rate_clock(unit: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """The unit exponential ``unit`` at rate ``rate``; a zero rate never
    fires (INF)."""
    return torch.where(rate > 0.0, unit / torch.clamp_min(rate, 1e-30), _INF)


def sample_hazard_clocks(tags: tuple, k: torch.Tensor,
                         hazard: torch.Tensor) -> torch.Tensor:
    """``Exp(h_t)`` revocation clocks per tag (:func:`hazard_units` at
    :func:`rate_clock`)."""
    return rate_clock(hazard_units(tags, k), hazard)


def _running_sums(h: torch.Tensor) -> list:
    """The cumulative sums of ``h``'s last axis, left to right in float32."""
    cum = [h[..., 0]]
    for p in range(1, h.shape[-1]):
        cum.append(cum[-1] + h[..., p])
    return cum


def hazard_total(h: torch.Tensor) -> torch.Tensor:
    """The total of ``h``'s last axis, summed left to right in float32 (the
    superposed hazard of :func:`hazard_clock`)."""
    return _running_sums(h)[-1]


def hazard_clock(hazard, u):
    """Time to the next preemption under the superposed total hazard:
    ``min_p Exp(h_p) ~ Exp(Σ h_p)``; a zero total never fires (INF).  Host
    scalars take a Python path, tensors the engine's (``hazard`` with the
    pools on its last axis)."""
    if not (isinstance(hazard, torch.Tensor) or isinstance(u, torch.Tensor)):
        total = float(np.sum(hazard))
        if total <= 0.0:
            return math.inf
        return -math.log1p(-float(u)) / total
    return rate_clock(exp_from_u(u), hazard_total(hazard))


def thinning_pick(hazard, u):
    """Which pool fired: a categorical draw with weights ``h_p``, a uniform
    thinned over the hazards' running sums; zero-hazard pools are never
    picked.  Host and tensor paths as :func:`hazard_clock`."""
    if not (isinstance(hazard, torch.Tensor) or isinstance(u, torch.Tensor)):
        cum = np.cumsum(np.asarray(hazard, np.float64))
        if cum[-1] <= 0.0:
            return 0
        return int(min(np.sum(float(u) * cum[-1] >= cum[:-1]),
                       len(cum) - 1))
    cum = _running_sums(hazard)
    x = u * cum[-1]
    pick = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for c in cum[:-1]:
        pick = pick + (x >= c).to(torch.int32)
    return torch.clamp_max(pick, hazard.shape[-1] - 1)


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """Static column map of one event's slab row.

    Spans are ``(start, n)`` column ranges; modes say how the kernel hook
    consumes its span: ``"u"`` = slab-aware hook receiving float32
    uniforms, ``"key"`` = two raw columns standing in for a legacy key,
    ``"none"`` = hook absent.  The preempt span is always two columns:
    [superposed clock draw, thinning pick].
    """

    n_cols: int
    job: tuple[int, int]
    spot: tuple[int, int]
    admit: tuple[int, int]
    admit_mode: str  # "u" | "key"
    market_admit: bool  # admit span feeds admit_market (vs plain admit)
    preempt: tuple[int, int] | None
    on_preempt: tuple[int, int] | None
    on_preempt_mode: str  # "u" | "key" | "none"
    route: tuple[int, int] | None
    route_mode: str  # "u" | "key" | "none"

    def bits(self, x: torch.Tensor, span: tuple[int, int]) -> torch.Tensor:
        """Raw words of one span (static slice of the last axis)."""
        return x[..., span[0]:span[0] + span[1]]

    def uniforms(self, x: torch.Tensor, span: tuple[int, int]) -> torch.Tensor:
        """One span as float32 uniforms on [0, 1)."""
        return u01(self.bits(x, span))


def kernel_slab_cols(kernel, hook: str, n: int) -> int | None:
    """Columns a kernel's slab-aware ``hook`` owns, or None for fallback.

    A kernel is slab-aware for ``hook`` iff it defines BOTH ``{hook}_u``
    and ``slab_cols(hook, n)`` returning a non-None count (``n`` is the
    pool/region count, for choice rules whose width depends on it).
    """
    if getattr(kernel, hook + "_u", None) is None:
        return None
    slab_cols = getattr(kernel, "slab_cols", None)
    if slab_cols is None:
        return None
    return slab_cols(hook, n)


def choice_cols(choice: str, n: int) -> int:
    """Uniform columns a pool/region choice rule consumes."""
    if choice == "uniform":
        return 1
    if choice == "weighted":
        return n
    return 0  # deterministic argmin rules (and "home") draw nothing


def build_slab_layout(kernel, *, job_udim: int, spot_udim: int, n: int = 1,
                      preempt_on: bool = False, has_route: bool = False,
                      market: bool = False) -> SlabLayout:
    """Assign a run's slab columns: engine clocks first, hooks after.

    Column order is [job refresh | spot refresh | admit hook | preempt
    clock+pick | on_preempt hook | route hook]; spans the configuration
    does not need are absent, so a degenerate configuration's layout is
    exactly the simpler loop's.
    """
    cursor = 0

    def take(width: int) -> tuple[int, int]:
        nonlocal cursor
        span = (cursor, width)
        cursor += width
        return span

    job = take(job_udim)
    spot = take(spot_udim)
    market_admit = market and hasattr(kernel, "admit_market")
    hook = "admit_market" if market_admit else "admit"
    cols = kernel_slab_cols(kernel, hook, n)
    admit_mode = "key" if cols is None else "u"
    admit = take(KEY_SYNTH_COLS if cols is None else cols)
    preempt = take(2) if preempt_on else None
    on_preempt, on_preempt_mode = None, "none"
    if preempt_on and hasattr(kernel, "on_preempt"):
        cols = kernel_slab_cols(kernel, "on_preempt", n)
        on_preempt_mode = "key" if cols is None else "u"
        on_preempt = take(KEY_SYNTH_COLS if cols is None else cols)
    route, route_mode = None, "none"
    if has_route:
        cols = kernel_slab_cols(kernel, "route", n)
        route_mode = "key" if cols is None else "u"
        route = take(KEY_SYNTH_COLS if cols is None else cols)
    return SlabLayout(
        n_cols=max(cursor, 1), job=job, spot=spot, admit=admit,
        admit_mode=admit_mode, market_admit=market_admit, preempt=preempt,
        on_preempt=on_preempt, on_preempt_mode=on_preempt_mode, route=route,
        route_mode=route_mode)


def process_udim(proc) -> int:
    """Uniform columns an arrival process needs per draw."""
    dim = getattr(proc, "u_dim", None)
    if dim is None:
        raise NotImplementedError(
            f"{proc!r} has no slab sampler (u_dim/sample_u); the split "
            "stream that would run it is not ported yet (ROADMAP.md "
            "Queue 1 item 7)")
    return int(dim)


def window_slab(key: torch.Tensor, n_events: int, n_cols: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance ``(..., 2)`` lane keys one window; return
    ``(new_key, (..., n_events, n_cols) slab)``."""
    ks = threefry.split(key)
    return ks[..., 0, :], threefry.bits32(ks[..., 1, :], (n_events, n_cols))


def window_slab_keys(key: torch.Tensor, n_windows: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-window key ladder of :func:`window_slab` without the slabs:
    ``(slab_keys (..., n_windows, 2), key after the last window)``.  Window
    ``w``'s slab is ``bits32(slab_keys[..., w, :], (n_events_w, n_cols))``."""
    slab_keys = []
    for _ in range(n_windows):
        ks = threefry.split(key)
        key = ks[..., 0, :]
        slab_keys.append(ks[..., 1, :])
    return torch.stack(slab_keys, dim=-2), key


def lane_window_slabs(key: torch.Tensor, plan: tuple[int, ...],
                      n_cols: int) -> torch.Tensor:
    """All of the lanes' window slabs, ``(..., n_windows, max_ev, n_cols)``,
    each window zero-padded up to the plan maximum."""
    max_ev = max(plan)
    slabs = []
    for n_ev in plan:
        key, slab = window_slab(key, n_ev, n_cols)
        slabs.append(torch.nn.functional.pad(slab, (0, 0, 0, max_ev - n_ev)))
    return torch.stack(slabs, dim=-3)
