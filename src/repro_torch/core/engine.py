"""The single-queue spot/on-demand event engine, run as a (grid × seeds) fleet.

One merged-renewal event loop: each lane holds a job clock, a spot-slot
clock and a queue of ``rmax`` slots; every event is the earliest of a job
arrival, a spot slot and a wait deadline (ties resolve spot > deadline >
job).  A policy kernel (:mod:`repro_torch.core.policies`) decides
admission; a job that is not admitted, or whose wait budget runs out, goes
to an on-demand instance at cost ``k``; a spot slot serves the oldest
queued job at cost 1.

Queue representation: ``ages``/``budgets``/``order`` arrays of width
``rmax`` plus an occupancy mask, updated with dense one-hot selects (the
CUDA kernel does the same arithmetic slot by slot).  Spot slots serve the
FIFO-oldest occupied slot (min join ``order``); deadlines fire on the slot
with the smallest remaining budget.  ``order``/``next_seq`` are int32 and
rebased at every window boundary (:func:`_rebase_order`).

Numerics: ages are relative (incremented by the gap ``dt``), sums are
accumulated in float32 per window of ``chunk_events`` events and assembled
in float64 on the host by :func:`summarize`.

Randomness: the slab stream only (:mod:`repro_torch.core.clocks`); the
per-event split ladder is still to be ported (ROADMAP.md Queue 1 item 7).

Executors: the device picks one.  A fleet on a GPU runs through the
hand-written batched-event kernel (:mod:`repro_torch.kernels.sweep`), a
fleet on the CPU through its plain PyTorch version on the same lane layout;
``impl=`` only names the one the device implies (``"cuda"`` or ``"ref"``)
and raises if it names another.  ``device=None`` means the GPU and raises
if there is none.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.arrivals import ArrivalProcess, Gamma
from repro_torch.core.clocks import SlabLayout, build_slab_layout, process_udim
from repro_torch.core.policies import SingleSlotKernel
from repro_torch.core.waittime import INF
from repro_torch.device import resolve_device
_ORDER_MAX = 2**31 - 1

#: float32 window sums are re-zeroed every 2**16 events and assembled in
#: float64 by :func:`summarize`; horizons up to this many events run as one
#: window (chunks clamp to ``n_events``).
DEFAULT_CHUNK_EVENTS = 1 << 16

#: Statistics that count events: bitwise identical across executors (and
#: against the JAX reference); float sums are held to rtol 1e-5 instead.
INT_STATS = ("jobs_arrived", "jobs_completed", "spot_served", "ondemand")


class WindowStats(NamedTuple):
    """Per-window accumulators (float32 sums / int32 counts), one per lane."""

    jobs_arrived: torch.Tensor
    jobs_completed: torch.Tensor
    spot_served: torch.Tensor
    ondemand: torch.Tensor
    cost_sum: torch.Tensor
    delay_sum: torch.Tensor
    time_elapsed: torch.Tensor
    empty_time: torch.Tensor
    spot_arrivals: torch.Tensor
    spot_found_empty: torch.Tensor

    @staticmethod
    def zeros(lanes: int, device) -> "WindowStats":
        z = torch.zeros(lanes, dtype=torch.float32, device=device)
        zi = torch.zeros(lanes, dtype=torch.int32, device=device)
        return WindowStats(zi, zi, zi, zi, z, z, z, z, zi, zi)


class EngineState(NamedTuple):
    """Per-lane state; leaves lead with the lane axis."""

    key: torch.Tensor  # (lanes, 2) int64 threefry key words
    next_job: torch.Tensor  # time until next job arrival
    next_spot: torch.Tensor  # time until next spot-slot arrival
    ages: torch.Tensor  # (lanes, rmax) time each queued job has waited
    budgets: torch.Tensor  # (lanes, rmax) remaining wait budget (INF = forever)
    occ: torch.Tensor  # (lanes, rmax) bool occupancy mask
    order: torch.Tensor  # (lanes, rmax) int32 join sequence number
    next_seq: torch.Tensor  # int32 next join sequence number
    qlen: torch.Tensor  # int32 number of queued jobs


def init_engine_state(key: torch.Tensor, job: ArrivalProcess,
                      spot: ArrivalProcess, rmax: int) -> EngineState:
    """Initial state of each ``(lanes, 2)`` key: the first job and spot
    clocks are drawn from two subkeys, the third becomes the lane key."""
    ks = threefry.split(key, 3)
    lanes, device = key.shape[0], key.device
    return EngineState(
        key=ks[:, 2],
        next_job=job.sample(ks[:, 0]),
        next_spot=spot.sample(ks[:, 1]),
        ages=torch.zeros(lanes, rmax, dtype=torch.float32, device=device),
        budgets=torch.full((lanes, rmax), INF, dtype=torch.float32,
                           device=device),
        occ=torch.zeros(lanes, rmax, dtype=torch.bool, device=device),
        order=torch.zeros(lanes, rmax, dtype=torch.int32, device=device),
        next_seq=torch.zeros(lanes, dtype=torch.int32, device=device),
        qlen=torch.zeros(lanes, dtype=torch.int32, device=device),
    )


def _engine_event(job: ArrivalProcess, spot: ArrivalProcess, kernel,
                  rmax: int, layout: SlabLayout, carry: EngineState,
                  stats: WindowStats, params: dict, k_cost: torch.Tensor,
                  x: torch.Tensor) -> tuple[EngineState, WindowStats]:
    """One merged event (job arrival / spot slot / wait deadline) for every
    lane; ``x`` is this event's ``(lanes, n_cols)`` slab row."""
    iota = torch.arange(rmax, device=carry.ages.device)

    budgets_masked = torch.where(carry.occ, carry.budgets, INF)
    deadline, defect_slot = torch.min(budgets_masked, dim=1)

    dt = torch.minimum(torch.minimum(carry.next_job, carry.next_spot),
                       deadline)
    is_spot = carry.next_spot <= torch.minimum(carry.next_job, deadline)
    is_deadline = (~is_spot) & (deadline <= carry.next_job)
    is_job = (~is_spot) & (~is_deadline)

    ages = carry.ages + dt[:, None]
    budgets = torch.where(carry.occ, carry.budgets - dt[:, None], INF)

    # ---- job arrival: ask the policy kernel ----
    admit_raw, budget = kernel.admit_u(params, carry.qlen,
                                       layout.uniforms(x, layout.admit))
    admit = is_job & admit_raw & (carry.qlen < rmax)
    od_now = is_job & (~admit)  # rejected -> immediate on-demand, delay 0
    join_slot = torch.argmin(carry.occ.to(torch.int32), dim=1)

    # ---- spot slot: serve the FIFO-oldest job ----
    serve_slot = torch.argmin(torch.where(carry.occ, carry.order, _ORDER_MAX),
                              dim=1)
    has_job = carry.qlen > 0
    served = is_spot & has_job
    wait_served = torch.where(iota == serve_slot[:, None], ages, 0.0).sum(1)

    # ---- deadline: the minimal-budget job defects to on-demand ----
    defected = is_deadline  # deadline < INF implies an occupied slot
    age_defect = torch.where(iota == defect_slot[:, None], ages, 0.0).sum(1)

    leave = served | defected
    leave_slot = torch.where(served, serve_slot, defect_slot)

    join_mask = admit[:, None] & (iota == join_slot[:, None])
    leave_mask = leave[:, None] & (iota == leave_slot[:, None])
    budget = torch.as_tensor(budget, dtype=torch.float32, device=ages.device)
    budget = budget[:, None] if budget.dim() else budget
    ages = torch.where(join_mask, 0.0, ages)
    budgets = torch.where(join_mask, budget, budgets)
    occ = (carry.occ | join_mask) & (~leave_mask)
    order = torch.where(join_mask, carry.next_seq[:, None], carry.order)

    job_draw = job.sample_u(layout.uniforms(x, layout.job))
    spot_draw = spot.sample_u(layout.uniforms(x, layout.spot))
    next_job = torch.where(is_job, job_draw, carry.next_job - dt)
    next_spot = torch.where(is_spot, spot_draw, carry.next_spot - dt)
    admit_i = admit.to(torch.int32)
    new_carry = EngineState(
        key=carry.key,  # advanced once per window by the slab generator
        next_job=next_job,
        next_spot=next_spot,
        ages=ages,
        budgets=budgets,
        occ=occ,
        order=order,
        next_seq=carry.next_seq + admit_i,
        qlen=carry.qlen + admit_i - leave.to(torch.int32),
    )
    od_or_def = od_now | defected
    new_stats = WindowStats(
        jobs_arrived=stats.jobs_arrived + is_job.to(torch.int32),
        jobs_completed=stats.jobs_completed
        + (od_now | served | defected).to(torch.int32),
        spot_served=stats.spot_served + served.to(torch.int32),
        ondemand=stats.ondemand + od_or_def.to(torch.int32),
        cost_sum=stats.cost_sum + torch.where(served, 1.0, 0.0)
        + torch.where(od_or_def, k_cost, 0.0),
        delay_sum=stats.delay_sum + torch.where(served, wait_served, 0.0)
        + torch.where(defected, age_defect, 0.0),
        time_elapsed=stats.time_elapsed + dt,
        empty_time=stats.empty_time + torch.where(carry.qlen == 0, dt, 0.0),
        spot_arrivals=stats.spot_arrivals + is_spot.to(torch.int32),
        spot_found_empty=stats.spot_found_empty
        + (is_spot & (~has_job)).to(torch.int32),
    )
    return new_carry, new_stats


def _rebase_order(state: EngineState) -> EngineState:
    """Rebase join sequence numbers to the oldest occupied slot.

    Subtracting the minimum *occupied* sequence (or ``next_seq`` when the
    queue is empty) at every window boundary keeps the int32 counter below
    window-events + rmax forever; the shift is uniform across occupied
    slots, so every order comparison — and every statistic — is unchanged.
    """
    base = torch.where(state.occ, state.order,
                       state.next_seq[:, None]).min(dim=1).values
    return state._replace(
        order=torch.where(state.occ, state.order - base[:, None], 0),
        next_seq=state.next_seq - base,
    )


def _window_plan(n_events: int, chunk_events: int,
                 burn_in: int) -> tuple[int, ...]:
    """Static per-window event counts: [burn-in?] + full chunks + [tail?]."""
    full, rem = divmod(n_events, chunk_events)
    return (((burn_in,) if burn_in else ()) + (chunk_events,) * full
            + ((rem,) if rem else ()))


def _engine_layout(job: ArrivalProcess, spot: ArrivalProcess,
                   kernel) -> SlabLayout:
    """Slab column map for the single-queue loop."""
    layout = build_slab_layout(kernel, job_udim=process_udim(job),
                               spot_udim=process_udim(spot))
    if layout.admit_mode != "u":
        raise NotImplementedError(
            f"{kernel!r} has no slab hook (admit_u/slab_cols); kernels "
            "without one need the split stream, which is not ported yet "
            "(ROADMAP.md Queue 1 item 7)")
    return layout


def lane_params(kernel, params: dict, k_cost: torch.Tensor) -> dict:
    """The kernel's per-lane params dict: a single-slot kernel whose wait
    parameters are not swept gets its wait family's own values."""
    if isinstance(kernel, SingleSlotKernel) and "wait" not in params:
        wait = {name: torch.full_like(k_cost, np.float32(v))
                for name, v in kernel.wait.params().items()}
        return {**params, "wait": wait}
    return params


class NonFiniteStatsError(ValueError):
    """Raised by :func:`summarize` when a reduced statistic is NaN/inf."""


def _check_finite_stats(s) -> None:
    for field in ("cost_sum", "delay_sum", "time_elapsed"):
        v = getattr(s, field)
        if not np.all(np.isfinite(v)):
            raise NonFiniteStatsError(
                f"summarize: window statistic {field!r} is non-finite "
                f"(NaN/inf) — the run diverged (bad params or a poisoned "
                f"window)")


def _flat_lane_args(params: dict, k_cost: torch.Tensor, keys: torch.Tensor):
    """Flatten a (grid × seeds) product to grid-major lanes (seed fastest):
    params and k repeat per seed, seed keys tile per grid point."""
    g, s = k_cost.shape[0], keys.shape[0]

    def rep(x):
        if isinstance(x, dict):
            return {name: rep(v) for name, v in x.items()}
        return torch.repeat_interleave(x, s, dim=0)

    return rep(params), rep(k_cost), keys.repeat(g, 1)


def summarize(stats: WindowStats) -> dict:
    """Reduce (…, n_windows) sums in float64; derive long-run stats.

    Leading batch axes pass through: every value in the returned dict is a
    numpy array of the batch shape (0-d for a single run).  Raises
    :class:`NonFiniteStatsError` when a reduced statistic is NaN/inf.
    """
    s = WindowStats(*(np.asarray(x.cpu(), np.float64).sum(axis=-1)
                      for x in stats))
    _check_finite_stats(s)
    completed = np.maximum(s.jobs_completed, 1.0)
    arrived = np.maximum(s.jobs_arrived, 1.0)
    time = np.maximum(s.time_elapsed, 1e-12)
    spot_arr = np.maximum(s.spot_arrivals, 1.0)
    return {
        "jobs_arrived": s.jobs_arrived,
        "jobs_completed": s.jobs_completed,
        "spot_served": s.spot_served,
        "ondemand": s.ondemand,
        "avg_cost": s.cost_sum / completed,
        "avg_delay": s.delay_sum / completed,
        "time": s.time_elapsed,
        "pi0_time": s.empty_time / time,
        "pi0_spot": s.spot_found_empty / spot_arr,
        "spot_utilization": (s.spot_arrivals - s.spot_found_empty) / spot_arr,
        "arrival_rate": arrived / time,
    }


def _resolve(device, impl: str | None, rng: str, job, spot, name: str):
    """Check the static run options; return the device."""
    if rng == "split":
        raise NotImplementedError(
            f"{name}: rng='split' (the per-event key ladder) is not ported "
            "yet (ROADMAP.md Queue 1 item 7); the port runs rng='slab'")
    if rng != "slab":
        raise ValueError(f"{name}: unknown rng {rng!r} (expected 'slab')")
    for proc in (job, spot):
        if isinstance(proc, Gamma):
            raise NotImplementedError(
                f"{name}: a Gamma process needs jax.random.gamma's rejection "
                "sampler for its initial clock, which is not ported yet "
                "(ROADMAP.md Queue 1 item 7)")
    device = resolve_device(device, name)
    if impl is None:
        return device
    if impl not in ("cuda", "ref"):
        raise ValueError(
            f"{name}: unknown impl {impl!r} (expected 'cuda'|'ref'; the "
            "JAX package's 'xla'/'pallas' executors have no port)")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"{name}: impl='cuda' needs a CUDA device, got "
                         f"{device}")
    if impl == "ref" and device.type != "cpu":
        raise ValueError(f"{name}: impl='ref' (the plain version) runs on "
                         f"the CPU, got {device}")
    return device


def _check_run_shape(name: str, n_events: int, burn_in: int) -> None:
    if n_events <= 0:
        raise ValueError(
            f"{name}: n_events must be a positive event count, got "
            f"{n_events}")
    if burn_in < 0:
        raise ValueError(
            f"{name}: burn_in must be >= 0 events, got {burn_in}")


def _run_lanes(job, spot, kernel, rmax, plan, burn_in, params, k_cost,
               keys) -> WindowStats:
    """Flat lanes through the executor of their device; returns (lanes,
    windows) stats without the burn-in window."""
    # imported here: the kernels package builds on this module's state types
    from repro_torch.kernels.sweep import batched_events

    state0 = init_engine_state(keys, job, spot, rmax)
    _, stats = batched_events(job, spot, kernel, rmax, state0,
                              lane_params(kernel, params, k_cost), k_cost,
                              plan)
    if burn_in:
        stats = WindowStats(*(x[:, 1:] for x in stats))
    return stats


def _lane_tensors(params: dict, k, device):
    """Broadcast params leaves and ``k`` to one grid; return the flat
    float32 grid tensors and the grid shape."""
    leaves = []

    def collect(p):
        for v in p.values():
            if isinstance(v, dict):
                collect(v)
            else:
                leaves.append(np.asarray(v))

    collect(params)
    k = np.asarray(k, np.float32)
    grid_shape = np.broadcast_shapes(k.shape, *(x.shape for x in leaves))

    def flat(x):
        x = np.broadcast_to(np.asarray(x, np.float32), grid_shape).reshape(-1)
        return torch.from_numpy(x.copy()).to(device)

    def walk(p):
        return {n: walk(v) if isinstance(v, dict) else flat(v)
                for n, v in p.items()}

    return walk(params), flat(k), tuple(grid_shape)


def run_sim(job: ArrivalProcess, spot: ArrivalProcess, kernel, params=None,
            *, k: float = 10.0, n_events: int, key: torch.Tensor,
            rmax: int = 64, burn_in: int = 0,
            chunk_events: int | None = DEFAULT_CHUNK_EVENTS,
            impl: str | None = None, rng: str = "slab",
            device=None) -> dict:
    """Run one policy at one parameter point; return long-run scalar stats.

    A one-lane :func:`run_sweep` whose lane key is ``key`` itself (no seed
    split), as in the JAX package.
    """
    params = {} if params is None else params
    device = _resolve(device, impl, rng, job, spot, "run_sim")
    _check_run_shape("run_sim", n_events, burn_in)
    params_f, k_f, grid_shape = _lane_tensors(params, k, device)
    if grid_shape != ():
        raise ValueError(f"run_sim: params and k must be scalars, got grid "
                         f"{grid_shape}")
    chunk = n_events if chunk_events is None else min(chunk_events, n_events)
    plan = _window_plan(n_events, chunk, burn_in)
    stats = _run_lanes(job, spot, kernel, rmax, plan, burn_in, params_f, k_f,
                       key.to(device)[None])
    return {name: float(v)
            for name, v in summarize(WindowStats(*(x[0] for x in stats))
                                     ).items()}


def run_sweep(job: ArrivalProcess, spot: ArrivalProcess, kernel, params=None,
              *, k=10.0, n_events: int, key: torch.Tensor, n_seeds: int = 1,
              rmax: int = 64, burn_in: int = 0,
              chunk_events: int | None = DEFAULT_CHUNK_EVENTS,
              impl: str | None = None, rng: str = "slab",
              device=None) -> dict:
    """Run a whole policy grid × seed fleet in one executor call.

    ``params`` is a dict (nested for ``{"wait": {...}}``) whose leaves,
    together with ``k``, broadcast to a common grid shape (e.g.
    ``{"r": np.linspace(0, 4, 32)}``).  Seeds use common random numbers
    across the grid: ``key`` (a ``(2,)`` threefry key, see
    :func:`repro_torch.core.threefry.key`) splits into ``n_seeds`` lane
    keys shared by every grid point.  Lanes are grid-major, seed fastest.

    ``device=None`` runs on the GPU (the hand-written kernel) and raises if
    there is none; ``device="cpu"`` runs the plain PyTorch version on the
    CPU.  ``impl`` may name the executor the device implies (``"cuda"`` on
    a GPU, ``"ref"`` on the CPU) and raises for any other.  ``rng`` defaults to
    ``"slab"``, the only stream ported so far (the JAX package defaults to
    ``"split"``).

    Returns :func:`summarize`'s dict with every value shaped
    ``grid_shape + (n_seeds,)``.
    """
    params = {} if params is None else params
    device = _resolve(device, impl, rng, job, spot, "run_sweep")
    _check_run_shape("run_sweep", n_events, burn_in)
    params_f, k_f, grid_shape = _lane_tensors(params, k, device)
    keys = threefry.split(key.to(device), n_seeds)
    params_l, k_l, keys_l = _flat_lane_args(params_f, k_f, keys)
    chunk = n_events if chunk_events is None else min(chunk_events, n_events)
    plan = _window_plan(n_events, chunk, burn_in)
    stats = _run_lanes(job, spot, kernel, rmax, plan, burn_in, params_l, k_l,
                       keys_l)
    out = summarize(stats)
    return {name: v.reshape(grid_shape + (n_seeds,)) for name, v in out.items()}
