"""The spot/on-demand event engine, run as a (grid × seeds) fleet.

Three traversals of one merged-renewal event loop: the single queue
(``run_sweep``/``run_sim``), the P-pool spot market
(``run_market_sweep``/``run_market_sim``) and N-region routing
(``run_region_sweep``/``run_region_sim``, the last part of this module).
In the single queue each lane holds a job clock, a spot-slot
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

Randomness (``rng=``, :mod:`repro_torch.core.clocks`): ``"split"`` is the
JAX package's default stream, a per-event key ladder (every event splits
the lane key into the next key and the job, spot and policy subkeys, and
in a market with preemption a fifth, the preemption subkey), run by the
single queue and the market; ``"slab"`` draws each window's random bits
from one key, consumed by static column, and runs on every loop.  The
port's entry points default to ``"slab"``; the regions refuse ``"split"``
(their 6-way ladder is not ported yet, ROADMAP.md Queue 1 item 7).

Optional axes on every entry point: ``telemetry=`` (:mod:`repro_torch.obs`)
and ``env=`` (an :class:`~repro_torch.core.env.EnvTimeline`: segment
boundaries join the event race, the segment's multipliers scale prices,
hazards and spot supply, and the shock counters of
:mod:`repro_torch.obs.shocks` ride outermost of the stats) and ``work=``
(a :class:`~repro_torch.core.work.WorkModel`: every job carries units of
work, restart overhead and checkpoints, the work state rides outermost of
the carry and the survival ledger of :mod:`repro_torch.obs.survival`
outermost of the stats; a :class:`~repro_torch.core.work.CantBeLateKernel`
adds the per-job slack watchdog).

Executors: the device picks one.  A fleet on a GPU runs through the
hand-written batched-event kernel of its traversal
(:mod:`repro_torch.kernels.sweep`), a fleet on the CPU through its plain
PyTorch version on the same lane layout;
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
from repro_torch.core.clocks import (SlabLayout, build_slab_layout,
                                     hazard_clock, hazard_total, hazard_units,
                                     process_udim, rate_clock,
                                     sample_clock_vector,
                                     sample_hazard_clocks, split_event_keys,
                                     thinning_pick)
from repro_torch.core.env import (EnvState, EnvTimeline, clock_rescale,
                                  env_row, init_env_state, inv_avail)
from repro_torch.core.market import (PoolState, as_market,
                                     checkpoint_within_notice)
from repro_torch.core.regions import RegionView, as_topology
from repro_torch.core.policies import deadline_slack
from repro_torch.core.waittime import INF
from repro_torch.core.work import WorkModel, WorkState, init_work_state
from repro_torch.device import resolve_device
from repro_torch.obs.shocks import env_update, summarize_env
from repro_torch.obs.stats import (Telemetry, drop_windows, lane,
                                   summarize_telemetry, telemetry_update)
from repro_torch.obs.survival import summarize_survival, survival_update
from repro_torch.obs.timing import annotate

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
                      spot: ArrivalProcess, rmax: int,
                      ep: dict | None = None) -> EngineState:
    """Initial state of each ``(lanes, 2)`` key: the first job and spot
    clocks are drawn from two subkeys, the third becomes the lane key.
    With an environment timeline ``ep`` the spot clock runs under segment
    0's availability."""
    ks = threefry.split(key, 3)
    lanes, device = key.shape[0], key.device
    next_spot = spot.sample(ks[:, 1])
    if ep is not None:
        next_spot = next_spot * inv_avail(ep["avail"][0])[0]
    return EngineState(
        key=ks[:, 2],
        next_job=job.sample(ks[:, 0]),
        next_spot=next_spot,
        ages=torch.zeros(lanes, rmax, dtype=torch.float32, device=device),
        budgets=torch.full((lanes, rmax), INF, dtype=torch.float32,
                           device=device),
        occ=torch.zeros(lanes, rmax, dtype=torch.bool, device=device),
        order=torch.zeros(lanes, rmax, dtype=torch.int32, device=device),
        next_seq=torch.zeros(lanes, dtype=torch.int32, device=device),
        qlen=torch.zeros(lanes, dtype=torch.int32, device=device),
    )


def _engine_event(job: ArrivalProcess, spot: ArrivalProcess, kernel,
                  rmax: int, layout: SlabLayout | None, carry: EngineState,
                  stats: WindowStats, params: dict, k_cost: torch.Tensor,
                  x: torch.Tensor | None, tel: Telemetry | None = None,
                  ep: dict | None = None, work: WorkModel | None = None,
                  wk: dict | None = None
                  ) -> tuple[EngineState, WindowStats]:
    """One merged event (job arrival / spot slot / wait deadline) for every
    lane; ``x`` is this event's ``(lanes, n_cols)`` slab row.  With
    ``layout=None`` the event runs the split stream instead (``x`` unused):
    it splits each lane key into the next key and the job, spot and policy
    subkeys, and draws from those (the keyed ``admit`` and ``sample``).
    With ``tel`` the stats are a ``(base, telemetry)`` pair and the event
    is also folded into the telemetry block (the JAX body's fold).  With an
    environment timeline ``ep`` (:meth:`EnvTimeline.params`) the carry is
    an ``(EngineState, EnvState)`` pair and the stats an outermost
    ``(stats, EnvWindowStats)`` pair: the segment boundary joins the race
    as the highest-priority event, the segment's availability scales the
    spot clock and its price multiplier the price of a spot serve.  With a
    work model (``work``, its :meth:`WorkModel.params` ``wk``) the carry
    is an outermost ``(carry, WorkState)`` pair and the stats an outermost
    ``(stats, SurvivalWindowStats)`` pair: a serve pays one unit, overhead
    first, and completes the job only when its remainder clears (the
    single queue has no preemption, so nothing rolls back here)."""
    wk_c = None
    if work is not None:
        carry, wk_c = carry
        stats, wstats = stats
    if ep is not None:
        carry, env_c = carry
        stats, estats = stats
        seg = env_c.seg
        avail_row = env_row(ep["avail"], seg)
    if tel is not None:
        stats, tstats = stats
    key = carry.key  # advanced once per window by the slab generator
    if layout is None:
        key, k_job, k_spot, k_pol, _, _ = split_event_keys(carry.key)
    iota = torch.arange(rmax, device=carry.ages.device)

    budgets_masked = torch.where(carry.occ, carry.budgets, INF)
    budgets_masked, armed = _panic_clock(kernel, work, wk, wk_c, carry.occ,
                                         budgets_masked)
    deadline, defect_slot = torch.min(budgets_masked, dim=1)

    dt = torch.minimum(torch.minimum(carry.next_job, carry.next_spot),
                       deadline)
    is_spot = carry.next_spot <= torch.minimum(carry.next_job, deadline)
    is_deadline = (~is_spot) & (deadline <= carry.next_job)
    is_job = (~is_spot) & (~is_deadline)
    if ep is not None:
        is_boundary, dt, (is_spot, is_deadline, is_job) = _boundary(
            env_c, dt, (is_spot, is_deadline, is_job))

    ages = carry.ages + dt[:, None]
    budgets = torch.where(carry.occ, carry.budgets - dt[:, None], INF)

    # ---- job arrival: ask the policy kernel ----
    if layout is None:
        admit_raw, budget = kernel.admit(params, carry.qlen, k_pol)
    else:
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
    complete_serve = served
    if work is not None:
        rem_tot, ws, done_inc, ckpt_taken, complete_serve = _work_serve(
            work, wk, wk_c, served, serve_slot, iota)

    # ---- deadline: the minimal-budget job defects to on-demand ----
    defected = is_deadline  # deadline < INF implies an occupied slot
    age_defect = torch.where(iota == defect_slot[:, None], ages, 0.0).sum(1)

    leave = complete_serve | defected
    leave_slot = torch.where(served, serve_slot, defect_slot)

    join_mask = admit[:, None] & (iota == join_slot[:, None])
    leave_mask = leave[:, None] & (iota == leave_slot[:, None])
    budget = torch.as_tensor(budget, dtype=torch.float32, device=ages.device)
    budget = budget[:, None] if budget.dim() else budget
    ages = torch.where(join_mask, 0.0, ages)
    budgets = torch.where(join_mask, budget, budgets)
    occ = (carry.occ | join_mask) & (~leave_mask)
    order = torch.where(join_mask, carry.next_seq[:, None], carry.order)
    if work is not None:
        ws = _work_join(ws, wk_c, join_mask, dt)

    if layout is None:
        job_draw, spot_draw = job.sample(k_job), spot.sample(k_spot)
    else:
        job_draw = job.sample_u(layout.uniforms(x, layout.job))
        spot_draw = spot.sample_u(layout.uniforms(x, layout.spot))
    next_job = torch.where(is_job, job_draw, carry.next_job - dt)
    next_spot = torch.where(is_spot, spot_draw, carry.next_spot - dt)
    if ep is not None:
        # the spot clock runs at rate·avail, as base draw × 1/avail: fresh
        # draws under the post-event segment, a crossing rescales the
        # survived clock by inv_new/inv_old (exact by memorylessness)
        seg_new = seg + is_boundary.to(torch.int32)
        inv_old = inv_avail(avail_row)[:, 0]
        inv_new = inv_avail(env_row(ep["avail"], seg_new))[:, 0]
        next_spot = torch.where(is_spot, spot_draw * inv_new, next_spot)
        next_spot = torch.where(is_boundary, next_spot * (inv_new / inv_old),
                                next_spot)
    admit_i = admit.to(torch.int32)
    new_carry = EngineState(
        key=key,
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
    # a spot serve pays the segment's price multiplier (k is not spiked)
    spot_price = 1.0 if ep is None else env_row(ep["price"], seg)[:, 0]
    new_stats = WindowStats(
        jobs_arrived=stats.jobs_arrived + is_job.to(torch.int32),
        jobs_completed=stats.jobs_completed
        + (od_now | served | defected).to(torch.int32),
        spot_served=stats.spot_served + served.to(torch.int32),
        ondemand=stats.ondemand + od_or_def.to(torch.int32),
        cost_sum=stats.cost_sum + torch.where(served, spot_price, 0.0)
        + torch.where(od_or_def, k_cost, 0.0),
        delay_sum=stats.delay_sum + torch.where(served, wait_served, 0.0)
        + torch.where(defected, age_defect, 0.0),
        time_elapsed=stats.time_elapsed + dt,
        empty_time=stats.empty_time + torch.where(carry.qlen == 0, dt, 0.0),
        spot_arrivals=stats.spot_arrivals + is_spot.to(torch.int32),
        spot_found_empty=stats.spot_found_empty
        + (is_spot & (~has_job)).to(torch.int32),
    )
    out_stats = new_stats
    if tel is not None:
        # the JAX body's cost sample stays 1.0 on a spot serve, even where
        # the segment's price multiplier is not 1 (cost_sum pays it)
        no = torch.zeros_like(is_spot)
        tstats = telemetry_update(
            tel, tstats, t=new_stats.time_elapsed, is_job=is_job,
            is_spot=is_spot, is_pre=no, is_deadline=is_deadline,
            served=served, resume=no, defected=defected, od_now=od_now,
            wait_sample=torch.where(served, wait_served, age_defect),
            wait_valid=served | defected,
            cost_inc=torch.where(served, np.float32(1.0), k_cost),
            cost_valid=served | od_now | defected,
            loc=torch.zeros_like(new_carry.qlen), n_locs=1,
            qlen=new_carry.qlen)
        out_stats = (new_stats, tstats)
    out_carry = new_carry
    if ep is not None:
        estats, new_env = _env_step(ep, env_c, estats, is_boundary, seg,
                                    seg_new, dt, is_job, od_now, served,
                                    torch.zeros_like(served))
        out_carry, out_stats = (new_carry, new_env), (out_stats, estats)
    if work is None:
        return out_carry, out_stats
    zero = torch.zeros_like(dt)
    wstats = _work_ledger(
        wk, wstats, wk_c, rem_tot, dt, iota, is_job=is_job, od_now=od_now,
        complete_serve=complete_serve, defected=defected, defect_pre=None,
        serve_slot=serve_slot, defect_slot=defect_slot,
        pre_slot=defect_slot, armed=armed, ckpt_taken=ckpt_taken,
        done_inc=done_inc, lost=zero, oh_inc=zero)
    return (out_carry, ws), (out_stats, wstats)


def _env_step(ep: dict, env_c: EnvState, estats, is_boundary, seg, seg_new,
              dt, is_job, od_now, served, resumed):
    """The shock counters' fold and the cursor's step of one event, shared
    by the three loops."""
    estats = env_update(
        estats, is_boundary=is_boundary, kind_prev=env_row(ep["kind"], seg),
        kind_next=env_row(ep["kind"], seg_new), dt=dt, is_job=is_job,
        od_now=od_now, served=served, resumed=resumed)
    t_end = ep["t_end"]
    new_env = EnvState(
        next_boundary=torch.where(
            is_boundary, env_row(t_end, seg_new) - env_row(t_end, seg),
            env_c.next_boundary - dt),
        seg=seg_new)
    return estats, new_env


# ---------------------------------------------------------------------------
# the work axis, shared by the three event bodies (the JAX bodies' work
# branches, in their order of operations)
# ---------------------------------------------------------------------------
def _at(v: torch.Tensor, idx: torch.Tensor, iota: torch.Tensor
        ) -> torch.Tensor:
    """``v[lane, idx[lane]]`` as the JAX bodies take it: the sum of a
    one-hot select."""
    return torch.where(iota == idx[:, None], v, 0.0).sum(1)


def _panic_clock(kernel, work, wk, wk_c, occ, budgets_masked):
    """The can't-be-late watchdog: ``(budgets_masked, armed)`` with each
    occupied slot's panic clock (its slack, clamped at 0) joined to the
    budget race, so that a panic is a defection through the deadline
    machinery; ``armed`` marks the slots whose panic clock beat their
    budget.  Unchanged, with ``armed`` None, without a safety net."""
    if work is None or not getattr(kernel, "safety_net", False):
        return budgets_masked, None
    buf = np.float32(getattr(kernel, "slack_buffer", 0.0))
    rem_all = wk_c.oh + torch.clamp_min(wk["total_work"] - wk_c.prog, 0.0)
    panic_at = torch.clamp_min(
        deadline_slack(wk["deadline"], wk_c.life, rem_all, wk["od_time"],
                       buf), 0.0)
    panic_at = torch.where(occ, panic_at, INF)
    return torch.minimum(budgets_masked, panic_at), panic_at < budgets_masked


def _work_serve(work, wk, wk_c: WorkState, served, serve_slot, iota):
    """A serve's unit of work: overhead debt first, the rest into progress,
    a periodic checkpoint where one falls due.  Returns ``(rem_tot,
    work state, work done, checkpoint taken?, complete_serve)``; a serve
    completes its job only where the remaining total clears."""
    total = wk["total_work"]
    serve_vec = served[:, None] & (iota == serve_slot[:, None])
    rem_tot = wk_c.oh + (total - wk_c.prog)
    rem_serve = _at(rem_tot, serve_slot, iota)
    oh_new = torch.where(serve_vec, torch.clamp_min(wk_c.oh - 1.0, 0.0),
                         wk_c.oh)
    spill = torch.clamp_min(1.0 - wk_c.oh, 0.0)
    prog_new = torch.where(serve_vec, torch.minimum(wk_c.prog + spill, total),
                           wk_c.prog)
    done_inc = torch.where(serve_vec, prog_new - wk_c.prog, 0.0).sum(1)
    ckpt_new, taken = wk_c.ckpt, torch.zeros_like(served)
    if work.ckpt == "periodic":
        take_vec = (serve_vec & (rem_tot > 1.0)
                    & (prog_new - wk_c.ckpt >= wk["ckpt_period"]))
        ckpt_new = torch.where(take_vec, prog_new, wk_c.ckpt)
        oh_new = oh_new + torch.where(take_vec, wk["ckpt_cost"], 0.0)
        taken = take_vec.any(dim=1)
    return (rem_tot, WorkState(prog_new, oh_new, ckpt_new, wk_c.life),
            done_inc, taken, served & (rem_serve <= 1.0))


def _work_rollback(work, wk, ws: WorkState, resume, pre_slot, notice,
                   iota):
    """A resume rolls the revoked job back to its checkpoint and bills the
    restart overhead; in notice mode the checkpoint first saves the
    current progress iff it fits the firing location's ``notice``.
    Returns ``(work state, lost, overhead charged, checkpoint taken?)``."""
    if work.ckpt == "notice":
        saved = resume & checkpoint_within_notice(wk["ckpt_time"], notice)
    else:
        saved = torch.zeros_like(resume)
    prog_p = _at(ws.prog, pre_slot, iota)
    ckpt_p = _at(ws.ckpt, pre_slot, iota)
    ckpt_val = torch.where(saved, torch.maximum(ckpt_p, prog_p), ckpt_p)
    resume_vec = resume[:, None] & (iota == pre_slot[:, None])
    overhead = wk["restart_overhead"]
    ws = ws._replace(
        prog=torch.where(resume_vec, ckpt_val[:, None], ws.prog),
        oh=torch.where(resume_vec, overhead, ws.oh),
        ckpt=torch.where(resume_vec, ckpt_val[:, None], ws.ckpt))
    lost = torch.where(resume, torch.clamp_min(prog_p - ckpt_val, 0.0), 0.0)
    oh_inc = torch.where(resume, overhead, 0.0)
    return ws, lost, oh_inc, resume & saved


def _work_join(ws: WorkState, wk_c: WorkState, join_mask, dt) -> WorkState:
    """Every slot's life ages by ``dt``; a joining job starts from zero."""
    return WorkState(prog=torch.where(join_mask, 0.0, ws.prog),
                     oh=torch.where(join_mask, 0.0, ws.oh),
                     ckpt=torch.where(join_mask, 0.0, ws.ckpt),
                     life=torch.where(join_mask, 0.0,
                                      wk_c.life + dt[:, None]))


def _work_ledger(wk, wstats, wk_c: WorkState, rem_tot, dt, iota, *, is_job,
                 od_now, complete_serve, defected, defect_pre, serve_slot,
                 defect_slot, pre_slot, armed, ckpt_taken, done_inc, lost,
                 oh_inc):
    """The survival ledger's fold of one event.  A job finishes at its last
    served unit or when it migrates to on-demand, whose finish time is its
    life at the migration plus its pre-event remainder × ``od_time``
    (``defect_pre`` None in the single queue, which has no preemption)."""
    life = wk_c.life + dt[:, None]
    od, dl = wk["od_time"], wk["deadline"]

    def late(slot):
        return _at(life, slot, iota) + _at(rem_tot, slot, iota) * od > dl

    miss = ((od_now & (wk["total_work"] * od > dl))
            | (defected & late(defect_slot)))
    finished = od_now | complete_serve | defected
    if defect_pre is not None:
        miss = miss | (defect_pre & late(pre_slot))
        finished = finished | defect_pre
    miss = miss | (complete_serve & (_at(life, serve_slot, iota) > dl))
    panic = torch.zeros_like(defected)
    if armed is not None:
        panic = defected & ((iota == defect_slot[:, None]) & armed).any(dim=1)
    return survival_update(
        wstats, admitted=is_job, finished=finished, missed=miss,
        checkpoint=ckpt_taken, panic=panic, work_done=done_inc,
        work_lost=lost, work_recomputed=lost + oh_inc,
        overhead_paid=oh_inc)


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


class NoAdmitHookError(TypeError):
    """A kernel without the admission hook its stream calls: ``admit_u``
    and ``slab_cols`` on the slab stream, the keyed ``admit`` on the split
    stream."""


def _engine_layout(job: ArrivalProcess, spot: ArrivalProcess, kernel,
                   rng: str = "slab") -> SlabLayout | None:
    """Slab column map for the single-queue loop; None on the split stream,
    whose event body draws from its key ladder."""
    if rng == "split":
        if getattr(kernel, "admit", None) is None:
            raise NoAdmitHookError(
                f"{kernel!r} has no keyed hook admit(params, qlen, key), "
                "which rng='split' calls")
        return None
    layout = build_slab_layout(kernel, job_udim=process_udim(job),
                               spot_udim=process_udim(spot))
    if layout.admit_mode != "u":
        raise NoAdmitHookError(
            f"{kernel!r} has no slab hook (admit_u/slab_cols), which "
            "rng='slab' calls; a kernel with only the keyed admit runs "
            "rng='split'")
    return layout


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


def _merge_telemetry(out: dict, telemetry: Telemetry, tstats,
                     time_elapsed: torch.Tensor) -> dict:
    """Append the telemetry summary (new keys only) and, with a trace, the
    per-window durations that place each window's ring on one clock."""
    tout = summarize_telemetry(telemetry, tstats)
    if "trace" in tout:
        tout["trace"]["time_windows"] = np.asarray(time_elapsed.cpu(),
                                                   np.float64)
    out.update(tout)
    return out


def summarize(stats: WindowStats, telemetry: Telemetry | None = None,
              env: EnvTimeline | None = None,
              work: WorkModel | None = None) -> dict:
    """Reduce (…, n_windows) sums in float64; derive long-run stats.

    Leading batch axes pass through: every value in the returned dict is a
    numpy array of the batch shape (0-d for a single run).  With
    ``telemetry``, ``stats`` is the ``(base, telemetry)`` pair and the dict
    gains :func:`repro_torch.obs.summarize_telemetry`'s keys (the base keys
    unchanged).  With ``env``, ``stats`` is wrapped in an outermost
    ``(stats, EnvWindowStats)`` pair and the dict gains
    :func:`repro_torch.obs.summarize_env`'s shock counters.  With ``work``
    the survival ledger rides outermost of all, ``(stats,
    SurvivalWindowStats)``, and the dict gains
    :func:`repro_torch.obs.summarize_survival`'s job-level keys.  Raises
    :class:`NonFiniteStatsError` when a reduced statistic is NaN/inf.
    """
    wstats = None
    if work is not None:
        stats, wstats = stats
    estats = None
    if env is not None:
        stats, estats = stats
    tstats = None
    if telemetry is not None:
        stats, tstats = stats
    s = WindowStats(*(np.asarray(x.cpu(), np.float64).sum(axis=-1)
                      for x in stats))
    _check_finite_stats(s)
    completed = np.maximum(s.jobs_completed, 1.0)
    arrived = np.maximum(s.jobs_arrived, 1.0)
    time = np.maximum(s.time_elapsed, 1e-12)
    spot_arr = np.maximum(s.spot_arrivals, 1.0)
    out = {
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
    if telemetry is not None:
        _merge_telemetry(out, telemetry, tstats, stats.time_elapsed)
    if estats is not None:
        out.update(summarize_env(estats))
    if wstats is not None:
        out.update(summarize_survival(wstats))
    return out


def _scalar_or_array(v):
    """A single run's value: a 0-d value as a float, an array as it is,
    the trace dict as it is."""
    if isinstance(v, dict) or np.ndim(v):
        return v
    return float(v)


def _reshape_sweep(out: dict, grid_shape: tuple, n_seeds: int) -> dict:
    """Flat ``(lanes, ...)`` summary values as ``grid_shape + (n_seeds,) +
    trailing``: scalar, per-pool/region, histogram and trace fields."""
    def shaped(v):
        return v.reshape(grid_shape + (n_seeds,) + v.shape[1:])

    return {name: ({key: shaped(x) for key, x in v.items()}
                   if isinstance(v, dict) else shaped(v))
            for name, v in out.items()}


def _without_burn_in(stats, burn_in: int, tel: Telemetry | None,
                     env: bool = False, work: bool = False):
    """Stats (or the ``(base, telemetry)`` pair, the ``(..., env)`` pair
    around it with ``env`` and the outermost ``(..., survival)`` pair with
    ``work``) of ``(lanes, windows, ...)`` without the burn-in window."""
    if not burn_in:
        return stats
    if work:
        inner, wstats = stats
        return (_without_burn_in(inner, burn_in, tel, env),
                type(wstats)(*(x[:, 1:] for x in wstats)))
    if env:
        inner, estats = stats
        return (_without_burn_in(inner, burn_in, tel),
                type(estats)(*(x[:, 1:] for x in estats)))
    if tel is not None:
        base, tstats = stats
        return (_without_burn_in(base, burn_in, None),
                drop_windows(tstats, 1))
    return type(stats)(*(x[:, 1:] for x in stats))


def _lane0(stats, tel: Telemetry | None, env: bool = False,
           work: bool = False):
    """The first lane's stats (or pairs), the lane axis dropped."""
    if work:
        inner, wstats = stats
        return (_lane0(inner, tel, env), type(wstats)(*(x[0] for x in wstats)))
    if env:
        inner, estats = stats
        return _lane0(inner, tel), type(estats)(*(x[0] for x in estats))
    if tel is not None:
        base, tstats = stats
        return _lane0(base, None), lane(tstats, 0)
    return type(stats)(*(x[0] for x in stats))


def _refuse_gamma(name: str, procs) -> None:
    """The named error for a Gamma process among ``procs``."""
    for proc in procs:
        if isinstance(proc, Gamma):
            raise NotImplementedError(
                f"{name}: a Gamma process needs jax.random.gamma's rejection "
                "sampler (for its initial clock, and for every draw on the "
                "split stream), which is not ported yet (ROADMAP.md Queue 1 "
                "item 7)")


def _resolve(device, impl: str | None, rng: str, name: str, procs=(),
             split: bool = True):
    """Check the static run options (a Gamma process among ``procs`` is
    refused, and ``rng="split"`` where ``split`` is False: the regions);
    return the device."""
    if rng not in ("split", "slab"):
        raise ValueError(f"{name}: unknown rng {rng!r} (expected "
                         "'split'|'slab')")
    if rng == "split" and not split:
        raise NotImplementedError(
            f"{name}: rng='split' (the per-event key ladder) is not ported "
            "yet for the regions (ROADMAP.md Queue 1 item 7); they run "
            "rng='slab'")
    _refuse_gamma(name, procs)
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


def _carry(state, ep: dict | None, work: WorkModel | None, n_slots: int):
    """The initial carry: the state, paired with every lane's timeline
    cursor when the env axis is on, then (outermost) with a zero work
    state of ``n_slots`` slots when the work axis is on."""
    lanes, device = state.key.shape[0], state.key.device
    if ep is not None:
        state = state, init_env_state(ep, lanes)
    if work is not None:
        state = state, init_work_state(n_slots, lanes, device)
    return state


def _run_lanes(job, spot, kernel, rmax, plan, burn_in, params, k_cost,
               keys, tel: Telemetry | None = None, ep: dict | None = None,
               work: WorkModel | None = None, wk: dict | None = None,
               rng: str = "slab"):
    """Flat lanes through the executor of their device on the ``rng``
    stream; returns (lanes, windows) stats (a ``(base, telemetry)`` pair
    with ``tel``, inside an ``(..., env)`` pair with ``ep`` and an
    outermost ``(..., survival)`` pair with ``work``) without the burn-in
    window."""
    # imported here: the kernels package builds on this module's state types
    from repro_torch.kernels.sweep import batched_events

    state0 = _carry(init_engine_state(keys, job, spot, rmax, ep), ep, work,
                    rmax)
    _, stats = batched_events(job, spot, kernel, rmax, state0, params, k_cost,
                              plan, tel, ep, work, wk, rng)
    return _without_burn_in(stats, burn_in, tel, ep is not None,
                            work is not None)


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
            telemetry: Telemetry | None = None, env=None, work=None,
            device=None) -> dict:
    """Run one policy at one parameter point; return long-run scalar stats.

    A one-lane :func:`run_sweep` whose lane key is ``key`` itself (no seed
    split), as in the JAX package.  ``rng`` as in :func:`run_sweep`.
    ``telemetry`` (a
    :class:`repro_torch.obs.Telemetry`) adds the P50/P90/P99 wait and cost
    sketches, the event counters and, with ``trace_cap``, the event rings
    (``"trace"``); ``env`` (a :class:`repro_torch.core.env.EnvTimeline`)
    runs the horizon through a piecewise-constant environment and adds the
    shock counters (:func:`repro_torch.obs.summarize_env`); ``work`` (a
    :class:`repro_torch.core.work.WorkModel`) gives every job a work
    structure and adds the survival ledger
    (:func:`repro_torch.obs.summarize_survival`).
    """
    params = {} if params is None else params
    _check_options("run_sim", (job, spot), telemetry, env, work, kernel)
    device = _resolve(device, impl, rng, "run_sim", (job, spot))
    _check_run_shape("run_sim", n_events, burn_in)
    params_f, k_f, grid_shape = _lane_tensors(params, k, device)
    if grid_shape != ():
        raise ValueError(f"run_sim: params and k must be scalars, got grid "
                         f"{grid_shape}")
    chunk = n_events if chunk_events is None else min(chunk_events, n_events)
    plan = _window_plan(n_events, chunk, burn_in)
    ep = None if env is None else env.params(1, device)
    wk = None if work is None else work.params(device)
    with annotate(f"repro_torch.run_sim[{device.type}]"):
        stats = _run_lanes(job, spot, kernel, rmax, plan, burn_in, params_f,
                           k_f, key.to(device)[None], telemetry, ep, work,
                           wk, rng)
    stats = _lane0(stats, telemetry, ep is not None, work is not None)
    return {name: _scalar_or_array(v)
            for name, v in summarize(stats, telemetry, env, work).items()}


def run_sweep(job: ArrivalProcess, spot: ArrivalProcess, kernel, params=None,
              *, k=10.0, n_events: int, key: torch.Tensor, n_seeds: int = 1,
              rmax: int = 64, burn_in: int = 0,
              chunk_events: int | None = DEFAULT_CHUNK_EVENTS,
              impl: str | None = None, rng: str = "slab",
              telemetry: Telemetry | None = None, env=None, work=None,
              shard: str = "none", mesh=None, device=None) -> dict:
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
    a GPU, ``"ref"`` on the CPU) and raises for any other.  ``rng`` picks
    the stream: ``"split"``, the JAX package's default, draws every event
    from a per-event key ladder (each lane key advances once an event; the
    kernel walks the ladder itself); ``"slab"``, the port's default (the
    regions run only it), draws each window's bits from one key.  The two
    streams agree in distribution, not bitwise.  ``telemetry`` (a
    :class:`repro_torch.obs.Telemetry`) adds the telemetry summary at every
    grid point, through the same kernel launch; ``env`` (an
    :class:`~repro_torch.core.env.EnvTimeline`) adds the shock counters at
    every grid point, through the same launch; ``work`` (a
    :class:`~repro_torch.core.work.WorkModel`) adds the survival ledger,
    through the same launch; ``shard``/``mesh`` are not ported and raise.

    Returns :func:`summarize`'s dict with every value shaped
    ``grid_shape + (n_seeds,)`` (plus a trailing bin, type or location
    axis for the telemetry vectors, and ``(windows, cap)`` for the trace).
    """
    params = {} if params is None else params
    _check_options("run_sweep", (job, spot), telemetry, env, work, kernel,
                   shard, mesh)
    device = _resolve(device, impl, rng, "run_sweep", (job, spot))
    _check_run_shape("run_sweep", n_events, burn_in)
    params_f, k_f, grid_shape = _lane_tensors(params, k, device)
    keys = threefry.split(key.to(device), n_seeds)
    params_l, k_l, keys_l = _flat_lane_args(params_f, k_f, keys)
    chunk = n_events if chunk_events is None else min(chunk_events, n_events)
    plan = _window_plan(n_events, chunk, burn_in)
    ep = None if env is None else env.params(1, device)
    wk = None if work is None else work.params(device)
    with annotate(f"repro_torch.run_sweep[{device.type}]"):
        stats = _run_lanes(job, spot, kernel, rmax, plan, burn_in, params_l,
                           k_l, keys_l, telemetry, ep, work, wk, rng)
    return _reshape_sweep(summarize(stats, telemetry, env, work), grid_shape,
                          n_seeds)


# ===========================================================================
# The P-pool spot market: per-pool spot clocks, one superposed preemption
# clock, pool-tagged FIFO service and revocation
# ===========================================================================
#
# The market loop widens the single queue: the spot clock becomes a (P,)
# vector, each queued job carries the pool it runs on, and (when any pool
# has a hazard) one superposed preemption clock at the total hazard revokes
# the FIFO-oldest job of a pool picked by thinning (clocks.hazard_clock,
# clocks.thinning_pick).  Ties resolve spot > preempt > deadline > job,
# ties between pools to the lowest index.  A preempted leg is paid at its
# pool's price; the kernel's ``on_preempt_u`` then re-queues it (age reset,
# a fresh join order, same slot and pool) or it defects to on-demand.  With
# one pool of unit price and no hazard every expression reduces bitwise to
# the single queue's (the preemption path is statically absent and the
# extra sums add +0.0).


class MarketWindowStats(NamedTuple):
    """Per-window market accumulators, one per lane; the first ten fields
    are :class:`WindowStats`'.  Under preemption completions count legs: a
    checkpointed revocation closes one, its retry another.  The pool fields
    are ``(lanes, P)``."""

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
    resumed: torch.Tensor  # i32 revoked legs that checkpointed and re-queued
    spot_cost: torch.Tensor  # f32 paid to spot pools, partial legs included
    pool_served: torch.Tensor  # (lanes, P) i32 completions per pool
    pool_spot_arrivals: torch.Tensor  # (lanes, P) i32 slots per pool
    pool_preempted: torch.Tensor  # (lanes, P) i32 revocations per pool

    @staticmethod
    def zeros(lanes: int, n_pools: int, device) -> "MarketWindowStats":
        z = torch.zeros(lanes, dtype=torch.float32, device=device)
        zi = torch.zeros(lanes, dtype=torch.int32, device=device)
        zp = torch.zeros(lanes, n_pools, dtype=torch.int32, device=device)
        return MarketWindowStats(zi, zi, zi, zi, z, z, z, z, zi, zi, zi, z,
                                 zp, zp, zp)


_POOL_FIELDS = frozenset({"pool_served", "pool_spot_arrivals",
                          "pool_preempted"})
#: market statistics that count events (bitwise across executors)
MARKET_INT_STATS = INT_STATS + ("resumed", "pool_served",
                                "pool_spot_arrivals", "pool_preempted",
                                "preemptions", "spot_arrivals",
                                "spot_found_empty")


class MarketState(NamedTuple):
    """Per-lane market state; leaves lead with the lane axis."""

    key: torch.Tensor  # (lanes, 2) threefry key words
    next_job: torch.Tensor  # time until the next job arrival
    next_spot: torch.Tensor  # (lanes, P) per-pool spot-slot clocks
    # the superposed preemption clock (INF = never); on the split stream
    # the (lanes, P) per-pool clocks
    next_preempt: torch.Tensor
    ages: torch.Tensor  # (lanes, rmax)
    budgets: torch.Tensor  # (lanes, rmax)
    occ: torch.Tensor  # (lanes, rmax) bool
    pool: torch.Tensor  # (lanes, rmax) int32 pool of each queued job
    order: torch.Tensor  # (lanes, rmax) int32 join sequence number
    next_seq: torch.Tensor  # int32
    qlen: torch.Tensor  # int32


def init_market_state(key: torch.Tensor, job: ArrivalProcess, market,
                      rmax: int, mp: dict, preempt_on: bool,
                      ep: dict | None = None,
                      rng: str = "slab") -> MarketState:
    """Initial state of each ``(lanes, 2)`` key under the per-lane
    pools-config ``mp`` (``(lanes, P)`` leaves).  As the JAX package's
    ``init_market_state``: the job, spot and lane keys are the three
    subkeys of a split; the pools' spot clocks come from ``fold_in(spot
    key, tag)`` (the spot key itself for one pool), and the per-pool
    hazard draws from ``fold_in(fold_in(spot key, 2**31 - 1), tag)``.  On
    the split stream they stay a ``(lanes, P)`` vector of preemption clocks
    (JAX's ``scalar_preempt=False``); on the slab stream their least is
    the one superposed clock, ``(lanes,)``.  An environment timeline ``ep``
    places the initial clocks under segment 0's hazard and availability
    (exact ×1.0 on a constant timeline)."""
    ks3 = threefry.split(key, 3)
    kj, ks = ks3[:, 0], ks3[:, 1]
    lanes, device = key.shape[0], key.device
    hazard0 = mp["hazard"] if ep is None else mp["hazard"] * ep["hazard"][0]
    shape = (lanes, market.n_pools) if rng == "split" else (lanes,)
    if preempt_on:
        next_preempt = sample_hazard_clocks(
            market.tags, threefry.fold_in(ks, 2**31 - 1), hazard0)
        if rng != "split":
            next_preempt = next_preempt.min(dim=-1).values
    else:
        next_preempt = torch.full(shape, INF, dtype=torch.float32,
                                  device=device)
    next_spot = sample_clock_vector(tuple(p.arrival for p in market.pools),
                                    market.tags, ks, mp["spot_scale"])
    if ep is not None:
        next_spot = next_spot * inv_avail(ep["avail"][0])
    return MarketState(
        key=ks3[:, 2],
        next_job=job.sample(kj),
        next_spot=next_spot,
        next_preempt=next_preempt,
        ages=torch.zeros(lanes, rmax, dtype=torch.float32, device=device),
        budgets=torch.full((lanes, rmax), INF, dtype=torch.float32,
                           device=device),
        occ=torch.zeros(lanes, rmax, dtype=torch.bool, device=device),
        pool=torch.zeros(lanes, rmax, dtype=torch.int32, device=device),
        order=torch.zeros(lanes, rmax, dtype=torch.int32, device=device),
        next_seq=torch.zeros(lanes, dtype=torch.int32, device=device),
        qlen=torch.zeros(lanes, dtype=torch.int32, device=device),
    )


def _kernel_admit_slab(kernel, params, qlen, pool_state: PoolState,
                       layout: SlabLayout, x):
    """(admit?, budget, pool): a market kernel's ``admit_market_u`` on its
    own columns; a single-queue kernel's ``admit_u``, to pool 0."""
    u = layout.uniforms(x, layout.admit)
    if layout.market_admit:
        admit, budget, pool = kernel.admit_market_u(params, qlen, pool_state,
                                                    u)
        return admit, budget, pool.to(torch.int32)
    admit, budget = kernel.admit_u(params, qlen, u)
    return admit, budget, torch.zeros_like(qlen)


def _kernel_admit(kernel, params, qlen, pool_state: PoolState, key):
    """(admit?, budget, pool) on the split stream: a market kernel's keyed
    ``admit_market``; a single-queue kernel's keyed ``admit``, to pool 0."""
    if hasattr(kernel, "admit_market"):
        admit, budget, pool = kernel.admit_market(params, qlen, pool_state,
                                                  key)
        return admit, budget, pool.to(torch.int32)
    admit, budget = kernel.admit(params, qlen, key)
    return admit, budget, torch.zeros_like(qlen)


def _kernel_on_preempt(kernel, params, age, notice, qlen, key):
    """resume? on the split stream: the kernel's keyed ``on_preempt``; a
    kernel without the hook defects on revocation."""
    if hasattr(kernel, "on_preempt"):
        return kernel.on_preempt(params, age, notice, qlen, key)
    return torch.zeros(qlen.shape, dtype=torch.bool, device=qlen.device)


def _kernel_on_preempt_slab(kernel, params, age, notice, qlen,
                            layout: SlabLayout, x):
    """resume?: the kernel's ``on_preempt_u``; a kernel without the hook
    defects on revocation."""
    if layout.on_preempt_mode == "u":
        return kernel.on_preempt_u(params, age, notice, qlen,
                                   layout.uniforms(x, layout.on_preempt))
    return torch.zeros(qlen.shape, dtype=torch.bool, device=qlen.device)


def _pick(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[lane, idx[lane]]`` for every lane."""
    return torch.gather(v, 1, idx.long()[:, None])[:, 0]


def _market_event(job: ArrivalProcess, market, kernel, rmax: int,
                  preempt_on: bool, layout: SlabLayout | None,
                  carry: MarketState, stats: MarketWindowStats, params: dict,
                  mp: dict, k_cost: torch.Tensor, x: torch.Tensor | None,
                  tel: Telemetry | None = None, ep: dict | None = None,
                  work: WorkModel | None = None, wk: dict | None = None
                  ) -> tuple[MarketState, MarketWindowStats]:
    """One merged event (job arrival / pool spot slot / pool preemption /
    wait deadline) for every lane; ``x`` is this event's slab row.  With
    ``layout=None`` the event runs the split stream instead (``x`` unused):
    each lane key splits into the next key and the job, spot, policy and
    (with preemption) preemption subkeys, the keyed hooks decide, the
    pools' fresh spot and hazard clocks are tag-folded draws, and the
    preemption clocks are a ``(lanes, P)`` vector whose earliest (lowest
    pool on ties) fires.  The JAX package's ``_market_event`` with its
    telemetry fold (``tel``: the stats are a ``(base, telemetry)`` pair) and
    its environment branch (``ep``, as in :func:`_engine_event`: the pools'
    effective price and hazard are the base × the segment's row, their
    spot supply × the availability, and the kernel's :class:`PoolState`
    sees the effective market, a zero ``rate`` the blackout signal
    ``PanicKernel`` keys on) and its work branch (``work``/``wk``, as in
    :func:`_engine_event`; here a resume rolls the job back to its
    checkpoint and owes the restart overhead, and the ledger prices every
    rollback)."""
    wk_c = None
    if work is not None:
        carry, wk_c = carry
        stats, wstats = stats
    if ep is not None:
        carry, env_c = carry
        stats, estats = stats
        seg = env_c.seg
        avail_row = env_row(ep["avail"], seg)
        price = mp["price"] * env_row(ep["price"], seg)
        hazard = mp["hazard"] * env_row(ep["hazard"], seg)
    else:
        price, hazard = mp["price"], mp["hazard"]
    if tel is not None:
        stats, tstats = stats
    key = carry.key  # advanced once per window by the slab generator
    if layout is None:
        key, k_job, k_spot, k_pol, k_pre, _ = split_event_keys(carry.key,
                                                               preempt_on)
    device = carry.ages.device
    iota = torch.arange(rmax, device=device)
    iota_p = torch.arange(market.n_pools, device=device)

    budgets_masked = torch.where(carry.occ, carry.budgets, INF)
    budgets_masked, armed = _panic_clock(kernel, work, wk, wk_c, carry.occ,
                                         budgets_masked)
    deadline, defect_slot = torch.min(budgets_masked, dim=1)
    min_spot, spot_pool = torch.min(carry.next_spot, dim=1)
    nj = carry.next_job
    if preempt_on:
        if layout is None:
            min_pre, pre_pool = torch.min(carry.next_preempt, dim=1)
        else:
            min_pre = carry.next_preempt
            pre_pool = thinning_pick(
                hazard, layout.uniforms(x, layout.preempt)[:, 1])
        dt = torch.minimum(torch.minimum(nj, min_spot),
                           torch.minimum(deadline, min_pre))
        is_spot = min_spot <= torch.minimum(nj, torch.minimum(deadline,
                                                              min_pre))
        is_pre = (~is_spot) & (min_pre <= torch.minimum(nj, deadline))
        is_deadline = (~is_spot) & (~is_pre) & (deadline <= nj)
        is_job = (~is_spot) & (~is_pre) & (~is_deadline)
    else:
        dt = torch.minimum(torch.minimum(nj, min_spot), deadline)
        is_spot = min_spot <= torch.minimum(nj, deadline)
        is_pre = torch.zeros_like(is_spot)
        is_deadline = (~is_spot) & (deadline <= nj)
        is_job = (~is_spot) & (~is_deadline)
    if ep is not None:
        is_boundary, dt, (is_spot, is_pre, is_deadline, is_job) = _boundary(
            env_c, dt, (is_spot, is_pre, is_deadline, is_job))

    ages = carry.ages + dt[:, None]
    budgets = torch.where(carry.occ, carry.budgets - dt[:, None], INF)

    rates = mp["rate"] / mp["spot_scale"]
    if ep is not None:
        rates = rates * avail_row  # 0 on a blacked-out pool: the signal
        if getattr(kernel, "drain_dead", False):
            # PanicKernel's drain: jobs queued on a dead pool re-tag to the
            # cheapest alive pool (identity where nothing is dark)
            alive_p = rates > 0
            cheapest = torch.argmin(torch.where(alive_p, price, INF),
                                    dim=1).to(torch.int32)
            alive_slot = torch.gather(alive_p, 1, carry.pool.long())
            retag = carry.occ & (~alive_slot) & alive_p.any(dim=1)[:, None]
            carry = carry._replace(pool=torch.where(retag, cheapest[:, None],
                                                    carry.pool))

    # ---- job arrival: the policy kernel admits and picks a pool ----
    qlen_pool = (carry.occ[:, :, None]
                 & (carry.pool[:, :, None] == iota_p)).sum(1).to(torch.int32)
    pool_state = PoolState(price=price, hazard=hazard, notice=mp["notice"],
                           rate=rates, qlen_pool=qlen_pool)
    if layout is None:
        admit_raw, budget, pool_choice = _kernel_admit(
            kernel, params, carry.qlen, pool_state, k_pol)
    else:
        admit_raw, budget, pool_choice = _kernel_admit_slab(
            kernel, params, carry.qlen, pool_state, layout, x)
    admit = is_job & admit_raw & (carry.qlen < rmax)
    od_now = is_job & (~admit)
    join_slot = torch.argmin(carry.occ.to(torch.int32), dim=1)

    # ---- pool spot slot: serve the FIFO-oldest job tagged that pool ----
    eligible_s = carry.occ & (carry.pool == spot_pool[:, None])
    serve_slot = torch.argmin(torch.where(eligible_s, carry.order,
                                          _ORDER_MAX), dim=1)
    has_elig = eligible_s.any(dim=1)
    served = is_spot & has_elig
    wait_served = torch.where(iota == serve_slot[:, None], ages, 0.0).sum(1)
    price_s = _pick(price, spot_pool)
    complete_serve = served
    if work is not None:
        rem_tot, ws, done_inc, ckpt_taken, complete_serve = _work_serve(
            work, wk, wk_c, served, serve_slot, iota)

    # ---- pool preemption: revoke the FIFO-oldest job on that pool ----
    no = torch.zeros_like(is_spot)
    if preempt_on:
        eligible_p = carry.occ & (carry.pool == pre_pool[:, None])
        pre_slot = torch.argmin(torch.where(eligible_p, carry.order,
                                            _ORDER_MAX), dim=1)
        pre_hit = is_pre & eligible_p.any(dim=1)
        age_pre = torch.where(iota == pre_slot[:, None], ages, 0.0).sum(1)
        # re-admission sees the queue without the revoked job
        qlen_wo = torch.clamp_min(carry.qlen - 1, 0)
        notice_p = _pick(mp["notice"], pre_pool)
        if layout is None:
            resume_raw = _kernel_on_preempt(kernel, params, age_pre,
                                            notice_p, qlen_wo, k_pre)
        else:
            resume_raw = _kernel_on_preempt_slab(
                kernel, params, age_pre, notice_p, qlen_wo, layout, x)
        resume = pre_hit & resume_raw
        defect_pre = pre_hit & (~resume)
        price_p = _pick(price, pre_pool)
    else:
        pre_pool = pre_slot = torch.zeros_like(spot_pool)
        pre_hit = resume = defect_pre = no
        age_pre = price_p = torch.zeros_like(dt)
    if work is not None:
        lost = oh_inc = torch.zeros_like(dt)
        if preempt_on:
            ws, lost, oh_inc, saved = _work_rollback(
                work, wk, ws, resume, pre_slot, _pick(mp["notice"], pre_pool),
                iota)
            ckpt_taken = ckpt_taken | saved

    # ---- deadline: the minimal-budget job defects to on-demand ----
    defected = is_deadline
    age_defect = torch.where(iota == defect_slot[:, None], ages, 0.0).sum(1)

    leave = complete_serve | defected | defect_pre
    leave_slot = torch.where(served, serve_slot,
                             torch.where(defected, defect_slot, pre_slot))
    join_mask = admit[:, None] & (iota == join_slot[:, None])
    leave_mask = leave[:, None] & (iota == leave_slot[:, None])
    resume_mask = resume[:, None] & (iota == pre_slot[:, None])
    budget = torch.as_tensor(budget, dtype=torch.float32, device=device)
    budget = budget[:, None] if budget.dim() else budget
    ages = torch.where(join_mask | resume_mask, 0.0, ages)
    budgets = torch.where(join_mask, budget,
                          torch.where(resume_mask, INF, budgets))
    occ = (carry.occ | join_mask) & (~leave_mask)
    pool = torch.where(join_mask, pool_choice[:, None], carry.pool)
    order = torch.where(join_mask | resume_mask, carry.next_seq[:, None],
                        carry.order)
    if work is not None:
        ws = _work_join(ws, wk_c, join_mask, dt)

    fire_s = is_spot[:, None] & (iota_p == spot_pool[:, None])
    procs = tuple(p.arrival for p in market.pools)
    if layout is None:
        spot_draws = sample_clock_vector(procs, market.tags, k_spot,
                                         mp["spot_scale"])
        job_draw = job.sample(k_job)
        # only the firing pool's hazard clock is drawn afresh
        pre_fired = is_pre[:, None] & (iota_p == pre_pool[:, None])
        pre_draw = (hazard_units(market.tags, k_pre) if preempt_on
                    else None)
    else:
        u_spot = layout.uniforms(x, layout.spot)
        spot_draws = torch.stack([p.sample_u(u_spot) for p in procs],
                                 dim=-1) * mp["spot_scale"]
        job_draw = job.sample_u(layout.uniforms(x, layout.job))
        pre_fired = is_pre
        pre_draw = (layout.uniforms(x, layout.preempt)[:, 0] if preempt_on
                    else None)
    next_spot, next_preempt, seg_new = _supply_clocks(
        mp, layout is None, pre_fired, pre_draw, preempt_on, spot_draws,
        fire_s, carry.next_spot, carry.next_preempt, dt, hazard,
        None if ep is None else (ep, is_boundary, seg, avail_row))

    admit_i = admit.to(torch.int32)
    new_carry = MarketState(
        key=key,
        next_job=torch.where(is_job, job_draw, nj - dt),
        next_spot=next_spot,
        next_preempt=next_preempt,
        ages=ages,
        budgets=budgets,
        occ=occ,
        pool=pool,
        order=order,
        next_seq=carry.next_seq + (admit | resume).to(torch.int32),
        qlen=carry.qlen + admit_i - leave.to(torch.int32),
    )
    od_any = od_now | defected | defect_pre
    completed = od_any | served | resume
    i32 = lambda b: b.to(torch.int32)  # noqa: E731
    new_stats = MarketWindowStats(
        jobs_arrived=stats.jobs_arrived + i32(is_job),
        jobs_completed=stats.jobs_completed + i32(completed),
        spot_served=stats.spot_served + i32(served),
        ondemand=stats.ondemand + i32(od_any),
        cost_sum=stats.cost_sum + torch.where(served, price_s, 0.0)
        + torch.where(od_any, k_cost, 0.0)
        + torch.where(pre_hit, price_p, 0.0),
        delay_sum=stats.delay_sum + torch.where(served, wait_served, 0.0)
        + torch.where(defected, age_defect, 0.0)
        + torch.where(pre_hit, age_pre, 0.0),
        time_elapsed=stats.time_elapsed + dt,
        empty_time=stats.empty_time + torch.where(carry.qlen == 0, dt, 0.0),
        spot_arrivals=stats.spot_arrivals + i32(is_spot),
        spot_found_empty=stats.spot_found_empty + i32(is_spot & (~has_elig)),
        resumed=stats.resumed + i32(resume),
        spot_cost=stats.spot_cost + torch.where(served, price_s, 0.0)
        + torch.where(pre_hit, price_p, 0.0),
        pool_served=stats.pool_served + i32(fire_s & served[:, None]),
        pool_spot_arrivals=stats.pool_spot_arrivals + i32(fire_s),
        pool_preempted=stats.pool_preempted
        + i32(pre_hit[:, None] & (iota_p == pre_pool[:, None])),
    )
    out_stats = new_stats
    if tel is not None:
        # a job event's loc is the pool it chose, a deadline's the
        # defecting job's pool
        loc = torch.where(is_spot, spot_pool, torch.where(
            is_pre, pre_pool, torch.where(is_deadline,
                                          _pick(carry.pool, defect_slot),
                                          pool_choice)))
        tstats = telemetry_update(
            tel, tstats, t=new_stats.time_elapsed, is_job=is_job,
            is_spot=is_spot, is_pre=is_pre, is_deadline=is_deadline,
            served=served, resume=resume, defected=defected, od_now=od_now,
            wait_sample=torch.where(served, wait_served,
                                    torch.where(defected, age_defect,
                                                age_pre)),
            wait_valid=served | defected | pre_hit,
            cost_inc=torch.where(served, price_s, 0.0)
            + torch.where(od_any, k_cost, 0.0)
            + torch.where(pre_hit, price_p, 0.0),
            cost_valid=served | od_now | defected | pre_hit,
            loc=loc, n_locs=market.n_pools, qlen=new_carry.qlen)
        out_stats = (new_stats, tstats)
    out_carry = new_carry
    if ep is not None:
        estats, new_env = _env_step(ep, env_c, estats, is_boundary, seg,
                                    seg_new, dt, is_job, od_now, served,
                                    resume)
        out_carry, out_stats = (new_carry, new_env), (out_stats, estats)
    if work is None:
        return out_carry, out_stats
    wstats = _work_ledger(
        wk, wstats, wk_c, rem_tot, dt, iota, is_job=is_job, od_now=od_now,
        complete_serve=complete_serve, defected=defected,
        defect_pre=defect_pre, serve_slot=serve_slot,
        defect_slot=defect_slot, pre_slot=pre_slot, armed=armed,
        ckpt_taken=ckpt_taken, done_inc=done_inc, lost=lost, oh_inc=oh_inc)
    return (out_carry, ws), (out_stats, wstats)


def _boundary(env_c: EnvState, dt: torch.Tensor, events: tuple):
    """Boundary-as-event: ``(is_boundary, dt, events)`` with the crossing
    winning the race outright (no queue activity, clocks age by dt), every
    queue event masked off on it, so dt never spans segments."""
    is_boundary = env_c.next_boundary <= dt
    not_b = ~is_boundary
    return (is_boundary, torch.minimum(dt, env_c.next_boundary),
            tuple(e & not_b for e in events))


def _supply_clocks(cfg, split, pre_fired, pre_draw, preempt_on, spot_draws,
                   fire_s, next_spot, next_preempt, dt, hazard, env=None):
    """The market's or regions' spot clocks (``(lanes, n)``) and preemption
    clocks after one event: fresh draws where a location fired, aged clocks
    elsewhere.  The preemption clocks are drawn afresh where ``pre_fired``,
    at the post-event hazard: on the slab stream (``split`` False) the one
    superposed clock, ``(lanes,)``, from the uniform ``pre_draw`` at the
    total hazard; on the split stream the ``(lanes, P)`` vector, the fired
    pool's from its unit exponential in ``pre_draw`` at its own hazard.
    ``hazard`` is the pre-event (effective) hazard.  With ``env`` (``(ep,
    is_boundary, seg, avail_row)``), fresh draws run under the post-event
    segment (spot × 1/avail, the preemption clocks at the new hazards) and
    a crossing rescales the survived clocks exactly, the superposed one by
    the ratio of the totals, a pool's by its own.  Returns ``(next_spot,
    next_preempt, seg_new)`` (``seg_new`` None without ``env``)."""
    seg_new = None
    hazard_new = hazard
    if env is not None:
        ep, is_boundary, seg, avail_row = env
        seg_new = seg + is_boundary.to(torch.int32)
        inv_old = inv_avail(avail_row)
        inv_new = inv_avail(env_row(ep["avail"], seg_new))
        hazard_new = cfg["hazard"] * env_row(ep["hazard"], seg_new)
        spot_draws = spot_draws * inv_new
    next_spot = torch.where(fire_s, spot_draws, next_spot - dt[:, None])
    if env is not None:
        next_spot = torch.where(is_boundary[:, None],
                                next_spot * (inv_new / inv_old), next_spot)
    if preempt_on:
        if split:
            fresh, aged = (rate_clock(pre_draw, hazard_new),
                           next_preempt - dt[:, None])
        else:
            fresh, aged = (hazard_clock(hazard_new, pre_draw),
                           next_preempt - dt)
        next_preempt = torch.where(pre_fired, fresh, aged)
        if env is not None:
            if split:
                crossed = is_boundary[:, None]
                rescale = clock_rescale(hazard, hazard_new)
            else:
                crossed = is_boundary
                rescale = clock_rescale(hazard_total(hazard),
                                        hazard_total(hazard_new))
            next_preempt = torch.where(crossed, next_preempt * rescale,
                                       next_preempt)
    return next_spot, next_preempt, seg_new


def _market_layout(job: ArrivalProcess, market, kernel, preempt_on: bool,
                   rng: str = "slab") -> SlabLayout | None:
    """Slab column map for the market loop: the spot span is the largest
    ``u_dim`` across the pools (every pool transforms the same uniforms;
    only the firing pool's draw is kept).  None on the split stream, whose
    event body draws from its key ladder and calls the keyed hooks."""
    if rng == "split":
        if not (hasattr(kernel, "admit_market")
                or getattr(kernel, "admit", None) is not None):
            raise NoAdmitHookError(
                f"{kernel!r} has no keyed hook admit_market(params, qlen, "
                "pool_state, key) or admit(params, qlen, key), which "
                "rng='split' calls")
        return None
    layout = build_slab_layout(
        kernel, job_udim=process_udim(job),
        spot_udim=max(process_udim(p.arrival) for p in market.pools),
        n=market.n_pools, preempt_on=preempt_on, market=True)
    if layout.admit_mode != "u" or layout.on_preempt_mode == "key":
        raise NoAdmitHookError(
            f"{kernel!r} has no slab hook for its market admission or "
            "revocation (admit_market_u/on_preempt_u with slab_cols), "
            "which rng='slab' calls; a kernel with only keyed hooks runs "
            "rng='split'")
    return layout


def summarize_market(stats: MarketWindowStats,
                     telemetry: Telemetry | None = None,
                     env: EnvTimeline | None = None,
                     work: WorkModel | None = None) -> dict:
    """:func:`summarize`'s dict plus the market's: preemptions, resumed
    legs, spot spend, per-job averages over final completions (spot
    service or on-demand: a resumed leg is not one), and per-pool arrays
    (a trailing pool axis).  Scalar fields reduce the last (window) axis,
    pool fields the one before it.  With ``telemetry``, ``stats`` is the
    ``(base, telemetry)`` pair and the telemetry keys are appended; with
    ``env`` the env block rides around them and the shock counters are
    appended; with ``work`` the survival ledger rides outermost of all and
    its job-level keys are appended."""
    wstats = None
    if work is not None:
        stats, wstats = stats
    estats = None
    if env is not None:
        stats, estats = stats
    tstats = None
    if telemetry is not None:
        stats, tstats = stats
    out = summarize(WindowStats(*stats[:len(WindowStats._fields)]))

    def red(name):
        x = getattr(stats, name)
        axis = -2 if name in _POOL_FIELDS else -1
        return np.asarray(x.cpu(), np.float64).sum(axis=axis)

    pool_served = red("pool_served")
    pool_arrivals = red("pool_spot_arrivals")
    pool_preempted = red("pool_preempted")
    final = np.maximum(red("spot_served") + red("ondemand"), 1.0)
    out.update({
        "preemptions": pool_preempted.sum(axis=-1),
        "resumed": red("resumed"),
        "spot_cost": red("spot_cost"),
        "avg_cost_job": red("cost_sum") / final,
        "avg_delay_job": red("delay_sum") / final,
        "pool_served": pool_served,
        "pool_spot_arrivals": pool_arrivals,
        "pool_preempted": pool_preempted,
        "pool_utilization": pool_served / np.maximum(pool_arrivals, 1.0),
    })
    if telemetry is not None:
        _merge_telemetry(out, telemetry, tstats, stats.time_elapsed)
    if estats is not None:
        out.update(summarize_env(estats))
    if wstats is not None:
        out.update(summarize_survival(wstats))
    return out


def _check_loc_overrides(name: str, n_locs: int, what: str, **arrays) -> None:
    """Every per-pool override is a scalar or has a last axis of 1 or
    ``n_locs``, and holds finite, non-negative values."""
    for field, arr in arrays.items():
        if arr is None:
            continue
        a = np.asarray(arr)
        if a.ndim > 0 and a.shape[-1] not in (1, n_locs):
            raise ValueError(
                f"{name}: {field} must be scalar or have last-axis length "
                f"{n_locs} (one per {what}), got shape {a.shape}")
        if not np.all(np.isfinite(a)):
            raise ValueError(f"{name}: {field} contains non-finite values")
        if np.any(a < 0):
            raise ValueError(f"{name}: {field} must be non-negative, got min "
                             f"{a.min()}")


def _broadcast_config_params(n: int, cfg: dict, overrides: dict,
                             grid_shape: tuple) -> dict:
    """Merge config overrides into the per-pool params dict, flat
    ``(grid points, n)`` float32 numpy arrays: a scalar fills every pool, a
    ``(n,)`` vector fixes a config, a ``grid_shape + (n,)`` array sweeps
    the configuration itself."""
    cfg = dict(cfg)
    for name, val in overrides.items():
        if val is None:
            continue
        v = np.asarray(val, np.float32)
        cfg[name] = np.broadcast_to(v, (n,)) if v.ndim == 0 else v
    return {name: np.broadcast_to(v, grid_shape + (n,)).reshape(-1, n)
            for name, v in cfg.items()}


def _broadcast_market_params(market, overrides: dict,
                             grid_shape: tuple) -> dict:
    """Pools-config overrides → flat per-grid-point market params."""
    return _broadcast_config_params(market.n_pools, market.params(),
                                    overrides, grid_shape)


def _check_options(name: str, procs, telemetry, env, work, kernel,
                   shard: str = "none", mesh=None) -> None:
    """The ``telemetry=``, ``env=`` and ``work=`` types, a safety-net
    kernel without a work model, and named errors for the options the port
    does not serve yet; ``procs`` are the run's arrival processes."""
    if telemetry is not None and not isinstance(telemetry, Telemetry):
        raise TypeError(f"{name}: telemetry must be a "
                        f"repro_torch.obs.Telemetry or None, got "
                        f"{telemetry!r}")
    if env is not None and not isinstance(env, EnvTimeline):
        raise TypeError(f"{name}: env must be a "
                        f"repro_torch.core.env.EnvTimeline or None, got "
                        f"{env!r}")
    if work is not None and not isinstance(work, WorkModel):
        raise TypeError(f"{name}: work must be a "
                        f"repro_torch.core.work.WorkModel or None, got "
                        f"{work!r}")
    if work is None and getattr(kernel, "safety_net", False):
        raise ValueError(
            f"{name}: a safety-net kernel (CantBeLateKernel) tracks per-job "
            "slack and needs the work axis: pass work=WorkModel(...)")
    if shard != "none" or mesh is not None:
        raise NotImplementedError(
            f"{name}: shard={shard!r}/mesh= (lane sharding) is not ported "
            "yet (ROADMAP.md Queue 1 item 12)")
    _refuse_gamma(name, procs)


def _check_market_options(name: str, market, telemetry, env, work, kernel,
                          shard: str = "none", mesh=None) -> None:
    _check_options(name, [p.arrival for p in market.pools], telemetry, env,
                   work, kernel, shard, mesh)


def _run_market_lanes(job, market, kernel, rmax, preempt_on, plan, burn_in,
                      params, mp, k_cost, keys,
                      tel: Telemetry | None = None, ep: dict | None = None,
                      work: WorkModel | None = None, wk: dict | None = None,
                      rng: str = "slab"):
    """Flat market lanes through the executor of their device on the
    ``rng`` stream; returns
    (lanes, windows[, P]) stats (a ``(base, telemetry)`` pair with
    ``tel``, inside an ``(..., env)`` pair with ``ep`` and an outermost
    ``(..., survival)`` pair with ``work``) without the burn-in window."""
    from repro_torch.kernels.sweep import market_events

    state0 = _carry(init_market_state(keys, job, market, rmax, mp,
                                      preempt_on, ep, rng), ep, work, rmax)
    _, stats = market_events(job, market, kernel, rmax, preempt_on, state0,
                             params, mp, k_cost, plan, tel, ep, work, wk,
                             rng)
    return _without_burn_in(stats, burn_in, tel, ep is not None,
                            work is not None)


def _one_lane(params: dict, device) -> dict:
    """A single run's params as one lane: every leaf as it is given (a
    ``(P,)`` pool_logits or ``(R,)`` region_logits too) with a lane axis
    in front."""
    return {n: _one_lane(v, device) if isinstance(v, dict) else
            torch.from_numpy(np.array(v, np.float32)).to(device)[None]
            for n, v in params.items()}


def _config_tensors(cfg: dict, device) -> dict:
    """A pools or regions config dict as tensors: int32 ``rmax``, float32
    the rest."""
    return {name: torch.from_numpy(np.array(
        v, np.int32 if name == "rmax" else np.float32)).to(device)
        for name, v in cfg.items()}


def run_market_sim(job: ArrivalProcess, market, kernel, params=None, *,
                   k: float = 10.0, n_events: int, key: torch.Tensor,
                   rmax: int = 64, burn_in: int = 0,
                   chunk_events: int | None = DEFAULT_CHUNK_EVENTS,
                   impl: str | None = None, rng: str = "slab",
                   telemetry=None, env=None, work=None, device=None) -> dict:
    """Run one market policy at one parameter point; long-run stats
    (floats, and ``(P,)`` arrays for the pool fields).

    A one-lane :func:`run_market_sweep` whose lane key is ``key`` itself,
    under the market's own pools config; ``params`` leaves are taken as
    they are (a ``(P,)`` ``pool_logits`` is one lane's logits).
    ``device``, ``impl``, ``rng`` and ``telemetry`` as in :func:`run_sim`
    (the telemetry's locations are the pools).
    """
    market = as_market(market)
    params = {} if params is None else params
    _check_market_options("run_market_sim", market, telemetry, env, work,
                          kernel)
    device = _resolve(device, impl, rng, "run_market_sim", (job,))
    _check_run_shape("run_market_sim", n_events, burn_in)
    if np.ndim(k) != 0:
        raise ValueError(f"run_market_sim: k must be a scalar, got shape "
                         f"{np.shape(k)}")

    params_f = _one_lane(params, device)
    k_f = torch.full((1,), np.float32(k), device=device)
    mp = _config_tensors(_broadcast_market_params(market, {}, ()), device)
    chunk = n_events if chunk_events is None else min(chunk_events, n_events)
    plan = _window_plan(n_events, chunk, burn_in)
    ep = None if env is None else env.params(market.n_pools, device)
    wk = None if work is None else work.params(device)
    with annotate(f"repro_torch.run_market_sim[{device.type}]"):
        stats = _run_market_lanes(job, market, kernel, rmax,
                                  market.preemptible, plan, burn_in,
                                  params_f, mp, k_f, key.to(device)[None],
                                  telemetry, ep, work, wk, rng)
    out = summarize_market(_lane0(stats, telemetry, ep is not None,
                                  work is not None), telemetry, env, work)
    return {name: _scalar_or_array(v) for name, v in out.items()}


def run_market_sweep(job: ArrivalProcess, market, kernel, params=None, *,
                     k=10.0, prices=None, hazards=None, notices=None,
                     spot_scales=None, n_events: int, key: torch.Tensor,
                     n_seeds: int = 1, rmax: int = 64, burn_in: int = 0,
                     chunk_events: int | None = DEFAULT_CHUNK_EVENTS,
                     impl: str | None = None, rng: str = "slab",
                     telemetry=None, env=None, work=None,
                     shard: str = "none", mesh=None, device=None) -> dict:
    """Run a (params × k × pools-config × seeds) market grid in one executor
    call.

    ``params`` leaves and ``k`` broadcast to a grid as in
    :func:`run_sweep`; ``prices``/``hazards``/``notices``/``spot_scales``
    override the market's pools config per grid point: a scalar fills every
    pool, a ``(P,)`` vector fixes one config, a ``grid_shape + (P,)`` array
    sweeps it.  A ``hazards`` override turns the preemption path on even
    for a market without hazards.  ``device``, ``impl``, ``rng`` and
    ``telemetry`` as in :func:`run_sweep`: a GPU fleet runs the
    hand-written market kernel, a CPU fleet its plain version.  ``env`` as
    in :func:`run_sweep` (its per-loc rows are the pools') and ``work``
    as in :func:`run_sweep`; ``shard`` is not ported and raises.

    Returns :func:`summarize_market`'s dict: scalar statistics shaped
    ``grid_shape + (n_seeds,)``, pool statistics ``grid_shape + (n_seeds,
    P)``.
    """
    market = as_market(market)
    n = market.n_pools
    params = {} if params is None else params
    _check_market_options("run_market_sweep", market, telemetry, env, work,
                          kernel, shard, mesh)
    device = _resolve(device, impl, rng, "run_market_sweep", (job,))
    _check_run_shape("run_market_sweep", n_events, burn_in)
    _check_loc_overrides("run_market_sweep", n, "pool", prices=prices,
                         hazards=hazards, notices=notices,
                         spot_scales=spot_scales)
    overrides = {"price": prices, "hazard": hazards, "notice": notices,
                 "spot_scale": spot_scales}
    override_shapes = [np.shape(v)[:-1] for v in overrides.values()
                       if v is not None and np.ndim(v) > 1]
    k = np.asarray(k, np.float32)
    params_f, k_f, grid_shape = _lane_tensors(
        params, np.broadcast_to(k, np.broadcast_shapes(k.shape,
                                                       *override_shapes)),
        device)
    mp = _config_tensors(_broadcast_market_params(market, overrides,
                                                  grid_shape), device)
    preempt_on = market.preemptible or hazards is not None
    keys = threefry.split(key.to(device), n_seeds)
    params_l, k_l, keys_l = _flat_lane_args(params_f, k_f, keys)
    mp_l = _flat_lane_args(mp, k_f, keys)[0]
    chunk = n_events if chunk_events is None else min(chunk_events, n_events)
    plan = _window_plan(n_events, chunk, burn_in)
    ep = None if env is None else env.params(n, device)
    wk = None if work is None else work.params(device)
    with annotate(f"repro_torch.run_market_sweep[{device.type}]"):
        stats = _run_market_lanes(job, market, kernel, rmax, preempt_on,
                                  plan, burn_in, params_l, mp_l, k_l, keys_l,
                                  telemetry, ep, work, wk, rng)
    return _reshape_sweep(summarize_market(stats, telemetry, env, work),
                          grid_shape, n_seeds)


# ===========================================================================
# N-region routing: per-region job and spot clocks, one superposed
# preemption clock, a packed slot array with a static slot->region map
# ===========================================================================
#
# The region loop widens the market: the job clock becomes an (R,) vector
# too (a job arrives in the region whose clock fires, its *home*), and the
# single queue becomes R partitions of rmax_r slots packed as one (Σ rmax_r)
# array whose slot->region map is static (slots [offset_r, offset_r +
# rmax_r) belong to region r).  A kernel's ``route_u`` hook picks the job's
# target region; the admission law then runs against the target's queue
# length and the job joins the first free slot of the target's partition
# (a full partition rejects to on-demand even while another has room).  A
# region's spot slot serves the FIFO-oldest job of its partition; a
# revocation (the superposed clock, its region picked by thinning) hits the
# FIFO-oldest job of the revoked region's partition.  Ties resolve spot >
# preempt > deadline > job, ties between regions to the lowest index.  A
# one-region topology without a ``route`` hook reduces bitwise to the
# single queue (unit price, no hazard) or the 1-pool market.


class RegionWindowStats(NamedTuple):
    """Per-window region accumulators, one per lane: the ten
    :class:`WindowStats` fields, the market's ``resumed``/``spot_cost``,
    ``routed_home`` and five ``(lanes, R)`` counters.  ``region_jobs``
    counts arrivals by home region, ``region_routed`` admissions by target
    region."""

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
    resumed: torch.Tensor  # i32 revoked legs that checkpointed and re-queued
    spot_cost: torch.Tensor  # f32 paid to region spot, partial legs included
    routed_home: torch.Tensor  # i32 admissions whose target is the home
    region_served: torch.Tensor  # (lanes, R) i32 completions per region
    region_spot_arrivals: torch.Tensor  # (lanes, R) i32 slots per region
    region_preempted: torch.Tensor  # (lanes, R) i32 revocations per region
    region_jobs: torch.Tensor  # (lanes, R) i32 arrivals per home region
    region_routed: torch.Tensor  # (lanes, R) i32 admissions per target

    @staticmethod
    def zeros(lanes: int, n_regions: int, device) -> "RegionWindowStats":
        z = torch.zeros(lanes, dtype=torch.float32, device=device)
        zi = torch.zeros(lanes, dtype=torch.int32, device=device)
        zr = torch.zeros(lanes, n_regions, dtype=torch.int32, device=device)
        return RegionWindowStats(zi, zi, zi, zi, z, z, z, z, zi, zi, zi, z,
                                 zi, zr, zr, zr, zr, zr)


_REGION_FIELDS = frozenset({"region_served", "region_spot_arrivals",
                            "region_preempted", "region_jobs",
                            "region_routed"})
#: region statistics that count events (bitwise across executors)
REGION_INT_STATS = INT_STATS + ("resumed", "routed_home", "preemptions",
                                "spot_arrivals", "spot_found_empty") \
    + tuple(sorted(_REGION_FIELDS))


class RegionState(NamedTuple):
    """Per-lane region state; leaves lead with the lane axis (S = Σ
    rmax_r)."""

    key: torch.Tensor  # (lanes, 2) threefry key words
    next_job: torch.Tensor  # (lanes, R) per-region job clocks
    next_spot: torch.Tensor  # (lanes, R) per-region spot-slot clocks
    next_preempt: torch.Tensor  # the superposed preemption clock (INF = never)
    ages: torch.Tensor  # (lanes, S) packed slots
    budgets: torch.Tensor  # (lanes, S)
    occ: torch.Tensor  # (lanes, S) bool
    order: torch.Tensor  # (lanes, S) int32 join sequence number
    next_seq: torch.Tensor  # int32
    qlen: torch.Tensor  # (lanes, R) int32 queued jobs per region


def _slot_region_iota(topo, iota_s: torch.Tensor) -> torch.Tensor:
    """The static slot->region map: the number of partition offsets at or
    below each slot."""
    reg = torch.zeros_like(iota_s)
    for off in topo.slot_offsets()[1:]:
        reg = reg + (iota_s >= int(off)).to(iota_s.dtype)
    return reg


def init_region_state(key: torch.Tensor, topo, rp: dict,
                      preempt_on: bool, ep: dict | None = None
                      ) -> RegionState:
    """Initial state of each ``(lanes, 2)`` key under the per-lane
    regions-config ``rp`` (``(lanes, R)`` leaves).  As the JAX package's
    ``init_region_state(..., scalar_preempt=True)``: the job, spot and lane
    keys are the three subkeys of a split; the regions' job and spot clocks
    come from ``fold_in(key, tag)`` (the key itself for one region), and
    the superposed preemption clock is the least of the per-region hazard
    draws under ``fold_in(spot key, 2**31 - 1)``.  An environment timeline
    ``ep`` places the initial supply clocks under segment 0 (the job clocks
    are never modulated)."""
    ks3 = threefry.split(key, 3)
    kj, ks = ks3[:, 0], ks3[:, 1]
    lanes, device = key.shape[0], key.device
    s = topo.total_slots
    hazard0 = rp["hazard"] if ep is None else rp["hazard"] * ep["hazard"][0]
    if preempt_on:
        next_preempt = sample_hazard_clocks(
            topo.tags, threefry.fold_in(ks, 2**31 - 1),
            hazard0).min(dim=-1).values
    else:
        next_preempt = torch.full((lanes,), INF, dtype=torch.float32,
                                  device=device)
    next_spot = sample_clock_vector(tuple(r.spot for r in topo.regions),
                                    topo.tags, ks, rp["spot_scale"])
    if ep is not None:
        next_spot = next_spot * inv_avail(ep["avail"][0])
    return RegionState(
        key=ks3[:, 2],
        next_job=sample_clock_vector(tuple(r.job for r in topo.regions),
                                     topo.tags, kj, rp["job_scale"]),
        next_spot=next_spot,
        next_preempt=next_preempt,
        ages=torch.zeros(lanes, s, dtype=torch.float32, device=device),
        budgets=torch.full((lanes, s), INF, dtype=torch.float32,
                           device=device),
        occ=torch.zeros(lanes, s, dtype=torch.bool, device=device),
        order=torch.zeros(lanes, s, dtype=torch.int32, device=device),
        next_seq=torch.zeros(lanes, dtype=torch.int32, device=device),
        qlen=torch.zeros(lanes, topo.n_regions, dtype=torch.int32,
                         device=device),
    )


def _kernel_region_admit_slab(kernel, params, qlen_t, view: RegionView,
                              layout: SlabLayout, x):
    """(admit?, budget) against the target's queue length: a market
    kernel's ``admit_market_u`` sees the regions as its pools (its pool
    choice is ignored: the route decides), a single-queue kernel's
    ``admit_u`` runs as it is."""
    u = layout.uniforms(x, layout.admit)
    if layout.market_admit:
        ps = PoolState(price=view.price, hazard=view.hazard,
                       notice=view.notice, rate=view.rate,
                       qlen_pool=view.qlen_region)
        admit, budget, _pool = kernel.admit_market_u(params, qlen_t, ps, u)
        return admit, budget
    return kernel.admit_u(params, qlen_t, u)


def _kernel_route_slab(kernel, params, qlens, view: RegionView,
                       layout: SlabLayout, x):
    return kernel.route_u(params, qlens, view,
                          layout.uniforms(x, layout.route))


def _region_event(topo, kernel, preempt_on: bool, layout: SlabLayout,
                  carry: RegionState, stats: RegionWindowStats, params: dict,
                  rp: dict, k_cost: torch.Tensor, x: torch.Tensor,
                  tel: Telemetry | None = None, ep: dict | None = None,
                  work: WorkModel | None = None, wk: dict | None = None
                  ) -> tuple[RegionState, RegionWindowStats]:
    """One merged event (job arrival in some region / region spot slot /
    region preemption / wait deadline) for every lane; ``x`` is this
    event's slab row.  The JAX package's ``_region_event`` on the slab
    stream with its telemetry fold (``tel``: the stats are a ``(base,
    telemetry)`` pair) and its environment branch (``ep``, as in
    :func:`_market_event` with the regions as the locations; the job
    clocks are never modulated) and its work branch (``work``/``wk``, as
    in :func:`_market_event`; a rollback reads the region's notice)."""
    wk_c = None
    if work is not None:
        carry, wk_c = carry
        stats, wstats = stats
    if ep is not None:
        carry, env_c = carry
        stats, estats = stats
        seg = env_c.seg
        avail_row = env_row(ep["avail"], seg)
        price = rp["price"] * env_row(ep["price"], seg)
        hazard = rp["hazard"] * env_row(ep["hazard"], seg)
    else:
        price, hazard = rp["price"], rp["hazard"]
    if tel is not None:
        stats, tstats = stats
    device = carry.ages.device
    iota_s = torch.arange(topo.total_slots, device=device)
    iota_r = torch.arange(topo.n_regions, device=device)
    slot_region = _slot_region_iota(topo, iota_s)

    budgets_masked = torch.where(carry.occ, carry.budgets, INF)
    budgets_masked, armed = _panic_clock(kernel, work, wk, wk_c, carry.occ,
                                         budgets_masked)
    deadline, defect_slot = torch.min(budgets_masked, dim=1)
    min_job, home = torch.min(carry.next_job, dim=1)
    min_spot, spot_region = torch.min(carry.next_spot, dim=1)
    home = home.to(torch.int32)
    if preempt_on:
        min_pre = carry.next_preempt
        pre_region = thinning_pick(hazard,
                                   layout.uniforms(x, layout.preempt)[:, 1])
        dt = torch.minimum(torch.minimum(min_job, min_spot),
                           torch.minimum(deadline, min_pre))
        is_spot = min_spot <= torch.minimum(min_job,
                                            torch.minimum(deadline, min_pre))
        is_pre = (~is_spot) & (min_pre <= torch.minimum(min_job, deadline))
        is_deadline = (~is_spot) & (~is_pre) & (deadline <= min_job)
        is_job = (~is_spot) & (~is_pre) & (~is_deadline)
    else:
        dt = torch.minimum(torch.minimum(min_job, min_spot), deadline)
        is_spot = min_spot <= torch.minimum(min_job, deadline)
        is_pre = torch.zeros_like(is_spot)
        is_deadline = (~is_spot) & (deadline <= min_job)
        is_job = (~is_spot) & (~is_deadline)
    if ep is not None:
        is_boundary, dt, (is_spot, is_pre, is_deadline, is_job) = _boundary(
            env_c, dt, (is_spot, is_pre, is_deadline, is_job))

    ages = carry.ages + dt[:, None]
    budgets = torch.where(carry.occ, carry.budgets - dt[:, None], INF)

    # ---- job arrival in region `home`: route, then the admission law ----
    rates = rp["rate"] / rp["spot_scale"]
    if ep is not None:
        rates = rates * avail_row  # 0 marks a blacked-out region
    view = RegionView(
        home=home, price=price, hazard=hazard, notice=rp["notice"],
        rate=rates,
        job_rate=rp["job_rate"] / rp["job_scale"],
        qlen_region=carry.qlen,
        free_slots=torch.clamp_min(rp["rmax"] - carry.qlen, 0))
    if hasattr(kernel, "route"):
        target = _kernel_route_slab(kernel, params, carry.qlen, view, layout,
                                    x).to(torch.int32)
    else:
        target = home
    qlen_t = _pick(carry.qlen, target)
    rmax_t = _pick(rp["rmax"], target)
    admit_raw, budget = _kernel_region_admit_slab(kernel, params, qlen_t,
                                                  view, layout, x)
    admit = is_job & admit_raw & (qlen_t < rmax_t)
    od_now = is_job & (~admit)
    target_mask = slot_region == target[:, None]
    join_slot = torch.argmin(torch.where(target_mask,
                                         carry.occ.to(torch.int32), 2), dim=1)

    # ---- region spot slot: serve the FIFO-oldest job queued there ----
    eligible_s = carry.occ & (slot_region == spot_region[:, None])
    serve_slot = torch.argmin(torch.where(eligible_s, carry.order,
                                          _ORDER_MAX), dim=1)
    has_elig = eligible_s.any(dim=1)
    served = is_spot & has_elig
    wait_served = torch.where(iota_s == serve_slot[:, None], ages,
                              0.0).sum(1)
    price_s = _pick(price, spot_region)
    complete_serve = served
    if work is not None:
        rem_tot, ws, done_inc, ckpt_taken, complete_serve = _work_serve(
            work, wk, wk_c, served, serve_slot, iota_s)

    # ---- region preemption: revoke the FIFO-oldest job queued there ----
    no = torch.zeros_like(is_spot)
    if preempt_on:
        eligible_p = carry.occ & (slot_region == pre_region[:, None])
        pre_slot = torch.argmin(torch.where(eligible_p, carry.order,
                                            _ORDER_MAX), dim=1)
        pre_hit = is_pre & eligible_p.any(dim=1)
        age_pre = torch.where(iota_s == pre_slot[:, None], ages, 0.0).sum(1)
        # re-admission sees the region's queue without the revoked job
        qlen_wo = torch.clamp_min(_pick(carry.qlen, pre_region) - 1, 0)
        resume_raw = _kernel_on_preempt_slab(
            kernel, params, age_pre, _pick(rp["notice"], pre_region),
            qlen_wo, layout, x)
        resume = pre_hit & resume_raw
        defect_pre = pre_hit & (~resume)
        price_p = _pick(price, pre_region)
    else:
        pre_region = pre_slot = torch.zeros_like(spot_region)
        pre_hit = resume = defect_pre = no
        age_pre = price_p = torch.zeros_like(dt)
    if work is not None:
        lost = oh_inc = torch.zeros_like(dt)
        if preempt_on:
            ws, lost, oh_inc, saved = _work_rollback(
                work, wk, ws, resume, pre_slot,
                _pick(rp["notice"], pre_region), iota_s)
            ckpt_taken = ckpt_taken | saved

    # ---- deadline: the minimal-budget job defects to on-demand ----
    defected = is_deadline
    age_defect = torch.where(iota_s == defect_slot[:, None], ages,
                             0.0).sum(1)

    leave = complete_serve | defected | defect_pre
    leave_slot = torch.where(served, serve_slot,
                             torch.where(defected, defect_slot, pre_slot))
    leave_region = slot_region[leave_slot]
    join_mask = admit[:, None] & (iota_s == join_slot[:, None])
    leave_mask = leave[:, None] & (iota_s == leave_slot[:, None])
    resume_mask = resume[:, None] & (iota_s == pre_slot[:, None])
    budget = torch.as_tensor(budget, dtype=torch.float32, device=device)
    budget = budget[:, None] if budget.dim() else budget
    ages = torch.where(join_mask | resume_mask, 0.0, ages)
    budgets = torch.where(join_mask, budget,
                          torch.where(resume_mask, INF, budgets))
    occ = (carry.occ | join_mask) & (~leave_mask)
    order = torch.where(join_mask | resume_mask, carry.next_seq[:, None],
                        carry.order)
    if work is not None:
        ws = _work_join(ws, wk_c, join_mask, dt)

    fire_j = is_job[:, None] & (iota_r == home[:, None])
    fire_s = is_spot[:, None] & (iota_r == spot_region[:, None])
    # every region's draw transforms the same columns (only the firing
    # region's is kept)
    u_job = layout.uniforms(x, layout.job)
    u_spot = layout.uniforms(x, layout.spot)
    job_draws = torch.stack([r.job.sample_u(u_job) for r in topo.regions],
                            dim=-1) * rp["job_scale"]
    spot_draws = torch.stack([r.spot.sample_u(u_spot)
                              for r in topo.regions], dim=-1) \
        * rp["spot_scale"]
    next_job = torch.where(fire_j, job_draws, carry.next_job - dt[:, None])
    u_pre = layout.uniforms(x, layout.preempt)[:, 0] if preempt_on else None
    next_spot, next_preempt, seg_new = _supply_clocks(
        rp, False, is_pre, u_pre, preempt_on, spot_draws, fire_s,
        carry.next_spot, carry.next_preempt, dt, hazard,
        None if ep is None else (ep, is_boundary, seg, avail_row))

    i32 = lambda b: b.to(torch.int32)  # noqa: E731
    to_target = admit[:, None] & (iota_r == target[:, None])
    new_carry = RegionState(
        key=carry.key,  # advanced once per window by the slab generator
        next_job=next_job,
        next_spot=next_spot,
        next_preempt=next_preempt,
        ages=ages,
        budgets=budgets,
        occ=occ,
        order=order,
        next_seq=carry.next_seq + i32(admit | resume),
        qlen=carry.qlen + i32(to_target)
        - i32(leave[:, None] & (iota_r == leave_region[:, None])),
    )
    od_any = od_now | defected | defect_pre
    new_stats = RegionWindowStats(
        jobs_arrived=stats.jobs_arrived + i32(is_job),
        jobs_completed=stats.jobs_completed + i32(od_any | served | resume),
        spot_served=stats.spot_served + i32(served),
        ondemand=stats.ondemand + i32(od_any),
        cost_sum=stats.cost_sum + torch.where(served, price_s, 0.0)
        + torch.where(od_any, k_cost, 0.0)
        + torch.where(pre_hit, price_p, 0.0),
        delay_sum=stats.delay_sum + torch.where(served, wait_served, 0.0)
        + torch.where(defected, age_defect, 0.0)
        + torch.where(pre_hit, age_pre, 0.0),
        time_elapsed=stats.time_elapsed + dt,
        empty_time=stats.empty_time
        + torch.where(carry.qlen.sum(dim=1) == 0, dt, 0.0),
        spot_arrivals=stats.spot_arrivals + i32(is_spot),
        spot_found_empty=stats.spot_found_empty + i32(is_spot & (~has_elig)),
        resumed=stats.resumed + i32(resume),
        spot_cost=stats.spot_cost + torch.where(served, price_s, 0.0)
        + torch.where(pre_hit, price_p, 0.0),
        routed_home=stats.routed_home + i32(admit & (target == home)),
        region_served=stats.region_served + i32(fire_s & served[:, None]),
        region_spot_arrivals=stats.region_spot_arrivals + i32(fire_s),
        region_preempted=stats.region_preempted
        + i32(pre_hit[:, None] & (iota_r == pre_region[:, None])),
        region_jobs=stats.region_jobs + i32(fire_j),
        region_routed=stats.region_routed + i32(to_target),
    )
    out_stats = new_stats
    if tel is not None:
        # a job event's loc is its target region, a deadline's the region
        # of the defecting job's slot
        loc = torch.where(is_spot, spot_region, torch.where(
            is_pre, pre_region, torch.where(is_deadline,
                                            slot_region[defect_slot],
                                            target)))
        tstats = telemetry_update(
            tel, tstats, t=new_stats.time_elapsed, is_job=is_job,
            is_spot=is_spot, is_pre=is_pre, is_deadline=is_deadline,
            served=served, resume=resume, defected=defected, od_now=od_now,
            wait_sample=torch.where(served, wait_served,
                                    torch.where(defected, age_defect,
                                                age_pre)),
            wait_valid=served | defected | pre_hit,
            cost_inc=torch.where(served, price_s, 0.0)
            + torch.where(od_any, k_cost, 0.0)
            + torch.where(pre_hit, price_p, 0.0),
            cost_valid=served | od_now | defected | pre_hit,
            loc=loc, n_locs=topo.n_regions, qlen=new_carry.qlen.sum(dim=1))
        out_stats = (new_stats, tstats)
    out_carry = new_carry
    if ep is not None:
        estats, new_env = _env_step(ep, env_c, estats, is_boundary, seg,
                                    seg_new, dt, is_job, od_now, served,
                                    resume)
        out_carry, out_stats = (new_carry, new_env), (out_stats, estats)
    if work is None:
        return out_carry, out_stats
    wstats = _work_ledger(
        wk, wstats, wk_c, rem_tot, dt, iota_s, is_job=is_job, od_now=od_now,
        complete_serve=complete_serve, defected=defected,
        defect_pre=defect_pre, serve_slot=serve_slot,
        defect_slot=defect_slot, pre_slot=pre_slot, armed=armed,
        ckpt_taken=ckpt_taken, done_inc=done_inc, lost=lost, oh_inc=oh_inc)
    return (out_carry, ws), (out_stats, wstats)


def _region_layout(topo, kernel, preempt_on: bool) -> SlabLayout:
    """Slab column map for the region loop: the job and spot spans are the
    largest ``u_dim`` across the regions (every region transforms the same
    uniforms)."""
    layout = build_slab_layout(
        kernel, job_udim=max(process_udim(r.job) for r in topo.regions),
        spot_udim=max(process_udim(r.spot) for r in topo.regions),
        n=topo.n_regions, preempt_on=preempt_on,
        has_route=hasattr(kernel, "route"), market=True)
    if "key" in (layout.admit_mode, layout.on_preempt_mode,
                 layout.route_mode):
        raise NotImplementedError(
            f"{kernel!r} has no slab hook for its admission, revocation or "
            "routing (*_u with slab_cols); kernels without one need the "
            "split stream, which is not ported yet for the regions "
            "(ROADMAP.md Queue 1 item 7)")
    return layout


def summarize_region(stats: RegionWindowStats,
                     telemetry: Telemetry | None = None,
                     env: EnvTimeline | None = None,
                     work: WorkModel | None = None) -> dict:
    """:func:`summarize`'s dict plus the region's: preemptions, resumed
    legs, spot spend, per-job averages over final completions, the routing
    flow (``routed_home``, ``cross_region_frac``: the share of admissions
    sent away from home) and per-region arrays (a trailing region axis).
    Scalar fields reduce the last (window) axis, region fields the one
    before it.  With ``telemetry``, ``stats`` is the ``(base, telemetry)``
    pair and the telemetry keys are appended; with ``env`` the env block
    rides around them and the shock counters are appended; with ``work``
    the survival ledger rides outermost of all and its job-level keys are
    appended."""
    wstats = None
    if work is not None:
        stats, wstats = stats
    estats = None
    if env is not None:
        stats, estats = stats
    tstats = None
    if telemetry is not None:
        stats, tstats = stats
    out = summarize(WindowStats(*stats[:len(WindowStats._fields)]))

    def red(name):
        x = getattr(stats, name)
        axis = -2 if name in _REGION_FIELDS else -1
        return np.asarray(x.cpu(), np.float64).sum(axis=axis)

    routed_home = red("routed_home")
    region_served = red("region_served")
    region_arrivals = red("region_spot_arrivals")
    region_preempted = red("region_preempted")
    region_routed = red("region_routed")
    final = np.maximum(red("spot_served") + red("ondemand"), 1.0)
    admitted = region_routed.sum(axis=-1)
    cross = np.where(admitted > 0,
                     1.0 - routed_home / np.maximum(admitted, 1.0), 0.0)
    out.update({
        "preemptions": region_preempted.sum(axis=-1),
        "resumed": red("resumed"),
        "spot_cost": red("spot_cost"),
        "avg_cost_job": red("cost_sum") / final,
        "avg_delay_job": red("delay_sum") / final,
        "routed_home": routed_home,
        "cross_region_frac": cross,
        "region_served": region_served,
        "region_spot_arrivals": region_arrivals,
        "region_preempted": region_preempted,
        "region_jobs": red("region_jobs"),
        "region_routed": region_routed,
        "region_utilization": region_served / np.maximum(region_arrivals,
                                                         1.0),
    })
    if telemetry is not None:
        _merge_telemetry(out, telemetry, tstats, stats.time_elapsed)
    if estats is not None:
        out.update(summarize_env(estats))
    if wstats is not None:
        out.update(summarize_survival(wstats))
    return out


def _run_region_lanes(topo, kernel, preempt_on, plan, burn_in, params, rp,
                      k_cost, keys, tel: Telemetry | None = None,
                      ep: dict | None = None, work: WorkModel | None = None,
                      wk: dict | None = None):
    """Flat region lanes through the executor of their device; returns
    (lanes, windows[, R]) stats (a ``(base, telemetry)`` pair with
    ``tel``, inside an ``(..., env)`` pair with ``ep`` and an outermost
    ``(..., survival)`` pair with ``work``) without the burn-in window."""
    from repro_torch.kernels.sweep import region_events

    state0 = _carry(init_region_state(keys, topo, rp, preempt_on, ep), ep,
                    work, topo.total_slots)
    _, stats = region_events(topo, kernel, preempt_on, state0, params, rp,
                             k_cost, plan, tel, ep, work, wk)
    return _without_burn_in(stats, burn_in, tel, ep is not None,
                            work is not None)


def _check_region_run(name: str, topo, kernel, telemetry, env, work, shard,
                      mesh, device, impl, rng, n_events, burn_in):
    """The options checks of the two region entry points; returns the
    device."""
    _check_options(name, [p for r in topo.regions for p in (r.job, r.spot)],
                   telemetry, env, work, kernel, shard, mesh)
    device = _resolve(device, impl, rng, name, split=False)
    _check_run_shape(name, n_events, burn_in)
    return device


def run_region_sim(topology, kernel, params=None, *, k: float = 10.0,
                   n_events: int, key: torch.Tensor, burn_in: int = 0,
                   chunk_events: int | None = DEFAULT_CHUNK_EVENTS,
                   impl: str | None = None, rng: str = "slab",
                   telemetry=None, env=None, work=None, device=None) -> dict:
    """Run one routing policy on one topology; long-run stats (floats, and
    ``(R,)`` arrays for the region fields).

    A one-lane :func:`run_region_sweep` whose lane key is ``key`` itself,
    under the topology's own regions config; ``params`` leaves are taken
    as they are (a ``(R,)`` ``region_logits`` is one lane's logits).
    A degenerate topology with a kernel without ``route`` reproduces
    :func:`run_sim` bitwise.  ``device``, ``impl``, ``rng`` and
    ``telemetry`` as in :func:`run_sim` (the telemetry's locations are the
    regions).
    """
    topology = as_topology(topology)
    params = {} if params is None else params
    device = _check_region_run("run_region_sim", topology, kernel,
                               telemetry, env, work, "none", None, device,
                               impl, rng, n_events, burn_in)
    if np.ndim(k) != 0:
        raise ValueError(f"run_region_sim: k must be a scalar, got shape "
                         f"{np.shape(k)}")

    rp = _config_tensors(_broadcast_config_params(
        topology.n_regions, topology.params(), {}, ()), device)
    chunk = n_events if chunk_events is None else min(chunk_events, n_events)
    plan = _window_plan(n_events, chunk, burn_in)
    ep = None if env is None else env.params(topology.n_regions, device)
    wk = None if work is None else work.params(device)
    with annotate(f"repro_torch.run_region_sim[{device.type}]"):
        stats = _run_region_lanes(
            topology, kernel, topology.preemptible, plan, burn_in,
            _one_lane(params, device), rp,
            torch.full((1,), np.float32(k), device=device),
            key.to(device)[None], telemetry, ep, work, wk)
    out = summarize_region(_lane0(stats, telemetry, ep is not None,
                                  work is not None), telemetry, env, work)
    return {name: _scalar_or_array(v) for name, v in out.items()}


def run_region_sweep(topology, kernel, params=None, *, k=10.0,
                     vector_params=None, prices=None, hazards=None,
                     notices=None, spot_scales=None, job_scales=None,
                     n_events: int, key: torch.Tensor, n_seeds: int = 1,
                     burn_in: int = 0,
                     chunk_events: int | None = DEFAULT_CHUNK_EVENTS,
                     impl: str | None = None, rng: str = "slab",
                     telemetry=None, env=None, work=None,
                     shard: str = "none", mesh=None, device=None) -> dict:
    """Run a (params × k × regions-config × seeds) region grid in one
    executor call.

    ``params`` leaves and ``k`` broadcast to a grid as in
    :func:`run_sweep`.  ``vector_params`` holds kernel params whose last
    axis is carried into every grid point: an ``(m,)`` leaf fixes one
    vector, a ``grid_shape + (m,)`` leaf sweeps it (``{"region_logits":
    logits}`` for the weighted rule).  ``prices``/``hazards``/``notices``/
    ``spot_scales``/``job_scales`` override the topology's regions config
    per grid point: a scalar fills every region, an ``(R,)`` vector fixes
    one config, a ``grid_shape + (R,)`` array sweeps it.  A ``hazards``
    override turns the preemption path on.  ``device``, ``impl``, ``rng``
    and ``telemetry`` as in :func:`run_sweep`: a GPU fleet runs the
    hand-written region kernel, a CPU fleet its plain version.  ``env`` as
    in :func:`run_sweep` (its per-loc rows are the regions') and
    ``work`` as in :func:`run_sweep`; ``shard`` is not ported and raises.

    Returns :func:`summarize_region`'s dict: scalar statistics shaped
    ``grid_shape + (n_seeds,)``, region statistics ``grid_shape +
    (n_seeds, R)``.
    """
    topology = as_topology(topology)
    n = topology.n_regions
    params = {} if params is None else params
    device = _check_region_run("run_region_sweep", topology, kernel,
                               telemetry, env, work, shard, mesh, device,
                               impl, rng, n_events, burn_in)
    _check_loc_overrides("run_region_sweep", n, "region", prices=prices,
                         hazards=hazards, notices=notices,
                         spot_scales=spot_scales, job_scales=job_scales)
    overrides = {"price": prices, "hazard": hazards, "notice": notices,
                 "spot_scale": spot_scales, "job_scale": job_scales}
    vparams = {name: np.asarray(v, np.float32)
               for name, v in (vector_params or {}).items()}
    carried = [np.shape(v)[:-1] for v in overrides.values()
               if v is not None and np.ndim(v) > 1]
    carried += [v.shape[:-1] for v in vparams.values()]
    k = np.asarray(k, np.float32)
    params_f, k_f, grid_shape = _lane_tensors(
        params, np.broadcast_to(k, np.broadcast_shapes(k.shape, *carried)),
        device)
    for name, v in vparams.items():
        v = np.broadcast_to(v, grid_shape + v.shape[-1:])
        params_f[name] = torch.from_numpy(
            v.reshape(-1, v.shape[-1]).copy()).to(device)
    rp = _config_tensors(_broadcast_config_params(
        n, topology.params(), overrides, grid_shape), device)
    preempt_on = topology.preemptible or hazards is not None
    keys = threefry.split(key.to(device), n_seeds)
    params_l, k_l, keys_l = _flat_lane_args(params_f, k_f, keys)
    rp_l = _flat_lane_args(rp, k_f, keys)[0]
    chunk = n_events if chunk_events is None else min(chunk_events, n_events)
    plan = _window_plan(n_events, chunk, burn_in)
    ep = None if env is None else env.params(n, device)
    wk = None if work is None else work.params(device)
    with annotate(f"repro_torch.run_region_sweep[{device.type}]"):
        stats = _run_region_lanes(topology, kernel, preempt_on, plan,
                                  burn_in, params_l, rp_l, k_l, keys_l,
                                  telemetry, ep, work, wk)
    return _reshape_sweep(summarize_region(stats, telemetry, env, work),
                          grid_shape, n_seeds)
