"""ctypes wrappers of the hand-written CUDA batched-event kernels (csrc/sweep.cu).

Three traversals of one kernel family: :func:`batched_event_windows` runs
the single queue, :func:`market_event_windows` the P-pool spot market,
:func:`region_event_windows` N-region routing.  Each
runs a fleet of lanes through a static plan of
event windows (burn-in, chunks, tail), each lane on a group of G threads
(:func:`group_size` picks G from rmax), with the lane state in registers
across all windows and the slab's random bits drawn in the kernel from
each window's key, a few events ahead.  The wrapper computes those keys
with the torch threefry (:func:`~repro_torch.core.clocks.window_slab_keys`),
turns the arrival, policy and wait descriptors into integer codes and
float32 constants, checks every tensor, allocates the outputs and launches
on the current stream.  The library is built with ``nvcc`` from the
repository's source at first use (:mod:`repro_torch.kernels._build`).

With a :class:`~repro_torch.obs.Telemetry` (``tel=``) each wrapper
launches the kernel's telemetry instantiation instead, from a second
library built from the same source (``TEL_LIBRARY``), and returns the
``(base, telemetry)`` pair; ``tel=None`` launches the instantiation
without the fold.  With an environment timeline (``ep=``, from
:meth:`~repro_torch.core.env.EnvTimeline.params`; the state then an
``(engine state, EnvState)`` pair) each wrapper launches the kernel's env
instantiation (``ENV_LIBRARY``, or ``TEL_ENV_LIBRARY`` with both axes) and
returns the state and the stats in env pairs.  A ``PanicKernel`` repairs
choices against dead locations, which only the env build holds: a market
or region run of one without a timeline where a location's rate is 0
launches that build under the constant timeline and drops its counters;
with every rate > 0 nothing is ever dead and the build without the env
state runs.  With a work model (``work=``, a
:class:`~repro_torch.core.work.WorkModel`; the state then wrapped
outermost in a ``(..., WorkState)`` pair) each wrapper launches the
kernel's work instantiation (``WORK_LIBRARY`` and its telemetry and env
twins) and returns the final work state and the survival ledger in work
pairs, outermost; a :class:`~repro_torch.core.work.CantBeLateKernel` is
unwrapped to its base, its safety net and slack buffer passed to the
kernel as run constants.

On the split stream (``rng="split"``, the single queue and the market) the
wrapper passes each lane's key instead of the window keys: the kernel walks
the per-event key ladder itself and returns the final lane keys.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.arrivals import (BathtubGCP, Deterministic, Exponential,
                                       Gamma, Uniform)
from repro_torch.core.clocks import kernel_slab_cols, window_slab_keys
from repro_torch.core.threefry import MASK
from repro_torch.core.engine import (EngineState, MarketState,
                                     MarketWindowStats, RegionState,
                                     RegionWindowStats, WindowStats,
                                     _engine_layout, _market_layout,
                                     _refuse_gamma, _region_layout)
from repro_torch.core.env import EnvState, EnvTimeline, init_env_state
from repro_torch.core.work import WorkState, peel_safety_net
from repro_torch.core.market import (NoticeAwareKernel, PanicKernel,
                                     PoolChoiceKernel, peel_panic)
from repro_torch.core.regions import RoutingKernel
from repro_torch.core.policies import SingleSlotKernel, ThreePhaseKernel
from repro_torch.core.waittime import (DeterministicWait, ExponentialWait,
                                       InfiniteWait, TwoPointWait)
from repro_torch.kernels._build import KernelLibrary, load
from repro_torch.obs.shocks import EnvWindowStats
from repro_torch.obs.stats import (Telemetry, TelemetryWindowStats,
                                   bin_constants)
from repro_torch.obs.survival import SurvivalWindowStats

_SOURCE = Path(__file__).resolve().parent / "csrc" / "sweep.cu"
#: the kernels without the telemetry fold (``tel=None``)
LIBRARY = KernelLibrary("sweep", _SOURCE, ("--fmad=false",))
#: the same source's telemetry instantiations (``tel=``)
TEL_LIBRARY = KernelLibrary("sweep_tel", _SOURCE,
                            ("--fmad=false", "-DSWEEP_TELEMETRY"))
#: ... its environment-timeline instantiations (``ep=``)
ENV_LIBRARY = KernelLibrary("sweep_env", _SOURCE,
                            ("--fmad=false", "-DSWEEP_ENV"))
#: ... and those with both axes
TEL_ENV_LIBRARY = KernelLibrary(
    "sweep_tel_env", _SOURCE,
    ("--fmad=false", "-DSWEEP_TELEMETRY", "-DSWEEP_ENV"))
#: ... the work-structure instantiations (``work=``), alone and with the
#: other axes
WORK_LIBRARY = KernelLibrary("sweep_work", _SOURCE,
                             ("--fmad=false", "-DSWEEP_WORK"))
TEL_WORK_LIBRARY = KernelLibrary(
    "sweep_tel_work", _SOURCE,
    ("--fmad=false", "-DSWEEP_TELEMETRY", "-DSWEEP_WORK"))
ENV_WORK_LIBRARY = KernelLibrary(
    "sweep_env_work", _SOURCE, ("--fmad=false", "-DSWEEP_ENV", "-DSWEEP_WORK"))
TEL_ENV_WORK_LIBRARY = KernelLibrary(
    "sweep_tel_env_work", _SOURCE,
    ("--fmad=false", "-DSWEEP_TELEMETRY", "-DSWEEP_ENV", "-DSWEEP_WORK"))
#: the eight builds, by (telemetry?, env?, work?)
LIBRARIES = {(False, False, False): LIBRARY,
             (True, False, False): TEL_LIBRARY,
             (False, True, False): ENV_LIBRARY,
             (True, True, False): TEL_ENV_LIBRARY,
             (False, False, True): WORK_LIBRARY,
             (True, False, True): TEL_WORK_LIBRARY,
             (False, True, True): ENV_WORK_LIBRARY,
             (True, True, True): TEL_ENV_WORK_LIBRARY}

#: slots a lane can hold: 32 threads of 8 slots, or 16 of 16
MAX_RMAX = 256
#: slab columns an event can take (a draw pass stages 64 words a lane)
MAX_COLS = 32
#: histogram bins a lane's telemetry slice holds in shared memory (the
#: kernel's kMaxBins; 2 × 256 int32 a lane)
MAX_BINS = 256
#: pools a market lane and regions a region lane can hold (the kernel's
#: kMaxPools and kMaxRegions)
MAX_POOLS = MAX_REGIONS = 8
#: the choice of G, from a probe of G against time on an H100 (PERF.md) at
#: the two rmax the main paths run: G at rmax 1 (4 beat 1, 2 and 8), and
#: the slots a thread G grows to keep at larger rmax (G 8 at rmax 64 beat
#: 4, 16 and 32); the picks at other rmax follow the rule, not a
#: measurement.  The kernel is built for these picks only.
SMALL_GROUP, SLOTS_A_THREAD = 4, 8


@functools.cache
def _library(tel: bool = False, env: bool = False,
             work: bool = False) -> ctypes.CDLL:
    """The kernel library of the telemetry, env and work instantiations
    asked for (each on or off)."""
    lib = load(LIBRARIES[tel, env, work])
    for fn in (lib.sweep_launch, lib.market_launch, lib.region_launch):
        fn.argtypes = [ctypes.c_void_p] * 12
        fn.restype = ctypes.c_int
    lib.sweep_error_string.argtypes = [ctypes.c_int]
    lib.sweep_error_string.restype = ctypes.c_char_p
    return lib


class TelemetryTooWideError(ValueError):
    """A Telemetry of more bins than a lane's shared-memory slice holds
    (MAX_BINS), or of fewer than three."""


def _telemetry_outputs(tel: Telemetry | None, n_locs: int, lanes: int,
                       w: int, device):
    """(outputs, pointers, int config, float config) of the telemetry
    arguments the kernel reads (``tel_args`` in csrc/sweep.cu), or
    ``(None, None, None, None)`` without the axis.  The outputs are the
    stacked ``(lanes, W, ...)`` TelemetryWindowStats; the rings start at
    zero (an unwritten slot is never exported)."""
    if tel is None:
        return None, None, None, None
    if not isinstance(tel, Telemetry):
        raise TypeError(f"sweep kernel: tel must be a "
                        f"repro_torch.obs.Telemetry, got {tel!r}")
    if not 3 <= tel.n_bins <= MAX_BINS:
        raise TelemetryTooWideError(
            f"sweep kernel: a Telemetry of {tel.n_bins} bins; the kernel "
            f"holds 3 to {MAX_BINS}")
    i32, f32 = torch.int32, torch.float32

    def empty(*shape, dtype=i32):
        return torch.empty((lanes, w) + shape, dtype=dtype, device=device)

    cap = tel.trace_cap
    ring = (None,) * 6
    if cap:
        ring = tuple(torch.zeros(lanes, w, cap, dtype=dtype, device=device)
                     for dtype in (f32, i32, i32, i32, f32)) + (
                         torch.zeros(lanes, w, dtype=i32, device=device),)
    counters = torch.empty(5, lanes, w, dtype=i32, device=device)
    out = TelemetryWindowStats(empty(tel.n_bins), empty(tel.n_bins),
                               empty(4), *counters, empty(n_locs),
                               empty(n_locs), *ring)
    ptrs = np.array([0 if x is None else x.data_ptr()
                     for x in out[:3] + (counters,) + out[8:]], np.int64)
    icfg = np.array([tel.n_bins, n_locs, cap], np.int32)
    fcfg = np.array(bin_constants(tel.wait_lo, tel.wait_hi, tel.n_bins)
                    + bin_constants(tel.cost_lo, tel.cost_hi, tel.n_bins),
                    np.float32)
    return out, ptrs, icfg, fcfg


def _env_outputs(ep: dict | None, es: EnvState | None, n_locs: int,
                 lanes: int, w: int, device, panic=(0, 0, 0)):
    """(outputs, pointers, int config) of the environment arguments the
    kernel reads (``env_args`` in csrc/sweep.cu), or ``(None, None, None)``
    without the axis.  The outputs are the final EnvState and the stacked
    ``(lanes, W)`` EnvWindowStats; ``panic`` the PanicKernel flags
    (admission gate, choice failover, drain)."""
    if ep is None:
        return None, None, None
    f32, i32 = torch.float32, torch.int32
    s = ep["t_end"].shape[0]
    for name, x, dtype, shape in (
            ("t_end", ep["t_end"], f32, (s,)), ("kind", ep["kind"], i32, (s,)),
            ("price", ep["price"], f32, (s, n_locs)),
            ("hazard", ep["hazard"], f32, (s, n_locs)),
            ("avail", ep["avail"], f32, (s, n_locs)),
            ("next_boundary", es.next_boundary, f32, (lanes,)),
            ("seg", es.seg, i32, (lanes,))):
        _check(f"env {name}", x, dtype, shape)
    if bool(((es.seg < 0) | (es.seg >= s)).any()):
        raise ValueError(f"sweep kernel: a lane's segment lies outside the "
                         f"timeline's {s}")
    es_out = EnvState(next_boundary=torch.empty(lanes, dtype=f32,
                                                device=device),
                      seg=torch.empty(lanes, dtype=i32, device=device))
    istats = torch.empty(8, lanes, w, dtype=i32, device=device)
    fstats = torch.empty(2, lanes, w, dtype=f32, device=device)
    ptrs = np.array([x.data_ptr() for x in (
        ep["t_end"], ep["kind"], ep["price"], ep["hazard"], ep["avail"],
        es.next_boundary, es.seg, *es_out, istats, fstats)], np.int64)
    icfg = np.array([s, n_locs, *panic], np.int32)
    return (es_out, EnvWindowStats(*istats, *fstats)), ptrs, icfg


_CKPT_CODES = {"never": 0, "notice": 1, "periodic": 2}


def _work_outputs(work, ws: WorkState | None, n_slots: int, lanes: int,
                  w: int, device, safety: tuple[bool, float]):
    """(outputs, pointers, int config, float config) of the work arguments
    the kernel reads (``work_args`` in csrc/sweep.cu), or ``(None, None,
    None, None)`` without the axis.  The outputs are the final WorkState
    and the stacked ``(lanes, W)`` SurvivalWindowStats; ``safety`` the
    CantBeLateKernel's (safety net?, slack buffer)."""
    if work is None:
        if safety[0]:
            raise ValueError("sweep kernel: a safety-net kernel "
                             "(CantBeLateKernel) needs work=WorkModel(...)")
        return None, None, None, None
    f32 = torch.float32
    for name, x in zip(WorkState._fields, ws):
        _check(f"work {name}", x, f32, (lanes, n_slots))
    ws_out = WorkState(*(torch.empty(lanes, n_slots, dtype=f32,
                                     device=device) for _ in ws))
    istats = torch.empty(6, lanes, w, dtype=torch.int32, device=device)
    fstats = torch.empty(4, lanes, w, dtype=f32, device=device)
    ptrs = np.array([x.data_ptr() for x in (*ws, *ws_out, istats, fstats)],
                    np.int64)
    icfg = np.array([_CKPT_CODES[work.ckpt], int(safety[0])], np.int32)
    fcfg = np.array([v.item() for v in work.params().values()]
                    + [safety[1]], np.float32)
    return (ws_out, SurvivalWindowStats(*istats, *fstats)), ptrs, icfg, fcfg


def _unpack(state, ep, work):
    """``(engine state, EnvState or None, WorkState or None)`` of a carry
    (the work pair outermost, the env pair inside it)."""
    es = ws = None
    if work is not None:
        state, ws = state
    if ep is not None:
        state, es = state
    return state, es, ws


def _with_pairs(out, stats, env_out, keep: bool = True, work_out=None):
    """The wrapper's return: ``(state, stats)``, in env pairs where the
    axis is on (``keep``: the caller passed a timeline), then in work pairs
    where that axis is."""
    if env_out is not None and keep:
        es_out, estats = env_out
        out, stats = (out, es_out), (stats, estats)
    if work_out is not None:
        ws_out, wstats = work_out
        out, stats = (out, ws_out), (stats, wstats)
    return out, stats


def _launch(fn_name: str, what: str, tel, ptrs, icfg, fcfg, tel_args,
            env_args, work_args, device) -> None:
    """Launch ``fn_name`` of the library on the current stream; raises on
    an error (never falls back)."""
    lib = _library(tel is not None, env_args[0] is not None,
                   work_args[0] is not None)
    tptrs, ticfg, tfcfg = (None if x is None else x.ctypes.data
                           for x in tel_args)
    eptrs, eicfg = (None if x is None else x.ctypes.data for x in env_args)
    wptrs, wicfg, wfcfg = (None if x is None else x.ctypes.data
                           for x in work_args)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn_name)(ptrs.ctypes.data, icfg.ctypes.data,
                                   fcfg.ctypes.data, tptrs, ticfg, tfcfg,
                                   eptrs, eicfg, wptrs, wicfg, wfcfg, stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.sweep_error_string(rc).decode()}")


def _arrival(proc) -> tuple[int, list[float], int]:
    """(code, four float32 constants, columns) of an arrival process, in
    the form ``sample_arrival`` in csrc/sweep.cu reads it (and
    ``keyed_arrivals``: a uniform's float32 width third)."""
    if isinstance(proc, Exponential):
        return 0, [1 / np.float32(proc.rate_)], 1
    if isinstance(proc, Gamma) and proc.u_dim is not None:
        return 1, [proc.scale], proc.u_dim
    if isinstance(proc, Uniform):
        return 2, [proc.low, proc.high - proc.low,
                   np.float32(proc.high) - np.float32(proc.low)], 1
    if isinstance(proc, Deterministic):
        return 3, [proc.value], 0
    if isinstance(proc, BathtubGCP):
        return 4, [proc.A, proc.tau1, proc.tau2, proc.b], 3
    raise NotImplementedError(f"the sweep kernel has no sampler for {proc!r}")


def _arrivals(procs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes, columns, (MAX_POOLS, 4) float32 constants) of up to
    MAX_POOLS arrival processes (a market's pools, a topology's regions)."""
    codes = np.zeros(MAX_POOLS, np.int32)
    ns = np.zeros(MAX_POOLS, np.int32)
    consts = np.zeros((MAX_POOLS, 4), np.float32)
    for r, proc in enumerate(procs):
        code, c, n = _arrival(proc)
        codes[r], ns[r] = code, n
        consts[r, :len(c)] = c
    return codes, ns, consts


_WAIT_CODES = {InfiniteWait: (0, ()), TwoPointWait: (1, ("p", "value")),
               ExponentialWait: (2, ("rate",)),
               DeterministicWait: (3, ("value",))}
#: an exponential wait at the family's own rate: a product with the float32
#: reciprocal (``ExponentialWait.sample``, ``ExponentialWait.sample_u``)
_FIXED_EXPONENTIAL_WAIT = 4


class NoKernelPolicyError(NotImplementedError):
    """A policy kernel the CUDA kernel holds no code for (a user's kernel
    runs on the CPU plain version only)."""


def _policy(kernel, params: dict, lanes: int, device):
    """(policy code, wait code, pa, pb): the kernel's per-lane params as
    the two float32 arrays the CUDA kernel reads (a ``PanicKernel`` admits
    as its base).  A single-slot kernel whose params hold no ``"wait"`` (an
    unswept wait) samples at its family's constants, on either stream, as
    the plain version does."""
    kernel = peel_panic(kernel)
    zero = torch.zeros(lanes, dtype=torch.float32, device=device)
    if isinstance(kernel, ThreePhaseKernel):
        return 0, 0, params["r"], zero
    if isinstance(kernel, SingleSlotKernel) and type(kernel.wait) in _WAIT_CODES:
        code, names = _WAIT_CODES[type(kernel.wait)]
        if "wait" in params:
            cols = [params["wait"][n] for n in names] + [zero, zero]
            return 1, code, cols[0], cols[1]
        own = kernel.wait.params()
        if isinstance(kernel.wait, ExponentialWait):
            code, own = _FIXED_EXPONENTIAL_WAIT, {
                "rate": 1 / np.float32(kernel.wait.rate_)}
        cols = [torch.full((lanes,), np.float32(own[n]), device=device)
                for n in names] + [zero, zero]
        return 1, code, cols[0], cols[1]
    raise NoKernelPolicyError(
        f"the sweep kernel has no policy {kernel!r}: a kernel with only "
        "keyed hooks runs on the CPU plain version (device='cpu'), and on "
        "a CUDA device it is refused, not run elsewhere")


def _check(name: str, x: torch.Tensor, dtype, shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"sweep kernel: {name} must be a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"sweep kernel: {name} must be {dtype} of shape "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"sweep kernel: {name} must be contiguous")


def slots_per_thread(rmax: int, group: int) -> int:
    """Slots each of a lane's ``group`` threads holds: the power of two
    that covers rmax."""
    spt = 1
    while spt * group < rmax:
        spt *= 2
    return spt


def group_size(rmax: int) -> int:
    """Threads a lane runs on: ``SMALL_GROUP`` where that holds rmax in
    ``SLOTS_A_THREAD`` slots a thread, else the power of two that does (at
    most 32)."""
    if not 1 <= rmax <= MAX_RMAX:
        raise ValueError(f"sweep kernel: rmax must be in [1, {MAX_RMAX}], "
                         f"got {rmax}")
    g = SMALL_GROUP
    while g < 32 and g * SLOTS_A_THREAD < rmax:
        g *= 2
    return g


def warps_per_block(lanes: int, group: int, sms: int) -> int:
    """Warps a block: the largest power of two, at most 4, that still
    leaves a block for every one of the card's ``sms`` SMs, so the warps
    spread evenly."""
    warps = -(-lanes * group // 32)
    wpb = 1
    while wpb < 4 and 2 * wpb * sms <= warps:
        wpb *= 2
    return wpb


def _as_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 tensor of 32-bit words -> the same bits as int32."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def batched_event_windows(job, spot, kernel, rmax: int, state: EngineState,
                          params: dict, k_cost: torch.Tensor,
                          plan: tuple[int, ...], tel: Telemetry | None = None,
                          ep: dict | None = None, work=None, wk=None,
                          rng: str = "slab"
                          ) -> tuple[EngineState, WindowStats]:
    """Run every lane through the windows of ``plan`` in one kernel launch.

    Same contract as :func:`repro_torch.kernels.sweep.ref.batched_event_windows_ref`:
    ``state`` holds ``(lanes, ...)`` CUDA tensors, ``params`` the kernel's
    per-lane float32 params, ``k_cost`` the per-lane on-demand price.
    A lane runs on :func:`group_size` threads.
    Returns ``(final_state, stats)`` with stats leaves ``(lanes, W)`` (with
    ``tel`` a ``(base, telemetry)`` pair; with ``ep`` the state and the
    stats in env pairs, with ``work`` in work pairs outermost; ``wk``, the
    work model's device params, is the plain version's and unused here).
    In the single queue a slot's life is its age: the kernel keeps one
    array, and the initial work state's ``life`` must equal ``ages``.
    ``rng="split"`` runs the split stream: the kernel walks each lane's key
    ladder, one step an event, and the final state holds the lane keys it
    reached.  Raises if the kernel cannot be built or launched, or holds no
    code for the policy (:class:`NoKernelPolicyError`); it never falls
    back.
    """
    kernel, *safety = peel_safety_net(kernel)
    split = rng == "split"
    layout = _engine_layout(job, spot, kernel, rng)
    state, es, ws = _unpack(state, ep, work)
    lanes, device = state.key.shape[0], state.key.device
    if lanes == 0 or not 1 <= rmax <= MAX_RMAX:
        raise ValueError(f"sweep kernel: need lanes >= 1 and 1 <= rmax <= "
                         f"{MAX_RMAX}, got {lanes} lanes, rmax {rmax}")
    n_cols = 0 if split else layout.n_cols
    if n_cols > MAX_COLS:
        raise ValueError(f"sweep kernel: a slab row of {n_cols} "
                         f"columns exceeds {MAX_COLS}")
    group = group_size(rmax)
    if max(plan) * n_cols >= 2**32:
        raise ValueError("sweep kernel: a window's slab index must fit in "
                         "32 bits")
    policy, wait, pa, pb = _policy(kernel, params, lanes, device)
    if split:
        _refuse_gamma("sweep kernel", (job, spot))
    job_code, job_c, job_n = _arrival(job)
    spot_code, spot_c, spot_n = _arrival(spot)

    w = len(plan)
    key_out = None
    if split:
        win_keys = _as_int32_words(state.key)[:, None].contiguous()
        key_out = torch.empty(lanes, 2, dtype=torch.int32, device=device)
        final_key = None
    else:
        slab_keys, final_key = window_slab_keys(state.key, len(plan))
        win_keys = _as_int32_words(slab_keys).contiguous()
    plan_t = torch.tensor(plan, dtype=torch.int32, device=device)
    f32, i32 = torch.float32, torch.int32
    inputs = [("next_job", state.next_job, f32, (lanes,)),
              ("next_spot", state.next_spot, f32, (lanes,)),
              ("ages", state.ages, f32, (lanes, rmax)),
              ("budgets", state.budgets, f32, (lanes, rmax)),
              ("occ", state.occ, torch.bool, (lanes, rmax)),
              ("order", state.order, i32, (lanes, rmax)),
              ("next_seq", state.next_seq, i32, (lanes,)),
              ("qlen", state.qlen, i32, (lanes,)),
              ("window keys", win_keys, i32, (lanes, 1 if split else w, 2)),
              ("plan", plan_t, i32, (w,)),
              ("k_cost", k_cost, f32, (lanes,)),
              ("policy param a", pa, f32, (lanes,)),
              ("policy param b", pb, f32, (lanes,))]
    for name, x, dtype, shape in inputs:
        _check(name, x, dtype, shape)

    out = EngineState(
        key=final_key,
        next_job=torch.empty(lanes, dtype=f32, device=device),
        next_spot=torch.empty(lanes, dtype=f32, device=device),
        ages=torch.empty(lanes, rmax, dtype=f32, device=device),
        budgets=torch.empty(lanes, rmax, dtype=f32, device=device),
        occ=torch.empty(lanes, rmax, dtype=torch.bool, device=device),
        order=torch.empty(lanes, rmax, dtype=i32, device=device),
        next_seq=torch.empty(lanes, dtype=i32, device=device),
        qlen=torch.empty(lanes, dtype=i32, device=device))
    istats = torch.empty(6, lanes, w, dtype=i32, device=device)
    fstats = torch.empty(4, lanes, w, dtype=f32, device=device)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ptrs = np.array([x.data_ptr() for _, x, _, _ in inputs]
                    + [x.data_ptr() for x in out[1:]]
                    + [istats.data_ptr(), fstats.data_ptr(),
                       0 if key_out is None else key_out.data_ptr()],
                    np.int64)
    cols = (0, 0, 0) if split else (layout.job[0], layout.spot[0],
                                    layout.admit[0])
    icfg = np.array([lanes, rmax, w, n_cols, job_code, spot_code, policy,
                     wait, *cols, job_n, spot_n, group,
                     slots_per_thread(rmax, group),
                     warps_per_block(lanes, group, sms), int(split)],
                    np.int32)
    fcfg = np.zeros(8, np.float32)
    fcfg[:len(job_c)] = job_c
    fcfg[4:4 + len(spot_c)] = spot_c
    tstats, *tel_args = _telemetry_outputs(tel, 1, lanes, w, device)
    env_out, *env_args = _env_outputs(ep, es, 1, lanes, w, device)
    work_out, *work_args = _work_outputs(work, ws, rmax, lanes, w, device,
                                         safety)
    if ws is not None and not torch.equal(ws.life, state.ages):
        raise ValueError("sweep kernel: the single queue holds a slot's "
                         "life in its age; the work state's life must "
                         "equal ages")

    _launch("sweep_launch", "sweep kernel", tel, ptrs, icfg, fcfg, tel_args,
            env_args, work_args, device)
    batched_event_windows.launches += 1
    if split:
        out = out._replace(key=key_out.to(torch.int64) & MASK)
    stats = WindowStats(jobs_arrived=istats[0], jobs_completed=istats[1],
                        spot_served=istats[2], ondemand=istats[3],
                        cost_sum=fstats[0], delay_sum=fstats[1],
                        time_elapsed=fstats[2], empty_time=fstats[3],
                        spot_arrivals=istats[4], spot_found_empty=istats[5])
    return _with_pairs(out, stats if tel is None else (stats, tstats), env_out,
                     work_out=work_out)


#: launches of the kernel since the count was last set to 0
batched_event_windows.launches = 0

_CHOICE_CODES = {"cheapest": 1, "fastest": 2, "least_loaded": 3,
                 "uniform": 4, "weighted": 5}


class TooManyPoolsError(ValueError):
    """A market of more pools than the market kernel holds (MAX_POOLS)."""


def _market_policy(kernel, params: dict, lanes: int, device):
    """(admit code, wait code, choice code, resume code, pa, pb, ckpt):
    the market kernel's rules and per-lane params as csrc/sweep.cu's
    ``market_kernel`` reads them.  A legacy single-queue kernel joins pool
    0 (choice 0) and defects on revocation (resume 0); a ``PanicKernel``
    decides as its base (its repairs are :func:`_panic_flags`)."""
    kernel = peel_panic(kernel)
    zero = torch.zeros(lanes, dtype=torch.float32, device=device)
    if isinstance(kernel, NoticeAwareKernel):
        ckpt = kernel.ckpt(params, zero).expand(lanes).contiguous()
        return (0, 0, _CHOICE_CODES[kernel.choice], 1, params["r"], zero,
                ckpt)
    choice, base = 0, kernel
    if isinstance(kernel, PoolChoiceKernel):
        choice, base = _CHOICE_CODES[kernel.choice], kernel.base
    admit, wait, pa, pb = _policy(base, params, lanes, device)
    return admit, wait, choice, 0, pa, pb, zero


def _panic_flags(kernel, regions: bool = False) -> tuple[int, int, int]:
    """PanicKernel's repairs as the kernel's flags: (admission gate on any
    location alive, failover of the pool choice or the route, drain of
    jobs queued on a dead pool).  An outer PanicKernel repairs its base's
    choice (in the regions its route) and gates its admission; one inside a
    routing kernel gates the admission alone (the route is the rule's); the
    drain runs in the market only."""
    if isinstance(kernel, PanicKernel):
        drain = int(kernel.drain_dead and not regions)
        return 1, 1, drain
    if regions and isinstance(kernel, RoutingKernel):
        inner = _panic_flags(kernel.base, regions)
        return inner[0], 0, 0
    return 0, 0, 0


def _env_for_panic(ep, es, panic, rates: torch.Tensor, n_locs: int,
                   lanes: int, device):
    """``(ep, es, keep)``: a PanicKernel's run without a timeline where a
    location's rate is 0 runs the env build under the constant timeline
    (``keep`` False: its counters are dropped).  Where every rate is > 0
    every location stays alive, every repair is the identity and the build
    without the env state runs."""
    if ep is not None or not any(panic) or bool((rates > 0).all()):
        return ep, es, True
    ep = EnvTimeline.constant().params(n_locs, device)
    return ep, init_env_state(ep, lanes), False


def _choice_col(kernel, layout, n_pools: int) -> int:
    """First slab column of the pool-choice rule's draws (0 on the split
    stream, which has no slab)."""
    if layout is None:
        return 0
    if isinstance(kernel, NoticeAwareKernel):
        return layout.admit[0] + 1
    if isinstance(kernel, PoolChoiceKernel):
        return layout.admit[0] + kernel_slab_cols(kernel.base, "admit",
                                                  n_pools)
    return 0


def market_event_windows(job, market, kernel, rmax: int, preempt_on: bool,
                         state: MarketState, params: dict, mp: dict,
                         k_cost: torch.Tensor, plan: tuple[int, ...],
                         tel: Telemetry | None = None, ep: dict | None = None,
                         work=None, wk=None, rng: str = "slab"
                         ) -> tuple[MarketState, MarketWindowStats]:
    """Run every market lane through the windows of ``plan`` in one launch.

    Same contract as
    :func:`repro_torch.kernels.sweep.ref.market_event_windows_ref`:
    ``state`` holds ``(lanes, ...)`` CUDA tensors, ``params`` the kernel's
    per-lane float32 params, ``mp`` the per-lane pools config (``(lanes,
    P)`` price, hazard, notice, rate, spot_scale), ``k_cost`` the per-lane
    on-demand price.  A lane runs on :func:`group_size` threads.  Returns
    ``(final_state, stats)`` with stats leaves ``(lanes, W)`` and ``(lanes,
    W, P)`` for the pool fields (with ``tel`` a ``(base, telemetry)``
    pair, the pools its locations; the env and work pairs as in
    :func:`batched_event_windows`).  ``rng="split"`` runs the split
    stream: the kernel walks each lane's key ladder, one step an event, the
    state's preemption clocks are ``(lanes, P)`` and the final state holds
    the lane keys it reached.  Raises if the kernel cannot be built or
    launched, for more than ``MAX_POOLS`` pools, or for a policy it holds
    no code for (:class:`NoKernelPolicyError`); it never falls back.
    """
    kernel, *safety = peel_safety_net(kernel)
    split = rng == "split"
    layout = _market_layout(job, market, kernel, preempt_on, rng)
    n_pools = market.n_pools
    state, es, ws = _unpack(state, ep, work)
    lanes, device = state.key.shape[0], state.key.device
    panic = _panic_flags(kernel)
    ep, es, keep = _env_for_panic(ep, es, panic, mp["rate"], n_pools, lanes,
                                  device)
    kernel = peel_panic(kernel)
    if n_pools > MAX_POOLS:
        raise TooManyPoolsError(f"market kernel: {n_pools} pools exceed "
                                f"{MAX_POOLS}")
    if lanes == 0 or not 1 <= rmax <= MAX_RMAX:
        raise ValueError(f"market kernel: need lanes >= 1 and 1 <= rmax <= "
                         f"{MAX_RMAX}, got {lanes} lanes, rmax {rmax}")
    n_cols = 0 if split else layout.n_cols
    if n_cols > MAX_COLS:
        raise ValueError(f"market kernel: a slab row of {n_cols} "
                         f"columns exceeds {MAX_COLS}")
    if max(plan) * n_cols >= 2**32:
        raise ValueError("market kernel: a window's slab index must fit in "
                         "32 bits")
    group = group_size(rmax)
    admit, wait, choice, resume, pa, pb, ckpt = _market_policy(
        kernel, params, lanes, device)
    if split:
        _refuse_gamma("market kernel", (job,) + tuple(
            p.arrival for p in market.pools))
    logits = None
    if choice == _CHOICE_CODES["weighted"]:
        logits = params["pool_logits"]
        logits = (logits[:, None] if logits.dim() == 1 else logits) \
            .expand(lanes, n_pools).contiguous()
    job_code, job_c, job_n = _arrival(job)
    codes, ns, consts = _arrivals(p.arrival for p in market.pools)

    w = len(plan)
    key_out = final_key = None
    if split:
        win_keys = _as_int32_words(state.key)[:, None].contiguous()
        key_out = torch.empty(lanes, 2, dtype=torch.int32, device=device)
    else:
        slab_keys, final_key = window_slab_keys(state.key, w)
        win_keys = _as_int32_words(slab_keys).contiguous()
    plan_t = torch.tensor(plan, dtype=torch.int32, device=device)
    f32, i32 = torch.float32, torch.int32
    lp = (lanes, n_pools)
    pre = lp if split else (lanes,)  # the preemption clocks
    inputs = [("next_job", state.next_job, f32, (lanes,)),
              ("next_spot", state.next_spot, f32, lp),
              ("next_preempt", state.next_preempt, f32, pre),
              ("ages", state.ages, f32, (lanes, rmax)),
              ("budgets", state.budgets, f32, (lanes, rmax)),
              ("occ", state.occ, torch.bool, (lanes, rmax)),
              ("pool", state.pool, i32, (lanes, rmax)),
              ("order", state.order, i32, (lanes, rmax)),
              ("next_seq", state.next_seq, i32, (lanes,)),
              ("qlen", state.qlen, i32, (lanes,)),
              ("window keys", win_keys, i32, (lanes, 1 if split else w, 2)),
              ("plan", plan_t, i32, (w,)),
              ("k_cost", k_cost, f32, (lanes,)),
              ("policy param a", pa, f32, (lanes,)),
              ("policy param b", pb, f32, (lanes,)),
              ("checkpoint time", ckpt, f32, (lanes,))] + [
                  (name, mp[name], f32, lp)
                  for name in ("price", "hazard", "notice", "rate",
                               "spot_scale")]
    if logits is not None:
        inputs.append(("pool_logits", logits, f32, lp))
    for name, x, dtype, shape in inputs:
        _check(name, x, dtype, shape)

    out = MarketState(
        key=final_key,
        next_job=torch.empty(lanes, dtype=f32, device=device),
        next_spot=torch.empty(lp, dtype=f32, device=device),
        next_preempt=torch.empty(pre, dtype=f32, device=device),
        ages=torch.empty(lanes, rmax, dtype=f32, device=device),
        budgets=torch.empty(lanes, rmax, dtype=f32, device=device),
        occ=torch.empty(lanes, rmax, dtype=torch.bool, device=device),
        pool=torch.empty(lanes, rmax, dtype=i32, device=device),
        order=torch.empty(lanes, rmax, dtype=i32, device=device),
        next_seq=torch.empty(lanes, dtype=i32, device=device),
        qlen=torch.empty(lanes, dtype=i32, device=device))
    istats = torch.empty(7, lanes, w, dtype=i32, device=device)
    fstats = torch.empty(5, lanes, w, dtype=f32, device=device)
    pstats = torch.empty(3, lanes, w, n_pools, dtype=i32, device=device)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    in_ptrs = [x.data_ptr() for _, x, _, _ in inputs[:21]]
    ptrs = np.array(in_ptrs + [0 if logits is None else logits.data_ptr()]
                    + [x.data_ptr() for x in out[1:]]
                    + [istats.data_ptr(), fstats.data_ptr(),
                       pstats.data_ptr(),
                       0 if key_out is None else key_out.data_ptr()],
                    np.int64)
    fcfg = np.zeros(4 + 4 * MAX_POOLS, np.float32)
    fcfg[:len(job_c)] = job_c
    fcfg[4:] = consts.reshape(-1)
    cols = [0] * 6
    if not split:
        cols = [layout.job[0], layout.spot[0], layout.admit[0],
                _choice_col(kernel, layout, n_pools),
                layout.preempt[0] if preempt_on else 0,
                layout.on_preempt[0] if layout.on_preempt else 0]
    tags = np.zeros(MAX_POOLS, np.uint32)
    tags[:n_pools] = [t & MASK for t in market.tags]
    icfg = np.array([lanes, rmax, w, n_cols, n_pools, job_code, job_n,
                     admit, wait, choice, resume, int(preempt_on),
                     int(0 in codes[:n_pools]), *cols,
                     group, slots_per_thread(rmax, group),
                     warps_per_block(lanes, group, sms)]
                    + codes.tolist() + ns.tolist() + [int(split)]
                    + tags.view(np.int32).tolist(), np.int32)
    tstats, *tel_args = _telemetry_outputs(tel, n_pools, lanes, w, device)
    env_out, *env_args = _env_outputs(ep, es, n_pools, lanes, w, device,
                                      panic)
    work_out, *work_args = _work_outputs(work, ws, rmax, lanes, w, device,
                                         safety)

    _launch("market_launch", "market kernel", tel, ptrs, icfg, fcfg,
            tel_args, env_args, work_args, device)
    market_event_windows.launches += 1
    if split:
        out = out._replace(key=key_out.to(torch.int64) & MASK)
    stats = MarketWindowStats(
        jobs_arrived=istats[0], jobs_completed=istats[1],
        spot_served=istats[2], ondemand=istats[3], cost_sum=fstats[0],
        delay_sum=fstats[1], time_elapsed=fstats[2], empty_time=fstats[3],
        spot_arrivals=istats[4], spot_found_empty=istats[5],
        resumed=istats[6], spot_cost=fstats[4], pool_served=pstats[0],
        pool_spot_arrivals=pstats[1], pool_preempted=pstats[2])
    return _with_pairs(out, stats if tel is None else (stats, tstats), env_out,
                     keep, work_out)


#: launches of the market kernel since the count was last set to 0
market_event_windows.launches = 0



class TooManyRegionsError(ValueError):
    """A topology of more regions than the region kernel holds
    (MAX_REGIONS)."""


def region_event_windows(topo, kernel, preempt_on: bool, state: RegionState,
                         params: dict, rp: dict, k_cost: torch.Tensor,
                         plan: tuple[int, ...], tel: Telemetry | None = None,
                         ep: dict | None = None, work=None, wk=None
                         ) -> tuple[RegionState, RegionWindowStats]:
    """Run every region lane through the windows of ``plan`` in one launch.

    Same contract as
    :func:`repro_torch.kernels.sweep.ref.region_event_windows_ref`:
    ``state`` holds ``(lanes, ...)`` CUDA tensors (the packed slot arrays
    ``(lanes, Σ rmax_r)``), ``params`` the kernel's per-lane float32
    params, ``rp`` the per-lane regions config (``(lanes, R)`` price,
    hazard, notice, rate, spot_scale, job_scale), ``k_cost`` the per-lane
    on-demand price.  A lane runs on ``group_size(Σ rmax_r)`` threads.
    Returns ``(final_state, stats)`` with stats leaves ``(lanes, W)`` and
    ``(lanes, W, R)`` for the region fields (with ``tel`` a ``(base,
    telemetry)`` pair, the regions its locations; the env and work pairs
    as in :func:`batched_event_windows`).  Raises if the kernel cannot be
    built or launched, or for more than ``MAX_REGIONS`` regions; it never
    falls back.
    """
    kernel, *safety = peel_safety_net(kernel)
    layout = _region_layout(topo, kernel, preempt_on)
    n_regions, n_slots = topo.n_regions, topo.total_slots
    state, es, ws = _unpack(state, ep, work)
    lanes, device = state.key.shape[0], state.key.device
    panic = _panic_flags(kernel, regions=True)
    ep, es, keep = _env_for_panic(ep, es, panic, rp["rate"], n_regions,
                                  lanes, device)
    kernel = peel_panic(kernel)
    if n_regions > MAX_REGIONS:
        raise TooManyRegionsError(f"region kernel: {n_regions} regions "
                                  f"exceed {MAX_REGIONS}")
    if lanes == 0 or n_slots > MAX_RMAX:
        raise ValueError(f"region kernel: need lanes >= 1 and at most "
                         f"{MAX_RMAX} slots, got {lanes} lanes, "
                         f"{n_slots} slots")
    if layout.n_cols > MAX_COLS:
        raise ValueError(f"region kernel: a slab row of {layout.n_cols} "
                         f"columns exceeds {MAX_COLS}")
    if max(plan) * layout.n_cols >= 2**32:
        raise ValueError("region kernel: a window's slab index must fit in "
                         "32 bits")
    group = group_size(n_slots)
    routed = isinstance(kernel, RoutingKernel)
    route = _CHOICE_CODES.get(kernel.choice, 0) if routed else 0
    admit, wait, _, resume, pa, pb, ckpt = _market_policy(
        kernel.base if routed else kernel, params, lanes, device)
    logits = None
    if route == _CHOICE_CODES["weighted"]:
        logits = params["region_logits"]
        logits = (logits[:, None] if logits.dim() == 1 else logits) \
            .expand(lanes, n_regions).contiguous()
    job_codes, job_ns, job_c = _arrivals(r.job for r in topo.regions)
    spot_codes, spot_ns, spot_c = _arrivals(r.spot for r in topo.regions)

    slab_keys, final_key = window_slab_keys(state.key, len(plan))
    win_keys = _as_int32_words(slab_keys).contiguous()
    plan_t = torch.tensor(plan, dtype=torch.int32, device=device)
    w = len(plan)
    f32, i32 = torch.float32, torch.int32
    lr, ls = (lanes, n_regions), (lanes, n_slots)
    inputs = [("next_job", state.next_job, f32, lr),
              ("next_spot", state.next_spot, f32, lr),
              ("next_preempt", state.next_preempt, f32, (lanes,)),
              ("ages", state.ages, f32, ls),
              ("budgets", state.budgets, f32, ls),
              ("occ", state.occ, torch.bool, ls),
              ("order", state.order, i32, ls),
              ("next_seq", state.next_seq, i32, (lanes,)),
              ("qlen", state.qlen, i32, lr),
              ("window keys", win_keys, i32, (lanes, w, 2)),
              ("plan", plan_t, i32, (w,)),
              ("k_cost", k_cost, f32, (lanes,)),
              ("policy param a", pa, f32, (lanes,)),
              ("policy param b", pb, f32, (lanes,)),
              ("checkpoint time", ckpt, f32, (lanes,))] + [
                  (name, rp[name], f32, lr)
                  for name in ("price", "hazard", "notice", "rate",
                               "spot_scale", "job_scale")]
    if logits is not None:
        inputs.append(("region_logits", logits, f32, lr))
    for name, x, dtype, shape in inputs:
        _check(name, x, dtype, shape)

    out = RegionState(
        key=final_key,
        next_job=torch.empty(lr, dtype=f32, device=device),
        next_spot=torch.empty(lr, dtype=f32, device=device),
        next_preempt=torch.empty(lanes, dtype=f32, device=device),
        ages=torch.empty(ls, dtype=f32, device=device),
        budgets=torch.empty(ls, dtype=f32, device=device),
        occ=torch.empty(ls, dtype=torch.bool, device=device),
        order=torch.empty(ls, dtype=i32, device=device),
        next_seq=torch.empty(lanes, dtype=i32, device=device),
        qlen=torch.empty(lr, dtype=i32, device=device))
    istats = torch.empty(8, lanes, w, dtype=i32, device=device)
    fstats = torch.empty(5, lanes, w, dtype=f32, device=device)
    rstats = torch.empty(5, lanes, w, n_regions, dtype=i32, device=device)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    in_ptrs = [x.data_ptr() for _, x, _, _ in inputs[:21]]
    ptrs = np.array(in_ptrs + [0 if logits is None else logits.data_ptr()]
                    + [x.data_ptr() for x in out[1:]]
                    + [istats.data_ptr(), fstats.data_ptr(),
                       rstats.data_ptr()], np.int64)
    offsets = np.zeros(MAX_REGIONS + 1, np.int32)
    offsets[:n_regions] = topo.slot_offsets()
    offsets[n_regions] = n_slots
    icfg = np.array([lanes, n_slots, w, layout.n_cols, n_regions, admit,
                     wait, route, resume, int(preempt_on),
                     int(0 in job_codes[:n_regions]),
                     int(0 in spot_codes[:n_regions]),
                     layout.job[0], layout.spot[0], layout.admit[0],
                     layout.route[0] if layout.route else 0,
                     layout.preempt[0] if preempt_on else 0,
                     layout.on_preempt[0] if layout.on_preempt else 0,
                     group, slots_per_thread(n_slots, group),
                     warps_per_block(lanes, group, sms)]
                    + offsets.tolist() + job_codes.tolist()
                    + job_ns.tolist() + spot_codes.tolist()
                    + spot_ns.tolist(), np.int32)
    fcfg = np.concatenate([job_c.reshape(-1), spot_c.reshape(-1)])
    tstats, *tel_args = _telemetry_outputs(tel, n_regions, lanes, w, device)
    env_out, *env_args = _env_outputs(ep, es, n_regions, lanes, w, device,
                                      panic)
    work_out, *work_args = _work_outputs(work, ws, n_slots, lanes, w, device,
                                         safety)

    _launch("region_launch", "region kernel", tel, ptrs, icfg, fcfg,
            tel_args, env_args, work_args, device)
    region_event_windows.launches += 1
    stats = RegionWindowStats(
        jobs_arrived=istats[0], jobs_completed=istats[1],
        spot_served=istats[2], ondemand=istats[3], cost_sum=fstats[0],
        delay_sum=fstats[1], time_elapsed=fstats[2], empty_time=fstats[3],
        spot_arrivals=istats[4], spot_found_empty=istats[5],
        resumed=istats[6], spot_cost=fstats[4], routed_home=istats[7],
        region_served=rstats[0], region_spot_arrivals=rstats[1],
        region_preempted=rstats[2], region_jobs=rstats[3],
        region_routed=rstats[4])
    return _with_pairs(out, stats if tel is None else (stats, tstats), env_out,
                     keep, work_out)


#: launches of the region kernel since the count was last set to 0
region_event_windows.launches = 0
