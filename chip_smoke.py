"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits nonzero):

1. the card (``nvidia-smi`` name and power limit) and a CUDA device check;
2. build the CUDA sweep kernel from ``src/repro_torch/kernels/sweep/csrc``;
3. the kernel against its plain PyTorch version on the card, on the
   configurations of the JAX package's kernel tests plus a bathtub spot, a
   two-point wait and an infinite wait, at ~96 lanes (8 lanes per block, so
   the lane count leaves a ragged block), rmax 8 and 1, 6,000 events with
   2,048-event windows and a 512-event burn-in, and from a join order a
   hair below INT32_MAX: integer statistics bitwise, float sums to rtol
   1e-5 (the port's tolerance against the JAX package; see
   tests/test_torch_sweep.py);
4. the full-width fleet through ``run_sweep``: Theorem-4 three-phase over
   r = 0.125..8 (64 points) × k ∈ {2, 5, 10, 20} × 16 seeds = 4,096 lanes,
   rmax 64, 2^20 events after a 65,536-event burn-in, held to Theorem 5
   (M/M/1/N) at the eight integer r; then the single-slot policy with a
   deterministic wait swept over 64 values at the same fleet size, rmax 1,
   held to Theorem 1.  The kernel's launch count is set to 0 just before
   each of these two calls and read just after; each must launch it once.
   Both fleets are also held, kernel against plain version, on the exact
   inputs ``run_sweep`` gives the kernel, at a cut depth (4,608 events).

The next-to-last line is a JSON object describing the kernel (times, bound,
launches, error against the plain version); the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.analytic import theorem5_cost  # noqa: E402
from repro_torch.core.arrivals import (BathtubGCP, Deterministic,  # noqa: E402
                                       Exponential, Gamma, Uniform)
from repro_torch.core.clocks import window_slab_keys  # noqa: E402
from repro_torch.core.cost import theorem1_cost  # noqa: E402
from repro_torch.core.engine import (WindowStats,  # noqa: E402
                                     _engine_layout, _flat_lane_args,
                                     _lane_tensors, _window_plan,
                                     init_engine_state, lane_params,
                                     run_sweep)
from repro_torch.core.policies import (SingleSlotKernel,  # noqa: E402
                                       ThreePhaseKernel)
from repro_torch.core.waittime import (DeterministicWait,  # noqa: E402
                                       ExponentialWait, InfiniteWait,
                                       TwoPointWait)
from repro_torch.kernels.sweep import sweep  # noqa: E402
from repro_torch.kernels.sweep.ref import batched_event_windows_ref  # noqa: E402

LAM, MU = 1 / 12, 1 / 24
RTOL = 1e-5
DEVICE = "cuda"
#: H100 SXM issue rates outside the tensor cores, from NVIDIA's data sheet
#: at the 700 W power limit: 67 TFLOP/s of float32 counts a fused
#: multiply-add as two, so float32 instructions issue at half that
#: (128 lanes an SM a clock); INT32 has 64 lanes an SM, half again.
PEAK_FP32 = 67e12 / 2
PEAK_INT32 = PEAK_FP32 / 2
PEAK_BYTES = 3.35e12


def ops_per_lane_event(rmax: int, n_cols: int) -> tuple[int, int]:
    """(INT32, FP32) operations one lane-event needs, counted from the
    plain version's arithmetic, by the type of the data they work on.

    Per slab column: 119 INT32 (threefry-2x32: 20 rounds of add, shift,
    shift, or, xor; 17 key adds; the final xor; the u01 shift) and 2 FP32
    (convert, scale).  Per slot: 16 INT32 (the first-free and FIFO arg-min
    compares and index selects, the masked order select, the one-hot
    compares, the join/leave masks, the occupancy and order updates) and
    11 FP32 (the masked budget select and compare, the age and budget
    updates, the two one-hot reads, the join writes).  Per event: 28 INT32
    (event-kind logic, admission masks, counters, queue length) and 36
    FP32 (clock merge, admission probability, two samplers with log1p
    counted as one, clock updates, four float sums)."""
    return 119 * n_cols + 16 * rmax + 28, 2 * n_cols + 11 * rmax + 36


def bytes_moved(lanes: int, rmax: int, n_windows: int) -> int:
    """Bytes the function must move: each lane's state and params read once
    (keys, clocks, slot arrays, k and two policy params, window keys) and
    its final state and per-window statistics written once."""
    state = 4 * 4 + rmax * (4 + 4 + 1 + 4)
    reads = state + 8 + 12 + n_windows * 8
    writes = state + n_windows * 10 * 4
    return lanes * (reads + writes)


def bound_ms(lanes: int, rmax: int, n_cols: int, plan) -> tuple[float, str]:
    """The least time the card could take for the run: the larger of the
    operation time and the byte time, and which one it is.  The operation
    time is the larger of the INT32 count over the INT32 rate, the FP32
    count over the FP32 rate, and both over the FP32 rate (one warp
    instruction a scheduler a clock issues either kind)."""
    n_int, n_fp = (lanes * sum(plan) * n
                   for n in ops_per_lane_event(rmax, n_cols))
    t_ops = max(n_int / PEAK_INT32, (n_int + n_fp) / PEAK_FP32)
    t_bytes = bytes_moved(lanes, rmax, len(plan)) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, repeat: int = 1) -> tuple[float, object]:
    """Device time of ``fn()`` by CUDA events (mean over ``repeat``)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeat):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat, out


def fleet(job, spot, kernel, rmax, params, lanes, seed, device=None):
    """Lane state and per-lane params for a direct kernel call: ``params``
    maps names to per-lane values (nested for the wait family)."""
    device = device or DEVICE
    keys = threefry.split(threefry.key(seed, device), lanes)
    k = torch.full((lanes,), 10.0, dtype=torch.float32, device=device)

    def lanewise(p):
        return {n: lanewise(v) if isinstance(v, dict) else
                torch.as_tensor(np.resize(np.float32(v), lanes),
                                device=device).contiguous()
                for n, v in p.items()}

    return (init_engine_state(keys, job, spot, rmax),
            lane_params(kernel, lanewise(params), k), k)


def compare(name: str, ref: WindowStats, ker: WindowStats) -> float:
    """Integer statistics bitwise, float sums to RTOL; returns the largest
    relative float difference."""
    worst = 0.0
    for field in WindowStats._fields:
        a = getattr(ref, field).cpu().numpy()
        b = getattr(ker, field).cpu().numpy()
        if a.dtype.kind == "i":
            if not np.array_equal(a, b):
                bad = np.argwhere(a != b)[0]
                raise AssertionError(
                    f"{name}: {field} differs at lane/window {bad.tolist()}: "
                    f"plain {a[tuple(bad)]}, kernel {b[tuple(bad)]}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=0,
                                       err_msg=f"{name}: {field}")
            rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-30)
            worst = max(worst, float(rel.max()))
    return worst


def max_abs(ref: WindowStats, ker: WindowStats) -> float:
    return max(float((getattr(ref, f).double() - getattr(ker, f).double())
                     .abs().max())
               for f in ("cost_sum", "delay_sum", "time_elapsed",
                         "empty_time"))


PARITY_CASES = [
    # (name, job, spot, kernel, rmax, params, lanes); a Gamma job's first
    # clock is drawn exponential (the port has no Gamma init sampler yet),
    # every later draw is Gamma's own
    ("three_phase", Exponential(LAM), Exponential(MU), ThreePhaseKernel(),
     8, {"r": np.repeat(np.linspace(0.25, 4.0, 5), 19)}, 95),
    ("three_phase_gamma", Gamma(12.0, 1.0), Exponential(MU),
     ThreePhaseKernel(), 8, {"r": np.repeat(np.linspace(0.0, 3.0, 4), 25)},
     100),
    ("single_slot", Exponential(LAM), Uniform(0.0, 48.0),
     SingleSlotKernel(wait=DeterministicWait(3.0)), 1, {}, 97),
    ("single_slot_exp_wait", Exponential(LAM), Exponential(MU),
     SingleSlotKernel(wait=ExponentialWait(0.5)), 1, {}, 97),
    ("bathtub_spot", Exponential(LAM), BathtubGCP(), ThreePhaseKernel(), 8,
     {"r": np.repeat(np.linspace(0.5, 6.0, 4), 24)}, 96),
    ("two_point_wait", Deterministic(12.0), Uniform(0.3, 48.7),
     SingleSlotKernel(wait=TwoPointWait(0.3, 20.0)), 1, {}, 97),
    ("infinite_wait", Exponential(LAM), Exponential(MU),
     SingleSlotKernel(wait=InfiniteWait()), 1, {}, 97),
]


def phase_parity() -> float:
    worst = 0.0
    plan = _window_plan(6_000, 2_048, 512)
    for name, job, spot, kernel, rmax, params, lanes in PARITY_CASES:
        init_job = Exponential(LAM) if isinstance(job, Gamma) else job
        state0, p, k = fleet(init_job, spot, kernel, rmax, params, lanes, 7)
        _, ref = batched_event_windows_ref(job, spot, kernel, rmax, state0,
                                           p, k, plan)
        _, ker = sweep.batched_event_windows(job, spot, kernel, rmax, state0,
                                             p, k, plan)
        torch.cuda.synchronize()
        rel = compare(name, ref, ker)
        worst = max(worst, rel)
        print(f"parity {name}: {lanes} lanes rmax {rmax} plan {plan}: ints "
              f"bitwise, max rel float diff {rel:.3g}", flush=True)

    # the join order starts a hair below INT32_MAX: without the per-window
    # rebase it would wrap within a few windows
    job = spot = Exponential(1.0)
    kernel, rmax, plan = ThreePhaseKernel(), 8, _window_plan(4_000, 128, 0)
    state0, p, k = fleet(job, spot, kernel, rmax, {"r": 6.0}, 96, 2)
    high = state0._replace(next_seq=state0.next_seq + (2**31 - 10_000))
    _, ref = batched_event_windows_ref(job, spot, kernel, rmax, high, p, k,
                                       plan)
    fin_hi, ker_hi = sweep.batched_event_windows(job, spot, kernel, rmax,
                                                 high, p, k, plan)
    _, ker_lo = sweep.batched_event_windows(job, spot, kernel, rmax, state0,
                                            p, k, plan)
    rel = compare("rebase", ref, ker_hi)
    compare("rebase vs zero start", ker_lo, ker_hi)
    if int(fin_hi.next_seq.max()) > 128 + rmax:
        raise AssertionError("rebase: next_seq not bounded by window + rmax")
    print(f"parity rebase: next_seq from 2^31-10^4, {len(plan)} windows: "
          f"ints bitwise, equal to the zero start, max rel float diff "
          f"{rel:.3g}", flush=True)
    return max(worst, rel)


# the full-width fleets: (r or wait) × k × seeds = 64 × 4 × 16 = 4,096 lanes
R_GRID = np.arange(1, 65) * 0.125
WAITS = np.linspace(0.0, 48.0, 64)
K_GRID = np.array([2.0, 5.0, 10.0, 20.0])
N_SEEDS, N_EVENTS, BURN_IN = 16, 2**20, 65_536
MAIN_SEED = 2026
WIDTH_PLAN = (512, 2_048, 2_048)
#: the main path's two fleets: (name, kernel, swept params, rmax)
MAIN_PATHS = (
    ("three_phase", ThreePhaseKernel(), {"r": R_GRID[:, None]}, 64),
    ("single_slot", SingleSlotKernel(wait=DeterministicWait(3.0)),
     {"wait": {"value": WAITS[:, None]}}, 1),
)
JOB, SPOT = Exponential(LAM), Exponential(MU)


def main_inputs(kernel, params, rmax):
    """The kernel's inputs exactly as ``run_sweep`` lays them out for the
    main path: grid-major lanes, seed fastest, the same seed keys."""
    params_f, k_f, _ = _lane_tensors(params, K_GRID[None, :], DEVICE)
    keys = threefry.split(threefry.key(MAIN_SEED, DEVICE), N_SEEDS)
    params_l, k_l, keys_l = _flat_lane_args(params_f, k_f, keys)
    state0 = init_engine_state(keys_l, JOB, SPOT, rmax)
    return state0, lane_params(kernel, params_l, k_l), k_l


def phase_width(entry: dict) -> None:
    """Kernel and plain version on each main-path fleet's inputs (cut
    depth): ints bitwise, floats to RTOL."""
    for name, kernel, params, rmax in MAIN_PATHS:
        state0, p, k = main_inputs(kernel, params, rmax)
        lanes = k.shape[0]
        args = (JOB, SPOT, kernel, rmax, state0, p, k, WIDTH_PLAN)
        sweep.batched_event_windows(*args)  # warm-up
        ms, (_, ker) = cuda_ms(lambda: sweep.batched_event_windows(*args), 3)
        plain_ms, (_, ref) = cuda_ms(lambda: batched_event_windows_ref(*args))
        rel = compare(f"width {name}", ref, ker)
        n_cols = _engine_layout(JOB, SPOT, kernel).n_cols
        b_ms, b_by = bound_ms(lanes, rmax, n_cols, WIDTH_PLAN)
        err = max_abs(ref, ker)
        if name == "three_phase":
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err)
        else:
            entry.update({f"{name}_ms": ms, f"{name}_plain_ms": plain_ms,
                          f"{name}_bound_ms": b_ms,
                          f"{name}_max_abs_err": err})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        print(f"width {name}: {lanes} lanes rmax {rmax} plan {WIDTH_PLAN}: "
              f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), ints bitwise, max rel float diff "
              f"{rel:.3g}", flush=True)


def phase_main_kernel(entry: dict) -> None:
    """Device time of the kernel alone at the main path's full size."""
    plan = _window_plan(N_EVENTS, 65_536, BURN_IN)
    for name, kernel, params, rmax in MAIN_PATHS:
        state0, p, k = main_inputs(kernel, params, rmax)
        lanes = k.shape[0]
        ladder_ms, _ = cuda_ms(lambda: window_slab_keys(state0.key,
                                                        len(plan)))
        ms, _ = cuda_ms(lambda: sweep.batched_event_windows(
            JOB, SPOT, kernel, rmax, state0, p, k, plan))
        n_cols = _engine_layout(JOB, SPOT, kernel).n_cols
        b_ms, _ = bound_ms(lanes, rmax, n_cols, plan)
        rate = lanes * sum(plan) / (ms / 1e3)
        entry.update({f"main_{name}_ms": ms, f"main_{name}_bound_ms": b_ms,
                      f"main_{name}_lane_events_per_s": rate,
                      f"main_{name}_key_ladder_ms": ladder_ms})
        print(f"main-size kernel {name}: {lanes} lanes × {sum(plan)} events "
              f"rmax {rmax} in {ms:.1f} ms = {rate:.4g} lane-events/s "
              f"(bound {b_ms:.1f} ms); window-key ladder {ladder_ms:.3f} ms",
              flush=True)


def phase_main_path(entry: dict) -> None:
    """The main path through ``run_sweep``: each fleet's launch count is
    set to 0 just before its call and read just after, and the outputs are
    held to the theory."""
    key = threefry.key(MAIN_SEED)
    out = {}
    for name, kernel, params, rmax in MAIN_PATHS:
        sweep.batched_event_windows.launches = 0
        t0 = time.perf_counter()
        out[name] = run_sweep(JOB, SPOT, kernel, params, k=K_GRID[None, :],
                              n_events=N_EVENTS, key=key, n_seeds=N_SEEDS,
                              rmax=rmax, burn_in=BURN_IN)
        wall = time.perf_counter() - t0
        launches = sweep.batched_event_windows.launches
        entry[f"launches_{name}"] = launches
        if launches != 1:
            raise AssertionError(f"main path {name}: run_sweep launched the "
                                 f"kernel {launches} times; expected 1")
        lanes = R_GRID.size * K_GRID.size * N_SEEDS
        lane_events = lanes * (N_EVENTS + BURN_IN)
        entry[f"run_sweep_{name}_s"] = wall
        print(f"main path {name}: run_sweep {wall:.3f} s wall "
              f"({lane_events / wall:.4g} lane-events/s), kernel launches "
              f"{launches}", flush=True)
    entry["launches"] = sum(entry[f"launches_{name}"]
                            for name, *_ in MAIN_PATHS)

    tp, ss = out["three_phase"], out["single_slot"]
    for res, shape in ((tp, (R_GRID.size, K_GRID.size, N_SEEDS)),
                       (ss, (WAITS.size, K_GRID.size, N_SEEDS))):
        for name, v in res.items():
            if v.shape != shape or not np.all(np.isfinite(v)):
                raise AssertionError(f"{name}: shape {v.shape} or non-finite")
    worst5 = 0.0
    for i in np.flatnonzero(R_GRID == np.round(R_GRID)):
        n = int(R_GRID[i])
        for j, kk in enumerate(K_GRID):
            got = tp["avg_cost"][i, j].mean()
            err = abs(got - theorem5_cost(kk, LAM, MU, n))
            worst5 = max(worst5, err / kk)
            if err >= 0.005 * kk:
                raise AssertionError(
                    f"Theorem 5: r={n} k={kk}: avg_cost {got:.5f} vs "
                    f"{theorem5_cost(kk, LAM, MU, n):.5f}")
    worst1 = 0.0
    for i in range(WAITS.size):
        for j, kk in enumerate(K_GRID):
            got = ss["avg_cost"][i, j].mean()
            want = theorem1_cost(kk, LAM, MU, ss["pi0_spot"][i, j].mean())
            worst1 = max(worst1, abs(got - want) / kk)
            if abs(got - want) >= 0.005 * kk:
                raise AssertionError(
                    f"Theorem 1: wait={WAITS[i]:.2f} k={kk}: avg_cost "
                    f"{got:.5f} vs {want:.5f}")
    print(f"theory: three-phase vs Theorem 5 at r=1..8 within "
          f"{worst5:.2e}·k, single-slot vs Theorem 1 within {worst1:.2e}·k "
          f"(limit 5e-3·k)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    lib = sweep.build(verbose=True)
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    entry = {"name": "sweep_batched_event_windows", "route": "cuda",
             "source": "src/repro_torch/kernels/sweep/csrc/sweep.cu",
             "replaces": "src/repro/kernels/sweep/sweep.py:124",
             "library_ms": None}
    phase_parity()
    phase_width(entry)
    phase_main_kernel(entry)
    phase_main_path(entry)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entry = {k: entry[k] for k in keys} | {
        k: v for k, v in entry.items() if k not in keys}
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
