"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits nonzero):

1. the card (``nvidia-smi`` name and power limit) and a CUDA device check;
2. build the three CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (sweep, flash attention, decode attention), one ``nvcc`` each, all
   started together, with ptxas's registers, shared memory and spills;
3. the sweep kernel against its plain PyTorch version on the card, on the
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
5. the flash and decode attention kernels against their plain versions on
   the JAX package's kernel-test shapes (float32 rtol 1e-5, bf16 within one
   ulp), at 16- and 48-token prompts (partial key sub-tiles) and at the
   serving shapes: flash at the prefill (B 4, S 512, H 20, D 128, bf16,
   causal), decode at (B 4, S 544, KH 20, D 128) over several fill levels;
6. spot-aware serving on qwen1.5-4b at full width (all 40 layers, the
   published widths, bf16, random weights from a seeded generator, flash
   attention): ``SpotServingFrontend`` with the launcher's controller, 8
   requests of 512 prompt tokens and 32 new tokens, batch 4.  The flash
   kernel's launch count is set to 0 just before the stream and read just
   after: it must be 40 a prefill.  Prints TTFT and prefill and decode
   tokens/s;
7. serving correctness: full-width bf16 prefill logits through the flash
   kernel against the plain version (atol 0.2, see ``LOGITS_ATOL``), beside
   two plain paths against each other; a teacher-forced check of
   ``decode_step``'s logits against prefills over the prompt plus the
   generated tokens (plain attention: 513..544 tokens do not tile by 128),
   with the greedy tokens' agreement; one generate call under
   ``torch.profiler`` (device time by kernel, idle share); and the same
   widths in float32, prefill logits kernel against plain version to rtol
   1e-4, atol 1e-5;
8. each attention kernel alone (CUDA events) at the serving shapes and at a
   long one (flash: one row of the prefill_32k cell, B 1, S 32,768,
   causal; decode: B 16, S 32,768 full), beside its plain version where
   memory allows and ``F.scaled_dot_product_attention`` as the library
   yardstick (timed here only; the port never calls it).

The next-to-last line is a JSON object describing the three kernels
(times, bound, launches, error against the plain version); the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sweep import sweep  # noqa: E402
from repro_torch.kernels.sweep.ref import batched_event_windows_ref  # noqa: E402
from repro_torch.cluster.orchestrator import (  # noqa: E402
    OnlineAdmissionController)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention as decode_mod)
from repro_torch.kernels.decode_attention.decode_attention import (  # noqa: E402,E501
    decode_attention_bh)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_bh_ref, decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_mod)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_bh)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, flash_attention_bh_ref)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import (BatchedServer,  # noqa: E402
                                        SpotServingFrontend)

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
#: dense bf16 tensor-core rate (NVIDIA's H100 SXM data sheet, 700 W)
PEAK_BF16 = 989e12
#: attention outputs against the plain version: float32 rtol 1e-5 with a
#: 1e-6 floor near zero; bf16 within one ulp (both compute in float32 and
#: round once)
F32_ATOL, BF16_RTOL = 1e-6, 2.0**-7
#: full-width (40-layer) bf16 logits: 0.2, twice the 0.100 measured between
#: two plain paths of the port that share no kernel (chunked and naive
#: prefill) on an H100; the 5e-2 of the CPU tests was sized at 2 layers
LOGITS_ATOL = 0.2
#: full-width float32 logits, kernel against plain version (the CPU tests'
#: float32 logits tolerance, tests/_torch_parity.py)
LOGITS_F32 = dict(rtol=1e-4, atol=1e-5)


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

def phase_build() -> None:
    """The three libraries, one nvcc each, all started together."""
    t0 = time.perf_counter()
    results = _build.build(sweep.LIBRARY, flash_mod.LIBRARY,
                           decode_mod.LIBRARY, verbose=True)
    for res in results:
        print(f"built {res.library.path.name}: nvcc {res.seconds:.1f} s",
              flush=True)
        for line in res.ptxas.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"  {line.strip()}", flush=True)
    print(f"build: {time.perf_counter() - t0:.1f} s wall for all three; "
          f"dynamic shared memory a block: flash "
          f"{flash_mod.smem_bytes(torch.bfloat16, HEAD_DIM)} B (bf16, D "
          f"{HEAD_DIM}), {flash_mod.smem_bytes(torch.float32, HEAD_DIM)} B "
          f"(f32); decode {decode_mod.smem_bytes(torch.bfloat16, 1, HEAD_DIM)}"
          f" B (bf16, g 1), {decode_mod.smem_bytes(torch.float32, 1, HEAD_DIM)}"
          f" B (f32); the sweep none", flush=True)


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------
#: tests/test_kernels.py's cases: (B, Sq, Sk, H, KH, D, causal, bq, bk)
FA_CASES = [
    (2, 128, 128, 8, 2, 64, True, 64, 64),
    (1, 256, 256, 4, 4, 32, True, 128, 128),
    (2, 64, 256, 8, 1, 64, False, 32, 64),
    (1, 128, 384, 6, 2, 128, True, 64, 128),
    (1, 64, 64, 2, 2, 16, True, 64, 64),
]
#: tests/test_kernels.py's cases: (B, S, H, KH, D, kv_len, bk)
DEC_CASES = [
    (2, 256, 8, 2, 64, 200, 64),
    (1, 512, 4, 1, 128, 512, 128),
    (3, 128, 6, 6, 32, 1, 32),
    (2, 1024, 8, 2, 64, 700, 256),
]
#: the serving slice's shapes: qwen1.5-4b, 20 heads (MHA) of 128
SERVE_B, PROMPT, MAX_NEW, HEADS, HEAD_DIM = 4, 512, 32, 20, 128
CACHE = PROMPT + MAX_NEW
DECODE_BLOCK = 32  # the decode kernel's KV tile at a 544-slot cache
LONG_S, LONG_DECODE_B = 32_768, 16


def randn(seed, dtype, *shapes):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(s, generator=g, device=DEVICE).to(dtype)
            for s in shapes]


def hold(name, ref, got) -> float:
    """An attention output against its plain version: float32 rtol 1e-5,
    bf16 one ulp; returns the largest absolute difference."""
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else RTOL
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{ref.dtype} {tuple(ref.shape)}")
    a, b = ref.float().cpu().numpy(), got.float().cpu().numpy()
    if not np.all(np.isfinite(b)):
        raise AssertionError(f"{name}: non-finite output")
    np.testing.assert_allclose(b, a, rtol=rtol, atol=F32_ATOL, err_msg=name)
    return float(np.abs(a - b).max())


def causal_pairs(sq: int, sk: int, q_offset: int, sk_valid: int,
                 causal: bool) -> int:
    """Unmasked query-key pairs of one (bh, g) row block."""
    qpos = q_offset + np.arange(sq)
    if not causal:
        return sq * min(sk, sk_valid)
    return int(np.minimum(np.minimum(qpos + 1, sk), sk_valid).clip(0).sum())


def flash_bound(bh, g, sq, sk, d, causal, q_offset=0, sk_valid=None,
                itemsize=2) -> tuple[float, str]:
    """The larger of 4·BH·g·D·(unmasked pairs) over the bf16 tensor-core
    rate and q, k, v, o read or written once over HBM; ms and which."""
    pairs = causal_pairs(sq, sk, q_offset, sk if sk_valid is None
                         else sk_valid, causal)
    t_ops = 4 * bh * g * d * pairs / PEAK_BF16
    t_bytes = itemsize * (2 * bh * g * sq * d + 2 * bh * sk * d) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def decode_bound(bh, g, d, kv_len, itemsize=2) -> tuple[float, str]:
    """K and V up to kv_len (plus q and o) over HBM, against 4·g·D
    operations a key at the bf16 rate; ms and which."""
    t_bytes = itemsize * (2 * bh * kv_len * d + 2 * bh * g * d) / PEAK_BYTES
    t_ops = 4 * bh * g * d * kv_len / PEAK_BF16
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_attention_parity(flash: dict, decode: dict) -> None:
    """Each kernel through its entry point against its plain version on
    the card.  Its launch count over these calls is reported apart from
    the main path's."""
    worst_f = worst_d = 0.0
    flash_attention_bh.launches = decode_attention_bh.launches = 0
    for i, (B, Sq, Sk, H, KH, D, causal, bq, bk) in enumerate(FA_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = randn(10 + i, dtype, (B, Sq, H, D), (B, Sk, KH, D),
                            (B, Sk, KH, D))
            off = Sk - Sq if causal else 0
            got = fa_ops.flash_attention(q, k, v, causal=causal, block_q=bq,
                                         block_k=bk, q_offset=off)
            ref = attention_ref(q, k, v, causal=causal, q_offset=off)
            worst_f = max(worst_f, hold(f"flash case {i} {dtype}", ref, got))
    q, k, v = randn(20, torch.float32, (1, 64, 4, 32), (1, 192, 2, 32),
                    (1, 192, 2, 32))
    for causal in (True, False):
        kw = dict(causal=causal, q_offset=40, sk_valid=150)
        got = fa_ops.flash_attention(q, k, v, block_q=32, block_k=64, **kw)
        worst_f = max(worst_f, hold(f"flash offset/valid causal={causal}",
                                    attention_ref(q, k, v, **kw), got))
    # the launcher's 16-token prompts: one tile of 16 keys, a partial
    # 32-key sub-tile in the kernel
    for S in (16, 48):
        q, k, v = randn(22, torch.bfloat16, *[(4, S, HEADS, HEAD_DIM)] * 3)
        got = fa_ops.flash_attention(q, k, v, causal=True)
        worst_f = max(worst_f, hold(f"flash S={S}", attention_ref(
            q, k, v, causal=True), got))
    q, k, v = randn(21, torch.bfloat16, *[(SERVE_B, PROMPT, HEADS,
                                           HEAD_DIM)] * 3)
    got = fa_ops.flash_attention(q, k, v, causal=True)
    worst_f = max(worst_f, hold("flash prefill shape", attention_ref(
        q, k, v, causal=True), got))
    print(f"parity flash: {len(FA_CASES)} test shapes x f32/bf16, offset + "
          f"valid keys, S 16 and 48 (partial key sub-tiles), prefill "
          f"{tuple(q.shape)} bf16 causal: max abs diff {worst_f:.3g}",
          flush=True)

    for i, (B, S, H, KH, D, kvl, bk) in enumerate(DEC_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = randn(30 + i, dtype, (B, 1, H, D), (B, S, KH, D),
                            (B, S, KH, D))
            got = dec_ops.decode_attention(q, k, v, kvl, block_k=bk)
            worst_d = max(worst_d, hold(f"decode case {i} {dtype}",
                                        decode_attention_ref(q, k, v, kvl),
                                        got))
    q, k, v = randn(40, torch.bfloat16, (SERVE_B, 1, HEADS, HEAD_DIM),
                    *[(SERVE_B, CACHE, HEADS, HEAD_DIM)] * 2)
    fills = (0, 1, 100, PROMPT, PROMPT + 17, CACHE)
    for kvl in fills:
        got = dec_ops.decode_attention(q, k, v, kvl, block_k=DECODE_BLOCK)
        worst_d = max(worst_d, hold(f"decode serving kv_len {kvl}",
                                    decode_attention_ref(q, k, v, kvl), got))
        if kvl == 0 and float(got.float().abs().max()) != 0.0:
            raise AssertionError("decode kv_len 0: output not zero")
    torch.cuda.synchronize()
    flash.update(max_abs_err=worst_f,
                 parity_launches=flash_attention_bh.launches)
    decode.update(max_abs_err=worst_d,
                  entry_point_launches=decode_attention_bh.launches)
    print(f"parity decode: {len(DEC_CASES)} test shapes x f32/bf16, serving "
          f"cache {tuple(k.shape)} bf16 at kv_len {fills}: max abs diff "
          f"{worst_d:.3g}; launches through ops.decode_attention "
          f"{decode_attention_bh.launches}", flush=True)


def full_width_model(dtype: str = "bfloat16"):
    """qwen1.5-4b at its published widths and depth, flash attention,
    random weights from a seeded generator on the card."""
    cfg = dataclasses.replace(get_config("qwen1.5-4b"), attn_impl="pallas",
                              dtype=dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(MAIN_SEED)
    return build_model(cfg, device=DEVICE, generator=gen)


def prefill_with(model, impl: str, tokens, **kw):
    """``model.prefill`` with ``attn_impl`` set to ``impl`` for the call."""
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, attn_impl=impl)
    try:
        return model.prefill({"tokens": tokens}, **kw)
    finally:
        model.cfg = cfg


def median_max(xs) -> str:
    xs = np.asarray(xs)
    return (f"median {np.median(xs) * 1e3:.1f} ms, max {xs.max() * 1e3:.1f} "
            f"ms over {xs.size}")


def phase_serving(flash: dict, decode: dict):
    """The serving main path: the spot-aware frontend on the full-width
    model.  Both attention kernels' counts are set to 0 just before the
    stream and read just after."""
    t0 = time.perf_counter()
    model = full_width_model()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: qwen1.5-4b, {model.cfg.num_layers} layers, d_model "
          f"{model.cfg.d_model}, {n_params / 1e9:.3f}e9 parameters bf16, "
          f"built on the card in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    server = BatchedServer(model, max_batch=SERVE_B, max_len=CACHE,
                           device=DEVICE)
    # warm-up outside the stream: cuBLAS handles and the kernel's first
    # launch, at the stream's shapes
    warm = np.random.default_rng(1).integers(2, model.cfg.vocab_size,
                                             size=(SERVE_B, PROMPT))
    server.generate(list(warm.astype(np.int32)), 2)
    server.timings.clear()

    ctl = OnlineAdmissionController(delta=5.0, eta=0.1, r0=2.0,
                                    window_jobs=16)
    front = SpotServingFrontend(server, spot_process=Exponential(1 / 3.0),
                                controller=ctl, k_cost=10.0,
                                batch_size=SERVE_B, seed=MAIN_SEED)
    torch.cuda.reset_peak_memory_stats()
    flash_attention_bh.launches = decode_attention_bh.launches = 0
    t0 = time.perf_counter()
    out = front.run_stream(Exponential(1 / 2.0), n_requests=8,
                           prompt_len=PROMPT, max_new=MAX_NEW,
                           vocab=model.cfg.vocab_size)
    wall = time.perf_counter() - t0
    flash_launches = flash_attention_bh.launches
    decode_launches = decode_attention_bh.launches
    prefills = len(server.timings)
    flash["launches"], decode["launches"] = flash_launches, decode_launches
    if flash_launches != model.cfg.num_layers * prefills:
        raise AssertionError(f"serving: {flash_launches} flash launches for "
                             f"{prefills} prefills of "
                             f"{model.cfg.num_layers} layers")
    if out["completed"] != 8 or not all(
            len(r.tokens_out) == MAX_NEW and
            all(0 <= t < model.cfg.vocab_size for t in r.tokens_out)
            for r in front.completed):
        raise AssertionError(f"serving: {out['completed']} of 8 completed "
                             "or tokens out of range")
    t = server.timings
    ttft = [x["prefill_s"] for x in t]
    prefill_tps = sum(x["batch"] * x["prompt"] for x in t) / sum(ttft)
    decode_tps = (sum(x["batch"] * x["new_tokens"] for x in t)
                  / sum(x["decode_s"] for x in t))
    step_s = [x["decode_s"] / x["new_tokens"] for x in t]
    batches = [x["batch"] for x in t]
    print(f"serving stream: {json.dumps(out)}", flush=True)
    print(f"serving: {prefills} generate calls (batches {batches}) in "
          f"{wall:.2f} s wall; TTFT {median_max(ttft)}; prefill "
          f"{prefill_tps:.0f} tokens/s; decode {decode_tps:.1f} tokens/s "
          f"(step {median_max(step_s)}); flash launches {flash_launches} "
          f"= {model.cfg.num_layers} x {prefills} prefills; decode-kernel "
          f"launches "
          f"{decode_launches} (no model calls it); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    flash.update(serving_stream=out, serving_wall_s=wall, ttft_s=ttft,
                 prefill_tokens_per_s=prefill_tps,
                 decode_tokens_per_s=decode_tps, decode_step_s=step_s,
                 batches=batches)
    return model


def phase_serving_correctness(model) -> dict:
    """Full-width prefill logits through the kernel against the plain
    version (bf16, and a float32 model of the same widths), and a
    teacher-forced check of decode_step against prefill."""
    toks = torch.as_tensor(np.random.default_rng(MAIN_SEED + 1).integers(
        2, model.cfg.vocab_size, size=(SERVE_B, PROMPT)), device=DEVICE)
    logits_k, cache = prefill_with(model, "pallas", toks, max_len=CACHE)
    logits_p, _ = prefill_with(model, "naive", toks)
    logits_c, _ = prefill_with(model, "chunked", toks)
    err = float((logits_k - logits_p).abs().max())
    floor = float((logits_c - logits_p).abs().max())
    if not (err <= LOGITS_ATOL and torch.isfinite(logits_k).all()):
        raise AssertionError(f"prefill logits kernel vs plain: max abs "
                             f"{err:.4g} > {LOGITS_ATOL}")
    print(f"prefill logits {tuple(toks.shape)} full width bf16, flash kernel "
          f"vs plain version: max abs {err:.4g} (limit {LOGITS_ATOL}); two "
          f"plain paths (chunked vs naive): {floor:.4g}; logits |max| "
          f"{float(logits_p.abs().max()):.3g}", flush=True)

    # greedy decode through the cache, then each prefix through prefill
    cur = logits_k[:, -1].argmax(-1)
    seq, dec_logits = [cur], []
    for _ in range(MAX_NEW - 1):
        lg, cache = model.decode_step({"tokens": cur[:, None]}, cache)
        dec_logits.append(lg[:, 0])
        cur = lg[:, 0].argmax(-1)
        seq.append(cur)
    worst, agree = 0.0, 0
    for t, lg in enumerate(dec_logits):
        prefix = torch.cat([toks, torch.stack(seq[:t + 1], 1)], dim=1)
        ref, _ = prefill_with(model, "naive", prefix)
        worst = max(worst, float((lg - ref[:, 0]).abs().max()))
        agree += int((lg.argmax(-1) == ref[:, 0].argmax(-1)).sum())
    share = agree / (len(dec_logits) * SERVE_B)
    print(f"teacher-forced: decode_step logits vs prefill over prompt + "
          f"generated ({PROMPT + 1}..{PROMPT + len(dec_logits)} tokens, "
          f"plain attention) at {len(dec_logits)} steps x {SERVE_B}: max "
          f"abs {worst:.4g} (limit {LOGITS_ATOL}); greedy tokens agree "
          f"{share:.4f}", flush=True)
    if not worst <= LOGITS_ATOL:
        raise AssertionError(f"teacher-forced decode: max abs {worst:.4g}")
    return {"prefill_logits_err": err, "plain_paths_logits_err": floor,
            "teacher_forced_err": worst, "teacher_forced_agree": share}


def phase_float32_prefill(result: dict) -> None:
    """The same widths in float32: prefill logits through the flash
    kernel (float32 inputs) against the plain version, to the CPU tests'
    float32 tolerance."""
    model = full_width_model("float32")
    toks = torch.as_tensor(np.random.default_rng(MAIN_SEED + 2).integers(
        2, model.cfg.vocab_size, size=(SERVE_B, PROMPT)), device=DEVICE)
    logits_k, _ = prefill_with(model, "pallas", toks)
    logits_p, _ = prefill_with(model, "naive", toks)
    a, b = logits_p.cpu().numpy(), logits_k.cpu().numpy()
    err = float(np.abs(a - b).max())
    np.testing.assert_allclose(b, a, err_msg="float32 prefill logits",
                               **LOGITS_F32)
    result["float32_prefill_logits_err"] = err
    print(f"prefill logits {tuple(toks.shape)} full width float32, flash "
          f"kernel vs plain version: max abs {err:.3g} (rtol "
          f"{LOGITS_F32['rtol']}, atol {LOGITS_F32['atol']})", flush=True)


def phase_profile(model) -> dict:
    """One generate call (prompt 512, 4 new tokens, batch 4) under
    torch.profiler: device time by kernel and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    server = BatchedServer(model, max_batch=SERVE_B, max_len=CACHE,
                           device=DEVICE)
    prompts = list(np.random.default_rng(3).integers(
        2, model.cfg.vocab_size, size=(SERVE_B, PROMPT)).astype(np.int32))
    server.generate(prompts, 4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.generate(prompts, 4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    print(f"profile: one generate (batch {SERVE_B}, prompt {PROMPT}, 4 new "
          f"tokens) {wall_us / 1e3:.1f} ms wall, device busy "
          f"{busy_us / 1e3:.1f} ms, idle share "
          f"{1 - busy_us / wall_us:.3f}", flush=True)
    for name, us, count in rows[:10]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:90]}", flush=True)
    return {"profile_wall_ms": wall_us / 1e3, "profile_busy_ms": busy_us / 1e3,
            "profile_top": [(n[:60], us / 1e3, c) for n, us, c in rows[:10]]}


def phase_attention_timings(flash: dict, decode: dict) -> None:
    """Each kernel alone by CUDA events at the serving shape and a long
    one, beside its plain version and F.scaled_dot_product_attention (the
    library yardstick, never on the port's path)."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    # flash, prefill: (B·KH, g, S, D) with g = 1 (MHA)
    for tag, B, S in (("", SERVE_B, PROMPT), ("long_", 1, LONG_S)):
        q, k, v = randn(50, bf16, (B * HEADS, 1, S, HEAD_DIM),
                        (B * HEADS, S, HEAD_DIM), (B * HEADS, S, HEAD_DIM))
        flash_attention_bh(q, k, v, causal=True)  # warm-up
        ms, out = cuda_ms(lambda: flash_attention_bh(q, k, v, causal=True), 3)
        q4, k4, v4 = (x.view(B, HEADS, S, HEAD_DIM) for x in (q, k, v))
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        lib_ms, lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 3)
        if S * S * B * HEADS * 4 <= 8 * 2**30:
            plain_ms, ref = cuda_ms(lambda: flash_attention_bh_ref(
                q, k, v, causal=True))
            hold(f"flash timing shape S={S}", ref, out)
        else:
            plain_ms = None  # the S x S float32 scores do not fit
        b_ms, b_by = flash_bound(B * HEADS, 1, S, S, HEAD_DIM, True)
        sdpa_err = float((lib.float() - out.view_as(lib).float()).abs().max())
        flash.update({f"{tag}ms": ms, f"{tag}plain_ms": plain_ms,
                      f"{tag}bound_ms": b_ms, f"{tag}bound_by": b_by,
                      f"{tag}library_ms": lib_ms})
        plain = ("n/a (S x S scores do not fit)" if plain_ms is None
                 else f"{plain_ms:.3f} ms")
        print(f"flash {tag or 'prefill_'}shape (B {B}, S {S}, H {HEADS}, D "
              f"{HEAD_DIM}, bf16, causal): kernel {ms:.3f} ms, plain {plain}"
              f", SDPA {lib_ms:.3f} ms (max abs vs kernel {sdpa_err:.3g}), "
              f"bound {b_ms:.4f} ms ({b_by}), kernel at "
              f"{100 * b_ms / ms:.2f}% of it", flush=True)
        del q, k, v, q4, k4, v4, out, lib

    # decode: (B·KH, 1, D) against (B·KH, S, D), the cache full
    for tag, B, S, bk in (("", SERVE_B, CACHE, DECODE_BLOCK),
                          ("long_", LONG_DECODE_B, LONG_S, 512)):
        q, k, v = randn(60, bf16, (B * HEADS, 1, HEAD_DIM),
                        (B * HEADS, S, HEAD_DIM), (B * HEADS, S, HEAD_DIM))
        kv_len = torch.tensor(S, dtype=torch.int32, device=DEVICE)
        decode_attention_bh(q, k, v, kv_len, block_k=bk)
        ms, out = cuda_ms(lambda: decode_attention_bh(q, k, v, kv_len,
                                                      block_k=bk), 10)
        plain_ms, ref = cuda_ms(lambda: decode_attention_bh_ref(q, k, v, S))
        hold(f"decode timing shape S={S}", ref, out)
        q4, k4, v4 = (x.view(B, HEADS, -1, HEAD_DIM) for x in (q, k, v))
        F.scaled_dot_product_attention(q4, k4, v4)
        lib_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4), 10)
        b_ms, b_by = decode_bound(B * HEADS, 1, HEAD_DIM, S)
        decode.update({f"{tag}ms": ms, f"{tag}plain_ms": plain_ms,
                       f"{tag}bound_ms": b_ms, f"{tag}bound_by": b_by,
                       f"{tag}library_ms": lib_ms})
        print(f"decode {tag or 'serving_'}shape (B {B}, S {S}, KH {HEADS}, D "
              f"{HEAD_DIM}, bf16, kv_len {S}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"kernel at {100 * b_ms / ms:.2f}% of it", flush=True)
        del q, k, v, q4, k4, v4, out, ref


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    entry = {"name": "sweep_batched_event_windows", "route": "cuda",
             "source": "src/repro_torch/kernels/sweep/csrc/sweep.cu",
             "replaces": "src/repro/kernels/sweep/sweep.py:124",
             "library_ms": None}
    phase_parity()
    phase_width(entry)
    phase_main_kernel(entry)
    phase_main_path(entry)

    flash = {"name": "flash_attention_bh", "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/"
                         "flash_attention.py:88"}
    decode = {"name": "decode_attention_bh", "route": "cuda",
              "source": "src/repro_torch/kernels/decode_attention/csrc/"
                        "decode_attention.cu",
              "replaces": "src/repro/kernels/decode_attention/"
                          "decode_attention.py:69"}
    phase_attention_parity(flash, decode)
    model = phase_serving(flash, decode)
    flash.update(phase_serving_correctness(model))
    flash.update(phase_profile(model))
    del model
    torch.cuda.empty_cache()
    phase_float32_prefill(flash)
    torch.cuda.empty_cache()
    phase_attention_timings(flash, decode)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries = [{k: e[k] for k in keys} | {
        k: v for k, v in e.items() if k not in keys}
        for e in (entry, flash, decode)]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
