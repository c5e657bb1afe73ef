"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its lines and then ``phase <name>: <s> s``, its wall
seconds; the run ends with its total; any failure raises and exits
nonzero):

1. the card (``nvidia-smi`` name and power limit) and a CUDA device check;
2. build the thirteen CUDA kernel libraries from
   ``src/repro_torch/kernels/*/csrc`` (sweep with its three traversals,
   the single queue, the market and the regions, eight times: with and
   without each of the telemetry fold (``sweep_tel``), the environment
   timeline (``sweep_env``) and the work state (``sweep_work``), and
   their pairs and triple (``sweep_tel_env``, ``sweep_tel_work``,
   ``sweep_env_work``, ``sweep_tel_env_work``); flash attention on the
   tensor cores and on the CUDA cores, decode attention, SSD on the tensor
   cores and on the CUDA cores), one ``nvcc`` each, all started together,
   with ptxas's registers, shared memory and spills (the two tensor-core
   kernels and the 112 market and region builds must spill nothing, and
   ptxas must not serialise flash's wgmma);
3. the sweep kernel against its plain PyTorch version on the card, on the
   configurations of the JAX package's kernel tests plus a bathtub spot, a
   two-point wait and an infinite wait, at ~96 lanes (8 lanes per block, so
   the lane count leaves a ragged block), rmax 8 and 1, 1,000 events (a
   256-event burn-in, a 512-event window and a tail), and from a join
   order a hair below INT32_MAX (20 windows of 128 events): integer statistics bitwise, float sums to rtol
   1e-5 (the port's tolerance against the JAX package; see
   tests/test_torch_sweep.py); then the lane-group layouts: rmax 2, 16,
   32, 33, 64, 65 and 256 and a Gamma(12) job (14 slab columns) at rmax 8,
   so that with the main paths every (G, slots a thread) pair the wrapper
   can pick (``sweep.group_size``) and the library holds is driven,
   windows of 498 events (no multiple of a draw pass) and 45 lanes (no
   multiple of 32/G), and every final budget +0 or more (the int32 order
   of their bits that the slot reductions rely on);
4. the full-width fleet through ``run_sweep``: Theorem-4 three-phase over
   r = 0.125..8 (64 points) × k ∈ {2, 5, 10, 20} × 16 seeds = 4,096 lanes,
   rmax 64, 2^20 events after a 65,536-event burn-in, held to Theorem 5
   (M/M/1/N) at the eight integer r; then the single-slot policy with a
   deterministic wait swept over 64 values at the same fleet size, rmax 1,
   held to Theorem 1.  The kernel's launch count is set to 0 just before
   each of these two calls and read just after; each must launch it once.
   Both fleets are also held, kernel against plain version, on the exact
   inputs ``run_sweep`` gives the kernel, at a cut depth (2,304 events).
   Each fleet's line names G (threads a lane, ``sweep.group_size``), the
   slots a thread and ptxas's registers for that build.
5. the flash and decode attention kernels against their plain versions on
   the JAX package's kernel-test shapes, at 16- and 48-token prompts
   (partial key tiles), GQA g 4 at D 128 with 40 and 96 query rows (rows
   that fill no 64-row warpgroup), q_offset / sk_valid, and at the serving
   shapes: flash at the prefill (B 4, S 512, H 20, D 128, bf16, causal),
   decode at (B 4, S 544, KH 20, D 128) over several fill levels; the
   split decode kernel at S 8,192 on three B·KH whose split counts differ
   (64, 13 and 2) and at the serving cache (4 splits), with kv_len at
   every split's first and last key, 0, 1 and S.  Flash
   runs both routes: every bf16 case of D 64 or 128 on the tensor cores,
   held by the floor rule (``tc_tolerance``: rtol one bf16 ulp, atol twice
   the distance between the plain version and its bf16-P twin, printed
   beside each error), and every case on the CUDA cores (float32 rtol
   1e-5, bf16 within one ulp, as before);
6. spot-aware serving on qwen1.5-4b at full width (all 40 layers, the
   published widths, bf16, random weights from a seeded generator, flash
   attention): ``SpotServingFrontend`` with the launcher's controller, 8
   requests of 512 prompt tokens and 32 new tokens, batch 4.  The flash
   kernels' launch counts are set to 0 just before the stream and read just
   after: 40 tensor-core launches a prefill, none on the CUDA cores.
   Prints TTFT and prefill and decode tokens/s;
7. serving correctness: full-width bf16 prefill logits through the flash
   kernel against the plain version (atol 0.2, see ``LOGITS_ATOL``), beside
   two plain paths against each other; a teacher-forced check of
   ``decode_step``'s logits against prefills over the prompt plus the
   generated tokens (plain attention: 513..544 tokens do not tile by 128),
   with the greedy tokens' agreement; one generate call under
   ``torch.profiler`` (device time by kernel, idle share); and the same
   widths in float32, prefill logits kernel (the CUDA-core route, 40
   launches, none on the tensor cores) against plain version to rtol 1e-4,
   atol 1e-5;
8. each attention kernel alone (CUDA events) at the serving shapes and at a
   long one (flash: one row of the prefill_32k cell, B 1, S 32,768,
   causal; decode: B 16, S 32,768 full, each line with its split count,
   its device time alone and its host time a call), beside its plain
   version where
   memory allows and ``F.scaled_dot_product_attention`` as the library
   yardstick (timed here only; the port never calls it).  Flash on both
   routes in the same run; at S 32,768 each route's last 256 query rows of
   four heads are held to the plain version on those rows;
9. the SSD kernels against their plain versions on the card: the JAX
   package's SSD test shapes and the property-test shapes in float32 and
   bf16, chunk continuity (Q 16 against Q 128, float32, and bf16 on the
   tensor cores), against the sequential recurrence; and the full-width
   layer shape (B 8, L 4,096, H 48, P 64, N 128, Q 256, bf16) against the
   chunked scan.  Every bf16 shape the tensor cores take runs on both
   routes.  The CUDA cores: float32 rtol 1e-4, bf16 rtol one ulp, each
   with an absolute floor of twice the difference between the two plain
   versions on the same inputs (``ssd_tolerance``).  The tensor cores (W,
   h_prev and the update's operand rounded to bf16): the floor rule of
   ``ssd/ref.py::tc_tolerance``, rtol one bf16 ulp and atol twice the
   larger of that float32 floor and the distance between the plain
   version and its rounding twin ``ssd_tc_twin``, printed beside each
   error;
10. mamba2-780m scoring at full width (all 48 layers, the published
   widths, random weights from a seeded generator): ``MambaLM.loss`` on a
   ``DataPipeline(seed=0)`` batch of 8 × 4,096 tokens (train_4k's length,
   its batch cut from 256 to 8) through the SSD kernel and through the
   plain chunked scan, in bf16 and in float32, one bf16 call under
   ``torch.profiler``; the SSD counts are set to 0 just before the
   kernel's call and must read 48 after it, all on the tensor cores in
   bf16 and all on the CUDA cores in float32.  On that seed and two more,
   the two bf16 losses must agree within twice the floor printed beside
   them: the spread of the loss over six plain versions at full depth (the
   chunked scan at Q 256, 128, 64 and 32, the sequential recurrence, the
   rounding twin); each line also says whether they agree within 1x.
   Float32 to rtol 1e-4;
11. spot-aware serving on mamba2-780m at full width, the stream of phase 6;
   the SSD counts (both routes) must read 0 across it (prefill takes the chunked scan, as
   in the JAX package), with a teacher-forced check of ``decode_step``
   against prefills: float32 (a twin with the same weights) to rtol 1e-4 /
   atol 1e-4 (the check of ``decode_step``); bf16 within twice the bf16
   prefill's distance from the twin's, and the twin's greedy token
   wherever the twin's top-1/top-2 margin exceeds that limit;
12. the SSD kernel alone (CUDA events) at the full-width layer shape and at
   one row of prefill_32k (B 1, L 32,768), on both routes in one run, B
   and C read in place as the model hands them over (and, on the tensor
   cores, from contiguous copies), beside the plain chunked scan and its
   bound; no single PyTorch call computes SSD (``library_ms`` null);
13. the sweep kernel's market traversal (``market_kernel``) against its
   plain version on the card: the JAX package's market kernel-test cases
   and every choice rule, the pools-config axis (per-lane prices, hazards
   with zeros, notices, spot scales), three pools whose hazard sums round
   by their order, eight pools of mixed slot processes, single-slot
   admission with and without revocation, at 96 lanes and rmax 1-33 over
   a burn-in, full windows and a tail; a join order from INT32_MAX; and
   every (G, slots a thread) layout the wrapper can pick (rmax 2 to 256),
   ptxas's registers printed for each: integers and floats bitwise
   (floats held to rtol 1e-5), final queues and pool tags bitwise;
14. the degenerate market (one pool, unit price, no hazard, a legacy
   three-phase kernel) through the market kernel against the single-queue
   kernel at the full fleet's 4,096 lanes and 69,632 events: every shared
   statistic, the final queue and clocks bitwise;
15. the market main path: ``benchmarks/market_bench.py::bench_market()``'s
   4-pool market (prices 0.5/0.3/0.2/0.1, hazards 0.02/0.05/0/0.10,
   notices 0.5/0.01/0/2.0, each pool ``Exponential(μ/4)``) with
   ``NoticeAwareKernel(checkpoint_time=0.05)`` and the cheapest rule over
   the single queue's fleet (r = 0.125..8 × k ∈ {2, 5, 10, 20} × 16 seeds
   = 4,096 lanes, rmax 64, 2^20 events after 65,536 burn-in): the kernel
   against its plain version on these inputs at cut depth (2,304 events;
   the times of both), the kernel alone at full size (CUDA events,
   lane-events/s, the bound of ``market_ops_per_lane_event``) with spot
   spend held window by window to its float32 rounding bound, then
   ``run_market_sweep`` with the launch count set to 0 just before and
   read just after (one launch): its result equal to the summary of the
   kernel's own call, completed legs = served + on-demand + resumed at
   every lane, revocations and resumes above 0, and ``avg_cost_job``
   above the preemption-priced LP floor (``core/lp.py::
   market_knapsack_lp``) at each lane's realised delay, within 5e-3·k.

16. the sweep kernel's region traversal (``region_kernel``) against its
   plain version on the card: the JAX package's test topology (regions of
   rmax 16/8/4/16, a ragged 44-slot partition) under every routing rule
   (home through a bare three-phase kernel, cheapest, fastest,
   least_loaded, uniform, weighted with per-lane logits), a routed
   single-slot kernel, the regions-config axis (per-lane prices, hazards
   with zeros, job scales, notices), a region of rmax 1 and eight regions
   of mixed processes, at 94 lanes (a ragged last warp) over a burn-in,
   full windows and a tail; a join order from INT32_MAX; and every
   (G, slots a thread) layout the wrapper can pick (2 to 256 slots),
   ptxas's registers printed for each: integers and floats bitwise, final
   queues bitwise;
17. at the full fleet's 4,096 lanes and 69,632 events, through the region
   kernel: one region of unit price and no hazard against the
   single-queue kernel, and one region of price 0.4, hazard 0.05 and
   notice 1.0 under ``NoticeAwareKernel`` against the 1-pool market
   kernel, every shared statistic and the final queue and clocks bitwise;
18. the region main path: ``benchmarks/region_bench.py::
   bench_topology(rmax=16)`` (four regions splitting λ and μ, jobs
   λ/4, λ/2, λ/8, λ/8, spot μ/4 each, prices 0.5/0.3/0.2/0.1, hazards
   0.02/0.05/0/0.10, notices 0.5/0.01/0/2.0, 64 slots) with
   ``RoutingKernel(NoticeAwareKernel(checkpoint_time=0.05),
   "least_loaded")`` over the single queue's fleet (4,096 lanes, 2^20
   events after 65,536 burn-in): the kernel against its plain version on
   these inputs at cut depth (2,304 events; both times and the bound of
   ``region_ops_per_lane_event``), the kernel alone at full size with
   spot spend held window by window to its float32 rounding bound, then
   ``run_region_sweep`` with the launch count set to 0 just before and
   read just after (one launch): its result equal to the summary of the
   kernel's own call; at every lane completed = served + on-demand +
   resumed, ``spot_served`` = Σ ``region_served``, ``jobs_arrived`` = Σ
   ``region_jobs``, ``routed_home`` ≤ admitted ≤ ``jobs_arrived``, and
   ``avg_cost_job`` above the preemption-priced pooled LP floor
   (``core/lp.py::region_knapsack_lp``) at its realised delay, within
   5e-3·k; revocations, resumes and cross-region admissions above 0;
19. the sweep kernel's three traversals with telemetry
   (``repro_torch.obs.Telemetry``) against their plain versions on the
   card: the single queue's three_phase and single_slot, the market's
   heterogeneous_notice and eight_pools_mixed, the regions' least_loaded
   and eight_regions parity configurations at their depths, each with
   ``Telemetry(trace_cap=32)`` or a narrow ``Telemetry(n_bins=16,
   wait_lo=0.1, wait_hi=100, trace_cap=8)`` whose ring wraps: every
   field bitwise, floats and rings included, and the base stats bitwise
   the same kernel's run without telemetry;
20. the four main-path fleets at full width with ``Telemetry()``: the
   kernel alone off and on in turns (off, on, on, off; the on/off ratio,
   and the bound with the fold's operations and bytes), the base stats
   bitwise the off run's; each entry point (``run_sweep`` for both
   single-queue fleets, ``run_market_sweep``, ``run_region_sweep``) with
   the launch count set to 0 just before and read just after (one
   launch), equal to the summary of the kernel's own call;
   tests/test_obs.py's ledgers and their region analogues at every lane;
   the single-slot fleet's P99 wait within a bin of its deterministic
   wait; the kernel against its plain version with ``Telemetry()`` on the
   main-path inputs over the first 256 events (every field bitwise, both
   timed); then at cut depth (2,304 events) with a ring as wide as the
   windows, every lane's P50/P90/P99 wait sketch within γ − 1 of the
   ring's exact quantiles, and lane 0's Perfetto trace well-formed;
21. the sweep kernel's three traversals with the environment timeline
   (``env=``, the ``sweep_env`` and ``sweep_tel_env`` builds) against their
   plain versions on the card at cut depth (140 events, each timeline
   scaled so that its boundaries land inside: a storm, blackouts of one
   location or of every location in turn, a price spike, every location
   dark at once, a storm that lowers a hazard), on every (G, slots a
   thread) layout of each traversal, under kernels with and without
   ``PanicKernel`` (with ``drain_dead`` in the market), with telemetry on
   one configuration of each: every field bitwise, floats, the final state
   and the shock counters included;
22. the three main-path fleets at full width (the three-phase sweep,
   ``bench_market()`` under ``PanicKernel(NoticeAwareKernel(0.05),
   drain_dead=True)``, ``bench_topology(rmax=16)`` under
   ``PanicKernel(RoutingKernel(NoticeAwareKernel(0.05), "least_loaded"))``)
   under the shock timeline (benchmarks/env_bench.py's calm/storm
   modulator over H = 0.4 × the least time a lane covers without a
   timeline, a blackout of location 0 over [0.40, 0.45]·H, a price spike
   ×3 over [0.70, 0.75]·H): the kernel under the constant timeline and
   under the shock one, and with ``Telemetry()`` under the shock one, one
   timed run each, the on/off ratios against phase 20's runs without a
   timeline (the same inputs); the constant timeline's base stats bitwise
   the run without one; each entry point
   with the launch count set to 0 just before and read just after (one
   launch), equal to the summary of the kernel's own call; at every lane
   every boundary crossed, the storms, blackouts and spikes observed equal
   to the timeline's, degraded admissions within shock arrivals, storm and
   blackout time within their float32 rounding bound of the segments'
   length, and the ledgers of PERF.md §2; the kernel against its plain
   version with the env state and ``Telemetry()`` on the main-path inputs
   over 256 events (the timeline scaled into them), every field bitwise;
23. the sweep kernel's three traversals with the work state (``work=``,
   the four ``*_work`` builds) against their plain versions on the card
   at cut depth (48 events): each of work alone, with telemetry, with the
   env timeline and with both, × the three checkpoint modes (never,
   notice, periodic), on the traversal's (G, slots a thread) layouts in
   turn, with and without ``CantBeLateKernel``: every field bitwise, the
   final work state and the survival ledger included; and ``WorkModel()``
   on each work build, its state and stats bitwise the build's without
   the work state;
24. the three main-path fleets at full width with the work state: the
   kernel under ``WorkModel()`` (base stats bitwise phase 20's off run)
   and under benchmarks/deadline_bench.py's priced model
   (``WorkModel.on_notice(0.2, total_work=3, restart_overhead=0.5,
   deadline=120, od_time=10)``), one timed run each, the on/off ratios
   against phase 20's off runs; the market again under the priced model
   with ``CantBeLateKernel`` (buffer 0.2 h: its misses at most its resumes
   at every lane and fewer than without it; buffer 5.2 h, which covers a
   resume's drop of slack: no miss at any lane) and under a model without
   restart overhead (work lost = recomputed at every lane and window);
   every finished job on time or late, every admission finished or still
   queued, at every lane; each entry point with the launch count set to 0
   just before and read just after (one launch), equal to the summary of
   the kernel's own call; the kernel against its plain version with the
   priced model and ``Telemetry()`` over 128 events; tests/test_work.py's
   k80 tournament at one lane through ``run_market_sim``, the base kernel
   and the safety net each equal to the plain version on every key, no
   miss under the safety net, its cost below the all-on-demand floor.

25. the sweep kernel's split traversal (``rng="split"``, the JAX package's
   default stream: ``sweep_kernel`` walks each lane's per-event key ladder
   itself, a run-time flag of every build) against its plain version at
   cut depth (100 events: a burn-in, two windows and a tail, 70 lanes):
   every (G, slots a thread) pick, each wait family (a swept exponential
   rate, the family's own, which XLA multiplies by its reciprocal, two
   points, infinite, a swept deterministic wait), the bathtub, uniform and
   deterministic processes, and the seven combinations of telemetry, env
   and work (under ``CantBeLateKernel``) on the layouts in turn: every
   field bitwise, the final lane keys included;
26. the two single-queue fleets of phase 4 on the split stream at full
   width: the kernel alone on the slab and the split stream in turns
   (slab, split, split, slab; the split/slab ratio, the bound recounted
   with the ladder's hashes), the kernel against its plain version on the
   main path's inputs over 256 events (every field bitwise, both timed),
   then ``run_sweep(rng="split")`` with the launch count set to 0 just
   before and read just after (one launch), equal to the summary of the
   kernel's own call, held to Theorems 5 and 1;
27. the market kernel's split traversal (``market_kernel``'s run-time
   split flag: the 5-way ladder, every pool's spot and hazard clock drawn
   in the pass, the preemption clocks a vector of P) against its plain
   version at cut depth (68 events: a burn-in, two windows and a tail, 70
   lanes): every (G, slots a thread) pick, every choice rule (uniform at
   P 1, 3, 5 and 8, weighted with per-lane logits), both market kernels,
   legacy three-phase and single-slot kernels, single-slot admission with
   an unswept exponential wait, mixed slot processes, the pools-config
   axis; then telemetry, the env timeline under
   ``PanicKernel(drain_dead=True)``, the work state under
   ``CantBeLateKernel`` and all three at once on the cases in turn: every
   field bitwise, the preemption clocks and the final lane keys included;
28. the 1-pool zero-hazard market (a legacy three-phase kernel) through
   the market kernel's split traversal against the single-queue kernel's
   split traversal at 4,096 lanes × 1,088 events: every shared statistic,
   the final queue, clocks and lane keys bitwise;
29. the market main path (phase 15's fleet) on the split stream at full
   width: the kernel alone on the slab and the split stream in turns
   (slab, split, split, slab; the split/slab ratio, the bound recounted
   with the hashes of ``split_market_hashes``), spot spend held window by
   window, the kernel against its plain version on the main path's inputs
   over 64 events (every field bitwise, both timed), then
   ``run_market_sweep(rng="split")`` with the launch count set to 0 just
   before and read just after (one launch), equal to the summary of the
   kernel's own call, completed legs = served + on-demand + resumed at
   every lane and ``avg_cost_job`` above the preemption-priced LP floor
   within 5e-3·k.

The next-to-last line is a JSON object describing the ported kernels
(times, bound, launches, error against the plain version; flash and SSD
with each route's time and launches; the sweep's three traversals as
three entries, each with its telemetry time, bound, on/off ratio and
launches, its env time, bound, on/off ratios and launches, and its work
time, bound, on/off ratios and launches; the single queue's and the
market's split traversals as two more); the last is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import re
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
from repro_torch.core.cost import all_ondemand_cost  # noqa: E402
from repro_torch.core.engine import (MarketWindowStats,  # noqa: E402
                                     RegionWindowStats, WindowStats,
                                     _broadcast_config_params,
                                     _broadcast_market_params,
                                     _engine_layout, _flat_lane_args,
                                     _lane0, _lane_tensors, _market_layout,
                                     _region_layout, _config_tensors,
                                     _window_plan, init_engine_state,
                                     init_market_state, init_region_state,
                                     run_market_sim, run_market_sweep,
                                     run_region_sweep,
                                     run_sweep, summarize, summarize_market,
                                     summarize_region)
from repro_torch.core.env import (SEG_BLACKOUT, SEG_STORM,  # noqa: E402
                                  EnvTimeline, Regime, init_env_state,
                                  inject_blackout, inject_price_spike,
                                  inject_storm, markov_timeline,
                                  timeline_from_trace)
from repro_torch.core.lp import (market_knapsack_lp,  # noqa: E402
                                 region_knapsack_lp)
from repro_torch.core.market import (NoticeAwareKernel,  # noqa: E402
                                     PanicKernel, PoolChoiceKernel,
                                     SpotMarket, SpotPool)
from repro_torch.core.regions import (Region, RegionTopology,  # noqa: E402
                                      RoutingKernel)
from repro_torch.core.policies import (SingleSlotKernel,  # noqa: E402
                                       ThreePhaseKernel)
from repro_torch.core.waittime import (DeterministicWait,  # noqa: E402
                                       ExponentialWait, InfiniteWait,
                                       TwoPointWait)
from repro_torch.core.work import (CantBeLateKernel,  # noqa: E402
                                   WorkModel, init_work_state)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sweep import sweep  # noqa: E402
from repro_torch.kernels.sweep.ref import (  # noqa: E402
    batched_event_windows_ref, market_event_windows_ref,
    region_event_windows_ref)
from repro_torch.cluster.orchestrator import (  # noqa: E402
    OnlineAdmissionController)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention as decode_mod)
from repro_torch.kernels.decode_attention.decode_attention import (  # noqa: E402,E501
    decode_attention_bh)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_bh_ref, decode_attention_ref, split_keys)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_mod)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402,E501
    flash_attention_bh, flash_attention_simt, flash_attention_tc, route)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, flash_attention_bh_ref, from_groups, tc_tolerance,
    to_groups)
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ssd as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd.ref import (ssd_chunked, ssd_ref,  # noqa: E402
                                         ssd_tc_twin)
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    tc_tolerance as ssd_tc_tolerance)
from repro_torch.kernels.ssd.ssd import (ssd_cuda, ssd_simt,  # noqa: E402
                                         ssd_tc)
from repro_torch.layers.norms import rms_norm  # noqa: E402
from repro_torch.layers.ssm import mamba_block  # noqa: E402
from repro_torch.models.base import cross_entropy_chunked  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs import (Telemetry, device_trace_records,  # noqa: E402
                             summarize_telemetry, to_perfetto)
from repro_torch.obs.shocks import EnvWindowStats  # noqa: E402
from repro_torch.obs.stats import drop_windows  # noqa: E402
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


#: INT32 instructions of one threefry-2x32 hash of a counter (0, c) as
#: sm_90 runs csrc/sweep.cu's ``threefry_pair``: 20 rounds of three (the
#: add, the rotate by a constant as one funnel shift, the xor), x1's five
#: key injections with their round constants as five three-input adds,
#: x0's last injection (its other four fold into the next round's add), and
#: the counter's add.  A key's parity (k0 ^ k1 ^ C, one three-input xor) is
#: counted once a key, apart from the hash.
HASH_INT32 = 67
#: INT32 instructions of a slab column: the hash, the xor that keeps one
#: word, and u01's shift (the lane key's parity is a window's, not a
#: column's)
COLUMN_INT32 = HASH_INT32 + 2


def ops_per_lane_event(rmax: int, n_cols: int) -> tuple[int, int]:
    """(INT32, FP32) operations one lane-event needs, counted from the
    plain version's arithmetic, by the type of the data they work on, the
    hashes at the instructions sm_90 runs them in.

    Per slab column: :data:`COLUMN_INT32` INT32 and 2 FP32 (convert,
    scale).  Per slot: 16 INT32 (the first-free and FIFO arg-min
    compares and index selects, the masked order select, the one-hot
    compares, the join/leave masks, the occupancy and order updates) and
    11 FP32 (the masked budget select and compare, the age and budget
    updates, the two one-hot reads, the join writes).  Per event: 28 INT32
    (event-kind logic, admission masks, counters, queue length) and 36
    FP32 (clock merge, admission probability, two samplers with log1p
    counted as one, clock updates, four float sums)."""
    return (COLUMN_INT32 * n_cols + 16 * rmax + 28,
            2 * n_cols + 11 * rmax + 36)


def bytes_moved(lanes: int, rmax: int, n_windows: int) -> int:
    """Bytes the function must move: each lane's state and params read once
    (keys, clocks, slot arrays, k and two policy params, window keys) and
    its final state and per-window statistics written once."""
    state = 4 * 4 + rmax * (4 + 4 + 1 + 4)
    reads = state + 8 + 12 + n_windows * 8
    writes = state + n_windows * 10 * 4
    return lanes * (reads + writes)


def bound_ms(lanes: int, plan, ops: tuple[int, int],
             n_bytes: int) -> tuple[float, str]:
    """The least time the card could take for a run of ``lanes`` lanes over
    ``plan`` that does ``ops`` (INT32, FP32) operations a lane-event and
    moves ``n_bytes``: the larger of the operation time and the byte time,
    and which one it is.  The operation time is the larger of the INT32
    count over the INT32 rate, the FP32 count over the FP32 rate, and both
    over the FP32 rate (one warp instruction a scheduler a clock issues
    either kind)."""
    n_int, n_fp = (lanes * sum(plan) * n for n in ops)
    t_ops = max(n_int / PEAK_INT32, (n_int + n_fp) / PEAK_FP32)
    t_bytes = n_bytes / PEAK_BYTES
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


def queued_ms(fn, repeat: int) -> float:
    """Device time of ``fn()`` (mean over ``repeat``) with every launch
    queued behind a sleep kernel before the first event runs, so that the
    host's time to launch does not show: the device's time alone."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms of cycles: the host gets ahead
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


def host_us(fn, repeat: int) -> float:
    """Host time a call of ``fn()`` in µs (mean over ``repeat`` calls
    launched back to back, no synchronisation inside the loop): what a
    caller waits before it can launch the next operation."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / repeat * 1e6


def fleet(job, spot, kernel, rmax, params, lanes, seed, device=None):
    """Lane state and per-lane params for a direct kernel call:
    ``params`` maps names to per-lane values (nested for the wait
    family)."""
    device = device or DEVICE
    keys = threefry.split(threefry.key(seed, device), lanes)
    k = torch.full((lanes,), 10.0, dtype=torch.float32, device=device)

    def lanewise(p):
        return {n: lanewise(v) if isinstance(v, dict) else
                torch.as_tensor(np.resize(np.float32(v), lanes),
                                device=device).contiguous()
                for n, v in p.items()}

    return (init_engine_state(keys, job, spot, rmax),
            lanewise(params), k)


def compare(name: str, ref, ker, fin_ref=None, fin_ker=None) -> float:
    """Integer statistics bitwise, float sums to RTOL (the fields of either
    traversal's window stats), and the final queue where the final states
    are given; returns the largest relative float difference."""
    worst = 0.0
    for field in ref._fields:
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
    if fin_ref is not None:
        for field in ("occ", "pool", "order", "next_seq", "qlen"):
            if field in fin_ref._fields and not torch.equal(
                    getattr(fin_ref, field), getattr(fin_ker, field)):
                raise AssertionError(f"{name}: final {field} differs")
    return worst


def max_abs(ref, ker) -> float:
    """The largest absolute difference of the float window sums."""
    return max(float((getattr(ref, f).double() - getattr(ker, f).double())
                     .abs().max())
               for f in ref._fields if getattr(ref, f).is_floating_point())


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
    plan = _window_plan(1_000, 512, 256)
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

    # an unswept exponential wait at a rate whose float32 reciprocal is
    # inexact: the kernel multiplies by it as the plain version does
    kernel = SingleSlotKernel(wait=ExponentialWait(1 / 3))
    state0, p, k = fleet(JOB, SPOT, kernel, 1, {}, 97, 7)
    args = (JOB, SPOT, kernel, 1, state0, p, k, plan)
    hold_all("parity unswept exponential wait 1/3",
             batched_event_windows_ref(*args),
             sweep.batched_event_windows(*args))
    print(f"parity unswept exponential wait 1/3: 97 lanes rmax 1 plan "
          f"{plan}: every field bitwise", flush=True)

    # the join order starts a hair below INT32_MAX: without the per-window
    # rebase it would wrap within a few windows
    job = spot = Exponential(1.0)
    kernel, rmax, plan = ThreePhaseKernel(), 8, _window_plan(2_560, 128, 0)
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


#: the lane-group layouts: (name, job, spot, kernel, rmax, params); each
#: runs on every G the wrapper can pick at its rmax
LAYOUT_CASES = [
    ("rmax2_exp_wait", Exponential(LAM), Exponential(MU),
     SingleSlotKernel(wait=ExponentialWait(0.5)), 2, {}),
    ("rmax16", Exponential(LAM), Exponential(MU), ThreePhaseKernel(), 16,
     {"r": np.linspace(1.0, 14.0, 9)}),
    ("rmax32", Exponential(LAM), Exponential(MU), ThreePhaseKernel(), 32,
     {"r": np.linspace(1.0, 30.0, 9)}),
    ("rmax33", Exponential(LAM), Exponential(MU), ThreePhaseKernel(), 33,
     {"r": np.linspace(1.0, 30.0, 9)}),
    ("rmax64", Exponential(LAM), Exponential(MU), ThreePhaseKernel(), 64,
     {"r": np.linspace(1.0, 60.0, 9)}),
    ("rmax65", Exponential(LAM), Exponential(MU), ThreePhaseKernel(), 65,
     {"r": np.linspace(1.0, 60.0, 9)}),
    ("rmax256_bathtub", Exponential(LAM), BathtubGCP(), ThreePhaseKernel(),
     256, {"r": np.linspace(1.0, 250.0, 9)}),
    ("gamma12_14_cols", Gamma(12.0, 1.0), Exponential(MU),
     ThreePhaseKernel(), 8, {"r": np.linspace(0.0, 3.0, 9)}),
]
#: windows of 498 events: no multiple of a draw pass (21, 32 or 4 events
#: at 3, 2 or 14 columns), after a 150-event burn-in
LAYOUT_PLAN = _window_plan(996, 498, 150)
LAYOUT_LANES = 45  # no multiple of 32/G for G < 32


def picked_layout(rmax: int) -> tuple[int, int]:
    """(G, slots a thread) of the wrapper's pick at rmax."""
    g = sweep.group_size(rmax)
    return g, sweep.slots_per_thread(rmax, g)


def ends_on_a_short_pass(what: str, plan: tuple[int, ...],
                         per_pass: int) -> None:
    """Raise unless every window of ``plan`` ends on a short draw pass (no
    window a multiple of the ``per_pass`` events a pass draws) and some
    window spans more than one pass: what a cut plan must keep of the
    deeper plan it replaced."""
    if any(n % per_pass == 0 for n in plan) or max(plan) <= per_pass:
        raise AssertionError(f"{what}: plan {plan} against passes of "
                             f"{per_pass} events")


def phase_layouts() -> None:
    """Every lane-group layout the wrapper can pick against the plain
    version: ints bitwise, floats to RTOL, every final budget +0 or more;
    with the main paths, every (G, slots a thread) pair it can pick (and,
    where this run compiled the library, every instantiation ptxas saw)."""
    picks = {picked_layout(rmax) for rmax in range(1, sweep.MAX_RMAX + 1)}
    driven = {picked_layout(rmax) for *_, rmax in MAIN_PATHS}
    for name, job, spot, kernel, rmax, params in LAYOUT_CASES:
        init_job = Exponential(LAM) if isinstance(job, Gamma) else job
        state0, p, k = fleet(init_job, spot, kernel, rmax, params,
                             LAYOUT_LANES, 11)
        n_cols = _engine_layout(job, spot, kernel).n_cols
        ends_on_a_short_pass(f"layout {name}", LAYOUT_PLAN, 64 // n_cols)
        args = (job, spot, kernel, rmax, state0, p, k, LAYOUT_PLAN)
        _, ref = batched_event_windows_ref(*args)
        fin, ker = sweep.batched_event_windows(*args)
        torch.cuda.synchronize()
        g, spt = picked_layout(rmax)
        driven.add((g, spt))
        worst = compare(f"layout {name}", ref, ker)
        if bool(torch.signbit(fin.budgets).any()):
            raise AssertionError(f"layout {name}: a budget with its sign "
                                 f"bit set")
        print(f"layout {name}: rmax {rmax}, {n_cols} columns, "
              f"{LAYOUT_LANES} lanes, plan {LAYOUT_PLAN}, G {g} ({spt} "
              f"slots a thread): ints bitwise, max rel float diff "
              f"{worst:.3g}, budgets >= +0", flush=True)
    if driven != picks or (SWEEP_PTXAS and set(SWEEP_PTXAS) != picks):
        raise AssertionError(f"sweep layouts driven {sorted(driven)}, "
                             f"picked {sorted(picks)}, built "
                             f"{sorted(SWEEP_PTXAS)}")


# the full-width fleets: (r or wait) × k × seeds = 64 × 4 × 16 = 4,096 lanes
R_GRID = np.arange(1, 65) * 0.125
WAITS = np.linspace(0.0, 48.0, 64)
K_GRID = np.array([2.0, 5.0, 10.0, 20.0])
N_SEEDS, N_EVENTS, BURN_IN = 16, 2**20, 65_536
MAIN_SEED = 2026
WIDTH_PLAN = (256, 1_024, 1_024)
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
    return state0, params_l, k_l


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
        b_ms, b_by = bound_ms(lanes, WIDTH_PLAN,
                              ops_per_lane_event(rmax, n_cols),
                              bytes_moved(lanes, rmax, len(WIDTH_PLAN)))
        err = max_abs(ref, ker)
        g, spt = picked_layout(rmax)
        entry.update({f"group_{name}": g, f"slots_a_thread_{name}": spt,
                      f"ptxas_{name}": SWEEP_PTXAS.get((g, spt))})
        if name == "three_phase":
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err)
        else:
            entry.update({f"{name}_ms": ms, f"{name}_plain_ms": plain_ms,
                          f"{name}_bound_ms": b_ms,
                          f"{name}_max_abs_err": err})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        print(f"width {name}: {lanes} lanes rmax {rmax} plan {WIDTH_PLAN}, G "
              f"{g} ({spt} slots a thread; ptxas: "
              f"{SWEEP_PTXAS.get((g, spt))}): "
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
        b_ms, _ = bound_ms(lanes, plan, ops_per_lane_event(rmax, n_cols),
                          bytes_moved(lanes, rmax, len(plan)))
        rate = lanes * sum(plan) / (ms / 1e3)
        entry.update({f"main_{name}_ms": ms, f"main_{name}_bound_ms": b_ms,
                      f"main_{name}_lane_events_per_s": rate,
                      f"main_{name}_key_ladder_ms": ladder_ms})
        print(f"main-size kernel {name}: {lanes} lanes × {sum(plan)} events "
              f"rmax {rmax}, G {sweep.group_size(rmax)}, in {ms:.1f} ms = "
              f"{rate:.4g} lane-events/s "
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

    hold_theory(out["three_phase"], out["single_slot"])


def hold_theory(tp: dict, ss: dict) -> None:
    """The two main-path fleets' results: finite, of the grid's shape, the
    three-phase fleet within 5e-3·k of Theorem 5 at the eight integer r and
    the single-slot fleet within 5e-3·k of Theorem 1 at every wait."""
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

#: ptxas's report of each sweep instantiation, (G, slots a thread) -> line
SWEEP_PTXAS: dict[tuple[int, int], str] = {}
#: ... of each telemetry instantiation (sweep.TEL_LIBRARY), by kernel name
TEL_PTXAS: dict[str, dict[tuple[int, int], str]] = {}


def sweep_ptxas(report: str, kernel: str = "sweep_kernel"
                ) -> dict[tuple[int, int], str]:
    """(G, SPT) -> ptxas's registers and spills line of that instantiation
    of ``kernel`` (``sweep_kernel<G, SPT, TEL, ENV, WORK>``,
    ``market_kernel`` or ``region_kernel``, mangled
    ``ILiGELiSPTELbTELELbENVELbWORKE``; a library holds one TEL, one ENV
    and one WORK)."""
    out, key = {}, None
    pattern = re.compile(rf"{kernel}ILi(\d+)ELi(\d+)E")
    for line in report.splitlines():
        if "Compiling entry" in line:
            m = pattern.search(line)
            key = (int(m.group(1)), int(m.group(2))) if m else None
        elif key and ("Used" in line or "spill" in line):
            out[key] = (out.get(key, "") + " "
                        + line.split(":", 1)[-1].strip()).strip()
    return out


def tel_slice_bytes(n_bins: int, events_a_pass: int) -> int:
    """Shared memory a lane's telemetry slice takes in csrc/sweep.cu
    (``tel_stride`` int32 words: two histograms, two location counts of
    kMaxLocs, four words for each event a pass stages: kDraws 64 in the
    single queue, kMarketPass 16 in the market and regions)."""
    return 4 * ((2 * n_bins + 2 * sweep.MAX_POOLS + 4 * events_a_pass) | 1)


def no_spill(line: str) -> bool:
    return "0 bytes spill stores, 0 bytes spill loads" in line


def phase_build() -> None:
    """Every kernel library, one nvcc each, all started together."""
    t0 = time.perf_counter()
    builds = {lib: key for key, lib in sweep.LIBRARIES.items()}
    results = _build.build(*builds, flash_mod.TC_LIBRARY, flash_mod.LIBRARY,
                           decode_mod.LIBRARY, ssd_mod.TC_LIBRARY,
                           ssd_mod.LIBRARY, verbose=True)
    for res in results:
        print(f"built {res.library.path.name}: nvcc {res.seconds:.1f} s",
              flush=True)
        if res.library in builds:
            # one instantiation a (G, slots a thread) the wrapper can pick
            tel, env, work = builds[res.library]
            tables = {name: sweep_ptxas(res.ptxas, name)
                      for name in ("sweep_kernel", "market_kernel",
                                   "region_kernel")}
            if work:
                WORK_PTXAS.update({(tel, env, n): t
                                   for n, t in tables.items()})
            elif env:
                ENV_PTXAS.update({(tel, n): t for n, t in tables.items()})
            elif tel:
                TEL_PTXAS.update(tables)
            else:
                SWEEP_PTXAS.update(tables["sweep_kernel"])
                MARKET_PTXAS.update(tables["market_kernel"])
                REGION_PTXAS.update(tables["region_kernel"])
            for name, table in tables.items():
                for key, line in sorted(table.items()):
                    print(f"  {name}<G {key[0]}, SPT {key[1]}, TEL "
                          f"{str(tel).lower()}, ENV {str(env).lower()}, WORK "
                          f"{str(work).lower()}>: {line}", flush=True)
            # the market and region builds must not spill, in any of the
            # eight builds
            for name in ("market_kernel", "region_kernel"):
                for key, line in tables[name].items():
                    if not no_spill(line):
                        raise AssertionError(
                            f"{name}<G {key[0]}, SPT {key[1]}, TEL {tel}, "
                            f"ENV {env}, WORK {work}>: {line}")
            continue
        for line in res.ptxas.splitlines():
            if any(w in line for w in ("Used", "spill", "Compiling",
                                       "(C75")):
                print(f"  {line.strip()}", flush=True)
            if res.library not in (flash_mod.TC_LIBRARY, ssd_mod.TC_LIBRARY):
                continue
            # the tensor-core kernels must neither spill nor have ptxas
            # serialise flash's wgmma (C7508-C7518: setmaxnreg ignored, a
            # wait injected, products serialised)
            if ("spill" in line and " 0 bytes spill stores, 0 bytes spill "
                    "loads" not in line) or any(
                        f"(C75{n:02d})" in line for n in range(8, 19)):
                raise AssertionError(f"the tensor-core kernel "
                                     f"{res.library.name}: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s wall for all "
          f"{len(results)}; dynamic shared memory a block: flash on the "
          f"tensor cores {flash_mod.tc_smem_bytes(HEAD_DIM)} B (bf16, D "
          f"{HEAD_DIM}), on the CUDA cores "
          f"{flash_mod.smem_bytes(torch.bfloat16, HEAD_DIM)} B (bf16), "
          f"{flash_mod.smem_bytes(torch.float32, HEAD_DIM)} B (f32); decode "
          f"{decode_mod.smem_bytes(torch.bfloat16, 1, HEAD_DIM)} B (bf16, g "
          f"1), {decode_mod.smem_bytes(torch.float32, 1, HEAD_DIM)}"
          f" B (f32); SSD on the tensor cores {ssd_mod.tc_smem_bytes(SSD_Q)} "
          f"B, on the CUDA cores {ssd_mod.smem_bytes(SSD_Q)} B (Q {SSD_Q}); "
          f"the sweep's telemetry slice a lane at 64 bins "
          f"{tel_slice_bytes(64, 64)} B (single queue), "
          f"{tel_slice_bytes(64, 16)} B (market, regions); its work slice a "
          f"lane of 64 slots {4 * (3 * 64 + 1)} B", flush=True)


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


def hold_tc(name, plain, twin, got) -> tuple[float, float]:
    """A tensor-core flash output against the float32 plain version, by the
    floor rule (``tc_tolerance``: rtol one bf16 ulp, atol the larger of
    F32_ATOL and twice the distance between ``twin``, the plain version
    rounding P to bf16 where the kernel does, and ``plain``); returns (max
    abs difference, floor)."""
    if got.dtype != plain.dtype or got.shape != plain.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{plain.dtype} {tuple(plain.shape)}")
    tol, floor = tc_tolerance(plain, twin)
    a, b = plain.float().cpu().numpy(), got.float().cpu().numpy()
    if not np.all(np.isfinite(b)):
        raise AssertionError(f"{name}: non-finite output")
    np.testing.assert_allclose(b, a, err_msg=f"{name} (floor {floor:.3g})",
                               **tol)
    return float(np.abs(a - b).max()), floor


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


#: tensor-core cases beyond the test shapes (B, Sq, Sk, H, KH, D, causal,
#: bq, bk, q_offset, sk_valid): GQA g 4 at D 128 with 40 and 96 query rows
#: (no 64-row warpgroup filled), and offset / valid keys at D 128 and 64
FA_TC_CASES = [
    (2, 40, 40, 16, 4, 128, True, 128, 128, 0, None),
    (2, 96, 96, 16, 4, 128, True, 128, 128, 0, None),
    (1, 64, 192, 4, 2, 128, True, 32, 64, 40, 150),
    (1, 64, 192, 4, 2, 64, False, 32, 64, 40, 150),
]


def phase_attention_parity(flash: dict, decode: dict) -> None:
    """Each kernel through its entry point against its plain version on
    the card; flash on both routes.  Its launch counts over these calls are
    reported apart from the main path's."""
    worst_d = 0.0
    worst = {"tc": 0.0, "simt": 0.0}
    worst_floor = 0.0
    flash_attention_bh.launches = decode_attention_bh.launches = 0
    flash_attention_tc.launches = flash_attention_simt.launches = 0

    def check(name, q, k, v, **kw):
        """``q, k, v`` through the entry point ops.flash_attention, and for
        bf16 of D 64 or 128 (the tensor cores there) on the CUDA cores too:
        the tensor cores by the floor rule, the CUDA cores by ``hold``."""
        nonlocal worst_floor
        blocks = {n: kw.pop(n) for n in ("block_q", "block_k") if n in kw}
        plain = attention_ref(q, k, v, **kw)
        routes = (("tc", "simt") if route(q.dtype, q.shape[-1]) == "tc"
                  else ("simt",))
        for r in routes:
            if r == routes[0]:
                got = fa_ops.flash_attention(q, k, v, **blocks, **kw)
            else:
                got = from_groups(flash_attention_bh(
                    *to_groups(q, k, v), route=r, **blocks, **kw), q.shape[0])
            if r == "tc":
                twin = attention_ref(q, k, v, p_dtype=torch.bfloat16, **kw)
                err, floor = hold_tc(f"{name} tc", plain, twin, got)
                worst_floor = max(worst_floor, floor)
            else:
                err = hold(f"{name} simt", plain, got)
            worst[r] = max(worst[r], err)

    for i, (B, Sq, Sk, H, KH, D, causal, bq, bk) in enumerate(FA_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = randn(10 + i, dtype, (B, Sq, H, D), (B, Sk, KH, D),
                            (B, Sk, KH, D))
            check(f"flash case {i} {dtype}", q, k, v, causal=causal,
                  block_q=bq, block_k=bk, q_offset=Sk - Sq if causal else 0)
    q, k, v = randn(20, torch.float32, (1, 64, 4, 32), (1, 192, 2, 32),
                    (1, 192, 2, 32))
    for causal in (True, False):
        check(f"flash offset/valid causal={causal}", q, k, v, block_q=32,
              block_k=64, causal=causal, q_offset=40, sk_valid=150)
    for i, (B, Sq, Sk, H, KH, D, causal, bq, bk, off, valid) in enumerate(
            FA_TC_CASES):
        q, k, v = randn(24 + i, torch.bfloat16, (B, Sq, H, D),
                        (B, Sk, KH, D), (B, Sk, KH, D))
        check(f"flash tensor-core case {i}", q, k, v, causal=causal,
              block_q=bq, block_k=bk, q_offset=off, sk_valid=valid)
    # the launcher's 16-token prompts: one tile of 16 keys (a partial
    # 32-key sub-tile on the CUDA cores, a partial 128-key tile on the
    # tensor cores)
    for S in (16, 48):
        q, k, v = randn(22, torch.bfloat16, *[(4, S, HEADS, HEAD_DIM)] * 3)
        check(f"flash S={S}", q, k, v, causal=True)
    q, k, v = randn(21, torch.bfloat16, *[(SERVE_B, PROMPT, HEADS,
                                           HEAD_DIM)] * 3)
    check("flash prefill shape", q, k, v, causal=True)
    print(f"parity flash: {len(FA_CASES)} test shapes x f32/bf16, offset + "
          f"valid keys, {len(FA_TC_CASES)} tensor-core shapes (GQA g 4, D "
          f"128, 40 and 96 rows; offset + valid at D 128 and 64), S 16 and "
          f"48, prefill {tuple(q.shape)} bf16 causal: tensor cores max abs "
          f"diff {worst['tc']:.3g} (largest floor {worst_floor:.3g}, limit "
          f"twice it), CUDA cores {worst['simt']:.3g}; launches "
          f"{flash_attention_tc.launches} tensor-core, "
          f"{flash_attention_simt.launches} CUDA-core", flush=True)

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
    split_calls = phase_decode_splits()
    torch.cuda.synchronize()
    flash.update(max_abs_err=max(worst.values()), tc_max_abs_err=worst["tc"],
                 tc_floor=worst_floor, simt_max_abs_err=worst["simt"],
                 parity_launches=flash_attention_bh.launches,
                 tc_parity_launches=flash_attention_tc.launches,
                 simt_parity_launches=flash_attention_simt.launches)
    worst_d = max(worst_d, split_calls.pop("worst"))
    decode.update(max_abs_err=worst_d,
                  entry_point_launches=decode_attention_bh.launches
                  - split_calls["calls"])
    print(f"parity decode: {len(DEC_CASES)} test shapes x f32/bf16, serving "
          f"cache {tuple(k.shape)} bf16 at kv_len {fills}, "
          f"{split_calls['calls']} calls at split edges: max abs diff "
          f"{worst_d:.3g}; launches through ops.decode_attention "
          f"{decode['entry_point_launches']}", flush=True)


#: the split decode kernel's edge cases: (BH, g, S, D, block_k); the
#: wrapper's split counts are 64, 13, 2 and 4
DEC_SPLIT_CASES = [
    (6, 4, 8_192, 128, 512),
    (320, 4, 8_192, 64, 512),
    (2_048, 1, 8_192, 32, 512),
    (SERVE_B * HEADS, 1, CACHE, HEAD_DIM, DECODE_BLOCK),
]


def split_fills(s: int, n_split: int) -> list[int]:
    """kv_len 0, 1, S and every split's first and last key."""
    kps = split_keys(s, n_split)
    fills = {0, 1, s}
    for j in range(n_split):
        if j * kps < s:
            fills |= {j * kps, min(s, (j + 1) * kps) - 1}
    return sorted(fills)


def phase_decode_splits() -> dict:
    """The split decode kernel at every split edge of the wrapper's split
    count for several shapes, in both types, against the unsplit plain
    version; zeros at kv_len 0."""
    worst, calls = 0.0, 0
    for i, (bh, g, S, D, bk) in enumerate(DEC_SPLIT_CASES):
        ns = decode_mod.split_count(S, bh)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = randn(70 + i, dtype, (bh, g, D), (bh, S, D), (bh, S, D))
            for kvl in split_fills(S, ns):
                got = decode_attention_bh(q, k, v, kvl, block_k=bk)
                worst = max(worst, hold(
                    f"decode split S {S} n_split {ns} kv_len {kvl} {dtype}",
                    decode_attention_bh_ref(q, k, v, kvl), got))
                if kvl == 0 and float(got.float().abs().max()) != 0.0:
                    raise AssertionError(f"decode split n_split {ns} kv_len "
                                         f"0: output not zero")
                calls += 1
            del q, k, v
        print(f"parity decode splits: BH {bh}, g {g}, S {S}, D {D}, tile "
              f"{bk}, f32/bf16, n_split {ns} ({split_keys(S, ns)} keys a "
              f"split), kv_len at every split's first and last key, 0, 1 "
              f"and S", flush=True)
    return {"worst": worst, "calls": calls}


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


def serve_stream(model, name: str, kernels) -> tuple[dict, dict, dict]:
    """The spot-aware frontend on ``model``: a warm-up generate at the
    stream's shapes, then 8 requests of PROMPT tokens and MAX_NEW new ones,
    batch 4, the launcher's controller.  The launch counts of ``kernels``
    (wrappers) are set to 0 just before the stream and read just after.
    Returns (the stream summary, launches by wrapper name, the timings)."""
    server = BatchedServer(model, max_batch=SERVE_B, max_len=CACHE,
                           device=DEVICE)
    # warm-up outside the stream: cuBLAS handles and the kernels' first
    # launches, at the stream's shapes
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
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = front.run_stream(Exponential(1 / 2.0), n_requests=8,
                           prompt_len=PROMPT, max_new=MAX_NEW,
                           vocab=model.cfg.vocab_size)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    if out["completed"] != 8 or not all(
            len(r.tokens_out) == MAX_NEW and
            all(0 <= t < model.cfg.vocab_size for t in r.tokens_out)
            for r in front.completed):
        raise AssertionError(f"{name} serving: {out['completed']} of 8 "
                             "completed or tokens out of range")
    t = server.timings
    ttft = [x["prefill_s"] for x in t]
    stats = dict(
        serving_stream=out, serving_wall_s=wall, ttft_s=ttft,
        prefill_tokens_per_s=sum(x["batch"] * x["prompt"] for x in t)
        / sum(ttft),
        decode_tokens_per_s=sum(x["batch"] * x["new_tokens"] for x in t)
        / sum(x["decode_s"] for x in t),
        decode_step_s=[x["decode_s"] / x["new_tokens"] for x in t],
        batches=[x["batch"] for x in t])
    print(f"{name} serving stream: {json.dumps(out)}", flush=True)
    print(f"{name} serving: {len(t)} generate calls (batches "
          f"{stats['batches']}) in {wall:.2f} s wall; TTFT "
          f"{median_max(ttft)}; prefill {stats['prefill_tokens_per_s']:.0f} "
          f"tokens/s; decode {stats['decode_tokens_per_s']:.1f} tokens/s "
          f"(step {median_max(stats['decode_step_s'])}); launches "
          f"{launches}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return out, launches, stats


def built(name: str, model, t0: float) -> None:
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {name}, {model.cfg.num_layers} layers, d_model "
          f"{model.cfg.d_model}, {n_params / 1e9:.3f}e9 parameters "
          f"{model.cfg.dtype}, built on the card in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)


def phase_serving(flash: dict, decode: dict):
    """The serving main path: the spot-aware frontend on the full-width
    qwen1.5-4b.  The attention kernels' counts are set to 0 just before
    the stream and read just after: flash 40 a prefill, all of them on the
    tensor cores (bf16, D 128), none on the CUDA cores; decode 0."""
    t0 = time.perf_counter()
    model = full_width_model()
    built("qwen1.5-4b", model, t0)
    _, launches, stats = serve_stream(
        model, "qwen1.5-4b", (flash_attention_bh, flash_attention_tc,
                              flash_attention_simt, decode_attention_bh))
    prefills = len(stats["batches"])
    flash["launches"] = launches["flash_attention_bh"]
    flash["tc_launches"] = launches["flash_attention_tc"]
    flash["simt_launches"] = launches["flash_attention_simt"]
    decode["launches"] = launches["decode_attention_bh"]
    want = model.cfg.num_layers * prefills
    if (flash["launches"], flash["tc_launches"],
            flash["simt_launches"]) != (want, want, 0):
        raise AssertionError(f"serving: flash launches {launches} for "
                             f"{prefills} prefills of "
                             f"{model.cfg.num_layers} layers: want {want} "
                             f"on the tensor cores, 0 on the CUDA cores")
    print(f"qwen1.5-4b serving: flash launches {flash['launches']} = "
          f"{model.cfg.num_layers} x {prefills} prefills, tensor cores "
          f"{flash['tc_launches']}, CUDA cores {flash['simt_launches']}; "
          f"decode-kernel launches {decode['launches']} (no model calls it)",
          flush=True)
    flash.update(stats)
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
          f"(tensor cores) vs plain version: max abs {err:.4g} (limit "
          f"{LOGITS_ATOL}); two "
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
    kernel (float32 inputs: the CUDA-core route, 40 launches, none on the
    tensor cores) against the plain version, to the CPU tests' float32
    tolerance."""
    model = full_width_model("float32")
    toks = torch.as_tensor(np.random.default_rng(MAIN_SEED + 2).integers(
        2, model.cfg.vocab_size, size=(SERVE_B, PROMPT)), device=DEVICE)
    flash_attention_tc.launches = flash_attention_simt.launches = 0
    logits_k, _ = prefill_with(model, "pallas", toks)
    routes = (flash_attention_simt.launches, flash_attention_tc.launches)
    if routes != (model.cfg.num_layers, 0):
        raise AssertionError(f"float32 prefill: {routes[0]} CUDA-core and "
                             f"{routes[1]} tensor-core flash launches")
    logits_p, _ = prefill_with(model, "naive", toks)
    a, b = logits_p.cpu().numpy(), logits_k.cpu().numpy()
    err = float(np.abs(a - b).max())
    np.testing.assert_allclose(b, a, err_msg="float32 prefill logits",
                               **LOGITS_F32)
    result["float32_prefill_logits_err"] = err
    print(f"prefill logits {tuple(toks.shape)} full width float32, flash "
          f"kernel (CUDA cores, {routes[0]} launches, {routes[1]} on the "
          f"tensor cores) vs plain version: max abs {err:.3g} (rtol "
          f"{LOGITS_F32['rtol']}, atol {LOGITS_F32['atol']})", flush=True)


def profile_call(label: str, fn) -> dict:
    """``fn()`` once under torch.profiler: the device's busy time, its idle
    share of the host wall time, and the ten longest device rows.  Busy
    time sums the rows that ran on the device (kernels, copies, sets);
    the host's operator rows carry their kernels' time again and are left
    out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not rows:
        raise AssertionError(f"profile {label}: no device rows")
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    print(f"profile: {label} {wall_us / 1e3:.1f} ms wall, device busy "
          f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / wall_us:.3f}",
          flush=True)
    for name, us, count in rows[:10]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:90]}", flush=True)
    return {"profile_wall_ms": wall_us / 1e3, "profile_busy_ms": busy_us / 1e3,
            "profile_top": [(n[:60], us / 1e3, c) for n, us, c in rows[:10]]}


def phase_profile(model) -> dict:
    """One generate call (prompt 512, 4 new tokens, batch 4) under
    torch.profiler."""
    server = BatchedServer(model, max_batch=SERVE_B, max_len=CACHE,
                           device=DEVICE)
    prompts = list(np.random.default_rng(3).integers(
        2, model.cfg.vocab_size, size=(SERVE_B, PROMPT)).astype(np.int32))
    server.generate(prompts, 4)
    return profile_call(f"one generate (batch {SERVE_B}, prompt {PROMPT}, "
                        f"4 new tokens)", lambda: server.generate(prompts, 4))


def phase_attention_timings(flash: dict, decode: dict) -> None:
    """Each kernel alone by CUDA events at the serving shape and a long
    one, beside its plain version and F.scaled_dot_product_attention (the
    library yardstick, never on the port's path)."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    # flash, prefill: (B·KH, g, S, D) with g = 1 (MHA), on both routes
    for tag, B, S in (("", SERVE_B, PROMPT), ("long_", 1, LONG_S)):
        q, k, v = randn(50, bf16, (B * HEADS, 1, S, HEAD_DIM),
                        (B * HEADS, S, HEAD_DIM), (B * HEADS, S, HEAD_DIM))
        times, outs = {}, {}
        # calls in a row: at the short shape, enough that the first call's
        # launch latency does not set the mean (the same count for SDPA)
        repeat = 3 if S > PROMPT else 50
        for r in ("tc", "simt"):
            flash_attention_bh(q, k, v, causal=True, route=r)  # warm-up
            times[r], outs[r] = cuda_ms(lambda: flash_attention_bh(
                q, k, v, causal=True, route=r),
                1 if r == "simt" and S > PROMPT else repeat)
        q4, k4, v4 = (x.view(B, HEADS, S, HEAD_DIM) for x in (q, k, v))
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        lib_ms, lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), repeat)
        sdpa_err = float((lib.float() - outs["tc"].view_as(lib).float())
                         .abs().max())
        if S * S * B * HEADS * 4 <= 8 * 2**30:
            plain_ms, plain = cuda_ms(lambda: flash_attention_bh_ref(
                q, k, v, causal=True))
            twin = flash_attention_bh_ref(q, k, v, causal=True,
                                          p_dtype=bf16)
            rows = slice(None)
            checked = "all rows"
        else:
            # the S x S float32 scores do not fit: the last 256 query rows
            # of four heads, against the plain version on those rows
            plain_ms = None
            rows, heads = slice(S - 256, S), slice(0, 4)
            kw = dict(causal=True, q_offset=S - 256)
            qs = q[heads, :, rows].contiguous()
            plain = flash_attention_bh_ref(qs, k[heads], v[heads], **kw)
            twin = flash_attention_bh_ref(qs, k[heads], v[heads],
                                          p_dtype=bf16, **kw)
            outs = {r: o[heads] for r, o in outs.items()}
            checked = "the last 256 rows of 4 heads"
        err, floor = hold_tc(f"flash timing shape S={S} tc", plain, twin,
                             outs["tc"][:, :, rows])
        simt_err = hold(f"flash timing shape S={S} simt", plain,
                        outs["simt"][:, :, rows])
        b_ms, b_by = flash_bound(B * HEADS, 1, S, S, HEAD_DIM, True)
        flash.update({f"{tag}ms": times["tc"], f"{tag}tc_ms": times["tc"],
                      f"{tag}simt_ms": times["simt"],
                      f"{tag}plain_ms": plain_ms, f"{tag}bound_ms": b_ms,
                      f"{tag}bound_by": b_by, f"{tag}library_ms": lib_ms,
                      f"{tag}tc_err": err, f"{tag}tc_floor": floor,
                      f"{tag}simt_err": simt_err})
        plain_t = ("n/a (S x S scores do not fit)" if plain_ms is None
                   else f"{plain_ms:.3f} ms")
        print(f"flash {tag or 'prefill_'}shape (B {B}, S {S}, H {HEADS}, D "
              f"{HEAD_DIM}, bf16, causal): tensor cores {times['tc']:.4f} ms "
              f"({100 * b_ms / times['tc']:.2f}% of the bound), CUDA cores "
              f"{times['simt']:.3f} ms ({100 * b_ms / times['simt']:.2f}%), "
              f"plain {plain_t}, SDPA {lib_ms:.4f} ms (max abs vs the "
              f"tensor cores {sdpa_err:.3g}), bound {b_ms:.4f} ms ({b_by}); "
              f"against the plain version on {checked}: tensor cores "
              f"{err:.3g} (floor {floor:.3g}), CUDA cores {simt_err:.3g}",
              flush=True)
        del q, k, v, q4, k4, v4, outs, lib, plain, twin

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
        n_split = decode_mod.split_count(S, B * HEADS)
        dev_ms = queued_ms(lambda: decode_attention_bh(q, k, v, kv_len,
                                                       block_k=bk), 10)
        lib_dev_ms = queued_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4), 10)
        host = host_us(lambda: decode_attention_bh(q, k, v, kv_len,
                                                   block_k=bk), 100)
        lib_host = host_us(lambda: F.scaled_dot_product_attention(
            q4, k4, v4), 100)
        decode.update({f"{tag}ms": ms, f"{tag}plain_ms": plain_ms,
                       f"{tag}bound_ms": b_ms, f"{tag}bound_by": b_by,
                       f"{tag}library_ms": lib_ms, f"{tag}n_split": n_split,
                       f"{tag}device_ms": dev_ms,
                       f"{tag}library_device_ms": lib_dev_ms,
                       f"{tag}host_us": host,
                       f"{tag}library_host_us": lib_host})
        print(f"decode {tag or 'serving_'}shape (B {B}, S {S}, KH {HEADS}, D "
              f"{HEAD_DIM}, bf16, kv_len {S}, n_split {n_split}, "
              f"{B * HEADS * n_split} split blocks): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"kernel at {100 * b_ms / ms:.2f}% of it; calls queued behind "
              f"a sleep (the device alone): kernel {dev_ms:.4f} ms, SDPA "
              f"{lib_dev_ms:.4f} ms; host a call (100 launched back to "
              f"back): kernel {host:.1f} us, SDPA {lib_host:.1f} us",
              flush=True)
        del q, k, v, q4, k4, v4, out, ref


# ---------------------------------------------------------------------------
# the SSD kernel and mamba2-780m
# ---------------------------------------------------------------------------
#: tests/test_kernels.py's SSD_CASES: (B, L, H, P, N, Q), then a chunk that
#: is not a multiple of the kernel's 64-row tiles
SSD_CASES = [
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 32, 64, 32),
    (2, 256, 4, 64, 32, 64),
    (1, 64, 8, 16, 128, 64),
    (1, 192, 3, 64, 128, 96),
]
#: test_ssd_property's shapes (Q 32, D 0): (B, chunks, H, P, N)
SSD_PROPERTY = [(1, 1, 1, 16, 16), (2, 3, 2, 32, 64), (2, 4, 4, 32, 64)]
#: mamba2-780m's layer: 48 heads of P 64, state 128, chunk 256; scoring at
#: train_4k's sequence length with the batch cut from 256 to 8
SSD_H, SSD_P, SSD_N, SSD_Q = 48, 64, 128, 256
SCORE_B, SCORE_L = 8, 4_096
SSD_LONG_L = 32_768  # one row of prefill_32k
#: the full-width mamba2 losses in float32, kernel against plain scan
LOSS_F32_RTOL = 1e-4
#: the bf16 scoring check's seeds: weights from MAIN_SEED + s, the batch
#: DataPipeline(seed=s); the first is the main path's run
SCORE_SEEDS = (0, 1, 2)
#: chunk lengths of the plain scan (besides the model's 256) whose losses,
#: with the sequential recurrence's, make the bf16 scoring floor
FLOOR_CHUNKS = (128, 64, 32)
#: the kernel's bf16 loss is held to twice that floor: the floor is a
#: spread of rounding noise from a few plain versions, and one more sample
#: of the same noise (the kernel's) exceeds 1x its spread by chance alone
#: in a good share of seeds, 2x rarely; the one-ulp layer parity and the
#: float32 loss are the tight checks of the kernel
LOSS_LIMIT_FLOORS = 2
#: float32 logits of 48 layers, recurrent decode against chunked prefill:
#: the two sum in other orders in every layer; 4.8e-5 was measured on an
#: H100 at logits of |max| ~5, so the 1e-5 floor of the 2-layer CPU tests
#: becomes 1e-4
MAMBA_LOGITS_F32 = dict(rtol=1e-4, atol=1e-4)


def ssd_inputs(seed, dtype, B, L, H, P, N, *, dt_shift=0.0, d_skip=1.0):
    """x·0.5, dt = softplus(normal + dt_shift), B and C ·0.3, A_log =
    log(1..H), D = d_skip: the JAX kernel tests' draws.  At the model's
    widths ``dt_shift`` -4 puts dt near the model's [1e-3, 1e-1]."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)

    x = (normal(B, L, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(normal(B, L, H) + dt_shift)
    b_in, c_in = ((normal(B, L, N) * 0.3).to(dtype) for _ in range(2))
    a_log = torch.log(torch.arange(1, H + 1, device=DEVICE).float())
    d = torch.full((H,), d_skip, device=DEVICE)
    return x, dt, a_log, d, b_in, c_in


def as_bc_slices(args) -> tuple:
    """The SSD inputs with B and C laid out as ``mamba_block`` hands them
    over: column slices of one [B, C] tensor, read in place."""
    bc = torch.cat(args[4:], dim=-1)
    N = args[4].shape[-1]
    return (*args[:4], bc[..., :N], bc[..., N:])


def ssd_tolerance(dtype, floor: float) -> dict:
    """The CUDA-core route: float32 rtol 1e-4, bf16 one ulp, each with an
    absolute floor of twice ``floor``, the largest difference between the
    two plain versions (chunked scan, sequential recurrence) on the same
    inputs in float32, and at least 1e-5 (float32) or 1e-6 (bf16)."""
    if dtype == torch.bfloat16:
        return dict(rtol=BF16_RTOL, atol=max(F32_ATOL, 2 * floor))
    return dict(rtol=1e-4, atol=max(1e-5, 2 * floor))


def ssd_plain(args, chunk, against: str = "ref") -> tuple[torch.Tensor,
                                                           float]:
    """A plain version's output on ``args`` (``ref``, the sequential
    recurrence, or ``chunked``) and the float32 floor: the largest
    difference between the chunked scan and the recurrence in float32."""
    f32 = [a.float() for a in args]
    floor = float((ssd_chunked(*f32, chunk=chunk) - ssd_ref(*f32)).abs().max())
    del f32
    want = ssd_ref(*args) if against == "ref" else ssd_chunked(
        *args, chunk=chunk)
    return want, floor


def hold_ssd(name, got, plain, floor: float, twin=None
             ) -> tuple[float, float]:
    """A kernel's output against ``plain``: the CUDA cores by
    ``ssd_tolerance``; the tensor cores (``twin`` given: the rounding twin
    on the same inputs and chunk) by the floor rule,
    ``ssd/ref.py::tc_tolerance``: rtol one bf16 ulp, atol twice the larger
    of ``floor`` and the twin's distance from ``plain``.  Returns (max abs
    difference, the floor used)."""
    if got.dtype != plain.dtype or got.shape != plain.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{plain.dtype} {tuple(plain.shape)}")
    if twin is None:
        tol = ssd_tolerance(got.dtype, floor)
    else:
        tol, dist = ssd_tc_tolerance(plain, twin, floor)
        floor = max(floor, dist)
    a, b = plain.float().cpu().numpy(), got.float().cpu().numpy()
    if not np.all(np.isfinite(b)):
        raise AssertionError(f"{name}: non-finite output")
    np.testing.assert_allclose(b, a, err_msg=f"{name} (floor {floor:.3g})",
                               **tol)
    return float(np.abs(a - b).max()), floor


def ssd_bound(B, L, H, P, N, Q, itemsize=2) -> tuple[float, str]:
    """The larger of the operations at the bf16 tensor-core rate and the
    bytes at HBM rate; ms and which.  Operations, 2 a multiply-add: C·Bᵀ
    over the causal pairs s <= q (N a pair) once a (b, chunk), since B and
    C are shared by the H heads; then a (b, h, chunk) its product with
    x·dt over the same pairs (P a pair), C·h_prev and the state update
    (Q·N·P each).  Bytes: x, B, C and y once in the input type, dt once in
    float32."""
    pairs = Q * (Q + 1) // 2
    ops = 2 * B * (L // Q) * (pairs * N + H * (pairs * P + 2 * Q * N * P))
    nbytes = itemsize * (2 * B * L * H * P + 2 * B * L * N) + 4 * B * L * H
    t_ops, t_bytes = ops / PEAK_BF16, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_ssd_parity(ssd: dict) -> None:
    """The kernels through ``ops.ssd`` against the plain versions, every
    bf16 shape the tensor cores take on both routes: the test shapes and
    the property shapes (float32 and bf16) against the recurrence, chunk
    continuity, the full-width layer against the chunked scan.  Their
    launches here are reported apart from the main path's."""
    worst = {"tc": 0.0, "simt": 0.0}
    worst_floor = {"tc": 0.0, "simt": 0.0}
    ssd_cuda.launches = ssd_tc.launches = ssd_simt.launches = 0

    def check(name, args, chunk, against="ref") -> dict:
        """``args`` through ops.ssd and, where that takes the tensor cores,
        on the CUDA cores too; returns {route: (error, floor)}."""
        plain, floor = ssd_plain(args, chunk, against)
        x, b_in = args[0], args[4]
        routes = (("tc", "simt") if ssd_mod.route(
            x.dtype, x.shape[-1], b_in.shape[-1], min(chunk, x.shape[1]))
                  == "tc" else ("simt",))
        out = {}
        for r in routes:
            got = (ssd_ops.ssd(*args, chunk=chunk) if r == routes[0]
                   else ssd_cuda(*args, chunk=chunk, route=r))
            twin = ssd_tc_twin(*args, chunk=chunk) if r == "tc" else None
            out[r] = hold_ssd(f"{name} {r}", got, plain, floor, twin)
            worst[r] = max(worst[r], out[r][0])
            worst_floor[r] = max(worst_floor[r], out[r][1])
            if r == "tc":
                print(f"  ssd {name} tensor cores: max abs {out[r][0]:.3g}, "
                      f"floor {out[r][1]:.3g} (limit twice it)", flush=True)
        return out

    for i, (B, L, H, P, N, Q) in enumerate(SSD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            check(f"case {i} {dtype}", ssd_inputs(70 + i, dtype, B, L, H, P,
                                                  N), Q)
    for i, (B, nc, H, P, N) in enumerate(SSD_PROPERTY):
        for dtype in (torch.float32, torch.bfloat16):
            check(f"property {i} {dtype}",
                  ssd_inputs(80 + i, dtype, B, nc * 32, H, P, N, d_skip=0.0),
                  32)
    args = list(ssd_inputs(90, torch.float32, 1, 128, 2, 16, 16, d_skip=0.0))
    args[2] = torch.zeros(2, device=DEVICE)  # A = -1
    small, big = (ssd_ops.ssd(*args, chunk=q) for q in (16, 128))
    np.testing.assert_allclose(small.cpu().numpy(), big.cpu().numpy(),
                               rtol=1e-4, atol=1e-5, err_msg="continuity")
    cont = float((small - big).abs().max())
    # bf16 on the tensor cores: each chunk held by the floor rule to the
    # recurrence, which has no chunks
    args = [a.bfloat16() if a.dim() > 1 and i != 1 else a
            for i, a in enumerate(args)]
    cont_tc = {q: check(f"continuity Q {q} bf16", args, q)["tc"]
               for q in (16, 128)}
    print(f"parity ssd: {len(SSD_CASES)} test shapes and "
          f"{len(SSD_PROPERTY)} property shapes x f32/bf16 against the "
          f"recurrence: tensor cores max abs diff {worst['tc']:.3g} (largest "
          f"floor {worst_floor['tc']:.3g}), CUDA cores {worst['simt']:.3g} "
          f"(the two plain versions differ by up to "
          f"{worst_floor['simt']:.3g}); chunk 16 vs 128 float32: {cont:.3g}; "
          f"bf16 on the tensor cores Q 16 / 128 vs the recurrence "
          f"{cont_tc[16][0]:.3g} / {cont_tc[128][0]:.3g}", flush=True)

    args = as_bc_slices(ssd_inputs(91, torch.bfloat16, SCORE_B, SCORE_L,
                                   SSD_H, SSD_P, SSD_N, dt_shift=-4.0))
    t0 = time.perf_counter()
    full = check("full-width layer", args, SSD_Q, against="chunked")
    torch.cuda.synchronize()
    print(f"parity ssd full-width layer {tuple(args[0].shape)} bf16 Q "
          f"{SSD_Q} vs the chunked scan: tensor cores max abs "
          f"{full['tc'][0]:.3g} (floor {full['tc'][1]:.3g}: the twin's "
          f"distance), CUDA cores {full['simt'][0]:.3g} (floor "
          f"{full['simt'][1]:.3g}: chunked vs recurrence in float32) "
          f"({time.perf_counter() - t0:.1f} s with the plain versions); "
          f"launches {ssd_tc.launches} tensor-core, {ssd_simt.launches} "
          f"CUDA-core", flush=True)
    ssd.update(max_abs_err=max(worst.values()), tc_max_abs_err=worst["tc"],
               tc_floor=worst_floor["tc"], simt_max_abs_err=worst["simt"],
               parity_floor=worst_floor["simt"],
               full_width_err=full["tc"][0], full_width_floor=full["tc"][1],
               full_width_simt_err=full["simt"][0],
               full_width_simt_floor=full["simt"][1],
               parity_launches=ssd_cuda.launches,
               tc_parity_launches=ssd_tc.launches,
               simt_parity_launches=ssd_simt.launches)


def mamba_model(dtype: str = "bfloat16", seed: int = MAIN_SEED, **changes):
    """mamba2-780m at its published widths, the SSD kernel selected,
    random weights from a seeded generator on the card."""
    cfg = dataclasses.replace(get_config("mamba2-780m"), attn_impl="pallas",
                              dtype=dtype, **changes)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return build_model(cfg, device=DEVICE, generator=gen)


def scan_loss(model, batch, impl: str, scan=None) -> float:
    """``MambaLM.loss`` with every layer's scan set to ``impl``: "pallas"
    (the kernel), "chunked" (the plain scan) or "ref" (the sequential
    recurrence, which the model, as the JAX package's, never selects).
    ``scan``, with "pallas", stands in for the kernel's entry ``ops.ssd``
    in every layer for the call: how the tensor-core route's rounding twin
    runs the whole model."""
    cfg = model.cfg
    real = ssd_ops.ssd
    if scan is not None:
        ssd_ops.ssd = scan
    try:
        x = model.embed[batch["tokens"].long()]
        for layer in model.layers:
            h = rms_norm(layer["ln"], x, cfg.norm_eps)
            x = x + mamba_block(layer["ssm"], model.dims, h,
                                norm_eps=cfg.norm_eps, impl=impl)
        x = rms_norm(model.final_norm, x, cfg.norm_eps)
        return float(cross_entropy_chunked(x, model.lm_head,
                                           batch["targets"]))
    finally:
        ssd_ops.ssd = real


def timed_loss(model, batch, impl: str) -> tuple[float, float]:
    """(loss, host seconds) of ``model.loss`` with ``attn_impl`` = impl."""
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, attn_impl=impl)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(model.loss(batch)[0])
        return loss, time.perf_counter() - t0
    finally:
        model.cfg = cfg


def hold_loss(model, batch, seed: int, loss_k: float, loss_p: float
              ) -> dict:
    """The kernel's bf16 loss against the plain chunked scan's, within
    LOSS_LIMIT_FLOORS times a floor: the spread (largest less smallest) of
    the loss over plain versions of the scan, all at full depth: the
    chunked scan at the model's chunk and at each of FLOOR_CHUNKS and the
    sequential recurrence, which differ from the model's only in the order
    of their float32 sums, and the tensor-core route's rounding twin
    (``ssd_tc_twin``: the chunked scan rounding to bf16 where the kernel
    does)."""
    dims = model.dims
    losses = {f"chunked Q {dims.chunk}": loss_p}
    try:
        for q in FLOOR_CHUNKS:
            model.dims = dims._replace(chunk=q)
            losses[f"chunked Q {q}"] = scan_loss(model, batch, "chunked")
    finally:
        model.dims = dims
    t0 = time.perf_counter()
    losses["recurrence"] = scan_loss(model, batch, "ref")
    wall_r = time.perf_counter() - t0
    losses["twin"] = scan_loss(model, batch, "pallas", scan=ssd_tc_twin)
    floor = max(losses.values()) - min(losses.values())
    err, limit = abs(loss_k - loss_p), LOSS_LIMIT_FLOORS * floor
    print(f"mamba2-780m scoring seed {seed} bf16: loss kernel {loss_k:.6f}, "
          f"plain chunked {loss_p:.6f}, difference {err:.3g}; floor "
          f"{floor:.3g} = the spread of the plain losses ("
          + ", ".join(f"{k} {v:.6f}" for k, v in losses.items())
          + f"; the recurrence {wall_r:.1f} s); within 1x the floor: "
          f"{err <= floor}; limit {limit:.3g}", flush=True)
    if not (np.isfinite(loss_k) and err <= limit):
        raise AssertionError(f"scoring seed {seed}: kernel loss {loss_k} vs "
                             f"plain {loss_p}: {err:.3g} > {limit:.3g}")
    return dict(seed=seed, loss_kernel=loss_k, loss_plain=loss_p, err=err,
                floor=floor)


def phase_mamba_scoring(ssd: dict) -> None:
    """The scoring main path: ``MambaLM.loss`` at full width through the
    kernel (the SSD count set to 0 just before, 48 just after) and through
    the plain scan, the two held within twice a floor of rounding noise,
    on the main path's seed and on two more; then float32."""
    t0 = time.perf_counter()
    model = mamba_model()
    built("mamba2-780m", model, t0)
    batch = DataPipeline(model.cfg.vocab_size, SCORE_B, SCORE_L,
                         seed=SCORE_SEEDS[0]).next(DEVICE)
    timed_loss(model, batch, "pallas")  # warm-up: cuBLAS, first launches
    torch.cuda.reset_peak_memory_stats()
    ssd_cuda.launches = ssd_tc.launches = ssd_simt.launches = 0
    loss_k, wall_k = timed_loss(model, batch, "pallas")
    launches = ssd_cuda.launches
    routes = (ssd_tc.launches, ssd_simt.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ssd.update(launches=launches, tc_launches=routes[0],
               simt_launches=routes[1])
    if (launches, routes) != (model.cfg.num_layers,
                              (model.cfg.num_layers, 0)):
        raise AssertionError(f"scoring: {launches} SSD launches ({routes[0]} "
                             f"tensor-core, {routes[1]} CUDA-core) for one "
                             f"bf16 loss of {model.cfg.num_layers} layers")
    loss_p, wall_p = timed_loss(model, batch, "chunked")
    tokens = SCORE_B * SCORE_L
    print(f"mamba2-780m scoring {SCORE_B} x {SCORE_L} bf16: SSD launches "
          f"{launches} ({routes[0]} tensor-core, {routes[1]} CUDA-core); "
          f"{wall_k:.3f} s wall = {tokens / wall_k:.0f} scored "
          f"tokens/s (plain chunked {wall_p:.3f} s); peak {peak:.2f} GiB",
          flush=True)
    ssd.update({f"score_{k}": v for k, v in profile_call(
        f"one loss ({SCORE_B} x {SCORE_L} tokens, SSD kernel)",
        lambda: model.loss(batch)).items()})
    checks = [hold_loss(model, batch, SCORE_SEEDS[0], loss_k, loss_p)]
    for seed in SCORE_SEEDS[1:]:
        del model
        torch.cuda.empty_cache()
        model = mamba_model(seed=MAIN_SEED + seed)
        other = DataPipeline(model.cfg.vocab_size, SCORE_B, SCORE_L,
                             seed=seed).next(DEVICE)
        checks.append(hold_loss(model, other, seed,
                                timed_loss(model, other, "pallas")[0],
                                timed_loss(model, other, "chunked")[0]))
    del model
    ssd.update(score_loss_kernel=loss_k, score_loss_plain=loss_p,
               score_loss_err=checks[0]["err"],
               score_loss_floor=checks[0]["floor"], score_loss_seeds=checks,
               score_wall_s=wall_k, score_plain_wall_s=wall_p,
               score_tokens_per_s=tokens / wall_k, score_peak_gib=peak)
    torch.cuda.empty_cache()

    model = mamba_model("float32")
    ssd_tc.launches = ssd_simt.launches = 0
    loss_k, wall_k = timed_loss(model, batch, "pallas")
    routes = (ssd_tc.launches, ssd_simt.launches)
    if routes != (0, model.cfg.num_layers):
        raise AssertionError(f"scoring float32: {routes[0]} tensor-core and "
                             f"{routes[1]} CUDA-core SSD launches")
    loss_p, _ = timed_loss(model, batch, "chunked")
    np.testing.assert_allclose(loss_k, loss_p, rtol=LOSS_F32_RTOL,
                               err_msg="float32 loss")
    print(f"mamba2-780m scoring {SCORE_B} x {SCORE_L} float32: loss kernel "
          f"{loss_k:.7f}, plain chunked {loss_p:.7f}, difference "
          f"{abs(loss_k - loss_p):.3g} (rtol {LOSS_F32_RTOL}); {wall_k:.3f} "
          f"s wall; SSD launches {routes[1]} CUDA-core, {routes[0]} "
          f"tensor-core", flush=True)
    ssd.update(score_f32_loss_err=abs(loss_k - loss_p),
               score_f32_simt_launches=routes[1])


def phase_mamba_serving(ssd: dict) -> None:
    """The serving main path on mamba2-780m at full width: no SSD launch
    (prefill takes the chunked scan with its final state), and a
    teacher-forced check of decode_step's logits against prefills."""
    t0 = time.perf_counter()
    model = mamba_model()
    built("mamba2-780m", model, t0)
    _, launches, stats = serve_stream(
        model, "mamba2-780m", (ssd_cuda, ssd_tc, ssd_simt,
                               flash_attention_bh, flash_attention_tc,
                               flash_attention_simt, decode_attention_bh))
    if any(launches.values()):
        raise AssertionError(f"mamba2 serving launched {launches}; the "
                             "stream runs no kernel")
    ssd.update({k if k.startswith("serving") else f"serving_{k}": v
                for k, v in stats.items()})
    ssd.update(serving_launches=launches["ssd_cuda"],
               serving_tc_launches=launches["ssd_tc"],
               serving_simt_launches=launches["ssd_simt"])

    toks = torch.as_tensor(np.random.default_rng(MAIN_SEED + 1).integers(
        2, model.cfg.vocab_size, size=(SERVE_B, PROMPT)), device=DEVICE)
    # a float32 twin with the bf16 model's weights exactly: the two plain
    # paths (recurrent decode, chunked prefill) are held tightly there, and
    # that is the check of decode_step.  The bf16 model's own distance from
    # the twin is the bf16 floor; bf16 logits of 48 layers spread so far
    # that their limit catches only gross faults, so bf16 is also held to
    # the greedy token where the twin's top-1/top-2 margin exceeds twice
    # that floor, as the CPU tests hold it against JAX
    twin = mamba_model("float32")
    twin.load_state_dict({k: v.float() for k, v in
                          model.state_dict().items()})
    logits, cache = model.prefill({"tokens": toks})
    _, cache32 = twin.prefill({"tokens": toks})
    cur = logits[:, -1].argmax(-1)
    seq, dec, dec32 = [cur], [], []
    for _ in range(MAX_NEW - 1):
        lg, cache = model.decode_step({"tokens": cur[:, None]}, cache)
        lg32, cache32 = twin.decode_step({"tokens": cur[:, None]}, cache32)
        dec.append(lg[:, 0])
        dec32.append(lg32[:, 0])
        cur = lg[:, 0].argmax(-1)
        seq.append(cur)
    worst = worst32 = floor = 0.0
    agree = 0
    greedy = []  # (bf16 decode's token, the twin's, the twin's margin)
    for t, (lg, lg32) in enumerate(zip(dec, dec32)):
        prefix = {"tokens": torch.cat([toks, torch.stack(seq[:t + 1], 1)],
                                      dim=1)}
        ref, ref32 = model.prefill(prefix)[0][:, 0], twin.prefill(prefix)[0][:, 0]
        np.testing.assert_allclose(lg32.cpu().numpy(), ref32.cpu().numpy(),
                                   err_msg=f"float32 decode step {t}",
                                   **MAMBA_LOGITS_F32)
        worst32 = max(worst32, float((lg32 - ref32).abs().max()))
        floor = max(floor, float((ref - ref32).abs().max()))
        worst = max(worst, float((lg - ref).abs().max()))
        agree += int((lg.argmax(-1) == ref.argmax(-1)).sum())
        top2 = ref32.topk(2, dim=-1).values
        greedy.append((lg.argmax(-1), ref32.argmax(-1),
                       top2[:, 0] - top2[:, 1]))
    share = agree / (len(dec) * SERVE_B)
    limit = 2 * floor
    held = missed = 0
    for got, want, margin in greedy:
        sure = margin > limit
        held += int(sure.sum())
        missed += int((got != want)[sure].sum())
    print(f"mamba2-780m teacher-forced: decode_step logits vs prefill over "
          f"prompt + generated ({PROMPT + 1}..{PROMPT + len(dec)} tokens) at "
          f"{len(dec)} steps x {SERVE_B}: float32 max abs {worst32:.3g} "
          f"(rtol {MAMBA_LOGITS_F32['rtol']}, atol "
          f"{MAMBA_LOGITS_F32['atol']}); bf16 max "
          f"abs {worst:.4g}, limit {limit:.4g} = twice the bf16 prefill's "
          f"distance from its float32 twin ({floor:.4g}); greedy tokens "
          f"agree {share:.4f}; where the twin's top-1/top-2 margin exceeds "
          f"{limit:.4g}: {held} of {len(dec) * SERVE_B} positions, "
          f"{missed} bf16 greedy tokens other than the twin's; logits |max| "
          f"{float(logits.abs().max()):.3g}", flush=True)
    if not worst <= limit or missed:
        raise AssertionError(f"mamba2 teacher-forced decode: max abs "
                             f"{worst:.4g} (limit {limit:.4g}); {missed} of "
                             f"{held} greedy tokens off the twin's at a "
                             f"clear margin")
    ssd.update(teacher_forced_err=worst, teacher_forced_floor=floor,
               teacher_forced_f32_err=worst32, teacher_forced_agree=share,
               teacher_forced_margin_held=held)


def phase_ssd_timings(ssd: dict) -> None:
    """Each route alone by CUDA events at the full-width layer shape and at
    one prefill_32k row, in one run, beside the plain chunked scan and the
    bound; B and C read in place as the model hands them over, and, to
    show what that layout costs, from contiguous copies (tensor cores).
    The tensor cores' output is held to the chunked scan by the floor rule
    at both shapes."""
    for tag, B, L in (("", SCORE_B, SCORE_L), ("long_", 1, SSD_LONG_L)):
        args = as_bc_slices(ssd_inputs(92, torch.bfloat16, B, L, SSD_H,
                                       SSD_P, SSD_N, dt_shift=-4.0))
        times, outs = {}, {}
        # warm-ups: the first call of each allocates its buffers
        for r in ("tc", "simt"):
            ssd_cuda(*args, chunk=SSD_Q, route=r)
            times[r], outs[r] = cuda_ms(lambda: ssd_cuda(
                *args, chunk=SSD_Q, route=r), 10 if r == "tc" else 3)
        packed = (*args[:4], args[4].contiguous(), args[5].contiguous())
        ssd_cuda(*packed, chunk=SSD_Q)
        packed_ms, _ = cuda_ms(lambda: ssd_cuda(*packed, chunk=SSD_Q), 10)
        ssd_chunked(*args, chunk=SSD_Q)
        plain_ms, ref = cuda_ms(lambda: ssd_chunked(*args, chunk=SSD_Q))
        err, floor = hold_ssd(f"ssd timing shape L={L} tc", outs["tc"], ref,
                              0.0, ssd_tc_twin(*args, chunk=SSD_Q))
        simt_err = float((outs["simt"].float() - ref.float()).abs().max())
        b_ms, b_by = ssd_bound(B, L, SSD_H, SSD_P, SSD_N, SSD_Q)
        ms, simt_ms = times["tc"], times["simt"]
        ssd.update({f"{tag}ms": ms, f"{tag}tc_ms": ms,
                    f"{tag}simt_ms": simt_ms, f"{tag}plain_ms": plain_ms,
                    f"{tag}bound_ms": b_ms, f"{tag}bound_by": b_by,
                    f"{tag}library_ms": None, f"{tag}timing_err": err,
                    f"{tag}timing_floor": floor,
                    f"{tag}simt_timing_err": simt_err,
                    f"{tag}contiguous_bc_ms": packed_ms})
        print(f"ssd {tag or 'scoring_'}shape (B {B}, L {L}, H {SSD_H}, P "
              f"{SSD_P}, N {SSD_N}, Q {SSD_Q}, bf16): tensor cores {ms:.4f} "
              f"ms (B and C contiguous {packed_ms:.4f} ms; "
              f"{100 * b_ms / ms:.2f}% of the bound), CUDA cores "
              f"{simt_ms:.3f} ms ({100 * b_ms / simt_ms:.2f}%; "
              f"{simt_ms / ms:.1f}x the tensor cores' time), plain chunked "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); against the "
              f"chunked scan: tensor cores {err:.3g} (floor {floor:.3g}), "
              f"CUDA cores {simt_err:.3g}; no library call", flush=True)
        del args, packed, outs, ref
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the P-pool spot market (the sweep kernel's market traversal)
# ---------------------------------------------------------------------------
def spot_market(prices, hazards, notices, arrivals=None) -> SpotMarket:
    """Pools of the given prices, hazards and notices; each pool's slots
    ``Exponential(μ/P)`` unless ``arrivals`` names them."""
    n = len(prices)
    arrivals = arrivals or [Exponential(MU / n)] * n
    return SpotMarket(pools=tuple(
        SpotPool(a, price=p, hazard=h, notice=w)
        for a, p, h, w in zip(arrivals, prices, hazards, notices)))


#: benchmarks/market_bench.py::bench_market(): prices, hazards, notices
BENCH_POOLS = ((0.5, 0.3, 0.2, 0.1), (0.02, 0.05, 0.0, 0.10),
               (0.5, 0.01, 0.0, 2.0))
BENCH_MARKET = spot_market(*BENCH_POOLS)
MARKET_KERNEL = NoticeAwareKernel(checkpoint_time=0.05, choice="cheapest")
#: three pools whose hazards sum to other float32 values left to right
#: than in pairs, so a reordered sum moves the thinned pick
SUM_HAZARDS = (0.0123457, 0.123456795, 0.00987654)
#: (name, market, kernel, rmax, per-lane params, per-lane pools config or
#: None); the pools-config rows draw prices, hazards (a quarter of them 0,
#: a lane in eight with none) and notices per lane
MARKET_CASES = [
    ("degenerate_1pool", SpotMarket.single(Exponential(MU)),
     ThreePhaseKernel(), 16, {"r": np.linspace(0.25, 4.0, 5)}, None),
    ("heterogeneous_notice", BENCH_MARKET, MARKET_KERNEL, 16,
     {"r": np.linspace(0.25, 4.0, 4)}, None),
    ("pool_choice_fastest", spot_market((1.0, 0.4), (0.0, 0.08), (0.0, 0.3)),
     PoolChoiceKernel(ThreePhaseKernel(), choice="fastest"), 16,
     {"r": np.linspace(0.5, 3.0, 3)}, None),
    ("least_loaded", BENCH_MARKET,
     NoticeAwareKernel(checkpoint_time=0.05, choice="least_loaded"), 16,
     {"r": np.linspace(0.5, 6.0, 4)}, None),
    ("uniform_choice", BENCH_MARKET,
     NoticeAwareKernel(checkpoint_time=0.05, choice="uniform"), 8,
     {"r": np.linspace(0.5, 6.0, 4)}, None),
    ("weighted_choice", BENCH_MARKET,
     PoolChoiceKernel(ThreePhaseKernel(), choice="weighted"), 16,
     {"r": np.linspace(0.5, 6.0, 4), "pool_logits": "per lane"}, None),
    ("pools_config_axis", BENCH_MARKET, MARKET_KERNEL, 16,
     {"r": np.linspace(0.5, 6.0, 4)}, "per lane"),
    ("three_pool_sums", spot_market((0.4, 0.3, 0.2), SUM_HAZARDS,
                                    (0.5, 0.01, 2.0)), MARKET_KERNEL, 16,
     {"r": np.linspace(0.5, 6.0, 4)}, None),
    ("eight_pools_mixed",
     spot_market((0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2),
                 (0.01, 0.0, 0.02, 0.03, 0.0, 0.05, 0.01, 0.02),
                 (1.0, 0.01, 0.5, 0.5, 2.0, 0.0, 0.02, 3.0),
                 [Exponential(MU / 8), Uniform(0.0, 384.0), BathtubGCP(),
                  Deterministic(150.0), Exponential(MU / 8),
                  Uniform(10.0, 300.0), Exponential(MU / 4),
                  Exponential(MU / 16)]),
     NoticeAwareKernel(checkpoint_time=0.05, choice="least_loaded"), 33,
     {"r": np.linspace(1.0, 12.0, 4)}, None),
    ("pool_choice_single_slot", BENCH_MARKET,
     PoolChoiceKernel(SingleSlotKernel(wait=DeterministicWait(3.0))), 1, {},
     None),
    ("legacy_single_slot_revoked",
     SpotMarket.single(Uniform(0.0, 48.0), price=0.4, hazard=0.05),
     SingleSlotKernel(wait=ExponentialWait(0.5)), 1, {}, None),
]
#: a burn-in, a window and a tail, none a multiple of a draw pass (rows
#: of 3 to 9 columns take 16, 12, 10, 9, 8 or 7 events a pass)
MARKET_PLAN = _window_plan(242, 163, 57)
MARKET_LANES = 96  # a ragged last block at G 4 (32 lanes a block)
#: every (G, slots a thread) the wrapper can pick, by rmax
MARKET_LAYOUT_RMAX = (2, 8, 16, 32, 64, 100, 256)
MARKET_LAYOUT_PLAN = _window_plan(444, 222, 74)
MARKET_LAYOUT_LANES = 45
MARKET_CUT_PLAN = WIDTH_PLAN
#: ptxas's report of each market instantiation, (G, slots a thread) -> line
MARKET_PTXAS: dict[tuple[int, int], str] = {}


def lane_inputs(defaults, params, lanes, seed, cfg=None, device=None):
    """Keys, params, k (10 a lane) and a pools or regions config as tensors
    for a direct call of the market or region kernel: ``params`` maps names
    to per-lane values, ``cfg`` is a per-lane config (``defaults`` a lane
    when it is None)."""
    device = device or DEVICE
    keys = threefry.split(threefry.key(seed, device), lanes)
    k = torch.full((lanes,), 10.0, dtype=torch.float32, device=device)
    cfg = cfg or {n: np.broadcast_to(v, (lanes,) + v.shape)
                  for n, v in defaults.items()}
    p = {n: torch.as_tensor(np.ascontiguousarray(v, np.float32),
                            device=device) for n, v in params.items()}
    return keys, p, k, _config_tensors(
        {n: np.ascontiguousarray(v) for n, v in cfg.items()}, device)


def case_inputs(defaults, params, config, lanes, rng, scale):
    """Per-lane params (a grid value repeated over ``lanes``, logits drawn
    a lane) and, for the config rows, a per-lane pools or regions config:
    prices, hazards (a quarter of them 0, a lane in eight with none),
    notices and the ``scale`` column."""
    n = len(defaults["price"])
    out = {}
    for name, v in params.items():
        if name.endswith("_logits"):
            out[name] = rng.normal(0.0, 1.5, (lanes, n))
        else:
            out[name] = np.resize(np.repeat(v, -(-lanes // len(v))), lanes)
    cfg = None
    if config:
        cfg = {n_: np.broadcast_to(v, (lanes, n)).copy()
               for n_, v in defaults.items()}
        cfg["price"] = rng.uniform(0.05, 1.0, (lanes, n))
        hz = rng.uniform(0.0, 0.2, (lanes, n))
        hz[rng.random((lanes, n)) < 0.25] = 0.0
        hz[::8] = 0.0
        cfg["hazard"] = hz
        cfg["notice"] = rng.uniform(0.0, 1.0, (lanes, n))
        cfg[scale] = rng.uniform(0.5, 2.0, (lanes, n))
    return out, cfg


def market_fleet(market, kernel, rmax, params, lanes, seed, mp=None,
                 device=None, rng="slab"):
    """Lane state, per-lane params, pools config and k for a direct call of
    the market kernel on the ``rng`` stream: ``params`` maps names to
    per-lane values."""
    keys, p, k, mp = lane_inputs(market.params(), params, lanes, seed, mp,
                                 device)
    preempt_on = bool((mp["hazard"] > 0).any())
    state0 = init_market_state(keys, JOB, market, rmax, mp, preempt_on,
                               rng=rng)
    return state0, p, mp, k, preempt_on


def prefilled(state, n_pools: int, rng):
    """``state`` with every lane's first slots holding jobs already
    (between half of rmax and all but two slots; ages up to 48 h, pools
    drawn, joined in slot order), so that a run at cut depth reaches the
    upper slots of a large rmax."""
    lanes, rmax = state.occ.shape
    held = rng.integers(rmax // 2, rmax - 1, lanes)
    occ = np.arange(rmax)[None, :] < held[:, None]
    dev = state.occ.device

    def put(x, dtype):
        return torch.as_tensor(np.where(occ, x, 0).astype(dtype), device=dev)

    return state._replace(
        ages=put(rng.uniform(0.0, 48.0, (lanes, rmax)), np.float32),
        occ=torch.as_tensor(occ, device=dev),
        pool=put(rng.integers(0, n_pools, (lanes, rmax)), np.int32),
        order=put(np.broadcast_to(np.arange(rmax), (lanes, rmax)), np.int32),
        next_seq=torch.as_tensor(held.astype(np.int32), device=dev),
        qlen=torch.as_tensor(held.astype(np.int32), device=dev))


def phase_market_parity() -> float:
    """The market kernel against its plain version on the card: the JAX
    package's market kernel-test cases, every choice rule, the pools-config
    axis, sums that round by their order, eight pools of mixed slot
    processes, single-slot admission, a join order from INT32_MAX; then
    every (G, slots a thread) the wrapper can pick."""
    rng = np.random.default_rng(18)
    worst, driven = 0.0, set()
    for name, market, kernel, rmax, params, pools_config in MARKET_CASES:
        lanes = MARKET_LANES
        p, mp = case_inputs(market.params(), params, pools_config, lanes,
                            rng, "spot_scale")
        state0, p, mp, k, pre = market_fleet(market, kernel, rmax, p, lanes,
                                             7, mp)
        n_cols = _market_layout(JOB, market, kernel, pre).n_cols
        ends_on_a_short_pass(f"market parity {name}", MARKET_PLAN,
                             min(64 // n_cols, 16))
        args = (JOB, market, kernel, rmax, pre, state0, p, mp, k,
                MARKET_PLAN)
        fin_ref, ref = market_event_windows_ref(*args)
        fin_ker, ker = sweep.market_event_windows(*args)
        torch.cuda.synchronize()
        rel = compare(name, ref, ker, fin_ref, fin_ker)
        worst = max(worst, rel)
        driven.add(picked_layout(rmax))
        print(f"market parity {name}: P {market.n_pools}, {lanes} lanes, "
              f"rmax {rmax}, preemption {'on' if pre else 'off'}, plan "
              f"{MARKET_PLAN}: ints bitwise, max rel float diff {rel:.3g}; "
              f"{int(ref.pool_preempted.sum())} revocations, "
              f"{int(ref.resumed.sum())} resumed", flush=True)

    # an unswept exponential wait at a rate whose float32 reciprocal is
    # inexact, through PoolChoiceKernel on the four revoking pools
    kernel = PoolChoiceKernel(SingleSlotKernel(wait=ExponentialWait(1 / 3)))
    state0, p, mp, k, pre = market_fleet(BENCH_MARKET, kernel, 1, {},
                                         MARKET_LANES, 7)
    args = (JOB, BENCH_MARKET, kernel, 1, pre, state0, p, mp, k, MARKET_PLAN)
    hold_all("market parity unswept exponential wait 1/3",
             market_event_windows_ref(*args),
             sweep.market_event_windows(*args))
    print(f"market parity unswept exponential wait 1/3: P 4, "
          f"{MARKET_LANES} lanes, rmax 1, plan {MARKET_PLAN}: every field "
          f"bitwise", flush=True)

    # a join order a hair below INT32_MAX: the per-window rebase holds it
    plan = _window_plan(1_280, 128, 0)
    state0, p, mp, k, pre = market_fleet(
        BENCH_MARKET, MARKET_KERNEL, 16, {"r": np.full(96, 6.0)}, 96, 2)
    high = state0._replace(next_seq=state0.next_seq + (2**31 - 10_000))
    args = (JOB, BENCH_MARKET, MARKET_KERNEL, 16, pre)
    _, ref = market_event_windows_ref(*args, high, p, mp, k, plan)
    fin_hi, ker_hi = sweep.market_event_windows(*args, high, p, mp, k, plan)
    _, ker_lo = sweep.market_event_windows(*args, state0, p, mp, k, plan)
    rel = compare("market rebase", ref, ker_hi)
    compare("market rebase vs zero start", ker_lo, ker_hi)
    if int(fin_hi.next_seq.max()) > 128 + 16:
        raise AssertionError("market rebase: next_seq not bounded")
    print(f"market parity rebase: next_seq from 2^31-10^4, {len(plan)} "
          f"windows: ints bitwise, equal to the zero start, max rel float "
          f"diff {rel:.3g}", flush=True)
    worst = max(worst, rel)

    for rmax in MARKET_LAYOUT_RMAX:
        state0, p, mp, k, pre = market_fleet(
            BENCH_MARKET, MARKET_KERNEL, rmax,
            {"r": np.linspace(1.0, rmax - 0.5, MARKET_LAYOUT_LANES)},
            MARKET_LAYOUT_LANES, 11)
        args = (JOB, BENCH_MARKET, MARKET_KERNEL, rmax, pre, state0, p, mp,
                k, MARKET_LAYOUT_PLAN)
        fin_ref, ref = market_event_windows_ref(*args)
        fin_ker, ker = sweep.market_event_windows(*args)
        torch.cuda.synchronize()
        rel = compare(f"market layout rmax {rmax}", ref, ker,
                             fin_ref, fin_ker)
        if bool(torch.signbit(fin_ker.budgets).any()):
            raise AssertionError(f"market layout rmax {rmax}: a budget with "
                                 f"its sign bit set")
        g, spt = picked_layout(rmax)
        driven.add((g, spt))
        worst = max(worst, rel)
        print(f"market layout rmax {rmax}: G {g} ({spt} slots a thread; "
              f"ptxas: {MARKET_PTXAS.get((g, spt))}), "
              f"{MARKET_LAYOUT_LANES} lanes, plan {MARKET_LAYOUT_PLAN}: "
              f"ints bitwise, max rel float diff {rel:.3g}", flush=True)
    picks = {picked_layout(rmax) for rmax in range(1, sweep.MAX_RMAX + 1)}
    if driven != picks or (MARKET_PTXAS and set(MARKET_PTXAS) != picks):
        raise AssertionError(f"market layouts driven {sorted(driven)}, "
                             f"picked {sorted(picks)}, built "
                             f"{sorted(MARKET_PTXAS)}")
    return worst


def main_lanes(n_locs: int, defaults: dict):
    """The main path's lanes exactly as ``run_market_sweep`` and
    ``run_region_sweep`` lay them out (grid-major, seed fastest): keys,
    params, k and the pools or regions config ``defaults`` a lane."""
    params_f, k_f, grid = _lane_tensors({"r": R_GRID[:, None]},
                                        K_GRID[None, :], DEVICE)
    keys = threefry.split(threefry.key(MAIN_SEED, DEVICE), N_SEEDS)
    params_l, k_l, keys_l = _flat_lane_args(params_f, k_f, keys)
    cfg = _config_tensors(_broadcast_config_params(n_locs, defaults, {},
                                                   grid), DEVICE)
    return keys_l, params_l, k_l, _flat_lane_args(cfg, k_f, keys)[0]


def market_main_inputs(market=BENCH_MARKET, kernel=MARKET_KERNEL,
                       rng="slab"):
    """The market kernel's inputs for the market main path on the ``rng``
    stream."""
    keys_l, params_l, k_l, mp_l = main_lanes(market.n_pools, market.params())
    pre = market.preemptible
    state0 = init_market_state(keys_l, JOB, market, 64, mp_l, pre, rng=rng)
    return (JOB, market, kernel, 64, pre, state0,
            params_l, mp_l, k_l)


def market_ops_per_lane_event(rmax: int, n_cols: int,
                              n_pools: int) -> tuple[int, int]:
    """(INT32, FP32) operations one market lane-event needs, counted from
    the plain version's arithmetic by the type of the data they work on.

    As :func:`ops_per_lane_event` for the columns (:data:`COLUMN_INT32`
    INT32 + 2 FP32 a column: threefry, u01), and a slot the single queue's 16 INT32 + 11
    FP32 plus the market's 8 INT32 (the pool compares and masks of the two
    FIFO keys, the revoked pool's order key and one-hot compare, the
    resume order select, the pool tag select) and 3 FP32 (the revoked
    age's one-hot read, the resume selects of age and budget).  A pool: 8
    INT32 (the spot argmin's index select, three per-pool counters'
    compares and adds, the thinning count) and 8 FP32 (the argmin compare,
    the clock's subtract and select, the draw's two products, the hazard's
    running sum, the thinning compare and the price read).  An event: the
    single queue's 28 INT32 + 36 FP32 plus 16 INT32 (the four-way event
    kind, revocation masks, the resume law's compares, two counters) and
    24 FP32 (the preemption clock's merge and refresh with log1p counted as
    one and its division, the thinning product, the re-admission law, three
    more float sums)."""
    return (COLUMN_INT32 * n_cols + 24 * rmax + 8 * n_pools + 44,
            2 * n_cols + 14 * rmax + 8 * n_pools + 60)


def market_bytes_moved(lanes: int, rmax: int, n_pools: int,
                       n_windows: int) -> int:
    """Bytes the market function must move: each lane's state, params,
    pools config and window keys read once, its final state and per-window
    statistics (12 scalars, 3 a pool) written once."""
    state = 4 * (3 + n_pools + 2) + rmax * (4 + 4 + 1 + 4 + 4)
    reads = state + 4 * 4 + 5 * 4 * n_pools + n_windows * 8
    writes = state + n_windows * 4 * (12 + 3 * n_pools)
    return lanes * (reads + writes)


def phase_market_degenerate() -> None:
    """The 1-pool zero-hazard market (unit price, a legacy three-phase
    kernel) through the market kernel against the single-queue kernel on
    the same lanes at full fleet width, cut depth: every statistic they
    share and the final queue bitwise."""
    degenerate = SpotMarket.single(SPOT)
    args = market_main_inputs(degenerate, ThreePhaseKernel())
    state0, p = args[5], args[6]
    plan = (4_096, 65_536)
    fin_m, m = sweep.market_event_windows(*args, plan)
    single0 = init_engine_state(state0.key, JOB, SPOT, 64)
    single0 = single0._replace(key=state0.key, next_job=state0.next_job,
                               next_spot=state0.next_spot[:, 0])
    fin_s, s = sweep.batched_event_windows(JOB, SPOT, ThreePhaseKernel(), 64,
                                           single0, p, args[8], plan)
    torch.cuda.synchronize()
    for field in WindowStats._fields:
        if not torch.equal(getattr(m, field), getattr(s, field)):
            raise AssertionError(f"degenerate market: {field} differs from "
                                 f"the single queue")
    for field in ("next_job", "ages", "budgets", "occ", "order", "next_seq",
                  "qlen"):
        if not torch.equal(getattr(fin_m, field), getattr(fin_s, field)):
            raise AssertionError(f"degenerate market: final {field} differs")
    if not torch.equal(fin_m.next_spot[:, 0], fin_s.next_spot):
        raise AssertionError("degenerate market: final spot clock differs")
    print(f"market degenerate: 1 pool, no hazard, unit price, "
          f"{state0.key.shape[0]} lanes × {sum(plan)} events, rmax 64: the "
          f"market kernel equals the single-queue kernel bitwise (every "
          f"shared statistic, the final queue and clocks)", flush=True)


def phase_market_width(market: dict) -> None:
    """Kernel and plain version on the market main path's inputs (cut
    depth): ints bitwise, floats to RTOL, and their times."""
    args = market_main_inputs()
    lanes = args[8].shape[0]
    sweep.market_event_windows(*args, MARKET_CUT_PLAN)  # warm-up
    ms, (_, ker) = cuda_ms(
        lambda: sweep.market_event_windows(*args, MARKET_CUT_PLAN), 3)
    plain_ms, (_, ref) = cuda_ms(
        lambda: market_event_windows_ref(*args, MARKET_CUT_PLAN))
    rel = compare("market width", ref, ker)
    n_cols = _market_layout(JOB, BENCH_MARKET, MARKET_KERNEL, True).n_cols
    n_pools = BENCH_MARKET.n_pools
    b_ms, b_by = bound_ms(
        lanes, MARKET_CUT_PLAN, market_ops_per_lane_event(64, n_cols, n_pools),
        market_bytes_moved(lanes, 64, n_pools, len(MARKET_CUT_PLAN)))
    g, spt = picked_layout(64)
    market.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                  max_abs_err=max_abs(ref, ker), group=g,
                  slots_a_thread=spt, ptxas=MARKET_PTXAS.get((g, spt)),
                  n_cols=n_cols)
    print(f"market width: {lanes} lanes, 4 pools, rmax 64, {n_cols} "
          f"columns, plan {MARKET_CUT_PLAN}, G {g} ({spt} slots a thread; "
          f"ptxas: {MARKET_PTXAS.get((g, spt))}): kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms ({plain_ms / ms:.0f}x), bound {b_ms:.4f} ms "
          f"({b_by}), ints bitwise, max rel float diff {rel:.3g}", flush=True)


def phase_market_main_kernel(market: dict) -> dict:
    """Device time of the market kernel alone at the main path's size, its
    spot spend held window by window; returns the summary of its windows
    after the burn-in (what ``run_market_sweep`` must return)."""
    plan = _window_plan(N_EVENTS, 65_536, BURN_IN)
    args = market_main_inputs()
    lanes = args[8].shape[0]
    ladder_ms, _ = cuda_ms(lambda: window_slab_keys(args[5].key, len(plan)))
    ms, (_, stats) = cuda_ms(lambda: sweep.market_event_windows(*args, plan))
    n_pools = BENCH_MARKET.n_pools
    b_ms, b_by = bound_ms(
        lanes, plan, market_ops_per_lane_event(64, market["n_cols"], n_pools),
        market_bytes_moved(lanes, 64, n_pools, len(plan)))
    rate = lanes * sum(plan) / (ms / 1e3)
    market.update(main_ms=ms, main_bound_ms=b_ms, main_bound_by=b_by,
                  main_lane_events_per_s=rate, main_key_ladder_ms=ladder_ms)
    print(f"market main-size kernel: {lanes} lanes × {sum(plan)} events, 4 "
          f"pools, rmax 64, G {sweep.group_size(64)}, in {ms:.1f} ms = "
          f"{rate:.4g} lane-events/s (bound {b_ms:.1f} ms, {b_by}: "
          f"{100 * b_ms / ms:.1f}%); window-key ladder {ladder_ms:.3f} ms",
          flush=True)
    # spot spend conservation, window by window: a float32 window sum of n
    # non-negative terms is within n half-ulps of its final value of the
    # exact sum of its (float32) prices; the legs are exact integers
    price = BENCH_MARKET.prices().astype(np.float32).astype(np.float64)
    legs = (stats.pool_served + stats.pool_preempted).cpu().numpy()
    exact = (legs * price).sum(-1)
    got = stats.spot_cost.cpu().numpy()
    bound = legs.sum(-1) * np.spacing(got) / 2
    if not np.all(np.abs(got - exact) <= bound):
        bad = np.argwhere(np.abs(got - exact) > bound)[0]
        raise AssertionError(f"market spend conservation: lane/window "
                             f"{bad.tolist()}: {got[tuple(bad)]} against "
                             f"{exact[tuple(bad)]}")
    rel = np.abs(got - exact) / np.maximum(exact, 1e-30)
    market.update(spend_max_rel=float(rel.max()),
                  spend_max_of_bound=float((np.abs(got - exact)
                                            / np.maximum(bound, 1e-30)).max()))
    print(f"market spend conservation: every lane's float32 window sum "
          f"within its rounding bound (n legs × half an ulp; at most "
          f"{market['spend_max_of_bound']:.3f} of it), largest relative "
          f"difference {rel.max():.3g}", flush=True)
    return summarize_market(MarketWindowStats(*(x[:, 1:] for x in stats)))


def phase_market_main_path(market: dict, kernel_summary: dict) -> None:
    """The market main path through ``run_market_sweep``: the launch count
    set to 0 just before the call and read just after; its result equal to
    the summary of the kernel's own call on the same inputs
    (``kernel_summary``), per-lane accounting identities and the
    preemption-priced LP floor."""
    sweep.market_event_windows.launches = 0
    t0 = time.perf_counter()
    out = run_market_sweep(JOB, BENCH_MARKET, MARKET_KERNEL,
                           {"r": R_GRID[:, None]}, k=K_GRID[None, :],
                           n_events=N_EVENTS, key=threefry.key(MAIN_SEED),
                           n_seeds=N_SEEDS, rmax=64, burn_in=BURN_IN)
    wall = time.perf_counter() - t0
    launches = sweep.market_event_windows.launches
    market["launches"] = launches
    if launches != 1:
        raise AssertionError(f"market main path: run_market_sweep launched "
                             f"the kernel {launches} times; expected 1")
    lanes = R_GRID.size * K_GRID.size * N_SEEDS
    market["run_market_sweep_s"] = wall
    shape = (R_GRID.size, K_GRID.size, N_SEEDS)
    for name, v in out.items():
        want = shape + ((4,) if name.startswith("pool_") else ())
        if v.shape != want or not np.all(np.isfinite(v)):
            raise AssertionError(f"market {name}: shape {v.shape} or "
                                 f"non-finite")
    for name, v in kernel_summary.items():
        if not np.array_equal(out[name], v.reshape(out[name].shape)):
            raise AssertionError(f"market main path: {name} differs from the "
                                 f"kernel's own call")
    # completed legs: spot service, on-demand, or a checkpointed revocation
    if not np.array_equal(out["jobs_completed"], out["spot_served"]
                          + out["ondemand"] + out["resumed"]):
        raise AssertionError("market: completed != served + ondemand + "
                             "resumed")
    if not np.array_equal(out["spot_served"], out["pool_served"].sum(-1)):
        raise AssertionError("market: spot_served != sum of pool_served")
    k = np.broadcast_to(K_GRID[None, :, None], shape)
    if not (out["preemptions"].sum() > 0 and out["resumed"].sum() > 0):
        raise AssertionError("market: no preemption or no resume")
    worst = np.inf
    for idx in np.ndindex(*shape):
        floor = market_knapsack_lp(float(k[idx]), LAM,
                                   float(out["avg_delay_job"][idx]),
                                   BENCH_MARKET,
                                   include_preemption=True)["objective"]
        margin = (out["avg_cost_job"][idx] - floor) / k[idx]
        worst = min(worst, margin)
        if margin < -0.005:
            raise AssertionError(f"market LP floor: lane {idx}: "
                                 f"avg_cost_job {out['avg_cost_job'][idx]:.5f}"
                                 f" below the floor {floor:.5f}")
    market["lp_floor_worst_margin_k"] = float(worst)
    print(f"market main path: run_market_sweep {wall:.3f} s wall "
          f"({lanes * (N_EVENTS + BURN_IN) / wall:.4g} lane-events/s), "
          f"kernel launches {launches}, equal to the kernel's own call; "
          f"{int(out['preemptions'].sum())} revocations, "
          f"{int(out['resumed'].sum())} resumed; completed legs = served + "
          f"on-demand + resumed at every lane; avg_cost_job "
          f"above the preemption-priced LP floor at every lane's delay by "
          f"at least {worst:.3e}·k (limit -5e-3·k)", flush=True)


# ---------------------------------------------------------------------------
# N-region routing (the sweep kernel's region traversal)
# ---------------------------------------------------------------------------
def region_topology(rows) -> RegionTopology:
    """Regions from rows of (job process, spot process, price, hazard,
    notice, rmax)."""
    return RegionTopology(regions=tuple(
        Region(job, spot, price=c, hazard=h, notice=w, rmax=m)
        for job, spot, c, h, w, m in rows))


#: benchmarks/region_bench.py::bench_topology(rmax=16): four regions that
#: split the paper's λ and μ
BENCH_TOPOLOGY = region_topology(
    [(Exponential(LAM / 4), Exponential(MU / 4), 0.5, 0.02, 0.5, 16),
     (Exponential(LAM / 2), Exponential(MU / 4), 0.3, 0.05, 0.01, 16),
     (Exponential(LAM / 8), Exponential(MU / 4), 0.2, 0.0, 0.0, 16),
     (Exponential(LAM / 8), Exponential(MU / 4), 0.1, 0.10, 2.0, 16)])
REGION_KERNEL = RoutingKernel(NoticeAwareKernel(checkpoint_time=0.05),
                              choice="least_loaded")
#: tests/test_core_regions.py::_hetero_topology: rmax 16/8/4/16, a ragged
#: partition of 44 slots
HETERO_TOPOLOGY = region_topology(
    [(Exponential(LAM / 4), Exponential(1 / 30), 0.5, 0.02, 0.5, 16),
     (Exponential(LAM / 2), Exponential(1 / 40), 0.3, 0.05, 0.01, 8),
     (Exponential(LAM / 8), Exponential(1 / 60), 0.2, 0.0, 0.0, 4),
     (Exponential(LAM / 8), Exponential(1 / 90), 0.1, 0.10, 2.0, 16)])
_NOTICE = NoticeAwareKernel(checkpoint_time=0.05)
#: (name, topology, kernel, per-lane params, per-lane regions config or
#: None); "per lane" logits and configs are drawn for each lane
REGION_CASES = [
    ("home", HETERO_TOPOLOGY, ThreePhaseKernel(),
     {"r": np.linspace(0.5, 6.0, 4)}, None),
    ("cheapest", HETERO_TOPOLOGY, RoutingKernel(_NOTICE, "cheapest"),
     {"r": np.linspace(0.5, 6.0, 4)}, None),
    ("fastest", HETERO_TOPOLOGY, RoutingKernel(ThreePhaseKernel(), "fastest"),
     {"r": np.linspace(0.5, 6.0, 4)}, None),
    ("least_loaded", HETERO_TOPOLOGY, RoutingKernel(_NOTICE, "least_loaded"),
     {"r": np.linspace(0.5, 6.0, 4)}, None),
    ("uniform", HETERO_TOPOLOGY, RoutingKernel(_NOTICE, "uniform"),
     {"r": np.linspace(0.5, 6.0, 4)}, None),
    ("weighted", HETERO_TOPOLOGY, RoutingKernel(ThreePhaseKernel(),
                                                "weighted"),
     {"r": np.linspace(0.5, 6.0, 4), "region_logits": "per lane"}, None),
    ("single_slot", HETERO_TOPOLOGY,
     RoutingKernel(SingleSlotKernel(wait=DeterministicWait(3.0)),
                   "least_loaded"), {}, None),
    ("regions_config", HETERO_TOPOLOGY, RoutingKernel(_NOTICE, "fastest"),
     {"r": np.linspace(0.5, 6.0, 4)}, "per lane"),
    ("rmax1_region", region_topology(
        [(Exponential(LAM / 2), Exponential(1 / 30), 0.5, 0.05, 0.5, 1),
         (Exponential(LAM / 2), Uniform(0.0, 48.0), 0.3, 0.0, 0.0, 6)]),
     RoutingKernel(_NOTICE, "least_loaded"), {"r": np.linspace(0.5, 6.0, 4)},
     None),
    ("eight_regions", region_topology([
        (job, spot, 0.9 - 0.1 * i, h, w, m) for i, (job, spot, h, w, m)
        in enumerate(zip(
            [Exponential(LAM / 8)] * 6 + [Uniform(0.0, 192.0),
                                          Exponential(LAM / 8)],
            [Exponential(MU / 8), Uniform(0.0, 384.0), BathtubGCP(),
             Deterministic(150.0), Exponential(MU / 8), Uniform(10.0, 300.0),
             Exponential(MU / 4), Exponential(MU / 16)],
            (0.01, 0.0, 0.02, 0.03, 0.0, 0.05, 0.01, 0.02),
            (1.0, 0.01, 0.5, 0.5, 2.0, 0.0, 0.02, 3.0),
            (5, 3, 1, 8, 4, 2, 6, 4)))]),
     RoutingKernel(_NOTICE, "weighted"),
     {"r": np.linspace(0.5, 6.0, 4), "region_logits": "per lane"}, None),
]
#: a burn-in, a window and a tail, none a multiple of a draw pass (rows
#: of 4 to 9 or 16 columns take 16, 12, 10, 9, 8, 7 or 4 events a pass)
REGION_PLAN = _window_plan(218, 163, 41)
REGION_LANES = 94  # no multiple of 32/G: a ragged last warp at every G
#: total slots whose wrapper picks are every (G, slots a thread) built
REGION_LAYOUT_SLOTS = (2, 8, 16, 32, 64, 100, 256)
REGION_LAYOUT_PLAN = _window_plan(301, 222, 47)
#: ptxas's report of each region instantiation, (G, slots a thread) -> line
REGION_PTXAS: dict[tuple[int, int], str] = {}


def region_fleet(topo, kernel, params, lanes, seed, rp=None):
    """The region kernel's arguments for a direct call (before the plan):
    ``params`` maps names to per-lane values."""
    keys, p, k, rp = lane_inputs(topo.params(), params, lanes, seed, rp)
    preempt_on = bool((rp["hazard"] > 0).any())
    state0 = init_region_state(keys, topo, rp, preempt_on)
    return (topo, kernel, preempt_on, state0,
            p, rp, k)


def phase_region_parity() -> float:
    """The region kernel against its plain version on the card: the JAX
    test topology (a ragged 16/8/4/16 partition) under every routing rule,
    a routed single-slot kernel, the regions-config axis, a region of rmax
    1, eight regions of mixed processes, a join order from INT32_MAX; then
    every (G, slots a thread) the wrapper can pick."""
    rng = np.random.default_rng(19)
    worst, driven = 0.0, set()
    for name, topo, kernel, params, regions_config in REGION_CASES:
        p, rp = case_inputs(topo.params(), params, regions_config,
                            REGION_LANES, rng, "job_scale")
        args = region_fleet(topo, kernel, p, REGION_LANES, 7, rp)
        n_cols = _region_layout(topo, kernel, args[2]).n_cols
        ends_on_a_short_pass(f"region parity {name}", REGION_PLAN,
                             min(64 // n_cols, 16))
        fin_ref, ref = region_event_windows_ref(*args, REGION_PLAN)
        fin_ker, ker = sweep.region_event_windows(*args, REGION_PLAN)
        torch.cuda.synchronize()
        rel = compare(f"region {name}", ref, ker, fin_ref, fin_ker)
        worst = max(worst, rel)
        driven.add(picked_layout(topo.total_slots))
        print(f"region parity {name}: R {topo.n_regions}, slots "
              f"{topo.total_slots} ({'/'.join(str(r.rmax) for r in topo.regions)}), "
              f"{REGION_LANES} lanes, preemption "
              f"{'on' if args[2] else 'off'}, plan {REGION_PLAN}: ints "
              f"bitwise, max rel float diff {rel:.3g}; "
              f"{int(ref.region_routed.sum())} admitted "
              f"({int(ref.routed_home.sum())} home), "
              f"{int(ref.region_preempted.sum())} revocations, "
              f"{int(ref.resumed.sum())} resumed", flush=True)

    # a join order a hair below INT32_MAX: the per-window rebase holds it
    plan = _window_plan(1_280, 128, 0)
    args = region_fleet(HETERO_TOPOLOGY, REGION_KERNEL,
                        {"r": np.full(96, 6.0)}, 96, 2)
    state0 = args[3]
    high = state0._replace(next_seq=state0.next_seq + (2**31 - 10_000))
    _, ref = region_event_windows_ref(*args[:3], high, *args[4:], plan)
    fin_hi, ker_hi = sweep.region_event_windows(*args[:3], high, *args[4:],
                                                plan)
    _, ker_lo = sweep.region_event_windows(*args, plan)
    rel = compare("region rebase", ref, ker_hi)
    compare("region rebase vs zero start", ker_lo, ker_hi)
    if int(fin_hi.next_seq.max()) > 128 + HETERO_TOPOLOGY.total_slots:
        raise AssertionError("region rebase: next_seq not bounded")
    print(f"region parity rebase: next_seq from 2^31-10^4, {len(plan)} "
          f"windows: ints bitwise, equal to the zero start, max rel float "
          f"diff {rel:.3g}", flush=True)
    worst = max(worst, rel)

    for slots in REGION_LAYOUT_SLOTS:
        topo = region_topology(
            [(Exponential(LAM / 2), Exponential(MU / 2), 0.5, 0.03, 0.5,
              -(-slots // 2)),
             (Exponential(LAM / 2), Exponential(MU / 2), 0.2, 0.06, 0.01,
              slots // 2)])
        args = region_fleet(topo, REGION_KERNEL,
                            {"r": np.linspace(1.0, slots / 2,
                                              MARKET_LAYOUT_LANES)},
                            MARKET_LAYOUT_LANES, 11)
        fin_ref, ref = region_event_windows_ref(*args, REGION_LAYOUT_PLAN)
        fin_ker, ker = sweep.region_event_windows(*args, REGION_LAYOUT_PLAN)
        torch.cuda.synchronize()
        rel = compare(f"region layout slots {slots}", ref, ker, fin_ref,
                      fin_ker)
        if bool(torch.signbit(fin_ker.budgets).any()):
            raise AssertionError(f"region layout slots {slots}: a budget "
                                 f"with its sign bit set")
        g, spt = picked_layout(slots)
        driven.add((g, spt))
        worst = max(worst, rel)
        print(f"region layout slots {slots}: G {g} ({spt} slots a thread; "
              f"ptxas: {REGION_PTXAS.get((g, spt))}), "
              f"{MARKET_LAYOUT_LANES} lanes, plan {REGION_LAYOUT_PLAN}: "
              f"ints bitwise, max rel float diff {rel:.3g}", flush=True)
    picks = {picked_layout(rmax) for rmax in range(1, sweep.MAX_RMAX + 1)}
    if driven != picks or (REGION_PTXAS and set(REGION_PTXAS) != picks):
        raise AssertionError(f"region layouts driven {sorted(driven)}, "
                             f"picked {sorted(picks)}, built "
                             f"{sorted(REGION_PTXAS)}")
    return worst


def region_main_inputs(topo=BENCH_TOPOLOGY, kernel=REGION_KERNEL):
    """The region kernel's arguments for the region main path."""
    keys_l, params_l, k_l, rp_l = main_lanes(topo.n_regions, topo.params())
    pre = topo.preemptible
    state0 = init_region_state(keys_l, topo, rp_l, pre)
    return (topo, kernel, pre, state0,
            params_l, rp_l, k_l)


def region_ops_per_lane_event(slots: int, n_cols: int, n_regions: int,
                              group: int) -> tuple[int, int]:
    """(INT32, FP32) operations one region lane-event needs on ``group``
    threads a lane, counted by the type of the data they work on: the plain
    version's arithmetic, with the static partition's work counted a thread,
    as the kernel does it.

    As :func:`market_ops_per_lane_event` for the columns
    (:data:`COLUMN_INT32` INT32 + 2 FP32).  A slot: the single queue's 16 INT32 + 11 FP32 plus the
    region's 5 INT32 (the revoked partition's bit test, its order key's
    select, arg-min compare and one-hot compare, the resume order select)
    and 3 FP32 (the revoked age's one-hot read, the resume selects of age
    and budget).  A thread: 36 INT32 for the three partition masks (spot,
    revoked and target region; each two offsets clamped to the thread's
    slots, two shifts, two subtracts and a bit operation, then its
    operation with the occupancy).  A region: 26 INT32 (two arg-min index
    selects, five counters' compares and adds, the thinning count, the
    queue length's two one-hot updates and the total, the target's queue,
    capacity and revoked-queue reads, least_loaded's compare and select,
    the free-slot view) and 16 FP32 (two clock compares, two clocks'
    subtract and select, two draws' products each, the hazard's running
    sum, the thinning compare, two price reads, the rate and job-rate
    divisions).  An event: the market's 44 INT32 + 60 FP32 plus 4 INT32
    (the route's home compare, the routed-home counter)."""
    return (COLUMN_INT32 * n_cols + 21 * slots + 36 * group
            + 26 * n_regions + 48,
            2 * n_cols + 14 * slots + 16 * n_regions + 60)


def region_bytes_moved(lanes: int, slots: int, n_regions: int,
                       n_windows: int) -> int:
    """Bytes the region function must move: each lane's state (key, R job
    and spot clocks and queue lengths, the preemption clock, next_seq, the
    packed slots), params (k, two policy params, the checkpoint time),
    regions config (six (R,) vectors) and window keys read once, its final
    state and per-window statistics (13 scalars, 5 a region) written
    once."""
    state = 4 * (2 + 3 * n_regions + 2) + slots * (4 + 4 + 1 + 4)
    reads = state + 4 * 4 + 6 * 4 * n_regions + n_windows * 8
    writes = state + n_windows * 4 * (13 + 5 * n_regions)
    return lanes * (reads + writes)


def region_bound_ms(lanes: int, plan, n_cols: int) -> tuple[float, str]:
    """:func:`bound_ms` of the region main path's topology and kernel."""
    slots, n = BENCH_TOPOLOGY.total_slots, BENCH_TOPOLOGY.n_regions
    return bound_ms(lanes, plan, region_ops_per_lane_event(
        slots, n_cols, n, sweep.group_size(slots)),
        region_bytes_moved(lanes, slots, n, len(plan)))


def phase_region_degenerate() -> None:
    """At full fleet width and cut depth, through the region kernel: one
    region of unit price and no hazard under a legacy three-phase kernel
    against the single-queue kernel, and one region of price 0.4, hazard
    0.05 and notice 1.0 under ``NoticeAwareKernel`` against the 1-pool
    market kernel (``pool_*`` as ``region_*``): every shared statistic and
    the final queue and clocks bitwise."""
    plan = (4_096, 65_536)
    single = RegionTopology.single(JOB, SPOT, rmax=64)
    args = region_main_inputs(single, ThreePhaseKernel())
    state0, p, k = args[3], args[4], args[6]
    fin_r, r = sweep.region_event_windows(*args, plan)
    single0 = init_engine_state(state0.key, JOB, SPOT, 64)._replace(
        key=state0.key, next_job=state0.next_job[:, 0],
        next_spot=state0.next_spot[:, 0])
    fin_s, s = sweep.batched_event_windows(JOB, SPOT, ThreePhaseKernel(), 64,
                                           single0, p, k, plan)
    torch.cuda.synchronize()
    for field in WindowStats._fields:
        if not torch.equal(getattr(r, field), getattr(s, field)):
            raise AssertionError(f"degenerate region: {field} differs from "
                                 f"the single queue")
    for field in ("ages", "budgets", "occ", "order", "next_seq"):
        if not torch.equal(getattr(fin_r, field), getattr(fin_s, field)):
            raise AssertionError(f"degenerate region: final {field} differs")
    for field in ("next_job", "next_spot", "qlen"):
        if not torch.equal(getattr(fin_r, field)[:, 0],
                           getattr(fin_s, field)):
            raise AssertionError(f"degenerate region: final {field} differs")

    spot = Exponential(1 / 40)
    kernel = NoticeAwareKernel(checkpoint_time=0.05)
    one = RegionTopology.single(JOB, spot, price=0.4, hazard=0.05,
                                notice=1.0, rmax=64)
    market = SpotMarket.single(spot, price=0.4, hazard=0.05, notice=1.0)
    args = region_main_inputs(one, kernel)
    state0, p, k = args[3], args[4], args[6]
    lanes = k.shape[0]
    fin_r, r = sweep.region_event_windows(*args, plan)
    mp = {n: torch.as_tensor(np.tile(v, (lanes, 1)), device=DEVICE)
          for n, v in market.params().items()}
    market0 = init_market_state(state0.key, JOB, market, 64, mp, True)
    market0 = market0._replace(
        key=state0.key, next_job=state0.next_job[:, 0],
        next_spot=state0.next_spot, next_preempt=state0.next_preempt)
    fin_m, m = sweep.market_event_windows(JOB, market, kernel, 64, True,
                                          market0, p, mp, k, plan)
    torch.cuda.synchronize()
    for field in MarketWindowStats._fields:
        if not torch.equal(getattr(r, field.replace("pool_", "region_")),
                           getattr(m, field)):
            raise AssertionError(f"one-region market: {field} differs from "
                                 f"the 1-pool market kernel")
    for field in ("next_spot", "next_preempt", "ages", "budgets", "occ",
                  "order", "next_seq"):
        if not torch.equal(getattr(fin_r, field), getattr(fin_m, field)):
            raise AssertionError(f"one-region market: final {field} differs")
    for field in ("next_job", "qlen"):
        if not torch.equal(getattr(fin_r, field)[:, 0],
                           getattr(fin_m, field)):
            raise AssertionError(f"one-region market: final {field} differs")
    print(f"region degenerate: {lanes} lanes × {sum(plan)} events, rmax "
          f"64: one region of unit price and no hazard equals the "
          f"single-queue kernel, one region of price 0.4, hazard 0.05 and "
          f"notice 1.0 the 1-pool market kernel ({int(m.pool_preempted.sum())}"
          f" revocations, {int(m.resumed.sum())} resumed), bitwise (every "
          f"shared statistic, the final queue and clocks)", flush=True)


def phase_region_width(region: dict) -> None:
    """Kernel and plain version on the region main path's inputs (cut
    depth): ints bitwise, floats to RTOL, and their times."""
    args = region_main_inputs()
    lanes, slots = args[6].shape[0], BENCH_TOPOLOGY.total_slots
    sweep.region_event_windows(*args, WIDTH_PLAN)  # warm-up
    ms, (_, ker) = cuda_ms(
        lambda: sweep.region_event_windows(*args, WIDTH_PLAN), 3)
    plain_ms, (_, ref) = cuda_ms(
        lambda: region_event_windows_ref(*args, WIDTH_PLAN))
    rel = compare("region width", ref, ker)
    n_cols = _region_layout(BENCH_TOPOLOGY, REGION_KERNEL, True).n_cols
    b_ms, b_by = region_bound_ms(lanes, WIDTH_PLAN, n_cols)
    g, spt = picked_layout(slots)
    region.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                  max_abs_err=max_abs(ref, ker), group=g,
                  slots_a_thread=spt, ptxas=REGION_PTXAS.get((g, spt)),
                  n_cols=n_cols)
    print(f"region width: {lanes} lanes, 4 regions, {slots} slots, "
          f"{n_cols} columns, plan {WIDTH_PLAN}, G {g} ({spt} slots a "
          f"thread; ptxas: {REGION_PTXAS.get((g, spt))}): kernel {ms:.3f} "
          f"ms, plain {plain_ms:.1f} ms ({plain_ms / ms:.0f}x), bound "
          f"{b_ms:.4f} ms ({b_by}), ints bitwise, max rel float diff "
          f"{rel:.3g}", flush=True)


def phase_region_main_kernel(region: dict) -> dict:
    """Device time of the region kernel alone at the main path's size, its
    spot spend held window by window; returns the summary of its windows
    after the burn-in (what ``run_region_sweep`` must return)."""
    plan = _window_plan(N_EVENTS, 65_536, BURN_IN)
    args = region_main_inputs()
    lanes, slots = args[6].shape[0], BENCH_TOPOLOGY.total_slots
    ladder_ms, _ = cuda_ms(lambda: window_slab_keys(args[3].key, len(plan)))
    ms, (_, stats) = cuda_ms(lambda: sweep.region_event_windows(*args, plan))
    b_ms, b_by = region_bound_ms(lanes, plan, region["n_cols"])
    rate = lanes * sum(plan) / (ms / 1e3)
    region.update(main_ms=ms, main_bound_ms=b_ms, main_bound_by=b_by,
                  main_lane_events_per_s=rate, main_key_ladder_ms=ladder_ms)
    print(f"region main-size kernel: {lanes} lanes × {sum(plan)} events, 4 "
          f"regions, {slots} slots, G {sweep.group_size(slots)}, in "
          f"{ms:.1f} ms = {rate:.4g} lane-events/s (bound {b_ms:.1f} ms, "
          f"{b_by}: {100 * b_ms / ms:.1f}%); window-key ladder "
          f"{ladder_ms:.3f} ms", flush=True)
    # spot spend conservation, window by window, as the market's
    price = BENCH_TOPOLOGY.prices().astype(np.float32).astype(np.float64)
    legs = (stats.region_served + stats.region_preempted).cpu().numpy()
    exact = (legs * price).sum(-1)
    got = stats.spot_cost.cpu().numpy()
    bound = legs.sum(-1) * np.spacing(got) / 2
    if not np.all(np.abs(got - exact) <= bound):
        bad = np.argwhere(np.abs(got - exact) > bound)[0]
        raise AssertionError(f"region spend conservation: lane/window "
                             f"{bad.tolist()}: {got[tuple(bad)]} against "
                             f"{exact[tuple(bad)]}")
    rel = np.abs(got - exact) / np.maximum(exact, 1e-30)
    region.update(spend_max_rel=float(rel.max()),
                  spend_max_of_bound=float((np.abs(got - exact)
                                            / np.maximum(bound, 1e-30)).max()))
    print(f"region spend conservation: every lane's float32 window sum "
          f"within its rounding bound (n legs × half an ulp; at most "
          f"{region['spend_max_of_bound']:.3f} of it), largest relative "
          f"difference {rel.max():.3g}", flush=True)
    return summarize_region(RegionWindowStats(*(x[:, 1:] for x in stats)))


def phase_region_main_path(region: dict, kernel_summary: dict) -> None:
    """The region main path through ``run_region_sweep``: the launch count
    set to 0 just before the call and read just after; its result equal to
    the summary of the kernel's own call on the same inputs
    (``kernel_summary``), the per-lane accounting identities and the
    preemption-priced pooled LP floor."""
    sweep.region_event_windows.launches = 0
    t0 = time.perf_counter()
    out = run_region_sweep(BENCH_TOPOLOGY, REGION_KERNEL,
                           {"r": R_GRID[:, None]}, k=K_GRID[None, :],
                           n_events=N_EVENTS, key=threefry.key(MAIN_SEED),
                           n_seeds=N_SEEDS, burn_in=BURN_IN)
    wall = time.perf_counter() - t0
    launches = sweep.region_event_windows.launches
    region["launches"] = launches
    if launches != 1:
        raise AssertionError(f"region main path: run_region_sweep launched "
                             f"the kernel {launches} times; expected 1")
    lanes = R_GRID.size * K_GRID.size * N_SEEDS
    region["run_region_sweep_s"] = wall
    shape = (R_GRID.size, K_GRID.size, N_SEEDS)
    for name, v in out.items():
        want = shape + ((4,) if name.startswith("region_") else ())
        if v.shape != want or not np.all(np.isfinite(v)):
            raise AssertionError(f"region {name}: shape {v.shape} or "
                                 f"non-finite")
    for name, v in kernel_summary.items():
        if not np.array_equal(out[name], v.reshape(out[name].shape)):
            raise AssertionError(f"region main path: {name} differs from the "
                                 f"kernel's own call")
    admitted = out["region_routed"].sum(-1)
    checks = {  # at every lane
        "completed = served + on-demand + resumed": np.array_equal(
            out["jobs_completed"],
            out["spot_served"] + out["ondemand"] + out["resumed"]),
        "spot_served = sum of region_served": np.array_equal(
            out["spot_served"], out["region_served"].sum(-1)),
        "jobs_arrived = sum of region_jobs": np.array_equal(
            out["jobs_arrived"], out["region_jobs"].sum(-1)),
        "routed_home <= admitted <= jobs_arrived": bool(np.all(
            (out["routed_home"] <= admitted)
            & (admitted <= out["jobs_arrived"])))}
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"region main path: {what} fails")
    if not (out["preemptions"].sum() > 0 and out["resumed"].sum() > 0
            and out["cross_region_frac"].sum() > 0):
        raise AssertionError("region main path: no revocation, resume or "
                             "cross-region admission")
    k = np.broadcast_to(K_GRID[None, :, None], shape)
    worst = np.inf
    for idx in np.ndindex(*shape):
        floor = region_knapsack_lp(float(k[idx]),
                                   float(out["avg_delay_job"][idx]),
                                   BENCH_TOPOLOGY,
                                   include_preemption=True)["objective"]
        margin = (out["avg_cost_job"][idx] - floor) / k[idx]
        worst = min(worst, margin)
        if margin < -0.005:
            raise AssertionError(f"region LP floor: lane {idx}: "
                                 f"avg_cost_job {out['avg_cost_job'][idx]:.5f}"
                                 f" below the floor {floor:.5f}")
    region["lp_floor_worst_margin_k"] = float(worst)
    region["cross_region_frac_mean"] = float(out["cross_region_frac"].mean())
    print(f"region main path: run_region_sweep {wall:.3f} s wall "
          f"({lanes * (N_EVENTS + BURN_IN) / wall:.4g} lane-events/s), "
          f"kernel launches {launches}, equal to the kernel's own call; "
          f"{int(out['preemptions'].sum())} revocations, "
          f"{int(out['resumed'].sum())} resumed, cross-region share "
          f"{out['cross_region_frac'].mean():.4f} (mean); "
          f"{', '.join(checks)} at every lane; avg_cost_job above the "
          f"preemption-priced pooled LP floor at every lane's delay by at "
          f"least {worst:.3e}·k (limit -5e-3·k)", flush=True)


# ---------------------------------------------------------------------------
# telemetry: the three traversals with the fold (sweep.TEL_LIBRARY)
# ---------------------------------------------------------------------------
#: the main path's telemetry, and the parity phase's two: a ring of 32
#: records a window, and a narrow sketch whose ring of 8 wraps
TEL_MAIN = Telemetry()
TEL_RING = Telemetry(trace_cap=32)
TEL_NARROW = Telemetry(n_bins=16, wait_lo=0.1, wait_hi=100.0, trace_cap=8)
#: the cut-depth fleets' ring: as wide as their widest window
TEL_WIDE = Telemetry(trace_cap=max(WIDTH_PLAN))
#: the depth at which each traversal with telemetry is held to, and timed
#: beside, its plain version on the main-path inputs: the cut-depth plan's
#: first window (the plain version's time grows with the events; the
#: earlier phases hold and time 2,304 without telemetry)
TEL_CUT_PLAN = WIDTH_PLAN[:1]


def tel_ops_per_lane_event(loop: str, ring: bool) -> tuple[int, int]:
    """(INT32, FP32) operations the telemetry fold adds to a lane-event,
    counted from ``repro_torch.obs.stats.telemetry_update`` as the kernel
    does it.  Each of the two bins: 5 FP32 (max, log counted as one,
    subtract, multiply, floor) and 6 INT32 (convert, +1, two clamps, the
    address, the leader's atomic add); the event type: 3 INT32 selects;
    the four type counts and five counters: 9 INT32 adds in registers; a
    location count: 1 INT32 (an address and an atomic add on the rare
    defect or resume, counted as one); the validity masks: 2 INT32 (single
    queue) or 4; the location: 3 INT32 selects (market, regions); the
    wait sample: 1 FP32 select (single queue) or 2; the cost: 1 FP32
    select, or 3 and 2 adds.  A ring (``trace_cap > 0``) adds 8 INT32: the
    modulo, the slot address, five stores, the count."""
    if loop == "single":
        n_int, n_fp = 2 * 6 + 3 + 9 + 1 + 2, 2 * 5 + 1 + 1
    else:
        n_int, n_fp = 2 * 6 + 3 + 9 + 1 + 4 + 3, 2 * 5 + 2 + 5
    return n_int + (8 if ring else 0), n_fp


def tel_bytes_moved(lanes: int, plan, tel: Telemetry, n_locs: int) -> int:
    """Bytes the fold adds: a window's accumulators written once, and each
    ring record a window keeps written once (20 B, and its count)."""
    per_window = 4 * (2 * tel.n_bins + 4 + 5 + 2 * n_locs)
    ring = (sum(min(n, tel.trace_cap) * 20 + 4 for n in plan)
            if tel.trace_cap else 0)
    return lanes * (len(plan) * per_window + ring)


def tel_bound_ms(loop: str, lanes: int, plan, tel: Telemetry | None,
                 rmax: int = 64, env: bool = False, work: bool = False,
                 safety: bool = False) -> tuple[float, str]:
    """:func:`bound_ms` of a main-path fleet's traversal (``loop``: single,
    market or region), with the fold's operations and bytes where ``tel``
    is given, the env state's (:func:`env_ops_per_lane_event`; the cursor
    read and written, ten shock sums a window written) with ``env``, and
    the work state's (:func:`work_ops_per_lane_event`, with the safety net
    where ``safety``; four floats a slot read and written, ten ledger sums
    a window written) with ``work``."""
    w = len(plan)
    if loop == "single":
        n_cols = _engine_layout(JOB, SPOT, ThreePhaseKernel()).n_cols
        ops, n_bytes = ops_per_lane_event(rmax, n_cols), bytes_moved(
            lanes, rmax, w)
        n_locs, slots = 1, rmax
    elif loop == "market":
        n_cols = _market_layout(JOB, BENCH_MARKET, MARKET_KERNEL, True).n_cols
        ops = market_ops_per_lane_event(64, n_cols, BENCH_MARKET.n_pools)
        n_bytes = market_bytes_moved(lanes, 64, BENCH_MARKET.n_pools, w)
        n_locs, slots = BENCH_MARKET.n_pools, 64
    else:
        slots, n_locs = BENCH_TOPOLOGY.total_slots, BENCH_TOPOLOGY.n_regions
        n_cols = _region_layout(BENCH_TOPOLOGY, REGION_KERNEL, True).n_cols
        ops = region_ops_per_lane_event(slots, n_cols, n_locs,
                                        sweep.group_size(slots))
        n_bytes = region_bytes_moved(lanes, slots, n_locs, w)
    if tel is not None:
        ops = tuple(a + b for a, b in zip(
            ops, tel_ops_per_lane_event(loop, bool(tel.trace_cap))))
        n_bytes += tel_bytes_moved(lanes, plan, tel, n_locs)
    if env:
        ops = tuple(a + b for a, b in zip(ops, env_ops_per_lane_event(
            loop, n_locs, slots)))
        n_bytes += lanes * (2 * 8 + w * 10 * 4)
    if work:
        ops = tuple(a + b for a, b in zip(ops, work_ops_per_lane_event(
            loop, slots, safety)))
        n_bytes += lanes * (2 * 4 * 4 * slots + w * 10 * 4)
    return bound_ms(lanes, plan, ops, n_bytes)


def hold_base(name: str, a, b, what: str = "base, telemetry off vs on"
              ) -> None:
    """Every field of two stats blocks bitwise (``None`` fields on both)."""
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if x is None and y is None:
            continue
        if x is None or y is None or not torch.equal(x, y):
            bad = (None if x is None or y is None
                   else (x != y).nonzero()[0].tolist())
            raise AssertionError(f"telemetry {name}: {field} ({what}) "
                                 f"differs at lane/window {bad}")


def hold_all(name: str, ref, ker) -> None:
    """Every leaf of two nested (state, stats) results bitwise, floats
    included; ``None`` leaves on both."""
    def walk(a, b, path):
        if a is None and b is None:
            return
        if a is None or b is None:
            raise AssertionError(f"{name}: {path} is None on one side")
        if isinstance(a, tuple):
            names = getattr(a, "_fields", None) or range(len(a))
            for field, x, y in zip(names, a, b):
                walk(x, y, f"{path}.{field}")
            return
        if a.shape != b.shape or not torch.equal(a, b):
            bad = None if a.shape != b.shape else (a != b).nonzero()[0]
            where = None if bad is None else bad.tolist()
            raise AssertionError(f"{name}: {path} differs (plain vs "
                                 f"kernel) at {where}")
    walk(ref, ker, "")


def hold_tel(name: str, ref, ker, off) -> None:
    """Kernel against plain version with telemetry: every field of both
    blocks bitwise, floats and rings included; and the kernel's base stats
    bitwise its own run without telemetry (``off``)."""
    hold_all(f"telemetry {name}", ref, ker)
    hold_base(name, off, ker[0])


def tel_line(tel: Telemetry, ts) -> str:
    """What a telemetry run saw, for the phase's lines."""
    events = ts.events.sum(dim=(0, 1)).tolist()
    ring = ""
    if tel.trace_cap:
        n = ts.ring_n
        ring = (f"; ring {tel.trace_cap}: {int(n.sum())} records, "
                f"{int((n - tel.trace_cap).clamp_min(0).sum())} dropped")
    return (f"Telemetry(n_bins={tel.n_bins}, trace_cap={tel.trace_cap}): "
            f"events by type {events}, {int(ts.wait_hist.sum())} waits, "
            f"{int(ts.cost_hist.sum())} costs binned{ring}")


def phase_telemetry_parity() -> None:
    """Each traversal with telemetry against its plain version on the card,
    on a named subset of its parity configurations at their depths: the
    single queue's three_phase (rmax 8) and single_slot (1,000 events,
    512-event windows after 256), the market's heterogeneous_notice and
    eight_pools_mixed (MARKET_PLAN), the regions' least_loaded and
    eight_regions (REGION_PLAN), each with one of the two telemetries:
    every field bitwise, and the base stats bitwise the kernel's own run
    without telemetry."""
    plan = _window_plan(1_000, 512, 256)
    for (name, job, spot, kernel, rmax, params, lanes), tel in (
            (PARITY_CASES[0], TEL_RING), (PARITY_CASES[2], TEL_NARROW)):
        state0, p, k = fleet(job, spot, kernel, rmax, params, lanes, 7)
        args = (job, spot, kernel, rmax, state0, p, k, plan)
        _, ref = batched_event_windows_ref(*args, tel)
        _, ker = sweep.batched_event_windows(*args, tel)
        _, off = sweep.batched_event_windows(*args)
        torch.cuda.synchronize()
        hold_tel(f"single {name}", ref, ker, off)
        print(f"telemetry parity single queue {name}: {lanes} lanes, rmax "
              f"{rmax}, plan {plan}, {tel_line(tel, ker[1])}: every field "
              f"bitwise, the base stats bitwise the run without telemetry",
              flush=True)
    rng = np.random.default_rng(18)
    for (name, market, kernel, rmax, params, cfg), tel in (
            (MARKET_CASES[1], TEL_RING), (MARKET_CASES[8], TEL_NARROW)):
        p, mp = case_inputs(market.params(), params, cfg, MARKET_LANES, rng,
                            "spot_scale")
        state0, p, mp, k, pre = market_fleet(market, kernel, rmax, p,
                                             MARKET_LANES, 7, mp)
        args = (JOB, market, kernel, rmax, pre, state0, p, mp, k,
                MARKET_PLAN)
        _, ref = market_event_windows_ref(*args, tel)
        _, ker = sweep.market_event_windows(*args, tel)
        _, off = sweep.market_event_windows(*args)
        torch.cuda.synchronize()
        hold_tel(f"market {name}", ref, ker, off)
        print(f"telemetry parity market {name}: P {market.n_pools}, "
              f"{MARKET_LANES} lanes, rmax {rmax}, plan {MARKET_PLAN}, "
              f"{tel_line(tel, ker[1])}: every field bitwise, the base stats "
              f"bitwise the run without telemetry", flush=True)
    rng = np.random.default_rng(19)
    for (name, topo, kernel, params, cfg), tel in (
            (REGION_CASES[3], TEL_RING), (REGION_CASES[9], TEL_NARROW)):
        p, rp = case_inputs(topo.params(), params, cfg, REGION_LANES, rng,
                            "job_scale")
        args = region_fleet(topo, kernel, p, REGION_LANES, 7, rp)
        _, ref = region_event_windows_ref(*args, REGION_PLAN, tel)
        _, ker = sweep.region_event_windows(*args, REGION_PLAN, tel)
        _, off = sweep.region_event_windows(*args, REGION_PLAN)
        torch.cuda.synchronize()
        hold_tel(f"region {name}", ref, ker, off)
        print(f"telemetry parity regions {name}: R {topo.n_regions}, slots "
              f"{topo.total_slots}, {REGION_LANES} lanes, plan "
              f"{REGION_PLAN}, {tel_line(tel, ker[1])}: every field "
              f"bitwise, the base stats bitwise the run without telemetry",
              flush=True)


def tel_fleets():
    """The main-path fleets: (key, loop, the kernel's call on its full-size
    inputs given a telemetry, the entry point's call given a telemetry,
    the launch counter's owner, the summary function)."""
    plan = _window_plan(N_EVENTS, 65_536, BURN_IN)
    key = threefry.key(MAIN_SEED)
    kw = dict(k=K_GRID[None, :], n_events=N_EVENTS, key=key,
              n_seeds=N_SEEDS, burn_in=BURN_IN)
    out = []
    for name, kernel, params, rmax in MAIN_PATHS:
        state0, p, k = main_inputs(kernel, params, rmax)
        out.append((name, "single", rmax, functools.partial(
            lambda tel, a: sweep.batched_event_windows(*a, tel),
            a=(JOB, SPOT, kernel, rmax, state0, p, k, plan)),
            functools.partial(lambda tel, kernel, params, rmax: run_sweep(
                JOB, SPOT, kernel, params, rmax=rmax, telemetry=tel, **kw),
                kernel=kernel, params=params, rmax=rmax),
            sweep.batched_event_windows, summarize))
    margs = market_main_inputs()
    out.append(("market", "market", 64, functools.partial(
        lambda tel: sweep.market_event_windows(*margs, plan, tel)),
        lambda tel: run_market_sweep(JOB, BENCH_MARKET, MARKET_KERNEL,
                                     {"r": R_GRID[:, None]}, rmax=64,
                                     telemetry=tel, **kw),
        sweep.market_event_windows, summarize_market))
    rargs = region_main_inputs()
    out.append(("region", "region", 64, functools.partial(
        lambda tel: sweep.region_event_windows(*rargs, plan, tel)),
        lambda tel: run_region_sweep(BENCH_TOPOLOGY, REGION_KERNEL,
                                     {"r": R_GRID[:, None]}, telemetry=tel,
                                     **kw),
        sweep.region_event_windows, summarize_region))
    return plan, out


def tel_ledgers(loop: str, out: dict) -> dict[str, bool]:
    """tests/test_obs.py's ledgers and their region analogues, at every
    lane of an entry point's result."""
    ev = out["events"]
    checks = {
        "events = n_events": np.all(ev.sum(-1) == N_EVENTS),
        "spot_starts = spot_served": np.array_equal(out["spot_starts"],
                                                    out["spot_served"]),
        "loc_defects = deadline_defects": np.array_equal(
            out["loc_defects"].sum(-1), out["deadline_defects"]),
        "job events = jobs_arrived": np.array_equal(ev[..., 0],
                                                    out["jobs_arrived"])}
    if loop == "single":
        checks.update({
            "no preemption": np.all(ev[..., 2] == 0)
            and np.all(out["preempts_fired"] == 0),
            "rejects + deadline_defects = ondemand": np.array_equal(
                out["rejects"] + out["deadline_defects"], out["ondemand"]),
            "waits = served + defects": np.array_equal(
                out["wait_hist"].sum(-1),
                out["spot_served"] + out["deadline_defects"])})
        return checks
    locs = "pool" if loop == "market" else "region"
    checks.update({
        "preempts_fired >= preemptions": np.all(
            out["preempts_fired"] >= out["preemptions"]),
        "preempt events = preempts_fired": np.array_equal(
            ev[..., 2], out["preempts_fired"]),
        "notices_honored = resumed = loc_resumed": np.array_equal(
            out["notices_honored"], out["resumed"]) and np.array_equal(
            out["loc_resumed"].sum(-1), out["resumed"]),
        f"spot events = sum of {locs}_spot_arrivals": np.array_equal(
            ev[..., 1], out[f"{locs}_spot_arrivals"].sum(-1)),
        "rejects + deadline_defects + revoked defects = ondemand":
            np.array_equal(out["rejects"] + out["deadline_defects"]
                           + out["preemptions"] - out["resumed"],
                           out["ondemand"]),
        "waits = served + defects + revocations": np.array_equal(
            out["wait_hist"].sum(-1), out["spot_served"]
            + out["deadline_defects"] + out["preemptions"])})
    if loop == "region":
        checks["job events = sum of region_jobs"] = np.array_equal(
            ev[..., 0], out["region_jobs"].sum(-1))
    return checks


def hold_sketch(name: str, ts, time_windows, tel: Telemetry) -> float:
    """Every lane's P50/P90/P99 wait sketch within γ − 1 (give or take
    ``wait_lo``) of the exact quantiles replayed from a ring that never
    wrapped (sorted on the card); lane 0's ring exported by
    ``to_perfetto`` as a well-formed trace.  Returns the largest relative
    distance of a sketch from the exact value."""
    cap = tel.trace_cap
    if int(ts.ring_n.max()) > cap:
        raise AssertionError(f"sketch {name}: the ring wrapped")
    keep = ((torch.arange(cap, device=ts.ring_n.device) < ts.ring_n[..., None])
            & (ts.ring_val >= 0))
    lanes = keep.shape[0]
    vals = torch.where(keep, ts.ring_val, torch.inf).reshape(lanes, -1)
    vals = vals.sort(dim=1).values
    count = keep.reshape(lanes, -1).sum(1)
    out = summarize_telemetry(dataclasses.replace(tel, trace_cap=0), ts)
    re, worst = tel.rel_error(), 0.0
    for q, key in ((0.50, "p50_wait"), (0.90, "p90_wait"),
                   (0.99, "p99_wait")):
        idx = torch.clamp_min(torch.ceil(q * count).long() - 1, 0)
        exact = vals[torch.arange(lanes, device=vals.device), idx] \
            .double().cpu().numpy()
        n = count.cpu().numpy()
        est = out[key]
        ok = (n == 0) | ((exact / (1 + re) - tel.wait_lo <= est)
                         & (est <= exact * (1 + re) + tel.wait_lo))
        if not ok.all():
            bad = int(np.flatnonzero(~ok)[0])
            raise AssertionError(f"sketch {name}: lane {bad} {key} "
                                 f"{est[bad]:.5g}, exact {exact[bad]:.5g}")
        sel = (n > 0) & (exact > tel.wait_lo)
        worst = max(worst, float(np.max(np.abs(est[sel] / exact[sel] - 1),
                                         initial=0.0)))
    lane0 = {field[len("ring_"):]: getattr(ts, field)[:1].cpu().numpy()
             for field in ("ring_t", "ring_type", "ring_loc", "ring_qlen",
                           "ring_val", "ring_n")}
    records = device_trace_records(lane0, time_windows[:1].cpu().numpy())
    doc = json.loads(json.dumps(to_perfetto(records, label=name)))
    inst = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    ts_ = [e["ts"] for e in inst]
    if (len(inst) != int(lane0["n"].sum()) or ts_ != sorted(ts_)
            or {e["ph"] for e in doc["traceEvents"]} != {"M", "i", "C"}):
        raise AssertionError(f"sketch {name}: a malformed Perfetto trace")
    return worst


def phase_telemetry_main_path(entries: dict[str, dict]) -> dict:
    """The main-path fleets at full width with ``Telemetry()``: the kernel
    alone with telemetry off and on in turns (off, on, on, off), its base
    stats bitwise the off run's (returned for the env phase: ``{name:
    (off stats, off ms, on ms)}``); each entry point with the launch count set
    to 0 just before and read just after (one launch), its result equal to
    the summary of the kernel's own call, the ledgers at every lane, the
    single-slot fleet's P99 wait within a bin of its deterministic wait;
    then at cut depth, a ring as wide as the windows: every lane's sketch
    within γ − 1 of the ring's exact quantiles, and a Perfetto trace."""
    plan, fleets = tel_fleets()
    lanes = R_GRID.size * K_GRID.size * N_SEEDS
    offs = {}
    for name, loop, rmax, kernel_call, entry_call, owner, summary in fleets:
        entry = entries[loop]
        times = {None: [], TEL_MAIN: []}
        for tel in (None, TEL_MAIN, TEL_MAIN, None):
            ms, (_, stats) = cuda_ms(lambda: kernel_call(tel))
            times[tel].append(ms)
            if tel is None:
                off = stats
            else:
                on = stats
        hold_base(f"{name} full width", off, on[0])
        off_ms, on_ms = (float(np.mean(times[t])) for t in (None, TEL_MAIN))
        offs[name] = off, off_ms, on_ms
        b_ms, b_by = tel_bound_ms(loop, lanes, plan, TEL_MAIN, rmax)
        suffix = "" if name in ("three_phase", "market", "region") \
            else f"_{name}"
        entry.update({f"telemetry{suffix}_ms": on_ms,
                      f"telemetry{suffix}_off_ms": off_ms,
                      f"telemetry{suffix}_bound_ms": b_ms,
                      f"telemetry{suffix}_ratio": on_ms / off_ms})
        print(f"telemetry main-size kernel {name}: {lanes} lanes × "
              f"{sum(plan)} events, off {times[None][0]:.1f} / "
              f"{times[None][1]:.1f} ms, on {times[TEL_MAIN][0]:.1f} / "
              f"{times[TEL_MAIN][1]:.1f} ms: on/off {on_ms / off_ms:.4f}; "
              f"bound with the fold {b_ms:.1f} ms ({b_by}: "
              f"{100 * b_ms / on_ms:.1f}%); base stats bitwise the off run",
              flush=True)

        owner.launches = 0
        t0 = time.perf_counter()
        out = entry_call(TEL_MAIN)
        wall = time.perf_counter() - t0
        launches = owner.launches
        entry["telemetry_launches"] = entry.get("telemetry_launches", 0) \
            + launches
        if launches != 1:
            raise AssertionError(f"telemetry {name}: the entry point "
                                 f"launched the kernel {launches} times")
        base, ts = on
        want = summary((type(base)(*(x[:, 1:] for x in base)),
                        drop_windows(ts, 1)), TEL_MAIN)
        for field, v in want.items():
            if not np.array_equal(out[field], v.reshape(out[field].shape)):
                raise AssertionError(f"telemetry {name}: {field} differs "
                                     f"from the kernel's own call")
        checks = tel_ledgers(loop, out)
        for what, ok in checks.items():
            if not ok:
                raise AssertionError(f"telemetry {name}: {what} fails")
        extra = ""
        if name == "single_slot":
            w = np.broadcast_to(WAITS[:, None, None], out["p99_wait"].shape)
            gamma = 1 + TEL_MAIN.rel_error()
            pos = w > 0
            limit = w * gamma * (1 + 1e-5) + TEL_MAIN.wait_lo
            if not np.all(out["p99_wait"][pos] <= limit[pos]):
                raise AssertionError("telemetry single_slot: a P99 wait "
                                     "above its deterministic wait's bin")
            extra = (f"; P99 wait within a bin of the deterministic wait at "
                     f"every lane (at most "
                     f"{np.max(out['p99_wait'][pos] / w[pos]):.4f}·w, limit "
                     f"γ = {gamma:.4f})")
        print(f"telemetry main path {name}: entry point {wall:.3f} s wall, "
              f"kernel launches {launches}, equal to the kernel's own call; "
              f"P50/P90/P99 wait (mean over lanes) "
              f"{out['p50_wait'].mean():.4f} / {out['p90_wait'].mean():.4f}"
              f" / {out['p99_wait'].mean():.4f} h; {', '.join(checks)} at "
              f"every lane{extra}", flush=True)

    # TEL_CUT_PLAN: kernel and plain version with Telemetry(), bitwise; cut
    # depth: the kernel with a ring as wide as the widest window, for the
    # sketches
    _, kernel, params, rmax = MAIN_PATHS[0]
    for name, loop, args, kernel_fn, plain_fn in (
            ("three_phase", "single",
             (JOB, SPOT, kernel, rmax, *main_inputs(kernel, params, rmax)),
             sweep.batched_event_windows, batched_event_windows_ref),
            ("market", "market", market_main_inputs(),
             sweep.market_event_windows, market_event_windows_ref),
            ("region", "region", region_main_inputs(),
             sweep.region_event_windows, region_event_windows_ref)):
        kernel_fn(*args, TEL_CUT_PLAN, TEL_MAIN)  # warm-up
        cut_ms, (_, ker) = cuda_ms(
            lambda: kernel_fn(*args, TEL_CUT_PLAN, TEL_MAIN), 3)
        plain_ms, (_, ref) = cuda_ms(
            lambda: plain_fn(*args, TEL_CUT_PLAN, TEL_MAIN))
        hold_base(f"{name} cut depth", ref[0], ker[0],
                  "base, plain vs kernel")
        hold_base(f"{name} cut depth", ref[1], ker[1],
                  "telemetry, plain vs kernel")
        b_ms, _ = tel_bound_ms(loop, lanes, TEL_CUT_PLAN, TEL_MAIN, rmax)
        _, (base, ts) = kernel_fn(*args, WIDTH_PLAN, TEL_WIDE)
        worst = hold_sketch(name, ts, base.time_elapsed, TEL_WIDE)
        entries[loop].update(telemetry_cut_ms=cut_ms,
                             telemetry_cut_bound_ms=b_ms,
                             telemetry_plain_ms=plain_ms,
                             sketch_worst_rel=worst)
        print(f"telemetry cut depth {name}: {lanes} lanes, plan "
              f"{TEL_CUT_PLAN}, Telemetry(): kernel {cut_ms:.3f} ms (bound "
              f"{b_ms:.4f} ms), plain {plain_ms:.1f} ms, every field "
              f"bitwise; plan {WIDTH_PLAN} with a ring of "
              f"{TEL_WIDE.trace_cap}: every lane's P50/P90/P99 wait within "
              f"γ − 1 = {TEL_WIDE.rel_error():.4f} of the ring's exact "
              f"quantiles (largest distance {worst:.4f}); lane 0's Perfetto "
              f"trace well-formed", flush=True)
    return offs


# ---------------------------------------------------------------------------
# the environment timeline: the three traversals with the env state
# (sweep.ENV_LIBRARY, and sweep.TEL_ENV_LIBRARY with telemetry)
# ---------------------------------------------------------------------------
#: ptxas's report of each env instantiation, by (telemetry?, kernel name)
ENV_PTXAS: dict[tuple[bool, str], dict[tuple[int, int], str]] = {}
#: the parity phase's plan: a burn-in, two windows and a tail (140 events;
#: none a multiple of a market or region pass, of 7 to 16 events)
ENV_PLAN = _window_plan(109, 47, 31)
ENV_LANES = 70  # a ragged last warp at every G
#: every (G, slots a thread) pick, by rmax (the region topologies' totals)
ENV_LAYOUT_RMAX = (4, 8, 16, 32, 64, 128, 256)


def env_parity_timeline(n: int, t_run: float, every_loc: bool = False
                        ) -> EnvTimeline:
    """A timeline whose boundaries land inside a run of ``t_run`` hours: a
    storm of every location (hazard ×8); a blackout of location 0, or of
    each location in turn (``every_loc``); a price spike ×3 of the last
    location; every location dark at once; a storm of location 0 whose
    multiplier is 0.5 (hazards fall)."""
    t = EnvTimeline.constant()
    t = inject_storm(t, 0.04 * t_run, 0.10 * t_run, hazard_mult=8.0)
    locs = range(n) if every_loc else (0,)
    step = 0.5 / len(locs)
    for i in locs:
        t0 = (0.12 + step * i) * t_run
        t = inject_blackout(t, t0, t0 + 0.8 * step * t_run, loc=i, n_locs=n)
    t = inject_price_spike(t, 0.64 * t_run, 0.70 * t_run, price_mult=3.0,
                           loc=n - 1, n_locs=n)
    t = inject_blackout(t, 0.72 * t_run, 0.76 * t_run)
    return inject_storm(t, 0.80 * t_run, 0.84 * t_run, hazard_mult=0.5,
                        loc=0, n_locs=n)


def env_main_timeline(n: int, horizon: float) -> EnvTimeline:
    """The main path's shock timeline over ``horizon`` hours:
    benchmarks/env_bench.py::_storm_timeline's calm/storm modulator (calm
    hold H/60, storm hold H/200, hazard ×8, availability 0.5, seed 0), a
    blackout of location 0 over [0.40, 0.45]·H and a price spike ×3 of
    every location over [0.70, 0.75]·H."""
    t = markov_timeline(
        (Regime(mean_hold=horizon / 60.0),
         Regime(mean_hold=horizon / 200.0, hazard_mult=8.0, avail=0.5,
                kind=SEG_STORM)), horizon=horizon, seed=0)
    t = inject_blackout(t, 0.40 * horizon, 0.45 * horizon, loc=0, n_locs=n)
    return inject_price_spike(t, 0.70 * horizon, 0.75 * horizon,
                              price_mult=3.0)


def with_env(state, tl: EnvTimeline | None, n_locs: int, init=None):
    """``(state, ep)``: the lanes' state paired with every lane's cursor at
    segment 0 and the timeline's table on the card (``init`` recomputes
    the state's initial clocks under segment 0), or as it is without a
    timeline."""
    if tl is None:
        return state, None
    ep = tl.params(n_locs, DEVICE)
    if init is not None:
        state = init(ep)
    return (state, init_env_state(ep, state.key.shape[0])), ep


def env_counts(estats) -> str:
    """What a run's shock counters saw, for the phase's lines."""
    s = {f: int(getattr(estats, f).sum()) for f in (
        "boundaries", "storms_entered", "blackouts_entered",
        "spikes_entered", "shock_arrivals", "degraded_admits",
        "shock_served", "shock_resumed")}
    return ", ".join(f"{k} {v}" for k, v in s.items())


def env_t_run(run) -> float:
    """0.9 × the least total time a lane of ``run()`` (the kernel without a
    timeline) covers, in hours."""
    _, stats = run()
    if not hasattr(stats, "time_elapsed"):  # a (base, ...) pair
        stats = stats[0]
    return 0.9 * float(stats.time_elapsed.double().sum(1).min())


def env_region_topology(slots: int) -> RegionTopology:
    """Three regions of a ragged partition of ``slots`` slots, unit-scale
    rates."""
    a = max(1, slots // 2)
    b = max(1, (slots - a) // 2)
    rows = [(Exponential(0.6), Exponential(0.5), 0.5, 0.2, 0.5, a),
            (Exponential(0.3), Exponential(0.4), 0.3, 0.4, 0.01, b),
            (Exponential(0.2), Exponential(0.3), 0.2, 0.0, 0.0,
             slots - a - b)]
    return region_topology([r for r in rows if r[5] > 0])


def phase_env_parity() -> None:
    """Each traversal with the env state against its plain version on the
    card, at cut depth (ENV_PLAN, 140 events; the timelines scaled so that
    their boundaries land inside): every (G, slots a thread) the wrapper
    can pick, the blackout of every location, PanicKernel on and off, its
    drain, a kernel without PanicKernel under it, and env with telemetry
    on one configuration of each traversal: every field bitwise, floats,
    the final state and the shock counters included."""
    job, spot = Exponential(1.0), Exponential(0.8)
    for rmax in ENV_LAYOUT_RMAX:
        kernel = (SingleSlotKernel(wait=ExponentialWait(0.5)) if rmax == 4
                  else ThreePhaseKernel())
        params = {} if rmax == 4 else {"r": np.linspace(0.5, rmax, 7)}
        state0, p, k = fleet(job, spot, kernel, rmax, params, ENV_LANES, 5)
        t_run = env_t_run(lambda: sweep.batched_event_windows(
            job, spot, kernel, rmax, state0, p, k, ENV_PLAN))
        keys = threefry.split(threefry.key(5, DEVICE), ENV_LANES)
        st, ep = with_env(state0, env_parity_timeline(1, t_run), 1,
                          lambda ep: init_engine_state(keys, job, spot, rmax,
                                                       ep))
        for tel in ((None, TEL_RING) if rmax == 8 else (None,)):
            args = (job, spot, kernel, rmax, st, p, k, ENV_PLAN, tel, ep)
            ref = batched_event_windows_ref(*args)
            ker = sweep.batched_event_windows(*args)
            torch.cuda.synchronize()
            hold_all(f"env single rmax {rmax}", ref, ker)
            g, spt = picked_layout(rmax)
            print(f"env parity single queue rmax {rmax} (G {g}, {spt} slots "
                  f"a thread), {ENV_LANES} lanes, plan {ENV_PLAN}"
                  f"{', ' + tel_line(tel, ker[1][0][1]) if tel else ''}: "
                  f"{env_counts(ker[1][1])}; every field bitwise",
                  flush=True)
    notice = NoticeAwareKernel(checkpoint_time=0.05)
    market_cases = [
        (4, 2, notice, False),
        (8, 3, PanicKernel(notice, drain_dead=True), False),
        (16, 4, PanicKernel(NoticeAwareKernel(0.05, "least_loaded"),
                            drain_dead=True), True),
        (32, 2, PanicKernel(PoolChoiceKernel(ThreePhaseKernel(),
                                             "fastest")), False),
        (64, 4, PanicKernel(NoticeAwareKernel(0.05, "uniform")), False),
        (128, 8, PanicKernel(notice, drain_dead=True), True),
        (256, 3, PanicKernel(ThreePhaseKernel()), False)]
    for rmax, n, kernel, every_loc in market_cases:
        market = spot_market(tuple(0.9 - 0.1 * i for i in range(n)),
                             tuple(0.1 + 0.05 * (i % 3) for i in range(n)),
                             tuple(0.3 * (i % 2) for i in range(n)),
                             [Exponential(1.0 / n)] * n)
        state0, p, mp, k, pre = market_fleet(
            market, kernel, rmax, {"r": np.linspace(0.5, 6.0, ENV_LANES)},
            ENV_LANES, 6)
        base = (JOB, market, kernel, rmax, pre)
        t_run = env_t_run(lambda: sweep.market_event_windows(
            *base, state0, p, mp, k, ENV_PLAN))
        keys = threefry.split(threefry.key(6, DEVICE), ENV_LANES)
        st, ep = with_env(state0, env_parity_timeline(n, t_run, every_loc),
                          n, lambda ep: init_market_state(
                              keys, JOB, market, rmax, mp, pre, ep))
        for tel in ((None, TEL_NARROW) if rmax == 16 else (None,)):
            args = (*base, st, p, mp, k, ENV_PLAN, tel, ep)
            ref = market_event_windows_ref(*args)
            ker = sweep.market_event_windows(*args)
            torch.cuda.synchronize()
            hold_all(f"env market rmax {rmax}", ref, ker)
            g, spt = picked_layout(rmax)
            print(f"env parity market P {n}, rmax {rmax} (G {g}, {spt} slots "
                  f"a thread), {type(kernel).__name__}"
                  f"{' drain' if getattr(kernel, 'drain_dead', False) else ''}"
                  f", {'every pool' if every_loc else 'pool 0'} blacked out "
                  f"in turn, {ENV_LANES} lanes"
                  f"{', ' + tel_line(tel, ker[1][0][1]) if tel else ''}: "
                  f"{env_counts(ker[1][1])}; every field bitwise",
                  flush=True)
    routed = RoutingKernel(notice, "least_loaded")
    region_cases = [
        (4, notice, False),
        (8, PanicKernel(routed), True),
        (16, RoutingKernel(notice, "cheapest"), False),
        (32, PanicKernel(RoutingKernel(ThreePhaseKernel(), "fastest")),
         True),
        (64, RoutingKernel(PanicKernel(notice), "uniform"), False),
        (128, PanicKernel(notice), True),
        (256, PanicKernel(routed), False)]
    for slots, kernel, every_loc in region_cases:
        topo = env_region_topology(slots)
        n = topo.n_regions
        rparams = {"r": np.linspace(0.5, 6.0, ENV_LANES)}
        args0 = region_fleet(topo, kernel, rparams, ENV_LANES, 8)
        t_run = env_t_run(lambda: sweep.region_event_windows(
            *args0, ENV_PLAN))
        topo_, kern_, pre, state0, p, rp, k = args0
        keys = threefry.split(threefry.key(8, DEVICE), ENV_LANES)
        st, ep = with_env(state0, env_parity_timeline(n, t_run, every_loc),
                          n, lambda ep: init_region_state(keys, topo, rp,
                                                          pre, ep))
        for tel in ((None, TEL_RING) if slots == 32 else (None,)):
            args = (topo, kernel, pre, st, p, rp, k, ENV_PLAN, tel, ep)
            ref = region_event_windows_ref(*args)
            ker = sweep.region_event_windows(*args)
            torch.cuda.synchronize()
            hold_all(f"env regions slots {slots}", ref, ker)
            g, spt = picked_layout(slots)
            print(f"env parity regions R {n}, slots {slots} (G {g}, {spt} "
                  f"slots a thread), {type(kernel).__name__}, "
                  f"{'every region' if every_loc else 'region 0'} blacked "
                  f"out in turn, {ENV_LANES} lanes"
                  f"{', ' + tel_line(tel, ker[1][0][1]) if tel else ''}: "
                  f"{env_counts(ker[1][1])}; every field bitwise",
                  flush=True)


def env_ops_per_lane_event(loop: str, n_locs: int,
                           rmax: int) -> tuple[int, int]:
    """(INT32, FP32) operations the env state adds to a lane-event,
    counted from the kernel's chain as csrc/sweep.cu does it (a crossing,
    ~10^-4 of the events, not counted).  Every loop: the boundary's
    compare and min (2 FP32), the three event masks (3 INT32), the cursor's
    countdown and select (2 FP32), the shock test and four counters'
    masks and adds (9 INT32), two dwell selects and adds (4 FP32).  The
    single queue: the spot draw's × 1/avail and the price select (2
    FP32).  The market and regions: the fixed choice's select (1 INT32),
    PanicKernel's failover and gate (4 INT32), a spot draw's × 1/avail a
    location (P FP32); the market the drain's test a slot (3 INT32 ×
    rmax).  The thinning pick and the preemption clock's division, which
    the env build does on the chain and the base build in the sample pass,
    are the base count's (:func:`market_ops_per_lane_event`)."""
    n_int, n_fp = 12, 8
    if loop == "single":
        return n_int, n_fp + 2
    n_int += 1 + 4
    n_fp += n_locs
    if loop == "market":
        n_int += 3 * rmax
    return n_int, n_fp


def dwell_bound(window_sums: np.ndarray, plan, n_segments: int,
                t_end_max: float, seg_len_max: float) -> np.ndarray:
    """The float32 rounding bound of a lane's total dwell time against the
    exact length of its segments: each window's sum of at most plan[w]
    terms within plan[w] half-ulps of its value (the market's spend bound, with
    the window's event count as the number of terms), the countdown's
    subtractions within half an ulp of a segment's length an event, and
    the table's float32 end times."""
    windows = (np.asarray(plan) * np.spacing(
        window_sums.astype(np.float32)).astype(np.float64) / 2).sum(-1)
    countdown = sum(plan) * float(np.spacing(np.float32(seg_len_max))) / 2
    table = n_segments * 2 * float(np.spacing(np.float32(t_end_max)))
    return windows + countdown + table


def env_fleets():
    """The three main-path fleets under env: (name, loop, n_locs, the
    kernel's call given (timeline, telemetry), the entry point's call
    given a timeline, the launch counter's owner, the summary function).
    The kernel's call without a timeline runs the base kernel (no
    PanicKernel) on the build without the env state: the off run the
    ratios divide by; with one, the main path's PanicKernel, its initial
    clocks under segment 0."""
    plan = _window_plan(N_EVENTS, 65_536, BURN_IN)
    key = threefry.key(MAIN_SEED)
    kw = dict(k=K_GRID[None, :], n_events=N_EVENTS, key=key,
              n_seeds=N_SEEDS, burn_in=BURN_IN)
    out = []
    _, kernel, params, rmax = MAIN_PATHS[0]
    state0, p, k = main_inputs(kernel, params, rmax)

    def single(tl, tel=None):
        st, ep = with_env(state0, tl, 1, lambda ep: init_engine_state(
            main_keys(), JOB, SPOT, rmax, ep))
        return sweep.batched_event_windows(JOB, SPOT, kernel, rmax, st, p, k,
                                           plan, tel, ep)

    out.append(("three_phase", "single", 1, single,
                lambda tl: run_sweep(JOB, SPOT, kernel, params, rmax=rmax,
                                     env=tl, **kw),
                sweep.batched_event_windows, summarize))
    margs = market_main_inputs(BENCH_MARKET, ENV_MARKET_KERNEL)
    moff = market_main_inputs()

    def mkt(tl, tel=None):
        if tl is None:  # the base kernel, on the build without the env
            return sweep.market_event_windows(*moff, plan, tel)
        st, ep = with_env(margs[5], tl, BENCH_MARKET.n_pools,
                          lambda ep: init_market_state(
                              main_keys(), JOB, BENCH_MARKET, 64, margs[7],
                              margs[4], ep))
        return sweep.market_event_windows(*margs[:5], st, *margs[6:], plan,
                                          tel, ep)

    out.append(("market", "market", BENCH_MARKET.n_pools, mkt,
                lambda tl: run_market_sweep(
                    JOB, BENCH_MARKET, ENV_MARKET_KERNEL,
                    {"r": R_GRID[:, None]}, rmax=64, env=tl, **kw),
                sweep.market_event_windows, summarize_market))
    rargs = region_main_inputs(BENCH_TOPOLOGY, ENV_REGION_KERNEL)
    roff = region_main_inputs()

    def reg(tl, tel=None):
        if tl is None:  # the base kernel, on the build without the env
            return sweep.region_event_windows(*roff, plan, tel)
        st, ep = with_env(rargs[3], tl, BENCH_TOPOLOGY.n_regions,
                          lambda ep: init_region_state(
                              main_keys(), BENCH_TOPOLOGY, rargs[5],
                              rargs[2], ep))
        return sweep.region_event_windows(*rargs[:3], st, *rargs[4:], plan,
                                          tel, ep)

    out.append(("region", "region", BENCH_TOPOLOGY.n_regions, reg,
                lambda tl: run_region_sweep(
                    BENCH_TOPOLOGY, ENV_REGION_KERNEL,
                    {"r": R_GRID[:, None]}, env=tl, **kw),
                sweep.region_event_windows, summarize_region))
    return plan, out


#: the main path's PanicKernels: the market's drains, the regions' route
#: fails over
ENV_MARKET_KERNEL = PanicKernel(NoticeAwareKernel(checkpoint_time=0.05),
                                drain_dead=True)
ENV_REGION_KERNEL = PanicKernel(REGION_KERNEL)


def main_keys():
    """Every main-path lane's key, as the entry points lay them out."""
    keys = threefry.split(threefry.key(MAIN_SEED, DEVICE), N_SEEDS)
    return keys.repeat(R_GRID.size * K_GRID.size, 1)


def env_ledgers(loop: str, out: dict, tl: EnvTimeline, estats) -> dict:
    """The shock identities at every lane over the whole run (``estats``,
    the kernel's own windows, the burn-in included: the timeline starts
    with it) and the ledgers of PERF.md §2 at every lane of an entry
    point's result under ``tl``."""
    def total(field):
        return getattr(estats, field).sum(1).cpu().numpy()

    checks = {
        "env_boundaries = S - 1": np.all(total("boundaries")
                                         == tl.n_segments - 1),
        "storms observed = injected": np.all(total("storms_entered")
                                             == tl.count_storms()),
        "blackouts observed = injected": np.all(
            total("blackouts_entered") == tl.count_blackouts()),
        "spikes observed = injected": np.all(total("spikes_entered")
                                             == tl.count_spikes()),
        "degraded_admits <= shock_arrivals": np.all(
            total("degraded_admits") <= total("shock_arrivals"))
        and np.all(out["degraded_admits"] <= out["shock_arrivals"])}
    if loop == "single":
        checks["completed = served + on-demand"] = np.array_equal(
            out["jobs_completed"], out["spot_served"] + out["ondemand"])
    else:
        checks["completed = served + on-demand + resumed"] = np.array_equal(
            out["jobs_completed"],
            out["spot_served"] + out["ondemand"] + out["resumed"])
    if loop == "region":
        admitted = out["region_routed"].sum(-1)
        checks.update({
            "spot_served = sum of region_served": np.array_equal(
                out["spot_served"], out["region_served"].sum(-1)),
            "jobs_arrived = sum of region_jobs": np.array_equal(
                out["jobs_arrived"], out["region_jobs"].sum(-1)),
            "routed_home <= admitted <= jobs_arrived": bool(np.all(
                (out["routed_home"] <= admitted)
                & (admitted <= out["jobs_arrived"])))})
    return checks


def phase_env_main_path(entries: dict[str, dict], offs: dict) -> None:
    """The three main-path fleets at full width under the shock timeline
    (H = 0.4 × the least time a lane covers without a timeline, so every
    lane crosses every boundary): the kernel under the constant timeline
    and under the shock one (the main path's PanicKernel), and with
    ``Telemetry()`` under the shock one, one timed run each, their on/off
    ratios against the off runs of :func:`phase_telemetry_main_path` in
    ``offs`` (the base kernel on the build without the env state, without
    and with ``Telemetry()``, the same inputs); the constant timeline's
    base stats bitwise the off run's (PanicKernel without a blackout is
    its base); each entry point under the shock timeline with
    the launch count set to 0 just before and read just after (one
    launch), equal to the summary of the kernel's own call, the shock
    identities and the ledgers at every lane, each lane's storm and
    blackout time within its float32 rounding bound of the segments'
    length; then the kernel against its plain version with the env state
    and ``Telemetry()`` on the main-path inputs over TEL_CUT_PLAN, the
    shock timeline scaled so that its boundaries land inside."""
    plan, fleets = env_fleets()
    lanes = R_GRID.size * K_GRID.size * N_SEEDS
    const = EnvTimeline.constant()
    for name, loop, n_locs, kernel_call, entry_call, owner, summary in fleets:
        entry = entries[loop]
        off, off_ms, tel_off_ms = offs[name]
        horizon = 0.4 * float(off.time_elapsed.double().sum(1).min())
        shock = env_main_timeline(n_locs, horizon)
        const_ms, (_, const_stats) = cuda_ms(lambda: kernel_call(const))
        hold_base(f"{name} constant timeline", off, const_stats[0],
                  "base, env off vs the constant timeline")
        env_ms, (_, shock_stats) = cuda_ms(lambda: kernel_call(shock))
        tel_ms, (_, tstats) = cuda_ms(lambda: kernel_call(shock, TEL_MAIN))
        hold_base(f"{name} shock timeline", shock_stats[0], tstats[0][0],
                  "base, telemetry off vs on under the shock timeline")
        hold_base(f"{name} shock timeline", shock_stats[1], tstats[1],
                  "shock counters, telemetry off vs on")
        b_ms, b_by = tel_bound_ms(loop, lanes, plan, None, env=True)
        bt_ms, _ = tel_bound_ms(loop, lanes, plan, TEL_MAIN, env=True)
        entry.update({
            "env_ms": env_ms, "env_off_ms": off_ms,
            "env_constant_ms": const_ms, "env_ratio": env_ms / off_ms,
            "env_constant_ratio": const_ms / off_ms,
            "env_tel_ms": tel_ms, "env_tel_off_ms": tel_off_ms,
            "env_tel_ratio": tel_ms / tel_off_ms,
            "env_bound_ms": b_ms, "env_bound_by": b_by,
            "env_tel_bound_ms": bt_ms, "env_segments": shock.n_segments,
            "env_horizon_h": horizon})
        print(f"env main-size kernel {name}: {lanes} lanes × {sum(plan)} "
              f"events; shock timeline over H {horizon:.4g} h, "
              f"{shock.n_segments} segments ({shock.count_storms()} storms, "
              f"{shock.count_blackouts()} blackout, {shock.count_spikes()} "
              f"spike); off {off_ms:.1f} ms (the telemetry phase's), "
              f"constant {const_ms:.1f} ms, shock {env_ms:.1f} ms: on/off "
              f"constant {entry['env_constant_ratio']:.4f}, shock "
              f"{entry['env_ratio']:.4f}; with Telemetry() off "
              f"{tel_off_ms:.1f} ms, shock {tel_ms:.1f} ms: "
              f"{entry['env_tel_ratio']:.4f}; bound with the env state "
              f"{b_ms:.1f} ms ({b_by}: {100 * b_ms / env_ms:.1f}%), "
              f"with telemetry too {bt_ms:.1f} ms; the constant timeline's "
              f"base stats bitwise the off run", flush=True)

        owner.launches = 0
        t0 = time.perf_counter()
        out = entry_call(shock)
        wall = time.perf_counter() - t0
        launches = owner.launches
        entry["env_launches"] = entry.get("env_launches", 0) + launches
        if launches != 1:
            raise AssertionError(f"env {name}: the entry point launched "
                                 f"the kernel {launches} times")
        base, estats = shock_stats
        want = summary((type(base)(*(x[:, 1:] for x in base)),
                        EnvWindowStats(*(x[:, 1:] for x in estats))),
                       None, shock)
        for field, v in want.items():
            if not np.array_equal(out[field], np.reshape(
                    v, np.shape(out[field]))):
                raise AssertionError(f"env {name}: {field} differs from the "
                                     f"kernel's own call")
        checks = env_ledgers(loop, out, shock, estats)
        for what, ok in checks.items():
            if not ok:
                raise AssertionError(f"env {name}: {what} fails")
        # the dwell times over the whole run (burn-in included) against the
        # segments' exact length, within their float32 rounding bound
        segs = list(shock.segments())
        worst = 0.0
        for kind, field, f in ((SEG_STORM, "storm_time", estats.storm_time),
                               (SEG_BLACKOUT, "blackout_time",
                                estats.blackout_time)):
            exact = sum(t1 - t0 for t0, t1, *_, kd in segs if kd == kind)
            got = f.double().sum(1).cpu().numpy()
            bound = dwell_bound(f.cpu().numpy(), plan, shock.n_segments,
                                shock.span(), max(
                                    t1 - t0 for t0, t1, *_ in segs[:-1]))
            if not np.all(np.abs(got - exact) <= bound):
                bad = int(np.flatnonzero(np.abs(got - exact) > bound)[0])
                raise AssertionError(f"env {name}: lane {bad} {field} "
                                     f"{got[bad]} against {exact} (bound "
                                     f"{bound[bad]:.4g})")
            worst = max(worst, float((np.abs(got - exact) / bound).max()))
        entry["env_dwell_max_of_bound"] = max(
            entry.get("env_dwell_max_of_bound", 0.0), worst)
        print(f"env main path {name}: entry point {wall:.3f} s wall, kernel "
              f"launches {launches}, equal to the kernel's own call; "
              f"{env_counts(estats)} (over all lanes, burn-in included); "
              f"{', '.join(checks)} at every lane; storm and blackout time "
              f"within their float32 rounding bound of the segments' length "
              f"(at most {worst:.3f} of it)", flush=True)

    # TEL_CUT_PLAN: kernel and plain version with the env state and
    # Telemetry() on the main-path inputs, the shock timeline scaled so
    # that its boundaries land inside the cut
    _, kernel, params, rmax = MAIN_PATHS[0]
    state0, p, k = main_inputs(kernel, params, rmax)
    margs = market_main_inputs(BENCH_MARKET, ENV_MARKET_KERNEL)
    rargs = region_main_inputs(BENCH_TOPOLOGY, ENV_REGION_KERNEL)
    for name, loop, n_locs, call, plain, init in (
            ("three_phase", "single", 1,
             lambda st, ep, tel: sweep.batched_event_windows(
                 JOB, SPOT, kernel, rmax, st, p, k, TEL_CUT_PLAN, tel, ep),
             lambda st, ep, tel: batched_event_windows_ref(
                 JOB, SPOT, kernel, rmax, st, p, k, TEL_CUT_PLAN, tel, ep),
             lambda ep: init_engine_state(main_keys(), JOB, SPOT, rmax, ep)),
            ("market", "market", BENCH_MARKET.n_pools,
             lambda st, ep, tel: sweep.market_event_windows(
                 *margs[:5], st, *margs[6:], TEL_CUT_PLAN, tel, ep),
             lambda st, ep, tel: market_event_windows_ref(
                 *margs[:5], st, *margs[6:], TEL_CUT_PLAN, tel, ep),
             lambda ep: init_market_state(main_keys(), JOB, BENCH_MARKET, 64,
                                          margs[7], margs[4], ep)),
            ("region", "region", BENCH_TOPOLOGY.n_regions,
             lambda st, ep, tel: sweep.region_event_windows(
                 *rargs[:3], st, *rargs[4:], TEL_CUT_PLAN, tel, ep),
             lambda st, ep, tel: region_event_windows_ref(
                 *rargs[:3], st, *rargs[4:], TEL_CUT_PLAN, tel, ep),
             lambda ep: init_region_state(main_keys(), BENCH_TOPOLOGY,
                                          rargs[5], rargs[2], ep))):
        entry = entries[loop]
        run0 = {"single": state0, "market": margs[5],
                "region": rargs[3]}[loop]
        _, off = call(run0, None, None)
        horizon = 0.4 * float(off.time_elapsed.double().sum(1).min())
        st, ep = with_env(run0, env_main_timeline(n_locs, horizon), n_locs,
                          init)
        call(st, ep, TEL_MAIN)  # warm-up
        cut_ms, ker = cuda_ms(lambda: call(st, ep, TEL_MAIN), 3)
        plain_ms, ref = cuda_ms(lambda: plain(st, ep, TEL_MAIN))
        hold_all(f"env {name} cut depth", ref, ker)
        b_ms, _ = tel_bound_ms(loop, lanes, TEL_CUT_PLAN, TEL_MAIN,
                               env=True)
        entry.update(env_cut_ms=cut_ms, env_cut_bound_ms=b_ms,
                     env_plain_ms=plain_ms)
        print(f"env cut depth {name}: {lanes} lanes, plan {TEL_CUT_PLAN}, "
              f"the shock timeline over H {horizon:.4g} h, Telemetry(): "
              f"kernel {cut_ms:.3f} ms (bound {b_ms:.4f} ms), plain "
              f"{plain_ms:.1f} ms; {env_counts(ker[1][1])}; every field "
              f"bitwise", flush=True)


# ---------------------------------------------------------------------------
# the work structure: the three traversals with the work state
# (sweep.WORK_LIBRARY, and its telemetry and env twins)
# ---------------------------------------------------------------------------
#: ptxas's report of each work instantiation, by (telemetry?, env?, kernel
#: name)
WORK_PTXAS: dict[tuple[bool, bool, str], dict[tuple[int, int], str]] = {}
#: the parity phase's plan: a burn-in, two windows and a tail (48 events,
#: no window a multiple of a draw pass)
WORK_PLAN = _window_plan(37, 15, 11)
#: the depth at which the work state with telemetry is held to, and timed
#: beside, its plain version on the main-path inputs
WORK_CUT_PLAN = (128,)
WORK_LANES = 70  # a ragged last warp at every G
#: a model of each checkpoint mode whose every ledger column moves within
#: WORK_PLAN at unit rates: three units a job, priced restarts, a deadline
#: a few services long
WORK_PARITY = {
    mode: make(total_work=3.0, restart_overhead=0.5, deadline=8.0,
               od_time=1.0)
    for mode, make in (
        ("never", WorkModel.never),
        ("notice", functools.partial(WorkModel.on_notice, 0.05)),
        ("periodic", functools.partial(WorkModel.periodic, 1.0, 0.25)))}
#: the axes each work configuration runs with: (telemetry, env?)
WORK_AXES = ((None, False), (TEL_RING, False), (None, True),
             (TEL_NARROW, True))
#: benchmarks/deadline_bench.py::_priced(): the main path's work model
WORK_PRICED = WorkModel.on_notice(0.2, total_work=3.0, restart_overhead=0.5,
                                  deadline=120.0, od_time=10.0)
#: ... without restart overhead or checkpoints: work lost = recomputed
WORK_FREE = WorkModel.never(total_work=3.0, deadline=120.0, od_time=10.0)
#: the main path's safety net over the market main path's kernel, with the
#: 0.2 h buffer of benchmarks/deadline_bench.py's tournament, and with one
#: that covers the largest drop of slack a resume can make there (the
#: restart overhead × od_time = 5 h: the cheapest pool's 2 h notice always
#: fits the 0.2 h checkpoint, so no progress is lost)
WORK_NET_KERNEL = CantBeLateKernel(MARKET_KERNEL, slack_buffer=0.2)
WORK_COVER_KERNEL = CantBeLateKernel(MARKET_KERNEL, slack_buffer=5.2)
#: tests/test_work.py's tournament on the committed k80 trace
K80_TRACE = ROOT / "tests" / "data" / "spot_trace_k80.json"
K80_WORK = WorkModel.on_notice(0.05, total_work=1.0, restart_overhead=0.2,
                               deadline=2.5, od_time=0.5)
K80_KERNEL = NoticeAwareKernel(checkpoint_time=0.05)


def work_counts(ws) -> str:
    """What a run's survival ledger saw, for the phase's lines."""
    s = {f: int(getattr(ws, f).sum()) for f in (
        "admitted", "finished", "misses", "checkpoints", "panics")}
    return (", ".join(f"{k} {v}" for k, v in s.items())
            + f", work lost {float(ws.work_lost.double().sum()):g}")


def work_state0(state, n_slots: int):
    """The carry paired (outermost) with every lane's zero work state."""
    base = state if hasattr(state, "key") else state[0]
    return state, init_work_state(n_slots, base.key.shape[0], DEVICE)


def work_parity_single(rmax: int, env: bool, i: int):
    """(kernel fn, plain fn, head given a kernel, state, tail, slots, the
    configuration's kernel, ep) of a single-queue work configuration."""
    job, spot, kernel = Exponential(1.0), Exponential(0.8), ThreePhaseKernel()
    state0, p, k = fleet(job, spot, kernel, rmax,
                         {"r": np.linspace(0.5, 6.0, WORK_LANES)},
                         WORK_LANES, 5 + i)
    st, ep = state0, None
    if env:
        t_run = env_t_run(lambda: sweep.batched_event_windows(
            job, spot, kernel, rmax, state0, p, k, WORK_PLAN))
        keys = threefry.split(threefry.key(5 + i, DEVICE), WORK_LANES)
        st, ep = with_env(state0, env_parity_timeline(1, t_run), 1,
                          lambda ep: init_engine_state(keys, job, spot, rmax,
                                                       ep))
    return (sweep.batched_event_windows, batched_event_windows_ref,
            lambda kern: (job, spot, kern, rmax), st, (p, k), rmax, kernel,
            ep)


def work_parity_market(rmax: int, env: bool, i: int):
    """:func:`work_parity_single`'s tuple for a market configuration: 2-4
    pools of unit-scale rates, hazards 0.15-0.25, notices 0 and 0.3 (the
    notice-mode checkpoint fits every other pool); under the env timeline
    every pool blacked out in turn and PanicKernel's drain on."""
    n = 2 + i % 3
    job = Exponential(1.0)
    market = spot_market(tuple(0.9 - 0.1 * j for j in range(n)),
                         tuple(0.15 + 0.05 * (j % 3) for j in range(n)),
                         tuple(0.3 * (j % 2) for j in range(n)),
                         [Exponential(0.8 / n)] * n)
    kernel = NoticeAwareKernel(0.05, "cheapest" if i % 2 else
                               "least_loaded")
    if env:
        kernel = PanicKernel(kernel, drain_dead=True)
    keys, p, k, mp = lane_inputs(market.params(),
                                 {"r": np.linspace(0.5, 6.0, WORK_LANES)},
                                 WORK_LANES, 6 + i)
    state0 = init_market_state(keys, job, market, rmax, mp, True)
    st, ep = state0, None
    if env:
        t_run = env_t_run(lambda: sweep.market_event_windows(
            job, market, kernel, rmax, True, state0, p, mp, k, WORK_PLAN))
        st, ep = with_env(state0, env_parity_timeline(n, t_run, True), n,
                          lambda ep: init_market_state(keys, job, market,
                                                       rmax, mp, True, ep))
    return (sweep.market_event_windows, market_event_windows_ref,
            lambda kern: (job, market, kern, rmax, True), st, (p, mp, k),
            rmax, kernel, ep)


def work_parity_region(slots: int, env: bool, i: int):
    """:func:`work_parity_single`'s tuple for a region configuration: three
    regions of a ragged partition under least_loaded routing; under the
    env timeline every region blacked out in turn and PanicKernel's route
    failover on."""
    topo = env_region_topology(slots)
    kernel = RoutingKernel(NoticeAwareKernel(checkpoint_time=0.05),
                           "least_loaded")
    if env:
        kernel = PanicKernel(kernel)
    topo, _, pre, state0, p, rp, k = region_fleet(
        topo, kernel, {"r": np.linspace(0.5, 6.0, WORK_LANES)}, WORK_LANES,
        8 + i)
    st, ep = state0, None
    if env:
        t_run = env_t_run(lambda: sweep.region_event_windows(
            topo, kernel, pre, state0, p, rp, k, WORK_PLAN))
        keys = threefry.split(threefry.key(8 + i, DEVICE), WORK_LANES)
        st, ep = with_env(state0, env_parity_timeline(topo.n_regions, t_run,
                                                      True),
                          topo.n_regions, lambda ep: init_region_state(
                              keys, topo, rp, pre, ep))
    return (sweep.region_event_windows, region_event_windows_ref,
            lambda kern: (topo, kern, pre), st, (p, rp, k), slots, kernel,
            ep)


def phase_work_parity() -> None:
    """Each traversal with the work state against its plain version on the
    card, at cut depth (WORK_PLAN, 48 events): each of the four axes
    (work alone, with telemetry, with the env timeline, with both) × the
    three checkpoint modes, on the traversal's (G, slots a thread) layouts
    in turn, with and without ``CantBeLateKernel``: every field bitwise,
    floats, the final work state and the survival ledger included.  And
    ``WorkModel()`` on the work builds: the state and the stats bitwise the
    build's without the work state, on each axis of each traversal."""
    for loop, build in (("single", work_parity_single),
                        ("market", work_parity_market),
                        ("region", work_parity_region)):
        seen = {"misses": 0, "panics": 0, "checkpoints": 0, "lost": 0.0}
        cases = [(a, m) for a in WORK_AXES for m in WORK_PARITY]
        for i, ((tel, env), mode) in enumerate(cases):
            rmax = ENV_LAYOUT_RMAX[i % len(ENV_LAYOUT_RMAX)]
            fn, plain, head, st, tail, slots, kernel, ep = build(rmax, env, i)
            work = WORK_PARITY[mode]
            for net in (False, True):
                kern = CantBeLateKernel(kernel, 0.2) if net else kernel
                args = (*head(kern), work_state0(st, slots), *tail,
                        WORK_PLAN, tel, ep, work, work.params(DEVICE))
                ref = plain(*args)
                ker = fn(*args)
                torch.cuda.synchronize()
                g, spt = picked_layout(slots)
                what = (f"work {loop} {mode}{' + telemetry' if tel else ''}"
                        f"{' + env' if env else ''}"
                        f"{' + CantBeLateKernel' if net else ''}, "
                        f"{'rmax' if loop != 'region' else 'slots'} {slots} "
                        f"(G {g}, {spt} slots a thread)")
                hold_all(what, ref, ker)
                ws = ker[1][1]
                seen["misses"] += int(ws.misses.sum()) if not net else 0
                seen["panics"] += int(ws.panics.sum())
                seen["checkpoints"] += int(ws.checkpoints.sum())
                seen["lost"] += float(ws.work_lost.double().sum())
                print(f"{what}, {WORK_LANES} lanes, plan {WORK_PLAN}: "
                      f"{work_counts(ws)}; every field bitwise", flush=True)
            if mode != "never":
                continue
            # the identity model on the work build: the build without it
            args = (*head(kernel), st, *tail, WORK_PLAN, tel, ep)
            fin_off, off = fn(*args)
            identity = WorkModel()
            fin_id, on = fn(*head(kernel), work_state0(st, slots), *tail,
                            WORK_PLAN, tel, ep, identity,
                            identity.params(DEVICE))
            torch.cuda.synchronize()
            hold_all(f"work {loop} identity model", (fin_off, off),
                     (fin_id[0], on[0]))
            print(f"work {loop} WorkModel(){' + telemetry' if tel else ''}"
                  f"{' + env' if env else ''}: state and stats bitwise the "
                  f"build without the work state", flush=True)
        need = ("panics", "checkpoints") + (
            ("misses",) if loop == "single" else ("misses", "lost"))
        if not all(seen[n] > 0 for n in need):
            raise AssertionError(f"work {loop}: the parity runs left a "
                                 f"ledger column still: {seen}")


def work_ops_per_lane_event(loop: str, slots: int,
                            safety: bool) -> tuple[int, int]:
    """(INT32, FP32) operations the work state adds to a lane-event,
    counted from csrc/sweep.cu's work code.  Every loop: the serve's slot
    (3 shared loads and their address, 4 INT32) and its arithmetic
    (remainder, debt, spill, progress, work done, completion, the periodic
    test: 13 FP32), the defector's remainder (2 FP32), the writes of the
    served and joining slots (2 INT32 addresses), the ledger's miss tests
    (3 products and sums, 4 compares: 10 FP32; 8 INT32 masks) and its
    counters (6 INT32, 5 FP32 adds).  The market and regions: each slot's
    life (1 FP32 add, 1 select at a join), its three one-hot reads at the
    defecting, serving and revoked slot (3 INT32 compares, 3 FP32 selects
    a slot), and the rollback (the revoked slot's 3 loads and its
    address, the notice bit, the checkpoint, loss and overhead: 4 INT32,
    6 FP32).  With the safety net: each slot's panic clock (2 loads, 8
    FP32: difference, clamp, sum, product, three differences, clamp), its
    race with the budget (2 FP32) and its bit (2 INT32), and the
    defector's bit (2 INT32)."""
    n_int, n_fp = 4 + 2 + 8 + 6, 13 + 2 + 10 + 5
    if loop != "single":
        n_int += 3 * slots + 4
        n_fp += 5 * slots + 6
    if safety:
        n_int += 4 * slots + 2
        n_fp += 10 * slots
    return n_int, n_fp


def work_fleets():
    """The three main-path fleets with the work state: (name, loop, the
    kernel's call given a work model and a kernel (None: the main path's),
    the entry point's call given the same, the launch counter's owner, the
    summary function, the final queue length of a final state)."""
    plan = _window_plan(N_EVENTS, 65_536, BURN_IN)
    key = threefry.key(MAIN_SEED)
    kw = dict(k=K_GRID[None, :], n_events=N_EVENTS, key=key,
              n_seeds=N_SEEDS, burn_in=BURN_IN)
    _, kernel, params, rmax = MAIN_PATHS[0]
    state0, p, k = main_inputs(kernel, params, rmax)
    margs = market_main_inputs()
    rargs = region_main_inputs()
    slots = BENCH_TOPOLOGY.total_slots
    return plan, [
        ("three_phase", "single",
         lambda work, kern=None: sweep.batched_event_windows(
             JOB, SPOT, kern or kernel, rmax, work_state0(state0, rmax), p, k,
             plan, None, None, work, work.params(DEVICE)),
         lambda work, kern=None: run_sweep(
             JOB, SPOT, kern or kernel, params, rmax=rmax, work=work, **kw),
         sweep.batched_event_windows, summarize, lambda s: s.qlen),
        ("market", "market",
         lambda work, kern=None: sweep.market_event_windows(
             *margs[:2], kern or margs[2], *margs[3:5],
             work_state0(margs[5], 64), *margs[6:], plan, None, None, work,
             work.params(DEVICE)),
         lambda work, kern=None: run_market_sweep(
             JOB, BENCH_MARKET, kern or MARKET_KERNEL,
             {"r": R_GRID[:, None]}, rmax=64, work=work, **kw),
         sweep.market_event_windows, summarize_market, lambda s: s.qlen),
        ("region", "region",
         lambda work, kern=None: sweep.region_event_windows(
             rargs[0], kern or rargs[1], rargs[2],
             work_state0(rargs[3], slots), *rargs[4:], plan, None, None,
             work, work.params(DEVICE)),
         lambda work, kern=None: run_region_sweep(
             BENCH_TOPOLOGY, kern or REGION_KERNEL, {"r": R_GRID[:, None]},
             work=work, **kw),
         sweep.region_event_windows, summarize_region,
         lambda s: s.qlen.sum(1))]


def work_ledgers(fin, stats, queue) -> dict[str, bool]:
    """The survival identities at every lane and window of a kernel's own
    run (cold start, burn-in included): every finished job on time or
    late, and every admission finished or still queued."""
    ws = stats[1]
    admitted = ws.admitted.long().sum(1)
    finished = ws.finished.long().sum(1)
    return {
        "ontime + misses = finished": bool(torch.equal(
            ws.ontime + ws.misses, ws.finished)),
        "admitted - finished = final queue": bool(torch.equal(
            admitted - finished, queue(fin[0]).long()))}


def k80_tournament(kernel, plain: bool = False) -> dict:
    """tests/test_work.py's tournament on the card at one lane, through
    ``run_market_sim`` (the kernel) or, with ``plain``, the market's plain
    version on the same inputs on the card."""
    d = json.loads(K80_TRACE.read_text())
    tl = timeline_from_trace(d["times"], d["avail"])
    market = SpotMarket(pools=tuple(
        SpotPool(Exponential(r), price=q["price"], hazard=q["hazard"],
                 notice=q["notice"]) for r, q in zip((0.8, 0.6), d["pools"])))
    job, key = Exponential(1.2), threefry.key(7)
    run = dict(n_events=2_500, burn_in=0, chunk_events=1_024)
    if not plain:
        return run_market_sim(job, market, kernel, {"r": 2.0}, k=5.0,
                              key=key, env=tl, work=K80_WORK, **run)
    mp = _config_tensors(_broadcast_market_params(market, {}, ()), DEVICE)
    ep = tl.params(market.n_pools, DEVICE)
    state = init_market_state(key.to(DEVICE)[None], job, market, 64, mp,
                              market.preemptible, ep)
    state = work_state0((state, init_env_state(ep, 1)), 64)
    k = torch.full((1,), np.float32(5.0), device=DEVICE)
    p = {"r": torch.tensor([2.0], device=DEVICE)}
    _, stats = market_event_windows_ref(
        job, market, kernel, 64, market.preemptible, state, p, mp, k,
        _window_plan(2_500, 1_024, 0), None, ep, K80_WORK,
        K80_WORK.params(DEVICE))
    out = summarize_market(_lane0(stats, None, True, True), None, tl,
                           K80_WORK)
    return {n: float(v) if np.ndim(v) == 0 else v for n, v in out.items()}


def phase_work_main_path(entries: dict[str, dict], offs: dict) -> None:
    """The three main-path fleets at full width with the work state: the
    kernel under ``WorkModel()`` (its base stats bitwise the off run of
    :func:`phase_telemetry_main_path`, in ``offs``) and under the priced
    model (benchmarks/deadline_bench.py), one timed run each, their on/off
    ratios against the off runs; the market again under the priced model
    with the safety net (``CantBeLateKernel``, buffer 0.2 h: its misses at
    most its resumes at every lane, fewer than the base kernel's; buffer
    5.2 h, which covers a resume's drop of slack: no miss at any lane) and
    under the model without restart overhead (work lost = recomputed at
    every lane and window); the survival identities at every lane; each
    entry point under the priced model with the launch count set to 0 just
    before and read just after (one launch), equal to the summary of the
    kernel's own call; the kernel against its plain version with the
    priced model and ``Telemetry()`` on the main-path inputs over
    WORK_CUT_PLAN; then tests/test_work.py's k80 tournament at one lane,
    the kernel against its plain version for the base kernel and the
    safety net: every key equal, no miss under the safety net, and its
    cost below the all-on-demand floor."""
    plan, fleets = work_fleets()
    lanes = R_GRID.size * K_GRID.size * N_SEEDS
    for name, loop, kernel_call, entry_call, owner, summary, queue in fleets:
        entry = entries[loop]
        off, off_ms, _ = offs[name]
        id_ms, (_, id_stats) = cuda_ms(lambda: kernel_call(WorkModel()))
        hold_base(f"{name} identity model", off, id_stats[0],
                  "base, work off vs the identity model")
        ms, (fin, stats) = cuda_ms(lambda: kernel_call(WORK_PRICED))
        checks = work_ledgers(fin, stats, queue)
        b_ms, b_by = tel_bound_ms(loop, lanes, plan, None, work=True)
        entry.update({
            "work_ms": ms, "work_off_ms": off_ms, "work_ratio": ms / off_ms,
            "work_identity_ms": id_ms, "work_identity_ratio": id_ms / off_ms,
            "work_bound_ms": b_ms, "work_bound_by": b_by})
        extra = ""
        if loop == "market":
            net_ms, (fin_n, net) = cuda_ms(
                lambda: kernel_call(WORK_PRICED, WORK_NET_KERNEL))
            checks.update({f"safety net: {k}": v for k, v in
                           work_ledgers(fin_n, net, queue).items()})
            misses = net[1].misses.long().sum(1)
            resumed = net[0].resumed.long().sum(1)
            checks["safety net: misses <= resumes"] = bool(
                (misses <= resumed).all())
            checks["safety net: fewer misses than without"] = int(
                misses.sum()) < int(stats[1].misses.long().sum())
            _, cover = kernel_call(WORK_PRICED, WORK_COVER_KERNEL)
            checks["covering buffer: no miss"] = int(
                cover[1].misses.sum()) == 0
            _, free = kernel_call(WORK_FREE)
            checks["no overhead: lost = recomputed"] = bool(torch.equal(
                free[1].work_lost, free[1].work_recomputed)) and float(
                    free[1].work_lost.double().sum()) > 0
            nb_ms, _ = tel_bound_ms(loop, lanes, plan, None, work=True,
                                    safety=True)
            entry.update({"work_net_ms": net_ms,
                          "work_net_ratio": net_ms / off_ms,
                          "work_net_bound_ms": nb_ms})
            extra = (f"; safety net (buffer 0.2 h) {net_ms:.1f} ms = "
                     f"{net_ms / off_ms:.4f} of off (bound {nb_ms:.1f} ms), "
                     f"{work_counts(net[1])}; buffer 5.2 h: "
                     f"{work_counts(cover[1])}; no overhead: "
                     f"{work_counts(free[1])}")
        print(f"work main-size kernel {name}: {lanes} lanes × {sum(plan)} "
              f"events, off {off_ms:.1f} ms (the telemetry phase's), "
              f"WorkModel() {id_ms:.1f} ms = {id_ms / off_ms:.4f} of off "
              f"(base stats bitwise the off run), priced {ms:.1f} ms = "
              f"{ms / off_ms:.4f} of off (bound with the work state "
              f"{b_ms:.1f} ms, {b_by}: {100 * b_ms / ms:.1f}%), "
              f"{work_counts(stats[1])}{extra}", flush=True)

        owner.launches = 0
        t0 = time.perf_counter()
        out = entry_call(WORK_PRICED)
        wall = time.perf_counter() - t0
        launches = owner.launches
        entry["work_launches"] = entry.get("work_launches", 0) + launches
        if launches != 1:
            raise AssertionError(f"work {name}: the entry point launched the "
                                 f"kernel {launches} times")
        base, ws = stats
        want = summary((type(base)(*(x[:, 1:] for x in base)),
                        type(ws)(*(x[:, 1:] for x in ws))), None, None,
                       WORK_PRICED)
        for field, v in want.items():
            if not np.array_equal(out[field], np.reshape(
                    v, np.shape(out[field]))):
                raise AssertionError(f"work {name}: {field} differs from the "
                                     f"kernel's own call")
        checks["entry point: ontime + misses = finished"] = np.array_equal(
            out["jobs_ontime"] + out["deadline_misses"], out["jobs_finished"])
        for what, ok in checks.items():
            if not ok:
                raise AssertionError(f"work {name}: {what} fails")
        print(f"work main path {name}: entry point {wall:.3f} s wall, kernel "
              f"launches {launches}, equal to the kernel's own call; "
              f"{', '.join(checks)} at every lane", flush=True)

    # WORK_CUT_PLAN: kernel and plain version with the priced model and
    # Telemetry() on the main-path inputs
    _, kernel, params, rmax = MAIN_PATHS[0]
    state0, p, k = main_inputs(kernel, params, rmax)
    margs = market_main_inputs()
    rargs = region_main_inputs()
    slots = BENCH_TOPOLOGY.total_slots
    wk = WORK_PRICED.params(DEVICE)
    for loop, fn, plain, args in (
            ("single", sweep.batched_event_windows, batched_event_windows_ref,
             (JOB, SPOT, kernel, rmax, work_state0(state0, rmax), p, k)),
            ("market", sweep.market_event_windows, market_event_windows_ref,
             (*margs[:5], work_state0(margs[5], 64), *margs[6:])),
            ("region", sweep.region_event_windows, region_event_windows_ref,
             (*rargs[:3], work_state0(rargs[3], slots), *rargs[4:]))):
        call = (*args, WORK_CUT_PLAN, TEL_MAIN, None, WORK_PRICED, wk)
        fn(*call)  # warm-up
        cut_ms, ker = cuda_ms(lambda: fn(*call), 3)
        plain_ms, ref = cuda_ms(lambda: plain(*call))
        hold_all(f"work {loop} cut depth", ref, ker)
        b_ms, _ = tel_bound_ms(loop, lanes, WORK_CUT_PLAN, TEL_MAIN,
                               work=True)
        entries[loop].update(work_cut_ms=cut_ms, work_cut_bound_ms=b_ms,
                             work_plain_ms=plain_ms)
        print(f"work cut depth {loop}: {lanes} lanes, plan {WORK_CUT_PLAN}, "
              f"the priced model and Telemetry(): kernel {cut_ms:.3f} ms "
              f"(bound {b_ms:.4f} ms), plain {plain_ms:.1f} ms; "
              f"{work_counts(ker[1][1])}; every field bitwise", flush=True)

    results = {}
    for label, kern in (("base", K80_KERNEL),
                        ("safety net", CantBeLateKernel(K80_KERNEL,
                                                        slack_buffer=0.2))):
        sweep.market_event_windows.launches = 0
        got = k80_tournament(kern)
        if sweep.market_event_windows.launches != 1:
            raise AssertionError("k80: run_market_sim did not launch the "
                                 "market kernel once")
        ref = k80_tournament(kern, plain=True)
        for field, v in ref.items():
            if not np.array_equal(np.asarray(got[field]), np.asarray(v)):
                raise AssertionError(f"k80 {label}: {field} kernel "
                                     f"{got[field]} vs plain {v}")
        results[label] = got
    base, safe = results["base"], results["safety net"]
    floor = all_ondemand_cost(5.0, 1)
    if not (base["deadline_misses"] > 0 and safe["deadline_misses"] == 0
            and safe["panic_entries"] > 0 and safe["avg_cost"] < floor):
        raise AssertionError(f"k80: base {base['deadline_misses']} misses, "
                             f"safety net {safe['deadline_misses']} misses, "
                             f"{safe['panic_entries']} panics, avg_cost "
                             f"{safe['avg_cost']} (floor {floor})")
    entries["market"].update(k80_base_misses=int(base["deadline_misses"]),
                             k80_net_misses=int(safe["deadline_misses"]),
                             k80_net_panics=int(safe["panic_entries"]),
                             k80_net_avg_cost=safe["avg_cost"])
    print(f"work k80 tournament (one lane, 2,500 events, the committed "
          f"trace): base kernel {int(base['deadline_misses'])} misses of "
          f"{int(base['jobs_finished'])} finished, avg_cost "
          f"{base['avg_cost']:.6g}; safety net "
          f"{int(safe['deadline_misses'])} misses of "
          f"{int(safe['jobs_finished'])}, {int(safe['panic_entries'])} "
          f"panic entries, avg_cost {safe['avg_cost']:.6g} (all-on-demand "
          f"floor {floor}); kernel and plain version equal on every key",
          flush=True)


# ---------------------------------------------------------------------------
# the split stream (rng="split"): the single queue's per-event key ladder,
# walked inside sweep_kernel (a run-time flag of every build)
# ---------------------------------------------------------------------------
#: the split parity phase's plan: a burn-in, two windows and a tail (100
#: events; a window of 37 is a pass of 32 and a short one; the plain
#: version walks the ladder a few hundred launches an event)
SPLIT_PLAN = _window_plan(81, 37, 19)
SPLIT_LANES = 70  # a ragged last warp at every G
#: (name, job, spot, kernel, rmax, params): one case at each (G, slots a
#: thread) pick, then each wait family at rmax 1; a case whose params hold
#: no "wait" samples at the family's constants (a fixed exponential rate is
#: a product with its float32 reciprocal)
SPLIT_CASES = [
    ("rmax1_exp_wait_swept", Exponential(LAM), Exponential(MU),
     SingleSlotKernel(wait=ExponentialWait(0.37)), 1,
     {"wait": {"rate": np.linspace(0.1, 2.5, SPLIT_LANES)}}),
    ("rmax8_bathtub", Exponential(LAM), BathtubGCP(), ThreePhaseKernel(), 8,
     {"r": np.linspace(0.25, 7.0, SPLIT_LANES)}),
    ("rmax16_uniform_job", Uniform(0.3, 24.7), Exponential(MU),
     ThreePhaseKernel(), 16, {"r": np.linspace(1.0, 14.0, SPLIT_LANES)}),
    ("rmax32_deterministic_job", Deterministic(12.0), Uniform(0.0, 48.0),
     ThreePhaseKernel(), 32, {"r": np.linspace(1.0, 30.0, SPLIT_LANES)}),
    ("rmax64", Exponential(LAM), Exponential(MU), ThreePhaseKernel(), 64,
     {"r": np.linspace(1.0, 60.0, SPLIT_LANES)}),
    ("rmax100", Exponential(LAM), Exponential(MU), ThreePhaseKernel(), 100,
     {"r": np.linspace(1.0, 90.0, SPLIT_LANES)}),
    ("rmax256_bathtub", Exponential(LAM), BathtubGCP(), ThreePhaseKernel(),
     256, {"r": np.linspace(1.0, 250.0, SPLIT_LANES)}),
    ("infinite_wait", Exponential(LAM), Uniform(0.3, 48.7),
     SingleSlotKernel(wait=InfiniteWait()), 1, {}),
    ("two_point_wait", Exponential(LAM), Uniform(0.3, 48.7),
     SingleSlotKernel(wait=TwoPointWait(0.3, 20.0)), 1, {}),
    ("exp_wait_fixed", Exponential(LAM), Exponential(MU),
     SingleSlotKernel(wait=ExponentialWait(0.37)), 1, {}),
    ("deterministic_wait_swept", Exponential(LAM), Uniform(0.0, 48.0),
     SingleSlotKernel(wait=DeterministicWait(3.0)), 1,
     {"wait": {"value": np.linspace(0.0, 9.0, SPLIT_LANES)}}),
]
#: the combinations of the three states beside the stream: (telemetry,
#: env?, work?), each on a layout case in turn, the work ones under
#: CantBeLateKernel
SPLIT_AXES = ((TEL_RING, False, False), (None, True, False),
              (None, False, True), (TEL_NARROW, True, False),
              (TEL_RING, False, True), (None, True, True),
              (TEL_NARROW, True, True))
#: a model of each checkpoint mode at the cases' hourly rates: three units
#: a job, priced restarts, a deadline the queues can miss
SPLIT_WORK = [make(total_work=3.0, restart_overhead=0.5, deadline=150.0,
                   od_time=20.0)
              for make in (WorkModel.never,
                           functools.partial(WorkModel.on_notice, 0.05),
                           functools.partial(WorkModel.periodic, 1.0, 0.25))]
#: the depth at which the split main-path fleets are held to, and timed
#: beside, the plain version
SPLIT_CUT_PLAN = (256,)


def split_hashes(job, spot, kernel) -> tuple[int, int, int]:
    """(subkey hashes, bits hashes, keys hashed under) a lane-event of the
    split stream needs: the ladder's next key, a subkey for each process
    and policy that draws (a bathtub splits its own three ways), and one
    bits word for each draw, each under a key of its own."""
    pairs, bits, keys = 1, 0, 1
    for proc in (job, spot):
        if isinstance(proc, Deterministic):
            continue
        n = 3 if isinstance(proc, BathtubGCP) else 1
        pairs += 1 + (n if n > 1 else 0)
        bits, keys = bits + n, keys + n + (n > 1)
    wait = getattr(kernel, "wait", None)
    if isinstance(kernel, ThreePhaseKernel) or isinstance(
            wait, (TwoPointWait, ExponentialWait)):
        pairs, bits, keys = pairs + 1, bits + 1, keys + 1
    return pairs, bits, keys


def split_ops_per_lane_event(rmax: int, pairs: int, bits: int, keys: int
                             ) -> tuple[int, int]:
    """(INT32, FP32) operations of a split-stream lane-event:
    :data:`HASH_INT32` a subkey hash, that and 3 more a bits word (the xor
    that keeps one word, the shift and the or under the exponent) with its
    1 FP32 (the subtract of 1.0), one a key for its parity; the event
    chain as :func:`ops_per_lane_event` counts it."""
    return (HASH_INT32 * (pairs + bits) + 3 * bits + keys + 16 * rmax + 28,
            bits + 11 * rmax + 36)


def split_bytes_moved(lanes: int, rmax: int, n_windows: int) -> int:
    """:func:`bytes_moved` with a lane key read and written once in place
    of the window keys."""
    return bytes_moved(lanes, rmax, 0) + lanes * (n_windows * 10 * 4 + 16)


def phase_split_parity() -> None:
    """The split traversal against its plain version on the card, at cut
    depth (SPLIT_PLAN): each (G, slots a thread) pick, each wait family,
    and each combination of the telemetry, env and work states on the
    layouts in turn (the work ones under CantBeLateKernel): every field
    bitwise, the lane keys it reached included; with telemetry alone the
    base stats bitwise the run without it."""
    picks = {picked_layout(rmax) for rmax in range(1, sweep.MAX_RMAX + 1)}
    driven = set()
    for i, (name, job, spot, kernel, rmax, params) in enumerate(SPLIT_CASES):
        state0, p, k = fleet(job, spot, kernel, rmax, params, SPLIT_LANES,
                             30 + i)
        ends_on_a_short_pass(f"split {name}", SPLIT_PLAN, 32)
        args = (job, spot, kernel, rmax, state0, p, k, SPLIT_PLAN)
        ref = batched_event_windows_ref(*args, rng="split")
        ker = sweep.batched_event_windows(*args, rng="split")
        torch.cuda.synchronize()
        hold_all(f"split {name}", ref, ker)
        if torch.equal(ker[0].key, state0.key):
            raise AssertionError(f"split {name}: the lane keys did not move")
        g, spt = picked_layout(rmax)
        driven.add((g, spt))
        print(f"split parity {name}: rmax {rmax} (G {g}, {spt} slots a "
              f"thread), {SPLIT_LANES} lanes, plan {SPLIT_PLAN}, "
              f"{split_hashes(job, spot, kernel)[:2]} (subkey, bits) hashes "
              f"an event: every field bitwise, the final lane keys included",
              flush=True)
    if driven != picks:
        raise AssertionError(f"split layouts driven {sorted(driven)}, "
                             f"picked {sorted(picks)}")
    for j, (tel, env, work) in enumerate(SPLIT_AXES):
        i = 1 + j % (len(picks) - 1)
        name, job, spot, kernel, rmax, params = SPLIT_CASES[i]
        state0, p, k = fleet(job, spot, kernel, rmax, params, SPLIT_LANES,
                             30 + i)
        off = sweep.batched_event_windows(job, spot, kernel, rmax, state0,
                                          p, k, SPLIT_PLAN, rng="split")
        st, ep, model, wk = state0, None, None, None
        if env:
            keys = threefry.split(threefry.key(30 + i, DEVICE), SPLIT_LANES)
            t_run = 0.9 * float(off[1].time_elapsed.double().sum(1).min())
            st, ep = with_env(state0, env_parity_timeline(1, t_run), 1,
                              lambda ep: init_engine_state(keys, job, spot,
                                                           rmax, ep))
        if work:
            kernel = CantBeLateKernel(kernel, 0.2)
            model = SPLIT_WORK[j % len(SPLIT_WORK)]
            wk = model.params(DEVICE)
            st = work_state0(st, rmax)
        args = (job, spot, kernel, rmax, st, p, k, SPLIT_PLAN, tel, ep, model,
                wk)
        ref = batched_event_windows_ref(*args, rng="split")
        ker = sweep.batched_event_windows(*args, rng="split")
        torch.cuda.synchronize()
        net = f" + work {model.ckpt} + CantBeLateKernel" if work else ""
        what = (f"split {name}{' + telemetry' if tel else ''}"
                f"{' + env' if env else ''}{net}")
        hold_all(what, ref, ker)
        if tel is not None and not env and not work:
            hold_base(what, off[1], ker[1][0])
        print(f"{what}, rmax {rmax}, {SPLIT_LANES} lanes, plan {SPLIT_PLAN}: "
              f"every field bitwise", flush=True)


def phase_split_main_path(split: dict) -> None:
    """The two main-path fleets at full width on the split stream: the
    kernel alone on the slab and the split stream in turns (slab, split,
    split, slab) on the main path's inputs; at SPLIT_CUT_PLAN the kernel
    against its plain version, every field bitwise, both timed; then
    ``run_sweep(rng="split")`` with the launch count set to 0 just before
    and read just after (one launch), its result equal to the summary of
    the kernel's own call and held to Theorems 5 and 1."""
    plan = _window_plan(N_EVENTS, 65_536, BURN_IN)
    lanes = R_GRID.size * K_GRID.size * N_SEEDS
    out = {}
    split["launches"] = 0
    for name, kernel, params, rmax in MAIN_PATHS:
        state0, p, k = main_inputs(kernel, params, rmax)
        times = {"slab": [], "split": []}
        for rng in ("slab", "split", "split", "slab"):
            ms, run = cuda_ms(lambda: sweep.batched_event_windows(
                JOB, SPOT, kernel, rmax, state0, p, k, plan, rng=rng))
            times[rng].append(ms)
            if rng == "split":
                stats = run[1]
        slab_ms, split_ms = (float(np.mean(times[r]))
                             for r in ("slab", "split"))
        pairs, bits, keys = split_hashes(JOB, SPOT, kernel)
        ops = split_ops_per_lane_event(rmax, pairs, bits, keys)
        b_ms, b_by = bound_ms(lanes, plan, ops,
                              split_bytes_moved(lanes, rmax, len(plan)))
        s_ms, _ = bound_ms(lanes, plan, ops_per_lane_event(
            rmax, _engine_layout(JOB, SPOT, kernel).n_cols),
            bytes_moved(lanes, rmax, len(plan)))

        cut = (JOB, SPOT, kernel, rmax, state0, p, k, SPLIT_CUT_PLAN)
        sweep.batched_event_windows(*cut, rng="split")  # warm-up
        cut_ms, ker = cuda_ms(
            lambda: sweep.batched_event_windows(*cut, rng="split"), 3)
        plain_ms, ref = cuda_ms(
            lambda: batched_event_windows_ref(*cut, rng="split"))
        hold_all(f"split {name} cut depth", ref, ker)
        cb_ms, _ = bound_ms(lanes, SPLIT_CUT_PLAN, ops,
                            split_bytes_moved(lanes, rmax, 1))
        err = max_abs(ref[1], ker[1])
        g, spt = picked_layout(rmax)
        split.update({
            f"main_{name}_ms": split_ms, f"main_{name}_slab_ms": slab_ms,
            f"main_{name}_ratio": split_ms / slab_ms,
            f"main_{name}_bound_ms": b_ms, f"main_{name}_bound_by": b_by,
            f"main_{name}_slab_bound_ms": s_ms,
            f"{name}_hashes": [pairs, bits], f"group_{name}": g,
            f"slots_a_thread_{name}": spt})
        if name == "three_phase":
            split.update(ms=cut_ms, plain_ms=plain_ms, bound_ms=cb_ms,
                         bound_by=b_by, max_abs_err=err)
        else:
            split.update({f"{name}_ms": cut_ms, f"{name}_plain_ms": plain_ms,
                          f"{name}_bound_ms": cb_ms})
            split["max_abs_err"] = max(split["max_abs_err"], err)
        print(f"split main-size kernel {name}: {lanes} lanes × {sum(plan)} "
              f"events, rmax {rmax} (G {g}, {spt} slots a thread), {pairs} "
              f"subkey + {bits} bits hashes an event: slab "
              f"{times['slab'][0]:.1f} / {times['slab'][1]:.1f} ms, split "
              f"{times['split'][0]:.1f} / {times['split'][1]:.1f} ms: "
              f"split/slab {split_ms / slab_ms:.4f}; bound {b_ms:.1f} ms "
              f"({b_by}: {100 * b_ms / split_ms:.1f}%; the slab's "
              f"{s_ms:.1f} ms); cut depth {SPLIT_CUT_PLAN}: kernel "
              f"{cut_ms:.3f} ms (bound {cb_ms:.4f} ms), plain "
              f"{plain_ms:.1f} ms, every field bitwise", flush=True)

        sweep.batched_event_windows.launches = 0
        t0 = time.perf_counter()
        res = run_sweep(JOB, SPOT, kernel, params, k=K_GRID[None, :],
                        n_events=N_EVENTS, key=threefry.key(MAIN_SEED),
                        n_seeds=N_SEEDS, rmax=rmax, burn_in=BURN_IN,
                        rng="split")
        wall = time.perf_counter() - t0
        launches = sweep.batched_event_windows.launches
        split["launches"] += launches
        split[f"launches_{name}"] = launches
        split[f"run_sweep_{name}_s"] = wall
        if launches != 1:
            raise AssertionError(f"split main path {name}: run_sweep "
                                 f"launched the kernel {launches} times")
        want = summarize(type(stats)(*(x[:, 1:] for x in stats)))
        for field, v in want.items():
            if not np.array_equal(res[field], np.reshape(
                    v, np.shape(res[field]))):
                raise AssertionError(f"split main path {name}: {field} "
                                     f"differs from the kernel's own call")
        out[name] = res
        print(f"split main path {name}: run_sweep(rng='split') {wall:.3f} "
              f"s wall ({lanes * (N_EVENTS + BURN_IN) / wall:.4g} "
              f"lane-events/s), kernel launches {launches}, equal to the "
              f"kernel's own call", flush=True)
    hold_theory(out["three_phase"], out["single_slot"])


# ---------------------------------------------------------------------------
# the split stream on the market (rng="split"): the 5-way ladder and the
# per-pool spot and hazard clocks, drawn inside market_kernel's split pass
# ---------------------------------------------------------------------------
#: the split market parity phase's plan: a burn-in, two windows and a tail
#: (68 events, a window of 24 a pass of 16 and a short one; the plain
#: version runs a few thousand launches an event); the cases of rmax 100
#: and 256 start with their queues mostly full (:func:`prefilled`), so that
#: their upper slots hold jobs within it

SPLIT_MARKET_PLAN = _window_plan(56, 24, 12)
SPLIT_MARKET_LANES = 70  # a ragged last warp at every G
#: (name, market, kernel, rmax, per-lane params, per-lane pools config?):
#: one case at each (G, slots a thread) pick (rmax 1 to 256), every choice
#: rule (the uniform rule at P 1, 3, 5 and 8), both market kernels, a
#: legacy kernel, single-slot admission with an unswept exponential wait,
#: P from 1 to 8, mixed slot processes, the pools-config axis
SPLIT_MARKET_CASES = [
    ("p1_uniform_notice", spot_market((0.4,), (0.05,), (0.3,)),
     NoticeAwareKernel(0.05, "uniform"), 1, {"r": np.linspace(0.5, 3.0, 4)},
     None),
    ("p1_degenerate_legacy", SpotMarket.single(Exponential(MU)),
     ThreePhaseKernel(), 8, {"r": np.linspace(0.5, 7.0, 4)}, None),
    ("p3_uniform_sums", spot_market((0.4, 0.3, 0.2), SUM_HAZARDS,
                                    (0.5, 0.01, 2.0)),
     NoticeAwareKernel(0.05, "uniform"), 16, {"r": np.linspace(1.0, 14.0, 4)},
     None),
    ("p5_uniform_mixed",
     spot_market((0.9, 0.7, 0.5, 0.3, 0.2), (0.01, 0.0, 0.05, 0.02, 0.1),
                 (1.0, 0.01, 0.5, 0.0, 2.0),
                 [Uniform(0.0, 240.0), BathtubGCP(), Deterministic(150.0),
                  Exponential(MU / 5), Exponential(MU / 3)]),
     NoticeAwareKernel(0.05, "uniform"), 32, {"r": np.linspace(1.0, 30.0, 4)},
     None),
    ("p8_uniform_mixed",
     spot_market((0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2),
                 (0.01, 0.0, 0.02, 0.03, 0.0, 0.05, 0.01, 0.02),
                 (1.0, 0.01, 0.5, 0.5, 2.0, 0.0, 0.02, 3.0),
                 [Exponential(MU / 8), Uniform(0.0, 384.0), BathtubGCP(),
                  Deterministic(150.0), Exponential(MU / 8),
                  Uniform(10.0, 300.0), Exponential(MU / 4),
                  Exponential(MU / 16)]),
     NoticeAwareKernel(0.05, "uniform"), 64, {"r": np.linspace(1.0, 60.0, 4)},
     None),
    ("p4_weighted", BENCH_MARKET,
     PoolChoiceKernel(ThreePhaseKernel(), choice="weighted"), 100,
     {"r": np.linspace(1.0, 90.0, 4), "pool_logits": "per lane"}, None),
    ("p2_least_loaded", spot_market((1.0, 0.4), (0.02, 0.08), (0.0, 0.3)),
     PoolChoiceKernel(ThreePhaseKernel(), choice="least_loaded"), 256,
     {"r": np.linspace(1.0, 250.0, 4)}, None),
    ("p2_exp_wait_fastest", spot_market((1.0, 0.4), (0.0, 0.0), (0.0, 0.3)),
     PoolChoiceKernel(SingleSlotKernel(wait=ExponentialWait(1 / 3)),
                      choice="fastest"), 1, {}, None),
    ("p4_legacy_single_slot", BENCH_MARKET,
     SingleSlotKernel(wait=TwoPointWait(0.3, 20.0)), 1, {}, None),
    ("p4_pools_config", BENCH_MARKET, MARKET_KERNEL, 16,
     {"r": np.linspace(0.5, 6.0, 4)}, "per lane"),
]
#: (telemetry, env?, work?): on the cases above in turn, env under
#: PanicKernel(drain_dead=True), work under CantBeLateKernel
SPLIT_MARKET_AXES = ((TEL_RING, False, False), (None, True, False),
                     (None, False, True), (TEL_NARROW, True, True))
#: the depth at which the split main path is held to, and timed beside,
#: the plain version
SPLIT_MARKET_CUT_PLAN = (64,)


def split_market_hashes(job, market, kernel, preempt_on: bool,
                        every_pool: bool = True) -> tuple[int, int, int]:
    """(subkey hashes, bits hashes, keys hashed under) a market lane-event
    of the split stream takes: the ladder's next key; the job's subkey and
    draw; the spot subkey, a pool's fold (where P > 1) and draw; the policy
    subkey, a market kernel's admission and (uniform, weighted) choice
    keys, the admission draw, the uniform rule's two keys and words or the
    weighted rule's P words; with preemption the preemption subkey, the
    re-admission draw and a pool's fold and draw.  With ``every_pool`` the
    pool terms count every pool, as csrc/sweep.cu's split pass draws them;
    without, one pool's (the least costly), what the function needs: an
    event keeps only the firing pool's spot and hazard clock."""
    def proc(p):  # (subkeys, bits, keys) of one keyed draw
        if isinstance(p, Deterministic):
            return 0, 0, 0
        if isinstance(p, BathtubGCP):
            return 3, 3, 4
        return 0, 1, 1

    base = kernel
    for wrapper in (CantBeLateKernel, PanicKernel):
        base = base.base if isinstance(base, wrapper) else base
    n = market.n_pools
    choice = getattr(base, "choice", None)
    pairs, bits, keys = 1, 0, 1
    pj, bj, kj = proc(job)
    pairs += (pj + 1) if bj else 0
    bits, keys = bits + bj, keys + kj
    pairs, keys = pairs + 1, keys + 1  # the spot subkey
    pools = market.pools if every_pool else (min(
        market.pools, key=lambda pool: sum(proc(pool.arrival))),)
    for pool in pools:
        ps, bs, ks = proc(pool.arrival)
        pairs += ps + (1 if bs and n > 1 else 0)
        bits, keys = bits + bs, keys + ks
    pairs, keys = pairs + 1, keys + 1  # the policy subkey
    if isinstance(base, (NoticeAwareKernel, PoolChoiceKernel)):
        pairs += 1 + (choice in ("uniform", "weighted"))
    inner = base.base if isinstance(base, PoolChoiceKernel) else base
    wait = getattr(inner, "wait", None)
    if not isinstance(inner, SingleSlotKernel) or isinstance(
            wait, (TwoPointWait, ExponentialWait)):
        bits += 1
    if choice == "uniform":
        pairs, bits, keys = pairs + 2, bits + 2, keys + 2
    elif choice == "weighted":
        bits += n
    if preempt_on:
        m = n if every_pool else 1
        pairs, keys = pairs + 1 + m, keys + 1 + m
        bits += m + isinstance(base, NoticeAwareKernel)
    return pairs, bits, keys


def split_market_ops_per_lane_event(rmax: int, n_pools: int, pairs: int,
                                    bits: int, keys: int) -> tuple[int, int]:
    """(INT32, FP32) operations of a market lane-event on the split stream:
    the hashes as :func:`split_ops_per_lane_event` counts them, and the
    event as :func:`market_ops_per_lane_event` counts it without slab
    columns, plus 4 FP32 a pool for the vector of preemption clocks (the
    argmin's compare, the aged clock's subtract, the refresh's select and
    division)."""
    i, f = market_ops_per_lane_event(rmax, 0, n_pools)
    return (i + HASH_INT32 * (pairs + bits) + 3 * bits + keys,
            f + bits + 4 * n_pools)


def split_market_bytes_moved(lanes: int, rmax: int, n_pools: int,
                             n_windows: int) -> int:
    """:func:`market_bytes_moved` with a lane key read and written once in
    place of the window keys, and P preemption clocks in place of one."""
    return (market_bytes_moved(lanes, rmax, n_pools, 0)
            + lanes * (n_windows * 4 * (12 + 3 * n_pools) + 16
                       + 8 * (n_pools - 1)))


def phase_split_market_parity() -> None:
    """The market kernel's split traversal against its plain version on
    the card, at cut depth (SPLIT_MARKET_PLAN): each (G, slots a thread)
    pick, every choice rule (uniform at P 1, 3, 5 and 8), both market
    kernels, a legacy kernel, single-slot admission, mixed slot processes,
    the pools-config axis; then telemetry, the env timeline under
    PanicKernel(drain_dead=True) and the work state under CantBeLateKernel
    on the cases in turn: every field bitwise, the (P,) preemption clocks
    and the lane keys it reached included."""
    picks = {picked_layout(rmax) for rmax in range(1, sweep.MAX_RMAX + 1)}
    driven, rng, lanes = set(), np.random.default_rng(25), SPLIT_MARKET_LANES
    inputs = []
    for i, (name, market, kernel, rmax, params, config) in enumerate(
            SPLIT_MARKET_CASES):
        p, mp = case_inputs(market.params(), params, config, lanes, rng,
                            "spot_scale")
        state0, p, mp, k, pre = market_fleet(market, kernel, rmax, p, lanes,
                                             40 + i, mp, rng="split")
        if rmax >= 100:
            state0 = prefilled(state0, market.n_pools, rng)
        inputs.append((name, market, kernel, rmax, state0, p, mp, k, pre))
        ends_on_a_short_pass(f"split market parity {name}",
                             SPLIT_MARKET_PLAN, 16)
        args = (JOB, market, kernel, rmax, pre, state0, p, mp, k,
                SPLIT_MARKET_PLAN)
        ref = market_event_windows_ref(*args, rng="split")
        ker = sweep.market_event_windows(*args, rng="split")
        torch.cuda.synchronize()
        hold_all(f"split market {name}", ref, ker)
        if torch.equal(ker[0].key, state0.key):
            raise AssertionError(f"split market {name}: the lane keys did "
                                 f"not move")
        g, spt = picked_layout(rmax)
        driven.add((g, spt))
        h = split_market_hashes(JOB, market, kernel, pre)
        top = int(max(state0.qlen.max(), ref[0].qlen.max()))
        if rmax >= 100 and top <= (rmax - 1) // spt * spt:
            raise AssertionError(f"split market {name}: the queue held at "
                                 f"most {top} of {rmax} slots, none of the "
                                 f"last thread's")
        print(f"split market parity {name}: P {market.n_pools}, rmax {rmax} "
              f"(G {g}, {spt} slots a thread), {lanes} lanes, plan "
              f"{SPLIT_MARKET_PLAN}, preemption {'on' if pre else 'off'}, "
              f"{h[0]} subkey + {h[1]} bits hashes an event: every field "
              f"bitwise, the preemption clocks and lane keys included; "
              f"{int(ref[1].pool_preempted.sum())} revocations, "
              f"{int(ref[1].resumed.sum())} resumed, queues up to {top} of "
              f"{rmax} slots", flush=True)
    if driven != picks:
        raise AssertionError(f"split market layouts driven {sorted(driven)},"
                             f" picked {sorted(picks)}")
    for j, (tel, env, work) in enumerate(SPLIT_MARKET_AXES):
        name, market, kernel, rmax, state0, p, mp, k, pre = inputs[
            [0, 2, 9, 3][j]]
        n = market.n_pools
        st, ep, model, wk = state0, None, None, None
        if env:
            kernel = PanicKernel(kernel, drain_dead=True)
            t_run = env_t_run(lambda: sweep.market_event_windows(
                JOB, market, kernel, rmax, pre, state0, p, mp, k,
                SPLIT_MARKET_PLAN, rng="split"))
            keys = threefry.split(threefry.key(40 + [0, 2, 9, 3][j], DEVICE),
                                  lanes)
            st, ep = with_env(state0, env_parity_timeline(n, t_run, True), n,
                              lambda ep: init_market_state(
                                  keys, JOB, market, rmax, mp, pre, ep,
                                  rng="split"))
        if work:
            kernel = CantBeLateKernel(kernel, 0.2)
            model = SPLIT_WORK[j % len(SPLIT_WORK)]
            wk = model.params(DEVICE)
            st = work_state0(st, rmax)
        args = (JOB, market, kernel, rmax, pre, st, p, mp, k,
                SPLIT_MARKET_PLAN, tel, ep, model, wk)
        ref = market_event_windows_ref(*args, rng="split")
        ker = sweep.market_event_windows(*args, rng="split")
        torch.cuda.synchronize()
        net = f" + work {model.ckpt} + CantBeLateKernel" if work else ""
        what = (f"split market {name}{' + telemetry' if tel else ''}"
                f"{' + env + PanicKernel(drain_dead)' if env else ''}{net}")
        hold_all(what, ref, ker)
        print(f"{what}, rmax {rmax}, {lanes} lanes, plan "
              f"{SPLIT_MARKET_PLAN}: every field bitwise", flush=True)


def phase_split_market_degenerate() -> None:
    """The 1-pool zero-hazard market (unit price, a legacy three-phase
    kernel) through the market kernel's split traversal against the
    single-queue kernel's split traversal from the same lane keys at the
    full fleet's width, cut depth: every statistic they share, the final
    queue, clocks and lane keys bitwise."""
    degenerate = SpotMarket.single(SPOT)
    args = market_main_inputs(degenerate, ThreePhaseKernel(), rng="split")
    state0, p = args[5], args[6]
    plan = (64, 1_024)
    fin_m, m = sweep.market_event_windows(*args, plan, rng="split")
    single0 = init_engine_state(state0.key, JOB, SPOT, 64)
    single0 = single0._replace(key=state0.key, next_job=state0.next_job,
                               next_spot=state0.next_spot[:, 0])
    fin_s, s = sweep.batched_event_windows(JOB, SPOT, ThreePhaseKernel(), 64,
                                           single0, p, args[8], plan,
                                           rng="split")
    torch.cuda.synchronize()
    for field in WindowStats._fields:
        if not torch.equal(getattr(m, field), getattr(s, field)):
            raise AssertionError(f"split degenerate market: {field} differs "
                                 f"from the single queue")
    for field in ("key", "next_job", "ages", "budgets", "occ", "order",
                  "next_seq", "qlen"):
        if not torch.equal(getattr(fin_m, field), getattr(fin_s, field)):
            raise AssertionError(f"split degenerate market: final {field} "
                                 f"differs")
    if not torch.equal(fin_m.next_spot[:, 0], fin_s.next_spot):
        raise AssertionError("split degenerate market: final spot clock "
                             "differs")
    print(f"split market degenerate: 1 pool, no hazard, unit price, "
          f"{state0.key.shape[0]} lanes × {sum(plan)} events, rmax 64: the "
          f"market kernel's split traversal equals the single-queue "
          f"kernel's bitwise (every shared statistic, the final queue, "
          f"clocks and lane keys)", flush=True)


def phase_split_market_main_path(entry: dict) -> None:
    """The market main path at full width on the split stream: the kernel
    alone on the slab and the split stream in turns (slab, split, split,
    slab) on the main path's inputs, spot spend held window by window;
    at SPLIT_MARKET_CUT_PLAN the kernel against its plain version, every
    field bitwise, both timed; then ``run_market_sweep(rng="split")`` with
    the launch count set to 0 just before and read just after (one
    launch), equal to the summary of the kernel's own call, completed legs
    = served + on-demand + resumed at every lane and ``avg_cost_job``
    above the preemption-priced LP floor within 5e-3·k."""
    plan = _window_plan(N_EVENTS, 65_536, BURN_IN)
    lanes = R_GRID.size * K_GRID.size * N_SEEDS
    n_pools = BENCH_MARKET.n_pools
    slab_args = market_main_inputs()
    split_args = market_main_inputs(rng="split")
    times = {"slab": [], "split": []}
    for rng in ("slab", "split", "split", "slab"):
        args = split_args if rng == "split" else slab_args
        ms, run = cuda_ms(lambda: sweep.market_event_windows(*args, plan,
                                                            rng=rng))
        times[rng].append(ms)
        if rng == "split":
            stats = run[1]
    slab_ms, split_ms = (float(np.mean(times[r])) for r in ("slab",
                                                            "split"))
    # the function's bound (only the firing pool's spot and hazard draws)
    # and the bound of what the kernel's pass issues (every pool's)
    pairs, bits, keys = split_market_hashes(JOB, BENCH_MARKET,
                                            MARKET_KERNEL, True, False)
    ops = split_market_ops_per_lane_event(64, n_pools, pairs, bits, keys)
    b_ms, b_by = bound_ms(lanes, plan, ops, split_market_bytes_moved(
        lanes, 64, n_pools, len(plan)))
    issued = split_market_hashes(JOB, BENCH_MARKET, MARKET_KERNEL, True)
    ops_issued = split_market_ops_per_lane_event(64, n_pools, *issued)
    bi_ms, _ = bound_ms(lanes, plan, ops_issued, split_market_bytes_moved(
        lanes, 64, n_pools, len(plan)))
    n_cols = _market_layout(JOB, BENCH_MARKET, MARKET_KERNEL, True).n_cols
    s_ms, _ = bound_ms(lanes, plan, market_ops_per_lane_event(
        64, n_cols, n_pools), market_bytes_moved(lanes, 64, n_pools,
                                                 len(plan)))
    # spot spend conservation, window by window (phase_market_main_kernel's)
    price = BENCH_MARKET.prices().astype(np.float32).astype(np.float64)
    legs = (stats.pool_served + stats.pool_preempted).cpu().numpy()
    exact = (legs * price).sum(-1)
    got = stats.spot_cost.cpu().numpy()
    bound = legs.sum(-1) * np.spacing(got) / 2
    if not np.all(np.abs(got - exact) <= bound):
        bad = np.argwhere(np.abs(got - exact) > bound)[0]
        raise AssertionError(f"split market spend conservation: lane/window "
                             f"{bad.tolist()}: {got[tuple(bad)]} against "
                             f"{exact[tuple(bad)]}")

    cut = split_args + (SPLIT_MARKET_CUT_PLAN,)
    sweep.market_event_windows(*cut, rng="split")  # warm-up
    cut_ms, ker = cuda_ms(
        lambda: sweep.market_event_windows(*cut, rng="split"), 3)
    plain_ms, ref = cuda_ms(lambda: market_event_windows_ref(*cut,
                                                             rng="split"))
    hold_all("split market cut depth", ref, ker)
    cut_bytes = split_market_bytes_moved(lanes, 64, n_pools, 1)
    cb_ms, cb_by = bound_ms(lanes, SPLIT_MARKET_CUT_PLAN, ops, cut_bytes)
    cbi_ms, _ = bound_ms(lanes, SPLIT_MARKET_CUT_PLAN, ops_issued, cut_bytes)
    g, spt = picked_layout(64)
    entry.update(
        ms=cut_ms, plain_ms=plain_ms, bound_ms=cb_ms, bound_by=cb_by,
        issued_bound_ms=cbi_ms, max_abs_err=max_abs(ref[1], ker[1]),
        main_ms=split_ms, main_slab_ms=slab_ms,
        main_ratio=split_ms / slab_ms, main_bound_ms=b_ms,
        main_bound_by=b_by, main_issued_bound_ms=bi_ms,
        main_slab_bound_ms=s_ms, hashes=[pairs, bits],
        issued_hashes=list(issued[:2]), group=g, slots_a_thread=spt,
        ptxas=MARKET_PTXAS.get((g, spt)))
    print(f"split market main-size kernel: {lanes} lanes × {sum(plan)} "
          f"events, 4 pools, rmax 64 (G {g}, {spt} slots a thread; ptxas: "
          f"{MARKET_PTXAS.get((g, spt))}), {pairs} subkey + {bits} bits "
          f"hashes an event needed ({issued[0]} + {issued[1]} issued): slab "
          f"{times['slab'][0]:.1f} / {times['slab'][1]:.1f} ms, split "
          f"{times['split'][0]:.1f} / {times['split'][1]:.1f} ms: split/slab"
          f" {split_ms / slab_ms:.4f}; the function's bound {b_ms:.1f} ms "
          f"({b_by}: {100 * b_ms / split_ms:.1f}%), the issued draws' "
          f"{bi_ms:.1f} ms ({100 * bi_ms / split_ms:.1f}%), the slab's "
          f"{s_ms:.1f} ms; spend within its rounding bound at every lane and"
          f" window; cut depth {SPLIT_MARKET_CUT_PLAN}: kernel {cut_ms:.3f} "
          f"ms (bound {cb_ms:.4f} ms, issued {cbi_ms:.4f} ms), plain "
          f"{plain_ms:.1f} ms, every field bitwise", flush=True)

    want = summarize_market(MarketWindowStats(*(x[:, 1:] for x in stats)))
    sweep.market_event_windows.launches = 0
    t0 = time.perf_counter()
    out = run_market_sweep(JOB, BENCH_MARKET, MARKET_KERNEL,
                           {"r": R_GRID[:, None]}, k=K_GRID[None, :],
                           n_events=N_EVENTS, key=threefry.key(MAIN_SEED),
                           n_seeds=N_SEEDS, rmax=64, burn_in=BURN_IN,
                           rng="split")
    wall = time.perf_counter() - t0
    launches = sweep.market_event_windows.launches
    entry["launches"] = launches
    entry["run_market_sweep_s"] = wall
    if launches != 1:
        raise AssertionError(f"split market main path: run_market_sweep "
                             f"launched the kernel {launches} times")
    shape = (R_GRID.size, K_GRID.size, N_SEEDS)
    for name, v in want.items():
        if not np.array_equal(out[name], v.reshape(out[name].shape)):
            raise AssertionError(f"split market main path: {name} differs "
                                 f"from the kernel's own call")
    for name, v in out.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"split market {name}: non-finite")
    if not np.array_equal(out["jobs_completed"], out["spot_served"]
                          + out["ondemand"] + out["resumed"]):
        raise AssertionError("split market: completed != served + ondemand"
                             " + resumed")
    if not (out["preemptions"].sum() > 0 and out["resumed"].sum() > 0):
        raise AssertionError("split market: no preemption or no resume")
    k = np.broadcast_to(K_GRID[None, :, None], shape)
    worst = np.inf
    for idx in np.ndindex(*shape):
        floor = market_knapsack_lp(float(k[idx]), LAM,
                                   float(out["avg_delay_job"][idx]),
                                   BENCH_MARKET,
                                   include_preemption=True)["objective"]
        margin = (out["avg_cost_job"][idx] - floor) / k[idx]
        worst = min(worst, margin)
        if margin < -0.005:
            raise AssertionError(f"split market LP floor: lane {idx}: "
                                 f"avg_cost_job {out['avg_cost_job'][idx]:.5f}"
                                 f" below the floor {floor:.5f}")
    entry["lp_floor_worst_margin_k"] = float(worst)
    print(f"split market main path: run_market_sweep(rng='split') "
          f"{wall:.3f} s wall ({lanes * (N_EVENTS + BURN_IN) / wall:.4g} "
          f"lane-events/s), kernel launches {launches}, equal to the "
          f"kernel's own call; {int(out['preemptions'].sum())} revocations, "
          f"{int(out['resumed'].sum())} resumed; completed legs = served + "
          f"on-demand + resumed at every lane; avg_cost_job above the "
          f"preemption-priced LP floor by at least {worst:.3e}·k (limit "
          f"-5e-3·k)", flush=True)


#: (phase, wall seconds) of this run, in order
PHASE_SECONDS: list[tuple[str, float]] = []


def timed(phase, *args):
    """Run ``phase(*args)``, print its wall seconds on a line of its own."""
    t0 = time.perf_counter()
    out = phase(*args)
    seconds = time.perf_counter() - t0
    PHASE_SECONDS.append((phase.__name__, seconds))
    print(f"phase {phase.__name__}: {seconds:.1f} s", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
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
    timed(phase_build)

    entry = {"name": "sweep_batched_event_windows", "route": "cuda",
             "source": "src/repro_torch/kernels/sweep/csrc/sweep.cu",
             "replaces": "src/repro/kernels/sweep/sweep.py:124",
             "library_ms": None}
    timed(phase_parity)
    timed(phase_layouts)
    timed(phase_width, entry)
    timed(phase_main_kernel, entry)
    timed(phase_main_path, entry)

    flash = {"name": "flash_attention_bh", "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention_tc.cu",
             "simt_source": "src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/"
                         "flash_attention.py:88"}
    decode = {"name": "decode_attention_bh", "route": "cuda",
              "source": "src/repro_torch/kernels/decode_attention/csrc/"
                        "decode_attention.cu",
              "replaces": "src/repro/kernels/decode_attention/"
                          "decode_attention.py:69"}
    timed(phase_attention_parity, flash, decode)
    model = timed(phase_serving, flash, decode)
    flash.update(timed(phase_serving_correctness, model))
    flash.update(timed(phase_profile, model))
    del model
    torch.cuda.empty_cache()
    timed(phase_float32_prefill, flash)
    torch.cuda.empty_cache()
    timed(phase_attention_timings, flash, decode)
    torch.cuda.empty_cache()

    ssd = {"name": "ssd_cuda", "route": "cuda",
           "source": "src/repro_torch/kernels/ssd/csrc/ssd_tc.cu",
           "simt_source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
           "replaces": "src/repro/kernels/ssd/ssd.py:79"}
    timed(phase_ssd_parity, ssd)
    timed(phase_mamba_scoring, ssd)
    timed(phase_mamba_serving, ssd)
    torch.cuda.empty_cache()
    timed(phase_ssd_timings, ssd)

    market = {"name": "sweep_market_event_windows", "route": "cuda",
              "source": "src/repro_torch/kernels/sweep/csrc/sweep.cu",
              "replaces": "src/repro/kernels/sweep/sweep.py:124 (body "
                          "src/repro/core/engine.py:1633 _market_event)",
              "library_ms": None}
    timed(phase_market_parity)
    timed(phase_market_degenerate)
    timed(phase_market_width, market)
    timed(phase_market_main_path, market,
          timed(phase_market_main_kernel, market))

    region = {"name": "sweep_region_event_windows", "route": "cuda",
              "source": "src/repro_torch/kernels/sweep/csrc/sweep.cu",
              "replaces": "src/repro/kernels/sweep/sweep.py:124 (body "
                          "src/repro/core/engine.py:2836 _region_event)",
              "library_ms": None}
    timed(phase_region_parity)
    timed(phase_region_degenerate)
    timed(phase_region_width, region)
    timed(phase_region_main_path, region,
          timed(phase_region_main_kernel, region))

    timed(phase_telemetry_parity)
    main_entries = {"single": entry, "market": market, "region": region}
    offs = timed(phase_telemetry_main_path, main_entries)

    timed(phase_env_parity)
    timed(phase_env_main_path, main_entries, offs)

    timed(phase_work_parity)
    timed(phase_work_main_path, main_entries, offs)

    split = {"name": "sweep_batched_event_windows_split", "route": "cuda",
             "source": "src/repro_torch/kernels/sweep/csrc/sweep.cu",
             "replaces": "src/repro/kernels/sweep/sweep.py:124 (body "
                         "src/repro/core/engine.py:241 _engine_event, "
                         "layout=None: the split stream)",
             "library_ms": None}
    timed(phase_split_parity)
    timed(phase_split_main_path, split)

    split_market = {"name": "sweep_market_event_windows_split",
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/sweep/csrc/sweep.cu",
                    "replaces": "src/repro/kernels/sweep/sweep.py:124 (body "
                                "src/repro/core/engine.py:1633 "
                                "_market_event, layout=None: the split "
                                "stream)",
                    "library_ms": None}
    timed(phase_split_market_parity)
    timed(phase_split_market_degenerate)
    timed(phase_split_market_main_path, split_market)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall, "
          f"{sum(s for _, s in PHASE_SECONDS):.1f} s in its "
          f"{len(PHASE_SECONDS)} phases", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries = [{k: e[k] for k in keys} | {
        k: v for k, v in e.items() if k not in keys}
        for e in (entry, flash, decode, ssd, market, region, split,
                  split_market)]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
