"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test of a kernel skips where there is no GPU (the
kernel has no CPU mode); one test, that the layout cases reach every
build of the sweep kernel, runs anywhere. This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch; there, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)

Tolerance of the sweep kernel, all three traversals (the single queue, the
P-pool market and N-region routing): integer statistics and the final join
orders, occupancy, pool tags, queue lengths, counters and keys bitwise;
float32 sums and clocks to rtol 1e-5
(see tests/_torch_parity.py). A Gamma job's first clock is drawn
exponential: the port has no Gamma initial sampler yet; every later draw
is Gamma's.  Each lane-group layout case runs on the G threads a lane
that the wrapper picks at its rmax.  Of the attention kernels: float32 outputs rtol 1e-5 (with a
1e-6 floor near zero), bf16 outputs within one bf16 ulp; the tensor-core
flash route (bf16, P rounded to bf16 before P·V) rtol one bf16 ulp with an
absolute floor of twice the distance between the plain version and its
bf16-P twin on the same inputs (``tc_tolerance``).  Of the SSD
kernels: on the CUDA cores, float32 rtol 1e-4 / atol 5e-5 against the
sequential and the chunked plain versions (sums of N products in another
order), bf16 one ulp; on the tensor cores (bf16, three intermediates
rounded to bf16), rtol one bf16 ulp with an absolute floor of twice the
distance between the plain version and its rounding twin
(``ssd/ref.py::tc_tolerance``).  The sweep kernel with telemetry (the three
traversals' telemetry instantiations): every field bitwise, floats and
trace rings included, and the base statistics bitwise the same kernel's
run without telemetry.  The sweep kernel with the env state (the ENV and
TEL+ENV builds, under the kernels and under PanicKernel): the final state,
the stats and the shock counters bitwise.  The sweep kernel with the work
state (the four WORK builds, each checkpoint mode, with and without the
safety net): the final state, the final work state, the stats and the
survival ledger bitwise.  The sweep kernel's split traversals (the
per-event key ladder of the single queue and of the market, on each (G,
slots a thread) pair, each wait family or choice rule and each
combination of the three states): the final state, the lane keys it
reached and every statistic bitwise.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, attn_tol, cuda_device  # noqa: F401
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import engine, threefry
from repro_torch.core.env import init_env_state
from repro_torch.kernels.decode_attention import (decode_attention_bh,
                                                  decode_attention_bh_ref)
from repro_torch.kernels.decode_attention import \
    decode_attention as decode_mod
from repro_torch.kernels.decode_attention.ref import split_keys
from repro_torch.kernels.flash_attention import (flash_attention_bh,
                                                 flash_attention_bh_ref,
                                                 flash_attention_simt,
                                                 flash_attention_tc,
                                                 tc_tolerance)
from repro_torch.kernels.ssd import (ForwardOnlyError, ssd_chunked, ssd_cuda,
                                     ssd_ref, ssd_simt, ssd_tc, ssd_tc_twin)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import tc_tolerance as ssd_tc_tolerance
from repro_torch.kernels.sweep import (batched_event_windows,
                                       batched_event_windows_ref,
                                       market_event_windows,
                                       market_event_windows_ref,
                                       region_event_windows,
                                       region_event_windows_ref)
from repro_torch.kernels.sweep import sweep as sweep_mod

LAM, MU = 1 / 12, 1 / 24

CASES = [
    ("three_phase", T.Exponential(LAM), T.Exponential(MU),
     T.ThreePhaseKernel(), 8, {"r": np.linspace(0.25, 4.0, 15)}),
    ("three_phase_gamma", T.Gamma(12.0, 1.0), T.Exponential(MU),
     T.ThreePhaseKernel(), 8, {"r": np.linspace(0.0, 3.0, 13)}),
    ("single_slot", T.Exponential(LAM), T.Uniform(0.0, 48.0),
     T.SingleSlotKernel(wait=T.DeterministicWait(3.0)), 1, {}),
    ("single_slot_exp_wait", T.Exponential(LAM), T.Exponential(MU),
     T.SingleSlotKernel(wait=T.ExponentialWait(0.5)), 1, {}),
    ("two_slots_a_thread", T.Exponential(LAM), T.Exponential(MU),
     T.ThreePhaseKernel(), 64, {"r": np.linspace(1.0, 60.0, 13)}),
    ("eight_slots_a_thread", T.Exponential(LAM), T.BathtubGCP(),
     T.ThreePhaseKernel(), 100, {"r": np.linspace(1.0, 90.0, 13)}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,job,spot,kernel,rmax,params", CASES,
                         ids=[c[0] for c in CASES])
def test_cuda_kernel_matches_plain_version(cuda_device, name, job, spot,
                                           kernel, rmax, params):
    lanes = 13  # not a multiple of the kernel's 8 lanes a block
    plan = engine._window_plan(3_000, 1_024, 256)
    init_job = T.Exponential(LAM) if isinstance(job, T.Gamma) else job
    s0 = engine.init_engine_state(
        threefry.split(threefry.key(7, cuda_device), lanes), init_job, spot,
        rmax)
    k = torch.full((lanes,), 10.0, device=cuda_device)
    p = {n: torch.as_tensor(np.resize(np.float32(v), lanes),
                            device=cuda_device) for n, v in params.items()}
    fin_r, ref = batched_event_windows_ref(job, spot, kernel, rmax, s0, p, k,
                                           plan)
    fin_k, ker = batched_event_windows(job, spot, kernel, rmax, s0, p, k,
                                       plan)
    torch.cuda.synchronize()
    assert_close({f: v.cpu().numpy() for f, v in ref._asdict().items()}, ker,
                 engine.INT_STATS, name)
    assert_close({f: v.cpu().numpy() for f, v in fin_r._asdict().items()},
                 fin_k, (), name)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["single", "market"])
def test_cuda_unswept_exponential_wait_is_bitwise(cuda_device, loop):
    """An unswept ExponentialWait at rate 1/3, whose float32 reciprocal is
    inexact, on the slab stream: the kernel multiplies by the reciprocal as
    the plain version does (a kernel that divided would round some budgets
    an ulp apart), so the final state and every statistic are bitwise."""
    lanes, kernel = 13, T.SingleSlotKernel(wait=T.ExponentialWait(1 / 3))
    plan = engine._window_plan(1_000, 512, 128)
    keys = threefry.split(threefry.key(5, cuda_device), lanes)
    k = torch.full((lanes,), 10.0, device=cuda_device)
    if loop == "single":
        job, spot = T.Exponential(LAM), T.Exponential(MU)
        s0 = engine.init_engine_state(keys, job, spot, 1)
        args = (job, spot, kernel, 1, s0, {}, k, plan)
        ref = batched_event_windows_ref(*args)
        ker = batched_event_windows(*args)
    else:
        mp = {f: torch.as_tensor(np.tile(v, (lanes, 1)), device=cuda_device)
              for f, v in _HETERO.params().items()}
        s0 = engine.init_market_state(keys, T.Exponential(LAM), _HETERO, 1,
                                      mp, True)
        args = (T.Exponential(LAM), _HETERO, T.PoolChoiceKernel(kernel), 1,
                True, s0, {}, mp, k, plan)
        ref = market_event_windows_ref(*args)
        ker = market_event_windows(*args)
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, f"{loop} unswept exponential wait 1/3")


@pytest.mark.cuda
def test_cuda_launch_count_and_device_checks(cuda_device):
    job, spot, kernel = T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel()
    s0 = engine.init_engine_state(
        threefry.split(threefry.key(1, cuda_device), 4), job, spot, 8)
    p = {"r": torch.full((4,), 2.5, device=cuda_device)}
    k = torch.full((4,), 10.0, device=cuda_device)
    before = batched_event_windows.launches
    batched_event_windows(job, spot, kernel, 8, s0, p, k, (100,))
    assert batched_event_windows.launches == before + 1
    with pytest.raises(ValueError, match="float32"):
        batched_event_windows(job, spot, kernel, 8, s0, p, k.double(), (100,))


#: the lane-group layouts: (name, job, spot, kernel, rmax, params), on the
#: G the wrapper picks at their rmax; together they reach every (G, slots
#: a thread) pair the library holds
LAYOUTS = [
    ("rmax2", T.Exponential(LAM), T.Exponential(MU),
     T.SingleSlotKernel(wait=T.ExponentialWait(0.5)), 2, {}),
    ("rmax16", T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel(),
     16, {"r": np.linspace(1.0, 14.0, 9)}),
    ("rmax32", T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel(),
     32, {"r": np.linspace(1.0, 30.0, 9)}),
    ("rmax33", T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel(),
     33, {"r": np.linspace(1.0, 30.0, 9)}),
    ("rmax64", T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel(),
     64, {"r": np.linspace(1.0, 60.0, 9)}),
    ("rmax65", T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel(),
     65, {"r": np.linspace(1.0, 60.0, 9)}),
    ("rmax256", T.Exponential(LAM), T.BathtubGCP(), T.ThreePhaseKernel(),
     256, {"r": np.linspace(1.0, 250.0, 9)}),
    ("gamma12", T.Gamma(12.0, 1.0), T.Exponential(MU), T.ThreePhaseKernel(),
     8, {"r": np.linspace(0.0, 3.0, 9)}),
    ("two_point_wait", T.Deterministic(12.0), T.Uniform(0.3, 48.7),
     T.SingleSlotKernel(wait=T.TwoPointWait(0.3, 20.0)), 1, {}),
]


def _picked(rmax: int) -> tuple[int, int]:
    g = sweep_mod.group_size(rmax)
    return g, sweep_mod.slots_per_thread(rmax, g)


def test_sweep_layouts_reach_every_built_pair():
    """The layout cases and the main paths (rmax 64 and 1) drive every
    (G, slots a thread) pair the wrapper can pick over rmax 1..256."""
    picks = {_picked(r) for r in range(1, sweep_mod.MAX_RMAX + 1)}
    driven = {_picked(c[4]) for c in LAYOUTS} | {_picked(64), _picked(1)}
    assert driven == picks


def _layout_run(device, case):
    """45 lanes (no multiple of 32/G for G < 32) through 999-event windows
    (no multiple of a draw pass: 21, 32 or 4 events at 3, 2 or 14 slab
    columns) after a 250-event burn-in."""
    name, job, spot, kernel, rmax, params = case
    lanes, plan = 45, engine._window_plan(2_997, 999, 250)
    init_job = T.Exponential(LAM) if isinstance(job, T.Gamma) else job
    s0 = engine.init_engine_state(
        threefry.split(threefry.key(11, device), lanes), init_job, spot, rmax)
    k = torch.full((lanes,), 10.0, device=device)
    p = {
        n: torch.as_tensor(np.resize(np.float32(v), lanes), device=device)
        for n, v in params.items()}
    args = (job, spot, kernel, rmax, s0, p, k, plan)
    return args, batched_event_windows(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LAYOUTS, ids=[
    f"{c[0]}-G{sweep_mod.group_size(c[4])}" for c in LAYOUTS])
def test_cuda_sweep_layouts_match_plain_version(cuda_device, case):
    """The wrapper's G at rmax 2, 16, 32, 33, 64, 65 and 256, a Gamma(12)
    job (14 slab columns) and a two-point wait: the kernel against the
    plain version."""
    args, (fin_k, ker) = _layout_run(cuda_device, case)
    fin_r, ref = batched_event_windows_ref(*args)
    torch.cuda.synchronize()
    name = f"{case[0]} G {sweep_mod.group_size(case[4])}"
    assert_close({f: v.cpu().numpy() for f, v in ref._asdict().items()}, ker,
                 engine.INT_STATS, name)
    assert_close({f: v.cpu().numpy() for f, v in fin_r._asdict().items()},
                 fin_k, (), name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in LAYOUTS
                                  if c[0] in ("rmax2", "two_point_wait")],
                         ids=lambda c: c[0])
def test_cuda_sweep_budgets_order_as_int32(cuda_device, case):
    """The slot reductions take the budgets' bits as int32: every budget
    the kernel leaves is +0 or more (a wait of exactly 0, a budget spent to
    its deadline) or kInf, and none has its sign bit set."""
    _, (fin, _) = _layout_run(cuda_device, case)
    b = fin.budgets
    assert not bool(torch.signbit(b).any())
    assert bool((b.view(torch.int32) >= 0).all())
    assert bool(((b >= 0) & (b <= 3e38)).all())


#: the market traversal's cases: (name, market, kernel, rmax, params), at
#: P 1, 2, 3, 4 and 8, every choice rule, single-slot admission, slot
#: processes other than Exponential
def _market(prices, hazards, notices, arrivals=None):
    n = len(prices)
    arrivals = arrivals or [T.Exponential(MU / n)] * n
    return T.SpotMarket(pools=tuple(
        T.SpotPool(a, price=p, hazard=h, notice=w)
        for a, p, h, w in zip(arrivals, prices, hazards, notices)))


_HETERO = _market((0.5, 0.3, 0.2, 0.1), (0.02, 0.05, 0.0, 0.10),
                  (0.5, 0.01, 0.0, 2.0))
_NOTICE = T.NoticeAwareKernel(checkpoint_time=0.05)
MARKET_CASES = [
    ("p1_degenerate", T.SpotMarket.single(T.Exponential(MU)),
     T.ThreePhaseKernel(), 16, {"r": np.linspace(0.25, 4.0, 15)}),
    ("p2_fastest", _market((1.0, 0.4), (0.0, 0.08), (0.0, 0.3)),
     T.PoolChoiceKernel(T.ThreePhaseKernel(), "fastest"), 16,
     {"r": np.linspace(0.5, 3.0, 15)}),
    ("p3_order_sensitive_sums",
     _market((0.4, 0.3, 0.2), (0.0123457, 0.123456795, 0.00987654),
             (0.5, 0.01, 2.0)), _NOTICE, 16, {"r": np.linspace(0.5, 6, 15)}),
    ("p4_notice", _HETERO, _NOTICE, 64, {"r": np.linspace(1.0, 60.0, 15)}),
    ("p4_least_loaded", _HETERO, T.NoticeAwareKernel(0.05, "least_loaded"),
     8, {"r": np.linspace(0.5, 7.0, 15)}),
    ("p4_uniform", _HETERO, T.NoticeAwareKernel(0.05, "uniform"), 16,
     {"r": np.linspace(0.5, 7.0, 15)}),
    ("p4_weighted", _HETERO, T.PoolChoiceKernel(T.ThreePhaseKernel(),
                                                "weighted"), 16,
     {"r": np.linspace(0.5, 7.0, 15), "pool_logits": np.linspace(-1, 1, 15)}),
    ("p4_single_slot", _HETERO,
     T.PoolChoiceKernel(T.SingleSlotKernel(wait=T.DeterministicWait(3.0))),
     1, {}),
    ("p8_mixed_slots",
     _market((0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2),
             (0.01, 0.0, 0.02, 0.03, 0.0, 0.05, 0.01, 0.02),
             (1.0, 0.01, 0.5, 0.5, 2.0, 0.0, 0.02, 3.0),
             [T.Exponential(MU / 8), T.Uniform(0.0, 384.0), T.BathtubGCP(),
              T.Deterministic(150.0), T.Exponential(MU / 8),
              T.Uniform(10.0, 300.0), T.Exponential(MU / 4),
              T.Exponential(MU / 16)]),
     T.NoticeAwareKernel(0.05, "least_loaded"), 33,
     {"r": np.linspace(1.0, 30.0, 15)}),
]
#: with the cases' rmax these reach every (G, slots a thread) build
MARKET_LAYOUT_RMAX = (2, 8, 16, 32, 64, 100, 256)


def _market_run(device, market, kernel, rmax, params, lanes=45,
                plan=engine._window_plan(666, 333, 111)):
    """``lanes`` lanes (no multiple of 32/G for G < 32) through ``plan``
    (windows of 333 events after a 111-event burn-in), straight into the
    kernel."""
    n = market.n_pools
    k = torch.full((lanes,), 10.0, device=device)
    mp = {name: torch.as_tensor(np.tile(v, (lanes, 1)), device=device)
          for name, v in market.params().items()}
    p = {
        name: torch.as_tensor(np.resize(np.float32(v), lanes), device=device)
        for name, v in params.items()}
    if "pool_logits" in p:  # one logit a lane, the same for every pool
        p["pool_logits"] = p["pool_logits"][:, None].expand(lanes, n)
    pre = market.preemptible
    s0 = engine.init_market_state(
        threefry.split(threefry.key(11, device), lanes), T.Exponential(LAM),
        market, rmax, mp, pre)
    args = (T.Exponential(LAM), market, kernel, rmax, pre, s0, p, mp, k, plan)
    return args, market_event_windows(*args)


def _assert_market_equal(args, fin_k, ker, name):
    fin_r, ref = market_event_windows_ref(*args)
    torch.cuda.synchronize()
    assert_close({f: v.cpu().numpy() for f, v in ref._asdict().items()}, ker,
                 engine.MARKET_INT_STATS, name)
    assert_close({f: v.cpu().numpy() for f, v in fin_r._asdict().items()},
                 fin_k, (), name)


@pytest.mark.cuda
@pytest.mark.parametrize("name,market,kernel,rmax,params", MARKET_CASES,
                         ids=[c[0] for c in MARKET_CASES])
def test_cuda_market_kernel_matches_plain_version(cuda_device, name, market,
                                                  kernel, rmax, params):
    args, (fin_k, ker) = _market_run(cuda_device, market, kernel, rmax,
                                     params)
    _assert_market_equal(args, fin_k, ker, name)


@pytest.mark.cuda
@pytest.mark.parametrize("rmax", MARKET_LAYOUT_RMAX,
                         ids=lambda r: f"rmax{r}-G{sweep_mod.group_size(r)}")
def test_cuda_market_layouts_match_plain_version(cuda_device, rmax):
    args, (fin_k, ker) = _market_run(cuda_device, _HETERO, _NOTICE, rmax,
                                     {"r": np.linspace(1.0, rmax, 9)})
    _assert_market_equal(args, fin_k, ker, f"rmax {rmax}")


def test_market_layouts_reach_every_built_pair():
    """The market cases and layouts drive every (G, slots a thread) pair
    the wrapper can pick over rmax 1..256 (the market kernel is built for
    the same pairs as the single queue's)."""
    picks = {_picked(r) for r in range(1, sweep_mod.MAX_RMAX + 1)}
    assert {_picked(r) for r in MARKET_LAYOUT_RMAX} == picks
    assert {c[0][:2] for c in MARKET_CASES} == {"p1", "p2", "p3", "p4", "p8"}


@pytest.mark.cuda
def test_cuda_market_degenerate_is_the_single_queue_kernel(cuda_device):
    """One pool, unit price, no hazard: the market kernel equals the
    single-queue kernel on the same lanes, bitwise."""
    market = T.SpotMarket.single(T.Exponential(MU))
    kernel = T.ThreePhaseKernel()
    args, (fin_m, m) = _market_run(cuda_device, market, kernel, 64,
                                   {"r": np.linspace(1.0, 60.0, 9)})
    s0 = args[5]
    single = engine.EngineState(
        key=s0.key, next_job=s0.next_job, next_spot=s0.next_spot[:, 0],
        ages=s0.ages, budgets=s0.budgets, occ=s0.occ, order=s0.order,
        next_seq=s0.next_seq, qlen=s0.qlen)
    fin_s, s = batched_event_windows(args[0], T.Exponential(MU), kernel, 64,
                                     single, args[6], args[8], args[9])
    torch.cuda.synchronize()
    for field in engine.WindowStats._fields:
        assert torch.equal(getattr(m, field), getattr(s, field)), field
    assert torch.equal(fin_m.next_spot[:, 0], fin_s.next_spot)


@pytest.mark.cuda
def test_cuda_market_launch_count_and_checks(cuda_device):
    before = market_event_windows.launches
    args, _ = _market_run(cuda_device, _HETERO, _NOTICE, 16, {"r": [2.0]},
                          lanes=4)
    assert market_event_windows.launches == before + 1
    with pytest.raises(ValueError, match="float32"):
        market_event_windows(*args[:8], args[8].double(), args[9])


#: the region traversal's cases: (name, topology, kernel, params) on the
#: JAX tests' ragged 16/8/4/16 partition (44 slots, G 8)
def _topology(rows):
    return T.RegionTopology(regions=tuple(
        T.Region(T.Exponential(j), T.Exponential(sp), price=c, hazard=h,
                 notice=w, rmax=m) for j, sp, c, h, w, m in rows))


_REGIONS = _topology([(LAM / 4, 1 / 30, 0.5, 0.02, 0.5, 16),
                      (LAM / 2, 1 / 40, 0.3, 0.05, 0.01, 8),
                      (LAM / 8, 1 / 60, 0.2, 0.0, 0.0, 4),
                      (LAM / 8, 1 / 90, 0.1, 0.10, 2.0, 16)])
REGION_CASES = [
    ("ragged_least_loaded", _REGIONS, T.RoutingKernel(_NOTICE,
                                                      "least_loaded"),
     {"r": np.linspace(0.5, 7.0, 15)}),
    ("ragged_weighted", _REGIONS, T.RoutingKernel(T.ThreePhaseKernel(),
                                                  "weighted"),
     {"r": np.linspace(0.5, 7.0, 15),
      "region_logits": np.linspace(-1, 1, 15)}),
    ("ragged_single_slot_uniform", _REGIONS,
     T.RoutingKernel(T.SingleSlotKernel(wait=T.DeterministicWait(3.0)),
                     "uniform"), {}),
]


def _region_run(device, topo, kernel, params, lanes=45,
                plan=engine._window_plan(666, 333, 111)):
    """``lanes`` lanes through ``plan`` (windows of 333 events after a
    111-event burn-in), straight into the region kernel."""
    k = torch.full((lanes,), 10.0, device=device)
    rp = engine._config_tensors({
        name: np.tile(v, (lanes, 1)) for name, v in topo.params().items()},
        device)
    p = {
        name: torch.as_tensor(np.resize(np.float32(v), lanes), device=device)
        for name, v in params.items()}
    pre = topo.preemptible
    s0 = engine.init_region_state(
        threefry.split(threefry.key(11, device), lanes), topo, rp, pre)
    args = (topo, kernel, pre, s0, p, rp, k, plan)
    return args, region_event_windows(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("name,topo,kernel,params", REGION_CASES,
                         ids=[c[0] for c in REGION_CASES])
def test_cuda_region_kernel_matches_plain_version(cuda_device, name, topo,
                                                  kernel, params):
    args, (fin_k, ker) = _region_run(cuda_device, topo, kernel, params)
    fin_r, ref = region_event_windows_ref(*args)
    torch.cuda.synchronize()
    assert_close({f: v.cpu().numpy() for f, v in ref._asdict().items()}, ker,
                 engine.REGION_INT_STATS, name)
    assert_close({f: v.cpu().numpy() for f, v in fin_r._asdict().items()},
                 fin_k, (), name)


@pytest.mark.cuda
def test_cuda_region_degenerate_is_the_one_pool_market_kernel(cuda_device):
    """One region with price, hazard and notice under a notice-aware
    kernel: the region kernel equals the 1-pool market kernel on the same
    lanes, bitwise, ``pool_*`` as ``region_*``."""
    spot = T.Exponential(1 / 40)
    topo = T.RegionTopology.single(T.Exponential(LAM), spot, price=0.4,
                                   hazard=0.05, notice=1.0, rmax=16)
    market = T.SpotMarket.single(spot, price=0.4, hazard=0.05, notice=1.0)
    args, (fin_r, r) = _region_run(cuda_device, topo, _NOTICE,
                                   {"r": np.linspace(0.5, 7.0, 9)})
    s0, lanes = args[3], args[6].shape[0]
    mp = {name: torch.as_tensor(np.tile(v, (lanes, 1)), device=cuda_device)
          for name, v in market.params().items()}
    m0 = engine.MarketState(
        key=s0.key, next_job=s0.next_job[:, 0], next_spot=s0.next_spot,
        next_preempt=s0.next_preempt, ages=s0.ages, budgets=s0.budgets,
        occ=s0.occ, pool=torch.zeros_like(s0.order), order=s0.order,
        next_seq=s0.next_seq, qlen=s0.qlen[:, 0])
    fin_m, m = market_event_windows(T.Exponential(LAM), market, _NOTICE, 16,
                                    True, m0, args[4], mp, args[6], args[7])
    torch.cuda.synchronize()
    assert int(m.pool_preempted.sum()) > 0 and int(m.resumed.sum()) > 0
    for field in engine.MarketWindowStats._fields:
        assert torch.equal(getattr(r, field.replace("pool_", "region_")),
                           getattr(m, field)), field
    assert torch.equal(fin_r.qlen[:, 0], fin_m.qlen)


@pytest.mark.cuda
def test_cuda_region_launch_count_and_checks(cuda_device):
    before = region_event_windows.launches
    args, _ = _region_run(cuda_device, _REGIONS, REGION_CASES[0][2],
                          {"r": [2.0]}, lanes=4)
    assert region_event_windows.launches == before + 1
    with pytest.raises(ValueError, match="float32"):
        region_event_windows(*args[:6], args[6].double(), args[7])


#: telemetry on the three traversals: a ring of 32 records a window, and a
#: narrow sketch whose ring of 8 wraps
TELS = [obs.Telemetry(trace_cap=32),
        obs.Telemetry(n_bins=16, wait_lo=0.1, wait_hi=100.0, trace_cap=8)]


def _assert_tel_equal(ref, ker, off, name):
    """Plain version and kernel with telemetry: both blocks bitwise; the
    kernel's base stats bitwise its run without telemetry (``off``)."""
    torch.cuda.synchronize()
    for a, b, what in ((ref[0], ker[0], "base"), (ref[1], ker[1], "tel"),
                       (off, ker[0], "off vs on")):
        for field in a._fields:
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None and y is None) or torch.equal(x, y), \
                f"{name}: {field} ({what})"


@pytest.mark.cuda
@pytest.mark.parametrize("tel", TELS, ids=["ring32", "narrow"])
@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[0] != "three_phase_gamma"],
                         ids=lambda c: c[0])
def test_cuda_telemetry_single_queue_matches_plain_version(cuda_device,
                                                           case, tel):
    name, job, spot, kernel, rmax, params = case
    lanes, plan = 13, engine._window_plan(2_000, 1_024, 256)
    s0 = engine.init_engine_state(
        threefry.split(threefry.key(7, cuda_device), lanes), job, spot, rmax)
    k = torch.full((lanes,), 10.0, device=cuda_device)
    p = {
        n: torch.as_tensor(np.resize(np.float32(v), lanes),
                           device=cuda_device)
        for n, v in params.items()}
    args = (job, spot, kernel, rmax, s0, p, k, plan)
    _assert_tel_equal(batched_event_windows_ref(*args, tel)[1],
                      batched_event_windows(*args, tel)[1],
                      batched_event_windows(*args)[1], name)


@pytest.mark.cuda
@pytest.mark.parametrize("tel", TELS, ids=["ring32", "narrow"])
@pytest.mark.parametrize("case", [MARKET_CASES[i] for i in (3, 4, 7, 8)],
                         ids=lambda c: c[0])
def test_cuda_telemetry_market_matches_plain_version(cuda_device, case, tel):
    name, market, kernel, rmax, params = case
    args, (_, off) = _market_run(cuda_device, market, kernel, rmax, params)
    _assert_tel_equal(market_event_windows_ref(*args, tel)[1],
                      market_event_windows(*args, tel)[1], off, name)


@pytest.mark.cuda
@pytest.mark.parametrize("tel", TELS, ids=["ring32", "narrow"])
@pytest.mark.parametrize("case", REGION_CASES, ids=lambda c: c[0])
def test_cuda_telemetry_regions_match_plain_version(cuda_device, case, tel):
    name, topo, kernel, params = case
    args, (_, off) = _region_run(cuda_device, topo, kernel, params)
    _assert_tel_equal(region_event_windows_ref(*args, tel)[1],
                      region_event_windows(*args, tel)[1], off, name)


@pytest.mark.cuda
def test_cuda_telemetry_launch_count(cuda_device):
    """A telemetry launch counts on the traversal's counter, once."""
    args, _ = _region_run(cuda_device, _REGIONS, REGION_CASES[0][2],
                          {"r": [2.0]}, lanes=4)
    before = region_event_windows.launches
    _, (base, ts) = region_event_windows(*args, obs.Telemetry())
    torch.cuda.synchronize()
    assert region_event_windows.launches == before + 1
    assert ts.ring_t is None and int(ts.events.sum()) == 4 * sum(args[7])


def _env_timeline(n: int, t_run: float):
    """A storm of every location, a blackout of location 0, a price spike
    of the last, every location dark at once: boundaries inside a run of
    ``t_run`` hours."""
    tl = T.inject_storm(T.EnvTimeline.constant(), 0.05 * t_run,
                        0.20 * t_run, hazard_mult=8.0)
    tl = T.inject_blackout(tl, 0.25 * t_run, 0.40 * t_run, loc=0, n_locs=n)
    tl = T.inject_price_spike(tl, 0.45 * t_run, 0.60 * t_run,
                              price_mult=3.0, loc=n - 1, n_locs=n)
    return T.inject_blackout(tl, 0.65 * t_run, 0.75 * t_run)


def _t_run(stats) -> float:
    """0.9 × the least time a lane of a run without a timeline covers."""
    return 0.9 * float(stats.time_elapsed.double().sum(1).min())


def _assert_tree_equal(ref, ker, name, path=""):
    """Every leaf of two nested (state, stats) results bitwise."""
    if ref is None and ker is None:
        return
    if isinstance(ref, tuple):
        names = getattr(ref, "_fields", None) or range(len(ref))
        for field, a, b in zip(names, ref, ker):
            _assert_tree_equal(a, b, name, f"{path}.{field}")
        return
    assert torch.equal(ref, ker), f"{name}: {path}"


def _panic(kernel, drain=False):
    return T.PanicKernel(kernel, drain_dead=drain)


@pytest.mark.cuda
@pytest.mark.parametrize("tel", [None, TELS[1]], ids=["env", "env_tel"])
@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[0] != "three_phase_gamma"],
                         ids=lambda c: c[0])
def test_cuda_env_single_queue_matches_plain_version(cuda_device, case, tel):
    """The single queue with the env state (the ENV and TEL+ENV builds):
    the final state, the stats and the shock counters bitwise the plain
    version's."""
    name, job, spot, kernel, rmax, params = case
    lanes, plan = 13, engine._window_plan(1_500, 512, 128)
    keys = threefry.split(threefry.key(7, cuda_device), lanes)
    k = torch.full((lanes,), 10.0, device=cuda_device)
    p = {
        n: torch.as_tensor(np.resize(np.float32(v), lanes),
                           device=cuda_device)
        for n, v in params.items()}
    s0 = engine.init_engine_state(keys, job, spot, rmax)
    _, off = batched_event_windows(job, spot, kernel, rmax, s0, p, k, plan)
    ep = _env_timeline(1, _t_run(off)).params(1, cuda_device)
    st = (engine.init_engine_state(keys, job, spot, rmax, ep),
          init_env_state(ep, lanes))
    args = (job, spot, kernel, rmax, st, p, k, plan, tel, ep)
    ref, ker = batched_event_windows_ref(*args), batched_event_windows(*args)
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, name)
    assert int(ker[1][1].boundaries.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tel", [None, TELS[0]], ids=["env", "env_tel"])
@pytest.mark.parametrize("panic", [False, True], ids=["base", "panic"])
@pytest.mark.parametrize("case", [MARKET_CASES[i] for i in (1, 3, 4, 8)],
                         ids=lambda c: c[0])
def test_cuda_env_market_matches_plain_version(cuda_device, case, panic,
                                               tel):
    """The market with the env state, under its kernel and under
    PanicKernel with ``drain_dead``: every field bitwise the plain
    version's."""
    name, market, kernel, rmax, params = case
    kernel = _panic(kernel, drain=True) if panic else kernel
    args, (_, off) = _market_run(cuda_device, market, kernel, rmax, params)
    n = market.n_pools
    ep = _env_timeline(n, _t_run(off)).params(n, cuda_device)
    job, market, kernel, rmax, pre, s0, p, mp, k, plan = args
    st = (engine.init_market_state(
        threefry.split(threefry.key(11, cuda_device), s0.key.shape[0]), job,
        market, rmax, mp, pre, ep), init_env_state(ep, s0.key.shape[0]))
    args = (job, market, kernel, rmax, pre, st, p, mp, k, plan, tel, ep)
    ref, ker = market_event_windows_ref(*args), market_event_windows(*args)
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, name)
    assert int(ker[1][1].boundaries.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tel", [None, TELS[1]], ids=["env", "env_tel"])
@pytest.mark.parametrize("panic", [False, True], ids=["base", "panic"])
@pytest.mark.parametrize("case", REGION_CASES, ids=lambda c: c[0])
def test_cuda_env_regions_match_plain_version(cuda_device, case, panic, tel):
    """The regions with the env state, under their kernel and under
    PanicKernel (its route fails over): every field bitwise the plain
    version's."""
    name, topo, kernel, params = case
    kernel = _panic(kernel) if panic else kernel
    args, (_, off) = _region_run(cuda_device, topo, kernel, params)
    n = topo.n_regions
    ep = _env_timeline(n, _t_run(off)).params(n, cuda_device)
    topo, kernel, pre, s0, p, rp, k, plan = args
    lanes = s0.key.shape[0]
    st = (engine.init_region_state(
        threefry.split(threefry.key(11, cuda_device), lanes), topo, rp, pre,
        ep), init_env_state(ep, lanes))
    args = (topo, kernel, pre, st, p, rp, k, plan, tel, ep)
    ref, ker = region_event_windows_ref(*args), region_event_windows(*args)
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, name)
    assert int(ker[1][1].boundaries.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [False, True],
                         ids=["all_alive", "cheapest_dead"])
def test_cuda_env_launch_count_and_panic_without_a_timeline(cuda_device,
                                                             dead):
    """A PanicKernel run without a timeline launches once.  With every
    pool's rate > 0 it runs the build without the env state and returns
    its base's stats bitwise; with the cheapest pool's rate 0 it runs the
    env build under the constant timeline, bitwise the plain version."""
    args, (_, base) = _market_run(cuda_device, _HETERO, _NOTICE, 16,
                                  {"r": [2.0]}, lanes=4)
    mp = args[7]
    if dead:
        mp = {**mp, "rate": mp["rate"].clone()}
        mp["rate"][:, 3] = 0.0
    args = (*args[:2], _panic(_NOTICE, True), *args[3:7], mp, *args[8:])
    before = market_event_windows.launches
    ker = market_event_windows(*args)
    torch.cuda.synchronize()
    assert market_event_windows.launches == before + 1
    if dead:
        _assert_tree_equal(market_event_windows_ref(*args), ker,
                           "panic without a timeline, a dead pool")
    else:
        _assert_tree_equal(base, ker[1], "panic without a timeline")


#: a work model of each checkpoint mode at the cases' hourly rates: three
#: units a job, priced restarts, a deadline the queues can miss
_WORK = {mode: make(total_work=3.0, restart_overhead=0.5, deadline=150.0,
                    od_time=20.0)
         for mode, make in (("never", T.WorkModel.never),
                            ("notice", lambda **kw: T.WorkModel.on_notice(
                                0.05, **kw)),
                            ("periodic", lambda **kw: T.WorkModel.periodic(
                                1.0, 0.25, **kw)))}
#: the axes beside the work state: (telemetry, env?)
_WORK_AXES = {"work": (None, False), "work_tel": (TELS[0], False),
              "work_env": (None, True), "work_tel_env": (TELS[1], True)}
_WORK_PLAN = engine._window_plan(300, 128, 64)


def _work_args(device, axes, net, i, kernel, n_slots, lanes, off, st, init):
    """(kernel, carry, telemetry, ep, work model, its params) of a work
    case: the checkpoint mode by ``i``, the env timeline (``init``: the
    state under it) scaled into the off run ``off``."""
    tel, env = _WORK_AXES[axes]
    ep = None
    if env:
        n = 1 if off[1] is None else off[1]
        ep = _env_timeline(n, _t_run(off[0])).params(n, device)
        st = (init(ep), init_env_state(ep, lanes))
    work = _WORK[("never", "notice", "periodic")[i % 3]]
    return ((T.CantBeLateKernel(kernel, 0.2) if net else kernel),
            (st, T.init_work_state(n_slots, lanes, device)), tel, ep, work,
            work.params(device))


@pytest.mark.cuda
@pytest.mark.parametrize("net", [False, True], ids=["base", "safety_net"])
@pytest.mark.parametrize("axes", list(_WORK_AXES))
@pytest.mark.parametrize("case", [CASES[0], CASES[4]], ids=lambda c: c[0])
def test_cuda_work_single_queue_matches_plain_version(cuda_device, case,
                                                      axes, net):
    """The single queue with the work state (the four WORK builds): the
    final state and work state, the stats and the ledger bitwise the plain
    version's."""
    name, job, spot, kernel, rmax, params = case
    lanes = 13
    keys = threefry.split(threefry.key(7, cuda_device), lanes)
    k = torch.full((lanes,), 10.0, device=cuda_device)
    p = {
        n: torch.as_tensor(np.resize(np.float32(v), lanes),
                           device=cuda_device)
        for n, v in params.items()}
    s0 = engine.init_engine_state(keys, job, spot, rmax)
    off = batched_event_windows(job, spot, kernel, rmax, s0, p, k,
                                _WORK_PLAN)[1]
    kern, st, tel, ep, work, wk = _work_args(
        cuda_device, axes, net, list(_WORK_AXES).index(axes) + net, kernel,
        rmax, lanes, (off, None), s0,
        lambda ep: engine.init_engine_state(keys, job, spot, rmax, ep))
    args = (job, spot, kern, rmax, st, p, k, _WORK_PLAN, tel, ep, work, wk)
    ref, ker = batched_event_windows_ref(*args), batched_event_windows(*args)
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, name)
    assert int(ker[1][1].finished.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("net", [False, True], ids=["base", "safety_net"])
@pytest.mark.parametrize("axes", list(_WORK_AXES))
@pytest.mark.parametrize("case", [MARKET_CASES[i] for i in (3, 4)],
                         ids=lambda c: c[0])
def test_cuda_work_market_matches_plain_version(cuda_device, case, axes,
                                                net):
    """The market with the work state, under its kernel (PanicKernel with
    ``drain_dead`` under the env timeline) and the safety net: every field
    bitwise the plain version's, the final work state and the ledger
    included."""
    name, market, kernel, rmax, params = case
    if _WORK_AXES[axes][1]:
        kernel = _panic(kernel, drain=True)
    args, (_, off) = _market_run(cuda_device, market, kernel, rmax, params,
                                 plan=_WORK_PLAN)
    job, market, kernel, rmax, pre, s0, p, mp, k, plan = args
    lanes, n = s0.key.shape[0], market.n_pools
    keys = threefry.split(threefry.key(11, cuda_device), lanes)
    kern, st, tel, ep, work, wk = _work_args(
        cuda_device, axes, net, list(_WORK_AXES).index(axes) + net, kernel,
        rmax, lanes, (off, n), s0,
        lambda ep: engine.init_market_state(keys, job, market, rmax, mp, pre,
                                            ep))
    args = (job, market, kern, rmax, pre, st, p, mp, k, plan, tel, ep, work,
            wk)
    ref, ker = market_event_windows_ref(*args), market_event_windows(*args)
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, name)
    assert int(ker[1][1].finished.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("net", [False, True], ids=["base", "safety_net"])
@pytest.mark.parametrize("axes", list(_WORK_AXES))
def test_cuda_work_regions_match_plain_version(cuda_device, axes, net):
    """The regions with the work state, under least_loaded routing
    (PanicKernel's failover under the env timeline) and the safety net:
    every field bitwise the plain version's."""
    name, topo, kernel, params = REGION_CASES[0]
    if _WORK_AXES[axes][1]:
        kernel = _panic(kernel)
    args, (_, off) = _region_run(cuda_device, topo, kernel, params,
                                 plan=_WORK_PLAN)
    topo, kernel, pre, s0, p, rp, k, plan = args
    lanes = s0.key.shape[0]
    keys = threefry.split(threefry.key(11, cuda_device), lanes)
    kern, st, tel, ep, work, wk = _work_args(
        cuda_device, axes, net, list(_WORK_AXES).index(axes) + net, kernel,
        topo.total_slots, lanes, (off, topo.n_regions), s0,
        lambda ep: engine.init_region_state(keys, topo, rp, pre, ep))
    args = (topo, kern, pre, st, p, rp, k, plan, tel, ep, work, wk)
    ref, ker = region_event_windows_ref(*args), region_event_windows(*args)
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, name)
    assert int(ker[1][1].finished.sum()) > 0


@pytest.mark.cuda
def test_cuda_work_none_launches_the_build_without_it(cuda_device,
                                                      monkeypatch):
    """``work=None`` loads the library without the work state (with
    telemetry, the telemetry build), ``work=`` its work twin; the identity
    model there equals the run without it bitwise; a single queue whose
    work life differs from its ages, and a safety net without a model, are
    refused."""
    loaded = []
    load = sweep_mod.load
    monkeypatch.setattr(sweep_mod, "load",
                        lambda lib: loaded.append(lib) or load(lib))
    sweep_mod._library.cache_clear()
    name, job, spot, kernel, rmax, params = CASES[0]
    lanes = 13
    k = torch.full((lanes,), 10.0, device=cuda_device)
    p = {"r": torch.full((lanes,), 2.0, device=cuda_device)}
    s0 = engine.init_engine_state(
        threefry.split(threefry.key(3, cuda_device), lanes), job, spot, rmax)
    ws = T.init_work_state(rmax, lanes, cuda_device)
    identity = T.WorkModel()
    try:
        for tel, off_lib, on_lib in (
                (None, sweep_mod.LIBRARY, sweep_mod.WORK_LIBRARY),
                (TELS[0], sweep_mod.TEL_LIBRARY,
                 sweep_mod.TEL_WORK_LIBRARY)):
            off = batched_event_windows(job, spot, kernel, rmax, s0, p, k,
                                        _WORK_PLAN, tel)
            assert loaded[-1] is off_lib
            on = batched_event_windows(job, spot, kernel, rmax, (s0, ws), p,
                                       k, _WORK_PLAN, tel, None, identity)
            assert loaded[-1] is on_lib
            torch.cuda.synchronize()
            _assert_tree_equal(off, (on[0][0], on[1][0]), f"identity {tel}")
        with pytest.raises(ValueError, match="life"):
            batched_event_windows(job, spot, kernel, rmax,
                                  (s0, ws._replace(life=ws.life + 1.0)), p, k,
                                  _WORK_PLAN, None, None, identity)
        with pytest.raises(ValueError, match="WorkModel"):
            batched_event_windows(job, spot, T.CantBeLateKernel(kernel), rmax,
                                  s0, p, k, _WORK_PLAN)
    finally:
        sweep_mod._library.cache_clear()


#: the split stream's (G, slots a thread) cases: (name, job, spot, kernel,
#: rmax, params), one at each rmax pick; params without "wait" sample at
#: the wait family's constants (a fixed exponential rate is a product with
#: its reciprocal)
SPLIT_CASES = [
    ("rmax1_exp_wait_swept", T.Exponential(LAM), T.Exponential(MU),
     T.SingleSlotKernel(wait=T.ExponentialWait(0.37)), 1,
     {"wait": {"rate": np.linspace(0.1, 2.5, 13)}}),
    ("rmax8_bathtub", T.Exponential(LAM), T.BathtubGCP(),
     T.ThreePhaseKernel(), 8, {"r": np.linspace(0.25, 7.0, 13)}),
    ("rmax16_uniform_job", T.Uniform(0.3, 24.7), T.Exponential(MU),
     T.ThreePhaseKernel(), 16, {"r": np.linspace(1.0, 14.0, 13)}),
    ("rmax32_deterministic_job", T.Deterministic(12.0),
     T.Uniform(0.0, 48.0), T.ThreePhaseKernel(), 32,
     {"r": np.linspace(1.0, 30.0, 13)}),
    ("rmax64", T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel(),
     64, {"r": np.linspace(1.0, 60.0, 13)}),
    ("rmax100", T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel(),
     100, {"r": np.linspace(1.0, 90.0, 13)}),
    ("rmax256_bathtub", T.Exponential(LAM), T.BathtubGCP(),
     T.ThreePhaseKernel(), 256, {"r": np.linspace(1.0, 250.0, 13)}),
]
SPLIT_WAITS = [
    ("infinite", T.InfiniteWait(), {}),
    ("two_point", T.TwoPointWait(0.3, 20.0), {}),
    ("exp_fixed", T.ExponentialWait(0.37), {}),
    ("deterministic_swept", T.DeterministicWait(3.0),
     {"wait": {"value": np.linspace(0.0, 9.0, 13)}}),
]
_SPLIT_PLAN = engine._window_plan(300, 128, 64)


def _split_run(device, case, lanes=13, seed=7):
    """(job, spot, kernel, rmax, initial state, params, k) of a split
    case, the wait params left out where the case sweeps none."""
    name, job, spot, kernel, rmax, params = case
    keys = threefry.split(threefry.key(seed, device), lanes)
    k = torch.full((lanes,), 10.0, device=device)

    def lanewise(p):
        return {n: lanewise(v) if isinstance(v, dict) else
                torch.as_tensor(np.resize(np.float32(v), lanes),
                                device=device) for n, v in p.items()}

    p = lanewise(params)
    return (job, spot, kernel, rmax,
            engine.init_engine_state(keys, job, spot, rmax), p, k)


def test_split_cases_reach_every_build():
    """The split cases drive every (G, slots a thread) pair the library
    holds (runs anywhere)."""
    pairs = {(sweep_mod.group_size(r),
              sweep_mod.slots_per_thread(r, sweep_mod.group_size(r)))
             for r in range(1, sweep_mod.MAX_RMAX + 1)}
    assert {(sweep_mod.group_size(c[4]),
             sweep_mod.slots_per_thread(c[4], sweep_mod.group_size(c[4])))
            for c in SPLIT_CASES} == pairs


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: c[0])
def test_cuda_split_matches_plain_version(cuda_device, case):
    """The split traversal on each (G, slots a thread) pair: the final
    state, the lane keys it reached and every statistic bitwise the plain
    version's."""
    args = (*_split_run(cuda_device, case), _SPLIT_PLAN)
    ref = batched_event_windows_ref(*args, rng="split")
    ker = batched_event_windows(*args, rng="split")
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, case[0])
    assert not torch.equal(ker[0].key, args[4].key)


@pytest.mark.cuda
@pytest.mark.parametrize("wait", SPLIT_WAITS, ids=lambda w: w[0])
def test_cuda_split_single_slot_waits_match_plain_version(cuda_device, wait):
    name, family, params = wait
    case = (name, T.Exponential(LAM), T.Uniform(0.3, 48.7),
            T.SingleSlotKernel(wait=family), 1, params)
    args = (*_split_run(cuda_device, case), _SPLIT_PLAN)
    ref = batched_event_windows_ref(*args, rng="split")
    ker = batched_event_windows(*args, rng="split")
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, name)


#: the split stream's axis combinations: (telemetry, env?, work?)
_SPLIT_AXES = {"tel": (TELS[0], False, False), "env": (None, True, False),
               "work": (None, False, True),
               "tel_env": (TELS[1], True, False),
               "tel_work": (TELS[0], False, True),
               "env_work": (None, True, True),
               "tel_env_work": (TELS[1], True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("axes", list(_SPLIT_AXES))
def test_cuda_split_axes_match_plain_version(cuda_device, axes):
    """The split traversal with each combination of the telemetry fold,
    the env state and the work state (under the safety net), each on a
    layout in turn: every field bitwise the plain version's, and the base
    stats bitwise the run without the axes where they leave them alone
    (telemetry alone)."""
    tel, env, work = _SPLIT_AXES[axes]
    i = list(_SPLIT_AXES).index(axes)
    case = SPLIT_CASES[(i + 1) % len(SPLIT_CASES)]
    job, spot, kernel, rmax, s0, p, k = _split_run(cuda_device, case)
    off = batched_event_windows(job, spot, kernel, rmax, s0, p, k,
                                _SPLIT_PLAN, rng="split")
    st, ep, model, wk = s0, None, None, None
    if env:
        ep = _env_timeline(1, _t_run(off[1])).params(1, cuda_device)
        st = (engine.init_engine_state(s0.key, job, spot, rmax, ep),
              init_env_state(ep, s0.key.shape[0]))
    if work:
        kernel = T.CantBeLateKernel(kernel, 0.2)
        model = _WORK[("never", "notice", "periodic")[i % 3]]
        wk = model.params(cuda_device)
        st = (st, T.init_work_state(rmax, s0.key.shape[0], cuda_device))
    args = (job, spot, kernel, rmax, st, p, k, _SPLIT_PLAN, tel, ep, model,
            wk)
    ref = batched_event_windows_ref(*args, rng="split")
    ker = batched_event_windows(*args, rng="split")
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, axes)
    if not env and not work:
        _assert_tree_equal(off, (ker[0], ker[1][0]), f"{axes}: base")


@pytest.mark.cuda
def test_cuda_split_launch_count_and_refusals(cuda_device):
    """One launch a call; a user's kernel with only the keyed hook, and a
    Gamma process, are refused by name on the card, not run elsewhere."""
    job, spot, kernel, rmax, s0, p, k = _split_run(cuda_device,
                                                   SPLIT_CASES[4], lanes=4)
    before = batched_event_windows.launches
    batched_event_windows(job, spot, kernel, rmax, s0, p, k, (100,),
                          rng="split")
    assert batched_event_windows.launches == before + 1

    class KeyedOnly:
        def admit(self, params, qlen, key):
            return qlen < 3, engine.INF

    with pytest.raises(sweep_mod.NoKernelPolicyError, match="KeyedOnly"):
        batched_event_windows(job, spot, KeyedOnly(), rmax, s0, p, k, (100,),
                              rng="split")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        batched_event_windows(T.Gamma(12.0, 1.0), spot, kernel, rmax, s0, p,
                              k, (100,), rng="split")
    assert batched_event_windows.launches == before + 1


#: the market's split stream: (name, market, kernel, rmax, params), one at
#: each rmax pick, every choice rule (uniform at P 1, 3, 5 and 8), both
#: market kernels, legacy kernels, an unswept exponential wait
SPLIT_MARKET_CASES = [
    ("p1_uniform_notice", _market((0.4,), (0.05,), (0.3,)),
     T.NoticeAwareKernel(0.05, "uniform"), 1,
     {"r": np.linspace(0.5, 3.0, 13)}),
    ("p1_degenerate_legacy", _market((1.0,), (0.0,), (0.0,)),
     T.ThreePhaseKernel(), 8, {"r": np.linspace(0.5, 7.0, 13)}),
    ("p3_uniform", _market((0.4, 0.3, 0.2), (0.01, 0.12, 0.0),
                           (0.5, 0.01, 2.0)),
     T.NoticeAwareKernel(0.05, "uniform"), 16,
     {"r": np.linspace(1.0, 14.0, 13)}),
    ("p5_uniform", _market((0.9, 0.7, 0.5, 0.3, 0.2),
                           (0.01, 0.0, 0.05, 0.02, 0.1),
                           (1.0, 0.01, 0.5, 0.0, 2.0)),
     T.NoticeAwareKernel(0.05, "uniform"), 32,
     {"r": np.linspace(1.0, 30.0, 13)}),
    ("p8_uniform", _market(tuple(np.linspace(0.9, 0.2, 8)),
                           (0.03, 0.0, 0.05, 0.01, 0.0, 0.08, 0.02, 0.04),
                           (0.5,) * 8),
     T.NoticeAwareKernel(0.05, "uniform"), 64,
     {"r": np.linspace(1.0, 60.0, 13)}),
    ("p4_weighted", _HETERO,
     T.PoolChoiceKernel(T.ThreePhaseKernel(), "weighted"), 100,
     {"r": np.linspace(1.0, 90.0, 13), "pool_logits": 0.25}),
    ("p2_least_loaded", _market((1.0, 0.4), (0.02, 0.08), (0.0, 0.3)),
     T.PoolChoiceKernel(T.ThreePhaseKernel(), "least_loaded"), 256,
     {"r": np.linspace(1.0, 250.0, 13)}),
    ("p2_exp_wait_fastest", _market((1.0, 0.4), (0.0, 0.0), (0.0, 0.3)),
     T.PoolChoiceKernel(T.SingleSlotKernel(wait=T.ExponentialWait(1 / 3)),
                        "fastest"), 1, {}),
    ("p4_notice_cheapest", _HETERO, _NOTICE, 16,
     {"r": np.linspace(0.5, 6.0, 13)}),
]
_SPLIT_MARKET_PLAN = engine._window_plan(120, 48, 24)


def test_split_market_cases_reach_every_build():
    """The market's split cases drive every (G, slots a thread) pair the
    library holds (runs anywhere)."""
    pairs = {(sweep_mod.group_size(r),
              sweep_mod.slots_per_thread(r, sweep_mod.group_size(r)))
             for r in range(1, sweep_mod.MAX_RMAX + 1)}
    assert {(sweep_mod.group_size(c[3]),
             sweep_mod.slots_per_thread(c[3], sweep_mod.group_size(c[3])))
            for c in SPLIT_MARKET_CASES} == pairs


def _prefilled(state, n_pools: int, seed: int):
    """``state`` with every lane's first slots holding jobs already
    (between half of rmax and all but two slots; ages up to 48 h, pools
    drawn, joined in slot order), so that a short run reaches the upper
    slots of a large rmax."""
    rng = np.random.default_rng(seed)
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


def _split_market_run(device, case, lanes=13):
    """The market kernel's arguments for a split case, without the plan;
    a case of rmax 100 or more starts with its queues mostly full."""
    name, market, kernel, rmax, params = case
    n = market.n_pools
    k = torch.full((lanes,), 10.0, device=device)
    mp = {f: torch.as_tensor(np.tile(v, (lanes, 1)), device=device)
          for f, v in market.params().items()}
    p = {f: torch.as_tensor(np.resize(np.float32(v), lanes), device=device)
         for f, v in params.items()}
    if "pool_logits" in p:
        p["pool_logits"] = p["pool_logits"][:, None].expand(lanes, n)
    pre = market.preemptible
    s0 = engine.init_market_state(
        threefry.split(threefry.key(9, device), lanes), T.Exponential(LAM),
        market, rmax, mp, pre, rng="split")
    if rmax >= 100:
        s0 = _prefilled(s0, n, rmax)
    return (T.Exponential(LAM), market, kernel, rmax, pre, s0, p, mp, k)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_MARKET_CASES, ids=lambda c: c[0])
def test_cuda_split_market_matches_plain_version(cuda_device, case):
    """The market kernel's split traversal on each (G, slots a thread)
    pair and rule: the final state (the preemption clocks among it), the
    lane keys it reached and every statistic bitwise the plain version's;
    one launch a call."""
    args = (*_split_market_run(cuda_device, case), _SPLIT_MARKET_PLAN)
    ref = market_event_windows_ref(*args, rng="split")
    before = market_event_windows.launches
    ker = market_event_windows(*args, rng="split")
    torch.cuda.synchronize()
    assert market_event_windows.launches == before + 1
    _assert_tree_equal(ref, ker, case[0])
    assert not torch.equal(ker[0].key, args[5].key)


@pytest.mark.cuda
@pytest.mark.parametrize("axes", list(_SPLIT_AXES))
def test_cuda_split_market_axes_match_plain_version(cuda_device, axes):
    """The market's split traversal with each combination of telemetry,
    the env state (under PanicKernel(drain_dead=True)) and the work state
    (under the safety net): every field bitwise the plain version's."""
    tel, env, work = _SPLIT_AXES[axes]
    i = list(_SPLIT_AXES).index(axes)
    job, market, kernel, rmax, pre, s0, p, mp, k = _split_market_run(
        cuda_device, SPLIT_MARKET_CASES[(2, 3, 8)[i % 3]])
    st, ep, model, wk = s0, None, None, None
    if env:
        kernel = T.PanicKernel(kernel, drain_dead=True)
        off = market_event_windows(job, market, kernel, rmax, pre, s0, p, mp,
                                   k, _SPLIT_MARKET_PLAN, rng="split")
        n = market.n_pools
        ep = _env_timeline(n, _t_run(off[1])).params(n, cuda_device)
        st = (engine.init_market_state(
            threefry.split(threefry.key(9, cuda_device), s0.key.shape[0]),
            job, market, rmax, mp, pre, ep, rng="split"),
            init_env_state(ep, s0.key.shape[0]))
    if work:
        kernel = T.CantBeLateKernel(kernel, 0.2)
        model = _WORK[("never", "notice", "periodic")[i % 3]]
        wk = model.params(cuda_device)
        st = (st, T.init_work_state(rmax, s0.key.shape[0], cuda_device))
    args = (job, market, kernel, rmax, pre, st, p, mp, k, _SPLIT_MARKET_PLAN,
            tel, ep, model, wk)
    ref = market_event_windows_ref(*args, rng="split")
    ker = market_event_windows(*args, rng="split")
    torch.cuda.synchronize()
    _assert_tree_equal(ref, ker, f"split market {axes}")


def _normals(device, dtype, seed, *shapes):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in shapes]


def _attn_close(ref, got):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               **attn_tol(got.dtype))


FLASH_CASES = [
    # (BH, g, Sq, Sk, D, causal, bq, bk, q_offset, sk_valid)
    (4, 4, 128, 128, 64, True, 64, 64, 0, None),
    (2, 3, 128, 384, 128, True, 64, 128, 256, None),
    (2, 8, 64, 256, 64, False, 32, 64, 0, None),
    (3, 1, 64, 64, 16, True, 64, 64, 0, None),
    (2, 2, 96, 96, 32, True, 96, 32, 0, None),   # bq not a multiple of 32
    (1, 2, 64, 192, 32, False, 32, 64, 40, 150),  # keys masked past 150
    (1, 2, 64, 192, 32, True, 32, 64, 40, 150),
    (2, 2, 16, 16, 64, True, 128, 128, 0, None),  # one 16-key sub-tile
    (1, 3, 48, 48, 32, True, 128, 128, 0, None),  # sub-tiles of 32 and 16
    (2, 1, 40, 40, 128, False, 128, 128, 0, None),
]
#: tensor-core cases beyond FLASH_CASES: GQA g 4 at D 128 with 40 and 96
#: query rows (no 64-row warpgroup filled), offset and valid keys at D 128,
#: and the serving prefill (B 4 x H 20, S 512)
TC_CASES = [
    (2, 4, 40, 40, 128, True, 128, 128, 0, None),
    (2, 4, 96, 96, 128, True, 128, 128, 0, None),
    (1, 2, 64, 192, 128, True, 32, 64, 40, 150),
    (1, 2, 64, 192, 128, False, 32, 64, 40, 150),
    (80, 1, 512, 512, 128, True, 128, 128, 0, None),
]
#: every FLASH_CASES case on the CUDA cores in both types, as before the
#: tensor-core route; the bf16 cases of D 64 or 128 and TC_CASES on the
#: tensor cores
FLASH_ROUTES = (
    [(c, dt, "simt") for c in FLASH_CASES
     for dt in (torch.float32, torch.bfloat16)]
    + [(c, torch.bfloat16, "tc") for c in FLASH_CASES + TC_CASES
       if c[4] in (64, 128)])


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,route", FLASH_ROUTES)
def test_cuda_flash_kernel_matches_plain_version(cuda_device, case, dtype,
                                                 route):
    BH, g, Sq, Sk, D, causal, bq, bk, off, valid = case
    q, k, v = _normals(cuda_device, dtype, 3, (BH, g, Sq, D), (BH, Sk, D),
                       (BH, Sk, D))
    counts = (flash_attention_bh, flash_attention_tc, flash_attention_simt)
    before = [f.launches for f in counts]
    kw = dict(causal=causal, q_offset=off, sk_valid=valid)
    got = flash_attention_bh(q, k, v, block_q=bq, block_k=bk, route=route,
                             **kw)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counts, before)] == [
        1, int(route == "tc"), int(route == "simt")]
    plain = flash_attention_bh_ref(q, k, v, **kw)
    if route == "simt":
        _attn_close(plain, got)
        return
    tol, _ = tc_tolerance(plain, flash_attention_bh_ref(
        q, k, v, p_dtype=torch.bfloat16, **kw))
    assert got.dtype == plain.dtype and got.shape == plain.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               plain.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 32, "simt"), (torch.float32, 128, "simt")])
def test_cuda_flash_default_route(cuda_device, dtype, head_dim, route):
    q, k, v = _normals(cuda_device, dtype, 5, (2, 2, 64, head_dim),
                       (2, 64, head_dim), (2, 64, head_dim))
    launch = flash_attention_tc if route == "tc" else flash_attention_simt
    before = launch.launches
    flash_attention_bh(q, k, v)
    torch.cuda.synchronize()
    assert launch.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len", [0, 1, 77, 256, 320])
def test_cuda_decode_kernel_matches_plain_version(cuda_device, dtype, kv_len):
    """kv_len 0 (zeros), inside a tile, at a tile's end and full."""
    BH, g, S, D = 6, 4, 320, 64
    q, k, v = _normals(cuda_device, dtype, 4, (BH, g, D), (BH, S, D),
                       (BH, S, D))
    got = decode_attention_bh(q, k, v, kv_len, block_k=64)
    torch.cuda.synchronize()
    _attn_close(decode_attention_bh_ref(q, k, v, kv_len), got)
    if kv_len == 0:
        assert not got.float().abs().max()


def _split_edges(s: int, n_split: int) -> list[int]:
    kps = split_keys(s, n_split)
    fills = {0, 1, s}
    for j in range(n_split):
        if j * kps < s:
            fills |= {j * kps, min(s, (j + 1) * kps) - 1}
    return sorted(fills)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,g,D,n_split", [(6, 4, 128, 64), (320, 4, 64, 13),
                                            (2_048, 1, 32, 2)])
def test_cuda_decode_split_edges(cuda_device, dtype, BH, g, D, n_split):
    """S 8,192 split over the cache, at three B·KH whose split counts
    differ: kv_len 0 (zeros), 1, S and every split's first and last key,
    against the unsplit plain version."""
    S = 8_192
    q, k, v = _normals(cuda_device, dtype, 8, (BH, g, D), (BH, S, D),
                       (BH, S, D))
    ns = decode_mod.split_count(S, BH)
    assert ns == n_split
    before = decode_attention_bh.launches
    fills = _split_edges(S, ns)
    for kv_len in fills:
        got = decode_attention_bh(q, k, v, kv_len)
        torch.cuda.synchronize()
        _attn_close(decode_attention_bh_ref(q, k, v, kv_len), got)
        if kv_len == 0:
            assert not got.float().abs().max()
    assert decode_attention_bh.launches == before + len(fills)


@pytest.mark.cuda
def test_cuda_attention_kernels_check_their_inputs(cuda_device):
    q = torch.zeros(2, 1, 100, 32, device=cuda_device)
    k = torch.zeros(2, 128, 32, device=cuda_device)
    with pytest.raises(ValueError, match="must tile"):
        flash_attention_bh(q, k, k, block_q=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_bh(q.cpu(), k.cpu(), k.cpu(), block_q=100)
    with pytest.raises(ValueError, match="g <= 8"):
        decode_attention_bh(torch.zeros(2, 9, 32, device=cuda_device), k, k,
                            5, block_k=64)
    with pytest.raises(ValueError, match="16-byte"):
        kk = torch.zeros(2 * 128 * 32 + 1, device=cuda_device)[1:]
        kk = kk.view(2, 128, 32)
        decode_attention_bh(torch.zeros(2, 4, 32, device=cuda_device), kk,
                            kk, 5, block_k=64)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------
SSD_CASES = [
    # (B, L, H, P, N, Q): tests/test_kernels.py's SSD_CASES, then a chunk
    # that is not a multiple of the kernel's 64-row tiles and a single
    # short chunk
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 32, 64, 32),
    (2, 256, 4, 64, 32, 64),
    (1, 64, 8, 16, 128, 64),
    (1, 192, 3, 64, 128, 96),
    (2, 16, 2, 8, 8, 16),
]
#: float32 rtol 1e-4 / atol 5e-5, bf16 one ulp (see tests/test_torch_ssd.py)
SSD_TOL = {torch.float32: dict(rtol=1e-4, atol=5e-5),
           torch.bfloat16: dict(rtol=2.0**-7, atol=1e-6)}


def _ssd_inputs(device, dtype, seed, B, L, H, P, N, a_log=None, d_skip=None):
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = (normal(B, L, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(normal(B, L, H))
    b_in, c_in = ((normal(B, L, N) * 0.3).to(dtype) for _ in range(2))
    a_log = (torch.log(torch.arange(1, H + 1, device=device).float())
             if a_log is None else a_log)
    d_skip = torch.ones(H, device=device) if d_skip is None else d_skip
    return x, dt, a_log, d_skip, b_in, c_in


#: every case on the CUDA cores in both types, as before the tensor-core
#: route; every bf16 case the tensor cores take (P, N, Q multiples of 16)
#: on the tensor cores too
SSD_ROUTES = ([(c, dt, "simt") for c in SSD_CASES
               for dt in (torch.float32, torch.bfloat16)]
              + [(c, torch.bfloat16, "tc") for c in SSD_CASES
                 if all(d % 16 == 0 for d in c[3:])])


def _hold_ssd_tc(args, chunk, got):
    """A tensor-core output against the sequential plain version by the
    floor rule: its rounding twin at this chunk sets the floor, and so
    does the float32 chunked scan's distance from the recurrence."""
    f32 = [a.float() for a in args]
    floor = float((ssd_chunked(*f32, chunk=chunk) - ssd_ref(*f32)).abs().max())
    plain = ssd_ref(*args)
    tol, _ = ssd_tc_tolerance(plain, ssd_tc_twin(*args, chunk=chunk), floor)
    assert got.dtype == plain.dtype and got.shape == plain.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               plain.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,route", SSD_ROUTES)
def test_cuda_ssd_kernel_matches_plain_version(cuda_device, case, dtype,
                                               route):
    B, L, H, P, N, Q = case
    args = _ssd_inputs(cuda_device, dtype, 3, B, L, H, P, N)
    counts = (ssd_cuda, ssd_tc, ssd_simt)
    before = [f.launches for f in counts]
    got = ssd_cuda(*args, chunk=Q, route=route)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counts, before)] == [
        1, int(route == "tc"), int(route == "simt")]
    assert got.dtype == dtype and got.shape == (B, L, H, P)
    if route == "tc":
        _hold_ssd_tc(args, Q, got)
        return
    for ref in (ssd_ref(*args), ssd_chunked(*args, chunk=Q)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   **SSD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,P,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 8, "simt"),
    (torch.float32, 64, "simt")])
def test_cuda_ssd_default_route(cuda_device, dtype, P, route):
    """ops.ssd (the model's entry) takes the tensor cores for bf16 with P,
    N and Q multiples of 16, the CUDA cores for float32 and the rest."""
    args = _ssd_inputs(cuda_device, dtype, 5, 2, 64, 2, P, 16)
    launch = ssd_tc if route == "tc" else ssd_simt
    before = launch.launches
    ssd_ops.ssd(*args, chunk=32)
    torch.cuda.synchronize()
    assert launch.launches == before + 1


@pytest.mark.cuda
def test_cuda_ssd_state_continuity_across_chunks(cuda_device):
    H = 2
    args = _ssd_inputs(cuda_device, torch.float32, 9, 1, 128, H, 16, 16,
                       a_log=torch.zeros(H, device=cuda_device),
                       d_skip=torch.zeros(H, device=cuda_device))
    small = ssd_cuda(*args, chunk=16)
    big = ssd_cuda(*args, chunk=128)
    np.testing.assert_allclose(small.cpu().numpy(), big.cpu().numpy(),
                               **SSD_TOL[torch.float32])


@pytest.mark.cuda
def test_cuda_ssd_tc_state_continuity_across_chunks(cuda_device):
    """bf16 on the tensor cores at chunk 16 and 128 (A = -1, D = 0): each
    held by the floor rule to the sequential plain version, which has no
    chunks."""
    H = 2
    args = _ssd_inputs(cuda_device, torch.bfloat16, 9, 1, 128, H, 16, 16,
                       a_log=torch.zeros(H, device=cuda_device),
                       d_skip=torch.zeros(H, device=cuda_device))
    before = ssd_tc.launches
    for chunk in (16, 128):
        _hold_ssd_tc(args, chunk, ssd_cuda(*args, chunk=chunk, route="tc"))
    assert ssd_tc.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tc", "simt"])
def test_cuda_ssd_kernel_reads_bc_column_slices(cuda_device, route):
    """B and C as mamba_block hands them over, column slices of one [B, C]
    tensor, give the output of contiguous copies bitwise; a layout the
    kernel cannot read raises."""
    args = _ssd_inputs(cuda_device, torch.bfloat16, 4, 2, 128, 4, 32, 64)
    bc = torch.cat(args[4:], dim=-1)
    sliced = ssd_cuda(*args[:4], bc[..., :64], bc[..., 64:], chunk=64,
                      route=route)
    torch.testing.assert_close(sliced, ssd_cuda(*args, chunk=64, route=route),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="strides"):
        ssd_cuda(*args[:4], args[4].transpose(0, 1).contiguous()
                 .transpose(0, 1), args[5], chunk=64, route=route)


@pytest.mark.cuda
def test_cuda_ssd_kernel_checks_its_inputs(cuda_device):
    args = _ssd_inputs(cuda_device, torch.float32, 1, 1, 48, 2, 8, 8)
    with pytest.raises(ValueError, match="must tile by chunk=32"):
        ssd_cuda(*args, chunk=32)
    with pytest.raises(ValueError, match="float32"):
        ssd_cuda(args[0], args[1].double(), *args[2:], chunk=16)
    with pytest.raises(ValueError, match="P <= 64"):
        ssd_cuda(*_ssd_inputs(cuda_device, torch.float32, 1, 1, 16, 1, 128,
                              8), chunk=16)
    x = args[0].clone().requires_grad_(True)
    with pytest.raises(ForwardOnlyError):
        ssd_ops.ssd(x, *args[1:], chunk=16)
    with pytest.raises(ValueError, match="tensor-core route takes bf16"):
        ssd_cuda(*args, chunk=16, route="tc")
    bf = _ssd_inputs(cuda_device, torch.bfloat16, 1, 1, 32, 2, 16, 16)
    x = torch.empty(bf[0].numel() + 1, dtype=torch.bfloat16,
                    device=cuda_device)[1:].view_as(bf[0]).copy_(bf[0])
    with pytest.raises(ValueError, match="16-byte"):
        ssd_cuda(x, *bf[1:], chunk=16, route="tc")
