"""The port's P-pool spot market against the JAX package's, on the CPU.

Both sides take the same seed keys, markets and grids; the JAX package runs
``impl="ref", rng="slab"`` (and once its Pallas kernel in interpret mode),
the port its plain PyTorch version (``device="cpu"``).

Tolerance.  Keys, raw bits, pool picks, choices and every integer are
bitwise.  A draw through ``-log1p(-u)`` is within four ulps of JAX's,
because XLA's and PyTorch's ``log1p`` each round within one ulp (see
tests/_torch_parity.py).  Whole runs are held bitwise, floats included,
under ``xla_log1p``: the fixture hands the port XLA's own ``-log1p(-u)``
for every uniform the slab and the key samplers can produce (2^24 and
2^23 values, tabulated once), so any difference left would be the port's
arithmetic.  With each side's own ``log1p``, integers stay bitwise and
floats agree to rtol 1e-5, except ``pi0_time``: its numerator sums the
gaps of the empty periods only, and the clocks' ulps move it in absolute
terms, so it is held to atol 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (RTOL, ulps, xla_log1p,  # noqa: F401
                           xla_log1p_tables)
import repro.core as R
from repro.cluster.orchestrator import OnlineAdmissionController as JControl
from repro.core import clocks as jclocks
from repro.core import engine as jengine
from repro.core import market as jmarket
from repro.core.waittime import DeterministicWait as JDet
import repro_torch.core as T
from repro_torch.cluster.orchestrator import OnlineAdmissionController
from repro_torch.core import clocks, engine, market, threefry
from repro_torch.core.lp import market_knapsack_lp
from repro_torch.core.waittime import DeterministicWait
from repro_torch.kernels.sweep import market_event_windows
from repro_torch.kernels.sweep.sweep import TooManyPoolsError

LAM, MU, K = 1 / 12, 1 / 24, 10.0
LOG1P_ULPS = 4
RNG = np.random.default_rng(1818)
KEYS = RNG.integers(0, 2**32, size=(8, 2), dtype=np.uint64).astype(np.uint32)
#: three hazards whose float32 sum differs left to right and in either
#: other order, so a reordered sum would move the superposed clock and
#: the thinned pick
SUM_HAZARDS = (0.0123457, 0.123456795, 0.00987654)


def words(x):
    return np.asarray(x).astype(np.int64)


def jkeys(raw):
    return jax.random.wrap_key_data(jnp.asarray(raw, jnp.uint32))


def both_markets(prices, hazards, notices, arrival="Exponential", n=None):
    """The same market in both packages: pools of ``arrival(μ/P)``."""
    n = n or len(prices)
    out = []
    for mod, mkt in ((R, jmarket), (T, market)):
        proc = getattr(mod, arrival)
        out.append(mkt.SpotMarket(pools=tuple(
            mkt.SpotPool(proc(MU / n), price=p, hazard=h, notice=w)
            for p, h, w in zip(prices, hazards, notices))))
    return out


HETERO = ((0.5, 0.3, 0.2, 0.1), (0.02, 0.05, 0.0, 0.10),
          (0.5, 0.01, 0.0, 2.0))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs dozens of small operations an event; on one
    thread they do not wait on a pool that other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# fold_in and the keyed clock vectors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag", [0, 1, 3, 7, 12_345, 2**31 - 1, 2**32 - 1])
def test_fold_in_matches_jax(tag):
    ref = jax.vmap(lambda k: jax.random.key_data(
        jax.random.fold_in(jax.random.wrap_key_data(k), tag)))(
            jnp.asarray(KEYS))
    got = threefry.fold_in(torch.from_numpy(words(KEYS)), tag)
    np.testing.assert_array_equal(got.numpy(), words(ref))


CLOCK_PROCS = [("Exponential", (1 / 24,)), ("Uniform", (0.3, 48.7)),
               ("Deterministic", (3.0,))]


@pytest.mark.parametrize("tags", [(0,), (0, 1, 2), (5, 2, 9, 1)])
@pytest.mark.parametrize("name,args", CLOCK_PROCS,
                         ids=[c[0] for c in CLOCK_PROCS])
def test_clock_vectors_match_jax(name, args, tags):
    n = len(tags)
    jprocs = tuple(getattr(R, name)(*args) for _ in tags)
    procs = tuple(getattr(T, name)(*args) for _ in tags)
    scale = RNG.uniform(0.5, 2.0, (len(KEYS), n)).astype(np.float32)
    hazard = RNG.uniform(0.0, 0.2, (len(KEYS), n)).astype(np.float32)
    hazard[::3] = 0.0
    hazard[1, 0] = 0.0
    ref_s = jax.jit(jax.vmap(lambda k, s: jclocks.sample_clock_vector(
        jprocs, tags, jax.random.wrap_key_data(k), s)))(jnp.asarray(KEYS),
                                                        scale)
    ref_h = jax.jit(jax.vmap(lambda k, h: jclocks.sample_hazard_clocks(
        tags, jax.random.wrap_key_data(k), h)))(jnp.asarray(KEYS), hazard)
    k = torch.from_numpy(words(KEYS))
    got_s = clocks.sample_clock_vector(procs, tags, k,
                                       torch.from_numpy(scale))
    got_h = clocks.sample_hazard_clocks(tags, k, torch.from_numpy(hazard))
    if name == "Exponential":
        assert ulps(got_s.numpy(), ref_s) <= LOG1P_ULPS
    else:
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    never = hazard == 0
    np.testing.assert_array_equal(got_h.numpy()[never],
                                  np.asarray(ref_h)[never])
    assert ulps(got_h.numpy()[~never], np.asarray(ref_h)[~never]) \
        <= LOG1P_ULPS


def test_clock_vectors_bitwise_under_xla_log1p(xla_log1p):
    tags = (4, 0, 7)
    jprocs = tuple(R.Exponential(r) for r in (1 / 24, 1 / 48, 0.3))
    procs = tuple(T.Exponential(r) for r in (1 / 24, 1 / 48, 0.3))
    scale = RNG.uniform(0.5, 2.0, (len(KEYS), 3)).astype(np.float32)
    hazard = RNG.uniform(0.0, 0.2, (len(KEYS), 3)).astype(np.float32)
    hazard[::2, 1] = 0.0
    k = torch.from_numpy(words(KEYS))
    ref = jax.jit(jax.vmap(lambda kk, s, h: (
        jclocks.sample_clock_vector(jprocs, tags,
                                    jax.random.wrap_key_data(kk), s),
        jclocks.sample_hazard_clocks(tags, jax.random.wrap_key_data(kk),
                                     h))))(jnp.asarray(KEYS), scale, hazard)
    np.testing.assert_array_equal(
        clocks.sample_clock_vector(procs, tags, k,
                                   torch.from_numpy(scale)).numpy(),
        np.asarray(ref[0]))
    np.testing.assert_array_equal(
        clocks.sample_hazard_clocks(tags, k,
                                    torch.from_numpy(hazard)).numpy(),
        np.asarray(ref[1]))


# ---------------------------------------------------------------------------
# the superposed preemption clock, the thinned pick, the choice rules
# ---------------------------------------------------------------------------
def hazard_rows(n_pools):
    """Random hazards with zeros, a row of zeros, and (for P >= 3) the
    order-sensitive sums."""
    h = RNG.uniform(0.0, 0.3, (60, n_pools)).astype(np.float32)
    h[RNG.random(h.shape) < 0.3] = 0.0
    h[0] = 0.0
    if n_pools >= 3:
        h[1, :3] = SUM_HAZARDS
        h[2, -3:] = SUM_HAZARDS[::-1]
    return h


def boundary_uniforms(h):
    """Per row: random uniforms, and the uniforms nearest each running sum
    over the total (a pick sits on its cumsum boundary)."""
    cum = np.cumsum(h.astype(np.float64), axis=1)
    total = np.maximum(cum[:, -1:], 1e-30)
    edge = (cum / total).astype(np.float32)
    cols = [RNG.random(h.shape[0]).astype(np.float32)]
    for i in range(h.shape[1]):
        for d in (-1, 0, 1):
            cols.append(np.clip(edge[:, i] + d * np.spacing(edge[:, i]), 0,
                                1 - 2**-24).astype(np.float32))
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("n_pools", [1, 2, 3, 4])
def test_superposed_clock_and_pick_match_jax(n_pools):
    h = hazard_rows(n_pools)
    u = boundary_uniforms(h)
    hh = np.repeat(h, u.shape[1], axis=0)
    uu = u.reshape(-1)
    jpick = jax.jit(jax.vmap(jclocks.thinning_pick))(jnp.asarray(hh),
                                                     jnp.asarray(uu))
    jclock = jax.jit(jax.vmap(jclocks.hazard_clock))(jnp.asarray(hh),
                                                     jnp.asarray(uu))
    pick = clocks.thinning_pick(torch.from_numpy(hh), torch.from_numpy(uu))
    clock = clocks.hazard_clock(torch.from_numpy(hh), torch.from_numpy(uu))
    np.testing.assert_array_equal(pick.numpy(), np.asarray(jpick))
    # + 0.0: at u = 0 the two log1p give zeros of opposite signs, a clock
    # that fires at once either way
    jclock = np.asarray(jclock) + np.float32(0.0)
    clock = clock.numpy() + np.float32(0.0)
    never = jclock == np.float32(3e38)
    np.testing.assert_array_equal(clock[never], jclock[never])
    assert ulps(clock[~never], jclock[~never]) <= LOG1P_ULPS
    # the host twins agree with the tensor path on every pick
    for row in range(0, len(hh), 37):
        assert clocks.thinning_pick(hh[row].tolist(), float(uu[row])) \
            == jclocks.thinning_pick(hh[row].tolist(), float(uu[row]))


def test_hazard_sums_run_left_to_right_as_in_jax(xla_log1p):
    """On hazards whose float32 sum depends on the order, the port's total
    is XLA's (left to right), not a pairwise one, so the superposed clock
    is bitwise JAX's."""
    h = np.tile(np.asarray(SUM_HAZARDS, np.float32), (4, 1))
    f = np.float32
    left = f(f(h[0, 0] + h[0, 1]) + h[0, 2])
    assert left != f(h[0, 0] + f(h[0, 1] + h[0, 2]))
    assert left != f(f(h[0, 0] + h[0, 2]) + h[0, 1])
    u = np.array([1_677_722, 2**23, 3 * 2**22, 15_099_494],
                 np.float32) * np.float32(2.0**-24)  # slab uniforms
    jclock = jax.jit(jax.vmap(jclocks.hazard_clock))(jnp.asarray(h),
                                                     jnp.asarray(u))
    assert np.asarray(jax.jit(jax.vmap(jnp.sum))(jnp.asarray(h)))[0] == left
    clock = clocks.hazard_clock(torch.from_numpy(h), torch.from_numpy(u))
    np.testing.assert_array_equal(clock.numpy(), np.asarray(jclock))


def test_gumbel_from_u_matches_jax():
    u = np.concatenate([RNG.random(20_000).astype(np.float32),
                        np.array([0.0, 2**-24, 0.5, 1 - 2**-24],
                                 np.float32)])
    ref = np.asarray(jax.jit(jclocks.gumbel_from_u)(u))
    got = clocks.gumbel_from_u(torch.from_numpy(u)).numpy()
    # two logs, each within an ulp: the outer one's absolute error is the
    # inner one's relative error
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def pool_states(n_pools, lanes):
    price = RNG.uniform(0.05, 1.0, (lanes, n_pools)).astype(np.float32)
    price[:, -1] = price[:, 0]  # a tie on cheapest goes to the first
    rate = RNG.uniform(0.01, 0.1, (lanes, n_pools)).astype(np.float32)
    scale = RNG.uniform(0.5, 2.0, (lanes, n_pools)).astype(np.float32)
    qlen_pool = RNG.integers(0, 3, (lanes, n_pools)).astype(np.int32)
    hazard = RNG.uniform(0.0, 0.2, (lanes, n_pools)).astype(np.float32)
    notice = RNG.uniform(0.0, 1.0, (lanes, n_pools)).astype(np.float32)
    fields = dict(price=price, hazard=hazard, notice=notice,
                  rate=rate / scale, qlen_pool=qlen_pool)
    return (jmarket.PoolState(**{n: jnp.asarray(v)
                                 for n, v in fields.items()}),
            market.PoolState(**{n: torch.from_numpy(v)
                                for n, v in fields.items()}))


@pytest.mark.parametrize("n_pools", [1, 2, 3, 4])
@pytest.mark.parametrize("choice", market.CHOICES)
def test_choose_pool_u_matches_jax(choice, n_pools):
    lanes = 400
    js, ts = pool_states(n_pools, lanes)
    u = RNG.random((lanes, n_pools)).astype(np.float32)
    logits = RNG.normal(0.0, 1.0, (lanes, n_pools)).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda s, lg, uu: jmarket.choose_pool_u(
        choice, s, {"pool_logits": lg}, uu)))(js, jnp.asarray(logits),
                                              jnp.asarray(u))
    got = market.choose_pool_u(choice, ts,
                               {"pool_logits": torch.from_numpy(logits)},
                               torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


KERNEL_PAIRS = [
    ("notice_cheapest", jmarket.NoticeAwareKernel(0.05),
     market.NoticeAwareKernel(0.05)),
    ("notice_weighted", jmarket.NoticeAwareKernel(0.2, "weighted"),
     market.NoticeAwareKernel(0.2, "weighted")),
    ("notice_uniform", jmarket.NoticeAwareKernel(0.05, "uniform"),
     market.NoticeAwareKernel(0.05, "uniform")),
    ("choice_three_phase",
     jmarket.PoolChoiceKernel(R.ThreePhaseKernel(), "least_loaded"),
     market.PoolChoiceKernel(T.ThreePhaseKernel(), "least_loaded")),
    ("choice_single_slot",
     jmarket.PoolChoiceKernel(R.SingleSlotKernel(wait=JDet(3.0)), "uniform"),
     market.PoolChoiceKernel(T.SingleSlotKernel(wait=DeterministicWait(3.0)),
                             "uniform")),
]


@pytest.mark.parametrize("name,jk,tk", KERNEL_PAIRS,
                         ids=[c[0] for c in KERNEL_PAIRS])
def test_market_kernel_hooks_match_jax(name, jk, tk):
    lanes, n_pools = 300, 4
    js, ts = pool_states(n_pools, lanes)
    cols = tk.slab_cols("admit_market", n_pools)
    assert cols == jk.slab_cols("admit_market", n_pools)
    assert tk.slab_cols("on_preempt", n_pools) \
        == jk.slab_cols("on_preempt", n_pools)
    u = RNG.random((lanes, max(cols, 1))).astype(np.float32)
    qlen = RNG.integers(0, 6, lanes).astype(np.int32)
    params = {"r": RNG.uniform(0.0, 5.0, lanes).astype(np.float32),
              "pool_logits": RNG.normal(0, 1, (lanes, n_pools))
              .astype(np.float32),
              "wait": {"value": np.full(lanes, 3.0, np.float32)}}
    if name == "notice_weighted":
        params["ckpt"] = RNG.uniform(0.0, 1.0, lanes).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    ref = jax.jit(jax.vmap(lambda p, q, s, uu: jk.admit_market_u(
        p, q, s, uu)))(jp, jnp.asarray(qlen), js, jnp.asarray(u))
    got = tk.admit_market_u(tp, torch.from_numpy(qlen), ts,
                            torch.from_numpy(u))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(
        np.broadcast_to(np.asarray(got[1], np.float32), (lanes,)),
        np.broadcast_to(np.asarray(ref[1]), (lanes,)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    notice = js.notice[:, 0]
    ref_r = jax.jit(jax.vmap(lambda p, q, w, uu: jk.on_preempt_u(
        p, 0.0, w, q, uu)))(jp, jnp.asarray(qlen), notice, jnp.asarray(u))
    got_r = tk.on_preempt_u(tp, None, ts.notice[:, 0],
                            torch.from_numpy(qlen), torch.from_numpy(u))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))


# ---------------------------------------------------------------------------
# the slab column map
# ---------------------------------------------------------------------------
LAYOUT_PAIRS = KERNEL_PAIRS + [
    (f"notice_{c}", jmarket.NoticeAwareKernel(0.05, c),
     market.NoticeAwareKernel(0.05, c))
    for c in ("fastest", "least_loaded")] + [
    ("choice_fastest",
     jmarket.PoolChoiceKernel(R.ThreePhaseKernel(), "fastest"),
     market.PoolChoiceKernel(T.ThreePhaseKernel(), "fastest")),
    ("choice_weighted_single_slot",
     jmarket.PoolChoiceKernel(R.SingleSlotKernel(), "weighted"),
     market.PoolChoiceKernel(T.SingleSlotKernel(), "weighted")),
    ("legacy_three_phase", R.ThreePhaseKernel(), T.ThreePhaseKernel()),
    ("legacy_single_slot", R.SingleSlotKernel(wait=JDet(3.0)),
     T.SingleSlotKernel(wait=DeterministicWait(3.0)))]


@pytest.mark.parametrize("preempt_on", [False, True])
@pytest.mark.parametrize("name,jk,tk", LAYOUT_PAIRS,
                         ids=[c[0] for c in LAYOUT_PAIRS])
def test_market_layout_matches_jax(name, jk, tk, preempt_on):
    jm, tm = both_markets(*HETERO)
    ref = jengine._market_layout(R.Exponential(LAM), jm, jk, preempt_on)
    got = engine._market_layout(T.Exponential(LAM), tm, tk, preempt_on)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


# ---------------------------------------------------------------------------
# whole runs: run_market_sweep / run_market_sim against the JAX package
# ---------------------------------------------------------------------------
def _sweep_cases():
    hetero = both_markets(*HETERO)
    fast = both_markets((1.0, 0.4), (0.0, 0.08), (0.0, 0.3))
    single = [m.SpotMarket.single(mod.Exponential(MU))
              for m, mod in ((jmarket, R), (market, T))]
    r4 = {"r": np.linspace(0.25, 4.0, 4)}
    grid = np.linspace(0.05, 1.0, 12, dtype=np.float32).reshape(3, 4)
    return [
        # the JAX package's MARKET_CASES (tests/test_sweep_kernel.py)
        ("degenerate_1pool", single, (R.ThreePhaseKernel(),
                                      T.ThreePhaseKernel()),
         {"r": np.linspace(0.25, 4.0, 5)}, {}),
        ("heterogeneous_notice", hetero, (jmarket.NoticeAwareKernel(0.05),
                                          market.NoticeAwareKernel(0.05)),
         r4, {}),
        ("pool_choice_fastest", fast,
         (jmarket.PoolChoiceKernel(R.ThreePhaseKernel(), "fastest"),
          market.PoolChoiceKernel(T.ThreePhaseKernel(), "fastest")),
         {"r": np.linspace(0.5, 3.0, 3)}, {}),
        # the other choice rules
        ("least_loaded", hetero,
         (jmarket.NoticeAwareKernel(0.05, "least_loaded"),
          market.NoticeAwareKernel(0.05, "least_loaded")), r4, {}),
        ("uniform", hetero, (jmarket.NoticeAwareKernel(0.05, "uniform"),
                             market.NoticeAwareKernel(0.05, "uniform")),
         r4, {}),
        ("weighted", hetero,
         (jmarket.PoolChoiceKernel(R.ThreePhaseKernel(), "weighted"),
          market.PoolChoiceKernel(T.ThreePhaseKernel(), "weighted")),
         {"r": np.linspace(0.5, 4.0, 3), "pool_logits": 0.25}, {}),
        # the pools-config axis: prices and hazards of grid_shape + (P,),
        # notices fixed per pool, one scale for every pool
        ("pools_config", hetero, (jmarket.NoticeAwareKernel(0.05),
                                  market.NoticeAwareKernel(0.05)),
         {"r": np.array([[1.0], [2.5], [4.0]])},
         {"prices": grid, "hazards": grid[::-1] * 0.2,
          "notices": np.array([0.5, 0.0, 0.01, 2.0]), "spot_scales": 1.5}),
        # the order-sensitive hazard sums, three pools
        ("three_pool_sums", both_markets((0.4, 0.3, 0.2), SUM_HAZARDS,
                                         (0.5, 0.01, 2.0)),
         (jmarket.NoticeAwareKernel(0.05), market.NoticeAwareKernel(0.05)),
         r4, {}),
    ]


SWEEP_CASES = _sweep_cases()
SWEEP_KW = dict(k=K, n_events=1_200, n_seeds=2, rmax=16, chunk_events=512,
                burn_in=100, rng="slab")


def run_both(markets, kernels, params, overrides, key=0, **kw):
    kw = {**SWEEP_KW, **kw}
    jparams = {n: jnp.asarray(v, jnp.float32) for n, v in params.items()}
    ref = R.run_market_sweep(R.Exponential(LAM), markets[0], kernels[0],
                             jparams, key=jax.random.key(key), impl="ref",
                             **overrides, **kw)
    got = T.run_market_sweep(T.Exponential(LAM), markets[1], kernels[1],
                             params, key=threefry.key(key), device="cpu",
                             **overrides, **kw)
    return ref, got


def assert_bitwise(ref, got, context):
    assert set(got) == set(ref)
    for name, a in ref.items():
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(a),
                                      err_msg=f"{name} ({context})")


@pytest.mark.parametrize("name,markets,kernels,params,overrides",
                         SWEEP_CASES, ids=[c[0] for c in SWEEP_CASES])
def test_run_market_sweep_matches_jax(name, markets, kernels, params,
                                      overrides, xla_log1p):
    ref, got = run_both(markets, kernels, params, overrides)
    assert_bitwise(ref, got, name)


def test_run_market_sweep_with_its_own_log1p():
    """Each side with its own log1p: integers bitwise, floats close."""
    name, markets, kernels, params, overrides = SWEEP_CASES[1]
    ref, got = run_both(markets, kernels, params, overrides)
    assert ref["preemptions"].sum() > 0 and ref["resumed"].sum() > 0
    for field, a in ref.items():
        a, b = np.asarray(a), np.asarray(got[field])
        if field in engine.MARKET_INT_STATS:
            np.testing.assert_array_equal(b, a, err_msg=field)
        elif field == "pi0_time":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6,
                                       err_msg=field)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=0,
                                       err_msg=field)


@pytest.mark.parametrize("which", ["heterogeneous_notice", "weighted"])
def test_run_market_sim_matches_jax(which, xla_log1p):
    markets = both_markets(*HETERO)
    if which == "weighted":
        kernels = (jmarket.PoolChoiceKernel(R.ThreePhaseKernel(), "weighted"),
                   market.PoolChoiceKernel(T.ThreePhaseKernel(), "weighted"))
        params = {"r": 3.0, "pool_logits": np.array([-1.0, 0.5, 2.0, 0.0])}
    else:
        kernels = (jmarket.NoticeAwareKernel(0.05),
                   market.NoticeAwareKernel(0.05))
        params = {"r": 2.5}
    kw = dict(k=K, n_events=1_500, rmax=16, chunk_events=600, burn_in=100,
              rng="slab")
    ref = R.run_market_sim(R.Exponential(LAM), markets[0], kernels[0],
                           jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                                        params),
                           key=jax.random.key(5), impl="ref", **kw)
    got = T.run_market_sim(T.Exponential(LAM), markets[1], kernels[1],
                           params, key=threefry.key(5), device="cpu", **kw)
    assert_bitwise(ref, got, which)
    assert isinstance(got["avg_cost"], float)
    assert got["pool_served"].shape == (4,)


def test_run_market_sweep_matches_jax_pallas_kernel(xla_log1p):
    """One case against the JAX market run through its Pallas kernel in
    interpret mode (as tests/test_event_rng.py runs it)."""
    markets = both_markets(*HETERO)
    kernels = (jmarket.NoticeAwareKernel(0.05),
               market.NoticeAwareKernel(0.05))
    params = {"r": np.array([1.0, 3.0])}
    kw = dict(k=K, n_events=600, n_seeds=2, rmax=8, chunk_events=256,
              rng="slab")
    ref = R.run_market_sweep(R.Exponential(LAM), markets[0], kernels[0],
                             {"r": jnp.asarray(params["r"], jnp.float32)},
                             key=jax.random.key(3), impl="pallas",
                             interpret=True, tile=4, **kw)
    got = T.run_market_sweep(T.Exponential(LAM), markets[1], kernels[1],
                             params, key=threefry.key(3), device="cpu", **kw)
    assert_bitwise(ref, got, "pallas")


# ---------------------------------------------------------------------------
# the port's own claims
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel,params,rmax", [
    (T.ThreePhaseKernel(), {"r": np.linspace(0.25, 4.0, 4)}, 8),
    (T.SingleSlotKernel(wait=DeterministicWait(3.0)), {}, 1)],
    ids=["three_phase", "single_slot"])
def test_degenerate_market_is_the_single_queue(kernel, params, rmax):
    """One pool, unit price, no hazard: bitwise the port's run_sweep (the
    JAX claim of tests/test_event_rng.py, on the port)."""
    kw = dict(k=K, n_events=1_200, key=threefry.key(3), n_seeds=2, rmax=rmax,
              chunk_events=500, rng="slab", device="cpu")
    degenerate = T.SpotMarket.single(T.Exponential(MU))
    assert degenerate.is_degenerate and not degenerate.preemptible
    single = T.run_sweep(T.Exponential(LAM), T.Exponential(MU), kernel,
                         params, **kw)
    mkt = T.run_market_sweep(T.Exponential(LAM), degenerate, kernel, params,
                             **kw)
    for name, v in single.items():
        got = mkt[name]
        got = got[..., 0] if got.ndim > v.ndim else got
        np.testing.assert_array_equal(got, v, err_msg=name)
    assert mkt["preemptions"].sum() == 0 and mkt["resumed"].sum() == 0


def test_preemption_accounting_identities():
    """The JAX package's accounting identities
    (tests/test_core_market.py::test_preemption_accounting_identities)."""
    tm = both_markets(*HETERO)[1]
    kernel = market.NoticeAwareKernel(0.05)
    res = T.run_market_sim(T.Exponential(LAM), tm, kernel,
                           kernel.init_params(3.0), k=K, n_events=4_000,
                           key=threefry.key(0), chunk_events=4_096,
                           device="cpu")
    assert res["preemptions"] > 0 and res["resumed"] > 0
    assert res["jobs_completed"] == (res["spot_served"] + res["ondemand"]
                                     + res["resumed"])
    spend = (tm.prices() * (res["pool_served"]
                            + res["pool_preempted"])).sum()
    np.testing.assert_allclose(res["spot_cost"], spend, rtol=2e-5)
    cost_sum = res["avg_cost"] * res["jobs_completed"]
    np.testing.assert_allclose(cost_sum, spend + K * res["ondemand"],
                               rtol=2e-5)
    final = res["spot_served"] + res["ondemand"]
    np.testing.assert_allclose(res["avg_cost_job"] * final, cost_sum,
                               rtol=1e-9)
    assert res["avg_cost_job"] > res["avg_cost"]
    floor = market_knapsack_lp(K, LAM, res["avg_delay_job"], tm,
                               include_preemption=True)["objective"]
    assert res["avg_cost_job"] > floor - 0.3


#: one preemptible pool: the market the relabelling test permutes
RELABEL_MARKET = both_markets((0.5, 0.3, 0.2, 0.1), (0.0, 0.0, 0.0, 0.1),
                              (0.5, 0.01, 0.0, 2.0))[1]


@functools.cache
def relabelled_run(perm: tuple) -> dict:
    return T.run_market_sim(
        T.Exponential(LAM), RELABEL_MARKET.relabel(list(perm)),
        market.NoticeAwareKernel(0.05), {"r": 3.0}, k=K, n_events=1_500,
        key=threefry.key(11), chunk_events=1_024, device="cpu")


@pytest.mark.parametrize("perm", [(1, 0, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1)])
def test_pool_relabelling_leaves_stats_unchanged(perm):
    """Permuting pools with their tags fixed leaves every statistic equal
    (pool arrays permuted).  On the slab stream this holds where one pool
    carries the hazard: the thinned pick of the firing pool is positional,
    in the JAX package as in the port."""
    res, res_p = relabelled_run((0, 1, 2, 3)), relabelled_run(perm)
    assert res["preemptions"] > 0
    inv = [list(perm).index(i) for i in range(4)]
    for name, v in res.items():
        if name.startswith("pool_"):
            np.testing.assert_array_equal(res_p[name][inv], v, err_msg=name)
        else:
            assert res_p[name] == v, name


def test_unported_options_raise_named_errors():
    tm = both_markets(*HETERO)[1]
    kernel = market.NoticeAwareKernel(0.05)
    job = T.Exponential(LAM)
    kw = dict(n_events=100, key=threefry.key(0), device="cpu")
    # the split stream is ported for the market
    # (tests/test_torch_split_market.py); lane sharding is not
    with pytest.raises(NotImplementedError):
        T.run_market_sweep(job, tm, kernel, {"r": 1.0}, **kw, shard="lanes")
    # telemetry=, env= and work= are ported: a value of another type is
    # refused
    with pytest.raises(TypeError, match="WorkModel"):
        T.run_market_sweep(job, tm, kernel, {"r": 1.0}, **kw, work=object())
    with pytest.raises(TypeError, match="Telemetry"):
        T.run_market_sweep(job, tm, kernel, {"r": 1.0}, **kw,
                           telemetry=object())
    with pytest.raises(TypeError, match="EnvTimeline"):
        T.run_market_sweep(job, tm, kernel, {"r": 1.0}, **kw, env=object())
    with pytest.raises(NotImplementedError, match="Gamma"):
        T.run_market_sweep(T.Gamma(12.0, 1.0), tm, kernel, {"r": 1.0}, **kw)
    with pytest.raises(NotImplementedError, match="Gamma"):
        T.run_market_sim(job, T.SpotMarket.single(T.Gamma(2.0, 12.0)),
                         kernel, {"r": 1.0}, **kw)
    # PanicKernel is ported (env= blacks pools out): without a blackout it
    # runs as its base; its keyed route is the regions' split stream, not
    # ported yet
    np.testing.assert_equal(
        T.run_market_sim(job, tm, T.PanicKernel(kernel), {"r": 1.0}, **kw),
        T.run_market_sim(job, tm, kernel, {"r": 1.0}, **kw))
    with pytest.raises(NotImplementedError, match="split stream"):
        T.PanicKernel(kernel).route({}, None, None, None)
    with pytest.raises(ValueError, match="unknown pool choice"):
        market.NoticeAwareKernel(0.05, "nearest")
    with pytest.raises(ValueError, match="impl='cuda' needs a CUDA"):
        T.run_market_sweep(job, tm, kernel, {"r": 1.0}, impl="cuda", **kw)


def test_no_silent_cpu_run_when_the_card_is_asked_for():
    """device=None means the GPU; the kernel's wrapper refuses CPU tensors
    and markets wider than it holds, and never falls back."""
    tm = both_markets(*HETERO)[1]
    kernel = market.NoticeAwareKernel(0.05)
    job = T.Exponential(LAM)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            T.run_market_sweep(job, tm, kernel, {"r": 1.0}, n_events=10,
                               key=threefry.key(0))
    lanes = 3
    mp = {n: torch.from_numpy(np.tile(v, (lanes, 1)))
          for n, v in tm.params().items()}
    k = torch.full((lanes,), K)
    state = engine.init_market_state(threefry.split(threefry.key(1), lanes),
                                     job, tm, 8, mp, True)
    args = (job, tm, kernel, 8, True, state, {"r": torch.ones(lanes)}, mp, k,
            (50,))
    with pytest.raises(ValueError, match="CUDA tensor"):
        market_event_windows(*args)
    wide = T.SpotMarket(pools=tuple(T.SpotPool(T.Exponential(MU / 9))
                                    for _ in range(9)))
    with pytest.raises(TooManyPoolsError):
        market_event_windows(job, wide, kernel, *args[3:])


# ---------------------------------------------------------------------------
# the host twin of the cheapest rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_choose_pool_host_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    prices = np.round(rng.uniform(0.05, 1.0, n), 1)  # ties on purpose
    jm, tm = both_markets(prices, (0.0,) * n, (0.0,) * n)
    jc, tc = JControl(delta=1.0), OnlineAdmissionController(delta=1.0)
    qlen = list(rng.integers(0, 5, n))
    assert tc.choose_pool(tm, qlen) == jc.choose_pool(jm, qlen)
    for _ in range(20):
        alive = rng.random(n) < 0.6
        if alive.any():
            assert tc.choose_pool(tm, qlen, alive) \
                == jc.choose_pool(jm, qlen, alive)
        else:
            for ctl, mkt in ((jc, jm), (tc, tm)):
                with pytest.raises(RuntimeError, match="no pool alive"):
                    ctl.choose_pool(mkt, qlen, alive)


def test_widest_market_row_fits_the_kernel():
    """The widest slab row the market can ask for (bathtub job and pools,
    the weighted rule over the most pools the kernel holds, preemption and
    re-admission) fits the kernel's MAX_COLS and its 64-word draw pass."""
    from repro_torch.kernels.sweep import sweep
    pools = tuple(T.SpotPool(T.BathtubGCP(), hazard=0.1)
                  for _ in range(sweep.MAX_POOLS))
    wide = T.SpotMarket(pools=pools)
    widths = []
    for kernel in (market.NoticeAwareKernel(0.05, "weighted"),
                   market.PoolChoiceKernel(
                       T.SingleSlotKernel(wait=T.TwoPointWait(0.3, 20.0)),
                       "weighted")):
        layout = engine._market_layout(T.BathtubGCP(), wide, kernel, True)
        widths.append(layout.n_cols)
    assert max(widths) == 18 and max(widths) <= sweep.MAX_COLS <= 64
