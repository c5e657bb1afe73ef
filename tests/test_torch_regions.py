"""The port's N-region routing against the JAX package's, on the CPU.

Both sides take the same seed keys, topologies and grids, built from one
description; the JAX package runs ``impl="ref", rng="slab"`` (and once its
Pallas kernel in interpret mode), the port its plain PyTorch version
(``device="cpu"``).

Tolerance, as in tests/test_torch_market.py.  Keys, raw bits, routes,
picks and every integer are bitwise.  Whole runs are held bitwise, floats
included, under ``xla_log1p`` (the port handed XLA's own ``-log1p(-u)``;
tests/_torch_parity.py), so any difference left would be the port's
arithmetic.  With each side's own ``log1p``, integers stay bitwise and
floats agree to rtol 1e-5, except ``pi0_time``, held to atol 1e-6 (its
numerator sums the gaps of the empty periods only).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (RTOL, xla_log1p,  # noqa: F401
                           xla_log1p_tables)
import repro.core as R
from repro.cluster.orchestrator import OnlineAdmissionController as JControl
from repro.core import engine as jengine
from repro.core import regions as jregions
import repro_torch.core as T
from repro_torch.cluster.orchestrator import OnlineAdmissionController
from repro_torch.core import engine, regions, threefry
from repro_torch.core.waittime import DeterministicWait
from repro_torch.kernels.sweep import region_event_windows
from repro_torch.kernels.sweep.sweep import MAX_COLS, TooManyRegionsError

LAM, MU, K = 1 / 12, 1 / 24, 10.0
RNG = np.random.default_rng(1919)

#: tests/test_core_regions.py::_hetero_topology: (job rate, spot rate,
#: price, hazard, notice, rmax) a region
HETERO = ((LAM / 4, 1 / 30, 0.5, 0.02, 0.5, 16),
          (LAM / 2, 1 / 40, 0.3, 0.05, 0.01, 8),
          (LAM / 8, 1 / 60, 0.2, 0.0, 0.0, 4),
          (LAM / 8, 1 / 90, 0.1, 0.10, 2.0, 16))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs dozens of small operations an event; on one
    thread they do not wait on a pool that other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both_topologies(rows=HETERO, tags=None):
    """The same topology in both packages: a region a row of (job rate,
    spot rate, price, hazard, notice, rmax), exponential processes."""
    tags = tags or [None] * len(rows)
    return tuple(mod.RegionTopology(regions=tuple(
        mod.Region(mod.Exponential(j), mod.Exponential(s), price=c,
                   hazard=h, notice=w, rmax=m, tag=tag)
        for (j, s, c, h, w, m), tag in zip(rows, tags)))
        for mod in (R, T))


def both(make):
    """``make(package)`` for the JAX package and the port."""
    return make(R), make(T)


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------
def test_topology_descriptors_and_params_match_jax():
    jt, tt = both_topologies(tags=[4, 0, 7, 2])
    for name in ("n_regions", "total_slots", "preemptible",
                 "is_degenerate"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt.tags == tuple(r.tag for r in jt.regions) == (4, 0, 7, 2)
    for name in ("slot_offsets", "prices", "hazards", "notices", "rates",
                 "job_rates", "rmaxes"):
        got, ref = getattr(tt, name)(), getattr(jt, name)()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert tt.total_job_rate() == jt.total_job_rate()
    ref, got = jt.params(), tt.params()
    assert set(got) == set(ref)
    for name, v in ref.items():
        assert got[name].dtype == np.asarray(v).dtype, name
        np.testing.assert_array_equal(got[name], np.asarray(v), err_msg=name)
    perm = [2, 0, 3, 1]
    assert tt.relabel(perm).tags == tuple(
        r.tag for r in jt.relabel(perm).regions)
    np.testing.assert_array_equal(tt.relabel(perm).slot_offsets(),
                                  jt.relabel(perm).slot_offsets())
    jd, td = both(lambda m: m.RegionTopology.single(
        m.Exponential(LAM), m.Exponential(MU), rmax=3))
    assert td.is_degenerate and jd.is_degenerate and td.tags == (0,)
    one = T.Region(T.Exponential(LAM), T.Exponential(MU))
    assert T.as_topology(one).regions[0].tag == 0
    assert T.as_topology(tt) is tt
    with pytest.raises(TypeError):
        T.as_topology(T.Exponential(LAM))
    with pytest.raises(ValueError, match="at least one region"):
        T.RegionTopology(regions=())
    with pytest.raises(ValueError, match="unique"):
        T.RegionTopology(regions=(dataclasses.replace(one, tag=1),
                                  dataclasses.replace(one, tag=1)))
    with pytest.raises(ValueError, match="rmax"):
        T.RegionTopology(regions=(dataclasses.replace(one, rmax=0),))
    with pytest.raises(ValueError, match="permutation"):
        tt.relabel([0, 1, 1, 2])
    with pytest.raises(ValueError, match="unknown routing rule"):
        T.RoutingKernel(T.ThreePhaseKernel(), "nearest")


# ---------------------------------------------------------------------------
# the routing rules
# ---------------------------------------------------------------------------
def region_views(n, lanes):
    price = RNG.uniform(0.05, 1.0, (lanes, n)).astype(np.float32)
    price[:, -1] = price[:, 0]  # a tie on cheapest goes to the first
    rate = RNG.uniform(0.01, 0.1, (lanes, n)).astype(np.float32)
    rate[::3, -1] = rate[::3, 0]  # and on fastest
    qlen = RNG.integers(0, 3, (lanes, n)).astype(np.int32)
    fields = dict(
        home=RNG.integers(0, n, lanes).astype(np.int32), price=price,
        hazard=RNG.uniform(0.0, 0.2, (lanes, n)).astype(np.float32),
        notice=RNG.uniform(0.0, 1.0, (lanes, n)).astype(np.float32),
        rate=rate, job_rate=rate[:, ::-1].copy(), qlen_region=qlen,
        free_slots=(4 - qlen).astype(np.int32))
    return (jregions.RegionView(**{k: jnp.asarray(v)
                                   for k, v in fields.items()}),
            regions.RegionView(**{k: torch.from_numpy(v)
                                  for k, v in fields.items()}))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("choice", regions.ROUTES)
def test_choose_region_u_matches_jax(choice, n):
    lanes = 300
    jv, tv = region_views(n, lanes)
    u = RNG.random((lanes, n)).astype(np.float32)
    u[:4, 0] = (0.0, 1 - 2**-24, 0.5, 1 / n)  # edges of the uniform rule
    logits = RNG.normal(0.0, 1.0, (lanes, n)).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda v, lg, uu: jregions.choose_region_u(
        choice, v, {"region_logits": lg}, uu)))(jv, jnp.asarray(logits),
                                                jnp.asarray(u))
    got = regions.choose_region_u(choice, tv,
                                  {"region_logits": torch.from_numpy(logits)},
                                  torch.from_numpy(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    kernel = T.RoutingKernel(T.ThreePhaseKernel(), choice)
    assert kernel.slab_cols("route", n) \
        == R.RoutingKernel(R.ThreePhaseKernel(), choice).slab_cols("route", n)


@pytest.mark.parametrize("seed", range(4))
def test_host_route_and_choose_region_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    rows = tuple((LAM / n, float(rng.choice([1 / 30, 1 / 40, 1 / 60])),
                  float(np.round(rng.uniform(0.05, 1.0), 1)), 0.0, 0.0, 4)
                 for _ in range(n))  # ties on price and rate on purpose
    jt, tt = both_topologies(rows)
    jc, tc = JControl(delta=1.0), OnlineAdmissionController(delta=1.0)
    qlen = list(rng.integers(0, 5, n))
    for rule in ("home", "cheapest", "fastest", "least_loaded"):
        for home in range(n):
            kw = dict(prices=jt.prices(), rates=jt.rates(), qlens=qlen,
                      home=home)
            assert regions.host_route(rule, **kw) \
                == jregions.host_route(rule, **kw)
            assert tc.choose_region(tt, qlen, home, rule) \
                == jc.choose_region(jt, qlen, home, rule)
        for _ in range(10):
            alive = rng.random(n) < 0.6
            home = int(rng.integers(0, n))
            if alive.any():
                assert tc.choose_region(tt, qlen, home, rule, alive) \
                    == jc.choose_region(jt, qlen, home, rule, alive)
            else:
                for ctl, topo in ((jc, jt), (tc, tt)):
                    with pytest.raises(RuntimeError, match="no region alive"):
                        ctl.choose_region(topo, qlen, home, rule, alive)
    with pytest.raises(ValueError, match="unknown host routing rule"):
        regions.host_route("uniform", prices=[1.0], rates=[1.0], qlens=[0])


# ---------------------------------------------------------------------------
# the slab column map
# ---------------------------------------------------------------------------
LAYOUT_KERNELS = {
    "bare_three_phase": lambda m: m.ThreePhaseKernel(),
    "bare_single_slot": lambda m: m.SingleSlotKernel(
        wait=m.DeterministicWait(3.0)),
    "bare_notice": lambda m: m.NoticeAwareKernel(0.05),
    "routed_three_phase_uniform": lambda m: m.RoutingKernel(
        m.ThreePhaseKernel(), "uniform"),
    "routed_notice_least_loaded": lambda m: m.RoutingKernel(
        m.NoticeAwareKernel(0.05), "least_loaded"),
    "routed_notice_weighted": lambda m: m.RoutingKernel(
        m.NoticeAwareKernel(0.2, "uniform"), "weighted"),
    "routed_single_slot_home": lambda m: m.RoutingKernel(
        m.SingleSlotKernel(wait=m.DeterministicWait(3.0)), "home"),
    "routed_pool_choice": lambda m: m.RoutingKernel(
        m.PoolChoiceKernel(m.ThreePhaseKernel(), "weighted"), "cheapest"),
}


@pytest.mark.parametrize("preempt_on", [False, True])
@pytest.mark.parametrize("name", list(LAYOUT_KERNELS))
def test_region_layout_matches_jax(name, preempt_on):
    jt, tt = both_topologies()
    jk, tk = both(LAYOUT_KERNELS[name])
    ref = jengine._region_layout(jt, jk, preempt_on)
    got = engine._region_layout(tt, tk, preempt_on)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_widest_region_row_fits_the_kernel():
    """The widest slab row a region run can ask for (bathtub jobs and
    spot, the weighted rule over the most regions the kernel holds, a
    notice-aware base drawing its own weighted pool, preemption and
    re-admission) fits the kernel's MAX_COLS and its 64-word draw pass."""
    from repro_torch.kernels.sweep import sweep
    wide = T.RegionTopology(regions=tuple(
        T.Region(T.BathtubGCP(), T.BathtubGCP(), hazard=0.1, rmax=4)
        for _ in range(sweep.MAX_REGIONS)))
    kernel = T.RoutingKernel(T.NoticeAwareKernel(0.05, "weighted"),
                             "weighted")
    layout = engine._region_layout(wide, kernel, True)
    assert layout.n_cols == 26 and layout.n_cols <= MAX_COLS <= 64


# ---------------------------------------------------------------------------
# the initial state
# ---------------------------------------------------------------------------
def test_init_region_state_bitwise_under_xla_log1p(xla_log1p):
    jt, tt = both_topologies(tags=[4, 0, 7, 2])
    lanes = 8
    raw = RNG.integers(0, 2**32, size=(lanes, 2),
                       dtype=np.uint64).astype(np.uint32)
    rp = {n: np.tile(v, (lanes, 1)) for n, v in tt.params().items()}
    rp["job_scale"] = RNG.uniform(0.5, 2.0, (lanes, 4)).astype(np.float32)
    rp["hazard"][::3, 1] = 0.0
    ref = jax.jit(jax.vmap(lambda k, r: jengine.init_region_state(
        jax.random.wrap_key_data(k), jt, r, True, scalar_preempt=True)))(
            jnp.asarray(raw), {n: jnp.asarray(v) for n, v in rp.items()})
    got = engine.init_region_state(
        torch.from_numpy(raw.astype(np.int64)), tt,
        {n: torch.from_numpy(v) for n, v in rp.items()}, True)
    np.testing.assert_array_equal(got.key.numpy(),
                                  np.asarray(jax.random.key_data(ref.key)))
    for name in ("next_job", "next_spot", "ages", "budgets", "occ", "order",
                 "next_seq", "qlen"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.next_preempt.numpy(),
                                  np.asarray(ref.next_preempt)[:, 0])


# ---------------------------------------------------------------------------
# whole runs: run_region_sweep / run_region_sim against the JAX package
# ---------------------------------------------------------------------------
R4 = {"r": np.linspace(0.5, 4.0, 4)}
GRID = np.linspace(0.05, 1.0, 12, dtype=np.float32).reshape(3, 4)
SWEEP_CASES = [
    # (name, kernel maker, params, vector_params, overrides)
    ("home", lambda m: m.ThreePhaseKernel(), R4, None, {}),
    ("cheapest", lambda m: m.RoutingKernel(m.NoticeAwareKernel(0.05),
                                           "cheapest"), R4, None, {}),
    ("fastest", lambda m: m.RoutingKernel(m.ThreePhaseKernel(), "fastest"),
     R4, None, {}),
    ("least_loaded", lambda m: m.RoutingKernel(m.NoticeAwareKernel(0.05),
                                               "least_loaded"), R4, None, {}),
    ("uniform", lambda m: m.RoutingKernel(m.NoticeAwareKernel(0.05),
                                          "uniform"), R4, None, {}),
    # a region_logits vector a grid point, swept beside r
    ("weighted", lambda m: m.RoutingKernel(m.ThreePhaseKernel(), "weighted"),
     {"r": np.array([[1.0], [3.0], [5.0]])}, {
         "region_logits": RNG.normal(0.0, 1.5, (3, 1, 4)).astype(
             np.float32)}, {}),
    ("single_slot", lambda m: m.RoutingKernel(
        m.SingleSlotKernel(wait=m.DeterministicWait(3.0)), "least_loaded"),
     {}, None, {}),
    # the regions-config axis: prices, hazards and job scales of
    # grid_shape + (R,), notices fixed per region, one spot scale for all
    ("regions_config", lambda m: m.RoutingKernel(m.NoticeAwareKernel(0.05),
                                                 "fastest"),
     {"r": np.array([[1.0], [2.5], [4.0]])},
     None, {"prices": GRID, "hazards": GRID[::-1] * 0.2,
            "job_scales": GRID * 2.0, "notices": np.array([0.5, 0.0, 0.01,
                                                          2.0]),
            "spot_scales": 1.5}),
]
SWEEP_KW = dict(k=K, n_events=800, n_seeds=2, chunk_events=384,
                burn_in=64, rng="slab")


def run_both(make_kernel, params, vector_params, overrides, key=0,
             topos=None, **kw):
    kw = {**SWEEP_KW, **kw}
    jt, tt = topos or both_topologies()
    jk, tk = both(make_kernel)
    jparams = {n: jnp.asarray(v, jnp.float32) for n, v in params.items()}
    ref = R.run_region_sweep(jt, jk, jparams, vector_params=vector_params,
                             key=jax.random.key(key), impl="ref",
                             **overrides, **kw)
    got = T.run_region_sweep(tt, tk, params, vector_params=vector_params,
                             key=threefry.key(key), device="cpu",
                             **overrides, **kw)
    return ref, got


def assert_bitwise(ref, got, context):
    assert set(got) == set(ref)
    for name, a in ref.items():
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(a),
                                      err_msg=f"{name} ({context})")


@pytest.mark.parametrize("name,make,params,vparams,overrides", SWEEP_CASES,
                         ids=[c[0] for c in SWEEP_CASES])
def test_run_region_sweep_matches_jax(name, make, params, vparams,
                                      overrides, xla_log1p):
    ref, got = run_both(make, params, vparams, overrides)
    assert_bitwise(ref, got, name)
    assert got["region_routed"].shape == got["avg_cost"].shape + (4,)


def test_run_region_sweep_with_its_own_log1p():
    """Each side with its own log1p: integers bitwise, floats close."""
    name, make, params, vparams, overrides = SWEEP_CASES[3]
    ref, got = run_both(make, params, vparams, overrides, key=4)
    assert ref["preemptions"].sum() > 0 and ref["resumed"].sum() > 0
    assert ref["cross_region_frac"].sum() > 0
    for field, a in ref.items():
        a, b = np.asarray(a), np.asarray(got[field])
        if field in engine.REGION_INT_STATS:
            np.testing.assert_array_equal(b, a, err_msg=field)
        elif field == "pi0_time":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6,
                                       err_msg=field)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=0,
                                       err_msg=field)


@pytest.mark.parametrize("which", ["notice_cheapest", "weighted"])
def test_run_region_sim_matches_jax(which, xla_log1p):
    if which == "weighted":
        make = lambda m: m.RoutingKernel(m.ThreePhaseKernel(),  # noqa: E731
                                         "weighted")
        params = {"r": 3.0, "region_logits": np.array([-1.0, 0.5, 2.0, 0.0])}
    else:
        make = lambda m: m.RoutingKernel(m.NoticeAwareKernel(0.05))  # noqa
        params = {"r": 2.5}
    jt, tt = both_topologies()
    jk, tk = both(make)
    kw = dict(k=K, n_events=1_000, chunk_events=400, burn_in=64,
              rng="slab")
    ref = R.run_region_sim(jt, jk, jax.tree.map(
        lambda v: jnp.asarray(v, jnp.float32), params),
        key=jax.random.key(5), impl="ref", **kw)
    got = T.run_region_sim(tt, tk, params, key=threefry.key(5),
                           device="cpu", **kw)
    assert_bitwise(ref, got, which)
    assert isinstance(got["avg_cost"], float)
    assert got["region_served"].shape == (4,)


def test_run_region_sweep_matches_jax_pallas_kernel(xla_log1p):
    """One case against the JAX region run through its Pallas kernel in
    interpret mode (as tests/test_core_regions.py runs it)."""
    jt, tt = both_topologies()
    jk, tk = both(lambda m: m.RoutingKernel(m.NoticeAwareKernel(0.05),
                                            "least_loaded"))
    kw = dict(k=K, n_events=600, n_seeds=2, chunk_events=256, rng="slab")
    ref = R.run_region_sweep(jt, jk, {"r": jnp.asarray([1.0, 3.0])},
                             key=jax.random.key(3), impl="pallas",
                             interpret=True, tile=4, **kw)
    got = T.run_region_sweep(tt, tk, {"r": np.array([1.0, 3.0])},
                             key=threefry.key(3), device="cpu", **kw)
    assert_bitwise(ref, got, "pallas")


# ---------------------------------------------------------------------------
# the port's own claims
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel,params,rmax", [
    (T.ThreePhaseKernel(), {"r": np.linspace(0.25, 4.0, 4)}, 8),
    (T.SingleSlotKernel(wait=DeterministicWait(3.0)), {}, 1)],
    ids=["three_phase", "single_slot"])
def test_degenerate_region_is_the_single_queue(kernel, params, rmax):
    """One region, unit price, no hazard, no route hook: bitwise the port's
    run_sweep (tests/test_core_regions.py's claim, on the port)."""
    kw = dict(k=K, n_events=1_200, key=threefry.key(3), n_seeds=2,
              chunk_events=500, burn_in=64, device="cpu")
    topo = T.RegionTopology.single(T.Exponential(LAM), T.Exponential(MU),
                                   rmax=rmax)
    assert topo.is_degenerate and not topo.preemptible
    single = T.run_sweep(T.Exponential(LAM), T.Exponential(MU), kernel,
                         params, rmax=rmax, **kw)
    reg = T.run_region_sweep(topo, kernel, params, **kw)
    for name, v in single.items():
        np.testing.assert_array_equal(reg[name], v, err_msg=name)
    assert reg["preemptions"].sum() == 0 and reg["cross_region_frac"].sum() == 0
    np.testing.assert_array_equal(reg["region_served"][..., 0],
                                  reg["spot_served"])
    np.testing.assert_array_equal(reg["spot_cost"], reg["spot_served"])


def test_degenerate_region_is_the_one_pool_market():
    """One region with price, hazard and notice under a notice-aware
    kernel: bitwise the port's 1-pool run_market_sweep, pool_* as
    region_*."""
    job, spot = T.Exponential(LAM), T.Exponential(1 / 40)
    kernel = T.NoticeAwareKernel(0.05)
    kw = dict(k=K, n_events=2_000, key=threefry.key(11), n_seeds=2,
              chunk_events=700, device="cpu")
    params = {"r": np.array([1.0, 2.0, 3.5])}
    mkt = T.run_market_sweep(job, T.SpotMarket.single(
        spot, price=0.4, hazard=0.05, notice=1.0), kernel, params, rmax=16,
        **kw)
    reg = T.run_region_sweep(T.RegionTopology.single(
        job, spot, price=0.4, hazard=0.05, notice=1.0, rmax=16), kernel,
        params, **kw)
    assert mkt["preemptions"].sum() > 0 and mkt["resumed"].sum() > 0
    for name, v in mkt.items():
        np.testing.assert_array_equal(
            reg[name.replace("pool_", "region_")], v, err_msg=name)


def test_capacity_partitions_are_respected():
    """rmax_r gates each region separately: under home routing a full
    region rejects to on-demand even while another partition is empty."""
    topo = T.RegionTopology(regions=(
        T.Region(T.Exponential(1.0), T.Exponential(1e-6), rmax=1),
        T.Region(T.Exponential(1e-6), T.Exponential(1.0), rmax=64)))
    res = T.run_region_sim(topo, T.ThreePhaseKernel(), {"r": 8.0}, k=K,
                           n_events=2_000, key=threefry.key(2), device="cpu")
    assert res["region_routed"][0] >= 1 and res["region_routed"][1] == 0
    assert res["ondemand"] > 0
    assert res["region_served"][1] == 0


def test_region_accounting_identities():
    """The JAX package's leg identities, spend conservation and the pooled
    LP floor on a run with routing, revocations and resumes."""
    tt = both_topologies()[1]
    kernel = T.RoutingKernel(T.NoticeAwareKernel(0.05), "least_loaded")
    res = T.run_region_sim(tt, kernel, {"r": 3.0}, k=K, n_events=3_000,
                           key=threefry.key(0), chunk_events=4_096,
                           device="cpu")
    assert res["preemptions"] > 0 and res["resumed"] > 0
    assert res["jobs_completed"] == (res["spot_served"] + res["ondemand"]
                                     + res["resumed"])
    assert res["spot_served"] == res["region_served"].sum()
    assert res["jobs_arrived"] == res["region_jobs"].sum()
    assert res["routed_home"] <= res["region_routed"].sum() \
        <= res["jobs_arrived"]
    spend = (tt.prices() * (res["region_served"]
                            + res["region_preempted"])).sum()
    np.testing.assert_allclose(res["spot_cost"], spend, rtol=2e-5)
    cost_sum = res["avg_cost"] * res["jobs_completed"]
    np.testing.assert_allclose(cost_sum, spend + K * res["ondemand"],
                               rtol=2e-5)
    floor = T.region_knapsack_lp(K, res["avg_delay_job"], tt,
                                 include_preemption=True)["objective"]
    assert res["avg_cost_job"] > floor - 0.3


#: one preemptible region: the topology the relabelling test permutes
RELABEL_ROWS = tuple((j, s, c, h if i == 3 else 0.0, w, m)
                     for i, (j, s, c, h, w, m) in enumerate(HETERO))


@functools.cache
def relabelled_run(perm: tuple) -> dict:
    topo = both_topologies(RELABEL_ROWS)[1].relabel(list(perm))
    return T.run_region_sim(
        topo, T.RoutingKernel(T.NoticeAwareKernel(0.05), "cheapest"),
        {"r": 3.0}, k=K, n_events=1_500, key=threefry.key(11),
        chunk_events=1_024, device="cpu")


@pytest.mark.parametrize("perm", [(1, 0, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1)])
def test_region_relabelling_leaves_stats_unchanged(perm):
    """Permuting regions with their tags fixed leaves every statistic
    equal (region arrays permuted).  On the slab stream this holds where
    one region carries the hazard: the thinned pick is positional, in the
    JAX package as in the port."""
    res, res_p = relabelled_run((0, 1, 2, 3)), relabelled_run(perm)
    assert res["preemptions"] > 0
    inv = [list(perm).index(i) for i in range(4)]
    for name, v in res.items():
        if name.startswith("region_"):
            np.testing.assert_array_equal(res_p[name][inv], v, err_msg=name)
        else:
            assert res_p[name] == v, name


def test_unported_options_raise_named_errors():
    tt = both_topologies()[1]
    kernel = T.RoutingKernel(T.NoticeAwareKernel(0.05), "least_loaded")
    kw = dict(n_events=100, key=threefry.key(0), device="cpu")
    for bad in ({"rng": "split"}, {"shard": "lanes"}):
        with pytest.raises(NotImplementedError):
            T.run_region_sweep(tt, kernel, {"r": 1.0}, **kw, **bad)
    # telemetry=, env= and work= are ported: a value of another type is
    # refused
    with pytest.raises(TypeError, match="WorkModel"):
        T.run_region_sweep(tt, kernel, {"r": 1.0}, **kw, work=object())
    with pytest.raises(TypeError, match="Telemetry"):
        T.run_region_sweep(tt, kernel, {"r": 1.0}, **kw, telemetry=object())
    with pytest.raises(TypeError, match="EnvTimeline"):
        T.run_region_sweep(tt, kernel, {"r": 1.0}, **kw, env=object())
    gamma = T.RegionTopology(regions=(
        tt.regions[0], dataclasses.replace(tt.regions[1],
                                           job=T.Gamma(12.0, 1.0))))
    with pytest.raises(NotImplementedError, match="Gamma"):
        T.run_region_sweep(gamma, kernel, {"r": 1.0}, **kw)
    with pytest.raises(NotImplementedError, match="Gamma"):
        T.run_region_sim(T.RegionTopology.single(
            T.Exponential(LAM), T.Gamma(2.0, 12.0)), kernel, {"r": 1.0}, **kw)
    # PanicKernel is ported: inside a routing kernel, without a blackout,
    # it runs as its base
    np.testing.assert_equal(
        T.run_region_sim(tt, T.RoutingKernel(T.PanicKernel(
            T.NoticeAwareKernel(0.05))), {"r": 1.0}, **kw),
        T.run_region_sim(tt, T.RoutingKernel(T.NoticeAwareKernel(0.05)),
                         {"r": 1.0}, **kw))
    with pytest.raises(NotImplementedError, match="split stream"):
        T.RoutingKernel(T.ThreePhaseKernel(), "uniform").route(
            {}, None, None, None)
    with pytest.raises(NotImplementedError, match="split stream"):
        regions.choose_region("weighted", None)
    with pytest.raises(ValueError, match="impl='cuda' needs a CUDA"):
        T.run_region_sweep(tt, kernel, {"r": 1.0}, impl="cuda", **kw)
    with pytest.raises(ValueError, match="one per region"):
        T.run_region_sweep(tt, kernel, {"r": 1.0}, prices=[0.1, 0.2], **kw)


def test_no_silent_cpu_run_when_the_card_is_asked_for():
    """device=None means the GPU; the kernel's wrapper refuses CPU tensors
    and topologies wider than it holds, and never falls back."""
    tt = both_topologies()[1]
    kernel = T.RoutingKernel(T.NoticeAwareKernel(0.05), "least_loaded")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            T.run_region_sweep(tt, kernel, {"r": 1.0}, n_events=10,
                               key=threefry.key(0))
    lanes = 3
    rp = {n: torch.from_numpy(np.tile(v, (lanes, 1)))
          for n, v in tt.params().items()}
    k = torch.full((lanes,), K)
    state = engine.init_region_state(threefry.split(threefry.key(1), lanes),
                                     tt, rp, True)
    args = (tt, kernel, True, state, {"r": torch.ones(lanes)}, rp, k, (50,))
    with pytest.raises(ValueError, match="CUDA tensor"):
        region_event_windows(*args)
    wide = T.RegionTopology(regions=tuple(
        T.Region(T.Exponential(LAM / 9), T.Exponential(MU / 9), rmax=2)
        for _ in range(9)))
    with pytest.raises(TooManyRegionsError):
        region_event_windows(wide, *args[1:])
