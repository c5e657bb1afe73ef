"""The port's samplers, policies, initial state and theory layer against JAX.

Inputs are numpy uniforms and threefry keys shared by both sides.
Tolerance: whatever involves no ``log1p`` is bitwise; a draw that goes
through ``-log1p(-u)`` is within four ulps (XLA's and PyTorch's ``log1p``
each round within one ulp of the true value, and the draw scales or sums
the result); the numpy theory layer matches to 1e-12, except the Gamma CDF,
which the JAX package evaluates in float32.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import ulps
import repro.core.analytic as janalytic
import repro.core.arrivals as jarrivals
import repro.core.cost as jcost
import repro.core.lp as jlp
import repro.core.policies as jpolicies
import repro.core.waittime as jwait
from repro.core import engine as jengine
import repro_torch.core.analytic as analytic
import repro_torch.core.arrivals as arrivals
import repro_torch.core.cost as cost
import repro_torch.core.lp as lp
import repro_torch.core.policies as policies
import repro_torch.core.waittime as wait
from repro_torch import convert
from repro_torch.core import engine

U = np.random.default_rng(11).random((20_000, 12)).astype(np.float32)
LOG1P_ULPS = 4

ARRIVALS = [("Exponential", (1 / 12,)), ("Gamma", (12.0, 1.0)),
            ("Gamma", (3.0, 2.5)), ("Uniform", (0.3, 48.7)),
            ("Uniform", (0.0, 48.0)), ("Deterministic", (3.0,)),
            ("BathtubGCP", ())]


def uses_log1p(name):
    return name in ("Exponential", "Gamma", "BathtubGCP", "ExponentialWait")


@pytest.mark.parametrize("name,args", ARRIVALS,
                         ids=[f"{n}{a}" for n, a in ARRIVALS])
def test_sample_u_matches_jax(name, args):
    jproc, proc = getattr(jarrivals, name)(*args), getattr(arrivals, name)(*args)
    assert proc.u_dim == jproc.u_dim
    ref = np.asarray(jax.jit(jax.vmap(jproc.sample_u))(U))
    got = proc.sample_u(torch.from_numpy(U)).numpy()
    assert got.shape == ref.shape
    if uses_log1p(name):
        assert ulps(got, ref) <= LOG1P_ULPS
    else:
        np.testing.assert_array_equal(got, ref)


WAITS = [("InfiniteWait", ()), ("TwoPointWait", (0.3, 20.0)),
         ("ExponentialWait", (0.37,)), ("DeterministicWait", (3.0,))]


@pytest.mark.parametrize("name,args", WAITS, ids=[w[0] for w in WAITS])
def test_wait_sample_from_u_and_admit_u_match_jax(name, args):
    jw, w = getattr(jwait, name)(*args), getattr(wait, name)(*args)
    lanes = U.shape[0]
    # per-lane parameters, as a swept wait family carries them
    scale = np.linspace(0.5, 1.5, lanes).astype(np.float32)
    jp = {k: np.float32(v) * scale for k, v in jw.params().items()}
    p = convert.params(jp)
    ref = np.asarray(jax.jit(jax.vmap(jw.sample_from_u))(jp, U))
    got = w.sample_from_u(p, torch.from_numpy(U)).numpy()
    if uses_log1p(name):
        assert ulps(got, ref) <= LOG1P_ULPS
    else:
        np.testing.assert_array_equal(got, ref)

    qlen = np.random.default_rng(3).integers(0, 3, lanes).astype(np.int32)
    jk, k = jpolicies.SingleSlotKernel(wait=jw), policies.SingleSlotKernel(wait=w)
    assert k.slab_cols("admit", 1) == jk.slab_cols("admit", 1)
    ja, jb = jax.jit(jax.vmap(jk.admit_u))({"wait": jp}, qlen, U)
    a, b = k.admit_u({"wait": p}, torch.from_numpy(qlen), torch.from_numpy(U))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert ulps(b.numpy(), jb) <= (LOG1P_ULPS if uses_log1p(name) else 0)


def test_three_phase_admit_matches_jax():
    lanes = U.shape[0]
    rng = np.random.default_rng(5)
    r = rng.choice(np.linspace(0.0, 6.0, 25), lanes).astype(np.float32)
    qlen = rng.integers(0, 8, lanes).astype(np.int32)
    jk, k = jpolicies.ThreePhaseKernel(), policies.ThreePhaseKernel()
    assert k.slab_cols("admit", 1) == jk.slab_cols("admit", 1)
    ja, jb = jax.jit(jax.vmap(jk.admit_u))({"r": r}, qlen, U)
    a, b = k.admit_u({"r": torch.from_numpy(r)}, torch.from_numpy(qlen),
                     torch.from_numpy(U))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert np.float32(b) == np.asarray(jb)[0]
    probs = jax.jit(jax.vmap(jpolicies.three_phase_admit_prob))(qlen, r)
    np.testing.assert_array_equal(
        policies.three_phase_admit_prob(torch.from_numpy(qlen),
                                        torch.from_numpy(r)).numpy(),
        np.asarray(probs))
    for q in range(5):
        for rr in (0.0, 1.5, 2.0, 3.75):
            assert (policies.three_phase_admit_prob(q, rr)
                    == jpolicies.three_phase_admit_prob(q, rr))
            assert policies.phase_boundaries(rr) == jpolicies.phase_boundaries(rr)


INIT = [("Exponential", (1 / 12,)), ("Uniform", (0.3, 48.7)),
        ("Deterministic", (3.0,)), ("BathtubGCP", ())]


@pytest.mark.parametrize("name,args", INIT, ids=[c[0] for c in INIT])
def test_init_engine_state_matches_jax(name, args):
    keys = jax.random.key_data(jax.random.split(jax.random.key(3), 64))
    jproc, proc = getattr(jarrivals, name)(*args), getattr(arrivals, name)(*args)
    ref = jax.vmap(lambda k: jengine.init_engine_state(
        k, jproc, jproc, 4))(keys)
    got = engine.init_engine_state(convert.key_words(np.asarray(keys)), proc,
                                   proc, 4)
    for field in engine.EngineState._fields:
        a, b = np.asarray(getattr(ref, field)), getattr(got, field).numpy()
        if field in ("next_job", "next_spot") and uses_log1p(name):
            assert ulps(b, a) <= LOG1P_ULPS, field
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=field)


def _bathtub():
    return jarrivals.BathtubGCP(), arrivals.BathtubGCP()


THEORY = [
    ("theorem1_cost", lambda m: m.theorem1_cost(10.0, 1 / 12, 1 / 24, 0.3)),
    ("pi0_from_cost", lambda m: m.pi0_from_cost(10.0, 1 / 12, 1 / 24, 7.5)),
    ("cost_lower_bound",
     lambda m: m.cost_lower_bound(10.0, 1 / 12, 1 / 24, 6.0)),
    ("spot_utilization_bound",
     lambda m: m.spot_utilization_bound(1 / 12, 1 / 24, 6.0)),
    ("all_ondemand_cost", lambda m: m.all_ondemand_cost(5.0, 17, 3.0)),
    ("theorem1_market_cost", lambda m: m.theorem1_market_cost(
        10.0, 1 / 12, [0.02, 0.01], [0.3, 0.5], [0.6, 0.2])),
]
ANALYTIC = [
    ("theorem2_cost", lambda m: m.theorem2_cost(10.0, 1 / 24, 6.0)),
    ("theorem5_cost", lambda m: [m.theorem5_cost(k, 1 / 12, 1 / 24, n)
                                 for k in (2, 10, 20) for n in range(9)]),
    ("theorem5_cost_rho1", lambda m: m.theorem5_cost(10.0, 0.1, 0.1, 4)),
    ("theorem5_delta", lambda m: [m.theorem5_delta(1 / 12, 1 / 24, n)
                                  for n in range(1, 9)]),
    ("mm1n_pi", lambda m: m.mm1n_pi(1 / 12, 1 / 24, 6)),
    ("mm1n_cost_from_pi", lambda m: m.mm1n_cost_from_pi(10.0, 1 / 12,
                                                        1 / 24, 5)),
    ("mm1n_expected_queue", lambda m: m.mm1n_expected_queue(0.1, 0.3, 7)),
]


@pytest.mark.parametrize("name,fn", THEORY + ANALYTIC,
                         ids=[t[0] for t in THEORY + ANALYTIC])
def test_theory_matches_jax_package(name, fn):
    mods = (jcost, cost) if (name, fn) in THEORY else (janalytic, analytic)
    np.testing.assert_allclose(np.asarray(fn(mods[1]), np.float64),
                               np.asarray(fn(mods[0]), np.float64),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pair", ["exp_exp", "exp_uniform", "exp_bathtub"])
def test_prob_and_lp_oracles_match_jax_package(pair):
    spots = {"exp_exp": (jarrivals.Exponential(1 / 24),
                         arrivals.Exponential(1 / 24)),
             "exp_uniform": (jarrivals.Uniform(0.0, 48.0),
                             arrivals.Uniform(0.0, 48.0)),
             "exp_bathtub": _bathtub()}[pair]
    jjob, job = jarrivals.Exponential(1 / 12), arrivals.Exponential(1 / 12)
    np.testing.assert_allclose(
        arrivals.prob_A_le_S(job, spots[1]),
        jarrivals.prob_A_le_S(jjob, spots[0]), rtol=1e-12)
    np.testing.assert_allclose(
        analytic.theorem2_delta_max(job, spots[1]),
        janalytic.theorem2_delta_max(jjob, spots[0]), rtol=1e-12)
    w = np.linspace(0.0, 30.0, 7)
    np.testing.assert_allclose(arrivals.int_G_mu(spots[1], w),
                               jarrivals.int_G_mu(spots[0], w), rtol=1e-12)
    a = lp.waittime_lp(spots[1], 1 / 12, 4.0, grid_points=200)
    b = jlp.waittime_lp(spots[0], 1 / 12, 4.0, grid_points=200)
    for field in ("support", "masses", "objective"):
        np.testing.assert_allclose(getattr(a, field), getattr(b, field),
                                   rtol=1e-12)
    ka, kb = lp.knapsack_lp(1 / 12, 30.0), jlp.knapsack_lp(1 / 12, 30.0)
    np.testing.assert_allclose(ka["objective"], kb["objective"], rtol=1e-12)


def test_gamma_cdf_matches_jax_package():
    # the JAX package evaluates gammainc in float32 (x64 off), the port in
    # float64 through scipy: agreement to float32 precision
    t = np.linspace(0.0, 40.0, 81)
    np.testing.assert_allclose(arrivals.Gamma(12.0, 1.0).cdf(t),
                               jarrivals.Gamma(12.0, 1.0).cdf(t),
                               rtol=1e-5, atol=1e-7)
