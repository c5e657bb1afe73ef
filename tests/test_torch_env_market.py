"""The port's environment-timeline axis on the P-pool market against the JAX
package's, on the CPU: effective prices and hazards, supply × availability,
PanicKernel's failover and ``drain_dead``, and the shock identities.

As tests/test_torch_env.py: the JAX package runs ``impl="xla",
rng="slab"``, the port its plain PyTorch version, under ``xla_log1p``;
every statistic bitwise, the shock counters included.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import xla_log1p, xla_log1p_tables  # noqa: F401
from test_torch_env import (assert_bitwise, chaos_timeline,  # noqa: F401
                            one_torch_thread)
from test_torch_telemetry import assert_run_matches, ring_samples
import repro.core as R
from repro.core import env as jenv, market as jmarket
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import env, market, threefry
from repro_torch.obs import shocks

LAM, K = 1.2, 10.0
RUN_KW = dict(k=K, n_events=1_500, burn_in=128, chunk_events=1_024,
              rng="slab")


def both_markets():
    """tests/test_env.py's two-pool market, in both packages."""
    return [mkt.SpotMarket(pools=(
        mkt.SpotPool(arrival=mod.Exponential(0.9), price=1.0, hazard=0.3,
                     notice=0.1),
        mkt.SpotPool(arrival=mod.Exponential(0.5), price=0.6, hazard=0.8,
                     notice=0.3))) for mkt, mod in ((jmarket, R),
                                                    (market, T))]


def kernels(name):
    """The kernel ``name`` in both packages."""
    def build(mkt, mod):
        notice = mkt.NoticeAwareKernel(checkpoint_time=0.05)
        return {"notice": notice,
                "panic": mod.PanicKernel(notice),
                "drain": mod.PanicKernel(notice, drain_dead=True),
                "panic_legacy": mod.PanicKernel(mod.ThreePhaseKernel()),
                "drain_least_loaded": mod.PanicKernel(
                    mkt.NoticeAwareKernel(0.05, "least_loaded"),
                    drain_dead=True)}[name]

    return build(jmarket, R), build(market, T)


def run_port(tl, kernel="notice", tel=None, sweep=False, r=2.0, **over):
    kw = {**RUN_KW, **over}
    tm, tk = both_markets()[1], kernels(kernel)[1]
    if sweep:
        return T.run_market_sweep(T.Exponential(LAM), tm, tk,
                                  {"r": np.array([1.0, 3.0])},
                                  hazards=np.array([[0.3, 0.8], [0.0, 1.5]]),
                                  key=threefry.key(7), n_seeds=2, rmax=4,
                                  device="cpu", env=tl, telemetry=tel, **kw)
    return T.run_market_sim(T.Exponential(LAM), tm, tk, {"r": r},
                            key=threefry.key(7), rmax=4, device="cpu",
                            env=tl, telemetry=tel, **kw)


def run_jax(tl, kernel="notice", tel=None, sweep=False, r=2.0, **over):
    kw = {**RUN_KW, **over}
    jm, jk = both_markets()[0], kernels(kernel)[0]
    if sweep:
        return R.run_market_sweep(
            R.Exponential(LAM), jm, jk, {"r": jnp.asarray([1.0, 3.0])},
            hazards=jnp.asarray([[0.3, 0.8], [0.0, 1.5]]),
            key=jax.random.key(7), n_seeds=2, rmax=4, impl="xla", env=tl,
            telemetry=tel, **kw)
    return R.run_market_sim(R.Exponential(LAM), jm, jk,
                            {"r": jnp.float32(r)}, key=jax.random.key(7),
                            rmax=4, impl="xla", env=tl, telemetry=tel, **kw)


def test_constant_timeline_is_env_off():
    off = run_port(None, "drain", n_events=1_000)
    on = run_port(env.EnvTimeline.constant(), "drain", n_events=1_000)
    assert_bitwise(off, on, "constant vs off")
    assert on["env_boundaries"] == 0 and on["blackout_time"] == 0.0


def assert_shock_identities(out, tl):
    """Every injected shock observed once, the dwell times the segments'
    lengths (dt never spans a boundary), degradation bounded by exposure
    (tests/test_env.py's identities)."""
    assert out["env_boundaries"] == tl.n_segments - 1
    assert out["storms_observed"] == tl.count_storms()
    assert out["blackouts_observed"] == tl.count_blackouts()
    assert out["spikes_observed"] == tl.count_spikes()
    for kind, field in ((env.SEG_STORM, "storm_time"),
                        (env.SEG_BLACKOUT, "blackout_time")):
        want = sum(t1 - t0 for t0, t1, *_, k in tl.segments() if k == kind)
        np.testing.assert_allclose(out[field], want, rtol=1e-5)
    assert out["degraded_admits"] <= out["shock_arrivals"]


@pytest.mark.parametrize("kernel", ["notice", "drain", "panic_legacy",
                                    "drain_least_loaded"])
def test_market_shock_run_matches_jax(kernel, xla_log1p):
    """A storm, a blackout of the cheap pool and a price spike: every key
    bitwise JAX's, under the base kernel and PanicKernel (with
    ``drain_dead``, and around a legacy kernel whose pool 0 fails over);
    and the shock identities."""
    ref = run_jax(chaos_timeline(jenv), kernel)
    got = run_port(chaos_timeline(env), kernel)
    assert set(got) == set(ref)
    assert_bitwise(ref, got, f"market {kernel}")
    assert_shock_identities(got, chaos_timeline(env))


def test_market_sweep_shock_run_matches_jax(xla_log1p):
    """A grid over r and the pools' hazards (one point without any), two
    seeds, under PanicKernel with ``drain_dead``."""
    ref = run_jax(chaos_timeline(jenv), "drain", sweep=True,
                  n_events=1_000, burn_in=0, chunk_events=512)
    got = run_port(chaos_timeline(env), "drain", sweep=True,
                   n_events=1_000, burn_in=0, chunk_events=512)
    assert set(got) == set(ref)
    assert_bitwise(ref, got, "market sweep")
    assert got["storm_time"].shape == (2, 2)


def test_panic_kernel_without_blackout_is_its_base():
    """No blackout: PanicKernel (and its drain) is its base, bitwise, with
    env off and under a storm and a spike."""
    tl = env.inject_price_spike(env.inject_storm(
        env.EnvTimeline.constant(), 50.0, 250.0, hazard_mult=8.0), 300.0,
        500.0, price_mult=3.0)
    kw = dict(n_events=1_000)
    for timeline, kernels_ in ((None, ("drain",)), (tl, ("panic", "drain"))):
        base = run_port(timeline, "notice", **kw)
        for kernel in kernels_:
            assert_bitwise(base, run_port(timeline, kernel, **kw),
                           f"{kernel} {timeline is not None}")


def test_drain_dead_reproduces_jax(xla_log1p):
    """tests/test_work.py::test_drain_dead_rescues_stranded_jobs's config
    on the slab stream: the port reproduces JAX's numbers bitwise,
    spot_served 353 -> 467.  (That test's avg_cost claim fails on the JAX
    package itself, so the port is held to what JAX computes.)"""
    tl_j = jenv.inject_blackout(jenv.EnvTimeline.constant(), 50.0, 1e6,
                                loc=1, n_locs=2)
    tl_t = env.inject_blackout(env.EnvTimeline.constant(), 50.0, 1e6, loc=1,
                               n_locs=2)
    kw = dict(n_events=2_500, burn_in=0, chunk_events=1_024)
    jm, tm = both_markets()
    got = {}
    for drain in (False, True):
        ref = R.run_market_sim(R.Exponential(2.5), jm, R.PanicKernel(
            jmarket.NoticeAwareKernel(0.05), drain_dead=drain),
            {"r": jnp.float32(4.0)}, k=K, key=jax.random.key(7),
            impl="xla", rng="slab", env=tl_j, **kw)
        got[drain] = T.run_market_sim(T.Exponential(2.5), tm, T.PanicKernel(
            market.NoticeAwareKernel(0.05), drain_dead=drain), {"r": 4.0},
            k=K, key=threefry.key(7), device="cpu", rng="slab", env=tl_t,
            **kw)
        assert_bitwise(ref, got[drain], f"drain_dead={drain}")
    assert (got[False]["spot_served"], got[True]["spot_served"]) == (353, 467)
    np.testing.assert_array_equal(got[False]["pool_served"], [328, 25])
    np.testing.assert_array_equal(got[True]["pool_served"], [442, 25])


def market_costs(tl):
    """Every cost increment the two-pool market can fold under ``tl``: a
    served or revoked leg's effective price, k, and price + k."""
    out = [np.float32(K)]
    for seg in range(tl.n_segments):
        for p, base in enumerate((1.0, 0.6)):
            mult = tl.price_mult[seg]
            mult = mult[p] if isinstance(mult, tuple) else mult
            price = np.float32(np.float32(base) * np.float32(mult))
            out += [price, np.float32(np.float32(K) + price)]
    return out


def test_market_env_with_telemetry_matches_jax(xla_log1p):
    """env= with telemetry=: base, telemetry and env keys bitwise JAX's
    (histograms as tests/test_torch_telemetry.py holds them)."""
    kw = dict(trace_cap=16)
    ref = run_jax(chaos_timeline(jenv), "drain", tel=R.Telemetry(**kw))
    got = run_port(chaos_timeline(env), "drain", tel=obs.Telemetry(**kw))
    run = functools.partial(lambda tel, **o: run_port(
        chaos_timeline(env), "drain", tel=tel, **o), chunk_events=1_024)
    assert_run_matches(ref, got, obs.Telemetry(**kw),
                       ring_samples(run, kw, market_costs(
                           chaos_timeline(env))), "market env+tel")
    assert set(shocks.ENV_INT_STATS) < set(got)


def test_panic_without_a_timeline_picks_its_build():
    """The sweep wrapper's build for a PanicKernel without a timeline: with
    every location's rate > 0 the build without the env state (nothing is
    ever dead); with a rate of 0 the env build under the constant
    timeline, its counters dropped."""
    import torch

    from repro_torch.kernels.sweep import sweep as ksweep

    rates = torch.ones(3, 2)
    for panic in ((0, 0, 0), (1, 1, 1)):
        assert ksweep._env_for_panic(None, None, panic, rates, 2, 3,
                                     "cpu") == (None, None, True)
    rates[1, 0] = 0.0
    assert ksweep._env_for_panic(None, None, (0, 0, 0), rates, 2, 3,
                                 "cpu") == (None, None, True)
    ep, es, keep = ksweep._env_for_panic(None, None, (1, 1, 0), rates, 2, 3,
                                         "cpu")
    want = env.EnvTimeline.constant().params(2, "cpu")
    assert not keep and set(ep) == set(want)
    for name, x in want.items():
        assert torch.equal(ep[name], x), name
    assert torch.equal(es.seg, torch.zeros(3, dtype=torch.int32))
