"""The port's environment-timeline axis on N-region routing against the JAX
package's, on the CPU: effective prices and hazards per region, spot supply
× availability (the job clocks are never modulated), PanicKernel's route
failover and admission gate, and the shock identities.

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
from test_torch_env_market import assert_shock_identities, market_costs
from test_torch_telemetry import assert_run_matches, ring_samples
import repro.core as R
from repro.core import env as jenv, market as jmarket, regions as jregions
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import env, market, regions, threefry

K = 10.0
RUN_KW = dict(k=K, n_events=1_500, burn_in=128, chunk_events=1_024,
              rng="slab")


def both_topologies():
    """tests/test_env.py's two-region topology, in both packages."""
    return [reg.RegionTopology(regions=(
        reg.Region(job=mod.Exponential(1.2), spot=mod.Exponential(0.9),
                   price=1.0, hazard=0.3, notice=0.1, rmax=4),
        reg.Region(job=mod.Exponential(0.7), spot=mod.Exponential(0.5),
                   price=0.6, hazard=0.8, notice=0.3, rmax=4)))
        for reg, mod in ((jregions, R), (regions, T))]


def kernels(name):
    """The kernel ``name`` in both packages."""
    def build(mkt, reg, mod):
        notice = mkt.NoticeAwareKernel(checkpoint_time=0.05)
        return {
            "routed": reg.RoutingKernel(notice, "cheapest"),
            "panic_routed": mod.PanicKernel(reg.RoutingKernel(
                notice, "least_loaded")),
            "panic_fastest": mod.PanicKernel(reg.RoutingKernel(
                notice, "fastest")),
            "panic_home": mod.PanicKernel(notice),
            "routed_panic": reg.RoutingKernel(mod.PanicKernel(notice),
                                              "cheapest"),
        }[name]

    return build(jmarket, jregions, R), build(market, regions, T)


def run_port(tl, kernel="routed", tel=None, sweep=False, **over):
    kw = {**RUN_KW, **over}
    tt, tk = both_topologies()[1], kernels(kernel)[1]
    if sweep:
        return T.run_region_sweep(tt, tk, {"r": np.array([1.0, 3.0])},
                                  hazards=np.array([[0.3, 0.8], [0.0, 1.5]]),
                                  key=threefry.key(7), n_seeds=2,
                                  device="cpu", env=tl, telemetry=tel, **kw)
    return T.run_region_sim(tt, tk, {"r": 2.0}, key=threefry.key(7),
                            device="cpu", env=tl, telemetry=tel, **kw)


def run_jax(tl, kernel="routed", tel=None, sweep=False, **over):
    kw = {**RUN_KW, **over}
    jt, jk = both_topologies()[0], kernels(kernel)[0]
    if sweep:
        return R.run_region_sweep(jt, jk, {"r": jnp.asarray([1.0, 3.0])},
                                  hazards=jnp.asarray([[0.3, 0.8],
                                                       [0.0, 1.5]]),
                                  key=jax.random.key(7), n_seeds=2,
                                  impl="xla", env=tl, telemetry=tel, **kw)
    return R.run_region_sim(jt, jk, {"r": jnp.float32(2.0)},
                            key=jax.random.key(7), impl="xla", env=tl,
                            telemetry=tel, **kw)


def test_constant_timeline_is_env_off():
    off = run_port(None, "panic_routed", n_events=1_000)
    on = run_port(env.EnvTimeline.constant(), "panic_routed",
                  n_events=1_000)
    assert_bitwise(off, on, "constant vs off")
    assert on["env_boundaries"] == 0 and on["storm_time"] == 0.0


@pytest.mark.parametrize("kernel", ["routed", "panic_routed", "panic_fastest",
                                    "panic_home", "routed_panic"])
def test_region_shock_run_matches_jax(kernel, xla_log1p):
    """A storm, a blackout of region 0 and a price spike: every key bitwise
    JAX's, under a routing kernel and PanicKernel around it (its route
    failover), around a kernel without a route (home unless dead) and
    inside a routing kernel (its admission gate alone); and the shock
    identities."""
    ref = run_jax(chaos_timeline(jenv), kernel)
    got = run_port(chaos_timeline(env), kernel)
    assert set(got) == set(ref)
    assert_bitwise(ref, got, f"regions {kernel}")
    assert_shock_identities(got, chaos_timeline(env))


def test_region_sweep_shock_run_matches_jax(xla_log1p):
    """A grid over r and the regions' hazards (one point without any), two
    seeds, under PanicKernel."""
    ref = run_jax(chaos_timeline(jenv), "panic_routed", sweep=True,
                  n_events=1_000, burn_in=0, chunk_events=512)
    got = run_port(chaos_timeline(env), "panic_routed", sweep=True,
                   n_events=1_000, burn_in=0, chunk_events=512)
    assert set(got) == set(ref)
    assert_bitwise(ref, got, "region sweep")
    assert got["blackout_time"].shape == (2, 2)


def test_panic_kernel_without_blackout_is_its_base():
    """No blackout: PanicKernel around a routing kernel is the routing
    kernel, bitwise, with env off and under a storm and a spike."""
    tl = env.inject_price_spike(env.inject_storm(
        env.EnvTimeline.constant(), 50.0, 250.0, hazard_mult=8.0), 300.0,
        500.0, price_mult=3.0)
    kw = dict(n_events=1_000)
    for timeline in (None, tl):
        base = run_port(timeline, "routed", **kw)
        got = T.run_region_sim(both_topologies()[1], T.PanicKernel(
            kernels("routed")[1]), {"r": 2.0}, key=threefry.key(7),
            device="cpu", env=timeline, **{**RUN_KW, **kw})
        assert_bitwise(base, got, f"panic {timeline is not None}")


def test_region_env_with_telemetry_matches_jax(xla_log1p):
    """env= with telemetry=: base, telemetry and env keys bitwise JAX's."""
    kw = dict(trace_cap=16)
    ref = run_jax(chaos_timeline(jenv), "panic_routed",
                  tel=R.Telemetry(**kw))
    got = run_port(chaos_timeline(env), "panic_routed",
                   tel=obs.Telemetry(**kw))
    run = functools.partial(lambda tel, **o: run_port(
        chaos_timeline(env), "panic_routed", tel=tel, **o),
        chunk_events=1_024)
    assert_run_matches(ref, got, obs.Telemetry(**kw),
                       ring_samples(run, kw, market_costs(
                           chaos_timeline(env))), "regions env+tel")
