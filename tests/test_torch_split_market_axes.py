"""The split stream (``rng="split"``) on the P-pool market with the market's
axes, against the JAX package on the CPU: ``telemetry=``, ``env=`` (a
storm, a blackout and a price spike, under ``PanicKernel`` with
``drain_dead``) and ``work=`` (each checkpoint mode under
``CantBeLateKernel``'s safety net), one run with all three, and
tests/test_work.py's k80 tournament on this stream.

Both sides take the same keys; the JAX package runs ``impl="xla",
rng="split"``, the port its plain PyTorch version (``device="cpu"``), under
``xla_log1p`` (tests/_torch_parity.py), so every statistic is bitwise: the
base keys, the telemetry counters and rings, the shock counters and the
survival ledger.  The histograms are bitwise too, or apart only by samples
that XLA's and PyTorch's ``log`` bin on the two sides of an edge
(tests/test_torch_telemetry.py::assert_hists replays them from a full
ring).
"""
import functools

import jax
import jax.numpy as jnp
import pytest

from _torch_parity import xla_log1p, xla_log1p_tables  # noqa: F401
from test_torch_env import one_torch_thread  # noqa: F401
from test_torch_env_market import both_markets
from test_torch_telemetry import assert_run_matches, assert_same, ring_samples
from test_torch_work import models
from test_torch_work_market import k80
import repro.core as R
from repro.core import env as jenv, market as jmarket, work as jwork
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import env, market, threefry, work
from repro_torch.core.cost import all_ondemand_cost

LAM, K = 1.2, 10.0
RUN_KW = dict(k=K, n_events=400, burn_in=0, chunk_events=200, rng="split")
TEL = dict(trace_cap=16)


def chaos_timeline(mod):
    """tests/test_torch_env.py's storm, blackout of pool 0 and price spike
    of pool 1, timed so that the runs here (~110 h) cross all six
    boundaries."""
    tl = mod.inject_storm(mod.EnvTimeline.constant(), 10.0, 25.0,
                          hazard_mult=8.0)
    tl = mod.inject_blackout(tl, 30.0, 45.0, loc=0, n_locs=2)
    return mod.inject_price_spike(tl, 50.0, 65.0, price_mult=3.0, loc=1,
                                  n_locs=2)


def kernels(net=False, drain=None):
    """NoticeAwareKernel(0.05) in both packages, inside a PanicKernel with
    ``drain`` (True/False) where it is given, wrapped in the safety net
    (outermost) where ``net``."""
    out = []
    for mkt, mod in ((jmarket, R), (market, T)):
        kernel = mkt.NoticeAwareKernel(checkpoint_time=0.05)
        if drain is not None:
            kernel = mod.PanicKernel(kernel, drain_dead=drain)
        if net:
            kernel = mod.CantBeLateKernel(kernel, slack_buffer=0.2)
        out.append(kernel)
    return out


def run(side, tl=None, tel=None, wm=None, net=False, drain=None, **over):
    """The two-pool market's run on ``side`` (0: JAX, 1: the port)."""
    kw = {**RUN_KW, **over}
    mkt, kernel = both_markets()[side], kernels(net, drain)[side]
    if side == 0:
        return R.run_market_sim(R.Exponential(LAM), mkt, kernel,
                                {"r": jnp.float32(2.0)},
                                key=jax.random.key(7), rmax=4, impl="xla",
                                env=tl, telemetry=tel, work=wm, **kw)
    return T.run_market_sim(T.Exponential(LAM), mkt, kernel, {"r": 2.0},
                            key=threefry.key(7), rmax=4, device="cpu",
                            env=tl, telemetry=tel, work=wm, **kw)


def test_telemetry_matches_jax(xla_log1p):
    """Telemetry with a wrapping ring: every field bitwise (the histograms
    to the JAX package's own exemption), the base keys bitwise the run
    without it."""
    ref = run(0, tel=R.Telemetry(**TEL))
    got = run(1, tel=obs.Telemetry(**TEL))
    assert_run_matches(ref, got, obs.Telemetry(**TEL), ring_samples(
        functools.partial(lambda tel, **o: run(1, tel=tel, **o),
                          chunk_events=RUN_KW["chunk_events"]), TEL,
        [0.6, 1.0, K]), "split market telemetry")
    off = run(1)
    assert_same(off, got, off, "telemetry on vs off")
    assert got["preemptions"] > 0 and got["resumed"] > 0


def test_shock_timeline_with_the_drain_matches_jax(xla_log1p):
    """A storm, a blackout of pool 0 and a price spike of pool 1, under
    PanicKernel(drain_dead=True): every key bitwise, the shock counters
    included; each pool's preemption clock rescaled at a crossing by its
    own hazards' ratio."""
    ref = run(0, tl=chaos_timeline(jenv), drain=True)
    got = run(1, tl=chaos_timeline(env), drain=True)
    assert_same(ref, got, ref, "split market env")
    assert got["env_boundaries"] == 6 and got["storms_observed"] == 1


@pytest.mark.parametrize("mode", ["never", "notice", "periodic"])
def test_work_under_the_safety_net_matches_jax(mode, xla_log1p):
    """Each checkpoint mode under CantBeLateKernel: every key bitwise, the
    survival ledger included; every resume billed its overhead."""
    ref = run(0, wm=models(jwork)[mode], net=True)
    got = run(1, wm=models(work)[mode], net=True)
    assert_same(ref, got, ref, f"split market work {mode}")
    assert got["jobs_ontime"] + got["deadline_misses"] == got["jobs_finished"]
    assert got["restart_overhead_paid"] == 0.5 * got["resumed"]
    assert got["panic_entries"] > 0


def test_all_three_axes_match_jax(xla_log1p):
    """Telemetry, the shock timeline under PanicKernel(drain_dead=True) and
    the periodic work model under the safety net, at once."""
    kw = dict(tl=None, net=True, drain=True)
    ref = run(0, tel=R.Telemetry(**TEL), wm=models(jwork)["periodic"],
              **{**kw, "tl": chaos_timeline(jenv)})
    got = run(1, tel=obs.Telemetry(**TEL), wm=models(work)["periodic"],
              **{**kw, "tl": chaos_timeline(env)})
    assert_run_matches(ref, got, obs.Telemetry(**TEL), ring_samples(
        functools.partial(lambda tel, **o: run(
            1, tel=tel, wm=models(work)["periodic"],
            **{**kw, "tl": chaos_timeline(env)}, **o),
            chunk_events=RUN_KW["chunk_events"]), TEL, [0.6, 1.0, K]),
        "split market, all three axes")
    assert got["env_boundaries"] == 6 and got["panic_entries"] > 0


def test_k80_tournament_matches_jax(xla_log1p):
    """tests/test_work.py's tournament on the split stream: every key of
    the base kernel's and the safety net's runs bitwise the JAX package's
    at test time (an earlier reading of the JAX package: 162 / 0 misses,
    237 panic entries, 2.39334 a leg); the safety net misses nothing,
    below the all-on-demand floor."""
    runs = {}
    w = dict(total_work=1.0, restart_overhead=0.2, deadline=2.5,
             od_time=0.5)
    kw = dict(k=5.0, n_events=2_500, burn_in=0, chunk_events=1_024,
              rng="split")
    for net in (False, True):
        jk, tk = kernels(net)
        jtl, jm = k80(R, jmarket)
        ttl, tm = k80(T, market)
        ref = R.run_market_sim(R.Exponential(1.2), jm, jk,
                               {"r": jnp.float32(2.0)},
                               key=jax.random.key(7), env=jtl, impl="xla",
                               work=jwork.WorkModel.on_notice(0.05, **w),
                               **kw)
        got = T.run_market_sim(T.Exponential(1.2), tm, tk, {"r": 2.0},
                               key=threefry.key(7), env=ttl, device="cpu",
                               work=work.WorkModel.on_notice(0.05, **w), **kw)
        assert_same(ref, got, ref, f"k80 split net={net}")
        runs[net] = got
    base, safe = runs[False], runs[True]
    assert base["deadline_misses"] > 0 and safe["deadline_misses"] == 0
    assert safe["panic_entries"] > 0
    assert safe["avg_cost"] < all_ondemand_cost(5.0, 1)
    print(f"k80 split: base {base['deadline_misses']} misses of "
          f"{base['jobs_finished']}, safety net {safe['deadline_misses']} of "
          f"{safe['jobs_finished']}, {safe['panic_entries']} panics, "
          f"{safe['avg_cost']:.5f} a leg")
