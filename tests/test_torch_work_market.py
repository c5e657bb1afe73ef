"""The port's work axis on the P-pool market against the JAX package's, on
the CPU: multi-unit service, rollbacks to the checkpoint and the restart
overhead on a resume, the survival ledger, the safety net, ``drain_dead``
with the work state, and tests/test_work.py's k80 tournament.

As tests/test_torch_work.py: the JAX package runs ``impl="xla",
rng="slab"``, the port its plain PyTorch version, under ``xla_log1p``;
every statistic bitwise, the ledger's float sums included.
"""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import xla_log1p, xla_log1p_tables  # noqa: F401
from test_torch_env_market import both_markets
from test_torch_env import chaos_timeline, one_torch_thread  # noqa: F401
from test_torch_telemetry import assert_run_matches, assert_same, ring_samples
from test_torch_work import models
import repro.core as R
from repro.core import env as jenv, market as jmarket, work as jwork
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import env, market, threefry, work
from repro_torch.core.cost import all_ondemand_cost

LAM, K = 1.2, 10.0
RUN_KW = dict(k=K, n_events=1_000, burn_in=128, chunk_events=512,
              rng="slab")
TRACE = Path(__file__).parent / "data" / "spot_trace_k80.json"


def kernels(net: bool, drain=None):
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


def run_port(work_name, net=False, drain=None, tl=None, tel=None,
             sweep=False, wm=None, **over):
    """The port's market run with the work model ``work_name`` of
    :func:`test_torch_work.models` (or ``wm``)."""
    kw = {**RUN_KW, **over}
    tm, tk = both_markets()[1], kernels(net, drain)[1]
    tw = wm or models(work)[work_name]
    if sweep:
        return T.run_market_sweep(
            T.Exponential(LAM), tm, tk, {"r": np.array([1.0, 3.0])},
            key=threefry.key(7), n_seeds=2, rmax=4, device="cpu", env=tl,
            telemetry=tel, work=tw, **kw)
    return T.run_market_sim(T.Exponential(LAM), tm, tk, {"r": 2.0},
                            key=threefry.key(7), rmax=4, device="cpu",
                            env=tl, telemetry=tel, work=tw, **kw)


def run_jax(work_name, net=False, drain=None, tl=None, tel=None,
            sweep=False, wm=None, **over):
    """:func:`run_port`'s run in the JAX package."""
    kw = {**RUN_KW, **over}
    jm, jk = both_markets()[0], kernels(net, drain)[0]
    jw = wm or models(jwork)[work_name]
    if sweep:
        return R.run_market_sweep(
            R.Exponential(LAM), jm, jk, {"r": jnp.asarray([1.0, 3.0])},
            key=jax.random.key(7), n_seeds=2, rmax=4, impl="xla", env=tl,
            telemetry=tel, work=jw, **kw)
    return R.run_market_sim(R.Exponential(LAM), jm, jk,
                            {"r": jnp.float32(2.0)}, key=jax.random.key(7),
                            rmax=4, impl="xla", env=tl, telemetry=tel,
                            work=jw, **kw)


@pytest.mark.parametrize("net", [False, True], ids=["base", "safety_net"])
@pytest.mark.parametrize("mode", ["never", "notice", "periodic"])
def test_market_work_matches_jax(mode, net, xla_log1p):
    """Each checkpoint mode, with and without the safety net: every key
    bitwise JAX's, the ledger included; rollbacks lose work except where
    the notice-mode checkpoint fits (both pools' notices fit 0.05), and
    every resume is billed its overhead."""
    ref, got = run_jax(mode, net), run_port(mode, net)
    assert set(got) == set(ref)
    assert_same(ref, got, ref, f"market {mode}")
    assert got["jobs_ontime"] + got["deadline_misses"] == got["jobs_finished"]
    assert got["restart_overhead_paid"] == 0.5 * got["resumed"]
    assert (got["work_lost"] > 0) == (mode != "notice")
    if net:
        assert got["panic_entries"] > 0


def test_identity_model_is_work_off_in_the_market():
    """``WorkModel()`` leaves every base key of the market bitwise, with
    preemptions and resumes."""
    (_, tm), (_, tk) = both_markets(), kernels(False)
    kw = dict(key=threefry.key(7), rmax=4, device="cpu", **RUN_KW)
    off = T.run_market_sim(T.Exponential(LAM), tm, tk, {"r": 2.0}, **kw)
    on = T.run_market_sim(T.Exponential(LAM), tm, tk, {"r": 2.0},
                          work=work.WorkModel(), **kw)
    assert off["resumed"] > 0
    assert_same(off, on, off, "identity vs off")
    assert on["work_lost"] == 0.0 and on["restart_overhead_paid"] == 0.0


def test_lost_is_recomputed_without_overhead(xla_log1p):
    """Without restart overhead, work recomputed is work lost, bitwise, and
    the port's ledger is JAX's."""
    jw, tw = (m.WorkModel.never(total_work=3.0, deadline=30.0, od_time=2.0)
              for m in (jwork, work))
    ref, got = run_jax(None, wm=jw), run_port(None, wm=tw)
    assert_same(ref, got, ref, "no overhead")
    assert got["work_lost"] > 0
    assert got["work_recomputed"] == got["work_lost"]


def test_drain_dead_with_work_matches_jax(xla_log1p):
    """tests/test_work.py's stranded pool (pool 1 dark from t = 50 on) with
    the work state: the drain re-tags queued jobs, their work state moves
    with their slot; PanicKernel(drain_dead=True) under the safety net,
    with telemetry, bitwise JAX's (the histograms to the JAX package's own
    exemption); more spot serves than without the drain."""
    tls = tuple(m.inject_blackout(m.EnvTimeline.constant(), 50.0, 1e6, loc=1,
                                  n_locs=2) for m in (jenv, env))
    kw = dict(trace_cap=16)
    ref = run_jax("periodic", True, True, tls[0], R.Telemetry(**kw))
    got = run_port("periodic", True, True, tls[1], obs.Telemetry(**kw))
    run = functools.partial(lambda tel, **o: run_port(
        "periodic", True, True, tls[1], tel, **o),
        chunk_events=RUN_KW["chunk_events"])
    assert_run_matches(ref, got, obs.Telemetry(**kw),
                       ring_samples(run, kw, [0.6, 1.0, K]),
                       "market drain work")
    stranded = run_port("periodic", True, False, tls[1])
    assert got["spot_served"] > stranded["spot_served"]


def test_market_sweep_with_env_matches_jax(xla_log1p):
    """run_market_sweep with the work state under a storm, a blackout and a
    spike (tests/test_torch_env.py's chaos timeline): every key bitwise
    JAX's, over two r and two seeds."""
    ref = run_jax("never", True, True, chaos_timeline(jenv), sweep=True)
    got = run_port("never", True, True, chaos_timeline(env), sweep=True)
    assert_same(ref, got, ref, "market sweep work+env")
    assert np.all(np.asarray(got["env_boundaries"]) > 0)


def k80(mod, mkt):
    """tests/test_work.py::_k80: the trace's timeline and its two-pool
    market, in one package."""
    d = json.loads(TRACE.read_text())
    tl = mod.timeline_from_trace(d["times"], d["avail"])
    return tl, mkt.SpotMarket(pools=tuple(
        mkt.SpotPool(arrival=mod.Exponential(r), price=p["price"],
                     hazard=p["hazard"], notice=p["notice"])
        for r, p in zip((0.8, 0.6), d["pools"])))


def test_k80_tournament_matches_jax(xla_log1p):
    """tests/test_work.py's tournament on the slab stream: the base kernel
    misses 154 deadlines, the safety net none, with 275 panic entries at
    an average cost of 2.47483, below the all-on-demand floor; every key
    bitwise the JAX package's."""
    runs = {}
    for net in (False, True):
        jk, tk = kernels(net)
        jtl, jm = k80(R, jmarket)
        ttl, tm = k80(T, market)
        w = dict(total_work=1.0, restart_overhead=0.2, deadline=2.5,
                 od_time=0.5)
        kw = dict(k=5.0, n_events=2_500, burn_in=0, chunk_events=1_024)
        ref = R.run_market_sim(R.Exponential(1.2), jm, jk,
                               {"r": jnp.float32(2.0)},
                               key=jax.random.key(7), env=jtl, rng="slab",
                               work=jwork.WorkModel.on_notice(0.05, **w),
                               **kw)
        got = T.run_market_sim(T.Exponential(1.2), tm, tk, {"r": 2.0},
                               key=threefry.key(7), env=ttl, device="cpu",
                               work=work.WorkModel.on_notice(0.05, **w), **kw)
        assert_same(ref, got, ref, f"k80 net={net}")
        runs[net] = got
    base, safe = runs[False], runs[True]
    assert (base["deadline_misses"], base["jobs_finished"]) == (154, 909)
    assert (safe["deadline_misses"], safe["jobs_finished"]) == (0, 788)
    assert safe["panic_entries"] == 275
    assert round(safe["avg_cost"], 5) == 2.47483
    assert safe["avg_cost"] < all_ondemand_cost(5.0, 1)
    # both runs see the trace's 24 h of blackout (their float32 sums of
    # it add different events)
    np.testing.assert_allclose([base["blackout_time"], safe["blackout_time"]],
                               24.0, rtol=1e-6)
