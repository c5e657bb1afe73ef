"""The port's work axis (``work=``) against the JAX package's, on the CPU:
the work model (:mod:`repro_torch.core.work`), the survival ledger
(:mod:`repro_torch.obs.survival`), the validation errors, and whole
single-queue runs.

Whole runs: the JAX package runs ``impl="xla", rng="slab"`` (its own tests
hold ``pallas``/``ref`` equal to it), the port its plain PyTorch version,
under the ``xla_log1p`` fixture (XLA's own ``-log1p(-u)``), so every
statistic is held bitwise, the ledger's float sums included.
tests/test_torch_work_market.py and tests/test_torch_work_regions.py hold
the other two loops the same way.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import xla_log1p, xla_log1p_tables  # noqa: F401
from test_torch_env import run_jax, run_port, single_timeline
from test_torch_telemetry import assert_run_matches, assert_same, ring_samples
import repro.core as R
from repro.core import env as jenv
from repro.core import work as jwork
from repro.obs import survival as jsurvival
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import env, threefry, work
from repro_torch.kernels.sweep import batched_event_windows_ref
from repro_torch.obs import survival

K = 10.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs dozens of small operations an event; on one
    thread they do not wait on a pool that other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def models(mod):
    """tests/test_work.py's ledger-exercising model in each checkpoint mode
    (three units a job, priced restarts, live deadlines), and the identity
    model."""
    kw = dict(total_work=3.0, restart_overhead=0.5, deadline=30.0,
              od_time=2.0)
    return {"identity": mod.WorkModel(),
            "never": mod.WorkModel.never(**kw),
            "notice": mod.WorkModel.on_notice(0.05, **kw),
            "periodic": mod.WorkModel.periodic(1.0, cost=0.25, **kw)}


def tight(mod):
    """A model whose deadline the single queue's jobs can miss (r = 2 at
    λ 1.2, μ 0.9): the safety net then panics."""
    return mod.WorkModel.periodic(1.0, cost=0.25, total_work=3.0,
                                  restart_overhead=0.5, deadline=9.0,
                                  od_time=1.0)


def kernels(net: bool):
    """The three-phase kernel of each package, wrapped in the safety net
    where ``net``."""
    jk, tk = R.ThreePhaseKernel(), T.ThreePhaseKernel()
    if net:
        return (R.CantBeLateKernel(jk, slack_buffer=0.2),
                T.CantBeLateKernel(tk, slack_buffer=0.2))
    return jk, tk


# ---------------------------------------------------------------------------
# the work model, the slack law, the safety net's wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["identity", "never", "notice", "periodic"])
def test_work_model_params_match_jax(name):
    """The same descriptor and the same float32 parameters; the identity
    model's deadline is 3e38, not infinity."""
    jm, tm = models(jwork)[name], models(work)[name]
    assert jm.__dict__ == tm.__dict__
    jp, tp = jm.params(), tm.params()
    assert list(jp) == list(tp)
    for field, a in jp.items():
        b = tp[field]
        assert b.dtype == torch.float32 and b.shape == ()
        assert b.numpy().tobytes() == np.asarray(a).tobytes(), field
    assert float(models(work)["identity"].params()["deadline"]) == \
        float(np.float32(3e38))
    huge = work.WorkModel(deadline=float("inf")).params()["deadline"]
    assert float(huge) == float(np.float32(3e38))


@pytest.mark.parametrize("make", [
    lambda m: m.WorkModel(ckpt="sometimes"),
    lambda m: m.WorkModel(total_work=0.0),
    lambda m: m.WorkModel.periodic(0.0),
    lambda m: m.WorkModel.periodic(-1.0, total_work=2.0),
], ids=["ckpt", "total_work", "period", "negative_period"])
def test_work_model_validation_matches_jax(make):
    """Each malformed model raises the JAX package's error: the same type
    and message."""
    with pytest.raises(ValueError) as want:
        make(jwork)
    with pytest.raises(ValueError) as got:
        make(work)
    assert str(got.value) == str(want.value)


def test_restart_overhead_and_slack_match_jax():
    """``restart_overhead_from_timing`` and ``deadline_slack`` (host
    scalars and tensors) as the JAX package's."""
    for args in ((3.0, 1.0, 2.0, 2.0), (0.5, 0.25, 0.1, 1.0),
                 (12.0, 0.0, 3.0, 0.5)):
        assert (work.restart_overhead_from_timing(*args)
                == jwork.restart_overhead_from_timing(*args))
    for bad in ((1.0, 1.0, 0.0), (1.0, 1.0, 1.0, 0.0)):
        with pytest.raises(ValueError) as want:
            jwork.restart_overhead_from_timing(*bad)
        with pytest.raises(ValueError) as got:
            work.restart_overhead_from_timing(*bad)
        assert str(got.value) == str(want.value)
    assert T.deadline_slack(10.0, 2.0, 4.0, 1.0) == R.deadline_slack(
        10.0, 2.0, 4.0, 1.0) == 4.0
    assert T.deadline_slack(10.0, 2.0, 4.0, 1.0, buffer=4.0) == 0.0
    # float32 arrays: the port's tensors round each operation as numpy's
    # float32 law does; a standalone jit of the law is XLA's, which fuses
    # the product into the subtraction (an FMA: within the product's
    # rounding and the result's)
    rng = np.random.default_rng(3)
    d, life, rem, od = (rng.random(64).astype(np.float32) * s
                        for s in (100.0, 60.0, 5.0, 10.0))
    buf = np.float32(0.2)
    got = T.deadline_slack(*(torch.from_numpy(x) for x in (d, life, rem, od)),
                           buf).numpy()
    np.testing.assert_array_equal(got, R.deadline_slack(d, life, rem, od,
                                                        buf))
    fused = np.asarray(jax.jit(lambda *a: R.deadline_slack(*a, buf))(
        d, life, rem, od))
    assert np.all(np.abs(got - fused)
                  <= np.spacing(np.abs(rem * od)) + np.spacing(np.abs(got)))


def test_cant_be_late_delegates_as_jax_does():
    """The wrapper forwards every foreign attribute to its base (a
    PanicKernel's drain, the hooks), owns the safety-net marker, and a
    PanicKernel around it does not forward the marker."""
    base = T.PanicKernel(T.NoticeAwareKernel(checkpoint_time=0.05),
                         drain_dead=True)
    wrapped = T.CantBeLateKernel(base, slack_buffer=0.1)
    assert wrapped.safety_net is True and wrapped.drain_dead is True
    assert wrapped.slab_cols("admit_market", 2) == base.slab_cols(
        "admit_market", 2)
    assert getattr(base, "safety_net", False) is False
    assert not hasattr(T.PanicKernel(wrapped), "safety_net")
    with pytest.raises(AttributeError):
        wrapped._private  # noqa: B018
    assert work.peel_safety_net(wrapped) == (base, True, 0.1)
    assert work.peel_safety_net(base) == (base, False, 0.0)


def test_entry_points_check_work_as_jax_does():
    """tests/test_work.py's host errors, on the port: a safety-net kernel
    without ``work=`` on every entry point, and a work model of another
    type; ``rng="split"`` on the regions, Gamma and ``shard=`` stay refused
    by name."""
    job, spot = T.Exponential(1.2), T.Exponential(0.9)
    net = T.CantBeLateKernel(T.NoticeAwareKernel(checkpoint_time=0.05))
    market = T.SpotMarket(pools=(T.SpotPool(T.Exponential(0.9), 1.0, 0.3,
                                            0.1),))
    topo = T.RegionTopology(regions=(T.Region(job, spot, rmax=4),))
    kw = dict(k=K, n_events=100, key=threefry.key(7), device="cpu")
    for call in (
            lambda: T.run_sim(job, spot, net, {"r": 2.0}, **kw),
            lambda: T.run_sweep(job, spot, net, {"r": [2.0]}, **kw),
            lambda: T.run_market_sim(job, market, net, {"r": 2.0}, **kw),
            lambda: T.run_market_sweep(job, market, net, {"r": [2.0]}, **kw),
            lambda: T.run_region_sim(topo, net, {"r": 2.0}, **kw),
            lambda: T.run_region_sweep(topo, net, {"r": [2.0]}, **kw)):
        with pytest.raises(ValueError, match="work"):
            call()
    with pytest.raises(TypeError, match="WorkModel"):
        T.run_sim(job, spot, T.ThreePhaseKernel(), {"r": 2.0},
                  work="periodic", **kw)
    with pytest.raises(TypeError, match="WorkModel"):
        T.run_sweep(job, spot, T.ThreePhaseKernel(), {"r": [2.0]},
                    work=jwork.WorkModel(), **kw)
    w = work.WorkModel()
    with pytest.raises(NotImplementedError, match="split"):
        T.run_region_sim(topo, T.NoticeAwareKernel(0.05), {"r": 2.0},
                         rng="split", work=w, **kw)
    with pytest.raises(NotImplementedError, match="Gamma"):
        T.run_sim(T.Gamma(2.0, 1.0), spot, T.ThreePhaseKernel(), {"r": 2.0},
                  work=w, **kw)
    with pytest.raises(NotImplementedError, match="shard"):
        T.run_sweep(job, spot, T.ThreePhaseKernel(), {"r": [2.0]},
                    shard="lanes", work=w, **kw)


# ---------------------------------------------------------------------------
# the survival ledger
# ---------------------------------------------------------------------------
def random_ledger(module, lead, rng):
    """A SurvivalWindowStats of ``lead`` shape with random counters and
    sums, as JAX arrays or as tensors."""
    ints = [rng.integers(0, 50, lead).astype(np.int32) for _ in range(6)]
    floats = [rng.random(lead).astype(np.float32) * 40 for _ in range(4)]
    if module is jsurvival:
        return jsurvival.SurvivalWindowStats(*(jnp.asarray(x)
                                               for x in ints + floats))
    return survival.SurvivalWindowStats(*(torch.from_numpy(x)
                                          for x in ints + floats))


def test_survival_ledger_matches_jax():
    """``survival_update`` over a stream of seeded events (the on-time twin
    derived inside), ``survival_merge``, ``survival_reduce`` and
    ``summarize_survival`` against the JAX package's."""
    rng = np.random.default_rng(22)
    n = 64
    ev = {"admitted": rng.random(n) < 0.5, "finished": rng.random(n) < 0.5,
          "missed": rng.random(n) < 0.3, "checkpoint": rng.random(n) < 0.2,
          "panic": rng.random(n) < 0.1,
          "work_done": rng.random(n).astype(np.float32),
          "work_lost": rng.random(n).astype(np.float32) * 3,
          "work_recomputed": rng.random(n).astype(np.float32) * 4,
          "overhead_paid": rng.random(n).astype(np.float32)}
    jws = jsurvival.survival_zeros()
    tws = survival.survival_zeros(1, "cpu")
    for i in range(n):
        jws = jsurvival.survival_update(jws, **{k: jnp.asarray(v[i])
                                                for k, v in ev.items()})
        tws = survival.survival_update(tws, **{k: torch.from_numpy(v[i:i + 1])
                                               for k, v in ev.items()})
    assert tws._fields == jws._fields
    for field, a in jws._asdict().items():
        b = getattr(tws, field)
        assert b.dtype == (torch.int32 if np.asarray(a).dtype == np.int32
                           else torch.float32), field
        np.testing.assert_array_equal(b.numpy()[0], np.asarray(a),
                                      err_msg=field)
    assert int(tws.ontime + tws.misses) == int(tws.finished)
    ja = random_ledger(jsurvival, (3, 4), np.random.default_rng(5))
    jb = random_ledger(jsurvival, (3, 4), np.random.default_rng(6))
    ta = random_ledger(survival, (3, 4), np.random.default_rng(5))
    tb = random_ledger(survival, (3, 4), np.random.default_rng(6))
    for jx, tx in ((jsurvival.survival_merge(ja, jb),
                    survival.survival_merge(ta, tb)),
                   (jsurvival.survival_reduce(ja, 1),
                    survival.survival_reduce(ta, 1))):
        for a, b in zip(jx, tx):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    js, ts = jsurvival.summarize_survival(ja), survival.summarize_survival(ta)
    assert list(js) == list(ts)
    assert set(survival.SURVIVAL_INT_STATS) < set(ts)
    assert survival.SURVIVAL_INT_STATS == jsurvival.SURVIVAL_INT_STATS
    assert_same(js, ts, js, "summarize_survival")
    one = survival.summarize_survival(
        survival.SurvivalWindowStats(*(x[0, 0] for x in ta)))
    assert isinstance(one["jobs_admitted"], int)


# ---------------------------------------------------------------------------
# whole single-queue runs
# ---------------------------------------------------------------------------
def test_identity_model_is_work_off():
    """``WorkModel()`` is ``work=None`` bitwise on the base keys (every
    serve completes its job, no deadline binds), and only adds the
    ledger's keys."""
    off = run_port(None)
    on = run_port(None, work=work.WorkModel())
    assert set(on) - set(off) == set(
        survival.summarize_survival(survival.survival_zeros(1, "cpu")))
    assert_same(off, on, off, "identity vs off")
    assert on["deadline_misses"] == 0 and on["panic_entries"] == 0
    assert on["jobs_ontime"] == on["jobs_finished"]


@pytest.mark.parametrize("net", [False, True], ids=["base", "safety_net"])
@pytest.mark.parametrize("mode", ["never", "notice", "periodic"])
def test_single_queue_work_matches_jax(mode, net, xla_log1p):
    """Each checkpoint mode, with and without the safety net: every key
    bitwise JAX's, the ledger included.  The single queue has no
    preemption: nothing is lost, and only periodic checkpoints are
    taken."""
    jk, tk = kernels(net)
    ref = run_jax(None, jk, work=models(jwork)[mode])
    got = run_port(None, tk, work=models(work)[mode])
    assert set(got) == set(ref)
    assert_same(ref, got, ref, f"single {mode}")
    assert got["work_lost"] == 0.0
    assert (got["checkpoints_taken"] > 0) == (mode == "periodic")
    assert got["jobs_ontime"] + got["deadline_misses"] == got["jobs_finished"]


def test_single_queue_safety_net_panics_match_jax(xla_log1p):
    """A deadline the base kernel misses: the safety net's panics and
    ledger bitwise JAX's, over a sweep of r and two seeds, and no miss
    left under it (nothing rolls back in the single queue)."""
    base = run_jax(None, kernels(False)[0], sweep=True, work=tight(jwork))
    assert np.asarray(base["deadline_misses"]).sum() > 0
    jk, tk = kernels(True)
    ref = run_jax(None, jk, sweep=True, work=tight(jwork))
    got = run_port(None, tk, sweep=True, work=tight(work))
    assert_same(ref, got, ref, "single safety net sweep")
    assert np.asarray(got["panic_entries"]).sum() > 0
    assert np.all(np.asarray(got["deadline_misses"]) == 0)


def test_single_queue_work_with_env_and_telemetry_matches_jax(xla_log1p):
    """work= with env= and telemetry=: every key against JAX's (the
    histograms to the JAX package's own exemption); the base, telemetry
    and env keys bitwise the same run without the work axis where the
    model is the identity."""
    kw = dict(trace_cap=16)
    jk, tk = kernels(True)
    ref = run_jax(single_timeline(jenv), jk, tel=R.Telemetry(**kw),
                  work=tight(jwork))
    got = run_port(single_timeline(env), tk, tel=obs.Telemetry(**kw),
                   work=tight(work))
    run = functools.partial(lambda tel, **o: run_port(
        single_timeline(env), tk, tel=tel, work=tight(work), **o),
        chunk_events=1_024)
    assert_run_matches(ref, got, obs.Telemetry(**kw),
                       ring_samples(run, kw, [np.float32(1.0),
                                              np.float32(K)]),
                       "single work+env+tel")
    base_tk = T.ThreePhaseKernel()
    off = run_port(single_timeline(env), base_tk, tel=obs.Telemetry(**kw))
    on = run_port(single_timeline(env), base_tk, tel=obs.Telemetry(**kw),
                  work=work.WorkModel())
    assert_same(off, on, off, "identity with env and telemetry")


def test_life_is_ages_in_the_single_queue():
    """The CUDA kernel keeps a slot's life in its age in the single queue:
    from zero states, the plain version's final life equals its final ages
    at every slot, with and without the env timeline (where a crossing
    moves no slot)."""
    job, spot = T.Exponential(1.2), T.Exponential(0.9)
    for tl in (None, single_timeline(env)):
        ep = None if tl is None else tl.params(1, "cpu")
        keys = threefry.split(threefry.key(3), 6)
        state = T.init_engine_state(keys, job, spot, 8, ep)
        if ep is not None:
            state = (state, env.init_env_state(ep, 6))
        state = (state, work.init_work_state(8, 6))
        params = {"r": torch.linspace(0.5, 6.0, 6)}
        k = torch.full((6,), np.float32(K))
        fin, stats = batched_event_windows_ref(
            job, spot, T.CantBeLateKernel(T.ThreePhaseKernel(), 0.2), 8,
            state, params, k, (256, 700, 300), None, ep, tight(work),
            tight(work).params())
        inner, ws = fin
        base = inner if ep is None else inner[0]
        assert torch.equal(ws.life, base.ages)
        assert int(stats[1].panics.sum()) > 0
