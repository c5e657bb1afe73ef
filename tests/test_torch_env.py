"""The port's environment-timeline axis (``env=``) against the JAX package's,
on the CPU: the timeline descriptors and generators, the device helpers,
the shock counters (:mod:`repro_torch.obs.shocks`), the validation errors,
and whole single-queue runs.

Whole runs: the JAX package runs ``impl="xla", rng="slab"`` (its own tests
hold ``pallas``/``ref`` equal to it), the port its plain PyTorch version,
under the ``xla_log1p`` fixture (XLA's own ``-log1p(-u)``), so every
statistic is held bitwise, floats and the shock counters included.
tests/test_torch_env_market.py and tests/test_torch_env_regions.py hold the
other two loops the same way.
"""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import xla_log1p, xla_log1p_tables  # noqa: F401
from test_torch_telemetry import assert_run_matches, assert_same, ring_samples
import repro.core as R
from repro.core import env as jenv
from repro.obs import shocks as jshocks
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import env, threefry
from repro_torch.obs import shocks

LAM, MU, K = 1.2, 0.9, 10.0
RUN_KW = dict(k=K, n_events=2_500, burn_in=256, chunk_events=1_024,
              rng="slab")
TRACE = Path(__file__).parent / "data" / "spot_trace_k80.json"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs dozens of small operations an event; on one
    thread they do not wait on a pool that other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# timelines in both packages
# ---------------------------------------------------------------------------
def shock_timeline(mod):
    """tests/test_env.py's two-location storm and blackout."""
    tl = mod.inject_storm(mod.EnvTimeline.constant(), 100.0, 400.0,
                          hazard_mult=6.0)
    return mod.inject_blackout(tl, 600.0, 800.0, loc=1, n_locs=2)


def chaos_timeline(mod):
    """A storm, a blackout of location 0 and a price spike of location 1,
    one after the other (the chaos smoke's three injectors), timed so that
    a run of a few thousand events crosses all six boundaries after its
    burn-in."""
    tl = mod.inject_storm(mod.EnvTimeline.constant(), 60.0, 90.0,
                          hazard_mult=8.0)
    tl = mod.inject_blackout(tl, 110.0, 150.0, loc=0, n_locs=2)
    return mod.inject_price_spike(tl, 170.0, 210.0, price_mult=3.0, loc=1,
                                  n_locs=2)


def single_timeline(mod):
    """One location: a blackout, then a price spike."""
    tl = mod.inject_blackout(mod.EnvTimeline.constant(), 200.0, 500.0)
    return mod.inject_price_spike(tl, 700.0, 900.0, price_mult=3.0)


def markov(mod):
    regimes = (mod.Regime(mean_hold=50.0),
               mod.Regime(mean_hold=10.0, hazard_mult=5.0,
                          kind=mod.SEG_STORM))
    return mod.markov_timeline(regimes, horizon=500.0, seed=3)


def from_trace(mod):
    data = json.loads(TRACE.read_text())
    return mod.timeline_from_trace(data["times"], data["avail"])


TIMELINES = {"constant": lambda m: m.EnvTimeline.constant(),
             "shock": shock_timeline, "chaos": chaos_timeline,
             "markov": markov, "trace": from_trace}


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_timeline_params_match_jax(name):
    """The same descriptor and the same ``ep`` arrays in both packages."""
    jt, tt = TIMELINES[name](jenv), TIMELINES[name](env)
    assert dataclasses_equal(jt, tt)
    assert tt.n_segments == jt.n_segments and tt.span() == jt.span()
    for kind in range(4):
        assert tt.count(kind) == jt.count(kind)
    ja, ta = jt.params(2), tt.params(2)
    assert set(ja) == set(ta)
    for field in ja:
        a, b = np.asarray(ja[field]), ta[field].numpy()
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(b, a, err_msg=field)


def dataclasses_equal(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f)
               for f in ("t_end", "price_mult", "hazard_mult", "avail",
                         "kind"))


def test_device_helpers_match_jax_on_edges():
    """``env_row``, ``inv_avail`` and ``clock_rescale`` on edge values:
    zero, a blackout, both rates zero, and exact 1.0."""
    avail = np.array([[1.0, 0.0, 0.5, 0.25, 3e-8],
                      [0.0, 0.0, 1.0, 2.0, 1.0]], np.float32)
    seg = np.array([1, 0, 1], np.int32)
    got = env.env_row(torch.from_numpy(avail), torch.from_numpy(seg))
    want = np.stack([np.asarray(jenv.env_row(jnp.asarray(avail), s))
                     for s in seg])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        env.env_row(torch.tensor([3.0, 7.0, 3e38]), torch.tensor([2, 0]))
        .numpy(), np.float32([3e38, 3.0]))
    np.testing.assert_array_equal(
        env.inv_avail(torch.from_numpy(avail)).numpy(),
        np.asarray(jenv.inv_avail(jnp.asarray(avail))))
    assert env.inv_avail(torch.tensor([0.0])).item() == np.float32(1e15)
    old = np.array([0.0, 0.0, 2.0, 3.0, 0.7, 1e-30], np.float32)
    new = np.array([0.0, 1.5, 0.0, 3.0, 0.3, 7.0], np.float32)
    np.testing.assert_array_equal(
        env.clock_rescale(torch.from_numpy(old), torch.from_numpy(new))
        .numpy(), np.asarray(jenv.clock_rescale(jnp.asarray(old),
                                                jnp.asarray(new))))


def random_env_block(module, lead, rng):
    """An EnvWindowStats of ``lead`` shape with random counters and times,
    as numpy for the JAX module and tensors for the port's."""
    ints = [rng.integers(0, 50, lead).astype(np.int32) for _ in range(8)]
    floats = [rng.random(lead).astype(np.float32) * 100 for _ in range(2)]
    if module is jshocks:
        return jshocks.EnvWindowStats(*(jnp.asarray(x)
                                        for x in ints + floats))
    return shocks.EnvWindowStats(*(torch.from_numpy(x)
                                   for x in ints + floats))


def test_shock_counters_match_jax():
    """``env_update`` over a stream of events, ``env_merge``,
    ``env_reduce`` and ``summarize_env`` against the JAX package's."""
    rng = np.random.default_rng(21)
    n = 64
    ev = {"is_boundary": rng.random(n) < 0.3,
          "kind_prev": rng.integers(0, 4, n).astype(np.int32),
          "kind_next": rng.integers(0, 4, n).astype(np.int32),
          "dt": rng.random(n).astype(np.float32),
          "is_job": rng.random(n) < 0.5, "od_now": rng.random(n) < 0.3,
          "served": rng.random(n) < 0.4, "resumed": rng.random(n) < 0.2}
    jes = jshocks.env_zeros()
    tes = shocks.env_zeros(1, "cpu")
    for i in range(n):
        jes = jshocks.env_update(jes, **{k: jnp.asarray(v[i])
                                         for k, v in ev.items()})
        tes = shocks.env_update(tes, **{k: torch.from_numpy(v[i:i + 1])
                                        for k, v in ev.items()})
    for field, a in jes._asdict().items():
        b = getattr(tes, field)
        assert b.dtype == (torch.int32 if np.asarray(a).dtype == np.int32
                           else torch.float32), field
        np.testing.assert_array_equal(b.numpy()[0], np.asarray(a),
                                      err_msg=field)
    ja = random_env_block(jshocks, (3, 4), np.random.default_rng(5))
    jb = random_env_block(jshocks, (3, 4), np.random.default_rng(6))
    ta = random_env_block(shocks, (3, 4), np.random.default_rng(5))
    tb = random_env_block(shocks, (3, 4), np.random.default_rng(6))
    for jx, tx in ((jshocks.env_merge(ja, jb), shocks.env_merge(ta, tb)),
                   (jshocks.env_reduce(ja, 1), shocks.env_reduce(ta, 1))):
        for a, b in zip(jx, tx):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    js, ts = jshocks.summarize_env(ja), shocks.summarize_env(ta)
    assert set(js) == set(ts) == set(shocks.ENV_INT_STATS) | {
        "storm_time", "blackout_time"}
    assert_same(js, ts, js, "summarize_env")
    one = shocks.summarize_env(shocks.EnvWindowStats(*(x[0, 0] for x in ta)))
    assert isinstance(one["env_boundaries"], int)


# ---------------------------------------------------------------------------
# validation: the same errors as the JAX package (tests/test_env.py)
# ---------------------------------------------------------------------------
BAD_TIMELINES = {
    "increasing": lambda m: m.EnvTimeline(t_end=(5.0, 2.0, float("inf"))),
    "open-ended": lambda m: m.EnvTimeline(t_end=(5.0, 10.0)),
    "hazard_mult": lambda m: m.inject_storm(m.EnvTimeline.constant(), 1.0,
                                            2.0, hazard_mult=0.0),
    "price_mult": lambda m: m.inject_price_spike(m.EnvTimeline.constant(),
                                                 1.0, 2.0, price_mult=-1.0),
    "entries": lambda m: m.EnvTimeline(t_end=(1.0, float("inf")),
                                       avail=(1.0, 0.5, 0.2)),
    "finite": lambda m: m.EnvTimeline(t_end=(float("inf"),),
                                      price_mult=(float("nan"),)),
    "kind": lambda m: m.EnvTimeline(t_end=(float("inf"),), kind=(7,)),
    "t0": lambda m: m.inject_blackout(m.EnvTimeline.constant(), 3.0, 1.0),
    "n_locs": lambda m: m.inject_blackout(m.EnvTimeline.constant(), 1.0,
                                          2.0, loc=0),
    "per-loc": lambda m: m.inject_blackout(
        m.EnvTimeline.constant(), 1.0, 2.0, loc=1, n_locs=3).params(2),
}


@pytest.mark.parametrize("name", sorted(BAD_TIMELINES))
def test_timeline_errors_match_jax(name):
    """Each malformed timeline raises the JAX package's error: the same
    type and message."""
    with pytest.raises(ValueError) as want:
        BAD_TIMELINES[name](jenv)
    with pytest.raises(ValueError) as got:
        BAD_TIMELINES[name](env)
    assert str(got.value) == str(want.value)


def test_entry_points_validate_as_jax_does():
    """tests/test_env.py's entry-point checks, on the port: the env type,
    the run shape and the per-location overrides."""
    job, spot = T.Exponential(LAM), T.Exponential(MU)
    kw = dict(k=K, key=threefry.key(7), device="cpu")
    with pytest.raises(TypeError, match="EnvTimeline"):
        T.run_sim(job, spot, T.ThreePhaseKernel(), {"r": 2.0},
                  n_events=100, env={"not": "a timeline"}, **kw)
    with pytest.raises(TypeError, match="EnvTimeline"):
        T.run_sweep(job, spot, T.ThreePhaseKernel(), {"r": 2.0},
                    n_events=100, env=jenv.EnvTimeline.constant(), **kw)
    with pytest.raises(ValueError, match="n_events"):
        T.run_sim(job, spot, T.ThreePhaseKernel(), {"r": 2.0}, n_events=0,
                  **kw)
    with pytest.raises(ValueError, match="per-loc entries"):
        T.run_sim(job, spot, T.ThreePhaseKernel(), {"r": 2.0}, n_events=100,
                  env=shock_timeline(env), **kw)


# ---------------------------------------------------------------------------
# whole single-queue runs
# ---------------------------------------------------------------------------
R_GRID = np.array([0.5, 2.0, 3.5])


def run_port(tl, kernel=None, tel=None, sweep=False, **over):
    kw = {**RUN_KW, **over}
    kernel = kernel or T.ThreePhaseKernel()
    if sweep:
        return T.run_sweep(T.Exponential(LAM), T.Exponential(MU), kernel,
                           {"r": R_GRID}, key=threefry.key(7), n_seeds=2,
                           rmax=4, device="cpu", env=tl, telemetry=tel,
                           **kw)
    return T.run_sim(T.Exponential(LAM), T.Exponential(MU), kernel,
                     {"r": 2.0}, key=threefry.key(7), rmax=4, device="cpu",
                     env=tl, telemetry=tel, **kw)


def run_jax(tl, kernel=None, tel=None, sweep=False, **over):
    kw = {**RUN_KW, **over}
    kernel = kernel or R.ThreePhaseKernel()
    if sweep:
        return R.run_sweep(R.Exponential(LAM), R.Exponential(MU), kernel,
                           {"r": jnp.asarray(R_GRID)},
                           key=jax.random.key(7), n_seeds=2, rmax=4,
                           impl="xla", env=tl, telemetry=tel, **kw)
    return R.run_sim(R.Exponential(LAM), R.Exponential(MU), kernel,
                     {"r": jnp.float32(2.0)}, key=jax.random.key(7), rmax=4,
                     impl="xla", env=tl, telemetry=tel, **kw)


def assert_bitwise(ref: dict, got: dict, context: str,
                   keys=None) -> None:
    """Every key of ``ref`` (or ``keys``) bitwise in ``got``."""
    keys = ref if keys is None else keys
    assert_same(ref, got, [k for k in keys], context)


def test_constant_timeline_is_env_off():
    """``EnvTimeline.constant()`` equals ``env=None`` bitwise on the base
    keys; no boundary is crossed."""
    off = run_port(None)
    on = run_port(env.EnvTimeline.constant())
    assert set(on) - set(off) == set(shocks.ENV_INT_STATS) | {
        "storm_time", "blackout_time"}
    assert_bitwise(off, on, "constant vs off")
    assert on["env_boundaries"] == 0 and on["storm_time"] == 0.0


@pytest.mark.parametrize("sweep", [False, True], ids=["sim", "sweep"])
def test_single_queue_shock_run_matches_jax(sweep, xla_log1p):
    """A blackout and a price spike: every key bitwise JAX's, the shock
    counters included."""
    ref = run_jax(single_timeline(jenv), sweep=sweep)
    got = run_port(single_timeline(env), sweep=sweep)
    assert set(got) == set(ref)
    assert_bitwise(ref, got, "single-queue shock")
    b = np.asarray(got["env_boundaries"])
    assert (b == 4).all()
    assert (np.asarray(got["blackouts_observed"]) == 1).all()


def test_single_queue_panic_kernel_is_its_base():
    """In the single queue PanicKernel admits as its base: bitwise the
    base's, with and without a blackout."""
    base, panic = T.ThreePhaseKernel(), T.PanicKernel(T.ThreePhaseKernel())
    assert_bitwise(run_port(None, base), run_port(None, panic), "panic off")
    tl = single_timeline(env)
    assert_bitwise(run_port(tl, base), run_port(tl, panic), "panic on")


def test_single_loop_blackout_starves_spot(xla_log1p):
    """tests/test_env.py's single-loop identity: no spot serve lands in a
    blackout, whose dwell time is its length; and JAX's numbers."""
    kw = dict(n_events=4_000, burn_in=0, chunk_events=4_000)
    ref = run_jax(jenv.inject_blackout(jenv.EnvTimeline.constant(), 200.0,
                                       500.0), **kw)
    got = run_port(env.inject_blackout(env.EnvTimeline.constant(), 200.0,
                                       500.0), **kw)
    assert_bitwise(ref, got, "single blackout")
    assert got["blackouts_observed"] == 1 and got["shock_served"] == 0
    np.testing.assert_allclose(got["blackout_time"], 300.0, rtol=1e-5)


def test_single_queue_env_with_telemetry_matches_jax(xla_log1p):
    """env= with telemetry=: base, telemetry and env keys against JAX's.
    The telemetry cost sample of a spot serve stays 1.0 under the spike,
    as the JAX body has it, while cost_sum pays the spike."""
    kw = dict(trace_cap=16)
    ref = run_jax(single_timeline(jenv), tel=R.Telemetry(**kw))
    got = run_port(single_timeline(env), tel=obs.Telemetry(**kw))
    costs = [np.float32(1.0), np.float32(K)]
    run = functools.partial(lambda tel, **o: run_port(
        single_timeline(env), tel=tel, **o), chunk_events=1_024)
    assert_run_matches(ref, got, obs.Telemetry(**kw),
                       ring_samples(run, kw, costs), "single env+tel")
    off = run_port(single_timeline(env))
    assert_bitwise(off, got, "tel on vs off")
