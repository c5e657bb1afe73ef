"""The split stream (``rng="split"``) with the single queue's axes, against
the JAX package on the CPU: ``telemetry=``, ``env=`` (a timeline with a
blackout and a price spike) and ``work=`` (each checkpoint mode, with and
without ``CantBeLateKernel``'s safety net), alone and together.  The
three-phase loop and the single-slot loop with an exponential wait budget
(the family's own rate, or swept) run each axis.

Both sides take the same keys; the JAX package runs ``impl="xla",
rng="split"``, the port its plain PyTorch version (``device="cpu"``), under
``xla_log1p`` (tests/_torch_parity.py), so every statistic is bitwise: the
base keys, the telemetry counters and rings, the shock counters and the
survival ledger.  The histograms are bitwise too, or apart only by samples
that XLA's and PyTorch's ``log`` bin on the two sides of an edge
(tests/test_torch_telemetry.py::assert_hists replays them from a full
ring).  Each axis in its neutral setting (telemetry on, the constant
timeline, ``WorkModel()``) leaves the base keys bitwise the run without
it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import xla_log1p, xla_log1p_tables  # noqa: F401
from test_torch_telemetry import assert_run_matches, assert_same, ring_samples
from test_torch_work import kernels, models, tight
import repro.core as R
from repro.core import env as jenv
from repro.core import work as jwork
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import env, threefry, work

LAM, MU, K = 1.2, 0.9, 10.0
RUN_KW = dict(k=K, n_events=450, burn_in=50, chunk_events=200, rng="split")
R_GRID = np.array([0.5, 2.0, 3.5])
TEL = dict(trace_cap=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs hundreds of small operations an event; on one
    thread they do not wait on a pool that other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def shock_timeline(mod):
    """A blackout and then a price spike, both inside the runs' ~240 h."""
    tl = mod.inject_blackout(mod.EnvTimeline.constant(), 40.0, 90.0)
    return mod.inject_price_spike(tl, 120.0, 170.0, price_mult=3.0)


#: the loop's base kernel, its params on the single run and on the sweep,
#: and its rmax: three-phase at rmax 4, and single-slot with a drawing wait
#: (an exponential budget at the family's own rate on the single run, swept
#: on the sweep), where env rescales the fresh spot draw and the budget
#: races the segment
LOOPS = {"three_phase": (lambda m: m.ThreePhaseKernel(), {"r": 2.0},
                         {"r": R_GRID}, 4),
         "single_slot": (lambda m: m.SingleSlotKernel(
             wait=m.ExponentialWait(0.37)), {},
             {"wait": {"rate": np.array([0.1, 0.37, 2.5])}}, 1)}


def loop_kernel(mod, loop, net=False):
    """The loop's kernel of package ``mod``, wrapped in the safety net where
    ``net``."""
    kernel = LOOPS[loop][0](mod)
    return mod.CantBeLateKernel(kernel, slack_buffer=0.2) if net else kernel


def run_port(tl=None, kernel=None, tel=None, sweep=False, loop="three_phase",
             **over):
    kw = {**RUN_KW, **over}
    _, sim_p, sweep_p, rmax = LOOPS[loop]
    kernel = kernel or loop_kernel(T, loop)
    if sweep:
        return T.run_sweep(T.Exponential(LAM), T.Exponential(MU), kernel,
                           sweep_p, key=threefry.key(7), n_seeds=2,
                           rmax=rmax, device="cpu", env=tl, telemetry=tel,
                           **kw)
    return T.run_sim(T.Exponential(LAM), T.Exponential(MU), kernel, sim_p,
                     key=threefry.key(7), rmax=rmax, device="cpu", env=tl,
                     telemetry=tel, **kw)


def run_jax(tl=None, kernel=None, tel=None, sweep=False, loop="three_phase",
            **over):
    kw = {**RUN_KW, **over}
    _, sim_p, sweep_p, rmax = LOOPS[loop]
    kernel = kernel or loop_kernel(R, loop)
    if sweep:
        return R.run_sweep(R.Exponential(LAM), R.Exponential(MU), kernel,
                           jax.tree.map(jnp.asarray, sweep_p),
                           key=jax.random.key(7), n_seeds=2, rmax=rmax,
                           impl="xla", env=tl, telemetry=tel, **kw)
    return R.run_sim(R.Exponential(LAM), R.Exponential(MU), kernel,
                     jax.tree.map(jnp.float32, sim_p), key=jax.random.key(7),
                     rmax=rmax, impl="xla", env=tl, telemetry=tel, **kw)


def samples(**run_kw):
    """:func:`ring_samples` of the port's run with ``run_kw``."""
    run = functools.partial(lambda tel, **o: run_port(tel=tel, **o),
                            chunk_events=RUN_KW["chunk_events"], **run_kw)
    return ring_samples(run, TEL, [np.float32(1.0), np.float32(K)])


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("sweep", [False, True], ids=["sim", "sweep"])
def test_split_telemetry_matches_jax(sweep, loop, xla_log1p):
    ref = run_jax(tel=R.Telemetry(**TEL), sweep=sweep, loop=loop)
    got = run_port(tel=obs.Telemetry(**TEL), sweep=sweep, loop=loop)
    assert_run_matches(ref, got, obs.Telemetry(**TEL),
                       samples(sweep=sweep, loop=loop),
                       f"split telemetry, {loop}")
    off = run_port(sweep=sweep, loop=loop)
    assert set(off) < set(got)
    assert_same(off, got, off, "telemetry on vs off")


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("sweep", [False, True], ids=["sim", "sweep"])
def test_split_env_matches_jax(sweep, loop, xla_log1p):
    ref = run_jax(shock_timeline(jenv), sweep=sweep, loop=loop)
    got = run_port(shock_timeline(env), sweep=sweep, loop=loop)
    assert set(got) == set(ref)
    assert_same(ref, got, ref, f"split env, {loop}")
    assert (np.asarray(got["env_boundaries"]) == 4).all()
    assert (np.asarray(got["blackouts_observed"]) == 1).all()
    # the constant timeline is the run without one, on the base keys
    off = run_port(sweep=sweep, loop=loop)
    assert_same(off, run_port(env.EnvTimeline.constant(), sweep=sweep,
                              loop=loop), off, "constant timeline vs off")


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("net", [False, True], ids=["base", "safety_net"])
@pytest.mark.parametrize("mode", ["never", "notice", "periodic"])
def test_split_work_matches_jax(mode, net, loop, xla_log1p):
    ref = run_jax(kernel=loop_kernel(R, loop, net), loop=loop,
                  work=models(jwork)[mode])
    got = run_port(kernel=loop_kernel(T, loop, net), loop=loop,
                   work=models(work)[mode])
    assert set(got) == set(ref)
    assert_same(ref, got, ref, f"split work {mode}, {loop}")
    assert got["jobs_admitted"] > 0
    assert (got["checkpoints_taken"] > 0) == (mode == "periodic")
    assert got["jobs_ontime"] + got["deadline_misses"] == got["jobs_finished"]


def test_split_identity_work_model_is_work_off():
    off = run_port(sweep=True)
    on = run_port(sweep=True, work=work.WorkModel())
    assert_same(off, on, off, "identity vs off")
    assert np.all(on["deadline_misses"] == 0)


def test_split_safety_net_with_env_and_telemetry_matches_jax(xla_log1p):
    """All three axes at once, under a deadline the base kernel misses: the
    safety net panics and every key is JAX's."""
    base = run_jax(kernel=kernels(False)[0], sweep=True, work=tight(jwork))
    assert np.asarray(base["deadline_misses"]).sum() > 0
    jk, tk = kernels(True)
    ref = run_jax(shock_timeline(jenv), jk, R.Telemetry(**TEL), sweep=True,
                  work=tight(jwork))
    got = run_port(shock_timeline(env), tk, obs.Telemetry(**TEL), sweep=True,
                   work=tight(work))
    assert_run_matches(ref, got, obs.Telemetry(**TEL),
                       samples(tl=shock_timeline(env), kernel=tk, sweep=True,
                               work=tight(work)), "split, all axes")
    assert np.asarray(got["panic_entries"]).sum() > 0
