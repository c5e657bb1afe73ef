"""The port's batched-event executor against the JAX package's, kernel level.

The JAX side builds each lane's initial state with ``init_engine_state``
(a Gamma job's first clock through ``jax.random.gamma``) and its slabs with
``_lane_slabs``, and runs them through ``batched_event_windows_ref`` with
the engine's event body, as the ``impl="ref"`` executor does.  The state
is carried into the port with :mod:`repro_torch.convert`; the port's plain
version draws the same slabs from the same lane keys.

Tolerance: integer statistics, join orders, occupancy and keys bitwise;
float32 window sums to rtol 1e-5 (see tests/_torch_parity.py); the final
clocks, ages and budgets to 1e-3 absolute (they are running differences,
see below).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
import repro.core as R
from repro.core import engine as jengine
from repro.core.waittime import DeterministicWait as JDet
from repro.core.waittime import ExponentialWait as JExpW
from repro.kernels.sweep import batched_event_windows_ref as jax_ref
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core import engine, threefry
from repro_torch.core.waittime import DeterministicWait, ExponentialWait
from repro_torch.kernels.sweep import (batched_event_windows,
                                       batched_event_windows_ref,
                                       batched_events)

LAM, MU = 1 / 12, 1 / 24

# the JAX package's ENGINE_CASES (tests/test_sweep_kernel.py), both sides
ENGINE_CASES = [
    ("three_phase",
     (R.Exponential(LAM), R.Exponential(MU), R.ThreePhaseKernel()),
     (T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel()),
     {"r": np.linspace(0.25, 4.0, 5)}),
    ("three_phase_gamma",
     (R.Gamma(12.0, 1.0), R.Exponential(MU), R.ThreePhaseKernel()),
     (T.Gamma(12.0, 1.0), T.Exponential(MU), T.ThreePhaseKernel()),
     {"r": np.linspace(0.0, 3.0, 4)}),
    ("single_slot",
     (R.Exponential(LAM), R.Uniform(0.0, 48.0),
      R.SingleSlotKernel(wait=JDet(3.0))),
     (T.Exponential(LAM), T.Uniform(0.0, 48.0),
      T.SingleSlotKernel(wait=DeterministicWait(3.0))), {}),
    ("single_slot_exp_wait",
     (R.Exponential(LAM), R.Exponential(MU),
      R.SingleSlotKernel(wait=JExpW(0.5))),
     (T.Exponential(LAM), T.Exponential(MU),
      T.SingleSlotKernel(wait=ExponentialWait(0.5))), {}),
]
IDS = [c[0] for c in ENGINE_CASES]
# burn-in, full windows and a tail window
N_SEEDS, N_EVENTS, CHUNK, BURN_IN = 3, 3_000, 1_024, 256


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _jax_windows(job, spot, kernel, rmax, plan, params, k, keys):
    state0 = jax.vmap(
        lambda key: jengine.init_engine_state(key, job, spot, rmax))(keys)
    layout = jengine._engine_layout(job, spot, kernel)
    xs = jengine._lane_slabs(state0, plan, layout)

    def step(carry, stats, p, x):
        return jengine._engine_event(job, spot, kernel, rmax, layout, carry,
                                     stats, p["params"], p["k"], x=x)

    final, stats = jax_ref(step, state0, {"params": params, "k": k},
                           jengine.WindowStats.zeros(), plan, xs=xs,
                           epilogue=jengine._rebase_order)
    return state0, final, stats


def _lanes(params):
    """Flat grid-major lanes (seed fastest), as both packages lay them out."""
    grid = max([np.size(v) for v in params.values()] + [1])
    flat = {n: np.repeat(np.asarray(v, np.float32), N_SEEDS)
            for n, v in params.items()}
    keys = np.tile(np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(7), N_SEEDS))), (grid, 1))
    return flat, np.full(grid * N_SEEDS, 10.0, np.float32), keys


@pytest.mark.parametrize("name,jcase,case,params", ENGINE_CASES, ids=IDS)
def test_plain_version_matches_jax_reference(name, jcase, case, params):
    rmax = 8 if params else 1
    plan = engine._window_plan(N_EVENTS, CHUNK, BURN_IN)
    flat, k, keys = _lanes(params)
    state0, jfinal, jstats = _jax_windows(*jcase, rmax, plan, flat, k, keys)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    s0 = convert.engine_state(np_tree(state0))
    kt = torch.from_numpy(k)
    p = convert.params(flat)
    final, stats = batched_event_windows_ref(*case, rmax, s0, p, kt, plan)
    assert stats.jobs_arrived.shape == (len(keys), len(plan))
    assert_close(np_tree(jstats), stats, engine.INT_STATS, name)
    # the JAX executor feeds pre-built slabs and leaves the lane key where it
    # was; the port advances it once per window, as the JAX scan path does
    key = jfinal.key
    for _ in plan:
        key = jax.vmap(lambda k: jax.random.split(k)[0])(key)
    jfinal = np_tree(jfinal._replace(key=key))
    for field in ("key", "occ", "order", "next_seq", "qlen"):
        np.testing.assert_array_equal(getattr(final, field).numpy(),
                                      getattr(jfinal, field), err_msg=field)
    # clocks, ages and budgets are running differences (``next - dt``):
    # their error is absolute, in ulps of the largest clock they were
    # subtracted from (~50 here, ulp ~4e-6), accumulated over the events
    # since the clock was drawn
    for field in ("next_job", "next_spot", "ages", "budgets"):
        np.testing.assert_allclose(getattr(final, field).numpy(),
                                   getattr(jfinal, field), rtol=1e-5,
                                   atol=1e-3, err_msg=field)


def test_dispatch_by_device():
    """A CPU fleet goes to the plain version; the CUDA wrapper refuses CPU
    tensors instead of falling back."""
    job, spot, kernel = T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel()
    keys = threefry.split(threefry.key(1), 4)
    s0 = engine.init_engine_state(keys, job, spot, 8)
    p, k = {"r": torch.full((4,), 2.5)}, torch.full((4,), 10.0)
    plan = (100, 37)
    a_state, a = batched_events(job, spot, kernel, 8, s0, p, k, plan)
    b_state, b = batched_event_windows_ref(job, spot, kernel, 8, s0, p, k,
                                           plan)
    for x, y in zip(a + a_state, b + b_state):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        batched_event_windows(job, spot, kernel, 8, s0, p, k, plan)
