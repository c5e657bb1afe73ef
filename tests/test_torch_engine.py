"""The port's run_sweep / run_sim against the JAX package's, end to end.

Both sides take the same seed key and the same grids; the JAX package runs
``impl="ref", rng="slab"`` on the CPU, the port its plain PyTorch version
(``device="cpu"``).  Configurations: the JAX package's ENGINE_CASES
(tests/test_sweep_kernel.py) whose initial clocks the port can draw, with a
burn-in window, full windows and a tail window, at rmax 8 and 1.

Tolerance: integer event counts bitwise; float statistics to rtol 1e-5
(see tests/_torch_parity.py).
"""
import jax
import jax.numpy as jnp
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
from repro_torch.core import engine, threefry
from repro_torch.core.waittime import DeterministicWait, ExponentialWait
from repro_torch.kernels.sweep import batched_event_windows_ref

LAM, MU = 1 / 12, 1 / 24
K = 10.0

CASES = [
    ("three_phase",
     (R.Exponential(LAM), R.Exponential(MU), R.ThreePhaseKernel()),
     (T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel()),
     {"r": np.linspace(0.25, 4.0, 5)}),
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
    ("swept_wait",
     (R.Exponential(LAM), R.Exponential(MU),
      R.SingleSlotKernel(wait=JDet(3.0))),
     (T.Exponential(LAM), T.Exponential(MU),
      T.SingleSlotKernel(wait=DeterministicWait(3.0))),
     {"wait": {"value": np.array([0.0, 2.0, 9.0])}}),
]


@pytest.mark.parametrize("name,jcase,case,params", CASES,
                         ids=[c[0] for c in CASES])
def test_run_sweep_matches_jax(name, jcase, case, params):
    kw = dict(k=K, n_events=3_000, n_seeds=3, rmax=8 if "r" in params else 1,
              chunk_events=1_024, burn_in=256)
    jparams = jax.tree.map(jnp.asarray, params)
    ref = R.run_sweep(*jcase, jparams, impl="ref", rng="slab",
                      key=jax.random.key(7), **kw)
    got = T.run_sweep(*case, params, key=threefry.key(7), device="cpu", **kw)
    assert set(got) == set(ref)
    for v in got.values():
        assert v.shape == np.asarray(ref["avg_cost"]).shape
    assert_close(ref, got, engine.INT_STATS, name)


def test_run_sweep_k_grid_broadcast_matches_jax():
    """params and k broadcast to one (r × k) grid, lanes grid-major."""
    kw = dict(n_events=1_500, n_seeds=2, rmax=8, chunk_events=1_024)
    r, k = np.linspace(0.5, 3.0, 3)[:, None], np.array([[2.0, 20.0]])
    ref = R.run_sweep(R.Exponential(LAM), R.Exponential(MU),
                      R.ThreePhaseKernel(), {"r": jnp.asarray(r)},
                      k=jnp.asarray(k), impl="ref", rng="slab",
                      key=jax.random.key(5), **kw)
    got = T.run_sweep(T.Exponential(LAM), T.Exponential(MU),
                      T.ThreePhaseKernel(), {"r": r}, k=k,
                      key=threefry.key(5), device="cpu", **kw)
    assert got["avg_cost"].shape == (3, 2, 2)
    assert_close(ref, got, engine.INT_STATS, "k grid")


def test_run_sim_matches_jax():
    kw = dict(k=K, n_events=4_000, rmax=16, chunk_events=1_024)
    ref = R.run_sim(R.Exponential(LAM), R.Exponential(MU),
                    R.ThreePhaseKernel(), {"r": jnp.float32(2.5)},
                    key=jax.random.key(3), impl="ref", rng="slab", **kw)
    got = T.run_sim(T.Exponential(LAM), T.Exponential(MU),
                    T.ThreePhaseKernel(), {"r": 2.5}, key=threefry.key(3),
                    device="cpu", **kw)
    assert all(isinstance(v, float) for v in got.values())
    assert_close(ref, got, engine.INT_STATS, "run_sim")


def test_order_rebase_prevents_int32_wrap():
    """The join order starts a hair below INT32_MAX: the per-window rebase
    keeps the run bitwise the zero start (and the JAX package's run from
    the same shifted state), with next_seq bounded by window + rmax."""
    job, spot, kernel = T.Exponential(1.0), T.Exponential(1.0), T.ThreePhaseKernel()
    jjob, jspot, jkernel = R.Exponential(1.0), R.Exponential(1.0), R.ThreePhaseKernel()
    rmax, chunk, n_events, lanes = 8, 128, 1_200, 2
    plan = engine._window_plan(n_events, chunk, 0)
    offset = 2**31 - 10_000
    keys = threefry.split(threefry.key(2), lanes)
    p, k = {"r": torch.full((lanes,), 6.0)}, torch.full((lanes,), K)
    s_lo = engine.init_engine_state(keys, job, spot, rmax)
    s_hi = s_lo._replace(next_seq=s_lo.next_seq + offset)
    fin_lo, st_lo = batched_event_windows_ref(job, spot, kernel, rmax, s_lo,
                                              p, k, plan)
    fin_hi, st_hi = batched_event_windows_ref(job, spot, kernel, rmax, s_hi,
                                              p, k, plan)
    for a, b in zip(st_lo, st_hi):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(fin_hi.next_seq.max()) <= chunk + rmax
    assert int(fin_lo.next_seq.max()) <= chunk + rmax

    layout = jengine._engine_layout(jjob, jspot, jkernel)
    jkeys = jnp.asarray(keys.numpy().astype(np.uint32))

    @jax.jit
    def jax_run(offset):
        state = jax.vmap(lambda key: jengine.init_engine_state(
            key, jjob, jspot, rmax))(jkeys)
        xs = jengine._lane_slabs(state, plan, layout)
        state = state._replace(next_seq=state.next_seq + offset)

        def step(carry, stats, p, x):
            return jengine._engine_event(jjob, jspot, jkernel, rmax, layout,
                                         carry, stats, p["params"], p["k"],
                                         x=x)

        return jax_ref(step, state,
                       {"params": {"r": jnp.full((lanes,), 6.0)},
                        "k": jnp.full((lanes,), K, jnp.float32)},
                       jengine.WindowStats.zeros(), plan, xs=xs,
                       epilogue=jengine._rebase_order)[1]

    ref = jax.tree.map(np.asarray, jax_run(jnp.int32(offset)))
    assert_close(ref, st_hi, engine.INT_STATS, "rebase")


def _sweep_args():
    return (T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel(),
            {"r": 1.0})


@pytest.mark.parametrize("kwargs,error,match", [
    # rng="split" runs on the single queue (tests/test_torch_split.py)
    ({"shard": "lanes", "device": "cpu"}, NotImplementedError,
     "Queue 1 item 12"),
    ({"impl": "cuda", "device": "cpu"}, ValueError, "needs a CUDA device"),
    ({"impl": "pallas", "device": "cpu"}, ValueError, "unknown impl"),
    ({"impl": "xla", "device": "cpu"}, ValueError, "unknown impl"),
    # the plain version runs only on the CPU; on any other device the device
    # picks the kernel, so "ref" there is a contradiction, not a switch
    ({"impl": "ref", "device": "meta"}, ValueError, "runs on the CPU"),
    ({"rng": "fast", "device": "cpu"}, ValueError, "unknown rng"),
])
def test_named_errors(kwargs, error, match):
    with pytest.raises(error, match=match):
        T.run_sweep(*_sweep_args(), n_events=64, key=threefry.key(0),
                    **kwargs)


def test_gamma_process_raises_named_error():
    for job, spot in ((T.Gamma(12.0, 1.0), T.Exponential(MU)),
                      (T.Exponential(LAM), T.Gamma(2.0, 12.0))):
        with pytest.raises(NotImplementedError, match="rejection sampler"):
            T.run_sweep(job, spot, T.ThreePhaseKernel(), {"r": 1.0},
                        n_events=64, key=threefry.key(0), device="cpu")


def test_no_gpu_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (T.run_sweep, T.run_sim):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(*_sweep_args(), n_events=64, key=threefry.key(0))
