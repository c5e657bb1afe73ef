"""The split stream (``rng="split"``) on the single queue, against the JAX
package on the CPU.

The split stream is the JAX package's default: every event splits the lane
key into the next key and a job, a spot and a policy subkey, and every draw
samples from its own subkey.  Both sides take the same keys and grids; the
JAX package runs ``impl="xla", rng="split"`` (once ``impl="pallas"`` in
interpret mode), the port its plain PyTorch version (``device="cpu"``).

Tolerance.  Under ``xla_log1p`` (tests/_torch_parity.py: the port is handed
XLA's own ``-log1p(-u)`` for every key uniform) every statistic is
bitwise, floats included, and so is the final lane key.  With each side's
own ``log1p`` the integer statistics are bitwise and the floats within
rtol 1e-5 (``pi0_time`` with an absolute floor of 1e-6: a fraction of
time near 0 is a difference of two float32 sums).  The axes
(``telemetry=``, ``env=``, ``work=``) on this stream are in
tests/test_torch_split_axes.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import RTOL, xla_log1p, xla_log1p_tables  # noqa: F401
import repro.core as R
import repro.core.arrivals as jarrivals
import repro.core.policies as jpolicies
import repro.core.waittime as jwait
from repro.core import clocks as jclocks
from repro.core import engine as jengine
from repro.core import simulator as jsimulator
from repro.kernels.sweep import batched_event_windows_ref as jax_ref
import repro_torch.core as T
import repro_torch.core.arrivals as arrivals
import repro_torch.core.policies as policies
import repro_torch.core.waittime as wait
from repro_torch import convert
from repro_torch.core import clocks, engine, threefry
from repro_torch.kernels.sweep import batched_event_windows_ref, sweep

LAM, MU, K = 1 / 12, 1 / 24, 10.0
#: a burn-in window, full chunks and a tail
RUN_KW = dict(k=K, n_events=520, chunk_events=200, burn_in=64)
KEYS = jax.random.key_data(jax.random.split(jax.random.key(11), 4_000))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs hundreds of small operations an event; on one
    thread they do not wait on a pool that other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_keys(keys=KEYS):
    return convert.key_words(np.asarray(keys))


@pytest.mark.parametrize("preempt_on,has_route",
                         [(False, False), (True, False), (False, True),
                          (True, True)], ids=["4way", "5way_pre", "5way_rt",
                                              "6way"])
def test_split_event_keys_match_jax(preempt_on, has_route):
    ref = jax.jit(jax.vmap(lambda k: jclocks.split_event_keys(
        k, preempt_on, has_route)))(KEYS)
    got = clocks.split_event_keys(port_keys(), preempt_on, has_route)
    assert len(got) == len(ref) == 6
    for name, a, b in zip(("key", "job", "spot", "pol", "pre", "rt"), ref,
                          got):
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)


ARRIVALS = [("Exponential", (1 / 12,)), ("Uniform", (0.3, 48.7)),
            ("Uniform", (0.0, 48.0)), ("Deterministic", (3.0,)),
            ("BathtubGCP", ()), ("BathtubGCP", (0.3, 2.0, 1.5, 12.0))]


@pytest.mark.parametrize("name,args", ARRIVALS,
                         ids=[f"{n}{a}" for n, a in ARRIVALS])
def test_keyed_arrival_samples_match_jax(name, args, xla_log1p):
    jproc = getattr(jarrivals, name)(*args)
    proc = getattr(arrivals, name)(*args)
    ref = np.asarray(jax.jit(jax.vmap(jproc.sample))(KEYS))
    got = proc.sample(port_keys()).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


WAITS = [("InfiniteWait", ()), ("TwoPointWait", (0.3, 20.0)),
         ("ExponentialWait", (0.37,)), ("DeterministicWait", (3.0,))]


@pytest.mark.parametrize("name,args", WAITS, ids=[w[0] for w in WAITS])
def test_keyed_wait_and_admit_match_jax(name, args, xla_log1p):
    jw, w = getattr(jwait, name)(*args), getattr(wait, name)(*args)
    lanes = KEYS.shape[0]
    # per-lane parameters, as a swept wait family carries them
    scale = np.linspace(0.5, 1.5, lanes).astype(np.float32)
    jp = {k: np.float32(v) * scale for k, v in jw.params().items()}
    p = convert.params(jp)
    ref = np.asarray(jax.jit(jax.vmap(jw.sample_from))(jp, KEYS))
    np.testing.assert_array_equal(w.sample_from(p, port_keys()).numpy(), ref)
    # the family's own parameters (a run whose params hold no "wait")
    ref = np.asarray(jax.jit(jax.vmap(jw.sample))(KEYS))
    np.testing.assert_array_equal(w.sample(port_keys()).numpy(), ref)

    qlen = np.random.default_rng(3).integers(0, 3, lanes).astype(np.int32)
    jk = jpolicies.SingleSlotKernel(wait=jw)
    k = policies.SingleSlotKernel(wait=w)
    for jparams, params in (({"wait": jp}, {"wait": p}), ({}, {})):
        ja, jb = jax.jit(jax.vmap(jk.admit))(jparams, qlen, KEYS)
        a, b = k.admit(params, torch.from_numpy(qlen), port_keys())
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(
            np.broadcast_to(b.numpy(), (lanes,)),
            np.broadcast_to(np.asarray(jb), (lanes,)))


def test_three_phase_keyed_admit_matches_jax():
    lanes = KEYS.shape[0]
    rng = np.random.default_rng(5)
    r = rng.choice(np.linspace(0.0, 6.0, 25), lanes).astype(np.float32)
    qlen = rng.integers(0, 8, lanes).astype(np.int32)
    jk, k = jpolicies.ThreePhaseKernel(), policies.ThreePhaseKernel()
    ja, jb = jax.jit(jax.vmap(jk.admit))({"r": r}, qlen, KEYS)
    a, b = k.admit({"r": torch.from_numpy(r)}, torch.from_numpy(qlen),
                   port_keys())
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert 0 < a.sum() < lanes
    assert np.float32(b) == np.asarray(jb)[0]


# (name, JAX (job, spot, kernel), port (job, spot, kernel), params, rmax)
SWEEP_CASES = [
    ("three_phase_rmax64",
     (R.Exponential(LAM), R.Exponential(MU), R.ThreePhaseKernel()),
     (T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel()),
     {"r": np.linspace(0.5, 60.0, 4)}, 64),
    ("single_slot_infinite",
     (R.Exponential(LAM), R.Exponential(MU),
      R.SingleSlotKernel(wait=R.InfiniteWait())),
     (T.Exponential(LAM), T.Exponential(MU),
      T.SingleSlotKernel(wait=T.InfiniteWait())), {}, 1),
    ("single_slot_two_point",
     (R.Deterministic(12.0), R.Uniform(0.3, 48.7),
      R.SingleSlotKernel(wait=R.TwoPointWait(0.3, 20.0))),
     (T.Deterministic(12.0), T.Uniform(0.3, 48.7),
      T.SingleSlotKernel(wait=T.TwoPointWait(0.3, 20.0))), {}, 1),
    ("single_slot_exp_wait_swept",
     (R.Exponential(LAM), R.BathtubGCP(),
      R.SingleSlotKernel(wait=R.ExponentialWait(0.37))),
     (T.Exponential(LAM), T.BathtubGCP(),
      T.SingleSlotKernel(wait=T.ExponentialWait(0.37))),
     {"wait": {"rate": np.array([0.1, 0.37, 2.5])}}, 1),
    ("single_slot_deterministic_swept",
     (R.Exponential(LAM), R.Uniform(0.0, 48.0),
      R.SingleSlotKernel(wait=R.DeterministicWait(3.0))),
     (T.Exponential(LAM), T.Uniform(0.0, 48.0),
      T.SingleSlotKernel(wait=T.DeterministicWait(3.0))),
     {"wait": {"value": np.array([0.0, 2.0, 9.0])}}, 1),
]
SWEEP_IDS = [c[0] for c in SWEEP_CASES]


def jax_sweep(jcase, params, rmax, seed=7, impl="xla", **kw):
    return R.run_sweep(*jcase, jax.tree.map(jnp.asarray, params), impl=impl,
                       rng="split", key=jax.random.key(seed), n_seeds=2,
                       rmax=rmax, **{**RUN_KW, **kw})


def port_sweep(case, params, rmax, seed=7, **kw):
    return T.run_sweep(*case, params, rng="split", key=threefry.key(seed),
                       n_seeds=2, rmax=rmax, device="cpu",
                       **{**RUN_KW, **kw})


def assert_bitwise(ref, got, context):
    assert set(got) == set(ref), context
    for name, a in ref.items():
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(a),
                                      err_msg=f"{name} ({context})")


def assert_tolerance(ref, got, context):
    """Integers bitwise, floats to RTOL (``pi0_time`` with an absolute
    floor of 1e-6)."""
    assert set(got) == set(ref), context
    for name, a in ref.items():
        a, b = np.asarray(a), np.asarray(got[name])
        if name in engine.INT_STATS:
            np.testing.assert_array_equal(b, a, err_msg=f"{name} ({context})")
        else:
            np.testing.assert_allclose(
                b, a, rtol=RTOL, atol=1e-6 if name == "pi0_time" else 0,
                err_msg=f"{name} ({context})")


@pytest.mark.parametrize("name,jcase,case,params,rmax", SWEEP_CASES,
                         ids=SWEEP_IDS)
def test_run_sweep_split_matches_jax_bitwise(name, jcase, case, params, rmax,
                                             xla_log1p):
    ref = jax_sweep(jcase, params, rmax)
    got = port_sweep(case, params, rmax)
    grid = np.broadcast_shapes(*(np.shape(v)
                                 for v in jax.tree.leaves(params)))
    assert got["avg_cost"].shape == grid + (2,)
    assert_bitwise(ref, got, name)


def test_run_sweep_split_with_own_log1p():
    """Each side's own ``log1p``: integers bitwise, floats to RTOL."""
    name, jcase, case, params, rmax = SWEEP_CASES[3]
    assert_tolerance(jax_sweep(jcase, params, rmax, seed=3),
                     port_sweep(case, params, rmax, seed=3), name)


def test_run_sim_split_matches_jax(xla_log1p):
    kw = dict(k=K, n_events=900, rmax=16, chunk_events=300, burn_in=64)
    ref = R.run_sim(R.Exponential(LAM), R.Exponential(MU),
                    R.ThreePhaseKernel(), {"r": jnp.float32(2.5)},
                    key=jax.random.key(3), rng="split", **kw)
    got = T.run_sim(T.Exponential(LAM), T.Exponential(MU),
                    T.ThreePhaseKernel(), {"r": 2.5}, key=threefry.key(3),
                    rng="split", device="cpu", **kw)
    assert all(isinstance(v, float) for v in got.values())
    assert_bitwise(ref, got, "run_sim")


def test_pallas_interpret_fleet_matches(xla_log1p):
    """One small fleet against the JAX package's Pallas kernel in interpret
    mode, which walks the same ladder inside the kernel."""
    _, jcase, case, _, _ = SWEEP_CASES[0]
    params = {"r": np.array([1.5, 4.0])}
    kw = dict(n_events=300, chunk_events=128, burn_in=40)
    ref = jax_sweep(jcase, params, 8, impl="pallas", interpret=True, **kw)
    got = port_sweep(case, params, 8, **kw)
    assert_bitwise(ref, got, "pallas interpret")


@pytest.mark.parametrize("name,jcase,case,params,rmax",
                         [SWEEP_CASES[0], SWEEP_CASES[3]],
                         ids=[SWEEP_IDS[0], SWEEP_IDS[3]])
def test_final_lane_key_and_state_match_jax(name, jcase, case, params, rmax,
                                            xla_log1p):
    """The executor level: the JAX package's kernel reference on the split
    step (``layout=None``) and the port's plain version, from the same
    lane states; the final lane key (advanced once an event, across the
    windows) and the whole final state bitwise."""
    plan = engine._window_plan(400, 150, 50)
    lanes = 6
    keys = KEYS[:lanes]
    jjob, jspot, jkernel = jcase
    flat = {n: (np.resize(np.float32(v), lanes) if not isinstance(v, dict)
                else {m: np.resize(np.float32(x), lanes)
                      for m, x in v.items()})
            for n, v in params.items()}
    k = np.full(lanes, K, np.float32)

    @jax.jit
    def run(p, kc, keys):
        state0 = jax.vmap(lambda key: jengine.init_engine_state(
            key, jjob, jspot, rmax))(keys)

        def step(carry, stats, pp):
            return jengine._engine_event(jjob, jspot, jkernel, rmax, None,
                                         carry, stats, pp["params"],
                                         pp["k"])

        final, stats = jax_ref(step, state0, {"params": p, "k": kc},
                               jengine.WindowStats.zeros(), plan,
                               epilogue=jengine._rebase_order)
        return state0, final, stats

    state0, jfinal, jstats = jax.tree.map(np.asarray, run(flat, k, keys))
    s0 = convert.engine_state(state0)
    kt = torch.from_numpy(k)
    p = convert.params(flat)
    final, stats = batched_event_windows_ref(*case, rmax, s0, p, kt, plan,
                                             rng="split")
    for field in engine.WindowStats._fields:
        np.testing.assert_array_equal(getattr(stats, field).numpy(),
                                      getattr(jstats, field), err_msg=field)
    for field in engine.EngineState._fields:
        np.testing.assert_array_equal(getattr(final, field).numpy(),
                                      getattr(jfinal, field).astype(
                                          getattr(final, field).numpy().dtype),
                                      err_msg=field)
    # the key went one step down the ladder an event, windows ignored
    key = s0.key
    for _ in range(sum(plan)):
        key = threefry.split(key, 4)[:, 0]
    assert torch.equal(final.key, key)


def test_seed_wrappers_match_jax(xla_log1p):
    kw = dict(k=K, n_events=450, chunk_events=200)
    ref = jsimulator.run_queue_sim(R.Exponential(LAM), R.Exponential(MU),
                                   r=2.5, key=jax.random.key(5), rmax=8,
                                   burn_in=50, **kw)
    got = T.run_queue_sim(T.Exponential(LAM), T.Exponential(MU), r=2.5,
                          key=threefry.key(5), rmax=8, burn_in=50,
                          device="cpu", **kw)
    assert_bitwise(ref, got, "run_queue_sim")
    ref = jsimulator.run_single_slot_sim(
        R.Exponential(LAM), R.Uniform(0.0, 48.0), R.ExponentialWait(0.37),
        key=jax.random.key(6), **kw)
    got = T.run_single_slot_sim(
        T.Exponential(LAM), T.Uniform(0.0, 48.0), T.ExponentialWait(0.37),
        key=threefry.key(6), device="cpu", **kw)
    assert_bitwise(ref, got, "run_single_slot_sim")


def test_int_stats_invariant_to_chunk_events():
    """The ladder advances once an event whatever the windows, so the
    integer statistics do not depend on ``chunk_events`` (on the slab
    stream the window plan picks the random numbers)."""
    _, _, case, params, rmax = SWEEP_CASES[0]
    runs = [T.run_sweep(*case, params, rng="split", key=threefry.key(9),
                        n_seeds=2, rmax=rmax, k=K, n_events=400,
                        chunk_events=chunk, device="cpu")
            for chunk in (None, 150, 64)]
    for other in runs[1:]:
        for name in engine.INT_STATS:
            np.testing.assert_array_equal(other[name], runs[0][name],
                                          err_msg=name)
        np.testing.assert_allclose(other["avg_cost"], runs[0]["avg_cost"],
                                   rtol=RTOL)


def test_named_refusals():
    job, spot = T.Exponential(LAM), T.Exponential(MU)
    kw = dict(n_events=50, key=threefry.key(0), device="cpu", rng="split")
    # Gamma: its keyed sampler needs jax.random.gamma's rejection loop
    for run in (T.run_sim, T.run_sweep):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            run(T.Gamma(12.0, 1.0), spot, T.ThreePhaseKernel(), {"r": 1.0},
                **kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        T.run_queue_sim(T.Gamma(2.5, 1.0), spot, r=1.0, n_events=50,
                        key=threefry.key(0), device="cpu")
    with pytest.raises(NotImplementedError, match="rejection sampler"):
        T.Gamma(2.5, 1.0).sample(threefry.key(0))
    # the regions: their 6-way ladder is not ported (the market's 5-way
    # one is: tests/test_torch_split_market.py)
    topo = T.RegionTopology.single(job, spot, rmax=4)
    for call in (
            lambda: T.run_region_sim(topo, T.ThreePhaseKernel(), {"r": 1.0},
                                     **kw),
            lambda: T.run_region_sweep(topo, T.ThreePhaseKernel(),
                                       {"r": 1.0}, **kw)):
        with pytest.raises(NotImplementedError,
                           match=r"regions \(ROADMAP.md Queue 1 item 7\)"):
            call()
    # a kernel without the keyed hook cannot run the split stream
    with pytest.raises(T.NoAdmitHookError, match="keyed hook"):
        T.run_sweep(job, spot, T.NoticeAwareKernel(0.05), {"r": 1.0}, **kw)


class KeyedOnly:
    """A user's kernel with only the keyed hook: admit while the queue is
    shorter than 3, with probability 0.7."""

    def admit(self, params, qlen, key):
        return (qlen < 3) & (threefry.uniform(key) < 0.7), engine.INF


def test_keyed_only_kernel_runs_on_the_cpu_and_the_card_refuses_it():
    """On the CPU the plain version runs a kernel with only the keyed hook
    (and the slab stream refuses it by name); the CUDA wrapper checks the
    kernel's policy before any tensor and raises a named error: it does not
    fall back to the plain version."""
    job, spot = T.Exponential(LAM), T.Exponential(MU)
    out = T.run_sweep(job, spot, KeyedOnly(), {}, n_events=300, n_seeds=2,
                      rmax=8, key=threefry.key(1), device="cpu", rng="split")
    assert np.all(out["ondemand"] > 0) and np.all(out["spot_served"] > 0)
    with pytest.raises(T.NoAdmitHookError, match="slab hook"):
        T.run_sweep(job, spot, KeyedOnly(), {}, n_events=50, rmax=8,
                    key=threefry.key(1), device="cpu")
    keys = threefry.split(threefry.key(1), 4)
    s0 = engine.init_engine_state(keys, job, spot, 8)
    k = torch.full((4,), K)
    with pytest.raises(sweep.NoKernelPolicyError, match="KeyedOnly"):
        sweep.batched_event_windows(job, spot, KeyedOnly(), 8, s0, {}, k,
                                    (64,), rng="split")
    # a policy the kernel holds gets as far as the device check
    with pytest.raises(ValueError, match="CUDA tensor"):
        sweep.batched_event_windows(job, spot, T.ThreePhaseKernel(), 8, s0,
                                    {"r": torch.full((4,), 2.0)}, k, (64,),
                                    rng="split")


def test_unswept_wait_samples_at_its_constants():
    """A single-slot kernel's params without ``"wait"`` (an unswept wait)
    sample at the family's constants, now on either stream (the slab
    stream's repair: tests/test_torch_split_market.py holds it against the
    JAX package): the plain version multiplies a unit exponential by the
    float32 reciprocal of the rate, and the wrapper's policy code asks the
    kernel for the same product."""
    job, spot = T.Exponential(LAM), T.Exponential(MU)
    kernel = T.SingleSlotKernel(wait=T.ExponentialWait(0.37))
    s0 = engine.init_engine_state(threefry.split(threefry.key(1), 4), job,
                                  spot, 1)
    for rng in ("slab", "split"):
        _, stats = batched_event_windows_ref(job, spot, kernel, 1, s0, {},
                                             torch.full((4,), K), (16,),
                                             rng=rng)
        assert stats.jobs_arrived.sum() > 0
    u = torch.tensor([[0.25], [0.5]])
    np.testing.assert_array_equal(
        kernel.wait.sample_u(u).numpy(),
        (clocks.exp_from_u(u[:, 0]) * (1 / np.float32(0.37))).numpy())
    policy, code, pa, _ = sweep._policy(kernel, {}, 4, "cpu")
    assert (policy, code) == (1, sweep._FIXED_EXPONENTIAL_WAIT)
    np.testing.assert_array_equal(pa.numpy(),
                                  np.full(4, 1 / np.float32(0.37), np.float32))
