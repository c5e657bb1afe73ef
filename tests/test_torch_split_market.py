"""The split stream (``rng="split"``) on the P-pool market, against the JAX
package on the CPU.

On the split stream every market event splits the lane key into the next
key and the job, spot and policy subkeys, and, where a pool has a hazard,
the preemption subkey; the keyed hooks (``admit_market``, ``on_preempt``)
decide, the fresh spot clocks are tag-folded draws under the spot subkey
and the preemption clocks a per-pool vector whose earliest fires, the
firing pool's refreshed from a tag-folded draw under the preemption
subkey.  Both sides take the same keys, markets and grids; the JAX package
runs ``impl="xla", rng="split"`` (once ``impl="pallas"`` in interpret
mode), the port its plain PyTorch version (``device="cpu"``).

Tolerance.  Under ``xla_log1p`` (tests/_torch_parity.py: the port is handed
XLA's own ``-log1p(-u)`` for every key uniform and XLA's own Gumbel draws)
every statistic is bitwise, floats included, and so are the final state,
the ``(P,)`` preemption clocks among it, and the final lane key.  The axes
(``telemetry=``, ``env=``, ``work=``) on this stream are in
tests/test_torch_split_market_axes.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import xla_log1p, xla_log1p_tables  # noqa: F401
from test_torch_split import KEYS, one_torch_thread, port_keys  # noqa: F401
import repro.core as R
from repro.core import engine as jengine
from repro.core import market as jmarket
from repro.kernels.sweep import batched_event_windows_ref as jax_ref
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core import engine, market, threefry
from repro_torch.kernels.sweep import market_event_windows_ref, sweep

LAM, MU, K = 1 / 12, 1 / 24, 10.0
#: two full chunks (burn-in and a tail: test_run_market_sim_split_matches_jax)
RUN_KW = dict(k=K, n_events=250, chunk_events=125, burn_in=0, rng="split")


def pools(mod, mkt, prices, hazards, notices, tags=None):
    """A market of Exponential(μ/P) pools in package ``mod``."""
    n = len(prices)
    tags = tags or (None,) * n
    return mkt.SpotMarket(pools=tuple(
        mkt.SpotPool(mod.Exponential(MU / n), price=p, hazard=h, notice=w,
                     tag=t)
        for p, h, w, t in zip(prices, hazards, notices, tags)))


def both(prices, hazards, notices, tags=None):
    return (pools(R, jmarket, prices, hazards, notices, tags),
            pools(T, market, prices, hazards, notices, tags))


HETERO = ((0.5, 0.3, 0.2, 0.1), (0.02, 0.05, 0.0, 0.10),
          (0.5, 0.01, 0.0, 2.0))
CALM = ((0.5, 0.3, 0.2, 0.1), (0.0,) * 4, (0.0,) * 4)
EIGHT = (tuple(np.linspace(0.9, 0.2, 8)), (0.03, 0.0, 0.05, 0.01, 0.0, 0.08,
                                           0.02, 0.04),
         (0.5, 0.0, 0.01, 2.0, 0.1, 0.02, 0.3, 0.05))


def notice(choice="cheapest"):
    return (jmarket.NoticeAwareKernel(0.05, choice),
            market.NoticeAwareKernel(0.05, choice))


def pool_choice(base, choice):
    """PoolChoiceKernel over ``base(mod)`` in both packages."""
    return (jmarket.PoolChoiceKernel(base(R), choice),
            market.PoolChoiceKernel(base(T), choice))


def exp_wait(mod):
    """A single-slot kernel with an unswept exponential wait at rate 1/3
    (whose float32 reciprocal is not exact)."""
    return mod.SingleSlotKernel(wait=mod.ExponentialWait(1 / 3))


R4 = {"r": np.linspace(0.5, 4.0, 3)}
#: (name, markets, kernels, params, rmax): every P the kernel's tests run,
#: preemption on and off, four of the rules (cheapest:
#: test_run_market_sim_split_matches_jax), both market kernels, a legacy
#: kernel, the single-slot base with an exponential wait
CASES = [
    ("p1_degenerate_legacy", both((1.0,), (0.0,), (0.0,)),
     (R.ThreePhaseKernel(), T.ThreePhaseKernel()), R4, 8),
    ("p1_preempt_notice", both((0.4,), (0.05,), (0.3,)), notice(), R4, 8),
    ("p2_exp_wait_fastest", both((1.0, 0.4), (0.0, 0.0), (0.0, 0.3)),
     pool_choice(exp_wait, "fastest"), {}, 1),
    ("p2_preempt_least_loaded", both((1.0, 0.4), (0.02, 0.08), (0.0, 0.3)),
     pool_choice(lambda m: m.ThreePhaseKernel(), "least_loaded"), R4, 8),
    ("p4_calm_weighted", both(*CALM),
     pool_choice(lambda m: m.ThreePhaseKernel(), "weighted"),
     {"r": np.linspace(0.5, 4.0, 3), "pool_logits": 0.25}, 16),
    ("p4_legacy_three_phase", both(*HETERO),
     (R.ThreePhaseKernel(), T.ThreePhaseKernel()), R4, 16),
    ("p8_notice_uniform", both(*EIGHT), notice("uniform"), R4, 16),
]
IDS = [c[0] for c in CASES]


def jax_run(markets, kernels, params, rmax, seed=7, impl="xla", **kw):
    jparams = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), params)
    return R.run_market_sweep(R.Exponential(LAM), markets[0], kernels[0],
                              jparams, key=jax.random.key(seed), n_seeds=2,
                              rmax=rmax, impl=impl, **{**RUN_KW, **kw})


def port_run(markets, kernels, params, rmax, seed=7, **kw):
    return T.run_market_sweep(T.Exponential(LAM), markets[1], kernels[1],
                              params, key=threefry.key(seed), n_seeds=2,
                              rmax=rmax, device="cpu", **{**RUN_KW, **kw})


def assert_bitwise(ref, got, context):
    assert set(got) == set(ref), context
    for name, a in ref.items():
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(a),
                                      err_msg=f"{name} ({context})")


# ---------------------------------------------------------------------------
# the keyed hooks
# ---------------------------------------------------------------------------
HOOK_KERNELS = {
    "notice_cheapest": notice(),
    "notice_least_loaded": notice("least_loaded"),
    "notice_uniform": notice("uniform"),
    "choice_weighted": pool_choice(lambda m: m.ThreePhaseKernel(),
                                   "weighted"),
    "choice_fastest_exp_wait": pool_choice(exp_wait, "fastest"),
    "panic_notice_uniform": (R.PanicKernel(notice("uniform")[0]),
                             T.PanicKernel(notice("uniform")[1])),
    "panic_legacy": (R.PanicKernel(R.ThreePhaseKernel()),
                     T.PanicKernel(T.ThreePhaseKernel())),
}


@pytest.mark.parametrize("n_pools", [1, 3, 8])
@pytest.mark.parametrize("name", list(HOOK_KERNELS))
def test_keyed_market_hooks_match_jax(name, n_pools, xla_log1p):
    """admit_market and on_preempt on the same keys and pool states (some
    pools dark, as a blackout leaves them): admission, budget, pool and
    resume bitwise."""
    jk, tk = HOOK_KERNELS[name]
    lanes = 512
    rng = np.random.default_rng(n_pools)
    state = {"price": rng.choice([0.2, 0.5, 0.9], (lanes, n_pools)),
             "hazard": rng.uniform(0.0, 0.1, (lanes, n_pools)),
             "notice": rng.choice([0.0, 0.05, 0.3], (lanes, n_pools)),
             "rate": rng.choice([0.0, 0.4, 1.0], (lanes, n_pools),
                                p=[0.2, 0.4, 0.4]),
             "qlen_pool": rng.integers(0, 4, (lanes, n_pools))}
    state = {n: v.astype(np.int32 if n == "qlen_pool" else np.float32)
             for n, v in state.items()}
    qlen = rng.integers(0, 6, lanes).astype(np.int32)
    params = {"r": rng.choice(np.linspace(0.0, 5.0, 21), lanes),
              "pool_logits": rng.normal(0.0, 1.0, (lanes, n_pools))}
    params = {n: v.astype(np.float32) for n, v in params.items()}
    keys = KEYS[:lanes]
    age = rng.uniform(0.0, 5.0, lanes).astype(np.float32)
    note = state["notice"][:, 0]

    def jax_hooks(p, q, s, k, a, w):
        ps = jmarket.PoolState(**s)
        adm = jk.admit_market(p, q, ps, k)
        res = (jk.on_preempt(p, a, w, q, k) if hasattr(jk, "on_preempt")
               else jnp.zeros((), jnp.bool_))
        return adm, res

    (ja, jb, jp), jr = jax.jit(jax.vmap(jax_hooks))(params, qlen, state, keys,
                                                    age, note)
    t = {n: torch.from_numpy(v) for n, v in state.items()}
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    qt = torch.from_numpy(qlen)
    a, b, p = tk.admit_market(tp, qt, market.PoolState(**t), port_keys(keys))
    r = engine._kernel_on_preempt(tk, tp, torch.from_numpy(age),
                                  torch.from_numpy(note), qt,
                                  port_keys(keys))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(
        np.broadcast_to(torch.as_tensor(b).numpy(), (lanes,)),
        np.broadcast_to(np.asarray(jb), (lanes,)))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    if n_pools > 1 and "uniform" in name:
        assert len(np.unique(np.asarray(jp))) == n_pools


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,markets,kernels,params,rmax", CASES, ids=IDS)
def test_run_market_sweep_split_matches_jax(name, markets, kernels, params,
                                            rmax, xla_log1p):
    ref = jax_run(markets, kernels, params, rmax)
    got = port_run(markets, kernels, params, rmax)
    assert_bitwise(ref, got, name)
    if markets[1].preemptible:
        assert got["preemptions"].sum() > 0


def test_run_market_sim_split_matches_jax(xla_log1p):
    """One lane of the heterogeneous market under the cheapest rule, over
    a burn-in, full chunks and a tail."""
    markets, kernels = both(*HETERO), notice()
    kw = dict(k=K, n_events=300, rmax=16, chunk_events=128, burn_in=40,
              rng="split")
    params = {"r": 2.5}
    ref = R.run_market_sim(R.Exponential(LAM), markets[0], kernels[0],
                           jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                                        params),
                           key=jax.random.key(5), impl="xla", **kw)
    got = T.run_market_sim(T.Exponential(LAM), markets[1], kernels[1],
                           params, key=threefry.key(5), device="cpu", **kw)
    assert_bitwise(ref, got, "run_market_sim")
    assert isinstance(got["avg_cost"], float) and got["preemptions"] > 0


def test_pallas_interpret_fleet_matches(xla_log1p):
    """One fleet against the JAX market run through its Pallas kernel in
    interpret mode, which walks the 5-way ladder inside the kernel."""
    markets, kernels = both(*HETERO), notice()
    ref = jax_run(markets, kernels, {"r": np.array([1.0, 3.0])}, 8,
                  seed=3, impl="pallas", interpret=True, tile=4,
                  n_events=260, chunk_events=128, burn_in=0)
    got = port_run(markets, kernels, {"r": np.array([1.0, 3.0])}, 8,
                   seed=3, n_events=260, chunk_events=128, burn_in=0)
    assert_bitwise(ref, got, "pallas interpret")


def test_final_state_and_lane_key_match_jax(xla_log1p):
    """The executor level: JAX's market event body on the split stream
    (``layout=None``) and the port's plain version from the same initial
    states: every window's statistics, the final state (the ``(P,)``
    preemption clocks among it) and the final lane key, bitwise; the key
    went one step down the 5-way ladder an event, windows ignored."""
    markets, kernels, params, rmax = both(*HETERO), notice(), R4, 16
    plan = engine._window_plan(200, 80, 30)
    lanes, keys = 4, KEYS[:4]
    jm, tm = markets
    preempt_on = tm.preemptible
    flat = {n: np.resize(np.float32(v), lanes) for n, v in params.items()}
    mp = {n: np.tile(v, (lanes, 1)) for n, v in jm.params().items()}
    kc = np.full(lanes, K, np.float32)
    job = R.Exponential(LAM)

    @jax.jit
    def run(p, m, k, keys):
        state0 = jax.vmap(lambda key, mm: jengine.init_market_state(
            key, job, jm, rmax, mm, preempt_on))(keys, m)

        def step(carry, stats, pp):
            return jengine._market_event(job, jm, kernels[0], rmax,
                                         preempt_on, None, carry, stats,
                                         pp["params"], pp["mp"], pp["k"])

        final, stats = jax_ref(step, state0, {"params": p, "mp": m, "k": k},
                               jengine.MarketWindowStats.zeros(jm.n_pools),
                               plan, epilogue=jengine._rebase_order)
        return state0, final, stats

    state0, jfinal, jstats = jax.tree.map(np.asarray, run(flat, mp, kc, keys))
    s0 = engine.init_market_state(port_keys(keys), T.Exponential(LAM), tm,
                                  rmax, {n: torch.from_numpy(v)
                                         for n, v in mp.items()},
                                  preempt_on, rng="split")
    for field in engine.MarketState._fields:
        np.testing.assert_array_equal(
            getattr(s0, field).numpy(),
            getattr(state0, field).astype(getattr(s0, field).numpy().dtype),
            err_msg=f"initial {field}")
    final, stats = market_event_windows_ref(
        T.Exponential(LAM), tm, kernels[1], rmax, preempt_on, s0,
        convert.params(flat), {n: torch.from_numpy(v) for n, v in mp.items()},
        torch.from_numpy(kc), plan, rng="split")
    for field in engine.MarketWindowStats._fields:
        np.testing.assert_array_equal(getattr(stats, field).numpy(),
                                      getattr(jstats, field), err_msg=field)
    for field in engine.MarketState._fields:
        np.testing.assert_array_equal(
            getattr(final, field).numpy(),
            getattr(jfinal, field).astype(getattr(final, field).numpy().dtype),
            err_msg=field)
    assert final.next_preempt.shape == (lanes, tm.n_pools)
    key = s0.key
    for _ in range(sum(plan)):
        key = threefry.split(key, 4 + int(preempt_on))[:, 0]
    assert torch.equal(final.key, key)


# ---------------------------------------------------------------------------
# the port's own claims
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel,params,rmax", [
    (T.ThreePhaseKernel(), {"r": np.linspace(0.25, 4.0, 3)}, 8),
    (exp_wait(T), {}, 1)], ids=["three_phase", "single_slot_exp_wait"])
def test_degenerate_market_is_the_split_single_queue(kernel, params, rmax):
    """One pool, unit price, no hazard: bitwise the port's own
    ``run_sweep(rng="split")`` (the 4-way ladder, the spot key itself)."""
    kw = dict(k=K, n_events=400, key=threefry.key(3), n_seeds=2, rmax=rmax,
              chunk_events=150, burn_in=30, rng="split", device="cpu")
    degenerate = T.SpotMarket.single(T.Exponential(MU))
    single = T.run_sweep(T.Exponential(LAM), T.Exponential(MU), kernel,
                         params, **kw)
    mkt = T.run_market_sweep(T.Exponential(LAM), degenerate, kernel, params,
                             **kw)
    for name, v in single.items():
        got = mkt[name]
        got = got[..., 0] if got.ndim > v.ndim else got
        np.testing.assert_array_equal(got, v, err_msg=name)


#: three preemptible pools of four, tags kept when permuted
RELABEL = pools(T, market, (0.5, 0.3, 0.2, 0.1), (0.04, 0.0, 0.08, 0.1),
                (0.5, 0.01, 0.0, 2.0))


@functools.cache
def relabelled_run(perm: tuple) -> dict:
    return T.run_market_sim(
        T.Exponential(LAM), RELABEL.relabel(list(perm)),
        market.NoticeAwareKernel(0.05), {"r": 3.0}, k=K, n_events=200,
        key=threefry.key(11), chunk_events=128, rng="split", device="cpu")


@pytest.mark.parametrize("perm", [(1, 0, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1)])
def test_pool_relabelling_with_several_preemptible_pools(perm):
    """Permuting pools with their tags fixed leaves every statistic equal
    (pool arrays permuted), with several pools carrying a hazard: on the
    split stream each pool's clocks are keyed by its tag and the pool that
    fires is the earliest clock, not a positional thinning pick.  Ties of
    price are avoided, so the cheapest rule picks the same pool."""
    res, res_p = relabelled_run((0, 1, 2, 3)), relabelled_run(perm)
    assert (RELABEL.hazards() > 0).sum() == 3 and res["preemptions"] > 0
    inv = [list(perm).index(i) for i in range(4)]
    for name, v in res.items():
        if name.startswith("pool_"):
            np.testing.assert_array_equal(res_p[name][inv], v, err_msg=name)
        else:
            assert res_p[name] == v, name


def test_chunk_invariance_of_the_integer_stats():
    """The ladder advances once an event whatever the windows, so the
    integer statistics do not depend on ``chunk_events``."""
    tm, tk = both(*HETERO)[1], notice()[1]
    runs = [T.run_market_sweep(T.Exponential(LAM), tm, tk, R4,
                               key=threefry.key(9), n_seeds=2, rmax=16, k=K,
                               n_events=200, chunk_events=c, rng="split",
                               device="cpu")
            for c in (None, 100)]
    ints = [n for n in runs[0] if n in engine.MARKET_INT_STATS]
    assert len(ints) >= 7
    for name in ints:
        np.testing.assert_array_equal(runs[1][name], runs[0][name],
                                      err_msg=name)


class KeyedOnlyMarket:
    """A user's market kernel with only keyed hooks: admit under a queue
    of 3 with probability 0.7, to the pool of the fewest queued jobs;
    resume half the revoked jobs."""

    def admit_market(self, params, qlen, pool_state, key):
        ks = threefry.split(key, 2)
        admit = (qlen < 3) & (threefry.uniform(ks[..., 0, :]) < 0.7)
        return admit, engine.INF, market.choose_pool(
            "least_loaded", pool_state)

    def on_preempt(self, params, age, notice, qlen, key):
        return threefry.uniform(key) < 0.5


def test_named_refusals_and_a_keyed_only_kernel():
    """The regions refuse the split stream and Gamma is refused, each by a
    named error; a kernel with only keyed hooks runs the split market on
    the CPU (the slab stream refuses it by name), and the CUDA wrapper
    refuses it with NoKernelPolicyError before any tensor, never running
    the plain version."""
    job, spot = T.Exponential(LAM), T.Exponential(MU)
    tm = both(*HETERO)[1]
    kw = dict(n_events=50, key=threefry.key(0), device="cpu", rng="split")
    topo = T.RegionTopology.single(job, spot, rmax=4)
    for call in (
            lambda: T.run_region_sim(topo, T.ThreePhaseKernel(), {"r": 1.0},
                                     **kw),
            lambda: T.run_region_sweep(topo, T.ThreePhaseKernel(),
                                       {"r": 1.0}, **kw)):
        with pytest.raises(NotImplementedError,
                           match=r"regions \(ROADMAP.md Queue 1 item 7\)"):
            call()
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        T.run_market_sweep(T.Gamma(12.0, 1.0), tm, notice()[1], {"r": 1.0},
                           **kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        T.run_market_sim(job, T.SpotMarket.single(T.Gamma(2.0, 12.0)),
                         notice()[1], {"r": 1.0}, **kw)
    out = T.run_market_sweep(job, tm, KeyedOnlyMarket(), {}, n_events=300,
                             n_seeds=2, rmax=8, key=threefry.key(1),
                             device="cpu", rng="split")
    assert np.all(out["resumed"] > 0) and np.all(out["spot_served"] > 0)
    with pytest.raises(T.NoAdmitHookError, match="slab hook"):
        T.run_market_sweep(job, tm, KeyedOnlyMarket(), {}, n_events=50,
                           rmax=8, key=threefry.key(1), device="cpu")
    lanes = 4
    mp = {n: torch.from_numpy(np.tile(v, (lanes, 1)))
          for n, v in tm.params().items()}
    s0 = engine.init_market_state(threefry.split(threefry.key(1), lanes),
                                  job, tm, 8, mp, True, rng="split")
    k = torch.full((lanes,), K)
    with pytest.raises(sweep.NoKernelPolicyError, match="KeyedOnlyMarket"):
        sweep.market_event_windows(job, tm, KeyedOnlyMarket(), 8, True, s0,
                                   {}, mp, k, (64,), rng="split")
    # a policy the kernel holds gets as far as the device check
    with pytest.raises(ValueError, match="CUDA tensor"):
        sweep.market_event_windows(job, tm, notice()[1], 8, True, s0,
                                   {"r": torch.full((lanes,), 2.0)}, mp, k,
                                   (64,), rng="split")


# ---------------------------------------------------------------------------
# the slab stream's unswept exponential wait
# ---------------------------------------------------------------------------
def slab_wait_run(mod, entry, key):
    """A single-slot kernel with the exponential wait at its own rate 1/3
    on the slab stream, through ``entry`` of package ``mod``."""
    kernel = exp_wait(mod)
    job, spot = mod.Exponential(1.2), mod.Exponential(0.9)
    kw = dict(n_events=1_500, chunk_events=512, burn_in=100, rng="slab",
              key=key)
    if mod is T:
        kw["device"] = "cpu"
    else:
        kw["impl"] = "xla"
    if entry == "run_sim":
        return mod.run_sim(job, spot, kernel, {}, k=K, rmax=1, **kw)
    if entry == "run_sweep":
        return mod.run_sweep(job, spot, kernel, {}, k=np.array([5.0, K]),
                             n_seeds=2, rmax=1, **kw)
    mkt = jmarket if mod is R else market
    two = mkt.SpotMarket(pools=(
        mkt.SpotPool(mod.Exponential(0.5), price=0.4, hazard=0.05),
        mkt.SpotPool(mod.Exponential(0.4), price=0.7, hazard=0.02)))
    return mod.run_market_sim(job, two, mkt.PoolChoiceKernel(kernel),
                              {}, k=K, rmax=1, **kw)


@pytest.mark.parametrize("entry", ["run_sim", "run_sweep", "run_market_sim"])
def test_slab_unswept_exponential_wait_matches_jax(entry, xla_log1p):
    """Where the wait's rate is not swept the JAX package divides by a
    constant, which XLA compiles as a product with the float32 reciprocal;
    the port's slab stream does the same (a division moves a budget by an
    ulp at rate 1/3, and with it the order of a defection and a serve), so
    every statistic is bitwise JAX's on the three entry points that see the
    constant."""
    ref = slab_wait_run(R, entry, jax.random.key(3))
    got = slab_wait_run(T, entry, threefry.key(3))
    assert_bitwise(ref, got, entry)
