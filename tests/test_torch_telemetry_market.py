"""The port's telemetry axis on the P-pool market against the JAX package's,
on the CPU; the market's ledgers and the sketch's accuracy on the port.

As tests/test_torch_telemetry.py: the JAX package runs ``impl="ref",
rng="slab"``, the port its plain PyTorch version, under ``xla_log1p``;
base statistics, ``TEL_INT_STATS`` and the rings bitwise, the histograms
bitwise or apart only at samples on a bin edge (``assert_hists``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import xla_log1p, xla_log1p_tables  # noqa: F401
from test_torch_telemetry import (K, LAM, MU, RUN_KW, TEL, TELS,
                                  assert_run_matches, assert_same,
                                  both_tels, ring_samples)
import repro.core as R
from repro.core import market as jmarket
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import market, threefry
from repro_torch.obs.stats import hist_bin


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both_markets(n_pools=2):
    """tests/test_obs.py's market, in both packages."""
    return [mkt.SpotMarket(pools=tuple(
        mkt.SpotPool(mod.Exponential(MU / n_pools), price=0.4 + 0.3 * i,
                     hazard=0.2 / (i + 1), notice=0.5 * (i % 2))
        for i in range(n_pools))) for mkt, mod in ((jmarket, R),
                                                   (market, T))]


def kernels(name):
    """The kernel ``name`` in both packages: a legacy three-phase kernel
    (pool 0, no resume) or the notice-aware kernel under least_loaded (it
    joins both pools, so the noticed pool's legs resume)."""
    return {"three_phase": (R.ThreePhaseKernel(), T.ThreePhaseKernel()),
            "notice": (jmarket.NoticeAwareKernel(0.05, "least_loaded"),
                       market.NoticeAwareKernel(0.05, "least_loaded"))}[name]


def run_port(tel, kernel="three_phase", sweep=False, **over):
    kw = {**RUN_KW, **over}
    tm, tk = both_markets()[1], kernels(kernel)[1]
    if sweep:
        return T.run_market_sweep(T.Exponential(LAM), tm, tk,
                                  {"r": np.array([1.0, 3.0])},
                                  key=threefry.key(11), n_seeds=2, rmax=4,
                                  device="cpu", telemetry=tel, **kw)
    return T.run_market_sim(T.Exponential(LAM), tm, tk, {"r": 2.0},
                            key=threefry.key(11), rmax=4, device="cpu",
                            telemetry=tel, **kw)


def run_both(tel_kw, kernel="three_phase", sweep=False, **over):
    kw = {**RUN_KW, **over}
    jt, tt = both_tels(**tel_kw) if tel_kw is not None else (None, None)
    jm, jk = both_markets()[0], kernels(kernel)[0]
    if sweep:
        ref = R.run_market_sweep(R.Exponential(LAM), jm, jk,
                                 {"r": jnp.asarray([1.0, 3.0])},
                                 key=jax.random.key(11), n_seeds=2, rmax=4,
                                 impl="ref", telemetry=jt, **kw)
    else:
        ref = R.run_market_sim(R.Exponential(LAM), jm, jk,
                               {"r": jnp.float32(2.0)},
                               key=jax.random.key(11), rmax=4, impl="ref",
                               telemetry=jt, **kw)
    return ref, run_port(tt, kernel, sweep, **over)


def costs(k=K):
    """Every cost increment the 2-pool market can fold: a served or
    revoked leg's price, k, and a revoked leg that defects (price + k)."""
    prices = [np.float32(0.4 + 0.3 * i) for i in range(2)]
    return prices + [np.float32(k)] + [np.float32(np.float32(k) + p)
                                       for p in prices]


@pytest.mark.parametrize("kernel,kw", [("three_phase", TELS[0]),
                                       ("notice", TELS[1])],
                         ids=["three_phase_ring32", "notice_narrow_wrapping"])
def test_run_market_sim_telemetry_matches_jax(kernel, kw, xla_log1p):
    """On equals JAX's on; the port's off run equals its on run's base
    keys (and tests/test_torch_market.py holds the off run to JAX's)."""
    kw = {**TEL, **kw}
    ref, got = run_both(kw, kernel)
    tel = obs.Telemetry(**kw)
    assert_run_matches(ref, got, tel, ring_samples(
        functools.partial(run_port, kernel=kernel), kw, costs()),
        f"market {kernel}")
    off = run_port(None, kernel)
    assert set(off) < set(got)
    assert_same(off, got, off, "on vs off")
    assert got["loc_defects"].shape == (2,)
    assert got["events"][2] > 0 and got["preempts_fired"] > 0


def test_run_market_sweep_telemetry_matches_jax(xla_log1p):
    kw = {"n_bins": 32, "trace_cap": 16}
    over = dict(n_events=1_500, chunk_events=512, burn_in=100)
    ref, got = run_both(kw, "notice", sweep=True, **over)
    assert_run_matches(ref, got, obs.Telemetry(**kw), ring_samples(
        functools.partial(run_port, kernel="notice", sweep=True,
                          **over), kw, costs()), "market sweep")
    assert got["wait_hist"].shape == (2, 2, 32)
    assert got["loc_resumed"].shape == (2, 2, 2)
    assert got["trace"]["loc"].shape == (2, 2, 3, 16)
    np.testing.assert_array_equal(got["events"].sum(-1),
                                  np.full((2, 2), 1_500.0))


def test_market_ledger():
    """tests/test_obs.py's market ledger, on the port."""
    out = T.run_market_sim(T.Exponential(LAM), both_markets()[1],
                           kernels("notice")[1], {"r": 2.0}, k=K,
                           n_events=3_000, key=threefry.key(3), rmax=4,
                           device="cpu", telemetry=obs.Telemetry(**TEL))
    assert out["events"].sum() == 3_000
    assert out["preempts_fired"] >= out["preemptions"] > 0
    assert out["events"][2] == out["preempts_fired"]
    assert out["notices_honored"] == out["resumed"] > 0
    assert out["loc_resumed"].sum() == out["resumed"]
    assert out["spot_starts"] == out["spot_served"]
    assert out["loc_defects"].sum() == out["deadline_defects"]
    assert out["events"][0] == out["jobs_arrived"]
    assert out["events"][1] == out["pool_spot_arrivals"].sum()
    # on-demand: rejections, budget expiries, revoked legs that defect
    assert out["rejects"] + out["deadline_defects"] + out["preemptions"] \
        - out["resumed"] == out["ondemand"]
    # a wait sample a served, defected or revoked leg
    assert out["wait_hist"].sum() == out["spot_served"] \
        + out["deadline_defects"] + out["preemptions"]


def replay_counters(out, tel, n_locs):
    """The counters and histograms, recounted from a ring that never
    wrapped: one record an event."""
    tr = out["trace"]
    keep = np.arange(tr["type"].shape[-1]) < tr["n"][..., None]
    typ, loc, val = tr["type"][keep], tr["loc"][keep], tr["val"][keep]
    waits = torch.from_numpy(val[val >= 0])
    return {
        "events": np.bincount(typ, minlength=4),
        "loc_defects": np.bincount(loc[typ == 3], minlength=n_locs),
        "deadline_defects": (typ == 3).sum(),
        "wait_hist": np.bincount(hist_bin(waits, tel.wait_lo, tel.wait_hi,
                                          tel.n_bins).numpy(),
                                 minlength=tel.n_bins)}


def test_market_counters_replay_the_trace():
    """Every counter is a sum over events: the unwrapped ring recounts
    them.  (The JAX package's chunked-equals-one-shot check needs the
    split stream: on the slab stream the window plan picks the random
    numbers, in the JAX package as in the port.)"""
    tel = obs.Telemetry(trace_cap=1_024)
    out = run_port(tel, "notice")
    assert out["trace"]["n"].max() <= tel.trace_cap
    for name, v in replay_counters(out, tel, 2).items():
        np.testing.assert_array_equal(out[name], v, err_msg=name)
    qlen = out["trace"]["qlen"]
    assert qlen.min() >= 0 and qlen.max() <= 4


def trace_waits(out) -> np.ndarray:
    """Every wait sample, replayed from a ring that never wrapped."""
    v, n = np.asarray(out["trace"]["val"]), np.asarray(out["trace"]["n"])
    assert n.max() <= v.shape[-1], "the ring wrapped"
    v = v[np.arange(v.shape[-1]) < n[..., None]]
    return v[v >= 0.0]


def assert_quantiles_within_bound(out, tel, context):
    """tests/test_obs.py's bound: each sketch quantile within a factor
    1 + (γ − 1) of the exact one, give or take ``wait_lo``."""
    s = np.sort(trace_waits(out))
    assert s.size > 50, context
    re, n = tel.rel_error(), s.size
    for q, key in ((0.50, "p50_wait"), (0.90, "p90_wait"),
                   (0.99, "p99_wait")):
        exact = s[max(int(np.ceil(q * n)) - 1, 0)]
        est = float(out[key])
        assert exact / (1 + re) - tel.wait_lo <= est \
            <= exact * (1 + re) + tel.wait_lo, (context, key, est, exact)


@pytest.mark.parametrize("seed", [0, 1])
def test_sketch_quantiles_market_random_configs(seed):
    rng = np.random.default_rng(seed)
    n_pools = int(rng.integers(1, 4))
    mkt = market.SpotMarket(pools=tuple(
        market.SpotPool(T.Exponential(float(rng.uniform(0.2, 0.6))),
                        price=float(rng.uniform(0.2, 0.9)),
                        hazard=float(rng.uniform(0.0, 0.3)),
                        notice=float(rng.choice([0.0, 0.25, 0.5])))
        for _ in range(n_pools)))
    n_events = 3_000
    tel = obs.Telemetry(trace_cap=n_events)
    out = T.run_market_sim(T.Exponential(float(rng.uniform(0.8, 1.6))), mkt,
                           kernels("notice")[1],
                           {"r": float(rng.uniform(1.0, 4.0))}, k=K,
                           n_events=n_events, key=threefry.key(seed), rmax=8,
                           chunk_events=None, device="cpu", telemetry=tel)
    assert_quantiles_within_bound(out, tel, f"market seed {seed}")
