"""The port's telemetry axis on N-region routing against the JAX
package's, on the CPU; the regions' ledgers and the sketch's accuracy on
the port.

As tests/test_torch_telemetry.py: the JAX package runs ``impl="ref",
rng="slab"``, the port its plain PyTorch version, under ``xla_log1p``;
base statistics, ``TEL_INT_STATS`` and the rings bitwise, the histograms
bitwise or apart only at samples on a bin edge (``assert_hists``).  A
region run's locations are its regions: a job event's is its target, a
deadline's the region of the defecting job's slot; ``qlen`` is the total
over the regions after the event.
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
from test_torch_telemetry_market import (assert_quantiles_within_bound,
                                         replay_counters)
import repro.core as R
from repro.core import market as jmarket
from repro.core import regions as jregions
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import market, regions, threefry


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both_topologies(n=2, rmax=4):
    """tests/test_obs.py's topology (with notices, so legs resume), in
    both packages."""
    return [reg.RegionTopology(regions=tuple(
        reg.Region(mod.Exponential(LAM / n), mod.Exponential(MU / n),
                   price=0.4 + 0.2 * i, hazard=0.1 / (i + 1),
                   notice=0.5 * (i % 2), rmax=rmax)
        for i in range(n))) for reg, mod in ((jregions, R), (regions, T))]


def kernels(name):
    """Home routing through a bare three-phase kernel, or least_loaded
    routing over the notice-aware kernel."""
    return {"home": (R.ThreePhaseKernel(), T.ThreePhaseKernel()),
            "least_loaded": (
                jregions.RoutingKernel(jmarket.NoticeAwareKernel(0.05),
                                       "least_loaded"),
                regions.RoutingKernel(market.NoticeAwareKernel(0.05),
                                      "least_loaded"))}[name]


def run_port(tel, kernel="home", sweep=False, **over):
    kw = {**RUN_KW, **over}
    topo, tk = both_topologies()[1], kernels(kernel)[1]
    if sweep:
        return T.run_region_sweep(topo, tk, {"r": np.array([1.0, 3.0])},
                                  key=threefry.key(11), n_seeds=2,
                                  device="cpu", telemetry=tel, **kw)
    return T.run_region_sim(topo, tk, {"r": 2.0}, key=threefry.key(11),
                            device="cpu", telemetry=tel, **kw)


def run_both(tel_kw, kernel="home", sweep=False, **over):
    kw = {**RUN_KW, **over}
    jt, tt = both_tels(**tel_kw)
    topo, jk = both_topologies()[0], kernels(kernel)[0]
    if sweep:
        ref = R.run_region_sweep(topo, jk, {"r": jnp.asarray([1.0, 3.0])},
                                 key=jax.random.key(11), n_seeds=2,
                                 impl="ref", telemetry=jt, **kw)
    else:
        ref = R.run_region_sim(topo, jk, {"r": jnp.float32(2.0)},
                               key=jax.random.key(11), impl="ref",
                               telemetry=jt, **kw)
    return ref, run_port(tt, kernel, sweep, **over)


def costs():
    """Every cost increment: a region's price, k, and price + k."""
    prices = [np.float32(0.4 + 0.2 * i) for i in range(2)]
    k = np.float32(K)
    return prices + [k] + [np.float32(k + p) for p in prices]


@pytest.mark.parametrize("kernel,kw", [("home", TELS[0]),
                                       ("least_loaded", TELS[1])],
                         ids=["home_ring32", "least_loaded_narrow_wrapping"])
def test_run_region_sim_telemetry_matches_jax(kernel, kw, xla_log1p):
    """On equals JAX's on; the port's off run equals its on run's base
    keys (and tests/test_torch_regions.py holds the off run to JAX's)."""
    kw = {**TEL, **kw}
    ref, got = run_both(kw, kernel)
    assert_run_matches(ref, got, obs.Telemetry(**kw), ring_samples(
        functools.partial(run_port, kernel=kernel), kw, costs()),
        f"regions {kernel}")
    off = run_port(None, kernel)
    assert set(off) < set(got)
    assert_same(off, got, off, "on vs off")
    assert got["loc_defects"].shape == (2,)
    assert got["events"][2] > 0


def test_run_region_sweep_telemetry_matches_jax(xla_log1p):
    kw = {"n_bins": 32, "trace_cap": 16}
    over = dict(n_events=1_500, chunk_events=512, burn_in=100)
    ref, got = run_both(kw, "least_loaded", sweep=True, **over)
    assert_run_matches(ref, got, obs.Telemetry(**kw), ring_samples(
        functools.partial(run_port, kernel="least_loaded", sweep=True,
                          **over), kw, costs()), "regions sweep")
    assert got["cost_hist"].shape == (2, 2, 32)
    assert got["loc_resumed"].shape == (2, 2, 2)
    assert got["trace"]["qlen"].shape == (2, 2, 3, 16)
    np.testing.assert_array_equal(got["events"].sum(-1),
                                  np.full((2, 2), 1_500.0))


def test_region_ledger():
    """The market ledger of tests/test_obs.py, and the regions' own: job
    events are arrivals by home region, spot events slots by region."""
    out = run_port(obs.Telemetry(**TEL), "least_loaded")
    assert out["events"].sum() == RUN_KW["n_events"]
    assert out["preempts_fired"] >= out["preemptions"] > 0
    assert out["events"][2] == out["preempts_fired"]
    assert out["notices_honored"] == out["resumed"] > 0
    assert out["loc_resumed"].sum() == out["resumed"]
    assert out["spot_starts"] == out["spot_served"]
    assert out["loc_defects"].sum() == out["deadline_defects"]
    assert out["events"][0] == out["jobs_arrived"] \
        == out["region_jobs"].sum()
    assert out["events"][1] == out["region_spot_arrivals"].sum()
    assert out["rejects"] + out["deadline_defects"] + out["preemptions"] \
        - out["resumed"] == out["ondemand"]
    assert out["wait_hist"].sum() == out["spot_served"] \
        + out["deadline_defects"] + out["preemptions"]


def test_region_counters_replay_the_trace():
    tel = obs.Telemetry(trace_cap=1_024)
    out = run_port(tel, "least_loaded")
    assert out["trace"]["n"].max() <= tel.trace_cap
    for name, v in replay_counters(out, tel, 2).items():
        np.testing.assert_array_equal(out[name], v, err_msg=name)
    # qlen is the total over the regions: at most the packed slots
    qlen = out["trace"]["qlen"]
    assert qlen.min() >= 0 and qlen.max() <= 8


def test_sketch_quantiles_region_random_config():
    rng = np.random.default_rng(100)
    topo = regions.RegionTopology(regions=tuple(
        regions.Region(T.Exponential(float(rng.uniform(0.3, 0.8))),
                       T.Exponential(float(rng.uniform(0.2, 0.6))),
                       price=float(rng.uniform(0.2, 0.9)),
                       hazard=float(rng.uniform(0.0, 0.2)))
        for _ in range(3)))
    n_events = 3_000
    tel = obs.Telemetry(trace_cap=n_events)
    out = T.run_region_sim(topo, T.ThreePhaseKernel(),
                           {"r": float(rng.uniform(1.0, 4.0))}, k=K,
                           n_events=n_events, key=threefry.key(0),
                           chunk_events=None, device="cpu", telemetry=tel)
    assert_quantiles_within_bound(out, tel, "regions")
