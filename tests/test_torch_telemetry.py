"""The port's telemetry axis against the JAX package's, on the CPU: the
``repro_torch.obs`` modules, and whole single-queue runs.

The module functions get the same numpy inputs as the JAX package's and
must give equal outputs.  Whole runs take the same keys and grids; the JAX
package runs ``impl="ref", rng="slab"`` (once its Pallas kernel in
interpret mode), the port its plain PyTorch version (``device="cpu"``),
under ``xla_log1p`` (tests/_torch_parity.py), so that every base statistic
is bitwise and so is every wait sample.

Tolerance.  Base statistics, ``TEL_INT_STATS`` and the trace rings
bitwise.  The histograms bitwise too, except where XLA's CPU ``log`` and
PyTorch's, each within an ulp, put one sample on the two sides of a bin
edge: :func:`assert_hists` then replays every sample and requires each
difference to be such a sample (the JAX package's own exemption between
its executors, tests/test_obs.py).  Market and region runs are in
tests/test_torch_telemetry_market.py and
tests/test_torch_telemetry_regions.py.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import xla_log1p, xla_log1p_tables  # noqa: F401
import repro.core as R
from repro.obs import stats as jstats
from repro.obs import trace as jtrace
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import threefry
from repro_torch.kernels.sweep import sweep
from repro_torch.obs import stats, trace

LAM, MU, K = 1.2, 0.9, 12.0
TEL = dict(trace_cap=32)
RUN_KW = dict(k=K, n_events=3_000, chunk_events=1_024, rng="slab")
RNG = np.random.default_rng(2020)
#: Telemetry configurations: the defaults, and a narrow one whose ring
#: wraps within a window
TELS = [{}, dict(n_bins=16, wait_lo=0.1, wait_hi=100.0, cost_lo=0.5,
                 cost_hi=50.0, trace_cap=8)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs dozens of small operations an event; on one
    thread they do not wait on a pool that other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both_tels(**kw):
    return R.Telemetry(**kw), obs.Telemetry(**kw)


def jax_bins(x, lo, hi, n_bins):
    return np.asarray(jax.jit(lambda v: jstats.hist_bin(v, lo, hi, n_bins))(
        jnp.asarray(x, jnp.float32)))


def port_bins(x, lo, hi, n_bins):
    return stats.hist_bin(torch.from_numpy(np.asarray(x, np.float32)), lo,
                          hi, n_bins).numpy()


def assert_bins_agree(x, lo, hi, n_bins):
    """The two packages' bins of ``x`` are equal, or one apart where the
    two float32 logs differ (a value on a bin edge); returns the number
    of such values."""
    x = np.asarray(x, np.float32)
    jb, tb = jax_bins(x, lo, hi, n_bins), port_bins(x, lo, hi, n_bins)
    off = jb != tb
    if off.any():
        jlog = np.asarray(jax.jit(jnp.log)(np.maximum(x[off],
                                                      np.float32(1e-30))))
        tlog = torch.log(torch.from_numpy(np.maximum(
            x[off], np.float32(1e-30)))).numpy()
        assert np.all(jlog != tlog), x[off][jlog == tlog]
        assert np.all(np.abs(jb[off] - tb[off]) == 1)
    return int(off.sum())


def assert_hists(ref, got, samples, tel, context):
    """Histograms bitwise, or apart only by samples that the two logs bin
    on the two sides of an edge.  ``samples`` maps each histogram to a
    function that returns every sample of the run."""
    for name, (lo, hi) in (("wait_hist", (tel.wait_lo, tel.wait_hi)),
                           ("cost_hist", (tel.cost_lo, tel.cost_hi))):
        a, b = np.asarray(ref[name]), np.asarray(got[name])
        if np.array_equal(a, b):
            continue
        x = np.asarray(samples[name](), np.float32)
        jb, tb = jax_bins(x, lo, hi, tel.n_bins), port_bins(x, lo, hi,
                                                            tel.n_bins)
        assert_bins_agree(x, lo, hi, tel.n_bins)
        want = (np.bincount(tb, minlength=tel.n_bins)
                - np.bincount(jb, minlength=tel.n_bins))
        np.testing.assert_array_equal(b.reshape(-1, tel.n_bins).sum(0)
                                      - a.reshape(-1, tel.n_bins).sum(0),
                                      want, err_msg=f"{name} ({context})")


def assert_same(ref, got, keys, context):
    """Bitwise, one level into the trace dict."""
    for name in keys:
        a, b = ref[name], got[name]
        if isinstance(a, dict):
            assert set(a) == set(b)
            for sub in a:
                np.testing.assert_array_equal(
                    np.asarray(b[sub]), np.asarray(a[sub]),
                    err_msg=f"{name}.{sub} ({context})")
            continue
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f"{name} ({context})")


def assert_run_matches(ref, got, tel, samples, context):
    assert set(got) == set(ref)
    hists = {"wait_hist", "cost_hist"}
    assert_same(ref, got, [n for n in ref if n not in hists], context)
    assert_hists(ref, got, samples, tel, context)


# ---------------------------------------------------------------------------
# the module: bins, edges, sketches, summaries, merges, traces
# ---------------------------------------------------------------------------
def test_telemetry_descriptor_matches_jax():
    for kw in TELS:
        jt, tt = both_tels(**kw)
        assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
        np.testing.assert_array_equal(tt.wait_edges(), jt.wait_edges())
        np.testing.assert_array_equal(tt.cost_edges(), jt.cost_edges())
        assert tt.rel_error() == jt.rel_error()
    assert obs.EVENT_TYPES == jstats.EVENT_TYPES
    assert obs.TEL_INT_STATS == jstats.TEL_INT_STATS
    assert stats.TEL_VECTOR_STATS == jstats.TEL_VECTOR_STATS
    assert (stats.TelemetryWindowStats._fields
            == jstats.TelemetryWindowStats._fields)


@pytest.mark.parametrize("lo,hi,n_bins", [(1e-2, 1e4, 64), (1e-2, 1e3, 64),
                                          (0.1, 100.0, 16), (0.5, 50.0, 256)])
def test_hist_bin_matches_jax(lo, hi, n_bins):
    """0, 1e-30, each edge and its float32 neighbours, hi, and very large
    values: the same bin, or one apart only where the two logs differ."""
    edges = np.float32(stats._edges(lo, hi, n_bins)[1:-1])
    near = np.concatenate([np.nextafter(edges, np.float32(0)), edges,
                           np.nextafter(edges, np.float32(np.inf))])
    x = np.concatenate([
        [0.0, 1e-30, 1e-38, lo, hi, np.nextafter(np.float32(hi),
                                                 np.float32(0)),
         1e30, 3e38, np.finfo(np.float32).max], near,
        np.exp(RNG.uniform(np.log(lo) - 3, np.log(hi) + 3, 50_000))])
    x = x.astype(np.float32)
    n_off = assert_bins_agree(x, lo, hi, n_bins)
    assert n_off <= 0.01 * x.size
    b = port_bins(x, lo, hi, n_bins)
    assert b.min() == 0 and b.max() == n_bins - 1


def test_sketch_quantile_matches_jax():
    tel = obs.Telemetry()
    hist = RNG.integers(0, 50, (6, 5, tel.n_bins)).astype(np.float64)
    hist[0] = 0.0  # empty sketches read 0
    hist[1, :, 1:] = 0.0  # everything in the underflow bin
    hist[2, :, :-1] = 0.0  # everything in the overflow bin
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        for edges in (tel.wait_edges(), tel.cost_edges()):
            np.testing.assert_array_equal(
                stats.sketch_quantile(hist, edges, q),
                jstats.sketch_quantile(hist, edges, q))


def random_block(module, tel, n_locs, lead, rings):
    """A TelemetryWindowStats of ``module`` with random counts of shape
    ``lead + (windows, ...)``, the same numbers for either package."""
    rng = np.random.default_rng(7)
    w, nb, cap = 3, tel.n_bins, max(tel.trace_cap, 1)

    def ints(*shape, hi=40):
        return rng.integers(0, hi, lead + (w,) + shape).astype(np.int32)

    ring = (None,) * 6
    if rings:
        ring = (rng.uniform(0, 5, lead + (w, cap)).astype(np.float32),
                ints(cap, hi=4), ints(cap, hi=n_locs), ints(cap, hi=9),
                rng.uniform(-1, 9, lead + (w, cap)).astype(np.float32),
                ints(hi=3 * cap))
    return module.TelemetryWindowStats(ints(nb), ints(nb), ints(4), ints(),
                                       ints(), ints(), ints(), ints(),
                                       ints(n_locs), ints(n_locs), *ring)


@pytest.mark.parametrize("kw", TELS, ids=["default", "narrow"])
def test_summarize_telemetry_matches_jax(kw):
    jt, tt = both_tels(**{**kw, "trace_cap": 8})
    for lead in ((), (2, 3)):
        ref = jstats.summarize_telemetry(
            jt, random_block(jstats, jt, 3, lead, True))
        got = stats.summarize_telemetry(
            tt, random_block(stats, tt, 3, lead, True))
        assert list(got) == list(ref)
        assert_same(ref, got, ref, f"lead {lead}")


def test_telemetry_merge_and_reduce_match_jax():
    jt, tt = both_tels(trace_cap=4)
    ja = random_block(jstats, jt, 2, (5,), False)
    ta = random_block(stats, tt, 2, (5,), False)
    for ref, got in ((jstats.telemetry_merge(ja, ja),
                      stats.telemetry_merge(ta, ta)),
                     (jstats.telemetry_reduce(ja, 0),
                      stats.telemetry_reduce(ta, 0)),
                     (jstats.telemetry_reduce(ja, 1),
                      stats.telemetry_reduce(ta, 1))):
        for name in stats.TelemetryWindowStats._fields:
            a, b = getattr(ref, name), getattr(got, name)
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(b, a, err_msg=name)
    # on tensors as on arrays
    tens = stats.TelemetryWindowStats(*(None if x is None else
                                        torch.from_numpy(x) for x in ta))
    merged = stats.telemetry_merge(tens, tens)
    np.testing.assert_array_equal(merged.wait_hist.numpy(),
                                  2 * ta.wait_hist)
    rings = random_block(stats, tt, 2, (5,), True)
    with pytest.raises(ValueError, match="trace rings"):
        stats.telemetry_merge(rings, ta)
    with pytest.raises(ValueError, match="trace rings"):
        stats.telemetry_reduce(rings)


def test_device_trace_records_and_perfetto_match_jax():
    """Rings of three windows, one wrapped, exported on one clock."""
    cap = 6
    block = random_block(stats, obs.Telemetry(trace_cap=cap), 3, (4,), True)
    tr = {name[len("ring_"):]: getattr(block, name)
          for name in stats._TRACE_FIELDS}
    tr["n"] = np.array([[3, cap, 2 * cap + 1]] * 4, np.int32)
    tw = RNG.uniform(1.0, 9.0, (4, 3))
    for lane in range(4):
        ref = jtrace.device_trace_records(tr, tw, lane=lane)
        got = trace.device_trace_records(tr, tw, lane=lane)
        assert got == ref
        assert any("dropped" in r for r in got)
        assert trace.to_perfetto(got, label="port") \
            == jtrace.to_perfetto(ref, label="port")
    rec, jrec = trace.TraceRecorder(cap=2), jtrace.TraceRecorder(cap=2)
    for r in (rec, jrec):
        for i in range(3):
            r.record(0.5 * i, "job", loc=1, qlen=i, wait=0.1)
    assert rec.records == jrec.records and rec.dropped == jrec.dropped == 1


def test_write_perfetto_is_well_formed(tmp_path):
    recs = [{"t": 0.5, "type": "spot", "loc": 1, "qlen": 2, "wait": 0.25},
            {"t": 1.0, "type": "deadline", "loc": 0, "qlen": 1,
             "dropped": 3}]
    path = tmp_path / "trace.json"
    trace.write_perfetto(str(path), recs, label="sweep")
    doc = json.loads(path.read_text())
    assert doc == jtrace.to_perfetto(recs, label="sweep")
    inst = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert [e["ts"] for e in inst] == [0.5e6, 1.0e6]
    assert inst[0]["args"]["wait"] == 0.25
    assert inst[1]["args"]["dropped"] == 3


# ---------------------------------------------------------------------------
# whole single-queue runs
# ---------------------------------------------------------------------------
R_GRID = np.array([0.5, 2.0, 3.5])


def run_port(tel, sweep=False, **over):
    kw = {**RUN_KW, **over}
    if sweep:
        return T.run_sweep(T.Exponential(LAM), T.Exponential(MU),
                           T.ThreePhaseKernel(), {"r": R_GRID},
                           key=threefry.key(11), n_seeds=2, rmax=4,
                           device="cpu", telemetry=tel, **kw)
    return T.run_sim(T.Exponential(LAM), T.Exponential(MU),
                     T.ThreePhaseKernel(), {"r": 2.0}, key=threefry.key(11),
                     rmax=4, device="cpu", telemetry=tel, **kw)


def run_both(tel_kw, sweep=False, **over):
    """The same single-queue run in both packages (``tel_kw`` None: the
    axis off)."""
    kw = {**RUN_KW, **over}
    jt, tt = both_tels(**tel_kw) if tel_kw is not None else (None, None)
    if sweep:
        ref = R.run_sweep(R.Exponential(LAM), R.Exponential(MU),
                          R.ThreePhaseKernel(), {"r": jnp.asarray(R_GRID)},
                          key=jax.random.key(11), n_seeds=2, rmax=4,
                          impl="ref", telemetry=jt, **kw)
    else:
        ref = R.run_sim(R.Exponential(LAM), R.Exponential(MU),
                        R.ThreePhaseKernel(), {"r": jnp.float32(2.0)},
                        key=jax.random.key(11), rmax=4, impl="ref",
                        telemetry=jt, **kw)
    return ref, run_port(tt, sweep, **over)


def ring_samples(run, tel_kw, costs):
    """Every wait sample of a run, replayed from the port's run with a
    ring as wide as a window (its samples are bitwise JAX's, as its rings
    are), and the run's few cost values; computed only where a histogram
    differs."""
    @functools.cache
    def waits():
        chunk = run.keywords.get("chunk_events", RUN_KW["chunk_events"])
        full = run(obs.Telemetry(**{**tel_kw, "trace_cap": chunk}))
        v, n = full["trace"]["val"], full["trace"]["n"]
        v = v[np.arange(v.shape[-1]) < n[..., None]]
        return v[v >= 0]

    return {"wait_hist": waits,
            "cost_hist": lambda: np.asarray(costs, np.float32)}


@pytest.mark.parametrize("kw", TELS, ids=["ring32", "narrow_wrapping"])
def test_run_sim_telemetry_matches_jax(kw, xla_log1p):
    kw = {**TEL, **kw}
    ref, got = run_both(kw)
    off_ref, off = run_both(None)
    tel = obs.Telemetry(**kw)
    assert_run_matches(ref, got, tel, ring_samples(
        functools.partial(run_port), kw, [1.0, K]), "run_sim")
    # off is the run as before, and on only adds keys
    assert_same(off_ref, off, off_ref, "off")
    assert set(off) < set(got)
    assert_same(off, got, off, "on vs off")
    assert isinstance(got["p99_wait"], float)
    assert got["wait_hist"].shape == (tel.n_bins,)
    assert got["trace"]["val"].shape == (3, tel.trace_cap)


def test_run_sweep_telemetry_matches_jax(xla_log1p):
    kw = {"n_bins": 32, "trace_cap": 16}
    over = dict(n_events=1_500, chunk_events=512, burn_in=100)
    ref, got = run_both(kw, sweep=True, **over)
    tel = obs.Telemetry(**kw)
    assert_run_matches(ref, got, tel, ring_samples(
        functools.partial(run_port, sweep=True, **over), kw, [1.0, K]),
        "run_sweep")
    assert got["p99_wait"].shape == (3, 2)
    assert got["wait_hist"].shape == (3, 2, 32)
    assert got["events"].shape == (3, 2, 4)
    assert got["loc_defects"].shape == (3, 2, 1)
    assert got["trace"]["t"].shape == (3, 2, 3, 16)
    assert got["trace"]["time_windows"].shape == (3, 2, 3)
    np.testing.assert_array_equal(got["events"].sum(-1),
                                  np.full((3, 2), 1_500.0))


def test_run_sim_telemetry_matches_jax_pallas_kernel(xla_log1p):
    """Once against the JAX run through its Pallas kernel in interpret
    mode."""
    kw = dict(k=K, n_events=700, chunk_events=256, rng="slab")
    jt, tt = both_tels(n_bins=24, trace_cap=8)
    ref = R.run_sim(R.Exponential(LAM), R.Exponential(MU),
                    R.ThreePhaseKernel(), {"r": jnp.float32(2.0)},
                    key=jax.random.key(4), rmax=4, impl="pallas",
                    interpret=True, tile=4, telemetry=jt, **kw)
    got = T.run_sim(T.Exponential(LAM), T.Exponential(MU),
                    T.ThreePhaseKernel(), {"r": 2.0}, key=threefry.key(4),
                    rmax=4, device="cpu", telemetry=tt, **kw)
    assert_same(ref, got, ref, "pallas")


def test_single_queue_ledger():
    """tests/test_obs.py's single-loop ledger, on the port."""
    out = T.run_sim(T.Exponential(LAM), T.Exponential(MU),
                    T.SingleSlotKernel(wait=T.DeterministicWait(0.8)), {},
                    key=threefry.key(3), rmax=4, device="cpu",
                    telemetry=obs.Telemetry(trace_cap=4), **RUN_KW)
    assert out["events"].sum() == RUN_KW["n_events"]
    assert out["events"][2] == 0  # no preemption clock in the single queue
    assert out["preempts_fired"] == 0 and out["notices_honored"] == 0
    assert out["spot_starts"] == out["spot_served"]
    assert out["deadline_defects"] > 0 and out["rejects"] > 0
    assert out["rejects"] + out["deadline_defects"] == out["ondemand"]
    assert out["wait_hist"].sum() == out["spot_served"] \
        + out["deadline_defects"]
    assert out["cost_hist"].sum() == out["jobs_completed"]
    assert out["loc_defects"].sum() == out["deadline_defects"]
    # every wait is at most the deterministic budget: P99 within a bin of it
    tel = obs.Telemetry()
    assert out["p99_wait"] <= 0.8 * (1 + tel.rel_error()) * (1 + 1e-5) \
        + tel.wait_lo


def test_wrapping_ring_counts_its_drops():
    tel = obs.Telemetry(trace_cap=8)
    out = T.run_sim(T.Exponential(LAM), T.Exponential(MU),
                    T.ThreePhaseKernel(), {"r": 2.0}, key=threefry.key(5),
                    rmax=4, device="cpu", telemetry=tel,
                    **{**RUN_KW, "n_events": 600, "chunk_events": 256})
    np.testing.assert_array_equal(out["trace"]["n"], [256, 256, 88])
    recs = obs.device_trace_records(out["trace"],
                                    out["trace"]["time_windows"])
    assert len(recs) == 3 * 8
    assert [r["dropped"] for r in recs if "dropped" in r] == [248, 248, 80]
    ts = [r["t"] for r in recs]
    assert ts == sorted(ts) and ts[-1] <= out["time"]
    doc = obs.to_perfetto(recs)
    assert sum(e["ph"] == "i" for e in doc["traceEvents"]) == len(recs)


ENTRIES = ("run_sim", "run_sweep", "run_market_sim", "run_market_sweep",
           "run_region_sim", "run_region_sweep")


def entry_args(name):
    job, spot = T.Exponential(LAM), T.Exponential(MU)
    market = T.SpotMarket.single(spot, price=0.4, hazard=0.05)
    topo = T.RegionTopology.single(job, spot, rmax=4)
    kernel = T.NoticeAwareKernel(0.05)
    return {"run_sim": (job, spot, kernel), "run_sweep": (job, spot, kernel),
            "run_market_sim": (job, market, kernel),
            "run_market_sweep": (job, market, kernel),
            "run_region_sim": (topo, kernel),
            "run_region_sweep": (topo, kernel)}[name]


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_points_refuse_what_is_not_ported(name):
    fn = getattr(T, name)
    kw = dict(n_events=50, key=threefry.key(0), device="cpu")
    args = entry_args(name)
    with pytest.raises(TypeError, match="Telemetry"):
        fn(*args, {"r": 1.0}, telemetry=R.Telemetry(), **kw)
    # env= and work= are ported: a value of another type is refused
    with pytest.raises(TypeError, match="EnvTimeline"):
        fn(*args, {"r": 1.0}, env=object(), **kw)
    with pytest.raises(TypeError, match="WorkModel"):
        fn(*args, {"r": 1.0}, work=object(), **kw)
    if name in ("run_sim", "run_sweep"):
        # the single queue runs the split stream; this kernel has no keyed
        # admission hook, which it calls
        with pytest.raises(T.NoAdmitHookError, match="keyed hook"):
            fn(*args, {"r": 1.0}, rng="split", **kw)
    elif name.startswith("run_market"):
        # the market runs it through the kernel's keyed market hooks
        assert np.all(np.asarray(fn(*args, {"r": 1.0}, rng="split",
                                    **kw)["jobs_arrived"]) > 0)
    else:
        with pytest.raises(NotImplementedError, match="rng='split'"):
            fn(*args, {"r": 1.0}, rng="split", **kw)
    if name.endswith("sweep"):
        with pytest.raises(NotImplementedError, match="lane sharding"):
            fn(*args, {"r": 1.0}, shard="lanes", **kw)
    # PanicKernel is ported: without a blackout it runs as its base
    base = (T.ThreePhaseKernel() if name in ("run_sim", "run_sweep")
            else args[-1])
    np.testing.assert_equal(
        fn(*args[:-1], T.PanicKernel(base), {"r": 1.0}, **kw),
        fn(*args[:-1], base, {"r": 1.0}, **kw))


def test_kernel_refuses_a_telemetry_wider_than_it_holds():
    """The kernel's shared-memory slice holds 3 to 256 bins; a wider
    sketch is refused by name before anything is launched (the plain
    version takes any)."""
    for n_bins in (2, sweep.MAX_BINS + 1):
        with pytest.raises(sweep.TelemetryTooWideError):
            sweep._telemetry_outputs(obs.Telemetry(n_bins=n_bins), 1, 4, 2,
                                     "cpu")
    out, ptrs, icfg, fcfg = sweep._telemetry_outputs(
        obs.Telemetry(n_bins=sweep.MAX_BINS, trace_cap=5), 3, 4, 2, "cpu")
    assert out.wait_hist.shape == (4, 2, sweep.MAX_BINS)
    assert out.loc_resumed.shape == (4, 2, 3) and out.ring_t.shape == (4, 2, 5)
    assert len(ptrs) == 12 and icfg.tolist() == [sweep.MAX_BINS, 3, 5]
    log_lo, inv = stats.bin_constants(1e-2, 1e4, sweep.MAX_BINS)
    assert fcfg[0] == log_lo and fcfg[1] == inv
    with pytest.raises(TypeError, match="Telemetry"):
        sweep._telemetry_outputs(R.Telemetry(), 1, 4, 2, "cpu")
