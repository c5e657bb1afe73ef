"""The port's work axis on N-region routing against the JAX package's, on the
CPU: multi-unit service, rollbacks on a resume priced by the region's
notice, the survival ledger, the safety net, and the work state under the
env timeline with PanicKernel's route failover.

As tests/test_torch_work.py: the JAX package runs ``impl="xla",
rng="slab"``, the port its plain PyTorch version, under ``xla_log1p``;
every statistic bitwise, the ledger's float sums included.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import xla_log1p, xla_log1p_tables  # noqa: F401
from test_torch_env import chaos_timeline, one_torch_thread  # noqa: F401
from test_torch_env_regions import both_topologies, kernels as env_kernels
from test_torch_telemetry import assert_run_matches, assert_same, ring_samples
from test_torch_work import models
import repro.core as R
from repro.core import env as jenv, work as jwork
import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import env, threefry, work

K = 10.0
RUN_KW = dict(k=K, n_events=1_000, burn_in=128, chunk_events=512,
              rng="slab")


def kernels(name: str, net: bool):
    """tests/test_torch_env_regions.py's kernel ``name`` in both packages,
    wrapped in the safety net (outermost) where ``net``."""
    jk, tk = env_kernels(name)
    if net:
        return (R.CantBeLateKernel(jk, slack_buffer=0.2),
                T.CantBeLateKernel(tk, slack_buffer=0.2))
    return jk, tk


def run_port(mode, net=False, kernel="routed", tl=None, tel=None,
             sweep=False, wm=None, **over):
    """The port's region run with the work model ``mode`` of
    :func:`test_torch_work.models` (or ``wm``)."""
    kw = {**RUN_KW, **over}
    tt, tk = both_topologies()[1], kernels(kernel, net)[1]
    tw = wm or models(work)[mode]
    if sweep:
        return T.run_region_sweep(tt, tk, {"r": np.array([1.0, 3.0])},
                                  hazards=np.array([[0.3, 0.8], [0.0, 1.5]]),
                                  key=threefry.key(7), n_seeds=2,
                                  device="cpu", env=tl, telemetry=tel,
                                  work=tw, **kw)
    return T.run_region_sim(tt, tk, {"r": 2.0}, key=threefry.key(7),
                            device="cpu", env=tl, telemetry=tel, work=tw,
                            **kw)


def run_jax(mode, net=False, kernel="routed", tl=None, tel=None,
            sweep=False, wm=None, **over):
    """:func:`run_port`'s run in the JAX package."""
    kw = {**RUN_KW, **over}
    jt, jk = both_topologies()[0], kernels(kernel, net)[0]
    jw = wm or models(jwork)[mode]
    if sweep:
        return R.run_region_sweep(jt, jk, {"r": jnp.asarray([1.0, 3.0])},
                                  hazards=jnp.asarray([[0.3, 0.8],
                                                       [0.0, 1.5]]),
                                  key=jax.random.key(7), n_seeds=2,
                                  impl="xla", env=tl, telemetry=tel,
                                  work=jw, **kw)
    return R.run_region_sim(jt, jk, {"r": jnp.float32(2.0)},
                            key=jax.random.key(7), impl="xla", env=tl,
                            telemetry=tel, work=jw, **kw)


@pytest.mark.parametrize("net", [False, True], ids=["base", "safety_net"])
@pytest.mark.parametrize("mode", ["never", "notice", "periodic"])
def test_region_work_matches_jax(mode, net, xla_log1p):
    """Each checkpoint mode, with and without the safety net, under
    cheapest routing: every key bitwise JAX's, the ledger included; every
    resume billed its overhead."""
    ref, got = run_jax(mode, net), run_port(mode, net)
    assert set(got) == set(ref)
    assert_same(ref, got, ref, f"regions {mode}")
    assert got["jobs_ontime"] + got["deadline_misses"] == got["jobs_finished"]
    assert got["restart_overhead_paid"] == 0.5 * got["resumed"]
    assert got["resumed"] > 0
    if net:
        assert got["panic_entries"] > 0


def test_identity_model_is_work_off_in_the_regions():
    """``WorkModel()`` leaves every base key of the regions bitwise."""
    tt, tk = both_topologies()[1], kernels("routed", False)[1]
    kw = dict(key=threefry.key(7), device="cpu", **RUN_KW)
    off = T.run_region_sim(tt, tk, {"r": 2.0}, **kw)
    on = T.run_region_sim(tt, tk, {"r": 2.0}, work=work.WorkModel(), **kw)
    assert off["resumed"] > 0
    assert_same(off, on, off, "identity vs off")
    assert on["deadline_misses"] == 0 and on["work_lost"] == 0.0


def test_region_work_under_env_with_telemetry_matches_jax(xla_log1p):
    """The work state under tests/test_torch_env.py's chaos timeline (a
    storm, a blackout of region 0, a spike of region 1), PanicKernel's
    least_loaded route failing over, the safety net outermost, with
    telemetry: every key against JAX's (the histograms to the JAX
    package's own exemption)."""
    kw = dict(trace_cap=16)
    ref = run_jax("periodic", True, "panic_routed", chaos_timeline(jenv),
                  R.Telemetry(**kw))
    got = run_port("periodic", True, "panic_routed", chaos_timeline(env),
                   obs.Telemetry(**kw))
    run = functools.partial(lambda tel, **o: run_port(
        "periodic", True, "panic_routed", chaos_timeline(env), tel, **o),
        chunk_events=RUN_KW["chunk_events"])
    assert_run_matches(ref, got, obs.Telemetry(**kw),
                       ring_samples(run, kw, [0.6, 1.0, 1.8, K]),
                       "regions work+env+tel")
    assert got["env_boundaries"] > 0 and got["panic_entries"] > 0


def test_region_sweep_work_matches_jax(xla_log1p):
    """run_region_sweep with the work state over a hazards axis, two r and
    two seeds: every key bitwise JAX's."""
    ref = run_jax("never", True, "routed", sweep=True)
    got = run_port("never", True, "routed", sweep=True)
    assert_same(ref, got, ref, "region sweep work")
    assert np.asarray(got["work_lost"]).shape == (2, 2)
    assert np.asarray(got["work_lost"]).sum() > 0
