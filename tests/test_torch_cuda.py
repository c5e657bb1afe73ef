"""The CUDA sweep kernel against its plain PyTorch version, on the card.

Marked ``cuda``: each test skips where there is no GPU (the kernel has no
CPU mode). This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch; there, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)

Tolerance: integer statistics and the final join orders, occupancy,
counters and keys bitwise; float32 sums and clocks to rtol 1e-5 (see
tests/_torch_parity.py). A Gamma job's first clock is drawn exponential:
the port has no Gamma initial sampler yet; every later draw is Gamma's.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, cuda_device  # noqa: F401
import repro_torch.core as T
from repro_torch.core import engine, threefry
from repro_torch.kernels.sweep import (batched_event_windows,
                                       batched_event_windows_ref)

LAM, MU = 1 / 12, 1 / 24

CASES = [
    ("three_phase", T.Exponential(LAM), T.Exponential(MU),
     T.ThreePhaseKernel(), 8, {"r": np.linspace(0.25, 4.0, 15)}),
    ("three_phase_gamma", T.Gamma(12.0, 1.0), T.Exponential(MU),
     T.ThreePhaseKernel(), 8, {"r": np.linspace(0.0, 3.0, 13)}),
    ("single_slot", T.Exponential(LAM), T.Uniform(0.0, 48.0),
     T.SingleSlotKernel(wait=T.DeterministicWait(3.0)), 1, {}),
    ("single_slot_exp_wait", T.Exponential(LAM), T.Exponential(MU),
     T.SingleSlotKernel(wait=T.ExponentialWait(0.5)), 1, {}),
    ("two_slots_a_thread", T.Exponential(LAM), T.Exponential(MU),
     T.ThreePhaseKernel(), 64, {"r": np.linspace(1.0, 60.0, 13)}),
    ("eight_slots_a_thread", T.Exponential(LAM), T.BathtubGCP(),
     T.ThreePhaseKernel(), 100, {"r": np.linspace(1.0, 90.0, 13)}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,job,spot,kernel,rmax,params", CASES,
                         ids=[c[0] for c in CASES])
def test_cuda_kernel_matches_plain_version(cuda_device, name, job, spot,
                                           kernel, rmax, params):
    lanes = 13  # not a multiple of the kernel's 8 lanes a block
    plan = engine._window_plan(3_000, 1_024, 256)
    init_job = T.Exponential(LAM) if isinstance(job, T.Gamma) else job
    s0 = engine.init_engine_state(
        threefry.split(threefry.key(7, cuda_device), lanes), init_job, spot,
        rmax)
    k = torch.full((lanes,), 10.0, device=cuda_device)
    p = {n: torch.as_tensor(np.resize(np.float32(v), lanes),
                            device=cuda_device) for n, v in params.items()}
    p = engine.lane_params(kernel, p, k)
    fin_r, ref = batched_event_windows_ref(job, spot, kernel, rmax, s0, p, k,
                                           plan)
    fin_k, ker = batched_event_windows(job, spot, kernel, rmax, s0, p, k,
                                       plan)
    torch.cuda.synchronize()
    assert_close({f: v.cpu().numpy() for f, v in ref._asdict().items()}, ker,
                 engine.INT_STATS, name)
    assert_close({f: v.cpu().numpy() for f, v in fin_r._asdict().items()},
                 fin_k, (), name)


@pytest.mark.cuda
def test_cuda_launch_count_and_device_checks(cuda_device):
    job, spot, kernel = T.Exponential(LAM), T.Exponential(MU), T.ThreePhaseKernel()
    s0 = engine.init_engine_state(
        threefry.split(threefry.key(1, cuda_device), 4), job, spot, 8)
    p = {"r": torch.full((4,), 2.5, device=cuda_device)}
    k = torch.full((4,), 10.0, device=cuda_device)
    before = batched_event_windows.launches
    batched_event_windows(job, spot, kernel, 8, s0, p, k, (100,))
    assert batched_event_windows.launches == before + 1
    with pytest.raises(ValueError, match="float32"):
        batched_event_windows(job, spot, kernel, 8, s0, p, k.double(), (100,))
