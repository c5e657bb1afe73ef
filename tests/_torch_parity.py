"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Tolerance, for every comparison of the port with the JAX package: integer
event counts bitwise; float32 values to rtol 1e-5, the JAX package's own
tolerance between its executors (tests/test_sweep_kernel.py), because the
CPU ``log1p`` of XLA and of PyTorch each round within one ulp of the true
value, so their exponential draws can sit two ulps apart, and those ulps
travel through the float32 clocks.
"""
import numpy as np
import pytest
import torch

RTOL = 1e-5


def ulps(a, b) -> int:
    """Largest distance in units in the last place between two float32
    arrays of one sign."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def assert_close(ref, port, int_fields, context=""):
    """Fields of two results (dicts or NamedTuples of arrays): the names in
    ``int_fields`` (and every integer array) bitwise, floats to RTOL."""
    items = ref.items() if isinstance(ref, dict) else ref._asdict().items()
    for name, a in items:
        b = port[name] if isinstance(port, dict) else getattr(port, name)
        a = np.asarray(a)
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if name in int_fields or a.dtype.kind in "biu":
            np.testing.assert_array_equal(
                b, a, err_msg=f"{name} diverged ({context})")
        else:
            np.testing.assert_allclose(
                b, a, rtol=RTOL, atol=0, err_msg=f"{name} diverged ({context})")


@pytest.fixture
def cuda_device():
    """The GPU, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the sweep kernel has no CPU mode")
    return torch.device("cuda")
