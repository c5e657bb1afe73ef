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

# Attention and the LM stack (tests/test_torch_attention.py,
# tests/test_torch_lm.py, tests/test_torch_cuda.py):
#: float32 values of O(1): RTOL, plus an absolute floor for the few that
#: cancel to near zero (an attention output, a rotated pair, a GELU), where
#: two float32 sums of O(1) terms in another order sit ~1e-7 apart and a
#: relative test alone would fail
F32_ATOL = 1e-6
#: bfloat16 outputs of two float32 computations: within one bf16 ulp
#: (8 bits of mantissa), where the float32 values straddle a rounding
#: boundary
BF16_RTOL = 2.0**-7
#: float32 model logits against the JAX package (measured JAX-vs-JAX
#: between its "pallas" and "chunked" prefill on qwen1.5-4b SMOKE: 2.1e-6)
LOGITS_F32 = dict(rtol=1e-4, atol=1e-5)
#: bf16 model logits: from the 2.7e-2 measured between two correct JAX
#: paths ("pallas" and "chunked") on qwen1.5-4b SMOKE
LOGITS_BF16_ATOL = 5e-2


def attn_tol(dtype) -> dict:
    """Tolerance of an attention output of ``dtype`` against another
    float32-inside computation of the same function."""
    rtol = BF16_RTOL if dtype == torch.bfloat16 else RTOL
    return dict(rtol=rtol, atol=F32_ATOL)


def as_np(x) -> np.ndarray:
    """A tensor or array (bf16 included) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(np.asarray(x).astype(np.float32))


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
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# XLA's log1p for the port (tests/test_torch_market.py,
# tests/test_torch_regions.py): XLA's and PyTorch's CPU log1p each round
# within one ulp, so whole runs are held bitwise, floats included, by
# handing the port XLA's own -log1p(-u) for every uniform the slab and the
# key samplers can produce (2^24 and 2^23 values, tabulated once a module),
# and XLA's own -log(-log(u)) for every uniform jax.random.gumbel can draw
# (2^23 values, on many of which XLA's log rounds apart from PyTorch's)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def xla_log1p_tables():
    import jax
    import jax.numpy as jnp

    neg_log1p = jax.jit(lambda u: -jnp.log1p(-u))
    slab = np.arange(2**24, dtype=np.float32) * np.float32(2.0**-24)
    key = ((np.arange(2**23, dtype=np.uint32) | 0x3F800000).view(np.float32)
           - np.float32(1.0))
    tiny = np.finfo(np.float32).tiny
    gumbel = jax.jit(lambda u: -jnp.log(-jnp.log(
        jnp.maximum(tiny, u + tiny))))
    return (torch.from_numpy(np.array(neg_log1p(slab))),
            torch.from_numpy(np.array(neg_log1p(key))),
            torch.from_numpy(np.array(gumbel(key))))


@pytest.fixture
def xla_log1p(monkeypatch, xla_log1p_tables):
    from repro_torch.core import arrivals, clocks, threefry, waittime

    slab, key, gumbel_table = xla_log1p_tables

    def exp_from_u(u):  # u is a slab uniform: a multiple of 2^-24
        idx = (u.double() * 2**24).long()
        assert torch.equal(idx.double() * 2.0**-24, u.double())
        return slab[idx]

    def exponential(k, shape=()):  # the key sampler's 23-bit uniforms
        return key[threefry.bits32(k, shape) >> 9]

    def gumbel(k, n):  # jax.random.gumbel's uniforms on [tiny, 1)
        return gumbel_table[threefry.bits32(k, (n,)) >> 9]

    for mod in (clocks, arrivals, waittime):
        monkeypatch.setattr(mod, "exp_from_u", exp_from_u)
    monkeypatch.setattr(threefry, "exponential", exponential)
    monkeypatch.setattr(threefry, "gumbel", gumbel)
