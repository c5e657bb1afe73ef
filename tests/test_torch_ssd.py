"""The port's SSD layer against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.  The
JAX side runs its Pallas SSD kernel in interpret mode
(``repro.kernels.ssd.ops.ssd``) and its plain ``ssd_ref``/``ssd_chunked``;
the port runs ``kernels.ssd.ops.ssd`` (on CPU tensors: the plain chunked
scan, the kernel's stand-in), ``ssd_chunked`` and ``ssd_reference``.

Tolerance (stated once, used throughout):
- float32 scan outputs: rtol 1e-4, atol 5e-5.  The JAX package's own two
  paths (its Pallas kernel and its sequential reference) differ by up to
  1.1e-5 beyond rtol 1e-4 at N = 128 (sums of 128 products of O(1) terms
  in another order), and the port's chunked scan by 1.7e-5 from the JAX
  kernel there; 5e-5 leaves room for the order of summation only.
- bfloat16 scan outputs: within one bf16 ulp (rtol 2^-7, atol 1e-6): both
  sides compute in float32 from the same bf16 inputs and round once.
- a whole Mamba block, float32: rtol 1e-4, atol 1e-5 (measured 1.2e-6 at
  outputs of ~4); bfloat16, against JAX run op by op: one bf16 ulp.
- the tensor-core route's rounding twin (``ssd_tc_twin``): with rounding
  off, the float32 tolerance above; in bf16 its distance from the JAX
  kernel is held to ``twin_bound``, derived from its three roundings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import BF16_RTOL, F32_ATOL, as_np
from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.layers import ssm as jssm
from repro.layers.norms import gated_rms_norm as jax_gated_rms_norm
from repro_torch import convert
from repro_torch.kernels.ssd import (ForwardOnlyError, ops, route,
                                     ssd_chunked, ssd_cuda, ssd_ref,
                                     ssd_simt, ssd_tc, ssd_tc_twin,
                                     tc_tolerance)
from repro_torch.layers import ssm
from repro_torch.layers.norms import gated_rms_norm

SSD_F32 = dict(rtol=1e-4, atol=5e-5)
SSD_BF16 = dict(rtol=BF16_RTOL, atol=F32_ATOL)
BLOCK_F32 = dict(rtol=1e-4, atol=1e-5)

#: tests/test_kernels.py's SSD_CASES: (B, L, H, P, N, Q)
SSD_CASES = [
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 32, 64, 32),
    (2, 256, 4, 64, 32, 64),
    (1, 64, 8, 16, 128, 64),  # single chunk
]
DTYPES = {"float32": (jnp.float32, SSD_F32),
          "bfloat16": (jnp.bfloat16, SSD_BF16)}


def _inputs(seed, B, L, H, P, N, dtype=jnp.float32, a_log=None, d_skip=None):
    """(JAX arrays, port tensors) of x, dt, a_log, D, B, C, as the JAX
    kernel tests draw them: x·0.5, softplus dt, B and C ·0.3."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H))))
    b = rng.standard_normal((B, L, N)) * 0.3
    c = rng.standard_normal((B, L, N)) * 0.3
    a_log = (np.log(np.arange(1, H + 1)) if a_log is None else a_log)
    d_skip = np.ones(H) if d_skip is None else d_skip
    jx = (jnp.asarray(x, dtype), jnp.asarray(dt, jnp.float32),
          jnp.asarray(a_log, jnp.float32), jnp.asarray(d_skip, jnp.float32),
          jnp.asarray(b, dtype), jnp.asarray(c, dtype))
    return jx, [convert._tensor(np.asarray(v)) for v in jx]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_matches_jax(case, dtype):
    """ops.ssd, ssd_chunked and ssd_reference of the port against the JAX
    Pallas kernel (interpret mode) and its reference."""
    B, L, H, P, N, Q = case
    jdt, tol = DTYPES[dtype]
    jx, tx = _inputs(3, B, L, H, P, N, jdt)
    want = as_np(jax_ssd(*jx, chunk=Q))
    want_ref = as_np(jax_ssd_ref(*jx))
    got = ops.ssd(*tx, chunk=Q)
    assert got.dtype == tx[0].dtype and got.shape == (B, L, H, P)
    np.testing.assert_allclose(as_np(got), want, **tol)
    np.testing.assert_allclose(as_np(ssd_chunked(*tx, chunk=Q)), want, **tol)
    np.testing.assert_allclose(as_np(ssd_ref(*tx)), want_ref, **tol)
    np.testing.assert_allclose(as_np(got), want_ref, **tol)


@pytest.mark.parametrize("b,nc,h,p,n", [(1, 1, 1, 16, 16), (2, 3, 2, 32, 64),
                                        (1, 4, 4, 16, 64), (2, 2, 4, 32, 16)])
def test_ssd_property_shapes_match_jax(b, nc, h, p, n):
    """Shapes of the JAX package's test_ssd_property (Q 32, D 0)."""
    jx, tx = _inputs(nc * 13 + h, b, nc * 32, h, p, n, d_skip=np.zeros(h))
    want = as_np(jax_ssd(*jx, chunk=32))
    np.testing.assert_allclose(as_np(ops.ssd(*tx, chunk=32)), want, **SSD_F32)
    np.testing.assert_allclose(as_np(ssd_ref(*tx)), want, **SSD_F32)


def test_ssd_state_continuity_across_chunks():
    """Chunk boundaries are invisible: chunk 16 against chunk 128 (A = -1,
    D = 0), in the port and against JAX."""
    H = 2
    jx, tx = _inputs(9, 1, 128, H, 16, 16, a_log=np.zeros(H),
                     d_skip=np.zeros(H))
    small = as_np(ops.ssd(*tx, chunk=16))
    np.testing.assert_allclose(small, as_np(ops.ssd(*tx, chunk=128)),
                               **SSD_F32)
    np.testing.assert_allclose(small, as_np(jax_ssd(*jx, chunk=16)),
                               **SSD_F32)


@pytest.mark.parametrize("L,Q", [(64, 16), (40, 16), (7, 16)])
def test_ssd_chunked_final_state_and_ragged_tail_match_jax(L, Q):
    """return_final, and a tail padded with dt = 0 (L % Q != 0)."""
    jx, tx = _inputs(5, 2, L, 3, 8, 8)
    jy, jh = jssm.ssd_chunked(*jx, chunk=Q, return_final=True)
    y, h = ssd_chunked(*tx, chunk=Q, return_final=True)
    assert h.dtype == torch.float32 and h.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(as_np(y), as_np(jy), **SSD_F32)
    np.testing.assert_allclose(as_np(h), as_np(jh), **SSD_F32)
    np.testing.assert_allclose(as_np(y), as_np(ssd_ref(*tx)), **SSD_F32)


def test_ssd_length_must_tile_by_the_chunk():
    _, tx = _inputs(0, 1, 48, 2, 8, 8)
    with pytest.raises(ValueError, match="must tile by chunk=32"):
        ops.ssd(*tx, chunk=32)
    with pytest.raises(ValueError, match="must tile by chunk=32"):
        jax_ssd(*_inputs(0, 1, 48, 2, 8, 8)[0], chunk=32)
    assert ops.ssd(*tx, chunk=64).shape == tx[0].shape  # Q = min(64, 48)


def test_ssd_kernel_entry_is_forward_only():
    """An input that requires grad raises, naming the missing backward;
    without grad mode it runs, and the chunked scan takes gradients."""
    _, tx = _inputs(1, 1, 32, 2, 8, 8)
    x = tx[0].clone().requires_grad_(True)
    with pytest.raises(ForwardOnlyError, match="no backward"):
        ops.ssd(x, *tx[1:], chunk=16)
    with torch.no_grad():
        ops.ssd(x, *tx[1:], chunk=16)
    ssd_chunked(x, *tx[1:], chunk=16).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_ssd_kernel_wrapper_takes_only_cuda_tensors():
    _, tx = _inputs(1, 1, 32, 2, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_cuda(*tx, chunk=16)


# ---------------------------------------------------------------------------
# the tensor-core route: its rounding twin, its tolerance, the route
# ---------------------------------------------------------------------------
#: the JAX kernel tests' SSD_CASES, a chunk of 96 (no multiple of 32 or
#: 64), and test_ssd_property's shapes (Q 32, D 0) as (B, L, H, P, N, Q)
TWIN_CASES = SSD_CASES + [(1, 192, 3, 64, 128, 96)]
TWIN_PROPERTY = [(1, 32, 1, 16, 16, 32), (2, 96, 2, 32, 64, 32),
                 (1, 128, 4, 16, 64, 32), (2, 64, 4, 32, 16, 32)]
#: bf16's unit roundoff: a value rounded to bf16 (8 significant bits) moves
#: by at most 2^-8 of itself
BF16_U = 2.0**-8


def twin_bound(tx, chunk, twin, want):
    """How far the bf16 twin may sit from the JAX kernel, element by
    element, from its three roundings.  Each term of y is rounded once
    (W, or the update's operand) or, through the state, twice (the
    operand, then h_prev), each time by at most BF16_U of itself; so the
    twin is within 2·BF16_U·T of the float32 scan, T = Σ|terms|, which is
    the chunked scan of |x|, |B|, |C| and |D| (every term nonnegative
    there, and |C_q·B_s| <= Σ_n |C_qn||B_sn|).  Both outputs are then
    rounded to bf16, BF16_U of each; the float32 sums of the two in other
    orders add at most the float32 tolerance, rtol 1e-4 of T and atol
    5e-5 (SSD_F32)."""
    x, dt, a_log, d_skip, b_in, c_in = tx
    terms = as_np(ssd_chunked(x.float().abs(), dt, a_log, d_skip.abs(),
                              b_in.float().abs(), c_in.float().abs(),
                              chunk=chunk))
    return ((2 * BF16_U + SSD_F32["rtol"]) * terms + SSD_F32["atol"]
            + BF16_U * (np.abs(as_np(twin)) + np.abs(as_np(want))))


def _twin_inputs(case, dtype):
    B, L, H, P, N, Q = case
    d_skip = np.zeros(H) if case in TWIN_PROPERTY else None
    jx, tx = _inputs(L * 7 + H, B, L, H, P, N, dtype, d_skip=d_skip)
    return jx, tx, Q


@pytest.mark.parametrize("case", TWIN_CASES + TWIN_PROPERTY)
def test_ssd_tc_twin_without_rounding_matches_chunked_and_jax(case):
    """With rounding off the twin is the chunked scan: against the port's
    ssd_chunked and the JAX Pallas kernel (interpret mode), float32."""
    jx, tx, Q = _twin_inputs(case, jnp.float32)
    got = as_np(ssd_tc_twin(*tx, chunk=Q, round_to=None))
    np.testing.assert_allclose(got, as_np(ssd_chunked(*tx, chunk=Q)),
                               **SSD_F32)
    np.testing.assert_allclose(got, as_np(jax_ssd(*jx, chunk=Q)), **SSD_F32)


@pytest.mark.parametrize("case", TWIN_CASES + TWIN_PROPERTY)
def test_ssd_tc_twin_bf16_within_its_rounding_bound_of_jax(case):
    """In bf16 the twin rounds (it differs from the unrounded twin) and
    stays within twin_bound of the JAX Pallas kernel (interpret mode)."""
    jx, tx, Q = _twin_inputs(case, jnp.bfloat16)
    twin = ssd_tc_twin(*tx, chunk=Q)
    assert twin.dtype == torch.bfloat16 and twin.shape == tx[0].shape
    want = as_np(jax_ssd(*jx, chunk=Q))
    got = as_np(twin)
    assert np.all(np.isfinite(got))
    bound = twin_bound(tx, Q, twin, want)
    assert np.all(np.abs(got - want) <= bound), float(
        (np.abs(got - want) - bound).max())
    unrounded = as_np(ssd_tc_twin(*tx, chunk=Q, round_to=None))
    assert np.abs(got - unrounded).max() > 0


def test_ssd_tc_tolerance_is_the_floor_rule():
    """rtol one bf16 ulp; atol the larger of 1e-6, twice the float32
    floor and twice the twin's largest distance from the plain version;
    the distance is returned."""
    plain = torch.tensor([1.0, -2.0, 0.5])
    twin = torch.tensor([1.0, -2.03125, 0.5078125])
    tol, dist = tc_tolerance(plain, twin, 1e-3)
    assert dist == 0.03125
    assert tol == dict(rtol=2.0**-7, atol=0.0625)
    assert tc_tolerance(plain, twin, 0.05)[0]["atol"] == 0.1
    assert tc_tolerance(plain, plain, 0.0)[0] == dict(rtol=2.0**-7,
                                                      atol=1e-6)
    tol, dist = tc_tolerance(plain.bfloat16(), twin.bfloat16(), 0.0)
    assert dist == 0.03125 and tol["atol"] == 0.0625


@pytest.mark.parametrize("dtype,P,N,Q,want", [
    (torch.bfloat16, 64, 128, 256, "tc"),   # mamba2-780m's layer
    (torch.bfloat16, 16, 16, 16, "tc"),
    (torch.bfloat16, 64, 128, 96, "tc"),
    (torch.bfloat16, 48, 80, 48, "tc"),
    (torch.float32, 64, 128, 256, "simt"),
    (torch.bfloat16, 8, 8, 16, "simt"),     # P, N no multiple of 16
    (torch.bfloat16, 64, 128, 40, "simt"),  # a chunk no multiple of 16
    (torch.bfloat16, 80, 128, 256, "simt"),
    (torch.bfloat16, 64, 144, 256, "simt"),
    (torch.bfloat16, 64, 128, 512, "simt"),
])
def test_ssd_route(dtype, P, N, Q, want):
    assert route(dtype, P, N, Q) == want


@pytest.mark.parametrize("case", TWIN_CASES)
def test_ssd_bf16_test_shapes_take_the_tensor_cores(case):
    B, L, H, P, N, Q = case
    assert route(torch.bfloat16, P, N, min(Q, L)) == "tc"


def test_ssd_explicit_route_the_kernel_cannot_take_raises():
    """Before any device check: an explicit "tc" on float32 or on a shape
    the tensor-core kernel does not take, and an unknown route."""
    _, tx = _inputs(1, 1, 32, 2, 8, 8)
    with pytest.raises(ValueError, match="tensor-core route takes bf16"):
        ssd_cuda(*tx, chunk=16, route="tc")
    bf = [t.bfloat16() if t.dim() in (3, 4) and t is not tx[1] else t
          for t in tx]
    with pytest.raises(ValueError, match="P=8 N=8"):
        ssd_cuda(*bf, chunk=16, route="tc")
    with pytest.raises(ValueError, match="route must be one of"):
        ssd_cuda(*tx, chunk=16, route="wgmma")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_cuda(*tx, chunk=16, route="simt")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_ops_on_the_cpu_runs_the_plain_chunked_scan(dtype):
    """CPU tensors take the plain chunked scan, bitwise, and launch no
    kernel on either route."""
    _, tx = _inputs(2, 2, 64, 2, 16, 32, dtype)
    counts = [f.launches for f in (ssd_cuda, ssd_tc, ssd_simt)]
    got = ops.ssd(*tx, chunk=32)
    assert torch.equal(got, ssd_chunked(*tx, chunk=32))
    assert [f.launches for f in (ssd_cuda, ssd_tc, ssd_simt)] == counts


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------
DIMS = jssm.SSMDims(d_model=128, d_inner=256, n_state=16, n_heads=16,
                    head_dim=16, conv_width=4, chunk=16)


def _block(dtype):
    """JAX ssm params (with random conv biases, A_log and D so that every
    term is exercised) and the same params as port tensors."""
    params = jssm.ssm_init(jax.random.key(1), DIMS, dtype=dtype)
    rng = np.random.default_rng(1)
    for name in ("conv_x_b", "conv_bc_b"):
        params[name] = jnp.asarray(
            rng.standard_normal(params[name].shape) * 0.1, dtype)
    params["D"] = jnp.asarray(rng.uniform(0.5, 1.5, DIMS.n_heads),
                              jnp.float32)
    return params, convert.tree_from_jax(jax.tree.map(np.asarray, params))


def _u(dtype, L=32, seed=0):
    u = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (2, L, DIMS.d_model)), dtype)
    return u, convert._tensor(np.asarray(u))


def _block_tol(dtype):
    return BLOCK_F32 if dtype == jnp.float32 else dict(rtol=BF16_RTOL,
                                                        atol=F32_ATOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_causal_conv_and_gated_norm_match_jax(dtype):
    params, tp = _block(dtype)
    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.standard_normal((2, 20, DIMS.d_inner)), dtype)
    z = jnp.asarray(rng.standard_normal((2, 20, DIMS.d_inner)), dtype)
    tu, tz = convert._tensor(np.asarray(u)), convert._tensor(np.asarray(z))
    with jax.disable_jit():
        conv = jssm.causal_conv(params["conv_x_w"], params["conv_x_b"], u)
        norm = jax_gated_rms_norm(params["norm"], u, z)
    got = ssm.causal_conv(tp["conv_x_w"], tp["conv_x_b"], tu)
    assert got.dtype == tu.dtype
    np.testing.assert_allclose(as_np(got), as_np(conv), **_block_tol(dtype))
    np.testing.assert_allclose(as_np(gated_rms_norm(tp["norm"], tu, tz)),
                               as_np(norm), **_block_tol(dtype))


@pytest.mark.parametrize("return_cache", [False, True])
@pytest.mark.parametrize("impl", ["pallas", "chunked", "ref"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mamba_block_matches_jax(dtype, impl, return_cache):
    """Both dispatch branches (the kernel only without a cache), the
    returned conv window and final state; JAX run op by op."""
    params, tp = _block(dtype)
    u, tu = _u(dtype)
    with jax.disable_jit():
        want = jssm.mamba_block(params, DIMS, u, impl=impl,
                                return_cache=return_cache)
    got = ssm.mamba_block(tp, ssm.SSMDims(*DIMS), tu, impl=impl,
                          return_cache=return_cache)
    if return_cache:
        (want, wcache), (got, gcache) = want, got
        assert gcache.conv.dtype == tu.dtype
        assert gcache.conv.shape == (2, 3, DIMS.conv_channels)
        np.testing.assert_allclose(as_np(gcache.conv), as_np(wcache.conv),
                                   **_block_tol(dtype))
        np.testing.assert_allclose(as_np(gcache.state), as_np(wcache.state),
                                   **SSD_F32)
    assert got.dtype == tu.dtype and got.shape == tu.shape
    np.testing.assert_allclose(as_np(got), as_np(want), **_block_tol(dtype))


def test_mamba_block_dispatch_reaches_the_kernel_only_without_a_cache(
        monkeypatch):
    calls = []
    real = ops.ssd
    monkeypatch.setattr(ops, "ssd", lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    _, tp = _block(jnp.float32)
    _, tu = _u(jnp.float32)
    dims = ssm.SSMDims(*DIMS)
    ssm.mamba_block(tp, dims, tu, impl="pallas")
    ssm.mamba_block(tp, dims, tu, impl="pallas", return_cache=True)
    ssm.mamba_block(tp, dims, tu, impl="chunked")
    assert len(calls) == 1


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mamba_block_decode_matches_jax(dtype):
    """Three recurrent steps from a random cache: outputs, window, state."""
    params, tp = _block(dtype)
    u, tu = _u(dtype, L=3, seed=5)
    rng = np.random.default_rng(6)
    cache = jssm.SSMCache(
        conv=jnp.asarray(rng.standard_normal((2, 3, DIMS.conv_channels)),
                         dtype),
        state=jnp.asarray(rng.standard_normal(
            (2, DIMS.n_heads, DIMS.head_dim, DIMS.n_state)), jnp.float32))
    tcache = ssm.SSMCache(conv=convert._tensor(np.asarray(cache.conv)),
                          state=convert._tensor(np.asarray(cache.state)))
    dims = ssm.SSMDims(*DIMS)
    for t in range(3):
        with jax.disable_jit():
            want, cache = jssm.mamba_block_decode(params, DIMS,
                                                  u[:, t:t + 1], cache)
        got, tcache = ssm.mamba_block_decode(tp, dims, tu[:, t:t + 1], tcache)
        np.testing.assert_allclose(as_np(got), as_np(want),
                                   **_block_tol(dtype))
        np.testing.assert_allclose(as_np(tcache.conv), as_np(cache.conv),
                                   **_block_tol(dtype))
        np.testing.assert_allclose(as_np(tcache.state), as_np(cache.state),
                                   **SSD_F32)
