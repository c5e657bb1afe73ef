"""The port's attention kernels' plain versions and layers against JAX.

Inputs are drawn from a seed with numpy and go through the JAX function
and the port's counterpart.  The JAX side runs its Pallas kernels as
tests/test_kernels.py runs them on the CPU (``interpret=True``); the port
runs on CPU tensors, where ``ops.flash_attention`` and
``ops.decode_attention`` take the kernels' plain versions.

Tolerance (tests/_torch_parity.py): float32 attention outputs rtol 1e-5
with a 1e-6 floor for outputs near zero; bf16 outputs within one bf16 ulp
(rtol 2^-7), since both sides compute in float32 and round once; the
float32 layers rtol 1e-5 (RoPE and the GELU MLP with the same 1e-6 floor
near zero).  The plain version's bf16-P rounding twin (the tensor-core
kernel's rounding) stays within 2^-9·max|v| of it, the bound rounding each
probability to bf16 gives.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_ATOL, RTOL, as_np, attn_tol
from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode_kernel
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.layers import attention as jattn
from repro.layers import mlp as jmlp
from repro.layers import norms as jnorms
from repro.layers import rotary as jrotary
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.layers import attention as tattn
from repro_torch.layers import mlp as tmlp
from repro_torch.layers import norms as tnorms
from repro_torch.layers import rotary as trotary

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """The same float32 numpy values as a JAX array and a CPU tensor of
    ``dtype`` (both round float32 to bf16 to nearest even)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _normals(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(ref, got, dtype):
    np.testing.assert_allclose(as_np(got), as_np(ref),
                               **attn_tol(DTYPES[dtype][1]))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FA_CASES = [
    # tests/test_kernels.py's FA_CASES: (B, Sq, Sk, H, KH, D, causal, bq, bk)
    (2, 128, 128, 8, 2, 64, True, 64, 64),
    (1, 256, 256, 4, 4, 32, True, 128, 128),
    (2, 64, 256, 8, 1, 64, False, 32, 64),
    (1, 128, 384, 6, 2, 128, True, 64, 128),
    (1, 64, 64, 2, 2, 16, True, 64, 64),  # single-tile path
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_plain_version_matches_jax_kernel(case, dtype):
    B, Sq, Sk, H, KH, D, causal, bq, bk = case
    q, k, v = _normals(0, (B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    off = Sk - Sq if causal else 0
    ref = jax_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                    q_offset=off, interpret=True)
    got = fa_ops.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                                 block_k=bk, q_offset=off)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, Sq, H, D)
    _close(ref, got, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_offset_and_valid_keys(dtype, causal):
    """q_offset > 0 and keys masked past sk_valid < Sk."""
    B, Sq, Sk, H, KH, D, off, valid = 1, 64, 192, 4, 2, 32, 40, 150
    q, k, v = _normals(1, (B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    kw = dict(causal=causal, block_q=32, block_k=64, q_offset=off,
              sk_valid=valid)
    ref = jax_flash(jq, jk, jv, interpret=True, **kw)
    got = fa_ops.flash_attention(tq, tk, tv, **kw)
    _close(ref, got, dtype)


def test_flash_rejects_bad_tiling():
    q = torch.zeros(1, 100, 4, 32)
    k = torch.zeros(1, 128, 4, 32)
    with pytest.raises(ValueError, match="must tile"):
        fa_ops.flash_attention(q, k, k, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="must tile"):
        fa_ops.flash_attention(k, torch.zeros(1, 200, 4, 32),
                               torch.zeros(1, 200, 4, 32))


def _plain_before_the_twin(q, k, v, *, causal, q_offset, sk_valid=None):
    """The plain version as it stood before it grew ``p_dtype``: masked
    scores, ``torch.softmax``, ``p·v`` in float32."""
    Sq, D, Sk = q.shape[2], q.shape[3], k.shape[1]
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) / math.sqrt(D)
    kpos = torch.arange(Sk)
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= (q_offset + torch.arange(Sq))[:, None] >= kpos[None, :]
    if sk_valid is not None:
        mask &= kpos[None, :] < sk_valid
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bgqk,bkd->bgqd", p, v.float()).to(q.dtype)


def _grouped(case, dtype, seed=0):
    B, Sq, Sk, H, KH, D, causal, _, _ = case
    q, k, v = _normals(seed, (B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D))
    return fa_ref.to_groups(*(torch.from_numpy(x).to(DTYPES[dtype][1])
                              for x in (q, k, v)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_plain_version_without_p_dtype_is_unchanged(case, dtype):
    """p_dtype=None is bit for bit the plain version the kernels and the
    JAX package were held to before the tensor-core route."""
    causal, Sk, Sq = case[6], case[2], case[1]
    q, k, v = _grouped(case, dtype)
    kw = dict(causal=causal, q_offset=Sk - Sq if causal else 0)
    got = fa_ref.flash_attention_bh_ref(q, k, v, p_dtype=None, **kw)
    torch.testing.assert_close(got, _plain_before_the_twin(q, k, v, **kw),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_bf16_p_twin_within_its_bound(case):
    """Rounding P to bf16 moves each probability by at most 2^-9 of
    itself, so the output by at most 2^-9·max|v| (and float32 sums in
    another order, 1e-5); the twin does move it."""
    causal, Sk, Sq = case[6], case[2], case[1]
    q, k, v = _grouped(case, "float32", seed=4)
    kw = dict(causal=causal, q_offset=Sk - Sq if causal else 0)
    plain = fa_ref.flash_attention_bh_ref(q, k, v, **kw)
    twin = fa_ref.flash_attention_bh_ref(q, k, v, p_dtype=torch.bfloat16,
                                         **kw)
    dist = float((twin - plain).abs().max())
    assert 0 < dist <= 2.0**-9 * float(v.abs().max()) + 1e-5
    tol, floor = fa_ref.tc_tolerance(plain, twin)
    assert floor == dist and tol == dict(rtol=2.0**-7, atol=2 * dist)


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 96, "simt"),
    (torch.bfloat16, 16, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 64, "simt")])
def test_flash_route_by_type_and_head_dim(dtype, head_dim, want):
    assert fa_mod.route(dtype, head_dim) == want


@pytest.mark.parametrize("dtype,head_dim", [
    (torch.float32, 128), (torch.bfloat16, 32), (torch.float32, 64)])
def test_flash_explicit_tensor_core_route_raises_before_the_card(dtype,
                                                               head_dim):
    """An explicit "tc" the tensor-core kernel cannot take raises on CPU
    tensors, before any device check or launch."""
    q = torch.zeros(1, 2, 16, head_dim, dtype=dtype)
    k = torch.zeros(1, 16, head_dim, dtype=dtype)
    before = fa_mod.flash_attention_bh.launches
    with pytest.raises(ValueError, match="tensor-core route"):
        fa_mod.flash_attention_bh(q, k, k, route="tc")
    with pytest.raises(ValueError, match="route must be"):
        fa_mod.flash_attention_bh(q, k, k, route="wgmma")
    assert fa_mod.flash_attention_bh.launches == before


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
DEC_CASES = [
    # tests/test_kernels.py's DEC_CASES: (B, S, H, KH, D, kv_len, bk),
    # kv_len 200 and 700 inside a tile, and 1
    (2, 256, 8, 2, 64, 200, 64),
    (1, 512, 4, 1, 128, 512, 128),
    (3, 128, 6, 6, 32, 1, 32),
    (2, 1024, 8, 2, 64, 700, 256),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DEC_CASES)
def test_decode_plain_version_matches_jax_kernel(case, dtype):
    B, S, H, KH, D, kvl, bk = case
    q, k, v = _normals(2, (B, 1, H, D), (B, S, KH, D), (B, S, KH, D))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    ref = jax_decode_kernel(jq, jk, jv, jnp.int32(kvl), block_k=bk,
                            interpret=True)
    got = dec_ops.decode_attention(tq, tk, tv, kvl, block_k=bk)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, 1, H, D)
    _close(ref, got, dtype)


def test_decode_plain_version_empty_cache_gives_zeros():
    """kv_len = 0: the TPU kernel skips every tile and returns zeros."""
    q, k, v = _normals(3, (2, 1, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, "float32") for x in (q, k, v))
    ref = jax_decode_kernel(jq, jk, jv, jnp.int32(0), block_k=32,
                            interpret=True)
    got = dec_ops.decode_attention(tq, tk, tv, 0, block_k=32)
    np.testing.assert_array_equal(as_np(ref), 0.0)
    np.testing.assert_array_equal(as_np(got), 0.0)


def test_decode_rejects_bad_tiling():
    q = torch.zeros(1, 1, 4, 32)
    k = torch.zeros(1, 544, 4, 32)
    with pytest.raises(ValueError, match="must tile"):
        dec_ops.decode_attention(q, k, k, 10)


# ---------------------------------------------------------------------------
# layers (float32)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gated", [False, True])
def test_rms_norm_matches_jax(gated):
    x, z, scale = _normals(4, (2, 5, 48), (2, 5, 48), (48,))
    jp, tp = {"scale": jnp.asarray(scale)}, {"scale": torch.from_numpy(scale)}
    if gated:  # Mamba2's output norm, RMSNorm(x * silu(z))
        ref = jnorms.gated_rms_norm(jp, jnp.asarray(x), jnp.asarray(z))
        got = tnorms.gated_rms_norm(tp, torch.from_numpy(x),
                                    torch.from_numpy(z))
    else:
        ref = jnorms.rms_norm(jp, jnp.asarray(x))
        got = tnorms.rms_norm(tp, torch.from_numpy(x))
    np.testing.assert_allclose(as_np(got), as_np(ref), rtol=RTOL, atol=0)


def test_apply_rope_matches_jax():
    (x,) = _normals(5, (2, 24, 3, 32))
    pos = np.stack([np.arange(24), np.arange(100, 124)]).astype(np.int32)
    ref = jrotary.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = trotary.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             10_000.0)
    np.testing.assert_allclose(as_np(got), as_np(ref), rtol=RTOL,
                               atol=F32_ATOL)


@pytest.mark.parametrize("variant", ["swiglu", "gelu"])
def test_mlp_matches_jax(variant):
    params = jmlp.mlp_init(jax.random.key(0), 32, 64, dtype=jnp.float32,
                           variant=variant)
    (x,) = _normals(6, (2, 5, 32))
    ref = jmlp.mlp(params, jnp.asarray(x))
    got = tmlp.mlp({n: torch.from_numpy(np.array(w))
                    for n, w in params.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(as_np(got), as_np(ref), rtol=RTOL,
                               atol=F32_ATOL)


def test_qkv_project_with_bias_matches_jax():
    D, H, KH, hd = 32, 4, 2, 16
    wq, wk, wv, bq, bk, bv, x = _normals(
        7, (D, H, hd), (D, KH, hd), (D, KH, hd), (H, hd), (KH, hd),
        (KH, hd), (2, 5, D))
    tree = dict(wq=wq, wk=wk, wv=wv, bq=bq, bk=bk, bv=bv)
    ref = jattn.qkv_project({n: jnp.asarray(a) for n, a in tree.items()},
                            jnp.asarray(x))
    got = tattn.qkv_project({n: torch.from_numpy(a) for n, a in tree.items()},
                            torch.from_numpy(x))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(as_np(g), as_np(r), rtol=RTOL, atol=0)


@pytest.mark.parametrize("chunk", [4096, 32])
def test_decode_attention_layer_with_self_kv_matches_jax(chunk):
    """The models' plain decode attention: a bf16 cache, the new token's
    own K/V folded in at float32, kv_len inside the last chunk."""
    B, S, H, KH, D, kvl = 2, 64, 4, 2, 16, 37
    q, k, v, kn, vn = _normals(8, (B, 1, H, D), (B, S, KH, D),
                               (B, S, KH, D), (B, 1, KH, D), (B, 1, KH, D))
    jk, tk = _pair(k, "bfloat16")
    jv, tv = _pair(v, "bfloat16")
    ref = jattn.decode_attention(jnp.asarray(q), jk, jv, jnp.int32(kvl),
                                 chunk=chunk,
                                 self_kv=(jnp.asarray(kn), jnp.asarray(vn)))
    got = tattn.decode_attention(torch.from_numpy(q), tk, tv, kvl,
                                 chunk=chunk,
                                 self_kv=(torch.from_numpy(kn),
                                          torch.from_numpy(vn)))
    np.testing.assert_allclose(as_np(got), as_np(ref), rtol=RTOL, atol=0)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_sequence_mixers_match_jax(impl):
    """naive and chunked attention (with padding to the chunk) in float32."""
    B, Sq, H, KH, D = 2, 40, 4, 2, 16
    q, k, v = _normals(9, (B, Sq, H, D), (B, Sq, KH, D), (B, Sq, KH, D))
    if impl == "naive":
        ref = jattn.naive_attention(*map(jnp.asarray, (q, k, v)), causal=True)
        got = tattn.naive_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=True)
    else:
        kw = dict(causal=True, q_chunk=16, k_chunk=16, block_skip=True)
        ref = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
        got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                      **kw)
    np.testing.assert_allclose(as_np(got), as_np(ref),
                               **attn_tol(torch.float32))
