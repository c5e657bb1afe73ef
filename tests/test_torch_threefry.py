"""The port's threefry and slab stream against ``jax.random``.

Tolerance: the hash, keys, split, raw bits, uniforms, ``randint`` and
slabs are bitwise JAX's; exponentials are within two ulps, because XLA and
PyTorch each round ``-log1p(-u)`` of the same uniform within one ulp of the
true value, on different sides (see tests/_torch_parity.py); Gumbel draws
are bitwise under XLA's own ``log`` (``xla_log1p``) and within a few ulps
(of a value near 0: an absolute 1e-6) with PyTorch's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from _torch_parity import ulps, xla_log1p, xla_log1p_tables  # noqa: F401
from repro.core import clocks as jclocks
from repro_torch.core import clocks, threefry

RNG = np.random.default_rng(20260)
KEYS = RNG.integers(0, 2**32, size=(6, 2), dtype=np.uint64).astype(np.uint32)


def jkey(raw):
    return jax.random.wrap_key_data(jnp.asarray(raw, jnp.uint32))


def words(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("i", range(len(KEYS)))
def test_threefry2x32_matches_jax(i):
    c = RNG.integers(0, 2**32, size=(2, 257), dtype=np.uint64)
    c = c.astype(np.uint32)
    ref = np.asarray(threefry_2x32(jnp.asarray(KEYS[i]),
                                   jnp.asarray(c.reshape(-1))))
    k = torch.from_numpy(KEYS[i].astype(np.int64))
    x0, x1 = threefry.threefry2x32(k[0], k[1],
                                   torch.from_numpy(words(c[0])),
                                   torch.from_numpy(words(c[1])))
    np.testing.assert_array_equal(torch.cat([x0, x1]).numpy(), words(ref))


@pytest.mark.parametrize("seed", [0, 7, 2026, 2**31 - 1])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(
        threefry.key(seed).numpy(),
        words(jax.random.key_data(jax.random.key(seed))))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16])
def test_split_matches_jax(n):
    ref = jax.vmap(lambda k: jax.random.key_data(jax.random.split(
        jax.random.wrap_key_data(k), n)))(jnp.asarray(KEYS))
    got = threefry.split(torch.from_numpy(words(KEYS)), n)
    assert got.shape == (len(KEYS), n, 2)
    np.testing.assert_array_equal(got.numpy(), words(ref))


@pytest.mark.parametrize("shape", [(), (7,), (5, 3), (2, 3, 4)])
def test_bits_uniform_exponential_match_jax(shape):
    for raw in KEYS:
        k = torch.from_numpy(raw.astype(np.int64))
        bits = jax.random.bits(jkey(raw), shape, jnp.uint32)
        np.testing.assert_array_equal(threefry.bits32(k, shape).numpy(),
                                      words(bits))
        np.testing.assert_array_equal(
            threefry.uniform(k, shape).numpy(),
            np.asarray(jax.random.uniform(jkey(raw), shape)))
        np.testing.assert_array_equal(
            threefry.uniform(k, shape, 0.3, 48.7).numpy(),
            np.asarray(jax.random.uniform(jkey(raw), shape, minval=0.3,
                                          maxval=48.7)))
        e = threefry.exponential(k, shape)
        np.testing.assert_array_equal(
            e.numpy(), (-torch.log1p(-threefry.uniform(k, shape))).numpy())
        assert ulps(e.numpy(),
                    jax.random.exponential(jkey(raw), shape)) <= 2


def test_exp_from_u_within_two_ulps():
    u = np.random.default_rng(1).random(100_000).astype(np.float32)
    ref = np.asarray(jax.jit(jclocks.exp_from_u)(u))
    assert ulps(clocks.exp_from_u(torch.from_numpy(u)).numpy(), ref) <= 2
    bits = RNG.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        clocks.u01(torch.from_numpy(words(bits))).numpy(),
        np.asarray(jclocks.u01(jnp.asarray(bits))))


@pytest.mark.parametrize("plan,n_cols", [
    ((16,), 1), ((512, 64, 64, 7), 3), ((5, 100, 37), 14), ((1, 1), 2)])
def test_lane_window_slabs_match_jax(plan, n_cols):
    ref = jax.vmap(lambda k: jclocks.lane_window_slabs(
        jax.random.wrap_key_data(k), plan, n_cols))(jnp.asarray(KEYS))
    lane_keys = torch.from_numpy(words(KEYS))
    got = clocks.lane_window_slabs(lane_keys, plan, n_cols)
    np.testing.assert_array_equal(got.numpy(), words(ref))
    # the kernel's key ladder gives the same slabs, window by window
    slab_keys, last = clocks.window_slab_keys(lane_keys, len(plan))
    for w, n_ev in enumerate(plan):
        np.testing.assert_array_equal(
            threefry.bits32(slab_keys[:, w], (n_ev, n_cols)).numpy(),
            got[:, w, :n_ev].numpy())
    key = lane_keys
    for n_ev in plan:
        key, _ = clocks.window_slab(key, n_ev, n_cols)
    np.testing.assert_array_equal(last.numpy(), key.numpy())


#: many keys, so that every residue of every span shows
MANY = jax.random.key_data(jax.random.split(jax.random.key(4), 4_096))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8])
def test_randint_matches_jax(n):
    """jax.random.randint(key, (), 0, n): the split key's two words reduced
    modulo n in uint32 arithmetic, bitwise, every value drawn."""
    ref = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.randint(
        jax.random.wrap_key_data(k), (), 0, n, jnp.int32)))(MANY))
    got = threefry.randint(torch.from_numpy(words(MANY)), 0, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(np.unique(ref)) == set(range(n))


@pytest.mark.parametrize("n", [1, 4, 8])
def test_gumbel_matches_jax(n, xla_log1p):
    """jax.random.gumbel(key, (n,)): its uniforms on [tiny, 1) bitwise (the
    key sampler's, on bits32's counters); the draws bitwise under XLA's
    log, and close under PyTorch's own."""
    ref = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.gumbel(
        jax.random.wrap_key_data(k), (n,), jnp.float32)))(MANY))
    keys = torch.from_numpy(words(MANY))
    np.testing.assert_array_equal(threefry.gumbel(keys, n).numpy(), ref)
    tiny = float(np.finfo(np.float32).tiny)
    u = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.uniform(
        jax.random.wrap_key_data(k), (n,), jnp.float32, tiny, 1.0)))(MANY))
    np.testing.assert_array_equal(
        threefry.uniform(keys, (n,), tiny, 1.0).numpy(), u)
    own = (-torch.log(-torch.log(torch.from_numpy(np.array(u))))).numpy()
    np.testing.assert_allclose(own, ref, rtol=1e-6, atol=1e-6)
