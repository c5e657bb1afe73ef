"""The split decode kernel's plain arithmetic, and the kernels' launch
choices, on the CPU.

``decode_attention_split_ref`` is the CUDA decode kernel's arithmetic in
plain PyTorch: float32 partials (m, l, acc) for each split of whole 32-key
chunks, then the combine.  It is held to the JAX package's Pallas
``decode_attention_bh`` (in interpret mode, as tests/test_kernels.py runs
it) and to the unsplit plain version, on inputs drawn from a seed with
numpy, at every split edge.  Tolerance: that of
``test_decode_plain_version_matches_jax_kernel`` (tests/_torch_parity.py):
float32 rtol 1e-5 with a 1e-6 floor near zero, bf16 within one ulp; the
split changes the order of the float32 sums, not what is summed.

The launch choices are pure functions of the shapes: the decode kernel's
split count (``split_count``) and the sweep kernel's threads a lane
(``group_size``), whose every pick must be a (G, slots a thread) pair the
kernel is built for.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_np, attn_tol
from repro.kernels.decode_attention.decode_attention import \
    decode_attention_bh as jax_decode_bh
from repro_torch.kernels.decode_attention import decode_attention as dec_mod
from repro_torch.kernels.decode_attention.ref import (
    NEG_INF, SPLIT_KEYS, decode_attention_bh_ref, decode_attention_split_ref,
    decode_split_partials, split_keys)
from repro_torch.kernels.sweep import sweep as sweep_mod

S, BH, BK = 256, 3, 64  # eight chunks, four tiles
SPLITS = (1, 2, 3, 7)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _fills(s: int) -> list[int]:
    """kv_len 0, 1, S and every split's first and last key, for every
    split count of SPLITS."""
    fills = {0, 1, s}
    for n in SPLITS:
        kps = split_keys(s, n)
        for j in range(n):
            if j * kps < s:
                fills |= {j * kps, min(s, (j + 1) * kps) - 1}
    return sorted(fills)


@functools.cache
def _inputs(g: int, d: int, dtype: str):
    rng = np.random.default_rng(1000 * g + d)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((BH, g, d), (BH, S, d), (BH, S, d))]


@functools.cache
def _jax_out(g: int, d: int, dtype: str, kv_len: int) -> np.ndarray:
    q, k, v = (jnp.asarray(x, DTYPES[dtype][0]) for x in _inputs(g, d, dtype))
    return as_np(jax_decode_bh(q, k, v, jnp.int32(kv_len), block_k=BK,
                               interpret=True))


def _torch_inputs(g, d, dtype):
    return [torch.from_numpy(x).to(DTYPES[dtype][1])
            for x in _inputs(g, d, dtype)]


CASES = ([(n, g, d, "float32") for n in SPLITS for g in (1, 4, 8)
          for d in (32, 64, 128)]
         + [(n, 4, 64, "bfloat16") for n in SPLITS])


@pytest.mark.parametrize("n_split,g,d,dtype", CASES,
                         ids=[f"n{n}-g{g}-d{d}-{t}" for n, g, d, t in CASES])
def test_split_ref_matches_jax_kernel(n_split, g, d, dtype):
    q, k, v = _torch_inputs(g, d, dtype)
    for kv_len in _fills(S):
        got = decode_attention_split_ref(q, k, v, kv_len, n_split,
                                         block_k=BK)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (BH, g, d)
        np.testing.assert_allclose(as_np(got), _jax_out(g, d, dtype, kv_len),
                                   err_msg=f"kv_len {kv_len}",
                                   **attn_tol(got.dtype))
        if kv_len == 0:
            np.testing.assert_array_equal(as_np(got), 0.0)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_unsplit_plain_version(n_split, dtype):
    """Against decode_attention_bh_ref (no tiles, no splits) at a cache
    that is no multiple of 32 keys and a tile of 40."""
    rng = np.random.default_rng(7)
    s, g, d = 200, 4, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(DTYPES[dtype][1])
               for shape in ((2, g, d), (2, s, d), (2, s, d)))
    for kv_len in _fills(s) + [39, 40, 41, 199]:
        got = decode_attention_split_ref(q, k, v, kv_len, n_split,
                                         block_k=40)
        want = decode_attention_bh_ref(q, k, v, kv_len)
        np.testing.assert_allclose(as_np(got), as_np(want),
                                   err_msg=f"kv_len {kv_len}",
                                   **attn_tol(got.dtype))


@pytest.mark.parametrize("kv_len", [0, 1, 63, 64, 65, 130, 256])
def test_split_partials_of_empty_splits(kv_len):
    """A split that starts at or past kv_len is (-1e30, 0, 0); a split
    that starts before it has its m from a real key; at kv_len 0 every
    split is empty and the combine gives zeros."""
    q, k, v = _torch_inputs(4, 32, "float32")
    n_split = 7  # 64 keys a split: the last three splits lie past S
    m, l, acc = decode_split_partials(q, k, v, kv_len, n_split, block_k=BK)
    starts = np.arange(n_split) * split_keys(S, n_split)
    empty = starts >= kv_len
    assert m.shape == l.shape == (BH, n_split, 4)
    assert acc.shape == (BH, n_split, 4, 32)
    np.testing.assert_array_equal(as_np(m)[:, empty], np.float32(NEG_INF))
    np.testing.assert_array_equal(as_np(l)[:, empty], 0.0)
    np.testing.assert_array_equal(as_np(acc)[:, empty], 0.0)
    assert np.all(as_np(m)[:, ~empty] > np.float32(NEG_INF))
    assert np.all(as_np(l)[:, ~empty] >= 1.0)  # the max key's own exp(0)


def test_split_keys_cover_the_cache_in_whole_chunks():
    for s in (32, 100, 544, 8192, 32_768):
        for n in (1, 2, 3, 7, 13, 64):
            kps = split_keys(s, n)
            chunks = -(-s // SPLIT_KEYS)
            assert kps == SPLIT_KEYS * -(-chunks // n)
            assert n * kps >= s


@pytest.mark.parametrize("s,bh", [(32, 1), (544, 80), (8192, 6),
                                  (32_768, 320), (32_768, 4096), (64, 512)])
def test_decode_split_count(s, bh):
    """At least one split, at least MIN_SPLIT_CHUNKS chunks a split where
    there are that many, and the grid at TARGET_BLOCKS or more where the
    cache has the chunks for it."""
    n = dec_mod.split_count(s, bh)
    chunks = -(-s // SPLIT_KEYS)
    assert 1 <= n <= max(1, chunks // dec_mod.MIN_SPLIT_CHUNKS)
    if chunks // dec_mod.MIN_SPLIT_CHUNKS >= -(-dec_mod.TARGET_BLOCKS // bh):
        assert n * bh >= dec_mod.TARGET_BLOCKS


#: the (G, slots a thread) pairs csrc/sweep.cu builds (launch_g)
BUILT = {(4, 1), (4, 2), (4, 4), (4, 8), (8, 8), (16, 8), (32, 8)}


def test_sweep_group_choice_over_rmax():
    """Every rmax the kernel takes gets a (G, slots a thread) pair the
    library is built for, the slots a power of two that covers rmax, and
    every built pair is some rmax's pick; G never shrinks as rmax grows;
    rmax 1 and 64 get the probe's picks."""
    last, picks = 0, set()
    for rmax in range(1, sweep_mod.MAX_RMAX + 1):
        g = sweep_mod.group_size(rmax)
        spt = sweep_mod.slots_per_thread(rmax, g)
        assert (g, spt) in BUILT
        assert spt & (spt - 1) == 0 and spt <= sweep_mod.SLOTS_A_THREAD
        assert g * spt >= rmax and g * spt <= 256
        assert g >= last
        last = g
        picks.add((g, spt))
    assert picks == BUILT
    assert sweep_mod.group_size(1) == sweep_mod.SMALL_GROUP
    assert sweep_mod.group_size(64) * sweep_mod.SLOTS_A_THREAD >= 64
    for bad in (0, sweep_mod.MAX_RMAX + 1):
        with pytest.raises(ValueError, match="rmax"):
            sweep_mod.group_size(bad)


def test_sweep_warps_a_block():
    """Powers of two up to 4, and a block for every SM where the fleet
    has the warps for it, on cards of 132 and 114 SMs."""
    for sms in (132, 114):
        for lanes in (1, 13, 96, 4096, 65_536):
            for g in (4, 8, 16, 32):
                wpb = sweep_mod.warps_per_block(lanes, g, sms)
                warps = -(-lanes * g // 32)
                assert wpb in (1, 2, 4)
                if warps >= sms:
                    assert -(-warps // wpb) >= sms
