"""ctypes wrapper of the hand-written CUDA decode-attention kernel
(csrc/decode_attention.cu), the port of the JAX package's Pallas
``decode_attention_bh``.

The kernel splits the cache (flash-decoding): a grid of (B·KH, n_split)
blocks writes one float32 partial (m, l, acc) a split to a scratch buffer,
and the block that finishes a row last (an atomic ticket a row) merges
them, so a call is one launch.  :func:`split_count` picks ``n_split`` from
the capacity S and B·KH.  ``kv_len`` reaches the kernel as one int32 on
the device, so one build serves every fill level.  The wrapper checks
device, type, shape, contiguity and alignment, allocates the output and
the scratch with ``torch.empty``, keeps the tickets of each stream and
launches on the current stream; a launch the driver refuses raises.  The
library is built with ``nvcc`` from the repository's source at first use
(:mod:`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary, load
from repro_torch.kernels.decode_attention.ref import SPLIT_KEYS, split_keys

LIBRARY = KernelLibrary(
    "decode_attention",
    Path(__file__).resolve().parent / "csrc" / "decode_attention.cu")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: D/32 accumulators a lane (at most 4), read 8 at once; g rows in registers
MAX_HEAD_DIM, MAX_GROUP = 128, 8
#: split blocks the grid aims at: two blocks fit an SM (bf16, D 128), so
#: this is ~16 waves of the 132 SMs, enough that the last, partial wave
#: costs little
TARGET_BLOCKS = 4096
#: chunks of 32 keys a split takes at least: two for each of its two warps
MIN_SPLIT_CHUNKS = 4


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(LIBRARY)
    lib.decode_attention_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                       ctypes.c_void_p])
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    lib.decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.decode_attention_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(dtype: torch.dtype, group: int, head_dim: int) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes."""
    return _library().decode_attention_smem_bytes(_DTYPES[dtype], group,
                                                  head_dim)


def tile(s: int, block_k: int) -> int:
    """The JAX wrapper's KV tile; raises where the cache does not tile."""
    bk = min(block_k, s)
    if s % bk:
        raise ValueError(f"S={s} must tile by {bk}")
    return bk


def split_count(s: int, bh: int) -> int:
    """Splits of a cache of ``s`` slots for ``bh`` rows: enough that the
    grid reaches ``TARGET_BLOCKS``, but no fewer than ``MIN_SPLIT_CHUNKS``
    chunks a split (and one split at least)."""
    chunks = -(-s // SPLIT_KEYS)
    want = -(-TARGET_BLOCKS // bh)
    return max(1, min(want, chunks // MIN_SPLIT_CHUNKS, 65_535))


#: the tickets of each (device, stream): int32 a row that the kernel sets
#: back to zero at the end of a launch; launches on one stream run in turn,
#: so they can share them
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, rows: int) -> torch.Tensor:
    t = _TICKETS.get((device.index, stream))
    if t is None or t.numel() < rows:
        # zeroed on the stream that will use them
        t = _TICKETS[device.index, stream] = torch.zeros(
            max(rows, 1024), dtype=torch.int32, device=device)
    return t


def decode_attention_bh(q, k, v, kv_len, *, block_k: int = 512
                        ) -> torch.Tensor:
    """q (BH, g, D); k/v (BH, S, D) CUDA tensors; ``kv_len`` an int or an
    int32 scalar tensor on the same device -> (BH, g, D).  The cache is cut
    into :func:`split_count` splits."""
    BH, g, D = q.shape
    S = k.shape[1]
    bk = tile(S, block_k)
    # the checks read each attribute once: at a small cache a call's host
    # time, not the kernel, sets its pace
    dtype, device = q.dtype, q.device
    if not (q.is_cuda and dtype in _DTYPES and k.dtype == dtype == v.dtype
            and k.device == device == v.device):
        raise ValueError(f"decode kernel: q, k and v must be float32 or "
                         f"bfloat16 CUDA tensors of one type on one device, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype} on "
                         f"{q.device}/{k.device}/{v.device}")
    if k.shape != (BH, S, D) or v.shape != (BH, S, D):
        raise ValueError(f"decode kernel: k and v must be of shape "
                         f"{(BH, S, D)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode kernel: q, k and v must be contiguous")
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (kp | vp) % 16:
        raise ValueError("decode kernel: k and v must be 16-byte aligned")
    if D % 8 or D > MAX_HEAD_DIM or not 1 <= g <= MAX_GROUP or BH < 1:
        raise ValueError(f"decode kernel: needs D % 8 == 0, D <= "
                         f"{MAX_HEAD_DIM}, 1 <= g <= {MAX_GROUP} and BH >= 1, "
                         f"got D={D}, g={g}, BH={BH}")
    n_split = split_count(S, BH)
    if not (isinstance(kv_len, torch.Tensor) and kv_len.dtype == torch.int32
            and kv_len.device == device):
        kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=device)
    if kv_len.numel() != 1:
        raise ValueError("decode kernel: kv_len must be a scalar")
    out = torch.empty_like(q)
    part = torch.empty(BH * n_split * g * (D + 2), dtype=torch.float32,
                       device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (qp, kp, vp, out.data_ptr(), part.data_ptr(),
            _tickets(device, stream, BH).data_ptr(), kv_len.data_ptr(),
            _DTYPES[dtype], BH, g, S, D, bk, n_split, split_keys(S, n_split),
            1.0 / math.sqrt(D), stream)
    lib = _library()
    # the launch needs q's device current; switch only where it is not
    if device.index == torch.cuda.current_device():
        rc = lib.decode_attention_launch(*args)
    else:
        with torch.cuda.device(device):
            rc = lib.decode_attention_launch(*args)
    if rc != 0:
        raise RuntimeError(f"decode kernel launch failed: "
                           f"{lib.decode_attention_error_string(rc).decode()}")
    decode_attention_bh.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
decode_attention_bh.launches = 0
