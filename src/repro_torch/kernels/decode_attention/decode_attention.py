"""ctypes wrapper of the hand-written CUDA decode-attention kernel
(csrc/decode_attention.cu), the port of the JAX package's Pallas
``decode_attention_bh``.

``kv_len`` reaches the kernel as one int32 on the device, so one build
serves every fill level.  The wrapper checks device, type, shape and
contiguity, allocates the output with ``torch.empty`` and launches on the
current stream; a launch the driver refuses raises.  The library is built
with ``nvcc`` from the repository's source at first use
(:mod:`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary, load

LIBRARY = KernelLibrary(
    "decode_attention",
    Path(__file__).resolve().parent / "csrc" / "decode_attention.cu")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: D/32 accumulators a lane (at most 4), read 8 at once; g rows in registers
MAX_HEAD_DIM, MAX_GROUP = 128, 8


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(LIBRARY)
    lib.decode_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
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


def decode_attention_bh(q, k, v, kv_len, *, block_k: int = 512
                        ) -> torch.Tensor:
    """q (BH, g, D); k/v (BH, S, D) CUDA tensors; ``kv_len`` an int or an
    int32 scalar tensor on the same device -> (BH, g, D)."""
    BH, g, D = q.shape
    S = k.shape[1]
    bk = tile(S, block_k)
    for name, x, shape in (("q", q, (BH, g, D)), ("k", k, (BH, S, D)),
                           ("v", v, (BH, S, D))):
        if x.device.type != "cuda" or x.dtype not in _DTYPES:
            raise ValueError(f"decode kernel: {name} must be a float32 or "
                             f"bfloat16 CUDA tensor, got {x.dtype} on "
                             f"{x.device}")
        if x.dtype != q.dtype or tuple(x.shape) != shape:
            raise ValueError(f"decode kernel: {name} must be {q.dtype} of "
                             f"shape {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"decode kernel: {name} must be contiguous")
    if D % 8 or D > MAX_HEAD_DIM or not 1 <= g <= MAX_GROUP or BH < 1:
        raise ValueError(f"decode kernel: needs D % 8 == 0, D <= "
                         f"{MAX_HEAD_DIM}, 1 <= g <= {MAX_GROUP} and BH >= 1, "
                         f"got D={D}, g={g}, BH={BH}")
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
    if kv_len.numel() != 1:
        raise ValueError("decode kernel: kv_len must be a scalar")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv_len.data_ptr(), _DTYPES[q.dtype], BH, g, S, D, bk,
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"decode kernel launch failed: "
                           f"{lib.decode_attention_error_string(rc).decode()}")
    decode_attention_bh.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
decode_attention_bh.launches = 0
