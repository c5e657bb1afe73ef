"""ctypes wrapper of the hand-written CUDA flash-attention kernel
(csrc/flash_attention.cu), the port of the JAX package's Pallas
``flash_attention_bh``.

The wrapper checks device, type, shape and contiguity, allocates the output
with ``torch.empty`` and launches on the current stream; a launch the
driver refuses raises.  The library is built with ``nvcc`` from the
repository's source at first use (:mod:`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import KernelLibrary, load

LIBRARY = KernelLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel keeps D/32 accumulators a lane (at most 4) and reads 8 at once
MAX_HEAD_DIM = 128


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(LIBRARY)
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                        ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes."""
    return _library().flash_attention_smem_bytes(_DTYPES[dtype], head_dim)


def tiles(sq: int, sk: int, block_q: int, block_k: int) -> tuple[int, int]:
    """The (bq, bk) tiling of the JAX wrapper; raises where the lengths do
    not tile."""
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"Sq={sq}/Sk={sk} must tile by ({bq},{bk})")
    return bq, bk


def flash_attention_bh(q, k, v, *, causal: bool = True, block_q: int = 128,
                       block_k: int = 128, q_offset: int = 0,
                       sk_valid: Optional[int] = None) -> torch.Tensor:
    """q (BH, g, Sq, D); k/v (BH, Sk, D) CUDA tensors -> (BH, g, Sq, D)."""
    BH, g, Sq, D = q.shape
    Sk = k.shape[1]
    bq, bk = tiles(Sq, Sk, block_q, block_k)
    for name, x, shape in (("q", q, (BH, g, Sq, D)), ("k", k, (BH, Sk, D)),
                           ("v", v, (BH, Sk, D))):
        if x.device.type != "cuda" or x.dtype not in _DTYPES:
            raise ValueError(f"flash kernel: {name} must be a float32 or "
                             f"bfloat16 CUDA tensor, got {x.dtype} on "
                             f"{x.device}")
        if x.dtype != q.dtype or tuple(x.shape) != shape:
            raise ValueError(f"flash kernel: {name} must be {q.dtype} of "
                             f"shape {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"flash kernel: {name} must be contiguous")
    if D % 8 or D > MAX_HEAD_DIM or not 1 <= BH <= 65535:
        raise ValueError(f"flash kernel: needs D % 8 == 0, D <= "
                         f"{MAX_HEAD_DIM} and 1 <= BH <= 65535, got D={D}, "
                         f"BH={BH}")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], BH, g, Sq, Sk, D, bq, bk, int(causal),
            q_offset, Sk if sk_valid is None else sk_valid,
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    flash_attention_bh.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
flash_attention_bh.launches = 0
