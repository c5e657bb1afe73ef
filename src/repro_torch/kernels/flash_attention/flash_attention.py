"""ctypes wrappers of the port's two hand-written CUDA flash-attention
kernels, the port of the JAX package's Pallas ``flash_attention_bh``.

Two routes, chosen by :func:`route` from the input type and head dim:

- ``"tc"``: bf16 with D in :data:`TC_HEAD_DIMS`, the tensor-core kernel
  (csrc/flash_attention_tc.cu: wgmma, K/V fed by TMA), which rounds P to
  bf16 before P·V;
- ``"simt"``: float32 and every other shape, the CUDA-core kernel
  (csrc/flash_attention.cu), float32 throughout.

``flash_attention_bh(..., route=...)`` takes an explicit route; a ``"tc"``
the tensor-core kernel cannot take raises ``ValueError`` before anything
touches the card.  Each wrapper checks device, type, shape and contiguity,
allocates the output with ``torch.empty`` and launches on the current
stream; a launch the driver refuses raises.  Each library is built with
``nvcc`` from the repository's source at first use
(:mod:`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import KernelLibrary, load

_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = KernelLibrary("flash_attention", _CSRC / "flash_attention.cu")
TC_LIBRARY = KernelLibrary("flash_attention_tc",
                           _CSRC / "flash_attention_tc.cu")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the CUDA-core kernel keeps D/32 accumulators a lane (at most 4) and
#: reads 8 at once
MAX_HEAD_DIM = 128
#: head dims of the tensor-core kernel (bf16 only): wgmma's N for P·V
TC_HEAD_DIMS = (64, 128)
ROUTES = ("tc", "simt")
#: the tensor-core kernel's query rows a block
TC_ROWS = 128


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a (type, head dim) goes to: ``"tc"`` for bf16 with a head
    dim in :data:`TC_HEAD_DIMS`, else ``"simt"``."""
    return ("tc" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
            else "simt")


def _resolve_route(dtype: torch.dtype, head_dim: int,
                   explicit: Optional[str]) -> str:
    """:func:`route`, or ``explicit`` where the kernel it names takes the
    inputs; raises ``ValueError`` where it does not."""
    if explicit is None:
        return route(dtype, head_dim)
    if explicit not in ROUTES:
        raise ValueError(f"flash kernel: route must be one of {ROUTES}, got "
                         f"{explicit!r}")
    if explicit == "tc" and route(dtype, head_dim) != "tc":
        raise ValueError(f"flash kernel: the tensor-core route takes bf16 "
                         f"with D in {TC_HEAD_DIMS}, got {dtype} D={head_dim}")
    return explicit


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
    """Dynamic shared memory of one block of the CUDA-core kernel, in
    bytes."""
    return _library().flash_attention_smem_bytes(_DTYPES[dtype], head_dim)


def tiles(sq: int, sk: int, block_q: int, block_k: int) -> tuple[int, int]:
    """The (bq, bk) tiling of the JAX wrapper; raises where the lengths do
    not tile."""
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"Sq={sq}/Sk={sk} must tile by ({bq},{bk})")
    return bq, bk


@functools.cache
def _tc_library() -> ctypes.CDLL:
    lib = load(TC_LIBRARY)
    lib.flash_attention_tc_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                        ctypes.c_void_p])
    lib.flash_attention_tc_launch.restype = ctypes.c_int
    lib.flash_attention_tc_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_tc_error_string.restype = ctypes.c_char_p
    lib.flash_attention_tc_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_attention_tc_smem_bytes.restype = ctypes.c_int
    return lib


def tc_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block of the tensor-core kernel."""
    return _tc_library().flash_attention_tc_smem_bytes(head_dim)


def flash_attention_bh(q, k, v, *, causal: bool = True, block_q: int = 128,
                       block_k: int = 128, q_offset: int = 0,
                       sk_valid: Optional[int] = None,
                       route: Optional[str] = None) -> torch.Tensor:
    """q (BH, g, Sq, D); k/v (BH, Sk, D) CUDA tensors -> (BH, g, Sq, D),
    through the kernel of ``route`` (by default :func:`route`'s choice)."""
    BH, g, Sq, D = q.shape
    Sk = k.shape[1]
    bq, bk = tiles(Sq, Sk, block_q, block_k)
    chosen = _resolve_route(q.dtype, D, route)
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
    launch = flash_attention_tc if chosen == "tc" else flash_attention_simt
    out = launch(q, k, v, bq=bq, bk=bk, causal=causal, q_offset=q_offset,
                 sk_valid=Sk if sk_valid is None else sk_valid)
    flash_attention_bh.launches += 1
    return out


def flash_attention_simt(q, k, v, *, bq: int, bk: int, causal: bool,
                         q_offset: int, sk_valid: int) -> torch.Tensor:
    """The CUDA-core kernel on inputs ``flash_attention_bh`` has checked."""
    BH, g, Sq, D = q.shape
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], BH, g, Sq, k.shape[1], D, bq, bk, int(causal),
            q_offset, sk_valid, 1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    flash_attention_simt.launches += 1
    return out


def flash_attention_tc(q, k, v, *, bq: int, bk: int, causal: bool,
                       q_offset: int, sk_valid: int) -> torch.Tensor:
    """The tensor-core kernel on inputs ``flash_attention_bh`` has checked
    (bf16, D in TC_HEAD_DIMS); TMA and its 16-byte loads need 16-byte
    aligned tensors."""
    BH, g, Sq, D = q.shape
    blocks = BH * -(-g * bq // TC_ROWS) * (Sq // bq)
    if blocks >= 2**31:
        raise ValueError(f"flash kernel: {blocks} blocks exceed the grid")
    out = torch.empty_like(q)
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} must be 16-byte aligned "
                             f"for the tensor-core route")
    lib = _tc_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, g,
            Sq, k.shape[1], D, bq, bk, int(causal), q_offset, sk_valid,
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash kernel (tensor cores) launch failed: "
            f"{lib.flash_attention_tc_error_string(rc).decode()}")
    flash_attention_tc.launches += 1
    return out


#: launches since each count was last set to 0: all routes, and each route
flash_attention_bh.launches = 0
flash_attention_simt.launches = 0
flash_attention_tc.launches = 0
