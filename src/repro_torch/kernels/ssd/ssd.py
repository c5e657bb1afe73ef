"""ctypes wrappers of the port's two hand-written CUDA SSD chunked-scan
kernels, the port of the JAX package's Pallas ``ssd_pallas``.

Two routes, chosen by :func:`route` from the input type and shape:

- ``"tc"``: bf16 with P, N and Q multiples of 16 (P <= 64, N <= 128, Q <=
  256), the tensor-core kernel (csrc/ssd_tc.cu: mma.sync, the chunk's B,
  C and x staged by cp.async), which rounds three intermediates to bf16
  (``ref.py::ssd_tc_twin``);
- ``"simt"``: float32 and every other shape, the CUDA-core kernel
  (csrc/ssd.cu), float32 throughout.

``ssd_cuda(..., route=...)`` takes an explicit route; a ``"tc"`` the
tensor-core kernel cannot take raises ``ValueError`` before anything
touches the card.  The wrapper checks device, type, shape and strides,
allocates the output with ``torch.empty`` and launches on the current
stream; a launch that CUDA refuses raises.  Each library is built with
``nvcc`` from the repository's source at first use
(:mod:`repro_torch.kernels._build`); a failed build raises, and no route
gives way to another.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import KernelLibrary, load

_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = KernelLibrary("ssd", _CSRC / "ssd.cu")
TC_LIBRARY = KernelLibrary("ssd_tc", _CSRC / "ssd_tc.cu")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' tiles are laid out for P <= 64 and N <= 128 (the CUDA-core
#: kernel: 16 threads x 4 columns, 16 threads x 8 state rows; the
#: tensor-core kernel: four 16-row strips of h, four 32-column quarters)
MAX_HEAD_DIM, MAX_STATE = 64, 128
#: the tensor-core kernel's largest chunk: 16 query strips of 16 rows for
#: its 16 warps, and the chunk's B, C and x in shared memory
TC_MAX_CHUNK = 256
ROUTES = ("tc", "simt")
#: dynamic shared memory a block may use on Hopper
MAX_SMEM = 232_448


def route(dtype: torch.dtype, head_dim: int, state: int, chunk: int) -> str:
    """The kernel a (type, P, N, Q) goes to: ``"tc"`` for bf16 with P, N
    and Q multiples of 16, P <= 64, N <= 128 and Q <= 256, else
    ``"simt"``."""
    dims = (head_dim, state, chunk)
    return ("tc" if dtype == torch.bfloat16
            and all(d > 0 and d % 16 == 0 for d in dims)
            and head_dim <= MAX_HEAD_DIM and state <= MAX_STATE
            and chunk <= TC_MAX_CHUNK else "simt")


def _resolve_route(dtype: torch.dtype, P: int, N: int, Q: int,
                   explicit: Optional[str]) -> str:
    """:func:`route`, or ``explicit`` where the kernel it names takes the
    inputs; raises ``ValueError`` where it does not."""
    if explicit is None:
        return route(dtype, P, N, Q)
    if explicit not in ROUTES:
        raise ValueError(f"ssd kernel: route must be one of {ROUTES}, got "
                         f"{explicit!r}")
    if explicit == "tc" and route(dtype, P, N, Q) != "tc":
        raise ValueError(f"ssd kernel: the tensor-core route takes bf16 with "
                         f"P, N and Q multiples of 16, P <= {MAX_HEAD_DIM}, "
                         f"N <= {MAX_STATE}, Q <= {TC_MAX_CHUNK}; got {dtype} "
                         f"P={P} N={N} Q={Q}")
    return explicit


class ForwardOnlyError(RuntimeError):
    """The SSD kernel has no backward, as the JAX package's Pallas kernel
    has none: ``jax.grad`` cannot differentiate ``ssd_pallas`` either.  A
    gradient goes through ``repro_torch.layers.ssm.ssd_chunked``."""


def check_forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ForwardOnlyError(
            "the SSD kernel is forward only (the JAX package's ssd_pallas "
            "has no backward either): take gradients through ssd_chunked")


def chunk_of(L: int, chunk: int) -> int:
    """The chunk length Q = min(chunk, L); raises where L does not tile."""
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"L={L} must tile by chunk={Q}")
    return Q


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(LIBRARY)
    lib.ssd_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.ssd_launch.restype = ctypes.c_int
    lib.ssd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_error_string.restype = ctypes.c_char_p
    lib.ssd_smem_bytes.argtypes = [ctypes.c_int]
    lib.ssd_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(chunk: int) -> int:
    """Dynamic shared memory of one block of the CUDA-core kernel at chunk
    length ``chunk``, in bytes (its tiles are laid out at the largest P
    and N)."""
    return _library().ssd_smem_bytes(chunk)


@functools.cache
def _tc_library() -> ctypes.CDLL:
    lib = load(TC_LIBRARY)
    lib.ssd_tc_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.ssd_tc_launch.restype = ctypes.c_int
    lib.ssd_tc_error_string.argtypes = [ctypes.c_int]
    lib.ssd_tc_error_string.restype = ctypes.c_char_p
    lib.ssd_tc_smem_bytes.argtypes = [ctypes.c_int]
    lib.ssd_tc_smem_bytes.restype = ctypes.c_int
    return lib


def tc_smem_bytes(chunk: int) -> int:
    """Dynamic shared memory of one block of the tensor-core kernel at
    chunk length ``chunk``, in bytes (laid out at the largest P and N)."""
    return _tc_library().ssd_tc_smem_bytes(chunk)


def ssd_cuda(x, dt, a_log, d_skip, b_in, c_in, *, chunk: int = 256,
             route: Optional[str] = None) -> torch.Tensor:
    """x (B, L, H, P) and b/c (B, L, N), float32 or bfloat16; dt (B, L, H),
    a_log and d_skip (H,) float32; CUDA tensors -> y (B, L, H, P), through
    the kernel of ``route`` (by default :func:`route`'s choice).  B and C
    may be column slices of one [B, C] tensor: each needs unit stride
    along N and the same row stride; every other input is contiguous."""
    check_forward_only(x, dt, a_log, d_skip, b_in, c_in)
    Bsz, L, H, P = x.shape
    N = b_in.shape[-1]
    Q = chunk_of(L, chunk)
    chosen = _resolve_route(x.dtype, P, N, Q, route)
    for name, t, dtype, shape in (
            ("x", x, x.dtype, (Bsz, L, H, P)), ("dt", dt, torch.float32,
                                                 (Bsz, L, H)),
            ("a_log", a_log, torch.float32, (H,)),
            ("d_skip", d_skip, torch.float32, (H,)),
            ("b_in", b_in, x.dtype, (Bsz, L, N)),
            ("c_in", c_in, x.dtype, (Bsz, L, N))):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"ssd kernel: {name} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"ssd kernel: {name} must be {dtype} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if name not in ("b_in", "c_in") and not t.is_contiguous():
            raise ValueError(f"ssd kernel: {name} must be contiguous")
    ld = b_in.stride(1)
    for name, t in (("b_in", b_in), ("c_in", c_in)):
        if t.stride() != (L * ld, ld, 1) or ld < N:
            raise ValueError(f"ssd kernel: {name} must have strides (L*ld, "
                             f"ld, 1) with b_in's row stride ld={ld}, got "
                             f"{t.stride()}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd kernel: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if P > MAX_HEAD_DIM or N > MAX_STATE or not 1 <= Bsz <= 65535:
        raise ValueError(f"ssd kernel: needs P <= {MAX_HEAD_DIM}, N <= "
                         f"{MAX_STATE} and 1 <= B <= 65535, got P={P}, "
                         f"N={N}, B={Bsz}")
    launch = ssd_tc if chosen == "tc" else ssd_simt
    y = launch(x, dt, a_log, d_skip, b_in, c_in, Q=Q, ld=ld)
    ssd_cuda.launches += 1
    return y


def ssd_simt(x, dt, a_log, d_skip, b_in, c_in, *, Q: int, ld: int
             ) -> torch.Tensor:
    """The CUDA-core kernel on inputs ``ssd_cuda`` has checked."""
    Bsz, L, H, P = x.shape
    if smem_bytes(Q) > MAX_SMEM:
        raise ValueError(f"ssd kernel: chunk {Q} needs {smem_bytes(Q)} B of "
                         f"shared memory, more than a block's {MAX_SMEM}")
    y = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_launch(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                            d_skip.data_ptr(), b_in.data_ptr(),
                            c_in.data_ptr(), y.data_ptr(), _DTYPES[x.dtype],
                            Bsz, L, H, P, b_in.shape[-1], Q, ld, stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: "
                           f"{lib.ssd_error_string(rc).decode()}")
    ssd_simt.launches += 1
    return y


def ssd_tc(x, dt, a_log, d_skip, b_in, c_in, *, Q: int, ld: int
           ) -> torch.Tensor:
    """The tensor-core kernel on inputs ``ssd_cuda`` has checked (bf16, P,
    N and Q multiples of 16); its 16-byte copies need x, B, C and y
    16-byte aligned and B's row stride a multiple of 8 elements."""
    Bsz, L, H, P = x.shape
    y = torch.empty_like(x)
    for name, t in (("x", x), ("b_in", b_in), ("c_in", c_in), ("y", y)):
        if t.data_ptr() % 16:
            raise ValueError(f"ssd kernel: {name} must be 16-byte aligned "
                             f"for the tensor-core route")
    if ld % 8:
        raise ValueError(f"ssd kernel: the tensor-core route needs B and C's "
                         f"row stride a multiple of 8, got {ld}")
    lib = _tc_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_tc_launch(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                               d_skip.data_ptr(), b_in.data_ptr(),
                               c_in.data_ptr(), y.data_ptr(), Bsz, L, H, P,
                               b_in.shape[-1], Q, ld, stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel (tensor cores) launch failed: "
                           f"{lib.ssd_tc_error_string(rc).decode()}")
    ssd_tc.launches += 1
    return y


#: launches since each count was last set to 0: all routes, and each route
ssd_cuda.launches = 0
ssd_simt.launches = 0
ssd_tc.launches = 0
