"""ctypes wrapper of the hand-written CUDA SSD chunked-scan kernel
(csrc/ssd.cu), the port of the JAX package's Pallas ``ssd_pallas``.

The wrapper checks device, type, shape and strides, allocates the output
with ``torch.empty`` and launches on the current stream; a launch that
CUDA refuses raises.  The library is built with ``nvcc`` from the
repository's source at first use (:mod:`repro_torch.kernels._build`).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary, load

LIBRARY = KernelLibrary("ssd", Path(__file__).resolve().parent / "csrc"
                        / "ssd.cu")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's tiles are laid out for P <= 64 (16 threads x 4 columns)
#: and N <= 128 (16 threads x 8 state rows)
MAX_HEAD_DIM, MAX_STATE = 64, 128
#: dynamic shared memory a block may use on Hopper
MAX_SMEM = 232_448


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
    """Dynamic shared memory of one block of the kernel at chunk length
    ``chunk``, in bytes (its tiles are laid out at the largest P and N)."""
    return _library().ssd_smem_bytes(chunk)


def ssd_cuda(x, dt, a_log, d_skip, b_in, c_in, *, chunk: int = 256
             ) -> torch.Tensor:
    """x (B, L, H, P) and b/c (B, L, N), float32 or bfloat16; dt (B, L, H),
    a_log and d_skip (H,) float32; CUDA tensors -> y (B, L, H, P).  B and C
    may be column slices of one [B, C] tensor: each needs unit stride
    along N and the same row stride; every other input is contiguous."""
    check_forward_only(x, dt, a_log, d_skip, b_in, c_in)
    Bsz, L, H, P = x.shape
    N = b_in.shape[-1]
    Q = chunk_of(L, chunk)
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
                            Bsz, L, H, P, N, Q, ld, stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: "
                           f"{lib.ssd_error_string(rc).decode()}")
    ssd_cuda.launches += 1
    return y


#: launches of the kernel since the count was last set to 0
ssd_cuda.launches = 0
