"""Public entry of the SSD kernel: the tiling contract, the layout and the
dispatch.

``ssd`` sends CUDA tensors to the hand-written kernels (:mod:`.ssd`, which
picks the tensor-core or CUDA-core route, checks its inputs, then launches
or raises) and CPU tensors to the plain chunked scan.  The contract is the JAX wrapper's on both: Q = min(chunk,
L) and L % Q == 0, else ``ValueError``; forward only, so an input that
requires grad raises :class:`~repro_torch.kernels.ssd.ssd.ForwardOnlyError`.
"""
from __future__ import annotations

from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.kernels.ssd.ssd import check_forward_only, chunk_of, ssd_cuda


def ssd(x, dt, a_log, d_skip, b_in, c_in, *, chunk: int = 256):
    """Mamba2 SSD: x (B,L,H,P); dt (B,L,H); b/c (B,L,N) -> (B,L,H,P)."""
    if x.device.type != "cpu":
        return ssd_cuda(x, dt, a_log, d_skip, b_in, c_in, chunk=chunk)
    check_forward_only(x, dt, a_log, d_skip, b_in, c_in)
    return ssd_chunked(x, dt, a_log, d_skip, b_in, c_in,
                       chunk=chunk_of(x.shape[1], chunk))
