"""Plain PyTorch versions of the SSD kernel.

``ssd_ref`` is the O(L) sequential recurrence (the oracle, as the JAX
package's ``ref.py`` re-exports it) and ``ssd_chunked`` the chunked scan
of the same algorithm as the kernel, on whole tensors: the CPU stand-in
for the kernel, and what ``chip_smoke.py`` holds the kernel to at full
width, where the sequential loop is too slow.

``ssd_tc_twin`` is the rounding twin of the tensor-core kernel
(csrc/ssd_tc.cu): the chunked scan's arithmetic in float32, rounded to
bf16 at the three points where the kernel feeds the tensor cores.
:func:`tc_tolerance` holds a tensor-core output to a float32-inside plain
version with a floor of twice the twin's distance from it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.layers.ssm import ssd_chunked  # noqa: F401
from repro_torch.layers.ssm import ssd_reference as ssd_ref  # noqa: F401

#: a bf16 output against a float32-inside plain version: one bf16 ulp, and
#: at least this absolute floor near zero
BF16_RTOL, F32_ATOL = 2.0**-7, 1e-6


def ssd_tc_twin(x, dt, a_log, d_skip, b_in, c_in, *, chunk: int,
                round_to: Optional[torch.dtype] = torch.bfloat16
                ) -> torch.Tensor:
    """The chunked scan (``layers/ssm.py::ssd_chunked``), rounded to
    ``round_to`` where the tensor-core kernel rounds (None: nowhere):

    1. the decayed, dt-scaled scores ``W[q,s] = (C_q·B_s)·exp(cum_q −
       cum_s)·dt_s`` (zero where s > q), before ``W·x``;
    2. the state before each chunk, ``h_prev``, before ``C·h_prev``; the
       float32 state carried to the next chunk is not rounded;
    3. the update's operand ``x_s·exp(cum_last − cum_s)·dt_s``, before its
       product with B.

    x, B and C enter as they are (bf16 on the tensor-core route) and every
    sum is float32.  x (B, L, H, P), dt (B, L, H), b/c (B, L, N); L must
    tile by Q = min(chunk, L).  Returns y (B, L, H, P) in x's type."""
    Bsz, L, H, P = x.shape
    N = b_in.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"L={L} must tile by chunk={Q}")
    nc = L // Q

    def rnd(t):
        return t if round_to is None else t.to(round_to).float()

    A = -torch.exp(a_log.float())
    dtc = dt.float().reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(dtc * A, dim=2)  # (B, nc, Q, H) inclusive
    xc = x.reshape(Bsz, nc, Q, H, P).float()
    bc = b_in.reshape(Bsz, nc, Q, N).float()
    cc = c_in.reshape(Bsz, nc, Q, N).float()

    # 1. W, masked before it is rounded (exp(seg) is never formed where
    # s > q, and may overflow there)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    del seg
    decay = decay * dtc[:, :, None, :, :]  # dt of the key s
    scores = cc @ bc.transpose(-1, -2)  # (B, nc, Q, Q)
    w = rnd((scores[..., None] * decay).permute(0, 1, 4, 2, 3))
    del decay
    y_diag = (w @ xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    del w

    # 3. the update's operand, then the chunk's contribution uᵀ·B
    wu = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # (B, nc, Q, H)
    u = rnd(xc * wu[..., None]).reshape(Bsz, nc, Q, H * P)
    s_chunk = (u.transpose(-1, -2) @ bc).reshape(Bsz, nc, H, P, N)
    total = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    h = torch.zeros(Bsz, H, P, N, device=x.device)
    h_before = []
    for c in range(nc):
        h_before.append(h)  # the float32 state before this chunk
        h = h * total[:, c, :, None, None] + s_chunk[:, c]
    # 2. the state as C·h_prev reads it
    hb = rnd(torch.stack(h_before, dim=1))  # (B, nc, H, P, N)
    y_off = (cc[:, :, None] @ hb.transpose(-1, -2)).permute(
        0, 1, 3, 2, 4) * torch.exp(cum)[..., None]

    y = y_diag + y_off + d_skip[None, None, :, None] * xc
    return y.reshape(Bsz, L, H, P).to(x.dtype)


def tc_tolerance(plain: torch.Tensor, twin: torch.Tensor, floor: float
                 ) -> tuple[dict, float]:
    """The tolerance of a tensor-core SSD output against ``plain`` (a
    float32-inside plain version, on the same inputs): ``rtol`` one bf16
    ulp, ``atol`` the larger of F32_ATOL, twice ``floor`` (the float32
    chunked scan's distance from the recurrence) and twice the largest
    distance between ``twin`` (:func:`ssd_tc_twin`) and ``plain``.
    Returns (``assert_allclose`` keywords, the twin's distance)."""
    dist = float((twin.float() - plain.float()).abs().max())
    return dict(rtol=BF16_RTOL, atol=max(F32_ATOL, 2 * floor, 2 * dist)), dist
