"""Mamba2 (state-space duality) block: the chunked SSD scan and its kin.

The port of the JAX package's ``layers/ssm.py``: big intra-chunk products
plus a cheap inter-chunk state recurrence (a Python loop over chunks).
``ssd_chunked`` is the plain chunked scan (prefill, and the CPU stand-in
for the kernel), ``ssd_reference`` the O(L) sequential recurrence (the
oracle), and ``impl="pallas"`` reaches the hand-written CUDA kernel
(:mod:`repro_torch.kernels.ssd`) under the JAX package's exact dispatch.

Per-layer parameters (ngroups = 1), the JAX package's names and layouts:
  z/x/b/c/dt_proj (D, ·) — the split in-projections → [z, x, B, C, dt]
  conv_x_w (W, d_inner), conv_bc_w (W, 2N) and biases — depthwise width-W
  causal conv over [x, B, C] (+ silu)
  A_log (H,), D (H,), dt_bias (H,); norm {scale} (gated RMSNorm);
  out_proj (d_inner, D)

Recurrence: h_t = exp(dt_t·A)·h_{t−1} + dt_t·B_t ⊗ x_t ;  y_t = C_t·h_t + D·x_t
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.layers.norms import gated_rms_norm


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int
    n_state: int
    n_heads: int
    head_dim: int
    conv_width: int
    chunk: int

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_state

    @property
    def proj_dim(self) -> int:
        return 2 * self.d_inner + 2 * self.n_state + self.n_heads


def dims_from_cfg(cfg) -> SSMDims:
    return SSMDims(
        d_model=cfg.d_model,
        d_inner=cfg.d_inner,
        n_state=cfg.ssm_state,
        n_heads=cfg.ssm_heads,
        head_dim=cfg.ssm_headdim,
        conv_width=cfg.ssm_conv_width,
        chunk=cfg.ssm_chunk,
    )


def ssm_init(dims: SSMDims, dtype=torch.bfloat16, device=None,
             generator: torch.Generator | None = None) -> dict:
    """Random weights at the JAX init's scales: normal projections at
    1/sqrt(fan-in), normal conv taps at 1/sqrt(W), zero conv biases,
    A_log = log(1..H), D = 1, and dt_bias the inverse softplus of a
    log-uniform dt in [1e-3, 1e-1] (the Mamba default)."""
    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device)
        return (w * scale).to(dtype)

    s_in = 1.0 / math.sqrt(dims.d_model)
    cw = 1.0 / math.sqrt(dims.conv_width)
    u = torch.rand(dims.n_heads, generator=generator, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "z_proj": normal((dims.d_model, dims.d_inner), s_in),
        "x_proj": normal((dims.d_model, dims.d_inner), s_in),
        "b_proj": normal((dims.d_model, dims.n_state), s_in),
        "c_proj": normal((dims.d_model, dims.n_state), s_in),
        "dt_proj": normal((dims.d_model, dims.n_heads), s_in),
        "conv_x_w": normal((dims.conv_width, dims.d_inner), cw),
        "conv_x_b": torch.zeros(dims.d_inner, dtype=dtype, device=device),
        "conv_bc_w": normal((dims.conv_width, 2 * dims.n_state), cw),
        "conv_bc_b": torch.zeros(2 * dims.n_state, dtype=dtype,
                                 device=device),
        "A_log": torch.log(torch.arange(1, dims.n_heads + 1,
                                        dtype=torch.float32, device=device)),
        "D": torch.ones(dims.n_heads, device=device),
        "dt_bias": dt_bias.float(),
        "norm": {"scale": torch.ones(dims.d_inner, device=device)},
        "out_proj": normal((dims.d_inner, dims.d_model),
                           1.0 / math.sqrt(dims.d_inner)),
    }


def causal_conv(w: torch.Tensor, b: torch.Tensor, u: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv by shifted adds, in the input's type, then
    silu in float32.  u (B, L, C); w (W, C)."""
    W, L = w.shape[0], u.shape[1]
    out = torch.zeros_like(u)
    for i in range(W):
        shift = W - 1 - i
        shifted = F.pad(u, (0, 0, shift, 0))[:, :L]
        out = out + shifted * w[i]
    return F.silu((out + b).float()).to(u.dtype)


def ssd_chunked(x, dt, a_log, d_skip, b_in, c_in, *, chunk: int,
                return_final: bool = False):
    """Chunked SSD scan.

    x (B, L, H, P); dt (B, L, H) float32 post-softplus; b_in/c_in (B, L, N);
    returns y (B, L, H, P) in x's type (+ the final state (B, H, P, N)
    float32 with ``return_final``).  A ragged tail is zero-padded with
    dt = 0, so the padded steps add nothing and decay nothing.

    The JAX package's three-operand einsums are contracted pairwise here,
    in an order that never builds a (b, c, q, s, h, p) product: at full
    width that product would be hundreds of GB.
    """
    Bsz, L, H, P = x.shape
    N = b_in.shape[-1]
    Q = min(chunk, L)
    nc = -(-L // Q)
    pad = nc * Q - L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    A = -torch.exp(a_log.float())  # (H,) negative
    dtc = dt.reshape(Bsz, nc, Q, H)
    dac = dtc * A
    xc = x.reshape(Bsz, nc, Q, H, P)
    bc = b_in.reshape(Bsz, nc, Q, N).float()
    cc = c_in.reshape(Bsz, nc, Q, N).float()

    cum = torch.cumsum(dac, dim=2)  # (B, nc, Q, H) inclusive
    # intra-chunk: contribution of s to q (q >= s): exp(cum_q - cum_s)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    del seg
    scores = cc @ bc.transpose(-1, -2)  # (B, nc, Q, Q)
    xdt = xc.float() * dtc[..., None]  # (B, nc, Q, H, P)
    # (scores ⊙ decay) per head, then a product over s for each (b, c, h)
    weights = (scores[..., None] * decay).permute(0, 1, 4, 2, 3)
    del decay
    y_diag = (weights @ xdt.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    del weights

    # chunk-final states: S_c = Σ_s exp(cum_last - cum_s) B_s ⊗ xdt_s
    decay_rest = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    xw = (xdt * decay_rest[..., None]).reshape(Bsz, nc, Q, H * P)
    s_chunk = (xw.transpose(-1, -2) @ bc).reshape(Bsz, nc, H, P, N)
    total = torch.exp(cum[:, :, -1, :])  # (B, nc, H) whole-chunk decay

    h = torch.zeros(Bsz, H, P, N, device=x.device)
    h_before = []
    for c in range(nc):
        h_before.append(h)  # the state before this chunk
        h = h * total[:, c, :, None, None] + s_chunk[:, c]
    h_before = torch.stack(h_before, dim=1)  # (B, nc, H, P, N)

    decay_in = torch.exp(cum)  # (B, nc, Q, H): from chunk start to q
    # C·h_prev for each (b, c, h): (Q, N) @ (N, P)
    y_off = (cc[:, :, None] @ h_before.transpose(-1, -2)).permute(
        0, 1, 3, 2, 4) * decay_in[..., None]

    y = y_diag + y_off + d_skip[None, None, :, None] * xc.float()
    y = y.reshape(Bsz, nc * Q, H, P)[:, :L]
    if return_final:
        return y.to(x.dtype), h
    return y.to(x.dtype)


def ssd_reference(x, dt, a_log, d_skip, b_in, c_in) -> torch.Tensor:
    """O(L) sequential recurrence — the ground-truth oracle for tests."""
    Bsz, L, H, P = x.shape
    N = b_in.shape[-1]
    A = -torch.exp(a_log.float())
    xf, bf, cf = x.float(), b_in.float(), c_in.float()
    h = torch.zeros(Bsz, H, P, N, device=x.device)
    ys = []
    for t in range(L):
        dtt = dt[:, t]  # (B, H)
        da = torch.exp(dtt * A)
        upd = (xf[:, t] * dtt[..., None])[..., None] * bf[:, t, None, None, :]
        h = h * da[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    y = torch.stack(ys, dim=1) + d_skip[None, None, :, None] * xf
    return y.to(x.dtype)


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, conv_width-1, conv_channels), the model's type
    state: torch.Tensor  # (B, H, P, N) float32


def ssm_init_cache(dims: SSMDims, batch: int, dtype=torch.bfloat16,
                   device=None) -> SSMCache:
    return SSMCache(
        conv=torch.zeros(batch, dims.conv_width - 1, dims.conv_channels,
                         dtype=dtype, device=device),
        state=torch.zeros(batch, dims.n_heads, dims.head_dim, dims.n_state,
                          device=device))


def _in_project(params, u):
    """u (..., D) -> z, x_raw, [B, C]_raw, dt_raw."""
    z = u @ params["z_proj"]
    x_raw = u @ params["x_proj"]
    bc_raw = torch.cat([u @ params["b_proj"], u @ params["c_proj"]], dim=-1)
    dt_raw = u @ params["dt_proj"]
    return z, x_raw, bc_raw, dt_raw


def mamba_block(params: dict, dims: SSMDims, u: torch.Tensor, *,
                norm_eps: float = 1e-6, impl: str = "chunked",
                return_cache: bool = False):
    """Full Mamba2 block on a sequence.  u (B, L, D) -> (B, L, D).

    The scan is the JAX package's dispatch: the CUDA kernel only for
    ``impl == "pallas"`` without ``return_cache``; the chunked scan (with
    its final state) for ``"chunked"`` or whenever a cache is asked for;
    the sequential reference otherwise.  With ``return_cache`` also returns
    the decode :class:`SSMCache` (terminal state + last conv window), so
    prefill hands off to decode.
    """
    z, x_raw, bc_raw, dt_raw = _in_project(params, u)
    x = causal_conv(params["conv_x_w"], params["conv_x_b"], x_raw)
    bc = causal_conv(params["conv_bc_w"], params["conv_bc_b"], bc_raw)
    b_in = bc[..., : dims.n_state]
    c_in = bc[..., dims.n_state:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    xh = x.reshape(x.shape[0], x.shape[1], dims.n_heads, dims.head_dim)
    h_final = None
    if return_cache or impl == "chunked" or impl == "pallas":
        if impl == "pallas" and not return_cache:
            from repro_torch.kernels.ssd import ops as ssd_ops

            y = ssd_ops.ssd(xh, dt, params["A_log"], params["D"], b_in, c_in,
                            chunk=dims.chunk)
        else:
            y, h_final = ssd_chunked(xh, dt, params["A_log"], params["D"],
                                     b_in, c_in, chunk=dims.chunk,
                                     return_final=True)
    else:
        y = ssd_reference(xh, dt, params["A_log"], params["D"], b_in, c_in)
    y = y.reshape(x.shape)
    y = gated_rms_norm(params["norm"], y, z, eps=norm_eps)
    out = y @ params["out_proj"]
    if return_cache:
        W = dims.conv_width
        conv_in = torch.cat([x_raw, bc_raw], dim=-1)
        return out, SSMCache(conv=conv_in[:, -(W - 1):, :], state=h_final)
    return out


def mamba_block_decode(params: dict, dims: SSMDims, u: torch.Tensor,
                       cache: SSMCache, *, norm_eps: float = 1e-6
                       ) -> tuple[torch.Tensor, SSMCache]:
    """Single-token recurrent step.  u (B, 1, D) -> (B, 1, D)."""
    B = u.shape[0]
    z, x_raw, bc_raw, dt_raw = _in_project(params, u[:, 0])
    conv_in = torch.cat([x_raw, bc_raw], dim=-1)  # (B, C)
    window = torch.cat([cache.conv, conv_in[:, None, :]], dim=1)
    conv_w = torch.cat([params["conv_x_w"], params["conv_bc_w"]], dim=-1)
    conv_b = torch.cat([params["conv_x_b"], params["conv_bc_b"]])
    conv_out = torch.einsum("bwc,wc->bc", window, conv_w)
    conv_out = F.silu((conv_out + conv_b).float()).to(u.dtype)
    x = conv_out[..., : dims.d_inner]
    b_in = conv_out[..., dims.d_inner: dims.d_inner + dims.n_state]
    c_in = conv_out[..., dims.d_inner + dims.n_state:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"].float())
    da = torch.exp(dt * A)  # (B, H)
    xh = x.reshape(B, dims.n_heads, dims.head_dim).float()
    upd = (xh * dt[..., None])[..., None] * b_in.float()[:, None, None, :]
    state = cache.state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, c_in.float())
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(B, dims.d_inner).to(u.dtype)
    y = gated_rms_norm(params["norm"], y, z, eps=norm_eps)
    out = y @ params["out_proj"]
    return out[:, None, :], SSMCache(conv=window[:, 1:], state=state)
