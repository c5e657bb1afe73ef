"""SSD kernel: the Mamba2 chunked scan, one (batch, head) a block.

House layout: ``csrc/ssd_tc.cu`` (bf16 on the tensor cores) and
``csrc/ssd.cu`` (float32 and other shapes, on the CUDA cores) are the
hand-written CUDA kernels and ``ssd.py`` their ctypes wrappers and route,
``ref.py`` the plain PyTorch versions the kernels must match (and the
tensor-core route's rounding twin and tolerance), ``ops.py`` the device
dispatch.  Consumed by :func:`repro_torch.layers.ssm.mamba_block` for
``impl="pallas"`` without a cache: every layer of ``MambaLM.loss`` under
``attn_impl="pallas"``.
"""
from repro_torch.kernels.ssd.ref import (ssd_chunked, ssd_ref, ssd_tc_twin,
                                         tc_tolerance)
from repro_torch.kernels.ssd.ssd import (ForwardOnlyError, route, ssd_cuda,
                                         ssd_simt, ssd_tc)

__all__ = ["ForwardOnlyError", "route", "ssd_chunked", "ssd_cuda",
           "ssd_ref", "ssd_simt", "ssd_tc", "ssd_tc_twin", "tc_tolerance"]
