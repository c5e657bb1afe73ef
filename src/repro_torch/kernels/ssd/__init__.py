"""SSD kernel: the Mamba2 chunked scan, one (batch, head) a block.

House layout: ``csrc/ssd.cu`` is the hand-written CUDA kernel and
``ssd.py`` its ctypes wrapper, ``ref.py`` the plain PyTorch versions the
kernel must match, ``ops.py`` the device dispatch.  Consumed by
:func:`repro_torch.layers.ssm.mamba_block` for ``impl="pallas"`` without a
cache: every layer of ``MambaLM.loss`` under ``attn_impl="pallas"``.
"""
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_ref
from repro_torch.kernels.ssd.ssd import ForwardOnlyError, ssd_cuda

__all__ = ["ForwardOnlyError", "ssd_chunked", "ssd_cuda", "ssd_ref"]
