"""Flash-attention kernel: forward GQA attention over KV tiles.

House layout: ``csrc/flash_attention.cu`` is the hand-written CUDA kernel
and ``flash_attention.py`` its ctypes wrapper, ``ref.py`` the plain PyTorch
version the kernel must match, ``ops.py`` the layout and device dispatch.
Consumed by :func:`repro_torch.layers.attention.mix_sequence` when
``cfg.attn_impl == "pallas"``: every layer of a prefill.
"""
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bh)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_bh_ref)

# the model-layout entry is ops.flash_attention; it is not re-exported
# here, where its name would hide the flash_attention module
__all__ = ["attention_ref", "flash_attention_bh", "flash_attention_bh_ref"]
