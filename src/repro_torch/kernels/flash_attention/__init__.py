"""Flash-attention kernel: forward GQA attention over KV tiles.

House layout: ``csrc/flash_attention_tc.cu`` (bf16 on the tensor cores)
and ``csrc/flash_attention.cu`` (CUDA cores, every other input) are the
hand-written CUDA kernels and ``flash_attention.py`` their ctypes wrapper
and route, ``ref.py`` the plain PyTorch version the kernels must match
(and its bf16-P rounding twin), ``ops.py`` the layout and device dispatch.
Consumed by :func:`repro_torch.layers.attention.mix_sequence` when
``cfg.attn_impl == "pallas"``: every layer of a prefill.
"""
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bh, flash_attention_simt, flash_attention_tc, route)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_bh_ref,
                                                     tc_tolerance)

# the model-layout entry is ops.flash_attention; it is not re-exported
# here, where its name would hide the flash_attention module
__all__ = ["attention_ref", "flash_attention_bh", "flash_attention_bh_ref",
           "flash_attention_simt", "flash_attention_tc", "route",
           "tc_tolerance"]
