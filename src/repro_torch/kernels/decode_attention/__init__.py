"""Decode-attention kernel: one query token against a KV cache.

House layout: ``csrc/decode_attention.cu`` is the hand-written CUDA kernel
and ``decode_attention.py`` its ctypes wrapper, ``ref.py`` the plain
PyTorch version the kernel must match, ``ops.py`` the layout and device
dispatch.  Reached through ``ops.decode_attention`` only, as in the JAX
package: the models' decode step does not call it.
"""
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention_bh)
from repro_torch.kernels.decode_attention.ref import (decode_attention_bh_ref,
                                                      decode_attention_ref)

# the model-layout entry is ops.decode_attention; it is not re-exported
# here, where its name would hide the decode_attention module
__all__ = ["decode_attention_bh", "decode_attention_bh_ref",
           "decode_attention_ref"]
