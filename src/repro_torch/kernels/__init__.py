"""Hand-written Hopper kernels of the port, one package per kernel.

kernels/sweep: the CUDA batched-event kernel that
repro_torch.core.engine runs a fleet on a GPU through.
kernels/flash_attention: the CUDA flash-attention kernel of every
prefill layer (repro_torch.layers.attention.mix_sequence, "pallas").
kernels/decode_attention: the CUDA decode-attention kernel, reached
through its own ops.decode_attention.
kernels/_build: the nvcc build and ctypes loading they share.
"""
