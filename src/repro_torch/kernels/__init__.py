"""Hand-written Hopper kernels of the port, one package per kernel.

kernels/sweep: the CUDA batched-event kernel that
repro_torch.core.engine runs a fleet on a GPU through.
kernels/flash_attention: the CUDA flash-attention kernel of every
prefill layer (repro_torch.layers.attention.mix_sequence, "pallas").
kernels/decode_attention: the CUDA decode-attention kernel, reached
through its own ops.decode_attention.
kernels/ssd: the CUDA SSD chunked-scan kernel of every layer of
repro_torch.models.mamba_lm.MambaLM.loss under attn_impl "pallas"
(repro_torch.layers.ssm.mamba_block).
kernels/_build: the nvcc build and ctypes loading they share.
"""
