"""Hand-written Hopper kernels of the port, one package per kernel.

kernels/sweep: the CUDA batched-event kernel that
repro_torch.core.engine runs a fleet on a GPU through.
"""
