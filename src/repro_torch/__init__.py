"""PyTorch/CUDA port of the opportunistic spot-scheduling system.

Mirrors the JAX package ``repro`` module by module and imports nothing of
it (nor JAX).  Two slices so far:

* the paper's single delay-constrained queue: ``repro_torch.core.run_sweep``
  drives a (params × k × seeds) fleet through the hand-written CUDA
  batched-event kernel on an NVIDIA H100, or through its plain PyTorch
  version on the CPU (``device="cpu"``);
* spot-aware LM serving: ``repro_torch.serving.engine.SpotServingFrontend``
  dispatches requests with the paper's online admission controller to a
  dense transformer (``repro_torch.models``, qwen1.5-4b), whose prefill
  runs the hand-written CUDA flash-attention kernel.
"""
from repro_torch.core import run_sim, run_sweep
from repro_torch.core.threefry import key

__all__ = ["key", "run_sim", "run_sweep"]
