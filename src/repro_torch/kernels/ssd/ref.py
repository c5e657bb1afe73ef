"""Plain PyTorch versions of the SSD kernel.

``ssd_ref`` is the O(L) sequential recurrence (the oracle, as the JAX
package's ``ref.py`` re-exports it) and ``ssd_chunked`` the chunked scan
of the same algorithm as the kernel, on whole tensors: the CPU stand-in
for the kernel, and what ``chip_smoke.py`` holds the kernel to at full
width, where the sequential loop is too slow.
"""
from repro_torch.layers.ssm import ssd_chunked  # noqa: F401
from repro_torch.layers.ssm import ssd_reference as ssd_ref  # noqa: F401
