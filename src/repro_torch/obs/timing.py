"""Profiler scopes: the host half of :mod:`repro_torch.obs`.

:func:`annotate` names a span of a ``torch.profiler`` capture, so that a
trace of a sweep attributes its time to the entry point that spent it.
The engine wraps its six entry points in it, as the JAX package wraps
them in ``jax.profiler`` scopes.  Without an active profiler the scope
costs a few microseconds of host time.
"""
from __future__ import annotations

import torch


def annotate(name: str) -> torch.profiler.record_function:
    """A named profiler span (``with annotate("run_sweep"): ...``)."""
    return torch.profiler.record_function(name)
