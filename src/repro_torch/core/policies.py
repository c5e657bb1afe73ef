"""Scheduling policies from the paper: one admission law, two engine kernels.

The central object is the Theorem-4 **three-phase policy** parameterized by a
single continuous knob ``r = N̂ + q`` (eq. 12):

  * queue length  < N̂ : admit, wait indefinitely (X = ∞)   [phase 1]
  * queue length == N̂ : admit with probability q = r − N̂    [phase 2]
  * queue length  > N̂ : dispatch straight to on-demand      [phase 3]

:func:`three_phase_admit_prob` is the single source of that admission math.

The engine kernels are frozen descriptors whose slab hook
``admit_u(params, qlen, u) -> (admit, budget)`` runs once per event for
every lane, with the pre-event queue length and the kernel's own uniform
columns (``slab_cols``), on the slab stream; on the split stream the keyed
hook ``admit(params, qlen, key)`` runs instead, drawing from the event's
policy subkey:

  * :class:`ThreePhaseKernel` — Theorem 4; params ``{"r": f32}``; admitted
    jobs wait indefinitely.
  * :class:`SingleSlotKernel` — Theorems 2/3; queue capped at one, each
    admitted job stamped with a sampled maximal wait X (budget) and defecting
    to on-demand when it expires.  Wait-time parameters may come per lane
    through ``params["wait"]``, so a wait-time family can be swept; without
    them the family samples at its own constants, on either stream.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import threefry
from repro_torch.core.waittime import INF, InfiniteWait, WaitTime


def deadline_slack(deadline, life, remaining_work, od_time, buffer=0.0):
    """Slack before a job can no longer finish on time, even on demand:
    ``deadline − life − remaining_work·od_time − buffer``.  One expression
    for host scalars and tensors."""
    return deadline - life - remaining_work * od_time - buffer


def three_phase_admit_prob(qlen, r):
    """P(admit | queue length) under the Theorem-4 three-phase law.

    Host scalars take a pure-Python path; tensors (``r`` float32 per lane,
    ``qlen`` int32 per lane) take the tensor path the engine runs.
    """
    if not (isinstance(qlen, torch.Tensor) or isinstance(r, torch.Tensor)):
        n_hat = math.floor(r)
        if qlen < n_hat:
            return 1.0
        return r - n_hat if qlen == n_hat else 0.0
    n_hat = torch.floor(r)
    frac = r - n_hat
    qf = qlen.to(torch.float32)
    return torch.where(qf < n_hat, 1.0, torch.where(qf == n_hat, frac, 0.0))


@dataclasses.dataclass(frozen=True)
class ThreePhaseKernel:
    """Theorem-4 engine kernel; params ``{"r": f32}``.  ``admit_u`` owns one
    uniform column — the Bernoulli admission draw."""

    def slab_cols(self, hook, n):
        del n
        return 1 if hook == "admit" else None

    def admit(self, params, qlen, key):
        p = three_phase_admit_prob(qlen, params["r"])
        return threefry.uniform(key) < p, INF

    def admit_u(self, params, qlen, u):
        p = three_phase_admit_prob(qlen, params["r"])
        return u[..., 0] < p, INF


@dataclasses.dataclass(frozen=True)
class SingleSlotKernel:
    """Theorems-2/3 engine kernel: queue ≤ 1 with maximal wait X.

    A job joins only if the queue is empty and its sampled wait budget is
    positive (X = 0 means "go on-demand immediately", as in Corollary 1's
    two-point optimum); otherwise it dispatches to on-demand at once.
    """

    wait: WaitTime = InfiniteWait()

    def slab_cols(self, hook, n):
        del n
        # admission itself is deterministic given X; the wait-time family
        # owns the columns (0 for Infinite/Deterministic waits)
        return self.wait.u_dim if hook == "admit" else None

    def admit(self, params, qlen, key):
        # the wait family's own parameters where the params hold none
        wp = params.get("wait") if isinstance(params, dict) else None
        x = (self.wait.sample_from(wp, key) if wp
             else self.wait.sample(key))
        return (qlen == 0) & (x > 0.0), x

    def admit_u(self, params, qlen, u):
        # the wait family's own parameters where the params hold none
        wp = params.get("wait") if isinstance(params, dict) else None
        x = self.wait.sample_from_u(wp, u) if wp else self.wait.sample_u(u)
        return (qlen == 0) & (x > 0.0), x


@dataclasses.dataclass(frozen=True)
class ThreePhasePolicy:
    """Host-side descriptor of the Theorem-4 policy at fixed ``r``."""

    r: float

    @property
    def n_hat(self) -> int:
        return int(math.floor(self.r))

    @property
    def q(self) -> float:
        return self.r - math.floor(self.r)

    def admit_prob(self, qlen: int) -> float:
        return three_phase_admit_prob(qlen, self.r)

    def kernel(self) -> ThreePhaseKernel:
        return ThreePhaseKernel()

    def kernel_params(self) -> dict:
        return {"r": self.r}


@dataclasses.dataclass(frozen=True)
class SingleSlotPolicy:
    """Queue-length ≤ 1 with maximal wait-time distribution (Theorems 2/3)."""

    wait: WaitTime = InfiniteWait()

    def admit_prob(self, qlen: int) -> float:
        return 1.0 if qlen == 0 else 0.0

    def kernel(self) -> SingleSlotKernel:
        return SingleSlotKernel(wait=self.wait)

    def kernel_params(self) -> dict:
        return {}


def phase_boundaries(r: float) -> tuple[int, float]:
    """(N̂, q) decomposition of the fractional queue cap."""
    n_hat = int(math.floor(r))
    return n_hat, r - n_hat
