"""Work-structured jobs: checkpoint-priced recovery and can't-be-late
safety nets.

The port of the JAX package's ``core/work.py``.  The base engine treats a
job as an atomic unit: one spot slot serves it, one preemption resumes it
for free.  The ``work=`` axis gives every job ``total_work`` units to
serve: a serve pays down restart-overhead debt first and then makes
progress, a preemption without a checkpoint rolls the job back to its
last checkpoint, and every resume owes ``restart_overhead`` units before
progress restarts.

- :class:`WorkModel` — the descriptor (frozen, hashable), whose
  :meth:`WorkModel.params` gives the float32 parameters the event bodies
  and the CUDA kernels read.  Its constructors are the checkpoint
  disciplines: :meth:`WorkModel.never`, :meth:`WorkModel.on_notice` and
  :meth:`WorkModel.periodic`.
- :class:`CantBeLateKernel` — a safety net around any policy kernel: the
  engine tracks each job's slack ``deadline − life −
  remaining_work·od_time − slack_buffer``
  (:func:`repro_torch.core.policies.deadline_slack`) and defects the job
  to on-demand the moment it would run out, so that a job admitted with
  positive slack cannot miss its deadline.

``work=None`` runs the engine as it was; the identity model
``WorkModel()`` (one unit of work, no overhead, no checkpoint, no
deadline) reproduces its statistics bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import numpy as np
import torch

#: the deadline of a model without one (the engine's INF, not infinity)
_INF = np.float32(3e38)

_CKPT_MODES = ("never", "notice", "periodic")


class WorkState(NamedTuple):
    """Per-slot work structure (float32, ``(lanes, slots)`` or ``(slots,)``).

    ``prog`` is progress toward ``total_work``; ``oh`` the restart-overhead
    debt served before progress resumes; ``ckpt`` the progress saved at the
    last checkpoint (the rollback target); ``life`` the age since
    admission, never reset on a resume, so that deadline accounting spans
    preemptions.
    """

    prog: torch.Tensor
    oh: torch.Tensor
    ckpt: torch.Tensor
    life: torch.Tensor


def init_work_state(n_slots: int, lanes: int | None = None,
                    device="cpu") -> WorkState:
    """Zero work structure for ``n_slots`` slots (optionally per lane)."""
    shape = (n_slots,) if lanes is None else (lanes, n_slots)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return WorkState(prog=z, oh=z, ckpt=z, life=z)


@dataclasses.dataclass(frozen=True)
class WorkModel:
    """The work-structure descriptor (the checkpoint disciplines).

    ``total_work`` is in service units (one spot serve serves one unit);
    ``restart_overhead`` the units a resumed job re-serves before it makes
    progress.  ``ckpt`` picks the discipline: ``"never"`` rolls back to the
    last saved point (zero unless periodic), ``"notice"`` saves the current
    progress at a preemption iff ``ckpt_time`` fits the firing location's
    notice window, ``"periodic"`` saves every ``ckpt_period`` units of
    progress at ``ckpt_cost`` extra units each.  ``deadline`` (time since
    admission) and ``od_time`` (time a unit of work on demand) feed the
    survival ledger's deadline-miss accounting and the
    :class:`CantBeLateKernel` slack law.  The default is the identity
    model.
    """

    total_work: float = 1.0
    restart_overhead: float = 0.0
    ckpt: str = "never"
    ckpt_time: float = 0.0
    ckpt_period: float = 0.0
    ckpt_cost: float = 0.0
    deadline: float = float(_INF)
    od_time: float = 0.0

    def __post_init__(self):
        if self.ckpt not in _CKPT_MODES:
            raise ValueError(
                f"ckpt must be one of {_CKPT_MODES}, got {self.ckpt!r}")
        if self.total_work <= 0:
            raise ValueError("total_work must be positive")
        if self.ckpt == "periodic" and self.ckpt_period <= 0:
            raise ValueError("periodic checkpointing needs ckpt_period > 0")

    def params(self, device="cpu") -> dict:
        """The float32 parameters (0-d tensors on ``device``) the event
        bodies read; the deadline is clamped to 3e38."""
        values = {
            "total_work": self.total_work,
            "restart_overhead": self.restart_overhead,
            "ckpt_time": self.ckpt_time,
            "ckpt_period": self.ckpt_period,
            "ckpt_cost": self.ckpt_cost,
            "deadline": min(float(self.deadline), float(_INF)),
            "od_time": self.od_time,
        }
        return {name: torch.tensor(np.float32(v), device=device)
                for name, v in values.items()}

    # ---- the checkpoint disciplines ------------------------------------
    @classmethod
    def never(cls, **kw) -> "WorkModel":
        """No checkpoints: every rollback loses all progress."""
        return cls(ckpt="never", **kw)

    @classmethod
    def on_notice(cls, ckpt_time: float, **kw) -> "WorkModel":
        """Checkpoint during the preemption notice window iff it fits."""
        return cls(ckpt="notice", ckpt_time=ckpt_time, **kw)

    @classmethod
    def periodic(cls, period: float, cost: float = 0.0, **kw) -> "WorkModel":
        """Checkpoint every ``period`` units of progress, at ``cost`` extra
        units of work each."""
        return cls(ckpt="periodic", ckpt_period=period, ckpt_cost=cost, **kw)


def restart_overhead_from_timing(save_seconds: float, restore_seconds: float,
                                 step_seconds: float,
                                 steps_per_unit: float = 1.0) -> float:
    """:attr:`WorkModel.restart_overhead` from measured wall time: a resume
    re-pays the checkpoint restore plus the blocking save that produced
    it, in work units of ``steps_per_unit`` steps of ``step_seconds``."""
    if step_seconds <= 0 or steps_per_unit <= 0:
        raise ValueError("step_seconds and steps_per_unit must be positive")
    return float(save_seconds + restore_seconds) / (
        float(step_seconds) * float(steps_per_unit))


@dataclasses.dataclass(frozen=True)
class CantBeLateKernel:
    """Safety net: defect a job to on-demand before it is too late.

    Wraps any policy kernel, delegating every hook and attribute to
    ``base`` (the slab hooks ``admit_u``, ``admit_market_u``,
    ``on_preempt_u``, ``route_u`` and ``slab_cols``, the split stream's
    keyed ``admit``, ``admit_market`` and ``on_preempt``, ``drain_dead``,
    ...), and arms the engine's
    per-job slack watchdog: a job whose slack ``deadline − life −
    (overhead + remaining work)·od_time − slack_buffer`` runs out defects to
    on-demand through the deadline machinery, counted as a *panic entry*
    in the survival ledger.  ``work=`` must be set (the entry points refuse
    the wrapper without it).  Wrap outermost: a ``PanicKernel`` around it
    would not forward the ``safety_net`` marker.
    """

    base: object
    slack_buffer: float = 0.0

    safety_net: ClassVar[bool] = True

    def __getattr__(self, name):
        if name.startswith("_") or name == "base":
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "base"), name)


def peel_safety_net(kernel):
    """``(kernel under the wrapper, safety net?, slack buffer)``: a
    :class:`CantBeLateKernel` unwrapped to the kernel that decides."""
    if isinstance(kernel, CantBeLateKernel):
        return kernel.base, True, float(kernel.slack_buffer)
    return kernel, False, 0.0
