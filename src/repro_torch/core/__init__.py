"""The paper's contribution: opportunistic spot/on-demand scheduling, in PyTorch.

The single-queue slice of :mod:`repro.core`:
  * threefry PRNG        — :mod:`repro_torch.core.threefry`
  * slab stream          — :mod:`repro_torch.core.clocks`
  * arrival processes    — :mod:`repro_torch.core.arrivals`
  * cost laws            — :mod:`repro_torch.core.cost` (Theorem 1)
  * closed forms         — :mod:`repro_torch.core.analytic` (Theorems 2, 5)
  * LP oracles           — :mod:`repro_torch.core.lp`
  * wait-time theory     — :mod:`repro_torch.core.waittime` (Theorem 3)
  * policy kernels       — :mod:`repro_torch.core.policies` (Theorem 4)
  * sweep engine         — :mod:`repro_torch.core.engine` (``run_sweep``
                           runs a policy grid × seed fleet through the CUDA
                           batched-event kernel, :mod:`repro_torch.kernels.sweep`)
"""
from repro_torch.core.analytic import (
    mm1n_pi,
    theorem2_cost,
    theorem5_cost,
    theorem5_delta,
)
from repro_torch.core.arrivals import (
    ArrivalProcess,
    BathtubGCP,
    Deterministic,
    Exponential,
    Gamma,
    Uniform,
    prob_A_le_S,
)
from repro_torch.core.cost import cost_lower_bound, theorem1_cost
from repro_torch.core.engine import (
    DEFAULT_CHUNK_EVENTS,
    INT_STATS,
    EngineState,
    NonFiniteStatsError,
    WindowStats,
    init_engine_state,
    run_sim,
    run_sweep,
    summarize,
)
from repro_torch.core.policies import (
    SingleSlotKernel,
    SingleSlotPolicy,
    ThreePhaseKernel,
    ThreePhasePolicy,
    three_phase_admit_prob,
)
from repro_torch.core.waittime import (
    DeterministicWait,
    ExponentialWait,
    InfiniteWait,
    TwoPointWait,
)

__all__ = [
    "ArrivalProcess", "BathtubGCP", "DEFAULT_CHUNK_EVENTS", "Deterministic",
    "DeterministicWait", "EngineState", "Exponential", "ExponentialWait",
    "Gamma", "INT_STATS", "InfiniteWait", "NonFiniteStatsError",
    "SingleSlotKernel", "SingleSlotPolicy", "ThreePhaseKernel",
    "ThreePhasePolicy", "TwoPointWait", "Uniform", "WindowStats",
    "cost_lower_bound", "init_engine_state", "mm1n_pi", "prob_A_le_S",
    "run_sim", "run_sweep", "summarize", "theorem1_cost", "theorem2_cost",
    "theorem5_cost", "theorem5_delta", "three_phase_admit_prob",
]
