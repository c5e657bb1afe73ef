"""The paper's contribution: opportunistic spot/on-demand scheduling, in PyTorch.

The single-queue slice of :mod:`repro.core`:
  * threefry PRNG        — :mod:`repro_torch.core.threefry`
  * random streams       — :mod:`repro_torch.core.clocks` (the split ladder
                           and the slab)
  * arrival processes    — :mod:`repro_torch.core.arrivals`
  * cost laws            — :mod:`repro_torch.core.cost` (Theorem 1)
  * closed forms         — :mod:`repro_torch.core.analytic` (Theorems 2, 5)
  * LP oracles           — :mod:`repro_torch.core.lp`
  * wait-time theory     — :mod:`repro_torch.core.waittime` (Theorem 3)
  * policy kernels       — :mod:`repro_torch.core.policies` (Theorem 4)
  * spot market          — :mod:`repro_torch.core.market` (pools, market
                           policy kernels, the notice law)
  * regions              — :mod:`repro_torch.core.regions` (topologies,
                           routing rules, ``RoutingKernel``)
  * environment          — :mod:`repro_torch.core.env` (``EnvTimeline``:
                           piecewise-constant price, hazard and supply
                           segments, storms, blackouts and spikes; with
                           ``PanicKernel`` in :mod:`repro_torch.core.market`)
  * sweep engine         — :mod:`repro_torch.core.engine` (``run_sweep``
                           runs a policy grid × seed fleet through the CUDA
                           batched-event kernel, :mod:`repro_torch.kernels.sweep`;
                           ``run_market_sweep`` the P-pool market through
                           its market traversal, ``run_region_sweep``
                           N-region routing through its region traversal;
                           ``telemetry=Telemetry(...)`` on all of them adds
                           the :mod:`repro_torch.obs` sketches, counters and
                           trace rings, ``env=EnvTimeline(...)`` the
                           environment timeline and its shock counters,
                           ``work=WorkModel(...)`` the work structure and
                           the survival ledger)
  * seed wrappers        — :mod:`repro_torch.core.simulator`
                           (``run_queue_sim``, ``run_single_slot_sim`` on
                           the split stream)
  * work structure       — :mod:`repro_torch.core.work` (``WorkModel``:
                           multi-unit jobs, restart overhead, checkpoints,
                           deadlines; ``CantBeLateKernel``, the safety net)
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
from repro_torch.core.cost import (cost_lower_bound, region_cost_lower_bound,
                                   theorem1_cost, theorem1_region_cost)
from repro_torch.core.engine import (
    DEFAULT_CHUNK_EVENTS,
    INT_STATS,
    EngineState,
    NonFiniteStatsError,
    WindowStats,
    MarketState,
    MarketWindowStats,
    RegionState,
    RegionWindowStats,
    init_engine_state,
    init_market_state,
    init_region_state,
    NoAdmitHookError,
    run_market_sim,
    run_market_sweep,
    run_region_sim,
    run_region_sweep,
    run_sim,
    run_sweep,
    summarize,
    summarize_market,
    summarize_region,
)
from repro_torch.core.env import (
    EnvTimeline,
    Regime,
    inject_blackout,
    inject_price_spike,
    inject_storm,
    markov_timeline,
    timeline_from_trace,
)
from repro_torch.core.lp import region_knapsack_lp
from repro_torch.core.market import (
    NoticeAwareKernel,
    PanicKernel,
    PoolChoiceKernel,
    SpotMarket,
    SpotPool,
    as_market,
    checkpoint_within_notice,
)
from repro_torch.core.regions import (
    Region,
    RegionTopology,
    RegionView,
    RoutingKernel,
    as_topology,
    choose_region,
    choose_region_u,
    host_route,
)
from repro_torch.core.policies import (
    SingleSlotKernel,
    SingleSlotPolicy,
    ThreePhaseKernel,
    ThreePhasePolicy,
    deadline_slack,
    three_phase_admit_prob,
)
from repro_torch.core.simulator import run_queue_sim, run_single_slot_sim
from repro_torch.core.waittime import (
    DeterministicWait,
    ExponentialWait,
    InfiniteWait,
    TwoPointWait,
)
from repro_torch.core.work import (
    CantBeLateKernel,
    WorkModel,
    WorkState,
    init_work_state,
    restart_overhead_from_timing,
)
from repro_torch.obs.stats import Telemetry

__all__ = [
    "ArrivalProcess", "BathtubGCP", "CantBeLateKernel",
    "DEFAULT_CHUNK_EVENTS", "Deterministic",
    "DeterministicWait", "EngineState", "EnvTimeline", "Exponential",
    "ExponentialWait",
    "Gamma", "INT_STATS", "InfiniteWait", "MarketState",
    "MarketWindowStats", "NoAdmitHookError", "NonFiniteStatsError",
    "NoticeAwareKernel",
    "PanicKernel", "PoolChoiceKernel", "Regime", "Region", "RegionState",
    "RegionTopology", "RegionView", "RegionWindowStats", "RoutingKernel",
    "SingleSlotKernel", "SingleSlotPolicy", "SpotMarket", "SpotPool",
    "Telemetry", "ThreePhaseKernel", "ThreePhasePolicy", "TwoPointWait",
    "Uniform",
    "WindowStats", "WorkModel", "WorkState", "as_market", "as_topology", "checkpoint_within_notice",
    "choose_region", "choose_region_u", "cost_lower_bound", "deadline_slack",
    "host_route",
    "init_engine_state", "init_market_state", "init_region_state",
    "init_work_state",
    "inject_blackout", "inject_price_spike", "inject_storm",
    "markov_timeline", "mm1n_pi", "prob_A_le_S", "region_cost_lower_bound",
    "region_knapsack_lp", "restart_overhead_from_timing", "run_market_sim", "run_market_sweep",
    "run_queue_sim", "run_region_sim", "run_region_sweep", "run_sim",
    "run_single_slot_sim", "run_sweep",
    "summarize", "summarize_market", "summarize_region", "theorem1_cost",
    "theorem1_region_cost", "theorem2_cost", "theorem5_cost",
    "theorem5_delta", "three_phase_admit_prob", "timeline_from_trace",
]
