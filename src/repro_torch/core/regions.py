"""Multi-region topology: N queues, per-region clocks, routing at admission.

The port of the JAX package's ``core/regions.py`` for the slab stream.  A
topology is N regions (cloud region × instance family), each with its own
demand (a job process), supply (a spot slot process), price ``c_r``,
Poisson preemption hazard ``h_r``, notice window and static queue capacity
``rmax_r``:

  * :class:`Region` and :class:`RegionTopology` — static, hashable
    descriptors; :meth:`RegionTopology.params` lowers the regions to the
    per-lane regions-config dict the event loop reads.  The engine packs
    the per-region partitions as one ``(Σ rmax_r,)`` slot array with a
    static slot→region map (:meth:`RegionTopology.slot_offsets`).
  * routing — a kernel's ``route_u`` hook picks the job's target region
    from a :class:`RegionView` (home region, prices, hazards, rates, queue
    lengths) and its own slab columns; the admission law then runs against
    the target's queue.  :class:`RoutingKernel` wraps any single-queue or
    market kernel with one of the rules of :func:`choose_region_u`; a
    kernel without ``route`` keeps every job home.  :func:`host_route` is
    the host twin of the deterministic rules.

Per-region initial clocks are keyed by ``fold_in(key, region.tag)``, so
permuting regions with their tags leaves every stream unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.clocks import choice_cols, gumbel_from_u
from repro_torch.core.market import _split_stream

#: the routing rules :func:`choose_region_u` knows
ROUTES = ("home", "cheapest", "fastest", "least_loaded", "uniform",
          "weighted")


@dataclasses.dataclass(frozen=True)
class Region:
    """One region: demand (job process), supply (spot process), economics.

    ``tag`` is the region's PRNG-stream identity (defaults to its index in
    the topology); keep tags fixed when permuting regions.  ``rmax`` is the
    region's static queue partition.
    """

    job: ArrivalProcess
    spot: ArrivalProcess
    price: float = 1.0
    hazard: float = 0.0  # preemption events per unit time on the running job
    notice: float = 0.0  # advance-notice window length
    rmax: int = 64
    tag: int | None = None

    def job_rate(self) -> float:
        return self.job.rate()

    def spot_rate(self) -> float:
        return self.spot.rate()


@dataclasses.dataclass(frozen=True)
class RegionTopology:
    """N heterogeneous regions as one static, hashable descriptor."""

    regions: tuple[Region, ...]

    def __post_init__(self):
        if not self.regions:
            raise ValueError("a RegionTopology needs at least one region")
        tagged = tuple(
            dataclasses.replace(r, tag=i) if r.tag is None else r
            for i, r in enumerate(self.regions))
        tags = [r.tag for r in tagged]
        if len(set(tags)) != len(tags):
            raise ValueError(f"region tags must be unique, got {tags}")
        for r in tagged:
            if r.rmax < 1:
                raise ValueError("every region needs rmax >= 1")
        object.__setattr__(self, "regions", tagged)

    @property
    def n_regions(self) -> int:
        return len(self.regions)

    @property
    def tags(self) -> tuple[int, ...]:
        return tuple(r.tag for r in self.regions)

    @property
    def total_slots(self) -> int:
        """Size of the packed slot array: the sum of the ``rmax_r``."""
        return sum(r.rmax for r in self.regions)

    @property
    def preemptible(self) -> bool:
        """Static: does any region carry a preemption hazard?"""
        return any(r.hazard > 0.0 for r in self.regions)

    @property
    def is_degenerate(self) -> bool:
        """1 region, unit price, zero hazard: the single queue, bitwise."""
        r = self.regions[0]
        return self.n_regions == 1 and r.hazard == 0.0 and r.price == 1.0

    def slot_offsets(self) -> np.ndarray:
        """Start offset of each region's slot partition (host ints)."""
        return np.cumsum([0] + [r.rmax for r in self.regions[:-1]]).astype(
            np.int32)

    def prices(self) -> np.ndarray:
        return np.array([r.price for r in self.regions], np.float64)

    def hazards(self) -> np.ndarray:
        return np.array([r.hazard for r in self.regions], np.float64)

    def notices(self) -> np.ndarray:
        return np.array([r.notice for r in self.regions], np.float64)

    def rates(self) -> np.ndarray:
        """Per-region spot slot rates μ_r (named as ``SpotMarket.rates``, so
        the topology plugs into :func:`repro_torch.core.lp.market_knapsack_lp`)."""
        return np.array([r.spot_rate() for r in self.regions], np.float64)

    def job_rates(self) -> np.ndarray:
        return np.array([r.job_rate() for r in self.regions], np.float64)

    def total_job_rate(self) -> float:
        return float(self.job_rates().sum())

    def rmaxes(self) -> np.ndarray:
        return np.array([r.rmax for r in self.regions], np.int32)

    def params(self) -> dict:
        """The regions-config dict of ``(R,)`` numpy arrays: float32
        ``price``, ``hazard``, ``notice``, ``spot_scale``/``job_scale``
        (multiply slot and job inter-arrival times), the raw ``rate`` and
        ``job_rate``, and int32 ``rmax``."""
        f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
        n = self.n_regions
        return {"price": f32(self.prices()), "hazard": f32(self.hazards()),
                "notice": f32(self.notices()),
                "spot_scale": np.ones(n, np.float32),
                "job_scale": np.ones(n, np.float32),
                "rate": f32(self.rates()), "job_rate": f32(self.job_rates()),
                "rmax": self.rmaxes()}

    @staticmethod
    def single(job: ArrivalProcess, spot: ArrivalProcess, *,
               price: float = 1.0, hazard: float = 0.0, notice: float = 0.0,
               rmax: int = 64) -> "RegionTopology":
        """A one-region topology (``hazard=0, price=1`` is the degenerate
        case)."""
        return RegionTopology(regions=(Region(
            job=job, spot=spot, price=price, hazard=hazard, notice=notice,
            rmax=rmax, tag=0),))

    def relabel(self, perm: Sequence[int]) -> "RegionTopology":
        """Permute region positions, keeping each region's tag."""
        if sorted(perm) != list(range(self.n_regions)):
            raise ValueError(f"not a permutation of {self.n_regions} regions")
        return RegionTopology(regions=tuple(self.regions[i] for i in perm))


def as_topology(obj) -> RegionTopology:
    """Coerce a Region (or a topology) to a RegionTopology."""
    if isinstance(obj, RegionTopology):
        return obj
    if isinstance(obj, Region):
        return RegionTopology(regions=(obj,))
    raise TypeError(f"expected Region or RegionTopology, got {obj!r}")


class RegionView(NamedTuple):
    """Per-region state handed to the ``route_u`` hook; ``home`` is
    ``(lanes,)``, every other field ``(lanes, R)``, indexed by region
    position."""

    home: torch.Tensor  # i32 arrival region of the current job
    price: torch.Tensor  # f32 region prices c_r
    hazard: torch.Tensor  # f32 preemption hazards h_r
    notice: torch.Tensor  # f32 notice windows
    rate: torch.Tensor  # f32 spot slot rates (scaled)
    job_rate: torch.Tensor  # f32 job arrival rates (scaled)
    qlen_region: torch.Tensor  # i32 queued jobs per region
    free_slots: torch.Tensor  # i32 remaining capacity rmax_r - qlen_r


def choose_region(choice: str, view: RegionView, params=None,
                  key=None) -> torch.Tensor:
    """The deterministic routing rules (first index on ties): ``home``,
    ``cheapest``, ``fastest``, ``least_loaded``.  ``uniform`` and
    ``weighted`` draw from a key (the split stream) and raise; the slab
    stream takes :func:`choose_region_u`."""
    del params, key
    if choice == "home":
        return view.home
    if choice == "cheapest":
        return torch.argmin(view.price, dim=-1).to(torch.int32)
    if choice == "fastest":
        return torch.argmax(view.rate, dim=-1).to(torch.int32)
    if choice == "least_loaded":
        return torch.argmin(view.qlen_region, dim=-1).to(torch.int32)
    if choice in ("uniform", "weighted"):
        _split_stream(f"choose_region({choice!r}, key)")
    raise ValueError(f"unknown routing rule {choice!r}")


def choose_region_u(choice: str, view: RegionView, params,
                    u: torch.Tensor) -> torch.Tensor:
    """Slab twin of :func:`choose_region`: ``uniform`` takes one uniform
    column, ``weighted`` Gumbel-samples from ``params["region_logits"]``
    with ``R`` columns; the deterministic rules consume nothing."""
    n = view.price.shape[-1]
    if choice == "uniform":
        return torch.clamp_max((u[..., 0] * n).to(torch.int32), n - 1)
    if choice == "weighted":
        g = gumbel_from_u(u[..., :n])
        logits = params["region_logits"]
        if logits.dim() < g.dim():  # one logit a lane, the same every region
            logits = logits[..., None]
        return torch.argmax(logits + g, dim=-1).to(torch.int32)
    return choose_region(choice, view, params)


def host_route(choice: str, *, prices, rates, qlens, home: int = 0,
               alive=None) -> int:
    """Host-scalar twin of the deterministic :func:`choose_region` rules.

    ``alive`` (an optional bool mask) restricts every rule to live regions:
    a dead ``home`` falls back to the cheapest live region, and the argmin
    and argmax rules never pick a dead one.  With none alive it raises
    ``RuntimeError`` (the orchestrator's cue to run the job on demand).
    """
    prices = np.asarray(prices, np.float64)
    rates = np.asarray(rates, np.float64)
    qlens = np.asarray(qlens, np.float64)
    if alive is not None:
        alive = np.asarray(alive, bool)
        if not alive.any():
            raise RuntimeError("host_route: no region alive")
        dead = ~alive
        if choice == "home" and dead[int(home)]:
            choice = "cheapest"  # failover: home is dark
        prices = np.where(dead, np.inf, prices)
        rates = np.where(dead, -np.inf, rates)
        qlens = np.where(dead, np.inf, qlens)
    if choice == "home":
        return int(home)
    if choice == "cheapest":
        return int(np.argmin(prices))
    if choice == "fastest":
        return int(np.argmax(rates))
    if choice == "least_loaded":
        return int(np.argmin(qlens))
    raise ValueError(f"unknown host routing rule {choice!r}")


@dataclasses.dataclass(frozen=True)
class RoutingKernel:
    """Adapt any engine kernel to the region protocol with a rule.

    Admission, wait budgets and the revocation hook delegate to ``base``,
    evaluated against the *target* region's queue; the target comes from
    :func:`choose_region_u`.  The region loop's slot→region map is static:
    routing steers new admissions only.
    """

    base: object
    choice: str = "cheapest"

    def __post_init__(self):
        if self.choice not in ROUTES:
            raise ValueError(f"unknown routing rule {self.choice!r} "
                             f"(expected one of {ROUTES})")

    def route(self, params, qlens, region_state: RegionView, key):
        del qlens  # carried by region_state.qlen_region
        return choose_region(self.choice, region_state, params, key)

    def slab_cols(self, hook, n):
        if hook == "route":
            return choice_cols(self.choice, n)
        base_cols = getattr(object.__getattribute__(self, "base"),
                            "slab_cols", None)
        return base_cols(hook, n) if base_cols is not None else None

    def route_u(self, params, qlens, region_state: RegionView, u):
        del qlens
        return choose_region_u(self.choice, region_state, params, u)

    def __getattr__(self, name):
        # delegate the admission and revocation hooks the base has, so that
        # the engine's hasattr dispatch sees exactly the base's protocol
        if name in ("admit", "admit_market", "on_preempt", "init_params",
                    "admit_u", "admit_market_u", "on_preempt_u"):
            return getattr(object.__getattribute__(self, "base"), name)
        raise AttributeError(name)
