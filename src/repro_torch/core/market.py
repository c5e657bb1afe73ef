"""SpotMarket — heterogeneous spot pools with preemption-with-notice.

The port of the JAX package's ``core/market.py``.  A market is P spot
*pools* (instance type × zone), each with its own slot process, price
``c_p``, Poisson preemption hazard ``h_p`` and notice window:

  * :class:`SpotPool` and :class:`SpotMarket` — static, hashable
    descriptors; :meth:`SpotMarket.params` lowers the pools to the per-lane
    float32 pools-config dict the event loop reads.
  * market policy kernels — :class:`PoolChoiceKernel` (any single-queue
    kernel plus a pool-choice rule; revoked jobs defect) and
    :class:`NoticeAwareKernel` (three-phase admission, a pool-choice rule,
    and checkpoint-within-notice recovery).  Their slab hooks
    (``admit_market_u``, ``on_preempt_u``) consume float32 uniforms from
    their own slab columns (``rng="slab"``); their keyed hooks
    (``admit_market``, ``on_preempt``) draw from the event's policy and
    preemption subkeys (``rng="split"``), as the JAX package's do.
  * :class:`PanicKernel` — blackout failover around any kernel: a choice
    of a dead pool (zero rate under the environment timeline) goes to the
    cheapest alive one, and with ``drain_dead`` the engine re-tags jobs
    queued on a dead pool.
  * :func:`checkpoint_within_notice` — the notice law, shared by the
    event loop and a host orchestrator.

Semantics (the JAX package's): a queued job tagged pool ``p`` runs on a
pool-p spot instance; pool p's spot event is its service (cost ``c_p``).
Pool p's preemption revokes its FIFO-oldest job: the partial leg is paid
(``c_p``), then the kernel checkpoints and re-queues it or it defects to
on-demand (cost ``k``).  Per-pool initial clocks are keyed by
``fold_in(key, pool.tag)``, so permuting pools with their tags leaves every
stream, and the statistics, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.clocks import choice_cols, gumbel_from_u, kernel_slab_cols
from repro_torch.core.policies import three_phase_admit_prob
from repro_torch.core.waittime import INF

#: the pool-choice rules :func:`choose_pool_u` knows
CHOICES = ("cheapest", "fastest", "least_loaded", "uniform", "weighted")


@dataclasses.dataclass(frozen=True)
class SpotPool:
    """One spot pool: arrival process + price + preemption hazard/notice.

    ``tag`` is the pool's PRNG-stream identity (defaults to its index in the
    market); keep tags fixed when permuting pools.
    """

    arrival: ArrivalProcess
    price: float = 1.0
    hazard: float = 0.0  # preemption events per unit time on the running job
    notice: float = 0.0  # advance-notice window length
    tag: int | None = None

    def rate(self) -> float:
        return self.arrival.rate()


@dataclasses.dataclass(frozen=True)
class SpotMarket:
    """P heterogeneous spot pools as one static, hashable descriptor."""

    pools: tuple[SpotPool, ...]

    def __post_init__(self):
        if not self.pools:
            raise ValueError("a SpotMarket needs at least one pool")
        tagged = tuple(
            dataclasses.replace(p, tag=i) if p.tag is None else p
            for i, p in enumerate(self.pools))
        tags = [p.tag for p in tagged]
        if len(set(tags)) != len(tags):
            raise ValueError(f"pool tags must be unique, got {tags}")
        object.__setattr__(self, "pools", tagged)

    @property
    def n_pools(self) -> int:
        return len(self.pools)

    @property
    def tags(self) -> tuple[int, ...]:
        return tuple(p.tag for p in self.pools)

    @property
    def preemptible(self) -> bool:
        """Static: does any pool carry a preemption hazard?"""
        return any(p.hazard > 0.0 for p in self.pools)

    @property
    def is_degenerate(self) -> bool:
        """1 pool, unit price, zero hazard: the single queue, bitwise."""
        p = self.pools[0]
        return self.n_pools == 1 and p.hazard == 0.0 and p.price == 1.0

    def prices(self) -> np.ndarray:
        return np.array([p.price for p in self.pools], np.float64)

    def hazards(self) -> np.ndarray:
        return np.array([p.hazard for p in self.pools], np.float64)

    def notices(self) -> np.ndarray:
        return np.array([p.notice for p in self.pools], np.float64)

    def rates(self) -> np.ndarray:
        return np.array([p.rate() for p in self.pools], np.float64)

    def total_rate(self) -> float:
        return float(self.rates().sum())

    def params(self) -> dict:
        """The pools-config dict of float32 ``(P,)`` numpy arrays: price,
        hazard, notice, ``spot_scale`` (multiplies pool inter-arrival times)
        and the raw slot ``rate``."""
        f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
        return {"price": f32(self.prices()), "hazard": f32(self.hazards()),
                "notice": f32(self.notices()),
                "spot_scale": np.ones(self.n_pools, np.float32),
                "rate": f32(self.rates())}

    @staticmethod
    def single(spot: ArrivalProcess, *, price: float = 1.0,
               hazard: float = 0.0, notice: float = 0.0) -> "SpotMarket":
        """A one-pool market (``hazard=0`` is the degenerate case)."""
        return SpotMarket(pools=(SpotPool(arrival=spot, price=price,
                                          hazard=hazard, notice=notice,
                                          tag=0),))

    def relabel(self, perm: Sequence[int]) -> "SpotMarket":
        """Permute pool positions, keeping each pool's tag."""
        if sorted(perm) != list(range(self.n_pools)):
            raise ValueError(f"not a permutation of {self.n_pools} pools")
        return SpotMarket(pools=tuple(self.pools[i] for i in perm))


def as_market(spot) -> SpotMarket:
    """Coerce an :class:`ArrivalProcess` (or a market) to a SpotMarket."""
    if isinstance(spot, SpotMarket):
        return spot
    if isinstance(spot, ArrivalProcess):
        return SpotMarket.single(spot)
    raise TypeError(f"expected ArrivalProcess or SpotMarket, got {spot!r}")


def checkpoint_within_notice(checkpoint_time, notice):
    """Can a revoked job checkpoint before its instance disappears?  Host
    scalars take a Python path, tensors the engine's (float32)."""
    if not (isinstance(checkpoint_time, torch.Tensor)
            or isinstance(notice, torch.Tensor)):
        return checkpoint_time <= notice
    like = notice if isinstance(notice, torch.Tensor) else checkpoint_time
    return (torch.as_tensor(checkpoint_time, dtype=torch.float32,
                            device=like.device)
            <= torch.as_tensor(notice, dtype=torch.float32,
                               device=like.device))


class PoolState(NamedTuple):
    """Non-clairvoyant per-pool state handed to ``admit_market_u``; every
    field is ``(lanes, P)``."""

    price: torch.Tensor  # f32 current pool prices c_p
    hazard: torch.Tensor  # f32 preemption hazards h_p
    notice: torch.Tensor  # f32 notice windows
    rate: torch.Tensor  # f32 slot arrival rates (scaled)
    qlen_pool: torch.Tensor  # i32 queued jobs per pool


def _split_stream(name: str):
    raise NotImplementedError(
        f"{name} draws from a PRNG key: that is the split stream, which is "
        "not ported yet for the regions (ROADMAP.md Queue 1 item 7); the "
        "port runs their slab hooks (*_u)")


def _weighted_pick(logits: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """argmax of logits + Gumbel noise (first index on ties); a ``(lanes,)``
    logits tensor is one logit a lane, the same every pool."""
    if logits.dim() < g.dim():
        logits = logits[..., None]
    return torch.argmax(logits + g, dim=-1).to(torch.int32)


def choose_pool(choice: str, pool_state: PoolState, params=None,
                key=None) -> torch.Tensor:
    """The pool-choice rules, first index on ties: ``cheapest``,
    ``fastest`` and ``least_loaded`` are deterministic; ``uniform`` draws
    ``jax.random.randint``'s pool from ``key`` and ``weighted``
    Gumbel-samples from ``params["pool_logits"]`` under ``key`` (the split
    stream; the slab stream takes :func:`choose_pool_u`)."""
    n = pool_state.price.shape[-1]
    if choice == "cheapest":
        return torch.argmin(pool_state.price, dim=-1).to(torch.int32)
    if choice == "fastest":
        return torch.argmax(pool_state.rate, dim=-1).to(torch.int32)
    if choice == "least_loaded":
        return torch.argmin(pool_state.qlen_pool, dim=-1).to(torch.int32)
    if choice == "uniform":
        return threefry.randint(key, 0, n)
    if choice == "weighted":
        return _weighted_pick(params["pool_logits"], threefry.gumbel(key, n))
    raise ValueError(f"unknown pool choice rule {choice!r}")


def choose_pool_u(choice: str, pool_state: PoolState, params,
                  u: torch.Tensor) -> torch.Tensor:
    """Slab twin of :func:`choose_pool`: ``uniform`` takes one uniform
    column, ``weighted`` Gumbel-samples from ``params["pool_logits"]`` with
    ``P`` columns; the deterministic rules consume nothing."""
    n = pool_state.price.shape[-1]
    if choice == "uniform":
        return torch.clamp_max((u[..., 0] * n).to(torch.int32), n - 1)
    if choice == "weighted":
        return _weighted_pick(params["pool_logits"], gumbel_from_u(u[..., :n]))
    return choose_pool(choice, pool_state, params)


def _check_choice(choice: str) -> None:
    if choice not in CHOICES:
        raise ValueError(f"unknown pool choice rule {choice!r} (expected one "
                         f"of {CHOICES})")


@dataclasses.dataclass(frozen=True)
class PoolChoiceKernel:
    """Adapt a single-queue kernel to the market with a choice rule.

    Admission and wait budgets come from ``base.admit_u`` (the slab
    stream) or ``base.admit`` (the split stream); the pool from
    :func:`choose_pool_u` or :func:`choose_pool`.  Revoked jobs always
    defect to on-demand.
    """

    base: object
    choice: str = "cheapest"

    def __post_init__(self):
        _check_choice(self.choice)

    def admit_market(self, params, qlen, pool_state, key):
        ks = threefry.split(key, 2)  # k_adm, k_choice
        admit, budget = self.base.admit(params, qlen, ks[..., 0, :])
        return admit, budget, choose_pool(self.choice, pool_state, params,
                                          ks[..., 1, :])

    def on_preempt(self, params, age, notice, qlen, key):
        del params, age, notice, key
        return torch.zeros(qlen.shape, dtype=torch.bool, device=qlen.device)

    def slab_cols(self, hook, n):
        if hook == "admit_market":
            base_cols = kernel_slab_cols(self.base, "admit", n)
            if base_cols is None:
                return None
            return base_cols + choice_cols(self.choice, n)
        if hook == "on_preempt":
            return 0  # always defects: draws nothing
        return None

    def admit_market_u(self, params, qlen, pool_state, u):
        base_cols = kernel_slab_cols(self.base, "admit",
                                     pool_state.price.shape[-1])
        admit, budget = self.base.admit_u(params, qlen, u[..., :base_cols])
        return admit, budget, choose_pool_u(self.choice, pool_state, params,
                                            u[..., base_cols:])

    def on_preempt_u(self, params, age, notice, qlen, u):
        del params, age, u
        return torch.zeros(qlen.shape, dtype=torch.bool, device=qlen.device)


@dataclasses.dataclass(frozen=True)
class NoticeAwareKernel:
    """Three-phase admission + pool choice + checkpoint-within-notice.

    A revoked job checkpoints iff its checkpoint fits the pool's notice
    window (:func:`checkpoint_within_notice`), then re-enters admission
    under the Theorem-4 law at the queue length without it.  Params:
    ``{"r": f32}`` (+ optional ``"ckpt"`` overriding ``checkpoint_time``).
    """

    checkpoint_time: float = 0.05
    choice: str = "cheapest"

    def __post_init__(self):
        _check_choice(self.choice)

    def init_params(self, r: float, ckpt: float | None = None) -> dict:
        p = {"r": np.float32(r)}
        if ckpt is not None:
            p["ckpt"] = np.float32(ckpt)
        return p

    def admit_market(self, params, qlen, pool_state, key):
        ks = threefry.split(key, 2)  # k_adm, k_choice
        p = three_phase_admit_prob(qlen, params["r"])
        admit = threefry.uniform(ks[..., 0, :]) < p
        pool = choose_pool(self.choice, pool_state, params, ks[..., 1, :])
        return admit, INF, pool

    def on_preempt(self, params, age, notice, qlen, key):
        del age
        within = checkpoint_within_notice(self.ckpt(params, notice), notice)
        readmit = threefry.uniform(key) < three_phase_admit_prob(
            qlen, params["r"])
        return within & readmit

    def slab_cols(self, hook, n):
        if hook == "admit_market":
            return 1 + choice_cols(self.choice, n)  # admission draw + rule
        if hook == "on_preempt":
            return 1  # the re-admission draw
        return None

    def admit_market_u(self, params, qlen, pool_state, u):
        p = three_phase_admit_prob(qlen, params["r"])
        admit = u[..., 0] < p
        pool = choose_pool_u(self.choice, pool_state, params, u[..., 1:])
        return admit, INF, pool

    def ckpt(self, params, like: torch.Tensor) -> torch.Tensor:
        """The checkpoint time: ``params["ckpt"]`` or the static one."""
        if "ckpt" in params:
            return params["ckpt"]
        return torch.tensor(np.float32(self.checkpoint_time),
                            device=like.device)

    def on_preempt_u(self, params, age, notice, qlen, u):
        del age
        within = checkpoint_within_notice(self.ckpt(params, notice), notice)
        readmit = u[..., 0] < three_phase_admit_prob(qlen, params["r"])
        return within & readmit


def _failover_alive(target: torch.Tensor, alive: torch.Tensor,
                    price: torch.Tensor) -> torch.Tensor:
    """Re-target a dead location to the cheapest alive one (identity where
    the chosen one is alive; position 0 where none is, and callers gate on
    ``alive.any(-1)``)."""
    cheapest_alive = torch.argmin(torch.where(alive, price, INF),
                                  dim=-1).to(torch.int32)
    target = torch.as_tensor(target, dtype=torch.int32, device=alive.device)
    target = target.expand(alive.shape[:-1])
    target_alive = torch.gather(alive, -1, target.long()[..., None])[..., 0]
    return torch.where(target_alive, target, cheapest_alive)


def peel_panic(kernel):
    """The kernel that decides under ``PanicKernel`` wrappers (``kernel``
    itself where there is none)."""
    while isinstance(kernel, PanicKernel):
        kernel = kernel.base
    return kernel


@dataclasses.dataclass(frozen=True)
class PanicKernel:
    """Blackout failover around a base kernel: degrade gracefully when
    supply goes dark.

    The environment timeline (``env=``) multiplies each location's slot
    rate by its availability before the kernel sees it, so ``rate > 0`` is
    the liveness signal.  PanicKernel delegates every decision to ``base``
    and repairs it:

      * an admission to a dead pool goes to the cheapest alive pool;
      * when every pool is dark the job is rejected, to on-demand at cost
        ``k``;
      * a route to a dead region goes to the cheapest alive region (a base
        without a ``route`` hook routes home unless home is dead).

    The failover draws no randomness (slab layouts are the base's), and
    with no blackout every repair is the identity: the statistics are the
    base's, bitwise.  ``drain_dead=True`` also re-tags, on every market
    event, each queued job whose pool is dark to the cheapest alive pool
    (the engine does it; market loop only, as in the JAX package).  In the
    single queue the kernel is its base: its admission is delegated.
    """

    base: object  # any single-queue, market or routing kernel
    drain_dead: bool = False  # re-queue jobs stranded on a dead pool

    # keyed hooks (the split stream): the slab twins' repairs around the
    # base's keyed hooks; a legacy base admits to pool 0
    def admit_market(self, params, qlen, pool_state, key):
        if hasattr(self.base, "admit_market"):
            admit, budget, pool = self.base.admit_market(
                params, qlen, pool_state, key)
        else:
            admit, budget = self.base.admit(params, qlen, key)
            pool = torch.zeros_like(qlen)
        alive = pool_state.rate > 0.0
        pool = _failover_alive(pool, alive, pool_state.price)
        return admit & alive.any(dim=-1), budget, pool

    def on_preempt(self, params, age, notice, qlen, key):
        if hasattr(self.base, "on_preempt"):
            return self.base.on_preempt(params, age, notice, qlen, key)
        return torch.zeros(qlen.shape, dtype=torch.bool, device=qlen.device)

    def route(self, params, qlens, region_state, key):
        _split_stream("PanicKernel.route")

    def slab_cols(self, hook, n):
        if hook == "route":
            if not hasattr(self.base, "route"):
                return 0  # the home fallback draws nothing
            return kernel_slab_cols(self.base, "route", n)
        if hook == "admit_market" and not hasattr(self.base, "admit_market"):
            return kernel_slab_cols(self.base, "admit", n)
        if hook == "on_preempt" and not hasattr(self.base, "on_preempt"):
            return 0  # the defect fallback draws nothing
        return kernel_slab_cols(self.base, hook, n)

    def admit_market_u(self, params, qlen, pool_state, u):
        if hasattr(self.base, "admit_market"):
            admit, budget, pool = self.base.admit_market_u(
                params, qlen, pool_state, u)
        else:
            admit, budget = self.base.admit_u(params, qlen, u)
            pool = torch.zeros_like(qlen)
        alive = pool_state.rate > 0.0
        pool = _failover_alive(pool, alive, pool_state.price)
        return admit & alive.any(dim=-1), budget, pool

    def on_preempt_u(self, params, age, notice, qlen, u):
        if hasattr(self.base, "on_preempt"):
            return self.base.on_preempt_u(params, age, notice, qlen, u)
        return torch.zeros(qlen.shape, dtype=torch.bool, device=qlen.device)

    def route_u(self, params, qlens, region_state, u):
        if hasattr(self.base, "route"):
            target = self.base.route_u(params, qlens, region_state, u)
        else:
            target = region_state.home
        alive = region_state.rate > 0.0
        return _failover_alive(target, alive, region_state.price)

    def __getattr__(self, name):
        # delegate the hooks the wrapper does not repair, so the engine's
        # hasattr dispatch sees the base's protocol for them
        if name in ("admit", "admit_u", "init_params"):
            return getattr(object.__getattribute__(self, "base"), name)
        raise AttributeError(name)
