"""The paper's Algorithm 1 running online, on a live request stream.

The port of the JAX package's ``cluster/orchestrator.py`` as far as the
serving frontend and the market use it: :class:`OnlineAdmissionController`
admits each job to the spot queue with the Theorem-4 three-phase
probability at the current cap ``r``, moves ``r`` by projected SGD on the
windowed mean delay, picks a spot pool for it (``choose_pool``, the host
twin of the event loop's ``cheapest`` rule) and routes it to a region
(``choose_region``, the host twin of the deterministic routing rules).
``SpotCluster`` and ``MultiRegionCluster`` belong to a later slice
(ROADMAP.md Queue 1 item 13).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.policies import (ThreePhaseKernel, ThreePhasePolicy,
                                       three_phase_admit_prob)
from repro_torch.core.regions import host_route


class OnlineAdmissionController:
    """Algorithm 1 on a live stream: windowed delay → projected SGD on r."""

    def __init__(self, *, delta: float, eta: float = 0.05,
                 eta_decay: float = 0.05, r0: float = 1.0,
                 r_max: float = 16.0, window_jobs: int = 64):
        self.delta = delta
        self.eta = eta
        self.eta_decay = eta_decay
        self.r = r0
        self.r_max = r_max
        self.window_jobs = window_jobs
        self._delays: list[float] = []
        self._updates = 0
        self.history: list[float] = [r0]

    def policy(self) -> ThreePhasePolicy:
        return ThreePhasePolicy(r=self.r)

    def kernel(self) -> ThreePhaseKernel:
        """The engine kernel twin; pair with :meth:`kernel_params`."""
        return ThreePhaseKernel()

    def kernel_params(self) -> dict:
        return self.policy().kernel_params()

    def admit(self, queue_len: int, rng: np.random.Generator) -> bool:
        return rng.random() < three_phase_admit_prob(queue_len, self.r)

    def choose_pool(self, market, qlen_pool, alive=None) -> int:
        """The cheapest pool (the first on ties), the event loop's default
        rule.  ``alive`` (a bool mask) restricts the choice to live pools;
        with none alive it raises ``RuntimeError`` (the cluster's cue to
        run on demand)."""
        del qlen_pool
        prices = market.prices()
        if alive is not None:
            alive = np.asarray(alive, bool)
            if not alive.any():
                raise RuntimeError("choose_pool: no pool alive")
            prices = np.where(alive, prices, np.inf)
        return int(np.argmin(prices))

    def choose_region(self, topology, qlen_region, home: int = 0,
                      rule: str = "cheapest", alive=None) -> int:
        """The routing hook's host twin: the deterministic
        :func:`repro_torch.core.regions.host_route` rules, with the region
        health mask ``alive`` (failover as there)."""
        return host_route(rule, prices=topology.prices(),
                          rates=topology.rates(), qlens=qlen_region,
                          home=home, alive=alive)

    def on_job_complete(self, delay: float) -> None:
        self._delays.append(delay)
        if len(self._delays) >= self.window_jobs:
            d = float(np.mean(self._delays))
            self._delays.clear()
            step = self.eta / math.sqrt(1.0 + self.eta_decay * self._updates)
            self._updates += 1
            self.r = min(self.r_max, max(0.0, self.r - step * (d - self.delta)))
            self.history.append(self.r)
