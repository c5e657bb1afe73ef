"""Batched serving engine with spot/on-demand request dispatch.

The port of the JAX package's ``serving/engine.py``.  The paper's
admission controller decides, per request, whether it queues for the cheap
*spot* decode pool (slots appear stochastically) or goes to the dedicated
on-demand pool at cost ``k``; either pool runs the batch through a real
model (prefill, then greedy decode).  The spot and request clocks are
drawn on the host with the port's threefry samplers, seeded from the
frontend's numpy generator, as the JAX package draws them with
``jax.random``.

:class:`BatchedServer` keeps, per ``generate`` call, its host-clock prefill
time (to the first token on the host, so the time to first token) and
decode time in ``timings``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.cluster.orchestrator import OnlineAdmissionController
from repro_torch.core import threefry
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.device import resolve_device


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    arrival_time: float = 0.0
    tokens_out: list = dataclasses.field(default_factory=list)
    pool: str = ""  # "spot" | "ondemand"
    delay: float = 0.0


class BatchedServer:
    """Slot-based batching for one model replica on ``device`` (``None``:
    the GPU; raises without one).  The model holds its weights."""

    def __init__(self, model, *, max_batch: int, max_len: int, device=None):
        self.device = resolve_device(device, "BatchedServer")
        self.model = model.to(self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.timings: list[dict] = []

    def generate(self, prompts: list[np.ndarray], max_new: int
                 ) -> list[list[int]]:
        """Greedy-decode a batch of equal-length prompts."""
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.stack(prompts), device=self.device)
        logits, cache = self.model.prefill({"tokens": toks},
                                           max_len=toks.shape[1] + max_new)
        cur = logits[:, -1].argmax(dim=-1)
        outs = [[] for _ in range(len(prompts))]
        first = cur.tolist()  # the first tokens reach the host
        t1 = time.perf_counter()
        for step in range(max_new):
            for out, tok in zip(outs, first if step == 0 else cur.tolist()):
                out.append(tok)
            logits, cache = self.model.decode_step({"tokens": cur[:, None]},
                                                   cache)
            cur = logits[:, 0].argmax(dim=-1)
        cur.tolist()  # the last step is done
        self.timings.append({"batch": len(prompts), "prompt": toks.shape[1],
                             "new_tokens": max_new, "prefill_s": t1 - t0,
                             "decode_s": time.perf_counter() - t1})
        return outs


class SpotServingFrontend:
    """Request stream → paper-policy dispatch → spot/on-demand pools."""

    def __init__(self, server: BatchedServer, *,
                 spot_process: ArrivalProcess,
                 controller: OnlineAdmissionController,
                 k_cost: float = 10.0, batch_size: int = 4, seed: int = 0):
        self.server = server
        self.spots = spot_process
        self.ctl = controller
        self.k = k_cost
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []
        self.total_cost = 0.0
        self._t = 0.0

    def _sample(self, process: ArrivalProcess) -> float:
        key = threefry.key(int(self.rng.integers(2**31)))
        return float(process.sample(key))

    def submit(self, req: Request, now: float) -> None:
        req.arrival_time = now
        if self.ctl.admit(len(self.queue), self.rng):
            self.queue.append(req)
        else:
            self._serve([req], "ondemand", now)

    def spot_slot(self, now: float) -> None:
        """A spot decode slot became available: serve up to batch_size."""
        if not self.queue:
            return
        batch = []
        while self.queue and len(batch) < self.batch_size:
            batch.append(self.queue.popleft())
        self._serve(batch, "spot", now)

    def _serve(self, reqs: list[Request], pool: str, now: float) -> None:
        prompts = [r.prompt for r in reqs]
        outs = self.server.generate(prompts, reqs[0].max_new_tokens)
        for r, toks in zip(reqs, outs):
            r.tokens_out = toks
            r.pool = pool
            r.delay = now - r.arrival_time
            self.completed.append(r)
            self.total_cost += 1.0 if pool == "spot" else self.k
            self.ctl.on_job_complete(r.delay)

    # ------------------------------------------------------------ simulation
    def run_stream(self, job_process: ArrivalProcess, *, n_requests: int,
                   prompt_len: int, max_new: int, vocab: int) -> dict:
        next_req = 0.0
        next_spot = self._sample(self.spots)
        rid = 0
        while rid < n_requests:
            if next_req <= next_spot:
                self._t += next_req
                next_spot -= next_req
                next_req = self._sample(job_process)
                rid += 1
                prompt = self.rng.integers(
                    2, vocab, size=prompt_len).astype(np.int32)
                self.submit(Request(rid, prompt, max_new), self._t)
            else:
                self._t += next_spot
                next_req -= next_spot
                next_spot = self._sample(self.spots)
                self.spot_slot(self._t)
        # drain
        while self.queue:
            self._t += next_spot
            next_spot = self._sample(self.spots)
            self.spot_slot(self._t)
        n = max(len(self.completed), 1)
        return {
            "avg_cost": self.total_cost / n,
            "avg_delay": float(np.mean([r.delay for r in self.completed])),
            "spot_fraction": float(np.mean(
                [r.pool == "spot" for r in self.completed])),
            "r_star": self.ctl.r,
            "completed": len(self.completed),
        }
