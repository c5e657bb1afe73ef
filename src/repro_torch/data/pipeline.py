"""Deterministic synthetic token pipeline with a checkpointable cursor.

The port of the JAX package's ``data/pipeline.py``.  Batches are a pure
function of (seed, step, host shard), drawn with numpy exactly as the JAX
package draws them, so both packages see the same tokens bitwise; ``next``
hands them over as tensors on an explicit device.  Documents are Zipf-ish
token draws with EOS terminators, greedily packed into ``seq_len``
windows; the cursor is the step counter, so a restore from ``state()``
reproduces the stream and a new host count re-partitions future steps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class DataPipeline:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    eos_id: int = 1
    step: int = 0

    def __post_init__(self):
        if self.global_batch % self.host_count:
            raise ValueError("global_batch must divide across hosts")
        self.host_batch = self.global_batch // self.host_count

    # ------------------------------------------------------------- sampling
    def _batch_for(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        B, S = self.host_batch, self.seq_len
        # Zipf-ish marginal over the vocab (heavier head, long tail)
        toks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        toks = (toks - 1) % (self.vocab_size - 2) + 2  # reserve 0=pad, 1=eos
        # doc packing: terminate docs with EOS at random boundaries
        doc_len = rng.integers(32, max(self.seq_len, 64), size=(B,))
        pos = np.arange(S + 1)[None, :]
        is_eos = (pos % doc_len[:, None]) == (doc_len[:, None] - 1)
        toks = np.where(is_eos, self.eos_id, toks)
        tokens = toks[:, :-1].astype(np.int32)
        targets = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "targets": targets}

    def next(self, device=None) -> dict:
        """The next batch as int32 tensors on ``device`` (``None``: the
        GPU; raises without one)."""
        device = resolve_device(device, "DataPipeline.next")
        batch = self._batch_for(self.step)
        self.step += 1
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    # ----------------------------------------------------------- checkpoint
    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed,
                "host_count": self.host_count}

    def restore(self, state: dict, *, host_index: int = None,
                host_count: int = None):
        """Resume; host topology may change (elastic re-shard)."""
        self.step = int(state["step"])
        self.seed = int(state["seed"])
        if host_count is not None and host_count != self.host_count:
            self.host_count = host_count
            self.host_index = host_index or 0
            self.__post_init__()
        return self
