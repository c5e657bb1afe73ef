"""Event-trace capture and Chrome/Perfetto export (numpy and json only).

The port of the JAX package's ``repro.obs.trace``.  Two producers, one
format:

* **Device rings** — with ``Telemetry(trace_cap=K)`` the engine's event
  loops record every merged event into a bounded per-window ring
  (:mod:`repro_torch.obs.stats`).  ``summarize*(..., telemetry=...)``
  returns the stacked rings under ``telemetry["trace"]``;
  :func:`device_trace_records` re-times them onto one global clock
  (window starts come from the base ``time_elapsed`` windows) and
  :func:`to_perfetto` turns records into Chrome trace JSON.
* **Host loops** — :class:`TraceRecorder` is the same record stream fed
  by hand from a Python event loop, so a host replay and a device run
  export the same schema.

The export is the classic Chrome ``traceEvents`` array (what
``ui.perfetto.dev`` and ``chrome://tracing`` both load): one instant
event (``"ph": "i"``) per sim event on a per-location track, plus a
``"ph": "C"`` counter track for queue length.  Sim time (hours) maps to
trace microseconds 1:1e6 so zooming works at event granularity.
"""
from __future__ import annotations

import json
from typing import Iterable

import numpy as np

from repro_torch.obs.stats import EVENT_TYPES

#: Perfetto track (tid) per event type keeps the instant events readable.
_TYPE_TID = {name: i + 1 for i, name in enumerate(EVENT_TYPES)}
_QLEN_TID = len(EVENT_TYPES) + 1


def device_trace_records(trace: dict, time_windows, *,
                         lane: int = 0) -> list[dict]:
    """Flatten one lane's stacked window rings into global-time records.

    ``trace`` is ``telemetry["trace"]`` from a ``summarize*`` call: each
    field is ``(..., n_windows, cap)`` (``n`` is ``(..., n_windows)``).
    ``time_windows`` is the matching per-window ``time_elapsed`` stack —
    window k's records are offset by the duration of windows < k.  Rings
    wrap at ``cap``; wrapped (overwritten) slots are skipped and counted
    in the ``dropped`` field of the first record of that window.
    """
    def _lane(x):
        x = np.asarray(x)
        return x.reshape((-1,) + x.shape[-2:])[lane] if x.ndim > 2 else x

    t = _lane(trace["t"])
    ev_type = _lane(trace["type"])
    loc = _lane(trace["loc"])
    qlen = _lane(trace["qlen"])
    val = _lane(trace["val"])
    n = np.asarray(trace["n"]).reshape(-1, t.shape[0])[lane] \
        if np.asarray(trace["n"]).ndim > 1 else np.asarray(trace["n"])
    tw = np.asarray(time_windows, np.float64)
    tw = tw.reshape(-1, tw.shape[-1])[lane] if tw.ndim > 1 else tw
    starts = np.concatenate([[0.0], np.cumsum(tw)[:-1]])

    cap = t.shape[-1]
    records: list[dict] = []
    for w in range(t.shape[0]):
        kept = int(min(n[w], cap))
        dropped = int(max(n[w] - cap, 0))
        # on wrap the ring holds the LAST cap records, starting at n % cap
        order = (np.arange(kept) + (int(n[w]) % cap if dropped else 0)) % cap
        for j in order:
            rec = {
                "t": float(starts[w] + t[w, j]),
                "type": EVENT_TYPES[int(ev_type[w, j])],
                "loc": int(loc[w, j]),
                "qlen": int(qlen[w, j]),
            }
            if val[w, j] >= 0.0:
                rec["wait"] = float(val[w, j])
            records.append(rec)
        if dropped and records:
            records[-kept]["dropped"] = dropped
    return records


class TraceRecorder:
    """Host-side record stream — the orchestrator's per-event tap.

    ``record(t, type, loc, qlen, **fields)`` appends one record; bounded
    by ``cap`` (drops are counted, mirroring the device ring contract).
    """

    def __init__(self, cap: int = 100_000):
        self.cap = cap
        self.records: list[dict] = []
        self.dropped = 0

    def record(self, t: float, type: str, loc: int = 0, qlen: int = 0,
               **fields) -> None:
        if len(self.records) >= self.cap:
            self.dropped += 1
            return
        rec = {"t": float(t), "type": type, "loc": int(loc),
               "qlen": int(qlen)}
        rec.update(fields)
        self.records.append(rec)


def to_perfetto(records: Iterable[dict], *, pid: int = 1,
                label: str = "sim") -> dict:
    """Chrome/Perfetto ``traceEvents`` JSON from a record stream.

    One instant event per record on the event-type's track; a queue-
    length counter track alongside.  Sim hours → trace µs at 1:1e6.
    """
    events: list[dict] = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": label}},
        {"ph": "M", "pid": pid, "tid": _QLEN_TID, "name": "thread_name",
         "args": {"name": "queue length"}},
    ]
    for name, tid in _TYPE_TID.items():
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
    for rec in records:
        ts = rec["t"] * 1e6
        args = {"loc": rec["loc"], "qlen": rec["qlen"]}
        for key in ("wait", "dropped"):
            if key in rec:
                args[key] = rec[key]
        events.append({
            "ph": "i", "s": "t", "pid": pid,
            "tid": _TYPE_TID.get(rec["type"], len(_TYPE_TID) + 2),
            "ts": ts, "name": f"{rec['type']}@{rec['loc']}", "args": args,
        })
        events.append({
            "ph": "C", "pid": pid, "tid": _QLEN_TID, "ts": ts,
            "name": "qlen", "args": {"jobs": rec["qlen"]},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(path: str, records: Iterable[dict], **kwargs) -> None:
    with open(path, "w") as f:
        json.dump(to_perfetto(records, **kwargs), f)
