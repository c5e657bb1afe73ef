"""``repro_torch.obs``: the observability axis of the port.

:class:`Telemetry` is the descriptor the engine entry points take as
``telemetry=``.  With it, sims and sweeps also return streaming wait and
cost quantile sketches, event-type counters and per-pool or per-region
defect and resume counts, accumulated in the same float32 windows as the
base stats, by the CUDA kernels on the card and their plain versions on
the CPU.  ``telemetry=None`` (the default) leaves every base statistic and
every kernel launch as it was.

* :mod:`repro_torch.obs.stats` — accumulators and host summaries.
* :mod:`repro_torch.obs.shocks` — the shock counters of the
  environment-timeline axis (``env=``): boundaries crossed, storms,
  blackouts and spikes entered, shock dwell times, degraded admissions.
* :mod:`repro_torch.obs.survival` — the survival ledger of the work axis
  (``work=``): jobs admitted, finished, on time and late, checkpoints,
  panic entries, work done, lost and recomputed.
* :mod:`repro_torch.obs.trace` — event rings and the Chrome/Perfetto
  exporter.
* :mod:`repro_torch.obs.timing` — profiler spans.
"""
from repro_torch.obs.shocks import (ENV_INT_STATS, EnvWindowStats, env_merge,
                                    env_reduce, env_update, env_zeros,
                                    summarize_env)
from repro_torch.obs.stats import (EVENT_TYPES, TEL_INT_STATS, Telemetry,
                                   TelemetryWindowStats, sketch_quantile,
                                   summarize_telemetry, telemetry_merge,
                                   telemetry_reduce, telemetry_update,
                                   telemetry_zeros)
from repro_torch.obs.survival import (SURVIVAL_INT_STATS,
                                      SurvivalWindowStats, summarize_survival,
                                      survival_merge, survival_reduce,
                                      survival_update, survival_zeros)
from repro_torch.obs.timing import annotate
from repro_torch.obs.trace import (TraceRecorder, device_trace_records,
                                   to_perfetto, write_perfetto)

__all__ = [
    "ENV_INT_STATS",
    "EVENT_TYPES",
    "EnvWindowStats",
    "SURVIVAL_INT_STATS",
    "SurvivalWindowStats",
    "TEL_INT_STATS",
    "Telemetry",
    "TelemetryWindowStats",
    "TraceRecorder",
    "annotate",
    "device_trace_records",
    "env_merge",
    "env_reduce",
    "env_update",
    "env_zeros",
    "sketch_quantile",
    "summarize_env",
    "summarize_survival",
    "summarize_telemetry",
    "survival_merge",
    "survival_reduce",
    "survival_update",
    "survival_zeros",
    "telemetry_merge",
    "telemetry_reduce",
    "telemetry_update",
    "telemetry_zeros",
    "to_perfetto",
    "write_perfetto",
]
