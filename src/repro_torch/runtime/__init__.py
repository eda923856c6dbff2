"""repro_torch.runtime — the continuous-batching serving runtime
(DESIGN.md §8), the port of `repro/runtime`.

The layer between the solver engine (core/) and the serving facade
(serve/): an event-loop scheduler that coalesces live requests onto the
power-of-two bucket ladder and launches lane-batched solves (`scheduler`),
a warm-start solution cache exploiting the paper's adjacent-lambda
observation (`cache`), rank-1 streaming-row updates (`online`),
latency/throughput percentile accounting (`metrics`) and a reproducible
open-loop load generator (`loadgen` — also the serving smoke:
``python -m repro_torch.runtime``), and the coordinator that spans the
scheduler over worker processes and survives a killed one (`multihost`).

Telemetry (DESIGN.md §12) lives in `repro_torch.obs` — the registry /
tracer / event-log surface is re-exported here because the runtime
components are its primary producers.
"""
from repro_torch.obs import (EventLog, MetricsRegistry, SolveLog, SolveRecord, Tracer,
                             default_events, default_registry, disable_tracing,
                             enable_tracing, get_tracer)
from repro_torch.runtime.cache import (CONSTRAINED, PENALIZED, PersistentCacheTier,
                                       SolutionCache, TieredSolutionCache, WarmEntry,
                                       fingerprint_problem)
from repro_torch.runtime.loadgen import LoadItem, LoadSpec, make_workload, run_open_loop
from repro_torch.runtime.metrics import LatencyRecorder, percentile
from repro_torch.runtime.multihost import MultiHostCoordinator
from repro_torch.runtime.online import OnlineElasticNet, OnlineSolution, OnlineStats
from repro_torch.runtime.scheduler import (ContinuousScheduler, EnRequest, EnResult,
                                           RuntimeStats, ceil_pow2)

__all__ = [
    "ContinuousScheduler",
    "MultiHostCoordinator",
    "EnRequest",
    "EnResult",
    "RuntimeStats",
    "ceil_pow2",
    "SolutionCache",
    "TieredSolutionCache",
    "PersistentCacheTier",
    "WarmEntry",
    "fingerprint_problem",
    "CONSTRAINED",
    "PENALIZED",
    "OnlineElasticNet",
    "OnlineSolution",
    "OnlineStats",
    "LatencyRecorder",
    "percentile",
    "LoadSpec",
    "LoadItem",
    "make_workload",
    "run_open_loop",
    "MetricsRegistry",
    "Tracer",
    "EventLog",
    "SolveLog",
    "SolveRecord",
    "default_registry",
    "default_events",
    "get_tracer",
    "enable_tracing",
    "disable_tracing",
]
