"""repro_torch.obs — unified telemetry for the serving stack (DESIGN.md §12).

The port of `repro/obs`, which imports no JAX: the same modules and names.

Three pillars, all host-side and hot-path safe:

    trace    structured spans/instants on the monotonic ns clock with
             Chrome-trace/Perfetto export and optional
             `torch.profiler.record_function` bridging (`Tracer`);
    metrics  labeled counters / gauges / exponential-bucket histograms
             with JSON snapshots, Prometheus text exposition and the
             cross-process counter-delta merge protocol the multihost
             coordinator aggregates over (`MetricsRegistry`);
    solve    per-solve records (iterations, KKT, keep-fraction, route,
             modeled-vs-actual seconds) feeding the cost-model residual
             report that validates `core.routing` (`SolveLog`).

Plus `events` (bounded ring of structured JSONL events — host death,
requeue, deadline_exceeded, cache corruption, speculation hit/miss) and
`clock` (the canonical monotonic/walltime aliases the runtime lint pins
timing to).

Environment switches: ``REPRO_TRACE=1`` enables the default tracer at
import; ``REPRO_EVENTS_OUT=/path.jsonl`` dumps the default event log at
interpreter exit.
"""
from __future__ import annotations

import os

from repro_torch.obs import clock
from repro_torch.obs.events import EventLog, default_events, dump_on_exit, emit
from repro_torch.obs.metrics import (Counter, ExponentialHistogram, Gauge, Histogram,
                                     MetricsRegistry, default_registry)
from repro_torch.obs.solve import SolveLog, SolveRecord
from repro_torch.obs.trace import Tracer, disable_tracing, enable_tracing, get_tracer

__all__ = [
    "clock",
    "Tracer", "get_tracer", "enable_tracing", "disable_tracing",
    "Counter", "Gauge", "Histogram", "ExponentialHistogram",
    "MetricsRegistry", "default_registry",
    "EventLog", "default_events", "emit", "dump_on_exit",
    "SolveLog", "SolveRecord",
]

if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    enable_tracing()
if os.environ.get("REPRO_EVENTS_OUT"):
    dump_on_exit(os.environ["REPRO_EVENTS_OUT"])
