"""Latency and throughput accounting for the serving runtime (DESIGN.md §8,
§12.2).

Every request passes through three instants — submitted (admission),
launched (its micro-batch dispatched to the device) and completed (results
unpadded and delivered) — so the recorder can split end-to-end latency into
queue wait (submitted -> launched: the price of coalescing) and service
time (launched -> completed: device compute + harvest). `summary()` folds
the rolled-up state into percentile/throughput numbers. The port of
`repro/runtime/metrics.py`.

Memory is BOUNDED: only OPEN (not-yet-completed) requests keep a
per-request record; completion folds the record into exponential-bucket
histograms on the recorder's `MetricsRegistry` (`request_latency_seconds`,
`request_queue_wait_seconds`) plus scalar rollups, so a long-running
loadgen never grows it. Percentiles are histogram
quantiles (<= ~4% relative error, exact at min/max), which every consumer
of `summary()` uses as ratios or ordering, never as exact values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Sequence

from repro_torch.obs.metrics import MetricsRegistry


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]) of a non-empty list."""
    if not values:
        raise ValueError("percentile: empty sequence")
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


@dataclasses.dataclass
class RequestTimes:
    """The three instants of one request's life in the runtime."""

    submitted: float
    launched: Optional[float] = None
    completed: Optional[float] = None

    @property
    def queue_wait(self) -> Optional[float]:
        if self.launched is None:
            return None
        return self.launched - self.submitted

    @property
    def latency(self) -> Optional[float]:
        if self.completed is None:
            return None
        return self.completed - self.submitted


class LatencyRecorder:
    """Per-request event log; pure host-side bookkeeping, no device syncs.

    `registry` hooks the latency/queue-wait histograms into an owner's
    `MetricsRegistry` (the scheduler passes its own, so the series show up
    in its Prometheus exposition); by default the recorder keeps a private
    one. Open requests are the only per-request state — completed requests
    live on solely as histogram mass.
    """

    def __init__(self, *, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self._open: Dict[int, RequestTimes] = {}
        self._lat = self.registry.histogram(
            "request_latency_seconds",
            "end-to-end latency of completed requests")
        self._wait = self.registry.histogram(
            "request_queue_wait_seconds",
            "admission -> launch coalescing wait of completed requests")
        self._n_completed = 0
        self._first_submitted: Optional[float] = None
        self._last_completed: Optional[float] = None

    def submitted(self, req_id: int, now: float) -> None:
        self._open[req_id] = RequestTimes(submitted=now)

    def launched(self, req_ids: Iterable[int], now: float) -> None:
        # ids missing from the open table were submitted before a reset()
        # (or already completed) — they are simply no longer tracked, never
        # an error on the serving path
        for rid in req_ids:
            t = self._open.get(rid)
            if t is not None:
                t.launched = now

    def completed(self, req_ids: Iterable[int], now: float) -> None:
        for rid in req_ids:
            t = self._open.pop(rid, None)
            if t is None:
                continue
            t.completed = now
            self._lat.observe(max(t.latency, 0.0))
            if t.queue_wait is not None:
                self._wait.observe(max(t.queue_wait, 0.0))
            self._n_completed += 1
            if (self._first_submitted is None
                    or t.submitted < self._first_submitted):
                self._first_submitted = t.submitted
            if self._last_completed is None or now > self._last_completed:
                self._last_completed = now

    def reset(self) -> None:
        self._open.clear()
        self._lat.reset()
        self._wait.reset()
        self._n_completed = 0
        self._first_submitted = None
        self._last_completed = None

    @property
    def open_count(self) -> int:
        return len(self._open)

    @property
    def completed_count(self) -> int:
        return self._n_completed

    def summary(self, quantiles: Sequence[float] = (50.0, 90.0, 99.0)) -> dict:
        """Latency percentiles (seconds) + open-loop throughput (req/s).

        Throughput is completed requests over the span from the first
        submission to the last completion — the sustained rate an open-loop
        client observed, not the reciprocal of mean latency.
        """
        lat = self._lat.series().get(())
        if self._n_completed == 0 or lat is None or lat.count == 0:
            return {"n_completed": 0, "req_per_s": 0.0}
        span = self._last_completed - self._first_submitted
        out = {
            "n_completed": self._n_completed,
            "req_per_s": self._n_completed / max(span, 1e-12),
            "mean_latency_s": lat.sum / lat.count,
        }
        for q in quantiles:
            out[f"p{int(q)}_latency_s"] = lat.quantile(q)
        wait = self._wait.series().get(())
        if wait is not None and wait.count:
            out["mean_queue_wait_s"] = wait.sum / wait.count
        return out
