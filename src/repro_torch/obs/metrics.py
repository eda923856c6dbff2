"""Labeled metrics registry: counters, gauges, exponential-bucket
histograms (DESIGN.md §12.2).

One `MetricsRegistry` per owner — each `ContinuousScheduler` (and its
cache) holds a private registry so per-scheduler counter semantics match
the pre-registry attribute counters they replaced; a process-wide
`default_registry()` collects cross-cutting series (solver trace counts,
router decisions). Snapshots serialize to plain JSON; `to_prometheus()`
renders the text exposition format `launch/serve_en.py --metrics-port`
serves.

Multihost aggregation (DESIGN.md §12.4) rides `counter_deltas()`: a worker
snapshots the counter increments since its previous snapshot and piggybacks
them on the result/error/stats messages it already sends; the coordinator
`merge_counter_deltas()` them into one fleet registry plus a per-host view.
Deltas are idempotent to host death — a dead host's final deltas either
arrived (salvaged with its buffered results) or are dropped with the
message, never double-merged, because each delta is consumed by exactly one
snapshot call on the worker side.

Instruments are deliberately lock-free: the serving runtime is
single-threaded per process, and the only concurrent reader (the metrics
HTTP endpoint) tolerates a torn multi-series view.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "ExponentialHistogram",
           "MetricsRegistry", "default_registry"]


class ExponentialHistogram:
    """Fixed-size exponential-bucket histogram of positive samples.

    Bucket ``i`` covers ``(start*factor**(i-1), start*factor**i]``; samples
    at or below ``start`` land in bucket 0, samples beyond the last edge in
    the last bucket. The default geometry (1e-7 s, x1.08, 420 buckets)
    spans sub-microsecond to ~1e7 seconds with <= 4% relative quantile
    error — memory is O(buckets), never O(samples), which is the point:
    rolled-up latency state stays bounded under an unbounded request
    stream (the `LatencyRecorder` leak fix rides on this).
    """

    __slots__ = ("start", "factor", "_log_factor", "counts", "count",
                 "sum", "min", "max")

    def __init__(self, *, start: float = 1e-7, factor: float = 1.08,
                 n_buckets: int = 420) -> None:
        if not (start > 0 and factor > 1 and n_buckets >= 1):
            raise ValueError(f"ExponentialHistogram: need start > 0, "
                             f"factor > 1, n_buckets >= 1 "
                             f"(got {start}/{factor}/{n_buckets})")
        self.start = start
        self.factor = factor
        self._log_factor = math.log(factor)
        self.counts = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, v: float) -> int:
        if v <= self.start:
            return 0
        i = int(math.ceil(math.log(v / self.start) / self._log_factor))
        return min(i, len(self.counts) - 1)

    def observe(self, v: float) -> None:
        self.counts[self._index(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def edges(self) -> List[float]:
        """Upper edge of every bucket (the Prometheus ``le`` values)."""
        return [self.start * self.factor ** i for i in range(len(self.counts))]

    def quantile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]); exact at the
        recorded min/max, within one bucket's width elsewhere."""
        if self.count == 0:
            raise ValueError("quantile: empty histogram")
        target = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.start * self.factor ** (i - 1) if i else 0.0
                hi = self.start * self.factor ** i
                frac = (target - cum) / c
                est = lo + frac * (hi - lo)
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def merge(self, other: "ExponentialHistogram") -> None:
        if (other.start != self.start or other.factor != self.factor
                or len(other.counts) != len(self.counts)):
            raise ValueError("merge: histogram geometries differ")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def reset(self) -> None:
        self.counts = [0] * len(self.counts)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class _Instrument:
    kind = "abstract"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[k]) for k in self.labelnames)


class Counter(_Instrument):
    """Monotone counter (resettable — this is an introspection tool, not a
    long-lived Prometheus server; `set()` exists for the read-through shims
    that keep ``stats.requests += 1`` style call sites working)."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def set(self, value: float, **labels) -> None:
        self._values[self._key(labels)] = value

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def series(self) -> Dict[tuple, float]:
        return dict(self._values)

    def reset(self) -> None:
        self._values.clear()


class Gauge(Counter):
    """Point-in-time value; same storage as Counter, different exposition
    type (and excluded from cross-host delta merging — a gauge has no
    meaningful sum across hosts)."""

    kind = "gauge"


class Histogram(_Instrument):
    """Labeled family of `ExponentialHistogram`s."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), *, start=1e-7,
                 factor=1.08, n_buckets=420):
        super().__init__(name, help, labelnames)
        self._geometry = dict(start=start, factor=factor, n_buckets=n_buckets)
        self._series: Dict[tuple, ExponentialHistogram] = {}

    def _hist(self, labels: dict) -> ExponentialHistogram:
        key = self._key(labels)
        h = self._series.get(key)
        if h is None:
            h = self._series[key] = ExponentialHistogram(**self._geometry)
        return h

    def observe(self, v: float, **labels) -> None:
        self._hist(labels).observe(v)

    def quantile(self, q: float, **labels) -> float:
        return self._hist(labels).quantile(q)

    def stats(self, **labels) -> dict:
        h = self._hist(labels)
        return {"count": h.count, "sum": h.sum,
                "min": (None if h.count == 0 else h.min),
                "max": (None if h.count == 0 else h.max)}

    def series(self) -> Dict[tuple, ExponentialHistogram]:
        return self._series

    def reset(self) -> None:
        self._series.clear()


def _labelstr(labelnames, key) -> str:
    return ",".join(f'{n}="{v}"' for n, v in zip(labelnames, key))


class MetricsRegistry:
    """Get-or-create instrument registry with JSON / Prometheus export.

    Naming conventions (DESIGN.md §12.2): snake_case, unit-suffixed
    (``_total`` counters, ``_seconds`` histograms), label cardinality
    bounded by construction (reasons, statuses, route paths — never request
    ids or fingerprints).
    """

    def __init__(self) -> None:
        self._instruments: "collections.OrderedDict[str, _Instrument]" = (
            collections.OrderedDict())
        self._delta_marks: Dict[str, Dict[tuple, float]] = {}

    def _get(self, cls, name, help, labelnames, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, help, labelnames, **kw)
            self._instruments[name] = inst
            return inst
        if not isinstance(inst, cls) or type(inst) is not cls:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{inst.kind}, requested {cls.kind}")
        if tuple(labelnames) != inst.labelnames:
            raise ValueError(f"metric {name!r} labelnames mismatch: "
                             f"{inst.labelnames} vs {tuple(labelnames)}")
        return inst

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), **geometry) -> Histogram:
        return self._get(Histogram, name, help, labelnames, **geometry)

    def instruments(self) -> Iterable[_Instrument]:
        return list(self._instruments.values())

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-JSON view of every series (histograms roll up to
        count/sum/min/max + headline quantiles, not raw buckets)."""
        out: dict = {}
        for inst in self._instruments.values():
            if isinstance(inst, Histogram):
                series = {}
                for key, h in inst.series().items():
                    s = {"count": h.count, "sum": h.sum}
                    if h.count:
                        s.update(min=h.min, max=h.max,
                                 p50=h.quantile(50.0), p99=h.quantile(99.0))
                    series[_labelstr(inst.labelnames, key) or "_"] = s
            else:
                series = {_labelstr(inst.labelnames, k) or "_": v
                          for k, v in inst.series().items()}
            out[inst.name] = {"type": inst.kind, "help": inst.help,
                              "values": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus/OpenMetrics text exposition."""
        lines: List[str] = []
        for inst in self._instruments.values():
            if inst.help:
                lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            if isinstance(inst, Histogram):
                for key, h in inst.series().items():
                    base = _labelstr(inst.labelnames, key)
                    sep = "," if base else ""
                    cum = 0
                    for edge, c in zip(h.edges(), h.counts):
                        cum += c
                        lines.append(f'{inst.name}_bucket{{{base}{sep}'
                                     f'le="{edge:.6g}"}} {cum}')
                    lines.append(f'{inst.name}_bucket{{{base}{sep}'
                                 f'le="+Inf"}} {h.count}')
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{inst.name}_sum{suffix} {h.sum:.9g}")
                    lines.append(f"{inst.name}_count{suffix} {h.count}")
            else:
                series = inst.series()
                if not series and not inst.labelnames:
                    series = {(): 0.0}   # expose unlabeled zeros explicitly
                for key, v in series.items():
                    base = _labelstr(inst.labelnames, key)
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{inst.name}{suffix} {v:.9g}")
        return "\n".join(lines) + "\n"

    # -- cross-process delta protocol (DESIGN.md §12.4) ---------------------

    def counter_deltas(self) -> dict:
        """Counter increments since the previous `counter_deltas()` call.

        Consumes the increments (advances the watermark), so each delta is
        merged at most once downstream — the idempotence the multihost
        salvage path relies on. Gauges and histograms are per-process by
        design and not shipped.
        """
        out: dict = {}
        for inst in self._instruments.values():
            if type(inst) is not Counter:
                continue
            marks = self._delta_marks.setdefault(inst.name, {})
            deltas = []
            for key, v in inst.series().items():
                d = v - marks.get(key, 0.0)
                if d:
                    deltas.append([list(key), d])
                    marks[key] = v
            if deltas:
                out[inst.name] = {"labelnames": list(inst.labelnames),
                                  "deltas": deltas}
        return out

    def merge_counter_deltas(self, deltas: Optional[dict]) -> None:
        for name, payload in (deltas or {}).items():
            c = self.counter(name, labelnames=tuple(payload["labelnames"]))
            for key, d in payload["deltas"]:
                c.inc(d, **dict(zip(payload["labelnames"], key)))

    def reset(self) -> None:
        for inst in self._instruments.values():
            inst.reset()
        self._delta_marks.clear()

    def reset_instrument(self, name: str) -> None:
        """Zero one instrument AND its delta watermark (so a post-reset
        `counter_deltas()` never ships a negative delta)."""
        inst = self._instruments.get(name)
        if inst is not None:
            inst.reset()
        self._delta_marks.pop(name, None)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry for cross-cutting series (solver trace counts,
    router decisions) — per-scheduler counters live on their own registry."""
    return _DEFAULT
