"""Structured host-side tracing: spans, instants, Chrome-trace export
(DESIGN.md §12.1).

A `Tracer` records nested spans on the host's monotonic ns clock into a
bounded deque — no device syncs, no allocation beyond one tuple per span,
and a disabled tracer costs one attribute check per span site, so the
instrumentation can stay in the serving hot path permanently. The port of
`repro/obs/trace.py`.

Span taxonomy (DESIGN.md §12.1 — the names CI schema-checks for):

    admit          one request admitted (scheduler.submit)
    launch         one bucket dispatched: pad/stack/warm-start + the solve
                   call (reason=full|deadline|flush)
    warm_start     cache lookups for one launch (hits recorded in args)
    harvest.block  the only blocking wait in the runtime
    complete       unpad + cache refill + delivery (parent of none)
    mh.place       coordinator placed a batch on a host (the multihost
                   coordinator is not ported yet)
    route          router decision instant (path + full price table; no
                   router in the port yet)

Export is Chrome-trace JSON (``chrome://tracing`` / Perfetto: "X" complete
events, µs timestamps). With ``annotate=True`` each span also enters a
`torch.profiler.record_function`, so when a torch profile is being captured
the host spans show in its trace beside the kernels they launched.
"""
from __future__ import annotations

import collections
import json
import os
import threading
from typing import Optional

from repro_torch.obs import clock as _clock

__all__ = ["Tracer", "get_tracer", "enable_tracing", "disable_tracing"]


def _torch_annotation(name: str):
    try:
        from torch.profiler import record_function
        return record_function(name)
    except Exception:  # noqa: BLE001 — profiler API absent: spans still work
        return None


class _Span:
    """Reusable context manager for one span — cheaper than a generator
    contextmanager on the per-request path."""

    __slots__ = ("tracer", "name", "args", "t0", "parent", "annot")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = None

    def __enter__(self):
        tr = self.tracer
        if not tr.enabled:
            return self
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.annot = None
        if tr.annotate:
            annot = _torch_annotation(self.name)
            if annot is not None:
                annot.__enter__()
                self.annot = annot
        self.t0 = _clock.monotonic_ns()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        if not tr.enabled or self.t0 is None:
            return False   # disabled, or toggled mid-span: record nothing
        dur = _clock.monotonic_ns() - self.t0
        if self.annot is not None:
            self.annot.__exit__(*exc)
        stack = tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        tr._record("X", self.name, self.parent, self.t0, dur, self.args)
        return False


class _NoopSpan:
    """Shared do-nothing span handed out while tracing is disabled — keeps
    the disabled hot path allocation-free (no `_Span` per call site)."""

    __slots__ = ()
    args = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Bounded in-memory span recorder with Chrome-trace export."""

    def __init__(self, *, capacity: int = 200_000) -> None:
        self.enabled = False
        self.annotate = False
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._counts: collections.Counter = collections.Counter()
        self._tls = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, phase, name, parent, t0_ns, dur_ns, args) -> None:
        self._counts[name] += 1
        self._spans.append((phase, name, parent,
                            threading.get_ident(), t0_ns, dur_ns, args))

    # -- control -----------------------------------------------------------

    def enable(self, *, annotate: bool = False) -> "Tracer":
        self.enabled = True
        self.annotate = annotate
        return self

    def disable(self) -> None:
        self.enabled = False
        self.annotate = False

    def reset(self) -> None:
        self._spans.clear()
        self._counts.clear()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args):
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, args or None)

    def traced(self, name: Optional[str] = None):
        """Decorator form: ``@tracer.traced("phase")``."""
        def deco(fn):
            span_name = name or fn.__qualname__

            def wrapper(*a, **kw):
                with self.span(span_name):
                    return fn(*a, **kw)
            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        stack = self._stack()
        self._record("i", name, stack[-1] if stack else None,
                     _clock.monotonic_ns(), 0, args or None)

    # -- introspection / export --------------------------------------------

    def __len__(self) -> int:
        return len(self._spans)

    def counts(self) -> dict:
        """Span-name -> recorded occurrences (includes rolled-off spans)."""
        return dict(self._counts)

    def spans(self) -> list:
        return list(self._spans)

    def chrome_trace(self) -> dict:
        """The retained spans as a Chrome-trace/Perfetto JSON object."""
        pid = os.getpid()
        events = []
        for phase, name, parent, tid, t0_ns, dur_ns, args in self._spans:
            ev = {"ph": phase, "name": name, "cat": "repro",
                  "pid": pid, "tid": tid, "ts": t0_ns / 1e3}
            if phase == "X":
                ev["dur"] = dur_ns / 1e3
            else:
                ev["s"] = "t"
            ev["args"] = dict(args or {})
            if parent is not None:
                ev["args"]["parent"] = parent
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON; returns the path written."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, default=str)
        return path


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-default tracer every runtime component records into
    unless handed a private one."""
    return _TRACER


def enable_tracing(*, annotate: bool = False) -> Tracer:
    return _TRACER.enable(annotate=annotate)


def disable_tracing() -> None:
    _TRACER.disable()
