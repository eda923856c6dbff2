"""Structured runtime events: a bounded ring buffer of JSONL-able records
(DESIGN.md §12.3).

Events are the rare, high-signal state transitions metrics can only count
and traces only timestamp — host death, batch requeue, deadline_exceeded
terminals, cache corruption-degrade, speculation hit/miss. Each record is
a plain dict ``{"ts": <epoch s>, "kind": <str>, ...fields}`` kept in a
fixed-capacity ring (old events roll off; `emitted` keeps the true total),
dumpable as JSON-lines at any time or automatically on interpreter exit
(``REPRO_EVENTS_OUT=/path/file.jsonl`` or `dump_on_exit()`).

Events always record (they are rare by construction); the tracer mirrors
each one as an instant when tracing is enabled, so the Perfetto view shows
WHERE in the request flow a death/requeue landed.
"""
from __future__ import annotations

import atexit
import collections
import json
from typing import List, Optional

from repro_torch.obs import clock as _clock
from repro_torch.obs import trace as _trace

__all__ = ["EventLog", "default_events", "emit", "dump_on_exit"]


class EventLog:
    """Bounded ring buffer of structured events."""

    def __init__(self, *, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"EventLog: capacity >= 1 required "
                             f"(got {capacity})")
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._counts: collections.Counter = collections.Counter()
        self.emitted = 0

    def emit(self, kind: str, **fields) -> dict:
        record = {"ts": _clock.walltime(), "kind": kind, **fields}
        self._events.append(record)
        self._counts[kind] += 1
        self.emitted += 1
        _trace.get_tracer().instant(f"event:{kind}", **fields)
        return record

    def __len__(self) -> int:
        return len(self._events)

    def records(self, kind: Optional[str] = None) -> List[dict]:
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e["kind"] == kind]

    def counts(self) -> dict:
        """kind -> total emitted (rolled-off events included)."""
        return dict(self._counts)

    def to_jsonl(self) -> str:
        return "".join(json.dumps(e, default=str) + "\n"
                       for e in self._events)

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return path

    def clear(self) -> None:
        self._events.clear()
        self._counts.clear()
        self.emitted = 0


_DEFAULT = EventLog()


def default_events() -> EventLog:
    return _DEFAULT


def emit(kind: str, **fields) -> dict:
    """Emit onto the process-default event log."""
    return _DEFAULT.emit(kind, **fields)


_exit_hooks: set = set()


def dump_on_exit(path: str) -> None:
    """Dump the default event log to `path` at interpreter exit (idempotent
    per path; a crashed run still leaves its last `capacity` events)."""
    if path in _exit_hooks:
        return
    _exit_hooks.add(path)
    atexit.register(lambda: _DEFAULT.dump(path))
