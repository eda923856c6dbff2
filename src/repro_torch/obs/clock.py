"""Canonical clocks for the serving stack (DESIGN.md §12.1).

Every timestamp the runtime takes goes through these names (the port of
`repro/obs/clock.py`, whose runtime a lint holds to them), so the choice of
clock stays a single, auditable decision:

    monotonic     durations and deadlines (never jumps backward);
    monotonic_ns  the tracer's span clock (integer ns, cheapest to take);
    walltime      epoch timestamps for things that must survive a process
                  (cache entry creation/TTL, event records, heartbeats).

These are aliases, not wrappers: ``monotonic is time.perf_counter`` holds,
so injected-clock tests and default-argument identity checks keep working
and there is zero call overhead.
"""
from __future__ import annotations

import time

monotonic = time.perf_counter
monotonic_ns = time.perf_counter_ns
walltime = time.time

__all__ = ["monotonic", "monotonic_ns", "walltime"]
