"""Per-solve telemetry: what each dispatched batch actually cost vs what
the cost model priced it at (DESIGN.md §12.5).

Every harvested batch appends one `SolveRecord`: the bucket geometry,
route decision, solver effort (iterations, final KKT violation), the
screening keep-fraction (nonzero share of the solution — the quantity
gap-safe screening trades against), and modeled-vs-actual seconds. The
modeled price is the router's estimate taken AT DISPATCH (so it reflects
the calibration the router actually used), the actual is dispatch ->
harvest wall time with the blocking wait broken out. A launch on one
device is priced by `core.routing.estimate_batch_seconds`, a routed one by
`route_batch`'s price of the path it took; a pinned mesh's launches are
recorded unpriced (modeled_s = 0.0).

`SolveLog.residual_report()` folds the records into the cost-model
residual summary: per route path, the distribution of log10(actual/modeled).
A drifting residual is the signal to recalibrate the router.
"""
from __future__ import annotations

import collections
import math
from typing import List, NamedTuple

__all__ = ["SolveRecord", "SolveLog"]


class SolveRecord(NamedTuple):
    """One dispatched-and-harvested stacked solve."""

    bucket: tuple           # (bn, bp)
    form: str               # constrained | penalized
    batch: int              # padded batch B the executable ran at
    b_real: int             # real (non-padding) requests in the batch
    route_path: str         # router decision: single | sharded | batch
    modeled_s: float        # cost-model price at dispatch (0.0 = unmodeled)
    actual_s: float         # dispatch -> harvest wall seconds
    blocked_s: float        # host seconds inside block_until_ready
    iters_max: int          # max solver iterations across the batch
    iters_mean: float
    kkt_max: float          # worst EN KKT violation across real slots
    keep_fraction: float    # nonzero share of the solution (screening keep)


class SolveLog:
    """Bounded log of `SolveRecord`s with a cost-model residual report."""

    def __init__(self, *, capacity: int = 4096) -> None:
        self._records: collections.deque = collections.deque(maxlen=capacity)
        self.recorded = 0

    def add(self, record: SolveRecord) -> None:
        self._records.append(record)
        self.recorded += 1

    def __len__(self) -> int:
        return len(self._records)

    def records(self) -> List[SolveRecord]:
        return list(self._records)

    def residual_report(self) -> dict:
        """Modeled-vs-actual summary per route path.

        ``log10_ratio`` statistics are over log10(actual/modeled): 0 means
        the calibration prices this path perfectly, +1 means solves run 10x
        slower than modeled (recalibrate), negative means the model is
        pessimistic (routing may be leaving fan-out wins on the table).
        Records without a model price (pinned meshes, unpriced forms) are
        counted but excluded from the ratio stats.
        """
        by_path: dict = {}
        unmodeled = 0
        for r in self._records:
            if r.modeled_s <= 0.0 or r.actual_s <= 0.0:
                unmodeled += 1
                continue
            by_path.setdefault(r.route_path, []).append(r)
        paths = {}
        for path, recs in sorted(by_path.items()):
            ratios = sorted(math.log10(r.actual_s / r.modeled_s)
                            for r in recs)
            n = len(ratios)
            paths[path] = {
                "n": n,
                "modeled_s_mean": sum(r.modeled_s for r in recs) / n,
                "actual_s_mean": sum(r.actual_s for r in recs) / n,
                "log10_ratio_mean": sum(ratios) / n,
                "log10_ratio_p50": ratios[n // 2],
                "log10_ratio_max_abs": max(abs(ratios[0]), abs(ratios[-1])),
            }
        return {"n_records": len(self._records), "n_unmodeled": unmodeled,
                "by_path": paths}

    def clear(self) -> None:
        self._records.clear()
        self.recorded = 0
