"""Continuous micro-batching scheduler for Elastic Net serving (DESIGN.md §8).

The port of `repro/runtime/scheduler.py`: an event loop over three request
states,

    PENDING   admitted into a priority/deadline queue, grouped by the
              power-of-two (n, p, form) bucket ladder of DESIGN.md §6.4;
    IN-FLIGHT a bucket's stacked, padded, warm-started solve has been
              dispatched to the device;
    COMPLETED `harvest()` waited on the batch's CUDA event — the ONLY
              blocking wait in the runtime — unpadded the results, fed the
              solutions back into the warm-start cache and recorded
              completion latency.

A bucket launches the moment it is FULL (`max_batch` requests coalesced) or
its earliest member DEADLINE expires (`max_wait` after submission, per-
request overridable). Solves go through the port's lane-batched
`core.batch.sven_batch` / `core.api.enet_batch`: on the CUDA device each
batched CG step launches each hinge pass once for all lanes, and a dual
launches the Gram once per lane. The launch is padded to a power-of-two
batch with all-zero dummy problems (X = 0, y = 0), so the set of (bucket,
batch, form) shapes stays small (`stats.bucket_shapes`).

What differs from JAX:

  - No async dispatch yet. JAX's jitted solve returns futures at once; the
    port's solves read the host during the solve (a CG test every
    `CG_READ_EVERY` steps, the Newton and line-search tests, the Illinois
    brackets), so `_dispatch` returns only after the solve's last read, and
    admission does not overlap device work. The scheduler's semantics —
    states, launch triggers, requeue, terminal statuses — are JAX's; the
    harvest still waits on a `torch.cuda.Event` recorded at the end of
    `_dispatch` (its last copies), and readiness is that event's `query()`
    (always ready on the CPU). No thread is added.
  - Host staging stays numpy (`stack_padded`), then one host-to-device
    copy of each stacked operand per launch. Requests on one data set are
    stacked like any others, so they take the stacked route of the hinge
    passes.
  - The mesh is a `repro_torch.dist.Mesh` (every rank runs the same
    scheduler on the same requests, SPMD), and it is opt-in: `mesh`
    defaults to None (one device), where JAX's defaults to "auto". Mesh
    placement is ROUTED, as in JAX: with mesh="auto" (the process group's
    ranks, when there are more than one) `core.routing.route_batch` prices
    each (bucket, batch) launch and its price is the launch's `modeled_s`;
    an explicit mesh or `route="batch"` pins the fan-out (unpriced,
    route_path "batch"). With no mesh, `routing.estimate_batch_seconds`
    prices the launch. Either way the calibration is measured when the
    scheduler is built, never on the admission path.
  - On a mesh of more than one rank, a launch runs collectives, so every
    rank must launch the same batches in the same order. Launches then come
    from counts and explicit calls only (a full bucket, flush, drain,
    result): a clock-driven trigger (`max_wait`, a request's `deadline`)
    and speculation (whose slots follow each rank's cache) are refused,
    since each rank's clock and cache would launch other batches at other
    ticks and the ranks' collectives would not match.

Warm starts come from `runtime.cache.SolutionCache`: hits are handed to the
stacked solve as initial iterates (zero rows = cold start, so mixed
hit/miss batches stay one solve) and every harvested solution is inserted
back, closing the loop the paper's adjacent-lambda observation suggests.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import math
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core import routing
from repro_torch.core.api import EnetCarry, PathConfig, enet_batch
from repro_torch.core.batch import ROUTES, sven_batch
from repro_torch.core.sven import SvenConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import clock as obs_clock
from repro_torch.obs import events as obs_events
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.solve import SolveLog, SolveRecord
from repro_torch.obs.trace import get_tracer
from repro_torch.runtime.cache import (CONSTRAINED, PENALIZED, SolutionCache, WarmEntry,
                                       fingerprint_problem)
from repro_torch.runtime.metrics import LatencyRecorder

#: the numpy type of each torch dtype the runtime stages in
_NUMPY_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}


def ceil_pow2(v: int, floor: int) -> int:
    """Smallest power-of-two multiple of `floor` that is >= v."""
    b = floor
    while b < v:
        b *= 2
    return b


def stack_padded(reqs, bn: int, bp: int, b_pad: int, dtype):
    """Zero-pad and stack a bucket's requests into (B, bn, bp)/(B, bn) HOST
    (numpy) buffers — one allocation and one fill pass, then one device
    transfer per operand. Trailing batch slots stay all-zero: the X = 0,
    y = 0 dummy problems, which converge in O(1) solver iterations."""
    Xb = np.zeros((b_pad, bn, bp), dtype)
    yb = np.zeros((b_pad, bn), dtype)
    for i, r in enumerate(reqs):
        n, p = r.X.shape
        Xb[i, :n, :p] = r.X
        yb[i, :n] = r.y
    return Xb, yb


class EnResult(NamedTuple):
    """Per-request solve result, unpadded back to the request's own p.

    `status` is "ok" for a solved request; "deadline_exceeded" marks a
    request whose deadline had already passed when a failure-recovery
    requeue re-examined it — those complete WITHOUT a solve (beta is None)
    instead of looping through the bucket ladder forever. Every admitted
    request ends in exactly one of these — never silence.
    """

    beta: Optional[np.ndarray]  # (p,) — None when status != "ok"
    iters: Any                # solver iterations spent (padded problem)
    kkt: Any                  # EN KKT violation of the padded problem
    bucket: tuple             # (n_bucket, p_bucket) shape this ran on
    status: str = "ok"        # "ok" | "deadline_exceeded" | "aborted"
    warm_from: Optional[float] = None  # the point (t or lambda1) of the warm-
    #                           start cache entry the solve started from; None: cold
    warm_start: Optional[tuple] = None  # that entry's (alpha, w), padded geometry


#: RuntimeStats attribute -> (instrument kind, metric name, fixed labels).
#: The attribute surface is a read-through shim: the values live on the
#: owning scheduler's MetricsRegistry, these names keep every
#: ``stats.requests += 1`` call site working.
_STAT_SPECS = {
    "requests": ("counter", "runtime_requests_total", {}),
    "batches": ("counter", "runtime_batches_total", {}),
    "bucket_shapes": ("gauge", "runtime_bucket_executables", {}),
    "padded_slots": ("counter", "runtime_padded_slots_total", {}),
    "solve_seconds": ("counter", "runtime_solve_seconds_total", {}),
    "launched_full": ("counter", "runtime_launches_total",
                      {"reason": "full"}),
    "launched_deadline": ("counter", "runtime_launches_total",
                          {"reason": "deadline"}),
    "launched_flush": ("counter", "runtime_launches_total",
                       {"reason": "flush"}),
    "speculative_slots": ("counter", "runtime_speculative_slots_total", {}),
}


class RuntimeStats:
    """Counters shared by the runtime scheduler and the engine facade.

    A thin attribute view over a `MetricsRegistry` (DESIGN.md §12.2): reads
    and writes of the fields (``requests``, ``batches``, ``launched_full``,
    ...) resolve to labeled registry series, so one store feeds both the
    attribute consumers and the JSON/Prometheus exposition. Counts read
    back as ints; ``solve_seconds`` stays a float. Cache hit/miss counters
    live on `SolutionCache` itself — one owner.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        object.__setattr__(self, "registry",
                           registry if registry is not None
                           else MetricsRegistry())

    def _series(self, name: str):
        kind, metric, labels = _STAT_SPECS[name]
        make = (self.registry.gauge if kind == "gauge"
                else self.registry.counter)
        return make(metric, labelnames=tuple(labels)), labels

    def __getattr__(self, name: str):
        if name not in _STAT_SPECS:
            raise AttributeError(name)
        inst, labels = self._series(name)
        v = inst.value(**labels)
        return v if name == "solve_seconds" else int(v)

    def __setattr__(self, name: str, value) -> None:
        if name not in _STAT_SPECS:
            raise AttributeError(f"RuntimeStats has no field {name!r}")
        inst, labels = self._series(name)
        inst.set(float(value), **labels)

    def __repr__(self) -> str:
        fields = ", ".join(f"{k}={getattr(self, k)}" for k in _STAT_SPECS)
        return f"RuntimeStats({fields})"


@dataclasses.dataclass
class EnRequest:
    """One admitted problem; `lam` is t (constrained) or lambda1 (penalized).

    X/y are held as HOST (numpy) arrays until their bucket launches — the
    device sees one stacked transfer per batch, not one per request."""

    req_id: int
    X: np.ndarray
    y: np.ndarray
    form: str                 # CONSTRAINED | PENALIZED
    lam: float
    lambda2: float
    priority: int
    deadline: float
    submitted: float
    fingerprint: Optional[str]


class _InFlight(NamedTuple):
    """A dispatched (not yet harvested) stacked solve."""

    key: tuple                # (bn, bp, form)
    reqs: tuple               # the b_real EnRequests, slot order
    beta: torch.Tensor        # (B, bp)
    iters: Any                # (B,) tensor, or a tuple of B ints (penalized)
    kkt: torch.Tensor         # (B,)
    alpha: torch.Tensor       # (B, 2*bp)
    w: torch.Tensor           # (B, bn)
    t_out: torch.Tensor       # (B,) |beta|_1 (penalized) or request t
    nu_out: torch.Tensor      # (B,) measured multiplier (penalized only)
    event: Optional[Any] = None  # CUDA event after the solve (None on the CPU)
    spec: tuple = ()          # ((slot, fingerprint, lam, lambda2), ...)
    #                           speculative pre-solves riding padding slots
    t_dispatch: float = 0.0   # scheduler clock at dispatch (solve telemetry)
    modeled_s: float = 0.0    # cost-model price of this launch (0 = unpriced)
    route_path: str = "single"  # router decision this launch ran under
    warm: tuple = ()          # each request's warm-start entry (None: cold)


def _urgency(req: EnRequest) -> tuple:
    return (-req.priority, req.deadline, req.req_id)


def _host(a) -> np.ndarray:
    """A result field on the host as numpy: a tensor copied once."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _host_array(a, dtype) -> np.ndarray:
    """A request operand as a host numpy array of `dtype` (a tensor is
    copied to the host first)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def check_mesh(mesh, who: str) -> None:
    """A mesh argument is a `repro_torch.dist.Mesh`, "auto" or None."""
    if not (mesh is None or isinstance(mesh, dist.Mesh)
            or (isinstance(mesh, str) and mesh == "auto")):
        raise ValueError(f"{who}: mesh must be a repro_torch.dist.Mesh, 'auto' or None "
                         f"(got {mesh!r})")


class ContinuousScheduler:
    """Priority/deadline admission queue + bucket coalescing + launch.

    `max_wait` is the default coalescing window: a submitted request's
    deadline is `now + max_wait`, and `poll()` launches its whole bucket
    once any member's deadline passes (or earlier, the moment the bucket
    holds `max_batch` requests). `max_wait=None` disables deadlines —
    drain-on-demand. Per-request `deadline` / `priority` override the
    default; higher priority solves first when a bucket overflows.

    `cache="default"` builds a private `SolutionCache`; pass None to serve
    every request cold. `fixed_batch=True` pads every launch to the full
    `max_batch` (instead of the power-of-two ladder), pinning the runtime
    to exactly ONE shape per (bucket, form). `auto_launch_full=False`
    disables the bucket-full trigger so NOTHING launches before an explicit
    flush/drain/result — the engine facade's drain-on-demand mode, which
    keeps `drain_reference()` a genuinely synchronous baseline.

    Runs on `device` (the CUDA device when none is named; with no CUDA
    device and none named it raises, `repro_torch.device.resolve_device`).
    `dtype` is the torch dtype the requests are solved in (float64 or
    float32). Each result names the point of the cache entry its solve
    was warm-started from (`EnResult.warm_from`) and holds that entry's
    arrays (`EnResult.warm_start`, the cache's own, not copied), so a
    caller can repeat the solve from exactly that start.
    """

    def __init__(self, config: SvenConfig = SvenConfig(), *,
                 path_config: PathConfig = PathConfig(),
                 max_batch: int = 64, min_n: int = 16, min_p: int = 8,
                 max_wait: Optional[float] = 0.01,
                 cache="default", fixed_batch: bool = False,
                 auto_launch_full: bool = True, mesh=None,
                 route: str = "auto", speculate: bool = False,
                 clock=obs_clock.monotonic, dtype: torch.dtype = torch.float64,
                 device: DeviceLike = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None):
        if max_batch < 1 or min_n < 1 or min_p < 1:
            raise ValueError(f"ContinuousScheduler: max_batch/min_n/min_p "
                             f"must be >= 1 (got {max_batch}/{min_n}/{min_p})")
        if max_wait is not None and max_wait < 0:
            raise ValueError(f"ContinuousScheduler: max_wait must be >= 0 or "
                             f"None (got {max_wait})")
        if route not in ROUTES:
            raise ValueError(f"ContinuousScheduler: route must be "
                             f"auto|batch|single (got {route!r})")
        check_mesh(mesh, "ContinuousScheduler")
        if dtype not in _NUMPY_DTYPES:
            raise ValueError(f"ContinuousScheduler: dtype must be one of "
                             f"{sorted(map(str, _NUMPY_DTYPES))} (got {dtype})")
        self.device = resolve_device(device)
        self.config = config
        self.path_config = path_config
        self.max_batch = max_batch
        self.min_n = min_n
        self.min_p = min_p
        self.max_wait = max_wait
        # one registry per scheduler: stats, latency histograms and cache
        # counters share it, so a scheduler's whole telemetry exports as a
        # single snapshot / Prometheus page (DESIGN.md §12.2)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.solve_log = SolveLog()
        self.cache = (SolutionCache(registry=self.registry)
                      if cache == "default" else cache)
        # mesh="auto": OFFER the process group's ranks when there are more
        # than one, priced per launch by the router; an explicit Mesh pins
        # the fan-out (routing skipped); `route` pins the layout for auto
        # meshes ("batch" = always fan out, "single" = never)
        self._mesh_pinned = isinstance(mesh, dist.Mesh)
        if not self._mesh_pinned and mesh is not None:
            mesh = dist.data_mesh()
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and (max_wait is not None or speculate):
            raise ValueError(
                "ContinuousScheduler: a mesh of more than one rank launches on counts "
                "and explicit calls only: max_wait must be None and speculate False "
                "(each rank's clock and cache would launch other batches and the "
                "ranks' collectives would not match)")
        # measured here, once, so that pricing never measures on the
        # admission path (every rank builds its scheduler alike)
        if self.mesh is None:
            routing.calibrate(dist.Mesh(device=self.device))
        elif not self._mesh_pinned:
            routing.calibrate(self.mesh)
        self.route = route
        self.fixed_batch = fixed_batch
        self.auto_launch_full = auto_launch_full
        # speculate=True repurposes a launch's PADDING slots as pre-solves:
        # when a client is crawling a lambda path (two distinct recent
        # points on one fingerprint), the geometric continuation of the
        # crawl is solved in a slot that would otherwise hold an all-zero
        # dummy, and the solution lands in the warm-start cache BEFORE the
        # client asks for it (DESIGN.md §11.3). Launch shapes are untouched
        # — speculation changes slot contents, never geometry.
        self.speculate = speculate and cache is not None
        self.clock = clock
        self.dtype = dtype
        self.np_dtype = _NUMPY_DTYPES[dtype]
        self.stats = RuntimeStats(self.registry)
        self.metrics = LatencyRecorder(registry=self.registry)
        # every admitted request must end in exactly ONE terminal status
        self._terminal = self.registry.counter(
            "requests_terminal_total",
            "admitted requests by terminal status", ("status",))
        self._buckets: Dict[tuple, List[EnRequest]] = {}
        self._deadlines: list = []       # heap of (deadline, req_id, key)
        self._in_flight: List[_InFlight] = []
        self._results: Dict[int, EnResult] = {}
        self._next_id = 0
        self._seen_shapes: set = set()
        # (fingerprint, form, lambda2) -> (prev_lam, last_lam): the crawl
        # trail speculation extrapolates; bounded, oldest trail dropped.
        self._lam_trail: "collections.OrderedDict" = collections.OrderedDict()
        # speculative points inserted but not yet consumed by a client
        # lookup — consumption emits a speculation_hit event, eviction from
        # this bounded set an (unconsumed) speculation_miss
        self._spec_points: "collections.OrderedDict" = collections.OrderedDict()

    # -- admission ---------------------------------------------------------

    def bucket_of(self, n: int, p: int) -> tuple:
        return (ceil_pow2(n, self.min_n), ceil_pow2(p, self.min_p))

    def submit(self, X, y, *, t: Optional[float] = None,
               lambda1: Optional[float] = None, lambda2: float = 1.0,
               priority: int = 0, deadline: Optional[float] = None) -> int:
        """Admit one problem; exactly one of `t` (constrained form) and
        `lambda1` (penalized form) must be given. Returns the request id.

        Admission already polls, so a bucket that fills launches before
        this call returns.
        """
        X = _host_array(X, self.np_dtype)
        y = _host_array(y, self.np_dtype)
        if X.ndim != 2 or y.shape != (X.shape[0],):
            raise ValueError(f"submit: bad shapes X{X.shape} y{y.shape}")
        if (t is None) == (lambda1 is None):
            raise ValueError("submit: give exactly one of t= and lambda1=")
        if t is not None and not (t > 0 and lambda2 >= 0):
            raise ValueError(f"submit: need t > 0, lambda2 >= 0 "
                             f"(t={t}, lambda2={lambda2})")
        # lambda1 = 0 (pure ridge) and lambda2 = 0 (Lasso) are both served:
        # the cache keys these edges exactly (runtime/cache.py).
        if lambda1 is not None and not (lambda1 >= 0 and lambda2 >= 0):
            raise ValueError(f"submit: need lambda1 >= 0, lambda2 >= 0 "
                             f"(lambda1={lambda1}, lambda2={lambda2})")
        if deadline is not None and self.mesh is not None:
            raise ValueError("submit: a mesh of more than one rank takes no deadline "
                             "(each rank's clock would fire it at another tick)")
        now = self.clock()
        if deadline is None:
            deadline = math.inf if self.max_wait is None else now + self.max_wait
        form = CONSTRAINED if t is not None else PENALIZED
        req = EnRequest(
            req_id=self._next_id, X=X, y=y, form=form,
            lam=float(t if t is not None else lambda1), lambda2=float(lambda2),
            priority=priority, deadline=deadline, submitted=now,
            fingerprint=(fingerprint_problem(X, y) if self.cache is not None
                         else None))
        self._next_id += 1
        key = self.bucket_of(*X.shape) + (form,)
        with self.tracer.span("admit", bucket=key[:2], form=form):
            self._buckets.setdefault(key, []).append(req)
            heapq.heappush(self._deadlines, (deadline, req.req_id, key))
            self.stats.requests += 1
            self.metrics.submitted(req.req_id, now)
            if self.speculate and req.fingerprint is not None:
                self._note_crawl(req)
        self.poll(now)
        return req.req_id

    def _note_crawl(self, req: EnRequest) -> None:
        """Record this request's lambda point on its fingerprint's trail."""
        tkey = (req.fingerprint, req.form, req.lambda2)
        prev = self._lam_trail.pop(tkey, (None, None))
        if prev[1] != req.lam:
            prev = (prev[1], req.lam)
        self._lam_trail[tkey] = prev
        while len(self._lam_trail) > 512:
            self._lam_trail.popitem(last=False)

    @property
    def pending_requests(self) -> List[EnRequest]:
        """Admitted, not-yet-launched requests in submission order."""
        reqs = [r for b in self._buckets.values() for r in b]
        return sorted(reqs, key=lambda r: r.req_id)

    @property
    def in_flight_count(self) -> int:
        return sum(len(inf.reqs) for inf in self._in_flight)

    def take_pending(self) -> List[EnRequest]:
        """Remove and return every pending request (the engine's reference
        drain path pulls the queue through here)."""
        reqs = self.pending_requests
        self._buckets.clear()
        self._deadlines.clear()
        return reqs

    def requeue(self, reqs: List[EnRequest]) -> None:
        """Put requests back into the admission queue (failure recovery).

        Re-admission re-checks each deadline against the NOW LATER clock: a
        request whose deadline has already passed completes immediately
        with status="deadline_exceeded" (a terminal result, beta=None)
        instead of re-entering the bucket ladder — where its expired
        deadline would fire it straight back into the launch that just
        failed, an infinite requeue loop under any persistent fault.
        `deadline=inf` (max_wait=None, the drain-on-demand engines) never
        expires, so those requeues retry forever.
        """
        now = self.clock()
        for r in reqs:
            if r.deadline <= now:
                self._results[r.req_id] = EnResult(
                    beta=None, iters=np.int64(0), kkt=math.inf,
                    bucket=self.bucket_of(*r.X.shape),
                    status="deadline_exceeded")
                self.metrics.completed([r.req_id], now)
                self._terminal.inc(status="deadline_exceeded")
                obs_events.emit("deadline_exceeded", req_id=r.req_id,
                                deadline=r.deadline, now=now)
                continue
            key = self.bucket_of(*r.X.shape) + (r.form,)
            self._buckets.setdefault(key, []).append(r)
            heapq.heappush(self._deadlines, (r.deadline, r.req_id, key))
            obs_events.emit("requeue", req_id=r.req_id, bucket=key[:2])

    # -- event loop --------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> int:
        """Launch every full bucket and every bucket past its deadline;
        opportunistically harvest in-flight batches whose results are ready
        (without blocking). Returns the number of batches launched."""
        if now is None:
            now = self.clock()
        launched = 0
        if self.auto_launch_full:
            for key in list(self._buckets):
                while len(self._buckets.get(key, ())) >= self.max_batch:
                    launched += self._launch_bucket(key, self.max_batch, "full")
        while self._deadlines and self._deadlines[0][0] <= now:
            deadline, rid, key = heapq.heappop(self._deadlines)
            # lazy invalidation: an entry whose request already launched
            # (bucket-full path, flush, result) must not fire the bucket
            # early for LATER arrivals still inside their max_wait window
            bucket = self._buckets.get(key)
            if bucket and any(r.req_id == rid for r in bucket):
                launched += self._launch_bucket(key, None, "deadline")
                rest = self._buckets.get(key)
                if rest and any(r.req_id == rid for r in rest):
                    # priority sorting bumped this expired request out of
                    # the launched chunk: re-arm its (already due) entry so
                    # the loop immediately launches the remainder too
                    heapq.heappush(self._deadlines, (deadline, rid, key))
        ready = [inf for inf in self._in_flight if _batch_ready(inf)]
        for inf in ready:
            self._in_flight.remove(inf)
            try:
                self._complete(inf)
            except Exception:
                self._in_flight.append(inf)   # keep retryable, never drop
                raise
        return launched

    def flush(self) -> int:
        """Launch everything pending regardless of fill level or deadline."""
        launched = 0
        for key in list(self._buckets):
            while self._buckets.get(key):
                launched += self._launch_bucket(key, self.max_batch, "flush")
        return launched

    def harvest(self, *, block: bool = True) -> Dict[int, EnResult]:
        """Complete in-flight batches (the one place results are awaited)
        and return every unclaimed result, including earlier leftovers."""
        pending = list(self._in_flight)
        self._in_flight = []
        try:
            while pending:
                inf = pending[0]
                if not block and not _batch_ready(inf):
                    self._in_flight.append(pending.pop(0))
                    continue
                self._complete(inf)     # idempotent: safe to retry on error
                pending.pop(0)
        except Exception:
            # the failed batch AND the untouched ones stay live — a later
            # harvest retries them; no request is ever dropped
            self._in_flight.extend(pending)
            raise
        out, self._results = self._results, {}
        return out

    def drain(self) -> Dict[int, EnResult]:
        """Flush + harvest: solve everything admitted, return all results."""
        self.flush()
        return self.harvest(block=True)

    def result(self, req_id: int) -> EnResult:
        """Block until one request's result is available and return it;
        other completed results stay claimable by later harvests."""
        if req_id in self._results:
            return self._results.pop(req_id)
        for key, bucket in list(self._buckets.items()):
            if any(r.req_id == req_id for r in bucket):
                while self._buckets.get(key):
                    self._launch_bucket(key, self.max_batch, "flush")
                break
        for inf in list(self._in_flight):
            if any(r.req_id == req_id for r in inf.reqs):
                self._in_flight.remove(inf)
                try:
                    self._complete(inf)
                except Exception:
                    self._in_flight.append(inf)
                    raise
                break
        if req_id not in self._results:
            raise KeyError(f"result: unknown request id {req_id}")
        return self._results.pop(req_id)

    # -- launch ------------------------------------------------------------

    def _launch_bucket(self, key: tuple, take: Optional[int],
                       reason: str) -> int:
        bucket = self._buckets[key]
        bucket.sort(key=_urgency)
        chunk = bucket[:take] if take is not None else bucket[:self.max_batch]
        rest = bucket[len(chunk):]
        if rest:
            self._buckets[key] = rest
        else:
            del self._buckets[key]
        try:
            with self.tracer.span("launch", reason=reason, bucket=key[:2],
                                  form=key[2], b_real=len(chunk)):
                inf = self._dispatch(key, chunk)
        except Exception:
            # a failed dispatch must not lose the queue: requeue the chunk
            # (which completes already-expired requests as
            # deadline_exceeded rather than spinning them through the
            # ladder again — see requeue())
            self.requeue(chunk)
            raise
        self._in_flight.append(inf)
        now = self.clock()
        self.metrics.launched([r.req_id for r in chunk], now)
        self.stats.batches += 1
        setattr(self.stats, f"launched_{reason}",
                getattr(self.stats, f"launched_{reason}") + 1)
        return 1

    def _warm_arrays(self, reqs: List[EnRequest], bn: int, bp: int,
                     b_pad: int, form: str):
        """Stack cache hits into warm-start operands (zeros where cold),
        with each request's entry (None where cold).

        Host (numpy) buffers filled in place; cached entries are stored as
        numpy at harvest, so a hit is a memcpy, not a device round trip."""
        alpha = np.zeros((b_pad, 2 * bp), self.np_dtype)
        w = np.zeros((b_pad, bn), self.np_dtype)
        beta = np.zeros((b_pad, bp), self.np_dtype)
        t_prev = np.zeros((b_pad,), self.np_dtype)
        nu_prev = np.zeros((b_pad,), self.np_dtype)
        hot = np.zeros((b_pad,), bool)
        used = [None] * len(reqs)
        if self.cache is not None:
            with self.tracer.span("warm_start", b=len(reqs)) as sp:
                for i, r in enumerate(reqs):
                    entry = self.cache.lookup(r.fingerprint, form, r.lam,
                                              r.lambda2)
                    if entry is not None:
                        used[i] = entry
                        alpha[i], w[i], beta[i] = (entry.alpha, entry.w,
                                                   entry.beta)
                        t_prev[i], nu_prev[i] = entry.t, entry.nu
                        hot[i] = True
                        skey = (r.fingerprint, form, entry.lam, entry.lambda2)
                        if self._spec_points.pop(skey, None) is not None:
                            # a pre-solved padding-slot point served a real
                            # client request — speculation paid off
                            obs_events.emit("speculation_hit",
                                            lam=entry.lam,
                                            lambda2=entry.lambda2)
                if sp.args is not None:
                    sp.args["hits"] = int(hot[:len(reqs)].sum())
        return alpha, w, beta, t_prev, nu_prev, hot, tuple(used)

    def _predict_candidates(self, reqs, form: str) -> list:
        """Predicted next crawl points for this chunk's fingerprints.

        A fingerprint whose trail shows two distinct positive lambda points
        is a crawl; its GEOMETRIC continuation `last * (last / prev)` — the
        step structure of every glmnet-style grid — is the prediction.
        Points already in the cache and duplicates within the launch are
        skipped (counter-free probe: speculation must not skew the client
        hit rate). Returns [(request, predicted_lam), ...]."""
        cands: list = []
        seen: set = set()
        for r in reqs:
            trail = (self._lam_trail.get((r.fingerprint, form, r.lambda2))
                     if r.fingerprint is not None else None)
            if trail is None or trail[0] is None:
                continue
            prev, last = trail
            if not (prev > 0.0 and last > 0.0) or prev == last:
                continue
            pred = last * (last / prev)
            if not (math.isfinite(pred) and pred > 0.0):
                continue
            skey = (r.fingerprint, r.lambda2, pred)
            if skey in seen or self.cache.probe(r.fingerprint, form, pred,
                                                r.lambda2):
                continue
            seen.add(skey)
            cands.append((r, pred))
        return cands

    def _fill_spec_slots(self, cands, key, b_real, Xb, yb, lamb, l2b,
                         wa, ww, wb, wt, wnu, hot) -> tuple:
        """Write the predicted problems into the padding slots (warm-started
        from the crawl tip when the cache has it). Returns the spec tuple
        `_complete` inserts the pre-solved solutions from."""
        bn, bp, form = key
        spec: list = []
        for slot, (r, pred) in enumerate(cands, start=b_real):
            n, p = r.X.shape
            Xb[slot, :n, :p] = r.X
            yb[slot, :n] = r.y
            lamb[slot] = pred
            l2b[slot] = r.lambda2
            entry = self.cache.lookup(r.fingerprint, form, pred, r.lambda2,
                                      count=False)
            if entry is not None:
                wa[slot], ww[slot], wb[slot] = entry.alpha, entry.w, entry.beta
                wt[slot], wnu[slot] = entry.t, entry.nu
                hot[slot] = True
            spec.append((slot, r.fingerprint, float(pred), r.lambda2))
            # remember the prediction: a later warm-start hit on exactly
            # this point is a speculation_hit; falling off the bounded set
            # unconsumed is a speculation_miss (the crawl went elsewhere)
            self._spec_points[(r.fingerprint, form, float(pred),
                               r.lambda2)] = True
            while len(self._spec_points) > 1024:
                old, _ = self._spec_points.popitem(last=False)
                obs_events.emit("speculation_miss", lam=old[2], lambda2=old[3])
        self.stats.speculative_slots += len(spec)
        return tuple(spec)

    def _dispatch(self, key: tuple, reqs: List[EnRequest]) -> _InFlight:
        """Pad, stack, warm-start and solve one bucket on the device.

        The stacked host buffers go to the device in one copy each; the
        solve is the port's `sven_batch` / `enet_batch`, which reads the
        host as it runs, so this returns after the solve's last read. A
        CUDA event recorded at the end is what `_complete` waits on."""
        bn, bp, form = key
        b_real = len(reqs)
        t_disp = self.clock()
        cands = (self._predict_candidates(reqs, form)
                 if self.speculate else [])
        if self.fixed_batch:
            b_pad = self.max_batch
        else:
            # speculation may GROW the pad one rung up the pow2 ladder to
            # make room for predicted points — a lone crawling client would
            # otherwise never have an idle slot to pre-solve in. The ladder
            # and max_batch still bound the set of launch shapes.
            want = b_real + min(len(cands), self.max_batch - b_real)
            b_pad = min(ceil_pow2(max(want, b_real), 1), self.max_batch)
        cands = cands[:b_pad - b_real]
        Xb, yb = stack_padded(reqs, bn, bp, b_pad, self.np_dtype)
        fill = [1.0] * (b_pad - b_real)
        lamb = np.asarray([r.lam for r in reqs] + fill, self.np_dtype)
        l2b = np.asarray([r.lambda2 for r in reqs] + fill, self.np_dtype)
        wa, ww, wb, wt, wnu, hot, used = self._warm_arrays(reqs, bn, bp, b_pad, form)
        spec = ()
        if cands:
            spec = self._fill_spec_slots(cands, key, b_real, Xb, yb, lamb,
                                         l2b, wa, ww, wb, wt, wnu, hot)

        route_form = "penalized" if form == PENALIZED else "constrained"
        mesh = self.mesh
        modeled_s = 0.0
        route_path = "single"
        if mesh is not None and not self._mesh_pinned and self.route != "batch":
            decision = routing.route_batch(bn, bp, b_pad, mesh, form=route_form,
                                           route=self.route)
            self.tracer.instant("route", path=decision.path, costs=dict(decision.costs),
                                reason=decision.reason)
            route_path = decision.path
            modeled_s = float(decision.costs.get(decision.path, 0.0))
            if decision.path != "batch":
                mesh = None
        elif mesh is None:
            # one device by construction: nothing to route, but the solve
            # telemetry still wants the model's price for this launch
            modeled_s = float(routing.estimate_batch_seconds(bn, bp, b_pad, form=route_form,
                                                             device=self.device))
        else:
            route_path = "batch"    # pinned mesh / route="batch": unpriced
        ctx = dist.mesh_context(mesh) if mesh is not None else contextlib.nullcontext()
        route = "batch" if mesh is not None else "auto"

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        Xd, yd, lamd, l2d = dev(Xb), dev(yb), dev(lamb), dev(l2b)
        with ctx:
            if form == PENALIZED:
                warm = EnetCarry(beta=dev(wb), alpha=dev(wa), w=dev(ww), t=dev(wt),
                                 nu=dev(wnu))
                pts, carry = enet_batch(Xd, yd, lamd, l2d, self.path_config,
                                        warm=warm, has_warm=dev(hot),
                                        return_carry=True, route=route)
                inf = _InFlight(key=key, reqs=tuple(reqs), beta=pts.beta,
                                iters=pts.sven_iters, kkt=pts.kkt,
                                alpha=carry.alpha, w=carry.w, t_out=pts.t,
                                nu_out=pts.nu, spec=spec, t_dispatch=t_disp,
                                modeled_s=modeled_s, route_path=route_path)
            else:
                sol = sven_batch(Xd, yd, lamd, l2d, self.config,
                                 warm_alpha=dev(wa), warm_w=dev(ww), route=route)
                inf = _InFlight(key=key, reqs=tuple(reqs), beta=sol.beta,
                                iters=sol.iters, kkt=sol.kkt, alpha=sol.alpha,
                                w=sol.w, t_out=lamd, nu_out=torch.zeros_like(lamd),
                                spec=spec, t_dispatch=t_disp,
                                modeled_s=modeled_s, route_path=route_path)
        inf = inf._replace(warm=used)
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            inf = inf._replace(event=event)
        self.stats.padded_slots += b_pad - b_real
        self._seen_shapes.add((bn, bp, b_pad, form))
        self.stats.bucket_shapes = len(self._seen_shapes)
        return inf

    # -- completion --------------------------------------------------------

    def _complete(self, inf: _InFlight) -> None:
        """Await one batch, unpad per-request results, refill the cache.

        The stacked device tensors are copied to the host ONCE each and
        sliced in numpy."""
        bn, bp, form = inf.key
        with self.tracer.span("complete", bucket=(bn, bp),
                              b_real=len(inf.reqs)):
            t0 = self.clock()
            with self.tracer.span("harvest.block"):
                # the runtime's single block point, one per bucket chunk,
                # after which the host copies below wait on nothing
                if inf.event is not None:
                    inf.event.synchronize()
            blocked = self.clock() - t0
            self.stats.solve_seconds += blocked
            beta, iters, kkt, alpha, w, t_out, nu_out = (
                _host(a) for a in (inf.beta, inf.iters, inf.kkt, inf.alpha,
                                   inf.w, inf.t_out, inf.nu_out))
            for i, req in enumerate(inf.reqs):
                p = req.X.shape[1]
                entry = inf.warm[i] if inf.warm else None
                self._results[req.req_id] = EnResult(
                    beta=beta[i, :p], iters=iters[i], kkt=kkt[i],
                    bucket=(bn, bp), warm_from=None if entry is None else entry.lam,
                    warm_start=None if entry is None else (entry.alpha, entry.w))
                if self.cache is not None:
                    self.cache.insert(req.fingerprint, form, WarmEntry(
                        lam=req.lam, lambda2=req.lambda2, alpha=alpha[i],
                        w=w[i], beta=beta[i], t=t_out[i], nu=nu_out[i]))
            if self.cache is not None:
                # speculative slots: nobody asked for these yet — the whole
                # point is that the NEXT step of the crawl finds them warm
                for slot, fp, lam, lam2 in inf.spec:
                    self.cache.insert(fp, form, WarmEntry(
                        lam=lam, lambda2=lam2, alpha=alpha[slot], w=w[slot],
                        beta=beta[slot], t=t_out[slot], nu=nu_out[slot]))
            now = self.clock()
            self.metrics.completed([r.req_id for r in inf.reqs], now)
            # nothing past this point can raise: a harvest retry after a
            # cache/unpad failure must not double-count terminals or solves
            self._terminal.inc(len(inf.reqs), status="ok")
            nnz = 0
            dim = 0
            for i, req in enumerate(inf.reqs):
                p = req.X.shape[1]
                nnz += int(np.count_nonzero(np.abs(beta[i, :p]) > 1e-12))
                dim += p
            b_real = len(inf.reqs)
            real_iters = iters[:b_real]
            self.solve_log.add(SolveRecord(
                bucket=(bn, bp), form=form, batch=int(beta.shape[0]),
                b_real=b_real, route_path=inf.route_path,
                modeled_s=inf.modeled_s,
                actual_s=(now - inf.t_dispatch if inf.t_dispatch > 0.0
                          else blocked),
                blocked_s=blocked, iters_max=int(real_iters.max(initial=0)),
                iters_mean=float(real_iters.mean()) if b_real else 0.0,
                kkt_max=float(kkt[:b_real].max(initial=0.0)),
                keep_fraction=nnz / dim if dim else 0.0))


def _batch_ready(inf: _InFlight) -> bool:
    """True when a dispatched batch's results have landed (non-blocking):
    its CUDA event has completed, or it ran on the CPU."""
    return inf.event is None or bool(inf.event.query())
