"""Multi-host serving coordinator: the scheduler spanned over worker
processes (DESIGN.md §11.1), the port of `repro/runtime/multihost.py`.

One `ContinuousScheduler` serves one process — its cache and event loop
die with it. `MultiHostCoordinator` spans that runtime over N worker
PROCESSES ("hosts": separate interpreters, each with its own CUDA context,
the single-machine stand-in for separate machines), adding the three
things a single process cannot have:

    placement   admitted requests coalesce onto the same pow2 bucket
                ladder as the scheduler's, but whole BATCHES are placed
                onto hosts: least modeled outstanding seconds first
                (`core.routing.estimate_batch_seconds` — the cost model
                reused as a load signal), bucket affinity as the tiebreak
                so each host keeps serving the shapes it has launched;
    admission   per-host in-flight caps (`max_inflight_per_host`) —
                batches beyond a host's cap wait in the coordinator's
                dispatch queue instead of piling onto a busy host;
    failure     each worker heartbeats on its duplex pipe while idle; a
                host whose process has exited (SIGKILL included — the
                `kill_host` fault injection), whose pipe has hit EOF, or
                whose last sign of life is older than `heartbeat_timeout`
                is declared dead, and every batch in flight on it is
                REQUEUED. Requeues re-check deadlines exactly like
                `ContinuousScheduler.requeue`: an expired request
                completes terminally as "deadline_exceeded" instead of
                chasing the fault forever. When NO host remains, every
                unfinished request completes terminally as "aborted" —
                the no-silent-drops contract: every admitted request ends
                in exactly one of "ok" / "deadline_exceeded" / "aborted".

Transport is one duplex `multiprocessing.Pipe` per worker, `spawn` start
method, so that no worker inherits the parent's CUDA context. A pipe has a
single writer on each end, so a SIGKILLed worker can corrupt at most its
OWN channel — the coordinator sees EOF/closed and fails over — whereas a
shared queue killed mid-`put` can wedge every producer behind a
half-written record.

Each worker is a one-device `ContinuousScheduler` (no mesh: workers share
no collective) on the coordinator's `device` and `dtype`; by the port's
device rule no device means the CUDA device, and a worker never falls back
to the CPU. Workers share one persistent spill directory when `cache_dir`
is given (`TieredSolutionCache`, §11.2): work a dead host completed before
dying is warm-servable by the survivors, and a restarted coordinator
starts warm. `speculate=True` turns on §11.3 pre-solves inside each worker.

What differs from JAX:

  - A worker reads its pipe on a thread of its own and queues what it
    reads. A batch at published widths is large (four GLA-BRA requests
    carry 283 MB of X) and a worker's result is larger than a pipe's
    buffer, so with the worker reading only between solves, the
    coordinator sending a second batch and the worker sending its result
    would each wait on the other for good.
  - JAX's `scrub_xla` (the XLA host-device flags a worker drops) has no
    counterpart and is gone.
  - A worker's final stats add `device` (its scheduler's device) and
    `kernel_launches` (`repro_torch.kernels.launches()` in that process).

The coordinator duck-types the scheduler's serving surface —
`submit`/`flush`/`poll`/`harvest`/`drain`/`metrics` — so
`loadgen.run_open_loop` drives a multi-host mesh unchanged
(``python -m repro_torch.runtime.loadgen --hosts 2``).
"""
from __future__ import annotations

import math
import multiprocessing as mp
import queue
import threading
import traceback
from multiprocessing.connection import wait as mp_wait
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import clock as obs_clock
from repro_torch.obs import events as obs_events
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer
from repro_torch.runtime.cache import CONSTRAINED, PENALIZED
from repro_torch.runtime.metrics import LatencyRecorder
from repro_torch.runtime.scheduler import (_NUMPY_DTYPES, EnRequest, EnResult, _host_array,
                                           ceil_pow2)

_HB_INTERVAL_DEFAULT = 0.05


# -- worker process ---------------------------------------------------------

def _read_pipe(conn, inbox: queue.Queue) -> None:
    """Move every message of `conn` into `inbox` until "stop" or EOF (put
    as ("eof",)), so that the parent's sends never wait on a solve."""
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            inbox.put(("eof",))
            return
        inbox.put(msg)
        if msg[0] == "stop":
            return


def _worker_main(host_id: int, conn, cfg: dict) -> None:
    """One host: a private ContinuousScheduler behind a request pipe.

    Protocol (parent -> child): ("solve", batch_id, items) | ("stop",).
    (child -> parent): ("ready", host_id) once serving; ("hb", host_id, ts)
    whenever `heartbeat_interval` passes with no work; ("result", host_id,
    batch_id, {req_id: result dict}, deltas); ("error", host_id, batch_id,
    tb, deltas) for a failed batch (the coordinator requeues it); ("stats",
    host_id, dict, deltas) once, just before a clean exit.

    `deltas` are the worker registry's `counter_deltas()` — metric
    increments since the previous message, piggybacked on the pipes the
    results already ride (DESIGN.md §12.4). Each delta is consumed by
    exactly one snapshot, so the coordinator's merge is idempotent under
    host death: a dead host's final deltas either arrived with a buffered
    message (salvaged) or died with the pipe — never merged twice.
    """
    from repro_torch import kernels
    from repro_torch.runtime.cache import TieredSolutionCache
    from repro_torch.runtime.scheduler import ContinuousScheduler

    cache = ("default" if not cfg.get("cache_dir") else
             TieredSolutionCache(spill_dir=cfg["cache_dir"]))
    sched = ContinuousScheduler(
        max_batch=cfg.get("max_batch", 8), min_n=cfg.get("min_n", 16),
        min_p=cfg.get("min_p", 8), max_wait=None, cache=cache,
        fixed_batch=cfg.get("fixed_batch", False),
        speculate=cfg.get("speculate", False), mesh=None,
        device=cfg.get("device"), dtype=cfg.get("dtype", torch.float64))
    hb = cfg.get("heartbeat_interval", _HB_INTERVAL_DEFAULT)
    inbox: queue.Queue = queue.Queue()
    threading.Thread(target=_read_pipe, args=(conn, inbox), daemon=True,
                     name=f"en-host-{host_id}-pipe").start()
    conn.send(("ready", host_id))
    try:
        while True:
            try:
                msg = inbox.get(timeout=hb)
            except queue.Empty:
                conn.send(("hb", host_id, obs_clock.walltime()))
                continue
            if msg[0] in ("stop", "eof"):
                break
            _, batch_id, items = msg
            try:
                local = {}
                for it in items:
                    kw = ({"lambda1": it["lam"]} if it["form"] == PENALIZED
                          else {"t": it["lam"]})
                    rid = sched.submit(it["X"], it["y"],
                                       lambda2=it["lambda2"],
                                       priority=it["priority"], **kw)
                    local[rid] = it["req_id"]
                results = sched.drain()
                payload = {}
                for rid, res in results.items():
                    payload[local[rid]] = {
                        "beta": (None if res.beta is None
                                 else np.asarray(res.beta)),
                        "iters": int(res.iters), "kkt": float(res.kkt),
                        "bucket": tuple(res.bucket), "status": res.status,
                        "warm_from": res.warm_from, "warm_start": res.warm_start}
                conn.send(("result", host_id, batch_id, payload,
                           sched.registry.counter_deltas()))
            except Exception:  # noqa: BLE001 — report, let the parent requeue
                conn.send(("error", host_id, batch_id,
                           traceback.format_exc(),
                           sched.registry.counter_deltas()))
        c = sched.cache
        conn.send(("stats", host_id, {
            "requests": sched.stats.requests,
            "batches": sched.stats.batches,
            "bucket_shapes": sched.stats.bucket_shapes,
            "speculative_slots": sched.stats.speculative_slots,
            "cache_hits": getattr(c, "hits", 0),
            "cache_misses": getattr(c, "misses", 0),
            "spill_hits": getattr(c, "spill_hits", 0),
            "device": str(sched.device),
            "kernel_launches": kernels.launches()},
            sched.registry.counter_deltas()))
    except (EOFError, BrokenPipeError, OSError):
        pass                    # parent gone: nothing left to report to
    finally:
        conn.close()


# -- coordinator-side host bookkeeping --------------------------------------

class _Host:
    def __init__(self, host_id, proc, conn, clock):
        self.host_id = host_id
        self.proc = proc
        self.conn = conn
        self.ready = False
        self.dead = False
        self.last_seen = clock()
        self.outstanding: Dict[int, "_Batch"] = {}   # batch_id -> batch
        self.load_s = 0.0          # modeled seconds of outstanding work
        self.buckets_seen: set = set()
        self.stats: Optional[dict] = None


class _Batch:
    __slots__ = ("batch_id", "key", "reqs", "cost")

    def __init__(self, batch_id, key, reqs, cost):
        self.batch_id = batch_id
        self.key = key
        self.reqs = reqs
        self.cost = cost


class MultiHostCoordinator:
    """Span the serving runtime over `n_hosts` worker processes.

    `max_wait=None` (default) is drain-on-demand: requests wait for an
    explicit `flush`/`drain`. A float arms per-request deadlines — they
    gate REQUEUE on failure (expired requeued requests terminate as
    "deadline_exceeded"); batch formation itself happens at flush.

    `cache_dir` points every worker's TieredSolutionCache at one shared
    persistent spill tier; None serves memory-only. `heartbeat_timeout`
    (None disables) additionally declares a host dead when its pipe has
    been silent too long — process exit and pipe EOF are always fatal.
    NOTE a worker mid-solve does not heartbeat (it is draining, not
    idling), so a timeout must comfortably exceed the slowest batch.

    Every worker solves on `device` (the CUDA device when none is named;
    with no CUDA device and none named this raises, as
    `repro_torch.device.resolve_device` does) in `dtype` (float64 or
    float32). Each result names the point of the warm-start entry its
    worker started from (`EnResult.warm_from`, None: cold) and carries that
    entry's arrays back (`EnResult.warm_start`), so the solve can be
    repeated from exactly the survivor's start.
    """

    def __init__(self, n_hosts: int = 2, *, max_batch: int = 8,
                 min_n: int = 16, min_p: int = 8,
                 max_wait: Optional[float] = None,
                 cache_dir: Optional[str] = None, speculate: bool = False,
                 fixed_batch: bool = False,
                 max_inflight_per_host: int = 2,
                 heartbeat_interval: float = _HB_INTERVAL_DEFAULT,
                 heartbeat_timeout: Optional[float] = None,
                 clock=obs_clock.monotonic,
                 spawn_timeout: float = 120.0, start: bool = True,
                 device: DeviceLike = None, dtype: torch.dtype = torch.float64,
                 registry: Optional[MetricsRegistry] = None):
        if n_hosts < 1:
            raise ValueError(f"MultiHostCoordinator: n_hosts >= 1 required "
                             f"(got {n_hosts})")
        if dtype not in _NUMPY_DTYPES:
            raise ValueError(f"MultiHostCoordinator: dtype must be one of "
                             f"{sorted(map(str, _NUMPY_DTYPES))} (got {dtype})")
        if device is None and not torch.cuda.is_available():
            resolve_device(None)        # raises: no CUDA device and none named
        # the parent names the device and never touches it: a CUDA device
        # is resolved in each worker, so the parent makes no CUDA context
        self.device = None if device is None else torch.device(device)
        self.dtype = dtype
        self.np_dtype = _NUMPY_DTYPES[dtype]
        self.n_hosts = n_hosts
        self.max_batch = max_batch
        self.min_n = min_n
        self.min_p = min_p
        self.max_wait = max_wait
        self.max_inflight_per_host = max_inflight_per_host
        self.heartbeat_timeout = heartbeat_timeout
        self.spawn_timeout = spawn_timeout
        self.clock = clock
        self.tracer = get_tracer()
        # three metric scopes (DESIGN.md §12.4): `registry` is the
        # coordinator's OWN accounting (admission, terminals, failover),
        # `fleet` is every worker's counter deltas merged, `host_registries`
        # keeps the same deltas split per host — a dead host's view freezes
        # at its last delivered message.
        self.registry = registry if registry is not None else MetricsRegistry()
        self.fleet = MetricsRegistry()
        self.host_registries: Dict[int, MetricsRegistry] = {}
        self.metrics = LatencyRecorder(registry=self.registry)
        self._admitted = self.registry.counter(
            "requests_admitted_total", "requests accepted by the coordinator")
        self._terminal = self.registry.counter(
            "requests_terminal_total",
            "admitted requests by terminal status", ("status",))
        self._requeues = self.registry.counter(
            "batches_requeued_total",
            "batches re-placed after a host failure or worker error")
        self._lost = self.registry.counter(
            "hosts_lost_total", "worker hosts declared dead")
        self.worker_stats: List[dict] = []
        self._cfg = {"max_batch": max_batch, "min_n": min_n, "min_p": min_p,
                     "cache_dir": cache_dir, "speculate": speculate,
                     "fixed_batch": fixed_batch,
                     "heartbeat_interval": heartbeat_interval,
                     "device": None if self.device is None else str(self.device),
                     "dtype": dtype}
        self._hosts: List[_Host] = []
        self._buckets: Dict[tuple, list] = {}
        self._queue: List[_Batch] = []
        self._results: Dict[int, EnResult] = {}
        self._owner: Dict[int, int] = {}     # req_id -> batch_id (in flight)
        self._next_req = 0
        self._next_batch = 0
        self._started = False
        if start:
            self.start()

    # -- telemetry ---------------------------------------------------------

    @property
    def hosts_lost(self) -> int:
        return int(self._lost.value())

    @property
    def requeued_batches(self) -> int:
        return int(self._requeues.value())

    def _merge_deltas(self, host_id: int, deltas: Optional[dict]) -> None:
        """Fold one worker message's piggybacked counter deltas into the
        fleet view and that host's view."""
        if not deltas:
            return
        self.fleet.merge_counter_deltas(deltas)
        reg = self.host_registries.setdefault(host_id, MetricsRegistry())
        reg.merge_counter_deltas(deltas)

    def metrics_snapshot(self) -> dict:
        """Coordinator + fleet + per-host metric state as plain JSON."""
        return {"coordinator": self.registry.snapshot(),
                "fleet": self.fleet.snapshot(),
                "hosts": {hid: reg.snapshot()
                          for hid, reg in sorted(self.host_registries.items())}}

    def accounting(self) -> dict:
        """The no-silent-drops invariant as numbers: every admitted request
        must sit in exactly one terminal-status counter once traffic has
        drained."""
        terminals = {status: int(v) for (status,), v
                     in self._terminal.series().items()}
        admitted = int(self._admitted.value())
        return {"admitted": admitted, "terminals": terminals,
                "outstanding": len(self._owner) + len(self._queue_reqs()),
                "balanced": admitted == sum(terminals.values())}

    def _queue_reqs(self) -> list:
        return ([r for b in self._queue for r in b.reqs]
                + [r for b in self._buckets.values() for r in b])

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Spawn the workers and wait for every "ready" (each worker builds
        its scheduler, and so calibrates the cost model, before it is
        ready)."""
        if self._started:
            return
        ctx = mp.get_context("spawn")
        for i in range(self.n_hosts):
            parent, child = ctx.Pipe(duplex=True)
            proc = ctx.Process(target=_worker_main, args=(i, child, self._cfg),
                               daemon=True, name=f"en-host-{i}")
            proc.start()
            child.close()            # the parent keeps only its own end
            self._hosts.append(_Host(i, proc, parent, self.clock))
        self._started = True
        t0 = self.clock()
        while not all(h.ready or h.dead for h in self._hosts):
            self._service(0.05)
            if self.clock() - t0 > self.spawn_timeout:
                self.shutdown()
                raise TimeoutError(
                    f"multihost: workers not ready after {self.spawn_timeout}s")
        if not self._alive():
            raise RuntimeError("multihost: every worker died during startup")

    def shutdown(self) -> List[dict]:
        """Stop every worker, collect final stats, reap processes."""
        for h in self._hosts:
            if not h.dead:
                try:
                    h.conn.send(("stop",))
                except (BrokenPipeError, OSError):
                    pass
        t0 = self.clock()
        while (any(not h.dead and h.stats is None for h in self._hosts)
               and self.clock() - t0 < 10.0):
            self._service(0.05)
        for h in self._hosts:
            h.proc.join(timeout=2.0)
            if h.proc.is_alive():
                h.proc.kill()
                h.proc.join(timeout=2.0)
            try:
                h.conn.close()
            except OSError:
                pass
        self.worker_stats = [h.stats for h in self._hosts
                             if h.stats is not None]
        return self.worker_stats

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- fault injection ---------------------------------------------------

    def kill_host(self, host_id: int) -> None:
        """SIGKILL one worker — the fault the test harness injects. The
        coordinator is NOT told: death must be DETECTED (exitcode / pipe
        EOF / stale heartbeat), exercising the real failover path."""
        self._hosts[host_id].proc.kill()

    # -- admission (mirrors ContinuousScheduler.submit) ----------------------

    def submit(self, X, y, *, t: Optional[float] = None,
               lambda1: Optional[float] = None, lambda2: float = 1.0,
               priority: int = 0, deadline: Optional[float] = None) -> int:
        X = _host_array(X, self.np_dtype)
        y = _host_array(y, self.np_dtype)
        if X.ndim != 2 or y.shape != (X.shape[0],):
            raise ValueError(f"submit: bad shapes X{X.shape} y{y.shape}")
        if (t is None) == (lambda1 is None):
            raise ValueError("submit: give exactly one of t= and lambda1=")
        if t is not None and not (t > 0 and lambda2 >= 0):
            raise ValueError(f"submit: need t > 0, lambda2 >= 0 "
                             f"(t={t}, lambda2={lambda2})")
        if lambda1 is not None and not (lambda1 >= 0 and lambda2 >= 0):
            raise ValueError(f"submit: need lambda1 >= 0, lambda2 >= 0 "
                             f"(lambda1={lambda1}, lambda2={lambda2})")
        now = self.clock()
        if deadline is None:
            deadline = (math.inf if self.max_wait is None
                        else now + self.max_wait)
        form = CONSTRAINED if t is not None else PENALIZED
        req = EnRequest(
            req_id=self._next_req, X=X, y=y, form=form,
            lam=float(t if t is not None else lambda1),
            lambda2=float(lambda2), priority=priority, deadline=deadline,
            submitted=now, fingerprint=None)
        self._next_req += 1
        key = self._key(req)
        self._buckets.setdefault(key, []).append(req)
        self.metrics.submitted(req.req_id, now)
        self._admitted.inc()
        if len(self._buckets[key]) >= self.max_batch:
            self._form_batches(only_full=True)
        self._pump()
        self._service(0.0)
        return req.req_id

    def _key(self, r: EnRequest) -> tuple:
        return (ceil_pow2(r.X.shape[0], self.min_n),
                ceil_pow2(r.X.shape[1], self.min_p), r.form)

    # -- placement ---------------------------------------------------------

    def _alive(self) -> List[_Host]:
        return [h for h in self._hosts if not h.dead]

    def _form_batches(self, only_full: bool = False) -> None:
        """Cut pending buckets into max_batch chunks on the dispatch queue."""
        for key in list(self._buckets):
            while (len(self._buckets.get(key, ())) >=
                   (self.max_batch if only_full else 1)):
                bucket = self._buckets[key]
                bucket.sort(key=lambda r: (-r.priority, r.deadline, r.req_id))
                chunk, rest = bucket[:self.max_batch], bucket[self.max_batch:]
                if rest:
                    self._buckets[key] = rest
                else:
                    del self._buckets[key]
                bn, bp, form = key
                cost = routing.estimate_batch_seconds(
                    bn, bp, len(chunk),
                    form="penalized" if form == PENALIZED else "constrained",
                    device=self.device)
                self._queue.append(_Batch(self._next_batch, key,
                                          list(chunk), cost))
                self._next_batch += 1
                if not self._buckets.get(key):
                    break

    def _pump(self) -> None:
        """Place queued batches: among hosts under their in-flight cap,
        least modeled load wins, bucket affinity breaks ties (a host that
        has served this (bn, bp, form) shape keeps getting it)."""
        while self._queue:
            eligible = [h for h in self._alive() if h.ready and
                        len(h.outstanding) < self.max_inflight_per_host]
            if not eligible:
                if self._started and not self._alive():
                    self._abort_everything()
                return
            batch = self._queue.pop(0)
            host = min(eligible, key=lambda h: (
                h.load_s, 0 if batch.key in h.buckets_seen else 1, h.host_id))
            items = [{"req_id": r.req_id, "X": r.X, "y": r.y, "form": r.form,
                      "lam": r.lam, "lambda2": r.lambda2,
                      "priority": r.priority} for r in batch.reqs]
            try:
                with self.tracer.span("mh.place", host=host.host_id,
                                      bucket=batch.key[:2],
                                      b=len(batch.reqs), cost_s=batch.cost):
                    host.conn.send(("solve", batch.batch_id, items))
            except (BrokenPipeError, OSError):
                self._mark_dead(host)
                self._queue.insert(0, batch)
                continue
            host.outstanding[batch.batch_id] = batch
            host.load_s += batch.cost
            host.buckets_seen.add(batch.key)
            now = self.clock()
            self.metrics.launched([r.req_id for r in batch.reqs], now)
            for r in batch.reqs:
                self._owner[r.req_id] = batch.batch_id

    # -- failure handling --------------------------------------------------

    def _mark_dead(self, host: _Host) -> None:
        if host.dead:
            return
        # salvage messages that beat the death into the pipe: a batch whose
        # result is already buffered completed — requeueing it would be
        # duplicate (if harmless) work
        try:
            while host.conn.poll(0):
                msg = host.conn.recv()
                if msg[0] == "result":
                    self._merge_deltas(host.host_id, msg[4])
                    self._finish_batch(host, msg[2], msg[3])
                elif msg[0] == "stats":
                    host.stats = msg[2]
                    self._merge_deltas(host.host_id, msg[3])
        except (EOFError, OSError):
            pass
        host.dead = True
        host.ready = False
        lost = list(host.outstanding.values())
        host.outstanding.clear()
        host.load_s = 0.0
        # a host whose FINAL stats arrived and whose slate is clean merely
        # stopped (shutdown handshake) — only count genuine failures
        if host.stats is None or lost:
            self._lost.inc()
            obs_events.emit("host_death", host=host.host_id,
                            lost_batches=len(lost),
                            exitcode=host.proc.exitcode)
        for batch in lost:
            self._requeues.inc()
            self._requeue(batch.reqs)

    def _terminate(self, r: EnRequest, status: str, now: float) -> None:
        """End one request without a solve (beta None) in `status`."""
        self._owner.pop(r.req_id, None)
        self._results[r.req_id] = EnResult(
            beta=None, iters=np.int64(0), kkt=math.inf, bucket=self._key(r)[:2],
            status=status)
        self.metrics.completed([r.req_id], now)
        self._terminal.inc(status=status)

    def _requeue(self, reqs) -> None:
        """Re-admit a failed batch's requests; expired deadlines terminate
        (the ContinuousScheduler.requeue contract, across processes)."""
        now = self.clock()
        for r in reqs:
            self._owner.pop(r.req_id, None)
            if r.deadline <= now:
                self._terminate(r, "deadline_exceeded", now)
                obs_events.emit("deadline_exceeded", req_id=r.req_id,
                                deadline=r.deadline, now=now)
                continue
            self._buckets.setdefault(self._key(r), []).append(r)
        self._form_batches()

    def _abort_everything(self) -> None:
        """No host left: terminate every unfinished request explicitly."""
        now = self.clock()
        doomed = self._queue_reqs()
        self._queue.clear()
        self._buckets.clear()
        if doomed:
            obs_events.emit("abort_all", n=len(doomed))
        for r in doomed:
            self._terminate(r, "aborted", now)

    # -- event loop --------------------------------------------------------

    def _service(self, timeout: float) -> None:
        """Drain worker pipes, detect deaths, refresh liveness clocks."""
        conns = {h.conn: h for h in self._hosts if not h.dead}
        if conns:
            for conn in mp_wait(list(conns), timeout=timeout or 0):
                host = conns[conn]
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    self._mark_dead(host)
                    continue
                host.last_seen = self.clock()
                kind = msg[0]
                if kind == "ready":
                    host.ready = True
                elif kind == "hb":
                    pass
                elif kind == "result":
                    self._merge_deltas(host.host_id, msg[4])
                    self._finish_batch(host, msg[2], msg[3])
                elif kind == "error":
                    self._merge_deltas(host.host_id, msg[4])
                    batch = host.outstanding.pop(msg[2], None)
                    if batch is not None:
                        host.load_s = max(0.0, host.load_s - batch.cost)
                        self._requeues.inc()
                        obs_events.emit("requeue", host=host.host_id,
                                        batch=msg[2])
                        self._requeue(batch.reqs)
                elif kind == "stats":
                    host.stats = msg[2]
                    self._merge_deltas(host.host_id, msg[3])
        now = self.clock()
        for h in self._hosts:
            if h.dead:
                continue
            if h.proc.exitcode is not None and h.stats is None:
                self._mark_dead(h)
            elif (self.heartbeat_timeout is not None
                  and now - h.last_seen > self.heartbeat_timeout):
                self._mark_dead(h)
        if self._started and not self._alive() and (self._queue
                                                    or self._buckets):
            self._abort_everything()

    def _finish_batch(self, host: _Host, batch_id: int, payload: dict) -> None:
        batch = host.outstanding.pop(batch_id, None)
        if batch is None:
            return                   # duplicate delivery after a requeue
        host.load_s = max(0.0, host.load_s - batch.cost)
        now = self.clock()
        done = []
        for r in batch.reqs:
            out = payload.get(r.req_id)
            if out is None:          # worker lost it: requeue, never drop
                self._requeue([r])
                continue
            self._owner.pop(r.req_id, None)
            self._results[r.req_id] = EnResult(
                beta=out["beta"], iters=np.int64(out["iters"]),
                kkt=out["kkt"], bucket=tuple(out["bucket"]),
                status=out["status"], warm_from=out.get("warm_from"),
                warm_start=out.get("warm_start"))
            self._terminal.inc(status=out["status"])
            done.append(r.req_id)
        if done:
            self.metrics.completed(done, now)

    # -- serving surface (duck-types ContinuousScheduler) --------------------

    def flush(self) -> int:
        self._form_batches()
        n = len(self._queue)
        self._pump()
        return n

    def poll(self, now=None) -> int:
        self._service(0.0)
        self._pump()
        return 0

    def harvest(self, *, block: bool = False) -> Dict[int, EnResult]:
        self._service(0.0)
        self._pump()
        out, self._results = self._results, {}
        return out

    def drain(self, timeout: float = 300.0) -> Dict[int, EnResult]:
        """Flush + wait until every admitted request has a result."""
        self.flush()
        t0 = self.clock()
        while self._owner or self._queue or self._buckets:
            self._service(0.05)
            self._pump()
            if self.clock() - t0 > timeout:
                raise TimeoutError(
                    f"multihost drain: {len(self._owner)} in flight, "
                    f"{len(self._queue)} queued after {timeout}s")
        out, self._results = self._results, {}
        return out
