"""Reproducible open-loop load generator for the serving runtime.

The port of `repro/runtime/loadgen.py`. Builds a seeded synthetic request
stream — a handful of distinct datasets, each hit repeatedly at nearby
points of the regularization surface (the "adjacent-lambda" pattern real
hyperparameter-sweep traffic has, and the pattern the warm-start cache
exists for) — and plays it into a `ContinuousScheduler` WITHOUT waiting for
completions between submissions (open loop: arrival times are independent
of service times).

    PYTHONPATH=src python -m repro_torch.runtime --requests 24 --waves 3
    PYTHONPATH=src python -m repro_torch.runtime --hosts 2 --kill-host 0

The CLI is the serving smoke: every wave after the first must complete
every request and add ZERO new launch shapes (`stats.bucket_shapes`,
asserted) — the runtime serves steady-state traffic on a constant set of
(bucket, batch, form) shapes, with the cache absorbing repeat/adjacent
work. (The JAX smoke also asserts zero jit retraces; the port compiles
nothing per shape.)

With `--hosts N` the same waves go to a `MultiHostCoordinator` over N
worker processes sharing a spill directory, and `--kill-host K` SIGKILLs
host K before the second wave (`run_multihost`).

A `LoadSpec` names the same stream in both packages: the same arrays, forms,
priorities and lambdas, byte for byte.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import clock as obs_clock
from repro_torch.runtime.cache import CONSTRAINED, PENALIZED


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """A seeded description of one request stream (fully reproducible)."""

    n_requests: int = 64
    n_datasets: int = 3                       # distinct (X, y) problems
    shapes: Sequence[Tuple[int, int]] = ((48, 24), (64, 40), (30, 56))
    pattern: str = "adjacent"                 # "adjacent" | "uniform"
    adjacent_width: float = 0.1               # +-10% around each lam center
    penalized_fraction: float = 0.0           # mix of glmnet-form requests
    lambda2_choices: Sequence[float] = (0.5, 1.0, 2.0)
    arrival_rate: Optional[float] = None      # req/s; None = back-to-back
    seed: int = 0
    data_seed: Optional[int] = None           # pin datasets across specs:
    # two specs sharing data_seed draw DIFFERENT lambda/arrival streams over
    # the SAME datasets — the repeat-traffic shape warm-start caching serves.


class LoadItem(NamedTuple):
    arrival: float        # seconds after stream start (0.0 when unpaced)
    dataset: int
    X: np.ndarray
    y: np.ndarray
    form: str
    lam: float
    lambda2: float
    priority: int


def _lambda1_max_host(X: np.ndarray, y: np.ndarray) -> float:
    """lambda1_max(X, y) = 2 max_j |x_j^T y| of host arrays, in numpy: the
    JAX package's loadgen hands its `lambda1_max` numpy arrays, so numpy
    does the product there too, and the same spec gives the same bits."""
    return float(2.0 * np.max(np.abs(X.T @ y)))


def make_workload(spec: LoadSpec) -> List[LoadItem]:
    """Materialize the stream: every array and lambda is a pure function of
    the spec (same spec => byte-identical workload => same fingerprints,
    in this package and in the JAX one)."""
    from repro_torch.data.synthetic import make_regression_numpy

    rng = np.random.default_rng(spec.seed)
    data_seed = spec.seed if spec.data_seed is None else spec.data_seed
    rng_data = np.random.default_rng(data_seed * 7919 + 13)
    datasets = []
    for d in range(spec.n_datasets):
        n, p = spec.shapes[d % len(spec.shapes)]
        X, y, _ = make_regression_numpy(n, p, k_true=max(3, p // 6), rho=0.3,
                                        seed=data_seed * 1000 + d)
        t_center = float(0.15 * np.abs(X.T @ y).sum() / n)
        # lambda2 is a per-DATASET trait (drawn from the data rng): waves
        # sharing data_seed revisit the same (dataset, lambda2) pairs, so
        # adjacent-lambda1/t traffic lands inside the cache neighborhood.
        lam2 = float(rng_data.choice(spec.lambda2_choices))
        l1_center = 0.3 * _lambda1_max_host(X, y)
        datasets.append((X, y, max(t_center, 1e-3), l1_center, lam2))

    items: List[LoadItem] = []
    arrival = 0.0
    for _ in range(spec.n_requests):
        d = int(rng.integers(spec.n_datasets))
        X, y, t_c, l1_c, lam2 = datasets[d]
        pen = rng.random() < spec.penalized_fraction
        center = l1_c if pen else t_c
        if spec.pattern == "adjacent":
            lam = center * (1.0 + spec.adjacent_width
                            * float(rng.uniform(-1.0, 1.0)))
        elif spec.pattern == "uniform":
            lam = center * float(rng.uniform(0.4, 1.6))
        else:
            raise ValueError(f"make_workload: unknown pattern {spec.pattern!r}")
        if spec.arrival_rate:
            arrival += float(rng.exponential(1.0 / spec.arrival_rate))
        items.append(LoadItem(
            arrival=arrival, dataset=d, X=X, y=y,
            form=PENALIZED if pen else CONSTRAINED, lam=lam, lambda2=lam2,
            priority=int(rng.integers(0, 3))))
    return items


def run_open_loop(scheduler, workload: Sequence[LoadItem], *,
                  pace: bool = False) -> dict:
    """Play a workload into a scheduler; returns wall time + metrics summary.

    Submissions never wait on results (`submit` polls, launching full /
    expired buckets); everything still pending is flushed and harvested at
    the end, so the returned summary covers every request. The scheduler's
    latency recorder is reset first — each run's summary stands alone even
    when waves share one scheduler (warm cache).
    """
    scheduler.metrics.reset()
    ids = []
    t0 = obs_clock.monotonic()
    for item in workload:
        if pace and item.arrival > 0.0:
            lag = t0 + item.arrival - obs_clock.monotonic()
            if lag > 0:
                time.sleep(lag)
        kw = ({"lambda1": item.lam} if item.form == PENALIZED
              else {"t": item.lam})
        ids.append(scheduler.submit(item.X, item.y, lambda2=item.lambda2,
                                    priority=item.priority, **kw))
    results = scheduler.drain()
    wall = obs_clock.monotonic() - t0
    out = {"n_requests": len(workload), "wall_seconds": wall,
           "results": results, "ids": ids}
    out.update(scheduler.metrics.summary())
    return out


def export_telemetry(args, *, registry_snapshot: dict,
                     required_metrics: Sequence[str],
                     required_spans: Sequence[str] = ()) -> None:
    """Write `--trace-out` / `--metrics-json` / `--events-out` artifacts and
    SCHEMA-CHECK them on the spot: the trace must be loadable Chrome-trace
    JSON containing the expected span names, the metrics snapshot must
    carry the expected series. Assertion failures here are loadgen
    failures — a telemetry regression fails the smoke."""
    import json

    from repro_torch.obs.events import default_events
    from repro_torch.obs.trace import get_tracer

    if args.trace_out:
        path = get_tracer().export(args.trace_out)
        with open(path) as f:
            trace = json.load(f)
        names = {ev["name"] for ev in trace["traceEvents"]}
        missing = set(required_spans) - names
        assert not missing, f"trace missing expected spans: {sorted(missing)}"
        assert all(ev["ph"] in ("X", "i") and "ts" in ev
                   for ev in trace["traceEvents"]), "malformed trace event"
        print(f"[loadgen] trace: {len(trace['traceEvents'])} events "
              f"-> {path}")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(registry_snapshot, f, indent=1, default=str)
        flat = json.dumps(registry_snapshot)
        missing = [m for m in required_metrics if m not in flat]
        assert not missing, f"metrics snapshot missing series: {missing}"
        print(f"[loadgen] metrics snapshot -> {args.metrics_json}")
    if args.events_out:
        path = default_events().dump(args.events_out)
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                assert "ts" in rec and "kind" in rec, f"malformed event {rec}"
        print(f"[loadgen] events: {len(default_events())} -> {path}")


def run_multihost(args) -> None:
    """Multi-process serving smoke (`--hosts N`): the same seeded waves
    played into a `MultiHostCoordinator` spanning N worker processes, with
    an optional host kill before wave 1 (`--kill-host`). Asserts the
    cross-process no-silent-drops contract — every submitted request gets a
    terminal result, and with no injected fault every status is "ok" — plus
    warm-start hits through the shared spill tier. (The steady-state launch
    shape assertion is per-process; the single-process smoke owns it.)"""
    import tempfile

    from repro_torch.runtime.multihost import MultiHostCoordinator

    spec = LoadSpec(n_requests=args.requests,
                    penalized_fraction=args.penalized, seed=args.seed)
    workload = make_workload(spec)
    with tempfile.TemporaryDirectory() as tmp:
        coord = MultiHostCoordinator(n_hosts=args.hosts,
                                     max_batch=args.max_batch,
                                     cache_dir=tmp, speculate=True,
                                     device=args.device)
        try:
            for wave in range(args.waves):
                if args.kill_host >= 0 and wave == 1:
                    coord.kill_host(args.kill_host)
                    print(f"[loadgen] wave {wave}: injected SIGKILL on "
                          f"host {args.kill_host}")
                summary = run_open_loop(coord, workload)
                statuses: dict = {}
                for res in summary["results"].values():
                    statuses[res.status] = statuses.get(res.status, 0) + 1
                print(f"[loadgen] wave {wave}: {summary['n_completed']}/"
                      f"{args.requests} done in "
                      f"{summary['wall_seconds']*1e3:7.1f} ms"
                      f" | p99 {summary['p99_latency_s']*1e3:6.1f} ms"
                      f" | statuses={statuses}"
                      f" hosts_lost={coord.hosts_lost}")
                assert set(summary["results"]) == set(summary["ids"]), \
                    "lost requests across hosts"
                if args.kill_host < 0:
                    assert statuses == {"ok": args.requests}, statuses
        finally:
            stats = coord.shutdown()
        hits = sum(s["cache_hits"] for s in stats)
        spill = sum(s["spill_hits"] for s in stats)
        acct = coord.accounting()
        print(f"[loadgen] multihost OK: {args.hosts} hosts, "
              f"{coord.hosts_lost} lost, {coord.requeued_batches} batches "
              f"requeued, {hits} warm hits ({spill} via shared spill).")
        print(f"[loadgen] accounting: {acct['admitted']} admitted, "
              f"terminals={acct['terminals']}")
        assert acct["balanced"], f"terminal accounting broken: {acct}"
        assert hits > 0, "multihost waves produced no warm-start hits"
        export_telemetry(
            args, registry_snapshot=coord.metrics_snapshot(),
            required_metrics=("requests_admitted_total",
                              "requests_terminal_total",
                              "runtime_requests_total"),
            required_spans=("mh.place",) if args.trace_out else ())


def main(argv=None) -> None:
    """Serving smoke: steady-state waves must add no launch shapes."""
    import argparse

    from repro_torch.runtime.scheduler import ContinuousScheduler

    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24, help="per wave")
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--penalized", type=float, default=0.25,
                    help="fraction of glmnet-form requests")
    ap.add_argument("--device", default=None,
                    help="torch device to solve on (default: the CUDA device)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="> 0: drive a MultiHostCoordinator over this many "
                         "worker processes instead of an in-process scheduler")
    ap.add_argument("--kill-host", type=int, default=-1,
                    help="with --hosts: SIGKILL this host before wave 1")
    ap.add_argument("--trace-out", default="",
                    help="enable tracing; write Chrome-trace JSON here and "
                         "schema-check it")
    ap.add_argument("--metrics-json", default="",
                    help="write the metrics snapshot (JSON) here and "
                         "schema-check it")
    ap.add_argument("--events-out", default="",
                    help="write the structured event log (JSONL) here")
    args = ap.parse_args(argv)

    if args.kill_host >= max(args.hosts, 0):
        ap.error(f"--kill-host {args.kill_host} needs --hosts greater than it")
    if args.trace_out:
        from repro_torch.obs.trace import enable_tracing
        enable_tracing()

    if args.hosts > 0:
        run_multihost(args)
        return

    # fixed_batch pins one launch shape per (bucket, form); repeating the
    # SAME seeded wave makes the steady-state assertion exact (launch sizes
    # under deadline scheduling would otherwise vary with wall clock).
    sched = ContinuousScheduler(max_batch=args.max_batch, max_wait=0.005,
                                fixed_batch=True, device=args.device)
    spec = LoadSpec(n_requests=args.requests,
                    penalized_fraction=args.penalized, seed=args.seed)
    workload = make_workload(spec)
    steady_execs = None
    for wave in range(args.waves):
        summary = run_open_loop(sched, workload)
        execs = sched.stats.bucket_shapes
        print(f"[loadgen] wave {wave}: {summary['n_completed']}/"
              f"{args.requests} done in {summary['wall_seconds']*1e3:7.1f} ms"
              f" | p50 {summary['p50_latency_s']*1e3:6.1f} ms"
              f" p99 {summary['p99_latency_s']*1e3:6.1f} ms"
              f" | launch shapes={execs}"
              f" cache_hit_rate={sched.cache.hit_rate:.2f}")
        assert summary["n_completed"] == args.requests, "lost requests"
        if wave > 0:
            assert execs == steady_execs, (
                f"steady-state wave added launch shapes: "
                f"{steady_execs} -> {execs}")
        steady_execs = execs
    assert sched.cache.hits > 0, "adjacent-lambda stream produced no cache hits"
    print(f"[loadgen] steady state OK: {sched.stats.requests} requests, "
          f"{steady_execs} launch shapes, none added after wave 0, "
          f"{sched.cache.hits} warm-start cache hits.")
    export_telemetry(
        args, registry_snapshot=sched.registry.snapshot(),
        required_metrics=("runtime_requests_total", "runtime_launches_total",
                          "cache_lookups_total", "request_latency_seconds",
                          "requests_terminal_total"),
        required_spans=("admit", "launch", "warm_start", "harvest.block",
                        "complete") if args.trace_out else ())


if __name__ == "__main__":
    main()
