"""Elastic Net serving launcher on the continuous-batching runtime: drive a
`ContinuousScheduler` with a reproducible open-loop request stream (mixed
constrained + glmnet-form, adjacent-lambda pattern) and report
runtime-vs-reference time, warm-start cache behaviour, launch-shape reuse,
and exactness against direct per-request solves. The synchronous path
survives as `ElasticNetEngine.drain_reference()` and is timed as the
baseline every wave. The port of `repro/launch/serve_en.py`.

    PYTHONPATH=src python -m repro_torch.launch.serve_en --requests 24 --waves 3

Runs on the CUDA device unless `--device` names another. Each wave checks
max|beta - direct| < 1e-6 for the first `--verify` requests, max|beta -
drain_reference| < 1e-6 for all, and each penalized request against
coordinate descent (`baselines.elastic_net_cd`, on the CPU) < 1e-5.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.baselines import elastic_net_cd
from repro_torch.core import SvenConfig, enet, sven
from repro_torch.device import resolve_device
from repro_torch.runtime import (PENALIZED, ContinuousScheduler, LoadSpec, make_workload,
                                 run_open_loop)
from repro_torch.serve import ElasticNetEngine


def _direct_solve(item, cfg: SvenConfig, device: torch.device) -> np.ndarray:
    """The unpadded problem solved on its own, as a host array."""
    X = torch.as_tensor(item.X, device=device)
    y = torch.as_tensor(item.y, device=device)
    if item.form == PENALIZED:
        return enet(X, y, item.lam, item.lambda2).beta.cpu().numpy()
    return sven(X, y, item.lam, item.lambda2, cfg).beta.cpu().numpy()


def _serve_metrics(registry, port: int):
    """Live Prometheus text exposition on a daemon thread (stdlib only).

    Scrape target for the duration of the run: ``GET /metrics`` renders
    `registry.to_prometheus()` at request time, so a scraper polling while
    waves are in flight sees counters move.
    """
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = registry.to_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # keep the wave report readable
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24, help="requests per wave")
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", type=int, default=4,
                    help="requests per wave cross-checked against direct "
                         "sven()/enet() solves")
    ap.add_argument("--penalized", type=int, default=2,
                    help="glmnet-form requests per wave (verified against "
                         "coordinate descent)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait", type=float, default=2e-3,
                    help="coalescing window (s) before a deadline launch")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to solve on (default: the CUDA device)")
    ap.add_argument("--cache-dir", type=str, default=None,
                    help="persistent warm-start spill directory: solutions "
                         "survive restarts and are shareable across hosts "
                         "(DESIGN.md §11.2)")
    ap.add_argument("--speculate", action="store_true",
                    help="pre-solve predicted next lambda-crawl points in "
                         "idle batch slots (DESIGN.md §11.3)")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="enable structured tracing and export a Chrome-trace "
                         "JSON here on exit (chrome://tracing / Perfetto)")
    ap.add_argument("--metrics-json", type=str, default=None,
                    help="write the final metrics-registry snapshot (JSON)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve live Prometheus text exposition on this port "
                         "for the duration of the run (GET /metrics)")
    ap.add_argument("--events-out", type=str, default=None,
                    help="dump the structured event ring as JSONL on exit")
    args = ap.parse_args(argv)

    if args.trace_out is not None:
        from repro_torch.obs import enable_tracing

        enable_tracing()

    device = resolve_device(args.device)
    cfg = SvenConfig()
    total = args.requests + args.penalized
    cache = "default"
    if args.cache_dir is not None:
        from repro_torch.runtime import TieredSolutionCache

        cache = TieredSolutionCache(spill_dir=args.cache_dir)
    sched = ContinuousScheduler(cfg, max_batch=args.max_batch,
                                max_wait=args.max_wait, cache=cache,
                                speculate=args.speculate, device=device)
    reference = ElasticNetEngine(cfg, max_batch=args.max_batch, cache=None,
                                 device=device)

    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = _serve_metrics(sched.registry, args.metrics_port)
        print(f"[serve_en] Prometheus exposition on "
              f"http://127.0.0.1:{metrics_server.server_address[1]}/metrics")

    new_shapes_last_wave = 0
    try:
        for wave in range(args.waves):
            shapes0 = sched.stats.bucket_shapes
            batches0 = sched.stats.batches
            padded0 = sched.stats.padded_slots
            # data_seed pins the datasets: every wave revisits the same
            # problems at freshly drawn adjacent lambdas — steady-state
            # serving traffic, which exercises both launch-shape reuse and
            # the warm cache.
            spec = LoadSpec(n_requests=total,
                            penalized_fraction=args.penalized / max(total, 1),
                            seed=args.seed + wave, data_seed=args.seed)
            workload = make_workload(spec)

            out = run_open_loop(sched, workload)
            results, ids = out["results"], out["ids"]

            # synchronous baseline: the cold blocking drain over the SAME wave
            ref_ids = []
            for item in workload:
                if item.form == PENALIZED:
                    ref_ids.append(reference.submit_penalized(
                        item.X, item.y, item.lam, item.lambda2))
                else:
                    ref_ids.append(reference.submit(
                        item.X, item.y, item.lam, item.lambda2))
            t0 = time.perf_counter()
            ref_results = reference.drain_reference()
            reference_s = time.perf_counter() - t0

            max_dev = ref_dev = pen_dev = 0.0
            n_verified = 0
            for item, rid, ref_rid in zip(workload, ids, ref_ids):
                beta = results[rid].beta
                ref_dev = max(ref_dev, float(np.abs(
                    beta - ref_results[ref_rid].beta).max()))
                if n_verified < args.verify:
                    direct = _direct_solve(item, cfg, device)
                    max_dev = max(max_dev, float(np.abs(beta - direct).max()))
                    n_verified += 1
                if item.form == PENALIZED:
                    beta_cd = elastic_net_cd(torch.as_tensor(item.X), torch.as_tensor(item.y),
                                             item.lam, item.lambda2).beta.numpy()
                    pen_dev = max(pen_dev, float(np.abs(beta - beta_cd).max()))

            new_shapes_last_wave = sched.stats.bucket_shapes - shapes0
            print(f"[serve_en] wave {wave}: {total} reqs "
                  f"({args.penalized} pen) in {sched.stats.batches - batches0} "
                  f"batches | runtime {out['wall_seconds']*1e3:7.1f} ms  "
                  f"reference {reference_s*1e3:7.1f} ms "
                  f"({reference_s/max(out['wall_seconds'],1e-9):4.1f}x) | "
                  f"p50 {out['p50_latency_s']*1e3:6.1f} ms "
                  f"p99 {out['p99_latency_s']*1e3:6.1f} ms | "
                  f"new_launch_shapes={new_shapes_last_wave} "
                  f"padded_slots={sched.stats.padded_slots - padded0} "
                  f"cache_hit_rate={sched.cache.hit_rate:.2f} | "
                  f"max|beta-beta_direct|={max_dev:.2e} "
                  f"ref_dev={ref_dev:.2e} pen_dev={pen_dev:.2e}")
            assert max_dev < 1e-6, "runtime diverged from direct solves"
            assert ref_dev < 1e-6, "runtime diverged from drain_reference()"
            assert pen_dev < 1e-5, "penalized path diverged from coordinate descent"
    finally:
        if metrics_server is not None:
            metrics_server.shutdown()
            metrics_server.server_close()

    steady = ("last wave added none" if new_shapes_last_wave == 0
              else f"last wave still added {new_shapes_last_wave}")
    print(f"[serve_en] done: {sched.stats.requests} runtime requests, "
          f"{sched.stats.bucket_shapes} launch shapes ({steady}); "
          f"launches: {sched.stats.launched_full} full / "
          f"{sched.stats.launched_deadline} deadline / "
          f"{sched.stats.launched_flush} flush; "
          f"warm-start hits {sched.cache.hits}/"
          f"{sched.cache.hits + sched.cache.misses}.")

    if args.trace_out is not None:
        from repro_torch.obs import get_tracer

        get_tracer().export(args.trace_out)
        print(f"[serve_en] trace -> {args.trace_out} "
              f"({len(get_tracer().spans())} events)")
    if args.metrics_json is not None:
        import json

        with open(args.metrics_json, "w") as fh:
            json.dump(sched.registry.snapshot(), fh, indent=2, sort_keys=True)
        print(f"[serve_en] metrics snapshot -> {args.metrics_json}")
    if args.events_out is not None:
        from repro_torch.obs import default_events

        default_events().dump(args.events_out)
        print(f"[serve_en] events -> {args.events_out}")


if __name__ == "__main__":
    run()
