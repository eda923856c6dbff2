"""Port parity of the telemetry layer: `repro_torch.obs` against `repro.obs`
on the same operations — the metrics registry (snapshots, Prometheus text,
the counter-delta protocol, exponential histograms), the tracer (span
structure and Chrome-trace export), the event ring and the solve log —
plus what is the port's own: spans entering `torch.profiler.record_function`,
the `REPRO_EVENTS_OUT` dump at exit, the runtime's spans and terminal
counts, and the clock discipline of `repro_torch/runtime`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import problem
from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.runtime import scheduler as tsched

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jobs, "torch": tobs}


def _registry_ops(obs):
    """One sequence of registry operations; returns what it exposes."""
    reg = obs.MetricsRegistry()
    c = reg.counter("requests_terminal_total", "t", ("status",))
    c.inc(status="ok")
    c.inc(2, status="ok")
    c.inc(status="aborted")
    g = reg.gauge("runtime_bucket_executables", "shapes")
    g.set(5)
    h = reg.histogram("request_latency_seconds", "lat")
    for v in (1e-9, 1e-4, 0.003, 0.25, 0.25, 7.0, 1e9):
        h.observe(v)
    h2 = reg.histogram("wait_seconds", "w", ("reason",), start=1e-3, factor=2.0,
                       n_buckets=12)
    h2.observe(0.01, reason="full")
    h2.observe(3.0, reason="deadline")
    d1 = reg.counter_deltas()
    c.inc(4, status="ok")
    d2 = reg.counter_deltas()
    fleet = obs.MetricsRegistry()
    fleet.merge_counter_deltas(d1)
    fleet.merge_counter_deltas(d2)
    reg.reset_instrument("requests_terminal_total")
    c.inc(status="ok")
    d3 = reg.counter_deltas()
    errors = []
    for bad in (lambda: c.inc(wrong="label"),
                lambda: reg.counter("requests_terminal_total", "t", ("reason",)),
                lambda: reg.gauge("requests_terminal_total")):
        with pytest.raises(ValueError) as err:
            bad()
        errors.append(str(err.value))
    quantiles = [h.quantile(q) for q in (0, 1, 50, 90, 99, 100)]
    return (reg.snapshot(), reg.to_prometheus(), d1, d2, d3, fleet.snapshot(),
            fleet.to_prometheus(), errors, quantiles, h.stats(), h2.stats(reason="full"))


def test_registry_snapshot_prometheus_and_deltas_match_jax():
    mine, theirs = _registry_ops(tobs), _registry_ops(jobs)
    assert mine == theirs
    json.dumps(mine[0])
    assert 'requests_terminal_total{status="ok"} 1' in mine[1]


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_exponential_histogram_matches_jax(seed):
    rng = np.random.default_rng(seed)
    xs = np.exp(rng.uniform(-20, 5, 2000)).tolist()
    hists = []
    for obs in (tobs, jobs):
        a, b = obs.ExponentialHistogram(), obs.ExponentialHistogram()
        for i, v in enumerate(xs):
            (a if i % 3 else b).observe(v)
        a.merge(b)
        hists.append((a.counts, a.count, a.sum, a.min, a.max,
                      [a.quantile(q) for q in (0.5, 5, 25, 50, 75, 95, 99.9)]))
    assert hists[0] == hists[1]
    with pytest.raises(ValueError, match="geometries"):
        tobs.ExponentialHistogram().merge(tobs.ExponentialHistogram(factor=1.5))


def _trace_ops(obs, path):
    tr = obs.Tracer(capacity=16)
    tr.enabled = True
    with tr.span("outer", bucket=(64, 32)):
        with tr.span("inner"):
            tr.instant("mark", k=1)
    for i in range(20):
        tr.instant(f"e{i}")

    @tr.traced("decorated")
    def f(x):
        return x + 1

    assert f(1) == 2
    tr.export(str(path))
    doc = json.loads(path.read_text())
    shape = [(e["ph"], e["name"], e["cat"], sorted(e["args"].items()))
             for e in doc["traceEvents"]]
    return shape, tr.counts(), len(tr), doc["displayTimeUnit"]


def test_tracer_matches_jax(tmp_path):
    mine = _trace_ops(tobs, tmp_path / "t.json")
    theirs = _trace_ops(jobs, tmp_path / "j.json")
    assert mine == theirs
    assert mine[1]["outer"] == 1 and mine[2] == 16
    off = tobs.Tracer()
    with off.span("ghost"):
        off.instant("ghost2")
    assert off.spans() == [] and off.counts() == {}


def test_annotated_spans_show_in_the_torch_profiler():
    """With annotate=True a span enters `torch.profiler.record_function`, so
    it shows in a torch profile beside the ops it ran (JAX's enters
    `jax.profiler.TraceAnnotation`)."""
    tr = tobs.Tracer()
    tr.enable(annotate=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("serve.launch"):
            torch.ones(64, dtype=torch.float64).sum()
    names = {e.key for e in prof.key_averages()}
    assert "serve.launch" in names and tr.counts() == {"serve.launch": 1}


def _events_ops(obs, path):
    ev = obs.EventLog(capacity=4)
    for i in range(9):
        ev.emit("requeue", host=i)
    ev.emit("cache_corrupt", path="x.npz")
    ev.dump(str(path))
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    with pytest.raises(ValueError) as err:
        obs.EventLog(capacity=0)
    return ([{k: v for k, v in r.items() if k != "ts"} for r in lines], ev.counts(),
            ev.emitted, len(ev), len(ev.records("requeue")), str(err.value))


def test_event_ring_matches_jax(tmp_path):
    assert _events_ops(tobs, tmp_path / "t.jsonl") == _events_ops(jobs, tmp_path / "j.jsonl")


def test_events_dump_on_exit(tmp_path):
    """`REPRO_EVENTS_OUT` makes `import repro_torch.obs` dump the default
    event ring at interpreter exit."""
    out = tmp_path / "events.jsonl"
    code = ("import repro_torch.obs as o\n"
            "o.emit('requeue', req_id=3)\no.emit('deadline_exceeded', req_id=4)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_EVENTS_OUT=str(out))
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
    kinds = [json.loads(line)["kind"] for line in out.read_text().splitlines()]
    assert kinds == ["requeue", "deadline_exceeded"]


def _solve_log_ops(obs):
    log = obs.SolveLog(capacity=6)
    for i in range(4):
        log.add(obs.SolveRecord(bucket=(64, 32), form="constrained", batch=4, b_real=3,
                                route_path="single", modeled_s=0.01 * (i + 1),
                                actual_s=0.02, blocked_s=0.001, iters_max=7,
                                iters_mean=5.0, kkt_max=1e-8, keep_fraction=0.4))
    for path in ("batch", "batch", "single"):
        log.add(obs.SolveRecord(bucket=(64, 32), form="penalized", batch=4, b_real=4,
                                route_path=path, modeled_s=0.0 if path == "single" else 0.03,
                                actual_s=0.05, blocked_s=0.0, iters_max=3, iters_mean=3.0,
                                kkt_max=0.0, keep_fraction=1.0))
    return log.residual_report(), len(log), log.recorded


def test_solve_log_matches_jax():
    assert _solve_log_ops(tobs) == _solve_log_ops(jobs)


def test_runtime_spans_and_terminal_accounting():
    """The port's scheduler records the span taxonomy of a request's life,
    reads its stats through its registry, and lands every request in
    exactly one terminal count; its launches on one device are priced by the
    router's estimate, on the "single" path."""
    X, y = problem(32, 16, seed=0, k_true=3)
    t = 0.2 * float(np.sum(np.abs(X.T @ y))) / 32
    sched = tsched.ContinuousScheduler(max_batch=2, max_wait=None, device="cpu")
    tracer = tobs.get_tracer()
    n0 = len(tracer.spans())
    tobs.enable_tracing()
    try:
        for i in range(4):
            sched.submit(X, y, t=t * (1 + 0.05 * i), lambda2=1.0)
        out = sched.drain()
    finally:
        tobs.disable_tracing()
    assert len(out) == 4
    reg = sched.registry
    assert sched.stats.requests == 4 == int(reg.counter("runtime_requests_total").total())
    assert sched.cache.hits + sched.cache.misses == int(
        reg.counter("cache_lookups_total", labelnames=("result",)).total())
    assert reg.counter("requests_terminal_total", labelnames=("status",)).value(status="ok") == 4
    names = {s[1] for s in tracer.spans()[n0:]}
    for expected in ("admit", "launch", "warm_start", "harvest.block", "complete"):
        assert expected in names, (expected, names)
    rep = sched.solve_log.residual_report()
    assert rep["n_records"] == 2 and rep["n_unmodeled"] == 0
    assert set(rep["by_path"]) == {"single"} and rep["by_path"]["single"]["n"] == 2


def test_port_runtime_takes_its_clocks_from_obs():
    """The JAX runtime's clock lint (reprolint TIM001: no bare `time.*`
    clock reads) applied to each file of `repro_torch/runtime`."""
    sys.path.insert(0, str(ROOT))
    try:
        from tools.reprolint import LintConfig, lint_source
    finally:
        sys.path.pop(0)
    findings = []
    for path in sorted((ROOT / "src" / "repro_torch" / "runtime").glob("*.py")):
        res = lint_source(path.read_text(), f"src/repro/runtime/{path.name}", LintConfig(),
                          ("TIM001",))
        findings += [f.render() for f in res.findings]
    assert findings == []
    assert tobs.clock.monotonic is __import__("time").perf_counter
