"""Port parity of the serving runtime: `repro_torch.runtime`,
`repro_torch.serve.ElasticNetEngine` and `repro_torch.launch.serve_en`
against `repro.runtime` / `repro.serve` on the same numpy inputs, the port
on `device="cpu"` (its kernels' plain float64 bodies).

Bounds: the scheduler's policy (launch triggers, priorities, requeue,
terminal statuses) gives equal `RuntimeStats` fields and terminal counts
under one fake clock; cold paths (`cache=None`, `drain_reference`, the
direct solves) lie within 1e-10 x max|beta| of JAX's; warm paths (the
default cache) within 1e-8 x, with equal cache hits and misses; the cache
gives equal hits, evictions and spills, and equal digests; `make_workload`
is byte for byte JAX's. Against the port's own direct solves the runtime
keeps JAX's test bound (1e-6, `tests/test_runtime.py`). The padded
batches' all-zero dummy lanes stay finite, zero and O(1) steps.
"""
import functools
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import npy, problem
from repro.core import api as japi
from repro.core import sven as j_sven
from repro.runtime import cache as jcache
from repro.runtime import loadgen as jloadgen
from repro.runtime import metrics as jmetrics
from repro.runtime import online as jonline
from repro.runtime import scheduler as jsched
from repro.serve import engine as jengine
from repro_torch.core import api as tapi
from repro_torch.core import sven as t_sven
from repro_torch.core.batch import sven_batch
from repro_torch.runtime import cache as tcache
from repro_torch.runtime import loadgen as tloadgen
from repro_torch.runtime import metrics as tmetrics
from repro_torch.runtime import online as tonline
from repro_torch.runtime import scheduler as tsched
from repro_torch.serve import engine as tengine

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-6        # the JAX runtime tests' bound against direct solves
COLD = 1e-10       # x max|beta|: cold paths against JAX's
WARM = 1e-8        # x max|beta|: warm-started paths against JAX's

#: each package's scheduler and engine, the port's on the CPU
PACKAGES = {
    "jax": (jsched.ContinuousScheduler, jengine.ElasticNetEngine, {}),
    "torch": (tsched.ContinuousScheduler, tengine.ElasticNetEngine, {"device": "cpu"}),
}


def _problem(n, p, seed=0):
    """The JAX tests' problem: (X, y, t) with t a fifth of |X^T y|_1 / n."""
    X, y = problem(n, p, seed=seed, k_true=max(3, p // 6))
    return X, y, 0.2 * float(np.sum(np.abs(X.T @ y))) / n


def _close(a, b, rel):
    a, b = npy(a), npy(b)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _stats(sched):
    """Every RuntimeStats field, the terminal counts, the completions and
    the solve records of a scheduler."""
    out = {k: getattr(sched.stats, k) for k in tsched._STAT_SPECS}
    out["terminal"] = dict(sched._terminal.series())
    out["completed"] = sched.metrics.completed_count
    out["solve_records"] = sched.solve_log.recorded
    return out


# ---------------------------------------------------------------------------
# scheduler policy under one fake clock
# ---------------------------------------------------------------------------

def _policy(name, pkg):
    """Run one policy scenario of tests/test_runtime.py on a package's
    scheduler; returns (what the scenario observed, the scheduler's stats)."""
    Sched, _, kw = PACKAGES[pkg]
    clock = FakeClock()

    def make(**k):
        return Sched(clock=clock, **kw, **k)

    X, y, t = _problem(20, 10, seed=3)
    seen = {}
    if name == "full_bucket":
        s = make(max_batch=4, max_wait=None)
        for i in range(4):
            s.submit(X, y, t=t * (1 + 0.01 * i), lambda2=1.0)
        seen["full"] = s.stats.launched_full
        seen["pending"] = [r.req_id for r in s.pending_requests]
        seen["harvested"] = sorted(s.harvest(block=True))
    elif name == "deadline":
        s = make(max_batch=64, max_wait=0.01)
        s.submit(X, y, t=t, lambda2=1.0)
        seen["before"] = s.stats.launched_deadline
        clock.t = 0.02
        s.poll()
        seen["after"] = s.stats.launched_deadline
        seen["harvested"] = sorted(s.harvest(block=True))
    elif name == "priority_overflow":
        s = make(max_batch=2, max_wait=None)
        low = s.submit(X, y, t=t, lambda2=1.0, priority=0)
        mid = s.submit(X, y, t=t * 1.1, lambda2=1.0, priority=1)
        hi = s.submit(X, y, t=t * 1.2, lambda2=1.0, priority=5)
        seen["pending"] = [r.req_id for r in s.pending_requests]
        seen["drained"] = sorted(s.drain())
        seen["ids"] = [low, mid, hi]
    elif name == "expired_not_stranded":
        s = make(max_batch=2, max_wait=0.01, auto_launch_full=False)
        low = s.submit(X, y, t=t, lambda2=1.0, priority=0)
        s.submit(X, y, t=t * 1.1, lambda2=1.0, priority=5)
        s.submit(X, y, t=t * 1.2, lambda2=1.0, priority=5)
        clock.t = 0.02
        s.poll()
        seen["pending"] = [r.req_id for r in s.pending_requests]
        seen["low_harvested"] = low in s.harvest(block=True)
    elif name == "dispatch_failure_requeues":
        s = make(max_batch=8, max_wait=None)
        rid = s.submit(X, y, t=t, lambda2=1.0)

        def boom(*a, **k):
            raise RuntimeError("boom")

        s._dispatch = boom
        with pytest.raises(RuntimeError, match="boom"):
            s.drain()
        seen["pending"] = [r.req_id for r in s.pending_requests]
        del s._dispatch
        out = s.drain()
        seen["beta"] = npy(out[rid].beta)
        seen["status"] = out[rid].status
    elif name == "requeue_rechecks_deadline":
        s = make(max_batch=8, max_wait=0.5)
        rid_live = s.submit(X, y, t=t, lambda2=1.0)
        rid_dead = s.submit(X, y, t=t * 1.1, lambda2=1.0, deadline=1.0)
        calls = []

        def boom(*a, **k):
            calls.append(1)
            raise RuntimeError("boom")

        s._dispatch = boom
        clock.t = 2.0
        with pytest.raises(RuntimeError, match="boom"):
            s.flush()
        del s._dispatch
        seen["pending"] = [r.req_id for r in s.pending_requests]
        for rid in (rid_dead, rid_live):
            res = s.result(rid)
            seen[f"status_{rid}"] = (res.status, res.beta is None)
        rid2 = s.submit(X, y, t=t, lambda2=1.0, deadline=100.0)
        s._dispatch = boom
        with pytest.raises(RuntimeError, match="boom"):
            s.flush()
        del s._dispatch
        seen["pending2"] = [r.req_id for r in s.pending_requests]
        out = s.drain()
        seen["status2"] = out[rid2].status
        seen["beta"] = npy(out[rid2].beta)
        seen["calls"] = len(calls)
    elif name == "validation":
        s = make()
        for kw_bad in ({"t": t, "lambda1": 1.0}, {}, {"lambda1": -1.0},
                       {"lambda1": 1.0, "lambda2": -1.0}, {"t": -1.0}):
            with pytest.raises(ValueError) as err:
                s.submit(X, y, **kw_bad)
            seen[str(sorted(kw_bad))] = str(err.value)
        with pytest.raises(ValueError) as err:
            s.submit(X, y[:-1], t=t)
        seen["shapes"] = str(err.value)
    elif name == "result_for_one_request":
        s = make(max_batch=8, max_wait=None)
        Xb, yb, tb = _problem(40, 20, seed=6)
        other = s.submit(X, y, t=t, lambda2=1.0)
        mine = s.submit(Xb, yb, t=tb, lambda2=2.0)
        seen["beta"] = npy(s.result(mine).beta)
        seen["pending"] = [r.req_id for r in s.pending_requests]
        seen["drained"] = sorted(s.drain())
        seen["ids"] = [other, mine]
    else:
        raise AssertionError(name)
    return seen, _stats(s)


POLICIES = ("full_bucket", "deadline", "priority_overflow", "expired_not_stranded",
            "dispatch_failure_requeues", "requeue_rechecks_deadline", "validation",
            "result_for_one_request")


@pytest.mark.parametrize("name", POLICIES)
def test_scheduler_policy_matches_jax(name):
    jseen, jstats = _policy(name, "jax")
    tseen, tstats = _policy(name, "torch")
    assert tstats == jstats
    assert set(tseen) == set(jseen)
    for key, want in jseen.items():
        if isinstance(want, np.ndarray):
            _close(tseen[key], want, COLD)
        else:
            assert tseen[key] == want, key


# ---------------------------------------------------------------------------
# mixed-form drains: runtime, reference and direct solves
# ---------------------------------------------------------------------------

#: tests/test_runtime.py's mixed-form problems: two share a bucket
MIXED = [(26, 12), (26, 12), (33, 17), (40, 9)]


@functools.lru_cache(maxsize=None)
def _mixed_items():
    items = []
    for s, (n, p) in enumerate(MIXED):
        X, y, t = _problem(n, p, seed=30 + s)
        lam1 = 0.35 * float(2.0 * np.max(np.abs(X.T @ y)))
        items.append((X, y, t, lam1, 0.5 + s))
    return items


def _submit_mixed(engine, scale=1.0):
    ids = []
    for X, y, t, lam1, lam2 in _mixed_items():
        ids.append((engine.submit(X, y, t * scale, lam2),
                    engine.submit_penalized(X, y, lam1 * scale, lam2)))
    return ids


@functools.lru_cache(maxsize=None)
def _mixed_drains(pkg):
    """(runtime waves at scales 1 and 1.04 with the default cache, the cold
    runtime drain, the reference drain), each {(item, form): (beta, iters)},
    and the warm engine's cache (hits, misses)."""
    _, Engine, kw = PACKAGES[pkg]

    def collect(out, ids):
        return {(i, f): (npy(out[rid].beta), int(np.asarray(out[rid].iters)))
                for i, pair in enumerate(ids) for f, rid in enumerate(pair)}

    warm = Engine(max_batch=8, **kw)
    waves = []
    for scale in (1.0, 1.04):
        ids = _submit_mixed(warm, scale)
        waves.append(collect(warm.drain(), ids))
    cold = Engine(max_batch=8, cache=None, **kw)
    ids = _submit_mixed(cold)
    cold_out = collect(cold.drain(), ids)
    ref = Engine(max_batch=8, cache=None, **kw)
    ids = _submit_mixed(ref)
    ref_out = collect(ref.drain_reference(), ids)
    return waves, cold_out, ref_out, (warm.cache.hits, warm.cache.misses), \
        _stats(warm.scheduler)


@functools.lru_cache(maxsize=None)
def _mixed_direct(pkg):
    out = {}
    for i, (X, y, t, lam1, lam2) in enumerate(_mixed_items()):
        if pkg == "jax":
            out[(i, 0)] = npy(j_sven(jnp.asarray(X), jnp.asarray(y), t, lam2).beta)
            out[(i, 1)] = npy(japi.enet(jnp.asarray(X), jnp.asarray(y), lam1, lam2).beta)
        else:
            Xt, yt = torch.tensor(X), torch.tensor(y)
            out[(i, 0)] = npy(t_sven(Xt, yt, t, lam2).beta)
            out[(i, 1)] = npy(tapi.enet(Xt, yt, lam1, lam2).beta)
    return out


@pytest.mark.parametrize("path", ("cold_runtime", "drain_reference", "direct"))
def test_cold_drains_match_jax(path):
    """cache=None through the runtime, the synchronous reference drain and
    the direct solves: each within 1e-10 x max|beta| of JAX's, Newton counts
    equal, and the runtime within 1e-6 of the port's direct solves."""
    pick = {"cold_runtime": lambda d: d[1], "drain_reference": lambda d: d[2]}
    if path == "direct":
        mine, theirs = _mixed_direct("torch"), _mixed_direct("jax")
        for key in theirs:
            _close(mine[key], theirs[key], COLD)
        return
    mine, theirs = pick[path](_mixed_drains("torch")), pick[path](_mixed_drains("jax"))
    direct = _mixed_direct("torch")
    for key, (beta, iters) in theirs.items():
        _close(mine[key][0], beta, COLD)
        assert mine[key][1] == iters, key
        np.testing.assert_allclose(mine[key][0], direct[key], rtol=0, atol=ATOL)


def test_warm_drains_match_jax_with_equal_cache_counts():
    """Two waves through the default cache (the second at 1.04 x the lambdas,
    warm-started): betas within 1e-8 x max|beta| of JAX's, the same cache
    hits and misses, every stats count and terminal count equal."""
    mine, theirs = _mixed_drains("torch"), _mixed_drains("jax")
    for wave_m, wave_j in zip(mine[0], theirs[0]):
        for key, (beta, _) in wave_j.items():
            _close(wave_m[key][0], beta, WARM)
    assert mine[3] == theirs[3]
    assert mine[3][0] > 0

    def counts(stats):       # solve_seconds is the engine's wall clock
        return {k: v for k, v in stats.items() if k != "solve_seconds"}

    assert counts(mine[4]) == counts(theirs[4])


def test_warm_resolve_same_solution_fewer_iters():
    """The serving property on the port: adjacent-lambda traffic re-solves
    warm to the same answer with no more Newton steps than cold."""
    X, y, t = _problem(48, 16, seed=8)
    cold = tsched.ContinuousScheduler(max_batch=4, max_wait=None, cache=None, device="cpu")
    warm = tsched.ContinuousScheduler(max_batch=4, max_wait=None, device="cpu")
    lams = [t, t * 1.05, t * 0.95, t * 1.02]
    cold_ids = [cold.submit(X, y, t=lam, lambda2=1.0) for lam in lams]
    cold_out = cold.drain()
    warm.submit(X, y, t=t, lambda2=1.0)
    warm.drain()
    warm_ids = [warm.submit(X, y, t=lam, lambda2=1.0) for lam in lams[1:]]
    warm_out = warm.drain()
    assert warm.cache.hits >= 3
    cold_iters = warm_iters = 0
    for wid, cid in zip(warm_ids, cold_ids[1:]):
        np.testing.assert_allclose(warm_out[wid].beta, cold_out[cid].beta, atol=ATOL)
        cold_iters += int(cold_out[cid].iters)
        warm_iters += int(warm_out[wid].iters)
    assert warm_iters <= cold_iters


def test_speculation_matches_jax():
    """A geometric crawl pre-solves its next point in a padding slot in both
    packages: the same speculative slots and hits, the same answers."""
    X, y, t = _problem(40, 12, seed=12)
    lams = [t, 0.8 * t, 0.8 * 0.8 * t]

    def crawl(pkg):
        Sched, _, kw = PACKAGES[pkg]
        s = Sched(max_batch=4, max_wait=None, speculate=True, clock=FakeClock(), **kw)
        betas = []
        for lam in lams:
            rid = s.submit(X, y, t=lam, lambda2=1.0)
            betas.append(npy(s.drain()[rid].beta))
        return betas, _stats(s), (s.cache.hits, s.cache.misses)

    tb, tstats, thits = crawl("torch")
    jb, jstats, jhits = crawl("jax")
    assert tstats == jstats and thits == jhits
    assert tstats["speculative_slots"] >= 1
    for a, b in zip(tb, jb):
        _close(a, b, WARM)


# ---------------------------------------------------------------------------
# padding: dummy lanes and zero rows / columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ("constrained", "penalized"))
def test_chunk_of_three_pads_one_dummy_lane(form):
    """Three requests of one bucket launch as a batch of 4: the all-zero
    dummy lane leaves every real lane within 1e-10 x of JAX's and within
    1e-6 of the port's unpadded direct solve."""
    probs = [_problem(26, 12, seed=60 + i) for i in range(3)]

    def run(pkg):
        _, Engine, kw = PACKAGES[pkg]
        eng = Engine(max_batch=4, cache=None, **kw)
        ids = []
        for X, y, t in probs:
            if form == "penalized":
                lam1 = 0.4 * float(2.0 * np.max(np.abs(X.T @ y)))
                ids.append(eng.submit_penalized(X, y, lam1, 1.0))
            else:
                ids.append(eng.submit(X, y, t, 1.0))
        out = eng.drain()
        assert eng.stats.padded_slots == 1 and eng.stats.batches == 1
        return [npy(out[rid].beta) for rid in ids]

    mine, theirs = run("torch"), run("jax")
    for i, (X, y, t) in enumerate(probs):
        _close(mine[i], theirs[i], COLD)
        Xt, yt = torch.tensor(X), torch.tensor(y)
        if form == "penalized":
            lam1 = 0.4 * float(2.0 * np.max(np.abs(X.T @ y)))
            direct = tapi.enet(Xt, yt, lam1, 1.0).beta
        else:
            direct = t_sven(Xt, yt, t, 1.0).beta
        np.testing.assert_allclose(mine[i], npy(direct), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode_shape", ((32, 16), (32, 64)))
def test_dummy_lanes_finite_zero_and_short(mode_shape):
    """An all-zero lane (X = 0, y = 0, t = lambda1 = lambda2 = 1), as the
    scheduler pads a launch with, in `sven_batch` and `enet_batch`, in the
    dual (32 x 16) and the primal (32 x 64): every output finite, beta 0,
    one Newton step (the constrained solve) and no Illinois evaluation (its
    lambda1 = 1 lies above its lambda1_max = 0), beside real lanes that keep
    their own solves."""
    bn, bp = mode_shape
    X, y = problem(20, min(bp, 10), seed=1)
    n, p = X.shape
    Xb = torch.zeros(4, bn, bp, dtype=torch.float64)
    yb = torch.zeros(4, bn, dtype=torch.float64)
    Xb[0, :n, :p] = Xb[1, :n, :p] = torch.tensor(X)
    yb[0, :n] = yb[1, :n] = torch.tensor(y)
    t = torch.tensor([1.0, 2.0, 1.0, 1.0], dtype=torch.float64)
    l2 = torch.tensor([1.0, 0.5, 1.0, 1.0], dtype=torch.float64)
    sol = sven_batch(Xb, yb, t, l2)
    assert sol.mode == ("dual" if 2 * bp <= bn else "primal")
    for f in (sol.beta, sol.alpha, sol.w, sol.kkt):
        assert bool(torch.isfinite(f).all())
    assert sol.iters[2:].tolist() == [1, 1]
    assert bool((sol.beta[2:] == 0).all()) and float(sol.kkt[2:].abs().max()) == 0.0
    for i in range(2):
        single = t_sven(Xb[i], yb[i], float(t[i]), float(l2[i]))
        _close(sol.beta[i], single.beta, COLD)
    l1 = torch.tensor([5.0, 3.0, 1.0, 1.0], dtype=torch.float64)
    pts, carry = tapi.enet_batch(Xb, yb, l1, l2, return_carry=True)
    assert pts.evals[2:] == (0, 0) and pts.sven_iters[2:] == (0, 0)
    for f in tuple(carry) + (pts.beta, pts.kkt, pts.nu):
        assert bool(torch.isfinite(f).all())
    assert bool((pts.beta[2:] == 0).all()) and pts.evals[0] > 0 and pts.evals[1] > 0


def _penalized_padding(n, p, lam_frac, lam2, pkg):
    X, y = problem(n, p, seed=50 + n, k_true=max(2, p // 4))
    lam1 = lam_frac * float(2.0 * np.max(np.abs(X.T @ y)))
    _, Engine, kw = PACKAGES[pkg]
    eng = Engine(min_n=16, min_p=8, cache=None, **kw)
    rid = eng.submit_penalized(X, y, lam1, lam2)
    res = eng.drain()[rid]
    return X, y, lam1, res


@pytest.mark.parametrize("n,p,lam_frac,lam2",
                         [(19, 7, 0.5, 1.0),    # pads rows and columns
                          (23, 11, 0.25, 0.5),  # pads both, light penalty
                          (32, 8, 0.6, 2.0)])   # exact-n bucket, pads p only
def test_penalized_padding_invariance(n, p, lam_frac, lam2):
    """tests/test_runtime.py's three cases on the port: the padded solve is
    the unpadded `enet` (1e-6, the same exact zeros) and JAX's padded solve
    (1e-10 x max|beta|)."""
    X, y, lam1, res = _penalized_padding(n, p, lam_frac, lam2, "torch")
    _, _, _, jres = _penalized_padding(n, p, lam_frac, lam2, "jax")
    bn, bp = res.bucket
    assert res.bucket == jres.bucket and (bn > n or bp > p or (bn, bp) == (n, p))
    ref = npy(tapi.enet(torch.tensor(X), torch.tensor(y), lam1, lam2).beta)
    assert res.beta.shape == (p,)
    np.testing.assert_allclose(res.beta, ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(res.beta == 0.0, ref == 0.0)
    _close(res.beta, jres.beta, COLD)


# ---------------------------------------------------------------------------
# warm-start cache
# ---------------------------------------------------------------------------

def _cache_ops(seed, n_ops=160, fps=("fp-a", "fp-b", "fp-c", "fp-d"),
               forms=(tcache.CONSTRAINED, tcache.PENALIZED),
               lams=(0.0, 1e-3, 0.5, 0.6, 1.0, 1.5, 2.7, 9.0)):
    """A seeded interleaving of inserts and lookups over a few fingerprints,
    forms and lambda points (the lambda = 0 edges included by default)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        op = "insert" if rng.random() < 0.45 else "lookup"
        ops.append((op, fps[rng.integers(len(fps))], forms[rng.integers(len(forms))],
                    float(lams[rng.integers(len(lams))]),
                    float(lams[rng.integers(1, len(lams))]), float(i)))
    return ops


def _play_op(cache, mod, op):
    """One cache operation; a lookup returns its served point (None on a
    miss)."""
    kind, fp, form, lam, lam2, tag = op
    if kind == "insert":
        cache.insert(fp, form, mod.WarmEntry(
            lam=lam, lambda2=lam2, alpha=np.zeros(8), w=np.zeros(6),
            beta=np.full(4, tag), t=lam, nu=0.0))
        return "inserted"
    e = cache.lookup(fp, form, lam, lam2)
    return None if e is None else (e.lam, e.lambda2, float(e.beta[0]))


def _counts(cache):
    return cache.hits, cache.misses, len(cache), len(cache._store)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_memory_cache_interleavings_match_jax(seed):
    ops = _cache_ops(seed)
    kw = dict(max_problems=3, per_problem=3, neighborhood=0.7)
    caches = [tcache.SolutionCache(**kw), jcache.SolutionCache(**kw)]
    for op in ops:
        assert _play_op(caches[0], tcache, op) == _play_op(caches[1], jcache, op), op
    assert _counts(caches[0]) == _counts(caches[1])


@pytest.mark.parametrize("seed", (0, 1))
def test_tiered_cache_interleavings_match_jax(tmp_path, seed):
    """The two-tier cache with a small spill bound, both packages in
    lockstep (each its own directory, one fake clock for the TTL): the same
    served points, hits, spill hits, evictions, expiries and files on disk.
    The spill tier evicts by file mtime, so the ops are a few ms apart: two
    files written in one tick of the file clock would tie."""
    ops = _cache_ops(seed, n_ops=80, fps=("fp-a", "fp-b", "fp-c"),
                     forms=(tcache.CONSTRAINED,), lams=(0.5, 0.6, 1.0, 1.5))
    clock = FakeClock(1000.0)
    tiers = []
    for mod in (tcache, jcache):
        spill = mod.PersistentCacheTier(tmp_path / mod.__name__, max_bytes=9000,
                                        ttl_s=30.0, clock=clock)
        tiers.append((mod, spill, mod.TieredSolutionCache(max_problems=2, per_problem=2,
                                                          neighborhood=0.7, spill=spill)))
    for i, op in enumerate(ops):
        if i % 20 == 0:
            clock.t += 40.0
        served = [_play_op(cache, mod, op) for mod, _, cache in tiers]
        assert served[0] == served[1], (i, op)
        time.sleep(0.012)
    outs = [(_counts(cache), cache.spill_hits, spill.evicted, spill.expired_dropped,
             sorted(f.name for f in (tmp_path / mod.__name__).glob("*.npz")))
            for mod, spill, cache in tiers]
    assert outs[0] == outs[1]
    assert outs[0][1] > 0 and outs[0][2] > 0 and outs[0][3] > 0


def test_fingerprint_digests_match_jax():
    X, y, _ = _problem(20, 10, seed=7)
    assert tcache.fingerprint_problem(X, y) == jcache.fingerprint_problem(X, y)
    X2 = X.copy()
    X2[0, 0] += 1e-12
    assert tcache.fingerprint_problem(X2, y) == jcache.fingerprint_problem(X2, y)
    assert tcache.fingerprint_problem(X2, y) != tcache.fingerprint_problem(X, y)
    # the runtime fingerprints what it stages: a tensor's host bytes
    assert tcache.fingerprint_problem(X, y) == tcache.fingerprint_problem(
        tsched._host_array(torch.tensor(X), np.float64), y)


# ---------------------------------------------------------------------------
# online rank-1 updates
# ---------------------------------------------------------------------------

def test_online_matches_jax_and_sven():
    """Blocks then single rows, a solve at t, then warm at 1.03 t: each
    solve within 1e-10 x max|beta| of JAX's (the same Newton counts) and
    within 1e-6 of the port's `sven` on the rows so far; the warm solve
    takes no more Newton steps than `sven` cold."""
    X, y, t = _problem(60, 12, seed=10)
    mine = tonline.OnlineElasticNet(p=12, device="cpu")
    theirs = jonline.OnlineElasticNet(p=12)
    checks = [(40, t), (60, t), (60, t * 1.03)]
    seen = 0
    for n_rows, tt in checks:
        if n_rows > seen:
            if seen == 0:
                mine.update(X[:n_rows], y[:n_rows])
                theirs.update(X[:n_rows], y[:n_rows])
            else:
                for i in range(seen, n_rows):       # rank-1 row arrivals
                    mine.update(X[i], y[i])
                    theirs.update(X[i], y[i])
            seen = n_rows
        s_m, s_j = mine.solve(tt, 1.0), theirs.solve(tt, 1.0)
        assert mine.n == theirs.n == n_rows
        _close(s_m.beta, s_j.beta, COLD)
        assert int(s_m.iters) == int(s_j.iters)
        np.testing.assert_allclose(float(s_m.kkt), float(s_j.kkt), rtol=0, atol=1e-10)
        direct = t_sven(torch.tensor(X[:n_rows]), torch.tensor(y[:n_rows]), tt, 1.0)
        np.testing.assert_allclose(npy(s_m.beta), npy(direct.beta), rtol=0, atol=ATOL)
    assert int(s_m.iters) <= int(direct.iters)


def test_online_validation():
    online = tonline.OnlineElasticNet(p=5, device="cpu")
    with pytest.raises(ValueError, match="no rows"):
        online.solve(1.0)
    with pytest.raises(ValueError, match="bad shapes"):
        online.update(np.zeros((3, 4)), np.zeros(3))
    with pytest.raises(ValueError, match="t > 0"):
        online.update(np.ones((2, 5)), np.ones(2)).solve(-1.0)


# ---------------------------------------------------------------------------
# loadgen, percentiles, latency summaries
# ---------------------------------------------------------------------------

LOAD_SPECS = (
    dict(n_requests=10, n_datasets=2, penalized_fraction=0.3,
         shapes=((20, 10), (30, 14)), seed=3),
    dict(n_requests=12, n_datasets=3, penalized_fraction=0.5, seed=4, data_seed=3,
         pattern="uniform", arrival_rate=50.0),
    dict(n_requests=8, n_datasets=1, shapes=((37, 90),), seed=0, data_seed=7),
)


@pytest.mark.parametrize("spec", range(len(LOAD_SPECS)))
def test_make_workload_byte_identical_to_jax(spec):
    kw = LOAD_SPECS[spec]
    mine = tloadgen.make_workload(tloadgen.LoadSpec(**kw))
    theirs = jloadgen.make_workload(jloadgen.LoadSpec(**kw))
    assert len(mine) == len(theirs) == kw["n_requests"]
    for a, b in zip(mine, theirs):
        assert (a.arrival, a.dataset, a.form, a.lam, a.lambda2, a.priority) == \
            (b.arrival, b.dataset, b.form, b.lam, b.lambda2, b.priority)
        assert a.X.tobytes() == np.asarray(b.X).tobytes()
        assert a.y.tobytes() == np.asarray(b.y).tobytes()
        assert tcache.fingerprint_problem(a.X, a.y) == jcache.fingerprint_problem(b.X, b.y)


def test_open_loop_completes_and_matches_direct():
    """tests/test_runtime.py's loadgen run on the port: every request done,
    each within 1e-6 of its direct solve."""
    w = tloadgen.make_workload(tloadgen.LoadSpec(**LOAD_SPECS[0]))
    sched = tsched.ContinuousScheduler(max_batch=4, max_wait=0.002, device="cpu")
    out = tloadgen.run_open_loop(sched, w)
    assert out["n_completed"] == 10 and len(out["results"]) == 10
    assert out["p99_latency_s"] >= out["p50_latency_s"] > 0
    for item, rid in zip(w, out["ids"]):
        X, y = torch.tensor(item.X), torch.tensor(item.y)
        ref = (tapi.enet(X, y, item.lam, item.lambda2).beta if item.form == "penalized"
               else t_sven(X, y, item.lam, item.lambda2).beta)
        np.testing.assert_allclose(out["results"][rid].beta, npy(ref), atol=ATOL)


@pytest.mark.parametrize("values", ([1.0, 2.0, 3.0, 4.0], [5.0], [0.3, -2.0, 7.5, 7.5, 1e-9]))
def test_percentile_matches_jax(values):
    for q in (0, 10, 50, 90, 99, 100):
        assert tmetrics.percentile(values, q) == jmetrics.percentile(values, q)
    with pytest.raises(ValueError):
        tmetrics.percentile([], 50)


def test_latency_recorder_summary_matches_jax():
    rng = np.random.default_rng(0)
    events = [(i, float(rng.uniform(0, 5)), float(rng.uniform(0, 0.2)),
               float(rng.uniform(0.01, 3))) for i in range(300)]
    summaries = []
    for mod in (tmetrics, jmetrics):
        rec = mod.LatencyRecorder()
        for rid, sub, wait, serve in events:
            rec.submitted(rid, sub)
            if rid % 7:
                rec.launched([rid], sub + wait)
            if rid % 11:
                rec.completed([rid], sub + wait + serve)
        rec.completed([999], 1.0)        # never submitted: untracked
        summaries.append((rec.summary((50.0, 90.0, 99.0, 99.9)), rec.open_count,
                          rec.completed_count))
    assert summaries[0] == summaries[1]


# ---------------------------------------------------------------------------
# the CLIs, the device rule and the port-only arguments
# ---------------------------------------------------------------------------

def test_runtime_cli_on_cpu(tmp_path):
    """`python -m repro_torch.runtime --device cpu`: two waves, the second
    adding no launch shape, with the telemetry artifacts schema-checked."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.runtime", "--device", "cpu", "--requests", "6",
         "--waves", "2", "--trace-out", str(tmp_path / "trace.json"), "--metrics-json",
         str(tmp_path / "metrics.json"), "--events-out", str(tmp_path / "events.jsonl")],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "steady state OK" in out.stdout and "none added after wave 0" in out.stdout
    assert (tmp_path / "trace.json").exists() and (tmp_path / "metrics.json").exists()


def test_serve_en_run_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve_en

    serve_en.run(["--device", "cpu", "--requests", "4", "--penalized", "1", "--waves", "2",
                  "--verify", "2", "--metrics-port", "0", "--metrics-json",
                  str(tmp_path / "m.json")])
    text = capsys.readouterr().out
    assert text.count("[serve_en] wave") == 2 and "[serve_en] done" in text
    assert (tmp_path / "m.json").exists()


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tsched.ContinuousScheduler(),
                 lambda: tengine.ElasticNetEngine(),
                 lambda: tonline.OnlineElasticNet(p=3)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloadgen.main(["--requests", "2", "--waves", "1"])
    assert tsched.ContinuousScheduler(device="cpu").device.type == "cpu"


def test_mesh_route_and_hosts_arguments():
    """A mesh is a `repro_torch.dist.Mesh`, "auto" or None; with no process
    group every one of them runs on one device. `--kill-host` names one of
    the `--hosts` (tests/test_torch_multihost.py runs them)."""
    from repro_torch import dist as tdist_mesh

    with pytest.raises(ValueError, match="mesh must be a repro_torch.dist.Mesh"):
        tsched.ContinuousScheduler(mesh="batch", device="cpu")
    with pytest.raises(ValueError, match="mesh must be a repro_torch.dist.Mesh"):
        tengine.ElasticNetEngine(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="route"):
        tsched.ContinuousScheduler(route="sharded", device="cpu")
    for mesh in ("auto", None, tdist_mesh.data_mesh(1)):
        for route in ("auto", "batch", "single"):
            assert tsched.ContinuousScheduler(mesh=mesh, route=route, device="cpu").mesh is None
    with pytest.raises(SystemExit):        # no host to kill
        tloadgen.main(["--kill-host", "0", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tloadgen.main(["--hosts", "2", "--kill-host", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="dtype"):
        tsched.ContinuousScheduler(dtype=torch.bfloat16, device="cpu")


def test_routed_launches_are_unpriced_and_harvest_waits_on_nothing_on_cpu():
    """A launch on one device is priced by the router's estimate (never
    measured on the admission path) and recorded on the "single" path; on
    the CPU a batch is ready as soon as it is dispatched."""
    from repro_torch.core import routing
    X, y, t = _problem(20, 10, seed=3)
    s = tsched.ContinuousScheduler(max_batch=2, max_wait=None, device="cpu")
    s.submit(X, y, t=t, lambda2=1.0)
    s.submit(X, y, t=t * 1.1, lambda2=1.0)
    assert s.in_flight_count == 0 and len(s._results) == 2   # harvested at poll
    rec = s.solve_log.records()[0]
    assert (rec.route_path, rec.batch, rec.b_real) == ("single", 2, 2)
    assert rec.modeled_s == routing.estimate_batch_seconds(32, 16, 2, device="cpu") > 0.0
    assert math.isfinite(rec.kkt_max)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_disk_cache_matches_jax(monkeypatch, tmp_path, writer):
    """`utils.cache_dir` / `disk_cache_load` / `disk_cache_update` keep JAX's
    REPRO_CACHE_DIR rule and file format: what one package writes the other
    reads, merges keep earlier keys, and a corrupt file or an unwritable
    directory degrades to "no cache" in both."""
    from repro import utils as jutils
    from repro_torch import utils as tutils
    mods = {"jax": jutils, "torch": tutils}
    w, r = mods[writer], mods["torch" if writer == "jax" else "jax"]
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "c"))
    assert tutils.cache_dir() == jutils.cache_dir() == tmp_path / "c"
    assert r.disk_cache_load("k") == w.disk_cache_load("k") == {}
    assert w.disk_cache_update("k", {"a": 1, "b": [2.5, "x"]})
    assert r.disk_cache_update("k", {"c": None})
    want = {"a": 1, "b": [2.5, "x"], "c": None}
    assert w.disk_cache_load("k") == r.disk_cache_load("k") == want
    assert sorted(os.listdir(tmp_path / "c")) == ["k.json"]     # no temp left
    (tmp_path / "c" / "bad.json").write_text("{not json")
    (tmp_path / "c" / "list.json").write_text("[1, 2]")
    for kind in ("bad", "list"):
        assert w.disk_cache_load(kind) == r.disk_cache_load(kind) == {}
    (tmp_path / "f").write_text("")               # a file where a directory goes
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "f" / "c"))
    assert tutils.cache_dir() is None and jutils.cache_dir() is None
    assert not w.disk_cache_update("k", {"a": 1}) and w.disk_cache_load("k") == {}
