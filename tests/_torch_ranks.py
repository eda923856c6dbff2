"""Rank functions of the port's multi-rank CPU tests (tests/test_torch_
distributed.py, tests/test_torch_routing.py), with the problems they solve.

`repro_torch.dist.launch` spawns each rank, which imports this module by
name: it imports torch, numpy and the port only (no JAX), so a rank starts
fast. Every rank runs the same calls; rank 0's results go back to the test,
which hands them to parametrized cases. The one-device references each case
is held to are solved inside the rank too, in the same process, so a
bitwise comparison sees the same thread count and the same code.
"""
import numpy as np
import torch

from repro_torch import dist
from repro_torch.core import distributed as tdist
from repro_torch.core import reduction as red
from repro_torch.core import routing
from repro_torch.core.api import enet_batch
from repro_torch.core.batch import en_grid, sven_batch
from repro_torch.core.cv import cross_validate
from repro_torch.core.sven import SvenConfig, sven
from repro_torch.data.synthetic import make_regression_numpy
from repro_torch.kernels.ref import hessian_matvec_ref, hinge_stats_ref

#: (n, p, seed, t, lambda2): a dual problem whose n the 4-rank mesh pads
#: (102 = 4 x 25 + 2) and a primal one (2p > n; 50 = 4 x 12 + 2)
DUAL = (102, 24, 0, 1.5, 1.0)
PRIMAL = (50, 64, 1, 0.8, 0.7)
#: a primal problem whose p = 121 no 2-rank mesh divides: the feature split
#: of `make_distributed_hessian_matvec` refuses it
INDIVISIBLE = (40, 121, 4, 0.8, 0.7)
#: the stacked batch of tests/test_dist_solve.py: B problems of (n, p)
BATCH = (8, 48, 12)
#: the CV problem: (n, p, seed, k, n_lambdas), and the k no mesh divides
CV = (64, 10, 3, 4, 6)
CV_NESTED_K = 5
#: the shapes and batches of the routing property (tests/test_dist_solve.py)
ROUTE_SHAPES = ((64, 8), (256, 16), (768, 48), (4096, 16), (32768, 8), (50, 64))


def problem(n, p, seed):
    """(X, y) float64 numpy arrays of the shared synthetic regression."""
    X, y, _ = make_regression_numpy(n, p, k_true=min(5, p), seed=seed)
    return X, y


def batch_problem():
    """The stacked batch: X (B, n, p), y (B, n), t (B,), lambda2 (B,),
    lambda1 (B,) as numpy arrays."""
    B, n, p = BATCH
    Xs, ys = zip(*(problem(n, p, 10 + i) for i in range(B)))
    return (np.stack(Xs), np.stack(ys), np.linspace(0.7, 1.8, B), np.linspace(0.5, 2.0, B),
            np.linspace(0.8, 0.2, B))


def hinge_w(n_pad):
    return np.random.default_rng(5).standard_normal(n_pad)


def hess_inputs(n, p):
    """(v, act) numpy arrays for one H v: v (n,), the (2p,) 0/1 act mask."""
    rng = np.random.default_rng(7)
    return rng.standard_normal(n), (rng.random(2 * p) < 0.5).astype(np.float64)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _fields(sol):
    return {"beta": sol.beta, "iters": sol.iters, "cg": sol.cg_iters}


def solves(mesh):
    """Every multi-rank case of tests/test_torch_distributed.py on `mesh`,
    each beside its one-device reference solved in this process."""
    out = {"size": mesh.size, "backend": mesh.backend}
    # -- sven_sharded, dual (padded rows) and primal, both backends ------
    for name, (n, p, seed, t, l2) in (("dual", DUAL), ("primal", PRIMAL)):
        X, y = map(_t, problem(n, p, seed))
        for cfg in (SvenConfig(), SvenConfig(backend="torch")):
            sh = tdist.sven_sharded(X, y, t, l2, cfg, mesh=mesh)
            one = sven(X, y, t, l2, cfg)
            out[f"sharded_{name}_{cfg.backend}"] = (_fields(sh), _fields(one), sh.mode)
        for route in ("auto", "single", "sharded"):
            out[f"routed_{name}_{route}"] = (
                routing.sven_routed(X, y, t, l2, mesh=mesh, route=route).beta,
                sven(X, y, t, l2).beta)
    # -- the feature-split primal (p = 64, divisible by 2 and 4) ---------
    n, p, seed, t, l2 = PRIMAL
    X, y = map(_t, problem(n, p, seed))
    C = red.svm_C(l2)
    v, act = map(_t, hess_inputs(n, p))
    out["hess_matvec"] = (tdist.make_distributed_hessian_matvec(mesh, X, y, t, C)(v, act),
                          hessian_matvec_ref(X, y, t, C, act[:p], act[p:], v))
    beta, _ = tdist.sven_primal_distributed(mesh, X, y, t, l2)
    out["primal_distributed"] = (beta, sven(X, y, t, l2).beta)
    # -- the Gram forms and the hinge stats on the dual problem ----------
    n, p, seed, t, _ = DUAL
    X, y = map(_t, problem(n, p, seed))
    Xp, yp = tdist.pad_rows(X, y, mesh.size)
    out["gram"] = {
        "distributed_gram": dist.gather(mesh, tdist.distributed_gram(mesh, X, y, t)),
        "distributed_gram_full": tdist.distributed_gram(mesh, X, y, t, row_shard_out=False),
        "distributed_gram_rs": dist.gather(mesh, tdist.distributed_gram_rs(mesh, X, y, t)),
        "distributed_gram_rs_syrk": dist.gather(mesh, tdist.distributed_gram_rs_syrk(
            mesh, X, y, t)),
        "distributed_gram_paper": tdist.distributed_gram_paper(mesh, X, y, t),
        "sharded_gram_stats": tdist.sharded_gram_stats(mesh, X, y, t),
        "gram_blocks": red.gram_blocks(X, y, t),
        "gram_reference": red.gram_reference(X, y, t),
        "labels": tdist.interleaved_labels(p, mesh.size),
    }
    w = _t(hinge_w(Xp.shape[0]))
    out["hinge_stats"] = (tdist.sharded_hinge_stats(mesh, X, y, t, w, 2.0),
                          hinge_stats_ref(Xp, yp, t, w, 2.0))
    # -- lane fan-out: stacked dual lanes, a shared-X primal grid, enet --
    Xb, yb, tb, l2b, l1b = map(_t, batch_problem())
    one = sven_batch(Xb, yb, tb, l2b)
    with dist.mesh_context(mesh):
        fan = sven_batch(Xb, yb, tb, l2b, route="batch")
        auto = sven_batch(Xb, yb, tb, l2b)
    out["sven_batch_stacked"] = (fan, one, auto)
    Xs, ys = map(_t, problem(*PRIMAL[:3]))
    ts, l2s = en_grid(_t([0.4, 0.6, 0.8, 1.0]), _t([0.5, 1.5]))
    one = sven_batch(Xs, ys, ts, l2s)
    with dist.mesh_context(mesh):
        fan = sven_batch(Xs, ys, ts, l2s, route="batch")
    out["sven_batch_shared"] = (fan, one, None)
    one_p, one_c = enet_batch(Xb, yb, l1b, l2b, return_carry=True)
    with dist.mesh_context(mesh):
        fan_p, fan_c = enet_batch(Xb, yb, l1b, l2b, return_carry=True, route="batch")
    out["enet_batch"] = ((fan_p, fan_c), (one_p, one_c))
    # -- fold fan-out, and the nested context whose k no mesh divides ----
    n, p, seed, k, L = CV
    Xc, yc = map(_t, problem(n, p, seed))
    out["cv"] = (cross_validate(Xc, yc, k=k, n_lambdas=L, mesh=mesh),
                 cross_validate(Xc, yc, k=k, n_lambdas=L, mesh=None))
    with dist.mesh_context(mesh):
        nested = cross_validate(Xc, yc, k=CV_NESTED_K, n_lambdas=L, mesh="auto")
    out["cv_nested"] = (nested, cross_validate(Xc, yc, k=CV_NESTED_K, n_lambdas=L,
                                               mesh=None))
    return out


def routes(mesh):
    """The routing property of tests/test_dist_solve.py on `mesh`: the
    calibration, each shape's routed and pinned decisions, each batch's."""
    cal = routing.calibrate(mesh)
    solve = {(n, p): (routing.route_solve(n, p, mesh=mesh),
                      routing.route_solve(n, p, mesh=mesh, route="single"),
                      routing.route_solve(n, p, mesh=mesh, route="sharded"))
             for n, p in ROUTE_SHAPES}
    batch = {(n, p, B): (routing.route_batch(n, p, B, mesh, form="penalized", points=8),
                         routing.route_batch(n, p, B, mesh, route="batch"))
             for n, p, B in ((48, 12, mesh.size), (256, 16, 2 * mesh.size), (64, 10, 64))}
    # a second calibrate is the cached one, on every rank alike
    return {"cal": cal, "again": routing.calibrate(mesh), "solve": solve, "batch": batch}


def serve(mesh):
    """One workload through `ContinuousScheduler` on `mesh` (auto: routed
    and priced; pinned: fanned out) and on one device."""
    from repro_torch.runtime import ContinuousScheduler, LoadSpec, make_workload

    spec = LoadSpec(n_requests=12, n_datasets=2, shapes=((24, 10), (32, 14)),
                    penalized_fraction=0.5, seed=11)
    out = {}
    for name, m in (("one", None), ("auto", "auto"), ("pinned", mesh)):
        sched = ContinuousScheduler(max_batch=4, max_wait=None, cache=None, mesh=m,
                                    device="cpu")
        ids = []
        for item in make_workload(spec):
            kw = {"lambda1": item.lam} if item.form == "penalized" else {"t": item.lam}
            ids.append(sched.submit(item.X, item.y, lambda2=item.lambda2, **kw))
        res = sched.drain()
        out[name] = ([res[i].beta for i in ids], sched.solve_log.records())
    out["refused"] = refused_triggers(mesh)
    return out


def refused_triggers(mesh):
    """The messages with which a multi-rank scheduler refuses clock-driven
    launches (max_wait, a request's deadline) and speculation, auto and
    pinned; None where nothing was refused."""
    from repro_torch.runtime import ContinuousScheduler

    def message(make):
        try:
            make()
        except ValueError as e:
            return str(e)
        return None

    X, y = problem(24, 10, 3)
    out = []
    for m in ("auto", mesh):
        out.append(message(lambda: ContinuousScheduler(max_wait=0.01, mesh=m, device="cpu")))
        out.append(message(lambda: ContinuousScheduler(max_wait=None, speculate=True, mesh=m,
                                                       device="cpu")))
        sched = ContinuousScheduler(max_wait=None, mesh=m, device="cpu")
        out.append(message(lambda: sched.submit(X, y, t=1.0, deadline=1.0)))
    return out


def indivisible_p(mesh):
    """Both feature-split calls at a p the mesh does not divide: each rank
    notes whether each call raised ValueError, and the notes are gathered
    (an all-reduce every rank reaches only if none of them hung). Returns
    (the notes of every rank, in rank order; one message)."""
    n, p, seed, t, l2 = INDIVISIBLE
    X, y = map(_t, problem(n, p, seed))
    raised, message = [], None
    for call in (lambda: tdist.make_distributed_hessian_matvec(mesh, X, y, t, red.svm_C(l2)),
                 lambda: tdist.sven_primal_distributed(mesh, X, y, t, l2)):
        try:
            call()
            raised.append(0.0)
        except ValueError as e:
            raised.append(1.0)
            message = str(e)
    return dist.gather(mesh, torch.tensor(raised, dtype=torch.float64)).tolist(), message


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits in an all-reduce that never completes."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return dist.all_reduce(mesh, torch.ones(1))


def stall_rank_1(mesh):
    """Rank 1 never joins rank 0's all-reduce."""
    import time

    if mesh.rank == 1:
        time.sleep(600)
    return dist.all_reduce(mesh, torch.ones(1))


def routing_cases(mesh):
    """Every multi-rank case of tests/test_torch_routing.py on `mesh`."""
    return {"size": mesh.size, "routes": routes(mesh), "serve": serve(mesh)}
