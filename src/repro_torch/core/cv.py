"""K-fold cross-validation of the penalized Elastic Net.

PyTorch counterpart of `repro/core/cv.py`. glmnet's `cv.glmnet` loops
folds one after another; here the k held-out training problems are
stacked by `core.batch.cv_folds`, and the (lambda grid x fold) surface is
solved fold chunk by fold chunk: each chunk walks the grid with
`core.api._enet_point_lanes` on its folds as lanes, every lane carrying its
own warm (beta, alpha, w, t, nu) state down the path. JAX compiles this as
one `lax.scan` over the grid whose body vmaps `_enet_point` over the folds;
here the scan is a host loop and the vmap the lane-batched root-find: each
lane keeps its own Illinois bracket on the host, and each evaluation solves
the folds still running in one lane-batched solve (on the kernel path, one
launch of each hinge pass per CG step for all of them, or one Gram per
fold). Every fold is bitwise its sequential path, so the surface does not
depend on the chunk size (tested).

`cross_validate` selects lambda by mean held-out MSE and refits on the full
data (`_enet_point`, as `enet` solves it). `cross_validate_reference` keeps
the glmnet-style sequential per-fold loop as the testable reference
(identical fold splits, identical grid).

The stacked fold axis is the "batch" axis the mesh rules split: with a
`repro_torch.dist` mesh (`_resolve_cv_mesh`) each rank walks the grid on
its own block of folds with no collective (`_enet_cv_scan_sharded`), and the
(L, k) surface is gathered in fold order; each fold is bitwise its
one-device path, so the surface is the same bits with or without the mesh.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core import api
from repro_torch.core.batch import cv_folds
from repro_torch.core.sven import _operands
from repro_torch.core.svm.state import host_float, host_list, pitched


def _auto_fold_chunk(k: int, device: torch.device, mesh=None) -> int:
    """How many folds advance together, keyed on where the folds are PLACED:
    all k when a mesh of more than one rank carries the fold axis (each
    rank then advances its own k / W) or on a CUDA device (one launch of
    each hinge pass per CG step for them all), 1 on the CPU, where the folds
    run one after another (`repro/core/cv.py::_auto_fold_chunk`). `mesh`
    must be the RESOLVED placement (`_resolve_cv_mesh`)."""
    if mesh is not None and mesh.size > 1:
        return k
    return k if device.type == "cuda" else 1


def _resolve_cv_mesh(mesh, k: int, n_tr: Optional[int] = None, p: Optional[int] = None,
                     points: int = 1):
    """mesh="auto" -> the innermost `dist.mesh_context`, else the process
    group's data mesh (one rank when there is none), else None; a mesh
    whose size does not divide k gives None (one device). An auto-resolved
    mesh is an OFFER: with the fold problem's shape (`n_tr`, `p`, `points`
    grid points a lane) the `core.routing` cost model prices it, and a
    single device that would finish sooner declines it. An EXPLICIT mesh
    pins the placement."""
    auto = isinstance(mesh, str) and mesh == "auto"
    if auto:
        ctx = dist.current_context()
        mesh = ctx[0] if ctx is not None else dist.data_mesh()
    if mesh is not None and (mesh.size <= 1 or k % mesh.size != 0):
        return None
    if auto and mesh is not None and n_tr is not None and p is not None:
        from repro_torch.core import routing
        decision = routing.route_batch(n_tr, p, k, mesh, form="penalized", points=points)
        if decision.path != "batch":
            return None
    return mesh


def _place_folds(mesh, *arrays):
    """This rank's block of each stacked array's leading (fold) axis, through
    the one batch-axis placement (`core.batch._maybe_shard_batch`); the rules
    come from the active context when it carries this mesh."""
    from repro_torch.core.batch import _maybe_shard_batch

    ctx = dist.current_context()
    rules = ctx[1] if ctx is not None and ctx[0] is mesh else dict(dist.DEFAULT_RULES)
    return tuple(_maybe_shard_batch(a, True, (mesh, rules)) for a in arrays)


def _enet_cv_scan_sharded(Xtr, ytr, Xva, yva, lambda1s: list, lambda2: float,
                          config: api.PathConfig, fold_chunk: int, mesh):
    """Rank-parallel CV: each rank runs `_enet_cv_scan` on ITS OWN block of
    folds with no collective (the solver loops never meet across ranks), and
    the (L, k) surface is gathered in fold order. `fold_chunk` is the
    PER-RANK lockstep width."""
    local = _enet_cv_scan(*_place_folds(mesh, Xtr, ytr, Xva, yva), lambda1s, lambda2,
                          config, fold_chunk)
    return tuple(dist.gather(mesh, a.T.contiguous()).T for a in local)


def _enet_cv_scan(Xtr, ytr, Xva, yva, lambda1s: list, lambda2: float,
                  config: api.PathConfig, fold_chunk: Optional[int] = None):
    """The (L,) grid over fold chunks; returns each point's CV diagnostics.

    Folds are solved `fold_chunk` at a time (None = all k at once): each
    chunk walks the grid (`lambda1s`, host floats) from cold starts with
    `_enet_point_lanes` on its folds, or `_enet_point` when the chunk is one
    fold, carrying its warm state. Returns (mse, n_kept, evals), each
    (L, k); a fold's held-out MSE is that of its own beta. `config.solver`
    must be resolved.
    """
    k = Xtr.shape[0]
    c = k if fold_chunk is None else fold_chunk
    if k % c:
        raise ValueError(f"_enet_cv_scan: fold_chunk={c} must divide k={k}")
    L = len(lambda1s)
    Xtr, ytr, Xva, yva = (pitched(a) for a in (Xtr, ytr, Xva, yva))
    mse = [[None] * k for _ in range(L)]
    n_kept = [[None] * k for _ in range(L)]
    evals = [[0] * k for _ in range(L)]

    def record(j, f, beta, kept, n_evals):
        resid = Xva[f] @ beta - yva[f]
        mse[j][f], n_kept[j][f], evals[j][f] = torch.mean(resid * resid), kept, n_evals

    for g in range(0, k, c):
        if c == 1:
            Xf, yf = Xtr[g], ytr[g]
            carry = api.cold_carry(Xf, yf)
            for j, lam1 in enumerate(lambda1s):
                carry, pt = api._enet_point(Xf, yf, lam1, lambda2, carry, config)
                record(j, g, pt.beta, pt.n_kept, pt.evals)
            continue
        Xc, yc = Xtr[g:g + c], ytr[g:g + c]
        carry = api._cold_carry_lanes(Xc, yc, c)
        for j, lam1 in enumerate(lambda1s):
            carry, pts = api._enet_point_lanes(Xc, yc, [lam1] * c, [lambda2] * c, carry,
                                               config)
            betas = pitched(pts.beta)
            for a in range(c):
                record(j, g + a, betas[a], pts.n_kept[a], pts.evals[a])
    return (torch.stack([torch.stack(row) for row in mse]),
            torch.stack([torch.stack(row) for row in n_kept]),
            torch.tensor(evals, device=Xtr.device))


class CVResult(NamedTuple):
    lambda1s: torch.Tensor    # (L,) descending grid
    lambda2: float
    mse_path: torch.Tensor    # (L, k) held-out MSE per grid point and fold
    mean_mse: torch.Tensor    # (L,)
    lambda_min: float         # grid point minimizing mean CV MSE
    index_min: int
    beta: torch.Tensor        # (p,) full-data refit at lambda_min (orig scale)
    intercept: torch.Tensor
    n_kept: torch.Tensor      # (L, k) screened problem sizes
    evals: torch.Tensor       # (L, k) SVEN solves per (lambda, fold)


def _prepare(X, y, lambda1s, n_lambdas, eps, standardize, fit_intercept):
    """(Xs, ys, scaler, lambda1s) on the full data, as both CV entry points see
    them: the statistics and the grid computed once (as cv.glmnet does)."""
    X, y = _operands(X, y)
    Xs, ys, scaler = api.standardize_fit(X, y, standardize=standardize,
                                         fit_intercept=fit_intercept)
    if lambda1s is None:
        lambda1s = api.lambda_grid(Xs, ys, n_lambdas=n_lambdas, eps=eps)
    if not isinstance(lambda1s, torch.Tensor):
        lambda1s = torch.tensor(np.asarray(lambda1s, dtype=np.float64))
    return Xs, ys, scaler, lambda1s.to(dtype=X.dtype, device=X.device)


def cross_validate(X, y, *, k: int = 5, lambda1s=None, n_lambdas: int = 40,
                   eps: Optional[float] = None, lambda2=1.0,
                   standardize: bool = True, fit_intercept: bool = True,
                   fold_chunk: Optional[int] = None, mesh="auto",
                   config: api.PathConfig = api.PathConfig()) -> CVResult:
    """K-fold CV over the lambda grid, batched across folds; refit at the min.

    Standardization statistics and the grid are computed once on the full
    data (so every fold sees the same grid, as cv.glmnet does); held-out MSE
    is measured in the centered space, which equals original-space MSE
    because the scaler is global.

    `fold_chunk` sets how many folds advance together (must divide k); the
    default is all k on a CUDA device or over a mesh, 1 on the CPU
    (`_auto_fold_chunk`). Any chunk gives the same bits. On the mesh path
    the chunk applies PER RANK (each holds k / W folds); an explicit chunk
    the local block cannot honor exactly declines the mesh rather than
    being overridden. Runs where X lies (array-likes go to the CUDA device).

    `mesh` places the stacked fold axis over the ranks: a
    `repro_torch.dist.Mesh` pins it, "auto" resolves the innermost
    `dist.mesh_context` or the process group (priced by the cost model),
    None is one device; a mesh whose size does not divide k declines
    (`_resolve_cv_mesh`). Every rank calls this alike and gets the same
    result, the same bits as with one device.
    """
    if not (mesh is None or isinstance(mesh, dist.Mesh) or mesh == "auto"):
        raise ValueError(f"cross_validate: mesh must be a repro_torch.dist.Mesh, 'auto' or "
                         f"None, got {mesh!r}")
    Xs, ys, scaler, lambda1s = _prepare(X, y, lambda1s, n_lambdas, eps, standardize,
                                        fit_intercept)
    n_tr = (Xs.shape[0] // k) * (k - 1)          # rows per training fold
    mesh = _resolve_cv_mesh(mesh, k, n_tr, Xs.shape[1], points=int(lambda1s.shape[0]))
    explicit_chunk = fold_chunk is not None
    if fold_chunk is None:
        fold_chunk = _auto_fold_chunk(k, Xs.device, mesh)
    if k % fold_chunk:
        raise ValueError(f"cross_validate: fold_chunk={fold_chunk} must divide k={k}")
    chunk_local = fold_chunk
    if mesh is not None:
        k_local = k // mesh.size
        if not explicit_chunk:
            chunk_local = k_local
        elif fold_chunk > k_local or k_local % fold_chunk:
            mesh = None
    config = api.resolve_path_config(config, Xs, ys)
    lam1s, lam2 = host_list(lambda1s), float(lambda2)
    Xtr, ytr, Xva, yva = cv_folds(Xs, ys, k)
    if mesh is not None:
        mse, n_kept, evals = _enet_cv_scan_sharded(Xtr, ytr, Xva, yva, lam1s, lam2, config,
                                                   chunk_local, mesh)
    else:
        mse, n_kept, evals = _enet_cv_scan(Xtr, ytr, Xva, yva, lam1s, lam2, config,
                                           fold_chunk)
    del Xtr, ytr, Xva, yva
    mean_mse = torch.mean(mse, dim=1)
    i_min = int(host_float(torch.argmin(mean_mse)))
    lambda_min = lam1s[i_min]

    _, pt = api._enet_point(Xs, ys, lambda_min, lam2, api.cold_carry(Xs, ys), config)
    beta, intercept = api.unscale_coef(pt.beta, scaler)
    return CVResult(lambda1s=lambda1s, lambda2=lam2, mse_path=mse, mean_mse=mean_mse,
                    lambda_min=lambda_min, index_min=i_min, beta=beta, intercept=intercept,
                    n_kept=n_kept, evals=evals)


def cross_validate_reference(X, y, *, k: int = 5, lambda1s=None,
                             n_lambdas: int = 40, eps: Optional[float] = None,
                             lambda2=1.0, standardize: bool = True,
                             fit_intercept: bool = True,
                             config: api.PathConfig = api.PathConfig(),
                             with_counts: bool = False):
    """Sequential per-fold loop (cv.glmnet's shape): the batched CV's oracle.

    Same splits, same full-data grid and scaler; each fold runs its own
    path (`enet_path`'s loop). Returns (lambda1s, mse_path (L, k)); with
    `with_counts` also n_kept and evals (L, k), as `CVResult` has them.
    """
    Xs, ys, _, lambda1s = _prepare(X, y, lambda1s, n_lambdas, eps, standardize,
                                   fit_intercept)
    config = api.resolve_path_config(config, Xs, ys)
    lam1s = host_list(lambda1s)
    Xtr, ytr, Xva, yva = cv_folds(Xs, ys, k)
    cols, kept, evals = [], [], []
    for i in range(k):
        pts = api._path_points(Xtr[i], ytr[i], lam1s, float(lambda2), config)
        resid = torch.stack([pt.beta for pt in pts]) @ Xva[i].T - yva[i][None, :]  # (L, fold)
        cols.append(torch.mean(resid * resid, dim=1))
        kept.append(torch.stack([pt.n_kept for pt in pts]))
        evals.append([pt.evals for pt in pts])
    mse = torch.stack(cols, dim=1)
    if not with_counts:
        return lambda1s, mse
    return (lambda1s, mse, torch.stack(kept, dim=1),
            torch.tensor(evals, device=Xs.device).T)


class ElasticNetCV:
    """sklearn-style K-fold CV estimator over the batched SVEN front end.

    After `fit`: `coef_`, `intercept_`, `lambda_min_`, `lambda1s_`,
    `mse_path_` (L, k), `mean_mse_` and `cv_result_` (the whole `CVResult`).
    """

    def __init__(self, k: int = 5, n_lambdas: int = 40,
                 eps: Optional[float] = None, lambda2: float = 1.0, *,
                 standardize: bool = True, fit_intercept: bool = True,
                 mesh="auto", config: api.PathConfig = api.PathConfig()):
        self.k = k
        self.n_lambdas = n_lambdas
        self.eps = eps
        self.lambda2 = lambda2
        self.standardize = standardize
        self.fit_intercept = fit_intercept
        self.mesh = mesh
        self.config = config

    def fit(self, X, y):
        res = cross_validate(X, y, k=self.k, n_lambdas=self.n_lambdas,
                             eps=self.eps, lambda2=self.lambda2,
                             standardize=self.standardize,
                             fit_intercept=self.fit_intercept,
                             mesh=self.mesh, config=self.config)
        self.coef_ = res.beta
        self.intercept_ = res.intercept
        self.lambda_min_ = res.lambda_min
        self.lambda1s_ = res.lambda1s
        self.mse_path_ = res.mse_path
        self.mean_mse_ = res.mean_mse
        self.cv_result_ = res
        return self

    def predict(self, X):
        X = torch.as_tensor(X, dtype=self.coef_.dtype, device=self.coef_.device)
        return X @ self.coef_ + self.intercept_
