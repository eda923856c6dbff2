"""glmnet-parity penalized front end over the SVEN engine.

The SVEN reduction solves the *constrained* Elastic Net (t, lambda2); glmnet
and the paper's comparison solve the *penalized* form (lambda1, lambda2)
along a lambda grid. PyTorch counterpart of `repro/core/api.py`:

  - `lambda_grid`: `n_lambdas` points geometrically spaced from lambda1_max
    (the smallest lambda with beta = 0) down to eps * lambda1_max.
  - `penalized_from_glmnet` / `penalized_to_glmnet` / `penalized_from_sklearn`
    convert those libraries' parameters into the paper's (lambda1, lambda2).
  - `standardize_fit` / `unscale_coef`: glmnet-style column standardization
    and intercept centering with an exact round trip.
  - `enet` / `enet_path` map each penalized (lambda1, lambda2) onto the
    constrained engine through t = |beta*|_1: the L1 multiplier
    nu(t) = max_j |g_j(beta(t))| is piecewise linear and decreasing in t, so
    the t* with nu(t*) = lambda1 is found by a guarded Illinois (modified
    regula falsi) iteration whose every evaluation is one warm-started
    `_sven_core` solve, on a gap-safe screened X (`core/screening.py`).
  - `ElasticNet`: the sklearn-style fit/predict wrapper.

JAX runs the root-find as a `lax.while_loop` and the path as one `lax.scan`;
here both are host loops with the same arithmetic, stops and endpoint
halving. The bracket scalars (t, f = nu - lambda1) are host floats, so each
evaluation reads nu back once (`host_float`, counted in `host_bool.syncs`).
Every evaluation runs the solver's kernels: on a CUDA tensor with the
default backend, the Gram kernel (dual) or the hinge kernels (primal).
`enet_batch`, `core/cv.py` and `ElasticNetCV` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import elastic_net as en
from repro_torch.core.screening import gap_safe_screen
from repro_torch.core.sven import SvenConfig, _operands, _sven_core, resolve_backend
from repro_torch.core.svm.state import host_float


# ---------------------------------------------------------------------------
# Scaling conventions: paper <-> glmnet <-> sklearn
# ---------------------------------------------------------------------------

def penalized_from_glmnet(lam, alpha, n: int) -> Tuple[float, float]:
    """glmnet (lambda, alpha) -> paper-scaled (lambda1, lambda2).

    glmnet minimizes 1/(2n) ||y - X b||^2 + lam * (alpha |b|_1
    + (1-alpha)/2 ||b||^2); multiplying by 2n (argmin-invariant) gives the
    paper objective with lambda1 = 2 n lam alpha, lambda2 = n lam (1-alpha).
    """
    return 2.0 * n * lam * alpha, n * lam * (1.0 - alpha)


def penalized_to_glmnet(lambda1, lambda2, n: int) -> Tuple[float, float]:
    """Inverse of `penalized_from_glmnet` (lambda1 + lambda2 must be > 0)."""
    la, lr = lambda1 / (2.0 * n), lambda2 / n
    lam = la + lr
    return lam, la / lam


def penalized_from_sklearn(alpha, l1_ratio, n: int) -> Tuple[float, float]:
    """sklearn ElasticNet (alpha, l1_ratio) -> paper-scaled (lambda1, lambda2).

    sklearn's objective is glmnet's with lambda = alpha, alpha = l1_ratio.
    """
    return penalized_from_glmnet(alpha, l1_ratio, n)


def lambda_grid(X: torch.Tensor, y: torch.Tensor, n_lambdas: int = 40,
                eps: Optional[float] = None) -> torch.Tensor:
    """The standard glmnet grid: geometric from lambda1_max to eps*lambda1_max.

    eps defaults to glmnet's: 1e-2 when p > n, else 1e-4. The first point is
    exactly lambda1_max, where the solution is identically zero.
    """
    n, p = X.shape
    if eps is None:
        eps = 1e-2 if p > n else 1e-4
    l1max = en.lambda1_max(X, y)
    return l1max * torch.as_tensor(np.geomspace(1.0, eps, n_lambdas), dtype=X.dtype,
                                   device=X.device)


# ---------------------------------------------------------------------------
# Standardization / intercept round trip
# ---------------------------------------------------------------------------

class Scaler(NamedTuple):
    """Column/response statistics needed to un-scale a standardized fit."""

    x_mean: torch.Tensor   # (p,)
    x_scale: torch.Tensor  # (p,)
    y_mean: torch.Tensor   # ()


def standardize_fit(X: torch.Tensor, y: torch.Tensor, *, standardize: bool = True,
                    fit_intercept: bool = True):
    """Center/scale (X, y) glmnet-style; returns (Xs, ys, Scaler).

    With fit_intercept, columns and the response are mean-centered so the
    (unpenalized) intercept drops out of the optimization; with standardize,
    columns are scaled to unit 1/n-variance (constant columns keep scale 1).
    """
    p = X.shape[1]
    if fit_intercept:
        x_mean = torch.mean(X, dim=0)
        y_mean = torch.mean(y)
    else:
        x_mean = X.new_zeros(p)
        y_mean = X.new_zeros(())
    Xc = X - x_mean
    if standardize:
        sd = torch.sqrt(torch.mean(Xc * Xc, dim=0))
        x_scale = torch.where(sd > 0, sd, torch.ones_like(sd))
    else:
        x_scale = X.new_ones(p)
    return Xc / x_scale, y - y_mean, Scaler(x_mean, x_scale, y_mean)


def unscale_coef(beta_std: torch.Tensor, scaler: Scaler):
    """Standardized-space coefficients -> original-scale (beta, intercept).

    Works for a single (p,) vector or a stacked (L, p) path.
    """
    beta = beta_std / scaler.x_scale
    intercept = scaler.y_mean - beta @ scaler.x_mean
    return beta, intercept


# ---------------------------------------------------------------------------
# The penalized point solver: multiplier root-find over the constrained engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Settings of the penalized front end. The solver's default backend is
    the port's "auto": the CUDA kernels on a CUDA tensor."""

    solver: SvenConfig = SvenConfig(tol=1e-10)
    screen: bool = True        # fuse gap_safe_screen keep-masks into each point
    max_evals: int = 30        # Illinois iterations == SVEN solves per point
    t_floor_rel: float = 1e-7  # smallest bracketed t, relative to |ridge|_1
    f_rtol: float = 1e-9       # |nu - lambda1| stop, relative to lambda1_max


def resolve_path_config(config: PathConfig, *tensors) -> PathConfig:
    """Pin the nested SvenConfig's "auto" backend to the operands' device
    (see `core.sven.resolve_backend`); a no-op for "torch"."""
    solver = resolve_backend(config.solver, *tensors)
    if solver is config.solver:
        return config
    return dataclasses.replace(config, solver=solver)


class EnetCarry(NamedTuple):
    """Warm state threaded across lambda points."""

    beta: torch.Tensor   # (p,)  last solution (screening warm point)
    alpha: torch.Tensor  # (2p,) dual warm start
    w: torch.Tensor      # (n,)  primal warm start
    t: torch.Tensor      # ()    L1 budget of the last solution
    nu: torch.Tensor     # ()    multiplier measured at (t, beta)


class EnetPoint(NamedTuple):
    """Per-lambda solve result (standardized space)."""

    beta: torch.Tensor    # (p,)
    t: torch.Tensor       # |beta|_1 — the constrained budget this maps to
    nu: torch.Tensor      # measured L1 multiplier (== lambda1 at the root)
    kkt: torch.Tensor     # Elastic Net KKT violation at beta
    keep: torch.Tensor    # (p,) gap-safe mask used for this point
    n_kept: torch.Tensor  # surviving columns
    gap: torch.Tensor     # duality gap at the screening warm point
    evals: int            # Illinois iterations spent (== SVEN solves)
    sven_iters: int       # total outer solver iterations across evals
    cg_iters: int         # total inner CG iterations across evals


def cold_carry(X: torch.Tensor, y: torch.Tensor) -> EnetCarry:
    """Zero warm state; nu(0) = lambda1_max is the exact multiplier at 0."""
    n, p = X.shape
    return EnetCarry(beta=X.new_zeros(p), alpha=X.new_zeros(2 * p), w=X.new_zeros(n),
                     t=X.new_zeros(()), nu=en.lambda1_max(X, y).to(X.dtype))


def _ridge_l1(X: torch.Tensor, y: torch.Tensor, lambda2: float) -> torch.Tensor:
    """|beta_ridge(lambda2)|_1 — the analytic top of the t bracket.

    For t >= this, the L1 constraint is slack so nu(t) = 0. Solved in the
    cheaper of the (p, p) primal or (n, n) dual normal equations; lambda2 is
    floored so the Lasso limit returns the min-norm least-squares point.
    """
    n, p = X.shape
    lam = max(float(lambda2), 1e-8)
    if p <= n:
        eye = torch.eye(p, dtype=X.dtype, device=X.device)
        b = torch.linalg.solve(X.T @ X + lam * eye, X.T @ y)
    else:
        eye = torch.eye(n, dtype=X.dtype, device=X.device)
        b = X.T @ torch.linalg.solve(X @ X.T + lam * eye, y)
    return torch.sum(torch.abs(b))


def _enet_point(X: torch.Tensor, y: torch.Tensor, lambda1: float, lambda2: float,
                carry: EnetCarry, config: PathConfig):
    """Solve one penalized (lambda1, lambda2) point on the constrained engine.

    `config.solver` must be resolved (`resolve_path_config`). Returns
    (next_carry, EnetPoint).
    """
    p = X.shape[1]
    dtype = X.dtype
    lambda1, lambda2 = float(lambda1), float(lambda2)

    if config.screen:
        scr = gap_safe_screen(X, y, carry.beta, lambda1, lambda2)
        keep, gap = scr.keep, scr.gap
    else:
        keep = torch.ones(p, dtype=torch.bool, device=X.device)
        gap = X.new_zeros(())
    keepf = keep.to(dtype)
    Xm = X * keepf[None, :]

    l1max_m = host_float(2.0 * torch.max(torch.abs(Xm.T @ y)))
    t_ridge = host_float(_ridge_l1(Xm, y, lambda2))
    t_floor = config.t_floor_rel * t_ridge + 1e-30
    ftol = config.f_rtol * max(l1max_m, 1e-30)
    wtol = 1e-12 * t_ridge
    has_root = l1max_m > lambda1          # else beta* = 0 (top of the path)

    # Bracket f(t) = nu(t) - lambda1: analytic endpoints nu(0) = l1max_m and
    # nu(t_ridge) = 0; the warm (t, nu) from the previous (larger) lambda is a
    # tighter lower endpoint whenever it is on the correct side.
    carry_t, carry_nu = host_float(carry.t), host_float(carry.nu)
    f_warm = carry_nu - lambda1
    warm_ok = f_warm > 0 and 0 < carry_t < t_ridge
    t_lo = carry_t if warm_ok else 0.0
    f_lo = f_warm if warm_ok else l1max_m - lambda1
    t_hi, f_hi = t_ridge, -lambda1
    side = 0              # +1: last eval replaced lo, -1: hi, 0: fresh
    beta = carry.beta * keepf
    alpha = carry.alpha * torch.cat([keepf, keepf])
    w = carry.w
    nu, f = carry_nu, f_lo
    evals = iters = cg_iters = 0

    while (evals < config.max_evals and has_root and t_hi - t_lo > wtol
           and abs(f) > ftol):
        frac = f_lo / max(f_lo - f_hi, 1e-30)
        frac = min(max(frac, 0.05), 0.95)   # never stall on an endpoint
        t_c = max(t_lo + frac * (t_hi - t_lo), t_floor)
        sol = _sven_core(Xm, y, t_c, lambda2, alpha, w, config.solver)
        g = en.smooth_grad(Xm, y, sol.beta, lambda2)
        nu_c = host_float(torch.max(torch.abs(g) * keepf))
        f_c = nu_c - lambda1
        # Illinois: replacing the same endpoint twice halves the stale side's
        # f, forcing the secant off that endpoint (superlinear on kinks).
        if f_c >= 0:
            if side == 1:
                f_hi = 0.5 * f_hi
            t_lo, f_lo, side = t_c, f_c, 1
        else:
            if side == -1:
                f_lo = 0.5 * f_lo
            t_hi, f_hi, side = t_c, f_c, -1
        beta, alpha, w, nu, f = sol.beta, sol.alpha, sol.w, nu_c, f_c
        evals += 1
        iters += sol.iters
        cg_iters += sol.cg_iters

    ok = float(has_root)
    beta = beta * keepf * ok
    t_out = torch.sum(torch.abs(beta))
    nu_out = torch.tensor(nu if has_root else l1max_m, dtype=dtype, device=X.device)
    next_carry = EnetCarry(beta=beta, alpha=alpha * ok, w=w * ok, t=t_out, nu=nu_out)
    point = EnetPoint(beta=beta, t=t_out, nu=nu_out,
                      kkt=en.kkt_violation(X, y, beta, lambda2),
                      keep=keep, n_kept=torch.sum(keep), gap=gap,
                      evals=evals, sven_iters=iters, cg_iters=cg_iters)
    return next_carry, point


# ---------------------------------------------------------------------------
# Public penalized API (original scale)
# ---------------------------------------------------------------------------

class EnetResult(NamedTuple):
    beta: torch.Tensor       # (p,) original-scale coefficients
    intercept: torch.Tensor  # ()
    lambda1: float
    lambda2: float
    t: torch.Tensor          # |beta_std|_1 — the constrained-form budget
    nu: torch.Tensor         # measured multiplier (== lambda1 at convergence)
    n_kept: torch.Tensor     # columns surviving the gap-safe screen
    evals: int               # SVEN solves spent on the multiplier root-find
    sven_iters: int
    cg_iters: int


class EnetPath(NamedTuple):
    lambda1s: torch.Tensor   # (L,) descending grid
    lambda2: float
    betas: torch.Tensor      # (L, p) original-scale coefficients
    intercepts: torch.Tensor  # (L,)
    ts: torch.Tensor         # (L,) constrained budgets |beta*|_1
    nus: torch.Tensor        # (L,) measured multipliers
    kkts: torch.Tensor       # (L,) Elastic Net KKT violations
    n_kept: torch.Tensor     # (L,) columns surviving the screen
    evals: Tuple[int, ...]   # SVEN solves per point
    sven_iters: Tuple[int, ...]
    cg_iters: Tuple[int, ...]


def enet(X, y, lambda1, lambda2, *, standardize: bool = False,
         fit_intercept: bool = False,
         config: PathConfig = PathConfig()) -> EnetResult:
    """Solve one penalized Elastic Net (paper scaling) via the SVEN engine.

    Runs where X lies (array-likes go to the CUDA device)."""
    X, y = _operands(X, y)
    Xs, ys, scaler = standardize_fit(X, y, standardize=standardize,
                                     fit_intercept=fit_intercept)
    config = resolve_path_config(config, Xs, ys)
    _, pt = _enet_point(Xs, ys, float(lambda1), float(lambda2), cold_carry(Xs, ys),
                        config)
    beta, intercept = unscale_coef(pt.beta, scaler)
    return EnetResult(beta=beta, intercept=intercept, lambda1=float(lambda1),
                      lambda2=float(lambda2), t=pt.t, nu=pt.nu, n_kept=pt.n_kept,
                      evals=pt.evals, sven_iters=pt.sven_iters, cg_iters=pt.cg_iters)


def enet_path(X, y, *, lambda1s=None, n_lambdas: int = 40,
              eps: Optional[float] = None, lambda2=1.0,
              standardize: bool = False, fit_intercept: bool = False,
              config: PathConfig = PathConfig()) -> EnetPath:
    """glmnet-style regularization path: a loop over the lambda grid that
    carries the warm `EnetCarry` (beta, alpha, w, t, nu) from a cold start.

    The grid is computed on the standardized problem (as glmnet does).
    """
    X, y = _operands(X, y)
    Xs, ys, scaler = standardize_fit(X, y, standardize=standardize,
                                     fit_intercept=fit_intercept)
    if lambda1s is None:
        lambda1s = lambda_grid(Xs, ys, n_lambdas=n_lambdas, eps=eps)
    if not isinstance(lambda1s, torch.Tensor):
        lambda1s = torch.tensor(np.asarray(lambda1s, dtype=np.float64))
    lambda1s = lambda1s.to(dtype=X.dtype, device=X.device)
    config = resolve_path_config(config, Xs, ys)
    carry = cold_carry(Xs, ys)
    pts = []
    for lam1 in lambda1s.tolist():
        carry, pt = _enet_point(Xs, ys, lam1, float(lambda2), carry, config)
        pts.append(pt)
    betas, intercepts = unscale_coef(torch.stack([pt.beta for pt in pts]), scaler)

    def stack(field):
        return torch.stack([getattr(pt, field) for pt in pts])

    return EnetPath(lambda1s=lambda1s, lambda2=float(lambda2), betas=betas,
                    intercepts=intercepts, ts=stack("t"), nus=stack("nu"),
                    kkts=stack("kkt"), n_kept=stack("n_kept"),
                    evals=tuple(pt.evals for pt in pts),
                    sven_iters=tuple(pt.sven_iters for pt in pts),
                    cg_iters=tuple(pt.cg_iters for pt in pts))


class ElasticNet:
    """sklearn-style estimator over the penalized SVEN front end.

    Parameters are in the paper's scaling (no 1/2, no 1/n; see
    `penalized_from_glmnet` / `penalized_from_sklearn`). After `fit`:
    `coef_`, `intercept_`, `t_` (the constrained budget the fit mapped to),
    `nu_`, `n_kept_` and `result_` (the whole `EnetResult`).
    """

    def __init__(self, lambda1: float, lambda2: float = 1.0, *,
                 standardize: bool = True, fit_intercept: bool = True,
                 config: PathConfig = PathConfig()):
        self.lambda1 = lambda1
        self.lambda2 = lambda2
        self.standardize = standardize
        self.fit_intercept = fit_intercept
        self.config = config

    def fit(self, X, y):
        res = enet(X, y, self.lambda1, self.lambda2,
                   standardize=self.standardize,
                   fit_intercept=self.fit_intercept, config=self.config)
        self.coef_ = res.beta
        self.intercept_ = res.intercept
        self.t_ = res.t
        self.nu_ = res.nu
        self.n_kept_ = res.n_kept
        self.result_ = res
        return self

    def predict(self, X):
        X = torch.as_tensor(X, dtype=self.coef_.dtype, device=self.coef_.device)
        return X @ self.coef_ + self.intercept_
