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
  - `enet_batch` solves a stack of penalized problems at once (the serving
    layer's call; `core/cv.py` runs its folds the same way).
  - `ElasticNet`: the sklearn-style fit/predict wrapper (`core/cv.py` adds
    `ElasticNetCV`).

JAX runs the root-find as a `lax.while_loop` and the path as one `lax.scan`;
here both are host loops with the same arithmetic, stops and endpoint
halving. The bracket scalars (t, f = nu - lambda1) are host floats, so each
evaluation reads nu back once (`host_float`, counted in `host_bool.syncs`).
Every evaluation runs the solver's kernels: on a CUDA tensor with the
default backend, the Gram kernel (dual) or the hinge kernels (primal).

JAX's `enet_batch` vmaps the point solver; here `_enet_point_lanes` is a
lane-batched host loop: each lane keeps its own bracket on the host, every
evaluation solves the lanes still running in one `_sven_core_lanes` (one
launch of each hinge pass per CG step for all of them), and the host reads
their multipliers in one read. Each lane is bitwise its sequential point.
Under a mesh context the lanes fan out over the ranks (`core/batch.py`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import elastic_net as en
from repro_torch.core.screening import gap_safe_screen
from repro_torch.core.sven import (SvenConfig, _lane, _operands, _sven_core, _sven_core_lanes,
                                   resolve_backend)
from repro_torch.core.svm.state import host_float, host_list, lane_where, pitched
from repro_torch.device import resolve_device


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
    """Warm state threaded across lambda points (and, stacked with a leading
    (B,) axis on every field, across lanes)."""

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
    # (of B lanes, `_enet_point_lanes`: each tensor with a leading (B,) axis,
    # evals, sven_iters and cg_iters tuples of B ints)


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


class _Illinois:
    """One point's multiplier root-find on the host: the bracket of
    f(t) = nu(t) - lambda1, its stops and its counts, as Python floats and
    ints (JAX's `_Illinois` carry). `_enet_point` runs one and
    `_enet_point_lanes` one per lane, so a lane's t_c are the sequential
    ones, bit for bit."""

    def __init__(self, lambda1: float, l1max_m: float, t_ridge: float, carry_t: float,
                 carry_nu: float, config: PathConfig):
        self.lambda1, self.l1max_m = lambda1, l1max_m
        self.t_floor = config.t_floor_rel * t_ridge + 1e-30
        self.ftol = config.f_rtol * max(l1max_m, 1e-30)
        self.wtol = 1e-12 * t_ridge
        self.max_evals = config.max_evals
        self.has_root = l1max_m > lambda1          # else beta* = 0 (top of the path)
        # Bracket f(t) = nu(t) - lambda1: analytic endpoints nu(0) = l1max_m and
        # nu(t_ridge) = 0; the warm (t, nu) from the previous (larger) lambda is a
        # tighter lower endpoint whenever it is on the correct side.
        f_warm = carry_nu - lambda1
        warm_ok = f_warm > 0 and 0 < carry_t < t_ridge
        self.t_lo = carry_t if warm_ok else 0.0
        self.f_lo = f_warm if warm_ok else l1max_m - lambda1
        self.t_hi, self.f_hi = t_ridge, -lambda1
        self.side = 0         # +1: last eval replaced lo, -1: hi, 0: fresh
        self.nu, self.f = carry_nu, self.f_lo
        self.evals = self.iters = self.cg_iters = 0

    def running(self) -> bool:
        """The loop test: another evaluation is due."""
        return (self.evals < self.max_evals and self.has_root
                and self.t_hi - self.t_lo > self.wtol and abs(self.f) > self.ftol)

    def next_t(self) -> float:
        """The secant point of the bracket, the budget of the next solve."""
        frac = self.f_lo / max(self.f_lo - self.f_hi, 1e-30)
        frac = min(max(frac, 0.05), 0.95)   # never stall on an endpoint
        return max(self.t_lo + frac * (self.t_hi - self.t_lo), self.t_floor)

    def update(self, t_c: float, nu_c: float, iters: int, cg_iters: int) -> None:
        """Take the evaluation at t_c (multiplier nu_c, solver counts)."""
        f_c = nu_c - self.lambda1
        # Illinois: replacing the same endpoint twice halves the stale side's
        # f, forcing the secant off that endpoint (superlinear on kinks).
        if f_c >= 0:
            if self.side == 1:
                self.f_hi = 0.5 * self.f_hi
            self.t_lo, self.f_lo, self.side = t_c, f_c, 1
        else:
            if self.side == -1:
                self.f_lo = 0.5 * self.f_lo
            self.t_hi, self.f_hi, self.side = t_c, f_c, -1
        self.nu, self.f = nu_c, f_c
        self.evals += 1
        self.iters += iters
        self.cg_iters += cg_iters


def _screen(X: torch.Tensor, y: torch.Tensor, beta: torch.Tensor, lambda1: float,
            lambda2: float, config: PathConfig):
    """The point's gap-safe keep mask and duality gap at the warm beta (all
    kept and gap 0 without screening)."""
    if config.screen:
        scr = gap_safe_screen(X, y, beta, lambda1, lambda2)
        return scr.keep, scr.gap
    return torch.ones(X.shape[-1], dtype=torch.bool, device=X.device), X.new_zeros(())


def _multiplier(Xm: torch.Tensor, y: torch.Tensor, beta: torch.Tensor, lambda2: float,
                keepf: torch.Tensor) -> torch.Tensor:
    """nu at a solve's beta: max |g_j| over the kept columns (0-d)."""
    return torch.max(torch.abs(en.smooth_grad(Xm, y, beta, lambda2)) * keepf)


def _point_out(X, y, lambda2: float, keep, gap, keepf, br: _Illinois, beta, alpha, w):
    """(next_carry, EnetPoint) of a finished root-find."""
    ok = float(br.has_root)
    beta = beta * keepf * ok
    t_out = torch.sum(torch.abs(beta))
    nu_out = torch.tensor(br.nu if br.has_root else br.l1max_m, dtype=X.dtype,
                          device=X.device)
    next_carry = EnetCarry(beta=beta, alpha=alpha * ok, w=w * ok, t=t_out, nu=nu_out)
    point = EnetPoint(beta=beta, t=t_out, nu=nu_out,
                      kkt=en.kkt_violation(X, y, beta, lambda2),
                      keep=keep, n_kept=torch.sum(keep), gap=gap,
                      evals=br.evals, sven_iters=br.iters, cg_iters=br.cg_iters)
    return next_carry, point


def _enet_point(X: torch.Tensor, y: torch.Tensor, lambda1: float, lambda2: float,
                carry: EnetCarry, config: PathConfig):
    """Solve one penalized (lambda1, lambda2) point on the constrained engine.

    `config.solver` must be resolved (`resolve_path_config`). Returns
    (next_carry, EnetPoint).
    """
    lambda1, lambda2 = float(lambda1), float(lambda2)
    keep, gap = _screen(X, y, carry.beta, lambda1, lambda2, config)
    keepf = keep.to(X.dtype)
    Xm = X * keepf[None, :]
    br = _Illinois(lambda1, host_float(en.lambda1_max(Xm, y)), host_float(_ridge_l1(Xm, y, lambda2)),
                   host_float(carry.t), host_float(carry.nu), config)
    beta = carry.beta * keepf
    alpha = carry.alpha * torch.cat([keepf, keepf])
    w = carry.w
    while br.running():
        t_c = br.next_t()
        sol = _sven_core(Xm, y, t_c, lambda2, alpha, w, config.solver)
        br.update(t_c, host_float(_multiplier(Xm, y, sol.beta, lambda2, keepf)), sol.iters,
                  sol.cg_iters)
        beta, alpha, w = sol.beta, sol.alpha, sol.w
    return _point_out(X, y, lambda2, keep, gap, keepf, br, beta, alpha, w)


def _cold_carry_lanes(X: torch.Tensor, y: torch.Tensor, B: int) -> EnetCarry:
    """`cold_carry` of B lanes, each field with a leading (B,) axis: X
    (n, p) shared or (B, n, p), y (n,) or (B, n)."""
    n, p = X.shape[-2:]
    Xl = X if X.dim() == 2 else pitched(X)
    yl = y if y.dim() == 1 else pitched(y)
    nu = torch.stack([en.lambda1_max(_lane(Xl, i, 2), _lane(yl, i, 1))
                      for i in range(B)]).to(X.dtype)
    return EnetCarry(beta=X.new_zeros(B, p), alpha=X.new_zeros(B, 2 * p), w=X.new_zeros(B, n),
                     t=X.new_zeros(B), nu=nu)


def _take(stack: torch.Tensor, idx: list) -> torch.Tensor:
    """Lanes idx of a `pitched` stack, laid out as one: the stack itself
    when idx names all its lanes, else a new stack."""
    if idx == list(range(stack.shape[0])):
        return stack
    return pitched(stack[torch.tensor(idx, device=stack.device)])


def _solve_active(Xm, y, idx: list, t_c: list, lambda2s: list, alphas: list, ws: list,
                  config: SvenConfig):
    """The solves of the lanes idx of the screened stack Xm (B, n, p) at the
    budgets t_c: `_sven_core` on one lane, `_sven_core_lanes` on more.
    Returns the solved lanes' beta (A, p), alpha (A, 2p) and w (A, n), and
    their Newton and CG counts as (A,) tensors of Xm's dtype on its device
    (read by the caller with the multipliers)."""
    dtype, dev = Xm.dtype, Xm.device
    alpha0, w0 = torch.stack(alphas), torch.stack(ws)
    ya = y if y.dim() == 1 else _take(y, idx)
    if len(idx) == 1:
        sol = _sven_core(Xm[idx[0]], ya if y.dim() == 1 else ya[0], t_c[0], lambda2s[0],
                         alpha0[0], w0[0], config)
        counts = torch.tensor([sol.iters, sol.cg_iters], dtype=dtype, device=dev)
        return sol.beta[None], sol.alpha[None], sol.w[None], counts[:1], counts[1:]
    sol = _sven_core_lanes(_take(Xm, idx), ya, torch.tensor(t_c, dtype=dtype, device=dev),
                           torch.tensor(lambda2s, dtype=dtype, device=dev), alpha0, w0,
                           config, ts=torch.tensor(t_c, dtype=dtype).tolist())
    return sol.beta, sol.alpha, sol.w, sol.iters.to(dtype), sol.cg_iters.to(dtype)


def _enet_point_lanes(X: torch.Tensor, y: torch.Tensor, lambda1s: list, lambda2s: list,
                      carry: EnetCarry, config: PathConfig):
    """`_enet_point` on B lanes at once: the port of `vmap(_enet_point)`.

    X (n, p) shared by the lanes or (B, n, p); y (n,) or (B, n); lambda1s and
    lambda2s B floats each; carry an `EnetCarry` whose fields have a leading
    (B,) axis; `config.solver` resolved. Each lane runs its own Illinois
    root-find on the host (`_Illinois`), and each evaluation solves only the
    lanes whose loop test still holds: one `_sven_core_lanes` for them all
    (on the kernel path one launch of each hinge pass per CG step for all
    of them, or one Gram per lane), `_sven_core` when one is left. Every
    per-lane product and reduction runs on its lane laid out as a fresh
    tensor (`pitched`), so each lane is bitwise `_enet_point` on its
    operands. The host reads the lanes' (l1max_m, t_ridge, carry t, carry
    nu) in one read, and their multipliers and solver counts in one read
    per evaluation.
    Returns (next_carry, EnetPoint), each tensor field with a leading (B,)
    axis, and evals, sven_iters and cg_iters tuples of B ints.
    """
    B = len(lambda1s)
    dtype = X.dtype
    lambda1s, lambda2s = [float(v) for v in lambda1s], [float(v) for v in lambda2s]
    Xl = X if X.dim() == 2 else pitched(X)
    yl = y if y.dim() == 1 else pitched(y)

    def lane(i):
        return _lane(Xl, i, 2), _lane(yl, i, 1)

    betal = pitched(carry.beta)
    screens = [_screen(*lane(i), betal[i], lambda1s[i], lambda2s[i], config) for i in range(B)]
    keepf = torch.stack([keep for keep, _ in screens]).to(dtype)
    Xm = pitched(Xl * keepf.unsqueeze(-2))       # (B, n, p), a shared X too
    heads = torch.stack([en.lambda1_max(Xm[i], lane(i)[1]) for i in range(B)])
    ridges = torch.stack([_ridge_l1(Xm[i], lane(i)[1], lambda2s[i]) for i in range(B)])
    vals = host_list(torch.cat([heads, ridges, carry.t, carry.nu]))
    brs = [_Illinois(lambda1s[i], vals[i], vals[B + i], vals[2 * B + i], vals[3 * B + i],
                     config) for i in range(B)]
    beta = [betal[i] * keepf[i] for i in range(B)]
    alpha = [carry.alpha[i] * torch.cat([keepf[i], keepf[i]]) for i in range(B)]
    w = list(carry.w)
    while True:
        idx = [i for i in range(B) if brs[i].running()]
        if not idx:
            break
        t_c = [brs[i].next_t() for i in idx]
        sb, sa, sw, iters, cg = _solve_active(
            Xm, yl, idx, t_c, [lambda2s[i] for i in idx], [alpha[i] for i in idx],
            [w[i] for i in idx], config.solver)
        sb = pitched(sb)
        nus = torch.stack([_multiplier(Xm[i], lane(i)[1], sb[j], lambda2s[i], keepf[i])
                           for j, i in enumerate(idx)])
        read = host_list(torch.cat([nus, iters, cg]))   # one read an evaluation
        A = len(idx)
        for j, i in enumerate(idx):
            brs[i].update(t_c[j], read[j], int(read[A + j]), int(read[2 * A + j]))
            beta[i], alpha[i], w[i] = sb[j], sa[j], sw[j]
    del Xm
    outs = [_point_out(*lane(i), lambda2s[i], screens[i][0], screens[i][1], keepf[i], brs[i],
                       beta[i], alpha[i], w[i]) for i in range(B)]
    carries, points = zip(*outs)
    next_carry = EnetCarry(*(torch.stack(f) for f in zip(*carries)))
    point = EnetPoint(*(torch.stack(f) if isinstance(f[0], torch.Tensor) else tuple(f)
                        for f in zip(*points)))
    return next_carry, point


def _path_points(X: torch.Tensor, y: torch.Tensor, lambda1s: list, lambda2: float,
                 config: PathConfig) -> list:
    """The points of a path over the floats lambda1s from `cold_carry`,
    each warm-started from the one before (`enet_path`'s loop, on the
    problem as given)."""
    carry = cold_carry(X, y)
    pts = []
    for lam1 in lambda1s:
        carry, pt = _enet_point(X, y, lam1, lambda2, carry, config)
        pts.append(pt)
    return pts


def enet_batch(X, y, lambda1s, lambda2s,
               config: PathConfig = PathConfig(), *,
               warm: Optional[EnetCarry] = None,
               has_warm=None,
               return_carry: bool = False,
               route: str = "auto"):
    """Stacked penalized solves in one lane-batched root-find (the serving
    layer's call), `_enet_point_lanes` on the stack.

    Batch axes by rank, as in `core.batch.sven_batch`: X (B, n, p) or (n, p)
    shared; y (B, n) or (n,); lambda1s / lambda2s (B,) or scalar. Every
    tensor field of the returned EnetPoint has a leading (B,) axis; evals,
    sven_iters and cg_iters are tuples of B ints. Each lane is bitwise
    `enet` on its operands (no standardization). A (B, p) screening mask
    makes even a shared X a stack of masked lanes, so a lane-batched solve
    of them takes the stacked route of the hinge passes.

    `warm` is an optional stacked EnetCarry (every field with a leading (B,)
    axis) and `has_warm` a (B,) bool selecting, per problem, the warm state
    over a cold start. With `return_carry` the final stacked EnetCarry comes
    back beside the points, as (points, carry). Runs where X lies
    (array-likes go to the CUDA device). Under an active
    `repro_torch.dist.mesh_context` the lanes fan out over the ranks as in
    `core.batch.sven_batch` (each rank runs its block's whole root-finds,
    no collective inside; results gathered in lane order) when the cost
    model prices the fan-out lower (`form="penalized"`); `route` pins the
    layout ("batch" / "single"). Each lane is bitwise the same either way.
    """
    from repro_torch.core.batch import ROUTES, batch_mesh, gather_lanes
    from repro_torch.dist import local_block

    if route not in ROUTES:
        raise ValueError(f"enet_batch: route must be one of {ROUTES}, got {route!r}")
    dev = resolve_device(None, X, y, lambda1s, lambda2s)
    X = torch.as_tensor(X, device=dev)
    dtype = X.dtype
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    if X.dim() not in (2, 3) or y.dim() not in (1, 2) or y.shape[-1] != X.shape[-2]:
        raise ValueError(f"enet_batch: X must be (n, p) or (B, n, p) and y (n,) or "
                         f"(B, n), got {tuple(X.shape)} and {tuple(y.shape)}")
    lambda1s = torch.as_tensor(lambda1s, dtype=dtype, device=dev)
    lambda2s = torch.as_tensor(lambda2s, dtype=dtype, device=dev)
    operands = (X, y, lambda1s, lambda2s)
    sizes = {op.shape[0] for op, lead in zip(operands, (3, 2, 1, 1)) if op.dim() == lead}
    if not sizes:
        raise ValueError("enet_batch: no batched operand (use enet())")
    if (warm is None) != (has_warm is None):
        raise ValueError("enet_batch: warm and has_warm must be given together")
    if has_warm is not None:
        has_warm = torch.as_tensor(has_warm, device=dev).to(torch.bool)
        warm = EnetCarry(*(torch.as_tensor(f, device=dev).to(dtype) for f in warm))
        sizes.update(f.shape[0] for f in warm)
        sizes.add(has_warm.shape[0])
    if len(sizes) != 1:
        raise ValueError(f"enet_batch: inconsistent batch sizes {sorted(sizes)}")
    B = sizes.pop()
    config = resolve_path_config(config, X, y)
    lams = host_list(torch.cat([lambda1s.expand(B), lambda2s.expand(B)]))
    l1s, l2s = lams[:B], lams[B:]
    mesh = batch_mesh(B, X.shape[-2], X.shape[-1], form="penalized", route=route)
    if mesh is not None:
        # this rank's block of lanes: the whole root-find of each, no
        # collective inside; the shared operands stay whole
        lo, B = mesh.rank * (B // mesh.size), B // mesh.size
        X = local_block(mesh, X) if X.dim() == 3 else X
        y = local_block(mesh, y) if y.dim() == 2 else y
        l1s, l2s = l1s[lo:lo + B], l2s[lo:lo + B]
        if warm is not None:
            warm = EnetCarry(*(local_block(mesh, f) for f in warm))
            has_warm = local_block(mesh, has_warm)
    carry = _cold_carry_lanes(X, y, B)
    if warm is not None:
        carry = EnetCarry(*lane_where(has_warm, tuple(warm), tuple(carry)))
    carry, points = _enet_point_lanes(X, y, l1s, l2s, carry, config)
    if mesh is not None:
        carry, points = gather_lanes(mesh, carry), gather_lanes(mesh, points)
    return (points, carry) if return_carry else points


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
    pts = _path_points(Xs, ys, lambda1s.tolist(), float(lambda2), config)
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
