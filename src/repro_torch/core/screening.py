"""Gap-safe feature screening for the Elastic Net.

Before running the SVM reduction, provably-inactive features can be discarded
(Ndiaye et al., "Gap Safe screening rules", JMLR 2017), shrinking the
constructed SVM problem from 2p to 2p_kept samples.

Derivation under this repo's scaling (P(b) = ||Xb-y||^2 + l2||b||^2 + l1|b|_1):
the ridge term folds into an augmented Lasso via A = [X; sqrt(l2) I],
b = [y; 0]: P = 2*(1/2||b-Ab||^2 + (l1/2)|b|_1). With lam = l1/2 and any
primal point beta:

    resid   = [y - X beta ; -sqrt(l2) beta]
    corr_j  = x_j^T (y - X beta) - l2 beta_j              (= a_j^T resid)
    theta   = resid / max(lam, ||corr||_inf)              (dual feasible)
    gap     = P_half(beta) - D(theta) >= 0
    DISCARD j  if  |corr_j| / scale + sqrt(2 gap) / lam * ||a_j|| < 1 - slack,
    ||a_j|| = sqrt(||x_j||^2 + l2)

Safe: a discarded j provably has beta*_j = 0. PyTorch counterpart of
`repro/core/screening.py`, with the same arithmetic; lambda1 and lambda2 are
host floats.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ScreenResult(NamedTuple):
    keep: torch.Tensor     # (p,) bool — features that MAY be active
    gap: torch.Tensor      # duality gap at (beta, theta)
    n_kept: torch.Tensor


def gap_safe_screen(X: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                    lambda1: float, lambda2: float,
                    slack: float = 1e-6) -> ScreenResult:
    """`slack` is a pure-numerics guard on the discard boundary: at a warm
    point that is already (near-)optimal the duality gap underflows toward 0
    and ACTIVE coordinates sit exactly on |corr_j|/scale = 1, where f64
    roundoff can push them to the discard side. A 1e-6 band around the
    boundary costs a few extra kept columns and keeps the rule safe."""
    lambda1, lambda2 = float(lambda1), float(lambda2)
    lam = lambda1 / 2.0
    # lambda1 = 0 (pure ridge) has no L1 dual ball: nothing is safely
    # discardable, and every lam division below would produce NaNs that
    # silently discard EVERYTHING. Guard the divisions and keep everything.
    lam_pos = lam > 0
    lam_s = lam if lam_pos else 1.0
    r = y - X @ beta
    corr = X.T @ r - lambda2 * beta                        # (p,)
    scale = torch.clamp(torch.max(torch.abs(corr)), min=lam_s)

    # P_half and D(theta) in the augmented-Lasso convention
    res_sq = r @ r + lambda2 * (beta @ beta)               # ||b - A beta||^2
    p_half = 0.5 * res_sq + lam * torch.sum(torch.abs(beta))
    b_sq = y @ y
    btheta = (y @ r) / scale
    theta_sq = res_sq / (scale * scale)
    # D = 1/2||b||^2 - lam^2/2 ||theta - b/lam||^2
    d_val = 0.5 * b_sq - 0.5 * lam_s * lam_s * (
        theta_sq - 2.0 * btheta / lam_s + b_sq / (lam_s * lam_s))
    gap = torch.clamp(p_half - d_val, min=0.0)

    radius = torch.sqrt(2.0 * gap) / lam_s
    col_norm = torch.sqrt(torch.sum(X * X, dim=0) + lambda2)
    keep = (torch.abs(corr) / scale + radius * col_norm) >= 1.0 - slack
    if not lam_pos:
        keep = torch.ones_like(keep)
    return ScreenResult(keep=keep, gap=gap, n_kept=torch.sum(keep))


def sven_with_screening(X, y, t, lambda2, *, warm_beta=None, config=None):
    """Screen-then-solve: estimate lambda1 from a warm beta (or 400 FISTA
    steps), drop provably-inactive columns, run SVEN on the survivors and
    scatter beta back to p dims. Exactness is preserved (safe rule).
    Returns (beta, SvenSolution on the kept columns, ScreenResult)."""
    from repro_torch.baselines.fista import elastic_net_fista
    from repro_torch.core import elastic_net as en
    from repro_torch.core.sven import SvenConfig, _operands, sven

    config = config or SvenConfig()
    X, y = _operands(X, y)
    p = X.shape[1]
    if warm_beta is None:
        # cheap warm start at the lambda1 implied by a rough path position
        l1_guess = 0.2 * float(en.lambda1_max(X, y))
        warm_beta = elastic_net_fista(X, y, l1_guess, lambda2, max_iters=400).beta
    # lambda1 consistent with the constrained-form multiplier at warm_beta
    lam1 = max(float(en.kkt_multiplier(X, y, warm_beta, lambda2)), 1e-8)
    scr = gap_safe_screen(X, y, warm_beta, lam1, lambda2)
    idx = torch.nonzero(scr.keep).flatten()
    sol = sven(X[:, idx], y, t, lambda2, config)
    beta = X.new_zeros(p)
    beta[idx] = sol.beta
    return beta, sol, scr
