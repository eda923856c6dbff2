"""Elastic Net objectives and optimality diagnostics (paper conventions).

    constrained form:  min_beta ||X beta - y||_2^2 + lambda2 ||beta||_2^2
                       s.t. |beta|_1 <= t                                  (1)

    penalized form:    min_beta ||X beta - y||_2^2 + lambda2 ||beta||_2^2
                       + lambda1 |beta|_1                                  (pen)

No 1/2 or 1/n factors anywhere — this matches the paper, not glmnet's
internal scaling. PyTorch counterpart of `repro/core/elastic_net.py`.
"""
from __future__ import annotations

import torch


def objective_constrained(X: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                          lambda2: float) -> torch.Tensor:
    """||X beta - y||^2 + lambda2 ||beta||^2 (the L1 part is a constraint)."""
    r = X @ beta - y
    return r @ r + lambda2 * (beta @ beta)


def objective_penalized(X: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                        lambda1: float, lambda2: float) -> torch.Tensor:
    return objective_constrained(X, y, beta, lambda2) + lambda1 * torch.sum(torch.abs(beta))


def smooth_grad(X: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                lambda2: float) -> torch.Tensor:
    """Gradient of the smooth part: 2 X^T (X beta - y) + 2 lambda2 beta."""
    return 2.0 * (X.T @ (X @ beta - y)) + 2.0 * lambda2 * beta


def _nu(g: torch.Tensor, beta: torch.Tensor, zero_tol: float):
    active = torch.abs(beta) > zero_tol
    nu_each = -g * torch.sign(beta)
    denom = torch.clamp(torch.sum(active), min=1)
    nu = torch.sum(torch.where(active, nu_each, torch.zeros_like(nu_each))) / denom
    return active, nu_each, nu


def kkt_multiplier(X: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                   lambda2: float, zero_tol: float = 1e-8) -> torch.Tensor:
    """Estimate the L1-constraint multiplier nu >= 0 from active coordinates:
    the mean of -g_j sign(beta_j) over active j, with g = smooth_grad."""
    return _nu(smooth_grad(X, y, beta, lambda2), beta, zero_tol)[2]


def kkt_violation_from_grad(g: torch.Tensor, beta: torch.Tensor,
                            zero_tol: float = 1e-8) -> torch.Tensor:
    """`kkt_violation` given a precomputed smooth gradient g at beta."""
    active, nu_each, nu = _nu(g, beta, zero_tol)
    zero = torch.zeros_like(g)
    act_res = torch.where(active, torch.abs(nu_each - nu), zero)
    inact_res = torch.where(~active, torch.clamp(torch.abs(g) - nu, min=0.0), zero)
    return torch.maximum(torch.max(act_res), torch.max(inact_res)) / (1.0 + torch.abs(nu))


def kkt_violation(X: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                  lambda2: float, zero_tol: float = 1e-8) -> torch.Tensor:
    """Max KKT residual of (1) at beta (0 at an exact optimum), normalized by
    (1 + nu): active coordinates agree on nu, inactive ones have |g_j| <= nu."""
    return kkt_violation_from_grad(smooth_grad(X, y, beta, lambda2), beta, zero_tol)


def lambda1_max(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Smallest lambda1 for which the penalized solution is beta = 0:
    |2 x_j^T y| <= lambda1 for all j."""
    return 2.0 * torch.max(torch.abs(X.T @ y))
