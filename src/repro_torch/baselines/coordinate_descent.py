"""glmnet-style coordinate descent for the penalized Elastic Net.

    min_beta ||X beta - y||^2 + lambda2 ||beta||^2 + lambda1 |beta|_1

(no 1/2 or 1/n factors — the paper's scaling). Coordinate update:

    beta_j <- S(2 x_j^T r_j, lambda1) / (2 ||x_j||^2 + 2 lambda2),
    r_j = y - X beta + x_j beta_j,  S = soft threshold.

The front end's oracle (it stands in for glmnet). PyTorch counterpart of
`repro/baselines/coordinate_descent.py`, with the same arithmetic: cyclic
sweeps with full residual updates until max |delta beta| < tol. The sweep is
a host loop over coordinates: the residual stays a tensor, each coordinate's
scalars are host floats (one read of x_j^T r per coordinate), so it is
meant for the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class CDResult(NamedTuple):
    beta: torch.Tensor
    sweeps: int
    delta: float


def _soft(rho: float, lambda1: float) -> float:
    """sign(rho) max(|rho| - lambda1, 0), with sign(0) = 0."""
    sign = (rho > 0) - (rho < 0)
    return sign * max(abs(rho) - lambda1, 0.0)


def elastic_net_cd(
    X: torch.Tensor,
    y: torch.Tensor,
    lambda1: float,
    lambda2: float,
    *,
    tol: float = 1e-12,
    max_sweeps: int = 2000,
    beta0: Optional[torch.Tensor] = None,
) -> CDResult:
    n, p = X.shape
    lambda1, lambda2 = float(lambda1), float(lambda2)
    XT = X.T.contiguous()                                # row j = x_j
    col_sq = torch.sum(X * X, dim=0)                     # ||x_j||^2
    denom = (2.0 * col_sq + 2.0 * lambda2).tolist()
    col_sq = col_sq.tolist()
    beta_init = X.new_zeros(p) if beta0 is None else beta0.to(X.dtype)
    r = y - X @ beta_init
    beta = beta_init.tolist()
    sweeps, delta = 0, float("inf")
    while delta > tol and sweeps < max_sweeps:
        old = list(beta)
        for j in range(p):
            bj = beta[j]
            rho = 2.0 * float(XT[j] @ r) + 2.0 * col_sq[j] * bj   # 2 x_j^T r_j
            bj_new = _soft(rho, lambda1) / denom[j]
            if bj_new != bj:
                r = r - XT[j] * (bj_new - bj)
            beta[j] = bj_new
        delta = max(abs(a - b) for a, b in zip(beta, old))
        sweeps += 1
    return CDResult(beta=torch.tensor(beta, dtype=X.dtype, device=X.device),
                    sweeps=sweeps, delta=delta)


def cd_path(X: torch.Tensor, y: torch.Tensor, lambda1s, lambda2: float, **kw
            ) -> torch.Tensor:
    """Warm-started CD along a decreasing lambda1 grid (glmnet's pathwise
    trick); (len(lambda1s), p)."""
    if isinstance(lambda1s, torch.Tensor):
        lambda1s = lambda1s.tolist()
    betas, beta = [], None
    for l1 in lambda1s:
        beta = elastic_net_cd(X, y, float(l1), lambda2, beta0=beta, **kw).beta
        betas.append(beta)
    return torch.stack(betas)
