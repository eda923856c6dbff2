"""FISTA (accelerated proximal gradient) for the penalized Elastic Net.

Smooth part g(b) = ||Xb - y||^2 + lambda2 ||b||^2, prox of lambda1 |.|_1 is
the soft threshold; step 1/(1.01 L) with L = 2 lambda_max(X^T X) + 2 lambda2
by 50 power iterations. PyTorch counterpart of `repro/baselines/fista.py`,
with the same arithmetic; the loop test (max |delta b| > tol) is one host
sync per iteration.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.svm.state import host_bool


class FistaResult(NamedTuple):
    beta: torch.Tensor
    iters: int
    delta: torch.Tensor


def elastic_net_fista(
    X: torch.Tensor,
    y: torch.Tensor,
    lambda1: float,
    lambda2: float,
    *,
    tol: float = 1e-12,
    max_iters: int = 20000,
    beta0: Optional[torch.Tensor] = None,
) -> FistaResult:
    n, p = X.shape
    lambda1, lambda2 = float(lambda1), float(lambda2)

    v = X.new_ones(p) / math.sqrt(p)
    for _ in range(50):
        w = X.T @ (X @ v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    L = 2.0 * (v @ (X.T @ (X @ v))) + 2.0 * lambda2
    step = 1.0 / (L * 1.01)

    def grad(b):
        return 2.0 * (X.T @ (X @ b - y)) + 2.0 * lambda2 * b

    def prox(b):
        return torch.sign(b) * torch.clamp(torch.abs(b) - step * lambda1, min=0.0)

    b = X.new_zeros(p) if beta0 is None else beta0.to(X.dtype)
    z, tk, it = b, 1.0, 0
    delta = torch.full((), float("inf"), dtype=X.dtype, device=X.device)
    while it < max_iters and host_bool(delta > tol):
        b_new = prox(z - step * grad(z))
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * tk * tk))
        z = b_new + ((tk - 1.0) / t_new) * (b_new - b)
        delta = torch.max(torch.abs(b_new - b))
        b, tk, it = b_new, t_new, it + 1
    return FistaResult(beta=b, iters=it, delta=delta)
