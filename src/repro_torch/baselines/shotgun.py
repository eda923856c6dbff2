"""Shotgun-style parallel coordinate descent (Bradley et al., ICML 2011).

The paper's parallel-CD comparison point. Shotgun updates P randomly chosen
coordinates *simultaneously* from the same residual snapshot; convergence
holds for P up to ~p/(2*spectral_radius). This is the synchronous variant:
draw P distinct coordinates, compute their soft-threshold targets from the
shared residual, apply all deltas at once (an index add) with a step
damping factor.

PyTorch counterpart of `repro/baselines/shotgun.py`, with the same update
and stop rule: rounds run while the last round's max |delta b| > tol and
fewer than `max_rounds` have run. The coordinates come from a
`torch.Generator` on X's device seeded by `seed` (`torch.randperm`), so the
draws are not JAX's `jax.random.choice` draws: the port's shotgun reaches
the same optimum by another sequence of rounds. JAX's `lax.while_loop` is
a host loop that evaluates its test on the device every round and reads it
once per block of READ_EVERY rounds; the rounds launched past the one whose
test turned false run on and are discarded, and the result is that round's
beta.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.svm.state import host_list

#: rounds a block: the loop test is read once per block
READ_EVERY = 16


class ShotgunResult(NamedTuple):
    beta: torch.Tensor
    rounds: int       # rounds up to the one whose test stopped the loop
    delta: float      # that round's max |delta b|


def elastic_net_shotgun(
    X: torch.Tensor,
    y: torch.Tensor,
    lambda1: float,
    lambda2: float,
    *,
    parallel: int = 64,
    max_rounds: int = 20000,
    tol: float = 1e-10,
    damping: float = 0.5,
    seed: int = 0,
) -> ShotgunResult:
    """min ||X b - y||^2 + lambda2 ||b||^2 + lambda1 |b|_1 (the paper's
    scaling, as `elastic_net_cd`) by rounds of `parallel` simultaneous
    coordinate updates. Runs where X lies."""
    n, p = X.shape
    lambda1, lambda2 = float(lambda1), float(lambda2)
    XT = X.T.contiguous()                                # row j = x_j
    col_sq = torch.sum(X * X, dim=0)
    denom = 2.0 * col_sq + 2.0 * lambda2
    P = min(parallel, p)
    gen = torch.Generator(device=X.device).manual_seed(seed)

    def round_step(beta, r):
        js = torch.randperm(p, generator=gen, device=X.device)[:P]
        XTj = XT[js]                                     # (P, n)
        bj = beta[js]
        rho = 2.0 * (XTj @ r) + 2.0 * col_sq[js] * bj
        bj_new = torch.sign(rho) * torch.clamp(torch.abs(rho) - lambda1, min=0.0) / denom[js]
        delta_b = damping * (bj_new - bj)
        return beta.index_add(0, js, delta_b), r - XTj.T @ delta_b, torch.max(torch.abs(delta_b))

    beta = X.new_zeros(p)
    r = y - X @ beta
    rounds, last = 0, float("inf")
    while rounds < max_rounds:
        block = min(READ_EVERY, max_rounds - rounds)
        betas, deltas = [], []
        for _ in range(block):
            beta, r, delta = round_step(beta, r)
            betas.append(beta)
            deltas.append(delta)
        stacked = torch.stack(deltas)
        # one read a block: each round's delta and its test, taken on the device
        read = host_list(torch.cat([stacked, (stacked > tol).to(stacked.dtype)]))
        for j in range(block):
            if not read[block + j]:
                return ShotgunResult(beta=betas[j], rounds=rounds + j + 1, delta=read[j])
        rounds, last = rounds + block, read[block - 1]
    return ShotgunResult(beta=beta, rounds=rounds, delta=last)


def drawn_coordinates(p: int, parallel: int, round_: int, seed: int = 0,
                      device=None) -> torch.Tensor:
    """The coordinates `elastic_net_shotgun` draws in round `round_` (1 is the
    first) with this seed on this device: the draws do not depend on the
    data, so a generator seeded alike and stepped `round_` times repeats
    them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(round_ - 1):
        torch.randperm(p, generator=gen, device=device)
    return torch.randperm(p, generator=gen, device=device)[:min(parallel, p)]


def coordinate_steps(X: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                     lambda1: float, lambda2: float) -> torch.Tensor:
    """s (p,): each coordinate's exact minimizer, the rest of beta held,
    less beta: the step a round would take on every coordinate at once,
    undamped, from the residual y - X beta."""
    col_sq = torch.sum(X * X, dim=0)
    rho = 2.0 * (X.T @ (y - X @ beta)) + 2.0 * col_sq * beta
    target = torch.sign(rho) * torch.clamp(torch.abs(rho) - lambda1, min=0.0)
    return target / (2.0 * col_sq + 2.0 * lambda2) - beta


def error_bound(X: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                lambda1: float, lambda2: float) -> float:
    """An a-posteriori bound on ||beta - beta*||_2 for the penalized Elastic
    Net (beta* its minimizer): ||s|| + ||(X^T X - diag(X^T X)) s|| / lambda2,
    s = `coordinate_steps`.

    beta + s is one proximal step in the metric D = diag(2 ||x_j||^2 +
    2 lambda2), so (H - D) s, H = 2 (X^T X + lambda2 I), is a subgradient of
    the objective at beta + s; the objective is 2 lambda2 strongly convex, so
    beta + s lies within ||(H - D) s|| / (2 lambda2) of beta*."""
    s = coordinate_steps(X, y, beta, lambda1, lambda2)
    off = X.T @ (X @ s) - torch.sum(X * X, dim=0) * s
    return float(torch.linalg.norm(s) + torch.linalg.norm(off) / float(lambda2))


def stop_rule_bounds(X: torch.Tensor, coords: torch.Tensor, lambda2: float, *,
                     tol: float = 1e-10, damping: float = 0.5) -> torch.Tensor:
    """What the stop rule certifies for the round that stopped the loop, on
    its drawn coordinates D (`drawn_coordinates`): before that round every
    j in D had |s_j| <= tol / damping (its damped step was <= tol), so after
    it |s_j| <= tol ((1 - damping) / damping + sum_{i in D, i != j}
    2 |x_j . x_i| / (2 ||x_j||^2 + 2 lambda2)): the own damped step leaves
    (1 - damping) s_j, and each other step of at most tol moves j's target
    by its coupling (the soft threshold is 1-Lipschitz). Returns that bound
    for each j in D, in D's order."""
    XD = X[:, coords]
    G = torch.abs(XD.T @ XD)
    diag = torch.diagonal(G)
    cross = (G.sum(dim=1) - diag) * 2.0 / (2.0 * diag + 2.0 * float(lambda2))
    return tol * ((1.0 - damping) / damping + cross)


def full_draw_bound(X: torch.Tensor, lambda2: float, *, tol: float = 1e-10,
                    damping: float = 0.5) -> float:
    """What the stop rule certifies when every round draws every coordinate
    (parallel >= p): a bound on ||beta - beta*||_2 of X, lambda2 and tol
    alone, ||c|| (1 + ||X^T X - diag(X^T X)||_2 / lambda2), c the
    `stop_rule_bounds` of all p coordinates (`error_bound` with |s| <= c)."""
    p = X.shape[1]
    c = stop_rule_bounds(X, torch.arange(p, device=X.device), lambda2, tol=tol,
                         damping=damping)
    G = X.T @ X
    off = torch.linalg.matrix_norm(G - torch.diag(torch.diagonal(G)), ord=2)
    return float(torch.linalg.norm(c) * (1.0 + off / float(lambda2)))
