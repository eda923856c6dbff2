"""Streaming-row Elastic Net: rank-1 statistic updates + warm re-solves
(DESIGN.md §8). The port of `repro/runtime/online.py`.

The SVEN dual is built entirely from three sufficient statistics of the
data — G = X^T X, c = X^T y, r = y^T y (`core.reduction.gram_from_stats`)
— and the dual's size is 2p regardless of n. That makes row arrival the
cheap direction: absorbing a new sample (x, y_new) is the rank-1 update

    G += x x^T,    c += y_new x,    r += y_new^2,    n += 1

(O(p^2), no pass over history), and re-solving after an update is a dual
Newton solve on the refreshed (2p, 2p) kernel, warm-started from the
previous dual alpha — a few iterations, cost INDEPENDENT of how many rows
have streamed by. The alternative it replaces is a from-scratch `sven()`
on the concatenated data: O(np) per matvec.

Diagnostics never touch the raw rows either: the Elastic Net smooth
gradient is 2 (G beta - c) + 2 lambda2 beta, so the same KKT residual
`sven()` reports is available from the statistics
(`core.elastic_net.kkt_violation_from_grad`).

JAX jits `_absorb` and `_resolve`; here they are plain functions on the
session's device. `Xr.T @ Xr` and the dual's `K @ v` are `torch.matmul`,
as JAX computes them outside any Pallas kernel too.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import elastic_net as en
from repro_torch.core import reduction as red
from repro_torch.core.svm import solve_dual_fista, solve_dual_newton
from repro_torch.device import DeviceLike, resolve_device


class OnlineStats(NamedTuple):
    """Sufficient statistics of everything streamed so far."""

    G: torch.Tensor   # (p, p)  X^T X
    c: torch.Tensor   # (p,)    X^T y
    r: torch.Tensor   # ()      y^T y
    n: int            # rows absorbed (a host count)


class OnlineSolution(NamedTuple):
    beta: torch.Tensor        # (p,)
    alpha: torch.Tensor       # (2p,) dual iterate — next solve's warm start
    iters: int                # dual Newton iterations this re-solve cost
    kkt: torch.Tensor         # EN KKT violation from the statistics
    n: int                    # rows absorbed at solve time


def init_stats(p: int, dtype: torch.dtype = torch.float64,
               device: DeviceLike = None) -> OnlineStats:
    dev = resolve_device(device)
    return OnlineStats(G=torch.zeros((p, p), dtype=dtype, device=dev),
                       c=torch.zeros((p,), dtype=dtype, device=dev),
                       r=torch.zeros((), dtype=dtype, device=dev), n=0)


def _absorb(stats: OnlineStats, Xr: torch.Tensor, yr: torch.Tensor) -> OnlineStats:
    """Rank-k statistic update for a block of k arriving rows (k=1: rank-1)."""
    return OnlineStats(G=stats.G + Xr.T @ Xr, c=stats.c + Xr.T @ yr,
                       r=stats.r + yr @ yr, n=stats.n + Xr.shape[0])


def _resolve(stats: OnlineStats, t: float, lambda2: float, warm_alpha: torch.Tensor,
             solver: str, tol: float, lambda2_floor: float):
    """Dual solve on the statistics-built kernel."""
    dtype = stats.G.dtype
    K = red.gram_from_stats(stats.G, stats.c / t, stats.r / (t * t))
    C = red.svm_C(lambda2, floor=lambda2_floor)
    solve = solve_dual_newton if solver == "newton" else solve_dual_fista
    res = solve(lambda v: K @ v, K.shape[0], C, dtype=dtype, device=K.device, tol=tol,
                alpha0=warm_alpha)
    beta = red.recover_beta(res.alpha, t)
    g = 2.0 * (stats.G @ beta - stats.c) + 2.0 * lambda2 * beta
    return beta, res.alpha, res.iters, en.kkt_violation_from_grad(g, beta)


@dataclasses.dataclass
class OnlineElasticNet:
    """A p-fixed Elastic Net session over streaming rows.

    `update(X_rows, y_rows)` absorbs arriving samples into the sufficient
    statistics; `solve(t, lambda2)` re-solves the constrained problem on
    whatever has arrived, warm-started from the previous call's dual alpha.
    Equal to a from-scratch `sven()` on the concatenated rows to solver
    tolerance (tested), at O(p^2) per arrival instead of O(n p).

    The statistics live on `device` (the CUDA device when none is named;
    with no CUDA device and none named it raises).
    """

    p: int
    dtype: torch.dtype = torch.float64
    solver: str = "newton"
    tol: float = 1e-8
    lambda2_floor: float = red.LAMBDA2_FLOOR
    device: Optional[DeviceLike] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.stats = init_stats(self.p, self.dtype, self.device)
        self._warm_alpha = torch.zeros((2 * self.p,), dtype=self.dtype, device=self.device)
        self.updates = 0
        self.solves = 0

    @property
    def n(self) -> int:
        return self.stats.n

    def update(self, X_rows, y_rows) -> "OnlineElasticNet":
        """Absorb one row ((p,)/scalar) or a block ((k, p)/(k,))."""
        Xr = torch.as_tensor(X_rows, dtype=self.dtype, device=self.device)
        yr = torch.as_tensor(y_rows, dtype=self.dtype, device=self.device)
        if Xr.dim() == 1:
            Xr, yr = Xr[None, :], yr.reshape(1)
        if Xr.dim() != 2 or Xr.shape[1] != self.p or yr.shape != (Xr.shape[0],):
            raise ValueError(f"update: bad shapes X{tuple(Xr.shape)} y{tuple(yr.shape)} "
                             f"for p={self.p}")
        self.stats = _absorb(self.stats, Xr, yr)
        self.updates += 1
        return self

    def solve(self, t: float, lambda2: float = 1.0) -> OnlineSolution:
        if not (t > 0 and lambda2 >= 0):
            raise ValueError(f"solve: need t > 0, lambda2 >= 0 "
                             f"(t={t}, lambda2={lambda2})")
        if self.n == 0:
            raise ValueError("solve: no rows absorbed yet")
        beta, alpha, iters, kkt = _resolve(
            self.stats, float(t), float(lambda2), self._warm_alpha, self.solver, self.tol,
            self.lambda2_floor)
        self._warm_alpha = alpha
        self.solves += 1
        return OnlineSolution(beta=beta, alpha=alpha, iters=iters, kkt=kkt,
                              n=self.n)
