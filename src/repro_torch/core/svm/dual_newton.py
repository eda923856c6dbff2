"""Squared-hinge SVM dual: projected Newton with active sets.

    min_{alpha >= 0} D(alpha) = alpha^T K alpha + 1/(2C) ||alpha||^2
                                - 2 sum(alpha)                     (paper eq. 3)

with K = Zhat^T Zhat. grad = 2 K alpha + alpha/C - 2; the Hessian
H = 2K + I/C is constant and PD, so a projected Newton method with a
free/clamped split converges in finitely many outer iterations:

    F   = {i : alpha_i > 0  or  grad_i < 0}        (free set)
    solve (H d)_F = grad_F, d_{F^c} = 0 via masked CG
    alpha <- max(0, alpha - s d), backtracking on D

The kernel mat-vec is a callable: `lambda v: K @ v` with a cached kernel
matrix, or the matrix-free O(np) SvenOperator product. PyTorch counterpart
of `repro/core/svm/dual_newton.py`, with the same arithmetic.
`dual_newton_lanes_machine` runs B problems at once (the vmapped machine of
`repro/core/batch.py`), each lane with the arithmetic of the single one.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.svm.state import (Hyper, LaneHyper, SolverMachine, SolverState,
                                        cg_lanes, device_ints, host_bool, initial_lane_state,
                                        initial_state, lane_dot, lanes, make_hyper,
                                        make_lane_hyper, run_lane_machine, run_machine)


class DualResult(NamedTuple):
    alpha: torch.Tensor
    iters: int
    pg_norm: torch.Tensor      # projected-gradient sup-norm
    objective: torch.Tensor
    cg_iters: int              # inner CG iterations over the whole solve


def _masked_cg(matvec: Callable, b: torch.Tensor, mask: torch.Tensor,
               maxiter: int, tol: float):
    """CG restricted to coordinates where mask==1 (others pinned to 0):
    `cg_lanes` on one lane. Returns (x, iterations)."""

    def mv(v):
        return mask * matvec(mask * v)

    x, _, it = cg_lanes(mv, mask * b, None, maxiter, tol)
    return x, it


def _dual_obj(kernel_matvec, alpha, C):
    return (alpha @ kernel_matvec(alpha)
            + (alpha @ alpha) / (2.0 * C) - 2.0 * torch.sum(alpha))


def dual_newton_machine(
    kernel_matvec: Callable[[torch.Tensor], torch.Tensor],   # v (m,) -> K v (m,)
    m: int,
    *,
    dtype: torch.dtype = torch.float64,
    device: Optional[torch.device] = None,
    max_newton: int = 100,
    cg_iters: int = 250,
) -> SolverMachine:
    """Projected Newton as a SolverState machine; `aux` counts CG iterations."""

    def grad_fn(alpha, C):
        return 2.0 * kernel_matvec(alpha) + alpha / C - 2.0

    def init(hyper: Hyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        del hyper
        a0 = (torch.zeros(m, dtype=dtype, device=device) if x0 is None
              else x0.to(dtype))
        return initial_state(a0)

    def step(state: SolverState, hyper: Hyper) -> SolverState:
        alpha, C = state.x, hyper.C
        g = grad_fn(alpha, C)
        free = ((alpha > 0) | (g < 0)).to(dtype)

        def hess_mv(v):
            return 2.0 * kernel_matvec(v) + v / C

        d, n_cg = _masked_cg(hess_mv, g, free, cg_iters, hyper.tol * 1e-2)

        f0 = _dual_obj(kernel_matvec, alpha, C)
        f_floor = f0 - 1e-12 * torch.abs(f0)

        def proj(s):
            return torch.clamp(alpha - s * d, min=0.0)

        s = 1.0
        fv = _dual_obj(kernel_matvec, proj(s), C)
        while s > 1e-12 and host_bool(fv > f_floor):
            s = s * 0.5
            fv = _dual_obj(kernel_matvec, proj(s), C)
        alpha_new = proj(s)
        # projected gradient: optimality measure for the bound-constrained QP
        g_new = grad_fn(alpha_new, C)
        pg = torch.max(torch.abs(torch.where(alpha_new > 0, g_new,
                                             torch.clamp(g_new, max=0.0))))
        # ~(> tol): NaN residual is terminal (diverged), not "keep iterating"
        return SolverState(x=alpha_new, aux=state.aux + n_cg,
                           iters=state.iters + 1, residual=pg,
                           converged=~(pg > hyper.tol))

    def run(hyper: Hyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        return run_machine(step, init(hyper, x0), hyper, max_newton)

    return SolverMachine(init=init, step=step, run=run)


def solve_dual_newton(
    kernel_matvec: Callable[[torch.Tensor], torch.Tensor],
    m: int,
    C,
    *,
    dtype: torch.dtype = torch.float64,
    device: Optional[torch.device] = None,
    tol=1e-8,
    max_newton: int = 100,
    cg_iters: int = 250,
    alpha0: Optional[torch.Tensor] = None,
) -> DualResult:
    """Classic-signature wrapper over the machine."""
    machine = dual_newton_machine(kernel_matvec, m, dtype=dtype, device=device,
                                  max_newton=max_newton, cg_iters=cg_iters)
    hyper = make_hyper(C, tol)
    st = machine.run(hyper, alpha0)
    return DualResult(alpha=st.x, iters=st.iters, pg_norm=st.residual,
                      objective=_dual_obj(kernel_matvec, st.x, hyper.C),
                      cg_iters=st.aux)


def dual_obj_lanes(kernel_matvec, alpha: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Each lane's dual objective, (B,): `_dual_obj` of alpha (B, m), C (B,)."""
    return (lane_dot(alpha, kernel_matvec(alpha))
            + lane_dot(alpha, alpha) / (2.0 * C) - 2.0 * lanes(torch.sum, alpha))


def dual_newton_lanes_machine(
    kernel_matvec: Callable[[torch.Tensor], torch.Tensor],   # v (B, m) -> K v (B, m)
    m: int,
    B: int,
    *,
    dtype: torch.dtype = torch.float64,
    device: Optional[torch.device] = None,
    max_newton: int = 100,
    cg_iters: int = 250,
) -> SolverMachine:
    """Projected Newton for B lanes as a machine: `step(state, hyper,
    active)` steps every lane with the single machine's arithmetic, CG and
    line search masked per lane; `aux` counts each lane's CG iterations."""

    def grad_fn(alpha, C):
        return 2.0 * kernel_matvec(alpha) + alpha / C - 2.0

    def init(hyper: LaneHyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        del hyper
        a0 = (torch.zeros((B, m), dtype=dtype, device=device) if x0 is None
              else x0.to(dtype))
        return initial_lane_state(a0)

    def step(state: SolverState, hyper: LaneHyper,
             active: Optional[torch.Tensor] = None) -> SolverState:
        alpha, C = state.x, hyper.C[:, None]
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=alpha.device)
        g = grad_fn(alpha, C)
        free = ((alpha > 0) | (g < 0)).to(dtype)

        def masked_hess_mv(v):
            v = free * v
            return free * (2.0 * kernel_matvec(v) + v / C)

        d, n_cg, _ = cg_lanes(masked_hess_mv, free * g, active, cg_iters, hyper.tol * 1e-2)
        n_cg = device_ints(n_cg, alpha.device)

        f0 = dual_obj_lanes(kernel_matvec, alpha, hyper.C)
        f_floor = f0 - 1e-12 * torch.abs(f0)

        def proj(s):
            return torch.clamp(alpha - s[:, None] * d, min=0.0)

        s = torch.ones_like(f0)
        fv = dual_obj_lanes(kernel_matvec, proj(s), hyper.C)
        while True:
            halve = active & (s > 1e-12) & (fv > f_floor)
            if not host_bool(halve.any()):
                break
            s = torch.where(halve, s * 0.5, s)
            fv = torch.where(halve, dual_obj_lanes(kernel_matvec, proj(s), hyper.C), fv)
        alpha_new = proj(s)
        g_new = grad_fn(alpha_new, C)
        pg = torch.amax(torch.abs(torch.where(alpha_new > 0, g_new,
                                              torch.clamp(g_new, max=0.0))), dim=-1)
        return SolverState(x=alpha_new, aux=state.aux + n_cg,
                           iters=state.iters + 1, residual=pg,
                           converged=~(pg > hyper.tol))

    def run(hyper: LaneHyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        return run_lane_machine(step, init(hyper, x0), hyper, max_newton)

    return SolverMachine(init=init, step=step, run=run)


def solve_dual_newton_lanes(
    kernel_matvec: Callable[[torch.Tensor], torch.Tensor],
    m: int,
    C,
    B: int,
    *,
    dtype: torch.dtype = torch.float64,
    device: Optional[torch.device] = None,
    tol=1e-8,
    max_newton: int = 100,
    cg_iters: int = 250,
    alpha0: Optional[torch.Tensor] = None,
) -> DualResult:
    """`solve_dual_newton` for B lanes: C and tol are (B,) tensors or
    scalars; every field of the result has a leading lane axis."""
    machine = dual_newton_lanes_machine(kernel_matvec, m, B, dtype=dtype, device=device,
                                        max_newton=max_newton, cg_iters=cg_iters)
    hyper = make_lane_hyper(C, tol, B, dtype, device)
    st = machine.run(hyper, alpha0)
    return DualResult(alpha=st.x, iters=st.iters, pg_norm=st.residual,
                      objective=dual_obj_lanes(kernel_matvec, st.x, hyper.C),
                      cg_iters=st.aux)
