"""Projected FISTA on the SVM dual — a first-order alternative to Newton.

Same bound-constrained QP as dual_newton; accelerated projected gradient with
step 1/L, L = lambda_max(2K + I/C) estimated by power iteration (times 1.02).
Linear convergence via strong convexity 1/C. PyTorch counterpart of
`repro/core/svm/dual_fista.py`, with the same arithmetic: the momentum pair
(z, tk) and the step size live in `state.aux`, computed once at init.
`dual_fista_lanes_machine` runs B problems at once, each lane with the
single machine's arithmetic.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.core.svm.dual_newton import DualResult, _dual_obj, dual_obj_lanes
from repro_torch.core.svm.state import (Hyper, LaneHyper, SolverMachine, SolverState,
                                        initial_lane_state, initial_state, lane_dot,
                                        lanes, make_hyper, make_lane_hyper, run_lane_machine,
                                        run_machine)


def _power_iter_L(hess_mv: Callable, m: int, dtype, device, iters: int = 30
                  ) -> torch.Tensor:
    v = torch.ones(m, dtype=dtype, device=device) / math.sqrt(m)
    for _ in range(iters):
        w = hess_mv(v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return v @ hess_mv(v)


def dual_fista_machine(
    kernel_matvec: Callable[[torch.Tensor], torch.Tensor],
    m: int,
    *,
    dtype: torch.dtype = torch.float64,
    device: Optional[torch.device] = None,
    max_iters: int = 5000,
) -> SolverMachine:
    """Projected FISTA as a SolverState machine; aux = (z, tk, step)."""

    def grad_fn(a, C):
        return 2.0 * kernel_matvec(a) + a / C - 2.0

    def init(hyper: Hyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        a0 = (torch.zeros(m, dtype=dtype, device=device) if x0 is None
              else x0.to(dtype))

        def hess_mv(v):
            return 2.0 * kernel_matvec(v) + v / hyper.C

        L = _power_iter_L(hess_mv, m, dtype, a0.device) * 1.02
        aux = (a0, torch.ones((), dtype=dtype, device=a0.device), 1.0 / L)
        return initial_state(a0, aux=aux)

    def step(state: SolverState, hyper: Hyper) -> SolverState:
        a = state.x
        z, tk, stepsz = state.aux
        g = grad_fn(z, hyper.C)
        a_new = torch.clamp(z - stepsz * g, min=0.0)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        z_new = a_new + ((tk - 1.0) / t_new) * (a_new - a)
        g_new = grad_fn(a_new, hyper.C)
        pg = torch.max(torch.abs(torch.where(a_new > 0, g_new,
                                             torch.clamp(g_new, max=0.0))))
        # ~(> tol): NaN residual is terminal (diverged), not "keep iterating"
        return SolverState(x=a_new, aux=(z_new, t_new, stepsz),
                           iters=state.iters + 1, residual=pg,
                           converged=~(pg > hyper.tol))

    def run(hyper: Hyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        return run_machine(step, init(hyper, x0), hyper, max_iters)

    return SolverMachine(init=init, step=step, run=run)


def solve_dual_fista(
    kernel_matvec: Callable[[torch.Tensor], torch.Tensor],
    m: int,
    C,
    *,
    dtype: torch.dtype = torch.float64,
    device: Optional[torch.device] = None,
    tol=1e-7,
    max_iters: int = 5000,
    alpha0: Optional[torch.Tensor] = None,
) -> DualResult:
    """Classic-signature wrapper over the machine; `cg_iters` is 0 (FISTA
    runs no inner CG)."""
    machine = dual_fista_machine(kernel_matvec, m, dtype=dtype, device=device,
                                 max_iters=max_iters)
    hyper = make_hyper(C, tol)
    st = machine.run(hyper, alpha0)
    return DualResult(alpha=st.x, iters=st.iters, pg_norm=st.residual,
                      objective=_dual_obj(kernel_matvec, st.x, hyper.C), cg_iters=0)


def dual_fista_lanes_machine(
    kernel_matvec: Callable[[torch.Tensor], torch.Tensor],   # v (B, m) -> K v (B, m)
    m: int,
    B: int,
    *,
    dtype: torch.dtype = torch.float64,
    device: Optional[torch.device] = None,
    max_iters: int = 5000,
) -> SolverMachine:
    """Projected FISTA for B lanes as a machine; aux = (z (B, m), tk (B,),
    step (B,)), each lane's step from its own power iteration."""

    def grad_fn(a, C):
        return 2.0 * kernel_matvec(a) + a / C[:, None] - 2.0

    def init(hyper: LaneHyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        a0 = (torch.zeros((B, m), dtype=dtype, device=device) if x0 is None
              else x0.to(dtype))

        def hess_mv(v):
            return 2.0 * kernel_matvec(v) + v / hyper.C[:, None]

        v = torch.ones((B, m), dtype=dtype, device=a0.device) / math.sqrt(m)
        for _ in range(30):
            w = hess_mv(v)
            v = w / torch.clamp(lanes(torch.linalg.norm, w), min=1e-30)[:, None]
        L = lane_dot(v, hess_mv(v)) * 1.02
        aux = (a0, torch.ones(B, dtype=dtype, device=a0.device), 1.0 / L)
        return initial_lane_state(a0, aux=aux)

    def step(state: SolverState, hyper: LaneHyper,
             active: Optional[torch.Tensor] = None) -> SolverState:
        del active   # no inner loop: the machine's loop freezes finished lanes
        a = state.x
        z, tk, stepsz = state.aux
        g = grad_fn(z, hyper.C)
        a_new = torch.clamp(z - stepsz[:, None] * g, min=0.0)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        z_new = a_new + ((tk - 1.0) / t_new)[:, None] * (a_new - a)
        g_new = grad_fn(a_new, hyper.C)
        pg = torch.amax(torch.abs(torch.where(a_new > 0, g_new,
                                              torch.clamp(g_new, max=0.0))), dim=-1)
        return SolverState(x=a_new, aux=(z_new, t_new, stepsz),
                           iters=state.iters + 1, residual=pg,
                           converged=~(pg > hyper.tol))

    def run(hyper: LaneHyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        return run_lane_machine(step, init(hyper, x0), hyper, max_iters)

    return SolverMachine(init=init, step=step, run=run)


def solve_dual_fista_lanes(
    kernel_matvec: Callable[[torch.Tensor], torch.Tensor],
    m: int,
    C,
    B: int,
    *,
    dtype: torch.dtype = torch.float64,
    device: Optional[torch.device] = None,
    tol=1e-7,
    max_iters: int = 5000,
    alpha0: Optional[torch.Tensor] = None,
) -> DualResult:
    """`solve_dual_fista` for B lanes; `cg_iters` is zeros (B,)."""
    machine = dual_fista_lanes_machine(kernel_matvec, m, B, dtype=dtype, device=device,
                                       max_iters=max_iters)
    hyper = make_lane_hyper(C, tol, B, dtype, device)
    st = machine.run(hyper, alpha0)
    return DualResult(alpha=st.x, iters=st.iters, pg_norm=st.residual,
                      objective=dual_obj_lanes(kernel_matvec, st.x, hyper.C),
                      cg_iters=torch.zeros_like(st.iters))
