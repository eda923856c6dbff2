"""Squared-hinge linear SVM, primal Newton-CG (Chapelle 2007), no bias.

    min_w f(w) = 1/2 ||w||^2 + C sum_i max(0, 1 - yhat_i w^T xhat_i)^2

Newton system at the current support-vector set SV = {i : margin_i < 1}:

    H = I + 2C Xhat_SV^T Xhat_SV
    H d = grad,   grad = w + 2C Xhat^T (act * (Xhat w - yhat))

solved matrix-free with conjugate gradients (the H mat-vec is two Xhat
products masked by `act`, or the fused two-pass hinge kernel through the
`hess_matvec` override), followed by a linearized backtracking line search.
PyTorch counterpart of `repro/core/svm/primal_newton.py`, with the same
arithmetic. `primal_newton_lanes_machine` runs B problems at once (the
vmapped machine of `repro/core/batch.py`), each lane with the arithmetic
of the single machine.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.svm.state import (Hyper, LaneHyper, SolverMachine, SolverState,
                                        cg_lanes, device_ints, host_bool, initial_lane_state,
                                        initial_state, lane_dot, make_hyper, make_lane_hyper,
                                        run_lane_machine, run_machine)


class PrimalResult(NamedTuple):
    w: torch.Tensor
    iters: int
    grad_norm: torch.Tensor
    objective: torch.Tensor
    cg_iters: int              # inner CG iterations over the solve (the H v products
                               # less the dead steps, `state.cg_lanes.dead`)


def _cg(matvec: Callable, b: torch.Tensor, maxiter: int, tol: float):
    """Plain CG on SPD `matvec`, early exit on tol: `cg_lanes` on one lane.
    Returns (x, iterations)."""
    x, _, it = cg_lanes(matvec, b, None, maxiter, tol)
    return x, it


def _primal_obj(matvec: Callable, yhat: torch.Tensor, w: torch.Tensor, C) -> torch.Tensor:
    """f(w) = 1/2 ||w||^2 + C sum_i max(0, 1 - yhat_i (Xhat w)_i)^2."""
    o = matvec(w)
    act = (yhat * o) < 1.0
    xi = torch.where(act, 1.0 - yhat * o, torch.zeros_like(o))
    return 0.5 * (w @ w) + C * (xi @ xi)


def primal_newton_machine(
    matvec: Callable[[torch.Tensor], torch.Tensor],     # w (d,) -> Xhat @ w (m,)
    rmatvec: Callable[[torch.Tensor], torch.Tensor],    # v (m,) -> Xhat^T v (d,)
    yhat: torch.Tensor,                                 # (m,) labels in {+1,-1}
    d: int,
    *,
    max_newton: int = 50,
    cg_iters: int = 250,
    hess_matvec: Optional[Callable] = None,             # (v, act, C) -> H v (kernel)
) -> SolverMachine:
    """Newton-CG as a SolverState machine; `aux` counts CG iterations."""
    dtype = yhat.dtype

    def init(hyper: Hyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        del hyper
        w0 = (torch.zeros(d, dtype=dtype, device=yhat.device) if x0 is None
              else x0.to(dtype))
        return initial_state(w0)

    def step(state: SolverState, hyper: Hyper) -> SolverState:
        w, C = state.x, hyper.C
        o = matvec(w)
        act = ((yhat * o) < 1.0).to(dtype)
        grad = w + 2.0 * C * rmatvec(act * (o - yhat))

        if hess_matvec is None:
            def hess_mv(v):
                return v + 2.0 * C * rmatvec(act * matvec(v))
        else:
            def hess_mv(v):
                return hess_matvec(v, act, C)

        dstep, n_cg = _cg(hess_mv, grad, cg_iters, hyper.tol * 1e-2)

        # Backtracking (Armijo) line search on f along -dstep, LINEARIZED:
        # matvec is linear, so Xhat (w - s d) = o - s (Xhat d) — one extra
        # matvec (od) per Newton step and every f evaluation is vector math.
        od = matvec(dstep)
        ww_ = w @ w
        wd = w @ dstep
        dd = dstep @ dstep
        zero = torch.zeros_like(o)

        def f_line(s):
            m = yhat * (o - s * od)
            xi = torch.where(m < 1.0, 1.0 - m, zero)
            return 0.5 * (ww_ - 2.0 * s * wd + s * s * dd) + C * (xi @ xi)

        f0 = f_line(0.0)
        gd = grad @ dstep

        s = 1.0
        fv = f_line(s)
        while s > 1e-10 and host_bool(fv > f0 - 1e-4 * s * gd):
            s = s * 0.5
            fv = f_line(s)
        gnorm = torch.max(torch.abs(grad))
        # ~(> tol) rather than (<= tol): a NaN residual counts as terminal,
        # so a diverged solve exits instead of spinning to max_iters.
        return SolverState(x=w - s * dstep, aux=state.aux + n_cg,
                           iters=state.iters + 1, residual=gnorm,
                           converged=~(gnorm > hyper.tol))

    def run(hyper: Hyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        return run_machine(step, init(hyper, x0), hyper, max_newton)

    return SolverMachine(init=init, step=step, run=run)


def solve_primal_newton(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    yhat: torch.Tensor,
    C,
    d: int,
    *,
    tol=1e-8,
    max_newton: int = 50,
    cg_iters: int = 250,
    w0: Optional[torch.Tensor] = None,
    hess_matvec: Optional[Callable] = None,
) -> PrimalResult:
    """Classic-signature wrapper over the machine."""
    machine = primal_newton_machine(matvec, rmatvec, yhat, d,
                                    max_newton=max_newton, cg_iters=cg_iters,
                                    hess_matvec=hess_matvec)
    hyper = make_hyper(C, tol)
    st = machine.run(hyper, w0)
    return PrimalResult(w=st.x, iters=st.iters, grad_norm=st.residual,
                        objective=_primal_obj(matvec, yhat, st.x, hyper.C),
                        cg_iters=st.aux)


def primal_newton_lanes_machine(
    matvec: Callable[[torch.Tensor], torch.Tensor],     # w (B, d) -> Xhat w (B, m)
    rmatvec: Callable[[torch.Tensor], torch.Tensor],    # v (B, m) -> Xhat^T v (B, d)
    yhat: torch.Tensor,                                 # (m,) labels, shared
    d: int,
    B: int,
    *,
    max_newton: int = 50,
    cg_iters: int = 250,
    hess_matvec: Optional[Callable] = None,             # (v, act, C (B,)) -> H v
) -> SolverMachine:
    """Newton-CG for B lanes as a machine: `step(state, hyper, active)`
    steps every lane with the single machine's arithmetic, CG and line
    search masked per lane; `aux` counts each lane's CG iterations."""
    dtype = yhat.dtype

    def init(hyper: LaneHyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        del hyper
        w0 = (torch.zeros((B, d), dtype=dtype, device=yhat.device) if x0 is None
              else x0.to(dtype))
        return initial_lane_state(w0)

    def step(state: SolverState, hyper: LaneHyper,
             active: Optional[torch.Tensor] = None) -> SolverState:
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=yhat.device)
        w, C = state.x, hyper.C[:, None]
        o = matvec(w)
        act = ((yhat * o) < 1.0).to(dtype)
        grad = w + 2.0 * C * rmatvec(act * (o - yhat))

        if hess_matvec is None:
            def hess_mv(v):
                return v + 2.0 * C * rmatvec(act * matvec(v))
        else:
            def hess_mv(v):
                return hess_matvec(v, act, hyper.C)

        dstep, n_cg, _ = cg_lanes(hess_mv, grad, active, cg_iters, hyper.tol * 1e-2)
        n_cg = device_ints(n_cg, w.device)

        # the single machine's linearized Armijo search, s (B,) per lane
        od = matvec(dstep)
        ww_ = lane_dot(w, w)
        wd = lane_dot(w, dstep)
        dd = lane_dot(dstep, dstep)
        zero = torch.zeros_like(o)

        def f_line(s):
            m = yhat * (o - s[:, None] * od)
            xi = torch.where(m < 1.0, 1.0 - m, zero)
            return 0.5 * (ww_ - 2.0 * s * wd + s * s * dd) + hyper.C * lane_dot(xi, xi)

        f0 = f_line(torch.zeros_like(ww_))
        gd = lane_dot(grad, dstep)

        s = torch.ones_like(ww_)
        fv = f_line(s)
        while True:
            halve = active & (s > 1e-10) & (fv > f0 - 1e-4 * s * gd)
            if not host_bool(halve.any()):
                break
            s = torch.where(halve, s * 0.5, s)
            fv = torch.where(halve, f_line(s), fv)
        gnorm = torch.amax(torch.abs(grad), dim=-1)
        return SolverState(x=w - s[:, None] * dstep, aux=state.aux + n_cg,
                           iters=state.iters + 1, residual=gnorm,
                           converged=~(gnorm > hyper.tol))

    def run(hyper: LaneHyper, x0: Optional[torch.Tensor] = None) -> SolverState:
        return run_lane_machine(step, init(hyper, x0), hyper, max_newton)

    return SolverMachine(init=init, step=step, run=run)


def solve_primal_newton_lanes(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    yhat: torch.Tensor,
    C,
    d: int,
    B: int,
    *,
    tol=1e-8,
    max_newton: int = 50,
    cg_iters: int = 250,
    w0: Optional[torch.Tensor] = None,
    hess_matvec: Optional[Callable] = None,
) -> PrimalResult:
    """`solve_primal_newton` for B lanes: C and tol are (B,) tensors or
    scalars; every field of the result has a leading lane axis (iters and
    cg_iters are (B,) int64 tensors)."""
    machine = primal_newton_lanes_machine(matvec, rmatvec, yhat, d, B,
                                          max_newton=max_newton, cg_iters=cg_iters,
                                          hess_matvec=hess_matvec)
    hyper = make_lane_hyper(C, tol, B, yhat.dtype, yhat.device)
    st = machine.run(hyper, w0)
    o = matvec(st.x)
    xi = torch.where((yhat * o) < 1.0, 1.0 - yhat * o, torch.zeros_like(o))
    return PrimalResult(w=st.x, iters=st.iters, grad_norm=st.residual,
                        objective=0.5 * lane_dot(st.x, st.x) + hyper.C * lane_dot(xi, xi),
                        cg_iters=st.aux)
