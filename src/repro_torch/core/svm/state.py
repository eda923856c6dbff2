"""The SolverState protocol — init/step/run machines driven from the host.

Every SVM solver here (primal Newton-CG, projected dual Newton) is the same
three functions as in `repro/core/svm/state.py`:

    init(hyper, x0=None) -> SolverState     starting carry
    step(state, hyper)   -> SolverState     one outer iteration
    run(hyper, x0=None)  -> SolverState     step to convergence

JAX runs `run` as a `lax.while_loop` on the device. Here it is a host loop
with the same stop rule, `~converged & iters < max_iters`: each loop test
reads one device boolean (`host_bool`), which is one host sync. The iterates
and the iteration counts are those of the JAX machines. The hyperparameters
(`Hyper.C`, `Hyper.tol`) are Python floats, so no other value crosses to
the host inside a solve.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def host_bool(x: torch.Tensor) -> bool:
    """A 0-d boolean tensor read on the host: the one sync of a loop test.

    `host_bool.syncs` counts the reads (a plain integer; callers reset it).
    """
    host_bool.syncs += 1
    return bool(x)


host_bool.syncs = 0


def host_float(x: torch.Tensor) -> float:
    """A 0-d tensor read on the host as a float: one host sync, counted in
    `host_bool.syncs` beside the loop tests."""
    host_bool.syncs += 1
    return float(x)


class Hyper(NamedTuple):
    """Solver hyperparameters, as host scalars."""

    C: float     # SVM cost 1/(2*lambda2), clamped (reduction.svm_C)
    tol: float   # outer-loop optimality tolerance


class SolverState(NamedTuple):
    """Common carry shared by all SVM solver machines."""

    x: torch.Tensor          # iterate: primal w (n,) or dual alpha (2p,)
    aux: Any                 # solver-private extras (inner CG iterations so far)
    iters: int               # outer-iteration count
    residual: torch.Tensor   # solver's optimality measure (sup-norm), 0-d
    converged: torch.Tensor  # 0-d bool: residual <= tol reached


class SolverMachine(NamedTuple):
    """An init/step/run triple closed over the problem operators."""

    init: Callable[..., SolverState]
    step: Callable[[SolverState, Hyper], SolverState]
    run: Callable[..., SolverState]


def make_hyper(C, tol) -> Hyper:
    """Coerce the hyperparameters to host floats."""
    return Hyper(C=float(C), tol=float(tol))


def initial_state(x0: torch.Tensor, aux: Any = 0) -> SolverState:
    return SolverState(
        x=x0,
        aux=aux,
        iters=0,
        residual=torch.full((), float("inf"), dtype=x0.dtype, device=x0.device),
        converged=torch.zeros((), dtype=torch.bool, device=x0.device),
    )


def run_machine(step: Callable[[SolverState, Hyper], SolverState],
                state: SolverState, hyper: Hyper, max_iters: int) -> SolverState:
    """Drive `step` to convergence: the host form of JAX's while_loop."""
    while state.iters < max_iters and host_bool(~state.converged):
        state = step(state, hyper)
    return state
