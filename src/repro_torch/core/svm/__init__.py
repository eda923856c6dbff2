from repro_torch.core.svm.state import (Hyper, SolverMachine, SolverState,
                                        host_bool, make_hyper, run_machine)
from repro_torch.core.svm.primal_newton import (PrimalResult, primal_newton_machine,
                                                solve_primal_newton)
from repro_torch.core.svm.dual_newton import (DualResult, dual_newton_machine,
                                              solve_dual_newton)

__all__ = [
    "Hyper",
    "SolverMachine",
    "SolverState",
    "host_bool",
    "make_hyper",
    "run_machine",
    "primal_newton_machine",
    "dual_newton_machine",
    "solve_primal_newton",
    "solve_dual_newton",
    "PrimalResult",
    "DualResult",
]
