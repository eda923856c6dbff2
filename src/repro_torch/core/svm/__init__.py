from repro_torch.core.svm.state import (Hyper, SolverMachine, SolverState,
                                        host_bool, host_float, make_hyper,
                                        run_machine)
from repro_torch.core.svm.primal_newton import (PrimalResult, primal_newton_machine,
                                                solve_primal_newton)
from repro_torch.core.svm.dual_newton import (DualResult, dual_newton_machine,
                                              solve_dual_newton)
from repro_torch.core.svm.dual_fista import dual_fista_machine, solve_dual_fista

__all__ = [
    "Hyper",
    "SolverMachine",
    "SolverState",
    "host_bool",
    "host_float",
    "make_hyper",
    "run_machine",
    "primal_newton_machine",
    "dual_newton_machine",
    "dual_fista_machine",
    "solve_primal_newton",
    "solve_dual_newton",
    "solve_dual_fista",
    "PrimalResult",
    "DualResult",
]
