"""Hand-written CUDA kernels of the SVEN solvers and the hinge-stats op,
their plain PyTorch versions, and the ops that choose between them (see ops.py)."""
from repro_torch.kernels import ops, ref, registry
from repro_torch.kernels.gram import shifted_gram_cuda
from repro_torch.kernels.hinge import (hinge_xd_cuda, hinge_xd_lanes_cuda, hinge_xtv_cuda,
                                      hinge_xtv_lanes_cuda)
from repro_torch.kernels.hinge_stats import hinge_stats_cuda
from repro_torch.kernels.ops import (hinge_hessian_matvec, hinge_hessian_matvec_lanes,
                                     hinge_stats, sharded_shifted_gram, shifted_gram)
from repro_torch.kernels.registry import resolve_kernel_backend

#: every kernel wrapper (each has a `.launches` counter)
WRAPPERS = (shifted_gram_cuda, hinge_xtv_cuda, hinge_xd_cuda, hinge_stats_cuda,
            hinge_xtv_lanes_cuda, hinge_xd_lanes_cuda)


def reset_launches() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    for w in WRAPPERS:
        w.launches = 0


def launches() -> dict:
    """{wrapper name: launches since the last reset}."""
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = ["WRAPPERS", "hinge_hessian_matvec", "hinge_hessian_matvec_lanes",
           "hinge_stats", "hinge_stats_cuda", "hinge_xd_cuda", "hinge_xd_lanes_cuda",
           "hinge_xtv_cuda", "hinge_xtv_lanes_cuda", "launches", "ops", "ref",
           "registry", "reset_launches", "resolve_kernel_backend", "sharded_shifted_gram",
           "shifted_gram", "shifted_gram_cuda"]
