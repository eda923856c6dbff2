"""Public kernel ops: body resolution through the registry, storage dtype.

One `backend` value picks the body (kernels/registry.py): "cuda" runs the
hand-written kernel, "ref" the plain PyTorch version, None/"auto" picks
from the operands' device. On a CUDA tensor the kernel runs or the call
raises; nothing drops to the plain version.

`precision` ("f32" | "bf16" | "tf32") selects the storage dtype of X (and
of y in the Gram) and the Gram's multiply mode; sums are float32 in every
mode. PyTorch counterpart of `repro/kernels/ops.py` (`shifted_gram`,
`hinge_hessian_matvec`); the Pallas tile arguments have no counterpart.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import gram as _gram
from repro_torch.kernels import hinge as _hinge
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import registry

PRECISIONS = ("f32", "bf16", "tf32")


def _gram_ref(X, y, t, *, precision: str = "f32", flatten: bool = True):
    Kb = _ref.gram_blocks_ref(X, y, t, precision)
    return _ref.flatten_gram(Kb) if flatten else Kb


registry.register("shifted_gram", "cuda")(_gram.shifted_gram_cuda)
registry.register("shifted_gram", "ref")(_gram_ref)
registry.register("hinge_xtv", "cuda")(_hinge.hinge_xtv_cuda)
registry.register("hinge_xtv", "ref")(_ref.hinge_xtv_ref)
registry.register("hinge_xd", "cuda")(_hinge.hinge_xd_cuda)
registry.register("hinge_xd", "ref")(_ref.hinge_xd_ref)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _storage(X: torch.Tensor, precision: str) -> torch.Tensor:
    """bf16 keeps reduced-precision STORAGE (kernels accumulate f32
    regardless); f32/tf32 leave the operand alone."""
    return X.to(torch.bfloat16) if precision == "bf16" else X


def shifted_gram(
    X: torch.Tensor,
    y: torch.Tensor,
    t: float,
    *,
    flatten: bool = True,
    backend: Optional[str] = None,
    precision: str = "f32",
) -> torch.Tensor:
    """K = Zhat^T Zhat of the SVEN dual, as (2p, 2p) (flatten) or (2,2,p,p)."""
    _check_precision(precision)
    body = registry.resolve_kernel_backend(backend, X, y)
    impl = registry.lookup("shifted_gram", body)
    return impl(_storage(X, precision), _storage(y, precision), t,
                precision=precision, flatten=flatten)


def hinge_hessian_matvec(
    X: torch.Tensor,
    y: torch.Tensor,
    t: float,
    C: float,
    act_top: torch.Tensor,
    act_bot: torch.Tensor,
    v: torch.Tensor,
    *,
    backend: Optional[str] = None,
    precision: str = "f32",
) -> torch.Tensor:
    """H v = v + 2C Xhat^T(act . (Xhat v)) via two fused GEMV passes.

    Pass 1 returns e in the body's own form (a 0-d sum for "ref", per-block
    partials for "cuda"), which pass 2 of the same body takes as it is.
    """
    _check_precision(precision)
    body = registry.resolve_kernel_backend(backend, X, v)
    Xs = _storage(X, precision)
    d, e = registry.lookup("hinge_xtv", body)(Xs, y, v, t, act_top, act_bot)
    return registry.lookup("hinge_xd", body)(Xs, y, d, e, v, t, C)
