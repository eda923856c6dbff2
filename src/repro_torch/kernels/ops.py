"""Public kernel ops: body resolution through the registry, storage dtype.

One `backend` value picks the body (kernels/registry.py): "cuda" runs the
hand-written kernel, "ref" the plain PyTorch version, None/"auto" picks
from the operands' device. On a CUDA tensor the kernel runs or the call
raises; nothing drops to the plain version.

`precision` ("f32" | "bf16" | "tf32") selects the storage dtype of X (and
of y in the Gram) and the Gram's multiply mode. Sums are float32 in every
mode, except that float64 operands at "f32" are summed in float64, by the
Gram and by both hinge passes (the kernels' float64 bodies, and the plain
versions in the operands' dtype), so a float64 problem gets its own float64
K and H v. `hinge_stats` takes float32 (or bfloat16) X in every mode.
PyTorch counterpart of `repro/kernels/ops.py` (`shifted_gram`,
`hinge_hessian_matvec`, `hinge_stats`); the Pallas tile arguments have no
counterpart. `hinge_hessian_matvec_lanes` is the counterpart of
`hinge_hessian_matvec` under JAX's vmap: one launch of each pass for a
stack of problems.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import gram as _gram
from repro_torch.kernels import hinge as _hinge
from repro_torch.kernels import hinge_stats as _hinge_stats
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
registry.register("hinge_xtv_lanes", "cuda")(_hinge.hinge_xtv_lanes_cuda)
registry.register("hinge_xtv_lanes", "ref")(_ref.hinge_xtv_lanes_ref)
registry.register("hinge_xd_lanes", "cuda")(_hinge.hinge_xd_lanes_cuda)
registry.register("hinge_xd_lanes", "ref")(_ref.hinge_xd_lanes_ref)
registry.register("hinge_stats", "cuda")(_hinge_stats.hinge_stats_cuda)
registry.register("hinge_stats", "ref")(_ref.hinge_stats_ref)


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

    y, act_top, act_bot and v share one dtype, float64 or float32, and X is
    of that dtype too (or bfloat16 storage beside float32); H v comes back
    in it. Pass 1 returns e in the body's own form (a 0-d sum for "ref", per-block
    partials for "cuda"), which pass 2 of the same body takes as it is.
    """
    _check_precision(precision)
    body = registry.resolve_kernel_backend(backend, X, v)
    Xs = _storage(X, precision)
    d, e = registry.lookup("hinge_xtv", body)(Xs, y, v, t, act_top, act_bot)
    return registry.lookup("hinge_xd", body)(Xs, y, d, e, v, t, C)


def hinge_hessian_matvec_lanes(
    X: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    C: torch.Tensor,
    act_top: torch.Tensor,
    act_bot: torch.Tensor,
    v: torch.Tensor,
    *,
    backend: Optional[str] = None,
    precision: str = "f32",
) -> torch.Tensor:
    """`hinge_hessian_matvec` for B problems at once, (B, n): one launch of
    each pass for all lanes on the "cuda" body.

    X (n, p) shared by every lane or (B, n, p) stacked; y (n,) or (B, n);
    t and C (B,); act_top, act_bot (B, p); v (B, n). Dtypes as for
    `hinge_hessian_matvec`; each lane computes what that op computes on
    the lane's operands.
    """
    _check_precision(precision)
    body = registry.resolve_kernel_backend(backend, X, v)
    Xs = _storage(X, precision)
    d, e = registry.lookup("hinge_xtv_lanes", body)(Xs, y, v, t, act_top, act_bot)
    return registry.lookup("hinge_xd_lanes", body)(Xs, y, d, e, v, t, C)


def hinge_stats(
    X: torch.Tensor,
    y: torch.Tensor,
    t: float,
    w: torch.Tensor,
    C: float,
    *,
    backend: Optional[str] = None,
    precision: str = "f32",
):
    """Fused Newton outer-step stats: (margin (2p,), act (2p,), loss (),
    galpha (2p,)) in w's dtype, loss = 0.5 w.w + C sum(xi^2).

    Both bodies take X in its storage dtype (float32 unless it is, or
    `precision` makes it, bfloat16) and y, w in float32, as the kernel does.
    The "cuda" body returns the raw halves and per-block loss partials,
    assembled here; a masked kernel has no padded columns, so unlike the JAX
    op no padding correction is subtracted.
    """
    _check_precision(precision)
    body = registry.resolve_kernel_backend(backend, X, w)
    impl = registry.lookup("hinge_stats", body)
    if X.dtype not in (torch.float32, torch.bfloat16):
        X = X.to(torch.float32)
    Xs = _storage(X.contiguous(), precision)
    y32 = y.to(torch.float32).contiguous()
    w32 = w.to(torch.float32).contiguous()
    if body == "ref":
        return tuple(o.to(w.dtype) for o in impl(Xs, y32, t, w32, C))
    mt, mb, gt, gb, loss_part = impl(Xs, y32, t, w32, C)
    margin = torch.cat([mt, mb]).to(w.dtype)
    act = (margin < 1.0).to(w.dtype)
    galpha = torch.cat([gt, gb]).to(w.dtype)
    loss = (0.5 * (w @ w) + loss_part.sum()).to(w.dtype)
    return margin, act, loss, galpha


# -- sharded Gram -----------------------------------------------------------

def sharded_shifted_gram(
    mesh,
    X: torch.Tensor,
    y: torch.Tensor,
    t: float,
    *,
    backend: Optional[str] = None,
    precision: str = "f32",
) -> torch.Tensor:
    """K = Zhat^T Zhat (2p, 2p) with the ROWS of X split over the ranks of
    `mesh` (a `repro_torch.dist.Mesh`; DESIGN.md §9).

    Every rank passes the same (X, y); rank r runs the Gram of the body
    `backend` resolves (the CUDA kernel on a CUDA tensor) on its block of
    ceil(n / W) rows, and ONE all-reduce of the (2p, 2p) partial K gives
    every rank the whole K: the quadrant identity is linear in the blocks'
    statistics (G, u, s), so the partial Ks sum exactly (a zero-padded
    block adds nothing, so the blocks need no padding). On a mesh of one
    rank it is `shifted_gram`, with no collective.
    """
    from repro_torch import dist

    rows = -(-X.shape[0] // mesh.size)
    lo = mesh.rank * rows
    K = shifted_gram(X[lo:lo + rows], y[lo:lo + rows], t, backend=backend,
                     precision=precision)
    return dist.all_reduce(mesh, K)
