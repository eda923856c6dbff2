"""Batched multi-problem SVEN solves: B problems in one lane-batched solve.

`sven_batch` stacks whole Elastic Net problems along a leading batch axis
and solves them together (`core/sven.py::_sven_core_lanes`): the port of
`repro/core/batch.py`, where `vmap(_sven_core)` makes one fat executable
instead of B thin dispatches. Here the solver machines carry the lane axis
themselves: every loop steps all lanes and freezes a lane whose own test
is false, as JAX's vmapped while_loop does, so each lane takes the steps
its own solve would, and each loop test is one host read for all lanes.
On the kernel path each CG step launches each hinge pass once for all
lanes; the dual launches the Gram once per lane. The three stacking
patterns the serving layer needs all go through here:

    multi-response     X (n, p) shared,  y (B, n)
    (t, lambda2) grid  X, y shared,      t (B,), lambda2 (B,)   [en_grid]
    k-fold CV          X (B, n_tr, p), y (B, n_tr)              [cv_folds]

Any subset of {X, y, t, lambda2} may carry the batch axis; the rest
broadcast. A shared X stays one (n, p) tensor that every lane reads.

Under an active `repro_torch.dist.mesh_context` whose size divides the
batch, the lanes fan out over the ranks (`shard_map_lanes`, DESIGN.md §9.2):
each rank solves its own block of lanes with the lane machines as they are,
with no collective inside the solve, and the results are gathered in lane
order (an all-reduce of zero-filled buffers, exact). Every lane is then
bitwise the one-device stack's. `batch_mesh` declines the mesh when it does
not divide the batch, and asks the `core.routing` cost model whether the
fan-out pays; `route` pins the layout ("batch" / "single").
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import dist
from repro_torch.core.sven import (SvenBatchSolution, SvenConfig, _sven_core,
                                   _sven_core_lanes, resolve_backend)
from repro_torch.core.svm import host_float, pitched
from repro_torch.device import resolve_device

#: the layouts `route` may pin (`batch_mesh`): "auto" asks the cost model
ROUTES = ("auto", "batch", "single")


def batch_mesh(batch_size: int, n: Optional[int] = None, p: Optional[int] = None, *,
               form: str = "constrained", route: str = "auto") -> Optional[dist.Mesh]:
    """The mesh a stacked launch should fan its batch axis over, or None.

    Structural vetoes first (no context, a mesh of one rank, a mesh that
    does not divide `batch_size` -> None: one device), then the COST MODEL:
    with the problem shape (`n`, `p`) given, `core.routing` prices the
    fan-out against one device and returns None when one device wins — an
    active mesh_context is an OFFER of ranks, not an obligation.
    `route="batch"` pins the fan-out, `route="single"` one device; without
    a shape the offer is taken as it is. Every rank decides alike.
    """
    ctx = dist.current_context()
    if ctx is None or route == "single":
        return None
    mesh = ctx[0]
    if mesh.size <= 1 or batch_size % mesh.size != 0:
        return None
    if route == "batch" or n is None or p is None:
        return mesh
    from repro_torch.core import routing
    decision = routing.route_batch(n, p, batch_size, mesh, form=form, route=route)
    return mesh if decision.path == "batch" else None


def _maybe_shard_batch(arr, batched: bool, ctx=None):
    """This rank's block of a stacked operand's leading ("batch") axis, by
    the rule table of `ctx` (a (mesh, rules) pair; default the innermost
    `dist.mesh_context`); the operand itself when it is not batched, there
    is no context, or the rules leave the axis whole. The one
    implementation of batch-axis placement: CV's folds go through it too."""
    if ctx is None:
        ctx = dist.current_context()
    if ctx is None or not batched or arr is None:
        return arr
    mesh, rules = ctx
    spec = dist.resolve_spec(("batch",) + (None,) * (arr.dim() - 1), tuple(arr.shape),
                             mesh, rules)
    return dist.local_block(mesh, arr) if spec[0] is not None else arr


def gather_lanes(mesh: dist.Mesh, out):
    """The ranks' lane blocks of a stacked result (a named tuple of (B_loc,
    ...) tensors, tuples of B_loc ints, and shared strings) stacked in lane
    order on every rank: each tensor field by one all-reduce of a
    zero-filled buffer (exact; booleans go as bytes), each int tuple as an
    int64 tensor."""
    def one(v):
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bool:
                return dist.gather(mesh, v.to(torch.uint8)).to(torch.bool)
            return dist.gather(mesh, v)
        if isinstance(v, tuple):
            return tuple(int(i) for i in dist.gather(mesh, torch.tensor(
                v, dtype=torch.int64, device=mesh.device)).tolist())
        return v
    return type(out)(*(one(v) for v in out))


def shard_map_lanes(mesh: dist.Mesh, axes: tuple, local, operands: tuple):
    """Fan a stacked solve out over the ranks (DESIGN.md §9.2).

    Problems are independent, so each rank runs `local` on ITS OWN block of
    lanes with no collective: the solver loops stay per rank. Batched
    operands (ax == 0) are cut to this rank's block, the rest are passed
    whole; the results are gathered in lane order (`gather_lanes`)."""
    ops = tuple(dist.local_block(mesh, op) if ax == 0 and op is not None else op
                for op, ax in zip(operands, axes))
    return gather_lanes(mesh, local(*ops))


def solve_lanes(operands: tuple, axes: tuple, config: SvenConfig) -> SvenBatchSolution:
    """Solve the stacked lanes of `operands` = (X, y, t, lambda2, keep,
    warm_alpha, warm_w) (axis 0 marks a batched operand; t and lambda2 are
    (B,)). A width-1 stack runs the single `_sven_core` on its one lane and
    stacks the result, as JAX skips vmap at width 1."""
    X, y, t, lambda2, keep, warm_alpha, warm_w = operands
    if t.shape[0] > 1:
        return _sven_core_lanes(X, y, t, lambda2, warm_alpha, warm_w, config, keep)
    one = [op[0] if ax == 0 and op is not None else op for op, ax in zip(operands, axes)]
    X1, y1, _, _, keep1, wa1, ww1 = one
    sol = _sven_core(X1, y1, host_float(t[0]), host_float(lambda2[0]), wa1, ww1, config,
                     keep1)
    dev = sol.beta.device
    return SvenBatchSolution(
        beta=sol.beta[None], alpha=sol.alpha[None], w=sol.w[None],
        iters=torch.tensor([sol.iters], device=dev),
        opt_residual=sol.opt_residual[None], kkt=sol.kkt[None],
        cg_iters=torch.tensor([sol.cg_iters], device=dev), mode=sol.mode)


def sven_batch(
    X,
    y,
    t,
    lambda2,
    config: SvenConfig = SvenConfig(),
    *,
    keep: Optional[torch.Tensor] = None,
    warm_alpha: Optional[torch.Tensor] = None,
    warm_w: Optional[torch.Tensor] = None,
    route: str = "auto",
) -> SvenBatchSolution:
    """Solve a stack of Elastic Net problems in one lane-batched solve.

    Batch-axis detection by rank: X (B, n, p) vs (n, p); y (B, n) vs (n,);
    t / lambda2 (B,) vs scalar; optional screening mask keep (B, p) vs (p,)
    (see `sven`'s keep). At least one operand must be batched; all batched
    operands must agree on B. Each lane takes the Newton and CG steps of
    its own `sven` call, and its beta matches it to solver rounding.

    `warm_alpha` (B, 2p) / `warm_w` (B, n) warm-start every problem in the
    stack (zero rows are exactly a cold start, so a mixed hit/miss batch
    stays one solve).

    Runs where X lies (array-likes go to the CUDA device). On CUDA tensors
    the default config runs the hand-written kernels: per CG step one launch
    of each hinge pass for all lanes, and one Gram launch per lane and dual
    solve; on CPU tensors their plain versions. Under an active
    `dist.mesh_context` the lanes fan out over the ranks when `batch_mesh`
    takes the mesh (the cost model, or `route="batch"`); `route="single"`
    pins one device. Each lane is bitwise the same either way.
    """
    if route not in ROUTES:
        raise ValueError(f"sven_batch: route must be one of {ROUTES}, got {route!r}")
    dev = resolve_device(None, X, y, t, lambda2)
    X = torch.as_tensor(X, device=dev)
    dtype = X.dtype
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    if X.dim() not in (2, 3) or y.dim() not in (1, 2) or y.shape[-1] != X.shape[-2]:
        raise ValueError(f"sven_batch: X must be (n, p) or (B, n, p) and y (n,) or "
                         f"(B, n), got {tuple(X.shape)} and {tuple(y.shape)}")
    t = torch.as_tensor(t, dtype=dtype, device=dev)
    lambda2 = torch.as_tensor(lambda2, dtype=dtype, device=dev)
    if keep is not None:
        keep = torch.as_tensor(keep, device=dev)
    if warm_alpha is not None:
        warm_alpha = torch.as_tensor(warm_alpha, dtype=dtype, device=dev)
    if warm_w is not None:
        warm_w = torch.as_tensor(warm_w, dtype=dtype, device=dev)

    axes = (0 if X.dim() == 3 else None,
            0 if y.dim() == 2 else None,
            0 if t.dim() == 1 else None,
            0 if lambda2.dim() == 1 else None,
            0 if keep is not None and keep.dim() == 2 else None,
            0 if warm_alpha is not None else None,
            0 if warm_w is not None else None)
    operands = (X, y, t, lambda2, keep, warm_alpha, warm_w)
    sizes = {op.shape[0] for op, ax in zip(operands, axes) if ax == 0}
    if not sizes:
        raise ValueError("sven_batch: no batched operand (add a leading batch "
                         "axis to X, y, t or lambda2, or call sven())")
    if len(sizes) != 1:
        raise ValueError(f"sven_batch: inconsistent batch sizes {sorted(sizes)}")
    B = sizes.pop()
    t = t.expand(B).contiguous()
    lambda2 = lambda2.expand(B).contiguous()
    config = resolve_backend(config, X, y)
    operands = (X, y, t, lambda2, keep, warm_alpha, warm_w)
    axes = (axes[0], axes[1], 0, 0) + axes[4:]
    mesh = batch_mesh(B, X.shape[-2], X.shape[-1], route=route)
    if mesh is not None:
        return shard_map_lanes(mesh, axes, lambda *ops: solve_lanes(ops, axes, config),
                               operands)
    return solve_lanes(operands, axes, config)


def en_grid(ts, lambda2s) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten a (t, lambda2) product grid into batched (B,) operand pairs,
    t-major: (ts[0], l2s[0]), (ts[0], l2s[1]), ... Where the operands lie
    (array-likes go to the CUDA device)."""
    dev = resolve_device(None, ts, lambda2s)
    ts = torch.as_tensor(ts, device=dev)
    lambda2s = torch.as_tensor(lambda2s, device=dev)
    dtype = torch.promote_types(ts.dtype, lambda2s.dtype)
    T, L = torch.meshgrid(ts.to(dtype), lambda2s.to(dtype), indexing="ij")
    return T.reshape(-1), L.reshape(-1)


def cv_folds(X, y, k: int):
    """Stack k leave-one-fold-out problems for `sven_batch` (equal-size folds).

    Uses the first k*(n//k) rows so every fold, and therefore every stacked
    training problem, has the same shape. Returns (X_train (k, n-f, p),
    y_train (k, n-f), X_val (k, f, p), y_val (k, f)), f = n // k, as
    new tensors where X lies (array-likes go to the CUDA device); each fold
    of X_train is laid out as a fresh tensor (`pitched`), as `sven_batch`
    solves its lanes, so it solves them without a copy.
    """
    dev = resolve_device(None, X, y)
    X = torch.as_tensor(X, device=dev)
    y = torch.as_tensor(y, device=dev)
    n = X.shape[0]
    if k < 2 or k > n:
        raise ValueError(f"cv_folds: need 2 <= k <= n, got k={k}, n={n}")
    fold = n // k
    n_use = fold * k
    X, y = X[:n_use], y[:n_use]
    idx = torch.arange(n_use, device=dev)
    val_idx = idx.reshape(k, fold)
    train_idx = torch.stack([torch.cat([idx[: i * fold], idx[(i + 1) * fold:]])
                             for i in range(k)])
    return pitched(X[train_idx]), y[train_idx], X[val_idx], y[val_idx]
