"""Distributed SVEN: the paper's solver over the ranks of a process group.

PyTorch counterpart of `repro/core/distributed.py`. JAX calls these once,
on global arrays, over a device mesh (`shard_map`); here every rank of a
`repro_torch.dist.Mesh` calls them with the same operands, keeps its own
block of the work and returns the same replicated result. Every collective
is an all-reduce (`dist.all_reduce`, `dist.gather`), and a mesh of one rank
issues none.

Data parallelism (DESIGN.md §9): rows of X (== rows of Zhat, the original
samples) split over the ranks, zero-padded to a multiple of the mesh size
(`pad_rows`; rank r keeps block r, `shard_rows`). A zero sample with a zero
response adds nothing to the Elastic Net objective, to any Gram statistic
or to any product, so padded parity is exact. Every solver product is then
local O(n_loc p) work plus one small collective:

    dual   K = Zhat^T Zhat       one all-reduce of (G, u, s) (p^2 + p + 1
                                 floats), or of the (2p, 2p) K of the CUDA
                                 Gram, per SOLVE; the projected Newton
                                 solver runs replicated on it
    primal Xhat @ w              one all-reduce of p + 1 floats a product
           Xhat^T v              one gather of the n-vector a product
           hinge stats           one all-reduce of p + 2 floats

The primal runs plain products (as JAX's does): no kernel fuses across an
all-reduce. Every loop test reads replicated values only, so the ranks
leave every loop together. Feature parallelism (`make_distributed_hessian_
matvec`: X's columns split, one all-reduce of the n-vector a product) and
the Gram forms of the §Perf hill-climb (`distributed_gram*`) are kept.

Every function here takes the operands every rank holds alike (the whole X
and y, a replicated w) and cuts its own block.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import dist
from repro_torch.core import reduction as red
from repro_torch.core.svm import solve_primal_newton


def _mesh(mesh: Optional[dist.Mesh]) -> dist.Mesh:
    """An explicit mesh, else the innermost `dist.mesh_context`, else the
    process's data mesh (one rank when no process group is up)."""
    if mesh is not None:
        return mesh
    ctx = dist.current_context()
    return ctx[0] if ctx is not None else dist.data_mesh()


def pad_rows(X: torch.Tensor, y: torch.Tensor, n_dev: int):
    """Zero-row pad (X, y) to a row count divisible by `n_dev` (exact)."""
    rem = (-X.shape[0]) % n_dev
    if rem == 0:
        return X, y
    return (torch.cat([X, X.new_zeros(rem, X.shape[1])]),
            torch.cat([y, y.new_zeros(rem)]))


def shard_rows(mesh: dist.Mesh, X: torch.Tensor, y: torch.Tensor):
    """This rank's block of the zero-row-padded (X, y): rank r keeps rows
    [r n_loc, (r + 1) n_loc) of the padded rows (views, no copy when the
    mesh divides n)."""
    Xp, yp = pad_rows(X, y, mesh.size)
    return dist.local_block(mesh, Xp), dist.local_block(mesh, yp)


def _packed(mesh: dist.Mesh, parts) -> list:
    """The tensors `parts` all-reduced in ONE collective (flattened into one
    buffer), returned in their shapes."""
    flat = dist.all_reduce(mesh, torch.cat([p_.reshape(-1) for p_ in parts]))
    out, at = [], 0
    for p_ in parts:
        out.append(flat[at:at + p_.numel()].reshape(p_.shape))
        at += p_.numel()
    return out


def _quadrants(G_rows, u_rows, u, s) -> torch.Tensor:
    """K rows from G rows: `reduction.gram_from_stats`'s identity, with the
    rows' own slice of u."""
    a, b = u_rows[:, None], u[None, :]
    top = torch.cat([G_rows - a - b + s, -G_rows - a + b + s], dim=1)
    bot = torch.cat([-G_rows + a - b + s, G_rows + a + b + s], dim=1)
    return torch.cat([top, bot], dim=0)


def sharded_stats(X: torch.Tensor, y: torch.Tensor, t: float, *, mesh: dist.Mesh):
    """The one collective of the sharded dual solve: the all-reduced
    sufficient statistics (G = X^T X, u = X^T y / t, s = y^T y / t^2) of
    the rows, each rank's block summed. Same op order per block as
    `reduction.gram_blocks`'s inputs, so a mesh of one rank reproduces the
    single-device statistics bitwise."""
    X_loc, y_loc = shard_rows(mesh, X, y)
    G, u, s = _packed(mesh, [X_loc.T @ X_loc, X_loc.T @ y_loc, y_loc @ y_loc])
    return G, u / t, s / (t * t)


def sharded_gram_stats(mesh: dist.Mesh, X: torch.Tensor, y: torch.Tensor, t: float
                       ) -> torch.Tensor:
    """K = Zhat^T Zhat (2p, 2p) from the all-reduced (G, u, s): the
    data-parallel twin of `reduction.gram_blocks` (bitwise it on one rank)."""
    return red.gram_from_stats(*sharded_stats(X, y, t, mesh=mesh))


def sharded_hinge_stats(mesh: dist.Mesh, X: torch.Tensor, y: torch.Tensor, t: float,
                        w: torch.Tensor, C: float):
    """`kernels.ref.hinge_stats_ref` on row-split X: the fused Newton
    outer-step stats (margin, act, loss, galpha) from ONE all-reduce of
    p + 2 floats, X_loc^T w_loc, y_loc . w_loc and w_loc . w_loc. w is the
    replicated (n_pad,) iterate; plain products, as JAX's."""
    from repro_torch.kernels.ref import _acc, hinge_stats_from_moments

    X_loc, y_loc = shard_rows(mesh, X, y)
    w_loc = dist.local_block(mesh, w)
    a, yw, ww = _packed(mesh, [(_acc(X_loc).T @ w_loc).to(w.dtype), y_loc @ w_loc,
                               w_loc @ w_loc])
    return hinge_stats_from_moments(a, yw / t, ww, C)


def distributed_gram(mesh: dist.Mesh, X: torch.Tensor, y: torch.Tensor, t: float,
                     row_shard_out: bool = True) -> torch.Tensor:
    """JAX's name and signature for `sharded_gram_stats`: K = Zhat^T Zhat
    (2p, 2p) with the SAMPLES split over the ranks. With `row_shard_out`
    each rank returns its (2p / W, 2p) block of K's rows (rank order), else
    all of K."""
    K = sharded_gram_stats(mesh, X, y, t)
    return dist.local_block(mesh, K) if row_shard_out else K


def _gram_rs(mesh: dist.Mesh, G_part, X_loc, y_loc, t: float) -> torch.Tensor:
    """The reduce-scatter tail of the rs forms: this rank's p / W rows of G
    (an all-reduce from which each rank takes its slice) and its K rows
    [+rows_r ; -rows_r]."""
    G, u, s = _packed(mesh, [G_part, (X_loc.T @ y_loc) / t, (y_loc @ y_loc) / (t * t)])
    return _quadrants(dist.local_block(mesh, G), dist.local_block(mesh, u), u, s)


def distributed_gram_rs(mesh: dist.Mesh, X: torch.Tensor, y: torch.Tensor, t: float
                        ) -> torch.Tensor:
    """Reduce-scatter Gram: each rank assembles only its own p / W rows of
    G, so its K rows are the feature-interleaved permutation
    [+rows_r ; -rows_r] (2p / W, 2p); labels via `interleaved_labels`
    (the solvers are permutation-equivariant)."""
    X_loc, y_loc = shard_rows(mesh, X, y)
    return _gram_rs(mesh, X_loc.T @ X_loc, X_loc, y_loc, t)


def distributed_gram_rs_syrk(mesh: dist.Mesh, X: torch.Tensor, y: torch.Tensor, t: float
                             ) -> torch.Tensor:
    """`distributed_gram_rs` with level-1 SYRK blocking: G = X^T X is
    symmetric, so with X = [X1 X2] only G11, G12 and G22 are computed (3/4
    of the MACs); G21 is a local transpose."""
    X_loc, y_loc = shard_rows(mesh, X, y)
    h = X.shape[1] // 2
    X1, X2 = X_loc[:, :h], X_loc[:, h:]
    G12 = X1.T @ X2
    G_part = torch.cat([torch.cat([X1.T @ X1, G12], dim=1),
                        torch.cat([G12.T, X2.T @ X2], dim=1)], dim=0)
    return _gram_rs(mesh, G_part, X_loc, y_loc, t)


def interleaved_labels(p: int, n_dev: int, dtype: torch.dtype = torch.float64,
                       device=None) -> torch.Tensor:
    """Labels matching `distributed_gram_rs`'s row permutation (all ranks'
    blocks in rank order)."""
    rows = p // n_dev
    one = torch.ones(rows, dtype=dtype, device=device)
    return torch.cat([one, -one]).repeat(n_dev)


def distributed_gram_paper(mesh: dist.Mesh, X: torch.Tensor, y: torch.Tensor, t: float
                           ) -> torch.Tensor:
    """The paper-faithful baseline of the hill-climb: materialize each
    block's constructed (n_loc, 2p) matrix Zhat (as the MATLAB listing does,
    `reduction.gram_reference`'s ops on the block) and all-reduce
    K = Z^T Z: 4x the MACs of `distributed_gram`'s block identity."""
    X_loc, y_loc = shard_rows(mesh, X, y)
    Xhat, yhat = red.build_svm_dataset(X_loc, y_loc, t)
    Z = (yhat[:, None] * Xhat).T
    return dist.all_reduce(mesh, Z.T @ Z)


def make_distributed_hessian_matvec(mesh: dist.Mesh, X: torch.Tensor, y: torch.Tensor,
                                    t: float, C: float):
    """Primal H v with ONE all-reduce of an n-vector a call, X's FEATURES
    split over the ranks (p divisible by the mesh): rank r takes columns
    [r p_loc, (r + 1) p_loc) and the matching slices of the (2p,) act mask.
    Returns the `hess_matvec(v, act, C)` hook of `solve_primal_newton`."""
    p = X.shape[1]
    p_loc = p // mesh.size
    lo = mesh.rank * p_loc
    X_loc = X[:, lo:lo + p_loc].contiguous()

    def hess_matvec(v, act, C_=None):
        C_op = C if C_ is None else C_
        act = act.to(v.dtype)
        a_t, a_b = act[lo:lo + p_loc], act[p + lo:p + lo + p_loc]
        c = X_loc.T @ v
        byv = (y @ v) / t
        u_t = a_t * (c - byv)
        u_b = a_b * (c + byv)
        e_loc = torch.sum(u_b) - torch.sum(u_t)
        hv = dist.all_reduce(mesh, X_loc @ (u_t + u_b) + (y / t) * e_loc)
        return v + 2.0 * C_op * hv

    return hess_matvec


def _sharded_kkt(mesh: dist.Mesh, X_loc, y_loc, beta, lambda2: float) -> torch.Tensor:
    """`elastic_net.kkt_violation` on row-split X: one all-reduce of X^T r."""
    from repro_torch.core import elastic_net as en

    g = dist.all_reduce(mesh, X_loc.T @ (X_loc @ beta - y_loc))
    return en.kkt_violation_from_grad(2.0 * g + 2.0 * lambda2 * beta, beta)


def _sven_sharded_dual(mesh, Xp, yp, t: float, lambda2: float, warm_alpha, n_orig: int,
                       config):
    """The sharded dual: K from one all-reduce (the CUDA Gram's K on the
    kernel backends, (G, u, s) on "torch"), the projected Newton replicated
    on it, one matrix-free full-precision refinement under "bf16"/"tf32"
    (one all-reduce of p + 1 floats a K v), w gathered once."""
    from repro_torch.core.svm import solve_dual_fista, solve_dual_newton
    from repro_torch.core.sven import SvenSolution, _kernel_dtype
    from repro_torch.kernels.ops import sharded_shifted_gram

    p = Xp.shape[1]
    dtype = Xp.dtype
    X_loc, y_loc = shard_rows(mesh, Xp, yp)
    C = red.svm_C(lambda2, floor=config.lambda2_floor)
    kernels = config.backend != "torch"
    if kernels:
        kdtype = _kernel_dtype(dtype, config.precision)
        K = sharded_shifted_gram(mesh, Xp.to(kdtype), yp.to(kdtype), t,
                                 backend=config.backend,
                                 precision=config.precision).to(dtype)
    else:
        K = sharded_gram_stats(mesh, Xp, yp, t)
    op = red.SvenOperator(X=X_loc, y=y_loc, t=t)

    def kernel_matvec(v):       # K v = Zhat^T (Zhat v) over the ranks' rows
        u = op.zhat_matvec(v)
        a, b = _packed(mesh, [X_loc.T @ u, y_loc @ u])
        b = b / t
        return torch.cat([a - b, -a - b])

    solver = solve_dual_newton if config.solver == "newton" else solve_dual_fista
    res = solver(lambda v: K @ v, 2 * p, C, dtype=dtype, device=Xp.device, tol=config.tol,
                 alpha0=warm_alpha)
    cg = res.cg_iters
    if kernels and config.precision != "f32":
        res = solver(kernel_matvec, 2 * p, C, dtype=dtype, device=Xp.device,
                     tol=config.tol, alpha0=res.alpha)
        cg += res.cg_iters
    beta = red.recover_beta(res.alpha, t)
    w = dist.gather(mesh, op.zhat_matvec(res.alpha))[:n_orig]
    return SvenSolution(beta=beta, alpha=res.alpha, mode="dual", w=w, iters=res.iters,
                        opt_residual=res.pg_norm,
                        kkt=_sharded_kkt(mesh, X_loc, y_loc, beta, lambda2), cg_iters=cg)


def _sven_sharded_primal(mesh, Xp, yp, t: float, lambda2: float, warm_w, n_orig: int,
                         config):
    """The sharded primal: the whole Newton-CG on the replicated (n_pad,)
    w; each Xhat w is one all-reduce of p + 1 floats, each Xhat^T v one
    gather of the n-vector."""
    from repro_torch.core.sven import SvenSolution

    p = Xp.shape[1]
    X_loc, y_loc = shard_rows(mesh, Xp, yp)

    def matvec(w):                       # Xhat @ w -> (2p,) replicated
        w_loc = dist.local_block(mesh, w)
        a, b = _packed(mesh, [X_loc.T @ w_loc, y_loc @ w_loc])
        b = b / t
        return torch.cat([a - b, a + b])

    def rmatvec(v):                      # Xhat^T v -> (n_pad,) replicated
        vt, vb = v[:p], v[p:]
        return dist.gather(mesh, X_loc @ (vt + vb) + (y_loc / t) * (torch.sum(vb)
                                                                    - torch.sum(vt)))

    C = red.svm_C(lambda2, floor=config.lambda2_floor)
    yhat = torch.cat([Xp.new_ones(p), -Xp.new_ones(p)])
    res = solve_primal_newton(matvec, rmatvec, yhat, C, Xp.shape[0], tol=config.tol,
                              max_newton=config.max_newton, cg_iters=config.cg_iters,
                              w0=warm_w)
    alpha = C * torch.clamp(1.0 - yhat * matvec(res.w), min=0.0)
    beta = red.recover_beta(alpha, t)
    return SvenSolution(beta=beta, alpha=alpha, mode="primal", w=res.w[:n_orig],
                        iters=res.iters, opt_residual=res.grad_norm,
                        kkt=_sharded_kkt(mesh, X_loc, y_loc, beta, lambda2),
                        cg_iters=res.cg_iters)


def sven_sharded(X, y, t, lambda2, config=None, *, mesh: Optional[dist.Mesh] = None,
                 warm_alpha=None, warm_w=None):
    """Data-parallel `sven()`: rows split over the ranks, same answers.

    Every rank calls this with the same (X, y); each keeps its block of the
    zero-padded rows and every rank returns the same `SvenSolution`. The
    dual assembles K from one all-reduce (on the kernel backends each rank
    runs the CUDA Gram on its rows, `kernels.ops.sharded_shifted_gram`), the
    primal runs its whole Newton-CG with one all-reduce and one gather a
    product. Within solver tolerance of `sven()` (<= 1e-10 tested at 2 and 4
    ranks); a mesh of one rank IS `sven()`, with no collective.

    `mesh=None` resolves the innermost `dist.mesh_context`, then the
    process's data mesh. This is the PINNED sharded layout:
    `core.routing.sven_routed` consults the cost model first.
    """
    from repro_torch.core.sven import SvenConfig, _operands, _pick_mode, resolve_backend, sven

    config = SvenConfig() if config is None else config
    mesh = _mesh(mesh)
    if mesh.size == 1:
        return sven(X, y, t, lambda2, config, warm_alpha=warm_alpha, warm_w=warm_w)
    X, y = _operands(X, y)
    config = resolve_backend(config, X, y)
    n, p = X.shape
    Xp, yp = pad_rows(X, y, mesh.size)
    t, lambda2 = float(t), float(lambda2)
    if _pick_mode(n, p, config) == "dual":
        wa = X.new_zeros(2 * p) if warm_alpha is None else warm_alpha.to(X)
        return _sven_sharded_dual(mesh, Xp, yp, t, lambda2, wa, n, config)
    ww = Xp.new_zeros(Xp.shape[0])
    if warm_w is not None:
        ww[:n] = warm_w.to(X)
    return _sven_sharded_primal(mesh, Xp, yp, t, lambda2, ww, n, config)


def sven_primal_distributed(mesh: dist.Mesh, X: torch.Tensor, y: torch.Tensor, t: float,
                            lambda2: float, *, tol: float = 1e-8, max_newton: int = 40,
                            cg_iters: int = 200):
    """Full primal SVEN solve with the feature-split Hessian mat-vec (the
    hot loop, one all-reduce a product) and the margins and gradient on the
    replicated implicit operator; beta by Algorithm 1's recovery. Returns
    (beta, the solver's result)."""
    n, p = X.shape
    C = red.svm_C(lambda2)
    op = red.SvenOperator(X=X, y=y, t=float(t))
    yhat = torch.cat([X.new_ones(p), -X.new_ones(p)])
    hess = make_distributed_hessian_matvec(mesh, X, y, float(t), C)
    res = solve_primal_newton(op.xhat_matvec, op.xhat_rmatvec, yhat, C, n, tol=tol,
                              max_newton=max_newton, cg_iters=cg_iters, hess_matvec=hess)
    alpha = C * torch.clamp(1.0 - yhat * op.xhat_matvec(res.w), min=0.0)
    return red.recover_beta(alpha, float(t)), res
