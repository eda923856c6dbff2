"""SVEN solve entry points — the paper's Algorithm 1 in PyTorch.

Dispatch (paper §3, "Implementation details"):
    2p > n  -> primal solver over w in R^n   (cost driven by n)
    else    -> dual solver over alpha in R^{2p}, kernel cached when it fits

On the kernel backends the dual caches K = Zhat^T Zhat from the fused
shifted-Gram kernel and the primal's CG mat-vec is the two-pass hinge
Hessian kernel. At the default precision "f32" a float64 problem hands
the kernels its float64 operands, and they sum in float64: the dual solves
on the problem's own K and the primal's H v is the problem's own float64
product, as on the plain backend. A float32 problem hands them float32
operands. Under "bf16"/"tf32" the kernels take float32 operands (bfloat16
storage of X under "bf16") and sum in float32; their results are cast back
to the problem dtype, which drives the solvers, and the dual gets one
full-precision matrix-free refinement re-solve, warm-started from the
low-precision alpha.

PyTorch counterpart of `repro/core/sven.py`. JAX compiles the solve once
per shape under `jit`; here it runs eagerly, with host loops (one host sync
per Newton or line-search test, and one per block of CG steps, see
`core/svm/state.py`). `t` and `lambda2` are host floats.
`sven_path` is a Python loop over the t-grid that carries the warm dual
alpha AND primal w from zeros, as the JAX scan does.

`_sven_core_lanes` is `_sven_core` for a stack of B problems (the
counterpart of `vmap(_sven_core)` in `repro/core/batch.py`): the lane-batched
solver machines, one launch of each hinge pass per CG step for all lanes,
and one Gram launch per lane. `core/batch.py` is its entry point.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import elastic_net as en
from repro_torch.core import reduction as red
from repro_torch.core.svm import (host_list, lanes, pitched, solve_dual_fista,
                                  solve_dual_fista_lanes, solve_dual_newton,
                                  solve_dual_newton_lanes, solve_primal_newton,
                                  solve_primal_newton_lanes)
from repro_torch.device import resolve_device


class SvenSolution(NamedTuple):
    beta: torch.Tensor
    alpha: torch.Tensor
    mode: str                    # "primal" | "dual"
    iters: int                   # outer (Newton) iterations
    opt_residual: torch.Tensor   # solver's own optimality measure
    kkt: torch.Tensor            # Elastic Net KKT violation at beta
    w: torch.Tensor              # primal SVM iterate — warm-start carrier
    cg_iters: int                # inner CG iterations (primal: H v products)


class SvenBatchSolution(NamedTuple):
    """Stacked per-problem solutions; every tensor has a leading (B,) axis.
    The port of `repro.core.batch.SvenBatchSolution`, with each lane's CG
    count as `SvenSolution` has it, and the mode all lanes share."""

    beta: torch.Tensor           # (B, p)
    alpha: torch.Tensor          # (B, 2p)
    w: torch.Tensor              # (B, n)
    iters: torch.Tensor          # (B,) outer (Newton) iterations
    opt_residual: torch.Tensor   # (B,)
    kkt: torch.Tensor            # (B,)
    cg_iters: torch.Tensor       # (B,) inner CG iterations
    mode: str                    # "primal" | "dual", shared by the lanes


#: every accepted SvenConfig.backend: "torch" = plain PyTorch products and
#: no kernels (the role of JAX's "xla"); "auto" = the kernel body chosen
#: from the operands' device (CUDA kernel on the card, plain version on the
#: CPU); "cuda" / "ref" = that body, whatever the device.
BACKENDS = ("torch", "auto", "cuda", "ref")
PRECISIONS = ("f32", "bf16", "tf32")


@dataclasses.dataclass(frozen=True)
class SvenConfig:
    """Solve settings; the fields of `repro.core.sven.SvenConfig` less the
    deprecated `interpret`.

    The default backend is "auto", so that `sven(X, y, t, lambda2)` runs
    the hand-written kernels on a CUDA tensor and their plain versions on a
    CPU tensor. The JAX default, "xla", runs no kernel at all; its
    counterpart here is "torch". At the default precision "f32" the dual's
    Gram and the primal's hinge passes of a float64 problem are summed in
    float64, so the default solve gives the plain solve's answer;
    "bf16"/"tf32" sum them in float32, and the dual refines once at full
    precision.
    """

    mode: str = "auto"            # "auto" | "primal" | "dual"
    matrix_free: bool = True      # SvenOperator vs explicit Xnew
    cache_kernel: str = "auto"    # "auto" | "blocks" | "never" (dual only)
    solver: str = "newton"        # "newton" | "fista" (dual only)
    backend: str = "auto"         # one of BACKENDS
    precision: str = "f32"        # kernel storage/multiply precision
    tol: float = 1e-8
    max_newton: int = 60
    cg_iters: int = 300
    kernel_cache_max_m: int = 8192   # cache K when 2p <= this
    lambda2_floor: float = red.LAMBDA2_FLOOR  # Lasso limit: C capped at 1/(2*floor)

    def __post_init__(self):
        for name, allowed in (("backend", BACKENDS), ("precision", PRECISIONS),
                              ("mode", ("auto", "primal", "dual")),
                              ("cache_kernel", ("auto", "blocks", "never")),
                              ("solver", ("newton", "fista"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"SvenConfig.{name} must be one of {allowed}, "
                                 f"got {getattr(self, name)!r}")


def _pick_mode(n: int, p: int, cfg: SvenConfig) -> str:
    if cfg.mode != "auto":
        return cfg.mode
    return "primal" if 2 * p > n else "dual"


def resolve_backend(config: SvenConfig, *tensors) -> SvenConfig:
    """Pin "auto" to the kernel body of the operands' device ("cuda" or
    "ref"); operands on different devices raise. A no-op for "torch" and
    for an already-resolved backend."""
    if config.backend == "torch":
        return config
    from repro_torch.kernels import registry

    body = registry.resolve_kernel_backend(
        None if config.backend == "auto" else config.backend, *tensors)
    if body == config.backend:
        return config
    return dataclasses.replace(config, backend=body)


def _operands(X, y):
    """X and y as tensors on one device (X's, or CUDA for array-likes)."""
    dev = resolve_device(None, X, y)
    X = torch.as_tensor(X, device=dev)
    y = torch.as_tensor(y, dtype=X.dtype, device=dev)
    if X.dim() != 2 or y.shape != (X.shape[0],):
        raise ValueError(f"sven: X must be (n, p) and y (n,), got "
                         f"{tuple(X.shape)} and {tuple(y.shape)}")
    return X, y


def _kernel_dtype(dtype: torch.dtype, precision: str) -> torch.dtype:
    """The dtype a solve hands the kernels: a float64 problem at "f32" keeps
    float64 (the kernels then sum in float64); everything else is float32
    (stored as bfloat16 under "bf16")."""
    wide = dtype == torch.float64 and precision == "f32"
    return torch.float64 if wide else torch.float32


def _floats(ts) -> list:
    if isinstance(ts, torch.Tensor):
        return [float(t) for t in ts.detach().cpu().tolist()]
    return [float(t) for t in ts]


def _sven_core(X, y, t: float, lambda2: float, warm_alpha, warm_w,
               config: SvenConfig, keep=None) -> SvenSolution:
    """One solve on resolved operands. `keep` is an optional (p,) screening
    mask: masked columns are zeroed and the returned beta is scattered back
    to exact zeros on them."""
    n, p = X.shape
    dtype = X.dtype
    X_full = X    # KKT diagnostics stay on the ORIGINAL problem: an unsafe
    keepf = None  # mask must show up as a large kkt, not pass trivially
    if keep is not None:
        keepf = keep.to(dtype)
        X = X * keepf[None, :]
        if warm_alpha is not None:
            # symmetrize masked duplicate pairs so dual warm starts can't
            # leave stale asymmetric mass on screened-out samples
            warm_alpha = warm_alpha * torch.cat([keepf, keepf])
    C = red.svm_C(lambda2, floor=config.lambda2_floor)
    mode = _pick_mode(n, p, config)
    op = red.SvenOperator(X=X, y=y, t=t)
    kernels = config.backend != "torch"

    if mode == "primal":
        if config.matrix_free:
            matvec, rmatvec = op.xhat_matvec, op.xhat_rmatvec
        else:
            Xhat, _ = red.build_svm_dataset(X, y, t)
            matvec = lambda w: Xhat @ w          # noqa: E731
            rmatvec = lambda v: Xhat.T @ v       # noqa: E731
        yhat = torch.cat([X.new_ones(p), -X.new_ones(p)])
        hess_matvec = None
        if kernels:
            from repro_torch.kernels.ops import _storage, hinge_hessian_matvec
            # the kernel operands are made once per solve, the act halves
            # once per Newton step (a new `act`), not per CG step; float64
            # ones are the problem's own tensors, cast nowhere
            kdtype = _kernel_dtype(dtype, config.precision)
            Xk = _storage(X.to(kdtype).contiguous(), config.precision)
            yk = y.to(kdtype).contiguous()
            halves = {"act": None}

            def hess_matvec(v, act, C_):  # the fused two-pass H v kernel
                if halves["act"] is not act:
                    halves.update(act=act, top=act[:p].to(kdtype), bot=act[p:].to(kdtype))
                hv = hinge_hessian_matvec(
                    Xk, yk, t, C_, halves["top"], halves["bot"], v.to(kdtype),
                    backend=config.backend, precision=config.precision)
                return hv.to(dtype)

        res = solve_primal_newton(
            matvec, rmatvec, yhat, C, n,
            tol=config.tol, max_newton=config.max_newton, cg_iters=config.cg_iters,
            w0=warm_w, hess_matvec=hess_matvec)
        alpha = C * torch.clamp(1.0 - yhat * matvec(res.w), min=0.0)  # Alg.1 line 7
        beta = red.recover_beta(alpha, t)
        if keepf is not None:
            beta = beta * keepf
        return SvenSolution(beta=beta, alpha=alpha, mode=mode, w=res.w,
                            iters=res.iters, opt_residual=res.grad_norm,
                            kkt=en.kkt_violation(X_full, y, beta, lambda2),
                            cg_iters=res.cg_iters)

    # --- dual ---
    m = 2 * p
    cache = config.cache_kernel
    if cache == "auto":
        cache = "blocks" if m <= config.kernel_cache_max_m else "never"
    refine = False
    if cache == "blocks":
        if kernels:
            from repro_torch.kernels.ops import shifted_gram
            kdtype = _kernel_dtype(dtype, config.precision)
            K = shifted_gram(X.to(kdtype).contiguous(), y.to(kdtype).contiguous(), t,
                             backend=config.backend,
                             precision=config.precision).to(dtype)
            refine = config.precision != "f32"
        elif config.matrix_free:
            K = red.gram_blocks(X, y, t)
        else:
            K = red.gram_reference(X, y, t)
        kernel_matvec = lambda v: K @ v   # noqa: E731
    else:
        kernel_matvec = op.kernel_matvec

    # the dual keeps the solver's own loop bounds, as JAX's `_sven_core` does
    solver = solve_dual_newton if config.solver == "newton" else solve_dual_fista
    res = solver(kernel_matvec, m, C, dtype=dtype, device=X.device, tol=config.tol,
                 alpha0=warm_alpha)
    cg = res.cg_iters
    if refine:
        # one step of iterative refinement: re-solving MATRIX-FREE at full
        # input precision, warm-started from the low-precision alpha,
        # re-evaluates every residual against exact Gram statistics at O(np)
        # per iteration and restores <= 1e-10 parity.
        res = solver(op.kernel_matvec, m, C, dtype=dtype, device=X.device,
                     tol=config.tol, alpha0=res.alpha)
        cg += res.cg_iters
    beta = red.recover_beta(res.alpha, t)
    if keepf is not None:
        beta = beta * keepf
    # w = Zhat @ alpha: the primal iterate this dual solution induces — carried
    # so a following primal-mode solve can warm-start from it.
    w = op.zhat_matvec(res.alpha)
    return SvenSolution(beta=beta, alpha=res.alpha, mode=mode, w=w,
                        iters=res.iters, opt_residual=res.pg_norm,
                        kkt=en.kkt_violation(X_full, y, beta, lambda2),
                        cg_iters=cg)


def _lane(x: torch.Tensor, i: int, shared_dim: int) -> torch.Tensor:
    """Lane i of x, or x itself when it has `shared_dim` dims (shared)."""
    return x if x.dim() == shared_dim else x[i]


def _sven_core_lanes(X, y, t: torch.Tensor, lambda2: torch.Tensor, warm_alpha, warm_w,
                     config: SvenConfig, keep=None, ts=None) -> SvenBatchSolution:
    """`_sven_core` for B problems at once, on resolved operands.

    X (n, p) shared by the lanes or (B, n, p); y (n,) or (B, n); t and
    lambda2 (B,) of X's dtype; warm_alpha (B, 2p) and warm_w (B, n) or None
    (zero rows are a cold start); keep None, (p,) or (B, p). The mode is
    picked once for all lanes. The primal's CG mat-vec is one launch of
    each hinge pass for all lanes on the kernel path (X read at its stride:
    0 when shared); the dual caches each lane's K from one launch of the
    Gram per lane, stacked to (B, 2p, 2p). Each lane's arithmetic is that
    of `_sven_core` on its operands, to the bit: products and reductions
    run per lane (`core/svm/state.py::lanes`), and each lane of the hinge
    passes is bitwise a single launch's. t is read to the host once, unless
    the caller hands its values over as `ts` (a list of B floats).
    """
    n, p = X.shape[-2:]
    B = t.shape[0]
    dtype = X.dtype
    X_full = X
    keepf = None
    if keep is not None:
        keepf = keep.to(dtype)
        X = X * keepf.unsqueeze(-2)     # a (B, p) mask stacks a shared X
        if warm_alpha is not None:
            warm_alpha = warm_alpha * torch.cat([keepf, keepf], dim=-1)
    # each lane of a stacked X laid out as a fresh tensor, as the single
    # solve's X is (a copy only where the stack is not): pass 2 of the hinge
    # kernels splits each row at its own 16-byte boundary
    if X.dim() == 3:
        X = pitched(X)
    # svm_C of each lane, in float64 as on the host
    C = (1.0 / (2.0 * torch.clamp(lambda2.to(torch.float64),
                                  min=config.lambda2_floor))).to(dtype)
    mode = _pick_mode(n, p, config)
    ts = host_list(t) if ts is None else ts
    op = red.SvenLaneOperator(X=X, y=y, t=ts)
    kernels = config.backend != "torch"

    if mode == "primal":
        if config.matrix_free:
            matvec, rmatvec = op.xhat_matvec, op.xhat_rmatvec
        else:
            Xhat = pitched(torch.stack([red.build_svm_dataset(
                _lane(X, i, 2), _lane(y, i, 1), ts[i])[0] for i in range(B)]))
            matvec = lambda w: lanes(torch.matmul, Xhat, w)                    # noqa: E731
            rmatvec = lambda v: lanes(lambda A, u: A.T @ u, Xhat, v)          # noqa: E731
        yhat = torch.cat([X.new_ones(p), -X.new_ones(p)])
        hess_matvec = None
        if kernels:
            from repro_torch.kernels.ops import _storage, hinge_hessian_matvec_lanes
            # made once per solve; a shared X stays one (n, p) operand that
            # every lane reads (stride 0), a stacked one keeps its lanes'
            # layout (`pitched`)
            kdtype = _kernel_dtype(dtype, config.precision)
            Xk = _storage(X.to(kdtype), config.precision)
            Xk = pitched(Xk) if Xk.dim() == 3 else Xk.contiguous()
            yk = y.to(kdtype).contiguous()

            halves = {"act": None}

            def hess_matvec(v, act, C_):  # one launch of each pass for all lanes
                if halves["act"] is not act:   # the (B, p) halves, once per Newton step
                    halves.update(act=act, top=act[:, :p].to(kdtype).contiguous(),
                                  bot=act[:, p:].to(kdtype).contiguous())
                hv = hinge_hessian_matvec_lanes(
                    Xk, yk, t, C_, halves["top"], halves["bot"], v.to(kdtype).contiguous(),
                    backend=config.backend, precision=config.precision)
                return hv.to(dtype)

        res = solve_primal_newton_lanes(
            matvec, rmatvec, yhat, C, n, B,
            tol=config.tol, max_newton=config.max_newton, cg_iters=config.cg_iters,
            w0=warm_w, hess_matvec=hess_matvec)
        alpha = C[:, None] * torch.clamp(1.0 - yhat * matvec(res.w), min=0.0)
        w, iters, residual, cg = res.w, res.iters, res.grad_norm, res.cg_iters
    else:
        m = 2 * p
        cache = config.cache_kernel
        if cache == "auto":
            cache = "blocks" if m <= config.kernel_cache_max_m else "never"
        refine = False
        if cache == "blocks":
            if kernels:
                from repro_torch.kernels.ops import shifted_gram
                kdtype = _kernel_dtype(dtype, config.precision)
                Xk, yk = X.to(kdtype), y.to(kdtype)
                if Xk.dim() == 3:
                    Xk = pitched(Xk)
                K = torch.stack([shifted_gram(_lane(Xk, i, 2).contiguous(),
                                              _lane(yk, i, 1).contiguous(), ts[i],
                                              backend=config.backend,
                                              precision=config.precision)
                                 for i in range(B)]).to(dtype)
                K = pitched(K)
                refine = config.precision != "f32"
            else:
                gram = red.gram_blocks if config.matrix_free else red.gram_reference
                K = pitched(torch.stack([gram(_lane(X, i, 2), _lane(y, i, 1), ts[i])
                                         for i in range(B)]))
            kernel_matvec = lambda v: lanes(torch.matmul, K, v)   # noqa: E731
        else:
            kernel_matvec = op.kernel_matvec

        solver = (solve_dual_newton_lanes if config.solver == "newton"
                  else solve_dual_fista_lanes)
        res = solver(kernel_matvec, m, C, B, dtype=dtype, device=X.device,
                     tol=config.tol, alpha0=warm_alpha)
        cg = res.cg_iters
        if refine:
            # each lane's matrix-free full-precision re-solve, as in _sven_core
            res = solver(op.kernel_matvec, m, C, B, dtype=dtype, device=X.device,
                         tol=config.tol, alpha0=res.alpha)
            cg = cg + res.cg_iters
        alpha = res.alpha
        w, iters, residual = op.zhat_matvec(alpha), res.iters, res.pg_norm

    alpha_l = pitched(alpha)
    beta = torch.stack([red.recover_beta(alpha_l[i], ts[i]) for i in range(B)])
    if keepf is not None:
        beta = beta * keepf
    beta_l = pitched(beta)
    kkt = torch.stack([en.kkt_violation(_lane(X_full, i, 2), _lane(y, i, 1), beta_l[i],
                                        lambda2[i]) for i in range(B)])
    return SvenBatchSolution(beta=beta, alpha=alpha, w=w, iters=iters,
                             opt_residual=residual, kkt=kkt, cg_iters=cg, mode=mode)


def sven(
    X,
    y,
    t,
    lambda2,
    config: SvenConfig = SvenConfig(),
    *,
    warm_alpha: Optional[torch.Tensor] = None,
    warm_w: Optional[torch.Tensor] = None,
    keep: Optional[torch.Tensor] = None,
) -> SvenSolution:
    """Solve the Elastic Net (paper eq. 1) via the SVM reduction.

    Runs where X lies (array-likes go to the CUDA device). `keep` is an
    optional (p,) safe screening mask: screened-out columns are zeroed and
    their coefficients scattered back as exact zeros. `cg_iters` of the
    result counts the inner CG iterations (over both solves of a refined
    dual); `iters` is the last solve's Newton count, as in JAX.
    """
    X, y = _operands(X, y)
    config = resolve_backend(config, X, y)
    return _sven_core(X, y, float(t), float(lambda2), warm_alpha, warm_w, config,
                      keep)


def sven_path_solutions(X, y, ts, lambda2,
                        config: SvenConfig = SvenConfig()) -> list:
    """The solves of `sven_path`, one `SvenSolution` per point of `ts`, with
    each point's Newton and CG counts.

    Both warm starts — the dual alpha and the primal w — are carried from
    point to point, starting from zeros, as the JAX scan does.
    """
    X, y = _operands(X, y)
    config = resolve_backend(config, X, y)
    n, p = X.shape
    warm_a = X.new_zeros(2 * p)
    warm_w = X.new_zeros(n)
    sols = []
    for t in _floats(ts):
        sols.append(_sven_core(X, y, t, float(lambda2), warm_a, warm_w, config))
        warm_a, warm_w = sols[-1].alpha, sols[-1].w
    return sols


def sven_path(X, y, ts, lambda2, config: SvenConfig = SvenConfig()) -> torch.Tensor:
    """Regularization path over a grid of L1 budgets (Fig. 1), (len(ts), p):
    the betas of `sven_path_solutions`."""
    return torch.stack([sol.beta for sol in
                        sven_path_solutions(X, y, ts, lambda2, config)])


def sven_path_reference(X, y, ts, lambda2,
                        config: SvenConfig = SvenConfig()) -> torch.Tensor:
    """Reference path: one `sven` call per point, warm-started like
    `sven_path` (alpha AND w), from no warm start at the first point."""
    betas = []
    warm_a, warm_w = None, None
    for t in _floats(ts):
        sol = sven(X, y, t, lambda2, config, warm_alpha=warm_a, warm_w=warm_w)
        betas.append(sol.beta)
        warm_a, warm_w = sol.alpha, sol.w
    return torch.stack(betas)
