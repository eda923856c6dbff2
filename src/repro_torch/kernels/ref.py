"""Plain PyTorch versions of the hand-written kernels.

One function per kernel, computing the same function from the same
operands: the X storage dtype is taken as given (float32, bfloat16 or
float64) and the products accumulate in the operands' dtype, float32 for
bfloat16 storage. On float64 operands the hinge passes are the plain
float64 product of `repro/core/svm/primal_newton.py`, in its order of
operations. These are what the CPU runs, what the
tests hold the JAX package against, and what `chip_smoke.py` holds each
CUDA kernel against on the card. Nothing on the main path calls them on a
CUDA tensor. PyTorch counterpart of `repro/kernels/ref.py`.
"""
from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 storage is read into float32 before any product."""
    return x.to(torch.float32) if x.dtype == torch.bfloat16 else x


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the `cvt.rna.tf32.f32` rounding of the CUDA Gram kernel.
    Takes float32 only, as the kernel's tf32 mode does."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32: x is {x.dtype}, expected torch.float32")
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def gram_blocks_ref(X: torch.Tensor, y: torch.Tensor, t: float,
                    precision: str = "f32") -> torch.Tensor:
    """Plain fused shifted Gram, K in block layout (2, 2, p, p):

        K[a, b, i, j] = s_a s_b G_ij - s_a u_i - s_b u_j + s

    with s_0=+1, s_1=-1, G = X^T X, u = X^T y / t, s = y^T y / t^2, in the
    operands' dtype (float32 for bfloat16 storage; float64 operands give
    the float64 K of the kernel's float64 body). `precision="tf32"` rounds
    float32 X and y to TF32 first, as the kernel does.
    """
    X, y = _acc(X), _acc(y)
    if precision == "tf32":
        X, y = round_tf32(X), round_tf32(y)
    G = X.T @ X
    u = (X.T @ y) / t
    s = (y @ y) / (t * t)
    signs = torch.tensor([1.0, -1.0], dtype=X.dtype, device=X.device)
    sa = signs[:, None, None, None]          # (2,1,1,1)
    sb = signs[None, :, None, None]          # (1,2,1,1)
    ui = u[None, None, :, None]
    uj = u[None, None, None, :]
    return sa * sb * G[None, None] - sa * ui - sb * uj + s


def flatten_gram(Kb: torch.Tensor) -> torch.Tensor:
    """(2,2,p,p) block layout -> (2p,2p) kernel matrix."""
    p = Kb.shape[-1]
    return Kb.permute(0, 2, 1, 3).reshape(2 * p, 2 * p)


def hinge_xtv_ref(X: torch.Tensor, y: torch.Tensor, v: torch.Tensor, t: float,
                  act_top: torch.Tensor, act_bot: torch.Tensor):
    """Plain hinge pass 1: masked dual-side reduction of Xhat @ v.

    c   = X^T v                       (p,)
    byv = (y . v) / t                 scalar
    u_t = act_top * (c - byv);  u_b = act_bot * (c + byv)
    returns d = u_t + u_b (p,), e = sum(u_b) - sum(u_t) (0-d)
    """
    c = _acc(X).T @ v
    byv = (y @ v) / t
    u_t = act_top * (c - byv)
    u_b = act_bot * (c + byv)
    return u_t + u_b, torch.sum(u_b) - torch.sum(u_t)


def hinge_xd_ref(X: torch.Tensor, y: torch.Tensor, d: torch.Tensor,
                 e: torch.Tensor, v: torch.Tensor, t: float, C: float) -> torch.Tensor:
    """Plain hinge pass 2: H v = v + 2C (X d + (y/t) e)."""
    return v + 2.0 * C * (_acc(X) @ d + (y / t) * e)


def hessian_matvec_ref(X, y, t, C, act_top, act_bot, v):
    """Full squared-hinge Hessian mat-vec (primal Newton-CG inner op)."""
    d, e = hinge_xtv_ref(X, y, v, t, act_top, act_bot)
    return hinge_xd_ref(X, y, d, e, v, t, C)


def _lane(x: torch.Tensor, i: int, shared_dim: int) -> torch.Tensor:
    """Lane i of x, or x itself when it has `shared_dim` dims (shared)."""
    return x if x.dim() == shared_dim else x[i]


def hinge_xtv_lanes_ref(X: torch.Tensor, y: torch.Tensor, v: torch.Tensor,
                        t: torch.Tensor, act_top: torch.Tensor, act_bot: torch.Tensor):
    """Plain hinge pass 1 for B problems: `hinge_xtv_ref` on each lane.

    X (n, p) shared or (B, n, p); y (n,) or (B, n); v (B, n); t (B,);
    act_top, act_bot (B, p). Returns d (B, p) and e (B,).
    """
    t = t.to(v.dtype)
    d, e = zip(*(hinge_xtv_ref(_lane(X, i, 2), _lane(y, i, 1), v[i], t[i], act_top[i],
                               act_bot[i]) for i in range(v.shape[0])))
    return torch.stack(d), torch.stack(e)


def hinge_xd_lanes_ref(X: torch.Tensor, y: torch.Tensor, d: torch.Tensor,
                       e: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                       C: torch.Tensor) -> torch.Tensor:
    """Plain hinge pass 2 for B problems: `hinge_xd_ref` on each lane, (B, n).
    d (B, p), e (B,), C (B,); the rest as for `hinge_xtv_lanes_ref`."""
    t, C = t.to(v.dtype), C.to(v.dtype)
    return torch.stack([hinge_xd_ref(_lane(X, i, 2), _lane(y, i, 1), d[i], e[i], v[i],
                                     t[i], C[i]) for i in range(v.shape[0])])


def hinge_stats_from_moments(a: torch.Tensor, byw, ww, C):
    """The margin/act/loss/galpha tail of the hinge-stats fusion, from the
    sufficient moments a = X^T w (p,), byw = (y . w) / t and ww = w . w."""
    p = a.shape[0]
    o = torch.cat([a - byw, a + byw])
    margin = torch.cat([o[:p], -o[p:]])
    act = (margin < 1.0).to(a.dtype)
    xi = act * (1.0 - margin)
    loss = 0.5 * ww + C * (xi @ xi)
    yhat = torch.cat([a.new_ones(p), -a.new_ones(p)])
    galpha = act * (o - yhat)
    return margin, act, loss, galpha


def hinge_stats_ref(X: torch.Tensor, y: torch.Tensor, t: float, w: torch.Tensor, C: float):
    """Plain fused margins/loss/gradient of the Newton outer step on the
    implicit SVEN dataset. Returns (margin, act, loss, galpha)."""
    a = (_acc(X).T @ w).to(w.dtype)
    return hinge_stats_from_moments(a, (y @ w) / t, w @ w, C)
