"""The paper's reduction: Elastic Net -> squared-hinge SVM (Algorithm 1).

Given (X in R^{n x p}, y in R^n, t > 0, lambda2 > 0) construct a binary
classification problem with m = 2p samples in d = n dimensions:

    Xhat_1 = X - (1/t) y 1^T    (columns are the +1 class)
    Xhat_2 = X + (1/t) y 1^T    (columns are the -1 class)
    Xhat   = [Xhat_1, Xhat_2]   as columns; SVM sample i is the i-th column
    yhat   = [+1_p ; -1_p],  C  = 1 / (2 lambda2)

If alpha* solves the SVM dual (3), the Elastic Net solution is

    beta* = t * (alpha*[:p] - alpha*[p:]) / |alpha*|_1.

Both an explicit construction (the paper-faithful baseline) and matrix-free
operators that never materialize the (2p, n) matrix. PyTorch counterpart of
`repro/core/reduction.py`; `t` is a Python float here. `SvenLaneOperator`
holds the operators of B problems at once (the lane-batched solve of
`core/batch.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.svm.state import pitched


# --------------------------------------------------------------------------
# Explicit construction (paper-faithful)
# --------------------------------------------------------------------------

def build_svm_dataset(X: torch.Tensor, y: torch.Tensor, t: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (Xhat, yhat): Xhat (2p, n) rows = SVM samples, yhat (2p,) labels."""
    shift = (y / t)[None, :]          # (1, n) broadcast over the p columns
    Xt = X.T                          # (p, n): row j = original feature j
    Xhat = torch.cat([Xt - shift, Xt + shift], dim=0)  # (2p, n)
    p = X.shape[1]
    yhat = torch.cat([X.new_ones(p), -X.new_ones(p)])
    return Xhat, yhat


#: Default Lasso-limit floor on lambda2 (C capped at 1/(2*floor)). The single
#: source of truth for the clamp — SvenConfig.lambda2_floor defaults to it.
LAMBDA2_FLOOR = 1e-12


def svm_C(lambda2: float, floor: float = LAMBDA2_FLOOR) -> float:
    """C = 1/(2 lambda2); capped for the Lasso limit lambda2 -> 0."""
    return 1.0 / (2.0 * max(float(lambda2), floor))


def recover_beta(alpha: torch.Tensor, t: float) -> torch.Tensor:
    """beta = t (alpha_top - alpha_bot) / sum(alpha); Algorithm 1 line 11."""
    p = alpha.shape[0] // 2
    s = torch.sum(alpha)
    # Degenerate |alpha|_1 = 0 (no support vectors) is meaningless per the
    # paper's footnote 1; guard to avoid NaN and return beta = 0.
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return torch.where(s > 0, t * (alpha[:p] - alpha[p:]) / safe,
                       alpha.new_zeros(p))


def alpha_from_primal(Xhat: torch.Tensor, yhat: torch.Tensor, w: torch.Tensor,
                      C: float) -> torch.Tensor:
    """Dual from primal solution: alpha_i = C max(0, 1 - yhat_i x_i^T w)."""
    return C * torch.clamp(1.0 - yhat * (Xhat @ w), min=0.0)


# --------------------------------------------------------------------------
# Matrix-free operators
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SvenOperator:
    """Matrix-free Xhat / Zhat operators built from the original (X, y, t).

    With a = X^T w (p,), b = y^T w / t (scalar):
        Xhat @ w          = [a - b ; a + b]
        Xhat^T @ v        = X (v_top + v_bot) + (y/t) (sum(v_bot) - sum(v_top))
        Zhat @ v          = X (v_top - v_bot) - (y/t) sum(v)          (n,)
        Zhat^T @ u        = [X^T u - (y^T u/t) 1 ; -X^T u - (y^T u/t) 1]
    where Zhat = [Xhat_1, -Xhat_2] (n x 2p) is the label-scaled data of the
    dual (3). Every product is O(np) on the original X.
    """

    X: torch.Tensor   # (n, p)
    y: torch.Tensor   # (n,)
    t: float

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def p(self) -> int:
        return self.X.shape[1]

    @property
    def m(self) -> int:
        return 2 * self.X.shape[1]

    def xhat_matvec(self, w: torch.Tensor) -> torch.Tensor:
        a = self.X.T @ w
        b = (self.y @ w) / self.t
        return torch.cat([a - b, a + b])

    def xhat_rmatvec(self, v: torch.Tensor) -> torch.Tensor:
        p = self.p
        vt, vb = v[:p], v[p:]
        return self.X @ (vt + vb) + (self.y / self.t) * (torch.sum(vb) - torch.sum(vt))

    def zhat_matvec(self, v: torch.Tensor) -> torch.Tensor:
        p = self.p
        vt, vb = v[:p], v[p:]
        return self.X @ (vt - vb) - (self.y / self.t) * torch.sum(v)

    def zhat_rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        a = self.X.T @ u
        b = (self.y @ u) / self.t
        return torch.cat([a - b, -a - b])

    def kernel_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """K v with K = Zhat^T Zhat (2p x 2p), in O(np)."""
        return self.zhat_rmatvec(self.zhat_matvec(v))

    def margins(self, w: torch.Tensor) -> torch.Tensor:
        """yhat * (Xhat @ w) as used by the squared hinge."""
        p = self.p
        o = self.xhat_matvec(w)
        return torch.cat([o[:p], -o[p:]])


class SvenLaneOperator:
    """`SvenOperator` for B problems at once: X (n, p) shared by the lanes or
    (B, n, p), y (n,) or (B, n), t a list of B floats. Every product takes
    and returns a leading lane axis and is each lane's `SvenOperator`
    product, with its bits: each lane's operand is handed over laid out as
    a fresh tensor (see `core/svm/state.py::lanes`)."""

    def __init__(self, X: torch.Tensor, y: torch.Tensor, t):
        self.ops = [SvenOperator(X=X if X.dim() == 2 else X[i],
                                 y=y if y.dim() == 1 else y[i], t=ti)
                    for i, ti in enumerate(t)]

    def _each(self, name: str, v: torch.Tensor) -> torch.Tensor:
        v = pitched(v)
        return torch.stack([getattr(op, name)(v[i]) for i, op in enumerate(self.ops)])

    def xhat_matvec(self, w: torch.Tensor) -> torch.Tensor:
        return self._each("xhat_matvec", w)

    def xhat_rmatvec(self, v: torch.Tensor) -> torch.Tensor:
        return self._each("xhat_rmatvec", v)

    def zhat_matvec(self, v: torch.Tensor) -> torch.Tensor:
        return self._each("zhat_matvec", v)

    def kernel_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """K v of each lane, in O(np) a lane."""
        return self._each("kernel_matvec", v)


def gram_from_stats(G: torch.Tensor, u: torch.Tensor, s) -> torch.Tensor:
    """K = Zhat^T Zhat (2p x 2p) from the sufficient statistics
    G = X^T X (p, p), u = X^T y / t (p,), s = y^T y / t^2 (scalar):

        K = [[ G - u1' - 1u' + s ,  -G - u1' + 1u' + s ],
             [ -G + u1' - 1u' + s,   G + u1' + 1u' + s ]]
    """
    u1 = u[:, None]
    u2 = u[None, :]
    top = torch.cat([G - u1 - u2 + s, -G - u1 + u2 + s], dim=1)
    bot = torch.cat([-G + u1 - u2 + s, G + u1 + u2 + s], dim=1)
    return torch.cat([top, bot], dim=0)


def gram_blocks(X: torch.Tensor, y: torch.Tensor, t: float) -> torch.Tensor:
    """K = Zhat^T Zhat (2p x 2p) from one p x p Gram (np^2 MACs instead of
    the (2p)^2 n of materializing Zhat)."""
    return gram_from_stats(X.T @ X, (X.T @ y) / t, (y @ y) / (t * t))


def gram_reference(X: torch.Tensor, y: torch.Tensor, t: float) -> torch.Tensor:
    """Paper-faithful K: materialize Zhat then Zhat^T Zhat."""
    Xhat, yhat = build_svm_dataset(X, y, t)
    Zhat = (yhat[:, None] * Xhat).T   # (n, 2p)
    return Zhat.T @ Zhat
