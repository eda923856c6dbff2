"""Gradient compression for cross-pod links: the port of
`repro/dist/compress.py`.

Two ladder rungs below full-precision all-reduce:

* bf16 round-trip — halves gradient wire bytes; unbiased enough for AdamW
  (the f32 master accumulation lives in the optimizer state).
* top-k sparsification with ERROR FEEDBACK — each step emits only the
  `frac` largest-magnitude entries of (gradient + residual) and banks the
  rest in the residual. The residual guarantees every coordinate is
  eventually transmitted: with a constant gradient the running mean of
  emissions converges to the gradient, and `frac=1.0` degenerates to
  exact transmission with a zero residual.

Both operate leaf-wise on gradient trees and are pure: state threads
explicitly. `torch.topk` may order entries of equal magnitude otherwise
than `jax.lax.top_k`, so which of two tied entries is emitted can differ.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


def bf16_compress(grads):
    """Cast float leaves to bf16 for the wire; non-floats pass through."""
    return tree_map(lambda g: g.to(torch.bfloat16) if g.is_floating_point() else g, grads)


def bf16_decompress(wire, like):
    """Cast wire leaves back to the dtypes of `like` (the original grads)."""
    return tree_map(lambda g, l: g.to(l.dtype), wire, like)


def topk_init(grads):
    """Zero error-feedback residual, one leaf per gradient leaf."""
    return tree_map(torch.zeros_like, grads)


def _k_for(size: int, frac: float) -> int:
    return max(1, min(size, int(math.ceil(frac * size))))


def topk_compress(grads, state, *, frac: float = 0.01):
    """(grads, residual) -> (values, indices, new_residual).

    Per leaf: form the error-corrected signal c = g + residual, emit its
    top-k entries by magnitude (signed values + flat indices), and keep the
    un-emitted remainder as the new residual.
    """
    vals_out, idx_out, res_out = [], [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(state)):
        c = (g + r).reshape(-1)
        k = _k_for(c.numel(), frac)
        idx = torch.topk(c.abs(), k).indices
        vals_out.append(c[idx])
        idx_out.append(idx)
        res = c.clone()
        res[idx] = 0
        res_out.append(res.reshape(g.shape))
    return (tree_unflatten(grads, vals_out), tree_unflatten(grads, idx_out),
            tree_unflatten(grads, res_out))


def topk_decompress(values, indices, like):
    """Scatter (values, flat indices) back to dense leaves shaped as `like`."""
    def dense(v, i, l):
        out = torch.zeros(l.numel(), dtype=v.dtype, device=v.device)
        out[i] = v
        return out.reshape(l.shape)

    return tree_map(dense, values, indices, like)
