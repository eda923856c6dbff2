"""Adafactor (Shazeer & Stern, 2018): the port of `repro/optim/adafactor.py`.
Factored second moments: rank-1 (row, col) statistics instead of a full v
tensor for matrices, cutting optimizer memory from 2x to ~1.01x params.
A leaf is factored when its last two axes both exceed 1 (JAX's rule);
otherwise it keeps a full v_row and a 0-size v_col stub. Updates are
clipped by their RMS. Everything stays on the device, as in `adamw.py`."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


class AdafactorState(NamedTuple):
    v_row: Any     # per-leaf: (rows,) for matrices, full shape for vectors
    v_col: Any     # per-leaf: (cols,) for matrices, 0-size stub otherwise
    count: torch.Tensor


def _is_factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Any) -> AdafactorState:
    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vr(p):
        return zeros(p.shape[:-1] if _is_factored(p.shape) else p.shape, p)

    def vc(p):
        return zeros(p.shape[:-2] + p.shape[-1:] if _is_factored(p.shape) else (0,), p)

    dev = tree_leaves(params)[0].device
    return AdafactorState(v_row=tree_map(vr, params), v_col=tree_map(vc, params),
                          count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adafactor_update(grads: Any, state: AdafactorState, params: Any, *,
                     lr=1e-2, decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    count = state.count + 1
    beta2 = 1.0 - count.to(torch.float32) ** (-decay)

    def upd(g, vr, vc, p):
        g32 = g.to(torch.float32)
        gsq = g32 * g32 + eps
        if _is_factored(p.shape):
            vr_new = beta2 * vr + (1 - beta2) * torch.mean(gsq, dim=-1)
            vc_new = beta2 * vc + (1 - beta2) * torch.mean(gsq, dim=-2)
            denom = torch.clamp(torch.mean(vr_new, dim=-1, keepdim=True), min=eps)
            vhat = (vr_new[..., None] / denom[..., None]) * vc_new[..., None, :]
            step = g32 / torch.sqrt(vhat + eps)
        else:
            vr_new = beta2 * vr + (1 - beta2) * gsq
            vc_new = vc
            step = g32 / torch.sqrt(vr_new + eps)
        # update clipping (RMS)
        rms = torch.sqrt(torch.mean(step * step) + eps)
        step = step / torch.clamp(rms / clip_threshold, min=1.0)
        p32 = p.to(torch.float32)
        p_new = p32 - lr * (step + weight_decay * p32)
        return p_new.to(p.dtype), vr_new, vc_new

    out = [upd(g, vr, vc, p) for g, vr, vc, p in zip(
        tree_leaves(grads), tree_leaves(state.v_row), tree_leaves(state.v_col),
        tree_leaves(params))]
    new_p, new_vr, new_vc = ([o[i] for o in out] for i in range(3))
    return tree_unflatten(grads, new_p), AdafactorState(
        v_row=tree_unflatten(grads, new_vr), v_col=tree_unflatten(grads, new_vc), count=count)
