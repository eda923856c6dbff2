"""AdamW on tensor trees: the port of `repro/optim/adamw.py`. First and
second moments are float32 whatever the parameter's dtype (bf16-safe).

Everything stays on the device: the step count is an int32 tensor, the
bias corrections are float32 powers of it, the global norm and the clip
scale are device tensors, and `lr` may be a float or a device tensor (a
schedule's value), so an update makes no host read. Leaves are updated
one by one, as JAX's are."""
from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from repro_torch import dist
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor     # int32 scalar on the parameters' device


def _f32_like(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), tree)


def adamw_init(params: Any) -> AdamWState:
    dev = tree_leaves(params)[0].device
    return AdamWState(m=_f32_like(params), v=_f32_like(params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree: Any, records: Any = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32, on the device.

    With `records` (a record tree like `tree`, `dist.shardings`), each leaf
    is this rank's block and each global element counts once: the leaves
    are grouped by the axes their records split them over, each group's
    squares are summed and then summed over the view of each of its axes,
    and a replicated leaf is counted once, not once a rank. The same norm
    comes out on every rank."""
    if records is None:
        sums = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
        return torch.sqrt(torch.sum(torch.stack(sums)))
    groups: dict = {}
    for x, rec in zip(tree_leaves(tree), tree_leaves(records)):
        axes, mesh = rec.split_axes(), rec.mesh
        groups.setdefault(axes, (mesh, []))[1].append(
            torch.sum(torch.square(x.to(torch.float32))))
    parts = []
    for axes in sorted(groups):
        mesh, sums = groups[axes]
        part = torch.sum(torch.stack(sums))
        for a in axes:
            part = dist.all_reduce(mesh.view(a), part)
        parts.append(part)
    return torch.sqrt(torch.sum(torch.stack(parts)))


def clip_by_global_norm(grads: Any, max_norm: float,
                        records: Any = None) -> tuple[Any, torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), norm); the scale is cast to
    each gradient's dtype, as JAX's is. `records`: as `global_norm`'s."""
    norm = global_norm(grads, records)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    *,
    lr: Union[torch.Tensor, float],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    donate: bool = False,
) -> tuple[Any, AdamWState]:
    """(new params, new state). With `donate` (JAX's `donate_argnums` of
    the sharded step), m, v and the parameters are overwritten in place and
    returned, the same bits in the same order of operations: the caller's
    operands are then the results, and the update holds no second copy of
    the moments."""
    count = state.count + 1
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        if donate:
            m_new = m.mul_(b1).add_((1 - b1) * g32)
            v_new = v.mul_(b2).add_((1 - b2) * g32 * g32)
        else:
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * g32 * g32
        step = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        p32 = p.to(torch.float32)
        p_new = (p32 - lr * (step + weight_decay * p32)).to(p.dtype)
        return (p.copy_(p_new) if donate else p_new), m_new, v_new

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v), tree_leaves(params))]
    new_p, new_m, new_v = ([o[i] for o in out] for i in range(3))
    return tree_unflatten(grads, new_p), AdamWState(
        m=tree_unflatten(grads, new_m), v=tree_unflatten(grads, new_v), count=count)
