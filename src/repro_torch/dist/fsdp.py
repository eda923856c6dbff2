"""The FSDP layer gather: parameters split over "data" (by the `fsdp`
rule's widening, or by `expert_fsdp`) made whole for the layer that uses
them, and their gradients handed back as blocks. The port of what GSPMD
inserts for JAX around a layer whose weights are sharded over "data"; it
has no JAX module of its own.

`gather(tree, recs)` is a `torch.autograd.Function` over the leaves that
their records split over an axis other than "model": each becomes its
"model" block (`Sharding.only("model")`), as tensor parallelism
(`dist.tp`) computes on it. A body layer's stacked leaf, which JAX's
widening splits on the stacked dim (a rank holds whole layers), is
broadcast from the rank that owns the layer; any other leaf (the tied
table, a prefix layer, the MTP block, `expert_fsdp`'s expert weights) is
gathered by a zero-filled all-reduce (`shardings.gather_leaf`). Backward
all-reduces each leaf's gradient over those axes and hands each rank its
block: the owner the whole layer, the others nothing. The gradient is then
the sum over the data ranks, and the step divides it by their number, as
it divides the all-reduced gradients of the replicated leaves.

`models/model.py` calls it inside each checkpointed layer, so remat
recomputes the gather and only the blocks outlive a layer; its prefill
and decode steps call it a layer at a time under `torch.inference_mode()`
(no checkpoint, no backward), decode_32k's layout among them.
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.dist import shardings as dsh
from repro_torch.dist.tp import AXIS
from repro_torch.utils import tree_leaves, tree_unflatten


def _gathered(rec) -> bool:
    return rec is not None and any(a != AXIS for a in rec.split_axes())


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, recs, *blocks):
        ctx.recs = recs
        outs = []
        for x, rec in zip(blocks, recs):
            out = dsh.gather_leaf(x, rec, rec.only((AXIS,)))
            outs.append(out.view_as(out) if out is x else out)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, rec in zip(grads, ctx.recs):
            to = rec.only((AXIS,))
            g = g.contiguous()
            for a in rec.split_axes():
                if a not in to.split_axes():
                    g = dist.all_reduce(rec.mesh.view(a), g)
            blk = dsh._narrow(g, to, rec)
            out.append(blk.clone() if blk.numel() < g.numel() else blk)
        return (None, *out)


def gather(tree, recs):
    """`tree` with each leaf whose record (in `recs`, a record tree like
    it, or None) splits it over an axis other than "model" replaced by its
    "model" block; the other leaves as they are. Differentiable."""
    if recs is None:
        return tree
    leaves, rec_leaves = tree_leaves(tree), tree_leaves(recs)
    idx = [i for i, r in enumerate(rec_leaves) if _gathered(r)]
    if not idx:
        return tree
    outs = _Gather.apply(tuple(rec_leaves[i] for i in idx), *(leaves[i] for i in idx))
    new = list(leaves)
    for i, o in zip(idx, outs):
        new[i] = o
    return tree_unflatten(tree, new)


def reduced(rec) -> bool:
    """Whether the gradient of a leaf with record `rec` comes out of the
    layer gather's backward already summed over the data ranks."""
    return _gathered(rec)
