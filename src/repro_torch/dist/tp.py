"""Tensor parallelism over the "model" axis: the operators GSPMD inserts
for JAX when it lowers a step whose parameter records split `heads`,
`kv_heads`, `mlp`, `vocab`, `experts` or `expert_ffn` over "model"
(`launch/dryrun.py`'s train step). This module has no JAX counterpart: in
the port each rank computes on its block, and these operators are the
collectives that make the blocks' results the whole layer's.

Megatron's two operators, each over a "model" view (`Mesh.view`):

- `copy_to`: identity forward, all-reduce backward; at the input of a
  column-split product (each rank's input gradient holds only its
  columns' part);
- `reduce_from`: all-reduce forward, identity backward; after a row-split
  product (each rank holds a partial sum of the output).

A layer's records (`dist.shardings.Sharding`, the layer's sub-dict of the
step's parameter records) say which of its weights are split:
`model_view(rec, dim)` is the "model" view when `rec` splits `dim` over a
"model" axis of more than one rank, else None, and every operator is the
identity on None. So a weight the rules leave replicated (a dim the axis
does not divide) is computed whole on every rank, as JAX computes it.

The vocabulary: `embed_lookup` is a masked local lookup and an
all-reduce (exact: the other ranks add zeros), `vocab_xent` the
cross-entropy of vocab-split logits (the log-sum-exp from an all-reduced
maximum and exp-sum, the gold logit by a masked local gather and an
all-reduce, the z-loss on that log-sum-exp).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import dist

#: the mesh axis tensor parallelism runs over
AXIS = "model"


def model_view(rec, dim: int) -> Optional[dist.Mesh]:
    """The "model" view of `rec`'s mesh when the record (a `Sharding`, or
    None) splits `dim` over a "model" axis of more than one rank, else
    None."""
    if rec is None or dim >= len(rec.spec) or rec.spec[dim] != AXIS:
        return None
    view = rec.mesh.view(AXIS)
    return view if view.size > 1 else None


def records(rec, key: str):
    """`rec[key]` of a layer's record dict, None when `rec` is None."""
    return None if rec is None else rec.get(key)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return dist.all_reduce(ctx.mesh, grad.contiguous()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return dist.all_reduce(mesh, x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(mesh: Optional[dist.Mesh], x: torch.Tensor) -> torch.Tensor:
    """x, whose gradient is summed over `mesh` in backward (x itself when
    `mesh` is None)."""
    return x if mesh is None else _CopyTo.apply(x, mesh)


def reduce_from(mesh: Optional[dist.Mesh], x: torch.Tensor) -> torch.Tensor:
    """x summed over `mesh`, its gradient handed on as it is (x itself when
    `mesh` is None)."""
    return x if mesh is None else _ReduceFrom.apply(x, mesh)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, mesh: Optional[dist.Mesh]):
    """`F.embedding(tokens, table)` of the whole table, from this rank's
    block of rows (`mesh` the "model" view it is split over, or None)."""
    if mesh is None:
        return F.embedding(tokens, table)
    rows = table.shape[0]
    local = tokens - mesh.rank * rows
    inside = (local >= 0) & (local < rows)
    emb = F.embedding(torch.clamp(local, 0, rows - 1), table)
    return reduce_from(mesh, torch.where(inside[..., None], emb, torch.zeros_like(emb)))


def vocab_xent(logits: torch.Tensor, targets: torch.Tensor, z_loss: float,
               mesh: dist.Mesh) -> torch.Tensor:
    """`train.step._xent` of logits whose last dim is this rank's block of
    the vocabulary (block `mesh.rank` of `mesh.size`): stable CE + z-loss,
    per position, the same on every rank of `mesh`."""
    v = logits.shape[-1]
    m = dist.all_reduce(mesh, logits.detach().amax(dim=-1), op="max")
    sumexp = reduce_from(mesh, torch.exp(logits - m[..., None]).sum(dim=-1))
    lse = m + torch.log(sumexp)
    local = targets.long() - mesh.rank * v
    inside = (local >= 0) & (local < v)
    picked = torch.gather(logits, -1, torch.clamp(local, 0, v - 1)[..., None])[..., 0]
    gold = reduce_from(mesh, torch.where(inside, picked, torch.zeros_like(picked)))
    return (lse - gold) + z_loss * torch.square(lse)
