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
  product (each rank holds a partial sum of the output). `reduce_product`
  is a row-split product and its sum: for bf16 operands each rank's
  partial comes out of the GEMM in float32 (`wide_matmul`, bf16 products
  accumulated in float32) and the partials are summed in float32, then
  rounded once, as the unsplit product rounds its accumulation once.
  JAX's psum sums the bf16 partials (each rounded first); the port's sum
  is the closer to one device's product (PERF.md, §6).

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
all-reduce, the z-loss on that log-sum-exp), `gather_last` a block of the
last dim (the serving steps' logits) made whole.

Three operators for what the records split without following the
compute:

- `gather_packed`: leaves whose record splits a dim into contiguous
  blocks that do not follow the parts packed along it (the SSM's `w_in`
  output packs z, x, B, C and dt; `conv_w`, `conv_b` and the conv cache
  pack x, B and C), made whole in one all-gather a dtype; backward
  all-reduces the gradient and hands each rank its block;
- `rms_norm_split`: an RMSNorm over a channel dim split over the view,
  the sum of squares all-reduced both ways (forward: the whole dim's
  statistic; backward: every rank's channels feed it);
- `attend_split`: softmax attention over a key dim split over a view
  (flash decoding): each rank's row maximum, exp-sums and weighted values
  of its keys, all-reduced in turn. The probabilities are normalized by
  the whole exp-sum and rounded to the values' dtype before the weighted
  sum, as the unsplit softmax rounds them, so bf16 ranks track one
  process. Serving only (no backward).
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


class _WideMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if not a.is_cuda:       # bf16 products are exact in float32
            return torch.matmul(a.float(), b.float())
        if b.dim() == 2:
            out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return out.view(*a.shape[:-1], b.shape[-1])
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = grad.to(a.dtype)
        ga = g @ b.mT if ctx.needs_input_grad[0] else None
        gb = None
        if ctx.needs_input_grad[1]:
            gb = (a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
                  if b.dim() == 2 else a.mT @ g)
        return ga, gb


def wide_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, b (k, n) beside a (..., k), or b (E, k, n) beside a (E, m, k).
    Operands narrower than float32 (bf16) give a float32 result: on the
    card one tensor-core GEMM with a float32 output (`out_dtype`), on the
    CPU the product of the widened operands (the same products and sums).
    Backward takes the gradient in the operands' dtype. The plain product
    for float32 operands."""
    if a.dtype.itemsize >= 4:
        return a @ b
    return _WideMatmul.apply(a, b)


def reduce_product(mesh: Optional[dist.Mesh], a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of a row-split product (a's last dim and b's rows this rank's
    block), summed over `mesh`: the partials `wide_matmul` gives are summed
    (in float32 for bf16) and rounded once to a's dtype. `a @ b` when
    `mesh` is None."""
    if mesh is None:
        return a @ b
    return reduce_from(mesh, wide_matmul(a, b)).to(a.dtype)


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


def gather_last(mesh: Optional[dist.Mesh], x: torch.Tensor) -> torch.Tensor:
    """The whole last dim from each rank's block of it (block `mesh.rank`
    of `mesh.size`), by a zero-filled all-reduce; x itself when `mesh` is
    None. Not differentiable (the serving steps' logits)."""
    if mesh is None:
        return x
    n = x.shape[-1]
    full = x.new_zeros(tuple(x.shape[:-1]) + (n * mesh.size,))
    full[..., mesh.rank * n:(mesh.rank + 1) * n] = x
    return dist.all_reduce_(mesh, full)


def _packed_whole(view, blocks, dims):
    """Each block made whole along its dim over `view`: the blocks of a
    dtype flattened together, all-gathered once, and each cut back out of
    every rank's piece."""
    out = list(blocks)
    for dtype in dict.fromkeys(x.dtype for x in blocks):
        idx = [i for i, x in enumerate(blocks) if x.dtype == dtype]
        sizes = [blocks[i].numel() for i in idx]
        pieces = [torch.split(p, sizes) for p in dist.all_gather(
            view, torch.cat([blocks[i].reshape(-1) for i in idx]))]
        for n, i in enumerate(idx):
            out[i] = torch.cat([p[n].view(blocks[i].shape) for p in pieces], dim=dims[i])
    return out


def _all_reduce_flat(view, tensors):
    """`tensors` summed over `view` in place of them: one all-reduce of
    their concatenation a dtype."""
    out = list(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = dist.all_reduce_(view, torch.cat([tensors[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


class _GatherPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, view, dims, *blocks):
        ctx.view, ctx.dims = view, dims
        ctx.sizes = [x.shape[d] for x, d in zip(blocks, dims)]
        return tuple(_packed_whole(view, blocks, dims))

    @staticmethod
    def backward(ctx, *grads):
        view = ctx.view
        whole = _all_reduce_flat(view, [g.contiguous() for g in grads])
        out = [g.narrow(d, view.rank * n, n).clone()
               for g, d, n in zip(whole, ctx.dims, ctx.sizes)]
        return (None, None, *out)


def gather_packed(view: Optional[dist.Mesh], blocks, dims) -> list:
    """Each of `blocks` (this rank's contiguous block along its dim in
    `dims`, block `view.rank` of `view.size`) made whole, in one all-gather
    over `view` a dtype; a block of None view is whole already.
    Backward all-reduces the gradients and narrows each to its block.
    The blocks as they are when `view` is None."""
    if view is None:
        return list(blocks)
    return list(_GatherPacked.apply(view, tuple(dims), *blocks))


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor, view: Optional[dist.Mesh],
                   eps: float = 1e-6) -> torch.Tensor:
    """`layers.rms_norm` of the whole last dim from this rank's channels of
    it (x and `scale` blocks split over `view`): the sum of squares
    all-reduced in forward, and its gradient all-reduced in backward (every
    rank's channels feed the statistic). The plain norm when `view` is
    None."""
    from repro_torch.models.layers import rms_norm

    if view is None:
        return rms_norm(x, scale, eps)
    dtype = x.dtype
    xf = x.to(torch.float32)
    sq = reduce_from(view, copy_to(view, torch.sum(xf * xf, dim=-1, keepdim=True)))
    var = sq / (x.shape[-1] * view.size)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * scale.to(dtype)


def attend_split(scores: torch.Tensor, values: torch.Tensor,
                 view: Optional[dist.Mesh]) -> torch.Tensor:
    """softmax(scores) @ values over a key dim split over `view` (flash
    decoding). scores (B, H, Q, K) float32, already masked (-1e30), over
    this rank's keys; values (B, K, H, D) per head, or (B, K, D) shared by
    the heads (MLA's latents). Returns (B, Q, H, D) in the values' dtype,
    the same on every rank of `view`: the maximum, the exp-sums and the
    weighted values each all-reduced (the last as float32 partials,
    `wide_matmul`, rounded once). With
    `view` None, the plain softmax, its probabilities cast to the values'
    dtype first, as `_sdpa` computes it."""
    eq = "bhqk,bkhd->bqhd" if values.dim() == 4 else "bhqk,bkd->bqhd"
    if view is None:
        probs = torch.softmax(scores, dim=-1).to(values.dtype)
        return torch.einsum(eq, probs, values)
    m = dist.all_reduce(view, scores.amax(dim=-1, keepdim=True), op="max")
    p = torch.exp(scores - m)
    probs = (p / dist.all_reduce(view, p.sum(dim=-1, keepdim=True))).to(values.dtype)
    (B, H, Q, K), D = probs.shape, values.shape[-1]
    if values.dim() == 4:       # a (B H) batch of (Q, K) @ (K, D)
        out = wide_matmul(probs.reshape(B * H, Q, K),
                          values.permute(0, 2, 1, 3).reshape(B * H, K, D))
    else:                       # the latents shared by the heads
        out = wide_matmul(probs.reshape(B, H * Q, K), values)
    out = reduce_from(view, out).to(values.dtype)
    return out.view(B, H, Q, D).permute(0, 2, 1, 3)
