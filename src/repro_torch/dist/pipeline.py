"""Microbatch pipeline parallelism over a `pipe` mesh axis: the port of
`repro/dist/pipeline.py`.

GPipe schedule: stage s (this rank's index along the axis) holds its own
slice of the stacked stage params; at tick t it runs microbatch t - s
(when valid) and hands its activation to stage s + 1. A run of M
microbatches over S stages takes M + S - 1 ticks with the familiar
(S - 1) / (M + S - 1) bubble.

JAX hands the activation on by a ring `ppermute`. Here the hand-off is an
all-reduce: each rank writes its output into its successor's slot of a
zero-filled (S, ...) buffer and takes its own slot, which is exact (the
other ranks add zeros) and serves gloo, which takes CUDA tensors for
`all_reduce` and `broadcast` only, and NCCL alike. The last stage's
outputs are all-reduced at the end, so every rank returns them, as
JAX's `psum` does.

`sequential_reference` is the semantics oracle: composing the stages in
order over all microbatches.
"""
from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.utils import tree_leaves, tree_map


def sequential_reference(stage_fn, params, x):
    """Compose the S stages in order on the full (M, Bm, ...) batch."""
    n_stages = tree_leaves(params)[0].shape[0]
    for s in range(n_stages):
        x = stage_fn(tree_map(lambda t: t[s], params), x)
    return x


def pipeline_apply(mesh: dist.Mesh, stage_fn, params, x, *, axis: str = "pipe"):
    """Run `stage_fn` as an S-stage pipeline over microbatches.

    params: tree with a leading stage dim of size mesh.shape[axis] on every
    leaf; x: (M, Bm, ...) microbatched input, the same on every rank.
    Stages must preserve the microbatch shape (residual-stream style), as
    each stage's output is the next stage's input. Returns (M, Bm, ...)
    outputs, replicated. Every rank runs M + S - 1 ticks, one all-reduce
    each, and one more for the outputs.
    """
    n_stages = mesh.shape[axis]
    if any(a != axis for a in dist.split_axes(mesh)):
        raise ValueError(f"pipeline_apply: the mesh {mesh.shape} splits another axis "
                         f"than {axis!r}")
    n_mb = x.shape[0]
    s = mesh.coord(axis)
    last = n_stages - 1
    p = tree_map(lambda t: t[s], params)
    state = torch.zeros_like(x[0])
    out_buf = torch.zeros_like(x)
    for t in range(n_mb + last):
        # stage 0 ingests microbatch t; later stages consume the handed-on
        # activation (microbatch t - s, pipelined in from stage s - 1)
        out = stage_fn(p, x[min(t, n_mb - 1)] if s == 0 else state)
        # stage S - 1 retires microbatch t - (S - 1) once it is valid
        if s == last and t - last >= 0:
            out_buf[t - last] = out
        if n_stages == 1:
            state = out
            continue
        ring = torch.zeros((n_stages,) + tuple(out.shape), dtype=out.dtype,
                           device=out.device)
        ring[(s + 1) % n_stages] = out
        state = dist.all_reduce(mesh, ring)[s]
    # only the last stage wrote anything; the all-reduce replicates it
    return dist.all_reduce(mesh, out_buf) if n_stages > 1 else out_buf
