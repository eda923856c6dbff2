"""Training step: causal-LM loss (z-loss regularized), microbatched
gradient accumulation, clipping and AdamW, over the ranks of a data mesh.
The port of `repro/train/step.py`, with autograd in place of
`jax.value_and_grad` and a Python loop over microbatches in place of
`lax.scan`.

Remat lives in the model (`cfg.remat`, `models/model.py::forward`), as in
JAX. A step makes no synchronizing CUDA call on one rank: its metrics stay
device tensors, so the caller's one read of the loss is the step's only
wait.

**Ranks.** Under a `dist.mesh_context` whose "batch" rule splits the
global batch over W > 1 ranks, each rank computes on its block of each
microbatch's rows, and the gradients and metrics are all-reduced to the
global means in their own dtype (the MoE's load-balance fractions sum
over the ranks inside the forward, `dist.data_parallel`). A batch that W
does not divide is computed whole on every rank, and rank 0's gradients
are handed to all (nothing counted twice). The step takes the global
batch, as JAX's does. `shardings=(p_sh, o_sh, b_sh)` (from
`dist.shardings.run_sharded`) names how the operands lie: moments placed
by `dist.zero.zero1_shardings` are updated a block a rank, and the
parameters are gathered back to their replicated layout. JAX's
`grad_shardings` (the layout each rank keeps of the gradients) and the
parameter records may only replicate for now: a record that splits a leaf
over "data" (FSDP) or a "model" axis raises NotImplementedError."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import dist
from repro_torch.dist import shardings as dsh
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWState, adamw_update, clip_by_global_norm
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


def _xent(logits: torch.Tensor, targets: torch.Tensor, z_loss: float = 1e-4):
    """Stable CE + z-loss. logits (..., V) float32, targets (...) integer."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    ce = lse - gold
    return ce + z_loss * torch.square(lse)


def lm_loss(params, cfg: M.ModelConfig, batch: dict, aux_weight: float = 0.01,
            mtp_weight: float = 0.3):
    """Next-token loss across front ends; adds the MoE aux loss and
    DeepSeek-V3's MTP loss. -> (loss, {"ce", "aux"[, "mtp_ce"]})."""
    need_hidden = cfg.mtp_depth > 0
    out = M.forward(params, cfg, batch, return_hidden=need_hidden)
    logits, aux = out[0], out[1]
    toks = batch["tokens"]

    if cfg.frontend == "patches":          # predict text tokens only
        logits = logits[:, cfg.vision_tokens:]
    # codebooks: (B,S,K,V) against (B,S,K); tokens: (B,S,V) against (B,S)
    loss = _xent(logits[:, :-1], toks[:, 1:]).mean()

    metrics = {"ce": loss}
    if cfg.mtp_depth > 0 and cfg.frontend == "tokens":
        mtp_logits = M.mtp_logits(params, cfg, out[2], batch)
        # depth-1 MTP predicts t+2: logits[:, t] vs tokens[:, t+2]
        mtp_ce = _xent(mtp_logits[:, :-2], toks[:, 2:]).mean()
        loss = loss + mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    loss = loss + aux_weight * aux
    metrics["aux"] = aux
    return loss, metrics


def _grads_of(params, cfg: M.ModelConfig, batch: dict):
    """(gradients of lm_loss as a tree like params, its metrics with
    "loss"), all detached. A leaf the loss does not reach gets zeros, as
    `jax.grad` gives it."""
    with torch.enable_grad():
        tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = lm_loss(tracked, cfg, batch)
        leaves = tree_leaves(tracked)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
    return tree_unflatten(params, grads), metrics


def _local_grads(params, cfg: M.ModelConfig, batch: dict, microbatches: int, rows):
    """The gradients and metrics of this rank's rows, before any
    collective: `rows(part)` is the rank's block of a microbatch. With
    microbatches > 1 the batch splits into that many consecutive groups
    along its first axis, and the gradients (in float32) and metrics are
    averaged over them, as JAX's `lax.scan` accumulates them. With one,
    each gradient keeps its parameter's dtype."""
    if microbatches == 1:
        return _grads_of(params, cfg, {k: rows(v) for k, v in batch.items()})
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
    parts = {k: torch.chunk(v, microbatches, dim=0) for k, v in batch.items()}
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    m_acc = None
    for i in range(microbatches):
        g, m = _grads_of(params, cfg, {k: rows(v[i]) for k, v in parts.items()})
        g_acc = tree_map(lambda a, x: a + x.to(torch.float32), g_acc, g)
        m_acc = m if m_acc is None else {k: m_acc[k] + v for k, v in m.items()}
    return (tree_map(lambda g: g / microbatches, g_acc),
            {k: v / microbatches for k, v in m_acc.items()})


def _split_of(batch_records) -> Optional[dsh.Sharding]:
    """The record of the batch's rows when they are split over more than
    one rank, else None (one rank, or a batch the mesh does not divide)."""
    recs = tree_leaves(batch_records)
    entries = {r.spec[0] if r.spec else None for r in recs}
    if len(entries) != 1:
        raise ValueError(f"the batch's leaves split their rows differently: {entries}")
    rec = recs[0]
    entry = rec.spec[0] if rec.spec else None
    if entry is None or dist._axis_size(rec.mesh, entry) == 1:
        return None
    return rec


def grads_and_metrics(params, cfg: M.ModelConfig, batch: dict, microbatches: int = 1,
                      batch_records=None):
    """The step's gradients and metrics of the global `batch`, before
    clipping. On one device (no mesh context) they are this process's.
    Under a context, `batch_records` (by default `batch_shardings(batch)`)
    say how the rows lie: split over W ranks, each rank computes its block
    of each microbatch and the gradients and metrics are all-reduced to
    the global means in their own dtype; not split on a mesh of more than
    one rank, every rank computes the whole batch and takes rank 0's."""
    ctx = dist.current_context()
    if batch_records is None and ctx is not None:
        batch_records = dsh.batch_shardings(batch)
    mesh = tree_leaves(batch_records)[0].mesh if batch_records is not None else None
    if mesh is None or mesh.size == 1:
        return _local_grads(params, cfg, batch, microbatches, lambda v: v)
    dist.executed_axis(mesh)
    rec = _split_of(batch_records)
    if rec is None:
        grads, metrics = _local_grads(params, cfg, batch, microbatches, lambda v: v)
        return (tree_map(lambda g: dist.agree(mesh, g), grads),
                {k: dist.agree(mesh, v) for k, v in metrics.items()})

    def rows(v):
        if v.shape[0] % mesh.size:
            raise ValueError(f"a microbatch of {v.shape[0]} rows does not split over "
                             f"{mesh.size} ranks")
        return dsh.block(v, rec)

    with dist.data_parallel(mesh):
        grads, metrics = _local_grads(params, cfg, batch, microbatches, rows)
    # the rank's own gradients are summed in place, so no second copy is held
    # (`contiguous` copies only a gradient autograd handed back expanded)
    return (tree_map(lambda g: dist.all_reduce_(mesh, g.contiguous()).div_(mesh.size), grads),
            {k: dist.all_reduce(mesh, v) / mesh.size for k, v in metrics.items()})


def zero1_update(grads, opt_state: AdamWState, params, moment_records, lr):
    """AdamW a block a rank: each rank updates its blocks of m, v and the
    parameters (AdamW is elementwise, so the blocks are the replicated
    update's), then the parameters are gathered back (`gather_leaf`)."""
    g_blk = dsh.place(grads, moment_records)
    p_blk = dsh.place(params, moment_records)
    new_blk, new_opt = adamw_update(g_blk, opt_state, p_blk, lr=lr)
    new_params = tree_map(dsh.gather_leaf, new_blk, moment_records)
    return new_params, new_opt


def make_train_step(cfg: M.ModelConfig, *, microbatches: int = 1,
                    learning_rate=1e-3, max_grad_norm: float = 1.0,
                    remat: bool = True, lr_schedule: Optional[Callable] = None,
                    grad_shardings=None):
    """Build step_fn(params, opt_state, batch, shardings=None) ->
    (params, opt_state, metrics).

    Gradient accumulation over `microbatches` groups, clipping to
    `max_grad_norm` (the global gradient's norm), then AdamW at
    `lr_schedule(opt_state.count)` (or the constant `learning_rate`). The
    metrics are device tensors: "loss", "ce", "aux", "grad_norm", and
    "mtp_ce" where MTP applies. `remat` is JAX's argument, unused there as
    here (remat lives in `cfg.remat`). `grad_shardings` is a record tree
    like params: each rank keeps the block its record gives. `shardings`
    = (p_sh, o_sh, b_sh) says how the operands lie (see the module)."""
    if grad_shardings is not None:
        dsh.check_executable(grad_shardings, "grad_shardings")

    def step_fn(params, opt_state: AdamWState, batch: dict, shardings=None):
        p_sh, o_sh, b_sh = shardings if shardings is not None else (None, None, None)
        if p_sh is not None:
            dsh.check_executable(p_sh, "the parameters' records")
        params, opt_state = dsh.place(params, p_sh), dsh.place(opt_state, o_sh)
        grads, metrics = grads_and_metrics(params, cfg, batch, microbatches, b_sh)
        grads = dsh.place(grads, grad_shardings)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_schedule(opt_state.count) if lr_schedule else learning_rate
        if o_sh is not None:
            new_params, new_opt = zero1_update(grads, opt_state, params, o_sh.m, lr)
        else:
            new_params, new_opt = adamw_update(grads, opt_state, params, lr=lr)
        return new_params, new_opt, dict(metrics, grad_norm=gnorm)

    return step_fn
