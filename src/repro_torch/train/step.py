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
global batch over the D ranks of the "data" view, each rank computes on
its block of each microbatch's rows, and the gradients and metrics are
all-reduced over that view to the global means in their own dtype (the
MoE's load-balance fractions sum over it inside the forward,
`dist.data_parallel`). A batch that D does not divide is computed whole on
every rank, and data rank 0's gradients are handed to all (nothing counted
twice). The step takes the global batch, as JAX's does.

`shardings=(p_sh, o_sh, b_sh)` (from `dist.shardings.run_sharded`, JAX's
`in_shardings`) names how the operands lie, and the step runs on each
rank's blocks: a layer's FSDP blocks (records over "data") are gathered
inside it (`dist.fsdp`), its "model" blocks run tensor-parallel
(`dist.tp`), the loss takes the vocab-split path when the logits are a
block of the vocabulary, and a model-split leaf's gradient is never summed
over "model". An FSDP leaf's gradient comes out of the gather's backward
summed over the data ranks; the others are all-reduced over the data view.
The clip's norm counts each global element once (`clip_by_global_norm`
with records). Moments placed by `dist.zero.zero1_shardings` are updated a
block a rank, and the parameters are gathered back to their records'
layout. JAX's `grad_shardings` (the layout each rank keeps of the
gradients) is honoured as blocks."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import dist
from repro_torch.dist import fsdp
from repro_torch.dist import shardings as dsh
from repro_torch.dist import tp
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWState, adamw_update, clip_by_global_norm
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


def _xent(logits: torch.Tensor, targets: torch.Tensor, z_loss: float = 1e-4,
          vocab: Optional[dist.Mesh] = None):
    """Stable CE + z-loss. logits (..., V) float32, targets (...) integer;
    logits of this rank's block of a vocabulary split over `vocab` (a
    "model" view) take `tp.vocab_xent`."""
    if vocab is not None:
        return tp.vocab_xent(logits, targets, z_loss, vocab)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    ce = lse - gold
    return ce + z_loss * torch.square(lse)


def lm_loss(params, cfg: M.ModelConfig, batch: dict, aux_weight: float = 0.01,
            mtp_weight: float = 0.3, records=None):
    """Next-token loss across front ends; adds the MoE aux loss and
    DeepSeek-V3's MTP loss. -> (loss, {"ce", "aux"[, "mtp_ce"]}). With
    `records`, params are this rank's blocks (`M.forward`)."""
    need_hidden = cfg.mtp_depth > 0
    out = M.forward(params, cfg, batch, return_hidden=need_hidden, records=records)
    logits, aux = out[0], out[1]
    toks = batch["tokens"]
    vocab = tp.model_view(tp.records(tp.records(records, "embed"), "table"), 0)

    if cfg.frontend == "patches":          # predict text tokens only
        logits = logits[:, cfg.vision_tokens:]
    # codebooks: (B,S,K,V) against (B,S,K); tokens: (B,S,V) against (B,S)
    loss = _xent(logits[:, :-1], toks[:, 1:], vocab=vocab).mean()

    metrics = {"ce": loss}
    if cfg.mtp_depth > 0 and cfg.frontend == "tokens":
        mtp_logits = M.mtp_logits(params, cfg, out[2], batch, records)
        # depth-1 MTP predicts t+2: logits[:, t] vs tokens[:, t+2]
        mtp_ce = _xent(mtp_logits[:, :-2], toks[:, 2:], vocab=vocab).mean()
        loss = loss + mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    loss = loss + aux_weight * aux
    metrics["aux"] = aux
    return loss, metrics


def _grads_of(params, cfg: M.ModelConfig, batch: dict, records=None):
    """(gradients of lm_loss as a tree like params, its metrics with
    "loss"), all detached. A leaf the loss does not reach gets zeros, as
    `jax.grad` gives it."""
    with torch.enable_grad():
        tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = lm_loss(tracked, cfg, batch, records=records)
        leaves = tree_leaves(tracked)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
    return tree_unflatten(params, grads), metrics


def _local_grads(params, cfg: M.ModelConfig, batch: dict, microbatches: int, rows,
                 records=None):
    """The gradients and metrics of this rank's rows, before the data
    all-reduce: `rows(part)` is the rank's block of a microbatch. With
    microbatches > 1 the batch splits into that many consecutive groups
    along its first axis, and the gradients (in float32) and metrics are
    averaged over them, as JAX's `lax.scan` accumulates them. With one,
    each gradient keeps its parameter's dtype."""
    if microbatches == 1:
        return _grads_of(params, cfg, {k: rows(v) for k, v in batch.items()}, records)
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
    parts = {k: torch.chunk(v, microbatches, dim=0) for k, v in batch.items()}
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    m_acc = None
    for i in range(microbatches):
        g, m = _grads_of(params, cfg, {k: rows(v[i]) for k, v in parts.items()}, records)
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


def _data_view(mesh: dist.Mesh, rec: Optional[dsh.Sharding]) -> dist.Mesh:
    """The view the batch's rows are split over (`rec`), or, for a batch not
    split, the one axis besides "model" whose ranks compute it alike."""
    if rec is not None:
        if not isinstance(rec.spec[0], str):
            raise NotImplementedError(f"the batch's rows split over the axes {rec.spec[0]}")
        return mesh.view(rec.spec[0])
    others = [a for a in dist.split_axes(mesh) if a != tp.AXIS]
    if len(others) > 1:
        raise NotImplementedError(f"a batch not split, on a mesh of shape {mesh.shape}")
    return mesh.view(others[0]) if others else dist.Mesh(device=mesh.device)


def grads_and_metrics(params, cfg: M.ModelConfig, batch: dict, microbatches: int = 1,
                      batch_records=None, param_records=None):
    """The step's gradients and metrics of the global `batch`, before
    clipping. On one device (no mesh context) they are this process's.
    Under a context, `batch_records` (by default `batch_shardings(batch)`)
    say how the rows lie: split over the D ranks of the "data" view, each
    rank computes its block of each microbatch and the gradients and
    metrics are all-reduced over that view to the global means in their
    own dtype; not split, every rank computes the whole batch and takes
    data rank 0's. `param_records` (None: params whole) say how params lie
    as this rank's blocks (the module doc); the gradients lie alike."""
    ctx = dist.current_context()
    if batch_records is None and ctx is not None:
        batch_records = dsh.batch_shardings(batch)
    mesh = tree_leaves(batch_records)[0].mesh if batch_records is not None else None
    if mesh is None or mesh.size == 1:
        return _local_grads(params, cfg, batch, microbatches, lambda v: v, param_records)
    rec = _split_of(batch_records)
    dmesh = _data_view(mesh, rec)
    n = dmesh.size
    reduced = ([fsdp.reduced(r) for r in tree_leaves(param_records)] if param_records
               is not None else [False] * len(tree_leaves(params)))
    if rec is None:
        grads, metrics = _local_grads(params, cfg, batch, microbatches, lambda v: v,
                                      param_records)
        out = [g.div_(n) if red else dist.agree(dmesh, g)
               for g, red in zip(tree_leaves(grads), reduced)]
        return (tree_unflatten(grads, out),
                {k: dist.agree(dmesh, v) for k, v in metrics.items()})

    def rows(v):
        if v.shape[0] % n:
            raise ValueError(f"a microbatch of {v.shape[0]} rows does not split over "
                             f"{n} ranks")
        return dsh.block(v, rec)

    with dist.data_parallel(dmesh):
        grads, metrics = _local_grads(params, cfg, batch, microbatches, rows, param_records)
    # the rank's own gradients are summed in place, so no second copy is held
    # (`contiguous` copies only a gradient autograd handed back expanded);
    # an FSDP leaf's was summed over the data ranks by the gather's backward
    out = [(g if red else dist.all_reduce_(dmesh, g.contiguous())).div_(n)
           for g, red in zip(tree_leaves(grads), reduced)]
    return (tree_unflatten(grads, out),
            {k: dist.all_reduce(dmesh, v) / n for k, v in metrics.items()})


def zero1_update(grads, opt_state: AdamWState, params, moment_records, lr,
                 param_records=None, grad_records=None, donate: bool = False):
    """AdamW a block a rank: each rank updates its blocks of m, v and the
    parameters (AdamW is elementwise, so the blocks are the replicated
    update's), then the parameters are gathered back over the axes the
    moments split and the parameters do not (`gather_leaf`). params are
    blocks by `param_records` (global when None), grads by `grad_records`
    (by default the parameters' layout). `donate`: as `adamw_update`'s."""
    g_rec = param_records if grad_records is None else grad_records
    g_blk = dsh.reblock(grads, g_rec, moment_records)
    p_blk = dsh.reblock(params, param_records, moment_records)
    new_blk, new_opt = adamw_update(g_blk, opt_state, p_blk, lr=lr, donate=donate)
    if param_records is None:
        return tree_map(dsh.gather_leaf, new_blk, moment_records), new_opt
    return tree_map(dsh.gather_leaf, new_blk, moment_records, param_records), new_opt


def make_train_step(cfg: M.ModelConfig, *, microbatches: int = 1,
                    learning_rate=1e-3, max_grad_norm: float = 1.0,
                    remat: bool = True, lr_schedule: Optional[Callable] = None,
                    grad_shardings=None):
    """Build step_fn(params, opt_state, batch, shardings=None, donate=False)
    -> (params, opt_state, metrics).

    Gradient accumulation over `microbatches` groups, clipping to
    `max_grad_norm` (the global gradient's norm), then AdamW at
    `lr_schedule(opt_state.count)` (or the constant `learning_rate`). The
    metrics are device tensors: "loss", "ce", "aux", "grad_norm", and
    "mtp_ce" where MTP applies. `remat` is JAX's argument, unused there as
    here (remat lives in `cfg.remat`). `grad_shardings` is a record tree
    like params: each rank keeps the block its record gives. `shardings`
    = (p_sh, o_sh, b_sh) says how the operands lie (see the module);
    `donate` lets the update overwrite the parameters and moments it is
    handed (`adamw_update`), as `donate_argnums=(0, 1)` lets JAX's."""

    def step_fn(params, opt_state: AdamWState, batch: dict, shardings=None,
                donate: bool = False):
        p_sh, o_sh, b_sh = shardings if shardings is not None else (None, None, None)
        params, opt_state = dsh.place(params, p_sh), dsh.place(opt_state, o_sh)
        grads, metrics = grads_and_metrics(params, cfg, batch, microbatches, b_sh, p_sh)
        g_sh = p_sh
        if grad_shardings is not None:
            grads, g_sh = dsh.reblock(grads, p_sh, grad_shardings), grad_shardings
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, records=g_sh)
        lr = lr_schedule(opt_state.count) if lr_schedule else learning_rate
        if o_sh is not None:
            new_params, new_opt = zero1_update(grads, opt_state, params, o_sh.m, lr,
                                               p_sh, g_sh, donate)
        else:
            if g_sh is not p_sh:
                grads = dsh.reblock(grads, g_sh, p_sh)
            new_params, new_opt = adamw_update(grads, opt_state, params, lr=lr,
                                               donate=donate)
        return new_params, new_opt, dict(metrics, grad_norm=gnorm)

    return step_fn
