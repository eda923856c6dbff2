"""Training step: causal-LM loss (z-loss regularized), microbatched
gradient accumulation, clipping and AdamW. The port of
`repro/train/step.py`, with autograd in place of `jax.value_and_grad` and
a Python loop over microbatches in place of `lax.scan`.

Remat lives in the model (`cfg.remat`, `models/model.py::forward`), as in
JAX. A step makes no synchronizing CUDA call: its metrics stay device
tensors, so the caller's one read of the loss is the step's only wait.
JAX's `grad_shardings` (a sharding hint on each microbatch's gradients)
comes with the LM's `dist/` and is left out."""
from __future__ import annotations

from typing import Callable, Optional

import torch

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


def grads_and_metrics(params, cfg: M.ModelConfig, batch: dict, microbatches: int = 1):
    """The step's gradients and metrics before clipping: with microbatches
    > 1 the batch splits into that many consecutive groups along its first
    axis, and the gradients (in float32) and metrics are averaged over
    them, as JAX's `lax.scan` accumulates them. With one, each gradient
    keeps its parameter's dtype."""
    if microbatches == 1:
        return _grads_of(params, cfg, batch)
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
    parts = {k: torch.chunk(v, microbatches, dim=0) for k, v in batch.items()}
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    m_acc = None
    for i in range(microbatches):
        g, m = _grads_of(params, cfg, {k: v[i] for k, v in parts.items()})
        g_acc = tree_map(lambda a, x: a + x.to(torch.float32), g_acc, g)
        m_acc = m if m_acc is None else {k: m_acc[k] + v for k, v in m.items()}
    return (tree_map(lambda g: g / microbatches, g_acc),
            {k: v / microbatches for k, v in m_acc.items()})


def make_train_step(cfg: M.ModelConfig, *, microbatches: int = 1,
                    learning_rate=1e-3, max_grad_norm: float = 1.0,
                    lr_schedule: Optional[Callable] = None):
    """Build step_fn(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation over `microbatches` groups, clipping to
    `max_grad_norm`, then AdamW at `lr_schedule(opt_state.count)` (or the
    constant `learning_rate`). The metrics are device tensors: "loss",
    "ce", "aux", "grad_norm", and "mtp_ce" where MTP applies."""

    def step_fn(params, opt_state: AdamWState, batch: dict):
        grads, metrics = grads_and_metrics(params, cfg, batch, microbatches)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_schedule(opt_state.count) if lr_schedule else learning_rate
        new_params, new_opt = adamw_update(grads, opt_state, params, lr=lr)
        return new_params, new_opt, dict(metrics, grad_norm=gnorm)

    return step_fn
