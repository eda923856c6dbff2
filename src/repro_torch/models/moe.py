"""Mixture-of-Experts: top-k router and capacity-bounded scatter dispatch.
The port of `repro/models/moe.py`.

Dispatch is scatter/gather-based (no (B,S,E,C) one-hot products): tokens
are scatter-added into a (B, E, C, d) capacity buffer, the expert SwiGLUs
run as one product batched over E, and the results gather back with their
routing weights. A token's rank within its expert comes from a stable sort
and the start of its run, O(B*S*K) memory; a one-hot cumsum would hold
S*K*E integers (8.6 TB at deepseek-v3 prefill scale). A token ranked at or
past the capacity C is dropped: it adds an exact zero to slot C-1 and
takes no weight at the combine, as in JAX.

Under a data mesh (`dist.data_parallel`) the load-balance fractions are
means over the global batch, summed over the data ranks; capacity and
drops are per batch row, so they do not depend on the split.

Under a "model" axis (`rec`, the layer's records; `dist.tp`) the tokens
are the same on every rank of the model view, so routing, capacity and
`keep` are computed whole on every rank, and no all-to-all is needed.
With `experts` split, each rank runs its experts' slots of the capacity
buffer; with `expert_ffn` split (mixtral's rules), each rank runs its
columns of every expert's W_g and W_u and rows of W_d. Either way each
rank's output is a partial sum, and one all-reduce of y over the model
view follows: for bf16 the experts' outputs come out of their GEMMs in
float32 (`tp.wide_matmul`), the partial y is combined and summed in
float32 and rounded once. The dispatched tokens and the combine weights
enter through `tp.copy_to`, so the router's and the input's gradients
are whole on every rank. The shared expert is a dense MLP
(`layers.apply_mlp`).

Router: float32 softmax top-k, the chosen probabilities renormalized over
the k experts; it returns the Switch-style load-balance aux loss beside
the output. (DeepSeek-V3's sigmoid, bias-free router is approximated by
this softmax router, as in JAX.)
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import dist
from repro_torch.dist import tp
from repro_torch.models.layers import apply_mlp, init_mlp, normal


class MoEConfig(NamedTuple):
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 14336
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype, device: torch.device) -> dict:
    E, f = cfg.n_experts, cfg.d_ff_expert
    s_in, s_out = d_model ** -0.5, f ** -0.5
    p = {
        "router": normal(generator, (d_model, E), torch.float32, device, s_in),
        "w_gate": normal(generator, (E, d_model, f), dtype, device, s_in),
        "w_up": normal(generator, (E, d_model, f), dtype, device, s_in),
        "w_down": normal(generator, (E, f, d_model), dtype, device, s_out),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(generator, d_model, cfg.d_ff_shared * cfg.n_shared, dtype,
                               device)
    return p


def moe_sharding(cfg: MoEConfig) -> dict:
    """The layer's logical parameter specs (`dist.shardings`)."""
    s = {
        "router": ("embed", None),
        "w_gate": ("experts", "expert_fsdp", "expert_ffn"),
        "w_up": ("experts", "expert_fsdp", "expert_ffn"),
        "w_down": ("experts", "expert_ffn", "expert_fsdp"),
    }
    if cfg.n_shared:
        s["shared"] = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                       "w_down": ("mlp", "embed")}
    return s


def _capacity(S: int, cfg: MoEConfig) -> int:
    c = math.ceil(cfg.top_k * S * cfg.capacity_factor / cfg.n_experts)
    return max(8, min(c, cfg.top_k * S))  # floor for tiny decode steps


def route(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """The float32 router: (probs (B,S,E), top_p (B,S,K) renormalized,
    top_e (B,S,K) the chosen experts)."""
    probs = torch.softmax(x.to(torch.float32) @ params["router"], dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def ranks(e_flat: torch.Tensor) -> torch.Tensor:
    """Each (B, S*K) choice's position within its expert, in token order:
    a stable sort by expert, then the distance to the start of its run."""
    B, n = e_flat.shape
    order = torch.argsort(e_flat, dim=1, stable=True)
    sorted_e = torch.gather(e_flat, 1, order)
    idx = torch.arange(n, device=e_flat.device).expand(B, n)
    starts = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=e_flat.device),
                        sorted_e[:, 1:] != sorted_e[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(starts, idx, 0), dim=1).values
    return torch.zeros_like(e_flat).scatter_(1, order, idx - run_start)


def apply_moe(params: dict, x: torch.Tensor, cfg: MoEConfig, rec=None):
    """x (B, S, d) -> (out (B, S, d), aux_loss float32 scalar); with
    `experts` or `expert_ffn` split over "model", on this rank's block
    (module doc)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(S, cfg)
    w_rec = tp.records(rec, "w_gate")
    e_view = tp.model_view(w_rec, 0)
    view = e_view or tp.model_view(w_rec, 2)

    probs, top_p, top_e = route(params, x, cfg)
    e_flat = top_e.reshape(B, S * K)
    rank = ranks(e_flat)
    keep = rank < C
    r_clip = torch.clamp(rank, max=C - 1)

    # dispatch: scatter-add the kept tokens into the capacity buffer, a
    # choice's slot being e * C + r in each row's (E * C, d) view
    slot = (e_flat * C + r_clip)[..., None].expand(B, S * K, d)
    xd = tp.copy_to(view, x)
    x_flat = xd[:, :, None, :].expand(B, S, K, d).reshape(B, S * K, d)
    buf = torch.zeros((B, E * C, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, slot, x_flat * keep[..., None].to(x.dtype))
    buf = buf.view(B, E, C, d)
    e_loc = params["w_gate"].shape[0]
    e0 = e_view.rank * e_loc if e_view is not None else 0
    if e_view is not None:
        buf = buf[:, e0:e0 + e_loc]

    # expert SwiGLU, batched over this rank's experts
    h = F.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, params["w_up"])
    if view is None:
        out_buf = torch.einsum("becf,efd->becd", h, params["w_down"])
    else:                       # this rank's partial outputs, float32 for bf16
        out_buf = tp.wide_matmul(h.transpose(0, 1).reshape(e_loc, B * C, h.shape[-1]),
                                 params["w_down"]).view(e_loc, B, C, d).transpose(0, 1)
        if e_view is not None:  # the other ranks' experts add nothing here
            out_buf = F.pad(out_buf, (0, 0, 0, 0, e0, E - e0 - e_loc))

    # combine: gather back with the routing weights of the kept choices
    gathered = torch.gather(out_buf.reshape(B, E * C, d), 1, slot)  # (B,SK,d)
    w_flat = tp.copy_to(view, (top_p.reshape(B, S * K) * keep).to(out_buf.dtype))
    y = (gathered * w_flat[..., None]).reshape(B, S, K, d).sum(dim=2)
    y = tp.reduce_from(view, y).to(x.dtype)

    if cfg.n_shared:
        y = y + apply_mlp(params["shared"], x, tp.records(rec, "shared"))

    # load-balance aux (Switch/GShard style); the first choices counted by a
    # scatter-add, since `F.one_hot` checks its input's range on the host.
    # Both fractions are over the global batch: with its rows split over
    # ranks (`dist.data_parallel`), the counts and the probabilities are
    # summed over them, the latter differentiably
    first = top_e[..., 0].reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, first, torch.ones_like(first, dtype=torch.float32))
    mesh = dist.data_parallel_mesh()
    if mesh is None:
        frac_tokens = counts / first.numel()
        frac_probs = probs.mean(dim=(0, 1))
    else:
        n = first.numel() * mesh.size
        frac_tokens = dist.all_reduce(mesh, counts) / n
        frac_probs = dist.sum_over_ranks(mesh, probs.sum(dim=(0, 1))) / n
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux
