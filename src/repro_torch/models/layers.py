"""Base layers: RMSNorm, RoPE, SwiGLU MLP, embeddings. The port of
`repro/models/layers.py`, in its plain-function style: params are nested
dicts of tensors, `init_*` builds them from an explicit `torch.Generator`,
`apply_*` consumes them. JAX's sharding hints are identities on one card
and are left out.

Under a "model" axis (`dist.tp`), the functions that take `rec` (the
module's records, `dist.shardings`) run on this rank's block of each split
weight: the MLP column-split in `w_gate` / `w_up` and row-split in
`w_down`, the tied table split over the vocabulary (a masked lookup, a
head that returns this rank's block of the logits). `rec=None` is the
whole module on one rank."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import tp


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalised in float32 whatever x's dtype (float64 included), then
    cast back to x's dtype and scaled, as JAX's is."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * scale.to(dtype)


def init_rms_norm(d: int, dtype: torch.dtype, device: torch.device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def normal(generator: torch.Generator, shape, dtype: torch.dtype, device: torch.device,
           std: float) -> torch.Tensor:
    """Standard normal draws of `dtype` from `generator`, times `std` (the
    product rounded to `dtype`, as JAX's `normal(key, shape, dtype) * s`)."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device) * std


# ------------------------------------------------------------------ RoPE ---

def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., head_dim/2), float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** (exps / head_dim))
    ang = positions.to(torch.float32)[..., None] * inv     # (..., hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (S, hd/2) broadcast over batch and heads.
    Rotates the split halves of hd (not interleaved pairs), in float32."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------- SwiGLU ---

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype,
             device: torch.device) -> dict:
    s_in = d_model ** -0.5
    s_out = d_ff ** -0.5
    return {
        "w_gate": normal(generator, (d_model, d_ff), dtype, device, s_in),
        "w_up": normal(generator, (d_model, d_ff), dtype, device, s_in),
        "w_down": normal(generator, (d_ff, d_model), dtype, device, s_out),
    }


def mlp_sharding() -> dict:
    """The SwiGLU MLP's logical parameter specs (`dist.shardings`)."""
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def apply_mlp(params: dict, x: torch.Tensor, rec=None) -> torch.Tensor:
    """SwiGLU: silu(x W_g) * (x W_u) W_d; with `mlp` split over "model",
    this rank's columns of W_g and W_u and rows of W_d, and the partial
    outputs summed over the model view."""
    view = tp.model_view(tp.records(rec, "w_gate"), 1)
    x = tp.copy_to(view, x)
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return tp.reduce_product(view, h, params["w_down"])


# ------------------------------------------------------------ embeddings ---

def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   dtype: torch.dtype, device: torch.device) -> dict:
    return {"table": normal(generator, (vocab, d_model), dtype, device, d_model ** -0.5)}


def embed_tokens(params: dict, tokens: torch.Tensor, rec=None) -> torch.Tensor:
    """The table's rows of `tokens`; with `vocab` split over "model", a
    masked lookup in this rank's rows summed over the model view."""
    return tp.embed_lookup(params["table"], tokens,
                           tp.model_view(tp.records(rec, "table"), 0))


def logits_from_embedding(params: dict, x: torch.Tensor, rec=None) -> torch.Tensor:
    """Tied output head: x (..., d) @ table^T -> (..., vocab), float32
    logits; with `vocab` split over "model", this rank's block of the
    vocabulary (..., vocab / M)."""
    view = tp.model_view(tp.records(rec, "table"), 0)
    return tp.copy_to(view, x.to(torch.float32)) @ params["table"].to(torch.float32).T
