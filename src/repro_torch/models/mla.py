"""Multi-head Latent Attention (DeepSeek-V2/V3). The port of
`repro/models/mla.py`.

The forward and prefill use the expanded form (per-head K/V decompressed
from the latent). Decode uses the ABSORBED form: W_uk is folded into the
query and W_uv applied after attending, so attention runs directly against
the compressed (c_kv, k_rope) cache, kv_lora_rank + rope_dim values a
token instead of 2 * H * head_dim.

The cache's `pos` is a Python int, as in `attention.KVCache`, and
`mla_decode_step` writes the new latent into the cache's tensors in place.
A position at or past the cache's length writes its last slot, as JAX's
`dynamic_update_slice` clamps it.

`mla_full` under a "model" axis (`rec`, the layer's records) runs on this
rank's heads: its blocks of `w_uq`, `w_uk`, `w_uv` and `wo`, the partial
outputs summed over the model view after `wo`. The latent projections
(`w_dq`, `w_dkv`, `w_kr` and their norms) stay replicated; their outputs
enter the head-split products through `tp.copy_to`, so their gradients
are whole on every rank.

`mla_prefill` and `mla_decode_step` take the layer's records and its
cache's (`cache_rec`, an MLACache of records): the heads split as in
`mla_full`, the latent cache whole under the default rules and split on
its sequence in the dry run's serving layouts, where the rank whose block
holds the new slot writes it and the absorbed decode attends over the
split sequence by `tp.attend_split` (flash decoding in latent space).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.dist import shardings as dsh
from repro_torch.dist import tp
from repro_torch.models.attention import _out_proj, sdpa_chunked
from repro_torch.models.layers import apply_rope, init_rms_norm, normal, rms_norm, rope_freqs


class MLAConfig(NamedTuple):
    n_heads: int = 128
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S, kv_lora_rank)
    k_rope: torch.Tensor  # (B, S, rope_dim) — shared across heads, roped
    pos: int              # number of tokens already written


def init_mla(generator: torch.Generator, d_model: int, cfg: MLAConfig, dtype: torch.dtype,
             device: torch.device) -> dict:
    H, r_q, r_kv = cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    s = d_model ** -0.5
    return {
        "w_dq": normal(generator, (d_model, r_q), dtype, device, s),
        "q_norm": init_rms_norm(r_q, dtype, device),
        "w_uq": normal(generator, (r_q, H, dn + dr), dtype, device, r_q ** -0.5),
        "w_dkv": normal(generator, (d_model, r_kv), dtype, device, s),
        "kv_norm": init_rms_norm(r_kv, dtype, device),
        "w_kr": normal(generator, (d_model, dr), dtype, device, s),
        "w_uk": normal(generator, (r_kv, H, dn), dtype, device, r_kv ** -0.5),
        "w_uv": normal(generator, (r_kv, H, dv), dtype, device, r_kv ** -0.5),
        "wo": normal(generator, (H, dv, d_model), dtype, device, (H * dv) ** -0.5),
    }


def mla_sharding(cfg: MLAConfig) -> dict:
    """The layer's logical parameter specs (`dist.shardings`)."""
    return {
        "w_dq": ("embed", None),
        "q_norm": {"scale": (None,)},
        "w_uq": ("latent", "heads", None),
        "w_dkv": ("embed", None),
        "kv_norm": {"scale": (None,)},
        "w_kr": ("embed", None),
        "w_uk": ("latent", "heads", None),
        "w_uv": ("latent", "heads", None),
        "wo": ("heads", None, "embed"),
    }


def _queries(params, x, cfg: MLAConfig, cos, sin, view=None):
    cq = tp.copy_to(view, rms_norm(x @ params["w_dq"], params["q_norm"]["scale"]))
    q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"])
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, cos, sin)


def _latents(params, x, cos, sin):
    c_kv = rms_norm(x @ params["w_dkv"], params["kv_norm"]["scale"])
    k_rope = apply_rope((x @ params["w_kr"])[:, :, None, :], cos, sin)[:, :, 0]
    return c_kv, k_rope


def mla_full(params: dict, x: torch.Tensor, cfg: MLAConfig, *, rope_theta: float,
             dense_max: int = 2048, rec=None) -> torch.Tensor:
    """Expanded-form causal attention (forward / prefill). The rope part is
    folded into an effective head dim so the shared chunked-SDPA core
    applies: q_eff = [q_nope ; q_rope], k_eff = [k_nope ; k_rope broadcast].
    With `heads` split over "model", on this rank's heads (module doc)."""
    B, S, _ = x.shape
    view = tp.model_view(tp.records(rec, "w_uq"), 1)
    H = params["w_uq"].shape[1]
    pos = torch.arange(S, device=x.device)
    cos, sin = rope_freqs(cfg.qk_rope_dim, rope_theta, pos)
    q_nope, q_rope = _queries(params, x, cfg, cos, sin, view)
    c_kv, k_rope = (tp.copy_to(view, t) for t in _latents(params, x, cos, sin))
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uv"])

    q_eff = torch.cat([q_nope, q_rope], dim=-1)
    k_eff = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, cfg.qk_rope_dim)],
                      dim=-1)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    if S > dense_max:
        out = sdpa_chunked(q_eff, k_eff, v, scale=scale)
    else:
        mask = (pos[None, :] <= pos[:, None])[None, None]
        scores = torch.einsum("bqhd,bkhd->bhqk", q_eff, k_eff).to(torch.float32) * scale
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return _out_proj(out, params["wo"], view)


def mla_prefill(params: dict, x: torch.Tensor, cfg: MLAConfig, *, rope_theta: float,
                cache_len: int, dense_max: int = 2048, rec=None,
                cache_rec=None) -> tuple[torch.Tensor, MLACache]:
    """`mla_full` and the latent cache: (c_kv, k_rope) of the S positions,
    zero-padded to `cache_len`; with records, on this rank's heads and the
    cache cut to its block."""
    S = x.shape[1]
    out = mla_full(params, x, cfg, rope_theta=rope_theta, dense_max=dense_max, rec=rec)
    cos, sin = rope_freqs(cfg.qk_rope_dim, rope_theta, torch.arange(S, device=x.device))
    c_kv, k_rope = _latents(params, x, cos, sin)
    pad = cache_len - S
    c_kv = torch.nn.functional.pad(c_kv, (0, 0, 0, pad))
    k_rope = torch.nn.functional.pad(k_rope, (0, 0, 0, pad))
    if cache_rec is not None:
        c_kv = dsh.cut_whole(c_kv, cache_rec.c_kv).clone()
        k_rope = dsh.cut_whole(k_rope, cache_rec.k_rope).clone()
    return out, MLACache(c_kv=c_kv, k_rope=k_rope, pos=S)


def mla_decode_step(params: dict, x: torch.Tensor, cache: MLACache, cfg: MLAConfig,
                    *, rope_theta: float, rec=None,
                    cache_rec=None) -> tuple[torch.Tensor, MLACache]:
    """Absorbed-form one-token decode, x (B,1,d), against the latent cache;
    with records, on this rank's heads against its block of the cache."""
    seq = dsh.dim_view(cache_rec.c_kv, 1) if cache_rec is not None else None
    view = tp.model_view(tp.records(rec, "w_uq"), 1)
    pos = cache.pos
    n_loc = cache.c_kv.shape[1]
    start = seq.rank * n_loc if seq is not None else 0
    n_slots = n_loc * (seq.size if seq is not None else 1)
    dev = x.device
    positions = torch.arange(pos, pos + 1, device=dev)   # made on the device: no host copy
    cos, sin = rope_freqs(cfg.qk_rope_dim, rope_theta, positions)
    q_nope, q_rope = _queries(params, x, cfg, cos, sin)       # (B,1,H,*)
    c_new, kr_new = _latents(params, x, cos, sin)             # (B,1,r), (B,1,dr)
    slot = min(pos, n_slots - 1) - start
    if 0 <= slot < n_loc:
        cache.c_kv[:, slot:slot + 1] = c_new.to(cache.c_kv.dtype)
        cache.k_rope[:, slot:slot + 1] = kr_new.to(cache.k_rope.dtype)

    # absorb W_uk into q: q_abs (B,1,H,r) = q_nope @ W_uk^T per head
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, params["w_uk"])
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bqhr,bkr->bhqk", q_abs, cache.c_kv)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, cache.k_rope)).to(torch.float32) * scale
    valid = start + torch.arange(n_loc, device=dev) <= pos
    scores = scores.masked_fill(~valid[None, None, None, :], -1e30)
    # attend in latent space, then absorb W_uv on the way out
    lat = tp.attend_split(scores, cache.c_kv.to(x.dtype), seq)
    out = torch.einsum("bqhr,rhd->bqhd", lat, params["w_uv"])
    return (_out_proj(out, params["wo"], view),
            MLACache(c_kv=cache.c_kv, k_rope=cache.k_rope, pos=pos + 1))
