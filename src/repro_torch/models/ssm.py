"""Mamba-2 SSD (state-space duality) block: the chunked form (quadratic
within a chunk, recurrent across chunks) for the forward and prefill, and
the O(1)-state recurrence for decode. The port of `repro/models/ssm.py`.

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;   y_t = C_t h_t + D x_t

Used by mamba2-130m and, as the SSM half, jamba (whose Mamba-1 layers JAX
realizes in the SSD form). State math is float32 throughout. JAX's
`lax.scan` over chunks is a Python loop carrying h. `ssm_decode_step`
returns a new cache (the state is O(1) in the sequence), where the
attention caches are written in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_rms_norm, normal, rms_norm


class SSMConfig(NamedTuple):
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_channels) trailing inputs
    h: torch.Tensor      # (B, H, d_state, head_dim) float32 SSM state


def _dims(d_model: int, cfg: SSMConfig):
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    conv_ch = d_inner + 2 * cfg.n_groups * cfg.d_state
    return d_inner, n_heads, conv_ch


def init_ssm(generator: torch.Generator, d_model: int, cfg: SSMConfig, dtype: torch.dtype,
             device: torch.device) -> dict:
    d_inner, H, conv_ch = _dims(d_model, cfg)
    d_in_proj = 2 * d_inner + 2 * cfg.n_groups * cfg.d_state + H
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=device))
    return {
        "w_in": normal(generator, (d_model, d_in_proj), dtype, device, d_model ** -0.5),
        "conv_w": normal(generator, (cfg.d_conv, conv_ch), dtype, device, 0.1),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((H,), dtype=dtype, device=device),
        "a_log": a_log.to(dtype),
        "d_skip": torch.ones((H,), dtype=dtype, device=device),
        "norm": init_rms_norm(d_inner, dtype, device),
        "w_out": normal(generator, (d_inner, d_model), dtype, device, d_inner ** -0.5),
    }


def ssm_sharding(cfg: SSMConfig) -> dict:
    """The layer's logical parameter specs (`dist.shardings`)."""
    return {
        "w_in": ("embed", "ssm_inner"),
        "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "dt_bias": (None,),
        "a_log": (None,),
        "d_skip": (None,),
        "norm": {"scale": ("ssm_inner",)},
        "w_out": ("ssm_inner", "embed"),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as JAX computes it (`logaddexp(x, 0)`):
    max(x, 0) + log1p(exp(-|x|)), at every x. torch's `F.softplus` returns
    x itself above its threshold (20), where JAX adds log1p(exp(-x))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _split_in_proj(params, x, d_model, cfg: SSMConfig):
    d_inner, H, conv_ch = _dims(d_model, cfg)
    zxbcdt = x @ params["w_in"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: d_inner + conv_ch]
    dt = zxbcdt[..., d_inner + conv_ch:]
    return z, xbc, dt


def _causal_conv(params, xbc, cfg: SSMConfig):
    """Depthwise causal conv over (B,S,C) with kernel (d_conv, C)."""
    dc, S = cfg.d_conv, xbc.shape[1]
    pads = F.pad(xbc, (0, 0, dc - 1, 0))
    out = sum(pads[:, i: i + S, :] * params["conv_w"][i] for i in range(dc))
    return F.silu(out + params["conv_b"])


def _ssd_scan(xh, a, dtv, Bm, Cm, cfg: SSMConfig):
    """Chunked SSD: a loop over chunks whose body holds the (Q,Q) quadratic
    intra-chunk form, the chunk-state contraction and the inter-chunk
    carry, so live memory is one chunk's tile whatever S is.

    xh (B,S,H,P); a = dt*A (B,S,H) log-decay <= 0; dtv (B,S,H);
    Bm/Cm (B,S,H,ds). Returns y (B,S,H,P) float32, final h (B,H,ds,P)
    float32. Raises ValueError unless Q = min(chunk, S) divides S.

    Every exp takes its argument clipped to [-60, 0] first: the masked
    upper triangle has L_i - L_j > 0, whose exp may be inf, and inf times
    the mask's 0 would be NaN."""
    Bsz, S, H, P = xh.shape
    ds = Bm.shape[-1]
    Q = min(cfg.chunk, S)
    if S % Q:
        raise ValueError(f"_ssd_scan: the chunk {Q} does not divide the sequence {S}")
    f32 = torch.float32
    xh, a, dtv, Bm, Cm = (t.to(f32) for t in (xh, a, dtv, Bm, Cm))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))

    h = torch.zeros((Bsz, H, ds, P), dtype=f32, device=xh.device)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        x_c, a_c, dt_c, B_c, C_c = xh[:, sl], a[:, sl], dtv[:, sl], Bm[:, sl], Cm[:, sl]
        L = torch.cumsum(a_c, dim=1)                                  # (B,Q,H)
        # intra-chunk: M_ij = (C_i.B_j) exp(L_i - L_j) dt_j  (i >= j)
        scores = torch.einsum("bqhd,bkhd->bhqk", C_c, B_c)
        decay = torch.exp(torch.clamp(L[:, :, None, :] - L[:, None, :, :], -60, 0))
        M = scores * decay.permute(0, 3, 1, 2) * dt_c.permute(0, 2, 1)[:, :, None, :]
        M = torch.where(mask, M, 0.0)
        y_intra = torch.einsum("bhqk,bkhp->bqhp", M, x_c)
        # inter-chunk: y_i += C_i exp(L_i) . h_prev
        y_inter = torch.einsum("bqhd,bhdp->bqhp",
                               C_c * torch.exp(torch.clamp(L, -60, 0))[..., None], h)
        # state update: h = exp(sum a) h + sum_j exp(Lend - L_j) dt_j B_j (x) x_j
        w = torch.exp(torch.clamp(L[:, -1:, :] - L, -60, 0)) * dt_c
        S_c = torch.einsum("bqh,bqhd,bqhp->bhdp", w, B_c, x_c)
        h = torch.exp(torch.clamp(a_c.sum(dim=1), -60, 0))[:, :, None, None] * h + S_c
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def _heads(xbc_c, d_inner, H, cfg: SSMConfig):
    """The conv output split into x (..., d_inner) and B, C repeated over
    each group's heads (..., H, d_state)."""
    gds = cfg.n_groups * cfg.d_state
    lead = xbc_c.shape[:-1]
    rep = H // cfg.n_groups
    Bm = xbc_c[..., d_inner: d_inner + gds].reshape(*lead, cfg.n_groups, cfg.d_state)
    Cm = xbc_c[..., d_inner + gds:].reshape(*lead, cfg.n_groups, cfg.d_state)
    return (xbc_c[..., :d_inner], torch.repeat_interleave(Bm, rep, dim=-2),
            torch.repeat_interleave(Cm, rep, dim=-2))


def _dt(params, dt):
    """dt (.., H) -> (softplus(dt + dt_bias), A = -exp(a_log)), float32."""
    f32 = torch.float32
    dtv = softplus(dt.to(f32) + params["dt_bias"].to(f32))
    return dtv, -torch.exp(params["a_log"].to(f32))


def _out(params, y, z, x_dtype):
    """The gated, normed output projection of y (B,S,d_inner) float32."""
    y = rms_norm(y.to(x_dtype) * F.silu(z), params["norm"]["scale"])
    return y @ params["w_out"]


def ssm_forward(params: dict, x: torch.Tensor, d_model: int, cfg: SSMConfig,
                return_cache: bool = False):
    """Full-sequence Mamba-2 block (forward / prefill); with `return_cache`
    also the decode cache: the last d_conv - 1 pre-conv inputs (zero-padded
    in front when S is shorter) and the final state."""
    Bsz, S, _ = x.shape
    d_inner, H, conv_ch = _dims(d_model, cfg)
    z, xbc, dt = _split_in_proj(params, x, d_model, cfg)
    xc, Bm, Cm = _heads(_causal_conv(params, xbc, cfg), d_inner, H, cfg)
    dtv, A = _dt(params, dt)
    xh = xc.reshape(Bsz, S, H, cfg.head_dim)
    y, h_final = _ssd_scan(xh, dtv * A, dtv, Bm, Cm, cfg)
    y = y + params["d_skip"].to(torch.float32)[None, None, :, None] * xh.to(torch.float32)
    out = _out(params, y.reshape(Bsz, S, d_inner), z, x.dtype)
    if not return_cache:
        return out
    tail = cfg.d_conv - 1
    conv_tail = xbc[:, S - tail:, :].clone() if S >= tail else F.pad(xbc, (0, 0, tail - S, 0))
    return out, SSMCache(conv=conv_tail, h=h_final)


def ssm_decode_step(params: dict, x: torch.Tensor, cache: SSMCache, d_model: int,
                    cfg: SSMConfig):
    """One-token recurrent step. x (B,1,d) -> (out (B,1,d), new cache)."""
    Bsz = x.shape[0]
    d_inner, H, conv_ch = _dims(d_model, cfg)
    z, xbc, dt = _split_in_proj(params, x, d_model, cfg)           # (B,1,*)
    window = torch.cat([cache.conv, xbc], dim=1)                   # (B,d_conv,C)
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"]) + params["conv_b"]
    xc, Bm, Cm = _heads(F.silu(conv_out), d_inner, H, cfg)  # (B,*), (B,H,ds)
    dtv, A = _dt(params, dt[:, 0])                                 # (B,H)
    xh = xc.reshape(Bsz, H, cfg.head_dim).to(torch.float32)
    Bm, Cm = Bm.to(torch.float32), Cm.to(torch.float32)
    h = torch.exp(dtv * A)[:, :, None, None] * cache.h + torch.einsum(
        "bh,bhd,bhp->bhdp", dtv, Bm, xh)
    y = torch.einsum("bhd,bhdp->bhp", Cm, h)
    y = y + params["d_skip"].to(torch.float32)[None, :, None] * xh
    out = _out(params, y.reshape(Bsz, 1, d_inner), z, x.dtype)
    return out, SSMCache(conv=torch.cat([cache.conv[:, 1:], xbc], dim=1), h=h)
