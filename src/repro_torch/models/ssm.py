"""Mamba-2 SSD (state-space duality) block: the chunked form (quadratic
within a chunk, recurrent across chunks) for the forward and prefill, and
the O(1)-state recurrence for decode. The port of `repro/models/ssm.py`.

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;   y_t = C_t h_t + D x_t

Used by mamba2-130m and, as the SSM half, jamba (whose Mamba-1 layers JAX
realizes in the SSD form). State math is float32 throughout. JAX's
`lax.scan` over chunks is a Python loop carrying h. `ssm_decode_step`
returns a new cache (the state is O(1) in the sequence), where the
attention caches are written in place.

Under a "model" axis (`rec`, the layer's records; `cache_rec`, its cache's)
the rank runs its heads. JAX's records split `w_in`'s output dim, `conv_w`,
`conv_b` and the conv cache into contiguous blocks, which do not follow
the parts they pack (z, x, B, C, dt), so those leaves are made whole by
one packed gather a layer (`tp.gather_packed`), and the rank takes its
heads' z and x channels and dt, and B and C whole. `w_out`'s rows, the
norm's scale and the state `h` follow the heads (d_inner = H x head_dim):
the norm's statistic is all-reduced over the view (`tp.rms_norm_split`),
and `w_out`'s partial outputs are summed after it (`tp.reduce_product`). The
replicated per-head leaves (`dt_bias`, `a_log`, `d_skip`) enter through
`tp.copy_to` before the rank takes its heads, and so do the input and any
packed leaf whose record leaves it whole (a dim the view does not divide), so
every gradient is whole: B and C feed only the rank's heads, and their
partial gradients sum over the view. The conv cache's new tail is
computed whole (its pre-conv channels are one product) and cut back to
the rank's block. Where the view divides d_inner and not the heads
(mamba2-130m's 24 heads over 16 ranks), every rank runs every head, and
takes its block of the channels into the split norm and `w_out`'s rows;
the state is then whole on every rank, as its record leaves it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import shardings as dsh
from repro_torch.dist import tp
from repro_torch.models.layers import init_rms_norm, normal


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


def _heads(xbc_c, d_inner, H, cfg: SSMConfig, heads: slice):
    """The conv output split into x (..., d_inner) and B, C repeated over
    each group's heads, of which `heads` are kept (..., len(heads),
    d_state); x is those heads' d_inner channels."""
    gds = cfg.n_groups * cfg.d_state
    lead = xbc_c.shape[:-1]
    rep = H // cfg.n_groups
    Bm = xbc_c[..., d_inner: d_inner + gds].reshape(*lead, cfg.n_groups, cfg.d_state)
    Cm = xbc_c[..., d_inner + gds:].reshape(*lead, cfg.n_groups, cfg.d_state)
    Bm = torch.repeat_interleave(Bm, rep, dim=-2)[..., heads, :]
    Cm = torch.repeat_interleave(Cm, rep, dim=-2)[..., heads, :]
    return xbc_c[..., :d_inner], Bm, Cm


def _dt(params, dt):
    """dt (.., H) -> (softplus(dt + dt_bias), A = -exp(a_log)), float32."""
    f32 = torch.float32
    dtv = softplus(dt.to(f32) + params["dt_bias"].to(f32))
    return dtv, -torch.exp(params["a_log"].to(f32))


def _out(params, y, z, x_dtype, view=None, chans: Optional[slice] = None):
    """The gated, normed output projection of y (B,S,d_inner) float32 (this
    rank's channels under `view`, the partial outputs summed over it);
    `chans` narrows whole y and z to this rank's block first."""
    if chans is not None:
        y, z = y[..., chans], z[..., chans]
    y = tp.rms_norm_split(y.to(x_dtype) * F.silu(z), params["norm"]["scale"], view)
    return tp.reduce_product(view, y, params["w_out"])


class _Split(NamedTuple):
    """A layer's leaves for this rank's heads (`_local`)."""
    view: object          # the "model" view the heads split over
    heads: slice          # this rank's heads
    chans: slice          # their d_inner channels
    params: dict          # w_in / conv_w / conv_b whole, the per-head leaves local
    conv: Optional[torch.Tensor]   # the conv cache whole (decode)
    out_chans: Optional[slice] = None   # this rank's block of whole channels into w_out


def _local(params, rec, d_model, cfg: SSMConfig, conv=None, conv_rec=None) -> _Split:
    """Gather the packed leaves (`w_in`, `conv_w`, `conv_b` and the conv
    cache, each whole where its record splits it over "model") in one
    all-gather, and take this rank's heads of `dt_bias`, `a_log` and
    `d_skip` (through `tp.copy_to`). The heads split as `w_out`'s rows;
    where the view does not divide the heads, the rank keeps every head and
    `out_chans` is its block of the channels (the module doc)."""
    d_inner, H, _ = _dims(d_model, cfg)
    items = [(params["w_in"], tp.records(rec, "w_in"), 1),
             (params["conv_w"], tp.records(rec, "conv_w"), 1),
             (params["conv_b"], tp.records(rec, "conv_b"), 0)]
    if conv is not None:
        items.append((conv, conv_rec, 2))
    views = [tp.model_view(r, d) for _, r, d in items]
    split = [i for i, v in enumerate(views) if v is not None]
    view = tp.model_view(tp.records(rec, "w_out"), 0)
    # a leaf its record leaves whole feeds only this rank's part of the
    # layer, so its gradient sums over the view
    whole = [t if view is None or i in split or i == 3 else tp.copy_to(view, t)
             for i, (t, _, _) in enumerate(items)]
    if split:
        got = tp.gather_packed(views[split[0]], [items[i][0] for i in split],
                               [items[i][2] for i in split])
        for i, g in zip(split, got):
            whole[i] = g
    out = dict(params, w_in=whole[0], conv_w=whole[1], conv_b=whole[2])
    if view is None:
        return _Split(None, slice(0, H), slice(0, d_inner), out,
                      whole[3] if conv is not None else None)
    if H % view.size:
        for name in ("dt_bias", "a_log", "d_skip"):
            out[name] = tp.copy_to(view, params[name])
        n = d_inner // view.size
        return _Split(view, slice(0, H), slice(0, d_inner), out,
                      whole[3] if conv is not None else None,
                      slice(view.rank * n, (view.rank + 1) * n))
    hl = H // view.size
    heads = slice(view.rank * hl, (view.rank + 1) * hl)
    chans = slice(heads.start * cfg.head_dim, heads.stop * cfg.head_dim)
    for name in ("dt_bias", "a_log", "d_skip"):
        out[name] = tp.copy_to(view, params[name])[heads]
    return _Split(view, heads, chans, out, whole[3] if conv is not None else None)


def _cols(w, parts):
    """The columns `parts` (slices of the last dim) of w, side by side: a
    view of w when each part starts where the one before it stops (all of
    w when the heads are whole), else a copy."""
    if all(p.start == q.stop for q, p in zip(parts, parts[1:])):
        return w[..., parts[0].start: parts[-1].stop]
    return torch.cat([w[..., p] for p in parts], dim=-1)


def ssm_forward(params: dict, x: torch.Tensor, d_model: int, cfg: SSMConfig,
                return_cache: bool = False, rec=None, cache_rec=None):
    """Full-sequence Mamba-2 block (forward / prefill); with `return_cache`
    also the decode cache: the last d_conv - 1 pre-conv inputs (zero-padded
    in front when S is shorter) and the final state. With `rec`, on this
    rank's heads (module doc), the cache cut to its blocks by
    `cache_rec`."""
    Bsz, S, _ = x.shape
    d_inner, H, conv_ch = _dims(d_model, cfg)
    gds = cfg.n_groups * cfg.d_state
    sp = _local(params, rec, d_model, cfg)
    p, view, c, h = sp.params, sp.view, sp.chans, sp.heads
    hl, cl = h.stop - h.start, c.stop - c.start
    bc = slice(2 * d_inner, 2 * d_inner + 2 * gds)
    dt_cols = slice(d_inner + conv_ch + h.start, d_inner + conv_ch + h.stop)
    w = _cols(p["w_in"], [c, slice(d_inner + c.start, d_inner + c.stop), bc, dt_cols])
    zxbcdt = tp.copy_to(view, x) @ w
    z, xbc, dt = zxbcdt[..., :cl], zxbcdt[..., cl: 2 * cl + 2 * gds], zxbcdt[..., -hl:]
    mine = [c, slice(d_inner, conv_ch)]
    conv_p = {"conv_w": _cols(p["conv_w"], mine), "conv_b": _cols(p["conv_b"], mine)}
    xc, Bm, Cm = _heads(_causal_conv(conv_p, xbc, cfg), cl, H, cfg, h)
    dtv, A = _dt(p, dt)
    xh = xc.reshape(Bsz, S, hl, cfg.head_dim)
    y, h_final = _ssd_scan(xh, dtv * A, dtv, Bm, Cm, cfg)
    y = y + p["d_skip"].to(torch.float32)[None, None, :, None] * xh.to(torch.float32)
    out = _out(p, y.reshape(Bsz, S, cl), z, x.dtype, view, sp.out_chans)
    if not return_cache:
        return out
    tail = cfg.d_conv - 1
    if cl < d_inner:            # the tail's pre-conv channels, whole
        xbc = x[:, max(S - tail, 0):] @ p["w_in"][:, d_inner: d_inner + conv_ch]
    n = xbc.shape[1]
    conv_tail = xbc[:, n - tail:, :].clone() if n >= tail else F.pad(xbc, (0, 0, tail - n, 0))
    if hl < H and cache_rec is not None and tp.model_view(cache_rec.h, 1) is None:
        raise NotImplementedError("the SSM's heads split over \"model\" and its state's "
                                  "record does not split them")
    return out, SSMCache(conv=dsh.cut_whole(conv_tail, _field(cache_rec, "conv")), h=h_final)


def _field(cache_rec, name):
    return None if cache_rec is None else getattr(cache_rec, name)


def ssm_decode_step(params: dict, x: torch.Tensor, cache: SSMCache, d_model: int,
                    cfg: SSMConfig, rec=None, cache_rec=None):
    """One-token recurrent step. x (B,1,d) -> (out (B,1,d), new cache). With
    `rec`, on this rank's heads (module doc): the conv cache (a block by
    `cache_rec`) is gathered with the packed weights and its new tail cut
    back to the block; the state holds this rank's heads."""
    Bsz = x.shape[0]
    d_inner, H, conv_ch = _dims(d_model, cfg)
    sp = _local(params, rec, d_model, cfg, cache.conv, _field(cache_rec, "conv"))
    p, conv, c, h = sp.params, sp.conv, sp.chans, sp.heads
    hl, cl = h.stop - h.start, c.stop - c.start
    dt_cols = slice(d_inner + conv_ch + h.start, d_inner + conv_ch + h.stop)
    zxbcdt = x @ _cols(p["w_in"], [c, slice(d_inner, d_inner + conv_ch), dt_cols])
    z, xbc, dt = zxbcdt[..., :cl], zxbcdt[..., cl: cl + conv_ch], zxbcdt[..., -hl:]
    mine = [c, slice(d_inner, conv_ch)]
    window = _cols(torch.cat([conv, xbc], dim=1), mine)            # (B,d_conv,C)
    conv_out = torch.einsum("bkc,kc->bc", window, _cols(p["conv_w"], mine)) + _cols(
        p["conv_b"], mine)
    xc, Bm, Cm = _heads(F.silu(conv_out), cl, H, cfg, h)           # (B,*), (B,h,ds)
    dtv, A = _dt(p, dt[:, 0])                                      # (B,H)
    xh = xc.reshape(Bsz, hl, cfg.head_dim).to(torch.float32)
    Bm, Cm = Bm.to(torch.float32), Cm.to(torch.float32)
    hs = torch.exp(dtv * A)[:, :, None, None] * cache.h + torch.einsum(
        "bh,bhd,bhp->bhdp", dtv, Bm, xh)
    y = torch.einsum("bhd,bhdp->bhp", Cm, hs)
    y = y + p["d_skip"].to(torch.float32)[None, :, None] * xh
    out = _out(p, y.reshape(Bsz, 1, cl), z, x.dtype, sp.view, sp.out_chans)
    new_conv = dsh.cut_whole(torch.cat([conv[:, 1:], xbc], dim=1), _field(cache_rec, "conv"))
    return out, SSMCache(conv=new_conv, h=hs)
