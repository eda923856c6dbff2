"""GQA attention (optional QKV bias, sliding window) with train / prefill /
decode paths and a KV cache (a rolling buffer under SWA). The port of
`repro/models/attention.py`: plain PyTorch, as JAX's is plain jnp, with
JAX's layouts (`wq (d, H, hd)`, `wo (H, hd, d)`) and its arithmetic (scores
in float32, masked with -1e30, probabilities cast back to q's dtype before
P V). The chunked path is JAX's double `lax.scan` as two Python loops.

The cache's `pos` is a Python int: the number of tokens already written,
which JAX carries as an int32 scalar array. `decode_step` writes the new
key and value into the cache's tensors in place, where JAX returns new
arrays.

`attend_full` under a "model" axis (`rec`, the layer's records) runs on
this rank's query heads: its blocks of `wq`, `wk`, `wv`, their biases and
`wo`, the partial outputs summed over the model view after `wo`. Where
the axis does not divide the KV heads, they stay replicated while the
query heads split, and the rank projects the KV heads its own query heads
map to (`_local_kv`), not the first ones.

`prefill` and `decode_step` take the layer's records and its cache's
(`cache_rec`, a KVCache of records), in each of the dry run's serving
layouts (`launch/dryrun.py::_rules_for`): the cache split on `kv_heads`
(the default rules), or on its sequence over "model" (prefill_32k,
decode_32k) or "data" (long_500k) with the KV heads whole. The prefill
computes the rank's KV heads over the whole sequence and keeps its block
of the cache; a decode step writes the new token's slot on the rank whose
block holds it, and attends over a split sequence by `tp.attend_split`
(flash decoding)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.dist import shardings as dsh
from repro_torch.dist import tp
from repro_torch.models.layers import apply_rope, normal, rope_freqs


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_buf, kv_heads, head_dim) — roped keys
    v: torch.Tensor     # (B, S_buf, kv_heads, head_dim)
    pos: int            # number of tokens already written


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   device: torch.device, qkv_bias: bool = False) -> dict:
    s = d_model ** -0.5
    p = {
        "wq": normal(generator, (d_model, n_heads, head_dim), dtype, device, s),
        "wk": normal(generator, (d_model, n_kv_heads, head_dim), dtype, device, s),
        "wv": normal(generator, (d_model, n_kv_heads, head_dim), dtype, device, s),
        "wo": normal(generator, (n_heads, head_dim, d_model), dtype, device,
                     (n_heads * head_dim) ** -0.5),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads, head_dim), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n_kv_heads, head_dim), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n_kv_heads, head_dim), dtype=dtype, device=device)
    return p


def attention_sharding(qkv_bias: bool = False) -> dict:
    """The layer's logical parameter specs (`dist.shardings`)."""
    s = {
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv_heads", None),
        "wv": ("embed", "kv_heads", None),
        "wo": ("heads", None, "embed"),
    }
    if qkv_bias:
        s.update({"bq": ("heads", None), "bk": ("kv_heads", None), "bv": ("kv_heads", None)})
    return s


def _out_proj(out: torch.Tensor, wo: torch.Tensor, view=None) -> torch.Tensor:
    """The heads' outputs (B,S,H,dh) through `wo` (H,dh,d); the heads this
    rank's, the partial outputs summed over `view` (`tp.reduce_product`)."""
    return tp.reduce_product(view, out.flatten(-2), wo.flatten(0, 1))


def _project_qkv(params: dict, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,kv,dh) -> (B,S,H,dh) by repeating each kv head H/kv times."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _sdpa(q, k, v, mask, head_dim):
    """q (B,Sq,H,dh), k/v (B,Sk,H,dh), mask (1|B, 1, Sq, Sk) bool."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * (head_dim ** -0.5)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# Materialized-score SDPA is used below this many query positions; above it
# the online-softmax (flash-style) chunked path runs.
CHUNKED_THRESHOLD = 2048
CHUNK_Q = 1024
CHUNK_KV = 1024


def sdpa_chunked(q, k, v, *, scale: float, window: Optional[int] = None,
                 causal: bool = True, chunk_q: int = CHUNK_Q, chunk_kv: int = CHUNK_KV):
    """Online-softmax attention: never materializes (Sq, Sk) scores.

    q (B,Sq,H,dh_qk), k (B,Sk,H,dh_qk), v (B,Sk,H,dh_v). A loop over query
    chunks around a loop over KV chunks with running (m, l, o) accumulators,
    the flash-attention recurrence, so live memory is one (cq, ckv) score
    tile. Assumes q positions == arange(Sq), k positions == arange(Sk).
    """
    B, Sq, H, _ = q.shape
    Sk = k.shape[1]
    Dv = v.shape[-1]
    cq = min(chunk_q, Sq)
    ckv = min(chunk_kv, Sk)
    if Sq % cq or Sk % ckv:
        raise ValueError(f"sdpa_chunked: chunks ({cq}, {ckv}) must divide ({Sq}, {Sk})")
    dev = q.device
    outs = []
    for iq in range(Sq // cq):
        q_c = q[:, iq * cq:(iq + 1) * cq]
        q_pos = iq * cq + torch.arange(cq, device=dev)
        m = torch.full((B, H, cq), -torch.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        o = torch.zeros((B, H, cq, Dv), dtype=torch.float32, device=dev)
        for jk in range(Sk // ckv):
            k_c = k[:, jk * ckv:(jk + 1) * ckv]
            v_c = v[:, jk * ckv:(jk + 1) * ckv]
            k_pos = jk * ckv + torch.arange(ckv, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", q_c, k_c).to(torch.float32) * scale
            mask = torch.ones((cq, ckv), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            s = s.masked_fill(~mask[None, None], -1e30)
            m_new = torch.maximum(m, s.amax(-1))                   # (B,H,cq)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v_c.dtype), v_c).to(torch.float32)
            m = m_new
        out_c = (o / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3)
        outs.append(out_c.to(q.dtype))                             # (B,cq,H,Dv)
    return torch.cat(outs, dim=1)


def _self_attention(q, kf, vf, positions, *, head_dim, window, dense_max):
    """Causal self-attention of q against the repeated kf/vf over the whole
    sequence: materialized scores up to `dense_max` positions, else chunked."""
    if q.shape[1] > dense_max:
        return sdpa_chunked(q, kf, vf, scale=head_dim ** -0.5, window=window)
    i = positions[:, None]
    j = positions[None, :]
    mask = j <= i
    if window is not None:
        mask &= (i - j) < window
    return _sdpa(q, kf, vf, mask[None, None], head_dim)


def _roped_qkv(params, x, positions, head_dim, rope_theta):
    q, k, v = _project_qkv(params, x)
    cos, sin = rope_freqs(head_dim, rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _local_kv(params: dict, rec, view, n_heads: int) -> dict:
    """The layer's weights for this rank's query heads when `heads` is
    split over `view` and `kv_heads` is not: the replicated KV weights
    (and biases) indexed by the KV head of each local query head, so the
    rank's K and V come out already repeated. Their gradients are partial
    (this rank's heads only), so they are summed over the view."""
    if tp.model_view(tp.records(rec, "wk"), 1) is not None:
        return params
    h_loc, n_kv = params["wq"].shape[1], params["wk"].shape[1]
    ids = (view.rank * h_loc + torch.arange(h_loc, device=params["wk"].device)) // (
        n_heads // n_kv)
    out = dict(params)
    for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if name in params:
            out[name] = torch.index_select(tp.copy_to(view, params[name]), dim, ids)
    return out


def attend_full(params: dict, x: torch.Tensor, *, n_heads: int, head_dim: int,
                rope_theta: float, window: Optional[int] = None,
                positions: Optional[torch.Tensor] = None,
                dense_max: int = CHUNKED_THRESHOLD, rec=None) -> torch.Tensor:
    """Training / prefill self-attention over the whole sequence (causal);
    with `heads` split over "model", on this rank's heads (module doc)."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    view = tp.model_view(tp.records(rec, "wq"), 1)
    if view is not None:
        x = tp.copy_to(view, x)
        params = _local_kv(params, rec, view, n_heads)
        n_heads = params["wq"].shape[1]
    elif tp.model_view(tp.records(rec, "wk"), 1) is not None:
        raise ValueError("attend_full: the KV heads are split over \"model\" and the query "
                         "heads are not")
    q, k, v = _roped_qkv(params, x, positions, head_dim, rope_theta)
    out = _self_attention(q, _repeat_kv(k, n_heads), _repeat_kv(v, n_heads), positions,
                          head_dim=head_dim, window=window, dense_max=dense_max)
    return _out_proj(out, params["wo"], view)


def _serve_qkv(params, x, positions, rec, n_heads: int, head_dim: int, rope_theta: float):
    """Roped q for this rank's query heads and k, v for the KV heads its
    records give it (its block where `kv_heads` splits over "model", else
    all of them), the heads' model view, and the index of each local query
    head's KV head in k (None: k repeats as `_repeat_kv` does)."""
    view = tp.model_view(tp.records(rec, "wq"), 1)
    kv_split = tp.model_view(tp.records(rec, "wk"), 1) is not None
    if kv_split and view is None:
        raise ValueError("attention: the KV heads are split over \"model\" and the query "
                         "heads are not")
    q, k, v = _roped_qkv(params, x, positions, head_dim, rope_theta)
    ids = None
    if view is not None and not kv_split:
        h_loc = params["wq"].shape[1]
        ids = (view.rank * h_loc + torch.arange(h_loc, device=x.device)) // (
            n_heads // params["wk"].shape[1])
    return q, k, v, view, ids


def _for_heads(k: torch.Tensor, ids, n_heads: int) -> torch.Tensor:
    """k (B,S,kv,dh) as the KV head of each of the `n_heads` query heads."""
    return _repeat_kv(k, n_heads) if ids is None else torch.index_select(k, 2, ids)


def prefill(params: dict, x: torch.Tensor, *, n_heads: int, head_dim: int,
            rope_theta: float, window: Optional[int] = None,
            cache_len: Optional[int] = None,
            dense_max: int = CHUNKED_THRESHOLD, rec=None,
            cache_rec=None) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence attention that also returns the KV cache (a rolling
    buffer of size `window` when SWA is active). With records, on this
    rank's query heads, the cache cut to the rank's block (module doc)."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    q, k, v, view, ids = _serve_qkv(params, x, positions, rec, n_heads, head_dim, rope_theta)
    h = q.shape[2]
    out = _self_attention(q, _for_heads(k, ids, h), _for_heads(v, ids, h), positions,
                          head_dim=head_dim, window=window, dense_max=dense_max)
    out = _out_proj(out, params["wo"], view)

    buf = cache_len if cache_len is not None else S
    if window is not None:
        buf = min(buf, window)
    if buf >= S:
        pad = buf - S
        k_buf = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v_buf = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    else:  # rolling buffer keeps the trailing `buf` positions at slot pos % buf
        shift = S % buf
        k_buf = torch.roll(k[:, S - buf:], shift, dims=1)
        v_buf = torch.roll(v[:, S - buf:], shift, dims=1)
    if cache_rec is not None:
        k_buf = dsh.cut_whole(k_buf, cache_rec.k).clone()
        v_buf = dsh.cut_whole(v_buf, cache_rec.v).clone()
    return out, KVCache(k=k_buf, v=v_buf, pos=S)


def decode_step(params: dict, x: torch.Tensor, cache: KVCache, *, n_heads: int,
                head_dim: int, rope_theta: float,
                window: Optional[int] = None, rec=None,
                cache_rec=None) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: x (B, 1, d) against the cache. Without a window the
    slot is min(pos, S_buf - 1), so a full cache overwrites its last slot
    (JAX's behaviour, kept). With records (module doc), the cache is this
    rank's block: the rank whose block of the sequence holds the slot
    writes it, and the softmax runs over the split sequence."""
    seq = dsh.dim_view(cache_rec.k, 1) if cache_rec is not None else None
    n_loc = cache.k.shape[1]
    S_buf = n_loc * (seq.size if seq is not None else 1)
    start = seq.rank * n_loc if seq is not None else 0
    pos = cache.pos
    dev = x.device
    positions = torch.arange(pos, pos + 1, device=dev)   # made on the device: no host copy
    q, k, v, view, ids = _serve_qkv(params, x, positions, rec, n_heads, head_dim, rope_theta)

    slot = (min(pos, S_buf - 1) if window is None else pos % S_buf) - start
    if 0 <= slot < n_loc:
        cache.k[:, slot:slot + 1] = k.to(cache.k.dtype)
        cache.v[:, slot:slot + 1] = v.to(cache.v.dtype)

    if window is not None and pos >= S_buf:     # a full rolling buffer: every slot
        valid = torch.ones(n_loc, dtype=torch.bool, device=dev)
    else:
        valid = start + torch.arange(n_loc, device=dev) <= pos
    h = q.shape[2]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, _for_heads(cache.k, ids, h)).to(
        torch.float32) * (head_dim ** -0.5)
    scores = scores.masked_fill(~valid[None, None, None, :], -1e30)
    out = tp.attend_split(scores, _for_heads(cache.v, ids, h), seq)
    out = _out_proj(out, params["wo"], view)
    return out, KVCache(k=cache.k, v=cache.v, pos=pos + 1)
