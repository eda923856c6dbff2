"""TransformerLM assembly: the port of `repro/models/model.py`. Layer
plans mix the `attn`, `mla` and `ssm` mixers with `dense`, `moe` and
`none` MLPs; the `tokens`, `codebooks` and `patches` front ends, the
tied-embedding head, DeepSeek-V3's depth-1 multi-token prediction
(`mtp_logits`), and the forward / prefill / decode entry points.

Layers run in a Python loop in JAX's order (the dense prefix, then period
r, position j), so the parameters hold one dict a layer in
`params["layers"]`, each with JAX's per-layer layout (`mixer_norm`,
`mixer`, `mlp_norm`, `mlp`); JAX stacks the body across periods for its
`lax.scan`, which `repro_torch.convert.model_params_from_jax` unstacks.
The caches follow the same list (`caches["layers"]`): a `KVCache`,
`MLACache` or `SSMCache` a layer. There is no jit or scan:
`unroll_layers` is kept so the configs match JAX's, and is unused.
`rules_override` feeds the rule table of `dist` (the train launcher's
`mesh_context`, `dist.shardings`); `dist.shardings` resolves a body layer
as its period stack in JAX's tree.

Remat: while autograd records (`torch.is_grad_enabled()`) and `cfg.remat`
is set, `forward` runs each layer under `torch.utils.checkpoint` (not
reentrant), so backward keeps each layer's input and recomputes its
inside; `remat_policy="dots"` keeps the matmul outputs too (JAX's
`checkpoint_dots`). JAX checkpoints each prefix layer and each scanned
period; the port checkpoints each layer, which is the same math and
differs only in memory. Serving runs under `torch.inference_mode()` and
takes no checkpoint.

Sharded (`records`, the step's parameter records, `dist.shardings`): the
parameters are this rank's blocks. Each layer gathers the blocks that
FSDP split over "data" (`dist.fsdp.gather`) inside its checkpointed
function, so remat recomputes the gather and only the blocks outlive the
layer; the leaves outside the layers are gathered once a forward. The
modules then run on their "model" blocks (`dist.tp`), and the head
returns this rank's block of the vocabulary for every front end (the
codebooks front end one block a codebook's table).

The serving entry points take the same records and the caches' own
(`cache_records`, `dist.shardings.cache_shardings` of `init_cache`'s tree):
each layer gathers its FSDP blocks under `torch.inference_mode()` (no
checkpoint, no backward), the mixers keep and write their blocks of the
caches, and the logits come back whole over the vocabulary for this
rank's rows (gathered over the vocab split). `init_cache` with records
allocates this rank's blocks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import dist
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import fsdp
from repro_torch.dist import shardings as dsh
from repro_torch.dist import tp
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig
from repro_torch.utils import tree_map


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 1e4
    qkv_bias: bool = False
    swa_window: Optional[int] = None
    mixer_pattern: tuple = ("attn",)          # tiled over layers
    mlp_pattern: tuple = ("dense",)
    dense_prefix: int = 0                      # first k layers: dense MLP (d_ff_dense)
    d_ff_dense: Optional[int] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    frontend: str = "tokens"                   # tokens | codebooks | patches
    n_codebooks: int = 1
    vision_tokens: int = 0                     # prepended patch embeddings (patches)
    mtp_depth: int = 0                         # DeepSeek-V3 multi-token prediction
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"
    attn_dense_max: int = 2048                 # S above this -> chunked (flash) SDPA
    unroll_layers: bool = False
    rules_override: dict = dataclasses.field(default_factory=dict)

    @property
    def period(self) -> int:
        return int(math.lcm(len(self.mixer_pattern), len(self.mlp_pattern)))

    def layer_spec(self, i: int) -> tuple[str, str]:
        mixer = self.mixer_pattern[i % len(self.mixer_pattern)]
        mlp = self.mlp_pattern[i % len(self.mlp_pattern)]
        if i < self.dense_prefix:
            mlp = "dense"
        return mixer, mlp

    @property
    def n_body(self) -> int:
        return self.n_layers - self.dense_prefix

    @property
    def n_periods(self) -> int:
        if self.n_body % self.period:
            raise ValueError(f"{self.name}: {self.n_body} body layers are not a whole "
                             f"number of periods of {self.period}")
        return self.n_body // self.period


# ------------------------------------------------------------------ init ---

def _init_layer(generator, cfg: ModelConfig, mixer: str, mlp: str, device) -> dict:
    dt = cfg.param_dtype
    p: dict = {"mixer_norm": L.init_rms_norm(cfg.d_model, dt, device),
               "mlp_norm": L.init_rms_norm(cfg.d_model, dt, device)}
    if mixer == "attn":
        p["mixer"] = attn.init_attention(generator, cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim, dt, device,
                                         cfg.qkv_bias)
    elif mixer == "mla":
        p["mixer"] = mla_mod.init_mla(generator, cfg.d_model, cfg.mla, dt, device)
    elif mixer == "ssm":
        p["mixer"] = ssm_mod.init_ssm(generator, cfg.d_model, cfg.ssm, dt, device)
    else:
        raise ValueError(mixer)
    if mlp == "dense":
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff_dense or cfg.d_ff, dt, device)
    elif mlp == "moe":
        p["mlp"] = moe_mod.init_moe(generator, cfg.d_model, cfg.moe, dt, device)
    elif mlp == "none":   # pure-SSM blocks (mamba2): mixer only, no MLP
        p.pop("mlp_norm")
    else:
        raise ValueError(mlp)
    return p


def init_model(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> dict:
    """Random parameters of `cfg` on `device` (CUDA when none is named),
    drawn from `generator` (a generator on that device seeded 0 when none
    is given): the embedding, the codebook embeddings, each layer in order,
    then the MTP module when `cfg.mtp_depth` is set. On the "meta" device
    the same tree of shapes and dtypes, no data and no generator (the
    counterpart of `jax.eval_shape(init_model)`)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        generator = None
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = cfg.param_dtype
    params: dict = {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model, dt, dev),
        "final_norm": L.init_rms_norm(cfg.d_model, dt, dev),
    }
    if cfg.frontend == "codebooks" and cfg.n_codebooks > 1:
        params["codebook_embeds"] = [
            L.init_embedding(generator, cfg.vocab_size, cfg.d_model, dt, dev)
            for _ in range(1, cfg.n_codebooks)]
    params["layers"] = [_init_layer(generator, cfg, *cfg.layer_spec(i), dev)
                        for i in range(cfg.n_layers)]
    if cfg.mtp_depth:
        d = cfg.d_model
        params["mtp"] = {
            "proj": L.normal(generator, (2 * d, d), dt, dev, (2 * d) ** -0.5),
            "layer": _init_layer(generator, cfg, "attn", "dense", dev),
            "norm": L.init_rms_norm(d, dt, dev),
        }
    return params


# --------------------------------------------------------------- forward ---

def _apply_mixer(p, x, cfg: ModelConfig, mixer: str, rec=None):
    if mixer == "attn":
        return attn.attend_full(p, x, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                                rope_theta=cfg.rope_theta, window=cfg.swa_window,
                                dense_max=cfg.attn_dense_max, rec=rec)
    if mixer == "mla":
        return mla_mod.mla_full(p, x, cfg.mla, rope_theta=cfg.rope_theta,
                                dense_max=cfg.attn_dense_max, rec=rec)
    if mixer == "ssm":
        return ssm_mod.ssm_forward(p, x, cfg.d_model, cfg.ssm, rec=rec)
    raise ValueError(mixer)


def _apply_mlp(p, x, cfg: ModelConfig, mlp: str, rec=None):
    """(x plus the layer's MLP of norm(x), the MoE aux loss or 0.0); x itself
    for "none"."""
    if mlp == "none":
        return x, 0.0
    hn = L.rms_norm(x, p["mlp_norm"]["scale"])
    if mlp == "dense":
        return x + L.apply_mlp(p["mlp"], hn, tp.records(rec, "mlp")), 0.0
    h, aux = moe_mod.apply_moe(p["mlp"], hn, cfg.moe, tp.records(rec, "mlp"))
    return x + h, aux


def _apply_layer(p, x, cfg: ModelConfig, mixer: str, mlp: str, rec=None):
    """One layer; with its records, on this rank's blocks, the FSDP blocks
    gathered first."""
    p = fsdp.gather(p, rec)
    h = _apply_mixer(p["mixer"], L.rms_norm(x, p["mixer_norm"]["scale"]), cfg, mixer,
                     tp.records(rec, "mixer"))
    return _apply_mlp(p, x + h, cfg, mlp, rec)


def _embed_inputs(params, cfg: ModelConfig, batch: dict, rec=None) -> torch.Tensor:
    emb = tp.records(rec, "embed")
    if cfg.frontend == "tokens":
        return L.embed_tokens(params["embed"], batch["tokens"], emb)
    if cfg.frontend == "codebooks":
        toks = batch["tokens"]                    # (B, S, K)
        x = L.embed_tokens(params["embed"], toks[..., 0], emb)
        for c in range(1, cfg.n_codebooks):
            x = x + L.embed_tokens(params["codebook_embeds"][c - 1], toks[..., c],
                                   rec["codebook_embeds"][c - 1] if rec else None)
        return x
    if cfg.frontend == "patches":
        x_txt = L.embed_tokens(params["embed"], batch["tokens"], emb)   # (B, S_txt, d)
        x_img = batch["patch_embeds"].to(x_txt.dtype)              # (B, P, d)
        return torch.cat([x_img, x_txt], dim=1)
    raise ValueError(cfg.frontend)


#: the matmuls whose outputs `remat_policy="dots"` keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _checkpointed(cfg: ModelConfig, p, x, mixer: str, mlp: str, rec=None):
    """`_apply_layer` under a non-reentrant checkpoint. The forward draws
    no random numbers, so no RNG state is kept for the recompute. The
    recompute re-enters this thread's `dist` contexts (a CUDA backward runs
    it on autograd's thread, where the MoE would not see its data-parallel
    mesh), and gathers the layer's FSDP blocks again."""
    snap = dist.snapshot()

    def contexts():
        if cfg.remat_policy == "dots":
            fwd, rec = ckpt.create_selective_checkpoint_contexts(_save_dots)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _both(rec, dist.entered(snap))

    return ckpt.checkpoint(_apply_layer, p, x, cfg, mixer, mlp, rec, use_reentrant=False,
                           preserve_rng_state=False, context_fn=contexts)


def _outer(params: dict, records, keys) -> dict:
    """params with the FSDP blocks of its entries `keys` gathered (the
    leaves outside the layers; `records` None: params itself)."""
    if records is None:
        return params
    return dict(params, **fsdp.gather({k: params[k] for k in keys if k in params},
                                      {k: records[k] for k in keys if k in params}))


def forward(params: dict, cfg: ModelConfig, batch: dict, return_hidden: bool = False,
            records=None):
    """Full-sequence forward -> (logits, aux_loss[, hidden]); `aux_loss` is
    the sum of the MoE layers' load-balance losses (float32, 0 without
    MoE), `hidden` the final-normed residual stream (B, S, d). With
    `records` (a record tree like params, whose leaves are then this
    rank's blocks), sharded as the module says: the logits are this rank's
    block of the vocabulary when `vocab` is split over "model"."""
    outer = _outer(params, records, ("embed", "codebook_embeds", "final_norm"))
    x = _embed_inputs(outer, cfg, batch, records)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(params["layers"]):
        rec = records["layers"][i] if records is not None else None
        if remat:
            x, aux = _checkpointed(cfg, p, x, *cfg.layer_spec(i), rec)
        else:
            x, aux = _apply_layer(p, x, cfg, *cfg.layer_spec(i), rec)
        aux_total = aux_total + aux
    x = L.rms_norm(x, outer["final_norm"]["scale"])
    logits = _head(outer, cfg, x, records)
    if return_hidden:
        return logits, aux_total, x
    return logits, aux_total


def _head(params, cfg: ModelConfig, x, records=None, whole: bool = False):
    """The tied head's logits of x: this rank's block of the vocabulary
    under a vocab split, or (`whole`) each table's block gathered."""
    def logits(table, rec):
        out = L.logits_from_embedding(table, x, rec)
        return tp.gather_last(tp.model_view(tp.records(rec, "table"), 0), out) if whole else out

    emb = tp.records(records, "embed")
    if cfg.frontend == "codebooks":
        tables = [params["embed"]] + list(params.get("codebook_embeds", []))
        recs = [emb] + (list(records.get("codebook_embeds", [])) if records else
                        [None] * (len(tables) - 1))
        return torch.stack([logits(t, r) for t, r in zip(tables, recs)], dim=2)  # (B,S,K,V)
    return logits(params["embed"], emb)


def mtp_logits(params: dict, cfg: ModelConfig, h: torch.Tensor, batch: dict,
               records=None):
    """DeepSeek-V3 MTP depth-1: predict token t+2 from (h_t, emb(tok_{t+1}));
    h is `forward`'s hidden state (B, S, d). With `records`, sharded as
    `forward` is."""
    emb = tp.records(records, "embed")
    m_rec = tp.records(records, "mtp")
    outer = _outer(params, records, ("embed",))
    mtp = dict(params["mtp"], **_outer(params["mtp"], m_rec, ("proj", "norm")))
    emb_next = L.embed_tokens(outer["embed"], torch.roll(batch["tokens"], -1, dims=1), emb)
    z = torch.cat([L.rms_norm(h, mtp["norm"]["scale"]), emb_next], dim=-1)
    z, _ = _apply_layer(mtp["layer"], z @ mtp["proj"], cfg, "attn", "dense",
                        tp.records(m_rec, "layer"))
    return L.logits_from_embedding(outer["embed"], z, emb)


# ------------------------------------------------------------- serve path ---

def init_cache(params: Optional[dict], cfg: ModelConfig, batch_size: int, max_len: int,
               records=None, device: DeviceLike = None) -> dict:
    """Empty per-layer caches on the parameters' device (or `device`; the
    "meta" device gives the shapes only): a KV buffer of
    min(max_len, swa_window) positions for `attn`, a latent buffer of
    max_len positions for `mla`, the conv tail and a float32 state for
    `ssm`. With `records` (`cache_shardings` of the whole tree), this
    rank's blocks of them."""
    dev = params["embed"]["table"].device if device is None else resolve_device(device)

    def z(shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def layer_cache(mixer):
        if mixer == "attn":
            buf = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
            shape = (batch_size, buf, cfg.n_kv_heads, cfg.head_dim)
            return attn.KVCache(k=z(shape), v=z(shape), pos=0)
        if mixer == "mla":
            return mla_mod.MLACache(c_kv=z((batch_size, max_len, cfg.mla.kv_lora_rank)),
                                    k_rope=z((batch_size, max_len, cfg.mla.qk_rope_dim)),
                                    pos=0)
        if mixer == "ssm":
            _, H, conv_ch = ssm_mod._dims(cfg.d_model, cfg.ssm)
            return ssm_mod.SSMCache(
                conv=z((batch_size, cfg.ssm.d_conv - 1, conv_ch)),
                h=z((batch_size, H, cfg.ssm.d_state, cfg.ssm.head_dim), torch.float32))
        raise ValueError(mixer)

    if records is not None:
        shapes = init_cache(None, cfg, batch_size, max_len, device="meta")
        return tree_map(lambda x, r: torch.zeros(dsh.block_shape(r), dtype=x.dtype, device=dev)
                        if isinstance(x, torch.Tensor) else x, shapes, records)
    return {"layers": [layer_cache(cfg.layer_spec(i)[0]) for i in range(cfg.n_layers)]}


def cache_records(cfg: ModelConfig, batch_size: int, max_len: int):
    """The caches' records (`dist.shardings.cache_shardings`) in the active
    mesh context. Resolved per layer: a cache leaf takes no FSDP widening,
    so its stacked dim is never split and JAX's stacked records give the
    same blocks."""
    return dsh.cache_shardings(init_cache(None, cfg, batch_size, max_len, device="meta"))


def _layer_recs(records, cache_records, i):
    rec = records["layers"][i] if records is not None else None
    return rec, (cache_records["layers"][i] if cache_records is not None else None)


def _mixer_step(p, x, cache, cfg: ModelConfig, mixer: str, rec=None, cache_rec=None):
    if mixer == "attn":
        return attn.decode_step(p, x, cache, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                                rope_theta=cfg.rope_theta, window=cfg.swa_window, rec=rec,
                                cache_rec=cache_rec)
    if mixer == "mla":
        return mla_mod.mla_decode_step(p, x, cache, cfg.mla, rope_theta=cfg.rope_theta,
                                       rec=rec, cache_rec=cache_rec)
    if mixer == "ssm":
        return ssm_mod.ssm_decode_step(p, x, cache, cfg.d_model, cfg.ssm, rec=rec,
                                       cache_rec=cache_rec)
    raise ValueError(mixer)


_OUTER = ("embed", "codebook_embeds", "final_norm")


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, caches: dict,
                records=None, cache_records=None):
    """One-token decode. tokens (B,) or (B, K) for codebooks -> logits, caches.
    The attention and latent caches' tensors are written in place. With
    `records` and `cache_records`, on this rank's blocks (module doc)."""
    outer = _outer(params, records, _OUTER)
    if cfg.frontend == "codebooks":
        x = _embed_inputs(outer, cfg, {"tokens": tokens[:, None, :]}, records)
    else:  # "patches" decodes text tokens only (the image is prefill-time)
        x = L.embed_tokens(outer["embed"], tokens[:, None], tp.records(records, "embed"))
    new = []
    for i, p in enumerate(params["layers"]):
        mixer, mlp = cfg.layer_spec(i)
        rec, c_rec = _layer_recs(records, cache_records, i)
        p = fsdp.gather(p, rec)
        h, c = _mixer_step(p["mixer"], L.rms_norm(x, p["mixer_norm"]["scale"]),
                           caches["layers"][i], cfg, mixer, tp.records(rec, "mixer"), c_rec)
        x, _ = _apply_mlp(p, x + h, cfg, mlp, rec)
        new.append(c)
    x = L.rms_norm(x, outer["final_norm"]["scale"])
    return _head(outer, cfg, x, records, whole=True)[:, 0], {"layers": new}


def _mixer_prefill(p, x, cfg: ModelConfig, mixer: str, max_len: int, rec=None,
                   cache_rec=None):
    if mixer == "attn":
        buf = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
        return attn.prefill(p, x, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                            rope_theta=cfg.rope_theta, window=cfg.swa_window,
                            cache_len=buf, dense_max=cfg.attn_dense_max, rec=rec,
                            cache_rec=cache_rec)
    if mixer == "mla":
        return mla_mod.mla_prefill(p, x, cfg.mla, rope_theta=cfg.rope_theta,
                                   cache_len=max_len, dense_max=cfg.attn_dense_max, rec=rec,
                                   cache_rec=cache_rec)
    if mixer == "ssm":
        return ssm_mod.ssm_forward(p, x, cfg.d_model, cfg.ssm, return_cache=True, rec=rec,
                                   cache_rec=cache_rec)
    raise ValueError(mixer)


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int, records=None,
            cache_records=None, last_only: bool = False):
    """Prefill: the full forward, building each layer's cache on the way.
    With `records` and `cache_records`, on this rank's blocks (module doc).
    `last_only` applies the head to the last position alone ((B, 1, ...)
    logits)."""
    outer = _outer(params, records, _OUTER)
    x = _embed_inputs(outer, cfg, batch, records)
    caches = []
    for i, p in enumerate(params["layers"]):
        mixer, mlp = cfg.layer_spec(i)
        rec, c_rec = _layer_recs(records, cache_records, i)
        p = fsdp.gather(p, rec)
        h, c = _mixer_prefill(p["mixer"], L.rms_norm(x, p["mixer_norm"]["scale"]), cfg,
                              mixer, max_len, tp.records(rec, "mixer"), c_rec)
        x, _ = _apply_mlp(p, x + h, cfg, mlp, rec)
        caches.append(c)
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, outer["final_norm"]["scale"])
    return _head(outer, cfg, x, records, whole=True), {"layers": caches}
