"""TransformerLM assembly: the port of `repro/models/model.py` for the
dense-attention family (the `attn` mixer with `dense` MLPs), with the
`tokens`, `codebooks` and `patches` front ends, the tied-embedding head,
and the forward / prefill / decode entry points.

Layers run in a Python loop in JAX's order (the dense prefix, then period
r, position j), so the parameters hold one dict a layer in
`params["layers"]`, each with JAX's per-layer layout (`mixer_norm`,
`mixer`, `mlp_norm`, `mlp`); JAX stacks the body across periods for its
`lax.scan`, which `repro_torch.convert.model_params_from_jax` unstacks.
The caches follow the same list (`caches["layers"]`). There is no jit,
scan or remat: `remat`, `remat_policy`, `unroll_layers` and
`rules_override` are kept so the configs match JAX's, and are unused.

The `moe`, `mla` and `ssm` mixers and MLPs and `mtp_logits` raise
`NotImplementedError`: they are the next slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig

NEXT_SLICE = "ROADMAP.md Queue 1 item 7: the MoE, SSM, MLA and MTP serving path"


def _not_ported(what: str):
    raise NotImplementedError(f"repro_torch.models: {what} is not ported yet; it comes "
                              f"with the next slice ({NEXT_SLICE})")


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


def _check_ported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` for a config this slice cannot run: every
    entry point calls it first, so the layers below see only the `attn`
    mixer and `dense` or `none` MLPs."""
    for i in range(cfg.n_layers):
        mixer, mlp = cfg.layer_spec(i)
        if mixer != "attn":
            _not_ported(f"the {mixer!r} mixer ({cfg.name}, layer {i})")
        if mlp not in ("dense", "none"):
            _not_ported(f"the {mlp!r} MLP ({cfg.name}, layer {i})")
    if cfg.mtp_depth:
        _not_ported(f"multi-token prediction ({cfg.name})")


# ------------------------------------------------------------------ init ---

def _init_layer(generator, cfg: ModelConfig, mlp: str, device) -> dict:
    dt = cfg.param_dtype
    p: dict = {"mixer_norm": L.init_rms_norm(cfg.d_model, dt, device),
               "mlp_norm": L.init_rms_norm(cfg.d_model, dt, device)}
    p["mixer"] = attn.init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim, dt, device, cfg.qkv_bias)
    if mlp == "dense":
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff_dense or cfg.d_ff, dt, device)
    else:   # "none": mixer only, no MLP
        p.pop("mlp_norm")
    return p


def init_model(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> dict:
    """Random parameters of `cfg` on `device` (CUDA when none is named),
    drawn from `generator` (a generator on that device seeded 0 when none
    is given): the embedding, the codebook embeddings, then each layer in
    order."""
    _check_ported(cfg)
    dev = resolve_device(device)
    if generator is None:
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
    params["layers"] = [_init_layer(generator, cfg, cfg.layer_spec(i)[1], dev)
                        for i in range(cfg.n_layers)]
    return params


# --------------------------------------------------------------- forward ---

def _apply_mlp(p, x, mlp: str):
    """x plus the layer's dense MLP of norm(x); x itself for "none"."""
    if mlp == "none":
        return x
    return x + L.apply_mlp(p["mlp"], L.rms_norm(x, p["mlp_norm"]["scale"]))


def _apply_layer(p, x, cfg: ModelConfig, mlp: str):
    h = attn.attend_full(p["mixer"], L.rms_norm(x, p["mixer_norm"]["scale"]),
                         n_heads=cfg.n_heads, head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                         window=cfg.swa_window, dense_max=cfg.attn_dense_max)
    return _apply_mlp(p, x + h, mlp)


def _embed_inputs(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    if cfg.frontend == "tokens":
        return L.embed_tokens(params["embed"], batch["tokens"])
    if cfg.frontend == "codebooks":
        toks = batch["tokens"]                    # (B, S, K)
        x = L.embed_tokens(params["embed"], toks[..., 0])
        for c in range(1, cfg.n_codebooks):
            x = x + L.embed_tokens(params["codebook_embeds"][c - 1], toks[..., c])
        return x
    if cfg.frontend == "patches":
        x_txt = L.embed_tokens(params["embed"], batch["tokens"])   # (B, S_txt, d)
        x_img = batch["patch_embeds"].to(x_txt.dtype)              # (B, P, d)
        return torch.cat([x_img, x_txt], dim=1)
    raise ValueError(cfg.frontend)


def _final(params, cfg: ModelConfig, x):
    return _head(params, cfg, L.rms_norm(x, params["final_norm"]["scale"]))


def forward(params: dict, cfg: ModelConfig, batch: dict, return_hidden: bool = False):
    """Full-sequence forward -> (logits, aux_loss[, hidden]); `hidden` is the
    final-normed residual stream (B, S, d)."""
    _check_ported(cfg)
    x = _embed_inputs(params, cfg, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)  # dense MLPs: no aux loss
    for i, p in enumerate(params["layers"]):
        x = _apply_layer(p, x, cfg, cfg.layer_spec(i)[1])
    x = L.rms_norm(x, params["final_norm"]["scale"])
    logits = _head(params, cfg, x)
    if return_hidden:
        return logits, aux_total, x
    return logits, aux_total


def _head(params, cfg: ModelConfig, x):
    if cfg.frontend == "codebooks":
        tables = [params["embed"]["table"]] + [
            e["table"] for e in params.get("codebook_embeds", [])]
        xf = x.to(torch.float32)
        return torch.stack([xf @ t.to(torch.float32).T for t in tables], dim=2)  # (B,S,K,V)
    return L.logits_from_embedding(params["embed"], x)


def mtp_logits(params: dict, cfg: ModelConfig, h: torch.Tensor, batch: dict):
    """DeepSeek-V3 MTP depth-1: the next slice of the port."""
    _not_ported("multi-token prediction (mtp_logits)")


# ------------------------------------------------------------- serve path ---

def init_cache(params: dict, cfg: ModelConfig, batch_size: int, max_len: int) -> dict:
    """Empty per-layer caches on the parameters' device (a KV buffer of
    min(max_len, swa_window) positions a layer)."""
    _check_ported(cfg)
    dev = params["embed"]["table"].device
    buf = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    shape = (batch_size, buf, cfg.n_kv_heads, cfg.head_dim)
    return {"layers": [attn.KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                                    v=torch.zeros(shape, dtype=cfg.dtype, device=dev), pos=0)
                       for _ in range(cfg.n_layers)]}


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, caches: dict):
    """One-token decode. tokens (B,) or (B, K) for codebooks -> logits, caches.
    The caches' tensors are written in place."""
    _check_ported(cfg)
    if cfg.frontend == "codebooks":
        x = _embed_inputs(params, cfg, {"tokens": tokens[:, None, :]})
    else:  # "patches" decodes text tokens only (the image is prefill-time)
        x = L.embed_tokens(params["embed"], tokens[:, None])
    new = []
    for i, p in enumerate(params["layers"]):
        h, c = attn.decode_step(p["mixer"], L.rms_norm(x, p["mixer_norm"]["scale"]),
                                caches["layers"][i], n_heads=cfg.n_heads,
                                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                                window=cfg.swa_window)
        x = _apply_mlp(p, x + h, cfg.layer_spec(i)[1])
        new.append(c)
    return _final(params, cfg, x)[:, 0], {"layers": new}


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int):
    """Prefill: the full forward, building each layer's cache on the way."""
    _check_ported(cfg)
    x = _embed_inputs(params, cfg, batch)
    buf = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    caches = []
    for i, p in enumerate(params["layers"]):
        h, c = attn.prefill(p["mixer"], L.rms_norm(x, p["mixer_norm"]["scale"]),
                            n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                            rope_theta=cfg.rope_theta, window=cfg.swa_window,
                            cache_len=buf, dense_max=cfg.attn_dense_max)
        x = _apply_mlp(p, x + h, cfg.layer_spec(i)[1])
        caches.append(c)
    return _final(params, cfg, x), {"layers": caches}
