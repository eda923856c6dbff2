"""Carry a JAX-package solve or model across to the port.

SVEN has no weights: what crosses is the problem, the solve settings and
the warm-start carry. The LM's parameters cross as a tree of numpy arrays
(`model_params_from_jax`). These functions take plain numpy arrays and
dicts (`dataclasses.asdict` of a `repro.core.sven.SvenConfig` or of a
`repro.core.api.PathConfig`), so this package still imports nothing of
`repro`.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.api import EnetCarry, PathConfig
from repro_torch.core.sven import SvenConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import ModelConfig
from repro_torch.utils import tree_map

#: JAX SvenConfig.backend -> port backend
_BACKEND = {"xla": "torch", "auto": "auto", "pallas": "auto", "tpu": "auto",
            "gpu": "auto", "tpu_interpret": "ref", "gpu_interpret": "ref",
            "ref": "ref"}


def problem_from_numpy(X, y, *, device: DeviceLike = None,
                       dtype: torch.dtype = torch.float64):
    """(X, y) as tensors of `dtype` on `device` (CUDA when none is named)."""
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(X), dtype=dtype, device=dev),
            torch.tensor(np.asarray(y), dtype=dtype, device=dev))


def config_from_jax(fields: Mapping) -> SvenConfig:
    """The port's SvenConfig from the fields of a JAX SvenConfig.

    backend "xla" -> "torch"; "auto"/"pallas"/"tpu"/"gpu" -> "auto";
    "*_interpret"/"ref" -> "ref". The deprecated `interpret` flag folds in
    as JAX folds it (True -> an interpreted body -> "ref") and is dropped.
    Every other field keeps its value.
    """
    fields = dict(fields)
    interpret = fields.pop("interpret", None)
    backend = fields.get("backend", "xla")
    if backend not in _BACKEND:
        raise ValueError(f"config_from_jax: unknown JAX backend {backend!r}")
    backend = _BACKEND[backend]
    if interpret and backend == "auto":
        backend = "ref"
    fields["backend"] = backend
    return SvenConfig(**fields)


def warm_from_jax(alpha, w, *, device: DeviceLike = None,
                  dtype: torch.dtype = torch.float64):
    """(warm_alpha, warm_w) for `sven` from a JAX solution's alpha and w."""
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(alpha), dtype=dtype, device=dev),
            torch.tensor(np.asarray(w), dtype=dtype, device=dev))


def path_config_from_jax(fields: Mapping) -> PathConfig:
    """The port's PathConfig from the fields of a JAX PathConfig; the nested
    solver settings go through `config_from_jax`."""
    fields = dict(fields)
    solver = fields.pop("solver", None)
    if solver is not None:
        fields["solver"] = config_from_jax(solver)
    return PathConfig(**fields)


def carry_from_jax(beta, alpha, w, t, nu, *, device: DeviceLike = None,
                   dtype: torch.dtype = torch.float64) -> EnetCarry:
    """The port's EnetCarry from the fields of a JAX `EnetCarry`: one
    point's, or a stacked one (every field with a leading (B,) axis) for
    `enet_batch`'s `warm`."""
    dev = resolve_device(device)
    return EnetCarry(*(torch.tensor(np.asarray(a), dtype=dtype, device=dev)
                       for a in (beta, alpha, w, t, nu)))


def model_params_from_jax(params, cfg: ModelConfig, *, device: DeviceLike = None) -> dict:
    """The port's parameters from a JAX `init_model` tree of numpy arrays
    (`jax.tree.map(np.asarray, params)`), on `device` (CUDA when none is
    named).

    JAX keeps the dense prefix as a list and stacks the body across
    periods: `params["body"][j]` holds position j of every period along a
    leading axis. The port holds one dict a layer in `params["layers"]`, so
    period r of `body[j]` becomes layer `dense_prefix + r * period + j`.
    Every other entry crosses as it is.
    """
    dev = resolve_device(device)

    def cross(a):
        return torch.tensor(np.asarray(a), device=dev)

    out = {k: tree_map(cross, v) for k, v in params.items() if k not in ("prefix", "body")}
    layers = [None] * cfg.n_layers
    for i, layer in enumerate(params["prefix"]):
        layers[i] = tree_map(cross, layer)
    for j, stacked in enumerate(params["body"]):
        for r in range(cfg.n_periods):
            layers[cfg.dense_prefix + r * cfg.period + j] = tree_map(
                lambda a, r=r: cross(np.asarray(a)[r]), stacked)
    if any(layer is None for layer in layers):
        raise ValueError(f"model_params_from_jax: the tree does not hold the "
                         f"{cfg.n_layers} layers of {cfg.name}")
    out["layers"] = layers
    return out


def caches_from_jax(caches, cfg: ModelConfig, *, device: DeviceLike = None) -> dict:
    """The port's decode caches from a JAX cache tree of numpy arrays
    (`jax.tree.map(np.asarray, caches)` of `init_cache` / `prefill`), on
    `device` (CUDA when none is named).

    JAX holds {"prefix": [cache a layer], "body": [cache a period
    position, stacked over periods]}, each a `KVCache`, `MLACache` or
    `SSMCache`; the port holds {"layers": [cache a layer]} of its own
    containers of the same fields, a cache's `pos` a Python int. The
    containers are matched by their fields, so nothing of `repro` is
    imported."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.mla import MLACache
    from repro_torch.models.ssm import SSMCache

    dev = resolve_device(device)
    kinds = {c._fields: c for c in (KVCache, MLACache, SSMCache)}

    def cross(cache, r=None):
        kind = kinds.get(tuple(cache._fields))
        if kind is None:
            raise ValueError(f"caches_from_jax: no port cache has the fields {cache._fields}")
        fields = {}
        for name in kind._fields:
            a = np.asarray(getattr(cache, name))
            a = a if r is None else a[r]
            fields[name] = int(a) if name == "pos" else torch.tensor(a, device=dev)
        return kind(**fields)

    layers = [None] * cfg.n_layers
    for i, cache in enumerate(caches["prefix"]):
        layers[i] = cross(cache)
    for j, stacked in enumerate(caches["body"]):
        for r in range(cfg.n_periods):
            layers[cfg.dense_prefix + r * cfg.period + j] = cross(stacked, r)
    if any(c is None for c in layers):
        raise ValueError(f"caches_from_jax: the tree does not hold the {cfg.n_layers} "
                         f"layers' caches of {cfg.name}")
    return {"layers": layers}
