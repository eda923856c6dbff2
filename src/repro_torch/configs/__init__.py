"""Assigned-architecture registry, the port of `repro/configs/`: one module
per arch exposing CONFIG (full width), SMOKE (reduced, CPU-runnable) and
META (per-shape microbatching, long_500k applicability, notes), with torch
dtypes.

Shapes: every LM arch pairs with all four; decode/long run the decode
step, train_4k the train step, prefill_32k the prefill step.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

ARCHS = [
    "deepseek_7b",
    "internlm2_1_8b",
    "phi3_medium_14b",
    "qwen2_5_14b",
    "musicgen_large",
    "mamba2_130m",
    "jamba_v0_1_52b",
    "mixtral_8x7b",
    "deepseek_v3_671b",
    "internvl2_26b",
]

# public ids -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "deepseek-7b": "deepseek_7b",
    "internlm2-1.8b": "internlm2_1_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2.5-14b": "qwen2_5_14b",
    "musicgen-large": "musicgen_large",
    "mamba2-130m": "mamba2_130m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "internvl2-26b": "internvl2_26b",
})

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


@dataclasses.dataclass(frozen=True)
class ArchMeta:
    params_b: float                      # approx parameter count (billions)
    active_params_b: float               # activated params (MoE) else == params_b
    train_microbatch: int = 1            # grad-accum steps for train_4k
    long_500k: bool = False              # sub-quadratic decode applicable?
    long_500k_note: str = ""
    notes: str = ""


def _mod(name: str):
    key = ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str, smoke: bool = False):
    m = _mod(name)
    return m.SMOKE if smoke else m.CONFIG


def get_meta(name: str) -> ArchMeta:
    return _mod(name).META


def input_specs(cfg, shape_name: str, shape: dict = None) -> dict:
    """Stand-ins for the model inputs of a shape cell: tensors on the meta
    device, which carry a shape and a dtype and allocate nothing (the
    counterpart of `jax.ShapeDtypeStruct`). `shape` replaces the cell's
    entry of SHAPES (a batch or sequence override)."""
    sh = SHAPES[shape_name] if shape is None else shape
    B, S = sh["global_batch"], sh["seq_len"]

    def tok(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    if sh["kind"] in ("train", "prefill"):
        if cfg.frontend == "codebooks":
            return {"tokens": tok(B, S, cfg.n_codebooks)}
        if cfg.frontend == "patches":
            P = cfg.vision_tokens
            return {"tokens": tok(B, S - P),
                    "patch_embeds": torch.empty((B, P, cfg.d_model), dtype=cfg.dtype,
                                                device="meta")}
        return {"tokens": tok(B, S)}
    # decode: one new token against a cache of S
    if cfg.frontend == "codebooks":
        return {"tokens": tok(B, cfg.n_codebooks)}
    return {"tokens": tok(B)}
