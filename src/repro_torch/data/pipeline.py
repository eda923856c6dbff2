"""Token data pipeline: deterministic, shardable, resumable. The port of
`repro/data/pipeline.py`, drawing from the same numpy generators, so its
tokens and patch embeddings are JAX's bit for bit; each batch becomes
tensors on a device (CUDA unless another is named).

Sources: synthetic LM streams (seeded, infinite) and memory-mapped token
files. Determinism contract: batch content is a pure function of
(seed, step, host_shard) — so (a) restarts resume exactly (the step index is
in the checkpoint), (b) stragglers/failed hosts can be re-issued their shard
("skip-ahead": no data server handshake needed at 1000-node scale), and
(c) elastic rescale re-partitions by recomputing shard indices."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    n_codebooks: int = 0        # musicgen-style multi-stream tokens
    vision_tokens: int = 0      # internvl2-style prepended patch embeds
    d_model: int = 0            # for patch embeds


def _host_batch(cfg: DataConfig) -> int:
    if cfg.global_batch % cfg.n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split over "
                         f"{cfg.n_hosts} hosts")
    return cfg.global_batch // cfg.n_hosts


def synthetic_numpy(cfg: DataConfig, step: int) -> dict:
    """Pure function of (seed, step, host): a Zipf-ish token stream with
    local n-gram structure (so loss curves are non-trivial), as numpy
    arrays: int32 tokens, and float32 patch embeddings for
    `vision_tokens`."""
    rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 65_537 + cfg.host_id)
    B = _host_batch(cfg)
    shape = (B, cfg.seq_len, cfg.n_codebooks) if cfg.n_codebooks else (B, cfg.seq_len)
    # Zipf marginal via inverse-CDF on a power law
    u = rng.random(shape)
    toks = np.floor((cfg.vocab_size ** u - 1.0) / (cfg.vocab_size - 1) * cfg.vocab_size)
    toks = np.clip(toks.astype(np.int32), 0, cfg.vocab_size - 1)
    # local structure: every 4th token repeats its predecessor
    if cfg.n_codebooks == 0:
        toks[:, 3::4] = toks[:, 2::4]
    batch = {"tokens": toks}
    if cfg.vision_tokens:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def synthetic_batch(cfg: DataConfig, step: int, device: DeviceLike = None) -> dict:
    """`synthetic_numpy(cfg, step)` as tensors on `device`."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in synthetic_numpy(cfg, step).items()}


class SyntheticStream:
    """Iterator facade with explicit step state (resume = set .step)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.step = start_step
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = synthetic_batch(self.cfg, self.step, self.device)
        self.step += 1
        return b


class MemmapTokens:
    """Pre-tokenized corpus on disk: (N,) int32 memmap, sampled in windows.
    Window starts are a pure function of (seed, step, host) => deterministic
    and resumable, same contract as SyntheticStream."""

    def __init__(self, path: str, cfg: DataConfig, start_step: int = 0,
                 device: DeviceLike = None):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg = cfg
        self.step = start_step
        self.device = resolve_device(device)
        if len(self.tokens) <= cfg.seq_len + 1:
            raise ValueError(f"{path} holds {len(self.tokens)} tokens, too few for windows "
                             f"of {cfg.seq_len}")

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 7_368_787 + self.step) * 65_537 + cfg.host_id)
        B = _host_batch(cfg)
        starts = rng.integers(0, len(self.tokens) - cfg.seq_len - 1, size=B)
        toks = np.stack([self.tokens[s: s + cfg.seq_len] for s in starts])
        self.step += 1
        return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(self.device)}


def write_token_file(path: str, tokens: np.ndarray):
    np.asarray(tokens, np.int32).tofile(path)
