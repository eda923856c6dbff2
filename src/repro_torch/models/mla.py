"""Multi-head latent attention: the configuration and cache types of
`repro/models/mla.py`, so that every config imports. Its compute (the
low-rank projections and the absorbed decode) is the next slice of the
port (ROADMAP.md Queue 1 item 7)."""
from __future__ import annotations

from typing import NamedTuple

import torch


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
    pos: int
