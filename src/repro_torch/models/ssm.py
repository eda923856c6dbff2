"""Mamba-2 (SSD): the configuration and cache types of
`repro/models/ssm.py`, so that every config imports. Its compute (the
chunked SSD scan and the decode recurrence) is the next slice of the port
(ROADMAP.md Queue 1 item 7)."""
from __future__ import annotations

from typing import NamedTuple

import torch


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
