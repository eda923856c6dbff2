"""Mixture-of-Experts: the configuration type of `repro/models/moe.py`, so
that every config imports. Its compute (router, capacity-bounded dispatch,
expert FFNs) is the next slice of the port (ROADMAP.md Queue 1 item 7)."""
from __future__ import annotations

from typing import NamedTuple


class MoEConfig(NamedTuple):
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 14336
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
