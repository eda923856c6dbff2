"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
8 experts top-2, sliding-window attention (W=4096) [arXiv:2401.04088].

8 experts < 16-way model axis: EP would pad 2x, so experts map to TP-within-
expert instead (rules_override: experts->None, expert_ffn->model). SWA makes
long_500k decode sub-quadratic (rolling 4096 KV buffer) — it RUNS."""
import torch

from repro_torch.configs import ArchMeta
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, rope_theta=1e6, swa_window=4096,
    mixer_pattern=("attn",), mlp_pattern=("moe",),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    rules_override={"experts": None, "expert_ffn": "model", "fsdp": "data"},
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, rope_theta=1e6, swa_window=64,
    mixer_pattern=("attn",), mlp_pattern=("moe",),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, capacity_factor=8.0),
    dtype=torch.float32, param_dtype=torch.float32,
)

META = ArchMeta(params_b=46.7, active_params_b=12.9, train_microbatch=8,
                long_500k=True,
                long_500k_note="SWA rolling KV (W=4096): decode state is O(W) "
                               "not O(S) — long_500k RUNS")
