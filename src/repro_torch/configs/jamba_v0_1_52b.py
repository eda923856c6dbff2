"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE every other layer
[arXiv:2403.19887].

Period-8 block: attention at position 3 (1 attn : 7 mamba), MoE on odd layers.
DESIGN.md note: Jamba's SSM layers are Mamba-1 (S6); we realize them with the
Mamba-2 SSD form (d_state 16 as in the paper) — same state size and
interleave, TPU-friendlier compute."""
import torch

from repro_torch.configs import ArchMeta
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    mixer_pattern=("ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm", "ssm"),
    mlp_pattern=("dense", "moe"),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
    rules_override={"fsdp": "data"},
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    d_model=64, n_layers=8, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    mixer_pattern=("ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm", "ssm"),
    mlp_pattern=("dense", "moe"),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, capacity_factor=8.0),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=32),
    dtype=torch.float32, param_dtype=torch.float32,
)

META = ArchMeta(params_b=52.0, active_params_b=12.0, train_microbatch=16,
                long_500k=True,
                long_500k_note="hybrid: SSM state + 4 attn layers' 524k KV "
                               "(seq-sharded) — long_500k RUNS")
