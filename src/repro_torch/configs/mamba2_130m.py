"""mamba2-130m [ssm]: 24L d_model=768, attention-free, ssm_state=128,
vocab=50280 — SSD state-space duality [arXiv:2405.21060]. Pure Mamba blocks:
no MLP (mlp_pattern = "none"); d_inner = 2*768, head_dim 64 -> 24 SSD heads."""
import torch

from repro_torch.configs import ArchMeta
from repro_torch.models.model import ModelConfig
from repro_torch.models.ssm import SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    d_model=768, n_layers=24, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    mixer_pattern=("ssm",), mlp_pattern=("none",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    d_model=64, n_layers=2, n_heads=1, n_kv_heads=1, head_dim=16,
    d_ff=0, vocab_size=256,
    mixer_pattern=("ssm",), mlp_pattern=("none",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=32),
    dtype=torch.float32, param_dtype=torch.float32,
)

META = ArchMeta(params_b=0.13, active_params_b=0.13,
                long_500k=True,
                long_500k_note="SSM: O(1) state decode — long_500k RUNS")
