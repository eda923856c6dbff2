"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 [arXiv:2403.17297]."""
import torch

from repro_torch.configs import ArchMeta
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    d_model=2048, n_layers=24, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internlm2-1.8b-smoke",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, rope_theta=1e6,
    dtype=torch.float32, param_dtype=torch.float32,
)

META = ArchMeta(params_b=1.8, active_params_b=1.8, train_microbatch=2, long_500k=False,
                long_500k_note="pure full attention — skipped")
