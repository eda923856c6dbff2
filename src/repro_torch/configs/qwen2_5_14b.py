"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias [hf:Qwen/Qwen2.5]."""
import torch

from repro_torch.configs import ArchMeta
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    d_model=5120, n_layers=48, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, rope_theta=1e6, qkv_bias=True,
    rules_override={"fsdp": "data"},
)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, rope_theta=1e6, qkv_bias=True,
    dtype=torch.float32, param_dtype=torch.float32,
)

META = ArchMeta(params_b=14.8, active_params_b=14.8, train_microbatch=8,
                long_500k=False, long_500k_note="pure full attention — skipped")
