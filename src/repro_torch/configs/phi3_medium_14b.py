"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA [arXiv:2404.14219]. 40 heads / 10 kv heads are
not 16-divisible: GSPMD pads the head dim on the 16-way model axis (noted in
EXPERIMENTS.md roofline as padding overhead)."""
import torch

from repro_torch.configs import ArchMeta
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    d_model=5120, n_layers=40, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100352, rope_theta=1e4,
    rules_override={"fsdp": "data"},
)

SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke",
    d_model=80, n_layers=2, n_heads=5, n_kv_heads=5, head_dim=16,
    d_ff=160, vocab_size=256, rope_theta=1e4,
    dtype=torch.float32, param_dtype=torch.float32,
)

META = ArchMeta(params_b=14.0, active_params_b=14.0, train_microbatch=8,
                long_500k=False, long_500k_note="pure full attention — skipped")
