"""deepseek-7b [dense]: 30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954]."""
import torch

from repro_torch.configs import ArchMeta
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    d_model=4096, n_layers=30, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, rope_theta=1e4,
    dtype=torch.float32, param_dtype=torch.float32,
)

META = ArchMeta(params_b=6.9, active_params_b=6.9, train_microbatch=4,
                long_500k=False,
                long_500k_note="pure full attention: O(S) KV + O(S) score per "
                               "step is fine, but 500k full-softmax decode is "
                               "assigned only to sub-quadratic archs — skipped")
