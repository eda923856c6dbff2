"""deepseek-v3-671b [moe]: 61L d_model=7168 128H MLA d_ff(expert)=2048
vocab=129280, 1 shared + 256 routed experts top-8, MTP [arXiv:2412.19437].

First 3 layers dense (d_ff 18432), remaining 58 MoE. MLA: q_lora 1536,
kv_lora 512, qk_nope 128, qk_rope 64, v 128. mtp_depth=1 adds the paper's
depth-1 multi-token-prediction module to train_step. Router here is softmax
top-k (V3's sigmoid + aux-free bias router approximated; DESIGN.md). Weights
2D-sharded (TP on model axis x FSDP on data axis) — required to fit 671B."""
import torch

from repro_torch.configs import ArchMeta
from repro_torch.models.mla import MLAConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    d_model=7168, n_layers=61, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=2048, vocab_size=129280, rope_theta=1e4,
    mixer_pattern=("mla",), mlp_pattern=("moe",),
    dense_prefix=3, d_ff_dense=18432,
    mla=MLAConfig(n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared=1, d_ff_shared=2048),
    mtp_depth=1,
    rules_override={"fsdp": "data", "expert_fsdp": "data"},
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke",
    d_model=64, n_layers=3, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=96, vocab_size=256,
    mixer_pattern=("mla",), mlp_pattern=("moe",),
    dense_prefix=1, d_ff_dense=128,
    mla=MLAConfig(n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96,
                  n_shared=1, d_ff_shared=96, capacity_factor=8.0),
    mtp_depth=1,
    dtype=torch.float32, param_dtype=torch.float32,
)

META = ArchMeta(params_b=671.0, active_params_b=37.0, train_microbatch=16,
                long_500k=False,
                long_500k_note="full (latent) attention — skipped; MLA cache "
                               "is 576B/token so 500k would fit, but scores "
                               "remain O(S) per step")
