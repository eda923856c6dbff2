"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2-20B backbone [arXiv:2404.16821].

Per assignment the spec covers the LLM BACKBONE only; the InternViT frontend
is a STUB: input_specs provides 256 precomputed patch embeddings (B, 256,
d_model) prepended to the text tokens. Causal mask over the concatenated
sequence (simplification of prefix-LM masking; DESIGN.md)."""
import torch

from repro_torch.configs import ArchMeta
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    d_model=6144, n_layers=48, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553, rope_theta=1e6,
    frontend="patches", vision_tokens=256,
    rules_override={"fsdp": "data"},
)

SMOKE = ModelConfig(
    name="internvl2-26b-smoke",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, rope_theta=1e6,
    frontend="patches", vision_tokens=8,
    dtype=torch.float32, param_dtype=torch.float32,
)

META = ArchMeta(params_b=25.5, active_params_b=25.5, train_microbatch=8,
                long_500k=False, long_500k_note="pure full attention — skipped")
