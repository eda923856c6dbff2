"""musicgen-large [audio]: 48L d_model=2048 32H (MHA) d_ff=8192 vocab=2048 —
decoder-only over EnCodec tokens [arXiv:2306.05284]. Modality frontend is a
STUB per assignment: inputs are 4 parallel EnCodec codebook token streams
(delay pattern applied upstream); embeddings are summed, one head per
codebook."""
import torch

from repro_torch.configs import ArchMeta
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    d_model=2048, n_layers=48, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, rope_theta=1e4,
    frontend="codebooks", n_codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64, rope_theta=1e4,
    frontend="codebooks", n_codebooks=4,
    dtype=torch.float32, param_dtype=torch.float32,
)

META = ArchMeta(params_b=3.3, active_params_b=3.3, train_microbatch=4, long_500k=False,
                long_500k_note="pure full attention — skipped")
