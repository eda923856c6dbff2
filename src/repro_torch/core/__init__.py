"""The paper's reduction and the constrained SVEN engine, in PyTorch."""
from repro_torch.core import elastic_net
from repro_torch.core.reduction import (
    LAMBDA2_FLOOR,
    SvenOperator,
    build_svm_dataset,
    gram_blocks,
    gram_reference,
    recover_beta,
    svm_C,
)
from repro_torch.core.sven import (
    SvenConfig,
    SvenSolution,
    sven,
    sven_path,
    sven_path_reference,
)

__all__ = [
    "LAMBDA2_FLOOR",
    "SvenConfig",
    "SvenOperator",
    "SvenSolution",
    "build_svm_dataset",
    "elastic_net",
    "gram_blocks",
    "gram_reference",
    "recover_beta",
    "sven",
    "sven_path",
    "sven_path_reference",
    "svm_C",
]
