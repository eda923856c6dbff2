"""The paper's reduction, the constrained SVEN engine and its batched
solves, gap-safe screening, the glmnet-parity penalized front end and its
batched cross-validation, in PyTorch."""
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
    SvenBatchSolution,
    SvenConfig,
    SvenSolution,
    sven,
    sven_path,
    sven_path_reference,
    sven_path_solutions,
)
from repro_torch.core.batch import cv_folds, en_grid, sven_batch
from repro_torch.core.screening import ScreenResult, gap_safe_screen, sven_with_screening
from repro_torch.core.api import (
    ElasticNet,
    EnetCarry,
    EnetPath,
    EnetPoint,
    EnetResult,
    PathConfig,
    Scaler,
    cold_carry,
    enet,
    enet_batch,
    enet_path,
    lambda_grid,
    penalized_from_glmnet,
    penalized_from_sklearn,
    penalized_to_glmnet,
    resolve_path_config,
    standardize_fit,
    unscale_coef,
)
from repro_torch.core.cv import CVResult, ElasticNetCV, cross_validate, cross_validate_reference

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
    "sven_path_solutions",
    "svm_C",
    # batched solves (core/batch.py)
    "SvenBatchSolution",
    "cv_folds",
    "en_grid",
    "sven_batch",
    # screening (core/screening.py)
    "ScreenResult",
    "gap_safe_screen",
    "sven_with_screening",
    # penalized front end (core/api.py)
    "ElasticNet",
    "EnetCarry",
    "EnetPath",
    "EnetPoint",
    "EnetResult",
    "PathConfig",
    "Scaler",
    "cold_carry",
    "enet",
    "enet_batch",
    "enet_path",
    "lambda_grid",
    "penalized_from_glmnet",
    "penalized_from_sklearn",
    "penalized_to_glmnet",
    "resolve_path_config",
    "standardize_fit",
    "unscale_coef",
    # batched cross-validation (core/cv.py)
    "CVResult",
    "ElasticNetCV",
    "cross_validate",
    "cross_validate_reference",
]
