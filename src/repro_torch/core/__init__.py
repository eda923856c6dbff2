"""The paper's reduction, the constrained SVEN engine and its batched
solves, gap-safe screening, the glmnet-parity penalized front end and its
batched cross-validation, the row-sharded solves over a process group and
the cost-model router, in PyTorch."""
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
from repro_torch.core.distributed import sharded_gram_stats, sharded_hinge_stats, sven_sharded
from repro_torch.core.routing import (
    Calibration,
    RouteDecision,
    calibrate,
    clear_calibration,
    route_batch,
    route_solve,
    sven_routed,
)
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
    # data-parallel sharded solve path (core/distributed.py)
    "sven_sharded",
    "sharded_gram_stats",
    "sharded_hinge_stats",
    # cost-model layout routing (core/routing.py)
    "sven_routed",
    "route_solve",
    "route_batch",
    "calibrate",
    "clear_calibration",
    "Calibration",
    "RouteDecision",
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
