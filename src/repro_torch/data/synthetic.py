"""Synthetic regression problems matched to the paper's regimes.

The numpy body is the JAX package's `data/synthetic.py::make_regression`,
copied so that the same seed gives the same problem in both packages; only
the return type differs (tensors on a chosen device).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def make_regression_numpy(n: int, p: int, *, k_true: int = 10, rho: float = 0.3,
                          noise: float = 0.1, seed: int = 0):
    """(X, y, beta_true) as float64 numpy arrays: AR(1)-correlated Gaussian
    design with standardized columns, k-sparse truth, centered response."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, p))
    if rho > 0:
        # AR(1) mixing along features via cumulative blend (cheap, full-rank)
        x = np.empty_like(z)
        x[:, 0] = z[:, 0]
        a = np.sqrt(1 - rho * rho)
        for j in range(1, p):
            x[:, j] = rho * x[:, j - 1] + a * z[:, j]
    else:
        x = z
    beta = np.zeros(p)
    idx = rng.choice(p, size=min(k_true, p), replace=False)
    beta[idx] = rng.standard_normal(len(idx)) * 2.0
    y = x @ beta + noise * rng.standard_normal(n)
    # standardize columns, center response (paper's preprocessing)
    x = (x - x.mean(0)) / (x.std(0) + 1e-12)
    y = y - y.mean()
    return x, y, beta


def make_regression(n: int, p: int, *, k_true: int = 10, rho: float = 0.3,
                    noise: float = 0.1, seed: int = 0,
                    dtype: torch.dtype = torch.float64,
                    device: DeviceLike = None):
    """`make_regression_numpy` as tensors of `dtype` on `device` (CUDA when
    no device is named). Returns (X, y, beta_true)."""
    dev = resolve_device(device)
    x, y, beta = make_regression_numpy(n, p, k_true=k_true, rho=rho,
                                       noise=noise, seed=seed)
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                 for a in (x, y, beta))
