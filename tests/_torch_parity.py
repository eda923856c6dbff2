"""Shared helpers of the port's parity tests (tests/test_torch_*.py): one
numpy problem, made from a seed, handed to both packages in one process."""
import numpy as np
import torch

from repro_torch.data.synthetic import make_regression_numpy


def problem(n, p, seed=0, k_true=5):
    """(X, y) float64 numpy arrays of the shared synthetic regression."""
    X, y, _ = make_regression_numpy(n, p, k_true=min(k_true, p), seed=seed)
    return X, y


def cpu(*arrays, dtype=torch.float64):
    """numpy arrays -> CPU tensors of `dtype` (one tensor for one array)."""
    out = tuple(torch.tensor(np.asarray(a), dtype=dtype) for a in arrays)
    return out[0] if len(out) == 1 else out


def npy(x):
    """A JAX array or a tensor as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x, dtype=np.float64)
