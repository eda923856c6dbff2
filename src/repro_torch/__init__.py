"""SVEN in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch/CUDA counterpart of the JAX package `repro`: the same module
names, the same solvers and the same results, checked against `repro` by
`tests/test_torch_*.py`. This package imports `torch` and numpy only.

Entry points run on the CUDA device unless the caller hands them CPU
tensors or `device="cpu"`; with no CUDA device and no device named they
raise (`repro_torch.device.default_device`).
"""
from repro_torch.device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
