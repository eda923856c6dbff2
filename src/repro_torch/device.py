"""The port's device rule: run on CUDA unless told otherwise.

An entry point that is given tensors runs where they lie. One that is
given a device runs there. One that is given neither runs on the current
CUDA device, and raises when there is none: it never falls back to the
CPU on its own.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The current CUDA device; raises when CUDA is not available."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available and no device was given; "
            "pass device='cpu' (or CPU tensors) to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None, *tensors) -> torch.device:
    """`device` if given, else the device of the first tensor, else CUDA."""
    if device is not None:
        return torch.device(device)
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    return default_device()
