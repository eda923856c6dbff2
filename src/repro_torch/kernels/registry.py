"""Per-backend kernel registry: which body computes a logical op.

Every logical op (`shifted_gram`, `hinge_xtv`, `hinge_xd`, their lane-batched
forms `hinge_xtv_lanes` and `hinge_xd_lanes`, `hinge_stats`) has two BODIES:

    "cuda"  the hand-written CUDA kernel (kernels/gram.py, hinge.py,
            hinge_stats.py)
    "ref"   the plain PyTorch version (kernels/ref.py)

The body is chosen from the operands' device: tensors on a CUDA device get
"cuda", tensors on the CPU get "ref". An explicit backend always wins. Unlike
`repro/kernels/registry.py`, nothing falls back: a missing body, operands on
different devices, or a device with no body raise.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import default_device

#: the kernel bodies a logical op may register
BODIES = ("cuda", "ref")

#: device type -> body (the "auto" rule)
_DEVICE_BODY = {"cuda": "cuda", "cpu": "ref"}

_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def register(op: str, body: str):
    """Class the decorated callable as `op`'s kernel body for `body`."""
    if body not in BODIES:
        raise ValueError(f"register: body must be one of {BODIES}, got {body!r}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(op, body)] = fn
        return fn

    return deco


def lookup(op: str, body: str) -> Callable:
    """The callable registered for (op, body); raises if there is none."""
    if body not in BODIES:
        raise ValueError(f"lookup({op!r}): body must be one of {BODIES}, got {body!r}")
    try:
        return _REGISTRY[(op, body)]
    except KeyError:
        raise KeyError(f"no {body!r} body registered for op {op!r}; registered: "
                       f"{kernel_backends(op)}") from None


def kernel_backends(op: str) -> Tuple[str, ...]:
    """The bodies registered for `op` (subset of BODIES)."""
    return tuple(b for b in BODIES if (op, b) in _REGISTRY)


def resolve_kernel_backend(backend: Optional[str], *tensors) -> str:
    """Pin the body for a launch: an explicit body wins; None / "auto" take
    it from the device the tensor operands share (CUDA when there are none).
    Operands on different devices, or on a device with no body, raise."""
    if backend is not None and backend != "auto":
        if backend not in BODIES:
            raise ValueError(f"resolve_kernel_backend: unknown backend {backend!r} "
                             f"(expected one of {BODIES} or 'auto')")
        return backend
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError("resolve_kernel_backend: operands lie on different "
                         f"devices {sorted(map(str, devices))}")
    dev = devices.pop() if devices else default_device()
    if dev.type not in _DEVICE_BODY:
        raise ValueError(f"resolve_kernel_backend: no kernel body for device {dev}")
    return _DEVICE_BODY[dev.type]
