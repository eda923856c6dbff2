"""Build the CUDA kernels from the package's sources, at first use, and
check the operands handed to them.

Each `csrc/*.cu` is compiled by `nvcc` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), all files
at once in parallel, and loaded with `ctypes`. The libraries go to
`build/kernels/` at the root of the checkout (listed in `.gitignore`), named
by a hash of the source and the flags, so an edited source is rebuilt and
an unchanged one is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register/shared-memory report) of each source built
#: in this process, and how long the last build took (None: nothing built).
build_log: Dict[str, str] = {}
build_seconds: Optional[float] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME); the "
                           "CUDA kernels are built from source at first use")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel; return
    {source stem: library path}. Raises with nvcc's output on a failure."""
    global build_seconds
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for stem, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[stem] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    if procs:
        build_seconds = time.perf_counter() - t0
    return {stem: out for stem, (_, out) in targets.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<stem>.cu` (built on first use)."""
    if stem not in _LIBS:
        path = build_all()[stem]
        _LIBS[stem] = ctypes.CDLL(str(path))
    return _LIBS[stem]


def check_operand(fn: str, name: str, x, shape: Tuple[int, ...],
                  dtypes: Tuple[torch.dtype, ...], device: torch.device) -> None:
    """Raise unless `x` is a contiguous tensor of `shape`, one of `dtypes`,
    on `device`: the wrappers check every operand before a launch."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{fn}: {name} is on {x.device}, X on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{fn}: {name} is {x.dtype}, expected one of {dtypes}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def check_matrix(fn: str, X, dtypes: Tuple[torch.dtype, ...]) -> Tuple[int, int]:
    """Raise unless X is a contiguous 2-D CUDA tensor of one of `dtypes`;
    return its shape (n, p)."""
    if not (isinstance(X, torch.Tensor) and X.is_cuda):
        raise ValueError(f"{fn}: X must be a CUDA tensor")
    if X.dim() != 2:
        raise ValueError(f"{fn}: X must be 2-D, got {tuple(X.shape)}")
    check_operand(fn, "X", X, tuple(X.shape), dtypes, X.device)
    return X.shape
