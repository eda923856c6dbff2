"""Wrapper of the hand-written CUDA fused shifted-Gram kernel.

The kernel (`csrc/gram.cu`) replaces the Pallas TPU kernel
`repro/kernels/gram.py::_gram_kernel` (and its Pallas-Triton twin
`repro/kernels/gram_gpu.py::_gram_gpu_kernel`): K = Zhat^T Zhat of the SVEN
dual, from the original (n, p) X, in one pass over X. Each mode has its own
partial kernel and one epilogue sums the partials in a fixed order:

- float64 operands at precision "f32" (mode 3) sum in float64 on the FP64
  tensor cores, bound by the bytes of X (0.101 ms at the YMSD shape on an
  H100);
- "tf32" (mode 1) and "bf16" (mode 2) take their products on the TF32 and
  BF16 tensor cores (`mma.sync`) with float32 sums, bound by the bytes of X
  (0.050 and 0.025 ms), from stages of rows copied flat by the copy engine;
- float32 operands at "f32" (mode 0) sum exact float32 FMAs in 8 x 8
  register tiles on the same staging, each stage repacked for 16-byte
  shared loads, bound by the FP32 rate (0.058 ms).

All four take 96-column tile pairs, one block per SM in one wave. The
source says how each is laid out. `shifted_gram_cuda.launches` counts the
launches (a plain integer; callers reset it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_MODES = {"f32": 0, "tf32": 1, "bf16": 2}
_F64_MODE = 3
#: the operand dtypes each precision takes; nothing is cast here
_DTYPES = {"f32": (torch.float32, torch.float64), "tf32": (torch.float32,),
           "bf16": (torch.bfloat16,)}
_ptr, _int, _double = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of `csrc/gram.cu`) with its functions' C types set."""
    if not getattr(lib, "_typed", False):
        lib.sven_gram.argtypes = [_ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int,
                                  _double, _int, _int, _ptr]
        lib.sven_gram.restype = _int
        for fn in ("sven_gram_tile_tc", "sven_gram_rows_step_tc", "sven_gram_tile_f64",
                   "sven_gram_rows_step_f64"):
            getattr(lib, fn).restype = _int
        lib.sven_gram_rows_step_tc.argtypes = [_int]
        lib.sven_gram_f64_probe.argtypes = [_ptr, _ptr, _ptr]
        lib.sven_gram_f64_probe.restype = _int
        lib.sven_gram_tc_probe.argtypes = [_ptr, _ptr, _int, _ptr]
        lib.sven_gram_tc_probe.restype = _int
        lib._typed = True
    return lib


def _lib() -> ctypes.CDLL:
    return _typed(_build.load("gram"))


def _pairs(p: int, tile: int) -> int:
    """Tile pairs (ti <= tj) that cover the upper triangle of A^T A."""
    nt = -(-(p + 1) // tile)
    return nt * (nt + 1) // 2


def split_rows_wave(n: int, p: int, sm_count: int, tile: int, step: int):
    """(rows_per_split, nsplit) of every body, each of which runs one block
    per SM: tile pairs x splits fit one wave of `sm_count` blocks (one split
    when the pairs alone outnumber the SMs), each split a whole number of
    the body's `step`-row stages."""
    want = max(1, min(-(-n // step), sm_count // _pairs(p, tile), 65535))
    rows = -(-(-(-n // want)) // step) * step
    return rows, -(-n // rows)


def shifted_gram_cuda(X: torch.Tensor, y: torch.Tensor, t: float, *,
                      precision: str = "f32", flatten: bool = True) -> torch.Tensor:
    """K = Zhat^T Zhat, (2p, 2p) if `flatten` else (2, 2, p, p).

    X (n, p) and y (n,) share one dtype: float32 or float64 for precision
    "f32", float32 for "tf32", bfloat16 for "bf16"; contiguous, on one CUDA
    device. K is float64 for float64 operands (summed in float64) and
    float32 otherwise. Launches on the current stream; raises on a wrong
    operand or a refused launch.
    """
    K = _launch(X, y, t, precision, flatten)
    shifted_gram_cuda.launches += 1
    return K


def _launch(X: torch.Tensor, y: torch.Tensor, t: float, precision: str, flatten: bool,
            lib: ctypes.CDLL = None) -> torch.Tensor:
    """`shifted_gram_cuda`, not counted, through `lib`: a typed build of
    `csrc/gram.cu` (another commit's, to compare with), else this
    package's."""
    if precision not in _MODES:
        raise ValueError(f"shifted_gram_cuda: precision must be one of "
                         f"{tuple(_MODES)}, got {precision!r}")
    n, p = _build.check_matrix("shifted_gram_cuda", X, _DTYPES[precision])
    _build.check_operand("shifted_gram_cuda", "y", y, (n,), (X.dtype,), X.device)
    f64 = X.dtype == torch.float64
    acc = torch.float64 if f64 else torch.float32
    lib = _lib() if lib is None else lib
    with torch.cuda.device(X.device):
        sms = torch.cuda.get_device_properties(X.device).multi_processor_count
        mode = _F64_MODE if f64 else _MODES[precision]
        if f64:
            rows, nsplit = split_rows_wave(n, p, sms, lib.sven_gram_tile_f64(),
                                           lib.sven_gram_rows_step_f64())
        else:
            rows, nsplit = split_rows_wave(n, p, sms, lib.sven_gram_tile_tc(),
                                           lib.sven_gram_rows_step_tc(mode))
        q = p + 1
        part = torch.empty((nsplit, q, q), dtype=acc, device=X.device)
        shape = (2 * p, 2 * p) if flatten else (2, 2, p, p)
        K = torch.empty(shape, dtype=acc, device=X.device)
        err = lib.sven_gram(X.data_ptr(), y.data_ptr(), part.data_ptr(), K.data_ptr(),
                            n, p, rows, nsplit, float(t), int(flatten), mode,
                            torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shifted_gram_cuda: launch failed with CUDA error {err}")
    return K


shifted_gram_cuda.launches = 0


def f64_mma_probe(S: torch.Tensor) -> torch.Tensor:
    """The float64 body's fragment loads, FP64 tensor-core products and
    stores on one 4 x 64 float64 S (CUDA): D (64 x 64) holds S^T S at the
    entries i <= j of its first 32 rows and zeros elsewhere. Not a launch
    of the Gram (not counted)."""
    _build.check_operand("f64_mma_probe", "S", S, (4, 64), (torch.float64,), S.device)
    D = torch.zeros((64, 64), dtype=torch.float64, device=S.device)
    with torch.cuda.device(S.device):
        err = _lib().sven_gram_f64_probe(S.data_ptr(), D.data_ptr(),
                                         torch.cuda.current_stream(S.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"f64_mma_probe: launch failed with CUDA error {err}")
    return D


def tc_mma_probe(S: torch.Tensor) -> torch.Tensor:
    """The tf32 and bf16 bodies' fragment loads, tensor-core products and
    stores on one step of rows: S (8, 192) float32 (tf32 products of its
    TF32-rounded entries) or (16, 192) bfloat16, on CUDA, staged as an
    off-diagonal pair of 96-column tiles. D (192, 192) float32 holds S^T S at
    the entries i <= j of its first 96 rows (a diagonal pair's step, then
    both halves of an off-diagonal pair's) and zeros elsewhere. Not a launch
    of the Gram (not counted)."""
    rows, mode = {torch.float32: (8, 1), torch.bfloat16: (16, 2)}.get(S.dtype, (0, 0))
    _build.check_operand("tc_mma_probe", "S", S, (rows, 192),
                         (torch.float32, torch.bfloat16), S.device)
    D = torch.zeros((192, 192), dtype=torch.float32, device=S.device)
    with torch.cuda.device(S.device):
        err = _lib().sven_gram_tc_probe(S.data_ptr(), D.data_ptr(), mode,
                                        torch.cuda.current_stream(S.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tc_mma_probe: launch failed with CUDA error {err}")
    return D
