"""Wrapper of the hand-written CUDA hinge-stats kernel (Newton outer step).

`csrc/hinge_stats.cu` replaces `repro/kernels/hinge_stats.py::_stats_kernel`
(and its Pallas-Triton twin `repro/kernels/hinge_stats_gpu.py::
_stats_gpu_kernel`): in one pass over X it computes a = X^T w and
byw = y.w/t, then margins, gradient halves and per-block loss partials of the
implicit SVEN dataset. A wide X is one launch; a tall one is cut into row
chunks whose partials a second launch sums in a fixed order before the
epilogue (`split_rows`). `hinge_stats_cuda.launches` counts the wrapper's
calls that launched (a plain integer; callers reset it). The source says
what bounds the kernel and how it is laid out.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ptr, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_X_DTYPES = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)
#: fewest rows a chunk gets when X is cut (32 per warp of a block)
MIN_ROWS = 256


def _lib():
    lib = _build.load("hinge_stats")
    if not getattr(lib, "_typed", False):
        lib.sven_hinge_stats.argtypes = [_ptr, _int, _ptr, _ptr, _int, _int, _int, _int,
                                         _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                                         _float, _float, _ptr]
        lib.sven_hinge_stats.restype = _int
        lib.sven_hinge_stats_loss_parts.argtypes = [_int, _int]
        lib.sven_hinge_stats_loss_parts.restype = _int
        lib.sven_hinge_stats_cols.restype = _int
        lib._typed = True
    return lib


def split_rows(n: int, p: int, sm_count: int, cols: int):
    """(rows_per_chunk, nchunk) for blocks of `cols` columns: one chunk when
    the column blocks alone give two per SM; else enough chunks for about
    four blocks per SM, each of at least MIN_ROWS rows (a multiple of 32)."""
    colblocks = -(-p // cols)
    if colblocks >= 2 * sm_count:
        return n, 1
    want = -(-4 * sm_count // colblocks)
    rows = max(MIN_ROWS, -(-n // want))
    rows = -(-rows // 32) * 32
    if rows >= n:
        return n, 1
    return rows, -(-n // rows)


def hinge_stats_cuda(X: torch.Tensor, y: torch.Tensor, t: float, w: torch.Tensor,
                     C: float):
    """Returns (m_top, m_bot, g_top, g_bot, loss_part), float32: four (p,)
    vectors and the per-block partials of C sum(xi^2) (loss = 0.5 w.w +
    loss_part.sum()).

    X (n, p) float32 or bfloat16; y, w (n,) float32; all contiguous on one
    CUDA device. Launches on the current stream; raises on a wrong operand
    or a refused launch.
    """
    fn = "hinge_stats_cuda"
    n, p = _build.check_matrix(fn, X, _X_DTYPES)
    if n == 0 or p == 0:
        raise ValueError(f"{fn}: X must not be empty, got {tuple(X.shape)}")
    for name, x in (("y", y), ("w", w)):
        _build.check_operand(fn, name, x, (n,), _F32, X.device)
    lib = _lib()
    dev = X.device
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rows, nchunk = split_rows(n, p, sms, lib.sven_hinge_stats_cols())
        out = torch.empty((4, p), dtype=torch.float32, device=dev)
        loss_part = torch.empty(lib.sven_hinge_stats_loss_parts(p, nchunk),
                                dtype=torch.float32, device=dev)
        a_part = yw_part = None
        if nchunk > 1:
            a_part = torch.empty((nchunk, p), dtype=torch.float32, device=dev)
            yw_part = torch.empty(nchunk, dtype=torch.float32, device=dev)
        mt, mb, gt, gb = out.unbind(0)
        err = lib.sven_hinge_stats(
            X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(), y.data_ptr(),
            n, p, rows, nchunk, None if a_part is None else a_part.data_ptr(),
            None if yw_part is None else yw_part.data_ptr(), mt.data_ptr(),
            mb.data_ptr(), gt.data_ptr(), gb.data_ptr(), loss_part.data_ptr(),
            1.0 / float(t), float(C), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    hinge_stats_cuda.launches += 1
    return mt, mb, gt, gb, loss_part


hinge_stats_cuda.launches = 0
