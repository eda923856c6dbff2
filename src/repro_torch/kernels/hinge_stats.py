"""Wrapper of the hand-written CUDA hinge-stats kernel (Newton outer step).

`csrc/hinge_stats.cu` replaces `repro/kernels/hinge_stats.py::_stats_kernel`
(and its Pallas-Triton twin `repro/kernels/hinge_stats_gpu.py::
_stats_gpu_kernel`): in one pass over X it computes a = X^T w and
byw = y.w/t, then margins, gradient halves and loss partials of the
implicit SVEN dataset, in one launch on either of two routes (`plan`): a
tall X is cut into contiguous row ranges, one block per SM, whose partials
the last block to finish sums in a fixed order; a wide X is cut into
32-column blocks. The tall route keeps one zeroed int32 ticket per device,
which every launch leaves at zero again, so launches on one device must be
ordered on one stream. `hinge_stats_cuda.launches` counts the wrapper's
calls that launched (a plain integer; callers reset it). The source says
what bounds the kernel and how it is laid out.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_ptr, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_X_DTYPES = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)
#: widest p of the tall route (`kMaxP` of the source: 512 threads x 4 columns)
TALL_MAX_P = 2048
#: fewest rows a block of the tall route takes
MIN_ROWS = 256
#: columns per block of the wide route
WIDE_COLS = 32


def _lib():
    lib = _build.load("hinge_stats")
    if not getattr(lib, "_typed", False):
        lib.sven_hinge_stats.argtypes = [_ptr, _int, _ptr, _ptr, _int, _int, _int, _int,
                                         _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                                         _float, _float, _ptr]
        lib.sven_hinge_stats.restype = _int
        for fn in (lib.sven_hinge_stats_tall_max_p, lib.sven_hinge_stats_cols):
            fn.restype = _int
        if (lib.sven_hinge_stats_tall_max_p(), lib.sven_hinge_stats_cols()) != (
                TALL_MAX_P, WIDE_COLS):
            raise RuntimeError("hinge_stats: the library's route limits differ from "
                               "kernels/hinge_stats.py's")
        lib._typed = True
    return lib


def plan(n: int, p: int, sm_count: int) -> Optional[Tuple[int, int]]:
    """(blocks, rows_per_block) of the tall route, or None for the wide one.

    The tall route gives one block per SM at most (one wave), each a
    contiguous range of at least MIN_ROWS rows that together cover n, every
    block at least one row. It is taken when p <= TALL_MAX_P and it gives more
    blocks than the wide route's ceil(p / WIDE_COLS) column blocks."""
    blocks = min(sm_count, -(-n // MIN_ROWS))
    if p > TALL_MAX_P or blocks <= -(-p // WIDE_COLS):
        return None
    rows = -(-n // blocks)
    return -(-n // rows), rows


#: device -> the int32 ticket of the tall route, zero between launches
_TICKETS = {}


def _ticket(device: torch.device) -> torch.Tensor:
    buf = _TICKETS.get(device)
    if buf is None:
        buf = _TICKETS[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return buf


def hinge_stats_cuda(X: torch.Tensor, y: torch.Tensor, t: float, w: torch.Tensor,
                     C: float):
    """Returns (m_top, m_bot, g_top, g_bot, loss_part), float32: four (p,)
    vectors and the partials of C sum(xi^2) (loss = 0.5 w.w +
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
        tall = plan(n, p, torch.cuda.get_device_properties(dev).multi_processor_count)
        blocks, rows = tall or (0, 0)
        out = torch.empty((4, p), dtype=torch.float32, device=dev)
        loss_part = torch.empty(1 if tall else -(-p // WIDE_COLS), dtype=torch.float32,
                                device=dev)
        part = torch.empty((blocks, p + 1), dtype=torch.float32, device=dev) if tall else None
        ticket = _ticket(dev) if tall else None
        mt, mb, gt, gb = out.unbind(0)
        err = lib.sven_hinge_stats(
            X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(), y.data_ptr(),
            n, p, blocks, rows, None if part is None else part.data_ptr(),
            None if ticket is None else ticket.data_ptr(), mt.data_ptr(),
            mb.data_ptr(), gt.data_ptr(), gb.data_ptr(), loss_part.data_ptr(),
            1.0 / float(t), float(C), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    hinge_stats_cuda.launches += 1
    return mt, mb, gt, gb, loss_part


hinge_stats_cuda.launches = 0
