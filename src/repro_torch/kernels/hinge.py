"""Wrappers of the hand-written CUDA hinge Hessian kernels (primal Newton-CG).

`csrc/hinge.cu` holds the two passes of H v = v + 2C Xhat^T(act . (Xhat v)):

  pass 1 (`hinge_xtv_cuda`) replaces `repro/kernels/hinge.py::_xtv_kernel`:
      c = X^T v, byv = y.v/t, d = act_top (c - byv) + act_bot (c + byv), and
      one partial of e = sum(u_b - u_t) per block of 128 columns.
  pass 2 (`hinge_xd_cuda`) replaces `repro/kernels/hinge.py::_xd_kernel`:
      H v = v + 2C (X d + (y/t) e), with e summed from the partials.

X is float32 or bfloat16 storage, with every other operand and every sum
float32, or float64, with every other operand and every sum float64 (the
kernels' float64 mode, which a float64 problem runs at precision "f32").
Each wrapper counts its launches in `<wrapper>.launches` (a plain integer;
callers reset it). The source says what bounds each pass and how it is laid
out. Pass 2 cuts wide rows into column chunks: its wrapper allocates the
per-chunk partials for each call, and keeps one zeroed int32 ticket buffer
per device and size, which every launch leaves at zero again. Launches that
share a buffer must therefore be ordered on one stream, as the solver's are.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ptr, _int, _double = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: X's dtype -> the kernels' mode
_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_X_DTYPES = tuple(_MODES)


def _operand_dtype(X: torch.Tensor) -> torch.dtype:
    """The dtype of every operand but X, and of every result: float64 for
    float64 X, else float32."""
    return torch.float64 if X.dtype == torch.float64 else torch.float32


def _lib():
    lib = _build.load("hinge")
    if not getattr(lib, "_typed", False):
        lib.sven_hinge_xtv.argtypes = [_ptr, _int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                                       _int, _int, _double, _ptr]
        lib.sven_hinge_xtv.restype = _int
        lib.sven_hinge_xd.argtypes = [_ptr, _int, _ptr, _ptr, _int, _ptr, _ptr, _ptr,
                                      _ptr, _ptr, _int, _int, _double, _double, _ptr]
        lib.sven_hinge_xd.restype = _int
        for fn in (lib.sven_hinge_xtv_blocks, lib.sven_hinge_xd_rows,
                   lib.sven_hinge_xd_chunks):
            fn.argtypes = [_int]
            fn.restype = _int
        lib._typed = True
    return lib


#: (device, row groups) -> the int32 ticket counters of pass 2, all zero
#: between launches
_TICKETS = {}


def _tickets(device: torch.device, groups: int) -> torch.Tensor:
    buf = _TICKETS.get((device, groups))
    if buf is None:
        buf = _TICKETS[(device, groups)] = torch.zeros(groups, dtype=torch.int32,
                                                       device=device)
    return buf


def hinge_xtv_cuda(X: torch.Tensor, y: torch.Tensor, v: torch.Tensor, t: float,
                   act_top: torch.Tensor, act_bot: torch.Tensor):
    """Pass 1: returns (d (p,), e_part (k,)) with e = e_part.sum(), float64
    for float64 X and float32 otherwise.

    X (n, p) float32, bfloat16 or float64; y, v (n,) and act_top, act_bot
    (p,) float64 with float64 X, else float32; all contiguous on one CUDA
    device. Nothing is cast: another dtype raises.
    """
    fn = "hinge_xtv_cuda"
    n, p = _build.check_matrix(fn, X, _X_DTYPES)
    acc = _operand_dtype(X)
    for name, x, shape in (("y", y, (n,)), ("v", v, (n,)),
                           ("act_top", act_top, (p,)), ("act_bot", act_bot, (p,))):
        _build.check_operand(fn, name, x, shape, (acc,), X.device)
    lib = _lib()
    d = torch.empty(p, dtype=acc, device=X.device)
    e_part = torch.empty(lib.sven_hinge_xtv_blocks(p), dtype=acc, device=X.device)
    with torch.cuda.device(X.device):
        err = lib.sven_hinge_xtv(X.data_ptr(), _MODES[X.dtype],
                                 v.data_ptr(), y.data_ptr(), act_top.data_ptr(),
                                 act_bot.data_ptr(), d.data_ptr(), e_part.data_ptr(),
                                 n, p, 1.0 / float(t),
                                 torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    hinge_xtv_cuda.launches += 1
    return d, e_part


def hinge_xd_cuda(X: torch.Tensor, y: torch.Tensor, d: torch.Tensor,
                  e_part: torch.Tensor, v: torch.Tensor, t: float, C: float
                  ) -> torch.Tensor:
    """Pass 2: H v = v + 2C (X d + (y/t) e) with e = sum(e_part), (n,) in
    the operands' dtype.

    X as for pass 1; d (p,), e_part (k,), y, v (n,) of pass 1's operand
    dtype, on the same device.
    """
    fn = "hinge_xd_cuda"
    n, p = _build.check_matrix(fn, X, _X_DTYPES)
    if not (isinstance(e_part, torch.Tensor) and e_part.dim() == 1
            and e_part.numel() > 0):
        raise ValueError(f"{fn}: e_part must be a non-empty 1-D tensor")
    acc = _operand_dtype(X)
    for name, x, shape in (("y", y, (n,)), ("v", v, (n,)), ("d", d, (p,)),
                           ("e_part", e_part, tuple(e_part.shape))):
        _build.check_operand(fn, name, x, shape, (acc,), X.device)
    lib = _lib()
    hv = torch.empty(n, dtype=acc, device=X.device)
    chunks = lib.sven_hinge_xd_chunks(p)
    part = ticket = None
    if chunks > 1:
        part = torch.empty((n, chunks), dtype=acc, device=X.device)
        ticket = _tickets(X.device, -(-n // lib.sven_hinge_xd_rows(p)))
    with torch.cuda.device(X.device):
        err = lib.sven_hinge_xd(X.data_ptr(), _MODES[X.dtype],
                                d.data_ptr(), e_part.data_ptr(), e_part.numel(),
                                y.data_ptr(), v.data_ptr(), hv.data_ptr(),
                                None if part is None else part.data_ptr(),
                                None if ticket is None else ticket.data_ptr(),
                                n, p, 1.0 / float(t), 2.0 * float(C),
                                torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    hinge_xd_cuda.launches += 1
    return hv


hinge_xtv_cuda.launches = 0
hinge_xd_cuda.launches = 0
