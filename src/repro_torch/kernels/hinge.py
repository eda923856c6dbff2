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

`hinge_xtv_lanes_cuda` and `hinge_xd_lanes_cuda` launch each pass once for
a stack of B problems (the lane-batched solve of `core/batch.py`; the port
of the leading grid axis JAX's vmap gives the Pallas kernels): X and y
shared by every lane or stacked (lanes contiguous, possibly a gap apart,
as `core/svm/state.py::pitched` lays them out), every other operand
stacked, and 1/t and 2C per lane. `plan` picks the route: a stacked X (or
one lane) takes the stacked route, on which pass 1 is the single launch's
kernel with the lane on grid z and a block of pass 2 takes one lane's
chunk of d for many rows; a shared X with two or more lanes the shared-X
route, on which a block takes its columns or rows for a group of up to G
lanes and reads X once for the group. Either way each lane's results are
bitwise those of a single launch on that lane's operands. One
lane-batched launch counts as one launch.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_ptr, _int, _long, _double = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_double)
#: X's dtype -> the kernels' mode
_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_X_DTYPES = tuple(_MODES)
#: the lane-group sizes G of the shared-X route that `csrc/hinge.cu` builds
#: (`SharedG`), per pass and mode; the library refuses any other G. Pass 1
#: holds G x 2 accumulators a thread; pass 2 G x 8 (two rows), and stages G
#: chunks of d in shared memory (34.8 KB a lane in float64, 16.9 KB in
#: float32).
_SHARED_G = {"xtv": {0: (8, 12), 1: (8, 12), 2: (4, 6)},
             "xd": {0: (3, 6), 1: (3, 6), 2: (2, 3)}}
#: `csrc/hinge.cu`'s kWideP and kChunk: from this row length pass 2 takes
#: R = 4 rows a row group and cuts rows into column chunks, below it R = 8
_WIDE_P, _CHUNK = 1024, 4096
#: blocks an SM of an H100 runs at once of `hinge_xd_stacked` (pass 2 of the
#: stacked route), per mode, in the plan's model of its waves: float32 and
#: bf16 six (its registers allow six); float64 three, although four fit,
#: because at the 9b shape the grid that fills three an SM ran fastest
#: (PERF.md §6, PR 26: fewer blocks stage fewer chunks of d)
_XD_STACKED_PER_SM = {0: 6, 1: 6, 2: 3}
#: the SMs of an NVIDIA H100 SXM, for a plan made without a device
H100_SMS = 132


@dataclass(frozen=True)
class LanePlan:
    """How a lane-batched launch runs, pass 2 taking `xd_rows` rows a block.
    Route "shared": lane groups of up to `xtv_group` (pass 1) and `xd_group`
    (pass 2) lanes. Route "stacked": a block of pass 1 per lane and strip
    (`xtv_group` 0), a block of pass 2 per lane (`xd_group` 1)."""
    route: str
    xtv_group: int
    xd_group: int
    xd_rows: int


def lane_groups(B: int, G: int) -> list:
    """The lanes of each group the shared-X route cuts B lanes into for a
    group size G: ceil(B / G) ranges whose sizes differ by at most one, as
    `csrc/hinge.cu::group_first` cuts them."""
    ng = -(-B // G)
    return [range(i * B // ng, (i + 1) * B // ng) for i in range(ng)]


def _group_size(B: int, sizes) -> int:
    """The smallest built G that cuts B lanes into as few groups as the
    largest does (fewer accumulators, less shared memory)."""
    per = -(-B // -(-B // max(sizes)))
    return min(g for g in sizes if g >= per)


def _xd_rows(n: int, p: int, groups: int, slots: int, step: int) -> int:
    """Rows a block of pass 2 takes: whole steps of `step` rows, so that the
    grid's waves (`slots` resident blocks each) are as full as any choice
    makes them, with as few blocks as that allows: a block's staged chunks
    of d serve all its rows."""
    chunks = -(-p // _CHUNK) if p >= _WIDE_P else 1
    best = None
    for k in range(1, -(-n // step) + 1):
        blocks = groups * chunks * -(-n // (k * step))
        full = round(blocks / (-(-blocks // slots) * slots), 6)
        if best is None or (full, -blocks) > best[:2]:
            best = (full, -blocks, k * step)
    return best[2]


def plan(B: int, n: int, p: int, dtype: torch.dtype, shared: bool,
         sms: int = H100_SMS) -> LanePlan:
    """The route of a lane-batched launch of B lanes on X (n, p) of `dtype`,
    shared by every lane or stacked, on a card of `sms` SMs: the shared-X
    route when X is shared and B >= 2, else the stacked route. Raises on an
    X dtype the kernels do not take."""
    if dtype not in _MODES:
        raise TypeError(f"hinge lanes: X dtype {dtype} not in {_X_DTYPES}")
    mode, R = _MODES[dtype], 4 if p >= _WIDE_P else 8
    if not shared or B < 2:
        # pass 2: R rows at a time, a block per lane
        return LanePlan("stacked", 0, 1,
                        _xd_rows(n, p, B, _XD_STACKED_PER_SM[mode] * sms, R))
    xd_group = _group_size(B, _SHARED_G["xd"][mode])
    # pass 2: passes of 4 R rows (a 512-thread block, two rows a group of the
    # single launch's threads per row), one block an SM
    return LanePlan("shared", _group_size(B, _SHARED_G["xtv"][mode]), xd_group,
                    _xd_rows(n, p, len(lane_groups(B, xd_group)), sms, 4 * R))


#: device -> its SM count
_SMS = {}


def _plan_on(X: torch.Tensor, B: int, n: int, p: int, shared: bool) -> LanePlan:
    """`plan` for a launch on X's device."""
    sms = _SMS.get(X.device)
    if sms is None:
        sms = _SMS[X.device] = torch.cuda.get_device_properties(X.device).multi_processor_count
    return plan(B, n, p, X.dtype, shared, sms)


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
        lib.sven_hinge_xtv_lanes.argtypes = [_ptr, _int, _long, _ptr, _ptr, _long, _ptr,
                                             _ptr, _ptr, _ptr, _int, _int, _int, _ptr,
                                             _int, _ptr]
        lib.sven_hinge_xtv_lanes.restype = _int
        lib.sven_hinge_xd_lanes.argtypes = [_ptr, _int, _long, _ptr, _ptr, _int, _ptr,
                                            _long, _ptr, _ptr, _ptr, _ptr, _int, _int,
                                            _int, _ptr, _ptr, _int, _int, _ptr]
        lib.sven_hinge_xd_lanes.restype = _int
        lib.sven_hinge_shared_group.argtypes = [_int, _int, _int]
        lib.sven_hinge_shared_group.restype = _int
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


def _check_lanes(fn: str, X, y, v):
    """Raise unless X is (n, p) or (B, n, p), y (n,) or (B, n) and v (B, n),
    contiguous on X's CUDA device in the dtypes of a single launch (a
    stacked X may leave a gap between its contiguous lanes, as `pitched`
    does); return (B, n, p, x_stride, y_stride): the elements between two
    lanes' X and y (0 where the lanes share them)."""
    if not (isinstance(X, torch.Tensor) and X.is_cuda):
        raise ValueError(f"{fn}: X must be a CUDA tensor")
    if X.dim() not in (2, 3):
        raise ValueError(f"{fn}: X must be (n, p) or (B, n, p), got {tuple(X.shape)}")
    n, p = X.shape[-2:]
    _build.check_operand(fn, "X", X if X.dim() == 2 else X[0], (n, p), _X_DTYPES,
                         X.device)
    if X.dim() == 3 and X.shape[0] > 1 and X.stride(0) < n * p:
        raise ValueError(f"{fn}: X's lanes overlap (stride {X.stride(0)} < n p)")
    if not (isinstance(v, torch.Tensor) and v.dim() == 2 and v.shape[0] > 0):
        raise ValueError(f"{fn}: v must be (B, n) with B >= 1")
    B = v.shape[0]
    if X.dim() == 3 and X.shape[0] != B:
        raise ValueError(f"{fn}: X stacks {X.shape[0]} lanes, v {B}")
    acc = _operand_dtype(X)
    y_shape = (n,) if isinstance(y, torch.Tensor) and y.dim() == 1 else (B, n)
    for name, x, shape in (("y", y, y_shape), ("v", v, (B, n))):
        _build.check_operand(fn, name, x, shape, (acc,), X.device)
    return B, n, p, (X.stride(0) if X.dim() == 3 else 0), (n if y.dim() == 2 else 0)


def _lane_f64(fn: str, name: str, x, B: int, X: torch.Tensor) -> torch.Tensor:
    """The (B,) per-lane scalars x in float64 on X's device, contiguous: the
    kernels take 1/t and 2C from them in float64 and round once to the
    summing dtype, as a single launch rounds the host's double."""
    if not (isinstance(x, torch.Tensor) and x.shape == (B,) and x.is_floating_point()):
        raise ValueError(f"{fn}: {name} must be a floating (B,) = ({B},) tensor")
    if x.device != X.device:
        raise ValueError(f"{fn}: {name} is on {x.device}, X on {X.device}")
    return x.to(torch.float64).contiguous()


def hinge_xtv_lanes_cuda(X: torch.Tensor, y: torch.Tensor, v: torch.Tensor,
                         t: torch.Tensor, act_top: torch.Tensor, act_bot: torch.Tensor):
    """Pass 1 for B problems in one launch: returns (d (B, p), e_part (B, k))
    with each lane's e = e_part[lane].sum().

    X (n, p) shared by every lane or (B, n, p); y (n,) or (B, n); v (B, n),
    act_top, act_bot (B, p); t (B,) of any float dtype. Dtypes and devices
    as for `hinge_xtv_cuda`.
    """
    fn = "hinge_xtv_lanes_cuda"
    B, n, p, xs, ys = _check_lanes(fn, X, y, v)
    acc = _operand_dtype(X)
    for name, x in (("act_top", act_top), ("act_bot", act_bot)):
        _build.check_operand(fn, name, x, (B, p), (acc,), X.device)
    t = _lane_f64(fn, "t", t, B, X)
    lib = _lib()
    d = torch.empty((B, p), dtype=acc, device=X.device)
    e_part = torch.empty((B, lib.sven_hinge_xtv_blocks(p)), dtype=acc, device=X.device)
    pl = _plan_on(X, B, n, p, xs == 0)
    with torch.cuda.device(X.device):
        err = lib.sven_hinge_xtv_lanes(X.data_ptr(), _MODES[X.dtype], xs, v.data_ptr(),
                                       y.data_ptr(), ys, act_top.data_ptr(),
                                       act_bot.data_ptr(), d.data_ptr(), e_part.data_ptr(),
                                       n, p, B, t.data_ptr(), pl.xtv_group,
                                       torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    hinge_xtv_lanes_cuda.launches += 1
    return d, e_part


def hinge_xd_lanes_cuda(X: torch.Tensor, y: torch.Tensor, d: torch.Tensor,
                        e_part: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                        C: torch.Tensor) -> torch.Tensor:
    """Pass 2 for B problems in one launch: H v (B, n), each lane's
    v + 2C (X d + (y/t) e) with e = e_part[lane].sum().

    X, y, v and t as for `hinge_xtv_lanes_cuda`; d (B, p), e_part (B, k)
    with k >= 1; C (B,) of any float dtype.
    """
    fn = "hinge_xd_lanes_cuda"
    B, n, p, xs, ys = _check_lanes(fn, X, y, v)
    if not (isinstance(e_part, torch.Tensor) and e_part.dim() == 2
            and e_part.shape[0] == B and e_part.shape[1] > 0):
        raise ValueError(f"{fn}: e_part must be (B, k) = ({B}, k) with k >= 1")
    acc = _operand_dtype(X)
    for name, x, shape in (("d", d, (B, p)), ("e_part", e_part, tuple(e_part.shape))):
        _build.check_operand(fn, name, x, shape, (acc,), X.device)
    t, C = _lane_f64(fn, "t", t, B, X), _lane_f64(fn, "C", C, B, X)
    lib = _lib()
    hv = torch.empty((B, n), dtype=acc, device=X.device)
    chunks = lib.sven_hinge_xd_chunks(p)
    pl = _plan_on(X, B, n, p, xs == 0)
    part = ticket = None
    if chunks > 1:
        part = torch.empty((B, n, chunks), dtype=acc, device=X.device)
        # one ticket per (lane group, row block); a lane on the stacked route
        ticket = _tickets(X.device, len(lane_groups(B, pl.xd_group)) * -(-n // pl.xd_rows))
    with torch.cuda.device(X.device):
        err = lib.sven_hinge_xd_lanes(X.data_ptr(), _MODES[X.dtype], xs, d.data_ptr(),
                                      e_part.data_ptr(), e_part.shape[1], y.data_ptr(), ys,
                                      v.data_ptr(), hv.data_ptr(),
                                      None if part is None else part.data_ptr(),
                                      None if ticket is None else ticket.data_ptr(),
                                      n, p, B, t.data_ptr(), C.data_ptr(),
                                      pl.xd_group if pl.route == "shared" else 0, pl.xd_rows,
                                      torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}")
    hinge_xd_lanes_cuda.launches += 1
    return hv


hinge_xtv_cuda.launches = 0
hinge_xd_cuda.launches = 0
hinge_xtv_lanes_cuda.launches = 0
hinge_xd_lanes_cuda.launches = 0
