"""The SolverState protocol — init/step/run machines driven from the host.

Every SVM solver here (primal Newton-CG, projected dual Newton) is the same
three functions as in `repro/core/svm/state.py`:

    init(hyper, x0=None) -> SolverState     starting carry
    step(state, hyper)   -> SolverState     one outer iteration
    run(hyper, x0=None)  -> SolverState     step to convergence

JAX runs `run` as a `lax.while_loop` on the device. Here it is a host loop
with the same stop rule, `~converged & iters < max_iters`: each Newton loop
test reads one device boolean (`host_bool`), which is one host sync. The CG
loop (`cg_lanes`, the one CG loop of every machine) keeps its test on the
device and reads it once per block of CG_READ_EVERY steps. The iterates
and the iteration counts are those of the JAX machines. The hyperparameters
(`Hyper.C`, `Hyper.tol`) are Python floats, so no other value crosses to
the host inside a solve.

The lane-batched machines (`core/batch.py`) solve B problems at once: the
counterpart of JAX's vmap over a machine. Their state carries a leading
lane axis: x (B, .), and per-lane iters, aux (the CG count), residual and
converged, all (B,) tensors; their hyperparameters are a `LaneHyper` of
(B,) tensors. `run_lane_machine` is vmap's form of the while_loop: every
step runs on all lanes, and a lane whose test is false keeps its state
(`lane_where`). Each loop test reads one host boolean for all lanes,
`active.any()`, counted in `host_bool.syncs`. Elementwise work runs on the
stacked tensors; every product and reduction runs per lane (`lanes`), as
the single solve's own op on that lane, because a batched product or sum
rounds in another order (on the CPU, `bmm` and `sum(-1)` lie 3e-15 from
`mv` and `@` on the same lanes) and CG, which runs for hundreds of steps,
turns such differences into other step counts. The op gets its lane laid
out as a fresh tensor (`pitched`), because some ops order their sums by
their operand's address (on CUDA, `torch.sum` and `torch.linalg.norm`
take a head of elements up to a 32-byte boundary). So each lane takes
exactly the steps of its single solve, with its bits.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


def host_bool(x: torch.Tensor) -> bool:
    """A 0-d boolean tensor read on the host: the one sync of a loop test.

    `host_bool.syncs` counts the reads (a plain integer; callers reset it).
    """
    host_bool.syncs += 1
    return bool(x)


host_bool.syncs = 0


def host_list(x: torch.Tensor) -> list:
    """A 1-d tensor read on the host as a list of floats: one host sync,
    counted in `host_bool.syncs` beside the loop tests."""
    host_bool.syncs += 1
    return [float(v) for v in x.tolist()]


def host_float(x: torch.Tensor) -> float:
    """A 0-d tensor read on the host as a float: one host sync, counted in
    `host_bool.syncs` beside the loop tests."""
    host_bool.syncs += 1
    return float(x)


class Hyper(NamedTuple):
    """Solver hyperparameters, as host scalars."""

    C: float     # SVM cost 1/(2*lambda2), clamped (reduction.svm_C)
    tol: float   # outer-loop optimality tolerance


class SolverState(NamedTuple):
    """Common carry shared by all SVM solver machines."""

    x: torch.Tensor          # iterate: primal w (n,) or dual alpha (2p,)
    aux: Any                 # solver-private extras (inner CG iterations so far)
    iters: int               # outer-iteration count
    residual: torch.Tensor   # solver's optimality measure (sup-norm), 0-d
    converged: torch.Tensor  # 0-d bool: residual <= tol reached


class SolverMachine(NamedTuple):
    """An init/step/run triple closed over the problem operators."""

    init: Callable[..., SolverState]
    step: Callable[[SolverState, Hyper], SolverState]
    run: Callable[..., SolverState]


def make_hyper(C, tol) -> Hyper:
    """Coerce the hyperparameters to host floats."""
    return Hyper(C=float(C), tol=float(tol))


def initial_state(x0: torch.Tensor, aux: Any = 0) -> SolverState:
    return SolverState(
        x=x0,
        aux=aux,
        iters=0,
        residual=torch.full((), float("inf"), dtype=x0.dtype, device=x0.device),
        converged=torch.zeros((), dtype=torch.bool, device=x0.device),
    )


def run_machine(step: Callable[[SolverState, Hyper], SolverState],
                state: SolverState, hyper: Hyper, max_iters: int) -> SolverState:
    """Drive `step` to convergence: the host form of JAX's while_loop."""
    while state.iters < max_iters and host_bool(~state.converged):
        state = step(state, hyper)
    return state


# ------------------------------------------------------------------ lanes ---

class LaneHyper(NamedTuple):
    """Per-lane solver hyperparameters, (B,) tensors of the problem dtype."""

    C: torch.Tensor
    tol: torch.Tensor


def make_lane_hyper(C, tol, B: int, dtype: torch.dtype,
                    device: Optional[torch.device]) -> LaneHyper:
    """(B,) tensors of `dtype` from per-lane tensors or scalars."""
    def lanes(x):
        return torch.as_tensor(x, device=device).to(dtype).expand(B).contiguous()

    return LaneHyper(C=lanes(C), tol=lanes(tol))


def initial_lane_state(x0: torch.Tensor, aux: Any = None) -> SolverState:
    """The starting carry of B lanes from x0 (B, .): aux defaults to a
    per-lane count (int64 zeros)."""
    B, dev = x0.shape[0], x0.device
    return SolverState(
        x=x0,
        aux=torch.zeros(B, dtype=torch.int64, device=dev) if aux is None else aux,
        iters=torch.zeros(B, dtype=torch.int64, device=dev),
        residual=torch.full((B,), float("inf"), dtype=x0.dtype, device=dev),
        converged=torch.zeros(B, dtype=torch.bool, device=dev),
    )


def lane_where(mask: torch.Tensor, new, old):
    """`new` on the lanes where mask (B,) holds, else `old`: tensors with a
    leading lane axis, or tuples of them."""
    if isinstance(new, tuple):
        return tuple(lane_where(mask, a, b) for a, b in zip(new, old))
    return torch.where(mask.view(-1, *([1] * (new.dim() - 1))), new, old)


#: the bytes between two lanes' slices in a `pitched` stack: the alignment of
#: a fresh tensor from PyTorch's CUDA caching allocator
LANE_PITCH = 512


def _fresh_align(x: torch.Tensor) -> int:
    """The alignment in bytes of a fresh tensor on x's device: 512 from the
    CUDA caching allocator, 64 from the CPU allocator."""
    return LANE_PITCH if x.is_cuda else 64


def pitched(x: torch.Tensor) -> torch.Tensor:
    """x (B, ...) with each lane's slice x[i] contiguous and starting a
    multiple of LANE_PITCH bytes past the stack's base, which is aligned as
    a fresh tensor: so an op that chooses its order of sums by its
    operand's address (PyTorch's vectorised reductions take a head of
    elements up to the operand's vector alignment) sums lane i in the order
    of the single solve, whose operands are fresh tensors. x itself when it
    is so laid out already, else a copy: one launch. `pitched.copies`
    counts the copies (a plain integer; callers reset it)."""
    size, row = x.element_size(), x[0].numel()
    if ((x.shape[0] == 1 or x.stride(0) * size % LANE_PITCH == 0)
            and x.data_ptr() % _fresh_align(x) == 0 and x[0].is_contiguous()):
        return x
    pitch = -(-row * size // LANE_PITCH) * LANE_PITCH // size
    buf = x.new_empty((x.shape[0], pitch))[:, :row]
    buf.copy_(x.reshape(x.shape[0], row))
    pitched.copies += 1
    return buf.view(x.shape)


pitched.copies = 0


def lanes(fn: Callable, *xs: torch.Tensor) -> torch.Tensor:
    """fn on each lane, stacked: fn(x1[i], x2[i], ...) for i < B. The single
    solve's op on each lane, on lanes laid out as fresh tensors (`pitched`;
    an operand passed twice is laid out once), so each lane's bits are the
    single solve's."""
    laid = {}
    for x in xs:
        if x.dim() > 1 and id(x) not in laid:
            laid[id(x)] = pitched(x)
    xs = [laid.get(id(x), x) for x in xs]
    return torch.stack([fn(*(x[i] for x in xs)) for i in range(xs[0].shape[0])])


def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each lane's a . b, (B,), for a and b (B, d)."""
    return lanes(torch.matmul, a, b)


def run_lane_machine(step: Callable, state: SolverState, hyper: LaneHyper,
                     max_iters: int) -> SolverState:
    """Drive a lane-batched `step(state, hyper, active)` until no lane is
    active (~converged & iters < max_iters): JAX's vmapped while_loop. Each
    lane stops where its own loop would; one host read per test."""
    while True:
        active = ~state.converged & (state.iters < max_iters)
        if not host_bool(active.any()):
            return state
        state = SolverState(*lane_where(active, tuple(step(state, hyper, active)),
                                        tuple(state)))


#: CG steps launched between two reads of the CG loop test (`cg_lanes`); 1
#: reads it before every step. Chosen from `chip_smoke.py --loop-trace`
#: (PERF.md §5, PR 27): a read cost the host 15-25 us of waiting a step,
#: plus its own launches, and a dead step costs a whole step (0.2-0.3 ms
#: primal, 0.7-0.9 ms at 9a); the untraced runs at k = 1, 2, 4, 8 and 16
#: could not tell k = 4-16 apart beyond the host's noise, and k = 8 keeps
#: a solve's reads near a sixth of its CG steps, at 4 % dead steps (the
#: primal) and 2 % (9a).
CG_READ_EVERY = 8


def host_flags(x: torch.Tensor) -> list:
    """A 2-d boolean tensor read on the host as lists of rows: one host
    sync, counted in `host_bool.syncs` beside the loop tests."""
    host_bool.syncs += 1
    return x.tolist()


def device_ints(values: list, device: torch.device) -> torch.Tensor:
    """Host integers as an int64 tensor on `device`, copied without waiting
    for the device's queue (from pinned memory on CUDA)."""
    t = torch.tensor(values, dtype=torch.int64)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)


def cg_lanes(matvec: Callable, b: torch.Tensor, active: Optional[torch.Tensor],
             maxiter: int, tol):
    """Plain CG on each lane of b (B, d) at once, with each lane's own early
    exit (rs <= tol^2; tol a (B,) tensor or a float): the vmapped form of the
    solvers' CG, and the one CG loop of every machine. Lanes not `active`
    (B,) take no step; None: all are active. A single solve passes b (d,),
    one lane without a lane axis, and a `matvec` of (d,): its steps are
    then the single solve's own ops (`@` and 0-d scalars), with none of
    the lane axis' views and broadcasts, which a step's host time shows.

    The loop test `active & (rs > tol^2)` is evaluated on the device, once
    per block of k = CG_READ_EVERY steps for every step of the block, and
    read by the host once per block: before steps k - 1, 2k - 1, ... (and
    before the last step allowed). A lane's count is its first step whose
    test is false (JAX's `lax.while_loop` stops there), and its x that of
    that step, kept from the block's iterates; the steps it is launched
    past it run on and are discarded. So a lane's x and count are those of
    the loop that reads its test before every step, to the bit, and a step
    adds no launch to freeze a lane. A solve in which some lane ran c steps
    makes ceil((c + 1) / k) reads and launches up to k - 1 "dead" steps
    after its end, whose mat-vec runs and is discarded; k = 1 reads before
    every step and launches none. Returns (x, each lane's count (a host
    list), the steps in which some lane ran). `cg_lanes.steps` counts the
    batched steps launched, each one `matvec` for all lanes,
    `cg_lanes.dead` the dead ones among them, and `cg_lanes.copies` the
    `pitched` copies its steps make (plain integers; callers reset them)."""
    k = CG_READ_EVERY
    lane_axis = b.dim() > 1
    B = b.shape[0] if lane_axis else 1
    dot = lane_dot if lane_axis else torch.matmul

    def col(t):   # a per-lane scalar against the lanes' (B, d) vectors
        return t[:, None] if lane_axis else t

    x, r, pvec, rs = torch.zeros_like(b), b, b, dot(b, b)
    copies = pitched.copies
    one = torch.ones_like(rs)
    thr = tol * tol
    xs, rss, first = [x], [rs], 0    # x and rs after first, first + 1, ... steps
    counts, ends = [None] * B, [None] * B   # each lane's count and its x
    it = 0
    while it < maxiter:
        if it % k == k - 1 or it == maxiter - 1:
            run = (torch.stack(rss) if len(rss) > 1 else rss[0][None]) > thr
            run = run if active is None else run & active
            for j, row in enumerate(host_flags(run.reshape(len(rss), B))):
                for i in range(B):
                    if counts[i] is None and not row[i]:
                        counts[i], ends[i] = first + j, xs[j][i] if lane_axis else xs[j]
            if None not in counts:
                break
            xs, rss, first = [], [], it + 1
        Ap = matvec(pvec)
        denom = dot(pvec, Ap)
        alpha = col(rs / torch.where(denom > 0, denom, one))
        x = x + alpha * pvec
        r = r - alpha * Ap
        rs_new = dot(r, r)
        beta = col(rs_new / torch.where(rs > 0, rs, one))
        pvec = r + beta * pvec
        rs = rs_new
        it += 1
        xs.append(x)
        rss.append(rs)
    for i in range(B):   # the step limit: lanes whose test held to its last step
        if counts[i] is None:
            counts[i], ends[i] = it, x[i] if lane_axis else x
    live = max(counts)
    cg_lanes.steps += it
    cg_lanes.dead += it - live
    cg_lanes.copies += pitched.copies - copies
    if not lane_axis:
        return ends[0], counts, live
    return (ends[0][None] if B == 1 else torch.stack(ends)), counts, live


cg_lanes.steps = cg_lanes.dead = cg_lanes.copies = 0
