"""The port's device mesh: a process group, its ranks, and their collectives.

PyTorch counterpart of the part of `repro/dist/__init__.py` that the
Elastic Net uses: `data_mesh`, `mesh_context`, `current_context` and the
"batch" axis of `DEFAULT_RULES` / `resolve_spec`. The LM's rules
(`constrain`, ZeRO, compression, pipeline) are not ported.

JAX is single-controller: one process calls a sharded function on global
arrays over a `Mesh` of devices. torch is SPMD: every rank is a process,
and every rank calls the same entry point with the same arguments. A
`Mesh` here names a `torch.distributed` process group, its size, this
process's rank in it and the rank's device. Functions that take a mesh
keep their own block of the work and return the same replicated result on
every rank. A mesh of one rank (no process group, or `data_mesh(1)`)
issues no collective at all.

Every collective is an `all_reduce` (`all_reduce`, `gather`, `agree`): a
gather is an all-reduce of a zero-filled buffer that holds this rank's
block (exact: the other ranks add zeros), and a reduce-scatter is an
all-reduce from which each rank takes its slice. gloo takes CUDA tensors
for `all_reduce` and `broadcast` only, so one code path serves gloo and
NCCL alike. Every process group is made with a timeout (`launch`), so a
rank that leaves a loop apart from the others fails instead of hanging.

`launch` is the counterpart of JAX's forced host devices: it spawns W rank
processes, meets them at a `file://` rendezvous and returns rank 0's
result. The backend follows the topology, and says which it took: NCCL
when every rank has a card of its own, gloo when ranks share one card or
run on the CPU (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import shutil
import tempfile
import threading
import time
import traceback
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Optional

import torch

# Logical axis -> mesh axis (or None = replicated): the solver layer's one
# rule, stacked problems and CV folds on their leading "batch" axis.
DEFAULT_RULES: dict = {"batch": "data"}

#: the device `launch` gave this rank (None outside a launched rank)
_RANK_DEVICE: Optional[torch.device] = None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D ("data",) mesh of `size` ranks: this process is `rank`, its
    shards live on `device`, and `group` is the process group (None for
    one rank). `backend` is the group's ("gloo" or "nccl")."""

    size: int = 1
    rank: int = 0
    device: Optional[torch.device] = None
    group: Any = None
    backend: Optional[str] = None

    @property
    def shape(self) -> dict:
        return {"data": self.size}


def data_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of the initialized default process group, or else a mesh of
    one rank; `n_devices=1` is always this rank alone.

    The solver layer's default placement: batch-axis fan-out of stacked
    problems (`core/batch.py`, `runtime/scheduler.py`), fold placement for
    CV (`core/cv.py`) and row-sharded solves
    (`core/distributed.py::sven_sharded`) run on this mesh unless the
    caller supplies their own.
    """
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        world = tdist.get_world_size()
        if n_devices == 1:
            return Mesh(device=_RANK_DEVICE)
        if n_devices not in (None, world):
            raise ValueError(f"data_mesh: n_devices={n_devices} but the process group "
                             f"has {world} ranks")
        return Mesh(size=world, rank=tdist.get_rank(), device=_RANK_DEVICE,
                    group=tdist.group.WORLD if world > 1 else None,
                    backend=tdist.get_backend())
    if n_devices not in (None, 1):
        raise ValueError(f"data_mesh: n_devices={n_devices} but no process group is "
                         "initialized (one rank; see dist.launch)")
    return Mesh(device=_RANK_DEVICE)


_state = threading.local()


def _stack() -> list:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


@contextmanager
def mesh_context(mesh: Mesh, rules: Optional[dict] = None):
    """Activate `mesh` and a rule table; contexts nest, the innermost wins.
    `rules` entries take precedence over DEFAULT_RULES."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _stack().append((mesh, merged))
    try:
        yield mesh
    finally:
        _stack().pop()


def current_context() -> Optional[tuple]:
    """(mesh, rules) of the innermost active mesh_context, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def resolve_spec(names: tuple, shape: tuple, mesh: Mesh, rules: dict) -> tuple:
    """Logical names (one per dim, None = unsharded) -> the mesh axis each
    dim is split over, or None. Skips a mesh axis when it would not divide
    the dimension or was already used by an earlier dimension."""
    used: set = set()
    out = []
    for dim, name in zip(shape, names):
        axis = rules.get(name) if name is not None else None
        if axis is None or axis not in mesh.shape or axis in used or dim % mesh.size:
            out.append(None)
            continue
        used.add(axis)
        out.append(axis)
    return tuple(out)


def local_block(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of x's leading axis (its size divisible by the mesh)."""
    rows = x.shape[0] // mesh.size
    return x[mesh.rank * rows:(mesh.rank + 1) * rows]


# -- collectives: every one an all_reduce ------------------------------------

def all_reduce(mesh: Mesh, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """x summed (or maxed) over the ranks, the same bits on every rank; x
    itself on a mesh of one rank. `all_reduce.calls` counts the collectives
    issued (a plain integer; callers reset it)."""
    if mesh.size == 1:
        return x
    import torch.distributed as tdist

    out = x.clone()
    tdist.all_reduce(out, op=tdist.ReduceOp.MAX if op == "max" else tdist.ReduceOp.SUM,
                     group=mesh.group)
    all_reduce.calls += 1
    return out


all_reduce.calls = 0


def gather(mesh: Mesh, x_loc: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks stacked along the leading axis in rank order (all
    blocks of one shape): an all-reduce of a zero-filled buffer holding
    this rank's block, exact. x_loc itself on one rank."""
    if mesh.size == 1:
        return x_loc
    rows = x_loc.shape[0]
    buf = x_loc.new_zeros((mesh.size * rows,) + tuple(x_loc.shape[1:]))
    buf[mesh.rank * rows:(mesh.rank + 1) * rows] = x_loc
    return all_reduce(mesh, buf)


def agree(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Rank 0's x on every rank (an all-reduce in which the other ranks
    add zeros): values measured on one rank that every rank must act on."""
    if mesh.size == 1:
        return x
    return all_reduce(mesh, x if mesh.rank == 0 else torch.zeros_like(x))


# -- the rank launcher --------------------------------------------------------

def _to_cpu(obj):
    """obj with every tensor in it moved to the CPU (tuples, named tuples,
    lists and dicts walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_cpu(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_cpu(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _rank_main(fn, args, rank: int, world: int, init: str, backend: str, device: str,
               collective_timeout: float, out_dir: str, threads: int) -> None:
    """One rank: join the group, run fn(mesh, *args), rank 0 saves the
    result; any failure is written beside it and exits non-zero."""
    global _RANK_DEVICE
    import torch.distributed as tdist

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        elif threads:
            torch.set_num_threads(threads)
        _RANK_DEVICE = dev
        tdist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                 timeout=datetime.timedelta(seconds=collective_timeout))
        out = fn(data_mesh(), *args)
        if rank == 0:
            torch.save(_to_cpu(out), os.path.join(out_dir, "result.pt"))
        tdist.destroy_process_group()
    except Exception:       # the parent reads this rank's traceback
        Path(out_dir, f"error-{rank}.txt").write_text(traceback.format_exc())
        raise


def topology(world_size: int, device: str = "cuda"):
    """(each rank's device, backend) for `world_size` ranks: on the CPU
    gloo; on CUDA one card a rank and NCCL when there are enough cards,
    else every rank on card 0 and gloo (NCCL refuses two ranks on one
    device)."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * world_size, "gloo"
    if torch.cuda.device_count() >= world_size:
        return [f"cuda:{r}" for r in range(world_size)], "nccl"
    return ["cuda:0"] * world_size, "gloo"


def launch(fn: Callable, world_size: int, args: tuple = (), *, device: str = "cuda",
           timeout: float = 600.0,
           collective_timeout: float = 300.0, threads: int = 0) -> Any:
    """Run fn(mesh, *args) on `world_size` rank processes and return rank
    0's result (its tensors on the CPU).

    The ranks are spawned (`fn` must be importable: a function of a module,
    not of `__main__` of an interactive session), meet at a `file://`
    rendezvous in a fresh temporary directory, and each joins a process
    group whose collectives time out after `collective_timeout` seconds.
    Devices and backend come from `topology`. A rank that fails, or ranks
    that outlive `timeout` seconds, end the run: the others are killed and
    this raises with every rank's traceback. `threads` > 0 sets each CPU
    rank's torch thread count (ranks of one host share its cores)."""
    devices, backend = topology(world_size, device)
    tmp = tempfile.mkdtemp(prefix="repro-ranks-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, world_size, init, backend, devices[r],
                               collective_timeout, tmp, threads))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = timed_out = False
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                failed = True
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errors = "".join(f"--- rank {r} ---\n{Path(tmp, f'error-{r}.txt').read_text()}"
                         for r in range(world_size) if Path(tmp, f"error-{r}.txt").exists())
        codes = [p.exitcode for p in procs]
        if timed_out:
            raise TimeoutError(f"launch: ranks outlived {timeout} s (exit codes {codes})\n"
                               f"{errors}")
        if failed or any(c != 0 for c in codes):
            raise RuntimeError(f"launch: a rank failed (exit codes {codes}, backend "
                               f"{backend})\n{errors}")
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
