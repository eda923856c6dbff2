"""The port's device mesh and logical-axis rules: a process group, its
ranks, their collectives, and the rule table that maps logical axis names
onto mesh axes.

PyTorch counterpart of `repro/dist/__init__.py`. Model code names logical
axes only (the per-module `*_sharding()` specs); `DEFAULT_RULES`,
overridable per config (`cfg.rules_override`) and per `mesh_context`, maps
them onto mesh axes; `resolve_spec` drops a mesh axis that does not divide
the dimension or that an earlier dimension of the spec already used. The
resolvers of `dist.shardings` and `dist.zero` build on it.

JAX is single-controller: one process calls a sharded function on global
arrays over a `Mesh` of devices. torch is SPMD: every rank is a process,
and every rank calls the same entry point with the same arguments. A
`Mesh` here names its axes and their sizes, a `torch.distributed` process
group, this process's rank in it and the rank's device. Functions that
take a mesh keep their own block of the work and return the same
replicated result on every rank. A mesh of one rank (no process group, or
`data_mesh(1)`) issues no collective at all; a mesh of more ranks that no
process group backs (the production 16 x 16, say) resolves specs, and
counts: a collective on it of an operand on the "meta" device (a shape
and a dtype, no data) records what it would move in the counters the
executed collectives keep and returns a meta result of the right shape,
while a collective of a real tensor on it raises, so a count never passes
for a run (`launch/dryrun.py` runs rank 0's step on meta tensors so). So
`constrain` is the identity inside a context too: each rank already holds
its own block.

**Axis views.** A mesh of several axes (`launch.mesh.make_local_mesh`,
`with_views`) holds one process group for each slice of ranks along an
axis: `mesh.view(axis)` is the 1-D mesh of the ranks that share every
other coordinate with this one. The collectives of a step run on views:
gradients and metrics over the "data" view, the tensor-parallel
operators (`dist.tp`) over the "model" view, the FSDP layer gather
(`dist.fsdp`) over the "data" view.

Every collective is an `all_reduce` (`all_reduce`, `gather`, `agree`) or
a `broadcast`: a gather is an all-reduce of a zero-filled buffer that
holds this rank's block (exact: the other ranks add zeros), and a
reduce-scatter is an all-reduce from which each rank takes its slice.
gloo takes CUDA tensors for `all_reduce` and `broadcast` only, so one
code path serves gloo and NCCL alike. Every process group is made with a
timeout (`launch`), so a rank that leaves a loop apart from the others
fails instead of hanging.

`launch` is the counterpart of JAX's forced host devices: it spawns W rank
processes, meets them at a `file://` rendezvous and returns rank 0's
result. The backend follows the topology, and says which it took: NCCL
when every rank has a card of its own, gloo when ranks share one card or
run on the CPU (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
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

# Logical axis -> mesh axis (or None = replicated): JAX's table. One table
# for the whole model zoo; per-arch deviations go through
# cfg.rules_override. The solver layer uses "batch" alone (stacked
# problems and CV folds on their leading axis).
DEFAULT_RULES: dict = {
    # activations
    "batch": "data",          # global batch dim (DP)
    "moe_batch": "data",      # MoE capacity buffer's batch dim (pre/post a2a)
    "seq_kv": None,           # KV sequence dim; "model"/"data" for long-ctx cells
    # shared activation/param feature axes
    "embed": None,            # d_model: replicated unless fsdp widens it
    "mlp": "model",           # dense FFN hidden (Megatron col->row TP)
    "vocab": "model",         # logits / embedding-table vocab dim
    "heads": "model",         # query heads (TP)
    "kv_heads": "model",      # KV heads (GQA TP; skipped when it won't divide)
    "ssm_inner": "model",     # mamba d_inner channels
    "ssm_heads": "model",     # SSD state heads
    "experts": "model",       # expert parallelism (mixtral overrides to TP)
    "expert_ffn": None,       # per-expert FFN hidden (TP-within-expert if set)
    "expert_fsdp": None,      # expert weight d_model dim (deepseek: "data")
    "latent": None,           # MLA low-rank latent dims
    # parameter-only pseudo-axis: when set, params_shardings/zero widen each
    # weight's first unsharded divisible dim over this mesh axis (FSDP/ZeRO).
    "fsdp": None,
}

#: the device `launch` gave this rank (None outside a launched rank)
_RANK_DEVICE: Optional[torch.device] = None
#: the collective timeout of the groups `with_views` makes (`launch` sets it)
_GROUP_TIMEOUT: Optional[datetime.timedelta] = None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh of `size` ranks with named `axes` of `sizes` (row-major over
    the ranks; one "data" axis of `size` when `sizes` is not given): this
    process is `rank`, its blocks live on `device`, and `group` is the
    process group (None for one rank, and for a mesh that resolves specs
    only). `backend` is the group's ("gloo" or "nccl")."""

    size: int = 1
    rank: int = 0
    device: Optional[torch.device] = None
    group: Any = None
    backend: Optional[str] = None
    axes: tuple = ("data",)
    sizes: Optional[tuple] = None
    #: axis -> the process group of this rank's slice along it (`with_views`)
    groups: Optional[dict] = None

    def __post_init__(self):
        sizes = (self.size,) if self.sizes is None else tuple(int(s) for s in self.sizes)
        if len(sizes) != len(self.axes) or len(set(self.axes)) != len(self.axes):
            raise ValueError(f"Mesh: axes {self.axes} and sizes {sizes} do not pair up")
        size = math.prod(sizes)
        if self.sizes is not None and self.size == 1:
            object.__setattr__(self, "size", size)
        elif size != self.size:
            raise ValueError(f"Mesh: sizes {sizes} make {size} ranks, not {self.size}")
        object.__setattr__(self, "axes", tuple(self.axes))
        object.__setattr__(self, "sizes", sizes)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axes, self.sizes))

    def coord(self, axis: str) -> int:
        """This rank's index along `axis`."""
        i = self.axes.index(axis)
        return (self.rank // math.prod(self.sizes[i + 1:])) % self.sizes[i]

    def view(self, axis: str) -> "Mesh":
        """The 1-D (`axis`,) mesh of the ranks that share every other
        coordinate with this one, this rank at its coordinate along `axis`:
        the mesh itself when `axis` spans every rank, one rank when it has
        size 1, else the slice's group of `with_views` (none on a mesh that
        resolves specs only, whose collectives raise)."""
        n = self.shape[axis]
        if self.axes == (axis,):
            return self
        if n == 1:
            return Mesh(device=self.device, axes=(axis,))
        group = self.group if n == self.size else (self.groups or {}).get(axis)
        return Mesh(size=n, rank=self.coord(axis), device=self.device, group=group,
                    backend=self.backend, axes=(axis,))


#: (ranks, axes, sizes) of a mesh -> {axis: this rank's slice group}
_VIEW_GROUPS: dict = {}


def with_views(mesh: Mesh) -> Mesh:
    """`mesh` with a process group for each slice of ranks along each axis
    of more than one rank that does not span the whole mesh
    (`torch.distributed.new_group`, called by every rank for every slice
    in the same order). The groups are made once a process for a mesh
    shape. A mesh of one rank, or one that no process group backs, is
    returned as it is."""
    if mesh.group is None or mesh.size == 1:
        return mesh
    import torch.distributed as tdist

    key = (mesh.size, mesh.axes, mesh.sizes)
    if key not in _VIEW_GROUPS:
        groups = {}
        ranks = torch.arange(mesh.size).reshape(mesh.sizes)
        for i, (axis, n) in enumerate(zip(mesh.axes, mesh.sizes)):
            if n in (1, mesh.size):
                continue
            slices = ranks.movedim(i, -1).reshape(-1, n).tolist()
            for members in slices:
                g = tdist.new_group(members, timeout=_GROUP_TIMEOUT)
                if mesh.rank in members:
                    groups[axis] = g
        _VIEW_GROUPS[key] = groups
    return dataclasses.replace(mesh, groups=_VIEW_GROUPS[key])


def split_axes(mesh: Mesh) -> tuple:
    """The axes of `mesh` with more than one rank, in its order."""
    return tuple(a for a, n in mesh.shape.items() if n > 1)


def data_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """A 1-D (`axis_name`,) mesh: the mesh of the initialized default
    process group, or else a mesh of one rank; `n_devices=1` is always this
    rank alone.

    The solver layer's default placement: batch-axis fan-out of stacked
    problems (`core/batch.py`, `runtime/scheduler.py`), fold placement for
    CV (`core/cv.py`) and row-sharded solves
    (`core/distributed.py::sven_sharded`) run on this mesh unless the
    caller supplies their own.
    """
    import torch.distributed as tdist

    axes = (axis_name,)
    if tdist.is_available() and tdist.is_initialized():
        world = tdist.get_world_size()
        if n_devices == 1:
            return Mesh(device=_RANK_DEVICE, axes=axes)
        if n_devices not in (None, world):
            raise ValueError(f"data_mesh: n_devices={n_devices} but the process group "
                             f"has {world} ranks")
        return Mesh(size=world, rank=tdist.get_rank(), device=_RANK_DEVICE,
                    group=tdist.group.WORLD if world > 1 else None,
                    backend=tdist.get_backend(), axes=axes)
    if n_devices not in (None, 1):
        raise ValueError(f"data_mesh: n_devices={n_devices} but no process group is "
                         "initialized (one rank; see dist.launch)")
    return Mesh(device=_RANK_DEVICE, axes=axes)


_state = threading.local()


def _stack(name: str = "stack") -> list:
    if not hasattr(_state, name):
        setattr(_state, name, [])
    return getattr(_state, name)


@contextmanager
def mesh_context(mesh: Mesh, rules: Optional[dict] = None):
    """Activate `mesh` and a rule table; contexts nest, the innermost wins.
    `rules` entries take precedence over DEFAULT_RULES; a partial override
    and a fully merged table both work."""
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


def _axis_size(mesh: Mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def resolve_spec(names: tuple, shape: tuple, mesh: Mesh, rules: dict) -> tuple:
    """Logical names (one per dim, None = unsharded) -> the mesh axis (or
    tuple of axes) each dim is split over, or None: JAX's PartitionSpec
    entries as a tuple. Skips a mesh axis when it would not divide the
    dimension or was already used by an earlier dimension of this spec."""
    used: set = set()
    out = []
    for dim, name in zip(shape, names):
        axis = rules.get(name) if name is not None else None
        if axis is None:
            out.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if (any(a not in mesh.shape for a in axes) or any(a in used for a in axes)
                or dim % _axis_size(mesh, axes) != 0):
            out.append(None)
            continue
        used.update(axes)
        out.append(axis)
    return tuple(out)


def constrain(x: torch.Tensor, *names) -> torch.Tensor:
    """JAX's sharding hint: `names` gives one logical axis name (or None)
    per dim of x. Raises ValueError when their count is not x's rank, and
    returns x itself, in a mesh_context or outside one: each rank of this
    SPMD port already holds its own block."""
    if len(names) != x.dim():
        raise ValueError(f"constrain: {len(names)} names for rank-{x.dim()} array")
    return x


def local_block(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of x's leading axis (its size divisible by the mesh)."""
    rows = x.shape[0] // mesh.size
    return x[mesh.rank * rows:(mesh.rank + 1) * rows]


@contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Within it, the batch a step computes on is this rank's block of a
    global batch whose rows are split over `mesh`, the "data" view of the
    step's mesh (None: not split), so what the model sums over the global
    batch (the MoE's load-balance fractions) sums over those ranks
    (`data_parallel_mesh`), and not over "model" ranks that hold the same
    rows."""
    _stack("split").append(mesh)
    try:
        yield mesh
    finally:
        _stack("split").pop()


def snapshot() -> tuple:
    """The active mesh contexts and data-parallel meshes, to re-enter on
    another thread (`entered`): these stacks are per thread, and autograd
    runs a CUDA backward, a checkpointed layer's recompute included, on a
    thread of its own."""
    return list(_stack()), list(_stack("split"))


@contextmanager
def entered(snap: tuple):
    """Within it, this thread's contexts are those of `snapshot()`."""
    saved = list(_stack()), list(_stack("split"))
    _stack()[:], _stack("split")[:] = snap
    try:
        yield
    finally:
        _stack()[:], _stack("split")[:] = saved


def data_parallel_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `data_parallel` with more than one rank,
    or None."""
    stack = _stack("split")
    mesh = stack[-1] if stack else None
    return mesh if mesh is not None and mesh.size > 1 else None


# -- collectives ---------------------------------------------------------------

def all_reduce(mesh: Mesh, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """x summed (or maxed) over the ranks, the same bits on every rank; x
    itself on a mesh of one rank. On a mesh that no process group backs, a
    meta x is counted (`_counted`) and a real one raises.
    `all_reduce.calls`, `.bytes` and `.seconds` count the collectives
    issued (`all_reduce_`'s too), their operands' bytes and the host
    seconds spent in them, `.by_axis` the calls and `.bytes_by_axis` the
    bytes by the mesh's axes ("model" for the model view; plain numbers,
    `reset_counts`)."""
    if mesh.size == 1:
        return x
    return all_reduce_(mesh, x.clone(), op)


def _counted(fn, mesh: Mesh, x: torch.Tensor) -> bool:
    """Whether a collective `fn` of x on `mesh` is only counted: on a mesh
    that no process group backs, a meta x is (`fn`'s counters take the call
    and x's bytes) and a real x raises."""
    if mesh.group is not None:
        return False
    if not x.is_meta:
        raise RuntimeError(f"{fn.__name__}: no process group backs this mesh of shape "
                           f"{mesh.shape}; it resolves specs only (and counts the "
                           "collectives of meta tensors)")
    _count(fn, mesh, x, time.perf_counter())
    return True


def all_reduce_(mesh: Mesh, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """`all_reduce` in place: x itself, overwritten with the result (for a
    tensor the caller owns, such as a rank's own gradients)."""
    if mesh.size == 1 or _counted(all_reduce, mesh, x):
        return x
    import torch.distributed as tdist

    t0 = time.perf_counter()
    tdist.all_reduce(x, op=tdist.ReduceOp.MAX if op == "max" else tdist.ReduceOp.SUM,
                     group=mesh.group)
    _count(all_reduce, mesh, x, t0)
    return x


def _count(fn, mesh: Mesh, x: torch.Tensor, t0: float) -> None:
    nbytes = x.numel() * x.element_size()
    fn.calls += 1
    fn.bytes += nbytes
    fn.seconds += time.perf_counter() - t0
    key = "+".join(mesh.axes)
    fn.by_axis[key] = fn.by_axis.get(key, 0) + 1
    fn.bytes_by_axis[key] = fn.bytes_by_axis.get(key, 0) + nbytes


def _collectives() -> dict:
    """The collectives by kind, under JAX's HLO names."""
    return {"all-reduce": all_reduce, "broadcast": broadcast, "all-gather": all_gather}


def reset_counts() -> None:
    """Every collective's counters to 0."""
    for fn in _collectives().values():
        fn.calls = fn.bytes = 0
        fn.seconds = 0.0
        fn.by_axis = {}
        fn.bytes_by_axis = {}


def counts() -> dict:
    """The collectives' counters since `reset_counts`, by kind:
    {kind: {"count", "bytes", "by_axis", "bytes_by_axis"}} for each kind
    called at least once (the record `launch/dryrun.py` keeps)."""
    return {kind: {"count": fn.calls, "bytes": fn.bytes, "by_axis": dict(fn.by_axis),
                   "bytes_by_axis": dict(fn.bytes_by_axis)}
            for kind, fn in _collectives().items() if fn.calls}


def broadcast(mesh: Mesh, x: torch.Tensor, src: int) -> torch.Tensor:
    """x overwritten in place with the x of the rank at index `src` of
    `mesh` (the FSDP layer gather's move of a whole layer from its owner);
    x itself on one rank. `broadcast.calls`, `.bytes`, `.seconds`,
    `.by_axis` and `.bytes_by_axis` count as `all_reduce`'s do."""
    if mesh.size == 1 or _counted(broadcast, mesh, x):
        return x
    import torch.distributed as tdist

    t0 = time.perf_counter()
    tdist.broadcast(x, src=tdist.get_global_rank(mesh.group, src), group=mesh.group)
    _count(broadcast, mesh, x, t0)
    return x


def all_gather(mesh: Mesh, x: torch.Tensor) -> list:
    """Every rank's x (all of one shape), in the mesh's rank order; [x] on
    one rank. `all_gather.calls`, `.bytes` (this rank's operand, the block
    it sends), `.seconds`, `.by_axis` and `.bytes_by_axis` count as
    `all_reduce`'s do."""
    if mesh.size == 1:
        return [x]
    if _counted(all_gather, mesh, x):
        return [torch.empty_like(x) for _ in range(mesh.size)]
    import torch.distributed as tdist

    t0 = time.perf_counter()
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    tdist.all_gather(out, x, group=mesh.group)
    _count(all_gather, mesh, x, t0)
    return out


reset_counts()


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


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.size = mesh.size
        return all_reduce(mesh, x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.size, None


def sum_over_ranks(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks of `mesh` (the step's "data" view),
    differentiably. Every rank's loss holds the sum whole and the step
    averages the ranks' gradients over that view, so backward hands each
    rank W times the gradient it sees (W the view's size): the average is
    then the gradient of the sum through every rank's own term."""
    if mesh.size == 1:
        return x
    return _SumOverRanks.apply(x, mesh)


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
    global _RANK_DEVICE, _GROUP_TIMEOUT
    import torch.distributed as tdist

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        elif threads:
            torch.set_num_threads(threads)
        _RANK_DEVICE = dev
        _GROUP_TIMEOUT = datetime.timedelta(seconds=collective_timeout)
        tdist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                 timeout=_GROUP_TIMEOUT)
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
