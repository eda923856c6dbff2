"""Fault-tolerant checkpointing of tensor trees: the port of
`repro/ckpt/checkpoint.py`, with JAX's on-disk format, so a checkpoint of
a tree both packages hold moves between them bit for bit.

  * layout: `<dir>/step_XXXXXXXX/` holds one `leaf_NNNNN.npy` per leaf, in
    JAX's flatten order, and a `manifest.json` naming each leaf's path
    (`utils.tree_paths`), file, shape, logical dtype and crc32;
  * bfloat16 (which numpy cannot hold) is stored as its raw bits in
    uint16, with "bfloat16" as the logical dtype, as JAX stores it;
  * atomic: writes go to `step_XXXXXXXX.tmp-<pid>-<usec>/`, then one
    `os.rename` publishes them, so a crashed writer never leaves a torn
    step behind;
  * self-validating: each leaf's crc32 is checked on load;
  * retention: `keep_last` + `keep_every`, and orphaned tmp directories
    swept, by `CheckpointManager`.

Leaves land on the target tree's devices unless a device is named
(`restore_checkpoint(..., device=)`).

**Under a mesh** (an active `dist.mesh_context` of more than one rank),
rank 0 writes JAX's global tree and every rank waits for it: a tree held
in blocks (ZeRO-1's moments) is gathered first by its sharding records
(`save_checkpoint(..., shardings=)`). Every rank restores the global tree
and, given records (`restore_checkpoint(..., shardings=)`, JAX's
argument), keeps its blocks. So a checkpoint written by 2 ranks restores
on 1 rank or on 2: JAX's "elastic restore re-shards onto whatever mesh
the relaunch built".
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import dist
from repro_torch.device import DeviceLike
from repro_torch.utils import tree_map, tree_map_with_path, tree_paths

#: the logical dtypes a checkpoint may hold, by their numpy (and JAX) names
_DTYPES = {"float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
           "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array to store, its logical dtype name)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _NAMES[t.dtype]


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if dtype not in _DTYPES:
        raise ValueError(f"a checkpoint leaf of dtype {dtype!r}, which this package "
                         "does not hold")
    # ascontiguousarray makes a 0-d array 1-d: the shape is put back
    return torch.from_numpy(np.ascontiguousarray(arr.astype(dtype)).reshape(arr.shape))


def _writer_mesh():
    """The active context's mesh when it has more than one rank, else None."""
    ctx = dist.current_context()
    return ctx[0] if ctx is not None and ctx[0].size > 1 else None


def _barrier(mesh) -> None:
    """Every rank of `mesh` waits here for the others (an all-reduce)."""
    dev = mesh.device if mesh.device is not None else torch.device("cpu")
    dist.all_reduce(mesh, torch.zeros(1, device=dev))


def save_checkpoint(directory: str, step: int, tree: Any, *, extra: Optional[dict] = None,
                    shardings: Any = None):
    """Write `tree` as the checkpoint of `step`; its path. Under a mesh of
    more than one rank, every rank calls it: the blocks of a tree held by
    `shardings` records are gathered, rank 0 writes, and every rank returns
    once the step is published."""
    if shardings is not None:
        from repro_torch.dist.shardings import gather_tree
        tree = gather_tree(tree, shardings)
    mesh = _writer_mesh()
    final = os.path.join(directory, f"step_{step:08d}")
    if mesh is not None and mesh.rank != 0:
        _barrier(mesh)
        return final
    path = _write(directory, step, tree, extra)
    if mesh is not None:
        _barrier(mesh)
    return path


def _write(directory: str, step: int, tree: Any, extra: Optional[dict]):
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}-{int(time.time() * 1e6) % 1_000_000}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(tree_paths(tree)):
        arr, logical_dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "path": path, "file": fname, "shape": list(arr.shape),
            "dtype": logical_dtype, "crc32": zlib.crc32(arr.tobytes()),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and ".tmp" not in d]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, target_tree: Any, *, step: Optional[int] = None,
                       device: DeviceLike = None, shardings: Any = None):
    """(a tree of target_tree's structure read from the checkpoint of
    `step` (the latest when None), its step, its extra dict). Each leaf
    has the dtype the checkpoint records and lands on `device`, or on the
    device of the target's leaf at its place when none is named. With
    `shardings` (a record tree like the target), each leaf is this rank's
    block, and the target's leaves may be blocks too. Raises IOError on a
    checksum mismatch and ValueError on a shape mismatch."""
    if shardings is not None:
        from repro_torch.dist.shardings import place
        like = tree_map(lambda leaf, rec: leaf if rec is None else torch.empty(
            rec.shape, dtype=leaf.dtype, device="meta"), target_tree, shardings)
        tree, step, extra = restore_checkpoint(directory, like, step=step, device="cpu")
        # each block copied apart, so the global leaf it was cut from is freed
        return tree_map(lambda x, leaf: x.to(device if device is not None else leaf.device,
                                             copy=True),
                        place(tree, shardings), target_tree), step, extra
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def load(path, leaf):
        entry = by_path[path]
        arr = np.load(os.path.join(final, entry["file"]))
        if zlib.crc32(arr.tobytes()) != entry["crc32"]:
            raise IOError(f"checksum mismatch for {path} in {final}")
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"{path}: the checkpoint holds shape {arr.shape}, the target "
                             f"{tuple(leaf.shape)}")
        where = device if device is not None else getattr(leaf, "device", "cpu")
        return _from_numpy(arr, entry["dtype"]).to(where)

    return tree_map_with_path(load, target_tree), manifest["step"], manifest["extra"]


class CheckpointManager:
    """Retention + resume policy around save/restore."""

    def __init__(self, directory: str, keep_last: int = 3, keep_every: int = 0):
        self.directory = directory
        self.keep_last = keep_last
        self.keep_every = keep_every

    def save(self, step: int, tree: Any, extra: Optional[dict] = None, shardings: Any = None):
        path = save_checkpoint(self.directory, step, tree, extra=extra, shardings=shardings)
        mesh = _writer_mesh()
        if mesh is None or mesh.rank == 0:
            self._gc()
        return path

    def restore(self, target_tree: Any, step: Optional[int] = None, device: DeviceLike = None,
                shardings: Any = None):
        return restore_checkpoint(self.directory, target_tree, step=step, device=device,
                                  shardings=shardings)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and ".tmp" not in d)
        keep = set(steps[-self.keep_last:])
        if self.keep_every:
            keep |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                              ignore_errors=True)
        # orphaned tmp dirs from crashed writers
        for d in os.listdir(self.directory):
            if ".tmp-" in d:
                shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
