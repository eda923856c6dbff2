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

On one card, `restore_checkpoint(..., device=)` takes the place of JAX's
`shardings`: leaves land on the target tree's devices unless a device is
named.
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

from repro_torch.device import DeviceLike
from repro_torch.utils import tree_map_with_path, tree_paths

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
    return torch.from_numpy(np.ascontiguousarray(arr.astype(dtype)))


def save_checkpoint(directory: str, step: int, tree: Any, *, extra: Optional[dict] = None):
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
                       device: DeviceLike = None):
    """(a tree of target_tree's structure read from the checkpoint of
    `step` (the latest when None), its step, its extra dict). Each leaf
    has the dtype the checkpoint records and lands on `device`, or on the
    device of the target's leaf at its place when none is named. Raises
    IOError on a checksum mismatch and ValueError on a shape mismatch."""
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

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        path = save_checkpoint(self.directory, step, tree, extra=extra)
        self._gc()
        return path

    def restore(self, target_tree: Any, step: Optional[int] = None, device: DeviceLike = None):
        return restore_checkpoint(self.directory, target_tree, step=step, device=device)

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
