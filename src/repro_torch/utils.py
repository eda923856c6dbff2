"""The port's small utilities (the jax-free parts of `repro/utils.py`,
which imports jax, so the port keeps its own copy): tree helpers and the
on-disk JSON cache.

A tree is what JAX calls a pytree, built of dicts, lists, tuples and
NamedTuples with tensors (or other objects) at the leaves; None is an
empty subtree. `tree_paths` walks it in JAX's order (a dict's keys
sorted) and names each leaf as `jax.tree_util.tree_flatten_with_path`
does: a dict key, a list index, a NamedTuple's field name, joined by
"/". The training path (optimizers, checkpoints) runs on these.

Facts measured on a machine that outlive the process persist here:
``${REPRO_CACHE_DIR:-~/.cache/repro-sven}/<kind>.json``, the same rule and
directory as the JAX package. The warm-start spill tier
(`runtime/cache.py::PersistentCacheTier`) lives under `cache_dir()` too.
Every entry key embeds whatever invalidates it, so one flat file per kind
suffices. All failures — read-only HOME, corrupt JSON, races — degrade to
"no cache", never to an exception on the solve path.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Callable, Optional


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`tree` rebuilt with each leaf x replaced by fn(path, x, *the leaves
    at the same place in `rest`), which share `tree`'s structure."""
    def walk(path, node, *others):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(path + (str(k),), v, *(o[k] for o in others))
                    for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(walk(path + (f,), getattr(node, f),
                                     *(getattr(o, f) for o in others))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            out = [walk(path + (str(i),), v, *(o[i] for o in others))
                   for i, v in enumerate(node)]
            return out if isinstance(node, list) else type(node)(out)
        return fn("/".join(path), node, *others)

    return walk((), tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`tree` with each leaf x replaced by fn(x, *the leaves of `rest` at
    the same place)."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_paths(tree: Any) -> list[tuple[str, Any]]:
    """[(path, leaf)] in JAX's flatten order: a dict's keys sorted, a
    sequence's items and a NamedTuple's fields in order."""
    out: list = []

    def walk(path, node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(path + (str(k),), node[k])
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(path + (f,), getattr(node, f))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(path + (str(i),), v)
        else:
            out.append(("/".join(path), node))

    walk((), tree)
    return out


def tree_leaves(tree: Any) -> list:
    """The leaves of `tree` in JAX's flatten order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of `like`'s structure holding `leaves`, given in JAX's
    flatten order (`tree_leaves(like)`'s)."""
    paths = [path for path, _ in tree_paths(like)]
    if len(paths) != len(leaves):
        raise ValueError(f"tree_unflatten: {len(leaves)} leaves for a tree of {len(paths)}")
    by_path = dict(zip(paths, leaves))
    return tree_map_with_path(lambda path, _: by_path[path], like)


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def cache_dir() -> Optional[Path]:
    """The persistent cache directory, or None when unwritable."""
    root = os.environ.get("REPRO_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-sven")
    try:
        p = Path(root)
        p.mkdir(parents=True, exist_ok=True)
        return p
    except OSError:
        return None


def disk_cache_load(kind: str) -> dict:
    """Read `<cache_dir>/<kind>.json`; {} on any failure."""
    d = cache_dir()
    if d is None:
        return {}
    try:
        with open(d / f"{kind}.json", encoding="utf-8") as f:
            out = json.load(f)
        return out if isinstance(out, dict) else {}
    except (OSError, ValueError):
        return {}


def disk_cache_update(kind: str, entries: dict) -> bool:
    """Merge `entries` into `<cache_dir>/<kind>.json` atomically
    (write-temp + rename, so concurrent processes see old or new, never
    torn). Returns False when persistence is unavailable."""
    d = cache_dir()
    if d is None:
        return False
    merged = disk_cache_load(kind)
    merged.update(entries)
    try:
        fd, tmp = tempfile.mkstemp(dir=d, prefix=f".{kind}-", suffix=".json")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
        os.replace(tmp, d / f"{kind}.json")
        return True
    except OSError:
        return False
