"""The port's small on-disk JSON cache (the jax-free part of
`repro/utils.py`, which imports jax, so the port keeps its own copy).

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
from typing import Optional


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
