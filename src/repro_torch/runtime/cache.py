"""Warm-start solution cache for the serving runtime (DESIGN.md §8).

The port of `repro/runtime/cache.py` (numpy and hashlib only, so nearly a
copy): the same keys, digests, neighborhoods and tiers.

The paper's own warm-start observation — solutions at adjacent points of the
regularization surface are near-identical, which is why `sven_path` carries
(alpha, w) down the t-grid — is exactly the structure serving traffic has:
the same dataset re-solved at a new lambda (hyperparameter sweeps, CV-like
exploration, online refresh). The cache keys solved problems by

    (data fingerprint, problem form)  ->  [ (lambda-point, solution), ... ]

and answers a lookup with the stored solution whose regularization point is
NEAREST in log-space, provided it falls inside the `neighborhood` radius.
The hit is fed back into `sven_batch` / `enet_batch` as a warm start — never
returned directly — so a hit changes iteration count, not the answer:
repeat and adjacent-lambda traffic re-solves in a few Newton steps instead
of from cold.

Stored warm arrays live in the PADDED bucket geometry the scheduler solves
in (a fingerprint maps to one bucket, since buckets are shape-derived), so
a hit is handed straight to the stacked solve with no re-layout.

Two tiers (DESIGN.md §11.2): `SolutionCache` is the in-process memory tier
and dies with its process. `TieredSolutionCache` backs it with a
`PersistentCacheTier` — one ``.npz`` file per stored point under a shared
spill directory, written with the same atomic tmp+rename discipline as
`utils.disk_cache_update`, TTL- and size-bounded. Because keys are blake2b
CONTENT fingerprints, spilled entries survive restarts and are shared by
every host pointed at the same directory: a restarted (or sibling) server
warm-starts from work another process already paid for. Every disk failure
mode — corrupt/truncated file, wrong fingerprint, races with eviction —
degrades to a MISS, never to an exception on the serving path.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import math
import os
import tempfile
import zipfile
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.obs import clock as obs_clock
from repro_torch.obs import events as obs_events
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer

#: Problem forms the runtime serves; the cache keeps them in disjoint keys
#: because their lambda-points live on different axes (t vs lambda1).
CONSTRAINED = "constrained"
PENALIZED = "penalized"


def fingerprint_problem(X, y) -> str:
    """Content hash of one (X, y) problem: shape + exact bytes.

    blake2b over the raw buffers — a repeat submission of the same data hits
    the same key; any changed entry (even 1 ulp) is a different problem.
    Costs one host pass over X, negligible next to a solve.
    """
    h = hashlib.blake2b(digest_size=16)
    Xh = np.asarray(X)
    yh = np.asarray(y)
    h.update(str((Xh.shape, str(Xh.dtype))).encode())
    h.update(Xh.tobytes())
    h.update(yh.tobytes())
    return h.hexdigest()


class WarmEntry(NamedTuple):
    """One cached solution at one point of the regularization surface.

    Arrays are HOST (numpy) copies in the padded bucket geometry: a hit is
    a memcpy into the next launch's warm buffers, no device round trip."""

    lam: float            # the lambda-point: t (constrained) or lambda1
    lambda2: float
    alpha: np.ndarray     # (2*bp,) dual iterate, padded bucket geometry
    w: np.ndarray         # (bn,) primal iterate, padded bucket geometry
    beta: np.ndarray      # (bp,) padded solution (penalized warm screening)
    t: float              # L1 budget of the stored solution
    nu: float             # multiplier at the stored solution (penalized)


def _log_distance(a: float, b: float) -> float:
    """|log(a/b)| on the positive lambda axis, with the zero edge exact.

    lambda = 0 is a FORM boundary, not a small lambda: lambda1 = 0 is pure
    ridge and lambda2 = 0 is the Lasso. It gets its own point on the key
    axis — distance 0 to another exact zero (lasso-only / ridge-only repeat
    traffic warm-starts itself) and +inf to any positive lambda (a
    regularized entry never masquerades as the edge form, and log(0) is
    never evaluated). The previous eps-floored `log((|a|+eps)/(|b|+eps))`
    broke both ways at the edges: genuinely tiny lambdas collapsed onto the
    floor (1e-13 vs 1e-14 scored as "adjacent"), and an entry within eps of
    zero scored finite distance to the exact edge.
    """
    a, b = abs(a), abs(b)
    if a == 0.0 and b == 0.0:
        return 0.0
    if a == 0.0 or b == 0.0:
        return math.inf
    return abs(math.log(a / b))


class SolutionCache:
    """LRU cache of solved problems, bounded per problem and overall.

    `neighborhood` is the hit radius in log-lambda space: an entry at
    (lam_e, lambda2_e) warm-starts a request at (lam_r, lambda2_r) when
    |log(lam_r/lam_e)| + |log(lambda2_r/lambda2_e)| <= neighborhood. The
    default (1.0 ~ one e-fold) is deliberately wide — a warm start is an
    initial iterate, so a far hit costs extra iterations, never correctness.

    Hit/miss accounting lives on a `MetricsRegistry`
    (``cache_lookups_total{result=hit|miss}``, DESIGN.md §12.2) — the
    scheduler passes its own so cache counters export with the rest of its
    telemetry; the historical ``hits`` / ``misses`` ints remain as
    read-through properties.
    """

    def __init__(self, *, max_problems: int = 128, per_problem: int = 8,
                 neighborhood: float = 1.0,
                 registry: Optional[MetricsRegistry] = None) -> None:
        if max_problems < 1 or per_problem < 1 or neighborhood <= 0:
            raise ValueError(
                f"SolutionCache: max_problems/per_problem must be >= 1 and "
                f"neighborhood > 0 (got {max_problems}/{per_problem}/"
                f"{neighborhood})")
        self.max_problems = max_problems
        self.per_problem = per_problem
        self.neighborhood = neighborhood
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lookups = self.registry.counter(
            "cache_lookups_total",
            "warm-start cache lookups by result", ("result",))
        self._store: "collections.OrderedDict[Tuple[str, str], list]" = (
            collections.OrderedDict())

    def __len__(self) -> int:
        return sum(len(v) for v in self._store.values())

    @property
    def hits(self) -> int:
        return int(self._lookups.value(result="hit"))

    @property
    def misses(self) -> int:
        return int(self._lookups.value(result="miss"))

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_counters(self) -> None:
        self.registry.reset_instrument("cache_lookups_total")

    def _search(self, fp: str, form: str, lam: float,
                lambda2: float) -> Tuple[Optional[WarmEntry], float]:
        """(nearest stored entry, its log-distance) — no counters, no
        neighborhood cut; callers decide what a hit means."""
        entries = self._store.get((fp, form))
        if not entries:
            return None, math.inf
        self._store.move_to_end((fp, form))
        best = min(entries, key=lambda e: (_log_distance(lam, e.lam)
                                           + _log_distance(lambda2,
                                                           e.lambda2)))
        return best, (_log_distance(lam, best.lam)
                      + _log_distance(lambda2, best.lambda2))

    def lookup(self, fp: str, form: str, lam: float, lambda2: float, *,
               count: bool = True) -> Optional[WarmEntry]:
        """Nearest stored solution within the neighborhood, else None.

        `count=False` leaves the hit/miss counters untouched — the
        scheduler's SPECULATIVE warm-start lookups use it so the reported
        hit rate keeps measuring client traffic only."""
        best, dist = self._search(fp, form, lam, lambda2)
        if best is not None and dist <= self.neighborhood:
            if count:
                self._lookups.inc(result="hit")
            return best
        if count:
            self._lookups.inc(result="miss")
        return None

    def probe(self, fp: str, form: str, lam: float, lambda2: float, *,
              radius: float = 1e-9) -> bool:
        """True when a stored point sits within `radius` of the query —
        i.e. this exact point is already solved. Counter-free; the
        scheduler's speculation uses it to skip predicting known points."""
        _, dist = self._search(fp, form, lam, lambda2)
        return dist <= radius

    def insert(self, fp: str, form: str, entry: WarmEntry) -> None:
        """Store a solved point; evicts the nearest-lambda duplicate first,
        then the oldest, keeping at most `per_problem` spread-out points."""
        key = (fp, form)
        entries = self._store.get(key)
        if entries is None:
            if len(self._store) >= self.max_problems:
                self._store.popitem(last=False)   # LRU problem eviction
            entries = []
            self._store[key] = entries
        else:
            self._store.move_to_end(key)
            same = [e for e in entries
                    if _log_distance(entry.lam, e.lam)
                    + _log_distance(entry.lambda2, e.lambda2) < 1e-9]
            for e in same:
                entries.remove(e)
        entries.append(entry)
        if len(entries) > self.per_problem:
            entries.pop(0)


# ---------------------------------------------------------------------------
# Persistent spill tier (DESIGN.md §11.2)
# ---------------------------------------------------------------------------

#: Errors a spilled entry can fail to load with. Anything here means "this
#: file is not a usable cache entry" — the tier deletes it and reports a
#: miss; it NEVER propagates into the solve path.
_LOAD_ERRORS = (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile)


def _point_digest(lam: float, lambda2: float) -> str:
    """Filename-safe digest of one exact regularization point."""
    h = hashlib.blake2b(digest_size=8)
    h.update(float(lam).hex().encode())
    h.update(float(lambda2).hex().encode())
    return h.hexdigest()


class PersistentCacheTier:
    """Disk spill tier: one atomic ``.npz`` per (fingerprint, form, point).

    Layout: ``<root>/<fp>.<form>.<point-digest>.npz`` — the fingerprint is
    the blake2b content hash of (X, y), so the same problem submitted to a
    different process (or after a restart) resolves to the same files. Two
    inserts at the same exact point overwrite each other (tmp + rename:
    concurrent writers race benignly, readers see old or new, never torn).

    Bounds: `ttl_s` ages entries out (checked at lookup and by `expire()`);
    `max_bytes` LRU-evicts by mtime, which `lookup` refreshes on a hit, so
    hot entries survive. `root=None` resolves under `utils.cache_dir()`
    (the ``REPRO_CACHE_DIR`` override applies); an unwritable root disables
    the tier — every operation degrades to miss/no-op, never raises.
    """

    def __init__(self, root=None, *, max_bytes: int = 64 << 20,
                 ttl_s: Optional[float] = None,
                 clock=obs_clock.walltime) -> None:
        if max_bytes < 1 or (ttl_s is not None and ttl_s <= 0):
            raise ValueError(f"PersistentCacheTier: need max_bytes >= 1 and "
                             f"ttl_s > 0 or None (got {max_bytes}/{ttl_s})")
        if root is None:
            from repro_torch.utils import cache_dir
            base = cache_dir()
            root = None if base is None else base / "warm"
        self.root: Optional[Path] = None
        if root is not None:
            try:
                p = Path(root)
                p.mkdir(parents=True, exist_ok=True)
                self.root = p
            except OSError:
                self.root = None
        self.max_bytes = max_bytes
        self.ttl_s = ttl_s
        self.clock = clock
        self.corrupt_dropped = 0
        self.expired_dropped = 0
        self.evicted = 0

    # -- file plumbing -----------------------------------------------------

    def _path(self, fp: str, form: str, lam: float, lambda2: float) -> Path:
        return self.root / f"{fp}.{form}.{_point_digest(lam, lambda2)}.npz"

    def _drop(self, path: Path) -> None:
        with contextlib.suppress(OSError):
            path.unlink()

    def _load(self, path: Path, fp: str):
        """(WarmEntry, created-timestamp) or (None, None); a file that
        cannot be loaded, fails its fingerprint check, or has inconsistent
        geometry is deleted on the spot — corruption degrades to miss."""
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["fingerprint"]) != fp:
                    raise ValueError("fingerprint mismatch")
                entry = WarmEntry(
                    lam=float(z["lam"]), lambda2=float(z["lambda2"]),
                    alpha=np.asarray(z["alpha"], np.float64),
                    w=np.asarray(z["w"], np.float64),
                    beta=np.asarray(z["beta"], np.float64),
                    t=float(z["t"]), nu=float(z["nu"]))
                created = float(z["created"])
            if (entry.alpha.ndim != 1 or entry.w.ndim != 1
                    or entry.beta.ndim != 1
                    or entry.alpha.shape[0] != 2 * entry.beta.shape[0]):
                raise ValueError("inconsistent warm-array geometry")
            return entry, created
        except _LOAD_ERRORS as e:
            self.corrupt_dropped += 1
            obs_events.emit("cache_corrupt", path=path.name,
                            error=type(e).__name__)
            self._drop(path)
            return None, None

    # -- tier interface ----------------------------------------------------

    def __len__(self) -> int:
        if self.root is None:
            return 0
        return sum(1 for _ in self.root.glob("*.npz"))

    def total_bytes(self) -> int:
        if self.root is None:
            return 0
        total = 0
        for path in self.root.glob("*.npz"):
            with contextlib.suppress(OSError):
                total += path.stat().st_size
        return total

    def lookup(self, fp: str, form: str, lam: float, lambda2: float, *,
               neighborhood: float = 1.0) -> Optional[WarmEntry]:
        """Nearest spilled point within `neighborhood`, else None. A hit
        refreshes the file's mtime (the LRU clock)."""
        if self.root is None or fp is None:
            return None
        best, best_d, best_path = None, math.inf, None
        for path in self.root.glob(f"{fp}.{form}.*.npz"):
            entry, created = self._load(path, fp)
            if entry is None:
                continue
            if self.ttl_s is not None and self.clock() - created > self.ttl_s:
                self.expired_dropped += 1
                self._drop(path)
                continue
            d = (_log_distance(lam, entry.lam)
                 + _log_distance(lambda2, entry.lambda2))
            if d < best_d:
                best, best_d, best_path = entry, d, path
        if best is not None and best_d <= neighborhood:
            with contextlib.suppress(OSError):
                os.utime(best_path)
            return best
        return None

    def insert(self, fp: str, form: str, entry: WarmEntry) -> bool:
        """Spill one solved point atomically; False when the tier is
        disabled or the write fails (both are silent no-ops upstream)."""
        if self.root is None or fp is None:
            return False
        try:
            fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".spill-")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, fingerprint=fp, form=form,
                             created=float(self.clock()),
                             lam=float(entry.lam),
                             lambda2=float(entry.lambda2),
                             alpha=np.asarray(entry.alpha, np.float64),
                             w=np.asarray(entry.w, np.float64),
                             beta=np.asarray(entry.beta, np.float64),
                             t=float(entry.t), nu=float(entry.nu))
                os.replace(tmp, self._path(fp, form, entry.lam, entry.lambda2))
            finally:
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
        except OSError:
            return False
        self._enforce_bound()
        return True

    def expire(self) -> int:
        """Drop every TTL-expired entry now; returns the number removed."""
        if self.root is None or self.ttl_s is None:
            return 0
        dropped = 0
        for path in list(self.root.glob("*.npz")):
            try:
                with np.load(path, allow_pickle=False) as z:
                    created = float(z["created"])
            except _LOAD_ERRORS as e:
                self.corrupt_dropped += 1
                obs_events.emit("cache_corrupt", path=path.name,
                                error=type(e).__name__)
                self._drop(path)
                continue
            if self.clock() - created > self.ttl_s:
                self.expired_dropped += 1
                self._drop(path)
                dropped += 1
        return dropped

    def _enforce_bound(self) -> None:
        """LRU-evict (oldest mtime first) until under `max_bytes`."""
        files = []
        for path in self.root.glob("*.npz"):
            with contextlib.suppress(OSError):
                st = path.stat()
                files.append((st.st_mtime, st.st_size, path))
        total = sum(size for _, size, _ in files)
        files.sort()
        while total > self.max_bytes and files:
            _, size, path = files.pop(0)
            self._drop(path)
            self.evicted += 1
            total -= size


class TieredSolutionCache(SolutionCache):
    """Memory tier backed by a persistent spill tier (write-through).

    Lookups search memory first; on a memory miss the spill tier is
    consulted and a spill hit is PROMOTED into memory (so the disk pays
    once per process per point). Inserts write through to both tiers.
    The hit/miss counters on THIS object are the authoritative serving
    metrics (spill hits count as hits, broken out in `spill_hits`); the
    inherited memory-tier machinery never double-counts because this class
    owns every counted path.
    """

    def __init__(self, *, max_problems: int = 128, per_problem: int = 8,
                 neighborhood: float = 1.0,
                 spill: Optional[PersistentCacheTier] = None,
                 spill_dir=None, max_bytes: int = 64 << 20,
                 ttl_s: Optional[float] = None, clock=obs_clock.walltime,
                 registry: Optional[MetricsRegistry] = None) -> None:
        super().__init__(max_problems=max_problems, per_problem=per_problem,
                         neighborhood=neighborhood, registry=registry)
        if spill is None:
            spill = PersistentCacheTier(spill_dir, max_bytes=max_bytes,
                                        ttl_s=ttl_s, clock=clock)
        self.spill = spill
        self._spill_hits = self.registry.counter(
            "cache_spill_hits_total",
            "memory-tier misses served by the persistent spill tier")

    @property
    def spill_hits(self) -> int:
        return int(self._spill_hits.value())

    def lookup(self, fp: str, form: str, lam: float, lambda2: float, *,
               count: bool = True) -> Optional[WarmEntry]:
        best, dist = self._search(fp, form, lam, lambda2)
        if best is not None and dist <= self.neighborhood:
            if count:
                self._lookups.inc(result="hit")
            return best
        spilled = self.spill.lookup(fp, form, lam, lambda2,
                                    neighborhood=self.neighborhood)
        if spilled is not None:
            super().insert(fp, form, spilled)      # promote, memory only
            get_tracer().instant("cache.spill_promote", form=form)
            if count:
                self._lookups.inc(result="hit")
                self._spill_hits.inc()
            return spilled
        if count:
            self._lookups.inc(result="miss")
        return None

    def insert(self, fp: str, form: str, entry: WarmEntry) -> None:
        super().insert(fp, form, entry)
        self.spill.insert(fp, form, entry)

    def reset_counters(self) -> None:
        super().reset_counters()
        self.registry.reset_instrument("cache_spill_hits_total")
