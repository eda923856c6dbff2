"""Adaptive execution routing: which layout of the ranks should run a solve?

PyTorch counterpart of `repro/core/routing.py`. Every solve routes to one
of three layouts:

    "single"   one device, the plain `sven` solve;
    "sharded"  rows of X split over the ranks (`core.distributed.
               sven_sharded`) — wins when the per-rank data pass saved beats
               collective latency plus the replicated-solver tax;
    "batch"    batch-axis fan-out (`core.batch`): each rank solves its own
               lanes with no collective — wins when the lanes' work
               amortizes the fan-out.

Decisions come from a COST MODEL, not thresholds. A one-time calibration
(`calibrate`) measures, on the mesh's own device (CUDA events and
`torch.cuda.synchronize` on a card, the host clock on the CPU):

    flops_per_s          one rank's dense GEMM rate,
    psum_latency_s       the wall time of a small all-reduce (the floor every
                         sharded iteration pays),
    psum_per_byte_s      the marginal cost of a reduced byte,
    fanout_speedup       W independent GEMM batches run one a rank at once
                         against one rank running all W: near W on separate
                         cards, near 1 when the ranks share one card,
    replicated_slowdown  the same GEMM batch run on every rank at once
                         against one rank alone (the tax the sharded path's
                         replicated Newton solve pays on a shared card),
    kernel_backend /     the RESOLVED kernel body of the dual Gram
    gram_flops_per_s     (`kernels/registry.py`: "cuda" on a card, "ref" on
                         the CPU) and its measured rate (the GEMM rate for
                         "ref", whose body is a GEMM),

and the router prices each layout's FLOPs and collectives with them. The
ranks measure together and agree on the slowest rank's times (one
all-reduce), so every rank takes the same decisions. Calibrations are
cached per (platform, rank count) in the process and on disk
(`<utils.cache_dir()>/calibration.json`, keyed (platform, rank count, torch
version); rank 0's entry is the one the ranks take). `calibrate(mesh,
force=True)` re-measures; `clear_calibration()` drops the in-process caches.

`route=` pins a path ("single", "sharded" or "batch") on every routed entry
point while still reporting the model's prices.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from repro_torch import dist

# -- effective iteration counts for pricing a solve ------------------------
#
# The model prices RELATIVE layout costs, so these only need the right order
# of magnitude (JAX's values).
DUAL_NEWTON_ITERS = 12      # projected-Newton outer steps (dual mode)
DUAL_CG_ITERS = 25          # masked-CG steps per outer step
PRIMAL_NEWTON_ITERS = 10    # Newton-CG outer steps (primal mode)
PRIMAL_CG_ITERS = 30        # CG steps per outer step
PENALIZED_EVALS = 8         # Illinois root-find SVEN evals per enet point

#: floats of the bandwidth probe's all-reduce (1 MB: well above the latency
#: floor, so the difference to a 16-float one is the bytes' cost)
_PSUM_BIG = 262_144

#: Fixed host-side overhead of any multi-rank launch — keeps the router off
#: the mesh for solves too small for the timings above to register.
MULTI_DEVICE_DISPATCH_S = 2e-4


class Calibration(NamedTuple):
    """Measured machine numbers the cost model prices layouts with."""

    devices: int
    backend: str               # the mesh's platform: "cuda" or "cpu"
    flops_per_s: float
    psum_latency_s: float
    psum_per_byte_s: float
    fanout_speedup: float
    replicated_slowdown: float
    kernel_backend: str = "ref"
    gram_flops_per_s: float = 0.0


class RouteDecision(NamedTuple):
    """One routing verdict: the chosen path and the model's price list."""

    path: str                 # "single" | "sharded" | "batch"
    costs: dict               # {path: predicted seconds} for every candidate
    calibration: Calibration
    reason: str


#: calibration cache, keyed (platform, rank count)
_CALIBRATIONS: dict = {}
#: decision cache: routing must cost microseconds on the serving path
_DECISIONS: dict = {}
#: the one-device calibration `estimate_batch_seconds` took from the disk
#: (or the shape-only default), per platform: the disk is read once
_PRICING: dict = {}

_SINGLE_DEVICE = Calibration(devices=1, backend="any", flops_per_s=1e9,
                             psum_latency_s=0.0, psum_per_byte_s=0.0,
                             fanout_speedup=1.0, replicated_slowdown=1.0)

#: the kernel body each platform resolves to (`kernels/registry.py`)
_KERNEL_BODY = {"cuda": "cuda", "cpu": "ref"}
#: the numeric fields, in the order the ranks agree on them
_NUMERIC = ("flops_per_s", "psum_latency_s", "psum_per_byte_s", "fanout_speedup",
            "replicated_slowdown", "gram_flops_per_s")


def clear_calibration() -> None:
    """Drop all in-process calibrations AND routing decisions. To force
    fresh measurements across processes, call `calibrate(mesh, force=True)`
    or delete `<utils.cache_dir()>/calibration.json`."""
    _CALIBRATIONS.clear()
    _DECISIONS.clear()
    _PRICING.clear()


def _platform(mesh: Optional[dist.Mesh]) -> str:
    """The device type the mesh's ranks compute on."""
    if mesh is not None and mesh.device is not None:
        return torch.device(mesh.device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _device(mesh: Optional[dist.Mesh]) -> torch.device:
    if mesh is not None and mesh.device is not None:
        return torch.device(mesh.device)
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")


def _disk_key(platform: str, ndev: int) -> str:
    return f"{platform}|{ndev}dev|torch{torch.__version__}"


def _load_disk_calibration(platform: str, ndev: int):
    from repro_torch import utils

    entry = utils.disk_cache_load("calibration").get(_disk_key(platform, ndev))
    if not isinstance(entry, dict) or set(entry) != set(Calibration._fields):
        return None
    try:
        return Calibration(**entry)
    except TypeError:
        return None


def _store_disk_calibration(cal: Calibration) -> None:
    from repro_torch import utils

    utils.disk_cache_update(
        "calibration", {_disk_key(cal.backend, cal.devices): cal._asdict()})


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_of(fn, dev: torch.device, reps: int = 3) -> float:
    """Best wall seconds of fn() over `reps` runs after one warm run, each
    ended by a device synchronize."""
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _gram_kernel_rate(flops_per_s: float, dev: torch.device) -> tuple:
    """(resolved kernel body, measured Gram FLOPs/s) on `dev`: the CUDA
    Gram is measured; the "ref" body keeps the GEMM rate."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import registry

    n, p = (65536 if dev.type == "cuda" else 2048), 256
    X = torch.ones(n, p, dtype=torch.float32, device=dev)
    y = torch.ones(n, dtype=torch.float32, device=dev)
    kb = registry.resolve_kernel_backend(None, X)
    if kb == "ref":
        return kb, flops_per_s
    t = _best_of(lambda: kops.shifted_gram(X, y, 1.0, backend=kb), dev)
    return kb, (2.0 * n * p * p) / max(t, 1e-9)


def _measure(mesh: dist.Mesh, dev: torch.device) -> Calibration:
    """Every rank's probes; the ranks agree on the slowest rank's times."""
    ndev = mesh.size
    m, reps = (1024, 8) if dev.type == "cuda" else (192, 4)   # GEMM probe: 2 m^3 FLOPs
    A = torch.ones(m, m, dtype=torch.float32, device=dev)

    def gemms(k):
        for _ in range(k):
            torch.mm(A, A)

    t_gemm = _best_of(lambda: gemms(reps), dev) / reps
    flops_per_s = (2.0 * m ** 3) / max(t_gemm, 1e-9)
    kernel_backend, gram_flops_per_s = _gram_kernel_rate(flops_per_s, dev)
    if ndev <= 1:
        return Calibration(devices=ndev, backend=dev.type, flops_per_s=flops_per_s,
                           psum_latency_s=0.0, psum_per_byte_s=0.0, fanout_speedup=1.0,
                           replicated_slowdown=1.0, kernel_backend=kernel_backend,
                           gram_flops_per_s=gram_flops_per_s)

    barrier = torch.zeros(1, device=dev)

    def per_all_reduce(x, k=10):
        """Seconds an all-reduce of x, over k back to back after the ranks
        meet (one call alone would time the ranks' arrival skew)."""
        best = float("inf")
        for _ in range(3):
            dist.all_reduce(mesh, barrier)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(k):
                dist.all_reduce(mesh, x)
            _sync(dev)
            best = min(best, (time.perf_counter() - t0) / k)
        return best

    t_small = per_all_reduce(torch.ones(16, dtype=torch.float32, device=dev))  # latency
    t_big = per_all_reduce(torch.ones(_PSUM_BIG, dtype=torch.float32, device=dev))  # 1 MB

    def alone(k):
        """k GEMMs on rank 0 while the others wait; every rank gets the time."""
        t = _best_of(lambda: gemms(k), dev) if mesh.rank == 0 else 0.0
        return float(dist.all_reduce(mesh, torch.tensor([t], dtype=torch.float64,
                                                        device=dev))[0])

    def together(k):
        """k GEMMs on every rank at once (started by an all-reduce); the
        slowest rank's best time."""
        best = float("inf")
        for _ in range(4):
            dist.all_reduce(mesh, barrier)
            _sync(dev)
            t0 = time.perf_counter()
            gemms(k)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        return float(dist.all_reduce(mesh, torch.tensor([best], dtype=torch.float64,
                                                       device=dev), op="max")[0])

    t_one = alone(reps)              # one rank's batch of GEMMs
    t_seq = alone(ndev * reps)       # one rank doing every rank's batch
    t_par = together(reps)           # every rank its own batch at once
    # the ranks agree on the slowest rank's measurements
    agreed = dist.all_reduce(mesh, torch.tensor(
        [t_gemm, 1.0 / gram_flops_per_s, t_small, t_big], dtype=torch.float64,
        device=dev), op="max").tolist()
    t_gemm, inv_gram, t_small, t_big = agreed
    return Calibration(devices=ndev, backend=dev.type,
                       flops_per_s=(2.0 * m ** 3) / max(t_gemm, 1e-9),
                       psum_latency_s=t_small,
                       psum_per_byte_s=max(t_big - t_small, 0.0) / (_PSUM_BIG * 4),
                       fanout_speedup=max(t_seq / max(t_par, 1e-9), 1e-3),
                       replicated_slowdown=max(t_par / max(t_one, 1e-9), 1.0),
                       kernel_backend=kernel_backend, gram_flops_per_s=1.0 / inv_gram)


def calibrate(mesh: Optional[dist.Mesh] = None, *, force: bool = False) -> Calibration:
    """Measure the mesh once; cached per (platform, rank count).

    A mesh of one rank (or None) measures only the GEMM and Gram rates. On
    more ranks every rank must call this together (the probes are
    collectives), and every rank returns the same calibration: rank 0's
    disk entry when it has one, else the slowest rank's measurements.
    """
    ndev = mesh.size if mesh is not None else 1
    platform = _platform(mesh)
    key = (platform, ndev)
    if not force and key in _CALIBRATIONS:
        return _CALIBRATIONS[key]
    cal = None
    if not force:
        cal = _load_disk_calibration(platform, ndev)
        if ndev > 1:     # rank 0's entry, or none for any rank
            vals = [1.0] + [float(getattr(cal, f)) for f in _NUMERIC] if cal else [0.0] * 7
            vals = dist.agree(mesh, torch.tensor(vals, dtype=torch.float64,
                                                 device=_device(mesh))).tolist()
            cal = None if vals[0] == 0.0 else Calibration(
                devices=ndev, backend=platform, kernel_backend=_KERNEL_BODY[platform],
                **dict(zip(_NUMERIC, vals[1:])))
    if cal is None:
        cal = _measure(mesh if mesh is not None else dist.Mesh(), _device(mesh))
        if mesh is None or mesh.rank == 0:
            _store_disk_calibration(cal)
        _DECISIONS.clear()
    _CALIBRATIONS[key] = cal
    return cal


# -- the cost model ---------------------------------------------------------

def _psum_cost(cal: Calibration, floats: float) -> float:
    return cal.psum_latency_s + floats * 8.0 * cal.psum_per_byte_s


def _solve_flops(n: int, p: int, mode: str) -> tuple:
    """(data-pass FLOPs over X, solver-iteration FLOPs) for one SVEN solve.

    dual: one Gram pass 2np^2 then Newton on the (2p, 2p) kernel — each
    outer step's masked CG does a K matvec, 2(2p)^2 FLOPs. primal: every
    Newton-CG product is a matvec + rmatvec pair over X, ~8np each.
    """
    if mode == "dual":
        data = 2.0 * n * p * p
        iters = DUAL_NEWTON_ITERS * (DUAL_CG_ITERS + 3) * 2.0 * (2 * p) ** 2
    else:
        data = 0.0
        iters = (PRIMAL_NEWTON_ITERS * (PRIMAL_CG_ITERS + 3)) * 8.0 * n * p
    return data, iters


def _solve_costs(n: int, p: int, mode: str, cal: Calibration) -> dict:
    """Predicted seconds for one solve under each layout."""
    F = cal.flops_per_s
    G = cal.gram_flops_per_s or F
    data, iters = _solve_flops(n, p, mode)
    costs = {"single": data / G + iters / F}
    if cal.devices > 1:
        if mode == "dual":
            # the data pass splits perfectly (one all-reduce closes it); the
            # projected Newton runs REPLICATED on the assembled kernel
            sharded = (data / (G * cal.fanout_speedup * cal.devices)
                       + _psum_cost(cal, p * p + p + 1)
                       + iters * cal.replicated_slowdown / F
                       + 2.0 * cal.psum_latency_s      # w recovery + kkt
                       + MULTI_DEVICE_DISPATCH_S)
        else:
            # every Newton-CG product: local O(np / W) work + one
            # all-reduce of p + 1 floats + one gather of the n-vector
            products = PRIMAL_NEWTON_ITERS * (PRIMAL_CG_ITERS + 3)
            per_product = (8.0 * n * p / (F * cal.fanout_speedup * cal.devices)
                           + _psum_cost(cal, p + 1) + _psum_cost(cal, n))
            sharded = products * per_product + MULTI_DEVICE_DISPATCH_S
        costs["sharded"] = sharded
    return costs


def _batch_costs(n: int, p: int, B: int, mode: str, cal: Calibration,
                 points: int) -> dict:
    """Predicted seconds for a B-problem stack: one device against
    batch-axis fan-out (each rank B / W lanes, no collective)."""
    data, iters = _solve_flops(n, p, mode)
    lane = points * (data + iters) / cal.flops_per_s
    costs = {"single": B * lane}
    if cal.devices > 1:
        costs["batch"] = B * lane / cal.fanout_speedup + MULTI_DEVICE_DISPATCH_S
    return costs


def _decide(costs: dict, cal: Calibration, pinned: Optional[str]) -> RouteDecision:
    if pinned is not None:
        decision = RouteDecision(path=pinned, costs=costs, calibration=cal,
                                 reason=f"pinned route={pinned!r}")
    else:
        path = min(costs, key=costs.get)
        others = {k: v for k, v in costs.items() if k != path}
        margin = (min(others.values()) / max(costs[path], 1e-12)
                  if others else float("inf"))
        decision = RouteDecision(path=path, costs=costs, calibration=cal,
                                 reason=f"cost model: {path} wins {margin:.2f}x")
    # telemetry: each FRESH verdict counts on the process registry and
    # drops a trace instant carrying the price table the model compared
    from repro_torch.obs.metrics import default_registry
    from repro_torch.obs.trace import get_tracer

    default_registry().counter(
        "route_decisions_total", "cost-model routing verdicts",
        ("path",)).inc(path=decision.path)
    get_tracer().instant("route", path=decision.path, costs=dict(costs),
                         reason=decision.reason)
    return decision


def _resolve_route_mesh(mesh):
    """None -> the innermost mesh_context, else the process's data mesh."""
    if mesh is None:
        ctx = dist.current_context()
        mesh = ctx[0] if ctx is not None else dist.data_mesh()
    return mesh


def _one_device() -> RouteDecision:
    return RouteDecision(path="single", costs={"single": 0.0}, calibration=_SINGLE_DEVICE,
                         reason="one device: nothing to route")


def route_solve(n: int, p: int, *, mesh: Optional[dist.Mesh] = None,
                config=None, route: str = "auto") -> RouteDecision:
    """Price one (n, p) solve on `mesh` and pick single-device vs sharded.
    `route` pins the verdict ("single" / "sharded") while still reporting
    the model's prices."""
    if route not in ("auto", "single", "sharded"):
        raise ValueError(f"route_solve: route must be auto|single|sharded, "
                         f"got {route!r}")
    from repro_torch.core.sven import SvenConfig, _pick_mode

    cfg = SvenConfig() if config is None else config
    mesh = _resolve_route_mesh(mesh)
    if mesh.size <= 1:
        return _one_device()
    mode = _pick_mode(n, p, cfg)
    cal = calibrate(mesh)
    key = ("solve", n, p, mesh.size, cal.backend, mode, route)
    if key not in _DECISIONS:
        _DECISIONS[key] = _decide(_solve_costs(n, p, mode, cal), cal,
                                  None if route == "auto" else route)
    return _DECISIONS[key]


def route_batch(n: int, p: int, batch_size: int, mesh: Optional[dist.Mesh] = None, *,
                form: str = "constrained", points: int = 1,
                route: str = "auto") -> RouteDecision:
    """Price a stacked B-problem launch: one device against batch-axis
    fan-out. `form="penalized"` scales each lane by the Illinois root-find's
    solve count; `points` by the grid points a lane walks (CV). Whether the
    mesh divides B is the caller's concern (`batch.batch_mesh`)."""
    if route not in ("auto", "single", "batch"):
        raise ValueError(f"route_batch: route must be auto|single|batch, "
                         f"got {route!r}")
    from repro_torch.core.sven import SvenConfig, _pick_mode

    mesh = _resolve_route_mesh(mesh)
    if mesh.size <= 1:
        return _one_device()
    mode = _pick_mode(n, p, SvenConfig())
    cal = calibrate(mesh)
    pts = points * (PENALIZED_EVALS if form == "penalized" else 1)
    key = ("batch", n, p, batch_size, pts, mesh.size, cal.backend, mode, route)
    if key not in _DECISIONS:
        _DECISIONS[key] = _decide(_batch_costs(n, p, batch_size, mode, cal, pts), cal,
                                  None if route == "auto" else route)
    return _DECISIONS[key]


def estimate_batch_seconds(n: int, p: int, batch_size: int, *,
                           form: str = "constrained", device=None) -> float:
    """Modeled one-device seconds for a stacked B-problem (n, p) solve: the
    "single" price with whatever calibration is already known for
    `device`'s platform (in-process, then disk, then the shape-only
    default; the disk is read once a process). Never measures: it runs on
    the admission path (`ContinuousScheduler` calibrates when it is built)."""
    platform = (torch.device(device).type if device is not None
                else ("cuda" if torch.cuda.is_available() else "cpu"))
    cal = _CALIBRATIONS.get((platform, 1))
    if cal is None:
        if platform not in _PRICING:
            _PRICING[platform] = _load_disk_calibration(platform, 1) or _SINGLE_DEVICE
        cal = _PRICING[platform]
    from repro_torch.core.sven import SvenConfig, _pick_mode

    mode = _pick_mode(n, p, SvenConfig())
    pts = PENALIZED_EVALS if form == "penalized" else 1
    return _batch_costs(n, p, batch_size, mode, cal, pts)["single"]


def sven_routed(X, y, t, lambda2, config=None, *, mesh: Optional[dist.Mesh] = None,
                route: str = "auto", warm_alpha=None, warm_w=None):
    """`sven` with the layout chosen by the cost model — the multi-rank
    entry point: single-device `sven` or row-sharded `sven_sharded`
    (within solver tolerance either way); `route` pins the path. Mesh
    resolution as `sven_sharded`'s. Every rank calls it alike."""
    from repro_torch.core.distributed import sven_sharded
    from repro_torch.core.sven import SvenConfig, sven

    cfg = SvenConfig() if config is None else config
    n, p = X.shape
    mesh = _resolve_route_mesh(mesh)
    decision = route_solve(n, p, mesh=mesh, config=cfg, route=route)
    if decision.path == "single":
        return sven(X, y, t, lambda2, cfg, warm_alpha=warm_alpha, warm_w=warm_w)
    return sven_sharded(X, y, t, lambda2, cfg, mesh=mesh,
                        warm_alpha=warm_alpha, warm_w=warm_w)
