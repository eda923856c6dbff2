#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, then drives the
port's main path through the entry points a user calls:

  1. setup: card name and power limit, kernel build, TF32 off for matmuls;
  2. each kernel vs its plain version at the main path's shapes and at a
     ragged small shape, with its time, the plain version's time and the
     least time the card could take (its bound); the Gram in f32, tf32,
     bf16 and float64, each beside cuBLAS's A^T A of A = [X, y] in the
     same type, its two launches apart in every mode (device times from
     torch.profiler, in a child process: `--gram-split`); both
     hinge passes in f32, bf16 and float64 (what a float64 problem runs at
     the default precision), beside the cuBLAS GEMVs X^T v and X d;
  3. the dual solve at the shape of UCI YearPredictionMSD (n = 463,715,
     p = 90), default config (float64 Gram), bf16 + refinement and tf32 +
     refinement, against the plain float64 solve ("torch" backend) on the
     card; the default solve again with the CG loop reading its test
     before every step (k = 1), bitwise the same;
  4. the primal solve at the shape of GLA-BRA-180 (n = 180, p = 49,151),
     default config (float64 hinge passes), against the plain float64
     solve: its answer, Newton steps and CG steps, and again at k = 1,
     bitwise the same; then (4b) the same
     problem on float32 data (the passes' float32 bodies) and at precision
     "bf16" (X stored in bfloat16), each against the plain run in its
     precision and against the float64 solve;
  5. `sven_path` over an 8-point t-grid at the primal shape, against
     `sven_path_reference` (the same kernels, solved point by point) and
     against the plain float64 path ("torch" backend), with both CG counts;
  6. the public op `kernels.hinge_stats` (the hinge-stats kernel) at the
     primal solve's w (GLA-BRA-180 shape), the dual solve's w (YMSD shape)
     and a ragged shape, in f32 and bf16, against its plain version, with
     its route, its times L2 cold and warm, the plain version's, a GEMV's
     and its bound (the JSON row's `by_case`);
  7. the penalized front end: `enet_path` over a 10-point lambda grid at the
     YMSD shape (dual: one Gram launch per Illinois evaluation) and
     `ElasticNet(...).fit` with standardization and intercept at the
     GLA-BRA-180 shape (primal: one launch of each hinge pass per CG step),
     each against the same call on the plain float64 backend;
  8. a float32 problem at the default precision: the dual solve and
     `enet_path` over the first 5 points of the 10-point lambda grid at the
     YMSD shape, whose Grams run the kernel's
     float32 body, against the same calls on the port's plain float32
     backend ("torch") on the same tensors;
  9. `sven_batch` (float64, default config), each lane bitwise the port's
     sequential `sven` on it: (9a) a 3 x 3 `en_grid` of (t, lambda2) on a
     shared GLA-BRA-180-shaped X (9 primal lanes), (9b) `cv_folds(X, y, 5)`
     of it (stacked X), (9c) `cv_folds` at the YMSD shape (5 dual lanes);
     the lane-batched hinge passes first at 9a's and 9b's operands (each
     also with X in float32 and bfloat16), each with its route (a shared X
     takes the shared-X route, a stacked one the stacked route), against
     their plain version and single launches, timed beside B single
     launches, the bound and one `torch.mm` / `torch.bmm`; each lane's
     Newton and CG lists of 9a and 9b against the ones PERF.md records;
     each case again at k = 1, bitwise the same;
 11. the lane-batched penalized stack (float64, default config), each
     fold or lane a lane of one Illinois root-find: (11a)
     `ElasticNetCV(k=5, n_lambdas=10)` at the GLA-BRA-180 shape (primal
     folds) and (11b) `cross_validate(k=5, n_lambdas=10)` at the YMSD
     shape (dual folds), each against the port's sequential
     `cross_validate_reference` on the same data (mse within 1e-10 x max,
     the same index_min, equal evaluations and kept columns per (lambda,
     fold)) and its refit bitwise `enet` at lambda_min; (11c) `enet_batch`
     on 5 stacked folds of 11a, cold and then warm from the cold carry on
     lanes 0, 2 and 4, each lane bitwise the sequential `_enet_point` on
     fresh copies of its operands. The hinge launches, lane-batched plus
     single (one lane left), equal the batched CG steps; the dual launches
     one Gram per lane and evaluation;
 12. the serving runtime (float64, default config): (12a) 2 waves of 10
     requests on one GLA-BRA-180-shaped data set (a fifth of them
     penalized; bucket 256 x 65,536, primal; the constrained requests at
     0.01 x the loadgen's t, where the l1 constraint binds) played open
     loop into one
     `ContinuousScheduler(max_batch=8, max_wait=None, fixed_batch=True)`
     with its warm-start cache, each wave also drained cold by
     `ElasticNetEngine(max_batch=8, cache=None).drain_reference()`, and
     (12b) the same at the YMSD shape (5 requests a wave, bucket 524,288 x
     128, dual, max_batch=4): every
     request "ok", each beta within 1e-6 of the reference's, the first two
     of each wave within 1e-6 of a direct `sven` / `enet` on the unpadded
     problem, wave 2 with a cache hit, no more Newton steps than the cold
     reference and no new launch shape, the hinge (12a) or Gram (12b)
     kernels launched; (12c) `OnlineElasticNet` fed the YMSD rows in blocks
     of 16,384, solved at t and warm at 1.03 t, each within 1e-8 x
     max|beta| of `sven` on the whole X, the warm solve in no more Newton
     steps than `sven`'s; every launch priced by the router's estimate
     from the calibration the scheduler measured on the card when it was
     built (modeled_s > 0), the median log10(actual / modeled) per route
     path within [0, 4];
 13. the multi-device layer (float64, default config): 2 ranks on the one
     card over gloo (`repro_torch.dist.launch`: spawned processes, a
     `file://` rendezvous), each check against the single-device call on
     the card: (13a) `sven_sharded` on the YMSD dual (231,858 rows a rank;
     one Gram launch a rank, beta 1e-10 x max|beta|, Newton steps equal),
     (13b) on the GLA-BRA primal (90 rows a rank; beta 1e-8 x, Newton
     equal, CG within 1 %; collectives per CG step), (13c) the lane fan-out
     of `sven_batch` (an 8-lane 4 t x 2 lambda2 `en_grid` on the shared
     GLA-BRA X) and of `enet_batch` (`cv_folds` at YMSD, lambda1 = 0.1 x
     each fold's lambda1_max), each lane bitwise the one-device stack's,
     (13d) the fold fan-out of `cross_validate(k=4, n_lambdas=10)` at YMSD
     bitwise `mesh=None`, and k = 5 with mesh="auto" under the 2-rank
     context declined, (13e) `calibrate` (every field finite and
     positive), the router's decisions and prices at 13a-13c, each no
     dearer than "single", `sven_routed(route="auto")` at 13a's and 13b's
     bounds, and a one-rank mesh's "one device: nothing to route", (13f)
     Shotgun at its callers' problems (`benchmarks/common.py` gla_bra_like
     180 x 3,500 at parallel 128, ymsd_like 10,000 x 90 at 64) and at
     ymsd_like with a full draw (parallel 90): the stop rule held on the
     last round's draw, beta within a fixed tolerance of the port's
     `enet` (5e-2 x max|beta| at gla_bra_like, whose stop rule sees 128 of
     3,500 coordinates a round; 1e-8 x at ymsd_like), and the full draw
     within the distance its stop rule certifies.

  14. the multi-host serving coordinator (float64, default config):
     (14a) JAX's `bench_serve.run_multihost` protocol at GLA-BRA width:
     `MultiHostCoordinator` over 2 spawned worker processes on the one
     card (max_batch 4, a shared spill directory), 16 constrained requests
     on 12a's data set at 0.01 x the loadgen's t, three waves (warm-up,
     no-fault, and a fault wave that flushes and SIGKILLs host 0 at
     request 8): every admitted request of every wave a result, balanced
     accounting, every status "ok", exactly 1 host lost and a batch
     requeued, fault p99 <= 3 x no-fault p99 (JAX's gate), the surviving
     worker on a CUDA device with the hinge kernels launched there, and
     the fault wave's first 8 betas within 1e-6 of a direct `sven` (printed
     beside JAX's 1e-10); it prints each wave's seconds and p50 / p99, the
     seconds from spawn to ready, a batch's pipe transport and a request's
     fingerprint; (14b) `python -m repro_torch.runtime.loadgen --hosts 2
     --kill-host 0 --waves 2` as a subprocess on the card, which must exit
     0. `--multihost` runs phase 14 alone.

The CG loop (`repro_torch.core.svm.state.cg_lanes`) reads its test once
per block of k = `CG_READ_EVERY` steps and launches up to k - 1 dead steps
past a CG solve's end: each hinge launch check counts the CG steps plus
the dead steps (`cg_lanes.dead`), and each solve prints both beside its
host syncs.

The data are synthetic (`repro_torch.data.make_regression`, fixed seeds).
Each path runs with every launch counter set to 0 just before it and read
just after it; a kernel of the path that was never launched fails the run.
The last two lines are a JSON object with every kernel's numbers (the
Gram's row counts its float64 body's launches and gives each body's under
`launches_by_mode`) and `{"ok": true, "device": {...}}`. Any failed check
exits non-zero without that last line. Exits non-zero at once without a
CUDA device, or without the rest of the repository beside this file.

    python3 chip_smoke.py --gram-split [f64|f32|tf32|bf16 ...]

times only the Gram at the YMSD shape in the modes named (float64 when
none is: together, its launches apart, cuBLAS's A^T A in the same type)
and prints no result line. It needs nothing of the checkout but
`shifted_gram_cuda`, so a copy of this file placed in a checkout of
another commit times that commit's Gram.

    python3 chip_smoke.py --gram-bitwise OTHER/gram.cu [f64|f32|tf32|bf16 ...]

builds another commit's `gram.cu` beside this checkout's and counts the
cases (five shapes, three radii, both layouts, in the modes named; f64,
tf32 and bf16 when none is) whose K the two give bitwise equal; exits 1 if
any differs.

    python3 chip_smoke.py --stats-time

times only the hinge-stats kernel at the GLA-BRA-180 and YMSD shapes in
f32 and bf16 beside the GEMV X^T w, and prints no result line; like
`--gram-split`, a copy placed in a checkout of another commit times that
commit's kernel.

    python3 chip_smoke.py --batch-time

times only phase 9's 9a and 9b (float64): the lane-batched hinge passes at
9a beside `torch.mm`, and `sven_batch` on each three times, with host syncs
and batched CG steps; it prints no result line, and a copy placed in a
checkout of another commit times that commit.

    python3 chip_smoke.py --loop-trace

shows where a CG step's time goes: the default float64 dual (YMSD shape),
primal (GLA-BRA-180 shape) and 9a, untraced at each k of READ_EVERY_SWEEP
(each k in turn, with seconds, host syncs and dead steps), then the primal
and 9a under torch.profiler: per CG step launched, the host's time in
reads, in launch calls and elsewhere, the device's busy time (hinge passes
and the rest), its idle share, and the launches by op. It prints no result
line; a copy placed in a checkout of another commit traces that commit.

    python3 chip_smoke.py --serving

runs phase 12 alone (the kernels built first), with its checks, and prints
no result line.

    python3 chip_smoke.py --multi-device

runs phase 13 alone (the kernels built first), with its checks, and prints
no result line.

    python3 chip_smoke.py --multihost

runs phase 14 alone (the kernels built first), with its checks, and prints
no result line.

    python3 chip_smoke.py --lane-time

checks and times, twice over, only the lane-batched hinge passes at 9b's
operands (5 stacked folds of 144 x 49,151) with X in float64, float32 and
bfloat16, beside 5 single launches, the plain op, `torch.bmm` and the
bound; it
prints no result line, and a copy placed in a checkout of another commit
times that commit's passes.
"""
from __future__ import annotations

import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "f64": 67e12}

YMSD = (463_715, 90)       # UCI YearPredictionMSD: n >> p, dual
GLA_BRA = (180, 49_151)    # GLA-BRA-180 (scikit-feature): p >> n, primal
RAGGED = (33, 57)
LAMBDA2 = 1.0


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str) -> None:
        print(("  ok    " if ok else "  FAIL  ") + what, flush=True)
        if not ok:
            self.failures.append(what)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def cuda_ms(torch, fn, min_reps: int = 5, min_ms: float = 50.0) -> float:
    """Mean device time of fn() in ms, by CUDA events over repeated calls,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = min_reps
    while True:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        if ms >= min_ms or reps >= 10_000:
            return ms / reps
        reps *= 4


def cuda_ms_each(torch, fn, dev, flush_l2: bool, reps: int = 50) -> float:
    """Mean device time of fn() in ms, each call between its own pair of CUDA
    events. The device first sleeps for ~10 ms so that the host queues every
    call before the first runs: no host gap falls inside a timed span. With
    `flush_l2`, a 256 MB buffer is read before each call, outside its span,
    so the call finds the 50 MB L2 cold."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev) if flush_l2 else None
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(20_000_000)
    for start, end in pairs:
        if flush is not None:
            flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


def kernel_ms(torch, fn, reps: int = 20) -> dict:
    """{kernel name: mean device ms per call of fn()} from torch.profiler's
    CUDA activity records, over `reps` calls after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / reps / 1e3 for e in prof.key_averages()
            if e.device_time_total > 0}


def cublas_gram_ms(torch, Xs, ys, prec: str) -> float:
    """cuBLAS's A^T A on a prebuilt contiguous A = [X, y] in the Gram mode's
    working type: one GEMM that holds all of the Gram kernel's O(n) work.
    f32 and f64 in full precision; tf32 the float32 call with TF32 allowed
    for it alone; bf16 on bfloat16 A (float32 accumulation, bfloat16
    output)."""
    A = torch.cat([Xs, ys[:, None]], 1).contiguous()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = prec == "tf32"
    try:
        return cuda_ms(torch, lambda: A.T @ A)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


GRAM_SPLIT_MODES = ("f64", "f32", "bf16", "tf32")


def gram_split_child(smoke) -> None:
    """Run `--gram-split` for GRAM_SPLIT_MODES in a child process and print
    its lines: the profiler's CUDA activity tracing then stays out of this
    process, whose later phases time the host loop."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--gram-split",
                          *GRAM_SPLIT_MODES], capture_output=True, text=True, timeout=600)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("  gram ")]
    for ln in lines:
        print(ln, flush=True)
    smoke.check(out.returncode == 0 and len(lines) == len(GRAM_SPLIT_MODES),
                f"--gram-split child: exit {out.returncode}, {out.stderr[-300:]!r}")


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, smoke, dev, gen):
    """Each kernel against its plain version; timings at the main-path shapes."""
    from repro_torch.data.synthetic import make_regression
    from repro_torch.kernels import gram, hinge, ref
    from repro_torch.kernels.ops import _storage

    rows = {}
    for (n, p) in (YMSD, RAGGED):
        X, y, beta_true = make_regression(n, p, seed=0, dtype=torch.float32, device=dev)
        Xd, yd = X.double(), y.double()
        # Three radii: the main path's rule (half the truth's L1 norm), where
        # the shift s = y^T y / t^2 dominates every entry; t_mix, where the
        # u = X^T y / t terms equal s; and a huge t, where K = +-X^T X, so
        # the P part is held at 1e-5 of its own size.
        t_main = 0.5 * beta_true.abs().sum().item()
        t_mix = (yd @ yd).item() / (Xd.T @ yd).abs().max().item()
        radii = {"t_main": t_main, "t_mix": t_mix, "t_big": 1e6 * t_main}
        for prec in ("f32", "tf32", "bf16", "f64"):
            # f64: float64 operands at precision "f32", the kernel's float64
            # body, which a float64 problem runs on the main path
            mode = "f32" if prec == "f64" else prec
            Xs, ys = (Xd, yd) if prec == "f64" else (_storage(X, prec), _storage(y, prec))
            # tf32 and bf16: the plain version sums the same rounded operands
            # (X and y rounded to TF32 as the kernel rounds them; bfloat16
            # storage), whose products are exact in f32, so only the f32 sums
            # differ (their order, and the tensor cores' rounding inside a
            # product): the f32 bound applies. f64: the worst case of a
            # float64 sum in another order, n eps = 5.1e-11 at n = 463,715,
            # is under 1e-10.
            tol = {"f32": 1e-5, "tf32": 1e-5, "bf16": 1e-5, "f64": 1e-10}[prec]
            for tname, t in radii.items():
                K = gram.shifted_gram_cuda(Xs, ys, t, precision=mode)
                Kr = ref.flatten_gram(ref.gram_blocks_ref(Xs, ys, t, mode))
                err = (K - Kr).abs().max().item()
                scale = Kr.abs().max().item()
                want = torch.float64 if prec == "f64" else torch.float32
                smoke.check(K.dtype == want, f"gram {n}x{p} {prec} {tname}: K is {K.dtype}")
                smoke.check(err <= tol * scale, f"gram {n}x{p} {prec} {tname} = {t:.4g}: "
                            f"max|K-K_plain| = {err:.3e} <= {tol:g} * max|K| = "
                            f"{tol * scale:.3e}")
                Kb = gram.shifted_gram_cuda(Xs, ys, t, precision=mode, flatten=False)
                smoke.check(torch.equal(ref.flatten_gram(Kb), K),
                            f"gram {n}x{p} {prec} {tname}: block layout equals the flat one")
                if tname == "t_main":
                    main_err, main_scale = err, scale
                    # a fixed summation order
                    smoke.check(all(torch.equal(gram.shifted_gram_cuda(
                        Xs, ys, t, precision=mode), K) for _ in range(3)),
                        f"gram {n}x{p} {prec} {tname}: three more launches give equal K")
            if (n, p) == YMSD:
                ms = cuda_ms(torch, lambda: gram.shifted_gram_cuda(Xs, ys, t_main,
                                                                   precision=mode))
                plain = cuda_ms(torch, lambda: ref.flatten_gram(
                    ref.gram_blocks_ref(Xs, ys, t_main, mode)))
                size = Xs.element_size()
                # A^T A of A = [X, y] is symmetric: (p+1)(p+2)/2 distinct
                # entries of n multiply-adds each; K (2p x 2p) is written in
                # the summing dtype
                b_ms, b_by = bound(n * p * size + n * size + 4 * p * p * (8 if prec == "f64" else 4),
                                   1.0 * n * (p + 1) * (p + 2), prec)
                library = cublas_gram_ms(torch, Xs, ys, prec)
                # the read rate one PyTorch reduction reaches on the same X
                read = cuda_ms(torch, lambda: Xs.sum(dtype=torch.float32 if size < 8
                                                      else torch.float64))
                note = " (bfloat16 output, float32 accumulation)" if prec == "bf16" else ""
                print(f"  gram {prec} at {n}x{p}: kernel {ms:.4f} ms, plain {plain:.4f} "
                      f"ms, bound {b_ms:.4f} ms ({b_by}), cuBLAS A^T A {library:.4f} ms"
                      f"{note}; max|K-K_plain| / max|K| at t_main {main_err / main_scale:.2e}"
                      f"; torch.sum of X {read:.4f} ms ({n * p * size / read / 1e9:.2f} TB/s)",
                      flush=True)
                if prec == "f64":   # what the main path runs on its float64 data
                    gram_split_child(smoke)
                    rows["shifted_gram_cuda"] = dict(
                        max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=library)
        del X, y, Xd, yd, Xs, ys

    for (n, p) in (GLA_BRA, RAGGED):
        X, y, _ = make_regression(n, p, seed=0, dtype=torch.float32, device=dev)
        v = torch.randn(n, generator=gen, dtype=torch.float64).to(dev, torch.float32)
        at = (torch.rand(p, generator=gen, dtype=torch.float64) > 0.4).to(dev, torch.float32)
        ab = (torch.rand(p, generator=gen, dtype=torch.float64) > 0.6).to(dev, torch.float32)
        t, C = 1.1, 2.5
        for prec in ("f32", "bf16", "f64"):
            # f64: float64 operands, the kernels' float64 bodies, which a
            # float64 problem runs on the main path
            if prec == "f64":
                Xs, ys, vs, ats, abs_ = (a.double() for a in (X, y, v, at, ab))
            else:
                Xs, ys, vs, ats, abs_ = _storage(X, prec), y, v, at, ab
            # f64: float64 sums in another order, far under 1e-10 at these n, p
            tol = {"f32": 1e-5, "bf16": 2e-2, "f64": 1e-10}[prec]
            d, e_part = hinge.hinge_xtv_cuda(Xs, ys, vs, t, ats, abs_)
            dr, er = ref.hinge_xtv_ref(Xs, ys, vs, t, ats, abs_)
            smoke.check(d.dtype == e_part.dtype == ys.dtype,
                        f"hinge_xtv {n}x{p} {prec}: d and e_part are {d.dtype}")
            d_err = (d - dr).abs().max().item()
            d_scale = max(1.0, dr.abs().max().item())
            smoke.check(d_err <= tol * d_scale, f"hinge_xtv {n}x{p} {prec}: max|d-d_plain|"
                        f" = {d_err:.3e} <= {tol:g} * max(1,|d|) = {tol * d_scale:.3e}")
            e_err = abs(e_part.sum().item() - er.item())
            print(f"  hinge_xtv {n}x{p} {prec}: |e - e_plain| = {e_err:.3e} "
                  f"(e_plain = {er.item():.6e})", flush=True)
            # a fixed summation order
            smoke.check(all(torch.equal(a, b) for _ in range(3) for a, b in zip(
                hinge.hinge_xtv_cuda(Xs, ys, vs, t, ats, abs_), (d, e_part))),
                f"hinge_xtv {n}x{p} {prec}: three more launches give equal d and e_part")
            # pass 2 alone, from the plain (d, e)
            hv = hinge.hinge_xd_cuda(Xs, ys, dr, er.reshape(1), vs, t, C)
            hr = ref.hinge_xd_ref(Xs, ys, dr, er, vs, t, C)
            xd_err = (hv - hr).abs().max().item()
            h_scale = max(1.0, hr.abs().max().item())
            smoke.check(hv.dtype == ys.dtype and xd_err <= tol * h_scale,
                        f"hinge_xd {n}x{p} {prec}: H v is {hv.dtype}, "
                        f"max|Hv-Hv_plain| = {xd_err:.3e} <= {tol * h_scale:.3e}")
            # both passes, as the solver calls them
            hv2 = hinge.hinge_xd_cuda(Xs, ys, d, e_part, vs, t, C)
            hv_err = (hv2 - ref.hessian_matvec_ref(Xs, ys, t, C, ats, abs_, vs)
                      ).abs().max().item()
            smoke.check(hv_err <= tol * h_scale, f"H v {n}x{p} {prec}: both kernels vs "
                        f"plain {hv_err:.3e} <= {tol * h_scale:.3e}")
            # a fixed summation order, and the ticket counters back at 0
            smoke.check(all(torch.equal(hinge.hinge_xd_cuda(Xs, ys, d, e_part, vs, t, C),
                                        hv2) for _ in range(3)),
                        f"hinge_xd {n}x{p} {prec}: three more launches give equal H v")
            if (n, p) == GLA_BRA:
                size, osize = Xs.element_size(), ys.element_size()
                nblk = e_part.numel()
                calls = {
                    "xtv": (lambda: hinge.hinge_xtv_cuda(Xs, ys, vs, t, ats, abs_),
                            lambda: ref.hinge_xtv_ref(Xs, ys, vs, t, ats, abs_)),
                    "xd": (lambda: hinge.hinge_xd_cuda(Xs, ys, d, e_part, vs, t, C),
                           lambda: ref.hinge_xd_ref(Xs, ys, dr, er, vs, t, C)),
                }
                # one cuBLAS call on X as stored each (bf16: the vector in
                # bfloat16 too, float32 accumulation)
                vg, dg = vs.to(Xs.dtype), d.to(Xs.dtype)
                calls["GEMV X^T v"] = (lambda: torch.mv(Xs.T, vg), None)
                calls["GEMV X d"] = (lambda: torch.mv(Xs, dg), None)
                # cold: L2 flushed before each launch, so the HBM bound holds;
                # warm: X left in L2 between launches, as in the CG loop (in
                # f64, X is larger than the L2)
                cold = {k: [cuda_ms_each(torch, f, dev, True) if f else None
                            for f in fs] for k, fs in calls.items()}
                warm = {k: [cuda_ms_each(torch, f, dev, False) if f else None
                            for f in fs] for k, fs in calls.items()}
                kind = "f64" if prec == "f64" else "f32"
                bounds = {"xtv": bound(n * p * size + osize * (2 * n + 3 * p + nblk),
                                       2.0 * n * p + 2.0 * n + 6.0 * p, kind),
                          "xd": bound(n * p * size + osize * (p + nblk + 3 * n),
                                      2.0 * n * p + 5.0 * n, kind)}
                grids = {"xtv": f" ({nblk} blocks)", "xd": ""}
                for k in ("xtv", "xd"):
                    print(f"  hinge {k} {prec} at {n}x{p}{grids[k]}: L2 cold "
                          f"{cold[k][0]:.4f} ms (plain {cold[k][1]:.4f}, HBM bound "
                          f"{bounds[k][0]:.4f} {bounds[k][1]}); L2 warm {warm[k][0]:.4f} ms "
                          f"(plain {warm[k][1]:.4f}); X = {n * p * size / 1e6:.1f} MB",
                          flush=True)
                for k in calls:
                    if k.startswith("GEMV"):
                        print(f"  {k} (torch.mv) {prec} at {n}x{p}: L2 cold "
                              f"{cold[k][0]:.4f} ms, warm {warm[k][0]:.4f} ms", flush=True)
                if prec == "f64":   # what the main path runs on its float64 data
                    errs = {"xtv": d_err, "xd": xd_err}
                    gemv = {"xtv": "GEMV X^T v", "xd": "GEMV X d"}
                    for k in ("xtv", "xd"):
                        rows[f"hinge_{k}_cuda"] = dict(
                            max_abs_err=errs[k], ms=cold[k][0], plain_ms=cold[k][1],
                            bound_ms=bounds[k][0], bound_by=bounds[k][1],
                            library_ms=cold[gemv[k]][0])
            del Xs, ys, vs, ats, abs_
        del X, y
    return rows


def stats_times(torch, kernel, Xs, y32, t, w32, C, dev) -> dict:
    """Device ms of one hinge-stats launch at L2 cold and warm, and of the
    GEMV X^T w alone (one cuBLAS call on X as stored; bf16: w in bfloat16)."""
    wg = w32.to(Xs.dtype)
    return dict(cold=cuda_ms_each(torch, lambda: kernel(Xs, y32, t, w32, C), dev, True),
                warm=cuda_ms_each(torch, lambda: kernel(Xs, y32, t, w32, C), dev, False),
                gemv_cold=cuda_ms_each(torch, lambda: torch.mv(Xs.T, wg), dev, True),
                gemv_warm=cuda_ms_each(torch, lambda: torch.mv(Xs.T, wg), dev, False))


def stats_bound(n: int, p: int, size: int):
    """The hinge-stats bound: X read once, w and y read, the four p-vectors
    written; 2 n p + 2 n + 12 p float32 operations."""
    return bound(n * p * size + 4 * (2 * n + 4 * p), 2.0 * n * p + 2.0 * n + 12.0 * p, "f32")


def stats_route(torch, ths, n: int, p: int, dev) -> str:
    """The route the wrapper takes at (n, p), with its blocks."""
    tall = ths.plan(n, p, torch.cuda.get_device_properties(dev).multi_processor_count)
    if tall is None:
        return f"wide route, {-(-p // ths.WIDE_COLS)} column blocks"
    return f"tall route, {tall[0]} blocks of {tall[1]} rows"


def stats_time_only(torch) -> int:
    """`--stats-time`: the hinge-stats kernel at the GLA-BRA-180 and YMSD
    shapes in f32 and bf16, L2 cold and warm, beside the GEMV X^T w, on
    synthetic data. It needs nothing of the checkout but `hinge_stats_cuda`
    and `ops._storage`, so a copy of this file placed in a checkout of
    another commit times that commit's kernel."""
    from repro_torch.data.synthetic import make_regression
    from repro_torch.kernels import ops

    ths = importlib.import_module("repro_torch.kernels.hinge_stats")
    print(f"card: {nvidia_smi()}", flush=True)
    dev = torch.device("cuda", 0)
    for case, (n, p) in (("GLA-BRA", GLA_BRA), ("YMSD", YMSD)):
        X, y, _ = make_regression(n, p, seed=0, dtype=torch.float32, device=dev)
        w = torch.randn(n, generator=torch.Generator().manual_seed(1)).to(dev) * 0.01
        for prec in ("f32", "bf16"):
            Xs = ops._storage(X, prec)
            tm = stats_times(torch, ths.hinge_stats_cuda, Xs, y, 0.7, w, 1.0, dev)
            b_ms, _ = stats_bound(n, p, Xs.element_size())
            print(f"  stats {case} {prec} at {n}x{p}: cold {tm['cold']:.4f} ms, warm "
                  f"{tm['warm']:.4f}; GEMV cold {tm['gemv_cold']:.4f}, warm "
                  f"{tm['gemv_warm']:.4f}; bound {b_ms:.4f}", flush=True)
        del X, y, w
        torch.cuda.empty_cache()
    return 0


def batch_time_only(torch) -> int:
    """`--batch-time`: phase 9's 9a and 9b on their data (float64, default
    config): at 9a the two lane-batched passes L2 cold beside `torch.mm`,
    then `sven_batch` on 9a and on 9b three times each, with seconds, host
    syncs, batched CG steps and whether each lane's Newton and CG counts
    equal the ones PERF.md records. It needs nothing of the checkout but
    `sven_batch`, `en_grid`, `cv_folds` and the lane wrappers, so a copy of
    this file placed in a checkout of another commit times that commit."""
    from repro_torch import kernels
    from repro_torch.core.batch import cv_folds, en_grid, sven_batch
    from repro_torch.core.svm import state as svm_state
    from repro_torch.core.svm.state import cg_lanes
    from repro_torch.data.synthetic import make_regression
    from repro_torch.kernels import hinge

    print(f"card: {nvidia_smi()}", flush=True)
    dev = torch.device("cuda", 0)
    f64 = dict(dtype=torch.float64, device=dev)
    X, y, beta_true = make_regression(*GLA_BRA, seed=2, device=dev)
    t = 0.5 * beta_true.abs().sum().item()
    ts, l2s = en_grid(torch.tensor([0.5, 0.75, 1.0], **f64) * t,
                      torch.tensor([0.5, 1.0, 4.0], **f64))
    C = 1.0 / (2.0 * l2s)
    gen = torch.Generator().manual_seed(0)
    B, (n, p) = ts.shape[0], GLA_BRA
    v = torch.randn(B, n, generator=gen, dtype=torch.float64).to(dev)
    at = (torch.rand(B, p, generator=gen) > 0.4).to(dev, torch.float64)
    ab = (torch.rand(B, p, generator=gen) > 0.6).to(dev, torch.float64)
    d, e_part = hinge.hinge_xtv_lanes_cuda(X, y, v, ts, at, ab)
    V, D = v.T.contiguous(), d.T.contiguous()
    for name, lanes_fn, lib_fn in (
            ("xtv", lambda: hinge.hinge_xtv_lanes_cuda(X, y, v, ts, at, ab),
             lambda: torch.mm(X.T, V)),
            ("xd", lambda: hinge.hinge_xd_lanes_cuda(X, y, d, e_part, v, ts, C),
             lambda: torch.mm(X, D))):
        ms, lib = (cuda_ms_each(torch, f, dev, True, reps=20) for f in (lanes_fn, lib_fn))
        print(f"  hinge {name} lanes float64 9a, {B} x {n}x{p}, X shared: L2 cold {ms:.4f} "
              f"ms, torch.mm {lib:.4f}", flush=True)
    Xtr, ytr, _, _ = cv_folds(X, y, 5)
    for label, args in (("9a", (X, y, ts, l2s)),
                        ("9b", (Xtr, ytr, torch.tensor(t, **f64),
                                torch.tensor(LAMBDA2, **f64)))):
        for rep in range(3):
            sol, secs, _, syncs = run_path(torch, kernels, svm_state,
                                           lambda: sven_batch(*args))
            live = cg_lanes.steps - cg_lanes.dead
            counts = (sol.iters.tolist(), sol.cg_iters.tolist(), live)
            print(f"  sven_batch {label} run {rep + 1}: {secs:.3f} s, {syncs} host syncs, "
                  f"{cg_lanes.steps} batched CG steps ({cg_lanes.dead} dead); counts equal "
                  f"the ones PERF.md records: {counts == RECORDED_COUNTS[label]}", flush=True)
    return 0


#: CUDA runtime calls in which the host waits for the device: a read of a
#: device value (the copy to the host, then the stream's synchronisation)
READ_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpyAsync", "cudaMemcpy")
#: CUDA runtime and driver calls that queue work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemsetAsync")


def _union_us(spans) -> float:
    """The length of the union of (start, end) spans."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


def _kernel_short(name: str) -> str:
    """A kernel's function name without its namespaces, template arguments
    and parameters."""
    head = re.sub(r"<.*", "", name.replace("void ", "", 1)).split("(")[0]
    return head.rsplit("::", 1)[-1].strip() or name[:40]


def trace_split(path: Path, wall_s: float, steps: int) -> dict:
    """Where the time of a run traced by torch.profiler went, per CG step:
    `path` is its Chrome trace, `wall_s` the run's host seconds (ending in a
    synchronisation), `steps` the CG steps it launched. Host time is split
    into the waits of reads (READ_CALLS), the launch calls (LAUNCH_CALLS)
    and the rest (Python and PyTorch's dispatch); device time into the
    hinge passes and everything else (the union of kernel, copy and memset
    spans); the idle share is the part of the run's wall time in which the
    device ran nothing. Each device launch is named by the outermost
    PyTorch op that issued it, or by its kernel where no op did (the
    hand-written kernels, launched through ctypes)."""
    import bisect
    from collections import Counter, defaultdict

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    by_cat = defaultdict(list)
    for e in events:
        by_cat[e.get("cat")].append(e)
    device = by_cat["kernel"] + by_cat["gpu_memcpy"] + by_cat["gpu_memset"]
    runtime = by_cat["cuda_runtime"] + by_cat["cuda_driver"]
    reads = [e for e in runtime if e["name"] in READ_CALLS]
    launch_calls = [e for e in runtime if e["name"] in LAUNCH_CALLS]
    tops = defaultdict(list)   # each host thread's outermost ops, in time order
    for e in sorted(by_cat["cpu_op"], key=lambda e: (str(e["tid"]), e["ts"], -e["dur"])):
        ops = tops[str(e["tid"])]
        if not ops or e["ts"] >= ops[-1][1]:
            ops.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    starts = {tid: [o[0] for o in ops] for tid, ops in tops.items()}
    issuer = {}
    for r in runtime:
        ops = tops.get(str(r["tid"]), [])
        i = bisect.bisect_right(starts.get(str(r["tid"]), []), r["ts"]) - 1
        issuer[r.get("args", {}).get("correlation")] = (
            ops[i][2] if i >= 0 and r["ts"] <= ops[i][1] else None)
    by_op = Counter(issuer.get(k.get("args", {}).get("correlation")) or _kernel_short(k["name"])
                    for k in device)
    wall = wall_s * 1e6
    busy = _union_us([(k["ts"], k["ts"] + k["dur"]) for k in device])
    hinge = _union_us([(k["ts"], k["ts"] + k["dur"]) for k in by_cat["kernel"]
                       if "hinge" in k["name"]])
    read_us = sum(e["dur"] for e in reads)
    launch_us = sum(e["dur"] for e in launch_calls)
    return dict(steps=steps, wall_us=wall / steps, read_us=read_us / steps,
                reads=sum(e["name"] == "cudaStreamSynchronize" for e in reads),
                launch_us=launch_us / steps, launch_calls=len(launch_calls) / steps,
                other_host_us=(wall - read_us - launch_us) / steps,
                busy_us=busy / steps, hinge_us=hinge / steps, other_dev_us=(busy - hinge) / steps,
                idle=1.0 - busy / wall, launches=len(device) / steps,
                by_op={k: v / steps for k, v in by_op.most_common()})


#: the blocks of CG steps between two reads that `--loop-trace` times
READ_EVERY_SWEEP = (1, 2, 4, 8, 16)


def loop_trace_only(torch) -> int:
    """`--loop-trace`: where a CG step's time goes. First, untraced, the
    default float64 dual `sven` at the YMSD shape (phase 3's problem), the
    primal at the GLA-BRA-180 shape (phase 4's) and 9a (phase 9's 3 x 3
    grid on the same X), with seconds, host syncs and CG steps (live and
    dead), at each k of READ_EVERY_SWEEP where the loop has a k (a loop
    that reads its test every step has none). Then the primal and 9a once
    more under torch.profiler (CPU and CUDA activities) at the module's k,
    each after an untraced run, and `trace_split`'s split per CG step
    launched. Traced numbers compare only with traced numbers. It needs
    nothing of the checkout but `sven`, `sven_batch`, `en_grid` and the
    counters, so a copy of this file placed in a checkout of another commit
    traces that commit."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.core.batch import en_grid, sven_batch
    from repro_torch.core.sven import sven
    from repro_torch.core.svm import state as svm_state
    from repro_torch.data.synthetic import make_regression

    print(f"card: {nvidia_smi()}", flush=True)
    dev = torch.device("cuda", 0)
    f64 = dict(dtype=torch.float64, device=dev)
    Xd, yd, beta_d = make_regression(*YMSD, seed=1, device=dev)
    td = 0.5 * beta_d.abs().sum().item()
    X, y, beta_true = make_regression(*GLA_BRA, seed=2, device=dev)
    t = 0.5 * beta_true.abs().sum().item()
    ts, l2s = en_grid(torch.tensor([0.5, 0.75, 1.0], **f64) * t,
                      torch.tensor([0.5, 1.0, 4.0], **f64))
    k = getattr(svm_state, "CG_READ_EVERY", None)
    cg = svm_state.cg_lanes
    cg.dead = 0   # a loop that reads its test every step counts no dead steps
    paths = (("dual", lambda: sven(Xd, yd, td, LAMBDA2), None, 3),
             ("primal", lambda: sven(X, y, t, LAMBDA2), "hinge_xtv_cuda", 2),
             ("9a", lambda: sven_batch(X, y, ts, l2s), "hinge_xtv_lanes_cuda", 1))
    sweep = READ_EVERY_SWEEP if k else (None,)
    for label, fn, _, reps in paths:
        run_path(torch, kernels, svm_state, fn)   # first calls paid
        runs = {kk: [] for kk in sweep}
        for _ in range(reps):   # each k in turn, so that a drift of the host spreads over all
            for kk in sweep:
                if kk:
                    svm_state.CG_READ_EVERY = kk
                out = run_path(torch, kernels, svm_state, fn)
                runs[kk].append((*out[1:], cg.dead, out[0]))
        if k:
            svm_state.CG_READ_EVERY = k
        for kk, rs_ in runs.items():
            _, _, syncs, dead, sol = rs_[-1]
            print(f"  loop {label} untraced, reads every {kk or 1} CG steps"
                  f"{'' if kk else ' (no constant)'}: "
                  f"{', '.join(f'{r[0]:.4f}' for r in rs_)} s, {syncs} host syncs, "
                  f"{int(torch.as_tensor(sol.iters).sum())} Newton / "
                  f"{int(torch.as_tensor(sol.cg_iters).sum())} CG, dead CG steps {dead}",
                  flush=True)
        del runs
    out_dir = ROOT / "build" / "loop-trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    for label, fn, pass1, _ in paths[1:]:
        run_path(torch, kernels, svm_state, fn)
        path = out_dir / f"{label}.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, secs, launched, syncs = run_path(torch, kernels, svm_state, fn)
        prof.export_chrome_trace(str(path))
        sp = trace_split(path, secs, launched[pass1])
        path.unlink()
        ops = ", ".join(f"{name} {n:.2f}" for name, n in list(sp["by_op"].items())[:14])
        print(f"  loop {label} traced, reads every {k or 1} CG steps: {secs:.3f} s, "
              f"{syncs} host syncs, {sp['steps']} CG steps launched ({cg.dead} dead); per "
              f"step: wall {sp['wall_us']:.1f} us = reads {sp['read_us']:.1f} "
              f"({sp['reads'] / sp['steps']:.3f} syncs) + launch calls "
              f"{sp['launch_us']:.1f} ({sp['launch_calls']:.2f}) + other host "
              f"{sp['other_host_us']:.1f}; device busy {sp['busy_us']:.1f} us (hinge "
              f"{sp['hinge_us']:.1f}, other {sp['other_dev_us']:.1f}), idle share "
              f"{sp['idle']:.3f}; {sp['launches']:.2f} device launches a step: {ops}",
              flush=True)
        del prof
    return 0



def phase_hinge_stats(torch, smoke, kernels, svm_state, dev, cases):
    """The hinge-stats op against its plain version. `cases` is a list of
    (label, X, y, t, w, C) with float64 X, y, w on the card. Returns
    (JSON row, launches of the counted run)."""
    from repro_torch.core.reduction import SvenOperator
    from repro_torch.core.svm.primal_newton import _primal_obj
    from repro_torch.kernels import ops, ref
    ths = importlib.import_module("repro_torch.kernels.hinge_stats")

    # the kernel's operands, made before the counted run
    calls = []
    for label, X, y, t, w, C in cases:
        X32 = X.to(torch.float32).contiguous()
        y32, w32 = y.to(torch.float32), w.to(torch.float32)
        for prec in ("f32", "bf16"):
            calls.append((label, prec, ops._storage(X32, prec), y32, w32, X, y, t, w, C))
    outs, secs, launched, _ = run_path(
        torch, kernels, svm_state,
        lambda: [ops.hinge_stats(Xs, y32, t, w, C, precision=prec)
                 for (_, prec, Xs, y32, _, _, _, t, w, C) in calls])
    print(f"    {len(calls)} op calls, {secs:.3f} s, launches {launched}", flush=True)
    smoke.check(launched["hinge_stats_cuda"] == len(calls),
                "one hinge_stats_cuda launch per op call")

    row, by_case = None, {}
    for (label, prec, Xs, y32, w32, X, y, t, w, C), (margin, act, loss, galpha) in zip(
            calls, outs):
        n, p = Xs.shape
        pm, pa, pl, pg = ref.hinge_stats_ref(Xs, y32, t, w32, C)
        S = (Xs.float().abs().T @ w32.abs()).max().item()
        m_err = max_dev(torch, margin, pm.double())
        g_err = max_dev(torch, galpha, pg.double())
        clear = (pm - 1.0).abs() > 1e-5 * S
        act_ok = torch.equal((act > 0)[clear], (pa > 0)[clear])
        l_rel = abs(loss.item() - pl.item()) / abs(pl.item())
        what = f"hinge_stats {label} {n}x{p} {prec}"
        smoke.check(m_err <= 1e-5 * S and g_err <= 1e-5 * S,
                    f"{what}: max|margin-plain| = {m_err:.3e}, max|galpha-plain| = "
                    f"{g_err:.3e} <= 1e-5 * S = {1e-5 * S:.3e}")
        smoke.check(act_ok, f"{what}: act equal outside |margin - 1| <= 1e-5 * S "
                    f"({int((~clear).sum())} of {2 * p} inside)")
        smoke.check(l_rel <= 1e-5, f"{what}: loss {loss.item():.9e} vs plain "
                    f"{pl.item():.9e}, rel {l_rel:.2e} <= 1e-5")
        if label == "primal w" and prec == "f32":
            # the loss is the primal objective of the solver at its own w
            yhat = torch.cat([X.new_ones(p), -X.new_ones(p)])
            obj = _primal_obj(SvenOperator(X=X, y=y, t=t).xhat_matvec, yhat, w, C).item()
            o_rel = abs(loss.item() - obj) / abs(obj)
            smoke.check(o_rel <= 1e-5, f"{what}: loss vs float64 primal objective "
                        f"{obj:.9e}: rel {o_rel:.2e} <= 1e-5")
        if label == "ragged":
            continue
        case = "GLA-BRA" if label == "primal w" else "YMSD"
        tm = stats_times(torch, ths.hinge_stats_cuda, Xs, y32, t, w32, C, dev)
        plain = tuple(cuda_ms_each(torch, lambda: ref.hinge_stats_ref(Xs, y32, t, w32, C),
                                   dev, cold) for cold in (True, False))
        b_ms, b_by = stats_bound(n, p, Xs.element_size())
        route = stats_route(torch, ths, n, p, dev)
        print(f"  hinge_stats {case} {prec} at {n}x{p}, {route}: "
              f"cold {tm['cold']:.4f} ms, warm {tm['warm']:.4f}; plain cold {plain[0]:.4f}, "
              f"warm {plain[1]:.4f}; GEMV X^T w cold {tm['gemv_cold']:.4f}, warm "
              f"{tm['gemv_warm']:.4f}; bound {b_ms:.4f} ({b_by}); X = "
              f"{n * p * Xs.element_size() / 1e6:.1f} MB", flush=True)
        by_case[f"{case} {prec}"] = dict(ms=tm["cold"], bound_ms=b_ms,
                                         gemv_ms=tm["gemv_cold"])
        if label == "primal w" and prec == "f32":
            row = dict(max_abs_err=max(m_err, g_err), ms=tm["cold"], plain_ms=plain[0],
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
    row["by_case"] = by_case
    return row, launched


def phase_front_end(torch, smoke, kernels, svm_state, count, ymsd, glabra):
    """`enet_path` at the YMSD shape and `ElasticNet.fit` at the GLA-BRA-180
    shape, each against the same call on the plain float64 backend."""
    from repro_torch.core import elastic_net as en
    from repro_torch.core.api import ElasticNet, PathConfig, enet_path, standardize_fit
    from repro_torch.core.sven import SvenConfig

    plain = PathConfig(solver=SvenConfig(backend="torch", tol=1e-10))
    X, y = ymsd
    n, p = X.shape
    print(f"[7a] enet_path, 10 lambdas, lambda2 = {LAMBDA2}, n = {n}, p = {p}", flush=True)
    path, secs, launched, syncs = run_path(
        torch, kernels, svm_state, lambda: enet_path(X, y, n_lambdas=10, lambda2=LAMBDA2))
    count(launched)
    ref, ref_s, _, ref_syncs = run_path(
        torch, kernels, svm_state,
        lambda: enet_path(X, y, n_lambdas=10, lambda2=LAMBDA2, config=plain))
    # the kernel run again, now that both runs have paid their first calls
    again, again_s, _, _ = run_path(
        torch, kernels, svm_state, lambda: enet_path(X, y, n_lambdas=10, lambda2=LAMBDA2))
    scale = ref.betas.abs().max().item()
    dev_b = max_dev(torch, path.betas, ref.betas)
    print(f"    kernels: {secs:.3f} s, {syncs} host syncs, launches {launched}, evals "
          f"per point {list(path.evals)}, Newton {list(path.sven_iters)}, CG "
          f"{list(path.cg_iters)}, kept {path.n_kept.tolist()}, max KKT after the "
          f"first point (beta = 0) {path.kkts[1:].max().item():.3e}, "
          f"|nu - lambda1| / lambda1_max max "
          f"{((path.nus - path.lambda1s).abs().max() / path.lambda1s[0]).item():.3e}",
          flush=True)
    print(f"    torch f64: {ref_s:.3f} s, {ref_syncs} host syncs, evals per point "
          f"{list(ref.evals)}, max KKT after the first point "
          f"{ref.kkts[1:].max().item():.3e}; kernels again: {again_s:.3f} s", flush=True)
    kkt = path.kkts[1:].max().item()
    smoke.check(again.evals == path.evals and torch.equal(again.betas, path.betas),
                "a second kernel run gives the same evaluations and betas")
    smoke.check(path.betas.shape == (10, p) and bool(torch.isfinite(path.betas).all()),
                "path betas finite, shape (10, p)")
    smoke.check(launched["shifted_gram_cuda"] == sum(path.evals) > 0,
                f"one Gram launch per Illinois evaluation ({sum(path.evals)})")
    smoke.check(dev_b <= 5e-4 * scale, f"max|beta - beta_torch| = {dev_b:.3e} <= "
                f"5e-4 * max|beta| = {5e-4 * scale:.3e}")
    # the float64 Gram gives the reference's stop: its evaluations and answer
    smoke.check(sum(path.evals) <= sum(ref.evals) + 2,
                f"evaluations {sum(path.evals)} {list(path.evals)} <= float64's "
                f"{sum(ref.evals)} {list(ref.evals)} + 2")
    smoke.check(kkt <= 1e-9, f"max KKT after the first point {kkt:.3e} <= 1e-9")
    smoke.check(dev_b <= 1e-8 * scale, f"max|beta - beta_torch| = {dev_b:.3e} <= "
                f"1e-8 * max|beta| = {1e-8 * scale:.3e}")
    del path, ref, again

    X, y = glabra
    n, p = X.shape
    Xs, ys, sc = standardize_fit(X, y)
    lam1 = 0.1 * en.lambda1_max(Xs, ys).item()
    print(f"[7b] ElasticNet(lambda1 = 0.1 lambda1_max = {lam1:.6g}, lambda2 = {LAMBDA2})"
          f".fit, standardize + intercept, n = {n}, p = {p}", flush=True)
    model, secs, launched, syncs = run_path(
        torch, kernels, svm_state, lambda: ElasticNet(lam1, LAMBDA2).fit(X, y))
    dead = svm_state.cg_lanes.dead
    count(launched)
    ref, ref_s, _, ref_syncs = run_path(
        torch, kernels, svm_state,
        lambda: ElasticNet(lam1, LAMBDA2, config=plain).fit(X, y))
    res = model.result_
    scale = ref.coef_.abs().max().item()
    dev_b = max_dev(torch, model.coef_, ref.coef_)

    def kkt(m):
        return en.kkt_violation(Xs, ys, m.coef_ * sc.x_scale, LAMBDA2).item()

    print(f"    kernels: {secs:.3f} s, {syncs} host syncs, launches {launched}, "
          f"{res.evals} evals, {res.sven_iters} Newton / {res.cg_iters} CG + {dead} dead "
          f"CG steps, kept "
          f"{int(model.n_kept_)}, KKT {kkt(model):.3e}, |nu - lambda1| / lambda1 "
          f"{abs(model.nu_.item() - lam1) / lam1:.3e}, intercept dev "
          f"{abs(model.intercept_.item() - ref.intercept_.item()):.3e}", flush=True)
    print(f"    torch f64: {ref_s:.3f} s, {ref_syncs} host syncs, {ref.result_.evals} "
          f"evals, {ref.result_.sven_iters} Newton / {ref.result_.cg_iters} CG, KKT "
          f"{kkt(ref):.3e}", flush=True)
    smoke.check(bool(torch.isfinite(model.coef_).all()) and model.coef_.shape == (p,),
                "coef_ finite, shape (p,)")
    smoke.check(launched["hinge_xtv_cuda"] == launched["hinge_xd_cuda"]
                == res.cg_iters + dead > 0, "exactly one launch of each hinge pass per CG "
                f"step ({res.cg_iters}) and dead CG step ({dead})")
    smoke.check(dead <= (svm_state.CG_READ_EVERY - 1) * res.sven_iters,
                f"dead CG steps {dead} <= k - 1 per CG solve ({res.sven_iters} solves)")
    # the float64 hinge passes give the reference's fit
    smoke.check(res.evals == ref.result_.evals,
                f"evaluations {res.evals} = float64's {ref.result_.evals}")
    cg_rel = abs(res.cg_iters - ref.result_.cg_iters) / ref.result_.cg_iters
    smoke.check(cg_rel <= 0.02, f"CG steps {res.cg_iters} within 2 % of float64's "
                f"{ref.result_.cg_iters} ({100 * cg_rel:.2f} %)")
    smoke.check(dev_b <= 1e-8 * scale, f"max|coef - coef_torch| = {dev_b:.3e} <= "
                f"1e-8 * max|coef| = {1e-8 * scale:.3e}")


#: max|beta - beta_ref| / max|beta_ref| allowed for a primal solve whose hinge
#: passes sum in float32 (float32 data, or precision "bf16"), against the
#: plain run in its precision and against the float64 default solve: the
#: reference's bound for a primal kernel path without refinement,
#: 5e-4 * max|beta_cd| (tests/test_sven_equivalence.py:107-116)
PRIMAL_LOW_REL = 5e-4


def phase_primal_precisions(torch, smoke, kernels, svm_state, X, y, t, sol64) -> dict:
    """Phase 4b: the GLA-BRA-180 primal at the default config on float32
    data (the hinge passes' float32 bodies) and on the float64 data at
    precision "bf16" (X stored in bfloat16, float32 sums), each against the
    port's plain run in the same precision on the card (float32 data on the
    "torch" backend; "bf16" on the passes' plain versions, backend "ref")
    and against the float64 default solve `sol64`, which stands in for
    coordinate descent: beta within PRIMAL_LOW_REL of each, one launch of
    each pass per CG step, none in the plain runs. Prints Newton and CG
    counts, seconds, and whether a solve stopped at its Newton limit.
    Returns each run's launches of the single passes, by mode."""
    from repro_torch.core.sven import SvenConfig, sven

    max_newton = SvenConfig().max_newton
    X32, y32 = X.float(), y.float()
    scale64 = sol64.beta.abs().max().item()
    by_mode = {}
    for mode, what, Xm, ym, cfg, plain in (
            ("f32", "float32 data, default config", X32, y32, SvenConfig(),
             SvenConfig(backend="torch")),
            ("bf16", "float64 data, precision bf16", X, y, SvenConfig(precision="bf16"),
             SvenConfig(backend="ref", precision="bf16"))):
        print(f"[4b] primal solve, {what}", flush=True)
        sol, secs, launched, syncs = run_path(
            torch, kernels, svm_state, lambda: sven(Xm, ym, t, LAMBDA2, cfg))
        dead = svm_state.cg_lanes.dead
        ref, ref_s, ref_launched, _ = run_path(
            torch, kernels, svm_state, lambda: sven(Xm, ym, t, LAMBDA2, plain))

        def stop(s_):
            res = s_.opt_residual.item()
            return (f"gradient sup-norm {res:.3e}" + (
                f", stopped at its Newton limit ({max_newton})" if s_.iters >= max_newton
                else ""))

        beta, beta_ref = sol.beta.double(), ref.beta.double()
        scale = beta_ref.abs().max().item()
        dev_p, dev_64 = max_dev(torch, beta, beta_ref), max_dev(torch, beta, sol64.beta)
        print(f"    kernels: {sol.iters} Newton / {sol.cg_iters} CG + {dead} dead CG steps, "
              f"{stop(sol)}, {secs:.3f} s, {syncs} host syncs; plain ({plain.backend}): "
              f"{ref.iters} Newton / "
              f"{ref.cg_iters} CG, {stop(ref)}, {ref_s:.3f} s; max|beta - beta_plain| = "
              f"{dev_p:.3e} ({dev_p / scale:.2e} of max|beta_plain|), max|beta - "
              f"beta_f64| = {dev_64:.3e} ({dev_64 / scale64:.2e} of max|beta_f64|)",
              flush=True)
        smoke.check(sol.mode == "primal" and sol.beta.dtype == Xm.dtype
                    and bool(torch.isfinite(sol.beta).all()),
                    f"{mode} primal: beta finite, {Xm.dtype}")
        smoke.check(launched["hinge_xtv_cuda"] == launched["hinge_xd_cuda"]
                    == sol.cg_iters + dead > 0, f"{mode} primal: one launch of each hinge "
                    f"pass per CG step ({sol.cg_iters}) and dead CG step ({dead})")
        smoke.check(not any(ref_launched.values()), f"{mode} primal: the plain run "
                    "launched no kernel")
        smoke.check(dev_p <= PRIMAL_LOW_REL * scale, f"{mode} primal: max|beta - "
                    f"beta_plain| {dev_p:.3e} <= {PRIMAL_LOW_REL:g} * max|beta_plain|")
        smoke.check(dev_64 <= PRIMAL_LOW_REL * scale64, f"{mode} primal: max|beta - "
                    f"beta_f64| {dev_64:.3e} <= {PRIMAL_LOW_REL:g} * max|beta_f64|")
        by_mode[mode] = launched["hinge_xtv_cuda"]
    return by_mode


#: max|beta - beta_plain| / max|beta| allowed for a float32 problem's default
#: solves (the Gram's float32 body) against its plain float32 solves, set
#: from the deviations of the previous float32 body (PR 11's) on the same
#: cells (PERF.md, PR 21): dual 4.3e-7, the float32 Gram's own 1e-5 bound;
#: enet_path 1.5e-4, whose solves nearly all stop at float32's floor short of
#: tol 1e-10, so its root-find runs on rounding noise
F32_BETA_REL = {"dual": 1e-5, "enet_path": 1e-2}
#: |evaluations - plain's| / plain's allowed for that enet_path: 5.7 % with
#: the previous body (130 against 123; per point up to 15 apart)
F32_PATH_EVALS_REL = 0.25
#: the points of phase 8b's float32 enet_path: the first 5 of the 10-point
#: grid, which took 318-412 s of the script at full depth (run twice)
F32_PATH_POINTS = 5


def phase_float32(torch, smoke, kernels, svm_state, dev) -> int:
    """A float32 problem at the default precision "f32": the dual solve and
    `enet_path` over the first F32_PATH_POINTS points of the 10-point grid
    at the YMSD shape, whose Grams run the kernel's
    float32 body, each against the same call on the port's plain float32
    backend ("torch") on the same tensors: the dual's Newton count, the
    path's evaluations within F32_PATH_EVALS_REL, beta within F32_BETA_REL.
    Returns the Gram's launches."""
    from repro_torch.core.api import PathConfig, enet_path, lambda_grid
    from repro_torch.core.sven import SvenConfig, sven
    from repro_torch.data.synthetic import make_regression

    n, p = YMSD
    X, y, beta_true = make_regression(n, p, seed=1, dtype=torch.float32, device=dev)
    t = 0.5 * beta_true.abs().sum().item()
    tol = SvenConfig().tol
    print(f"[8a] dual solve, float32 data, n = {n}, p = {p}, tol {tol:g}", flush=True)
    ref, ref_s, _, ref_syncs = run_path(
        torch, kernels, svm_state,
        lambda: sven(X, y, t, LAMBDA2, SvenConfig(backend="torch")))
    sol, secs, launched, syncs = run_path(torch, kernels, svm_state,
                                          lambda: sven(X, y, t, LAMBDA2))
    gram = launched.pop("shifted_gram_cuda")

    def stop(s):
        res = s.opt_residual.item()
        return (f"residual {res:.3e}" + ("" if res <= tol else
                                         f" > tol {tol:g}: stopped short"))

    scale = ref.beta.abs().max().item()
    dev_b = max_dev(torch, sol.beta, ref.beta)
    print(f"    default (float32 Gram): {sol.iters} Newton / {sol.cg_iters} CG, "
          f"{stop(sol)}, {secs:.3f} s, {syncs} host syncs, Gram launches {gram}, "
          f"others {launched}; torch f32: {ref.iters} Newton / {ref.cg_iters} CG, "
          f"{stop(ref)}, {ref_s:.3f} s, {ref_syncs} syncs; max|beta - beta_torch| = "
          f"{dev_b:.3e} ({dev_b / scale:.2e} of max|beta|)", flush=True)
    smoke.check(sol.mode == "dual" and gram == 1, "float32 dual: one Gram launch")
    smoke.check(sol.beta.dtype == torch.float32 and sol.beta.shape == (p,)
                and bool(torch.isfinite(sol.beta).all()), "float32 beta finite, shape (p,)")
    smoke.check(sol.iters == ref.iters, f"float32 dual: Newton steps {sol.iters} = "
                f"plain float32's {ref.iters}")
    bound = F32_BETA_REL["dual"]
    smoke.check(dev_b <= bound * scale, f"float32 dual: max|beta - beta_torch| = "
                f"{dev_b:.3e} <= {bound:g} * max|beta| = {bound * scale:.3e}")

    plain = PathConfig(solver=SvenConfig(backend="torch", tol=PathConfig().solver.tol))
    # the depth is cut to the first F32_PATH_POINTS points of the 10-point
    # grid (the same points and warm starts), for the script's time
    grid = lambda_grid(X, y, n_lambdas=10)[:F32_PATH_POINTS]
    print(f"[8b] enet_path, float32 data, the first {F32_PATH_POINTS} of 10 lambdas, tol "
          f"{plain.solver.tol:g}", flush=True)
    path, secs, launched, syncs = run_path(
        torch, kernels, svm_state, lambda: enet_path(X, y, lambda1s=grid, lambda2=LAMBDA2))
    path_gram = launched.pop("shifted_gram_cuda")
    ref, ref_s, _, ref_syncs = run_path(
        torch, kernels, svm_state,
        lambda: enet_path(X, y, lambda1s=grid, lambda2=LAMBDA2, config=plain))
    scale = ref.betas.abs().max().item()
    dev_b = max_dev(torch, path.betas, ref.betas)

    def counts(r):
        return (f"evals {list(r.evals)} ({sum(r.evals)}), Newton {list(r.sven_iters)} "
                f"({sum(r.sven_iters) / max(1, sum(r.evals)):.1f} a solve), CG "
                f"{sum(r.cg_iters)}, max KKT after the first point "
                f"{r.kkts[1:].max().item():.3e}")

    print(f"    kernels: {secs:.3f} s, {syncs} host syncs, Gram launches {path_gram}, "
          f"others {launched}, {counts(path)}", flush=True)
    print(f"    torch f32: {ref_s:.3f} s, {ref_syncs} host syncs, {counts(ref)}; "
          f"max|beta - beta_torch| = {dev_b:.3e} ({dev_b / scale:.2e} of max|beta|)",
          flush=True)
    smoke.check(path.betas.shape == (F32_PATH_POINTS, p)
                and bool(torch.isfinite(path.betas).all()),
                f"float32 path betas finite, shape ({F32_PATH_POINTS}, p)")
    smoke.check(path_gram == sum(path.evals) > 0,
                f"float32 path: one Gram launch per Illinois evaluation ({sum(path.evals)})")
    ev, ev_ref = sum(path.evals), sum(ref.evals)
    smoke.check(abs(ev - ev_ref) <= F32_PATH_EVALS_REL * ev_ref,
                f"float32 path: evaluations {ev} within {F32_PATH_EVALS_REL:.0%} of the "
                f"plain float32 path's {ev_ref}")
    bound = F32_BETA_REL["enet_path"]
    smoke.check(dev_b <= bound * scale, f"float32 path: max|beta - beta_torch| = "
                f"{dev_b:.3e} <= {bound:g} * max|beta| = {bound * scale:.3e}")
    return gram + path_gram


#: bounds of the lane-batched passes against their plain version, by X's
#: dtype: float64 sums in another order (far under 1e-10 at these n, p); the
#: float32 and bfloat16 modes at the single passes' bounds (phase 2)
LANE_TOL = {"float64": 1e-10, "float32": 1e-5, "bfloat16": 2e-2}


def route_text(hinge, pl, B: int, n: int, p: int) -> str:
    """The route `hinge.plan` picked, with its lane groups or runs and
    blocks."""
    if pl.route == "shared":
        return (f"route shared, pass 1 in {len(hinge.lane_groups(B, pl.xtv_group))} lane "
                f"group(s) of G <= {pl.xtv_group}, pass 2 in "
                f"{len(hinge.lane_groups(B, pl.xd_group))} of G <= {pl.xd_group}, "
                f"{pl.xd_rows} rows a block")
    if pl.route == "stacked":
        chunks = -(-p // 4096) if p >= 1024 else 1
        return (f"route stacked, pass 1 {-(-p // 128) * B} blocks (a lane per grid z), "
                f"pass 2 {B * -(-n // pl.xd_rows) * chunks} blocks of one lane, "
                f"{pl.xd_rows} rows and one chunk")
    return f"route {pl.route}, a block per lane"


def lane_kernel_rows(torch, smoke, dev, gen, cases) -> dict:
    """The lane-batched hinge passes at each case's operands: against the
    plain lane op, each lane bitwise against a single launch, and timed L2
    cold beside B single launches, the plain op, the bound and one PyTorch
    call (shared X: `torch.mm` on the lanes as columns, bf16 on bfloat16
    lanes; stacked X: `torch.bmm`). Prints each case's route (`hinge.plan`).
    `cases` is a list of (label, X, y, t (B,), C (B,)); X float64 (what a
    batched primal runs on float64 data), float32 or bfloat16, with the
    other operands float64 or float32. Returns the JSON rows of
    `hinge_xtv_lanes_cuda` and `hinge_xd_lanes_cuda` (the first case's
    numbers, every case's under `by_case`)."""
    from repro_torch.kernels import hinge, ref

    rows = {}
    for label, X, y, t, C in cases:
        B = t.shape[0]
        n, p = X.shape[-2:]
        shared = X.dim() == 2
        acc = y.dtype
        kind = str(X.dtype).removeprefix("torch.")
        v = torch.randn(B, n, generator=gen, dtype=torch.float64).to(dev, acc)
        at = (torch.rand(B, p, generator=gen, dtype=torch.float64) > 0.4).to(dev, acc)
        ab = (torch.rand(B, p, generator=gen, dtype=torch.float64) > 0.6).to(dev, acc)
        ts, Cs = t.tolist(), C.tolist()
        lane = [(X if shared else X[i], y if y.dim() == 1 else y[i]) for i in range(B)]
        pl = hinge.plan(B, n, p, X.dtype, shared,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
        what = f"hinge lanes {label} ({B} lanes, X {'shared' if shared else 'stacked'} {kind})"
        print(f"  {what}: {route_text(hinge, pl, B, n, p)}", flush=True)
        d, e_part = hinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab)
        dr, er = ref.hinge_xtv_lanes_ref(X, y, v, t, at, ab)
        hv = hinge.hinge_xd_lanes_cuda(X, y, dr, er[:, None].contiguous(), v, t, C)
        hr = ref.hinge_xd_lanes_ref(X, y, dr, er, v, t, C)
        hv2 = hinge.hinge_xd_lanes_cuda(X, y, d, e_part, v, t, C)
        d_err = (d - dr).abs().max().item()
        xd_err = (hv - hr).abs().max().item()
        hv_err = (hv2 - hr).abs().max().item()
        d_scale, h_scale = max(1.0, dr.abs().max().item()), max(1.0, hr.abs().max().item())
        tol = LANE_TOL[kind]
        smoke.check(d_err <= tol * d_scale and xd_err <= tol * h_scale
                    and hv_err <= tol * h_scale,
                    f"{what}: max|d - plain| = {d_err:.3e}, max|Hv - plain| = {xd_err:.3e} "
                    f"(pass 2 alone), {hv_err:.3e} (both) <= {tol:g} * scale")
        same = 0
        for i in range(B):
            di, ei = hinge.hinge_xtv_cuda(*lane[i], v[i], ts[i], at[i], ab[i])
            hvi = hinge.hinge_xd_cuda(*lane[i], di, ei, v[i], ts[i], Cs[i])
            same += (torch.equal(d[i], di) and torch.equal(e_part[i], ei)
                     and torch.equal(hv2[i], hvi))
        smoke.check(same == B, f"{what}: {same} of {B} lanes bitwise a single launch")
        # the yardstick's lanes in X's type where that is bfloat16, as phase 2's GEMVs
        V, D = (v.T.contiguous(), d.T.contiguous()) if shared else (v, d)
        V, D = V.to(X.dtype), D.to(X.dtype)
        calls = {
            "xtv": (lambda: hinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab),
                    lambda: [hinge.hinge_xtv_cuda(*lane[i], v[i], ts[i], at[i], ab[i])
                             for i in range(B)],
                    lambda: ref.hinge_xtv_lanes_ref(X, y, v, t, at, ab),
                    (lambda: torch.mm(X.T, V)) if shared
                    else (lambda: torch.bmm(V.unsqueeze(1), X))),
            "xd": (lambda: hinge.hinge_xd_lanes_cuda(X, y, d, e_part, v, t, C),
                   lambda: [hinge.hinge_xd_cuda(*lane[i], d[i], e_part[i], v[i], ts[i], Cs[i])
                            for i in range(B)],
                   lambda: ref.hinge_xd_lanes_ref(X, y, dr, er, v, t, C),
                   (lambda: torch.mm(X, D)) if shared
                   else (lambda: torch.bmm(X, D.unsqueeze(2)))),
        }
        # X read once when the lanes share it, B times when they stack it;
        # y once or B times; each lane's vectors once
        xs, ws = X.element_size(), y.element_size()
        x_bytes = (1 if shared else B) * n * p * xs
        y_bytes = (1 if y.dim() == 1 else B) * n * ws
        k = e_part.shape[1]
        peak = "f64" if kind == "float64" else "f32"
        bounds = {"xtv": bound(x_bytes + y_bytes + ws * B * (n + 3 * p + k + 1),
                               B * (2.0 * n * p + 2.0 * n + 6.0 * p), peak),
                  "xd": bound(x_bytes + y_bytes + ws * B * (p + k + 2 * n + 2),
                              B * (2.0 * n * p + 5.0 * n), peak)}
        for name, (lanes_fn, singles_fn, plain_fn, lib_fn) in calls.items():
            ms, singles, plain, lib = (cuda_ms_each(torch, f, dev, True, reps=20)
                                       for f in (lanes_fn, singles_fn, plain_fn, lib_fn))
            b_ms, b_by = bounds[name]
            print(f"  hinge {name} lanes {kind} {label}, {B} x {n}x{p}, X "
                  f"{'shared' if shared else 'stacked'}, route {pl.route}: L2 cold {ms:.4f} "
                  f"ms, {B} single launches {singles:.4f}, plain {plain:.4f}, library "
                  f"{lib:.4f} ({'beaten' if ms < lib else 'not beaten'}), bound {b_ms:.4f} "
                  f"({b_by}; {ms / b_ms:.1f}x, {100 * b_ms / ms:.0f} % of it)", flush=True)
            row = dict(ms=ms, singles_ms=singles, plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib, lane_route=pl.route)
            key = f"hinge_{name}_lanes_cuda"
            if key not in rows:
                rows[key] = dict(max_abs_err=d_err if name == "xtv" else max(xd_err, hv_err),
                                 **row, by_case={})
            rows[key]["by_case"][label] = row
        del v, at, ab, d, e_part, dr, er, hv, hr, hv2, V, D
    return rows


#: each lane's Newton and CG counts and the live batched CG steps (launched
#: less dead) of 9a and 9b as PERF.md records them (§2): each lane's counts
#: are its sequential solve's,
#: and a tree whose lanes stay bitwise single launches gives these iterates
#: again on that card and software
RECORDED_COUNTS = {
    "9a": ([27, 21, 17, 28, 20, 18, 28, 26, 18],
           [2334, 1596, 729, 2074, 1346, 819, 2273, 2367, 763], 2994),
    "9b": ([25, 22, 22, 25, 19], [1630, 1418, 1450, 1356, 805], 1885),
}


def batch_cases(torch, dev, labels=None):
    """Phase 9's GLA-BRA-180-shaped data (seed 2): X, y, cv_folds(X, y, 5)'s
    training stacks, t, the 3 x 3 (t, lambda2) grid, and the lane-pass
    cases (label, X, y, t (B,), C (B,)) whose labels are in `labels` (all
    when None): 9a, the grid on the shared X, and 9b, the stacked folds,
    in float64, and each with X in float32 and bfloat16."""
    from repro_torch.core.batch import cv_folds, en_grid
    from repro_torch.data.synthetic import make_regression

    f64 = dict(dtype=torch.float64, device=dev)
    X, y, beta_true = make_regression(*GLA_BRA, seed=2, device=dev)
    t = 0.5 * beta_true.abs().sum().item()
    ts, l2s = en_grid(torch.tensor([0.5, 0.75, 1.0], **f64) * t,
                      torch.tensor([0.5, 1.0, 4.0], **f64))
    Xtr, ytr, _, _ = cv_folds(X, y, 5)
    C = 1.0 / (2.0 * l2s)
    t5, C5 = torch.full((5,), t, **f64), torch.full((5,), 0.5 / LAMBDA2, **f64)
    make = {"9a": lambda: (X, y, ts, C), "9b": lambda: (Xtr, ytr, t5, C5),
            "9a f32": lambda: (X.float(), y.float(), ts, C),
            "9a bf16": lambda: (X.bfloat16(), y.float(), ts, C),
            "9b f32": lambda: (Xtr.float(), ytr.float(), t5, C5),
            "9b bf16": lambda: (Xtr.bfloat16(), ytr.float(), t5, C5)}
    cases = [(k, *f()) for k, f in make.items() if labels is None or k in labels]
    return X, y, Xtr, ytr, t, ts, l2s, cases


def lane_time_only(torch) -> int:
    """`--lane-time`: `lane_kernel_rows` twice at 9b's operands (cv_folds(X,
    y, 5) of the GLA-BRA-180 shape: 5 stacked folds of 144 x 49,151) with X
    in float64, float32 and bfloat16: each lane bitwise a single launch, and
    the passes L2 cold beside 5 single launches, the plain op, `torch.bmm`
    and the bound. It prints no result line and exits 1 if a check fails;
    it needs nothing of the checkout but the lane and single wrappers, their
    plain versions, `hinge.plan` and `cv_folds`, so a copy of this file
    placed in a checkout of another commit times that commit's passes."""
    print(f"card: {nvidia_smi()}", flush=True)
    dev = torch.device("cuda", 0)
    smoke = Smoke()
    *_, cases = batch_cases(torch, dev, ("9b", "9b f32", "9b bf16"))
    for _ in range(2):   # twice: one reading of a call can stray
        lane_kernel_rows(torch, smoke, dev, torch.Generator().manual_seed(0), cases)
    return 1 if smoke.failures else 0


def phase_batch(torch, smoke, kernels, svm_state, count, dev, gen) -> dict:
    """Phase 9: `sven_batch` at full width on float64 data, default config,
    each lane held to the port's sequential `sven` on that lane on the card:
    9a a (t, lambda2) grid of 9 lanes on a shared GLA-BRA-180-shaped X
    (primal), 9b `cv_folds(X, y, 5)` of it (stacked X, primal), 9c
    `cv_folds` of a YMSD-shaped problem (stacked X, dual). Checks that each
    lane is bitwise its sequential solve (beta by `torch.equal`, equal
    Newton and CG counts), and the launches: one of each lane-batched hinge
    pass per batched CG step, one Gram per lane; prints the copies that lay
    the lanes out as fresh tensors (`pitched`), in all and per batched CG
    step. Returns the lane kernels' JSON rows."""
    from repro_torch.core.batch import cv_folds, sven_batch
    from repro_torch.core.sven import sven
    from repro_torch.core.svm.state import cg_lanes, pitched
    from repro_torch.data.synthetic import make_regression

    f64 = dict(dtype=torch.float64, device=dev)

    def run_case(label, X, y, t, lambda2):
        cg_lanes.steps = cg_lanes.copies = pitched.copies = 0
        sol, secs, launched, syncs = run_path(torch, kernels, svm_state,
                                              lambda: sven_batch(X, y, t, lambda2))
        steps, copies, cg_copies = cg_lanes.steps, pitched.copies, cg_lanes.copies
        dead = cg_lanes.dead
        B = sol.beta.shape[0]
        count(launched)
        check_read_every_1(torch, smoke, kernels, svm_state, label, sol, secs, syncs, dead,
                           lambda: sven_batch(X, y, t, lambda2))

        def lane(i):
            return (X if X.dim() == 2 else X[i], y if y.dim() == 1 else y[i],
                    float(t if t.dim() == 0 else t[i]),
                    float(lambda2 if lambda2.dim() == 0 else lambda2[i]))

        args = [lane(i) for i in range(B)]
        seq, seq_s, seq_launched, seq_syncs = run_path(
            torch, kernels, svm_state, lambda: [sven(*a) for a in args])
        dual = sol.mode == "dual"
        cg_b, cg_s = sol.cg_iters.tolist(), [s_.cg_iters for s_ in seq]
        it_b, it_s = sol.iters.tolist(), [s_.iters for s_ in seq]
        devs = [max_dev(torch, sol.beta[i], s_.beta) / s_.beta.abs().max().item()
                for i, s_ in enumerate(seq)]
        bitwise = sum(torch.equal(sol.beta[i], s_.beta) for i, s_ in enumerate(seq))
        print(f"    batched: {secs:.3f} s, {syncs} host syncs, launches {launched}, "
              f"{steps} batched CG steps ({steps - dead} live, {dead} dead); Newton {it_b}, "
              f"CG {cg_b}; lane layout copies (pitched) {copies} in all, {cg_copies} in CG "
              f"steps ({cg_copies / max(1, steps):.2f} launches a batched CG step)",
              flush=True)
        if label in RECORDED_COUNTS:
            print(f"    per-lane Newton and CG lists and live batched CG steps equal the "
                  f"ones PERF.md records: "
                  f"{(it_b, cg_b, steps - dead) == RECORDED_COUNTS[label]}", flush=True)
        print(f"    sequential ({B} sven calls): {seq_s:.3f} s, {seq_syncs} host syncs, "
              f"launches {seq_launched}; Newton {it_s}, CG {cg_s} ({sum(cg_s)}); max "
              f"|beta - beta_seq| / max|beta_seq| {max(devs):.3e}, {bitwise} of {B} lanes "
              f"bitwise", flush=True)
        smoke.check(sol.mode == ("dual" if label == "9c" else "primal"),
                    f"{label}: mode {sol.mode}")
        smoke.check(sol.beta.shape == (B, X.shape[-1]) and bool(torch.isfinite(sol.beta).all()),
                    f"{label}: beta finite, shape ({B}, p)")
        smoke.check(it_b == it_s, f"{label}: each lane's Newton steps equal its sequential "
                    "solve's")
        smoke.check(cg_b == cg_s, f"{label}: each lane's CG steps equal its sequential "
                    "solve's")
        smoke.check(bitwise == B, f"{label}: {bitwise} of {B} lanes' beta bitwise their "
                    "sequential solves'")
        if dual:
            smoke.check(launched["shifted_gram_cuda"] == B and launched["hinge_xtv_lanes_cuda"]
                        == launched["hinge_xd_lanes_cuda"] == 0,
                        f"{label}: one Gram launch per lane ({B}), no hinge launch")
        else:
            smoke.check(launched["hinge_xtv_lanes_cuda"] == launched["hinge_xd_lanes_cuda"]
                        == steps > 0 and max(cg_b) <= steps - dead <= sum(cg_b),
                        f"{label}: one launch of each lane-batched hinge pass per batched "
                        f"CG step ({steps}: {steps - dead} live, {dead} dead; longest lane "
                        f"{max(cg_b)}, all lanes {sum(cg_b)})")
            smoke.check(launched["hinge_xtv_cuda"] == launched["hinge_xd_cuda"]
                        == launched["shifted_gram_cuda"] == 0,
                        f"{label}: no single hinge launch and no Gram launch")
        return secs

    t_phase = time.perf_counter()
    X, y, Xtr, ytr, t, ts, l2s, cases = batch_cases(torch, dev)
    rows = lane_kernel_rows(torch, smoke, dev, gen, cases)
    del cases
    n, p = GLA_BRA
    print(f"[9a] sven_batch on en_grid(t x {{0.5, 0.75, 1}}, {{0.5, 1, 4}}): 9 lanes on "
          f"a shared X, n = {n}, p = {p}", flush=True)
    run_case("9a", X, y, ts, l2s)
    print(f"[9b] sven_batch on cv_folds(X, y, 5): X {tuple(Xtr.shape)} "
          f"({Xtr.numel() * 8 / 1e6:.0f} MB), t, lambda2 = {LAMBDA2}", flush=True)
    run_case("9b", Xtr, ytr, torch.tensor(t, **f64), torch.tensor(LAMBDA2, **f64))
    del X, y, Xtr, ytr
    torch.cuda.empty_cache()
    X, y, beta_true = make_regression(*YMSD, seed=1, device=dev)
    t = 0.5 * beta_true.abs().sum().item()
    Xtr, ytr, _, _ = cv_folds(X, y, 5)
    del X, y
    print(f"[9c] sven_batch on cv_folds(X, y, 5) at the YMSD shape: X "
          f"{tuple(Xtr.shape)} ({Xtr.numel() * 8 / 1e9:.2f} GB), lambda2 = {LAMBDA2}",
          flush=True)
    run_case("9c", Xtr, ytr, torch.tensor(t, **f64), torch.tensor(LAMBDA2, **f64))
    del Xtr, ytr
    torch.cuda.empty_cache()
    print(f"    phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def cv_checks(torch, smoke, label, res, secs, launched, syncs, steps, dead, ref,
              refit, dual, n_lambdas, k):
    """Phase 11's checks of one `cross_validate` run (its CVResult `res`,
    with its seconds, launches, host syncs and batched CG steps launched and
    dead) against the port's sequential `cross_validate_reference` run
    `ref` = ((lambda1s, mse, n_kept, evals), seconds, launches, syncs, CG
    steps) and `enet` at lambda_min (`refit`, the same scaling)."""
    (_, mse, kept, evals), ref_s, ref_launched, ref_syncs, ref_steps = ref
    scale = mse.max().item()
    dev_mse = max_dev(torch, res.mse_path, mse)
    ref_min = int(torch.argmin(mse.mean(1)))
    print(f"    batched: {secs:.3f} s, {syncs} host syncs, launches {launched}, {steps} "
          f"batched CG steps ({steps - dead} live, {dead} dead); evaluations per lambda "
          f"(sum over folds) {res.evals.sum(1).tolist()}, per fold "
          f"{res.evals.sum(0).tolist()}; index_min {res.index_min}, lambda_min "
          f"{res.lambda_min:.6g}", flush=True)
    print(f"    reference ({k} sequential paths): {ref_s:.3f} s, {ref_syncs} host syncs, "
          f"launches {ref_launched}, {ref_steps} CG steps; evaluations per lambda "
          f"{evals.sum(1).tolist()}; index_min {ref_min}; max|mse - mse_ref| {dev_mse:.3e}, "
          f"max mse {scale:.6g}", flush=True)
    print(f"    refit (enet at lambda_min): {refit.evals} evals, {refit.sven_iters} Newton / "
          f"{refit.cg_iters} CG", flush=True)
    smoke.check(res.mse_path.shape == (n_lambdas, k) and bool(torch.isfinite(res.mse_path).all())
                and bool(torch.isfinite(res.beta).all()),
                f"{label}: mse_path finite, shape ({n_lambdas}, {k}); refit beta finite")
    smoke.check(dev_mse <= 1e-10 * scale, f"{label}: max|mse - mse_ref| = {dev_mse:.3e} <= "
                f"1e-10 x max mse = {1e-10 * scale:.3e}")
    smoke.check(res.index_min == ref_min, f"{label}: index_min {res.index_min} = the "
                f"reference's {ref_min}")
    smoke.check(torch.equal(res.evals, evals) and torch.equal(res.n_kept, kept),
                f"{label}: evaluations and kept columns per (lambda, fold) equal the "
                "reference's")
    smoke.check(torch.equal(res.beta, refit.beta) and torch.equal(res.intercept, refit.intercept),
                f"{label}: the refit's beta and intercept bitwise `enet` at lambda_min")
    if dual:
        n_gram = int(res.evals.sum()) + refit.evals
        smoke.check(launched["shifted_gram_cuda"] == n_gram and launched["hinge_xtv_cuda"]
                    == launched["hinge_xtv_lanes_cuda"] == 0,
                    f"{label}: one Gram launch per lane and evaluation, the refit's included "
                    f"({n_gram}), no hinge launch")
        smoke.check(ref_launched["shifted_gram_cuda"] == int(evals.sum()),
                    f"{label}: the reference launched one Gram per evaluation")
        return
    for p1, p2 in (("hinge_xtv_lanes_cuda", "hinge_xd_lanes_cuda"),
                   ("hinge_xtv_cuda", "hinge_xd_cuda")):
        smoke.check(launched[p1] == launched[p2], f"{label}: {p1} = {p2} ({launched[p1]})")
    both = launched["hinge_xtv_lanes_cuda"] + launched["hinge_xtv_cuda"]
    smoke.check(launched["hinge_xtv_lanes_cuda"] > 0 and both == steps
                and launched["shifted_gram_cuda"] == 0,
                f"{label}: lane-batched hinge launches ({launched['hinge_xtv_lanes_cuda']}) + "
                f"single launches ({launched['hinge_xtv_cuda']}) = batched CG steps ({steps}: "
                f"{steps - dead} live, {dead} dead), no Gram launch")
    smoke.check(ref_launched["hinge_xtv_cuda"] == ref_launched["hinge_xd_cuda"] == ref_steps
                and ref_launched["hinge_xtv_lanes_cuda"] == 0,
                f"{label}: the reference launched one single hinge pass of each kind per "
                f"CG step ({ref_steps})")


def phase_cv(torch, smoke, kernels, svm_state, count, dev) -> None:
    """Phase 11: the penalized stack on float64 data, default config. 11a
    `ElasticNetCV(k=5, n_lambdas=10)` at the GLA-BRA-180 shape (primal
    folds), 11b `cross_validate` at the YMSD shape (dual folds), each
    against the port's sequential `cross_validate_reference` on the card
    and its refit bitwise `enet`; 11c `enet_batch` on 5 stacked folds, cold
    and then warm, each lane bitwise the sequential `_enet_point` on fresh
    copies of its operands and its carry."""
    from repro_torch.core import api
    from repro_torch.core.batch import cv_folds
    from repro_torch.core.cv import ElasticNetCV, cross_validate, cross_validate_reference
    from repro_torch.core.elastic_net import lambda1_max
    from repro_torch.core.sven import _pick_mode
    from repro_torch.core.svm.state import cg_lanes
    from repro_torch.data.synthetic import make_regression

    k, L = 5, 10
    t_phase = time.perf_counter()

    def cv_case(label, X, y, fit, dual):
        n, p = X.shape
        res, secs, launched, syncs = run_path(torch, kernels, svm_state, fit)
        steps, dead = cg_lanes.steps, cg_lanes.dead
        count(launched)
        ref_out, ref_s, ref_launched, ref_syncs = run_path(
            torch, kernels, svm_state,
            lambda: cross_validate_reference(X, y, k=k, n_lambdas=L, lambda2=LAMBDA2,
                                             with_counts=True))
        ref = (ref_out, ref_s, ref_launched, ref_syncs, cg_lanes.steps)
        refit = api.enet(X, y, res.lambda_min, LAMBDA2, standardize=True, fit_intercept=True)
        mode = _pick_mode((n // k) * (k - 1), p, api.PathConfig().solver)
        print(f"    every fold in {mode} mode ({(n // k) * (k - 1)} x {p})", flush=True)
        smoke.check(mode == ("dual" if dual else "primal"), f"{label}: folds in {mode} mode")
        cv_checks(torch, smoke, label, res, secs, launched, syncs, steps, dead, ref,
                  refit, dual, L, k)

    X, y, _ = make_regression(*GLA_BRA, seed=2, device=dev)
    print(f"[11a] ElasticNetCV(k={k}, n_lambdas={L}, lambda2={LAMBDA2}).fit, standardize + "
          f"intercept, n = {GLA_BRA[0]}, p = {GLA_BRA[1]}", flush=True)
    cv_case("11a", X, y,
            lambda: ElasticNetCV(k=k, n_lambdas=L, lambda2=LAMBDA2).fit(X, y).cv_result_,
            dual=False)

    Xtr, ytr, _, _ = cv_folds(X, y, k)   # for 11c
    del X, y
    torch.cuda.empty_cache()

    X, y, _ = make_regression(*YMSD, seed=1, device=dev)
    print(f"[11b] cross_validate(k={k}, n_lambdas={L}, lambda2={LAMBDA2}), standardize + "
          f"intercept, n = {YMSD[0]}, p = {YMSD[1]}", flush=True)
    cv_case("11b", X, y, lambda: cross_validate(X, y, k=k, n_lambdas=L, lambda2=LAMBDA2),
            dual=True)
    del X, y
    torch.cuda.empty_cache()

    # 11c: enet_batch on 11a's folds, cold and then warm from the cold carry
    config = api.resolve_path_config(api.PathConfig(), Xtr)
    heads = [lambda1_max(Xtr[i], ytr[i]).item() for i in range(k)]
    print(f"[11c] enet_batch on cv_folds(X, y, {k}): X {tuple(Xtr.shape)}, lambda1 = "
          f"{{0.1, ..., 0.5}} x each fold's lambda1_max, lambda2 = {LAMBDA2}; cold, then at "
          f"0.8 x those lambda1s warm from the cold carry on lanes 0, 2, 4", flush=True)
    l1 = [0.1 * (i + 1) * heads[i] for i in range(k)]
    warm_l1 = [0.8 * v for v in l1]
    has_warm = [True, False, True, False, True]
    cold_out, secs, launched, syncs = run_path(
        torch, kernels, svm_state,
        lambda: api.enet_batch(Xtr, ytr, torch.tensor(l1, dtype=torch.float64, device=dev),
                               LAMBDA2, return_carry=True))
    count(launched)
    runs = [("cold", cold_out, secs, launched, syncs, cg_lanes.steps, cg_lanes.dead, l1,
             [None] * k)]
    pts0, carry0 = cold_out
    warm_out, secs, launched, syncs = run_path(
        torch, kernels, svm_state,
        lambda: api.enet_batch(Xtr, ytr, torch.tensor(warm_l1, dtype=torch.float64, device=dev),
                               LAMBDA2, warm=carry0, has_warm=has_warm, return_carry=True))
    count(launched)
    runs.append(("warm", warm_out, secs, launched, syncs, cg_lanes.steps, cg_lanes.dead,
                 warm_l1, [api.EnetCarry(*(f[i].clone() for f in carry0)) if has_warm[i]
                           else None for i in range(k)]))
    for name, (pts, carry), secs, launched, syncs, steps, dead, lam1s, starts in runs:
        lanes = [(Xtr[i].clone(), ytr[i].clone()) for i in range(k)]

        def sequential():
            return [api._enet_point(Xi, yi, lam1s[i], LAMBDA2,
                                    starts[i] if starts[i] is not None
                                    else api.cold_carry(Xi, yi), config)
                    for i, (Xi, yi) in enumerate(lanes)]

        seq, seq_s, seq_launched, seq_syncs = run_path(torch, kernels, svm_state, sequential)
        bitwise = [torch.equal(pts.beta[i], pt.beta) and torch.equal(carry.alpha[i], nc.alpha)
                   and torch.equal(carry.w[i], nc.w) and pts.t[i].item() == pt.t.item()
                   and pts.nu[i].item() == pt.nu.item() and torch.equal(pts.keep[i], pt.keep)
                   for i, (nc, pt) in enumerate(seq)]
        counts_b = (list(pts.evals), list(pts.sven_iters), list(pts.cg_iters))
        counts_s = tuple([getattr(pt, f) for _, pt in seq]
                         for f in ("evals", "sven_iters", "cg_iters"))
        print(f"    {name}: batched {secs:.3f} s, {syncs} host syncs, launches {launched}, "
              f"{steps} batched CG steps ({dead} dead); evals {counts_b[0]}, Newton "
              f"{counts_b[1]}, CG {counts_b[2]}; kept {pts.n_kept.tolist()}", flush=True)
        print(f"    {name}: sequential ({k} _enet_point calls) {seq_s:.3f} s, {seq_syncs} host "
              f"syncs, launches {seq_launched}; evals {counts_s[0]}, Newton {counts_s[1]}, CG "
              f"{counts_s[2]}; {sum(bitwise)} of {k} lanes bitwise", flush=True)
        smoke.check(all(bitwise), f"11c {name}: {sum(bitwise)} of {k} lanes' beta, alpha, w, "
                    "t, nu and keep bitwise their sequential points'")
        smoke.check(counts_b == counts_s, f"11c {name}: each lane's evaluations, Newton and CG "
                    "steps equal its sequential point's")
        both = launched["hinge_xtv_lanes_cuda"] + launched["hinge_xtv_cuda"]
        smoke.check(both == launched["hinge_xd_lanes_cuda"] + launched["hinge_xd_cuda"] == steps
                    > 0 and launched["hinge_xtv_lanes_cuda"] > 0,
                    f"11c {name}: lane-batched ({launched['hinge_xtv_lanes_cuda']}) + single "
                    f"({launched['hinge_xtv_cuda']}) hinge launches = batched CG steps "
                    f"({steps})")
    del Xtr, ytr, runs, pts0, carry0, cold_out, warm_out
    torch.cuda.empty_cache()

    print(f"    phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)


#: phase 12's cells: label, request shape, requests a wave, penalized
#: fraction, max_batch, the kernels its solves must launch, and the factor
#: on the loadgen's t of each constrained request. At GLA-BRA the
#: loadgen's t (0.15 sum_j |x_j^T y| / n) lies far above the l1 norm of
#: the unconstrained solution, so every such request would be the same
#: 2-Newton solve, warm or cold, and wave 2's warm-start check could not
#: fail; at 0.01 x it the constraint binds and a cold solve takes tens of
#: Newton and hundreds of CG steps
SERVE_CELLS = (("12a", GLA_BRA, 10, 0.2, 8, "hinge", 0.01),
               ("12b", YMSD, 5, 0.0, 4, "gram", 1.0))
SERVE_WAVES = 2
#: phase 12: the top of the band that each route path's median
#: log10(actual / modeled seconds) must lie in; the bottom is 0. The cost
#: model counts FLOPs at the card's measured rates (JAX's iteration
#: constants), and a launch of the runtime runs slower than that
RESIDUAL_BAND = 4.0
SERVE_DATA_SEED = 11       # the requests' data set (`LoadSpec.data_seed`)
ONLINE_BLOCK = 16_384      # rows a block fed to `OnlineElasticNet` (12c)


def phase_serving(torch, smoke, kernels, svm_state, count, dev, cells=SERVE_CELLS,
                  waves=SERVE_WAVES, block=ONLINE_BLOCK) -> None:
    """Phase 12: the serving runtime on float64 data, default config. Each
    cell of `cells` plays `waves` seeded waves of one data set's requests
    (`runtime.LoadSpec`, seed = the wave) open loop into one
    `ContinuousScheduler(max_batch, max_wait=None, fixed_batch=True)` (its
    warm-start cache carried from wave to wave; every launch padded to
    max_batch with all-zero dummy lanes), and drains each wave again cold
    through `ElasticNetEngine(max_batch, cache=None).drain_reference()`;
    then (12c) `OnlineElasticNet` takes the last cell's rows in blocks of
    `block` and solves at t and 1.03 t. A cell's constrained requests are
    served at its t factor times the loadgen's t (the penalized ones as
    drawn), so that wave 2's warm starts have Newton steps to save."""
    import numpy as np

    from repro_torch.core import enet, routing, sven
    from repro_torch.runtime import (PENALIZED, ContinuousScheduler, LoadSpec,
                                     OnlineElasticNet, fingerprint_problem, make_workload,
                                     run_open_loop)
    from repro_torch.runtime.scheduler import stack_padded
    from repro_torch.serve import ElasticNetEngine

    def host_seconds(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t_phase = time.perf_counter()
    hinge = ("hinge_xtv_lanes_cuda", "hinge_xtv_cuda", "hinge_xd_lanes_cuda", "hinge_xd_cuda")
    for label, shape, n_req, pen, max_batch, kind, t_scale in cells:
        t_cell = time.perf_counter()
        # fixed_batch pads every launch to max_batch, as JAX's loadgen smoke
        # does to pin its launch shapes: the waves' form mixes differ (seed =
        # wave), and the power-of-two ladder would give a new rung for it
        sched = ContinuousScheduler(max_batch=max_batch, max_wait=None, fixed_batch=True,
                                    device=dev)
        reference = ElasticNetEngine(max_batch=max_batch, cache=None, device=dev)
        print(f"[{label}] serving {waves} waves of {n_req} requests (penalized fraction "
              f"{pen}) on one {shape[0]} x {shape[1]} data set: bucket "
              f"{sched.bucket_of(*shape)}, max_batch {max_batch}", flush=True)
        cell_launched = {}
        for wave in range(waves):
            workload = make_workload(LoadSpec(shapes=(shape,), n_datasets=1, n_requests=n_req,
                                              penalized_fraction=pen,
                                              data_seed=SERVE_DATA_SEED, seed=wave))
            workload = [i if i.form == PENALIZED else i._replace(lam=t_scale * i.lam)
                        for i in workload]
            shapes0, padded0 = sched.stats.bucket_shapes, sched.stats.padded_slots
            hits0, misses0 = sched.cache.hits, sched.cache.misses
            out, secs, launched, syncs = run_path(torch, kernels, svm_state,
                                                  lambda: run_open_loop(sched, workload))
            count(launched)
            ref_ids = [reference.submit_penalized(i.X, i.y, i.lam, i.lambda2)
                       if i.form == PENALIZED else reference.submit(i.X, i.y, i.lam, i.lambda2)
                       for i in workload]
            ref, ref_s, ref_launched, ref_syncs = run_path(torch, kernels, svm_state,
                                                           reference.drain_reference)
            count(ref_launched)
            for k, v in list(launched.items()) + list(ref_launched.items()):
                cell_launched[k] = cell_launched.get(k, 0) + v
            res = [out["results"][rid] for rid in out["ids"]]
            refs = [ref[rid] for rid in ref_ids]
            statuses = sorted({r.status for r in res})
            ref_dev = max(float(np.abs(r.beta - q.beta).max()) for r, q in zip(res, refs))
            newton = [int(r.iters) for r in res]
            ref_newton = [int(q.iters) for q in refs]
            hits, misses = sched.cache.hits - hits0, sched.cache.misses - misses0
            new_shapes = sched.stats.bucket_shapes - shapes0
            forms = [i.form[0] for i in workload]
            print(f"    wave {wave + 1} ({''.join(forms)}): runtime {secs:.3f} s "
                  f"({syncs} host syncs, launches {launched}), reference {ref_s:.3f} s "
                  f"({ref_syncs} host syncs), reference / runtime {ref_s / secs:.2f}x; p50 "
                  f"{out['p50_latency_s']:.3f} s, p99 {out['p99_latency_s']:.3f} s; padded "
                  f"slots {sched.stats.padded_slots - padded0}; cache hits {hits} / "
                  f"{hits + misses} ({hits / max(1, hits + misses):.2f}); new launch shapes "
                  f"{new_shapes}; Newton steps {sum(newton)} {newton}, cold reference "
                  f"{sum(ref_newton)} {ref_newton}; "
                  f"max|beta - beta_ref| {ref_dev:.3e}", flush=True)
            smoke.check(statuses == ["ok"] and len(res) == n_req,
                        f"{label} wave {wave + 1}: all {n_req} requests ok ({statuses})")
            smoke.check(all(r.beta.shape == (shape[1],) and bool(np.isfinite(r.beta).all())
                            for r in res), f"{label} wave {wave + 1}: betas finite, shape (p,)")
            smoke.check(ref_dev < 1e-6, f"{label} wave {wave + 1}: max|beta - "
                        f"drain_reference| = {ref_dev:.3e} < 1e-6")
            for item, r in list(zip(workload, res))[:2]:
                Xd = torch.as_tensor(item.X, device=dev)
                yd = torch.as_tensor(item.y, device=dev)
                direct = (enet(Xd, yd, item.lam, item.lambda2) if item.form == PENALIZED
                          else sven(Xd, yd, item.lam, item.lambda2)).beta.cpu().numpy()
                dev_d = float(np.abs(r.beta - direct).max())
                rel = dev_d / max(float(np.abs(direct).max()), 1e-300)
                del Xd, yd
                smoke.check(dev_d < 1e-6, f"{label} wave {wave + 1}: {item.form} request vs "
                            f"a direct solve of the unpadded problem: max|beta - direct| = "
                            f"{dev_d:.3e} < 1e-6 ({rel:.3e} x max|beta|)")
            if wave > 0:
                smoke.check(hits > 0, f"{label} wave {wave + 1}: {hits} cache hits > 0")
                smoke.check(sum(newton) <= sum(ref_newton), f"{label} wave {wave + 1}: Newton "
                            f"steps {sum(newton)} <= the cold reference's {sum(ref_newton)}")
                smoke.check(new_shapes == 0, f"{label} wave {wave + 1}: no new launch shape "
                            f"({sched.stats.bucket_shapes} in all)")
            torch.cuda.empty_cache()
        if kind == "hinge":
            n_kernel = sum(cell_launched.get(k, 0) for k in hinge[:2])
            smoke.check(n_kernel > 0 and n_kernel == sum(cell_launched.get(k, 0)
                                                         for k in hinge[2:]),
                        f"{label}: hinge launches (lane-batched + single) {n_kernel} > 0, "
                        "both passes alike")
        else:
            n_kernel = cell_launched.get("shifted_gram_cuda", 0)
            smoke.check(n_kernel > 0, f"{label}: Gram launches {n_kernel} > 0")
        # every launch is priced by the router's estimate on one device,
        # from the calibration the scheduler measured on the card when it
        # was built; the model counts FLOPs only, and the runtime runs
        # slower than its FLOPs at the measured rate (PERF.md §5)
        recs = sched.solve_log.records()
        rep = sched.solve_log.residual_report()
        cal = routing._CALIBRATIONS.get(("cuda", 1))
        print(f"    {label}: {len(recs)} launches, priced with {cal}; modeled against actual "
              f"per route path {rep['by_path']} ({rep['n_unmodeled']} unmodeled)", flush=True)
        smoke.check(cal is not None and cal.kernel_backend == "cuda"
                    and cal.flops_per_s > 1e12 and cal.gram_flops_per_s > 1e12,
                    f"{label}: the launches are priced with the card's measured rates, "
                    "not the shape-only default")
        smoke.check(len(recs) > 0 and all(r.modeled_s == routing.estimate_batch_seconds(
            *r.bucket, r.batch, form=r.form, device=dev) > 0.0 for r in recs),
                    f"{label}: every launch priced (modeled_s > 0; "
                    f"{[round(r.modeled_s, 6) for r in recs]})")
        p50 = {k: v["log10_ratio_p50"] for k, v in rep["by_path"].items()}
        smoke.check(set(p50) == {"single"} and all(0.0 <= v <= RESIDUAL_BAND for v in
                                                     p50.values()),
                    f"{label}: the median log10(actual / modeled) {p50} within "
                    f"[0, {RESIDUAL_BAND}]")
        # the runtime's host work apart: a request's fingerprint, and a
        # launch's staging into host buffers and its copy to the card
        X, y = workload[0].X, workload[0].y
        bn, bp = sched.bucket_of(*shape)
        fp_s = host_seconds(lambda: fingerprint_problem(X, y))
        stage_s = host_seconds(lambda: stack_padded(workload[:max_batch], bn, bp, max_batch,
                                                    np.float64))
        Xb, _ = stack_padded(workload[:1], bn, bp, max_batch, np.float64)
        copy_s = host_seconds(lambda: torch.from_numpy(Xb).to(dev))
        del Xb
        print(f"    {label}: {time.perf_counter() - t_cell:.1f} s; launches {cell_launched}; "
              f"host work: fingerprint {fp_s:.3f} s a request, staging {stage_s:.3f} s and "
              f"copy to the card {copy_s:.3f} s a launch of {max_batch} ({bn} x {bp})",
              flush=True)
        t = next((i.lam for i in workload if i.form != PENALIZED), None)
        del sched, reference, workload, out, ref, res, refs
        torch.cuda.empty_cache()

    # 12c: the online session on the last cell's data set
    n, p = X.shape
    print(f"[12c] OnlineElasticNet(p={p}): {n} rows in blocks of {block}, solved at t = "
          f"{t:.6g} and warm at 1.03 t", flush=True)
    online = OnlineElasticNet(p=p, device=dev)
    t0 = time.perf_counter()
    for lo in range(0, n, block):
        online.update(X[lo:lo + block], y[lo:lo + block])
    torch.cuda.synchronize()
    upd_s = time.perf_counter() - t0
    Xd, yd = torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev)
    for tt, name in ((t, "cold"), (1.03 * t, "warm")):
        sol, secs, launched, syncs = run_path(torch, kernels, svm_state,
                                              lambda: online.solve(tt, 1.0))
        ref_sol, ref_s, ref_launched, _ = run_path(torch, kernels, svm_state,
                                                   lambda: sven(Xd, yd, tt, 1.0))
        count(ref_launched)
        scale = ref_sol.beta.abs().max().item()
        dev_o = max_dev(torch, sol.beta, ref_sol.beta)
        print(f"    {name} at {tt:.6g}: {sol.iters} Newton, {secs:.3f} s, {syncs} host syncs, "
              f"kkt {sol.kkt.item():.3e}; sven on all {n} rows: {ref_sol.iters} Newton, "
              f"{ref_s:.3f} s; max|beta - beta_sven| {dev_o:.3e} ({dev_o / scale:.3e} x "
              f"max|beta|)", flush=True)
        smoke.check(sol.n == n and bool(torch.isfinite(sol.beta).all()),
                    f"12c {name}: beta finite after {sol.n} rows")
        smoke.check(dev_o <= 1e-8 * scale, f"12c {name}: max|beta - beta_sven| = {dev_o:.3e} "
                    f"<= 1e-8 x max|beta| = {1e-8 * scale:.3e}")
        if name == "warm":
            smoke.check(sol.iters <= ref_sol.iters, f"12c warm: {sol.iters} Newton steps <= "
                        f"sven's cold {ref_sol.iters}")
    print(f"    12c: {upd_s:.3f} s for {online.updates} updates", flush=True)
    del Xd, yd, online
    torch.cuda.empty_cache()
    print(f"    phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)


def serving_only(torch) -> int:
    """`--serving`: phase 12 alone (the kernels built first), with its
    checks; prints no result line. Exits 1 if a check failed."""
    from repro_torch import kernels
    from repro_torch.core.svm import state as svm_state
    from repro_torch.kernels import _build

    print(f"card: {nvidia_smi()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    smoke = Smoke()
    t0 = time.perf_counter()
    phase_serving(torch, smoke, kernels, svm_state, lambda launched: None,
                  torch.device("cuda", 0))
    print(f"total {time.perf_counter() - t0:.1f} s; {len(smoke.failures)} check(s) failed",
          flush=True)
    return 1 if smoke.failures else 0


def gram_bitwise_only(torch, other: Path, modes) -> int:
    """`--gram-bitwise`: this checkout's Gram against a build of another
    `gram.cu` (`other`), in each of `modes` (f64: float64 operands at
    "f32"), at the YMSD shape and four ragged ones (one to six 96-column
    tiles), three radii and both layouts: how many K are bitwise equal.
    Returns 1 if any differs."""
    import ctypes

    from repro_torch.data.synthetic import make_regression
    from repro_torch.kernels import _build, gram
    from repro_torch.kernels.ops import _storage

    lib = _build.BUILD_DIR / f"other-{_build._target(other).name}"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(other)],
                       check=True, capture_output=True)
    lib = gram._typed(ctypes.CDLL(str(lib)))
    print(f"card: {nvidia_smi()}", flush=True)
    dev = torch.device("cuda", 0)
    cases = differ = 0
    for n, p in (YMSD, RAGGED, (1003, 97), (1000, 191), (13, 500)):
        X, y, _ = make_regression(n, p, seed=0, dtype=torch.float32, device=dev)
        for prec in modes:
            mode = "f32" if prec == "f64" else prec
            Xs, ys = ((X.double(), y.double()) if prec == "f64"
                      else (_storage(X, prec), _storage(y, prec)))
            for t in (0.9, 37.0, 1e6):
                for flatten in (True, False):
                    same = torch.equal(gram._launch(Xs, ys, t, mode, flatten),
                                       gram._launch(Xs, ys, t, mode, flatten, lib=lib))
                    cases, differ = cases + 1, differ + (not same)
                    if not same:
                        print(f"  differs: {prec} {n}x{p} t = {t:g} flatten = {flatten}",
                              flush=True)
    print(f"  gram bitwise: {cases - differ} of {cases} K ({', '.join(modes)}) equal to "
          f"the build of {other}", flush=True)
    return 1 if differ else 0


def gram_split_only(torch, modes) -> int:
    """`--gram-split`: the Gram at the YMSD shape in each of `modes` (f64:
    float64 operands at "f32"), on phase 2's data: its time (back-to-back
    launches, CUDA events), each of its launches apart (profiler), and
    cuBLAS's A^T A in the same type."""
    from repro_torch.data.synthetic import make_regression
    from repro_torch.kernels import gram
    from repro_torch.kernels.ops import _storage

    print(f"card: {nvidia_smi()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    X, y, beta_true = make_regression(*YMSD, seed=0, dtype=torch.float32,
                                      device=torch.device("cuda", 0))
    t = 0.5 * beta_true.abs().sum().item()
    lines = []
    for prec in modes:   # every mode's launches timed before the profiler runs
        mode = "f32" if prec == "f64" else prec
        Xs, ys = ((X.double(), y.double()) if prec == "f64"
                  else (_storage(X, prec), _storage(y, prec)))
        call = (lambda Xs=Xs, ys=ys, mode=mode:
                gram.shifted_gram_cuda(Xs, ys, t, precision=mode))
        lines.append((prec, call, cuda_ms(torch, call), cublas_gram_ms(torch, Xs, ys, prec)))
    for prec, call, ms, library in lines:
        apart = {}
        for _ in range(3):   # a profiler session now and then records no kernel
            apart = apart or kernel_ms(torch, call)
        # the kernel's name and template arguments (one level of nesting)
        names = {k: re.search(r"(?:::|\s)(\w+(?:<(?:[^<>]|<[^<>]*>)*>)?)\(",
                              k.replace("(anonymous namespace)::", "")) for k in apart}
        print(f"  gram {prec} at {YMSD[0]}x{YMSD[1]}: kernel {ms:.4f} ms together; apart "
              "(profiler) " + ", ".join(f"{names[k].group(1) if names[k] else k[:40]} "
                                        f"{v:.4f} ms" for k, v in apart.items())
              + f"; cuBLAS A^T A {library:.4f} ms", flush=True)
    return 0


#: phase 13: the ranks of its mesh (all on the one card, over gloo), the
#: 8-lane grid of 13c (4 t x 2 lambda2) and the folds of 13c and 13d
MULTI_WORLD = 2
MULTI_TS = (0.25, 0.5, 0.75, 1.0)
MULTI_L2S = (0.5, 1.0)
MULTI_FOLDS = 4
MULTI_LAMBDAS = 10
#: 13f: the shotgun baseline at its callers' problems (`benchmarks/common.py`:
#: gla_bra_like and ymsd_like, `bench_pggn.py` / `bench_nggp.py`'s parallel),
#: and ymsd_like with a full draw (parallel = p). The last field is the
#: tolerance against `enet`, x max|beta|: a partial draw's stop rule sees
#: only the drawn coordinates, and at gla_bra_like (128 of 3,500 a round)
#: Shotgun stops 2.4e-2 x from the optimum (JAX's alike on the CPU); at
#: ymsd_like it stops within 4e-11 x. A full draw is also held to the
#: bound its stop rule certifies (`baselines/shotgun.py::full_draw_bound`).
SHOTGUN_CELLS = (("gla_bra_like", 180, 3500, 0.4, 128, 5e-2),
                 ("ymsd_like", 10_000, 90, 0.2, 64, 1e-8),
                 ("ymsd_like", 10_000, 90, 0.2, 90, 1e-8))


def _lane_counts(torch, sol):
    return [torch.as_tensor(v).tolist() for v in (sol.iters, sol.cg_iters)]


def multi_rank(mesh):
    """Phase 13's work on one rank of `mesh` (every rank runs it alike):
    13a-13e, each timed and counted on this rank; returns rank 0's results
    with the per-rank counts gathered (CPU tensors)."""
    import torch

    from repro_torch import dist, kernels
    from repro_torch.core import routing
    from repro_torch.core.api import enet_batch
    from repro_torch.core.batch import cv_folds, en_grid, sven_batch
    from repro_torch.core.cv import cross_validate
    from repro_torch.core.distributed import sven_sharded
    from repro_torch.core.elastic_net import lambda1_max
    from repro_torch.core.svm import state as svm_state
    from repro_torch.data.synthetic import make_regression

    dev = mesh.device
    out = {"size": mesh.size, "backend": mesh.backend, "device": str(dev)}

    def per_rank(v):        # each rank's number, in rank order
        return dist.gather(mesh, torch.tensor([float(v)], dtype=torch.float64,
                                              device=dev)).tolist()

    def run(fn):
        torch.cuda.synchronize()
        dist.all_reduce(mesh, torch.zeros(1, device=dev))      # start together
        kernels.reset_launches()
        svm_state.cg_lanes.steps = svm_state.cg_lanes.dead = dist.all_reduce.calls = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched, calls, steps = kernels.launches(), dist.all_reduce.calls, \
            svm_state.cg_lanes.steps          # read before the gathers below add to them
        return res, {"seconds": per_rank(secs), "launches": {
            k: per_rank(v) for k, v in launched.items() if v},
            "collectives": per_rank(calls), "cg_steps": per_rank(steps)}

    Xd, yd, bd = make_regression(*YMSD, seed=1, device=dev)
    td = 0.5 * bd.abs().sum().item()
    Xp, yp, bp = make_regression(*GLA_BRA, seed=2, device=dev)
    tp = 0.5 * bp.abs().sum().item()
    # 13a, 13b: rows split over the ranks (13a once untimed first: a rank's
    # first solve pays its process's CUDA and library set-up)
    sven_sharded(Xd, yd, td, LAMBDA2, mesh=mesh)
    sol, out["13a_run"] = run(lambda: sven_sharded(Xd, yd, td, LAMBDA2, mesh=mesh))
    out["13a"] = (sol.beta, sol.iters, sol.cg_iters, sol.mode)
    sol, out["13b_run"] = run(lambda: sven_sharded(Xp, yp, tp, LAMBDA2, mesh=mesh))
    out["13b"] = (sol.beta, sol.iters, sol.cg_iters, sol.mode)
    # 13c: lane fan-out, pinned
    ts, l2s = en_grid(torch.tensor([f * tp for f in MULTI_TS], device=dev),
                      torch.tensor(MULTI_L2S, device=dev, dtype=torch.float64))
    with dist.mesh_context(mesh):
        sol, out["13c_grid_run"] = run(lambda: sven_batch(Xp, yp, ts, l2s, route="batch"))
    out["13c_grid"] = sol
    Xtr, ytr, _, _ = cv_folds(Xd, yd, MULTI_FOLDS)
    l1 = torch.stack([0.1 * lambda1_max(Xtr[i], ytr[i]) for i in range(MULTI_FOLDS)])
    with dist.mesh_context(mesh):
        pts, out["13c_folds_run"] = run(lambda: enet_batch(Xtr, ytr, l1, LAMBDA2,
                                                           route="batch"))
    out["13c_folds"] = pts
    del Xtr, ytr
    torch.cuda.empty_cache()
    # 13d: fold fan-out; then k = 5 under the context, which the mesh does not divide
    cv, out["13d_run"] = run(lambda: cross_validate(Xd, yd, k=MULTI_FOLDS,
                                                    n_lambdas=MULTI_LAMBDAS, mesh=mesh))
    out["13d"] = cv
    with dist.mesh_context(mesh):
        cv5, out["13d_nested_run"] = run(lambda: cross_validate(
            Xd, yd, k=MULTI_FOLDS + 1, n_lambdas=MULTI_LAMBDAS, mesh="auto"))
    out["13d_nested"] = cv5
    torch.cuda.empty_cache()
    # 13e: the router on this card
    out["13e_cal"] = routing.calibrate(mesh, force=True)
    n_tr = (YMSD[0] // MULTI_FOLDS) * (MULTI_FOLDS - 1)
    out["13e_decisions"] = {
        "13a dual": routing.route_solve(*YMSD, mesh=mesh),
        "13b primal": routing.route_solve(*GLA_BRA, mesh=mesh),
        "13c grid": routing.route_batch(*GLA_BRA, len(MULTI_TS) * len(MULTI_L2S), mesh),
        "13c folds": routing.route_batch(n_tr, YMSD[1], MULTI_FOLDS, mesh, form="penalized"),
    }
    for label, (X, y, t) in (("13a", (Xd, yd, td)), ("13b", (Xp, yp, tp))):
        sol, out[f"13e_{label}_run"] = run(lambda: routing.sven_routed(X, y, t, LAMBDA2,
                                                                       mesh=mesh))
        out[f"13e_{label}"] = sol.beta
    return out


def phase_multi_device(torch, smoke, kernels, svm_state, count, dev) -> None:
    """Phase 13: the multi-device layer, `MULTI_WORLD` ranks on this card
    over gloo (`dist.launch`), float64, default config; every check against
    the single-device call on the card, made here. 13a `sven_sharded` on
    the YMSD dual (one Gram per rank), 13b on the GLA-BRA primal, 13c the
    lane fan-out of `sven_batch` (8-lane grid, shared X) and `enet_batch`
    (YMSD folds) bitwise, 13d the fold fan-out of `cross_validate` bitwise
    and a k no mesh divides declined, 13e the router's calibration and
    decisions and `sven_routed`, 13f Shotgun at its callers' problems."""
    import numpy as np

    from repro_torch import dist
    from repro_torch.baselines.shotgun import (coordinate_steps, drawn_coordinates,
                                              elastic_net_shotgun, error_bound,
                                              full_draw_bound, stop_rule_bounds)
    from repro_torch.core import routing
    from repro_torch.core.api import enet, enet_batch
    from repro_torch.core.batch import cv_folds, en_grid, sven_batch
    from repro_torch.core.cv import cross_validate
    from repro_torch.core.elastic_net import lambda1_max, objective_penalized
    from repro_torch.core.sven import sven
    from repro_torch.data.synthetic import make_regression, make_regression_numpy

    t_phase = time.perf_counter()
    devices, backend = dist.topology(MULTI_WORLD, "cuda")
    print(f"[13] multi-device: {MULTI_WORLD} ranks on {sorted(set(devices))} over {backend} "
          "(ranks share one card: gloo; NCCL needs a card a rank)", flush=True)
    t0 = time.perf_counter()
    got = dist.launch(multi_rank, MULTI_WORLD, device="cuda", timeout=600,
                      collective_timeout=300)
    ranks_s = time.perf_counter() - t0
    smoke.check(got["size"] == MULTI_WORLD and got["backend"] == backend,
                f"13: {got['size']} ranks over {got['backend']} on {got['device']}")
    print(f"    ranks: {ranks_s:.1f} s from spawn to rank 0's result", flush=True)

    def report(label):
        r = got[f"{label}_run"]
        for k, v in r["launches"].items():
            count({k: int(sum(v))})
        print(f"    {label}: seconds per rank {[round(s, 3) for s in r['seconds']]}, launches "
              f"per rank {r['launches']}, collectives per rank {r['collectives']}, batched CG "
              f"steps per rank {r['cg_steps']}", flush=True)
        return r

    def rel(a, b):
        return max_dev(torch, a, b), max(b.abs().max().item(), 1e-300)

    # -- 13a / 13b: rows split over the ranks ------------------------------
    Xd, yd, bd = make_regression(*YMSD, seed=1, device=dev)
    td = 0.5 * bd.abs().sum().item()
    Xp, yp, bp = make_regression(*GLA_BRA, seed=2, device=dev)
    tp = 0.5 * bp.abs().sum().item()
    for label, (X, y, t), tol in (("13a", (Xd, yd, td), 1e-10), ("13b", (Xp, yp, tp), 1e-8)):
        beta, iters, cg, mode = got[label]
        one, one_s, _, _ = run_path(torch, kernels, svm_state, lambda: sven(X, y, t, LAMBDA2))
        d, scale = rel(beta.to(dev), one.beta)
        r = report(label)
        n, p = X.shape
        print(f"    {label} sven_sharded ({mode}, {n} x {p}, {-(-n // MULTI_WORLD)} rows a rank): "
              f"{iters} Newton / {cg} CG; one device {one.iters} / {one.cg_iters}, "
              f"{one_s:.3f} s; max|beta - beta_one| {d:.3e} ({d / scale:.3e} x max|beta|)",
              flush=True)
        smoke.check(bool(torch.isfinite(beta).all()) and beta.shape == (p,),
                    f"{label}: beta finite, shape (p,)")
        smoke.check(d <= tol * scale, f"{label}: max|beta - beta_one| = {d:.3e} <= {tol:g} x "
                    f"max|beta| = {tol * scale:.3e}")
        smoke.check(iters == one.iters, f"{label}: Newton steps {iters} = one device's "
                    f"{one.iters}")
        if label == "13a":
            grams = r["launches"].get("shifted_gram_cuda", [0] * MULTI_WORLD)
            smoke.check(grams == [1.0] * MULTI_WORLD, f"13a: Gram launches per rank {grams}: "
                        "exactly one")
        else:
            cg_rel = abs(cg - one.cg_iters) / one.cg_iters
            smoke.check(cg_rel <= 0.01, f"13b: CG steps {cg} within 1 % of one device's "
                        f"{one.cg_iters} ({100 * cg_rel:.2f} %)")
            steps = r["cg_steps"][0]
            print(f"    13b: {r['seconds'][0]:.3f} s; {r['collectives'][0]:.0f} collectives over "
                  f"{steps:.0f} CG steps launched: {r['collectives'][0] / max(steps, 1):.2f} a "
                  "step (one all-reduce of p + 1 floats a Xhat w, one gather of n a Xhat^T v)",
                  flush=True)
        del one
    torch.cuda.empty_cache()

    # -- 13c: lane fan-out, bitwise the one-device stack -------------------
    ts, l2s = en_grid(torch.tensor([f * tp for f in MULTI_TS], device=dev),
                      torch.tensor(MULTI_L2S, device=dev, dtype=torch.float64))
    one, one_s, one_l, _ = run_path(torch, kernels, svm_state,
                                    lambda: sven_batch(Xp, yp, ts, l2s))
    fan = got["13c_grid"]
    r = report("13c_grid")
    same = [torch.equal(fan.beta[i], one.beta[i].cpu()) for i in range(len(ts))]
    print(f"    13c sven_batch, {len(ts)}-lane en_grid on the GLA-BRA X (shared), "
          f"{len(ts) // MULTI_WORLD} lanes a rank: Newton {fan.iters.tolist()}, CG "
          f"{fan.cg_iters.tolist()}; one device {one_s:.3f} s, launches {one_l}; {sum(same)} "
          f"of {len(ts)} lanes bitwise", flush=True)
    smoke.check(all(same) and _lane_counts(torch, fan) == _lane_counts(torch, one),
                f"13c grid: {sum(same)} of {len(ts)} lanes bitwise the one-device stack's, "
                "Newton and CG lists equal")
    smoke.check(sum(r["launches"].get("hinge_xtv_lanes_cuda", [0])) > 0,
                "13c grid: the ranks ran the lane-batched hinge passes")
    del one
    Xtr, ytr, _, _ = cv_folds(Xd, yd, MULTI_FOLDS)
    l1 = torch.stack([0.1 * lambda1_max(Xtr[i], ytr[i]) for i in range(MULTI_FOLDS)])
    one, one_s, one_l, _ = run_path(torch, kernels, svm_state,
                                    lambda: enet_batch(Xtr, ytr, l1, LAMBDA2))
    fan = got["13c_folds"]
    r = report("13c_folds")
    same = [torch.equal(fan.beta[i], one.beta[i].cpu()) for i in range(MULTI_FOLDS)]
    counts = [(f.evals, f.sven_iters, f.cg_iters) for f in (fan, one)]
    print(f"    13c enet_batch on cv_folds(X, y, {MULTI_FOLDS}) at YMSD, lambda1 = 0.1 x each "
          f"fold's lambda1_max, {MULTI_FOLDS // MULTI_WORLD} lanes a rank: evals {fan.evals}, "
          f"Newton {fan.sven_iters}, CG {fan.cg_iters}; one device {one_s:.3f} s; {sum(same)} "
          f"of {MULTI_FOLDS} lanes bitwise", flush=True)
    smoke.check(all(same) and counts[0] == counts[1],
                f"13c folds: {sum(same)} of {MULTI_FOLDS} lanes bitwise, evaluations, Newton "
                "and CG lists equal")
    smoke.check(sum(r["launches"].get("shifted_gram_cuda", [0])) > 0,
                "13c folds: the ranks ran the Gram")
    del Xtr, ytr, one
    torch.cuda.empty_cache()

    # -- 13d: fold fan-out --------------------------------------------------
    for label, k in (("13d", MULTI_FOLDS), ("13d_nested", MULTI_FOLDS + 1)):
        one, one_s, _, _ = run_path(torch, kernels, svm_state, lambda: cross_validate(
            Xd, yd, k=k, n_lambdas=MULTI_LAMBDAS, mesh=None))
        cv = got[label]
        r = report(label)
        same = (torch.equal(cv.mse_path, one.mse_path.cpu()) and cv.index_min == one.index_min
                and torch.equal(cv.evals, one.evals.cpu()))
        how = "mesh pinned" if label == "13d" else "mesh='auto' under the 2-rank context"
        print(f"    {label}: cross_validate(k={k}, n_lambdas={MULTI_LAMBDAS}) at YMSD, {how}: "
              f"index_min {cv.index_min} (one device {one.index_min}), evals "
              f"{int(cv.evals.sum())}; one device (mesh=None) {one_s:.3f} s", flush=True)
        smoke.check(same, f"{label}: mse_path bitwise, index_min and evaluations equal to "
                    "mesh=None")
        if label == "13d_nested":
            smoke.check(sum(r["collectives"]) == 0, f"13d: k = {k} declines the "
                        f"{MULTI_WORLD}-rank mesh (collectives {r['collectives']})")
        del one
    torch.cuda.empty_cache()

    # -- 13e: the router ----------------------------------------------------
    cal = got["13e_cal"]
    print(f"    13e calibrate (force): {cal._asdict()}", flush=True)
    nums = [getattr(cal, f) for f in routing._NUMERIC]
    smoke.check(all(np.isfinite(v) and v > 0 for v in nums),
                f"13e: every calibration field finite and positive ({nums})")
    for name, dec in got["13e_decisions"].items():
        print(f"    13e {name}: {dec.path} ({dec.reason}); costs {dec.costs}", flush=True)
        smoke.check(dec.costs[dec.path] <= dec.costs["single"] + 1e-12,
                    f"13e {name}: the chosen cost is at most single's")
    for label, (X, y, t), tol in (("13a", (Xd, yd, td), 1e-10), ("13b", (Xp, yp, tp), 1e-8)):
        one = sven(X, y, t, LAMBDA2).beta
        d, scale = rel(got[f"13e_{label}"].to(dev), one)
        report(f"13e_{label}")
        smoke.check(d <= tol * scale, f"13e sven_routed(route='auto') at {label}'s problem: "
                    f"max|beta - beta_one| = {d:.3e} <= {tol:g} x max|beta|")
    one_rank = routing.route_solve(*YMSD, mesh=dist.data_mesh(1))
    smoke.check(one_rank.reason == "one device: nothing to route",
                f"13e: a one-rank mesh says '{one_rank.reason}'")
    del Xd, yd, Xp, yp
    torch.cuda.empty_cache()

    # -- 13f: Shotgun at its callers' problems ------------------------------
    for name, n, p, rho, par, tol in SHOTGUN_CELLS:
        Xn, yn, _ = make_regression_numpy(n, p, k_true=max(5, p // 100), rho=rho, noise=0.3,
                                          seed=0)
        X, y = (torch.as_tensor(a, device=dev) for a in (Xn, yn))
        l1 = 0.1 * lambda1_max(X, y).item()
        res, secs, _, syncs = run_path(torch, kernels, svm_state,
                                       lambda: elastic_net_shotgun(X, y, l1, LAMBDA2,
                                                                   parallel=par))
        ref, ref_s, _, _ = run_path(torch, kernels, svm_state, lambda: enet(X, y, l1, LAMBDA2))
        D = drawn_coordinates(p, par, res.rounds, device=dev)
        steps = coordinate_steps(X, y, res.beta, l1, LAMBDA2)[D].abs()
        stop_ok = bool((steps <= stop_rule_bounds(X, D, LAMBDA2)).all())
        own, other = (error_bound(X, y, b, l1, LAMBDA2) for b in (res.beta, ref.beta))
        dist2 = torch.linalg.norm(res.beta - ref.beta).item()
        d, scale = rel(res.beta, ref.beta)
        gap = (objective_penalized(X, y, res.beta, l1, LAMBDA2)
               - objective_penalized(X, y, ref.beta, l1, LAMBDA2)).item()
        cell = f"{name} at parallel {par}"
        print(f"    13f shotgun {name} ({n} x {p}, parallel {par}): {res.rounds} rounds of "
              f"max 20000 (last delta {res.delta:.2e}), {secs:.3f} s, {syncs} host syncs; enet "
              f"{ref_s:.3f} s; max|beta - beta_enet| {d:.3e} ({d / scale:.3e} x max|beta|, "
              f"tolerance {tol:.0e} x), ||.||_2 {dist2:.3e}, the two iterates' error bounds "
              f"{own + other:.3e} (shotgun's {own:.3e}, enet's {other:.3e}); objective above "
              f"enet's by {gap:.3e}", flush=True)
        smoke.check(res.rounds < 20000 and res.delta <= 1e-10 and stop_ok,
                    f"13f {cell}: the stop rule held on the last round's {len(D)} coordinates")
        smoke.check(bool(torch.isfinite(res.beta).all()) and d <= tol * scale,
                    f"13f {cell}: max|beta - beta_enet| = {d:.3e} <= {tol:.0e} x max|beta| "
                    f"({d / scale:.3e} x)")
        if par >= p:
            cert = full_draw_bound(X, LAMBDA2)
            smoke.check(dist2 <= cert + other and own <= cert,
                        f"13f {cell}: ||beta - beta_enet|| = {dist2:.3e} <= the full draw's "
                        f"certificate {cert:.3e} + enet's error bound {other:.3e}")
        del X, y
    print(f"    phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)


def multi_device_only(torch) -> int:
    """`--multi-device`: phase 13 alone (the kernels built first), with its
    checks; prints no result line. Exits 1 if a check failed."""
    from repro_torch import kernels
    from repro_torch.core.svm import state as svm_state
    from repro_torch.kernels import _build

    print(f"card: {nvidia_smi()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    smoke = Smoke()
    t0 = time.perf_counter()
    phase_multi_device(torch, smoke, kernels, svm_state, lambda launched: None,
                       torch.device("cuda", 0))
    print(f"total {time.perf_counter() - t0:.1f} s; {len(smoke.failures)} check(s) failed",
          flush=True)
    for f in smoke.failures:
        print(f"  FAILED {f}", flush=True)
    return 1 if smoke.failures else 0


#: phase 14: JAX's `bench_serve.run_multihost` protocol at GLA-BRA width
MH_HOSTS = 2
MH_MAX_BATCH = 4
MH_REQUESTS = 16           # a wave; the fault wave kills host 0 at half of it
MH_T_SCALE = 0.01          # x the loadgen's t, as 12a's constrained requests
MH_P99_RATIO = 3.0         # JAX's gate: fault p99 <= 3 x no-fault p99
MH_DIRECT = 8              # the fault wave's results held to a direct `sven`
MH_TOL = 1e-6              # phase 12's bound on warm-started GLA-BRA results
MH_JAX_TOL = 1e-10         # JAX's bench bound, which JAX checks at 48 x 24 only
MH_HINGE = ("hinge_xtv_lanes_cuda", "hinge_xtv_cuda")


def pipe_seconds(items) -> float:
    """Seconds to send one batch's `items` as the coordinator does (one
    message on a spawn-context duplex Pipe) to a reader thread of this
    process, unpickled there: a batch's pipe transport."""
    import multiprocessing as mp
    import threading

    a, b = mp.get_context("spawn").Pipe(duplex=True)
    got = []
    reader = threading.Thread(target=lambda: got.append(b.recv()))
    t0 = time.perf_counter()
    reader.start()
    a.send(("solve", 0, items))
    reader.join()
    secs = time.perf_counter() - t0
    a.close()
    b.close()
    return secs


def phase_multihost(torch, smoke, count, dev, shape=GLA_BRA, cli=True) -> None:
    """Phase 14: (14a) JAX's `bench_serve.run_multihost` protocol on
    `MultiHostCoordinator` over MH_HOSTS spawned workers sharing the card
    and a spill directory, float64, default config, at `shape`; (14b) the
    loadgen's `--hosts 2 --kill-host 0` CLI as a subprocess (when `cli`)."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.core import routing, sven
    from repro_torch.runtime import (LoadSpec, MultiHostCoordinator, fingerprint_problem,
                                     make_workload, run_open_loop)

    t_phase = time.perf_counter()
    workload = make_workload(LoadSpec(shapes=(shape,), n_datasets=1, n_requests=MH_REQUESTS,
                                      penalized_fraction=0.0, data_seed=SERVE_DATA_SEED,
                                      seed=SERVE_DATA_SEED))
    workload = [i._replace(lam=MH_T_SCALE * i.lam) for i in workload]
    kill_at = MH_REQUESTS // 2
    print(f"[14a] MultiHostCoordinator: {MH_HOSTS} workers on one card, max_batch "
          f"{MH_MAX_BATCH}, a shared spill directory; 3 waves of {MH_REQUESTS} constrained "
          f"requests on one {shape[0]} x {shape[1]} data set, host 0 killed at request "
          f"{kill_at} of the third", flush=True)
    waves, lost = [], 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        coord = MultiHostCoordinator(n_hosts=MH_HOSTS, max_batch=MH_MAX_BATCH, cache_dir=tmp,
                                     device=dev)
        spawn_s = time.perf_counter() - t0
        try:
            for name in ("warm-up", "no-fault"):
                out = run_open_loop(coord, workload)
                lost += len(set(out["ids"]) - set(out["results"]))
                waves.append((name, out["wall_seconds"], out, list(out["results"].values())))
            # the fault wave: flush at half, so host 0 holds in-flight work,
            # SIGKILL it, submit the rest; detection, requeue and re-solve
            # all land inside the measured window
            coord.metrics.reset()
            ids = []
            t0 = time.perf_counter()
            for i, item in enumerate(workload):
                if i == kill_at:
                    coord.flush()
                    coord.kill_host(0)
                ids.append(coord.submit(item.X, item.y, t=item.lam, lambda2=item.lambda2,
                                        priority=item.priority))
            results = coord.drain()
            wall = time.perf_counter() - t0
            lost += len(set(ids) - set(results))
            waves.append(("fault", wall, coord.metrics.summary(), list(results.values())))
            hosts_lost, requeued = coord.hosts_lost, coord.requeued_batches
            acct = coord.accounting()
        finally:
            stats = coord.shutdown()
    for name, wall, summ, res in waves:
        statuses = sorted({r.status for r in res})
        print(f"    {name}: {wall:.3f} s, p50 {summ['p50_latency_s']:.3f} s, p99 "
              f"{summ['p99_latency_s']:.3f} s, statuses {statuses}", flush=True)
        smoke.check(statuses == ["ok"] and len(res) == MH_REQUESTS,
                    f"14a {name}: all {MH_REQUESTS} requests ok ({statuses})")
    p99_nofault = waves[1][2]["p99_latency_s"]
    p99_fault = waves[2][2]["p99_latency_s"]
    ratio = p99_fault / max(p99_nofault, 1e-9)
    print(f"    spawn to ready {spawn_s:.3f} s; hosts lost {hosts_lost}, batches requeued "
          f"{requeued}; accounting {acct}; fault p99 / no-fault p99 {ratio:.3f}", flush=True)
    smoke.check(lost == 0 and acct["balanced"] and acct["outstanding"] == 0,
                f"14a: every admitted request of every wave has a result ({lost} lost), "
                "accounting balanced")
    smoke.check(hosts_lost == 1 and requeued >= 1,
                f"14a: hosts lost {hosts_lost} == 1, batches requeued {requeued} >= 1")
    smoke.check(ratio <= MH_P99_RATIO, f"14a: fault p99 {p99_fault:.3f} s <= {MH_P99_RATIO:g} x "
                f"no-fault p99 {p99_nofault:.3f} s ({ratio:.3f} x)")
    for s in stats:
        hinge = {k: s["kernel_launches"].get(k, 0) for k in MH_HINGE}
        print(f"    surviving worker on {s['device']}: {s['requests']} requests, "
              f"{s['batches']} batches, cache hits {s['cache_hits']} (spill {s['spill_hits']}), "
              f"misses {s['cache_misses']}; launches "
              f"{ {k: v for k, v in s['kernel_launches'].items() if v} }", flush=True)
        smoke.check(s["device"].startswith("cuda") and sum(hinge.values()) > 0,
                    f"14a: the surviving worker ran on {s['device']} and launched the hinge "
                    f"kernels ({hinge})")
        count(s["kernel_launches"])
    smoke.check(len(stats) == MH_HOSTS - 1, f"14a: {len(stats)} worker(s) reported final "
                f"stats, the {MH_HOSTS - 1} survivor(s)")
    spill = sum(s["spill_hits"] for s in stats)
    # the fault wave's first results against direct solves of the unpadded problems
    dev_max = rel_max = 0.0
    for item, rid in list(zip(workload, ids))[:MH_DIRECT]:
        r = results[rid]
        if r.status != "ok":
            continue
        direct = sven(torch.as_tensor(item.X, device=dev), torch.as_tensor(item.y, device=dev),
                      item.lam, item.lambda2).beta.cpu().numpy()
        d = float(np.abs(r.beta - direct).max())
        dev_max = max(dev_max, d)
        rel_max = max(rel_max, d / max(float(np.abs(direct).max()), 1e-300))
    print(f"    the fault wave's first {MH_DIRECT} against a direct sven: max|beta - direct| "
          f"{dev_max:.3e} ({rel_max:.3e} x max|beta|): <= {MH_TOL:g} "
          f"{dev_max <= MH_TOL}, <= JAX's {MH_JAX_TOL:g} {dev_max <= MH_JAX_TOL}", flush=True)
    smoke.check(dev_max <= MH_TOL, f"14a: max|beta - direct sven| = {dev_max:.3e} <= {MH_TOL:g}")
    # the host work apart: a batch through the pipe, a request's fingerprint
    items = [{"req_id": k, "X": it.X, "y": it.y, "form": it.form, "lam": it.lam,
              "lambda2": it.lambda2, "priority": it.priority}
             for k, it in enumerate(workload[:MH_MAX_BATCH])]
    pipe_s = [pipe_seconds(items) for _ in range(2)]
    t0 = time.perf_counter()
    fingerprint_problem(workload[0].X, workload[0].y)
    fp_s = time.perf_counter() - t0
    mb = sum(it["X"].nbytes for it in items) / 1e6
    cal = routing._load_disk_calibration("cuda", 1)
    print(f"    pipe transport a batch ({MH_MAX_BATCH} x {mb / MH_MAX_BATCH:.1f} MB of X): "
          f"{', '.join(f'{v:.3f}' for v in pipe_s)} s; fingerprint {fp_s:.3f} s a request; "
          f"spill hits {spill}; the calibration on disk (what a worker prices with) {cal}; "
          f"14a {time.perf_counter() - t_phase:.1f} s", flush=True)

    if cli:
        cmd = [sys.executable, "-m", "repro_torch.runtime.loadgen", "--hosts", "2",
               "--kill-host", "0", "--waves", "2"]
        print(f"[14b] {' '.join(cmd[1:])}", flush=True)
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=600)
        for line in run.stdout.splitlines():
            if line.startswith("[loadgen]"):
                print(f"    {line}", flush=True)
        smoke.check(run.returncode == 0, f"14b: the loadgen's multihost smoke exited "
                    f"{run.returncode} in {time.perf_counter() - t0:.1f} s"
                    + ("" if run.returncode == 0 else f": {run.stderr[-2000:]}"))
    print(f"    phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)


def multihost_only(torch) -> int:
    """`--multihost`: phase 14 alone (the kernels built first), with its
    checks; prints no result line. Exits 1 if a check failed."""
    from repro_torch.kernels import _build

    print(f"card: {nvidia_smi()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    smoke = Smoke()
    t0 = time.perf_counter()
    phase_multihost(torch, smoke, lambda launched: None, torch.device("cuda", 0))
    print(f"total {time.perf_counter() - t0:.1f} s; {len(smoke.failures)} check(s) failed",
          flush=True)
    for f in smoke.failures:
        print(f"  FAILED {f}", flush=True)
    return 1 if smoke.failures else 0


def run_path(torch, kernels, svm_state, fn):
    """Run fn with every launch counter, the sync counter and the CG loop's
    counters (`cg_lanes.steps`, `.dead`) at 0; return (result, seconds,
    launches, syncs)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    svm_state.host_bool.syncs = svm_state.cg_lanes.steps = svm_state.cg_lanes.dead = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, kernels.launches(), svm_state.host_bool.syncs


def max_dev(torch, a, b) -> float:
    return (a - b).abs().max().item()


def check_read_every_1(torch, smoke, kernels, svm_state, what, sol, secs, syncs, dead, fn):
    """Hold `sol`, the run of fn() at the module's k (`secs` seconds,
    `syncs` host syncs, `dead` dead CG steps), bitwise to fn() run with the
    CG loop reading its test before every step (k = 1): beta by
    `torch.equal`, the same Newton and CG counts (per lane for a batch).
    Prints both runs' seconds, host syncs and dead steps, and checks the
    dead steps: none at k = 1, at most k - 1 per CG solve (one per Newton
    step; a batch's count its batched Newton steps)."""
    k = svm_state.CG_READ_EVERY
    one, one_s, _, one_syncs = run_path(torch, kernels, svm_state,
                                        lambda: read_every(svm_state, 1, fn))
    one_dead = svm_state.cg_lanes.dead

    def counts(s_):
        return torch.as_tensor(s_.iters).tolist(), torch.as_tensor(s_.cg_iters).tolist()

    solves = max(torch.as_tensor(sol.iters).reshape(-1).tolist())
    print(f"    CG test read every {k} steps: {secs:.3f} s, {syncs} host syncs, {dead} dead "
          f"CG steps; read every step: {one_s:.3f} s, {one_syncs} host syncs, {one_dead} "
          f"dead", flush=True)
    smoke.check(torch.equal(one.beta, sol.beta) and counts(one) == counts(sol),
                f"{what}: beta, Newton and CG steps reading the CG test every {k} steps "
                "bitwise those reading it every step")
    smoke.check(one_dead == 0 and dead <= (k - 1) * solves,
                f"{what}: dead CG steps {dead} <= (k - 1) x {solves} CG solves, none ({one_dead}) "
                "reading every step")


def read_every(svm_state, k: int, fn):
    """fn() with the CG loop reading its test once every k steps (1: before
    every step), the module's k restored after."""
    saved = svm_state.CG_READ_EVERY
    svm_state.CG_READ_EVERY = k
    try:
        return fn()
    finally:
        svm_state.CG_READ_EVERY = saved


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--gram-split"]:
        modes = sys.argv[2:] or ["f64"]
        if not set(modes) <= {"f64", "f32", "tf32", "bf16"}:
            print(f"chip_smoke: unknown Gram modes {modes}", file=sys.stderr)
            return 2
        return gram_split_only(torch, modes)
    if sys.argv[1:2] == ["--gram-bitwise"] and len(sys.argv) > 2:
        modes = sys.argv[3:] or ["f64", "tf32", "bf16"]
        if not set(modes) <= {"f64", "f32", "tf32", "bf16"}:
            print(f"chip_smoke: unknown Gram modes {modes}", file=sys.stderr)
            return 2
        return gram_bitwise_only(torch, Path(sys.argv[2]).resolve(), modes)
    if sys.argv[1:] == ["--stats-time"]:
        return stats_time_only(torch)
    if sys.argv[1:] == ["--batch-time"]:
        return batch_time_only(torch)
    if sys.argv[1:] == ["--lane-time"]:
        return lane_time_only(torch)
    if sys.argv[1:] == ["--loop-trace"]:
        return loop_trace_only(torch)
    if sys.argv[1:] == ["--serving"]:
        return serving_only(torch)
    if sys.argv[1:] == ["--multi-device"]:
        return multi_device_only(torch)
    if sys.argv[1:] == ["--multihost"]:
        return multihost_only(torch)
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    from repro_torch import kernels
    from repro_torch.core.svm import state as svm_state
    from repro_torch.core.reduction import svm_C
    from repro_torch.core.sven import (SvenConfig, sven, sven_path, sven_path_reference,
                                       sven_path_solutions)
    from repro_torch.data.synthetic import make_regression
    from repro_torch.kernels import _build

    smoke = Smoke()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 1. setup -------------------------------------------------------------
    card = nvidia_smi()
    print(f"[1] card: {card}", flush=True)
    print(f"    python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"    torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    libs = _build.build_all()
    built = ("already built" if _build.build_seconds is None
             else f"built in {_build.build_seconds:.1f} s")
    print(f"    kernels {built}: {', '.join(p.name for p in libs.values())}", flush=True)
    for stem, log in _build.build_log.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"    {stem}: {line.strip()}", flush=True)

    # -- 2. kernels vs plain ----------------------------------------------------
    print("[2] kernels vs their plain versions", flush=True)
    gen = torch.Generator().manual_seed(0)
    rows = phase_kernels(torch, smoke, dev, gen)
    torch.cuda.empty_cache()
    path_launches = {name: 0 for name in kernels.launches()}

    def count(launched):
        for k, v in launched.items():
            path_launches[k] += v

    # -- 3. dual at the YMSD shape ---------------------------------------------
    n, p = YMSD
    print(f"[3] dual solve, n = {n}, p = {p}", flush=True)
    X, y, beta_true = make_regression(n, p, seed=1, device=dev)
    t = 0.5 * beta_true.abs().sum().item()
    ref_sol, ref_s, _, ref_syncs = run_path(
        torch, kernels, svm_state,
        lambda: sven(X, y, t, LAMBDA2, SvenConfig(backend="torch")))
    sol, secs, launched, syncs = run_path(torch, kernels, svm_state,
                                          lambda: sven(X, y, t, LAMBDA2))
    dead = svm_state.cg_lanes.dead
    count(launched)
    scale = ref_sol.beta.abs().max().item()
    dev_b = max_dev(torch, sol.beta, ref_sol.beta)
    print(f"    default (float64 Gram): mode {sol.mode}, {sol.iters} Newton / "
          f"{sol.cg_iters} CG iterations ({dead} dead CG steps), kkt {sol.kkt.item():.3e}, "
          f"{secs:.3f} s, {syncs} host syncs, launches {launched}; torch f64: "
          f"{ref_sol.iters} Newton / {ref_sol.cg_iters} CG, kkt {ref_sol.kkt.item():.3e}, "
          f"{ref_s:.3f} s, {ref_syncs} syncs", flush=True)
    smoke.check(sol.mode == "dual", "YMSD shape takes the dual branch")
    check_read_every_1(torch, smoke, kernels, svm_state, "dual", sol, secs, syncs, dead,
                       lambda: sven(X, y, t, LAMBDA2))
    smoke.check(launched["shifted_gram_cuda"] == 1, "one Gram launch per dual solve")
    smoke.check(bool(torch.isfinite(sol.beta).all()) and sol.beta.shape == (p,),
                "beta finite, shape (p,)")
    smoke.check(dev_b <= 1e-10 * scale, f"max|beta - beta_torch| = {dev_b:.3e} <= "
                f"1e-10 * max|beta| = {1e-10 * scale:.3e}")
    ref12, ref12_s, _, _ = run_path(
        torch, kernels, svm_state,
        lambda: sven(X, y, t, LAMBDA2, SvenConfig(backend="torch", tol=1e-12)))
    lo, lo_s, lo_launched, lo_syncs = run_path(
        torch, kernels, svm_state,
        lambda: sven(X, y, t, LAMBDA2, SvenConfig(precision="bf16", tol=1e-12)))
    dev_lo = max_dev(torch, lo.beta, ref12.beta)
    print(f"    bf16 + refinement, tol 1e-12: {lo.iters} Newton (refinement) / "
          f"{lo.cg_iters} CG, kkt {lo.kkt.item():.3e}, {lo_s:.3f} s, {lo_syncs} syncs; "
          f"torch f64 tol 1e-12: {ref12.iters} Newton, {ref12_s:.3f} s", flush=True)
    # the Gram row's launches are its float64 body's; the bf16 and tf32
    # bodies' are counted apart, under the row's "launches_by_mode"
    gram_modes = {"bf16": lo_launched.pop("shifted_gram_cuda")}
    count(lo_launched)
    smoke.check(gram_modes["bf16"] == 1, "bf16 solve launched the Gram once")
    smoke.check(dev_lo <= 1e-10, f"bf16 refined max|beta - beta_torch| = {dev_lo:.3e} "
                "<= 1e-10")
    tf, tf_s, tf_launched, tf_syncs = run_path(
        torch, kernels, svm_state,
        lambda: sven(X, y, t, LAMBDA2, SvenConfig(precision="tf32", tol=1e-12)))
    gram_modes["tf32"] = tf_launched.pop("shifted_gram_cuda")
    count(tf_launched)
    dev_tf = max_dev(torch, tf.beta, ref12.beta)
    print(f"    tf32 + refinement, tol 1e-12: {tf.iters} Newton (refinement) / "
          f"{tf.cg_iters} CG, kkt {tf.kkt.item():.3e}, {tf_s:.3f} s, {tf_syncs} syncs",
          flush=True)
    smoke.check(gram_modes["tf32"] == 1, "tf32 solve launched the Gram once")
    smoke.check(dev_tf <= 1e-10, f"tf32 refined max|beta - beta_torch| = {dev_tf:.3e} "
                "<= 1e-10")
    ymsd_case = ("dual w", X, y, t, sol.w, svm_C(LAMBDA2))
    del sol, ref_sol, ref12, lo, tf
    torch.cuda.empty_cache()

    # -- 4. primal at the GLA-BRA-180 shape ------------------------------------
    n, p = GLA_BRA
    print(f"[4] primal solve, n = {n}, p = {p}", flush=True)
    X, y, beta_true = make_regression(n, p, seed=2, device=dev)
    t = 0.5 * beta_true.abs().sum().item()
    ref_sol, ref_s, _, ref_syncs = run_path(
        torch, kernels, svm_state,
        lambda: sven(X, y, t, LAMBDA2, SvenConfig(backend="torch")))
    sol, secs, launched, syncs = run_path(torch, kernels, svm_state,
                                          lambda: sven(X, y, t, LAMBDA2))
    dead = svm_state.cg_lanes.dead
    count(launched)
    scale = ref_sol.beta.abs().max().item()
    dev_b = max_dev(torch, sol.beta, ref_sol.beta)
    print(f"    default (float64 hinge passes): mode {sol.mode}, {sol.iters} Newton / "
          f"{sol.cg_iters} CG iterations + {dead} dead CG steps (= H v products), kkt "
          f"{sol.kkt.item():.3e}, {secs:.3f} s, {syncs} host syncs, launches {launched}; "
          f"torch f64: {ref_sol.iters} Newton / {ref_sol.cg_iters} CG, kkt "
          f"{ref_sol.kkt.item():.3e}, {ref_s:.3f} s, {ref_syncs} syncs", flush=True)
    smoke.check(sol.mode == "primal", "GLA-BRA-180 shape takes the primal branch")
    smoke.check(launched["hinge_xtv_cuda"] == launched["hinge_xd_cuda"]
                == sol.cg_iters + dead > 0, "exactly one launch of each hinge pass per H v "
                f"product: CG steps {sol.cg_iters} + dead steps {dead}")
    check_read_every_1(torch, smoke, kernels, svm_state, "primal", sol, secs, syncs, dead,
                       lambda: sven(X, y, t, LAMBDA2))
    smoke.check(bool(torch.isfinite(sol.beta).all()) and sol.beta.shape == (p,),
                "beta finite, shape (p,)")
    # the float64 hinge passes give the reference's solve: its Newton steps,
    # its CG steps up to the summation order, and its answer
    smoke.check(sol.iters == ref_sol.iters,
                f"Newton steps {sol.iters} = float64's {ref_sol.iters}")
    cg_rel = abs(sol.cg_iters - ref_sol.cg_iters) / ref_sol.cg_iters
    smoke.check(cg_rel <= 0.01, f"CG steps {sol.cg_iters} within 1 % of float64's "
                f"{ref_sol.cg_iters} ({100 * cg_rel:.2f} %)")
    smoke.check(dev_b <= 1e-8 * scale, f"max|beta - beta_torch| = {dev_b:.3e} <= "
                f"1e-8 * max|beta| = {1e-8 * scale:.3e}")
    glabra_case = ("primal w", X, y, t, sol.w, svm_C(LAMBDA2))
    # the hinge rows' launches are their float64 bodies'; the float32 and
    # bf16 bodies' are counted apart, under the rows' "launches_by_mode"
    hinge_modes = phase_primal_precisions(torch, smoke, kernels, svm_state, X, y, t, sol)
    torch.cuda.empty_cache()

    # -- 5. sven_path at the primal shape --------------------------------------
    ts = [t * f for f in (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)]
    print(f"[5] sven_path, {len(ts)} points, n = {n}, p = {p}", flush=True)
    betas, secs, launched, syncs = run_path(
        torch, kernels, svm_state, lambda: sven_path(X, y, ts, LAMBDA2))
    dead = svm_state.cg_lanes.dead
    count(launched)
    ref_betas, ref_s, _, _ = run_path(
        torch, kernels, svm_state, lambda: sven_path_reference(X, y, ts, LAMBDA2))
    plain_sols, plain_s, _, _ = run_path(
        torch, kernels, svm_state,
        lambda: sven_path_solutions(X, y, ts, LAMBDA2, SvenConfig(backend="torch")))
    plain_betas = torch.stack([s_.beta for s_ in plain_sols])
    plain_cg = sum(s_.cg_iters for s_ in plain_sols)
    dev_p = max_dev(torch, betas, ref_betas)
    dev_plain = max_dev(torch, betas, plain_betas)
    scale = plain_betas.abs().max().item()
    print(f"    path {secs:.3f} s, {syncs} host syncs, launches {launched}, "
          f"{launched['hinge_xtv_cuda'] - dead} CG + {dead} dead CG steps; reference "
          f"{ref_s:.3f} s; torch f64 path {plain_s:.3f} s, {plain_cg} CG", flush=True)
    smoke.check(betas.shape == (len(ts), p) and bool(torch.isfinite(betas).all()),
                "path betas finite, shape (8, p)")
    smoke.check(launched["hinge_xtv_cuda"] > 0 and launched["hinge_xd_cuda"] > 0,
                "the path ran the hinge kernels")
    smoke.check(dev_p <= 1e-10, f"max|path - path_reference| = {dev_p:.3e} <= 1e-10")
    smoke.check(dev_plain <= 1e-8 * scale, f"max|path - path_torch| = {dev_plain:.3e} "
                f"<= 1e-8 * max|beta| = {1e-8 * scale:.3e}")

    del betas, ref_betas, plain_betas, plain_sols, sol, ref_sol

    # -- 6. the hinge-stats op vs plain ------------------------------------------
    print("[6] kernels.hinge_stats vs its plain version", flush=True)
    Xr, yr, _ = make_regression(*RAGGED, seed=3, device=dev)
    wr = torch.randn(RAGGED[0], generator=gen, dtype=torch.float64).to(dev) * 0.3
    rows["hinge_stats_cuda"], launched = phase_hinge_stats(
        torch, smoke, kernels, svm_state, dev,
        [glabra_case, ymsd_case, ("ragged", Xr, yr, 1.3, wr, 2.0)])
    count(launched)
    torch.cuda.empty_cache()

    # -- 7. the penalized front end --------------------------------------------
    phase_front_end(torch, smoke, kernels, svm_state, count, ymsd_case[1:3],
                    glabra_case[1:3])
    del ymsd_case, glabra_case
    torch.cuda.empty_cache()

    # -- 8. a float32 problem --------------------------------------------------
    gram_modes["f32"] = phase_float32(torch, smoke, kernels, svm_state, dev)
    torch.cuda.empty_cache()

    # -- 9. batched solves -----------------------------------------------------
    print("[9] sven_batch: lane-batched solves vs sequential sven", flush=True)
    rows.update(phase_batch(torch, smoke, kernels, svm_state, count, dev, gen))
    torch.cuda.empty_cache()

    # -- 11. batched penalized solves and cross-validation ---------------------
    print("[11] enet_batch and cross-validation: lane-batched root-finds vs sequential",
          flush=True)
    phase_cv(torch, smoke, kernels, svm_state, count, dev)
    torch.cuda.empty_cache()

    # -- 12. the serving runtime -----------------------------------------------
    print("[12] the serving runtime: open-loop waves vs the cold reference drain, and "
          "the online session", flush=True)
    phase_serving(torch, smoke, kernels, svm_state, count, dev)
    torch.cuda.empty_cache()

    # -- 13. the multi-device layer --------------------------------------------
    phase_multi_device(torch, smoke, kernels, svm_state, count, dev)
    torch.cuda.empty_cache()

    # -- 14. the multi-host serving coordinator --------------------------------
    print("[14] the multi-host serving coordinator: worker processes on the card, one "
          "killed", flush=True)
    phase_multihost(torch, smoke, count, dev)

    # -- summary ---------------------------------------------------------------
    for name, n_launch in path_launches.items():
        smoke.check(n_launch > 0, f"{name} launched on the main path ({n_launch})")
    for prec, n_launch in gram_modes.items():
        smoke.check(n_launch > 0, f"shifted_gram_cuda {prec} body launched on the main "
                    f"path ({n_launch})")
    rows["shifted_gram_cuda"]["launches_by_mode"] = {
        "f64": path_launches["shifted_gram_cuda"], **gram_modes}
    for name in ("hinge_xtv_cuda", "hinge_xd_cuda"):
        for prec, n_launch in hinge_modes.items():
            smoke.check(n_launch > 0, f"{name} {prec} body launched on the main path "
                        f"({n_launch})")
        rows[name]["launches_by_mode"] = {"f64": path_launches[name], **hinge_modes}
    meta = {
        "shifted_gram_cuda": ("src/repro_torch/kernels/csrc/gram.cu",
                              "src/repro/kernels/gram.py:25"),
        "hinge_xtv_cuda": ("src/repro_torch/kernels/csrc/hinge.cu",
                           "src/repro/kernels/hinge.py:25"),
        "hinge_xd_cuda": ("src/repro_torch/kernels/csrc/hinge.cu",
                          "src/repro/kernels/hinge.py:91"),
        "hinge_stats_cuda": ("src/repro_torch/kernels/csrc/hinge_stats.cu",
                             "src/repro/kernels/hinge_stats.py:22"),
        # the same TPU kernels under vmap (sven_batch): a leading grid axis
        "hinge_xtv_lanes_cuda": ("src/repro_torch/kernels/csrc/hinge.cu",
                                 "src/repro/kernels/hinge.py:25"),
        "hinge_xd_lanes_cuda": ("src/repro_torch/kernels/csrc/hinge.cu",
                                "src/repro/kernels/hinge.py:91"),
    }
    line = {"kernels": [dict(name=name, route="cuda", source=meta[name][0],
                             replaces=meta[name][1], launches=path_launches[name],
                             **rows[name]) for name in meta]}
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} check(s) failed:", file=sys.stderr)
        for f in smoke.failures:
            print(f"  {f}", file=sys.stderr)
        print(json.dumps(line), flush=True)
        return 1
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
