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
     `enet_path` over the first 3 points of the 10-point lambda grid at the
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
     `ElasticNetCV(k=3, n_lambdas=2)` at the GLA-BRA-180 shape (primal
     folds) and (11b) `cross_validate(k=5, n_lambdas=2)` at the YMSD
     shape (dual folds), each against the port's sequential
     `cross_validate_reference` on the same data (mse within 1e-10 x max,
     the same index_min, equal evaluations and kept columns per (lambda,
     fold)) and its refit bitwise `enet` at lambda_min; (11c) `enet_batch`
     on 5 stacked folds of 11a's data, cold and then warm from the cold carry on
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
     (13d) the fold fan-out of `cross_validate(k=4, n_lambdas=2)` at YMSD
     bitwise `mesh=None`, and k = 3 with mesh="auto" under the 2-rank
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
     the fault wave's first 8 betas within 1e-6 of a direct `sven` and
     within JAX's 1e-10 of `sven` on the padded problem started from the
     warm-start entry each result's worker used (its point and arrays come
     back with the result), or cold; it prints each
     wave's seconds and p50 / p99, the
     seconds from spawn to ready, a batch's pipe transport and a request's
     fingerprint; (14b) `python -m repro_torch.runtime.loadgen --hosts 2
     --kill-host 0 --waves 2` as a subprocess on the card, which must exit
     0. `--multihost` runs phase 14 alone.
  15. the LM serving path (the dense-attention family, random weights from
     seeded generators on the card): (15a) `python -m
     repro_torch.launch.serve --arch internlm2-1.8b --no-smoke --batch 4
     --prompt-len 64 --gen 32`, its full width (24 layers, d_model 2048,
     vocab 92,544, 1.7 B parameters) in bf16, twice: prefill ms and decode
     tokens per second, every token in the vocabulary, equal tokens both
     runs; (15b) one float32 draw cast to bf16, and a float32 model on the
     same (bf16-rounded) weights, TF32 off: the float32 model's decode
     logits at 8 teacher-forced steps within JAX's atol = rtol = 2e-3 of
     its forward's, and the bf16 model's last-position prefill logits
     within 2e-2 x max|logits| of the float32 model's (the float32 model on
     the unrounded draw printed beside, not gated); (15c) the float32
     model cut to 2 layers, on the card against the CPU within 1e-4 x
     max|logits|; (15d) `examples/feature_selection_lm.py`'s flow on the
     bf16 model: 48 x 32 tokens, the last-position hidden states (48,
     2048) in float64, standardized, y from 5 units, coordinate descent on
     the CPU, then `sven` on the card at t = |beta_cd|_1: the primal
     branch, one launch of each hinge pass per H v product, beta within
     1e-8 x max|beta| of the plain float64 backend and 5e-4 x max|beta_cd|
     of CD, the true units recovered printed; (15e) deepseek-7b,
     phi3-medium-14b, qwen2.5-14b (QKV bias), musicgen-large (codebooks)
     and internvl2-26b (patches) at SMOKE size, prefill and 4 decode steps
     against forward at 2e-3.
  16. the MoE, SSM and MLA serving path (random weights from seeded
     generators): (16a) mixtral-8x7b at full width (d_model 4096, 32 / 8
     heads, SWA 4096, 8 experts of d_ff 14,336, top-2, vocab 32,000) cut
     to 16 of 32 layers (46.7 GB in bf16), served twice through
     `launch.serve.serve_config` (batch 4, prompt 64, gen 32): prefill ms,
     decode tokens per second beside the bytes bound, peak memory, every
     token in the vocabulary, equal tokens both runs; and `python -m
     repro_torch.launch.serve` with no arguments (JAX's default arch,
     mixtral SMOKE) as a subprocess, exit 0; (16b) the same width in
     float32 at 1 layer, capacity factor n_experts / top_k (C >= S, no
     drop): decode logits at 8 teacher-forced steps within atol = rtol =
     2e-3 of forward's, the card within 1e-4 x max|logits| of the CPU, the
     router's top-k experts equal on both; (16c) mamba2-130m whole (24
     layers) through the launcher (`--no-smoke`) in bf16, twice, equal
     tokens; its float32 model's decode against forward (2e-3) and card
     against CPU (1e-4 x); a prefill of one 128-token chunk and 128
     decode steps against the forward of two chunks (2e-3), and the
     states against a prefill of both; (16d) deepseek-v3 at full width
     (MLA 128 heads, ranks 1,536 / 512, 256 experts of d_ff 2,048, top-8,
     1 shared, vocab 129,280, MTP) cut to 2 layers (1 dense MLA, 1 MLA +
     MoE), served twice as 16a, `mtp_logits` on the prompt's hidden states
     finite and (4, 64, vocab), and one MLA layer in float32: `mla_prefill`
     + 8 absorbed `mla_decode_step`s against `mla_full` (2e-3); (16e)
     mixtral, mamba2, jamba and deepseek-v3 at SMOKE size, prefill and 4
     decode steps against forward at 2e-3, and a prefill and 2 decode steps
     with no synchronizing CUDA call. `--lm` runs phases 15 and 16
     alone. `rehearse_lm_moe()` runs phase 16 on the CPU at reduced widths.
  17. the LM training path: internlm2-1.8b trained at full width and
     depth through `launch.train`, its float32 model card against CPU,
     mamba2-130m through a fault and a restart, mixtral-8x7b at 1 layer,
     every SMOKE config (`phase_train`; `--train` runs it alone).
  18. data-parallel training over 2 ranks on the one card (gloo, as phase
     13): (18a) the sharded train step (parameters by `params_shardings`,
     moments by `zero1_shardings`, `grad_shardings` the parameters'
     records) at internlm2-1.8b's full width and depth, bf16, global batch
     8 x 128, 1 step: losses finite and equal on both ranks, the
     parameters bitwise equal after the step, each rank's m and v
     half of one rank's, the first loss within 1e-3 of the one-rank
     step's; (18b) float32 parity at 2 layers and for mixtral at 1 layer:
     gradients within 1e-4 x max|g| of one rank's, chosen experts equal,
     the ZeRO-1 update bitwise the replicated one; (18c)
     `dist.launch(train.train, 2, ...)` on mamba2-130m through a fault,
     its step-10 checkpoint resumed on one rank (its first loss within
     1e-4) and on the same 2 ranks (both losses within 1e-4); (18d)
     `pipeline_apply` on a 2-rank "pipe" mesh within 1e-6 of
     `sequential_reference`, M + S - 1 ticks; (18e) `compress` on the card
     against the CPU (`phase_dist`; `--dist` runs it with phase 19,
     `rehearse_dist()` on the CPU at reduced widths);
  19. the sharded step with FSDP and the "model" axis executed, on gloo
     ranks on the one card (`phase_tp`; `--tp` runs it alone,
     `rehearse_tp()` on the CPU): (19a) internlm2-1.8b whole on a (data 1,
     model 2) mesh in 2 microbatches, 2 steps, in phase 18's ranks; (19b)
     the same on (2, 1) under `{"fsdp": "data"}`, 1 step, there too;
     (19c) mixtral-8x7b at full width, 2 of 32 layers, on (2, 2) under its
     rules, 1 step, in 4 ranks of its own: each first loss within 1e-3
     relative of a one-process loss on the same weights and batch (19c: a
     forward once the ranks have exited), a model group's losses equal,
     the leaves no record splits over an axis bitwise equal across its
     views after the update, a rank holding its blocks only, 19a's "model"
     all-reduces a step the design's count (`tp_expected_calls`).
  20. the prefill and decode steps on (data, model) meshes in the dry
     run's serving layouts (`launch/dryrun.py::_rules_for`), gloo ranks on
     the one card (`phase_serve_tp`; `--serve-tp` runs it alone,
     `rehearse_serve_tp()` on the CPU): (20a) internlm2-1.8b whole on (1, 2)
     under the default rules, prefill 4 x 64 and 32 greedy decode steps;
     (20b) on (2, 2), prefill 4 x 3,072 in prefill_32k's layout, then 2
     decode steps in decode_32k's (a cache of 4,096 positions split by
     sequence over "model", flash decoding, FSDP over "data"); (20c)
     mamba2-130m whole in float32 on (1, 2), the SSM split over "model": a
     sharded train step, then prefill 4 x 64 and 8 decode steps; (20d)
     jamba-v0.1-52b at full width, a train step at 2 layers and serving at
     4 (3 SSM layers and the attention one, dense and MoE MLPs) on (1, 2);
     (20e) mixtral-8x7b at full width, 2 layers, on (2, 2) in long_500k's
     layout, batch 1, prompt 8,192, its 4,096-slot ring buffer split over
     "data" and wrapping, 16 decode steps. Each against one process on the
     same weights and prompt once the ranks have exited, teacher-forced on
     the ranks' tokens: the prefill's and the first decode step's logits
     (20c: 8 steps, 20e: 16) within 2e-2 x max|logits| in bf16 and 1e-4 x
     in float32, tokens in the vocabulary and the same on every rank, the
     train steps' first loss within 1e-3 relative; 20a's "model"
     all-reduces a decode step the design's count (2 a layer + the
     embedding lookup's + the head's gather). Prints prefill ms, decode
     tok/s, a step's collectives by axis, a traced step's launches and
     idle share, and each rank's bytes and peak.
  21. the launch tools (`launch/dryrun.py`, `launch/roofline.py`;
     `phase_launch_tools`, `--launch-tools` runs it alone after 19a and 20a
     on 2 ranks of their own): (21a) rank 0's block of the dry run's sven
     cells at (16, 16), `sven_gram_nggp`'s 4,096 x 8,192 X through the
     CUDA Gram in f32 and bf16 against the plain Gram (1e-5 / 2e-2 x
     max|K|) and `sven_hess_pggn`'s 4,096 x 4,096 block through
     `make_distributed_hessian_matvec`'s plain products against float64
     sums (1e-5 x), each timed beside the roofline terms the dry run
     counted for its cell, the device terms over the measured time <=
     1.05; (21b) the dry run counted on the CPU at the shapes and meshes
     phases 15, 17, 19 and 20 ran: 19a's train step and 20a's decode step
     on a (1, 2) mesh with no process group, their collectives by kind and
     axis (calls and bytes) equal to what rank 0 counted there, 19a's
     parameter and ZeRO-1 moment bytes a rank equal to its blocks', and
     15a's, 17a's, 19a's and 20a's medians at or above their roofline
     step (share <= 1.05); (21c) the twins of examples/ in process on the
     card: quickstart, regpath_genomics (150 x 8,000, 3 points),
     feature_selection_lm, serve_lm (mixtral SMOKE, 8 steps) and train_lm
     (internlm2 SMOKE, 10 steps), each passing its own checks.

The run ends with every phase's seconds on one line ("phase seconds: ...").

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

    python3 chip_smoke.py --lm

runs phases 15 and 16 alone (the kernels built first), with their checks,
and prints no result line.

    python3 chip_smoke.py --dist

runs phase 18 alone, with its checks, and prints no result line.

    python3 chip_smoke.py --serve-tp

runs phase 20 alone, with its checks, and prints no result line.

    python3 chip_smoke.py --launch-tools

runs phase 21 alone, after 19a and 20a (2 steps each) on 2 ranks of their
own to hold its counts against, and prints no result line.

    python3 chip_smoke.py --lm-trace [ARCH]

shows where 15a's time goes (or, given ARCH, that arch's: mixtral-8x7b and
deepseek-v3-671b at phase 16's depth cuts): internlm2-1.8b at full width
in bf16, batch 4, prompt 64, a prefill and 8 decode steps untraced and then under
torch.profiler, with the host's time in launch calls and elsewhere, the
device's busy time and idle share, and the launches by op, per prefill and
per decode step. It prints no result line.

    python3 chip_smoke.py --lane-time

checks and times, twice over, only the lane-batched hinge passes at 9b's
operands (5 stacked folds of 144 x 49,151) with X in float64, float32 and
bfloat16, beside 5 single launches, the plain op, `torch.bmm` and the
bound; it
prints no result line, and a copy placed in a checkout of another commit
times that commit's passes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: what phases 15, 17, 19 and 20 measured, for phase 21 to hold against the
#: dry run's counts: label -> {"step_s", and for 19a and 20a rank 0's
#: "counts" (`dist.counts()` of a step) and 19a its "param_bytes" and
#: "moment_bytes"}
MEASURED: dict = {}


def peaks():
    """The H100 SXM's datasheet peaks (dense, at the 700 W limit):
    `repro_torch/launch/roofline.py`, the dry run's roofline (`HBM_BW`,
    `PEAK_FLOPS_BY_TYPE`), importable once `main` has put this checkout's
    `src` on the path."""
    from repro_torch.launch import roofline

    return roofline


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


class PhaseClock:
    """Each phase's seconds on the host clock: `start(label)` ends the phase
    running and starts the next."""

    def __init__(self):
        self.seconds: dict = {}
        self._label, self._t0 = None, 0.0

    def start(self, label) -> None:
        now = time.perf_counter()
        if self._label is not None:
            self.seconds[self._label] = now - self._t0
        self._label, self._t0 = label, now


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
    t_bytes = nbytes / peaks().HBM_BW * 1e3
    t_ops = flops / peaks().PEAK_FLOPS_BY_TYPE[kind] * 1e3
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
#: the points of phase 8b's float32 enet_path: the first 3 of the 10-point
#: grid (the full depth took 318-412 s of the script, run twice; 5 points
#: about 50 s), for the script's time
F32_PATH_POINTS = 3


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


#: phase 11's lambdas a path (cut from 10 to 5, to 3, then to 2, for the script's time)
CV_LAMBDAS = 2
#: 11a's folds (cut from 5 for the script's time; 11b and 11c keep 5)
CV_FOLDS_11A = 3


def phase_cv(torch, smoke, kernels, svm_state, count, dev) -> None:
    """Phase 11: the penalized stack on float64 data, default config. 11a
    `ElasticNetCV(k=CV_FOLDS_11A, n_lambdas=CV_LAMBDAS)` at the GLA-BRA-180 shape (primal
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

    k, L = 5, CV_LAMBDAS
    t_phase = time.perf_counter()

    def cv_case(label, X, y, fit, dual, k):
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
    k_a = CV_FOLDS_11A
    print(f"[11a] ElasticNetCV(k={k_a}, n_lambdas={L}, lambda2={LAMBDA2}).fit, standardize + "
          f"intercept, n = {GLA_BRA[0]}, p = {GLA_BRA[1]}", flush=True)
    cv_case("11a", X, y,
            lambda: ElasticNetCV(k=k_a, n_lambdas=L, lambda2=LAMBDA2).fit(X, y).cv_result_,
            dual=False, k=k_a)

    Xtr, ytr, _, _ = cv_folds(X, y, k)   # 5 folds, for 11c
    del X, y
    torch.cuda.empty_cache()

    X, y, _ = make_regression(*YMSD, seed=1, device=dev)
    print(f"[11b] cross_validate(k={k}, n_lambdas={L}, lambda2={LAMBDA2}), standardize + "
          f"intercept, n = {YMSD[0]}, p = {YMSD[1]}", flush=True)
    cv_case("11b", X, y, lambda: cross_validate(X, y, k=k, n_lambdas=L, lambda2=LAMBDA2),
            dual=True, k=k)
    del X, y
    torch.cuda.empty_cache()

    # 11c: enet_batch on 5 folds of 11a's data, cold and then warm from the cold carry
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
MULTI_LAMBDAS = 2             # 13d (cut from 10 to 5, to 3, then to 2, for the script's time)
MULTI_DECLINED_FOLDS = 3      # 13d's k that the 2-rank mesh does not divide (cut from 5)
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
    # 13d: fold fan-out; then a k under the context that the mesh does not divide
    cv, out["13d_run"] = run(lambda: cross_validate(Xd, yd, k=MULTI_FOLDS,
                                                    n_lambdas=MULTI_LAMBDAS, mesh=mesh))
    out["13d"] = cv
    with dist.mesh_context(mesh):
        cv5, out["13d_nested_run"] = run(lambda: cross_validate(
            Xd, yd, k=MULTI_DECLINED_FOLDS, n_lambdas=MULTI_LAMBDAS, mesh="auto"))
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
    for label, k in (("13d", MULTI_FOLDS), ("13d_nested", MULTI_DECLINED_FOLDS)):
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
MH_TOL = 1e-6              # phase 12's bound on warm-started GLA-BRA results, against a
#                            cold direct `sven`
MH_JAX_TOL = 1e-10         # JAX's bench bound (`run_multihost`): against `sven` from the
#                            result's own warm start
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
    # the fault wave's first results against direct solves of the unpadded
    # problems (cold, MH_TOL), and against `sven` on the padded problem
    # started from each result's own warm start: the entry its worker took
    # (`warm_from`, its point; `warm_start`, its arrays), or cold (MH_JAX_TOL)
    dev_max = rel_max = warm_max = 0.0
    n_warm = 0
    starts = []
    for k, (item, rid) in enumerate(list(zip(workload, ids))[:MH_DIRECT]):
        r = results[rid]
        if r.status != "ok":
            continue
        X, y = torch.as_tensor(item.X, device=dev), torch.as_tensor(item.y, device=dev)
        direct = sven(X, y, item.lam, item.lambda2).beta.cpu().numpy()
        d = float(np.abs(r.beta - direct).max())
        dev_max = max(dev_max, d)
        rel_max = max(rel_max, d / max(float(np.abs(direct).max()), 1e-300))
        (bn, bp), (n, p) = r.bucket, X.shape
        Xp = torch.zeros((bn, bp), dtype=X.dtype, device=dev)
        Xp[:n, :p] = X
        yp = torch.zeros((bn,), dtype=y.dtype, device=dev)
        yp[:n] = y
        kw = {}
        if r.warm_from is not None:
            alpha, w = r.warm_start
            kw = {"warm_alpha": torch.as_tensor(alpha, device=dev),
                  "warm_w": torch.as_tensor(w, device=dev)}
            n_warm += 1
        starts.append("cold" if r.warm_from is None else f"{r.warm_from:.4g}")
        warm = sven(Xp, yp, item.lam, item.lambda2, **kw).beta[:p].cpu().numpy()
        warm_max = max(warm_max, float(np.abs(r.beta - warm).max()))
    print(f"    the fault wave's first {MH_DIRECT} against a direct sven: max|beta - direct| "
          f"{dev_max:.3e} ({rel_max:.3e} x max|beta|): <= {MH_TOL:g} "
          f"{dev_max <= MH_TOL}; their workers' warm starts (the entries' points, t) "
          f"{starts} ({n_warm} warm); against sven on the padded problem from that start: "
          f"{warm_max:.3e}", flush=True)
    smoke.check(dev_max <= MH_TOL, f"14a: max|beta - direct sven| = {dev_max:.3e} <= {MH_TOL:g}")
    smoke.check(len(starts) == MH_DIRECT and warm_max <= MH_JAX_TOL,
                f"14a: max|beta - sven from the result's own warm start| = {warm_max:.3e} <= "
                f"JAX's {MH_JAX_TOL:g} ({len(starts)} results, {n_warm} warm)")
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


#: phase 15: the LM serving path of the dense-attention family
LM_ARCH = "internlm2-1.8b"
LM_PROMPT, LM_BATCH = 64, 4
LM_SERVE = ["--arch", LM_ARCH, "--no-smoke", "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen", "32"]
LM_STEPS = 8                  # 15b's teacher-forced decode steps
LM_DECODE_TOL = 2e-3          # atol = rtol: JAX's decode-vs-forward bound
LM_BF16_TOL = 2e-2            # x max|logits|: bf16 against float32
LM_CPU_TOL = 1e-4             # x max|logits|: the card against the CPU, float32
LM_CPU_LAYERS = 2             # 15c's depth cut
FS_SEQS, FS_LEN, FS_TRUE = 48, 32, 5     # 15d: examples/feature_selection_lm.py's sizes
FS_LAMBDA2 = 0.5
FS_TORCH_TOL = 1e-8           # x max|beta|: PERF.md §2's primal bound
FS_CD_TOL = 5e-4              # x max|beta_cd|: PERF.md §2's primal bound against CD
LM_TRACE_STEPS = 8            # `--lm-trace`: decode steps traced
LM_OTHERS = ("deepseek-7b", "phi3-medium-14b", "qwen2.5-14b", "musicgen-large",
             "internvl2-26b")


def teacher_forced(torch, M, params, cfg, batch, steps):
    """[(decode logits, forward logits)] for the last `steps` text tokens of
    `batch`: a prefill of the rest, then a decode step a token, each beside
    the forward's logits at that token's position."""
    with torch.inference_mode():
        full, _ = M.forward(params, cfg, batch)
        toks = batch["tokens"]
        s_txt = toks.shape[1]
        offset = full.shape[1] - s_txt            # the prepended patches
        pre = dict(batch, tokens=toks[:, :s_txt - steps])
        _, caches = M.prefill(params, cfg, pre, max_len=full.shape[1] + 4)
        pairs = []
        for s in range(steps):
            pos = s_txt - steps + s
            logits, caches = M.decode_step(params, cfg, toks[:, pos], caches)
            pairs.append((logits, full[:, offset + pos]))
    return pairs


def decode_vs_forward(pairs) -> float:
    """The largest |decode - forward| - rtol |forward| over `pairs`: within
    JAX's bound (atol = rtol = LM_DECODE_TOL) when <= LM_DECODE_TOL."""
    return max(((a - b).abs() - LM_DECODE_TOL * b.abs()).max().item() for a, b in pairs)


def hidden_state_probe(torch, smoke, kernels, svm_state, count, params, cfg, dev, label,
                       what, with_cd: bool = True) -> None:
    """The feature-selection flow on `params`' hidden states (15d, 17f): X
    = the last-position hidden states of FS_SEQS random sequences of
    FS_LEN tokens, float64, standardized; y from FS_TRUE true units plus
    noise; CD on the CPU at a quarter of lambda1_max, then `sven` on the
    card at t = |beta_cd|_1 against the plain float64 backend and CD.
    Without `with_cd`, t is half the true units' l1 norm and CD is not
    run (on a trained model's hidden states it does not converge in its
    2,000 sweeps)."""
    from repro_torch.baselines import elastic_net_cd
    from repro_torch.core.elastic_net import lambda1_max
    from repro_torch.core.sven import SvenConfig, sven
    from repro_torch.models import model as M

    gen = torch.Generator(dev).manual_seed(2)
    fs_toks = torch.randint(0, cfg.vocab_size, (FS_SEQS, FS_LEN), generator=gen, device=dev)
    with torch.inference_mode():
        _, _, h = M.forward(params, cfg, {"tokens": fs_toks}, return_hidden=True)
    X = h[:, -1, :].to(torch.float64)
    X = (X - X.mean(0)) / (X.std(0, correction=0) + 1e-9)
    true_idx = torch.randperm(cfg.d_model, generator=gen, device=dev)[:FS_TRUE]
    w = torch.randn(FS_TRUE, generator=gen, dtype=torch.float64, device=dev)
    y = X[:, true_idx] @ w + 0.05 * torch.randn(FS_SEQS, generator=gen, dtype=torch.float64,
                                                device=dev)
    y = y - y.mean()
    del h
    if with_cd:
        t0 = time.perf_counter()
        cd = elastic_net_cd(X.cpu(), y.cpu(), 0.25 * float(lambda1_max(X, y)), FS_LAMBDA2)
        cd_text = f"CD on the CPU {cd.sweeps} sweeps, {time.perf_counter() - t0:.2f} s"
        beta_cd = cd.beta.to(dev)
        t = float(beta_cd.abs().sum())
    else:
        cd_text, t = "no CD", 0.5 * float(w.abs().sum())
    sol, secs, launched, syncs = run_path(torch, kernels, svm_state,
                                          lambda: sven(X, y, t, FS_LAMBDA2))
    dead = svm_state.cg_lanes.dead
    count(launched)
    ref, ref_s, _, _ = run_path(torch, kernels, svm_state,
                                lambda: sven(X, y, t, FS_LAMBDA2, SvenConfig(backend="torch")))
    picked = set(torch.nonzero(sol.beta.abs() > 1e-6).flatten().tolist())
    hit = len(set(true_idx.tolist()) & picked)
    print(f"[{label}] feature selection: X = last-position hidden states ({FS_SEQS}, "
          f"{cfg.d_model}) of {what}, float64, standardized; {cd_text}; t {t:.4f}; sven: mode {sol.mode}, {sol.iters} Newton / "
          f"{sol.cg_iters} CG + {dead} dead, {secs:.3f} s, {syncs} host syncs, launches "
          f"{launched}; torch backend {ref_s:.3f} s; {len(picked)} selected, recovered "
          f"{hit}/{FS_TRUE} true units", flush=True)
    smoke.check(sol.mode == "primal", f"{label}: p = d_model > n takes the primal branch")
    smoke.check(launched["hinge_xtv_cuda"] == launched["hinge_xd_cuda"]
                == sol.cg_iters + dead > 0, f"{label}: one launch of each hinge pass per H v "
                f"product: CG steps {sol.cg_iters} + dead steps {dead}")
    scale = ref.beta.abs().max().item()
    dev_b = max_dev(torch, sol.beta, ref.beta)
    smoke.check(dev_b <= FS_TORCH_TOL * scale, f"{label}: max|beta - beta_torch| = {dev_b:.3e} "
                f"<= {FS_TORCH_TOL} x max|beta| = {FS_TORCH_TOL * scale:.3e}")
    if not with_cd:
        return
    scale = beta_cd.abs().max().item()
    dev_cd = max_dev(torch, sol.beta, beta_cd)
    smoke.check(dev_cd <= FS_CD_TOL * scale, f"{label}: max|beta - beta_cd| = {dev_cd:.3e} <= "
                f"{FS_CD_TOL} x max|beta_cd| = {FS_CD_TOL * scale:.3e}")


def phase_lm(torch, smoke, kernels, svm_state, count, dev, card: str) -> None:
    """Phase 15: the LM serving path (dense-attention family). 15a the
    launcher at internlm2-1.8b's full width in bf16, twice; 15b float32
    decode against forward, and bf16 against float32, on one float32 draw;
    15c the card against the CPU at 2 layers; 15d the feature-selection
    flow on the bf16 model's hidden states, solved by `sven` on the hinge
    kernels; 15e the five other dense-family SMOKE configs."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    from repro_torch.utils import tree_map, tree_size

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    vocab = cfg.vocab_size

    # -- 15a: the launcher at full width, bf16 -----------------------------------
    print(f"[15a] python -m repro_torch.launch.serve {' '.join(LM_SERVE)} (bf16), twice",
          flush=True)
    runs = [launcher.serve(LM_SERVE) for _ in range(2)]
    for i, r in enumerate(runs):
        print(f"    run {i + 1}: prefill {LM_BATCH} x {LM_PROMPT} {r.prefill_s * 1e3:.3f} ms, "
              f"decode {r.n_decoded} tokens in {r.decode_s:.4f} s = {r.tok_per_s:.1f} tok/s; "
              f"{card}", flush=True)
    toks = runs[0].tokens
    smoke.check(toks.shape == (LM_BATCH, 33) and int(toks.min()) >= 0
                and int(toks.max()) < vocab,
                f"15a: tokens {tuple(toks.shape)}, every one in [0, {vocab})")
    smoke.check(torch.equal(runs[0].tokens, runs[1].tokens),
                "15a: two greedy runs give equal tokens")
    MEASURED["15a"] = {"step_s": statistics.median(r.decode_s / LM_GEN for r in runs)}
    del runs
    torch.cuda.empty_cache()

    # -- 15b: float32 and bf16 on the same weights, one float32 draw --------------
    # the bf16 model holds the draw cast to bf16; the float32 model holds the
    # same values widened back, so the two differ in their arithmetic alone
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    draw = M.init_model(cfg32, generator=torch.Generator(dev).manual_seed(0), device=dev)
    p16 = tree_map(lambda t: t.to(torch.bfloat16), draw)
    n_params = tree_size(p16)
    print(f"[15b] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {vocab}: "
          f"{n_params:,} parameters, {2 * n_params / 1e9:.2f} GB in bf16; float32 "
          f"(TF32 {torch.backends.cuda.matmul.allow_tf32}) and bf16 on the same weights",
          flush=True)
    gen = torch.Generator(dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, vocab, (LM_BATCH, LM_PROMPT + LM_STEPS),
                                     generator=gen, device=dev)}
    prompt = {"tokens": batch["tokens"][:, :LM_PROMPT]}
    with torch.inference_mode():
        l_draw = M.prefill(draw, cfg32, prompt, max_len=LM_PROMPT + 4)[0][:, -1]
    del draw
    p32 = tree_map(lambda t: t.to(torch.float32), p16)
    worst = decode_vs_forward(teacher_forced(torch, M, p32, cfg32, batch, LM_STEPS))
    smoke.check(worst <= LM_DECODE_TOL,
                f"15b: float32 decode logits at {LM_STEPS} teacher-forced steps match "
                f"forward's within atol = rtol = {LM_DECODE_TOL} (worst |d - f| - rtol |f| "
                f"= {worst:.3e})")
    with torch.inference_mode():
        l32 = M.prefill(p32, cfg32, prompt, max_len=LM_PROMPT + 4)[0][:, -1]
        l16 = M.prefill(p16, cfg16, prompt, max_len=LM_PROMPT + 4)[0][:, -1]
    scale = l32.abs().max().item()
    dev16 = (l16 - l32).abs().max().item()
    dev_draw = (l16 - l_draw).abs().max().item() / l_draw.abs().max().item()
    print(f"    bf16 against float32, last-position prefill logits: max|d| {dev16:.4e}, "
          f"max|logits| {scale:.4f}, ratio {dev16 / scale:.4e} (against the float32 model "
          f"on the unrounded draw, not gated: {dev_draw:.4e}); {card}", flush=True)
    smoke.check(dev16 <= LM_BF16_TOL * scale,
                f"15b: bf16 prefill logits within {LM_BF16_TOL} x max|logits| of float32's "
                f"({dev16 / scale:.4e} x)")
    del l32, l16, l_draw

    # -- 15c: the card against the CPU, 2 layers at full width ---------------------
    cfg2 = dataclasses.replace(cfg32, n_layers=LM_CPU_LAYERS)
    p2 = dict(p32, layers=p32["layers"][:LM_CPU_LAYERS])
    b2 = {"tokens": batch["tokens"][:2, :32]}
    with torch.inference_mode():
        on_card = M.forward(p2, cfg2, b2)[0].cpu()
        t0 = time.perf_counter()
        on_cpu = M.forward(tree_map(lambda t: t.cpu(), p2), cfg2,
                           {"tokens": b2["tokens"].cpu()})[0]
        cpu_s = time.perf_counter() - t0
    scale = on_cpu.abs().max().item()
    dev_cpu = (on_card - on_cpu).abs().max().item()
    print(f"    [15c] {LM_CPU_LAYERS} layers, logits {tuple(on_cpu.shape)}: card against CPU "
          f"max|d| {dev_cpu:.3e} = {dev_cpu / scale:.3e} x max|logits| (CPU forward "
          f"{cpu_s:.2f} s)", flush=True)
    smoke.check(dev_cpu <= LM_CPU_TOL * scale,
                f"15c: float32 logits on the card within {LM_CPU_TOL} x max|logits| of the "
                "CPU's")
    del p32, p2, on_card, on_cpu
    torch.cuda.empty_cache()

    # -- 15d: feature selection on the bf16 model's hidden states ------------------
    hidden_state_probe(torch, smoke, kernels, svm_state, count, p16, cfg16, dev, "15d",
                       "the bf16 model")
    del p16
    torch.cuda.empty_cache()

    # -- 15e: the other dense-family configs at SMOKE size -------------------------
    for arch in LM_OTHERS:
        c = get_config(arch, smoke=True)
        params = M.init_model(c, generator=torch.Generator(dev).manual_seed(0), device=dev)
        b = launcher.make_batch(c, 2, 16, torch.Generator(dev).manual_seed(1), dev)
        worst = decode_vs_forward(teacher_forced(torch, M, params, c, b, 4))
        smoke.check(worst <= LM_DECODE_TOL,
                    f"15e: {c.name} ({c.frontend}{', qkv bias' if c.qkv_bias else ''}): "
                    f"prefill + 4 decode steps match forward within {LM_DECODE_TOL} "
                    f"(worst {worst:.3e})")
    print(f"    phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)


#: phase 16: the MoE, SSM and MLA serving path
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 16     # 16a's depth cut: 32 layers hold 93 GB
SSM_ARCH = "mamba2-130m"
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 2  # 16d: 1 dense MLA layer, 1 MLA + MoE layer
LM_GEN = 32
SSM_CHUNKS = 2                # 16c: a prefill of one chunk, decode through the second
LM_NEW_SMOKE = ("mixtral-8x7b", "mamba2-130m", "jamba-v0.1-52b", "deepseek-v3-671b")


def f32_of(torch, cfg, **kw):
    return dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32, **kw)


def ample_capacity(cfg):
    """`cfg` with its MoE capacity factor at n_experts / top_k: then C >= S,
    and a forward drops no token that a decode step keeps."""
    moe = cfg.moe._replace(capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, moe=moe)


def settle(torch, dev, reset_peak=False) -> None:
    """Free the card's cached blocks (and restart its peak count)."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        if reset_peak:
            torch.cuda.reset_peak_memory_stats(dev)


def peak_text(torch, dev) -> str:
    if dev.type != "cuda":
        return "peak not measured (CPU)"
    return f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB allocated"


def decode_bound(params, cfg, moe_mod) -> str:
    """The least time of a decode step: every expert runs on C slots (C >=
    1 at S = 1), so a step reads every weight but the MTP module's."""
    from repro_torch.utils import tree_bytes

    nbytes = tree_bytes(params) - tree_bytes(params.get("mtp", {}))
    return (f"A decode step runs every expert on C = {moe_mod._capacity(1, cfg.moe)} slots, "
            f"so it reads every weight but MTP's, {nbytes / 1e9:.3f} GB: bound "
            f"{nbytes / peaks().HBM_BW * 1e3:.3f} ms a step = "
            f"{LM_BATCH * peaks().HBM_BW / nbytes:.1f} tok/s at batch {LM_BATCH}")


def serve_twice(torch, smoke, launcher, cfg, params, dev, card, label) -> None:
    """`serve_config` twice on the same weights (batch LM_BATCH, prompt
    LM_PROMPT, LM_GEN tokens): each run's prefill ms and decode tokens per
    second; every token in the vocabulary, equal tokens both runs."""
    runs = [launcher.serve_config(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN,
                                  device=dev, params=params) for _ in range(2)]
    report_runs(torch, smoke, runs, cfg.vocab_size, dev, card, label)


def report_runs(torch, smoke, runs, vocab, dev, card, label) -> None:
    for i, r in enumerate(runs):
        print(f"    {label} run {i + 1}: prefill {LM_BATCH} x {LM_PROMPT} "
              f"{r.prefill_s * 1e3:.3f} ms, decode {r.n_decoded} tokens in {r.decode_s:.4f} s "
              f"= {r.tok_per_s:.1f} tok/s ({r.decode_s / LM_GEN * 1e3:.3f} ms a step); "
              f"{peak_text(torch, dev)}; {card}", flush=True)
    toks = runs[0].tokens
    smoke.check(toks.shape == (LM_BATCH, LM_GEN + 1) and int(toks.min()) >= 0
                and int(toks.max()) < vocab,
                f"{label}: tokens {tuple(toks.shape)}, every one in [0, {vocab})")
    smoke.check(torch.equal(runs[0].tokens, runs[1].tokens),
                f"{label}: two greedy runs give equal tokens")


def card_vs_cpu(torch, smoke, M, params, cfg, tokens, label) -> None:
    """The forward of `tokens` on `params` and on a CPU copy of them:
    logits within LM_CPU_TOL x max|logits|."""
    from repro_torch.utils import tree_map

    with torch.inference_mode():
        on_card = M.forward(params, cfg, {"tokens": tokens})[0].cpu()
        cpu_params = tree_map(lambda t: t.cpu(), params)
        t0 = time.perf_counter()
        on_cpu = M.forward(cpu_params, cfg, {"tokens": tokens.cpu()})[0]
        secs = time.perf_counter() - t0
    scale = on_cpu.abs().max().item()
    dev_cpu = (on_card - on_cpu).abs().max().item()
    print(f"    [{label}] {cfg.n_layers} layer(s), logits {tuple(on_cpu.shape)}: card against "
          f"CPU max|d| {dev_cpu:.3e} = {dev_cpu / scale:.3e} x max|logits| (CPU forward "
          f"{secs:.2f} s)", flush=True)
    smoke.check(dev_cpu <= LM_CPU_TOL * scale,
                f"{label}: float32 logits on the card within {LM_CPU_TOL} x max|logits| of the "
                "CPU's")


def lm_tokens(torch, cfg, shape, seed, dev):
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)


def decode_check(torch, smoke, M, params, cfg, dev, label) -> None:
    """LM_STEPS teacher-forced decode steps after a prompt of LM_PROMPT,
    against the forward, within JAX's atol = rtol = LM_DECODE_TOL."""
    batch = {"tokens": lm_tokens(torch, cfg, (LM_BATCH, LM_PROMPT + LM_STEPS), 1, dev)}
    worst = decode_vs_forward(teacher_forced(torch, M, params, cfg, batch, LM_STEPS))
    smoke.check(worst <= LM_DECODE_TOL,
                f"{label}: float32 decode logits at {LM_STEPS} teacher-forced steps match "
                f"forward's within atol = rtol = {LM_DECODE_TOL} (worst |d - f| - rtol |f| = "
                f"{worst:.3e})")


def no_host_sync(torch, M, params, cfg, batch) -> bool:
    """Whether a prefill of `batch` and 2 greedy decode steps run without a
    synchronizing CUDA call (one that waits for the card), so the host
    can queue a step while the card runs the one before."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            logits, caches = M.prefill(params, cfg, batch, max_len=batch["tokens"].shape[1] + 4)
            tok = torch.argmax(logits[:, -1], dim=-1)
            for _ in range(2):
                logits, caches = M.decode_step(params, cfg, tok, caches)
                tok = torch.argmax(logits, dim=-1)
    except RuntimeError as e:
        print(f"    a synchronizing call: {e}", flush=True)
        return False
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return True


def phase_lm_moe(torch, smoke, dev, card: str) -> None:
    """Phase 16: the MoE, SSM and MLA serving path. 16a mixtral-8x7b at full
    width in bf16, cut to MOE_LAYERS layers, served twice, and the launcher
    with no arguments; 16b the same width in float32 at 1 layer: decode
    against forward, the card against the CPU, the router's choices equal
    on both; 16c mamba2-130m whole: the launcher twice in bf16, float32
    decode against forward, the card against the CPU, and the chunk carry
    (a prefill of one chunk, decode through the second, against the
    forward of both); 16d deepseek-v3 at full width in bf16, cut to
    MLA_LAYERS layers, served twice, with `mtp_logits`, and one MLA layer
    in float32: the absorbed decode against the expanded form; 16e the four
    SMOKE configs. Runs on the CPU too (`rehearse_lm_moe`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import mla as mla_mod
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.utils import tree_bytes, tree_map, tree_size

    t_phase = time.perf_counter()

    # -- 16a: mixtral-8x7b at full width, bf16, MOE_LAYERS layers ----------------
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    settle(torch, dev, reset_peak=True)
    params = M.init_model(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    print(f"[16a] {MOE_ARCH}: {cfg.n_layers} of {full.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads, SWA {cfg.swa_window}, "
          f"{cfg.moe.n_experts} experts of d_ff {cfg.moe.d_ff_expert} top-{cfg.moe.top_k}, vocab "
          f"{cfg.vocab_size}: {tree_size(params):,} parameters, "
          f"{tree_bytes(params) / 1e9:.3f} GB in bf16. {decode_bound(params, cfg, moe_mod)}",
          flush=True)
    serve_twice(torch, smoke, launcher, cfg, params, dev, card, "16a")
    del params
    settle(torch, dev)
    argv = [] if dev.type == "cuda" else ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *argv], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=600)
    out = proc.stdout.strip()
    print(f"    python -m repro_torch.launch.serve {' '.join(argv)}: exit {proc.returncode} "
          f"in {time.perf_counter() - t0:.1f} s: {out[-200:]}", flush=True)
    smoke.check(proc.returncode == 0 and f"[serve] {MOE_ARCH}-smoke:" in out,
                f"16a: the launcher with no arguments serves {MOE_ARCH} SMOKE "
                f"(exit {proc.returncode}) {proc.stderr.strip()[-400:]}")

    # -- 16b: the same width in float32, 1 layer ---------------------------------
    cfg32 = ample_capacity(f32_of(torch, full, n_layers=1))
    settle(torch, dev, reset_peak=True)
    p32 = M.init_model(cfg32, generator=torch.Generator(dev).manual_seed(0), device=dev)
    print(f"[16b] {MOE_ARCH} in float32, 1 layer, capacity factor "
          f"{cfg32.moe.capacity_factor} (C >= S): {4 * tree_size(p32) / 1e9:.3f} GB", flush=True)
    decode_check(torch, smoke, M, p32, cfg32, dev, "16b")
    chosen = []
    route = moe_mod.route

    def record(p, x, c):
        picked = route(p, x, c)
        chosen.append(picked[2].cpu())
        return picked

    moe_mod.route = record
    try:
        card_vs_cpu(torch, smoke, M, p32, cfg32, lm_tokens(torch, cfg32, (2, 32), 2, dev), "16b")
    finally:
        moe_mod.route = route
    smoke.check(len(chosen) == 2 and torch.equal(chosen[0], chosen[1]),
                f"16b: the router's top-{cfg32.moe.top_k} experts of all "
                f"{chosen[0].shape[0] * chosen[0].shape[1]} tokens equal on the card and on "
                "the CPU")
    # bf16 against float32 on the same (bf16-rounded) weights, the router
    # float32 in both: printed, not gated, since a near-tie of the router
    # may choose another expert in bf16 and move that token by O(1)
    p16 = tree_map(lambda t: t.to(torch.bfloat16), p32)
    for l32, l16 in zip(p32["layers"], p16["layers"]):
        l16["mlp"]["router"] = l32["mlp"]["router"]
    widened = tree_map(lambda t: t.to(torch.float32), p16)
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    prompt = {"tokens": lm_tokens(torch, cfg32, (LM_BATCH, LM_PROMPT), 1, dev)}
    chosen.clear()
    moe_mod.route = record
    try:
        with torch.inference_mode():
            l32 = M.prefill(widened, cfg32, prompt, max_len=LM_PROMPT + 4)[0][:, -1]
            l16 = M.prefill(p16, cfg16, prompt, max_len=LM_PROMPT + 4)[0][:, -1]
    finally:
        moe_mod.route = route
    flips = int((chosen[0].sort(-1).values != chosen[1].sort(-1).values).any(-1).sum())
    ratio = (l16 - l32).abs().max().item() / l32.abs().max().item()
    print(f"    [16b] bf16 against float32 on the same weights, last-position prefill logits: "
          f"{ratio:.4e} x max|logits| (not gated); tokens routed to another expert set "
          f"{flips} of {chosen[0].shape[0] * chosen[0].shape[1]}", flush=True)
    del p16, widened, l32, l16
    print(f"    16b {peak_text(torch, dev)}; {card}", flush=True)
    del p32
    settle(torch, dev)

    # -- 16c: mamba2-130m whole ---------------------------------------------------
    cfg = get_config(SSM_ARCH)
    serve_args = ["--arch", SSM_ARCH, "--no-smoke", "--batch", str(LM_BATCH), "--prompt-len",
                  str(LM_PROMPT), "--gen", str(LM_GEN)]
    if dev.type != "cuda":
        serve_args += ["--device", "cpu"]
    print(f"[16c] python -m repro_torch.launch.serve {' '.join(serve_args)} (bf16), twice; "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_state {cfg.ssm.d_state}, chunk "
          f"{cfg.ssm.chunk}", flush=True)
    settle(torch, dev, reset_peak=True)
    report_runs(torch, smoke, [launcher.serve(serve_args) for _ in range(2)], cfg.vocab_size,
                dev, card, "16c")
    cfg32 = f32_of(torch, cfg)
    p32 = M.init_model(cfg32, generator=torch.Generator(dev).manual_seed(0), device=dev)
    decode_check(torch, smoke, M, p32, cfg32, dev, "16c")
    card_vs_cpu(torch, smoke, M, p32, cfg32, lm_tokens(torch, cfg32, (2, 32), 2, dev), "16c")
    Q, S = cfg32.ssm.chunk, SSM_CHUNKS * cfg32.ssm.chunk
    toks = lm_tokens(torch, cfg32, (2, S), 3, dev)
    with torch.inference_mode():
        full_logits, _ = M.forward(p32, cfg32, {"tokens": toks})
        _, caches = M.prefill(p32, cfg32, {"tokens": toks[:, :Q]}, max_len=S)
        pairs = []
        for pos in range(Q, S):
            logits, caches = M.decode_step(p32, cfg32, toks[:, pos], caches)
            pairs.append((logits, full_logits[:, pos]))
        _, whole = M.prefill(p32, cfg32, {"tokens": toks}, max_len=S)
    h_dev = max(((a.h - b.h).abs().max() / b.h.abs().max()).item()
                for a, b in zip(caches["layers"], whole["layers"]))
    worst = decode_vs_forward(pairs)
    smoke.check(worst <= LM_DECODE_TOL and h_dev <= LM_DECODE_TOL,
                f"16c: a prefill of {Q} and {S - Q} decode steps match the {SSM_CHUNKS}-chunk "
                f"forward of {S} within {LM_DECODE_TOL} (worst {worst:.3e}), and the states the "
                f"prefill of {S} leaves within {LM_DECODE_TOL} x max|h| ({h_dev:.3e} x)")
    print(f"    16c {peak_text(torch, dev)}; {card}", flush=True)
    del p32, full_logits, caches, whole, pairs
    settle(torch, dev)

    # -- 16d: deepseek-v3 at full width, bf16, MLA_LAYERS layers, MTP -------------
    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS, dense_prefix=1)
    settle(torch, dev, reset_peak=True)
    params = M.init_model(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    print(f"[16d] {MLA_ARCH}: {cfg.n_layers} of {full.n_layers} layers "
          f"{[cfg.layer_spec(i) for i in range(cfg.n_layers)]}, d_model {cfg.d_model}, MLA "
          f"{cfg.mla.n_heads} heads, ranks {cfg.mla.q_lora_rank} / {cfg.mla.kv_lora_rank}, "
          f"{cfg.moe.n_experts} experts of d_ff {cfg.moe.d_ff_expert} top-{cfg.moe.top_k} + "
          f"{cfg.moe.n_shared} shared, vocab {cfg.vocab_size}, MTP depth {cfg.mtp_depth}: "
          f"{tree_size(params):,} parameters, {tree_bytes(params) / 1e9:.3f} GB in bf16. "
          f"{decode_bound(params, cfg, moe_mod)}", flush=True)
    serve_twice(torch, smoke, launcher, cfg, params, dev, card, "16d")
    b = launcher.make_batch(cfg, LM_BATCH, LM_PROMPT, torch.Generator(dev).manual_seed(1), dev)
    with torch.inference_mode():
        _, _, h = M.forward(params, cfg, b, return_hidden=True)
        mtp = M.mtp_logits(params, cfg, h, b)
    smoke.check(mtp.shape == (LM_BATCH, LM_PROMPT, cfg.vocab_size)
                and bool(torch.isfinite(mtp).all()),
                f"16d: mtp_logits on the hidden states {tuple(mtp.shape)}, every one finite")
    del params, h, mtp
    settle(torch, dev, reset_peak=True)
    # one MLA layer at full width in float32: the absorbed decode against the expanded form
    gen = torch.Generator(dev).manual_seed(3)
    mp = mla_mod.init_mla(gen, cfg.d_model, cfg.mla, torch.float32, dev)
    x = torch.randn((2, LM_PROMPT + LM_STEPS, cfg.d_model), generator=gen, device=dev)
    with torch.inference_mode():
        expanded = mla_mod.mla_full(mp, x, cfg.mla, rope_theta=cfg.rope_theta)
        _, cache = mla_mod.mla_prefill(mp, x[:, :LM_PROMPT], cfg.mla, rope_theta=cfg.rope_theta,
                                       cache_len=LM_PROMPT + LM_STEPS)
        pairs = []
        for s in range(LM_PROMPT, LM_PROMPT + LM_STEPS):
            out, cache = mla_mod.mla_decode_step(mp, x[:, s:s + 1], cache, cfg.mla,
                                                 rope_theta=cfg.rope_theta)
            pairs.append((out[:, 0], expanded[:, s]))
    worst = decode_vs_forward(pairs)
    smoke.check(worst <= LM_DECODE_TOL,
                f"16d: one MLA layer at full width in float32: mla_prefill + {LM_STEPS} absorbed "
                f"mla_decode_steps match mla_full within atol = rtol = {LM_DECODE_TOL} (worst "
                f"{worst:.3e}, max|out| {expanded.abs().max().item():.3e}; "
                f"{peak_text(torch, dev)})")
    del mp, x, expanded, cache, pairs
    settle(torch, dev)

    # -- 16e: the four SMOKE configs ----------------------------------------------
    for arch in LM_NEW_SMOKE:
        c = get_config(arch, smoke=True)
        p = M.init_model(c, generator=torch.Generator(dev).manual_seed(0), device=dev)
        b = launcher.make_batch(c, 2, 16, torch.Generator(dev).manual_seed(1), dev)
        worst = decode_vs_forward(teacher_forced(torch, M, p, c, b, 4))
        smoke.check(worst <= LM_DECODE_TOL,
                    f"16e: {c.name}: prefill + 4 decode steps match forward within "
                    f"{LM_DECODE_TOL} (worst {worst:.3e})")
        if dev.type == "cuda":
            smoke.check(no_host_sync(torch, M, p, c, b),
                        f"16e: {c.name}: prefill and 2 decode steps make no synchronizing "
                        "CUDA call (torch.cuda.set_sync_debug_mode)")
    print(f"    phase 16: {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)


#: `rehearse_lm_moe`'s reduced widths: each full-width config with these fields
REHEARSAL = {
    "mixtral_8x7b": dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                         vocab_size=4096, swa_window=64),
    "mamba2_130m": dict(d_model=128, vocab_size=4096),
    "deepseek_v3_671b": dict(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=128,
                             d_ff_dense=512, vocab_size=4096),
}
REHEARSAL_PARTS = {
    "mixtral_8x7b": dict(moe=dict(d_ff_expert=512)),
    "mamba2_130m": dict(ssm=dict(d_state=32, head_dim=32)),
    "deepseek_v3_671b": dict(mla=dict(n_heads=4, q_lora_rank=64, kv_lora_rank=32,
                                      qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32),
                             moe=dict(n_experts=16, top_k=4, d_ff_expert=128,
                                      d_ff_shared=128)),
}


def rehearse_lm_moe() -> int:
    """Phase 16 on the CPU at REHEARSAL's widths (each arch's depth, heads
    and patterns kept, its widths cut), for the figures a chip run is
    predicted against and to try the phase's logic where there is no card:

        PYTHONPATH=src python3 -c "import chip_smoke; chip_smoke.rehearse_lm_moe()"

    Returns 1 if a check failed."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    saved = {}
    for name, fields in REHEARSAL.items():
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        saved[name] = mod.CONFIG
        parts = {k: getattr(mod.CONFIG, k)._replace(**v)
                 for k, v in REHEARSAL_PARTS[name].items()}
        mod.CONFIG = dataclasses.replace(mod.CONFIG, **fields, **parts)
    smoke = Smoke()
    try:
        phase_lm_moe(torch, smoke, torch.device("cpu"), "CPU rehearsal")
    finally:
        for name, cfg in saved.items():
            importlib.import_module(f"repro_torch.configs.{name}").CONFIG = cfg
    print(f"{len(smoke.failures)} check(s) failed", flush=True)
    return 1 if smoke.failures else 0


def lm_only(torch) -> int:
    """`--lm`: phases 15 and 16 alone (the kernels built first), with their checks;
    prints no result line. Exits 1 if a check failed."""
    from repro_torch import kernels
    from repro_torch.core.svm import state as svm_state
    from repro_torch.kernels import _build

    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    smoke = Smoke()
    t0 = time.perf_counter()
    phase_lm(torch, smoke, kernels, svm_state, lambda launched: None,
             torch.device("cuda", 0), card)
    torch.cuda.empty_cache()
    phase_lm_moe(torch, smoke, torch.device("cuda", 0), card)
    print(f"total {time.perf_counter() - t0:.1f} s; {len(smoke.failures)} check(s) failed",
          flush=True)
    for f in smoke.failures:
        print(f"  FAILED {f}", flush=True)
    return 1 if smoke.failures else 0


#: phase 17: the LM training path
TRAIN_ARCH, TRAIN_STEPS = "internlm2-1.8b", 10   # 17a (cut from 20, for the script's time)
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--log-every", "5"]
TRAIN_CPU_LAYERS = 2          # 17b's depth cut
TRAIN_CPU_SHAPE = (4, 64)     # 17b's batch and sequence
TRAIN_LOSS_TOL = 1e-5         # relative: a step's loss and metrics, the card against the CPU
TRAIN_GRAD_TOL = 1e-4         # x max|g|: 15c's and 16b's card-against-CPU bound
TRAIN_OPT_TOL = 1e-6          # x max: AdamW on identical gradients, the card against the CPU
TRAIN_RESTART_TOL = 1e-4      # JAX's restart-exactness bound (tests/test_fault_tolerance.py)
#: 17c: steps, a checkpoint every 5, the fault, and the stop resumed from
#: (cut from 20 steps, a checkpoint every 10 and the fault at 12)
SSM_TRAIN_STEPS, SSM_CKPT_EVERY, TRAIN_FAULT_AT, SSM_STOP = 12, 5, 8, 10
MOE_TRAIN_STEPS = 5           # 17d: mixtral-8x7b at full width, 1 layer
SMOKE_TRAIN_SHAPE = (4, 32)   # 17e's batch and sequence


def sync_recorder(torch):
    """A `TorchDispatchMode` that records each aten op during which the CUDA
    sync debug mode ("warn") warned, with whether autograd's backward ran
    it (built here, since its base class needs torch)."""
    import warnings

    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.hits = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = func(*args, **(kwargs or {}))
            if any("synchroniz" in str(w.message) for w in caught):
                in_backward = torch._C._current_graph_task_id() != -1
                self.hits.append((str(func), "backward" if in_backward else "forward"))
            return out

    return Recorder()


def step_syncs(torch, fn):
    """fn() under `torch.cuda.set_sync_debug_mode("warn")`: (its result, the
    ops that synchronized outside autograd's backward, those inside it,
    and the Python stacks of the sync warnings no op caught)."""
    import traceback
    import warnings

    torch.cuda.synchronize()
    rec = sync_recorder(torch)
    stray = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stray.append("".join(traceback.format_stack(limit=10)[:-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # setting the mode warns of itself
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            with rec:
                out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    forward = [op for op, where in rec.hits if where == "forward"]
    backward = [op for op, where in rec.hits if where == "backward"]
    return out, forward, backward, stray


def train_bound_ms(n_params: int, tokens: int, remat: bool) -> float:
    """The least time of a training step: 6 N FLOPs a token (8 N when the
    forward runs twice, under remat) at the card's bf16 peak."""
    return (8 if remat else 6) * n_params * tokens / peaks().PEAK_FLOPS * 1e3


def trained_run_text(torch, res, cfg, dev, n_tokens) -> str:
    """A launcher run's median step against the bound, and peak memory."""
    import statistics

    from repro_torch.utils import tree_size

    med = statistics.median(res.step_s) * 1e3
    bound = train_bound_ms(tree_size(res.params), n_tokens, cfg.remat)
    return (f"median step {med:.3f} ms (first {res.step_s[0] * 1e3:.3f} ms) = "
            f"{n_tokens / med * 1e3:.1f} tokens/s; bound {bound:.3f} ms = "
            f"{n_tokens / bound * 1e3:.1f} tokens/s ({8 if cfg.remat else 6} N FLOPs a "
            f"token at {peaks().PEAK_FLOPS / 1e12:.0f} TFLOP/s), "
            f"{bound / med:.4f} of it; {peak_text(torch, dev)}")


def quiet(fn):
    """(fn(), what it printed), printing nothing (a rank's output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def captured(fn):
    """(fn(), what it printed), the printed lines echoed indented."""
    out, text = quiet(fn)
    for line in text.strip().splitlines():
        print(f"      {line}", flush=True)
    return out, text


def tree_dev(torch, got, want) -> float:
    """max|got - want| over two trees of one structure (want's leaves on
    the CPU) in units of max|want|."""
    from repro_torch.utils import tree_leaves

    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    scale = max(w.abs().max().item() for _, w in pairs)
    return max((g.cpu().double() - w.double()).abs().max().item() for g, w in pairs) / scale


def phase_train(torch, smoke, kernels, svm_state, count, dev, card: str) -> None:
    """Phase 17: the LM training path. 17a `launch.train` at internlm2-1.8b's
    full width and depth in bf16 with remat, TRAIN_STEPS steps: a falling
    loss, one step under the sync debug mode, one step traced; 17f the
    feature-selection flow on its trained hidden states (the hinge
    kernels); 17b its float32 model at 2 layers, one step's loss, metrics
    and gradients and an AdamW update, the card against the CPU; 17c
    mamba2-130m whole through the launcher: a fault at step 8 survived,
    and a run stopped at step 10 resumed to the same loss; 17d
    mixtral-8x7b at full width, 1 layer, MOE_TRAIN_STEPS steps; 17e one
    float32 step of each SMOKE config, the card against the CPU. Runs on
    the CPU too (`rehearse_train`)."""
    import math
    import statistics
    import tempfile

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch, synthetic_numpy
    from repro_torch.launch import train as launcher
    from repro_torch.optim import adamw_init, constant_lr, warmup_cosine
    from repro_torch.optim.adamw import adamw_update, clip_by_global_norm
    from repro_torch.train.step import grads_and_metrics, make_train_step
    from repro_torch.utils import tree_bytes, tree_leaves, tree_map, tree_size

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"

    # -- 17a: internlm2-1.8b at full width and depth, bf16, remat -----------------
    cfg = get_config(TRAIN_ARCH)
    args = launcher._parser().parse_args(TRAIN_ARGV)
    n_tokens = args.batch * args.seq
    settle(torch, dev, reset_peak=True)
    print(f"[17a] python -m repro_torch.launch.train {' '.join(TRAIN_ARGV)} (bf16, remat "
          f"{cfg.remat_policy if cfg.remat else 'off'}; batch {args.batch}, seq {args.seq}, "
          f"lr {args.lr} warmup_cosine)", flush=True)
    res = launcher.train_config(cfg, args, dev)
    n_params = tree_size(res.params)
    text = trained_run_text(torch, res, cfg, dev, n_tokens)
    first, last = statistics.mean(res.losses[:5]), statistics.mean(res.losses[-5:])
    print(f"    {cfg.n_layers} layers, {n_params:,} parameters ({tree_bytes(res.params) / 1e9:.3f}"
          f" GB); losses {[round(x, 4) for x in res.losses]}; {text}; {card}", flush=True)
    smoke.check(len(res.losses) == TRAIN_STEPS and all(math.isfinite(x) for x in res.losses),
                f"17a: {TRAIN_STEPS} losses, every one finite")
    smoke.check(last < first, f"17a: the mean of the last 5 losses {last:.4f} < the first "
                f"5's {first:.4f}")
    MEASURED["17a"] = {"step_s": statistics.median(res.step_s)}
    step_fn = make_train_step(cfg, lr_schedule=warmup_cosine(args.lr, 10, TRAIN_STEPS))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    batch = synthetic_batch(dcfg, TRAIN_STEPS, device=dev)
    params, opt = res.params, res.opt_state
    del res
    if on_card:
        settle(torch, dev)
        out, fwd, bwd, stray = step_syncs(torch, lambda: step_fn(params, opt, batch))
        del out
        settle(torch, dev)
        from collections import Counter
        in_autograd = [w for w in stray if f"torch{os.sep}autograd" in w]
        ours = [w for w in stray if w not in in_autograd]
        print(f"    one step under the sync debug mode: synchronizing ops outside backward "
              f"{dict(Counter(fwd))}; inside PyTorch's backward (not gated) "
              f"{dict(Counter(bwd))}; warnings no op caught: {len(in_autograd)} from "
              f"autograd (not gated), {len(ours)} elsewhere", flush=True)
        for stack in stray:
            print("      a sync warning no op caught, at:\n" + stack, flush=True)
        smoke.check(not fwd and not ours,
                    "17a: a train step makes no synchronizing CUDA call from the port's own "
                    "code (forward, loss, clip, schedule, AdamW)")
        # one step traced: launches, device busy, idle share
        from torch.profiler import ProfilerActivity, profile
        out_dir = ROOT / "build" / "train-trace"
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / "step.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        del out
        prof.export_chrome_trace(str(path))
        del prof
        sp = trace_split(path, secs, 1)
        path.unlink()
        ops = ", ".join(f"{name} {k:.0f}" for name, k in list(sp["by_op"].items())[:12])
        print(f"    one step traced: wall {sp['wall_us'] / 1e3:.3f} ms = launch calls "
              f"{sp['launch_us'] / 1e3:.3f} ms ({sp['launch_calls']:.0f}) + reads "
              f"{sp['read_us'] / 1e3:.3f} + other host {sp['other_host_us'] / 1e3:.3f}; "
              f"device busy {sp['busy_us'] / 1e3:.3f} ms, idle share {sp['idle']:.3f}; "
              f"{sp['launches']:.0f} device launches a step: {ops}; {card}", flush=True)
        settle(torch, dev)

    # -- 17f: feature selection on the trained model's hidden states ---------------
    del opt
    settle(torch, dev)
    hidden_state_probe(torch, smoke, kernels, svm_state, count, params, cfg, dev, "17f",
                       f"the model trained {TRAIN_STEPS} steps (17a)", with_cd=False)
    del params, batch, step_fn
    settle(torch, dev)

    # -- 17b: the float32 model at 2 layers, the card against the CPU --------------
    cfg32 = f32_of(torch, cfg, n_layers=TRAIN_CPU_LAYERS)
    cpu_params = init_on_cpu(torch, cfg32)
    on_dev = tree_map(lambda t: t.to(dev), cpu_params)
    B, S = TRAIN_CPU_SHAPE
    data = synthetic_numpy(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B), 0)
    g_dev, m_dev = grads_and_metrics(on_dev, cfg32, {k: torch.from_numpy(v).to(dev)
                                                     for k, v in data.items()})
    t0 = time.perf_counter()
    g_cpu, m_cpu = grads_and_metrics(cpu_params, cfg32, {k: torch.from_numpy(v)
                                                         for k, v in data.items()})
    cpu_s = time.perf_counter() - t0
    loss_rel = max(abs(m_dev[k].item() - m_cpu[k].item()) / max(abs(m_cpu[k].item()), 1e-6)
                   for k in m_cpu)
    g_rel = tree_dev(torch, g_dev, g_cpu)
    del g_dev
    print(f"[17b] {TRAIN_ARCH} float32 at {TRAIN_CPU_LAYERS} layers, batch {B} x {S}: loss "
          f"{m_cpu['loss'].item():.6f}; metrics, the card against the CPU, {loss_rel:.3e} "
          f"relative; gradients {g_rel:.3e} x max|g| (CPU forward and backward {cpu_s:.2f} s)",
          flush=True)
    smoke.check(loss_rel <= TRAIN_LOSS_TOL, f"17b: loss and metrics on the card within "
                f"{TRAIN_LOSS_TOL} relative of the CPU's ({loss_rel:.3e})")
    smoke.check(g_rel <= TRAIN_GRAD_TOL, f"17b: every gradient on the card within "
                f"{TRAIN_GRAD_TOL} x max|g| of the CPU's ({g_rel:.3e} x)")
    # AdamW on the CPU's gradients, clipped on each side: the new parameters
    # and moments (the update itself printed, in units of its own max)
    lr = constant_lr(args.lr)
    upd = {}
    for where, params_w in (("card", on_dev), ("cpu", cpu_params)):
        grads_w = tree_map(lambda g: g.to(params_w["embed"]["table"].device), g_cpu)
        clipped, _ = clip_by_global_norm(grads_w, 1.0)
        state = adamw_init(params_w)
        new, st = adamw_update(clipped, state, params_w, lr=lr(state.count))
        upd[where] = (new, st.m, st.v, tree_map(lambda a, b: a - b, new, params_w))
    dev_opt = [tree_dev(torch, upd["card"][i], upd["cpu"][i]) for i in range(4)]
    differ = sum(int((a.cpu() != b).sum()) for a, b in zip(tree_leaves(upd["card"][0]),
                                                           tree_leaves(upd["cpu"][0])))
    print(f"    AdamW on the CPU's gradients (lr {args.lr}), the card against the CPU: "
          f"parameters {dev_opt[0]:.3e}, m {dev_opt[1]:.3e}, v {dev_opt[2]:.3e} x each's max; "
          f"{differ:,} of {tree_size(cpu_params):,} parameters differ; the update "
          f"{dev_opt[3]:.3e} x max|update| (not gated)", flush=True)
    smoke.check(max(dev_opt[:3]) <= TRAIN_OPT_TOL, f"17b: AdamW's new parameters and moments "
                f"on the card within {TRAIN_OPT_TOL} x of the CPU's ({max(dev_opt[:3]):.3e} x)")
    del on_dev, cpu_params, g_cpu, upd
    settle(torch, dev)

    # -- 17c: mamba2-130m whole through the launcher: a fault, a restart -----------
    base = ["--arch", SSM_ARCH, "--steps", str(SSM_TRAIN_STEPS), "--ckpt-every",
            str(SSM_CKPT_EVERY), "--log-every", "5"]
    if not on_card:
        base += ["--device", "cpu"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        faulted = base + ["--ckpt-dir", os.path.join(tmp, "a"), "--inject-fault-at",
                          str(TRAIN_FAULT_AT)]
        print(f"[17c] python -m repro_torch.launch.train {' '.join(faulted)}", flush=True)
        t0 = time.perf_counter()
        res_a, out_a = captured(lambda: launcher.train(faulted))
        a_s = time.perf_counter() - t0
        text_a = trained_run_text(torch, res_a, get_config(SSM_ARCH), dev, n_tokens)
        loss_a = res_a.loss
        del res_a
        cut = [a if a != str(SSM_TRAIN_STEPS) else str(SSM_STOP) for a in base] + [
            "--ckpt-dir", os.path.join(tmp, "b")]
        print(f"    then {' '.join(cut)}, and again with --steps {SSM_TRAIN_STEPS}",
              flush=True)
        _, out_b = captured(lambda: launcher.train(cut))
        res_c, out_c = captured(lambda: launcher.train(base + ["--ckpt-dir",
                                                               os.path.join(tmp, "b")]))
    gap = abs(res_c.loss - loss_a)
    print(f"    faulted run {a_s:.1f} s, {text_a}; resumed against faulted final loss "
          f"|d| = {gap:.3e} (bitwise equal: {gap == 0}); {card}", flush=True)
    smoke.check(f"[supervisor] step {TRAIN_FAULT_AT} failed (injected node failure); retry 1"
                in out_a and f"[train] done at step {SSM_TRAIN_STEPS}," in out_a,
                f"17c: the supervisor survived the fault at step {TRAIN_FAULT_AT} and the run "
                f"reached step {SSM_TRAIN_STEPS}")
    smoke.check(f"[train] done at step {SSM_STOP}," in out_b
                and f"[train] resumed from step {SSM_STOP}" in out_c
                and f"[train] done at step {SSM_TRAIN_STEPS}," in out_c,
                f"17c: a run stopped at step {SSM_STOP} resumed from its checkpoint")
    smoke.check(gap < TRAIN_RESTART_TOL, f"17c: the resumed run's final loss within "
                f"{TRAIN_RESTART_TOL} of the faulted run's ({gap:.3e})")
    del res_c
    settle(torch, dev, reset_peak=True)

    # -- 17d: mixtral-8x7b at full width, 1 layer, bf16 -----------------------------
    moe_cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=1)
    moe_args = launcher._parser().parse_args(["--arch", MOE_ARCH, "--steps",
                                              str(MOE_TRAIN_STEPS), "--log-every", "1"])
    print(f"[17d] {MOE_ARCH} at full width, 1 layer, bf16, {MOE_TRAIN_STEPS} steps through "
          "launch.train.train_config", flush=True)
    res = launcher.train_config(moe_cfg, moe_args, dev)
    aux = res.metrics["aux"].item()
    text = trained_run_text(torch, res, moe_cfg, dev, n_tokens)
    print(f"    {tree_size(res.params):,} parameters; losses "
          f"{[round(x, 4) for x in res.losses]}, last aux {aux:.4f}; {text}; {card}", flush=True)
    smoke.check(len(res.losses) == MOE_TRAIN_STEPS and all(math.isfinite(x) for x in res.losses)
                and math.isfinite(aux), f"17d: {MOE_TRAIN_STEPS} losses and the aux loss finite")
    del res
    settle(torch, dev)

    # -- 17e: every SMOKE config, one float32 step, the card against the CPU -------
    B, S = SMOKE_TRAIN_SHAPE
    worst_loss = worst_norm = 0.0
    for arch in ARCHS:
        c = get_config(arch, smoke=True)
        s_txt = S - c.vision_tokens if c.frontend == "patches" else S
        data = synthetic_numpy(DataConfig(
            vocab_size=c.vocab_size, seq_len=s_txt, global_batch=B,
            n_codebooks=c.n_codebooks if c.frontend == "codebooks" else 0,
            vision_tokens=c.vision_tokens if c.frontend == "patches" else 0,
            d_model=c.d_model), 0)
        p_cpu = init_on_cpu(torch, c)
        step = make_train_step(c, learning_rate=1e-3)
        out = {}
        for where in ("cpu", dev):
            pw = tree_map(lambda t: t.to(where), p_cpu)
            bw = {k: torch.from_numpy(v).to(where) for k, v in data.items()}
            out["cpu" if where == "cpu" else "card"] = step(pw, adamw_init(pw), bw)[2]
        rel = {k: abs(out["card"][k].item() - out["cpu"][k].item())
               / max(abs(out["cpu"][k].item()), 1e-6) for k in ("loss", "grad_norm")}
        worst_loss, worst_norm = max(worst_loss, rel["loss"]), max(worst_norm, rel["grad_norm"])
        smoke.check(rel["loss"] <= TRAIN_LOSS_TOL and rel["grad_norm"] <= TRAIN_GRAD_TOL,
                    f"17e: {c.name}: one step's loss ({rel['loss']:.2e}) within "
                    f"{TRAIN_LOSS_TOL} and grad_norm ({rel['grad_norm']:.2e}) within "
                    f"{TRAIN_GRAD_TOL} relative of the CPU's")
    print(f"    17e worst: loss {worst_loss:.3e}, grad_norm {worst_norm:.3e} relative",
          flush=True)
    print(f"    phase 17: {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)


def init_on_cpu(torch, cfg):
    """`cfg`'s parameters drawn on the CPU from a generator seeded 0."""
    from repro_torch.models import model as M

    return M.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")


def train_only(torch) -> int:
    """`--train`: phase 17 alone (the kernels built first), with its checks;
    prints no result line. Exits 1 if a check failed."""
    from repro_torch import kernels
    from repro_torch.core.svm import state as svm_state
    from repro_torch.kernels import _build

    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    smoke = Smoke()
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)       # the allocator's stats need the device set up
    t0 = time.perf_counter()
    phase_train(torch, smoke, kernels, svm_state, lambda launched: None, dev, card)
    print(f"total {time.perf_counter() - t0:.1f} s; {len(smoke.failures)} check(s) failed",
          flush=True)
    for f in smoke.failures:
        print(f"  FAILED {f}", flush=True)
    return 1 if smoke.failures else 0


#: `rehearse_train`'s reduced widths (each arch's depth and patterns kept)
TRAIN_REHEARSAL = {
    "internlm2_1_8b": dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                           vocab_size=4096),
    **{k: v for k, v in REHEARSAL.items() if k != "deepseek_v3_671b"},
}


def rehearse_train() -> int:
    """Phase 17 on the CPU at TRAIN_REHEARSAL's widths, for the figures a
    chip run is predicted against and to try the phase's logic where there
    is no card (the sync gate and the trace need one and are left out;
    `torch.cuda.synchronize` is stubbed; the hinge launch count of 17f
    fails there, since the CPU runs the plain passes):

        PYTHONPATH=src python3 -c "import chip_smoke; chip_smoke.rehearse_train()"

    Returns 1 if a check failed."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.svm import state as svm_state

    sys.path.insert(0, str(ROOT / "src"))
    saved = {}
    for name, fields in TRAIN_REHEARSAL.items():
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        saved[name] = mod.CONFIG
        parts = {k: getattr(mod.CONFIG, k)._replace(**v)
                 for k, v in REHEARSAL_PARTS.get(name, {}).items()}
        mod.CONFIG = dataclasses.replace(mod.CONFIG, **fields, **parts)
    smoke = Smoke()
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **k: None     # run_path's, for 17f
    try:
        phase_train(torch, smoke, kernels, svm_state, lambda launched: None,
                    torch.device("cpu"), "CPU rehearsal")
    finally:
        torch.cuda.synchronize = sync
        for name, cfg in saved.items():
            importlib.import_module(f"repro_torch.configs.{name}").CONFIG = cfg
    print(f"{len(smoke.failures)} check(s) failed", flush=True)
    return 1 if smoke.failures else 0


#: `--lm-trace ARCH`: the depth cuts of phase 16's full-width serving cells
LM_TRACE_CUTS = {MOE_ARCH: dict(n_layers=MOE_LAYERS),
                 MLA_ARCH: dict(n_layers=MLA_LAYERS, dense_prefix=1)}


def lm_trace_only(torch, arch: str = LM_ARCH) -> int:
    """`--lm-trace [ARCH]`: where a serving cell's time goes (internlm2-1.8b,
    15a's, unless ARCH names another; mixtral-8x7b and deepseek-v3 at
    phase 16's depth cuts), at full width in bf16, batch 4, prompt 64.
    Untraced, a prefill and decode steps (after warm-up), host clock
    ending in a synchronisation; then one prefill and
    LM_TRACE_STEPS decode steps under torch.profiler (CPU and CUDA
    activities), each split by `trace_split` (per prefill, per decode step):
    host time in launch calls and the rest, the device's busy time, its
    idle share, launches by op. Traced numbers compare only with traced
    numbers. Prints no result line."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import model as M
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    print(f"card: {nvidia_smi()}", flush=True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(arch), **LM_TRACE_CUTS.get(arch, {}))
    print(f"  {cfg.name}: {cfg.n_layers} layers", flush=True)
    params = M.init_model(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    batch = make_batch(cfg, LM_BATCH, LM_PROMPT, torch.Generator(dev).manual_seed(1), dev)
    steps = LM_TRACE_STEPS
    prefill = make_prefill_step(cfg, max_len=LM_PROMPT + 4 * steps + 4)
    decode = make_decode_step(cfg)

    def run_prefill():
        logits, caches = prefill(params, batch)
        return torch.argmax(logits, dim=-1), caches

    def run_decode(tok, caches):
        for _ in range(steps):
            logits, caches = decode(params, tok, caches)
            tok = torch.argmax(logits, dim=-1)
        return tok, caches

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (tok, caches), _ = timed(run_prefill)                    # first calls paid
    (tok, caches), _ = timed(run_decode, tok, caches)
    (tok, caches), pre_s = timed(run_prefill)
    (tok, caches), dec_s = timed(run_decode, tok, caches)
    print(f"  untraced: prefill {LM_BATCH} x {LM_PROMPT} {pre_s * 1e3:.3f} ms; decode "
          f"{dec_s / steps * 1e3:.3f} ms a step = {LM_BATCH * steps / dec_s:.1f} tok/s",
          flush=True)
    out_dir = ROOT / "build" / "lm-trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    for label, fn, n in (("prefill", run_prefill, 1),
                         ("decode", lambda: run_decode(tok, caches), steps)):
        path = out_dir / f"{label}.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            (tok, caches), secs = timed(fn)
        prof.export_chrome_trace(str(path))
        sp = trace_split(path, secs, n)
        path.unlink()
        del prof
        ops = ", ".join(f"{name} {k:.1f}" for name, k in list(sp["by_op"].items())[:12])
        print(f"  {label} traced, per {'call' if n == 1 else 'step'} ({n} traced): wall "
              f"{sp['wall_us']:.1f} us = launch calls {sp['launch_us']:.1f} "
              f"({sp['launch_calls']:.1f}) + reads {sp['read_us']:.1f} + other host "
              f"{sp['other_host_us']:.1f}; device busy {sp['busy_us']:.1f} us, idle share "
              f"{sp['idle']:.3f}; {sp['launches']:.1f} device launches: {ops}", flush=True)
    return 0


#: phase 18: data-parallel training over ranks, all on the one card (gloo)
DIST_WORLD = 2
DIST_STEPS = 1                # 18a: steps of the sharded step at full width and depth
#                               (cut from 6 to 2, then to 1, for the script's time)
                              # (cut from 6 for the script's time: ~10 s a step)
DIST_SHAPE = (8, 128)         # 18a: the global batch (4 rows a rank) and sequence
DIST_LOSS_TOL = 1e-3          # relative: 18a's first loss against the one-rank step's
DIST_B_SHAPE = (4, 64)        # 18b: the float32 parity cells' batch and sequence
DIST_C_STEPS, DIST_C_FAULT, DIST_C_EVERY = 12, 8, 5   # 18c: the launcher on 2 ranks
PIPE_SHAPE = (2048, 8, 512)   # 18d: d, microbatches M, rows a microbatch (float32)
PIPE_TOL = 1e-6               # x max|out|: 18d against sequential_reference
TOPK_FRAC = 0.01              # 18e

#: phase 19: the sharded step with FSDP and the "model" axis executed, on
#: gloo ranks on the one card. 19a and 19b run in phase 18's 2 ranks;
#: 19c in 4 ranks of its own. Each: (data, model), microbatches, steps
TP_A = ((1, 2), 2, 2)         # 19a: internlm2-1.8b whole, tensor parallel
TP_B = ((2, 1), 1, 1)         # 19b: internlm2-1.8b whole, FSDP (rules {"fsdp": "data"});
#                               1 step (cut from 2 for the script's time)
TP_C = ((2, 2), 1, 1)         # 19c: mixtral-8x7b's full width, both axes
TP_C_LAYERS = 2               # 19c's depth cut (32 layers: 93 GB in bf16)


def bit_sums(torch, tree):
    """Per leaf, the sum of its bits and of their squares (int64): a
    checksum two ranks' trees are compared by."""
    from repro_torch.utils import tree_leaves

    sums = []
    for x in tree_leaves(tree):
        b = x.contiguous().view(torch.int16 if x.element_size() == 2 else torch.int32)
        b = b.to(torch.int32)
        sums += [torch.sum(b, dtype=torch.int64), torch.sum(b * b, dtype=torch.int64)]
    return torch.stack(sums)


def dist_rank(mesh, cfg, cfg_b, cfg_moe, argv_c, ckpt_dir, pipe_shape, tp_subs=()):
    """Phase 18's work on one rank of `mesh` (every rank runs it alike):
    18a the sharded step at `cfg`'s full width, 18b float32 parity at
    `cfg_b` and `cfg_moe`, 18c the launcher (`argv_c`, checkpoints in
    `ckpt_dir`) and its step-10 checkpoint resumed on these ranks, 18d the
    pipeline; then phase 19's sub-phases `tp_subs` ((label, `tp_rank`'s
    arguments)) on the same ranks; returns rank 0's results with what the
    ranks must agree on gathered (CPU tensors)."""
    import shutil

    import torch

    from repro_torch import dist
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.dist import pipeline as pipe
    from repro_torch.dist import shardings as dsh
    from repro_torch.dist.zero import zero1_shardings
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import adamw_init, warmup_cosine
    from repro_torch.optim.adamw import AdamWState, adamw_update, clip_by_global_norm
    from repro_torch.train.step import grads_and_metrics, make_train_step, zero1_update
    from repro_torch.utils import tree_leaves, tree_map

    dev = mesh.device
    on_card = dev.type == "cuda"
    lmesh = make_local_mesh()
    out = {"size": mesh.size, "backend": mesh.backend, "device": str(dev)}

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def per_rank(v):           # each rank's number, in rank order
        return dist.gather(mesh, torch.tensor([float(v)], dtype=torch.float64,
                                              device=dev)).tolist()

    reset_counts = dist.reset_counts

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def zero_blocks(records):
        return tree_map(lambda r: torch.zeros(dsh.block_shape(r), dtype=torch.float32,
                                              device=dev), records)

    # -- 18a: the sharded step (dryrun.py:191-201's), run ------------------------
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    B, S = DIST_SHAPE
    t0 = time.perf_counter()
    params = M.init_model(cfg, generator=gen(), device=dev)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    with dist.mesh_context(lmesh, rules={**dist.DEFAULT_RULES, **cfg.rules_override}):
        p_sh = dsh.params_shardings(params, cfg)
        m_sh = zero1_shardings(p_sh, params)
        count = torch.zeros((), dtype=torch.int32, device=dev)
        opt = AdamWState(m=zero_blocks(m_sh), v=zero_blocks(m_sh), count=count)
        o_sh = AdamWState(m=m_sh, v=m_sh, count=dsh.replicated(count))
        b_sh = dsh.batch_shardings(synthetic_batch(dcfg, 0, device=dev))
        step = make_train_step(cfg, lr_schedule=warmup_cosine(3e-4, 10, DIST_STEPS),
                               grad_shardings=p_sh)
        sync()
        out["18a_init_s"] = time.perf_counter() - t0
        steps = []
        for i in range(DIST_STEPS):
            batch = synthetic_batch(dcfg, i, device=dev)
            sync()
            dist.all_reduce(mesh, torch.zeros(1, device=dev))       # start together
            reset_counts()
            traced = i == DIST_STEPS - 1 and on_card and mesh.rank == 0
            if traced:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            params, opt, metrics = dsh.run_sharded(step, (p_sh, o_sh, b_sh), params, opt,
                                                   batch)
            loss = float(metrics["loss"])
            sync()
            secs = time.perf_counter() - t0
            steps.append(dict(loss=loss, secs=secs, calls=dist.all_reduce.calls,
                              bytes=dist.all_reduce.bytes, ar_s=dist.all_reduce.seconds,
                              bc_calls=dist.broadcast.calls, bc_bytes=dist.broadcast.bytes,
                              bc_s=dist.broadcast.seconds))
            if traced:
                prof.__exit__(None, None, None)
                path = ROOT / "build" / "dist-trace" / "step.json"
                path.parent.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(path))
                del prof
                out["18a_trace"] = trace_split(path, secs, 1)
                path.unlink()
        out["18a_steps"] = steps
        out["18a_losses"] = dist.gather(mesh, torch.tensor(
            [s["loss"] for s in steps], dtype=torch.float64, device=dev)[None]).tolist()
        out["18a_sums"] = dist.gather(mesh, bit_sums(torch, params)[None]).tolist()
        held = sum(x.numel() * x.element_size() for x in tree_leaves((opt.m, opt.v)))
        full = 2 * 4 * sum(x.numel() for x in tree_leaves(params))
        whole = 2 * 4 * sum(x.numel() for x, r in zip(tree_leaves(params), tree_leaves(m_sh))
                            if not r.uses("data"))
        out["18a_moments"] = dict(held=per_rank(held), full=full, replicated=whole,
                                  stacked=sum(r.stack == "data" for r in tree_leaves(m_sh)),
                                  leaves=len(tree_leaves(m_sh)))
        out["18a_params"] = sum(x.numel() for x in tree_leaves(params))
        # the gradient all-reduce alone: a tree of the gradients' shapes and dtypes
        grads_like = tree_map(torch.zeros_like, params)
        sync()
        dist.all_reduce(mesh, torch.zeros(1, device=dev))
        reset_counts()
        t0 = time.perf_counter()
        reduced = tree_map(lambda g: dist.all_reduce(mesh, g), grads_like)
        sync()
        out["18a_grad_ar"] = dict(secs=per_rank(time.perf_counter() - t0),
                                  bytes=dist.all_reduce.bytes, calls=dist.all_reduce.calls)
        del grads_like, reduced
        out["18a_peak"] = per_rank(torch.cuda.max_memory_allocated(dev) if on_card else 0)
    if mesh.rank == 0:         # shown even if a later part fails
        print(f"    rank 0: 18a done: step s {[round(s['secs'], 3) for s in steps]}, losses "
              f"{[round(s['loss'], 6) for s in steps]}, peak {out['18a_peak']}", flush=True)
    del params, opt, metrics, step, p_sh, m_sh, o_sh
    if on_card:
        torch.cuda.empty_cache()

    # -- 18b: float32 parity, 2 ranks against one -----------------------------------
    B2, S2 = DIST_B_SHAPE
    for label, c in (("dense", cfg_b), ("moe", cfg_moe)):
        params = M.init_model(c, generator=gen(), device=dev)
        batch = synthetic_batch(DataConfig(vocab_size=c.vocab_size, seq_len=S2,
                                           global_batch=B2), 0, device=dev)
        seen, route = [], moe_mod.route

        def record(p, x, cfg_, route=route, seen=seen):
            res = route(p, x, cfg_)
            seen.append(res[2].detach().clone())
            return res

        moe_mod.route = record
        try:
            g1, m1 = grads_and_metrics(params, c, batch)
            n1 = len(seen)
            with dist.mesh_context(lmesh, rules={**dist.DEFAULT_RULES, **c.rules_override}):
                g2, m2 = grads_and_metrics(params, c, batch)
        finally:
            moe_mod.route = route
        rows = B2 // mesh.size
        n_moe = sum(c.layer_spec(i)[1] == "moe" for i in range(c.n_layers))
        same = all(torch.equal(a[mesh.rank * rows:(mesh.rank + 1) * rows], b)
                   for a, b in zip(seen[:n_moe], seen[n1:n1 + n_moe]))
        scale = max(g.abs().max().item() for g in tree_leaves(g1))
        g_dev = max(torch.sub(a, b).abs_().max().item() for a, b in zip(tree_leaves(g2),
                                                                        tree_leaves(g1))) / scale
        rel = {k: abs(m2[k].item() - m1[k].item()) / max(abs(m1[k].item()), 1e-6) for k in m1}
        res = dict(g_dev=g_dev, rel=rel, loss=m1["loss"].item(), aux=m1["aux"].item(),
                   choices_equal=per_rank(same), moe_layers=n_moe)
        if label == "dense":
            # ZeRO-1 on identical (all-reduced) gradients: bitwise the replicated update
            with dist.mesh_context(lmesh, rules={**dist.DEFAULT_RULES, **c.rules_override}):
                p_sh = dsh.params_shardings(params, c)
                m_sh = zero1_shardings(p_sh, params)
            clipped, _ = clip_by_global_norm(g2, 1.0)
            rep_p, rep_o = adamw_update(clipped, adamw_init(params), params, lr=3e-4)
            state = AdamWState(m=zero_blocks(m_sh), v=zero_blocks(m_sh),
                               count=torch.zeros((), dtype=torch.int32, device=dev))
            z_p, z_o = zero1_update(clipped, state, params, m_sh, 3e-4)
            res["zero_params_equal"] = per_rank(all(
                torch.equal(a, b) for a, b in zip(tree_leaves(z_p), tree_leaves(rep_p))))
            res["zero_moments_equal"] = per_rank(all(
                torch.equal(a, b) for a, b in zip(tree_leaves((z_o.m, z_o.v)), tree_leaves(
                    dsh.place((rep_o.m, rep_o.v), (m_sh, m_sh))))))
            del rep_p, rep_o, z_p, z_o, state
        out[f"18b_{label}"] = res
        if mesh.rank == 0:
            print(f"    rank 0: 18b {label} done: gradients {g_dev:.3e} x", flush=True)
        del params, g1, g2, seen
        if on_card:
            torch.cuda.empty_cache()

    # -- 18c: the launcher on the ranks: a fault, checkpoints -----------------------
    t0 = time.perf_counter()
    res, text = quiet(lambda: launcher.train(mesh, argv_c + ["--ckpt-dir", ckpt_dir]))
    out["18c"] = dict(losses=res.losses, step=res.step, text=text, step_s=res.step_s,
                      secs=time.perf_counter() - t0,
                      final=per_rank(res.loss))
    del res
    # the step-10 checkpoint resumed on the same ranks that wrote it
    again = ckpt_dir + "-again"
    if mesh.rank == 0:
        os.makedirs(again)
        shutil.copytree(os.path.join(ckpt_dir, "step_00000010"),
                        os.path.join(again, "step_00000010"))
    dist.all_reduce(mesh, torch.zeros(1, device=dev))
    i = argv_c.index("--inject-fault-at")
    argv_r = argv_c[:i] + argv_c[i + 2:]
    res, text = quiet(lambda: launcher.train(mesh, argv_r + ["--ckpt-dir", again]))
    out["18c_again"] = dict(losses=res.losses, text=text, final=per_rank(res.loss))
    del res
    if on_card:
        torch.cuda.empty_cache()

    # -- 18d: the pipeline on a ("pipe",) mesh of the ranks -------------------------
    d, n_mb, bm = pipe_shape
    g = gen()
    w = {"w": torch.randn((mesh.size, d, d), generator=g, device=dev) * d ** -0.5,
         "b": torch.randn((mesh.size, d), generator=g, device=dev) * 0.1}
    x = torch.randn((n_mb, bm, d), generator=g, device=dev)

    def stage(p, v):
        return torch.tanh(v @ p["w"]) + p["b"]

    pmesh = dist.data_mesh(axis_name="pipe")
    pipe.pipeline_apply(pmesh, stage, w, x)               # warm-up
    sync()
    dist.all_reduce(mesh, torch.zeros(1, device=dev))
    reset_counts()
    t0 = time.perf_counter()
    got = pipe.pipeline_apply(pmesh, stage, w, x)
    sync()
    secs = time.perf_counter() - t0
    calls = dist.all_reduce.calls
    t0 = time.perf_counter()
    ref = pipe.sequential_reference(stage, w, x)
    sync()
    ref_s = time.perf_counter() - t0
    # the reference a microbatch at a time runs the pipeline's GEMM shapes;
    # on the whole (M * Bm, d) batch cuBLAS sums in another order
    each = torch.cat([pipe.sequential_reference(stage, w, x[m:m + 1]) for m in range(n_mb)])
    scale = each.abs().max().item()
    out["18d"] = dict(dev=(got - each).abs().max().item() / scale,
                      dev_whole=(got - ref).abs().max().item() / scale,
                      secs=secs, calls=calls, ref_s=ref_s,
                      shape=tuple(got.shape), stages=pmesh.shape["pipe"])
    del w, x, got, ref, each
    if on_card:
        torch.cuda.empty_cache()
    out.update(tp_ranks(mesh, tp_subs))
    return out


def phase_dist(torch, smoke, dev, card: str, cfgs=None, argv_c=None,
               pipe_shape=PIPE_SHAPE, cfg_c=None) -> None:
    """Phase 18: data-parallel training over DIST_WORLD ranks on this card
    over gloo (`dist.launch`), as phase 13 runs them. 18a the sharded train
    step of dryrun.py:191-201 (parameters by `params_shardings`, moments by
    `zero1_shardings`, `grad_shardings = p_sh`) at internlm2-1.8b's full
    width and depth, against the one-rank step's first loss; 18b float32
    parity (2 layers; mixtral at 1 layer); 18c the launcher on the ranks
    through a fault, its step-10 checkpoint resumed on one rank; 18d
    `pipeline_apply`; 18e `compress` on the card against the CPU. Then
    phase 19 (`phase_tp`): 19a and 19b in the same ranks, 19c in 4 of its
    own. `cfgs`, `argv_c` and `cfg_c` replace the configs and the
    launcher's flags (`rehearse_dist`)."""
    import shutil
    import statistics
    import tempfile

    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.dist import compress as C
    from repro_torch.launch import train as launcher
    from repro_torch.models import model as M
    from repro_torch.train.step import grads_and_metrics
    from repro_torch.utils import tree_bytes, tree_size

    import math

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    if cfgs is None:
        cfg = get_config(TRAIN_ARCH)
        cfgs = (cfg, f32_of(torch, cfg, n_layers=TRAIN_CPU_LAYERS),
                ample_capacity(f32_of(torch, get_config(MOE_ARCH), n_layers=1)))
    cfg, cfg_b, cfg_moe = cfgs
    if argv_c is None:
        argv_c = ["--arch", SSM_ARCH, "--steps", str(DIST_C_STEPS), "--ckpt-every",
                  str(DIST_C_EVERY), "--log-every", "5"] + ([] if on_card else
                                                            ["--device", "cpu"])
    B, S = DIST_SHAPE

    # the one-rank step's loss on 18a's weights and first batch, and its
    # embedding gradient (18e); freed before the ranks start
    settle(torch, dev, reset_peak=True)
    t0 = time.perf_counter()
    params = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    n_params, p_bytes = tree_size(params), tree_bytes(params)
    batch = synthetic_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B),
                            0, device=dev)
    grads, metrics = grads_and_metrics(params, cfg, batch)
    loss1 = metrics["loss"].item()
    emb = grads["embed"]["table"].float()
    one_s = time.perf_counter() - t0
    print(f"[18] {DIST_WORLD} ranks on this card over gloo (`dist.launch`); the one-rank "
          f"reference first: {cfg.name} ({cfg.n_layers} layers, {n_params:,} parameters, "
          f"{p_bytes / 1e9:.3f} GB), loss {loss1:.6f} on the global batch {B} x {S} "
          f"({one_s:.1f} s with init; {peak_text(torch, dev)})", flush=True)
    del params, grads, metrics, batch
    settle(torch, dev)
    # each rank: parameters and gradients whole, its half of m and v (float32)
    state = 2 * p_bytes + 4 * n_params
    print(f"    reckoned a rank: parameters + gradients + half of m and v = "
          f"{state / 1e9:.1f} GB, and {p_bytes / 1e9:.1f} GB of new parameters and "
          f"{4 * n_params / 1e9:.1f} GB of new moment blocks while the update holds both: "
          f"{(state + p_bytes + 4 * n_params) / 1e9:.1f} GB before activations, "
          f"{2 * (state + p_bytes + 4 * n_params) / 1e9:.1f} GB for the two", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-dist-") as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        res = dist.launch(dist_rank, DIST_WORLD,
                          args=(cfg, cfg_b, cfg_moe, argv_c + ["--inject-fault-at",
                                                               str(DIST_C_FAULT)],
                                ckpt, pipe_shape, tp_subs(cfg)),
                          device=dev.type, timeout=1000, threads=0 if on_card else 2)
        ranks_s = time.perf_counter() - t0
        print(f"    ranks: {ranks_s:.1f} s from spawn to rank 0's result; backend "
              f"{res['backend']}, device {res['device']}", flush=True)

        # 18a
        steps = res["18a_steps"]
        losses = res["18a_losses"]
        step_ms = [s["secs"] * 1e3 for s in steps]
        med = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
        mo = res["18a_moments"]
        gar = res["18a_grad_ar"]
        print(f"[18a] the sharded step at {cfg.name}'s full width and depth, bf16, remat "
              f"{cfg.remat_policy if cfg.remat else 'off'}: global batch {B} x {S} "
              f"({B // DIST_WORLD} rows a rank), lr 3e-4 warmup_cosine, {DIST_STEPS} steps; "
              f"init {res['18a_init_s']:.1f} s", flush=True)
        print(f"    losses rank 0 {[round(x, 6) for x in losses[0]]}, rank 1 "
              f"{[round(x, 6) for x in losses[1]]}; one rank's first {loss1:.6f}", flush=True)
        print(f"    step ms {[round(x, 1) for x in step_ms]} (median after the first "
              f"{med:.1f}); all-reduces a step {[s['calls'] for s in steps]}, "
              f"{steps[-1]['bytes'] / 1e9:.3f} GB, {[round(s['ar_s'], 3) for s in steps]} s "
              f"in them (host clock); broadcasts a step {[s['bc_calls'] for s in steps]} (the "
              f"ZeRO-1 gather of the stacked leaves from their owners), "
              f"{steps[-1]['bc_bytes'] / 1e9:.3f} GB, {[round(s['bc_s'], 3) for s in steps]} s; "
              f"the gradient all-reduce alone "
              f"{gar['bytes'] / 1e9:.3f} GB in {gar['calls']} calls, "
              f"{[round(x, 3) for x in gar['secs']]} s ({gar['secs'][0] * 1e9 / gar['bytes']:.3f}"
              f" ns a byte); {card}", flush=True)
        print(f"    m and v: rank 0 holds {mo['held'][0] / 1e9:.3f} GB, rank 1 "
              f"{mo['held'][1] / 1e9:.3f} GB of {mo['full'] / 1e9:.3f} GB "
              f"({mo['replicated'] / 1e9:.6f} GB in leaves 2 divides no dim of); "
              f"{mo['stacked']} of {mo['leaves']} moment records split on the stacked layer "
              f"dim; peak {[round(x / 1e9, 2) for x in res['18a_peak']]} GB allocated a rank",
              flush=True)
        if "18a_trace" in res:
            sp = res["18a_trace"]
            print(f"    rank 0's last step traced: wall {sp['wall_us'] / 1e3:.1f} ms, "
                  f"{sp['launches']:.0f} device launches, device busy "
                  f"{sp['busy_us'] / 1e3:.1f} ms, idle share {sp['idle']:.3f}", flush=True)
        smoke.check(all(math.isfinite(x) for x in losses[0]) and losses[0] == losses[1],
                    f"18a: {DIST_STEPS} losses finite and the same on both ranks")
        sums = res["18a_sums"]
        smoke.check(sums[0] == sums[1], f"18a: after step {DIST_STEPS} the parameters on "
                    f"both ranks are bitwise equal ({len(sums[0]) // 2} leaves' checksums)")
        want = (mo["full"] - mo["replicated"]) / DIST_WORLD + mo["replicated"]
        smoke.check(all(h == want for h in mo["held"]), f"18a: each rank holds "
                    f"{want / 1e9:.3f} GB of m and v: half of one rank's "
                    f"{mo['full'] / 1e9:.3f} GB but the leaves 2 divides no dim of")
        rel = abs(losses[0][0] - loss1) / abs(loss1)
        smoke.check(rel <= DIST_LOSS_TOL, f"18a: the first loss {losses[0][0]:.6f} within "
                    f"{DIST_LOSS_TOL} relative of the one-rank step's {loss1:.6f} ({rel:.2e})")

        # 18b
        B2, S2 = DIST_B_SHAPE
        for label, c in (("dense", cfg_b), ("moe", cfg_moe)):
            r = res[f"18b_{label}"]
            worst = max(r["rel"].values())
            print(f"[18b] {c.name} float32, {c.n_layers} layer(s), batch {B2} x {S2}: 2 ranks "
                  f"against one: gradients {r['g_dev']:.3e} x max|g|, metrics "
                  f"{ {k: f'{v:.2e}' for k, v in r['rel'].items()} } relative (loss "
                  f"{r['loss']:.6f}, aux {r['aux']:.6f})", flush=True)
            smoke.check(r["g_dev"] <= TRAIN_GRAD_TOL and worst <= TRAIN_LOSS_TOL,
                        f"18b {label}: the 2-rank gradients within {TRAIN_GRAD_TOL} x max|g| "
                        f"({r['g_dev']:.2e}) and metrics within {TRAIN_LOSS_TOL} relative "
                        f"({worst:.2e}) of one rank's")
            if r["moe_layers"]:
                smoke.check(all(r["choices_equal"]), f"18b {label}: each rank's chosen "
                            f"experts equal one rank's on its rows ({r['choices_equal']})")
            if label == "dense":
                smoke.check(all(r["zero_params_equal"]) and all(r["zero_moments_equal"]),
                            "18b: the ZeRO-1 update on identical gradients is bitwise the "
                            "replicated update (parameters, and each rank's m and v blocks)")

        # 18c, and the step-10 checkpoint resumed on one rank
        rc = res["18c"]
        print(f"[18c] dist.launch(train.train, {DIST_WORLD}, args=(argv,)), argv "
              f"{' '.join(argv_c)} --inject-fault-at {DIST_C_FAULT}: {rc['secs']:.1f} s, "
              f"median step {statistics.median(rc['step_s']) * 1e3:.1f} ms; rank 0 "
              "printed:", flush=True)
        for line in rc["text"].strip().splitlines():
            print(f"      {line}", flush=True)
        smoke.check(f"[supervisor] step {DIST_C_FAULT} failed (injected node failure); "
                    "retry 1" in rc["text"] and f"[train] done at step {DIST_C_STEPS},"
                    in rc["text"] and rc["final"][0] == rc["final"][1],
                    f"18c: the supervisor's line, the run done at step {DIST_C_STEPS}, the "
                    "same final loss on both ranks")
        one = os.path.join(tmp, "one")
        os.makedirs(one)
        shutil.copytree(os.path.join(ckpt, "step_00000010"), os.path.join(one,
                                                                          "step_00000010"))
        r1, text1 = quiet(lambda: launcher.train(argv_c + ["--ckpt-dir", one]))
        gaps = [abs(a - b) for a, b in zip(r1.losses, rc["losses"][-2:])]
        print(f"    the step-10 checkpoint on one rank: losses {r1.losses} against the 2 "
              f"ranks' {rc['losses'][-2:]}: |d| {[f'{g:.2e}' for g in gaps]} (the first on "
              "the restored state; the second after an update from bf16 gradients summed "
              "in another order, which AdamW's early steps turn into +-lr moves where a "
              "gradient is near 0: printed, not gated)", flush=True)
        smoke.check("[train] resumed from step 10" in text1 and len(gaps) == 2
                    and gaps[0] < TRAIN_RESTART_TOL, f"18c: the 2-rank checkpoint at step "
                    f"10 resumed on one rank: its loss there within {TRAIN_RESTART_TOL} of "
                    "the 2 ranks'")
        del r1
        ra = res["18c_again"]
        gaps2 = [abs(a - b) for a, b in zip(ra["losses"], rc["losses"][-2:])]
        print(f"    the step-10 checkpoint on the same {DIST_WORLD} ranks that wrote it: losses "
              f"{ra['losses']}: |d| {[f'{g:.2e}' for g in gaps2]}", flush=True)
        smoke.check("[train] resumed from step 10" in ra["text"] and len(gaps2) == 2
                    and max(gaps2) < TRAIN_RESTART_TOL and ra["final"][0] == ra["final"][1],
                    f"18c: the 2-rank checkpoint at step 10 resumed on the same 2 ranks: both "
                    f"losses within {TRAIN_RESTART_TOL} of the faulted run's, the ranks equal")

    # 18d
    rd = res["18d"]
    d, n_mb, bm = pipe_shape
    ticks = rd["calls"] - 1
    print(f"[18d] pipeline_apply on a ('pipe',) mesh of {rd['stages']} ranks, tanh(x @ w) + b "
          f"at d = {d}, M = {n_mb} microbatches of {bm} rows, float32: {rd['secs']:.4f} s, "
          f"{ticks} ticks ({rd['secs'] / max(ticks, 1) * 1e3:.2f} ms a tick), bubble "
          f"(S - 1) / (M + S - 1) = {(rd['stages'] - 1) / (n_mb + rd['stages'] - 1):.3f}; "
          f"sequential_reference on one rank {rd['ref_s']:.4f} s; max|out - ref| = "
          f"{rd['dev']:.3e} x max|out| against the reference a microbatch at a time, "
          f"{rd['dev_whole']:.3e} x on the whole batch at once (not gated: other GEMM "
          "shapes, another summation order)", flush=True)
    smoke.check(rd["dev"] <= PIPE_TOL and ticks == n_mb + rd["stages"] - 1,
                f"18d: within {PIPE_TOL} x max|out| of sequential_reference a microbatch at "
                f"a time, M + S - 1 = {n_mb + rd['stages'] - 1} ticks ({ticks})")

    # 18e: compress on the card against the CPU
    g_dev = emb
    g_cpu = emb.cpu()
    bitwise = []
    for name, x_dev, x_cpu in (("gradient", g_dev, g_cpu), ("gradient / 3", g_dev / 3,
                                                             g_cpu / 3)):
        w_dev = C.bf16_decompress(C.bf16_compress({"g": x_dev}), {"g": x_dev})["g"]
        w_cpu = C.bf16_decompress(C.bf16_compress({"g": x_cpu}), {"g": x_cpu})["g"]
        bitwise.append(torch.equal(w_dev.cpu(), w_cpu))
    t0 = time.perf_counter()
    v_d, i_d, r_d = C.topk_compress({"g": g_dev}, C.topk_init({"g": g_dev}), frac=TOPK_FRAC)
    if on_card:
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_c, i_c, r_c = C.topk_compress({"g": g_cpu}, C.topk_init({"g": g_cpu}), frac=TOPK_FRAC)
    cpu_s = time.perf_counter() - t0
    i_d, v_d, r_d = i_d["g"].cpu(), v_d["g"].cpu(), r_d["g"].cpu()
    i_c, v_c, r_c = i_c["g"], v_c["g"], r_c["g"]
    flat = g_cpu.reshape(-1)
    only_d, only_c = i_d[~torch.isin(i_d, i_c)], i_c[~torch.isin(i_c, i_d)]
    kth = v_c.abs().min()
    ties = bool((flat[only_d].abs() == kth).all() and (flat[only_c].abs() == kth).all())
    sd, od = torch.sort(i_d)
    sc, oc = torch.sort(i_c)
    same_pairs = torch.equal(sd, sc) and torch.equal(v_d[od], v_c[oc])
    differ = (r_d != r_c).reshape(-1).nonzero().reshape(-1)
    res_ok = bool(torch.isin(differ, torch.cat([only_d, only_c])).all())
    print(f"[18e] compress on {cfg.name}'s embedding gradient ({flat.numel():,} entries, "
          f"the one-rank step's, float32), the card against the CPU: bf16 round trip bitwise "
          f"{bitwise} (the gradient, bf16-valued, and a third of it); top-k frac {TOPK_FRAC}: "
          f"k = {i_c.numel():,}, card {card_s:.3f} s, CPU {cpu_s:.3f} s; (index, value) pairs "
          f"equal {same_pairs}; {only_d.numel()} pairs only on the card and {only_c.numel()} "
          f"only on the CPU, all at the k-th magnitude {kth.item():.6e} (ties): {ties}; "
          f"residual entries apart {differ.numel()}", flush=True)
    for idx in only_d[:8].tolist():
        print(f"      card only: index {idx}, value {flat[idx].item():.6e}", flush=True)
    for idx in only_c[:8].tolist():
        print(f"      CPU only: index {idx}, value {flat[idx].item():.6e}", flush=True)
    smoke.check(all(bitwise), "18e: the bf16 round trip on the card is bitwise the CPU's")
    smoke.check(same_pairs or (ties and res_ok), "18e: the top-k (index, value) pairs and "
                "the residual equal the CPU's, or differ only at ties")
    del emb, g_dev, g_cpu, v_d, i_d, r_d, v_c, i_c, r_c, flat
    settle(torch, dev)
    print(f"    phase 18: {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    print("[19] the sharded step with FSDP and the \"model\" axis executed: internlm2-1.8b "
          "whole on (1, 2) and (2, 1), mixtral-8x7b's full width on (2, 2)", flush=True)
    phase_tp(torch, smoke, dev, card, res, loss1, cfg_c)


def dist_only(torch) -> int:
    """`--dist`: phases 18 and 19 alone, with their checks; prints no
    result line. Exits 1 if a check failed."""
    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke()
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)       # the allocator's stats need the device set up
    t0 = time.perf_counter()
    phase_dist(torch, smoke, dev, card)
    print(f"total {time.perf_counter() - t0:.1f} s; {len(smoke.failures)} check(s) failed",
          flush=True)
    for f in smoke.failures:
        print(f"  FAILED {f}", flush=True)
    return 1 if smoke.failures else 0


def rehearse_dist() -> int:
    """Phase 18 on the CPU at TRAIN_REHEARSAL's widths (2 layers for 18a,
    mamba2-130m's SMOKE config for 18c, d = 256 for 18d), to try the
    phase's logic where there is no card:

        PYTHONPATH=src python3 -c "import chip_smoke; chip_smoke.rehearse_dist()"

    Returns 1 if a check failed."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config

    small = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2,
                                **TRAIN_REHEARSAL["internlm2_1_8b"])
    moe = get_config(MOE_ARCH)
    moe = dataclasses.replace(moe, n_layers=1, d_model=256, n_heads=4, n_kv_heads=2,
                              head_dim=64, vocab_size=4096,
                              moe=moe.moe._replace(d_ff_expert=512))
    cfgs = (small, f32_of(torch, small), ample_capacity(f32_of(torch, moe)))
    argv_c = ["--arch", SSM_ARCH, "--smoke", "--device", "cpu", "--batch", "4", "--seq", "64",
              "--steps", str(DIST_C_STEPS), "--ckpt-every", str(DIST_C_EVERY),
              "--log-every", "5"]
    smoke = Smoke()
    phase_dist(torch, smoke, torch.device("cpu"), "CPU rehearsal", cfgs=cfgs, argv_c=argv_c,
               pipe_shape=(256, 8, 16), cfg_c=_rehearsal_moe(get_config))
    print(f"{len(smoke.failures)} check(s) failed", flush=True)
    return 1 if smoke.failures else 0


def _rehearsal_moe(get_config):
    """19c's config cut for the CPU: mixtral-8x7b's rules and layout at
    d_model 256, 2 layers, experts of d_ff 512, vocab 4096."""
    moe = get_config(MOE_ARCH)
    return dataclasses.replace(moe, n_layers=TP_C_LAYERS, d_model=256, n_heads=4,
                               n_kv_heads=2, head_dim=64, vocab_size=4096,
                               moe=moe.moe._replace(d_ff_expert=512))


def tp_only(torch, dev=None, cfg=None, cfg_c=None, card=None) -> int:
    """`--tp`: phase 19 alone (19a and 19b in 2 ranks of their own), with its
    checks; prints no result line. Exits 1 if a check failed. `dev`, `cfg`,
    `cfg_c` and `card` replace the card and the configs (`rehearse_tp`)."""
    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.step import grads_and_metrics

    if dev is None:
        card = nvidia_smi()
        print(f"card: {card}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.empty(1, device=dev)
    cfg = get_config(TRAIN_ARCH) if cfg is None else cfg
    smoke = Smoke()
    t0 = time.perf_counter()
    B, S = DIST_SHAPE
    params = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = synthetic_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B),
                            0, device=dev)
    loss1 = grads_and_metrics(params, cfg, batch)[1]["loss"].item()
    del params, batch
    settle(torch, dev)
    res = dist.launch(tp_ranks, DIST_WORLD, args=(tp_subs(cfg),), device=dev.type,
                      timeout=900, threads=0 if dev.type == "cuda" else 2)
    print("[19] the sharded step with FSDP and the \"model\" axis executed", flush=True)
    phase_tp(torch, smoke, dev, card, res, loss1, cfg_c)
    print(f"total {time.perf_counter() - t0:.1f} s; {len(smoke.failures)} check(s) failed",
          flush=True)
    for f in smoke.failures:
        print(f"  FAILED {f}", flush=True)
    return 1 if smoke.failures else 0


def rehearse_tp() -> int:
    """Phase 19 alone on the CPU (`tp_only`) at TRAIN_REHEARSAL's widths for
    internlm2-1.8b (2 layers) and `_rehearsal_moe` for 19c:

        PYTHONPATH=src python3 -c "import chip_smoke; chip_smoke.rehearse_tp()"

    Returns 1 if a check failed."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config

    small = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2,
                                **TRAIN_REHEARSAL["internlm2_1_8b"])
    return tp_only(torch, torch.device("cpu"), small, _rehearsal_moe(get_config),
                   "CPU rehearsal")


def tp_rank(mesh, cfg, shape, steps, microbatches, model_axis, rules, trace):
    """One sub-phase of phase 19 on one rank of `mesh`: `steps` sharded
    train steps (`run_sharded`: parameters by `params_shardings`, ZeRO-1
    moments, `grad_shardings` = the parameters' records) of `cfg` at the
    global batch `shape` on make_local_mesh(`model_axis`) under `cfg`'s
    rules and `rules`, each rank holding its blocks only. Returns each
    step's seconds, loss and collective counts (rank 0's), every rank's
    losses, per split axis A the checksums over A's view of the leaves no
    record splits over A (the rows must be equal), the bytes each rank
    holds, its peak, and (`trace`) rank 0's last step traced."""
    import torch

    from repro_torch import dist
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.dist import shardings as dsh
    from repro_torch.dist.zero import zero1_shardings
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import warmup_cosine
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import make_train_step
    from repro_torch.utils import tree_leaves, tree_map

    dev = mesh.device
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def per_rank(v):
        return dist.gather(mesh, torch.tensor([float(v)], dtype=torch.float64,
                                              device=dev)).tolist()

    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    lmesh = make_local_mesh(model_axis)
    B, S = shape
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    t0 = time.perf_counter()
    with dist.mesh_context(lmesh, rules={**dist.DEFAULT_RULES, **cfg.rules_override, **rules}):
        params = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        p_sh = dsh.params_shardings(params, cfg)
        m_sh = zero1_shardings(p_sh, params)
        n_params = sum(x.numel() for x in tree_leaves(params))
        params = dsh.place(params, p_sh)          # this rank's blocks; the whole freed
        if on_card:
            torch.cuda.empty_cache()
        count = torch.zeros((), dtype=torch.int32, device=dev)
        opt = AdamWState(m=tree_map(lambda r: torch.zeros(dsh.block_shape(r), device=dev),
                                    m_sh),
                         v=tree_map(lambda r: torch.zeros(dsh.block_shape(r), device=dev),
                                    m_sh), count=count)
        o_sh = AdamWState(m=m_sh, v=m_sh, count=dsh.replicated(count))
        b_sh = dsh.batch_shardings(synthetic_batch(dcfg, 0, device=dev))
        step = make_train_step(cfg, microbatches=microbatches,
                               lr_schedule=warmup_cosine(3e-4, 10, steps), grad_shardings=p_sh)
        sync()
        out = dict(init_s=time.perf_counter() - t0, shape=lmesh.shape, params=n_params,
                   n_layers=cfg.n_layers)
        records = []
        for i in range(steps):
            batch = synthetic_batch(dcfg, i, device=dev)
            sync()
            dist.all_reduce(mesh, torch.zeros(1, device=dev))        # start together
            dist.reset_counts()
            traced = trace and i == steps - 1 and on_card and mesh.rank == 0
            if traced:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            params, opt, metrics = dsh.run_sharded(step, (p_sh, o_sh, b_sh), params, opt,
                                                   batch, donate=True)
            loss = float(metrics["loss"])
            sync()
            secs = time.perf_counter() - t0
            records.append(dict(
                loss=loss, secs=secs, calls=dist.all_reduce.calls, bytes=dist.all_reduce.bytes,
                ar_s=dist.all_reduce.seconds, by_axis=dict(dist.all_reduce.by_axis),
                bc_calls=dist.broadcast.calls, bc_bytes=dist.broadcast.bytes,
                bc_s=dist.broadcast.seconds, ag_calls=dist.all_gather.calls,
                ag_bytes=dist.all_gather.bytes, counts=dist.counts()))
            if traced:
                prof.__exit__(None, None, None)
                path = ROOT / "build" / "tp-trace" / "step.json"
                path.parent.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(path))
                del prof
                out["trace"] = trace_split(path, secs, 1)
                path.unlink()
        out["steps"] = records
        out["losses"] = dist.gather(mesh, torch.tensor(
            [r["loss"] for r in records], dtype=torch.float64, device=dev)[None]).tolist()
        same = {}
        for axis in dist.split_axes(lmesh):
            trees = ((params, p_sh), (opt.m, m_sh), (opt.v, m_sh))
            leaves = [x for tree, recs in trees for x, r in zip(tree_leaves(tree),
                                                                tree_leaves(recs))
                      if axis not in r.split_axes()]
            if leaves:          # under FSDP every leaf may split over "data"
                same[axis] = (len(leaves), dist.gather(lmesh.view(axis),
                                                       bit_sums(torch, leaves)[None]).tolist())
        out["same"] = same
        out["param_bytes"] = per_rank(sum(x.numel() * x.element_size()
                                          for x in tree_leaves(params)))
        out["moment_bytes"] = per_rank(sum(x.numel() * x.element_size()
                                           for x in tree_leaves((opt.m, opt.v))))
        out["peak"] = per_rank(torch.cuda.max_memory_allocated(dev) if on_card else 0)
    del params, opt, metrics, step
    if on_card:
        torch.cuda.empty_cache()
    return out


def tp_ranks(mesh, subs) -> dict:
    """`tp_rank` for each (label, arguments) of `subs`, on these ranks."""
    out = {}
    for label, args in subs:
        out[label] = tp_rank(mesh, *args)
        if mesh.rank == 0:     # shown even if a later part fails
            r = out[label]
            print(f"    rank 0: {label} done: step s {[round(x['secs'], 3) for x in r['steps']]}, "
                  f"losses {r['losses'][0]}, peak {r['peak']}", flush=True)
    return out


def tp_subs(cfg, shape=None) -> list:
    """19a and 19b's (label, `tp_rank` arguments) for `cfg`."""
    shape = DIST_SHAPE if shape is None else shape
    subs = []
    for label, ((_, model), mb, steps), rules in (("19a", TP_A, {}),
                                                  ("19b", TP_B, {"fsdp": "data"})):
        subs.append((label, (cfg, shape, steps, mb, model, rules, True)))
    return subs


def tp_expected_calls(n_layers: int, microbatches: int) -> int:
    """The "model" all-reduces of one step of a dense attention config
    whose heads, MLP and vocabulary all split (19a), by design: a layer 2
    in the forward (after `wo`, after `w_down`), 2 in the backward (the
    inputs of the column-split products), and 1 in the checkpointed
    recompute (which stops once the last saved tensor, `w_down`'s input, is
    rebuilt, before the MLP's all-reduce); a microbatch's embedding 1, loss
    3 (the maximum, the exp-sum, the gold logit) and head backward 1; and 1
    for the clip's norm."""
    return microbatches * (5 * n_layers + 5) + 1


def phase_tp(torch, smoke, dev, card: str, res: dict, loss1: float, cfg_c=None,
             shape=None) -> None:
    """Phase 19's output and checks: 19a and 19b from `res` (phase 18's
    ranks' results, or a launch of their own) against the one-rank loss
    `loss1` on the same weights and batch, then 19c, mixtral-8x7b at full
    width (`cfg_c`: TP_C_LAYERS layers by default) on TP_C's mesh of 4
    ranks, against a one-process forward once the ranks have exited."""
    import statistics

    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.step import lm_loss

    import math

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    shape = DIST_SHAPE if shape is None else shape
    B, S = shape
    if cfg_c is None:
        cfg_c = dataclasses.replace(get_config(MOE_ARCH), n_layers=TP_C_LAYERS)
    (data_c, model_c), mb_c, steps_c = TP_C
    subs_c = [("19c", (cfg_c, shape, steps_c, mb_c, model_c, {}, True))]
    t0 = time.perf_counter()
    res_c = dist.launch(tp_ranks, data_c * model_c, args=(subs_c,), device=dev.type,
                        timeout=900, threads=0 if on_card else 1)["19c"]
    ranks_s = time.perf_counter() - t0
    # 19c's one-process reference: the same weights' loss on the same batch
    settle(torch, dev, reset_peak=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = M.init_model(cfg_c, generator=torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        batch = synthetic_batch(DataConfig(vocab_size=cfg_c.vocab_size, seq_len=S,
                                           global_batch=B), 0, device=dev)
        loss_c = float(lm_loss(params, cfg_c, batch)[0])
    ref_s = time.perf_counter() - t0
    ref_peak = peak_text(torch, dev)
    del params, batch
    settle(torch, dev)

    cases = (("19a", res["19a"], TP_A, loss1, "internlm2-1.8b whole, tensor parallel"),
             ("19b", res["19b"], TP_B, loss1, "internlm2-1.8b whole, FSDP (rules "
                                              "{'fsdp': 'data'})"),
             ("19c", res_c, TP_C, loss_c, f"{cfg_c.name} at full width, {cfg_c.n_layers} of "
                                          f"32 layers, its rules {cfg_c.rules_override}"))
    for label, r, ((data, model), mb, steps), ref, what in cases:
        st = r["steps"]
        losses = r["losses"]
        print(f"[{label}] {what}: mesh (data {data}, model {model}) of {data * model} gloo ranks "
              f"on this card, {r['params']:,} parameters, bf16, remat, global batch {B} x {S}, "
              f"{mb} microbatch(es), {steps} step(s); init {r['init_s']:.1f} s", flush=True)
        print(f"    step s {[round(x['secs'], 3) for x in st]} (cold first"
              f"{', warm ' + str(round(statistics.median(x['secs'] for x in st[1:]), 3)) if len(st) > 1 else ''}); "
              f"all_reduce a step: calls {[x['calls'] for x in st]} "
              f"({st[-1]['by_axis']}), bytes {[x['bytes'] for x in st]}, seconds "
              f"{[round(x['ar_s'], 3) for x in st]}; broadcast calls "
              f"{[x['bc_calls'] for x in st]}, bytes {[x['bc_bytes'] for x in st]}, seconds "
              f"{[round(x['bc_s'], 3) for x in st]} (host clock); {card}", flush=True)
        if "trace" in r:
            sp = r["trace"]
            print(f"    rank 0's last step traced: wall {sp['wall_us'] / 1e3:.1f} ms, "
                  f"{sp['launches']:.0f} device launches, device busy "
                  f"{sp['busy_us'] / 1e3:.1f} ms, idle share {sp['idle']:.3f}", flush=True)
        print(f"    held a rank: parameters {[round(x / 1e9, 3) for x in r['param_bytes']]} GB, "
              f"moments {[round(x / 1e9, 3) for x in r['moment_bytes']]} GB; peak "
              f"{[round(x / 1e9, 2) for x in r['peak']]} GB allocated a rank", flush=True)
        print(f"    losses by rank {losses}; the one-process loss on the same weights and batch "
              f"{ref:.6f}", flush=True)
        for axis, (n, sums) in r["same"].items():
            smoke.check(all(x == sums[0] for x in sums), f"{label}: after the update the "
                        f"{n} leaves no record splits over {axis!r} (parameters and moments) "
                        f"are bitwise equal across each {axis!r} view ({len(sums)} ranks)")
        groups = [[losses[d * model + m] for m in range(model)] for d in range(data)]
        smoke.check(all(math.isfinite(x) for row in losses for x in row)
                    and all(g[0] == x for g in groups for x in g),
                    f"{label}: the losses finite, the ranks of each model group equal")
        rel = abs(losses[0][0] - ref) / abs(ref)
        smoke.check(rel <= DIST_LOSS_TOL, f"{label}: the first loss {losses[0][0]:.6f} within "
                    f"{DIST_LOSS_TOL} relative of the one-process loss {ref:.6f} ({rel:.2e})")
        held = sum(r["param_bytes"]) / len(r["param_bytes"])
        smoke.check(held < 2 * r["params"] * 0.75, f"{label}: a rank holds its blocks: "
                    f"{held / 1e9:.3f} GB of the {2 * r['params'] / 1e9:.3f} GB of bf16 "
                    "parameters")
    st = res["19a"]["steps"]
    MEASURED["19a"] = {"step_s": statistics.median(x["secs"] for x in st[1:] or st[:1]),
                       "counts": st[-1]["counts"], "param_bytes": res["19a"]["param_bytes"][0],
                       "moment_bytes": res["19a"]["moment_bytes"][0],
                       "n_layers": res["19a"]["n_layers"], "shape": shape}
    want = tp_expected_calls(res["19a"]["n_layers"], TP_A[1])
    got = res["19a"]["steps"][-1]["by_axis"].get("model", 0)
    print(f"    19a: \"model\" all-reduces a step {got}; the design's count "
          f"{want} = microbatches x (5 a layer + 5) + 1 (`tp_expected_calls`)", flush=True)
    smoke.check(got == want, f"19a: the \"model\" all-reduces a step ({got}) are the design's "
                f"count ({want})")
    print(f"    phase 19: 19c ranks {ranks_s:.1f} s from spawn to rank 0's result; its "
          f"one-process forward {ref_s:.1f} s ({ref_peak}); phase {time.perf_counter() - t_phase:.1f} s "
          f"after phase 18's ranks; {card}", flush=True)


#: phase 20: prefill and decode steps on (data, model) meshes in the dry
#: run's serving layouts (`launch/dryrun.py::_rules_for`), gloo ranks on the
#: one card. A serving sub-phase: (data, model), (prefill layout, decode
#: layout), (batch, prompt), max_len, decode steps, decode steps whose
#: logits are held to one process
SERVE_TP_A = ((1, 2), ("default", "default"), (LM_BATCH, LM_PROMPT), LM_PROMPT + LM_GEN,
              LM_GEN, 1)
SERVE_TP_B = ((2, 2), ("prefill_32k", "decode_32k"), (4, 3072), 4096, 2, 1)  # 2 decode
#                                                       steps (cut from 4 for the script's time)
SERVE_TP_C = ((1, 2), ("default", "default"), (LM_BATCH, LM_PROMPT), LM_PROMPT + 8, 8, 8)
SERVE_TP_D = ((1, 2), ("default", "default"), (LM_BATCH, LM_PROMPT), LM_PROMPT + 4, 4, 1)
SERVE_TP_E = ((2, 2), ("long_500k", "long_500k"), (1, 8192), 8192 + 16, 16, 16)
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_SERVE_LAYERS, HYBRID_TRAIN_LAYERS = 4, 2   # 20d: 3 SSM layers + the attention one
SERVE_TP_E_LAYERS = 2                             # 20e: mixtral-8x7b's depth cut


def serve_tp_rank(mesh, cfg, model_axis, layouts, shape, max_len, steps, keep, trace):
    """One serving sub-phase of phase 20 on one rank of `mesh`: `cfg`'s
    weights (seed 0, each rank its blocks by `params_shardings`) on
    make_local_mesh(`model_axis`), a prefill (`run_prefill`) of the seeded
    prompt `shape` in the layout `layouts[0]` ("default": the config's
    rules; else the dry run's `_rules_for`), then `steps` greedy decode
    steps (`run_decode`) in `layouts[1]` (the weights placed anew when the
    layouts differ). Returns the prefill's seconds and logits, each decode
    step's seconds and collective counts (rank 0's), the first `keep` decode
    steps' logits, the tokens, every rank's token checksums, the bytes each
    rank holds and its peak, and (`trace`) rank 0's second decode step
    traced."""
    import torch

    from repro_torch import dist
    from repro_torch.dist import shardings as dsh
    from repro_torch.launch.dryrun import _rules_for
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    from repro_torch.utils import tree_leaves

    dev = mesh.device
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def together():
        sync()
        dist.all_reduce(mesh, torch.zeros(1, device=dev))

    def per_rank(v):
        return dist.gather(mesh, torch.tensor([float(v)], dtype=torch.float64,
                                              device=dev)).tolist()

    def rules(layout):
        if layout == "default":
            return {**dist.DEFAULT_RULES, **cfg.rules_override}
        return _rules_for(cfg, layout)

    def blocks():
        params = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        p_sh = dsh.params_shardings(params, cfg)
        held = dsh.place(params, p_sh)
        del params
        if on_card:
            torch.cuda.empty_cache()
        return held, p_sh

    def counts(secs):
        return dict(secs=secs, calls=dist.all_reduce.calls, bytes=dist.all_reduce.bytes,
                    ar_s=dist.all_reduce.seconds, by_axis=dict(dist.all_reduce.by_axis),
                    bc_calls=dist.broadcast.calls, bc_bytes=dist.broadcast.bytes,
                    bc_s=dist.broadcast.seconds, bc_by_axis=dict(dist.broadcast.by_axis),
                    ag_calls=dist.all_gather.calls, ag_bytes=dist.all_gather.bytes,
                    ag_s=dist.all_gather.seconds, counts=dist.counts())

    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    lmesh = make_local_mesh(model_axis)
    B = shape[0]
    batch = {"tokens": lm_tokens(torch, cfg, shape, 1, dev)}
    prefill, decode = make_prefill_step(cfg, max_len), make_decode_step(cfg)
    with routed(torch) as seen:
        t0 = time.perf_counter()
        with dist.mesh_context(lmesh, rules=rules(layouts[0])):
            params, p_sh = blocks()
            b_sh = dsh.batch_shardings(batch)
            out = dict(init_s=time.perf_counter() - t0, shape=lmesh.shape, n_layers=cfg.n_layers,
                       param_bytes=per_rank(sum(x.numel() * x.element_size()
                                                for x in tree_leaves(params))))
            together()
            dist.reset_counts()
            seen[:] = [[]]
            t0 = time.perf_counter()
            logits, caches = dsh.run_prefill(prefill, (p_sh, b_sh), params, batch)
            sync()
            out["prefill"] = counts(time.perf_counter() - t0)
            out["prefill_logits"] = logits.float().cpu()
        with dist.mesh_context(lmesh, rules=rules(layouts[1])):
            if layouts[1] != layouts[0]:
                del params
                params, p_sh = blocks()
            c_sh = M.cache_records(cfg, B, max_len)
            caches = dsh.place(caches, c_sh)
            tok = torch.argmax(logits, dim=-1)
            tok_sh = dsh.batch_shardings(tok)
            toks, records, kept = [tok], [], []
            for i in range(steps):
                together()
                dist.reset_counts()
                traced = trace and on_card and mesh.rank == 0 and i == min(1, steps - 1)
                if traced:
                    from torch.profiler import ProfilerActivity, profile
                    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    prof.__enter__()
                seen.append([])
                t0 = time.perf_counter()
                logits, caches = dsh.run_decode(decode, (p_sh, tok_sh, c_sh), params, tok, caches)
                tok = torch.argmax(logits, dim=-1)
                sync()
                secs = time.perf_counter() - t0
                records.append(counts(secs))
                if traced:
                    prof.__exit__(None, None, None)
                    path = ROOT / "build" / "serve-tp-trace" / "step.json"
                    path.parent.mkdir(parents=True, exist_ok=True)
                    prof.export_chrome_trace(str(path))
                    del prof
                    out["trace"] = trace_split(path, secs, 1)
                    path.unlink()
                if i < keep:
                    kept.append(logits.float().cpu())
                toks.append(tok)
            tokens = torch.stack(toks, dim=1)
            out.update(steps=records, decode_logits=kept, tokens=tokens.cpu(),
                       token_sums=dist.gather(mesh, bit_sums(torch, [tokens.to(torch.int32)])[None]
                                              ).tolist(),
                       cache_bytes=per_rank(sum(x.numel() * x.element_size()
                                                for x in tree_leaves(caches)
                                                if isinstance(x, torch.Tensor))),
                       peak=per_rank(torch.cuda.max_memory_allocated(dev) if on_card else 0))
        del params, caches, logits
    out["choices"] = [[c.cpu() for c in step] for step in seen]
    if on_card:
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def routed(torch):
    """Within it, each MoE layer's chosen experts (top-k indices, on the
    device) are appended to the last list of the yielded list of steps."""
    from repro_torch.models import moe as moe_mod

    steps, route = [[]], moe_mod.route

    def record(params, x, cfg):
        out = route(params, x, cfg)
        steps[-1].append(out[2])
        return out

    moe_mod.route = record
    try:
        yield steps
    finally:
        moe_mod.route = route


def serve_tp_ranks(mesh, subs) -> dict:
    """Phase 20's sub-phases on these ranks: each (label, kind, arguments),
    kind "serve" (`serve_tp_rank`) or "train" (`tp_rank`), each starting
    from the memory the one before it freed (reference cycles collected)."""
    import gc

    import torch

    out = {}
    for label, kind, args in subs:
        gc.collect()
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
        out[label] = (serve_tp_rank if kind == "serve" else tp_rank)(mesh, *args)
        if mesh.rank == 0:      # shown even if a later part fails
            r = out[label]
            secs = [round(x["secs"], 3) for x in r["steps"]]
            print(f"    rank 0: {label} done: step s {secs}, peak {r['peak']}", flush=True)
    return out


def serve_tp_reference(torch, cfg, shape, max_len, tokens, choices, n_steps, dev) -> dict:
    """One process on the same weights and prompt, teacher-forced on the
    ranks' `tokens` and on their MoE `choices` (per step, per MoE layer,
    the top-k experts the ranks chose): the prefill's logits and `n_steps`
    decode steps' ("logits"). A choice the ranks made otherwise than this
    process would is counted ("apart", tokens a step) and measured: how far
    below this process's own k-th probability the weakest expert it is
    handed lies, relative to it ("shortfall", the largest; 0 when every
    choice is its own). So bf16 rounding that tips a near tie of the
    router apart, a discrete change, is told from the split's arithmetic.
    "planted": the shortfall the same reading gives a wrong router planted
    beside it, one that hands every token its (k+1)-th expert in place of
    its k-th, so the gate is seen to tell such a router from near ties."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    route = moe_mod.route
    step, calls, apart, worst, planted = [0], [0], [], [0.0], [0.0]

    def shortfall(probs, kth, chosen):
        picked = torch.gather(probs, -1, chosen)
        return float(((kth - picked.min(dim=-1).values) / kth).clamp(min=0).max()), picked

    def replay(p, x, c):
        probs, _, own = route(p, x, c)
        forced = choices[step[0]][calls[0]].to(probs.device)
        calls[0] += 1
        top = torch.topk(probs, c.top_k + 1, dim=-1).indices
        kth = torch.gather(probs, -1, top[..., c.top_k - 1:c.top_k])[..., 0]
        short, picked = shortfall(probs, kth, forced)
        worst[0] = max(worst[0], short)
        wrong = torch.cat([top[..., :c.top_k - 1], top[..., c.top_k:]], dim=-1)
        planted[0] = max(planted[0], shortfall(probs, kth, wrong)[0])
        differ = (torch.sort(own, dim=-1).values != torch.sort(forced, dim=-1).values).any(-1)
        apart[-1] += int(differ.sum())
        return probs, picked / torch.clamp(picked.sum(-1, keepdim=True), min=1e-9), forced

    params = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    moe_mod.route = replay
    try:
        apart.append(0)
        logits, caches = make_prefill_step(cfg, max_len)(
            params, {"tokens": lm_tokens(torch, cfg, shape, 1, dev)})
        out = [logits.float().cpu()]
        decode = make_decode_step(cfg)
        for s in range(n_steps):
            step[0], calls[0] = s + 1, 0
            apart.append(0)
            logits, caches = decode(params, tokens[:, s].to(dev), caches)
            out.append(logits.float().cpu())
    finally:
        moe_mod.route = route
    del params, caches
    settle(torch, dev)
    return dict(logits=out, apart=apart, shortfall=worst[0], planted=planted[0])


#: a MoE choice the ranks make otherwise than one process must be a near tie
#: there: the weakest expert handed to it within this share of its own k-th
#: probability (bf16 rounding of the router's input moves them about 1 %)
SERVE_TP_TIE = 0.1


def serve_tp_cfgs(get_config):
    """Phase 20's configs: internlm2-1.8b, mamba2-130m (float32) and
    jamba-v0.1-52b at HYBRID_SERVE_LAYERS / HYBRID_TRAIN_LAYERS layers, whole
    width; mixtral-8x7b at SERVE_TP_E_LAYERS."""
    import torch

    hybrid = get_config(HYBRID_ARCH)
    return dict(a=get_config(LM_ARCH), b=get_config(LM_ARCH),
                c=f32_of(torch, get_config(SSM_ARCH)),
                d=dataclasses.replace(hybrid, n_layers=HYBRID_SERVE_LAYERS),
                d_train=dataclasses.replace(hybrid, n_layers=HYBRID_TRAIN_LAYERS),
                e=dataclasses.replace(get_config(MOE_ARCH), n_layers=SERVE_TP_E_LAYERS))


def phase_serve_tp(torch, smoke, dev, card: str, cfgs=None, subs=None) -> None:
    """Phase 20: the prefill and decode steps on (data, model) meshes of
    gloo ranks on the one card, each against one process on the same
    weights and prompt once the ranks have exited (`serve_tp_cfgs`'s
    configs and SERVE_TP_*'s shapes; `cfgs` and `subs` replace them for
    the CPU rehearsal): 20a internlm2-1.8b whole on (1, 2); 20b on (2, 2)
    in prefill_32k's then decode_32k's layout; 20c mamba2-130m whole in
    float32 on (1, 2), a train step and then serving; 20d jamba-v0.1-52b
    at full width (a train step at 2 layers, serving at 4) on (1, 2); 20e
    mixtral-8x7b at full width, 2 layers, on (2, 2) in long_500k's layout
    at batch 1, its ring buffer split over "data" and wrapping."""
    import math
    import statistics

    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models import model as M
    from repro_torch.train.step import lm_loss

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    cfgs = serve_tp_cfgs(get_config) if cfgs is None else cfgs
    subs = dict(a=SERVE_TP_A, b=SERVE_TP_B, c=SERVE_TP_C, d=SERVE_TP_D, e=SERVE_TP_E) \
        if subs is None else subs

    def serve(key):
        (_, model), layouts, shape, max_len, steps, keep = subs[key]
        return ("serve", (cfgs[key], model, layouts, shape, max_len, steps, keep, True))

    def train(key):
        return ("train", (cfgs[key], DIST_SHAPE if on_card else DIST_B_SHAPE, 1, 1, 2, {},
                          False))

    two = [("20a", *serve("a")), ("20c/train", *train("c")), ("20c", *serve("c")),
           ("20d", *serve("d")), ("20d/train", *train("d_train"))]
    four = [("20b", *serve("b")), ("20e", *serve("e"))]
    threads = 0 if on_card else 1
    t0 = time.perf_counter()
    res = dist.launch(serve_tp_ranks, 2, args=(two,), device=dev.type, timeout=900,
                      threads=threads)
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res.update(dist.launch(serve_tp_ranks, 4, args=(four,), device=dev.type, timeout=900,
                           threads=threads))
    four_s = time.perf_counter() - t0

    # the one-process references, once the ranks have exited
    settle(torch, dev, reset_peak=True)
    t0 = time.perf_counter()
    refs, losses = {}, {}
    for key in "abcde":
        r = res[f"20{key}"]
        _, _, shape, max_len, _, keep = subs[key]
        refs[key] = serve_tp_reference(torch, cfgs[key], shape, max_len, r["tokens"],
                                       r["choices"], keep, dev)
    for key in ("c", "d_train"):
        cfg = cfgs[key]
        B, S = DIST_SHAPE if on_card else DIST_B_SHAPE
        with torch.no_grad():
            params = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
            batch = synthetic_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                               global_batch=B), 0, device=dev)
            losses[key] = float(lm_loss(params, cfg, batch)[0])
        del params, batch
        settle(torch, dev)
    ref_s = time.perf_counter() - t0
    ref_peak = peak_text(torch, dev)

    what = {"a": f"{cfgs['a'].name} whole, the default rules",
            "b": f"{cfgs['b'].name} whole, prefill_32k's layout then "
                 "decode_32k's (flash decoding, FSDP over \"data\")",
            "c": f"{cfgs['c'].name} whole, float32, the SSM split over \"model\"",
            "d": f"{cfgs['d'].name} at full width, {cfgs['d'].n_layers} layers (3 SSM + "
                 "attention, dense and MoE MLPs), its rules",
            "e": f"{cfgs['e'].name} at full width, {cfgs['e'].n_layers} layers, long_500k's "
                 "layout (the ring buffer's sequence over \"data\")"}
    for key in "abcde":
        label = f"20{key}"
        r, ref = res[label], refs[key]
        (data, model), layouts, (B, S), max_len, steps, keep = subs[key]
        cfg = cfgs[key]
        st = r["steps"]
        warm = [x["secs"] for x in st[1:]] or [st[0]["secs"]]
        step_s = statistics.median(warm)
        print(f"[{label}] {what[key]}: mesh (data {data}, model {model}) of {data * model} gloo "
              f"ranks on this card, {cfg.dtype}, batch {B}, prompt {S}, max_len {max_len}, "
              f"{steps} decode steps; init {r['init_s']:.1f} s", flush=True)
        pre = r["prefill"]
        print(f"    prefill {pre['secs'] * 1e3:.1f} ms (all_reduce calls {pre['calls']}, "
              f"{pre['bytes']} bytes, {pre['ar_s']:.3f} s; broadcast calls {pre['bc_calls']}, "
              f"{pre['bc_bytes']} bytes, {pre['bc_s']:.3f} s); decode step s "
              f"{[round(x['secs'], 4) for x in st]}, median warm {step_s * 1e3:.1f} ms = "
              f"{B / step_s:.1f} tok/s at batch {B}; {card}", flush=True)
        last = st[-1]
        MEASURED[label] = {"step_s": step_s, "counts": last["counts"], "n_layers": cfg.n_layers}
        print(f"    a decode step's collectives: all_reduce calls {last['calls']} "
              f"{last['by_axis']}, {last['bytes']} bytes, {last['ar_s']:.3f} s; broadcast "
              f"calls {last['bc_calls']} {last['bc_by_axis']}, {last['bc_bytes']} bytes, "
              f"{last['bc_s']:.3f} s; all_gather calls {last['ag_calls']}, {last['ag_bytes']} "
              f"bytes sent a rank, {last['ag_s']:.3f} s (host clock)", flush=True)
        if "trace" in r:
            sp = r["trace"]
            print(f"    rank 0's decode step traced: wall {sp['wall_us'] / 1e3:.1f} ms, "
                  f"{sp['launches']:.0f} device launches, device busy "
                  f"{sp['busy_us'] / 1e3:.1f} ms, idle share {sp['idle']:.3f}", flush=True)
        print(f"    held a rank: parameters {[round(x / 1e9, 3) for x in r['param_bytes']]} GB, "
              f"caches {[round(x / 1e9, 4) for x in r['cache_bytes']]} GB; peak "
              f"{[round(x / 1e9, 2) for x in r['peak']]} GB allocated a rank", flush=True)
        toks = r["tokens"]
        sums = r["token_sums"]
        smoke.check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
                    and toks.shape == (B, steps + 1) and all(x == sums[0] for x in sums),
                    f"{label}: tokens {tuple(toks.shape)} in [0, {cfg.vocab_size}), the same "
                    f"on all {len(sums)} ranks")
        tol = LM_CPU_TOL if cfg.dtype == torch.float32 else LM_BF16_TOL
        got = [r["prefill_logits"]] + list(r["decode_logits"])
        want = ref["logits"]
        agree = [int((torch.argmax(w, dim=-1) == toks[:, s]).sum()) for s, w in enumerate(want)]
        if cfg.moe is not None:
            print(f"    tokens whose experts the ranks chose otherwise than one process, a "
                  f"step: {ref['apart']} (one process replays the ranks' choices); the weakest "
                  f"expert handed to it at most {ref['shortfall']:.3e} below its own k-th "
                  f"probability, relative (a router planted to hand the (k+1)-th: "
                  f"{ref['planted']:.3e})", flush=True)
            smoke.check(ref["shortfall"] <= SERVE_TP_TIE, f"{label}: every MoE choice the ranks "
                        f"made otherwise is a near tie in one process (shortfall "
                        f"{ref['shortfall']:.3e} <= {SERVE_TP_TIE})")
            smoke.check(ref["planted"] > SERVE_TP_TIE, f"{label}: a router planted to hand "
                        f"the (k+1)-th expert for the k-th fails the same gate (shortfall "
                        f"{ref['planted']:.3e} > {SERVE_TP_TIE})")
        for s, (g, w) in enumerate(zip(got, want)):
            scale = w.abs().max().item()
            d = (g - w).abs().max().item()
            name = "prefill" if s == 0 else f"decode step {s}"
            smoke.check(math.isfinite(d) and d <= tol * scale,
                        f"{label}: {name} logits within {tol} x max|logits| of one process "
                        f"({d / scale:.3e})")
        print(f"    tokens the one process picks alike, a step of {B}: {agree}", flush=True)
        if key == "a":
            want = 2 * cfg.n_layers + 2
            got_calls = last["by_axis"].get("model", 0)
            print(f"    20a: \"model\" all-reduces a decode step {got_calls}; the design's "
                  f"{want} = 2 a layer (after `wo`, after `w_down`) + the embedding lookup's "
                  "+ the head's gather", flush=True)
            smoke.check(got_calls == want, f"20a: the \"model\" all-reduces a decode step "
                        f"({got_calls}) are the design's count ({want})")
    for key, label in (("c", "20c/train"), ("d_train", "20d/train")):
        r = res[label]
        loss0, ref = r["losses"][0][0], losses[key]
        rel = abs(loss0 - ref) / abs(ref)
        print(f"[{label}] {cfgs[key].name}, {cfgs[key].n_layers} layers, one sharded train "
              f"step on (1, 2): step s {[round(x['secs'], 3) for x in r['steps']]}, "
              f"\"model\" all-reduces {r['steps'][0]['by_axis']} ({r['steps'][0]['bytes']} "
              f"bytes), all-gathers {r['steps'][0]['ag_calls']} ({r['steps'][0]['ag_bytes']} "
              f"bytes sent a rank), peak "
              f"{[round(x / 1e9, 2) for x in r['peak']]} GB a rank; losses by rank "
              f"{r['losses']}, one process {ref:.6f}", flush=True)
        smoke.check(rel <= DIST_LOSS_TOL, f"{label}: the first loss {loss0:.6f} within "
                    f"{DIST_LOSS_TOL} relative of the one-process loss ({rel:.2e})")
    print(f"    phase 20: 2 ranks {two_s:.1f} s, 4 ranks {four_s:.1f} s from spawn to rank 0's "
          f"result; one-process references {ref_s:.1f} s ({ref_peak}); phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)


def serve_tp_only(torch, dev=None, cfgs=None, subs=None, card=None) -> int:
    """`--serve-tp`: phase 20 alone, with its checks; prints no result line.
    Exits 1 if a check failed. `dev`, `cfgs`, `subs` and `card` replace the
    card, the configs and the shapes (`rehearse_serve_tp`)."""
    if dev is None:
        card = nvidia_smi()
        print(f"card: {card}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.empty(1, device=dev)
    smoke = Smoke()
    t0 = time.perf_counter()
    print("[20] prefill and decode on (data, model) meshes in the dry run's serving layouts",
          flush=True)
    phase_serve_tp(torch, smoke, dev, card, cfgs, subs)
    print(f"total {time.perf_counter() - t0:.1f} s; {len(smoke.failures)} check(s) failed",
          flush=True)
    for f in smoke.failures:
        print(f"  FAILED {f}", flush=True)
    return 1 if smoke.failures else 0


def rehearse_serve_tp() -> int:
    """Phase 20 on the CPU at reduced widths (internlm2-1.8b at
    TRAIN_REHEARSAL's, 2 layers; mamba2-130m at REHEARSAL's; jamba at
    d_model 256; `_rehearsal_moe` with a 128-position window), to try the
    phase's logic where there is no card:

        PYTHONPATH=src python3 -c "import chip_smoke; chip_smoke.rehearse_serve_tp()"

    Returns 1 if a check failed."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config

    small = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2,
                                **TRAIN_REHEARSAL["internlm2_1_8b"])
    ssm = get_config(SSM_ARCH)
    ssm = f32_of(torch, ssm, n_layers=2, **REHEARSAL["mamba2_130m"],
                 ssm=ssm.ssm._replace(**REHEARSAL_PARTS["mamba2_130m"]["ssm"]))
    hybrid = get_config(HYBRID_ARCH)
    hybrid = dataclasses.replace(hybrid, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                                 d_ff=512, vocab_size=4096,
                                 moe=hybrid.moe._replace(d_ff_expert=512))
    moe = dataclasses.replace(_rehearsal_moe(get_config), swa_window=128)
    cfgs = dict(a=small, b=small, c=ssm,
                d=dataclasses.replace(hybrid, n_layers=HYBRID_SERVE_LAYERS),
                d_train=dataclasses.replace(hybrid, n_layers=HYBRID_TRAIN_LAYERS), e=moe)
    subs = dict(a=((1, 2), ("default", "default"), (4, 16), 24, 8, 1),
                b=((2, 2), ("prefill_32k", "decode_32k"), (4, 96), 128, 4, 1),
                c=((1, 2), ("default", "default"), (4, 64), 72, 8, 8),
                d=((1, 2), ("default", "default"), (4, 16), 20, 4, 1),
                e=((2, 2), ("long_500k", "long_500k"), (1, 256), 272, 16, 16))
    return serve_tp_only(torch, torch.device("cpu"), cfgs, subs, "CPU rehearsal")


#: phase 21: the launch tools (`launch/{dryrun,roofline}.py`) against the card
LT_GRAM_TOL = {"f32": 1e-5, "bf16": 2e-2}   # x max|K|: the repo's kernel bounds
LT_HV_TOL = 1e-5                            # x max|H v|: float32 against float64 sums
LT_SHARE = 1.05            # roofline step / measured time: no reading beats the bound
LT_TWINS = (("quickstart", []), ("regpath_genomics", ["--points", "3"]),
            ("feature_selection_lm", []),
            ("serve_lm", ["--arch", "mixtral-8x7b", "--steps", "8"]),
            ("train_lm", ["--arch", "internlm2-1.8b", "--steps", "10"]))


def counts_text(c: dict) -> str:
    """A `dist.counts()` record, calls and bytes by axis, on one line."""
    return "; ".join(f"{kind} " + ", ".join(f"{ax} {n} calls {e['bytes_by_axis'][ax]} B"
                                            for ax, n in e["by_axis"].items())
                     for kind, e in c.items()) or "none"


def counts_apart(counted: dict, measured: dict) -> str:
    """The differences in calls and bytes by kind and axis between two
    `dist.counts()` records ("0" when they are equal)."""
    out = []
    for kind in sorted(set(counted) | set(measured)):
        a, b = counted.get(kind, {}), measured.get(kind, {})
        for ax in sorted(set(a.get("by_axis", {})) | set(b.get("by_axis", {}))):
            dc = a.get("by_axis", {}).get(ax, 0) - b.get("by_axis", {}).get(ax, 0)
            db = a.get("bytes_by_axis", {}).get(ax, 0) - b.get("bytes_by_axis", {}).get(ax, 0)
            if dc or db:
                out.append(f"{kind} {ax}: calls {dc:+d}, bytes {db:+d}")
    return "; ".join(out) or "0"


def launch_tool_cells() -> dict:
    """The dry run's records (`launch/dryrun.py::_lower_one`, on the CPU,
    one thread) of internlm2-1.8b at the shapes and meshes phases 15, 17,
    19 and 20 run: 15a's decode step and 17a's train step on (1, 1), 19a's
    train step and 20a's decode step on (1, 2), each a mesh with no process
    group (`lower_cell` records), and "seconds". The main run computes
    them in a process of its own while the card works."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import train as train_launcher

    torch.set_num_threads(1)
    args = train_launcher._parser().parse_args(TRAIN_ARGV)
    (d19, m19), mb19, _ = TP_A
    (d20, m20), layouts20, (B20, _), max_len20, _, _ = SERVE_TP_A
    cells = {"15a": ("decode_32k", "default", (1, 1), 1, LM_BATCH, LM_PROMPT + LM_GEN),
             "17a": ("train_4k", "train_4k", (1, 1), args.microbatches, args.batch, args.seq),
             "19a": ("train_4k", "train_4k", (d19, m19), mb19, *DIST_SHAPE),
             "20a": ("decode_32k", layouts20[1], (d20, m20), 1, B20, max_len20)}
    t0 = time.perf_counter()
    out = {label: D.lower_cell(TRAIN_ARCH, shape, D.spec_mesh(sizes=sizes),
                               opt_overrides={"microbatches": mb}, global_batch=B, seq_len=S,
                               layout=layout)
           for label, (shape, layout, sizes, mb, B, S) in cells.items()}
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_launch_tools(torch, smoke, dev, card: str, count, cells=None) -> dict:
    """Phase 21: (21a) rank 0's block of the dry run's sven cells at (16,
    16) on the card, each beside the roofline terms the dry run counted for
    its cell: `sven_gram_nggp`'s 4,096 x 8,192 X through the CUDA Gram in
    f32 ("blocks") and bf16 ("blocks_bf16") against the plain Gram, and
    `sven_hess_pggn`'s 4,096 x 4,096 block through the plain products of
    `make_distributed_hessian_matvec` against float64 sums; (21b) the dry
    run counted at the shapes and meshes phases 15, 17, 19 and 20 ran
    (spec-only (1, 1) and (1, 2)): 19a's train step and 20a's decode step,
    whose collectives by kind and axis and whose bytes a rank must equal
    what the ranks counted, and each measured median at or above its
    roofline step; (21c) the twins of examples/ on the card, in process.
    `cells` are `launch_tool_cells()`'s records (counted here when None).
    Returns the Gram launches by mode."""
    from repro_torch import dist, kernels
    from repro_torch.core.distributed import make_distributed_hessian_matvec
    from repro_torch.kernels import gram as gram_mod
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R

    t_phase = time.perf_counter()
    modes = {"f32": 0, "bf16": 0}
    mesh = D.spec_mesh()
    gen = torch.Generator(device=dev).manual_seed(21)

    def share_text(label, terms, measured_s, part):
        """The roofline step of `part` over a measured time, checked."""
        step = (max(terms["t_compute_s"] or 0.0, terms["t_memory_s"] or 0.0)
                if part == "device" else terms["roofline_step_s"])
        share = step / measured_s
        print(f"    {label}: roofline t_compute {terms['t_compute_s'] * 1e3:.4f} ms, "
              f"t_memory {terms['t_memory_s'] * 1e3:.4f} ms, t_collective "
              f"{terms['t_collective_s'] * 1e3:.4f} ms ({terms.get('bottleneck')}); "
              f"{'the device terms' if part == 'device' else 'the step'} {step * 1e3:.4f} ms "
              f"against {measured_s * 1e3:.4f} ms measured: share {share:.4f}; {card}",
              flush=True)
        smoke.check(share <= LT_SHARE, f"{label}: roofline {step * 1e3:.4f} ms / measured "
                    f"{measured_s * 1e3:.4f} ms = {share:.4f} <= {LT_SHARE}")

    # -- 21a: the sven cells' per-device work -------------------------------------
    t0 = time.perf_counter()
    for variant, prec in (("blocks", "f32"), ("blocks_bf16", "bf16")):
        rec = D.lower_sven_cell("sven_gram_nggp", mesh, variant)
        fl = D.sven_floor("sven_gram_nggp", mesh.size, variant)
        n, p = fl["n_loc"], fl["p"]
        X = torch.randn((n, p), generator=gen, device=dev, dtype=torch.float32)
        y = torch.randn((n,), generator=gen, device=dev, dtype=torch.float32)
        if prec == "bf16":
            X, y = X.to(torch.bfloat16), y.to(torch.bfloat16)
        before = kernels.shifted_gram_cuda.launches
        K = kernels.shifted_gram(X, y, 1.5, precision=prec)
        modes[prec] += kernels.shifted_gram_cuda.launches - before
        plain = kernels.shifted_gram(X, y, 1.5, backend="ref", precision=prec)
        torch.cuda.synchronize()
        scale = plain.abs().max().item()
        err = (K - plain).abs().max().item()
        del K, plain
        torch.cuda.empty_cache()
        ms = cuda_ms(torch, lambda: gram_mod._launch(X, y, 1.5, prec, True), min_reps=3,
                     min_ms=30.0)
        print(f"[21a] sven_gram_nggp ({variant}) rank 0's block at pod16x16: X {n} x {p} "
              f"{X.dtype}, K {2 * p} x {2 * p} float32 by the CUDA Gram ({prec}): "
              f"{ms:.4f} ms; max|K - plain| {err:.3e} (bound {LT_GRAM_TOL[prec]:g} x "
              f"max|K| = {LT_GRAM_TOL[prec] * scale:.3e}); the dry run's cell: "
              f"{rec['flops']:.4e} FLOPs, {rec['bytes_accessed']:.4e} B a device (floors), "
              f"collectives {rec['collectives']}", flush=True)
        smoke.check(err <= LT_GRAM_TOL[prec] * scale, f"21a {variant}: max|K - plain| "
                    f"{err:.3e} <= {LT_GRAM_TOL[prec]:g} x max|K|")
        share_text(f"21a {variant}", R.roofline_terms(rec), ms / 1e3, "device")
        del X, y
        torch.cuda.empty_cache()
    rec = D.lower_sven_cell("sven_hess_pggn", mesh)
    fl = D.sven_floor("sven_hess_pggn", mesh.size)
    n, p = fl["n"], fl["p_loc"]
    X = torch.randn((n, p), generator=gen, device=dev, dtype=torch.float32)
    y = torch.randn((n,), generator=gen, device=dev, dtype=torch.float32)
    v = torch.randn((n,), generator=gen, device=dev, dtype=torch.float32)
    act = (torch.randn((2 * p,), generator=gen, device=dev) > 0).to(torch.float32)
    one = dist.Mesh(device=dev)
    hv = make_distributed_hessian_matvec(one, X, y, 1.5, 10.0)
    got = hv(v, act).double()
    want = make_distributed_hessian_matvec(one, X.double(), y.double(), 1.5, 10.0)(
        v.double(), act.double())
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    ms = cuda_ms(torch, lambda: hv(v, act))
    print(f"[21a] sven_hess_pggn rank 0's block at pod16x16: X {n} x {p} float32, H v by "
          f"the plain products: {ms:.4f} ms; max|Hv - float64| {err:.3e} (bound "
          f"{LT_HV_TOL:g} x max|Hv| = {LT_HV_TOL * scale:.3e}); the dry run's cell: "
          f"{rec['flops']:.4e} FLOPs, {rec['bytes_accessed']:.4e} B a device (floors), "
          f"collectives {rec['collectives']}", flush=True)
    smoke.check(err <= LT_HV_TOL * scale, f"21a sven_hess_pggn: max|Hv - float64| {err:.3e} "
                f"<= {LT_HV_TOL:g} x max|Hv|")
    share_text("21a sven_hess_pggn", R.roofline_terms(rec), ms / 1e3, "device")
    del X, y, v, act, got, want
    torch.cuda.empty_cache()
    print(f"    21a {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 21b: the dry run at the shapes phases 15-20 ran ----------------------------
    t0 = time.perf_counter()
    cells = launch_tool_cells() if cells is None else cells
    print(f"[21b] the dry run on {TRAIN_ARCH} at the shapes and meshes phases 15, 17, 19 and "
          f"20 ran (no process group; counted on the CPU in {cells['seconds']:.1f} s)",
          flush=True)
    for label, what in (("19a", "the train step"), ("20a", "a decode step")):
        rec, m = cells[label], MEASURED.get(label)
        print(f"    {label} {what} counted: {counts_text(rec['collectives_by_axis'])}",
              flush=True)
        if m is None:
            smoke.check(False, f"21b {label}: phase {label[:2]} measured nothing to compare")
            continue
        print(f"    {label} {what} on the ranks (rank 0): {counts_text(m['counts'])}; "
              f"counted - measured: {counts_apart(rec['collectives_by_axis'], m['counts'])}",
              flush=True)
        smoke.check(rec["collectives_by_axis"] == m["counts"], f"21b {label}: the counted "
                    f"collectives equal the ranks' by kind and axis, calls and bytes "
                    f"({counts_apart(rec['collectives_by_axis'], m['counts'])})")
    m = MEASURED.get("19a")
    if m is not None:
        rec = cells["19a"]
        print(f"    19a a rank's blocks: parameters counted {rec['param_bytes']} B, held "
              f"{m['param_bytes']:.0f} B; ZeRO-1 moments counted {rec['moment_bytes']} B, "
              f"held {m['moment_bytes']:.0f} B", flush=True)
        smoke.check(rec["param_bytes"] == m["param_bytes"]
                    and rec["moment_bytes"] == m["moment_bytes"],
                    "21b 19a: the counted parameter and moment bytes a rank equal the blocks "
                    "phase 19's rank 0 holds")
    for label in ("15a", "17a", "19a", "20a"):
        rec, m = cells[label], MEASURED.get(label)
        if m is None:
            print(f"    {label}: not measured in this run", flush=True)
            continue
        share_text(f"21b {label} ({rec['kind']}, {rec['global_batch']} x {rec['seq_len']}, "
                   f"mesh {rec['mesh']}, {rec['flops']:.4e} FLOPs)", R.roofline_terms(rec),
                   m["step_s"], "step")
    print(f"    21b {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 21c: the twins of examples/ -------------------------------------------------
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "examples"))
    for name, argv in LT_TWINS:
        t1 = time.perf_counter()
        before = kernels.launches()
        try:
            importlib.import_module(f"{name}_torch").main(argv + ["--device", str(dev)])
            ok, why = True, "exited normally"
        except (Exception, SystemExit) as e:  # noqa: BLE001 — a twin's failure is a check
            ok, why = False, f"{type(e).__name__}: {e}"
        torch.cuda.synchronize()
        count({k: v - before[k] for k, v in kernels.launches().items()})
        print(f"[21c] examples/{name}_torch.py {' '.join(argv)}: {why} in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        smoke.check(ok, f"21c {name}_torch: {why}")
        torch.cuda.empty_cache()
    print(f"    21c {time.perf_counter() - t0:.1f} s; phase 21: "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return modes


def launch_tools_only(torch) -> int:
    """`--launch-tools`: phase 21 alone (the kernels built first), with 19a
    and 20a run first on 2 ranks of their own (2 steps each) to hold the
    counts against; prints no result line. Exits 1 if a check failed."""
    import statistics

    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda", 0)
    smoke = Smoke()
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    (_, model), mb, _ = TP_A
    (_, model20), layouts, shape, max_len, _, _ = SERVE_TP_A
    subs = [("19a", "train", (cfg, DIST_SHAPE, 2, mb, model, {}, False)),
            ("20a", "serve", (cfg, model20, layouts, shape, max_len, 2, 0, False))]
    res = dist.launch(serve_tp_ranks, 2, args=(subs,), device="cuda", timeout=900)
    st = res["19a"]["steps"]
    MEASURED["19a"] = {"step_s": st[-1]["secs"], "counts": st[-1]["counts"],
                       "param_bytes": res["19a"]["param_bytes"][0],
                       "moment_bytes": res["19a"]["moment_bytes"][0], "shape": DIST_SHAPE}
    st = res["20a"]["steps"]
    MEASURED["20a"] = {"step_s": statistics.median(x["secs"] for x in st[1:]),
                       "counts": st[-1]["counts"]}
    print(f"19a and 20a on 2 ranks: {time.perf_counter() - t0:.1f} s", flush=True)
    phase_launch_tools(torch, smoke, dev, card, lambda launched: None)
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
    if sys.argv[1:] == ["--lm"]:
        return lm_only(torch)
    if sys.argv[1:] == ["--train"]:
        return train_only(torch)
    if sys.argv[1:] == ["--dist"]:
        return dist_only(torch)
    if sys.argv[1:] == ["--tp"]:
        return tp_only(torch)
    if sys.argv[1:] == ["--serve-tp"]:
        return serve_tp_only(torch)
    if sys.argv[1:] == ["--launch-tools"]:
        return launch_tools_only(torch)
    if sys.argv[1:2] == ["--lm-trace"] and len(sys.argv) <= 3:
        from repro_torch.configs import ALIASES
        if sys.argv[2:] and sys.argv[2] not in ALIASES:
            print(f"chip_smoke: unknown arch {sys.argv[2]}", file=sys.stderr)
            return 2
        return lm_trace_only(torch, *sys.argv[2:])
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
    clock = PhaseClock()
    clock.start("1")
    # phase 21's dry-run counts, on one CPU core while the card works
    import concurrent.futures
    import multiprocessing

    counting_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    counting = counting_pool.submit(launch_tool_cells)

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
    clock.start("2")
    print("[2] kernels vs their plain versions", flush=True)
    gen = torch.Generator().manual_seed(0)
    rows = phase_kernels(torch, smoke, dev, gen)
    torch.cuda.empty_cache()
    path_launches = {name: 0 for name in kernels.launches()}

    def count(launched):
        for k, v in launched.items():
            path_launches[k] += v

    # -- 3. dual at the YMSD shape ---------------------------------------------
    clock.start("3")
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
    clock.start("4")
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
    clock.start("5")
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
    clock.start("6")
    print("[6] kernels.hinge_stats vs its plain version", flush=True)
    Xr, yr, _ = make_regression(*RAGGED, seed=3, device=dev)
    wr = torch.randn(RAGGED[0], generator=gen, dtype=torch.float64).to(dev) * 0.3
    rows["hinge_stats_cuda"], launched = phase_hinge_stats(
        torch, smoke, kernels, svm_state, dev,
        [glabra_case, ymsd_case, ("ragged", Xr, yr, 1.3, wr, 2.0)])
    count(launched)
    torch.cuda.empty_cache()

    # -- 7. the penalized front end --------------------------------------------
    clock.start("7")
    phase_front_end(torch, smoke, kernels, svm_state, count, ymsd_case[1:3],
                    glabra_case[1:3])
    del ymsd_case, glabra_case
    torch.cuda.empty_cache()

    # -- 8. a float32 problem --------------------------------------------------
    clock.start("8")
    gram_modes["f32"] = phase_float32(torch, smoke, kernels, svm_state, dev)
    torch.cuda.empty_cache()

    # -- 9. batched solves -----------------------------------------------------
    clock.start("9")
    print("[9] sven_batch: lane-batched solves vs sequential sven", flush=True)
    rows.update(phase_batch(torch, smoke, kernels, svm_state, count, dev, gen))
    torch.cuda.empty_cache()

    # -- 11. batched penalized solves and cross-validation ---------------------
    clock.start("11")
    print("[11] enet_batch and cross-validation: lane-batched root-finds vs sequential",
          flush=True)
    phase_cv(torch, smoke, kernels, svm_state, count, dev)
    torch.cuda.empty_cache()

    # -- 12. the serving runtime -----------------------------------------------
    clock.start("12")
    print("[12] the serving runtime: open-loop waves vs the cold reference drain, and "
          "the online session", flush=True)
    phase_serving(torch, smoke, kernels, svm_state, count, dev)
    torch.cuda.empty_cache()

    # -- 13. the multi-device layer --------------------------------------------
    clock.start("13")
    phase_multi_device(torch, smoke, kernels, svm_state, count, dev)
    torch.cuda.empty_cache()

    # -- 14. the multi-host serving coordinator --------------------------------
    clock.start("14")
    print("[14] the multi-host serving coordinator: worker processes on the card, one "
          "killed", flush=True)
    phase_multihost(torch, smoke, count, dev)
    torch.cuda.empty_cache()

    # -- 15. the LM serving path -----------------------------------------------
    clock.start("15")
    print("[15] the LM serving path: internlm2-1.8b at full width, and sven on its hidden "
          "states", flush=True)
    phase_lm(torch, smoke, kernels, svm_state, count, dev, card)
    torch.cuda.empty_cache()

    # -- 16. the MoE, SSM and MLA serving path ---------------------------------
    clock.start("16")
    print("[16] the MoE, SSM and MLA serving path: mixtral-8x7b and deepseek-v3 at full "
          "width, mamba2-130m whole", flush=True)
    phase_lm_moe(torch, smoke, dev, card)
    torch.cuda.empty_cache()

    # -- 17. the LM training path ----------------------------------------------
    clock.start("17")
    print("[17] the LM training path: internlm2-1.8b trained at full width and depth, "
          "mamba2-130m through a fault and a restart, mixtral-8x7b's MoE at full width",
          flush=True)
    phase_train(torch, smoke, kernels, svm_state, count, dev, card)
    torch.cuda.empty_cache()

    # -- 18-19. training over ranks --------------------------------------------
    clock.start("18-19")
    print("[18] data-parallel training: internlm2-1.8b's sharded step at full width and "
          "depth on 2 ranks, parity, the launcher across ranks, the pipeline, compression; "
          "then [19] FSDP and the \"model\" axis", flush=True)
    phase_dist(torch, smoke, dev, card)
    torch.cuda.empty_cache()

    # -- 20. prefill and decode on meshes --------------------------------------
    clock.start("20")
    print("[20] prefill and decode on (data, model) meshes in the dry run's serving layouts: "
          "internlm2-1.8b whole, mamba2-130m whole, jamba-v0.1-52b and mixtral-8x7b at full "
          "width", flush=True)
    phase_serve_tp(torch, smoke, dev, card)

    # -- 21. the launch tools ------------------------------------------------------
    clock.start("21")
    print("[21] the launch tools: the dry run's sven cells run at pod16x16's block on the "
          "card, its counts against phases 15-20, the twins of examples/", flush=True)
    cells = counting.result()
    counting_pool.shutdown()
    for prec, n_launch in phase_launch_tools(torch, smoke, dev, card, count, cells).items():
        gram_modes[prec] = gram_modes.get(prec, 0) + n_launch
    torch.cuda.empty_cache()

    # -- summary ---------------------------------------------------------------
    clock.start(None)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in clock.seconds.items()),
          flush=True)
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
