"""Serving entry points, the port of `repro/serve/engine.py`.

LM side: prefill_step / decode_step builders and a batched greedy
generation loop, each run under `torch.inference_mode()`. A step
handed `shardings` (the dry run's `in_shardings`, through
`dist.shardings.run_prefill` / `run_decode`) runs on this rank's blocks of
the parameters, rows and caches; `greedy_generate` with `shardings` runs
so in the active mesh context, every rank picking the same tokens from
logits gathered whole.

Elastic Net side: `ElasticNetEngine` — the shape-bucketed batch server of
DESIGN.md §6.4, a facade over the continuous-batching runtime
(`repro_torch.runtime.scheduler`, DESIGN.md §8). Incoming (n, p) problems
are padded up to a small ladder of power-of-two buckets, so arbitrary
request shapes hit a bounded set of launch shapes. Padding is exact, not
approximate: zero rows (with zero responses) add nothing to the Elastic
Net objective, and zero columns provably carry beta_j = 0 through the SVM
reduction, so the unpadded slice of the padded solution IS the original
solution (tested against unpadded `sven`).

The engine speaks both of the paper's problem forms: `submit` takes the
constrained (t, lambda2) and `submit_penalized` the glmnet-style
(lambda1, lambda2); penalized requests drain in their own buckets through
`core.api.enet_batch` (the lane-batched multiplier root-find, DESIGN.md §7)
and the same padding argument applies — zero columns are screened/zeroed
and the dummy batch-fill problems (X = 0) short-circuit to beta = 0.

`drain()` routes through the runtime scheduler, with warm starts from the
scheduler's solution cache. `drain_reference()` keeps the synchronous path —
one blocking, cold `sven_batch`/`enet_batch` call per bucket chunk — as the
parity oracle the runtime is tested and measured against.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.api import PathConfig, enet_batch
from repro_torch.core.batch import sven_batch
from repro_torch.core.sven import SvenConfig
from repro_torch.device import DeviceLike
from repro_torch.dist import shardings as dsh
from repro_torch.models import model as M
from repro_torch.runtime.cache import PENALIZED, SolutionCache
from repro_torch.runtime.scheduler import (ContinuousScheduler, EnResult, RuntimeStats,
                                           ceil_pow2, stack_padded)

#: The engine's stats ARE the runtime scheduler's.
EngineStats = RuntimeStats


def make_prefill_step(cfg: M.ModelConfig, max_len: int):
    """prefill_step(params, batch, shardings=None) -> (last_logits, caches).
    With `shardings` = (p_sh, b_sh), on this rank's blocks
    (`dist.shardings.run_prefill`): the caches are its blocks by the
    records `M.cache_records` resolves in the active mesh context, the
    logits its rows, whole over the vocabulary."""

    @torch.inference_mode()
    def prefill_step(params, batch, shardings=None):
        p_sh, b_sh = shardings or (None, None)
        c_sh = None if b_sh is None else M.cache_records(cfg, b_sh["tokens"].shape[0],
                                                          max_len)
        logits, caches = M.prefill(params, cfg, batch, max_len=max_len, records=p_sh,
                                   cache_records=c_sh, last_only=True)
        return logits[:, -1], caches

    return prefill_step


def make_decode_step(cfg: M.ModelConfig):
    """decode_step(params, tokens, caches, shardings=None) -> (logits,
    caches): one new token against the caches; the KV and latent caches
    are written in place. With `shardings` = (p_sh, tok_sh, c_sh), on this
    rank's blocks (`dist.shardings.run_decode`)."""

    @torch.inference_mode()
    def decode_step(params, tokens, caches, shardings=None):
        p_sh, _, c_sh = shardings or (None, None, None)
        return M.decode_step(params, cfg, tokens, caches, records=p_sh, cache_records=c_sh)

    return decode_step


def greedy_generate(params, cfg: M.ModelConfig, batch: dict, *, steps: int,
                    max_len: int, shardings=None) -> torch.Tensor:
    """Prefill then greedy-decode `steps` tokens: (B, steps + 1) token ids,
    (B, steps + 1, K) for codebooks, the first from the prefill's logits.
    With `shardings` = (p_sh, b_sh), in the active mesh context on this
    rank's blocks (`run_prefill`, `run_decode`): every rank returns the
    same tokens."""
    prefill_step = make_prefill_step(cfg, max_len)
    decode_step = make_decode_step(cfg)
    p_sh, b_sh = shardings or (None, None)
    params = dsh.place(params, p_sh)
    logits, caches = dsh.run_prefill(prefill_step, shardings, params, batch)
    c_sh = None if b_sh is None else M.cache_records(cfg, logits.shape[0], max_len)
    tok = torch.argmax(logits, dim=-1)
    outs = []
    for _ in range(steps):
        outs.append(tok)
        step_sh = None if shardings is None else (p_sh, dsh.batch_shardings(tok), c_sh)
        logits, caches = dsh.run_decode(decode_step, step_sh, params, tok, caches)
        tok = torch.argmax(logits, dim=-1)
    outs.append(tok)
    return torch.stack(outs, dim=1)


class ElasticNetEngine:
    """Queue + bucket + drain server for Elastic Net solves.

    `submit()` / `submit_penalized()` enqueue a problem and return a request
    id; `drain()` solves everything queued through the runtime scheduler —
    one warm-started `sven_batch`/`enet_batch` per bucket chunk, awaited at
    harvest. Because shapes are bucketed, steady-state traffic runs on a
    small, constant set of launch shapes — `stats.bucket_shapes` counts the
    distinct ones ever launched.

    The engine is drain-on-demand (no deadlines): for latency-driven
    continuous batching use `repro_torch.runtime.ContinuousScheduler`
    directly with a `max_wait` coalescing window, as `launch/serve_en.py`
    does. Runs on `device` (the CUDA device when none is named).
    """

    def __init__(self, config: SvenConfig = SvenConfig(), *,
                 path_config: PathConfig = PathConfig(),
                 max_batch: int = 64, min_n: int = 16, min_p: int = 8,
                 cache: Optional[SolutionCache] = "default",
                 cache_dir: Optional[str] = None, speculate: bool = False,
                 mesh=None, dtype: torch.dtype = torch.float64,
                 device: DeviceLike = None):
        if max_batch < 1 or min_n < 1 or min_p < 1:
            raise ValueError(f"ElasticNetEngine: max_batch/min_n/min_p must be "
                             f">= 1 (got {max_batch}/{min_n}/{min_p})")
        # `cache_dir` upgrades the default warm-start cache to the two-tier
        # one (DESIGN.md §11.2): solutions spill to a persistent directory
        # that survives engine restarts and is shareable across processes.
        # Ignored when an explicit cache instance (or None) is passed.
        if cache_dir is not None and cache == "default":
            from repro_torch.runtime.cache import TieredSolutionCache

            cache = TieredSolutionCache(spill_dir=cache_dir)
        self.config = config
        self.path_config = path_config
        self.max_batch = max_batch
        self.min_n = min_n
        self.min_p = min_p
        self.dtype = dtype
        # drain-on-demand: no deadlines AND no bucket-full auto-launch, so
        # nothing runs before an explicit drain/solve — which also keeps
        # drain_reference() a genuinely synchronous, untouched-queue oracle.
        self._scheduler = ContinuousScheduler(
            config, path_config=path_config, max_batch=max_batch,
            min_n=min_n, min_p=min_p, max_wait=None, cache=cache,
            auto_launch_full=False, mesh=mesh, speculate=speculate,
            dtype=dtype, device=device)
        self.device = self._scheduler.device

    @property
    def scheduler(self) -> ContinuousScheduler:
        """The underlying runtime scheduler (deadlines disabled)."""
        return self._scheduler

    @property
    def stats(self) -> RuntimeStats:
        return self._scheduler.stats

    @property
    def registry(self):
        """The scheduler's MetricsRegistry — the engine's whole telemetry
        (stats, cache counters, latency histograms) in one snapshot."""
        return self._scheduler.registry

    @property
    def cache(self) -> Optional[SolutionCache]:
        return self._scheduler.cache

    @property
    def _queue(self):
        return self._scheduler.pending_requests

    # -- request side ------------------------------------------------------

    def submit(self, X, y, t: float, lambda2: float) -> int:
        return self._scheduler.submit(X, y, t=t, lambda2=lambda2)

    def submit_penalized(self, X, y, lambda1: float, lambda2: float) -> int:
        """Enqueue a glmnet-style penalized request (DESIGN.md §7 front-end).

        Penalized requests bucket and pad exactly like constrained ones but
        drain through `core.api.enet_batch` — the lane-batched multiplier
        root-find that maps (lambda1, lambda2) onto the constrained engine.
        """
        return self._scheduler.submit(X, y, lambda1=lambda1, lambda2=lambda2)

    def solve(self, X, y, t: float, lambda2: float) -> EnResult:
        """Submit + solve a single request (convenience / interactive path).

        Only this request's bucket is launched; same-bucket ride-alongs that
        complete with it are held and returned by the next `drain()`.
        """
        req_id = self.submit(X, y, t, lambda2)
        return self._scheduler.result(req_id)

    # -- bucket side -------------------------------------------------------

    def bucket_of(self, n: int, p: int) -> tuple:
        return self._scheduler.bucket_of(n, p)

    # -- drain side --------------------------------------------------------

    def drain(self) -> dict:
        """Solve everything queued; returns {request_id: EnResult}, including
        any results solved earlier but not yet delivered."""
        return self._scheduler.drain()

    def drain_reference(self) -> dict:
        """The synchronous drain: one blocking, COLD (no warm-start cache)
        batched solve per bucket chunk, in bucket order.

        Kept as the parity oracle for the runtime path: `drain()` and
        `drain_reference()` return identical solutions to solver tolerance
        (tested), and the runtime's time is measured against this baseline.
        """
        queue = self._scheduler.take_pending()
        groups: dict = {}
        for req in queue:
            key = self._scheduler.bucket_of(*req.X.shape) + (req.form,)
            groups.setdefault(key, []).append(req)

        results = self._scheduler.harvest(block=True)
        done_ids: set = set()
        try:
            for (bn, bp, form), reqs in sorted(groups.items()):
                for lo in range(0, len(reqs), self.max_batch):
                    chunk = reqs[lo:lo + self.max_batch]
                    self._drain_chunk(bn, bp, chunk, results,
                                      form == PENALIZED)
                    done_ids.update(r.req_id for r in chunk)
        except Exception:
            # A failed chunk must not lose the rest of the queue: re-queue
            # unsolved requests (results already held stay claimable).
            self._scheduler.requeue(
                [r for g in groups.values() for r in g
                 if r.req_id not in done_ids])
            self._scheduler._results.update(results)
            raise
        return results

    def _drain_chunk(self, bn: int, bp: int, reqs: list, results: dict,
                     pen: bool = False) -> None:
        sched = self._scheduler
        b_real = len(reqs)
        b_pad = min(ceil_pow2(b_real, 1), self.max_batch)
        Xb, yb = stack_padded(reqs, bn, bp, b_pad, sched.np_dtype)
        fill = [1.0] * (b_pad - b_real)
        lamb = np.asarray([r.lam for r in reqs] + fill, sched.np_dtype)
        l2b = np.asarray([r.lambda2 for r in reqs] + fill, sched.np_dtype)

        def dev(a):
            return torch.from_numpy(a).to(sched.device)

        t0 = sched.clock()
        if pen:
            pts = enet_batch(dev(Xb), dev(yb), dev(lamb), dev(l2b), self.path_config)
            betas, iters, kkts = pts.beta, pts.sven_iters, pts.kkt
        else:
            sol = sven_batch(dev(Xb), dev(yb), dev(lamb), dev(l2b), self.config)
            betas, iters, kkts = sol.beta, sol.iters, sol.kkt
        # the blocking wait: the results on the host
        betas, iters, kkts = (a.cpu().numpy() if isinstance(a, torch.Tensor)
                              else np.asarray(a) for a in (betas, iters, kkts))
        now = sched.clock()
        sched.stats.solve_seconds += now - t0
        sched.stats.batches += 1
        sched.stats.padded_slots += b_pad - b_real
        sched._seen_shapes.add((bn, bp, b_pad, "ref-pen" if pen else "ref"))
        sched.stats.bucket_shapes = len(sched._seen_shapes)
        sched.metrics.launched([r.req_id for r in reqs], t0)
        sched.metrics.completed([r.req_id for r in reqs], now)

        for i, req in enumerate(reqs):
            p = req.X.shape[1]
            results[req.req_id] = EnResult(beta=betas[i, :p], iters=iters[i],
                                           kkt=kkts[i], bucket=(bn, bp))
