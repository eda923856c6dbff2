"""Training launcher: init, the train step, checkpoint/restart, a
supervised retry loop (fault tolerance) and a per-step watchdog
(straggler detection). The port of `repro/launch/train.py`, with JAX's
flags (plus `--device`) and JAX's printed lines.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \\
        --steps 200 --ckpt-dir /tmp/ckpt --device cpu
    python -m repro_torch.launch.train --arch internlm2-1.8b --steps 20

Runs on the CUDA device unless `--device` names another, and raises
where there is none. `--smoke` (off by default, as in JAX's train
launcher) runs the arch's reduced SMOKE config. Parameters are drawn from
a generator seeded 0 on the run's device, and batches come from
`data.pipeline.SyntheticStream` (seed 0). `train_config` runs the same
loop on a config given as it is (a depth-cut one, say).

The loop runs inside `dist.mesh_context(make_local_mesh(), rules=
{**DEFAULT_RULES, **cfg.rules_override})`, as JAX's: the mesh is the
default process group's, one rank when none is initialized. So

    dist.launch(train.train, W, args=(argv,))

trains on W ranks with no flag: each rank draws the same global batch,
computes on its block of the rows, and the gradients are all-reduced
(`train/step.py`); parameters and moments stay replicated, as under JAX's
`jit` with no shardings, and the loss read is the global loss, so every
rank prints and checks the same number. Rank 0 writes the checkpoints.

Fault-tolerance model (exercised on one host):
  * every step is a pure function of (params, opt_state, step_index) and the
    deterministic data pipeline => restart-exactness;
  * the supervisor catches step failures (flaky node <-> injected fault),
    restores the latest checkpoint and resumes — bounded retries;
  * a wall-clock watchdog flags steps exceeding `watchdog_factor` x the
    rolling median step time (straggler detection: it logs);
  * checkpoints are atomic + content-hashed (`ckpt/checkpoint.py`).
The loss read after each step (`float`) is the step's one host sync.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import statistics
import time
from typing import Optional

import torch

from repro_torch import dist
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw_init, warmup_cosine
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainResult:
    loss: float             # the last completed step's loss (nan if none ran)
    losses: list            # every completed step's loss, in the order run
    step_s: list            # their seconds, host clock up to the loss read
    step: int               # the step reached
    params: dict
    opt_state: AdamWState
    metrics: Optional[dict]  # the last completed step's metrics (device tensors)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--watchdog-factor", type=float, default=5.0)
    ap.add_argument("--inject-fault-at", type=int, default=-1,
                    help="test hook: raise at this step once (supervisor must recover)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA device)")
    return ap


def build_state(cfg: M.ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None):
    """(params drawn from `generator` (one on `device` seeded 0 when none
    is given), their AdamW state)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = M.init_model(cfg, generator=generator, device=dev)
    return params, adamw_init(params)


def train_config(cfg: M.ModelConfig, args: argparse.Namespace,
                 device: torch.device) -> TrainResult:
    """The launcher's loop on `cfg` with the parsed flags `args` (see
    `_parser`) on `device`, under the local mesh; prints JAX's lines."""
    mesh = make_local_mesh()
    with dist.mesh_context(mesh, rules={**dist.DEFAULT_RULES, **cfg.rules_override}):
        return _loop(cfg, args, device)


def _loop(cfg: M.ModelConfig, args: argparse.Namespace, device: torch.device) -> TrainResult:
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch,
                      n_codebooks=cfg.n_codebooks if cfg.frontend == "codebooks" else 0,
                      vision_tokens=cfg.vision_tokens if cfg.frontend == "patches" else 0,
                      d_model=cfg.d_model)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    schedule = warmup_cosine(args.lr, max(10, args.steps // 20), args.steps)

    params, opt_state = build_state(cfg, device=device)
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        (params, opt_state), start_step, _ = ckpt.restore((params, opt_state))
        print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = make_train_step(cfg, microbatches=args.microbatches, lr_schedule=schedule)

    stream = SyntheticStream(dcfg, start_step=start_step, device=device)
    injected = False
    retries = 0
    step = start_step
    times: list[float] = []
    losses: list[float] = []
    loss, metrics = math.nan, None
    while step < args.steps:
        batch = next(stream)
        try:
            if step == args.inject_fault_at and not injected:
                injected = True
                raise RuntimeError("injected node failure")
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])  # sync point
            dt = time.perf_counter() - t0
            times.append(dt)
            losses.append(loss)
            if len(times) > 5:
                med = statistics.median(times[-50:])
                if dt > args.watchdog_factor * med:
                    print(f"[watchdog] step {step} took {dt:.3f}s "
                          f"(median {med:.3f}s) — straggler suspected", flush=True)
            if not math.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {step}")
        except Exception as e:  # supervisor: restore + retry
            retries += 1
            print(f"[supervisor] step {step} failed ({e}); retry {retries}", flush=True)
            if retries > args.max_retries:
                raise
            if ckpt and ckpt.latest_step() is not None:
                (params, opt_state), step, _ = ckpt.restore((params, opt_state))
                stream.step = step
            continue
        step += 1
        stream.step = step
        if step % args.log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"({dt * 1e3:.0f} ms)", flush=True)
        if ckpt and step % args.ckpt_every == 0:
            ckpt.save(step, (params, opt_state), extra={"arch": args.arch})
    if ckpt:
        ckpt.save(step, (params, opt_state), extra={"arch": args.arch})
    print(f"[train] done at step {step}, final loss {loss:.4f}", flush=True)
    return TrainResult(loss=loss, losses=losses, step_s=times, step=step, params=params,
                       opt_state=opt_state, metrics=metrics)


def train(*args) -> TrainResult:
    """Parse argv and train the arch it names: `train(argv)` in one
    process, `train(mesh, argv)` as `dist.launch(train, W, args=(argv,))`
    calls it on each rank (the mesh is the default process group's either
    way)."""
    if args and isinstance(args[0], dist.Mesh):
        args = args[1:]
    args = _parser().parse_args(*args[:1])
    device = resolve_device(args.device)
    return train_config(get_config(args.arch, smoke=args.smoke), args, device)


def run(argv=None) -> float:
    """The launcher's run: the final loss."""
    return train(argv).loss


if __name__ == "__main__":
    run()
