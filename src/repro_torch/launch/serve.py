"""Serving launcher: a batch of random prompts through prefill and greedy
decode, with prefill time and decode tokens per second. The port of
`repro/launch/serve.py`, with the same run, the same default arch
(mixtral-8x7b) and the same printed line.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
        --batch 4 --prompt-len 64 --gen 32 --device cpu
    python -m repro_torch.launch.serve --arch mamba2-130m --no-smoke

Runs the arch's SMOKE config unless `--no-smoke` asks for its full-width
CONFIG (JAX's `--smoke` cannot be turned off), on the CUDA device unless
`--device` names another. Weights are drawn from a generator seeded 0 and
prompts from one seeded 1, both on the run's device. `serve_config` runs
the same on a config given as it is (a depth-cut one, say).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import make_decode_step, make_prefill_step


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor    # (B, gen + 1) greedy tokens, (B, gen + 1, K) for codebooks
    prefill_s: float
    decode_s: float
    n_decoded: int          # tokens decoded: batch x gen

    @property
    def tok_per_s(self) -> float:
        return self.n_decoded / self.decode_s


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="the arch's reduced SMOKE config (default); --no-smoke runs "
                         "its full-width CONFIG")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA device)")
    return ap


def make_batch(cfg: M.ModelConfig, batch: int, prompt_len: int,
               generator: torch.Generator, device: torch.device) -> dict:
    """Random prompts for `cfg`'s front end: token ids, plus patch
    embeddings for "patches"."""
    def toks(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=generator, device=device)

    if cfg.frontend == "codebooks":
        return {"tokens": toks(batch, prompt_len, cfg.n_codebooks)}
    if cfg.frontend == "patches":
        return {"tokens": toks(batch, prompt_len),
                "patch_embeds": torch.randn((batch, cfg.vision_tokens, cfg.d_model),
                                            generator=generator, dtype=cfg.dtype,
                                            device=device)}
    return {"tokens": toks(batch, prompt_len)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_config(cfg: M.ModelConfig, *, batch: int, prompt_len: int, gen: int,
                 device: torch.device, params: Optional[dict] = None) -> ServeResult:
    """Serve one batch of `cfg` on `device` and print the launcher's line;
    `params` are drawn from a generator seeded 0 when none are given."""
    dev = device
    if params is None:
        params = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    max_len = prompt_len + gen + cfg.vision_tokens + 4
    prompts = make_batch(cfg, batch, prompt_len, torch.Generator(device=dev).manual_seed(1),
                         dev)

    prefill = make_prefill_step(cfg, max_len=max_len)
    decode = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits, dim=-1)

    toks = [tok]
    t0 = time.perf_counter()
    n = 0
    for _ in range(gen):
        logits, caches = decode(params, tok, caches)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        n += batch
    _sync(dev)
    t_decode = time.perf_counter() - t0
    print(f"[serve] {cfg.name}: prefill {batch}x{prompt_len} in "
          f"{t_prefill * 1e3:.0f} ms; decode {n} tokens in {t_decode * 1e3:.0f} ms "
          f"({n / t_decode:.0f} tok/s)", flush=True)
    return ServeResult(tokens=torch.stack(toks, dim=1), prefill_s=t_prefill,
                       decode_s=t_decode, n_decoded=n)


def serve(argv=None) -> ServeResult:
    """Parse `argv`, serve one batch, print the launcher's line."""
    args = _parser().parse_args(argv)
    return serve_config(get_config(args.arch, smoke=args.smoke), batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen,
                        device=resolve_device(args.device))


def run(argv=None) -> float:
    """The launcher's run: decode tokens per second."""
    return serve(argv).tok_per_s


if __name__ == "__main__":
    run()
