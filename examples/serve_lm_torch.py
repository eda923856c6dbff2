"""Batched LM serving on the PyTorch port: prefill a batch of prompts, then
greedy-decode new tokens with the KV/SSM caches (the decode cells' code
path). The twin of examples/serve_lm.py.

    python examples/serve_lm_torch.py --arch mixtral-8x7b --steps 16 [--device cpu]

Reduced (SMOKE) configs, random weights from seed 0. Exits non-zero when a
generated token lies outside the vocabulary.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import greedy_generate  # noqa: E402


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    B, S = args.batch, args.prompt_len
    if cfg.frontend == "codebooks":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S, cfg.n_codebooks),
                                         generator=gen, device=dev)}
    elif cfg.frontend == "patches":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev),
                 "patch_embeds": torch.randn((B, cfg.vision_tokens, cfg.d_model), generator=gen,
                                             device=dev).to(cfg.dtype)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)}

    out = greedy_generate(params, cfg, batch, steps=args.steps,
                          max_len=args.prompt_len + args.steps + cfg.vision_tokens + 4)
    print(f"arch={cfg.name} generated token ids, shape {tuple(out.shape)}:")
    print(out[:, :10].cpu())
    if out.shape[:2] != (B, args.steps + 1) or not bool(((out >= 0) &
                                                         (out < cfg.vocab_size)).all()):
        raise SystemExit(f"serve_lm_torch: tokens of shape {tuple(out.shape)} outside "
                         f"[0, {cfg.vocab_size})")
    return out


if __name__ == "__main__":
    main()
