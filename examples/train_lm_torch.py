"""End-to-end LM training on the PyTorch port: trains a reduced (SMOKE)
config through the full launcher stack (AdamW, checkpointing, supervised
retries, deterministic data) and prints the loss curve. The twin of
examples/train_lm.py.

    python examples/train_lm_torch.py --arch mamba2-130m --steps 60 [--device cpu]

Full-size runs use the same entry point:
    python -m repro_torch.launch.train --arch mamba2-130m --steps 500 --batch 64 ...

Checkpoints go to a temporary directory. Exits non-zero when a step's loss
is not finite.
"""
import argparse
import math
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro-example-ckpt-") as ckpt:
        res = train(["--arch", args.arch, "--smoke", "--steps", str(args.steps),
                     "--batch", str(args.batch), "--seq", str(args.seq), "--ckpt-dir", ckpt,
                     "--log-every", "5", "--device", args.device])
    print(f"final loss: {res.loss:.4f}")
    if len(res.losses) != args.steps or not all(math.isfinite(x) for x in res.losses):
        raise SystemExit(f"train_lm_torch: {len(res.losses)} losses of {args.steps} steps, "
                         f"not all finite: {res.losses}")
    return res


if __name__ == "__main__":
    main()
