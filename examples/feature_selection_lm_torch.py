"""The paper's use case on the LM substrate, on the PyTorch port: SVEN
selects a sparse set of hidden-state features that linearly predict a
target signal from a frozen LM's activations (n = examples, p = hidden
features). The twin of examples/feature_selection_lm.py.

    python examples/feature_selection_lm_torch.py [--device cpu]

internlm2-1.8b's SMOKE config, random weights from seed 0. SVEN runs on
--device; the coordinate-descent baseline, a host loop, on a CPU copy.
Exits non-zero when SVEN lies further than 5e-4 x max|beta_cd| from CD.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.baselines import elastic_net_cd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import sven  # noqa: E402
from repro_torch.core.elastic_net import lambda1_max  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

CD_TOL = 5e-4       # x max|beta_cd|


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_config("internlm2-1.8b", smoke=True)
    params = M.init_model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                          device=dev)

    # final-layer activations over a batch of sequences
    B, S = args.batch, args.seq
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    with torch.no_grad():
        _, _, h = M.forward(params, cfg, {"tokens": toks}, return_hidden=True)
    X = h[:, -1, :].to(torch.float64)                       # (n=B, p=d_model)
    X = (X - X.mean(0)) / (X.std(0, unbiased=False) + 1e-9)

    # target: a synthetic signal driven by a sparse set of hidden units
    true_idx = torch.randperm(cfg.d_model, generator=gen, device=dev)[:5]
    w = torch.randn(5, generator=gen, device=dev, dtype=torch.float64)
    y = X[:, true_idx] @ w + 0.05 * torch.randn(B, generator=gen, device=dev,
                                                 dtype=torch.float64)
    y = y - y.mean()

    lam2 = 0.5
    l1 = 0.25 * float(lambda1_max(X, y))
    beta_cd = elastic_net_cd(X.cpu(), y.cpu(), l1, lam2).beta.to(dev)
    t = float(beta_cd.abs().sum())
    sol = sven(X, y, t, lam2)

    picked = torch.nonzero(sol.beta.abs() > 1e-6)[:, 0].tolist()
    truth = sorted(true_idx.tolist())
    dev_cd = float((sol.beta - beta_cd).abs().max())
    print(f"true feature ids:   {truth}")
    print(f"SVEN selected ids:  {sorted(picked)}")
    hit = len(set(truth) & set(picked))
    print(f"recovered {hit}/5 true features; agreement with CD: {dev_cd:.2e}")
    bound = CD_TOL * float(beta_cd.abs().max())
    if not dev_cd <= bound:
        raise SystemExit(f"feature_selection_lm_torch: SVEN lies {dev_cd:.3e} from CD "
                         f"(bound {bound:.3e})")
    return {"dev": dev_cd, "bound": bound, "hit": hit, "picked": picked}


if __name__ == "__main__":
    main()
