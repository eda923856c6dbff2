"""Distributed SVEN over the ranks of a process group, on the PyTorch port:
the paper's solver with feature-split Hessian mat-vecs, the sample-split
Gram build and the row-split production solve. The twin of
examples/distributed_sven.py, whose 8 forced host devices become W rank
processes (`repro_torch.dist.launch`: spawned, gloo, 2 by default).

    python examples/distributed_sven_torch.py [--ranks 2] [--device cpu]

Ranks on the CPU run gloo; on CUDA every rank shares the card under gloo
unless each has a card of its own (NCCL). Each part is held to a
one-device reference computed on the rank (the primal against coordinate
descent 5e-4 x max|beta_cd|, the Gram against `gram_reference` 1e-10 x
max|K|, the sharded solve against `sven` 1e-10 x max|beta|); a failed
check exits non-zero.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import dist  # noqa: E402

CD_TOL = 5e-4        # x max|beta_cd|
GRAM_TOL = 1e-10     # x max|K|
SHARDED_TOL = 1e-10  # x max|beta|


def parts(mesh: dist.Mesh) -> dict:
    """The three parts on this rank of `mesh` (every rank calls it alike);
    each returns its deviation and bound."""
    from repro_torch.baselines import elastic_net_cd
    from repro_torch.core import sven, sven_sharded
    from repro_torch.core.distributed import distributed_gram, sven_primal_distributed
    from repro_torch.core.elastic_net import lambda1_max
    from repro_torch.core.reduction import gram_reference
    from repro_torch.data.synthetic import make_regression

    dev = mesh.device
    out = {"ranks": mesh.size, "backend": mesh.backend}

    # p >> n: feature-split primal solve
    X, y, _ = make_regression(48, 512, k_true=10, rho=0.3, seed=0, device=dev)
    l1 = 0.3 * float(lambda1_max(X, y))
    beta_cd = elastic_net_cd(X.cpu(), y.cpu(), l1, 1.0).beta.to(dev)
    t = float(beta_cd.abs().sum())
    beta, res = sven_primal_distributed(mesh, X, y, t, 1.0)
    out["primal"] = (int(res.iters), float((beta - beta_cd).abs().max()),
                     CD_TOL * float(beta_cd.abs().max()))

    # n >> p: sample-split Gram build (one all-reduce of G, u, s)
    X2, y2, _ = make_regression(4096, 64, seed=1, device=dev)
    K = distributed_gram(mesh, X2, y2, 1.2, row_shard_out=False)
    K_ref = gram_reference(X2, y2, 1.2)
    out["gram"] = (float((K - K_ref).abs().max()), GRAM_TOL * float(K_ref.abs().max()))

    # the production sharded solve: rows of Zhat over the ranks, parity with
    # the single-device engine
    X3, y3, _ = make_regression(600, 48, seed=2, device=dev)
    s0 = sven(X3, y3, 1.3, 1.0)
    s1 = sven_sharded(X3, y3, 1.3, 1.0, mesh=mesh)
    out["sharded"] = (s1.mode, int(s1.iters), float((s1.beta - s0.beta).abs().max()),
                      SHARDED_TOL * float(s0.beta.abs().max()))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("distributed_sven_torch: CUDA is not available; pass --device cpu "
                           "to run on the CPU")
    out = dist.launch(parts, args.ranks, device=dev.type, timeout=600,
                      threads=1 if dev.type == "cpu" else 0)
    print(f"mesh: {out['ranks']} ranks over {out['backend']}")
    iters, d_p, b_p = out["primal"]
    print(f"primal: iters={iters} max|beta - beta_cd|={d_p:.2e}")
    d_g, b_g = out["gram"]
    print(f"gram:   max err vs reference = {d_g:.2e}")
    mode, s_iters, d_s, b_s = out["sharded"]
    print(f"sharded: mode={mode} iters={s_iters} max|beta_sharded - beta| = {d_s:.2e}")
    failed = [name for name, ok in (("primal", d_p <= b_p), ("gram", d_g <= b_g),
                                    ("sharded", d_s <= b_s)) if not ok]
    if failed:
        raise SystemExit(f"distributed_sven_torch: checks failed: {failed}")
    return out


if __name__ == "__main__":
    main()
