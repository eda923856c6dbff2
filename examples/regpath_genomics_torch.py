"""A full regularization path on a genomics-scale p >> n problem, on the
PyTorch port: warm-started across the t grid, with correctness audits (KKT
residuals per point) and timing against the coordinate-descent baseline.
The twin of examples/regpath_genomics.py.

    python examples/regpath_genomics_torch.py [--p 20000] [--n 200] [--device cpu]

SVEN solves on --device (CUDA by default). The coordinate-descent
baseline is a host loop over coordinates (`baselines/coordinate_descent.py`)
and runs on a CPU copy of the data. A point whose SVEN beta lies further
than 5e-4 x max|beta_cd| from CD's (the primal kernel path's bound against
CD) exits non-zero.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.baselines import elastic_net_cd  # noqa: E402
from repro_torch.core import SvenConfig, sven  # noqa: E402
from repro_torch.core.elastic_net import lambda1_max  # noqa: E402
from repro_torch.data.synthetic import make_regression  # noqa: E402

CD_TOL = 5e-4       # x max|beta_cd|


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=150)
    ap.add_argument("--p", type=int, default=8000)
    ap.add_argument("--points", type=int, default=10)
    ap.add_argument("--lam2", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"generating gene-expression-like problem n={args.n} p={args.p} ...")
    X, y, _ = make_regression(args.n, args.p, k_true=30, rho=0.5, noise=0.3, seed=7,
                              device=args.device)
    dev = X.device
    Xc, yc = X.cpu(), y.cpu()
    l1max = float(lambda1_max(X, y))

    print(f"{'frac':>6} {'t':>9} {'nnz':>5} {'kkt':>9} {'sven_ms':>8} {'cd_ms':>8} {'dev':>9}")
    rows, warm_w, beta_cd = [], None, None
    for frac in np.geomspace(0.7, 0.05, args.points):
        t0 = time.perf_counter()
        res = elastic_net_cd(Xc, yc, float(frac * l1max), args.lam2, beta0=beta_cd)
        beta_cd = res.beta
        cd_ms = (time.perf_counter() - t0) * 1e3
        t = float(beta_cd.abs().sum())
        if t < 1e-8:
            continue
        sync(dev)
        t0 = time.perf_counter()
        sol = sven(X, y, t, args.lam2, SvenConfig(tol=1e-8), warm_w=warm_w)
        sync(dev)
        sven_ms = (time.perf_counter() - t0) * 1e3
        warm_w = sol.w
        ref = beta_cd.to(dev)
        dev_b = float((sol.beta - ref).abs().max())
        nnz = int((sol.beta.abs() > 1e-8).sum())
        print(f"{frac:6.3f} {t:9.3f} {nnz:5d} {float(sol.kkt):9.2e} "
              f"{sven_ms:8.1f} {cd_ms:8.1f} {dev_b:9.2e}")
        rows.append({"frac": float(frac), "t": t, "kkt": float(sol.kkt), "dev": dev_b,
                     "bound": CD_TOL * float(ref.abs().max()), "sven_ms": sven_ms,
                     "cd_ms": cd_ms})
    bad = [r["frac"] for r in rows if not r["dev"] <= r["bound"]]
    if bad:
        raise SystemExit(f"regpath_genomics_torch: SVEN left CD's path by more than "
                         f"{CD_TOL:g} x max|beta_cd| at frac {bad}")
    print("path complete — SVEN reproduces the CD path (dev column).")
    return rows


if __name__ == "__main__":
    main()
