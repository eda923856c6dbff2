"""Quickstart, on the PyTorch port: the penalized glmnet-parity API end to
end, then the paper's raw constrained form (Algorithm 1). The twin of
examples/quickstart.py.

    python examples/quickstart_torch.py                 # on the current CUDA device
    python examples/quickstart_torch.py --device cpu

Every check bound is the repo's (ROADMAP, "How a slice is checked"): the
kernel solve against the plain one 1e-8 x max|beta|, the front end against
coordinate descent 5e-4 x max|beta_cd|. A failed check exits non-zero.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.baselines import elastic_net_cd  # noqa: E402
from repro_torch.core import ElasticNet, ElasticNetCV, SvenConfig, enet_path, sven  # noqa: E402
from repro_torch.core.elastic_net import lambda1_max  # noqa: E402
from repro_torch.data.synthetic import make_regression  # noqa: E402

CD_TOL = 5e-4        # x max|beta_cd|: a solve against coordinate descent
PLAIN_TOL = 1e-8     # x max|beta|: the kernel bodies against the plain products


def fit_elastic_net(X, y, lam1: float, lam2: float):
    """The glmnet user's fit: `ElasticNet(lam1, lam2)` with standardization
    and an intercept; its coefficients (p,) and intercept."""
    model = ElasticNet(lambda1=lam1, lambda2=lam2).fit(X, y)
    return model.coef_, model.intercept_, model.t_


def run(X, y, *, lam2: float = 1.0, n_lambdas: int = 20, folds: int = 5) -> dict:
    """The quickstart on (X, y) where they lie; prints each step and returns
    its check values."""
    p = X.shape[1]
    lam1 = 0.3 * float(lambda1_max(X, y))
    coef, intercept, t_fit = fit_elastic_net(X, y, lam1, lam2)
    nnz = int((coef.abs() > 1e-8).sum())
    print(f"ElasticNet(lambda1={lam1:.2f}): {nnz} / {p} features, "
          f"intercept={float(intercept):.2e}, mapped to t={float(t_fit):.3f}")

    # parity with the coordinate-descent baseline (the glmnet stand-in),
    # run on a CPU copy: its sweep is a host loop over coordinates
    beta_cd = elastic_net_cd(X.cpu(), y.cpu(), lam1, lam2).beta.to(X.device)
    res = ElasticNet(lam1, lam2, standardize=False, fit_intercept=False).fit(X, y)
    cd_dev = float((res.coef_ - beta_cd).abs().max())
    print(f"max |beta_sven - beta_cd| = {cd_dev:.2e}")

    path = enet_path(X, y, n_lambdas=n_lambdas, lambda2=lam2)
    print(f"enet_path: {path.betas.shape[0]} lambdas, screened problem sizes "
          f"{int(path.n_kept.min())}..{int(path.n_kept.max())} of {p}")

    cv = ElasticNetCV(k=folds, n_lambdas=n_lambdas, lambda2=lam2).fit(X, y)
    print(f"ElasticNetCV: lambda_min={cv.lambda_min_:.3f} "
          f"(grid point {int(torch.argmin(cv.mean_mse_))}/{n_lambdas}), "
          f"cv_mse={float(cv.mean_mse_.min()):.4f}")

    t = float(beta_cd.abs().sum())
    sol = sven(X, y, t, lam2)   # 2p > n: the primal Newton-CG
    print(f"sven: mode={sol.mode}  newton_iters={int(sol.iters)}  "
          f"kkt_violation={float(sol.kkt):.2e}")
    # the kernel bodies (CUDA on the card, their plain versions on the CPU)
    # against the plain products
    plain = sven(X, y, t, lam2, SvenConfig(backend="torch"))
    plain_dev = float((sol.beta - plain.beta).abs().max())
    print(f"kernel vs plain backend agreement: {plain_dev:.2e}")
    scale_cd = float(beta_cd.abs().max())
    return {"cd_dev": cd_dev, "cd_bound": CD_TOL * scale_cd,
            "sven_cd_dev": float((sol.beta - beta_cd).abs().max()),
            "plain_dev": plain_dev, "plain_bound": PLAIN_TOL * float(plain.beta.abs().max()),
            "path_finite": bool(torch.isfinite(path.betas).all()),
            "cv_finite": bool(torch.isfinite(cv.mean_mse_).all()), "coef": coef}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--p", type=int, default=500)
    ap.add_argument("--n-lambdas", type=int, default=20)
    args = ap.parse_args(argv)
    # a p >> n problem (the Elastic Net's home turf: genomics/fMRI shapes)
    X, y, _ = make_regression(args.n, args.p, k_true=8, rho=0.4, seed=0,
                              device=args.device)
    out = run(X, y, n_lambdas=args.n_lambdas)
    failed = [name for name, ok in (
        ("front end vs CD", out["cd_dev"] <= out["cd_bound"]),
        ("sven vs CD", out["sven_cd_dev"] <= out["cd_bound"]),
        ("kernel vs plain", out["plain_dev"] <= out["plain_bound"]),
        ("path finite", out["path_finite"]), ("CV finite", out["cv_finite"])) if not ok]
    if failed:
        raise SystemExit(f"quickstart_torch: checks failed: {failed}")
    return out


if __name__ == "__main__":
    main()
