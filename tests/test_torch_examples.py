"""The PyTorch twins of examples/ (`examples/*_torch.py`) on the CPU: each
twin's `main` at its smallest arguments with `--device cpu` passes its own
checks (the repo's bounds: a solve against coordinate descent 5e-4 x
max|beta_cd|, the kernel bodies against the plain products 1e-8 x, the
sharded solve 1e-10 x), the quickstart's `ElasticNet` equals JAX's
`ElasticNet.fit` on the same numpy data within 1e-10 x max|coef|, and no
twin runs on when its CUDA device is missing."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
sys.path.insert(0, str(EXAMPLES))

import distributed_sven_torch  # noqa: E402
import feature_selection_lm_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import regpath_genomics_torch  # noqa: E402
import serve_lm_torch  # noqa: E402
import train_lm_torch  # noqa: E402

TWINS = {
    "quickstart": (quickstart_torch, ["--n", "30", "--p", "120", "--n-lambdas", "3"]),
    "regpath_genomics": (regpath_genomics_torch, ["--n", "40", "--p", "200", "--points", "3"]),
    "distributed_sven": (distributed_sven_torch, []),
    "train_lm": (train_lm_torch, ["--steps", "3", "--batch", "4", "--seq", "32"]),
    "serve_lm": (serve_lm_torch, ["--steps", "4", "--prompt-len", "8"]),
    "feature_selection_lm": (feature_selection_lm_torch, []),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These problems are small: one CPU thread runs them fastest (and as
    they run on a shared host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_runs_on_the_cpu_and_passes_its_checks(name, capsys):
    mod, argv = TWINS[name]
    out = mod.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.strip()
    if name == "quickstart":
        assert out["cd_dev"] <= out["cd_bound"] and out["plain_dev"] <= out["plain_bound"]
        assert out["sven_cd_dev"] <= out["cd_bound"]
    elif name == "regpath_genomics":
        assert len(out) == 3 and all(r["dev"] <= r["bound"] and r["kkt"] < 1e-6 for r in out)
    elif name == "distributed_sven":
        assert out["ranks"] == 2 and out["backend"] == "gloo"
        assert out["primal"][1] <= out["primal"][2] and out["gram"][0] <= out["gram"][1]
        assert out["sharded"][2] <= out["sharded"][3]
    elif name == "train_lm":
        assert len(out.losses) == 3 and all(np.isfinite(out.losses))
    elif name == "serve_lm":
        assert tuple(out.shape[:2]) == (4, 5)
    else:
        assert out["dev"] <= out["bound"]


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_does_not_fall_back_to_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod, argv = TWINS[name]
    with pytest.raises((RuntimeError, AssertionError)):
        mod.main(argv + ["--device", "cuda"])


def test_quickstart_elastic_net_equals_jax():
    import jax.numpy as jnp
    from repro.core import ElasticNet as JElasticNet
    from repro.core.elastic_net import lambda1_max as j_lambda1_max
    from repro.data.synthetic import make_regression as j_make_regression

    X, y, _ = j_make_regression(n=60, p=500, k_true=8, rho=0.4, seed=0)
    X, y = np.array(X), np.array(y)
    lam1 = 0.3 * float(j_lambda1_max(jnp.asarray(X), jnp.asarray(y)))
    want = np.asarray(JElasticNet(lambda1=lam1, lambda2=1.0).fit(X, y).coef_)
    coef, _, _ = quickstart_torch.fit_elastic_net(torch.from_numpy(X), torch.from_numpy(y),
                                                  lam1, 1.0)
    dev = float(np.abs(coef.numpy() - want).max())
    assert dev <= 1e-10 * float(np.abs(want).max()), dev
