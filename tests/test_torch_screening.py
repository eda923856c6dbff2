"""Port parity of gap-safe screening and of the penalized baselines:
`repro_torch.core.screening` and `repro_torch.baselines` against the JAX
package on the same float64 numpy problems. Screening: keep masks equal,
duality gap within 1e-12. Coordinate descent, its path and FISTA: beta
within 1e-10, the same sweep / iteration counts."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import cpu, npy, problem
from repro.baselines.coordinate_descent import cd_path as jcd_path
from repro.baselines.coordinate_descent import elastic_net_cd as jcd
from repro.baselines.fista import elastic_net_fista as jfista
from repro.core import screening as jscr
from repro.core.sven import SvenConfig as JaxConfig
from repro_torch.baselines import cd_path, elastic_net_cd, elastic_net_fista
from repro_torch.convert import config_from_jax
from repro_torch.core import screening as tscr

TOL = 1e-10


def _problem(n, p, seed):
    X, y = problem(n, p, seed=seed, k_true=6)
    return (X, y), (jnp.asarray(X), jnp.asarray(y)), cpu(X, y)


def _l1max(X, y):
    return float(2.0 * np.abs(X.T @ y).max())


@pytest.mark.parametrize("n,p,seed,frac,lam2", [(40, 120, 0, 0.3, 1.0),
                                                (60, 25, 2, 0.1, 0.5)])
def test_cd_and_fista_match_jax(n, p, seed, frac, lam2):
    (X, y), (Xj, yj), (Xt, yt) = _problem(n, p, seed)
    l1 = frac * _l1max(X, y)
    jr, tr = jcd(Xj, yj, l1, lam2), elastic_net_cd(Xt, yt, l1, lam2)
    np.testing.assert_allclose(npy(tr.beta), npy(jr.beta), rtol=0, atol=TOL)
    assert tr.sweeps == int(jr.sweeps) and tr.delta <= 1e-12
    # warm-started from a perturbed point
    b0 = np.asarray(jr.beta) + 0.01
    jw = jcd(Xj, yj, l1, lam2, beta0=jnp.asarray(b0))
    tw = elastic_net_cd(Xt, yt, l1, lam2, beta0=cpu(b0))
    np.testing.assert_allclose(npy(tw.beta), npy(jw.beta), rtol=0, atol=TOL)
    assert tw.sweeps == int(jw.sweeps)
    jf, tf = jfista(Xj, yj, l1, lam2), elastic_net_fista(Xt, yt, l1, lam2)
    np.testing.assert_allclose(npy(tf.beta), npy(jf.beta), rtol=0, atol=TOL)
    assert tf.iters == int(jf.iters)
    np.testing.assert_allclose(npy(tf.beta), npy(tr.beta), rtol=0, atol=1e-8)
    jf40 = jfista(Xj, yj, l1, lam2, max_iters=40)
    tf40 = elastic_net_fista(Xt, yt, l1, lam2, max_iters=40)
    assert tf40.iters == int(jf40.iters) == 40
    np.testing.assert_allclose(npy(tf40.beta), npy(jf40.beta), rtol=0, atol=TOL)


def test_cd_path_matches_jax():
    (X, y), (Xj, yj), (Xt, yt) = _problem(50, 30, 4)
    grid = _l1max(X, y) * np.geomspace(1.0, 1e-2, 12)
    np.testing.assert_allclose(npy(cd_path(Xt, yt, grid, 0.8)),
                               npy(jcd_path(Xj, yj, grid, 0.8)), rtol=0, atol=TOL)
    # a tensor grid gives the same path
    np.testing.assert_array_equal(npy(cd_path(Xt, yt, cpu(grid), 0.8)),
                                  npy(cd_path(Xt, yt, grid, 0.8)))


@pytest.mark.parametrize("warm", ["exact", "crude", "zero"])
@pytest.mark.parametrize("frac,lam2", [(0.4, 1.0), (0.15, 0.3)])
def test_gap_safe_screen_matches_jax(warm, frac, lam2):
    (X, y), (Xj, yj), (Xt, yt) = _problem(45, 160, 3)
    l1 = frac * _l1max(X, y)
    beta = {"exact": np.asarray(jcd(Xj, yj, l1, lam2).beta),
            "crude": np.asarray(jfista(Xj, yj, l1, lam2, max_iters=40).beta),
            "zero": np.zeros(160)}[warm]
    js = jscr.gap_safe_screen(Xj, yj, jnp.asarray(beta), l1, lam2)
    ts = tscr.gap_safe_screen(Xt, yt, cpu(beta), l1, lam2)
    np.testing.assert_array_equal(npy(ts.keep), npy(js.keep))
    assert int(ts.n_kept) == int(js.n_kept)
    assert abs(float(ts.gap) - float(js.gap)) <= 1e-12
    if warm == "exact":
        assert int(ts.n_kept) < 160 and float(ts.gap) < 1e-6


def test_gap_safe_screen_keeps_everything_at_lambda1_zero():
    (X, y), (Xj, yj), (Xt, yt) = _problem(30, 50, 5)
    beta = np.random.default_rng(0).standard_normal(50) * 0.1
    ts = tscr.gap_safe_screen(Xt, yt, cpu(beta), 0.0, 1.0)
    js = jscr.gap_safe_screen(Xj, yj, jnp.asarray(beta), 0.0, 1.0)
    assert bool(ts.keep.all()) and int(ts.n_kept) == 50
    np.testing.assert_array_equal(npy(ts.keep), npy(js.keep))
    assert np.isfinite(float(ts.gap))


@pytest.mark.parametrize("warm", ["exact", "none"])
def test_sven_with_screening_matches_jax(warm):
    """Screen-then-solve on the plain backend ("torch" vs "xla"): the same
    mask, beta within 1e-10, exact zeros on the dropped columns."""
    (X, y), (Xj, yj), (Xt, yt) = _problem(45, 160, 3)
    lam2 = 1.0
    l1 = 0.35 * _l1max(X, y)
    beta_cd = jcd(Xj, yj, l1, lam2).beta
    t = float(jnp.sum(jnp.abs(beta_cd)))
    jcfg = JaxConfig(tol=1e-10)
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    jwarm = beta_cd if warm == "exact" else None
    twarm = cpu(np.asarray(beta_cd)) if warm == "exact" else None
    jb, _, jscr_res = jscr.sven_with_screening(Xj, yj, t, lam2, warm_beta=jwarm,
                                               config=jcfg)
    tb, tsol, tscr_res = tscr.sven_with_screening(Xt, yt, t, lam2, warm_beta=twarm,
                                                  config=tcfg)
    np.testing.assert_array_equal(npy(tscr_res.keep), npy(jscr_res.keep))
    assert int(tscr_res.n_kept) < 160
    np.testing.assert_allclose(npy(tb), npy(jb), rtol=0, atol=TOL)
    assert (npy(tb)[~npy(tscr_res.keep).astype(bool)] == 0.0).all()
    assert tsol.beta.shape == (int(tscr_res.n_kept),)
    np.testing.assert_allclose(npy(tb), npy(beta_cd), rtol=0, atol=1e-7)
