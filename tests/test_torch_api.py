"""Port parity of the penalized front end: `repro_torch.core.api` against
`repro.core.api` on the same float64 numpy problems.

Bounds: on the plain backend ("torch" vs JAX "xla") beta within 1e-10, the
multiplier nu within 1e-10 * lambda1_max and the budget t within
1e-10 * t_ridge, with the same Illinois evaluations per point; the path
against warm-started coordinate descent within 1e-5 on a 40-point grid
(tests/test_api_cv.py::test_enet_path_matches_cd_40_points); the default
config on CPU tensors (the kernels' plain versions, "ref") within the f32
kernel path's 5e-4 * max|beta| (tests/test_sven_equivalence.py); both
packages' defaults on a float64 problem (the port's Gram and hinge passes
summed in float64) beta within 1e-10, with the same Illinois evaluations.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu, npy, problem
from repro.core import api as japi
from repro_torch.baselines import cd_path
from repro_torch.convert import carry_from_jax, path_config_from_jax
from repro_torch.core import api as tapi
from repro_torch.core.sven import SvenConfig
from repro_torch.data.synthetic import make_regression_numpy

TOL = 1e-10
#: the JAX default path config (plain "xla" solver), carried to the port
PLAIN = path_config_from_jax(dataclasses.asdict(japi.PathConfig()))
SHAPES = {"primal": (30, 70), "dual": (80, 25)}


def _problem(shape, seed=2):
    X, y = problem(*SHAPES[shape], seed=seed, k_true=6)
    return (X, y), (jnp.asarray(X), jnp.asarray(y)), cpu(X, y)


def _scales(X, y, lam2, scaled=False):
    """(lambda1_max, t_ridge) of the problem the solver sees."""
    Xt, yt, _ = tapi.standardize_fit(*cpu(X, y), standardize=scaled,
                                     fit_intercept=scaled)
    return (float(2.0 * (Xt.T @ yt).abs().max()),
            float(tapi._ridge_l1(Xt, yt, lam2)))


def test_plain_config_is_the_jax_default():
    assert PLAIN.solver.backend == "torch" and PLAIN.solver.tol == 1e-10
    assert (PLAIN.max_evals, PLAIN.f_rtol, PLAIN.t_floor_rel, PLAIN.screen) == \
        (30, 1e-9, 1e-7, True)
    assert tapi.PathConfig().solver.backend == "auto"


@pytest.mark.parametrize("shape", ["primal", "dual"])
@pytest.mark.parametrize("frac,lam2", [(0.5, 1.0), (0.05, 2.0)])
@pytest.mark.parametrize("scaled", [False, True])
def test_enet_matches_jax(shape, frac, lam2, scaled):
    (X, y), (Xj, yj), (Xt, yt) = _problem(shape)
    X = X * 3.0 + 1.5   # off-centre, unscaled columns for the scaled case
    Xj, Xt = jnp.asarray(X), cpu(X)
    l1max, t_ridge = _scales(X, y, lam2, scaled)
    kw = dict(standardize=scaled, fit_intercept=scaled)
    j = japi.enet(Xj, yj, frac * l1max, lam2, **kw)
    t = tapi.enet(Xt, yt, frac * l1max, lam2, config=PLAIN, **kw)
    np.testing.assert_allclose(npy(t.beta), npy(j.beta), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(t.intercept), float(j.intercept), rtol=0,
                               atol=TOL * max(1.0, abs(float(j.intercept))))
    assert abs(float(t.nu) - float(j.nu)) <= TOL * l1max
    assert abs(float(t.t) - float(j.t)) <= TOL * t_ridge
    assert t.evals == int(j.evals) > 0 and t.sven_iters == int(j.sven_iters)
    assert int(t.n_kept) == int(j.n_kept)
    assert (t.lambda1, t.lambda2) == (j.lambda1, j.lambda2)


@pytest.mark.parametrize("shape", ["primal", "dual"])
def test_enet_path_matches_jax(shape):
    (X, y), (Xj, yj), (Xt, yt) = _problem(shape, seed=5)
    lam2 = 0.9
    l1max, t_ridge = _scales(X, y, lam2)
    jp = japi.enet_path(Xj, yj, n_lambdas=12, lambda2=lam2)
    tp = tapi.enet_path(Xt, yt, n_lambdas=12, lambda2=lam2, config=PLAIN)
    # np.geomspace and jnp.geomspace differ in the last bit or two
    np.testing.assert_allclose(npy(tp.lambda1s), npy(jp.lambda1s), rtol=1e-14, atol=0)
    np.testing.assert_allclose(npy(tp.betas), npy(jp.betas), rtol=0, atol=TOL)
    np.testing.assert_allclose(npy(tp.nus), npy(jp.nus), rtol=0, atol=TOL * l1max)
    np.testing.assert_allclose(npy(tp.ts), npy(jp.ts), rtol=0, atol=TOL * t_ridge)
    np.testing.assert_allclose(npy(tp.kkts), npy(jp.kkts), rtol=0, atol=1e-9)
    assert tp.evals == tuple(int(e) for e in np.asarray(jp.evals))
    assert tp.sven_iters == tuple(int(e) for e in np.asarray(jp.sven_iters))
    np.testing.assert_array_equal(npy(tp.n_kept), npy(jp.n_kept))
    assert tp.betas.shape == (12, X.shape[1]) and tp.intercepts.shape == (12,)
    assert tp.evals[0] == 0 and float(tp.betas[0].abs().max()) == 0.0


def test_enet_path_matches_cd_40_points():
    """The gate of tests/test_api_cv.py: the screened path within 1e-5 of
    warm-started CD over a 40-point grid (primal-mode shape)."""
    X, y, _ = make_regression_numpy(60, 40, k_true=8, rho=0.4, seed=1)
    Xt, yt = cpu(X, y)
    grid = tapi.lambda_grid(Xt, yt, n_lambdas=40)
    path = tapi.enet_path(Xt, yt, lambda1s=grid, lambda2=1.0, config=PLAIN)
    np.testing.assert_allclose(npy(path.betas), npy(cd_path(Xt, yt, grid, 1.0)),
                               rtol=0, atol=1e-5)
    assert float(path.betas[0].abs().max()) == 0.0
    np.testing.assert_allclose(npy(path.ts), npy(path.betas.abs().sum(1)), rtol=0,
                               atol=1e-12)


def test_default_config_runs_the_plain_kernels_on_cpu():
    """CPU tensors + the default PathConfig = the kernels' plain versions
    ("ref", which sum this float64 data in float64); no kernel launches, and
    beta within the f32 kernel path's bound of the plain float64 path."""
    from repro_torch import kernels
    (X, y), _, (Xt, yt) = _problem("primal", seed=7)
    grid = tapi.lambda_grid(Xt, yt, n_lambdas=8)
    kernels.reset_launches()
    kp = tapi.enet_path(Xt, yt, lambda1s=grid, lambda2=1.0)
    assert all(v == 0 for v in kernels.launches().values())
    plain = tapi.enet_path(Xt, yt, lambda1s=grid, lambda2=1.0, config=PLAIN)
    scale = float(plain.betas.abs().max())
    np.testing.assert_allclose(npy(kp.betas), npy(plain.betas), rtol=0,
                               atol=5e-4 * scale)
    assert sum(kp.evals) > 0 and sum(kp.cg_iters) > 0
    assert tapi.resolve_path_config(tapi.PathConfig(), Xt).solver.backend == "ref"


def test_default_path_config_matches_jax_default():
    """`enet_path` with both packages' default PathConfig() on a float64
    dual problem (one Gram per evaluation): the port's "ref" Gram body sums
    in float64, so every point takes JAX "xla"'s evaluations and beta."""
    (X, y), (Xj, yj), (Xt, yt) = _problem("dual", seed=5)
    assert tapi.resolve_path_config(tapi.PathConfig(), Xt).solver.backend == "ref"
    jp = japi.enet_path(Xj, yj, n_lambdas=12, lambda2=0.9)
    tp = tapi.enet_path(Xt, yt, n_lambdas=12, lambda2=0.9)
    assert tp.evals == tuple(int(e) for e in np.asarray(jp.evals))
    np.testing.assert_allclose(npy(tp.betas), npy(jp.betas), rtol=0, atol=TOL)


def test_default_estimator_matches_jax_default():
    """`ElasticNet(...).fit` with both packages' defaults (standardize and
    intercept, default PathConfig()) at a wide, primal-mode shape: the
    port's "ref" hinge bodies sum in float64, so the fit takes JAX's
    evaluations and Newton steps (through `enet`, which JAX's fit calls and
    which reports them), the plain float64 fit's CG steps, and JAX's coef
    within 1e-10."""
    X, y = problem(30, 120, seed=3, k_true=6)
    X, y = X * 2.0 + 0.5, y + 4.0
    l1 = 0.2 * float(2.0 * np.abs(X.T @ y).max())
    jm = japi.ElasticNet(l1, 0.8).fit(jnp.asarray(X), jnp.asarray(y))
    jr = japi.enet(jnp.asarray(X), jnp.asarray(y), l1, 0.8, standardize=True,
                   fit_intercept=True)
    tm = tapi.ElasticNet(l1, 0.8).fit(*cpu(X, y))
    plain = tapi.ElasticNet(l1, 0.8, config=PLAIN).fit(*cpu(X, y))
    assert tapi.resolve_path_config(tapi.PathConfig(), cpu(X)).solver.backend == "ref"
    np.testing.assert_allclose(npy(tm.coef_), npy(jm.coef_), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(tm.intercept_), float(jm.intercept_), rtol=0,
                               atol=TOL * abs(float(jm.intercept_)))
    assert tm.result_.evals == int(jr.evals) > 0
    assert tm.result_.sven_iters == int(jr.sven_iters)
    assert tm.result_.cg_iters == plain.result_.cg_iters > 0


def test_screen_on_off_identical():
    (X, y), _, (Xt, yt) = _problem("primal", seed=4)
    grid = tapi.lambda_grid(Xt, yt, n_lambdas=10)
    on = tapi.enet_path(Xt, yt, lambda1s=grid, lambda2=0.7, config=PLAIN)
    off = tapi.enet_path(Xt, yt, lambda1s=grid, lambda2=0.7,
                         config=dataclasses.replace(PLAIN, screen=False))
    np.testing.assert_allclose(npy(on.betas), npy(off.betas), rtol=0, atol=1e-8)
    assert int(on.n_kept.min()) < X.shape[1] == int(off.n_kept.min())


def test_standardize_intercept_round_trip():
    """standardize_fit / unscale_coef against JAX, and the round trip: the
    fit on (Xs, ys) predicts the same as the un-scaled fit on (X, y)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((50, 8)) * rng.uniform(0.5, 4.0, 8) + rng.normal(0, 3, 8)
    X[:, 3] = 2.0                      # a constant column keeps scale 1
    y = X @ rng.standard_normal(8) + 5.0
    Xt, yt = cpu(X, y)
    Xs, ys, sc = tapi.standardize_fit(Xt, yt)
    jXs, jys, jsc = japi.standardize_fit(jnp.asarray(X), jnp.asarray(y))
    for a, b in zip((Xs, ys, *sc), (jXs, jys, *jsc)):
        np.testing.assert_allclose(npy(a), npy(b), rtol=0, atol=1e-12)
    assert float(sc.x_scale[3]) == 1.0
    np.testing.assert_allclose(npy(Xs.mean(0)), 0.0, atol=1e-12)
    beta_std = cpu(rng.standard_normal(8))
    beta, b0 = tapi.unscale_coef(beta_std, sc)
    np.testing.assert_allclose(npy(Xt @ beta + b0), npy(Xs @ beta_std + sc.y_mean),
                               rtol=0, atol=1e-10)
    jbeta, jb0 = japi.unscale_coef(jnp.asarray(npy(beta_std)), jsc)
    np.testing.assert_allclose(npy(beta), npy(jbeta), rtol=0, atol=1e-12)
    # a stacked (L, p) path un-scales row by row
    stack = torch.stack([beta_std, 2.0 * beta_std])
    bs, b0s = tapi.unscale_coef(stack, sc)
    assert bs.shape == (2, 8) and b0s.shape == (2,)
    np.testing.assert_allclose(npy(bs[1]), npy(2.0 * beta), rtol=0, atol=1e-12)
    # without centring or scaling the problem passes through unchanged
    Xn, yn, scn = tapi.standardize_fit(Xt, yt, standardize=False, fit_intercept=False)
    assert torch.equal(Xn, Xt) and torch.equal(yn, yt) and float(scn.y_mean) == 0.0


def test_elastic_net_estimator_matches_jax():
    (X, y), (Xj, yj), (Xt, yt) = _problem("primal", seed=3)
    X = X * 2.0 + 0.5
    y = y + 4.0
    l1 = 0.2 * float(2.0 * np.abs(X.T @ y).max())
    jm = japi.ElasticNet(l1, 0.8).fit(jnp.asarray(X), jnp.asarray(y))
    tm = tapi.ElasticNet(l1, 0.8, config=PLAIN).fit(cpu(X), cpu(y))
    np.testing.assert_allclose(npy(tm.coef_), npy(jm.coef_), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(tm.intercept_), float(jm.intercept_), rtol=0,
                               atol=TOL * abs(float(jm.intercept_)))
    np.testing.assert_allclose(npy(tm.predict(X)), npy(jm.predict(jnp.asarray(X))),
                               rtol=0, atol=1e-9)
    assert int(tm.n_kept_) == int(jm.n_kept_) and tm.result_.evals > 0


def test_conversions_grid_and_bracket_match_jax():
    for args in ((0.3, 0.5, 100), (1.2, 1.0, 7), (0.01, 0.0, 50)):
        assert tapi.penalized_from_glmnet(*args) == japi.penalized_from_glmnet(*args)
        assert tapi.penalized_from_sklearn(*args) == japi.penalized_from_sklearn(*args)
    l1, l2 = tapi.penalized_from_glmnet(0.3, 0.25, 40)
    np.testing.assert_allclose(tapi.penalized_to_glmnet(l1, l2, 40), (0.3, 0.25),
                               rtol=1e-15)
    for shape in ("primal", "dual"):
        (X, y), (Xj, yj), (Xt, yt) = _problem(shape)
        for eps in (None, 1e-3):
            np.testing.assert_allclose(npy(tapi.lambda_grid(Xt, yt, 9, eps)),
                                       npy(japi.lambda_grid(Xj, yj, 9, eps)),
                                       rtol=1e-14, atol=0)
        np.testing.assert_allclose(float(tapi._ridge_l1(Xt, yt, 0.7)),
                                   float(japi._ridge_l1(Xj, yj, 0.7)), rtol=1e-12)
        for a, b in zip(tapi.cold_carry(Xt, yt), japi.cold_carry(Xj, yj)):
            np.testing.assert_allclose(npy(a), npy(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", ["primal", "dual"])
def test_point_warm_started_from_a_jax_carry(shape):
    """A JAX path's carry crosses over (`carry_from_jax`): the port's next
    point from it equals JAX's next point."""
    (X, y), (Xj, yj), (Xt, yt) = _problem(shape, seed=6)
    l1max, t_ridge = _scales(X, y, 1.0)
    jcfg = japi.PathConfig()
    carry, _ = japi._enet_point(Xj, yj, 0.5 * l1max, 1.0, japi.cold_carry(Xj, yj), jcfg)
    _, jpt = japi._enet_point(Xj, yj, 0.3 * l1max, 1.0, carry, jcfg)
    tcarry = carry_from_jax(*(np.asarray(f) for f in carry), device="cpu")
    _, tpt = tapi._enet_point(Xt, yt, 0.3 * l1max, 1.0, tcarry, PLAIN)
    np.testing.assert_allclose(npy(tpt.beta), npy(jpt.beta), rtol=0, atol=TOL)
    assert tpt.evals == int(jpt.evals)
    assert abs(float(tpt.nu) - float(jpt.nu)) <= TOL * l1max
    assert abs(float(tpt.t) - float(jpt.t)) <= TOL * t_ridge
    np.testing.assert_array_equal(npy(tpt.keep), npy(jpt.keep))
    assert abs(float(tpt.gap) - float(jpt.gap)) <= 1e-12


def test_entry_points_need_cuda_or_cpu_tensors(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = problem(20, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.enet(X, y, 1.0, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.enet_path(X, y, n_lambdas=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.ElasticNet(1.0).fit(X, y)
    res = tapi.enet(*cpu(X, y), 1.0, 1.0, config=PLAIN)
    assert res.beta.device.type == "cpu"
