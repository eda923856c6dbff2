"""Port parity: the reduction, its operators and the KKT diagnostics of
`repro_torch.core` against `repro.core`, in float64, to 1e-12."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import cpu, npy, problem
from repro.core import elastic_net as jen
from repro.core import reduction as jred
from repro.data.synthetic import make_regression as jax_make_regression
from repro_torch.core import elastic_net as ten
from repro_torch.core import reduction as tred
from repro_torch.data.synthetic import make_regression as torch_make_regression

TOL = 1e-12
SHAPES = [(30, 12), (12, 30)]


def _close(a, b, tol=TOL):
    a, b = npy(a), npy(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def test_make_regression_copy_matches_jax():
    Xj, yj, bj = jax_make_regression(40, 15, k_true=4, rho=0.3, seed=5)
    Xt, yt, bt = torch_make_regression(40, 15, k_true=4, rho=0.3, seed=5,
                                       device="cpu")
    for a, b in ((Xt, Xj), (yt, yj), (bt, bj)):
        np.testing.assert_array_equal(npy(a), npy(b))


@pytest.mark.parametrize("n,p", SHAPES)
def test_build_svm_dataset_and_gram(n, p):
    X, y = problem(n, p, seed=1)
    Xt, yt = cpu(X, y)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    t = 1.3
    for a, b in zip(tred.build_svm_dataset(Xt, yt, t), jred.build_svm_dataset(Xj, yj, t)):
        _close(a, b)
    _close(tred.gram_blocks(Xt, yt, t), jred.gram_blocks(Xj, yj, t))
    _close(tred.gram_reference(Xt, yt, t), jred.gram_reference(Xj, yj, t))
    G, u, s = X.T @ X, X.T @ y / t, y @ y / t**2
    _close(tred.gram_from_stats(*cpu(G, u), s),
           jred.gram_from_stats(jnp.asarray(G), jnp.asarray(u), s))


@pytest.mark.parametrize("n,p", SHAPES)
def test_operator_products(n, p):
    X, y = problem(n, p, seed=2)
    rng = np.random.default_rng(3)
    w, v = rng.standard_normal(n), rng.standard_normal(2 * p)
    top = tred.SvenOperator(X=cpu(X), y=cpu(y), t=0.7)
    jop = jred.SvenOperator(X=jnp.asarray(X), y=jnp.asarray(y), t=0.7)
    assert (top.n, top.p, top.m) == (jop.n, jop.p, jop.m)
    for name, arg in (("xhat_matvec", w), ("xhat_rmatvec", v), ("zhat_matvec", v),
                      ("zhat_rmatvec", w), ("kernel_matvec", v), ("margins", w)):
        _close(getattr(top, name)(cpu(arg)), getattr(jop, name)(jnp.asarray(arg)))


@pytest.mark.parametrize("lam2", [1.0, 0.25, 1e-3, 0.0, 1e-15])
def test_svm_C_clamp(lam2):
    assert tred.svm_C(lam2) == pytest.approx(float(jred.svm_C(lam2)), rel=1e-15)
    assert tred.svm_C(lam2, floor=1e-6) == pytest.approx(
        float(jred.svm_C(lam2, floor=1e-6)), rel=1e-15)
    assert tred.LAMBDA2_FLOOR == jred.LAMBDA2_FLOOR


def test_recover_beta_and_alpha_from_primal():
    rng = np.random.default_rng(4)
    alpha = np.abs(rng.standard_normal(16))
    _close(tred.recover_beta(cpu(alpha), 2.0), jred.recover_beta(jnp.asarray(alpha), 2.0))
    zero = np.zeros(16)   # |alpha|_1 = 0: the guard returns beta = 0, not NaN
    bt = tred.recover_beta(cpu(zero), 2.0)
    np.testing.assert_array_equal(npy(bt), npy(jred.recover_beta(jnp.asarray(zero), 2.0)))
    np.testing.assert_array_equal(npy(bt), np.zeros(8))
    X, y = problem(10, 8, seed=6)
    Xhat, yhat = tred.build_svm_dataset(*cpu(X, y), 1.5)
    Jhat, jyhat = jred.build_svm_dataset(jnp.asarray(X), jnp.asarray(y), 1.5)
    w = rng.standard_normal(10)
    _close(tred.alpha_from_primal(Xhat, yhat, cpu(w), 0.8),
           jred.alpha_from_primal(Jhat, jyhat, jnp.asarray(w), 0.8))


@pytest.mark.parametrize("n,p", SHAPES)
def test_objectives_and_kkt(n, p):
    X, y = problem(n, p, seed=7)
    rng = np.random.default_rng(8)
    beta = rng.standard_normal(p) * (rng.random(p) > 0.5)
    Xt, yt, bt = cpu(X, y, beta)
    Xj, yj, bj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta)
    lam1, lam2 = 0.3, 0.7
    _close(ten.objective_constrained(Xt, yt, bt, lam2),
           jen.objective_constrained(Xj, yj, bj, lam2))
    _close(ten.objective_penalized(Xt, yt, bt, lam1, lam2),
           jen.objective_penalized(Xj, yj, bj, lam1, lam2))
    g = ten.smooth_grad(Xt, yt, bt, lam2)
    _close(g, jen.smooth_grad(Xj, yj, bj, lam2))
    _close(ten.kkt_multiplier(Xt, yt, bt, lam2), jen.kkt_multiplier(Xj, yj, bj, lam2))
    _close(ten.kkt_violation(Xt, yt, bt, lam2), jen.kkt_violation(Xj, yj, bj, lam2))
    _close(ten.kkt_violation_from_grad(g, bt),
           jen.kkt_violation_from_grad(jnp.asarray(npy(g)), bj))
    _close(ten.lambda1_max(Xt, yt), jen.lambda1_max(Xj, yj))
