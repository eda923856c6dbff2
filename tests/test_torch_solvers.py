"""Port parity of the SVM solver machines: `repro_torch.core.svm` against
`repro.core.svm`, fed the same float64 mat-vecs. Iterates agree within
1e-10 and iteration counts are equal, step by step and to convergence."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import cpu, npy, problem
from repro.core import reduction as jred
from repro.core.svm import dual_fista as jfista
from repro.core.svm import dual_newton as jdual
from repro.core.svm import make_hyper as jmake_hyper
from repro.core.svm import primal_newton as jprimal
from repro_torch.core import reduction as tred
from repro_torch.core.svm import dual_fista as tfista
from repro_torch.core.svm import dual_newton as tdual
from repro_torch.core.svm import host_bool, make_hyper, state
from repro_torch.core.svm import primal_newton as tprimal

TOL = 1e-10


def _close(a, b):
    np.testing.assert_allclose(npy(a), npy(b), rtol=0, atol=TOL)


def _ops(n, p, t, seed):
    X, y = problem(n, p, seed=seed)
    return (tred.SvenOperator(X=cpu(X), y=cpu(y), t=t),
            jred.SvenOperator(X=jnp.asarray(X), y=jnp.asarray(y), t=t))


@pytest.mark.parametrize("n,p,seed", [(60, 12, 0), (40, 30, 3)])
@pytest.mark.parametrize("cached", [True, False])
def test_dual_newton_machine_matches_jax(n, p, seed, cached):
    top, jop = _ops(n, p, 1.5, seed)
    if cached:
        K = tred.gram_blocks(top.X, top.y, 1.5)
        Kj = jnp.asarray(npy(K))
        tmv, jmv = (lambda v: K @ v), (lambda v: Kj @ v)
    else:
        tmv, jmv = top.kernel_matvec, jop.kernel_matvec
    C, tol = 0.5 / 0.7, 1e-9
    tm = tdual.dual_newton_machine(tmv, 2 * p, max_newton=100, cg_iters=250)
    jm = jdual.dual_newton_machine(jmv, 2 * p, max_newton=100, cg_iters=250)
    th, jh = make_hyper(C, tol), jmake_hyper(C, tol, jnp.float64)
    ts, js = tm.init(th), jm.init(jh)
    for _ in range(3):   # step by step
        ts, js = tm.step(ts, th), jm.step(js, jh)
        _close(ts.x, js.x)
        _close(ts.residual, js.residual)
        assert ts.iters == int(js.iters)
        assert bool(ts.converged) == bool(js.converged)
    tr = tdual.solve_dual_newton(tmv, 2 * p, C, tol=tol)
    jr = jdual.solve_dual_newton(jmv, 2 * p, C, tol=tol)
    _close(tr.alpha, jr.alpha)
    assert tr.iters == int(jr.iters) and tr.cg_iters > 0
    _close(tr.objective, jr.objective)


@pytest.mark.parametrize("n,p,seed", [(30, 40, 1), (20, 60, 4)])
def test_primal_newton_machine_matches_jax(n, p, seed):
    top, jop = _ops(n, p, 2.0, seed)
    C, tol = 0.5, 1e-9
    yhat = cpu(np.r_[np.ones(p), -np.ones(p)])
    jyhat = jnp.asarray(npy(yhat))
    tm = tprimal.primal_newton_machine(top.xhat_matvec, top.xhat_rmatvec, yhat, n)
    jm = jprimal.primal_newton_machine(jop.xhat_matvec, jop.xhat_rmatvec, jyhat, n)
    th, jh = make_hyper(C, tol), jmake_hyper(C, tol, jnp.float64)
    ts, js = tm.init(th), jm.init(jh)
    for _ in range(3):
        ts, js = tm.step(ts, th), jm.step(js, jh)
        _close(ts.x, js.x)
        _close(ts.residual, js.residual)
        assert ts.iters == int(js.iters)
    tr = tprimal.solve_primal_newton(top.xhat_matvec, top.xhat_rmatvec, yhat, C, n,
                                     tol=tol)
    jr = jprimal.solve_primal_newton(jop.xhat_matvec, jop.xhat_rmatvec, jyhat, C, n,
                                     tol=tol)
    _close(tr.w, jr.w)
    assert tr.iters == int(jr.iters)
    _close(tr.objective, jr.objective)


def test_primal_hess_matvec_override_matches_jax():
    """The `hess_matvec` hook (the kernel's seat) with the same plain H v."""
    top, jop = _ops(24, 40, 1.2, 2)
    C = 0.8
    yhat = cpu(np.r_[np.ones(40), -np.ones(40)])
    jyhat = jnp.asarray(npy(yhat))

    def t_hmv(v, act, C_):
        return v + 2.0 * C_ * top.xhat_rmatvec(act * top.xhat_matvec(v))

    def j_hmv(v, act, C_):
        return v + 2.0 * C_ * jop.xhat_rmatvec(act * jop.xhat_matvec(v))

    tr = tprimal.solve_primal_newton(top.xhat_matvec, top.xhat_rmatvec, yhat, C, 24,
                                     hess_matvec=t_hmv)
    jr = jprimal.solve_primal_newton(jop.xhat_matvec, jop.xhat_rmatvec, jyhat, C, 24,
                                     hess_matvec=j_hmv)
    _close(tr.w, jr.w)
    assert tr.iters == int(jr.iters)


def test_cg_helpers_match_jax():
    rng = np.random.default_rng(9)
    A = rng.standard_normal((20, 20))
    A = A @ A.T + 20 * np.eye(20)
    b = rng.standard_normal(20)
    mask = (rng.random(20) > 0.3).astype(np.float64)
    At, Aj = cpu(A), jnp.asarray(A)
    x, it = tprimal._cg(lambda v: At @ v, cpu(b), 50, 1e-12)
    _close(x, jprimal._cg(lambda v: Aj @ v, jnp.asarray(b), 50, 1e-12))
    assert 0 < it <= 20
    xm, _ = tdual._masked_cg(lambda v: At @ v, cpu(b), cpu(mask), 50, 1e-12)
    _close(xm, jdual._masked_cg(lambda v: Aj @ v, jnp.asarray(b), jnp.asarray(mask),
                                50, 1e-12))
    np.testing.assert_array_equal(npy(xm)[mask == 0], 0.0)


def test_host_loop_counts_its_syncs(monkeypatch):
    top, _ = _ops(60, 12, 1.5, 0)
    k = state.CG_READ_EVERY
    syncs = {}
    for every in (1, k):
        monkeypatch.setattr(state, "CG_READ_EVERY", every)
        host_bool.syncs = 0
        r = tdual.solve_dual_newton(top.kernel_matvec, 24, 0.5, tol=1e-9)
        syncs[every] = host_bool.syncs
    # CG reading its test before every step (k = 1): one read per loop test:
    # Newton tests (iters + 1), CG tests (cg + one per Newton step), and at
    # least one line-search test per Newton step
    assert syncs[1] >= (r.iters + 1) + (r.cg_iters + r.iters) + r.iters
    # at the default k the CG test is read once per block of k steps: at
    # most ceil((c + 1) / k) reads for a CG solve of c steps, so at most
    # (cg + k iters) / k for the solve's CG; the other reads are unchanged
    other = syncs[1] - (r.cg_iters + r.iters)
    assert other + r.iters <= syncs[k] and k * (syncs[k] - other) <= r.cg_iters + k * r.iters
    assert k == 1 or syncs[k] < syncs[1]


@pytest.mark.parametrize("n,p,seed", [(60, 12, 0), (40, 30, 3)])
def test_dual_fista_machine_matches_jax(n, p, seed):
    """Projected FISTA: the power-iteration step size, every iterate and the
    momentum carry step by step, then the whole solve, within 1e-10."""
    top, jop = _ops(n, p, 1.5, seed)
    K = tred.gram_blocks(top.X, top.y, 1.5)
    Kj = jnp.asarray(npy(K))
    tmv, jmv = (lambda v: K @ v), (lambda v: Kj @ v)
    C, tol = 0.5 / 0.7, 1e-8
    tm = tfista.dual_fista_machine(tmv, 2 * p, max_iters=5000)
    jm = jfista.dual_fista_machine(jmv, 2 * p, max_iters=5000)
    th, jh = make_hyper(C, tol), jmake_hyper(C, tol, jnp.float64)
    ts, js = tm.init(th), jm.init(jh)
    np.testing.assert_allclose(float(ts.aux[2]), float(js.aux[2]), rtol=1e-12)
    for _ in range(5):
        ts, js = tm.step(ts, th), jm.step(js, jh)
        _close(ts.x, js.x)
        _close(ts.aux[0], js.aux[0])
        _close(ts.residual, js.residual)
        assert ts.iters == int(js.iters)
    tr = tfista.solve_dual_fista(tmv, 2 * p, C, tol=tol)
    jr = jfista.solve_dual_fista(jmv, 2 * p, C, tol=tol)
    _close(tr.alpha, jr.alpha)
    assert tr.iters == int(jr.iters) and tr.cg_iters == 0
    _close(tr.objective, jr.objective)
