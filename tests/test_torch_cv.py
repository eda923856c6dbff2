"""Port parity of `enet_batch` and the batched cross-validation:
`repro_torch.core.api.enet_batch` and `repro_torch.core.cv` against
`repro.core.api.enet_batch` and `repro.core.cv` (JAX's vmapped point solver
and its scan-of-vmap over folds) and against the port's own sequential
points, on the same float64 numpy problems, in both solver modes.

Bounds: against JAX at both packages' default configs (JAX "xla", the
port's "auto", which on CPU tensors runs the kernels' plain float64
bodies): lambda1s within 1e-12 relative, mse_path within 1e-10 x max(mse),
refit beta and intercept within 1e-10 x max|beta|, beta of `enet_batch`
within 1e-10 x max|beta|, and equal index_min, evaluations and kept
columns. Against the port's sequential reference: mse_path within 1e-10
and the same index_min, refit beta within 1e-5 of coordinate descent
(`tests/test_api_cv.py::test_cv_matches_sequential_reference_and_trace_budget`).
Each lane of the lane-batched root-find is bitwise the sequential
`_enet_point` / `enet` on its operands, and the CV surface is bitwise the
same for every fold chunk.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu, npy, problem
from repro.core import api as japi
from repro.core import batch as jbatch
from repro.core import cv as jcv
from repro_torch.baselines import elastic_net_cd
from repro_torch.convert import carry_from_jax
from repro_torch.core import api as tapi
from repro_torch.core import cv as tcv
from repro_torch.core.svm import host_bool
from repro_torch.core.svm.state import cg_lanes
from repro_torch.kernels import registry

#: (n, p, grid points, standardize and intercept) of the two CV problems:
#: the dual one of tests/test_api_cv.py:199-220, and a primal one (2p > n)
CV_SHAPES = {"dual": (84, 30, 40, False), "primal": (48, 64, 8, True)}
BATCH_SHAPES = {"dual": (84, 30), "primal": (48, 64)}
BATCH_CASES = ("stacked", "shared", "multi_response", "warm")
K = 4


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_traces():
    """Drop JAX's compiled functions when this module ends: its dual CV
    problem is tests/test_api_cv.py's, and a cached `enet_cv_scan` trace
    of it would leave that test's trace count at 0 in the same process."""
    yield
    jax.clear_caches()


def _cv_problem(shape):
    n, p, L, scaled = CV_SHAPES[shape]
    X, y = problem(n, p, seed=5, k_true=6)
    if scaled:
        X, y = X * 2.0 + 0.5, y + 3.0
    return X, y, dict(k=K, n_lambdas=L, lambda2=1.0, standardize=scaled,
                      fit_intercept=scaled)


@functools.lru_cache(maxsize=None)
def _jax_cv(shape):
    X, y, kw = _cv_problem(shape)
    return jcv.cross_validate(jnp.asarray(X), jnp.asarray(y), mesh=None, **kw)


@functools.lru_cache(maxsize=None)
def _port_cv(shape, fold_chunk=None):
    X, y, kw = _cv_problem(shape)
    return tcv.cross_validate(*cpu(X, y), fold_chunk=fold_chunk, **kw)


@pytest.mark.parametrize("shape", ["dual", "primal"])
def test_cross_validate_matches_jax(shape):
    """The port's `cross_validate` (default config) against JAX's
    (default config, mesh=None), point by point and fold by fold."""
    r, j = _port_cv(shape), _jax_cv(shape)
    L = CV_SHAPES[shape][2]
    assert r.mse_path.shape == (L, K) and r.n_kept.shape == r.evals.shape == (L, K)
    np.testing.assert_allclose(npy(r.lambda1s), npy(j.lambda1s), rtol=1e-12, atol=0)
    mse_j = np.asarray(j.mse_path)
    np.testing.assert_allclose(npy(r.mse_path), mse_j, rtol=0, atol=1e-10 * mse_j.max())
    np.testing.assert_allclose(npy(r.mean_mse), np.asarray(j.mean_mse), rtol=0,
                               atol=1e-10 * mse_j.max())
    assert r.index_min == j.index_min
    assert r.lambda_min == pytest.approx(j.lambda_min, rel=1e-12, abs=0)
    np.testing.assert_array_equal(npy(r.evals), np.asarray(j.evals))
    np.testing.assert_array_equal(npy(r.n_kept), np.asarray(j.n_kept))
    assert int(r.evals.sum()) > 0 and int(r.n_kept.min()) < CV_SHAPES[shape][1]
    scale = float(np.abs(np.asarray(j.beta)).max())
    assert scale > 0
    np.testing.assert_allclose(npy(r.beta), np.asarray(j.beta), rtol=0, atol=1e-10 * scale)
    assert abs(float(r.intercept) - float(j.intercept)) <= 1e-10 * scale
    assert r.lambda2 == j.lambda2 == 1.0


@pytest.mark.parametrize("shape", ["dual", "primal"])
def test_reference_matches_jax_and_cv_matches_reference(shape):
    """`cross_validate_reference` against JAX's; the batched CV against
    it (JAX's gate: 1e-10, same index_min) with its counts; the refit
    against coordinate descent at lambda_min within 1e-5, and bitwise
    `enet` at lambda_min with the same scaling."""
    X, y, kw = _cv_problem(shape)
    lam, mse, kept, evals = tcv.cross_validate_reference(*cpu(X, y), with_counts=True, **kw)
    jlam, jmse = jcv.cross_validate_reference(jnp.asarray(X), jnp.asarray(y), **kw)
    np.testing.assert_allclose(npy(lam), np.asarray(jlam), rtol=1e-12, atol=0)
    np.testing.assert_allclose(npy(mse), np.asarray(jmse), rtol=0,
                               atol=1e-10 * float(np.asarray(jmse).max()))
    r = _port_cv(shape)
    np.testing.assert_allclose(npy(r.mse_path), npy(mse), rtol=0, atol=1e-10)
    assert r.index_min == int(torch.argmin(mse.mean(1)))
    assert torch.equal(r.n_kept, kept) and torch.equal(r.evals, evals)
    Xt, yt = cpu(X, y)
    refit = tapi.enet(Xt, yt, r.lambda_min, 1.0, standardize=kw["standardize"],
                      fit_intercept=kw["fit_intercept"])
    assert torch.equal(r.beta, refit.beta) and torch.equal(r.intercept, refit.intercept)
    Xs, ys, sc = tapi.standardize_fit(Xt, yt, standardize=kw["standardize"],
                                      fit_intercept=kw["fit_intercept"])
    beta_cd, _ = tapi.unscale_coef(elastic_net_cd(Xs, ys, r.lambda_min, 1.0).beta, sc)
    np.testing.assert_allclose(npy(r.beta), npy(beta_cd), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fold_chunk", [2, 4])
@pytest.mark.parametrize("shape", ["dual", "primal"])
def test_fold_chunks_give_the_same_bits(shape, fold_chunk):
    """Folds advanced together (lane-batched root-finds) give the bits of
    folds solved one after another (chunk 1, the CPU default)."""
    one, r = _port_cv(shape, 1), _port_cv(shape, fold_chunk)
    assert tcv._auto_fold_chunk(K, torch.device("cpu")) == 1
    assert tcv._auto_fold_chunk(K, torch.device("cuda")) == K
    for field in ("mse_path", "mean_mse", "n_kept", "evals", "beta", "intercept"):
        assert torch.equal(getattr(r, field), getattr(one, field)), field
    assert r.index_min == one.index_min and r.lambda_min == one.lambda_min


def test_elastic_net_cv_estimator_matches_jax():
    X, y = problem(60, 20, seed=6, k_true=5)
    X, y = X * 1.5 - 0.5, y + 2.0
    j = jcv.ElasticNetCV(k=K, n_lambdas=12, lambda2=1.0, mesh=None).fit(jnp.asarray(X),
                                                                        jnp.asarray(y))
    t = tcv.ElasticNetCV(k=K, n_lambdas=12, lambda2=1.0).fit(*cpu(X, y))
    scale = float(np.abs(np.asarray(j.coef_)).max())
    np.testing.assert_allclose(npy(t.coef_), np.asarray(j.coef_), rtol=0, atol=1e-10 * scale)
    assert abs(float(t.intercept_) - float(j.intercept_)) <= 1e-10 * scale
    assert t.lambda_min_ == pytest.approx(j.lambda_min_, rel=1e-12, abs=0)
    np.testing.assert_allclose(npy(t.lambda1s_), np.asarray(j.lambda1s_), rtol=1e-12, atol=0)
    mse_j = np.asarray(j.mse_path_)
    assert t.mse_path_.shape == (12, K)
    np.testing.assert_allclose(npy(t.mse_path_), mse_j, rtol=0, atol=1e-10 * mse_j.max())
    np.testing.assert_allclose(npy(t.mean_mse_), np.asarray(j.mean_mse_), rtol=0,
                               atol=1e-10 * mse_j.max())
    assert t.cv_result_.index_min == int(np.argmin(np.asarray(j.mean_mse_)))
    # predict takes array-likes, as ElasticNet.predict does
    np.testing.assert_allclose(npy(t.predict(X)), np.asarray(j.predict(jnp.asarray(X))),
                               rtol=0, atol=1e-9)
    assert float(torch.mean((t.predict(X) - cpu(y)) ** 2)) < float(np.var(y))


def _batch_operands(shape, case):
    """numpy (X, y, lambda1s, lambda2s) of an `enet_batch` case: K stacked
    folds (one lambda1 per fold), three lambda1s on a shared X, three
    responses on a shared X with three lambda2s; "warm" is the stacked case
    at 0.7 x its lambda1s."""
    X, y = problem(*BATCH_SHAPES[shape], seed=5, k_true=6)
    head = 2.0 * np.abs(X.T @ y).max()
    if case == "shared":
        return X, y, head * np.array([0.6, 0.3, 0.15]), np.asarray(0.8)
    if case == "multi_response":
        return X, np.stack([y, -y, 0.5 * y + 0.1]), np.asarray(0.2 * head), \
            np.array([0.5, 1.0, 2.0])
    Xtr, ytr, _, _ = (np.asarray(a) for a in jbatch.cv_folds(jnp.asarray(X), jnp.asarray(y), K))
    heads = np.array([2.0 * np.abs(Xtr[i].T @ ytr[i]).max() for i in range(K)])
    return Xtr, ytr, heads * np.array([0.5, 0.3, 0.2, 0.1]), np.asarray(1.0)


HAS_WARM = np.array([True, False, True, False])


@functools.lru_cache(maxsize=None)
def _jax_batch(shape, case):
    ops = [jnp.asarray(a) for a in _batch_operands(shape, case)]
    if case != "warm":
        return japi.enet_batch(*ops, return_carry=True)
    _, carry = _jax_batch(shape, "stacked")
    ops[2] = 0.7 * ops[2]
    return japi.enet_batch(*ops, warm=carry, has_warm=jnp.asarray(HAS_WARM),
                           return_carry=True)


def _lane(x, i, shared_dim):
    return x if x.dim() == shared_dim else x[i]


@pytest.mark.parametrize("case", BATCH_CASES)
@pytest.mark.parametrize("shape", ["dual", "primal"])
def test_enet_batch_matches_jax_and_sequential(shape, case):
    """`enet_batch` (default config) against JAX's vmapped `enet_batch`,
    and each lane bitwise the port's sequential `_enet_point` on fresh
    copies of its operands from its own carry (cold, or the warm one)."""
    X, y, l1, l2 = cpu(*_batch_operands(shape, case))
    if case == "warm":
        l1 = 0.7 * l1
    jp, jc = _jax_batch(shape, case)
    kw = {}
    if case == "warm":
        _, jwarm = _jax_batch(shape, "stacked")
        kw = dict(warm=carry_from_jax(*(np.asarray(f) for f in jwarm), device="cpu"),
                  has_warm=HAS_WARM)
    pts, carry = tapi.enet_batch(X, y, l1, l2, return_carry=True, **kw)
    B = jp.beta.shape[0]
    assert pts.beta.shape == (B, X.shape[-1]) and len(pts.evals) == B
    scale = float(np.abs(np.asarray(jp.beta)).max())
    assert scale > 0
    np.testing.assert_allclose(npy(pts.beta), np.asarray(jp.beta), rtol=0, atol=1e-10 * scale)
    assert list(pts.evals) == np.asarray(jp.evals).tolist()
    np.testing.assert_array_equal(npy(pts.keep), np.asarray(jp.keep))
    np.testing.assert_allclose(npy(carry.t), np.asarray(jc.t), rtol=1e-10, atol=0)
    config = tapi.resolve_path_config(tapi.PathConfig(), X)
    for i in range(B):
        Xi, yi = _lane(X, i, 2).clone(), _lane(y, i, 1).clone()
        li1, li2 = float(_lane(l1, i, 0)), float(_lane(l2, i, 0))
        cold = tapi.cold_carry(Xi, yi)
        start = cold
        if case == "warm" and HAS_WARM[i]:
            start = tapi.EnetCarry(*(f[i].clone() for f in kw["warm"]))
        nxt, pt = tapi._enet_point(Xi, yi, li1, li2, start, config)
        for field in ("beta", "t", "nu", "keep", "kkt", "gap", "n_kept"):
            assert torch.equal(getattr(pts, field)[i], getattr(pt, field)), (field, i)
        assert (pts.evals[i], pts.sven_iters[i], pts.cg_iters[i]) == \
            (pt.evals, pt.sven_iters, pt.cg_iters), i
        for a, b in zip(carry, nxt):
            assert torch.equal(a[i], b), i
        if case != "warm":   # a cold lane is `enet` on its lane
            assert torch.equal(pts.beta[i], tapi.enet(Xi, yi, li1, li2).beta)


@pytest.mark.parametrize("shape", ["dual", "primal"])
def test_point_lanes_one_launch_for_the_running_lanes(shape, monkeypatch):
    """`_enet_point_lanes` on CPU tensors at the default config: each
    evaluation solves only the lanes still running, one lane-batched solve
    for two or more (one call of each lane pass per batched CG step) and
    the single solve for the last one; lane hinge calls plus single hinge
    calls equal the batched CG steps; fewer host syncs than the lanes'
    sequential points; a width-1 stack is the sequential point."""
    calls = {op: 0 for op in ("hinge_xtv", "hinge_xtv_lanes", "shifted_gram")}
    for op in calls:
        body = registry.lookup(op, "ref")

        def counting(*a, _op=op, _body=body, **k):
            calls[_op] += 1
            return _body(*a, **k)

        monkeypatch.setitem(registry._REGISTRY, (op, "ref"), counting)
    X, y, l1, l2 = cpu(*_batch_operands(shape, "stacked"))
    config = tapi.resolve_path_config(tapi.PathConfig(), X)
    l1s, l2s = l1.tolist(), [float(l2)] * K
    carry = tapi._cold_carry_lanes(X, y, K)
    host_bool.syncs = cg_lanes.steps = 0
    _, pts = tapi._enet_point_lanes(X, y, l1s, l2s, carry, config)
    lane_syncs, steps = host_bool.syncs, cg_lanes.steps
    assert len(set(pts.evals)) > 1      # the lanes stop at different evaluations
    last = sorted(pts.evals)
    if shape == "primal":
        # the single solve runs exactly when one lane outlasts the others
        assert calls["hinge_xtv_lanes"] > 0 and (calls["hinge_xtv"] > 0) == (last[-1] > last[-2])
        assert calls["hinge_xtv_lanes"] + calls["hinge_xtv"] == steps
        assert calls["shifted_gram"] == 0
    else:
        assert calls["shifted_gram"] == sum(pts.evals) and steps > 0
        assert calls["hinge_xtv_lanes"] == calls["hinge_xtv"] == 0
    host_bool.syncs = 0
    for i in range(K):
        tapi._enet_point(X[i], y[i], l1s[i], l2s[i], tapi.cold_carry(X[i], y[i]), config)
    assert lane_syncs < host_bool.syncs
    one = tapi._enet_point_lanes(X[:1], y[:1], l1s[:1], l2s[:1],
                                 tapi.EnetCarry(*(f[:1] for f in carry)), config)[1]
    seq = tapi._enet_point(X[0], y[0], l1s[0], l2s[0], tapi.cold_carry(X[0], y[0]), config)[1]
    assert torch.equal(one.beta[0], seq.beta) and one.evals == (seq.evals,)


def test_plain_config_lanes_and_no_screen():
    """The plain "torch" solver and screening off: each lane still its
    sequential point, and screening changes no answer beyond 1e-8."""
    X, y, l1, l2 = cpu(*_batch_operands("primal", "shared"))
    plain = tapi.PathConfig(solver=dataclasses.replace(tapi.PathConfig().solver,
                                                       backend="torch"))
    for config in (plain, dataclasses.replace(plain, screen=False)):
        pts = tapi.enet_batch(X, y, l1, l2, config)
        for i in range(3):
            pt = tapi._enet_point(X, y, float(l1[i]), float(l2), tapi.cold_carry(X, y),
                                  config)[1]
            assert torch.equal(pts.beta[i], pt.beta) and pts.cg_iters[i] == pt.cg_iters
        if not config.screen:
            assert int(pts.n_kept.min()) == X.shape[1]
            np.testing.assert_allclose(npy(pts.beta), npy(on.beta), rtol=0, atol=1e-8)
        on = pts


def test_carry_from_jax_takes_a_stacked_carry():
    _, jc = _jax_batch("dual", "stacked")
    carry = carry_from_jax(*(np.asarray(f) for f in jc), device="cpu")
    assert isinstance(carry, tapi.EnetCarry)
    for a, b in zip(carry, jc):
        assert a.shape == b.shape and a.shape[0] == K and a.dtype == torch.float64
        np.testing.assert_array_equal(npy(a), np.asarray(b))


def test_validation_errors():
    X, y = cpu(*problem(30, 10, seed=9))
    Y = torch.stack([y, -y])
    with pytest.raises(ValueError, match="no batched operand"):
        tapi.enet_batch(X, y, 1.0, 1.0)
    with pytest.raises(ValueError, match="warm and has_warm"):
        tapi.enet_batch(X, Y, 1.0, 1.0, warm=tapi._cold_carry_lanes(X, Y, 2))
    with pytest.raises(ValueError, match="warm and has_warm"):
        tapi.enet_batch(X, Y, 1.0, 1.0, has_warm=[True, False])
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        tapi.enet_batch(X, Y, torch.ones(3, dtype=X.dtype), 1.0)
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        tapi.enet_batch(X, Y, 1.0, 1.0, warm=tapi._cold_carry_lanes(X, Y, 2),
                        has_warm=[True, False, True])
    with pytest.raises(ValueError, match="route"):
        tapi.enet_batch(X, Y, 1.0, 1.0, route="mesh")
    with pytest.raises(ValueError, match="X must be"):
        tapi.enet_batch(X[0], Y, 1.0, 1.0)
    with pytest.raises(ValueError, match="fold_chunk"):
        tcv.cross_validate(X, y, k=3, n_lambdas=3, fold_chunk=2)
    with pytest.raises(ValueError, match="fold_chunk"):
        tcv._enet_cv_scan(*tcv.cv_folds(X, y, 3), [1.0], 1.0, tapi.PathConfig(), 2)
    with pytest.raises(ValueError, match="mesh"):
        tcv.cross_validate(X, y, k=3, n_lambdas=3, mesh="data")
    # every route spelling of JAX is accepted and changes nothing
    base = tapi.enet_batch(X, Y, 5.0, 1.0)
    for route in ("auto", "batch", "single"):
        assert torch.equal(tapi.enet_batch(X, Y, 5.0, 1.0, route=route).beta, base.beta)
    # mesh=None is accepted and changes nothing
    a = tcv.cross_validate(X, y, k=3, n_lambdas=3, mesh=None)
    assert torch.equal(a.mse_path, tcv.cross_validate(X, y, k=3, n_lambdas=3).mse_path)


def test_array_likes_need_cuda(monkeypatch):
    """Entry points given numpy arrays run on the CUDA device and never drop
    to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = problem(20, 5, seed=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.enet_batch(X, np.stack([y, y]), 1.0, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcv.cross_validate(X, y, k=2, n_lambdas=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcv.cross_validate_reference(X, y, k=2, n_lambdas=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcv.ElasticNetCV(k=2, n_lambdas=3).fit(X, y)
    res = tcv.cross_validate(*cpu(X, y), k=2, n_lambdas=3)
    assert res.beta.device.type == "cpu" and res.mse_path.device.type == "cpu"
