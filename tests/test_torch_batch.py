"""Port parity of the batched solves: `repro_torch.core.batch` against
`repro.core.batch` (JAX's `vmap(_sven_core)`) and against the port's own
sequential `sven`, on the same float64 numpy problems, both modes.

Bounds: each lane within 1e-10 of JAX's `sven_batch` at `SvenConfig()`
(backend "xla") with the same Newton count, the bounds of
`tests/test_torch_sven.py::test_default_{dual,primal}_matches_jax_default`;
each lane within 1e-12 * max(1, max|beta|) of the port's sequential `sven`
on that lane with equal Newton and CG counts (ROADMAP Queue 1 item 2). The
lane-batched solve runs each lane's products and reductions as the single
solve's own ops, so on the CPU a lane is bitwise its sequential solve; the
bounds are kept for the card, where the hinge kernels run.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu, npy, problem
from repro.core import batch as jbatch
from repro.core.sven import SvenConfig as JSvenConfig
from repro_torch import kernels
from repro_torch.core import batch as tbatch
from repro_torch.core.sven import SvenConfig, sven
from repro_torch.core.svm import (dual_newton_lanes_machine, host_bool, make_lane_hyper,
                                  primal_newton_lanes_machine)
from repro_torch.core.svm.state import cg_lanes
from repro_torch.core import reduction as tred
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import registry

MODES = {"primal": (30, 50), "dual": (60, 12)}
PATTERNS = ("grid", "multi_response", "folds")
BACKENDS = ("torch", "auto")


def _operands(pattern, mode, seed=7):
    """numpy (X, y, t, lambda2) of a stacking pattern
    (tests/test_engine_batch_path.py:144-170): the (t, lambda2) grid on a
    shared X and y, three responses on a shared X, and four stacked folds."""
    n, p = MODES[mode]
    X, y = problem(n, p, seed=seed, k_true=5)
    if pattern == "grid":
        ts, l2s = jbatch.en_grid(jnp.asarray([0.6, 1.2, 2.0]), jnp.asarray([0.5, 1.0, 4.0]))
        return X, y, np.asarray(ts), np.asarray(l2s)
    if pattern == "multi_response":
        return X, np.stack([y, -y, 0.5 * y + 0.1]), np.asarray(1.5), np.asarray(0.7)
    Xtr, ytr, _, _ = jbatch.cv_folds(jnp.asarray(X), jnp.asarray(y), 4)
    return np.asarray(Xtr), np.asarray(ytr), np.asarray(1.5), np.asarray(0.7)


@functools.lru_cache(maxsize=None)
def _jax_batch(pattern, mode):
    X, y, t, l2 = _operands(pattern, mode)
    return jbatch.sven_batch(jnp.asarray(X), jnp.asarray(y), jnp.asarray(t),
                             jnp.asarray(l2), JSvenConfig())


def _lane_args(X, y, t, l2, i):
    """Lane i's operands for a sequential `sven` call: views of the stacks."""
    return (X if X.dim() == 2 else X[i], y if y.dim() == 1 else y[i],
            float(t if t.dim() == 0 else t[i]), float(l2 if l2.dim() == 0 else l2[i]))


def _assert_matches_sequential(sol, X, y, t, l2, config, **kw):
    """Every lane of `sol` against the port's sequential `sven` on it:
    beta within 1e-12 * max(1, max|beta|), equal Newton and CG counts."""
    for i in range(sol.beta.shape[0]):
        lane_kw = {k: v[i] for k, v in kw.items()}
        ref = sven(*_lane_args(X, y, t, l2, i), config, **lane_kw)
        scale = max(1.0, float(ref.beta.abs().max()))
        np.testing.assert_allclose(npy(sol.beta[i]), npy(ref.beta), rtol=0,
                                   atol=1e-12 * scale)
        assert int(sol.iters[i]) == ref.iters and int(sol.cg_iters[i]) == ref.cg_iters
        assert sol.mode == ref.mode


def test_en_grid_and_cv_folds_match_jax():
    X, y = problem(23, 6, seed=1)
    ts, l2s = np.array([0.3, 0.9, 2.5]), np.array([0.1, 1.0])
    jt, jl = jbatch.en_grid(jnp.asarray(ts), jnp.asarray(l2s))
    tt, tl = tbatch.en_grid(*cpu(ts, l2s))
    assert tt.shape == tl.shape == (6,)
    np.testing.assert_array_equal(npy(tt), np.asarray(jt))
    np.testing.assert_array_equal(npy(tl), np.asarray(jl))
    for k in (2, 5, 23):
        jf = jbatch.cv_folds(jnp.asarray(X), jnp.asarray(y), k)
        tf = tbatch.cv_folds(*cpu(X, y), k)
        for a, b in zip(tf, jf):
            assert tuple(a.shape) == b.shape
            np.testing.assert_array_equal(npy(a), np.asarray(b))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["primal", "dual"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_stacking_patterns_match_jax_and_sequential(pattern, mode, backend):
    """The plain "torch" solve and the default one (the kernels' plain bodies
    on CPU tensors) against JAX's vmapped solve and the port's own loop."""
    X, y, t, l2 = cpu(*_operands(pattern, mode))
    config = SvenConfig(backend=backend)
    sol = tbatch.sven_batch(X, y, t, l2, config)
    js = _jax_batch(pattern, mode)
    B = js.beta.shape[0]
    assert sol.mode == mode and sol.beta.shape == js.beta.shape == (B, X.shape[-1])
    assert sol.iters.shape == sol.cg_iters.shape == sol.kkt.shape == (B,)
    assert float(sol.beta.abs().max()) > 0
    np.testing.assert_allclose(npy(sol.beta), np.asarray(js.beta), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(npy(sol.iters), np.asarray(js.iters))
    np.testing.assert_allclose(npy(sol.w), np.asarray(js.w), rtol=0, atol=1e-8)
    assert float(sol.kkt.max()) < 1e-7
    _assert_matches_sequential(sol, X, y, t, l2, config)


def test_default_primal_launches_each_lane_pass_once_per_cg_step(monkeypatch):
    """On CPU tensors the default config runs the lane-batched op's plain
    bodies: one call of each pass per batched CG step, none of the single
    passes."""
    calls = {op: 0 for op in ("hinge_xtv", "hinge_xd", "hinge_xtv_lanes",
                              "hinge_xd_lanes")}
    for op in calls:
        body = registry.lookup(op, "ref")

        def counting(*a, _op=op, _body=body):
            calls[_op] += 1
            return _body(*a)

        monkeypatch.setitem(registry._REGISTRY, (op, "ref"), counting)
    X, y, t, l2 = cpu(*_operands("grid", "primal"))
    host_bool.syncs = cg_lanes.steps = 0
    sol = tbatch.sven_batch(X, y, t, l2)
    batched_syncs = host_bool.syncs
    assert calls["hinge_xtv"] == calls["hinge_xd"] == 0
    assert calls["hinge_xtv_lanes"] == calls["hinge_xd_lanes"] == cg_lanes.steps
    # the batched CG steps: at least the longest lane's, at most the sum
    assert int(sol.cg_iters.max()) <= calls["hinge_xtv_lanes"] < int(sol.cg_iters.sum())
    host_bool.syncs = 0
    for i in range(t.shape[0]):
        sven(*_lane_args(X, y, t, l2, i))
    assert batched_syncs < host_bool.syncs


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_keep_masks_leave_exact_zeros(mode):
    """keep (B, p) masks each lane apart (tests/test_api_cv.py:175): exact
    zeros on its screened-out columns, and the lane's own masked solve."""
    X, y, t, l2 = cpu(*_operands("grid", mode))
    p = X.shape[1]
    rng = np.random.default_rng(3)
    keep = torch.tensor(rng.random((t.shape[0], p)) > 0.3)
    keep[:, :5] = True
    for backend in BACKENDS:
        config = SvenConfig(backend=backend)
        sol = tbatch.sven_batch(X, y, t, l2, config, keep=keep)
        assert np.all(npy(sol.beta)[~npy(keep).astype(bool)] == 0.0)
        _assert_matches_sequential(sol, X, y, t, l2, config, keep=keep)
    # a shared (p,) mask keeps X shared and masks every lane alike
    shared = tbatch.sven_batch(X, y, t, l2, keep=keep[0])
    _assert_matches_sequential(shared, X, y, t, l2, SvenConfig(),
                               keep=keep[0].expand(t.shape[0], p))


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_warm_starts(mode):
    """Zero warm rows are exactly a cold start; other rows warm-start each
    lane as `sven`'s warm_alpha / warm_w do."""
    X, y, t, l2 = cpu(*_operands("multi_response", mode))
    n, p = X.shape
    B = y.shape[0]
    cold = tbatch.sven_batch(X, y, t, l2)
    zero = tbatch.sven_batch(X, y, t, l2, warm_alpha=torch.zeros(B, 2 * p,
                                                                dtype=X.dtype),
                             warm_w=torch.zeros(B, n, dtype=X.dtype))
    assert torch.equal(zero.beta, cold.beta) and torch.equal(zero.cg_iters, cold.cg_iters)
    near = tbatch.sven_batch(X, y, 1.1 * t, l2)
    warm = tbatch.sven_batch(X, y, t, l2, warm_alpha=near.alpha, warm_w=near.w)
    _assert_matches_sequential(warm, X, y, t, l2, SvenConfig(), warm_alpha=near.alpha,
                               warm_w=near.w)
    assert int(warm.iters.sum()) < int(cold.iters.sum())


def test_fista_lanes_match_jax_and_sequential():
    """solver="fista" on the dual: each lane with the sequential FISTA's
    iterations and beta, and within 1e-10 of JAX's vmapped FISTA."""
    X, y, t, l2 = _operands("grid", "dual")
    jcfg = JSvenConfig(solver="fista", tol=1e-9)
    js = jbatch.sven_batch(*(jnp.asarray(a) for a in (X, y, t, l2)), jcfg)
    X, y, t, l2 = cpu(X, y, t, l2)
    config = SvenConfig(solver="fista", backend="torch", tol=1e-9)
    sol = tbatch.sven_batch(X, y, t, l2, config)
    np.testing.assert_allclose(npy(sol.beta), np.asarray(js.beta), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(npy(sol.iters), np.asarray(js.iters))
    assert int(sol.cg_iters.abs().sum()) == 0
    _assert_matches_sequential(sol, X, y, t, l2, config)


@pytest.mark.parametrize("precision", ["bf16", "tf32"])
def test_low_precision_dual_lanes_refine(precision):
    """bf16 / tf32 Grams and each lane's full-precision refinement: the
    sequential refined solve on each lane, and within 1e-10 of the plain
    float64 solve (tests/test_torch_sven.py)."""
    X, y, t, l2 = cpu(*_operands("grid", "dual"))
    config = SvenConfig(precision=precision, tol=1e-12)
    sol = tbatch.sven_batch(X, y, t, l2, config)
    _assert_matches_sequential(sol, X, y, t, l2, config)
    plain = tbatch.sven_batch(X, y, t, l2, SvenConfig(backend="torch", tol=1e-12))
    np.testing.assert_allclose(npy(sol.beta), npy(plain.beta), rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_width_one_stack_is_the_single_solve(mode):
    X, y, t, l2 = cpu(*_operands("folds", mode))
    for config in (SvenConfig(), SvenConfig(backend="torch", matrix_free=False)):
        sol = tbatch.sven_batch(X[:1], y[:1], t, l2, config)
        ref = sven(X[0], y[0], float(t), float(l2), config)
        assert sol.beta.shape == (1, X.shape[-1]) and sol.mode == ref.mode
        assert torch.equal(sol.beta[0], ref.beta) and torch.equal(sol.w[0], ref.w)
        assert int(sol.iters[0]) == ref.iters and int(sol.cg_iters[0]) == ref.cg_iters


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_explicit_dataset_and_uncached_kernel_lanes(mode):
    """matrix_free=False (the explicit Xhat / K of the paper) and the dual's
    uncached matrix-free K v give each lane its sequential solve too."""
    X, y, t, l2 = cpu(*_operands("folds", mode))
    for config in (SvenConfig(backend="torch", matrix_free=False),
                   SvenConfig(cache_kernel="never")):
        sol = tbatch.sven_batch(X, y, t, l2, config)
        _assert_matches_sequential(sol, X, y, t, l2, config)


def test_validation_errors():
    X, y = cpu(*problem(30, 10, seed=9))
    with pytest.raises(ValueError, match="no batched operand"):
        tbatch.sven_batch(X, y, 1.0, 1.0)
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        tbatch.sven_batch(X, torch.stack([y, y]), torch.ones(3, dtype=X.dtype), 1.0)
    with pytest.raises(ValueError, match="route"):
        tbatch.sven_batch(X, torch.stack([y, y]), 1.0, 1.0, route="mesh")
    with pytest.raises(ValueError, match="X must be"):
        tbatch.sven_batch(X[0], torch.stack([y, y]), 1.0, 1.0)
    with pytest.raises(ValueError, match="cv_folds"):
        tbatch.cv_folds(X, y, 1)
    with pytest.raises(ValueError, match="cv_folds"):
        tbatch.cv_folds(X, y, 31)
    # every route spelling of JAX is accepted and changes nothing
    Y = torch.stack([y, -y])
    base = tbatch.sven_batch(X, Y, 1.0, 1.0)
    for route in tbatch.ROUTES:
        assert torch.equal(tbatch.sven_batch(X, Y, 1.0, 1.0, route=route).beta, base.beta)


def test_array_likes_need_cuda(monkeypatch):
    """Entry points given numpy arrays run on the CUDA device and never drop
    to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = problem(20, 5, seed=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.sven_batch(X, np.stack([y, y]), 1.0, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.en_grid([1.0, 2.0], [0.5])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.cv_folds(X, y, 2)


@pytest.mark.parametrize("precision", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("shared", [True, False])
def test_lane_hinge_op_equals_single_calls(shared, precision):
    """The lane-batched plain hinge op: each lane bitwise the single op on
    that lane's operands (shared or stacked X and y), in every dtype."""
    B, n, p = 3, 17, 40
    rng = np.random.default_rng(5)
    dtype = torch.float64 if precision == "f64" else torch.float32
    X = torch.tensor(rng.standard_normal((n, p) if shared else (B, n, p)), dtype=dtype)
    y = torch.tensor(rng.standard_normal(n if shared else (B, n)), dtype=dtype)
    v = torch.tensor(rng.standard_normal((B, n)), dtype=dtype)
    at = torch.tensor(rng.random((B, p)) > 0.4, dtype=dtype)
    ab = torch.tensor(rng.random((B, p)) > 0.6, dtype=dtype)
    t = torch.tensor([1.1, 0.7, 2.3], dtype=torch.float64)
    C = torch.tensor([2.5, 0.5, 1e3], dtype=torch.float64)
    prec = "f32" if precision == "f64" else precision
    kernels.reset_launches()
    hv = tops.hinge_hessian_matvec_lanes(X, y, t, C, at, ab, v, precision=prec)
    assert hv.shape == (B, n) and hv.dtype == dtype
    for i in range(B):
        Xi, yi = (X, y) if shared else (X[i], y[i])
        want = tops.hinge_hessian_matvec(Xi, yi, float(t[i]), float(C[i]), at[i], ab[i],
                                         v[i], precision=prec)
        assert torch.equal(hv[i], want)
        if precision == "f64":
            np.testing.assert_allclose(
                npy(hv[i]), npy(tref.hessian_matvec_ref(Xi, yi, float(t[i]), float(C[i]),
                                                        at[i], ab[i], v[i])),
                rtol=0, atol=1e-12)
    assert all(n_launch == 0 for n_launch in kernels.launches().values())
    with pytest.raises(ValueError, match="CUDA"):
        tops.hinge_hessian_matvec_lanes(X, y, t, C, at, ab, v, backend="cuda")


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_lane_machines_init_step_run(mode):
    """The lane machines' init/step/run: a step advances every lane, run
    stops each lane at its own convergence, with per-lane C and tol."""
    X, y, t, _ = cpu(*_operands("grid", mode))
    B = t.shape[0]
    ts = [float(v) for v in t]
    op = tred.SvenLaneOperator(X, y, ts)
    n, p = X.shape
    C = torch.tensor([0.5, 1.0, 4.0] * 3, dtype=X.dtype)
    if mode == "primal":
        yhat = torch.cat([X.new_ones(p), -X.new_ones(p)])
        machine = primal_newton_lanes_machine(op.xhat_matvec, op.xhat_rmatvec, yhat, n, B)
    else:
        machine = dual_newton_lanes_machine(op.kernel_matvec, 2 * p, B)
    hyper = make_lane_hyper(C, 1e-8, B, X.dtype, X.device)
    state = machine.init(hyper)
    assert not bool(state.converged.any()) and int(state.iters.sum()) == 0
    stepped = machine.step(state, hyper)
    assert torch.equal(stepped.iters, torch.ones(B, dtype=torch.int64))
    final = machine.run(hyper)
    assert bool(final.converged.all()) and float(final.residual.max()) <= 1e-8
    assert len(set(final.iters.tolist())) > 1 or len(set(final.aux.tolist())) > 1


@pytest.mark.parametrize("n,p", [(33, 57), (96, 130)])
@pytest.mark.parametrize("precision,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_lane_hinge_op_shared_x_matches_jax_interpret(n, p, precision, tol):
    """The plain lane op on a shared X at B = 17 lanes (more than one lane
    group of the shared-X route in every mode) against JAX's Pallas kernel
    in interpret mode under `jax.vmap` over the lanes, as
    `repro/core/batch.py` batches the solve: each lane within the bounds
    of `tests/test_torch_kernels.py::test_hinge_hessian_matvec_matches_jax_interpret`
    (tol x max(1, max|H v|) of that lane)."""
    import jax
    from repro.kernels import ops as jops

    B = 17
    X, y = problem(n, p, seed=3)
    rng = np.random.default_rng(17)
    v = rng.standard_normal((B, n))
    at = (rng.random((B, p)) > 0.4).astype(np.float64)
    ab = (rng.random((B, p)) > 0.6).astype(np.float64)
    t, C = rng.uniform(0.5, 3.0, B), rng.uniform(0.1, 10.0, B)
    f32 = functools.partial(cpu, dtype=torch.float32)
    hv = tops.hinge_hessian_matvec_lanes(*f32(X, y), torch.tensor(t), torch.tensor(C),
                                         *f32(at, ab, v), precision=precision)
    assert hv.shape == (B, n) and hv.dtype == torch.float32
    Xj, yj = (jnp.asarray(a, jnp.float32) for a in (X, y))

    def one(t_, C_, at_, ab_, v_):
        return jops.hinge_hessian_matvec(Xj, yj, t_, C_, at_, ab_, v_, bp=32, bn=32, bk=32,
                                         backend="tpu_interpret", precision=precision)

    hvj = np.asarray(jax.vmap(one)(*(jnp.asarray(a, jnp.float32) for a in (t, C, at, ab, v))))
    for i in range(B):
        scale = max(1.0, float(np.abs(hvj[i]).max()))
        np.testing.assert_allclose(npy(hv[i]), hvj[i], rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(5, 49), (5, 64), (3, 7, 9), (1, 33), (4, 128)])
def test_lanes_hand_each_lane_laid_out_as_a_fresh_tensor(shape, dtype):
    """`lanes` and `SvenLaneOperator` hand `fn` each lane of a stack at the
    buffer's base plus a multiple of 512 bytes (`pitched`), equal to the
    lane, so an op that sums in an order set by its operand's address sums
    every lane as on a fresh tensor; an operand passed twice is laid out
    once, a stack so laid out already is not copied, and every lane's
    result is the op's on that lane."""
    from repro_torch.core.svm import state

    x = torch.arange(float(np.prod(shape)), dtype=dtype).reshape(shape) * 0.37
    seen = []

    def fn(a, b):
        seen.append((a.data_ptr(), b.data_ptr()))
        assert a.is_contiguous() and torch.equal(a, b)
        return torch.sum(a * b)

    state.pitched.copies = 0
    out = state.lanes(fn, x, x)
    base = seen[0][0]
    assert all(a == b and (a - base) % state.LANE_PITCH == 0 for a, b in seen)
    assert torch.equal(out, torch.stack([torch.sum(x[i] * x[i]) for i in range(shape[0])]))
    row = x[0].numel() * x.element_size()
    assert state.pitched.copies == (0 if shape[0] == 1 or row % state.LANE_PITCH == 0 else 1)
    laid = state.pitched(x)
    assert state.pitched(laid) is laid and torch.equal(laid, x)
    assert all((laid[i].data_ptr() - laid.data_ptr()) % state.LANE_PITCH == 0
               for i in range(shape[0]))
    if len(shape) == 2:
        X, y = problem(6, shape[1] // 2 or 1, seed=1)
        op = tred.SvenLaneOperator(*cpu(X, y), [1.5] * shape[0])
        w = torch.randn(shape[0], 6, dtype=torch.float64)
        ptrs = []
        for one in op.ops:
            one_fn = one.xhat_matvec
            object.__setattr__(one, "xhat_matvec",
                               lambda v, f=one_fn: ptrs.append(v.data_ptr()) or f(v))
        got = op.xhat_matvec(w)
        assert all((q - ptrs[0]) % state.LANE_PITCH == 0 for q in ptrs)
        assert torch.equal(got, torch.stack([tred.SvenOperator(*cpu(X, y), 1.5).xhat_matvec(
            w[i]) for i in range(shape[0])]))
