"""Port parity of the SVEN entry points: `repro_torch.core.sven` against
`repro.core.sven` on the same float64 numpy problems, both modes.

Bounds: plain "torch" vs JAX "xla" 1e-10 in beta; the kernel path ("ref"
on the CPU: the kernels' plain versions, which sum this float64 data in
float64) vs JAX "tpu_interpret" (f32 kernels, no refinement)
5e-4 * max|beta| (tests/test_sven_equivalence.py); bf16 dual + refinement
1e-10 of the plain solve (tests/test_kernels_gpu.py); the default config on
a float64 problem (its Gram and both hinge passes summed in float64) vs
JAX's default "xla" 1e-10 with equal Newton iterations, and on the primal
with the CG steps of the port's plain "torch" solve, which is JAX "xla"'s
arithmetic (JAX reports no CG count)."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu, npy, problem
from repro_torch.convert import config_from_jax, problem_from_numpy, warm_from_jax
from repro_torch.core.sven import SvenConfig

# the modules, not the `sven` functions their packages re-export
jsven_mod = importlib.import_module("repro.core.sven")
tsven_mod = importlib.import_module("repro_torch.core.sven")

MODES = {"primal": (30, 50), "dual": (60, 12)}


def _pair(mode, seed=11, **cfg):
    n, p = MODES[mode]
    X, y = problem(n, p, seed=seed, k_true=6)
    jcfg = jsven_mod.SvenConfig(mode=mode, **cfg)
    return (X, y), (jnp.asarray(X), jnp.asarray(y)), jcfg, \
        config_from_jax(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_torch_backend_matches_jax_xla(mode):
    (X, y), (Xj, yj), jcfg, tcfg = _pair(mode, backend="xla", tol=1e-10)
    assert tcfg.backend == "torch"
    js = jsven_mod.sven(Xj, yj, 1.8, 0.7, jcfg)
    ts = tsven_mod.sven(*problem_from_numpy(X, y, device="cpu"), 1.8, 0.7, tcfg)
    assert ts.mode == js.mode == mode
    np.testing.assert_allclose(npy(ts.beta), npy(js.beta), rtol=0, atol=1e-10)
    np.testing.assert_allclose(npy(ts.w), npy(js.w), rtol=0, atol=1e-8)
    assert ts.iters == int(js.iters)
    assert float(ts.kkt) < 1e-7 and float(js.kkt) < 1e-7


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_kernel_path_matches_jax_interpret(mode):
    """Default config on CPU tensors = the plain kernel bodies ("ref")."""
    (X, y), (Xj, yj), jcfg, _ = _pair(mode, backend="tpu_interpret", tol=1e-6)
    js = jsven_mod.sven(Xj, yj, 1.8, 0.7, jcfg)
    ts = tsven_mod.sven(*problem_from_numpy(X, y, device="cpu"), 1.8, 0.7,
                        SvenConfig(mode=mode, tol=1e-6))
    scale = max(1.0, float(np.abs(npy(js.beta)).max()))
    np.testing.assert_allclose(npy(ts.beta), npy(js.beta), rtol=0, atol=5e-4 * scale)


def test_default_dual_matches_jax_default():
    """Both packages' default SvenConfig() on a float64 dual problem: the
    port's "ref" Gram body sums the float64 operands in float64, so it gives
    JAX "xla"'s answer, with the same Newton iterations."""
    n, p = MODES["dual"]
    X, y = problem(n, p, seed=11, k_true=6)
    jcfg = jsven_mod.SvenConfig()
    assert jcfg.backend == "xla" and SvenConfig().backend == "auto"
    js = jsven_mod.sven(jnp.asarray(X), jnp.asarray(y), 1.8, 0.7, jcfg)
    ts = tsven_mod.sven(*problem_from_numpy(X, y, device="cpu"), 1.8, 0.7, SvenConfig())
    assert ts.mode == js.mode == "dual"
    np.testing.assert_allclose(npy(ts.beta), npy(js.beta), rtol=0, atol=1e-10)
    assert ts.iters == int(js.iters)


def test_default_primal_matches_jax_default():
    """Both packages' default SvenConfig() on a float64 primal problem: the
    port's "ref" hinge bodies take the float64 operands and sum in float64,
    so the default solve is JAX "xla"'s, with its Newton iterations and the
    CG steps of the plain float64 solve."""
    n, p = MODES["primal"]
    X, y = problem(n, p, seed=11, k_true=6)
    js = jsven_mod.sven(jnp.asarray(X), jnp.asarray(y), 1.8, 0.7, jsven_mod.SvenConfig())
    Xt, yt = problem_from_numpy(X, y, device="cpu")
    ts = tsven_mod.sven(Xt, yt, 1.8, 0.7, SvenConfig())
    plain = tsven_mod.sven(Xt, yt, 1.8, 0.7, SvenConfig(backend="torch"))
    assert ts.mode == js.mode == "primal"
    np.testing.assert_allclose(npy(ts.beta), npy(js.beta), rtol=0, atol=1e-10)
    assert ts.iters == int(js.iters) == plain.iters
    assert ts.cg_iters == plain.cg_iters > 0


def test_default_primal_path_matches_jax_default(monkeypatch):
    """`sven_path` with both packages' defaults at the primal shape: betas
    within 1e-10 of JAX's, and one call of each hinge pass per CG step of
    the same path on the plain float64 backend, with the CG test read
    before every step (k = 1). At the default k, one more per dead CG step
    (a step launched after its loop test turned false, `cg_lanes.dead`),
    at most k - 1 of them per CG solve."""
    from repro_torch.core.svm import state
    from repro_torch.kernels import registry
    calls = {"hinge_xtv": 0, "hinge_xd": 0}
    for op in calls:
        body = registry.lookup(op, "ref")

        def counting(*a, _op=op, _body=body):
            calls[_op] += 1
            return _body(*a)

        monkeypatch.setitem(registry._REGISTRY, (op, "ref"), counting)
    n, p = MODES["primal"]
    X, y = problem(n, p, seed=5, k_true=6)
    grid = np.linspace(0.4, 3.0, 6)
    jb = jsven_mod.sven_path(jnp.asarray(X), jnp.asarray(y), grid, 0.9,
                             jsven_mod.SvenConfig())
    Xt, yt = problem_from_numpy(X, y, device="cpu")
    plain = tsven_mod.sven_path_solutions(Xt, yt, grid, 0.9, SvenConfig(backend="torch"))
    plain_cg = sum(sol.cg_iters for sol in plain)
    newton = sum(sol.iters for sol in plain)
    k = state.CG_READ_EVERY
    for every in (1, k):
        monkeypatch.setattr(state, "CG_READ_EVERY", every)
        calls.update(hinge_xtv=0, hinge_xd=0)
        state.cg_lanes.dead = 0
        tb = tsven_mod.sven_path(Xt, yt, grid, 0.9)
        np.testing.assert_allclose(npy(tb), npy(jb), rtol=0, atol=1e-10)
        if every == 1:
            assert state.cg_lanes.dead == 0
            assert calls["hinge_xtv"] == calls["hinge_xd"] == plain_cg > 0
        else:
            dead = state.cg_lanes.dead
            assert dead <= (k - 1) * newton
            assert calls["hinge_xtv"] == calls["hinge_xd"] == plain_cg + dead > 0


@pytest.mark.parametrize("dtype,precision,want", [
    (torch.float64, "f32", torch.float64), (torch.float32, "f32", torch.float32),
    (torch.float64, "tf32", torch.float32), (torch.float64, "bf16", torch.bfloat16)])
def test_hinge_operands_follow_problem_dtype_and_precision(monkeypatch, dtype, precision,
                                                           want):
    """The primal's hinge passes get float64 operands only for a float64
    problem at "f32"; a float32 problem and tf32 get float32, and bf16
    bfloat16 storage of X beside float32 operands, whose passes sum in
    float32. Seen through counting stand-ins for the registry's "ref"
    bodies; one call of each per CG step with the CG test read before
    every step (k = 1), and at the default k one more per dead step
    (`cg_lanes.dead`), at most k - 1 of them per CG solve."""
    from repro_torch.core.svm import state
    from repro_torch.kernels import registry
    xtv, xd = registry.lookup("hinge_xtv", "ref"), registry.lookup("hinge_xd", "ref")
    seen = {"hinge_xtv": [], "hinge_xd": []}

    def counting_xtv(X, y, v, t, at, ab):
        d, e = xtv(X, y, v, t, at, ab)
        seen["hinge_xtv"].append((X.dtype, y.dtype, v.dtype, at.dtype, ab.dtype,
                                  d.dtype))
        return d, e

    def counting_xd(X, y, d, e, v, t, C):
        hv = xd(X, y, d, e, v, t, C)
        seen["hinge_xd"].append((X.dtype, y.dtype, d.dtype, v.dtype, hv.dtype))
        return hv

    monkeypatch.setitem(registry._REGISTRY, ("hinge_xtv", "ref"), counting_xtv)
    monkeypatch.setitem(registry._REGISTRY, ("hinge_xd", "ref"), counting_xd)
    n, p = MODES["primal"]
    X, y = cpu(*problem(n, p, seed=11, k_true=6), dtype=dtype)
    acc = torch.float64 if want == torch.float64 else torch.float32
    k = state.CG_READ_EVERY
    for every in (1, k):
        monkeypatch.setattr(state, "CG_READ_EVERY", every)
        seen["hinge_xtv"].clear()
        seen["hinge_xd"].clear()
        state.cg_lanes.dead = 0
        sol = tsven_mod.sven(X, y, 1.8, 0.7, SvenConfig(precision=precision))
        assert sol.mode == "primal" and sol.beta.dtype == dtype
        if every == 1:
            assert state.cg_lanes.dead == 0
            assert len(seen["hinge_xtv"]) == len(seen["hinge_xd"]) == sol.cg_iters > 0
        else:
            dead = state.cg_lanes.dead
            assert dead <= (k - 1) * sol.iters
            assert len(seen["hinge_xtv"]) == len(seen["hinge_xd"]) == sol.cg_iters + dead > 0
        assert set(seen["hinge_xtv"]) == {(want, acc, acc, acc, acc, acc)}
        assert set(seen["hinge_xd"]) == {(want, acc, acc, acc, acc)}


@pytest.mark.parametrize("dtype,precision,want", [
    (torch.float64, "f32", torch.float64), (torch.float32, "f32", torch.float32),
    (torch.float64, "tf32", torch.float32), (torch.float64, "bf16", torch.bfloat16)])
def test_gram_operands_follow_problem_dtype_and_precision(monkeypatch, dtype, precision,
                                                          want):
    """The dual's one Gram call gets float64 operands only for a float64
    problem at "f32"; a float32 problem, and tf32/bf16, get float32 (bf16
    storage), as before. Seen through a counting stand-in for the
    registry's "ref" body."""
    from repro_torch.kernels import registry
    body = registry.lookup("shifted_gram", "ref")
    seen = []

    def counting(X, y, t, **kw):
        seen.append((X.dtype, y.dtype, kw["precision"]))
        return body(X, y, t, **kw)

    monkeypatch.setitem(registry._REGISTRY, ("shifted_gram", "ref"), counting)
    n, p = MODES["dual"]
    X, y = cpu(*problem(n, p, seed=11, k_true=6), dtype=dtype)
    sol = tsven_mod.sven(X, y, 1.8, 0.7, SvenConfig(precision=precision))
    assert sol.mode == "dual" and sol.beta.dtype == dtype
    assert seen == [(want, want, precision)]


def test_float32_dual_matches_jax_float32():
    """A float32 problem at the default precision, through the port's plain
    bodies (its Gram summed in float32, as the CUDA kernel's float32 body
    sums it), against JAX's float32 solve with its `ref` bodies, on the same
    numpy inputs cast to float32: the same Newton count, beta within
    1e-5 * max|beta|.

    tol 1e-6: float32's projected gradient cannot go much below eps times
    its terms (it stalls at 1.2e-7 - 2.4e-7 here), so at the default 1e-8
    a float32 solve stops by chance, when a rounding makes it 0, and the two
    packages' counts then differ even on one shared K (their products round
    apart). 1e-5: the deviation measured here is 4.3e-7 of max|beta|; the
    bound leaves room for other summation orders and is 50x under the
    kernel path's 5e-4 (tests/test_sven_equivalence.py)."""
    (X, y), _, _, _ = _pair("dual")
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    js = jsven_mod.sven(jnp.asarray(X32), jnp.asarray(y32), 1.8, 0.7,
                        jsven_mod.SvenConfig(backend="ref", tol=1e-6))
    ts = tsven_mod.sven(*cpu(X32, y32, dtype=torch.float32), 1.8, 0.7,
                        SvenConfig(tol=1e-6))
    assert ts.mode == js.mode == "dual"
    assert ts.beta.dtype == torch.float32 and js.beta.dtype == jnp.float32
    assert float(ts.opt_residual) <= 1e-6 and float(js.opt_residual) <= 1e-6
    assert ts.iters == int(js.iters)
    scale = float(np.abs(npy(js.beta)).max())
    np.testing.assert_allclose(npy(ts.beta), npy(js.beta), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("n,p,seed", [(120, 16, 0), (200, 24, 7)])
@pytest.mark.parametrize("precision", ["bf16", "tf32"])
def test_low_precision_dual_refines_to_the_plain_solve(n, p, seed, precision):
    """Port side of tests/test_kernels_gpu.py::_check_bf16_refined."""
    rng = np.random.default_rng(seed)
    X, y = cpu(rng.standard_normal((n, p)) / np.sqrt(n), rng.standard_normal(n))
    t = 1.0 + 0.01 * seed
    plain = tsven_mod.sven(X, y, t, 0.5, SvenConfig(mode="dual", backend="torch",
                                                    tol=1e-12))
    low = tsven_mod.sven(X, y, t, 0.5, SvenConfig(mode="dual", precision=precision,
                                                  tol=1e-12))
    np.testing.assert_allclose(npy(low.beta), npy(plain.beta), rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_keep_mask_scatters_back_exact_zeros(mode):
    n, p = MODES[mode]
    X, y = cpu(*problem(n, p, seed=2, k_true=4))
    keep = cpu(np.arange(p) % 3 != 0).bool()
    for backend in ("torch", "auto"):
        sol = tsven_mod.sven(X, y, 1.5, 0.5, SvenConfig(mode=mode, backend=backend),
                             keep=keep)
        assert np.all(npy(sol.beta)[~npy(keep).astype(bool)] == 0.0)
        ref = tsven_mod.sven(X[:, keep], y, 1.5, 0.5,
                             SvenConfig(mode=mode, backend=backend))
        np.testing.assert_allclose(npy(sol.beta)[npy(keep).astype(bool)],
                                   npy(ref.beta), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_sven_path_matches_jax_and_reference(mode):
    (X, y), (Xj, yj), jcfg, tcfg = _pair(mode, seed=5, backend="xla", tol=1e-10)
    ts = np.linspace(0.4, 3.0, 6)
    jb = jsven_mod.sven_path(Xj, yj, ts, 0.9, jcfg)
    Xt, yt = problem_from_numpy(X, y, device="cpu")
    tb = tsven_mod.sven_path(Xt, yt, ts, 0.9, tcfg)
    assert tb.shape == (6, X.shape[1])
    np.testing.assert_allclose(npy(tb), npy(jb), rtol=0, atol=1e-10)
    rb = tsven_mod.sven_path_reference(Xt, yt, ts, 0.9, tcfg)
    np.testing.assert_allclose(npy(rb), npy(tb), rtol=0, atol=1e-10)
    kb = tsven_mod.sven_path(Xt, yt, ts, 0.9, SvenConfig(mode=mode))   # plain kernels
    np.testing.assert_allclose(npy(kb), npy(tsven_mod.sven_path_reference(
        Xt, yt, ts, 0.9, SvenConfig(mode=mode))), rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_warm_start_from_jax_reproduces_iteration_count(mode):
    (X, y), (Xj, yj), jcfg, tcfg = _pair(mode, seed=3, backend="xla")
    first = jsven_mod.sven(Xj, yj, 1.5, 0.7, jcfg)
    jwarm = jsven_mod.sven(Xj, yj, 1.7, 0.7, jcfg, warm_alpha=first.alpha,
                           warm_w=first.w)
    wa, ww = warm_from_jax(np.asarray(first.alpha), np.asarray(first.w), device="cpu")
    twarm = tsven_mod.sven(*problem_from_numpy(X, y, device="cpu"), 1.7, 0.7, tcfg,
                           warm_alpha=wa, warm_w=ww)
    assert twarm.iters == int(jwarm.iters) < int(jsven_mod.sven(
        Xj, yj, 1.7, 0.7, jcfg).iters)
    np.testing.assert_allclose(npy(twarm.beta), npy(jwarm.beta), rtol=0, atol=1e-10)


def test_fista_is_not_ported_yet():
    """`solver="fista"` on the dual (plain "torch" vs JAX "xla"): beta within
    1e-10 and the same iteration count; the primal ignores the setting, as
    in JAX."""
    (X, y), (Xj, yj), jcfg, tcfg = _pair("dual", solver="fista", backend="xla",
                                         tol=1e-9)
    assert tcfg.solver == "fista"
    js = jsven_mod.sven(Xj, yj, 1.8, 0.7, jcfg)
    ts = tsven_mod.sven(*problem_from_numpy(X, y, device="cpu"), 1.8, 0.7, tcfg)
    np.testing.assert_allclose(npy(ts.beta), npy(js.beta), rtol=0, atol=1e-10)
    assert ts.iters == int(js.iters) and ts.cg_iters == 0
    newton = tsven_mod.sven(*problem_from_numpy(X, y, device="cpu"), 1.8, 0.7,
                            dataclasses.replace(tcfg, solver="newton", tol=1e-10))
    np.testing.assert_allclose(npy(ts.beta), npy(newton.beta), rtol=0, atol=1e-6)
    Xp, yp = cpu(*problem(20, 30))
    np.testing.assert_array_equal(
        npy(tsven_mod.sven(Xp, yp, 1.0, 1.0, SvenConfig(solver="fista")).beta),
        npy(tsven_mod.sven(Xp, yp, 1.0, 1.0, SvenConfig()).beta))
