"""The CG loop that reads its test once per block of steps (`cg_lanes`, the
port of JAX's `lax.while_loop` CG of `repro/core/svm/{primal,dual}_newton.py`).

`cg_lanes` evaluates the loop test on the device and reads it once per
block of k = `state.CG_READ_EVERY` steps; a lane's x is kept from the step
its test turned false, and the steps launched past it are discarded. So
any k gives the iterates and counts of the loop that reads before every
step (k = 1, the form of the loops before it), to the bit: held here for
`cg_lanes` (one and four lanes, one of them inactive, and the step limit),
`_cg`, `_masked_cg` and every entry point that runs them, at k = 1, the
default k and a k longer than any CG solve, against the per-step loops as
they were. Also held: the reads, at most ceil((c + 1) / k) per CG solve of
c steps beside the unchanged Newton and line-search reads, and the
launches of the hinge passes, one per CG step launched, live or dead."""
import importlib
import math

import numpy as np
import pytest
import torch

from _torch_parity import cpu, problem
from repro_torch.core import api as tapi
from repro_torch.core import batch as tbatch
from repro_torch.core.svm import dual_newton, primal_newton, state
from repro_torch.core.svm.state import cg_lanes, host_bool, lane_dot, lane_where
from repro_torch.kernels import registry

tsven = importlib.import_module("repro_torch.core.sven")   # the module, not the function
DEFAULT_K = state.CG_READ_EVERY
#: 1, the default and a block longer than any CG solve here
KS = (1, DEFAULT_K, 1000)


def _per_step_lanes(matvec, b, active, maxiter, tol):
    """The lane CG that reads its test before every step: `cg_lanes` as it
    was before it read once per block."""
    x, r, pvec, rs = torch.zeros_like(b), b, b, lane_dot(b, b)
    one = torch.ones_like(rs)
    thr = tol * tol
    its = torch.zeros(b.shape[0], dtype=torch.int64)
    it = 0
    while it < maxiter:
        run = active & (rs > thr)
        if not bool(run.any()):
            break
        Ap = matvec(pvec)
        denom = lane_dot(pvec, Ap)
        alpha = (rs / torch.where(denom > 0, denom, one))[:, None]
        x_new = x + alpha * pvec
        r_new = r - alpha * Ap
        rs_new = lane_dot(r_new, r_new)
        beta = (rs_new / torch.where(rs > 0, rs, one))[:, None]
        x, r, pvec, rs = lane_where(run, (x_new, r_new, r_new + beta * pvec, rs_new),
                                    (x, r, pvec, rs))
        its += run
        it += 1
    return x, its


def _per_step_single(matvec, b, maxiter, tol):
    """The single solve's CG that reads its test before every step: `_cg` as
    it was before it ran `cg_lanes`."""
    x, r, pvec, rs = torch.zeros_like(b), b, b, b @ b
    one = torch.ones_like(rs)
    it = 0
    while it < maxiter and bool(rs > tol * tol):
        Ap = matvec(pvec)
        denom = pvec @ Ap
        alpha = rs / torch.where(denom > 0, denom, one)
        x = x + alpha * pvec
        r = r - alpha * Ap
        rs_new = r @ r
        beta = rs_new / torch.where(rs > 0, rs, one)
        pvec = r + beta * pvec
        rs = rs_new
        it += 1
    return x, it


def _spd(B, d, seed=0):
    """B SPD (d, d) matrices of growing condition, right-hand sides and
    per-lane tolerances, as CPU tensors."""
    rng = np.random.default_rng(seed)
    A = []
    for i in range(B):
        M = rng.standard_normal((d, d))
        A.append(M @ M.T + (0.5 + 3.0 * i) * np.eye(d))
    b = rng.standard_normal((B, d))
    return cpu(np.stack(A)), cpu(b), cpu(np.geomspace(1e-12, 1e-6, B))


def _lane_matvec(A):
    return lambda V: torch.stack([A[i] @ V[i] for i in range(A.shape[0])])


def _reset():
    host_bool.syncs = cg_lanes.steps = cg_lanes.dead = 0


@pytest.mark.parametrize("maxiter", [5, 100])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("k", KS)
def test_cg_lanes_equals_the_per_step_loop(monkeypatch, k, B, maxiter):
    """Iterates and per-lane counts bitwise the per-step loop's, lane 1
    inactive at B = 4; the reads, the dead steps and the steps launched."""
    monkeypatch.setattr(state, "CG_READ_EVERY", k)
    A, b, tol = _spd(B, 24, seed=B)
    active = torch.tensor([True, False, True, True][:B])
    ref_x, ref_its = _per_step_lanes(_lane_matvec(A), b, active, maxiter, tol)
    _reset()
    x, counts, live = cg_lanes(_lane_matvec(A), b, active, maxiter, tol)
    assert torch.equal(x, ref_x) and counts == ref_its.tolist()
    c = int(ref_its.max())
    assert live == c and (B == 1 or counts[1] == 0)
    assert cg_lanes.steps == c + cg_lanes.dead and 0 <= cg_lanes.dead <= k - 1
    assert host_bool.syncs <= math.ceil((c + 1) / k)
    if maxiter == 100:
        assert 0 < c < maxiter and host_bool.syncs == math.ceil((c + 1) / k)
    if k == 1:
        assert cg_lanes.dead == 0 and host_bool.syncs == min(c + 1, maxiter)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", KS)
def test_single_cg_equals_the_per_step_loop(monkeypatch, k, masked):
    """`_cg` and `_masked_cg` (`cg_lanes` at one lane) against the single
    solve's per-step CG: the same bits and the same count."""
    monkeypatch.setattr(state, "CG_READ_EVERY", k)
    A, b, _ = _spd(1, 30, seed=7)
    A, b = A[0], b[0]
    mask = cpu((np.random.default_rng(3).random(30) > 0.3).astype(np.float64))
    _reset()
    if masked:
        x, it = dual_newton._masked_cg(lambda v: A @ v, b, mask, 200, 1e-11)
        ref_x, ref_it = _per_step_single(lambda v: mask * (A @ (mask * v)), mask * b, 200,
                                         1e-11)
        assert torch.equal(x[mask == 0], torch.zeros_like(x[mask == 0]))
    else:
        x, it = primal_newton._cg(lambda v: A @ v, b, 200, 1e-11)
        ref_x, ref_it = _per_step_single(lambda v: A @ v, b, 200, 1e-11)
    assert torch.equal(x, ref_x) and it == ref_it > 0 and isinstance(it, int)
    assert cg_lanes.steps == it + cg_lanes.dead and cg_lanes.dead <= k - 1
    assert host_bool.syncs == math.ceil((it + 1) / k)


def _pair_operands(shape, seed):
    X, y = problem(*shape, seed=seed, k_true=6)
    return cpu(X, y)


def _solve(case):
    """Run one entry point on a small problem (default config: the
    kernels' plain bodies on CPU tensors) and return (betas, Newton counts,
    CG counts)."""
    if case in ("sven primal", "sven dual", "sven primal torch"):
        mode = case.split()[1]
        X, y = _pair_operands((30, 50) if mode == "primal" else (60, 12), 11)
        cfg = tsven.SvenConfig(backend="torch" if case.endswith("torch") else "auto")
        sol = tsven.sven(X, y, 1.8, 0.7, cfg)
        assert sol.mode == mode
        return sol.beta, [sol.iters], [sol.cg_iters]
    if case == "sven_path":
        X, y = _pair_operands((30, 50), 5)
        sols = tsven.sven_path_solutions(X, y, np.linspace(0.4, 3.0, 6), 0.9)
        return (torch.stack([s.beta for s in sols]), [s.iters for s in sols],
                [s.cg_iters for s in sols])
    if case == "ElasticNet.fit":
        X, y = _pair_operands((30, 120), 3)
        l1 = 0.2 * float(2.0 * (X.T @ y).abs().max())
        model = tapi.ElasticNet(l1, 0.8).fit(X, y)
        return model.coef_, [model.result_.sven_iters], [model.result_.cg_iters]
    X, y = _pair_operands((30, 50), 7)
    if case == "sven_batch shared":
        ts, l2s = tbatch.en_grid(cpu(np.array([0.6, 1.2, 2.0])), cpu(np.array([0.5, 4.0])))
        sol = tbatch.sven_batch(X, y, ts, l2s)
    else:   # stacked folds
        Xtr, ytr, _, _ = tbatch.cv_folds(X, y, 4)
        sol = tbatch.sven_batch(Xtr, ytr, torch.tensor(1.5, dtype=X.dtype),
                                torch.tensor(0.7, dtype=X.dtype))
    assert sol.mode == "primal"
    return sol.beta, sol.iters.tolist(), sol.cg_iters.tolist()


CASES = ("sven primal", "sven dual", "sven primal torch", "sven_path", "ElasticNet.fit",
         "sven_batch shared", "sven_batch stacked")


@pytest.mark.parametrize("case", CASES)
def test_entry_points_same_bits_at_every_k(monkeypatch, case):
    """beta, Newton and CG counts at the default k and at a k longer than
    any CG solve are bitwise those at k = 1."""
    out = {}
    for k in KS:
        monkeypatch.setattr(state, "CG_READ_EVERY", k)
        out[k] = _solve(case)
    beta1, newton1, cg1 = out[1]
    assert float(beta1.abs().max()) > 0 and sum(cg1) > 0
    for k in KS[1:]:
        beta, newton, cg = out[k]
        assert torch.equal(beta, beta1), f"k = {k}"
        assert newton == newton1 and cg == cg1, f"k = {k}"


def _recording(monkeypatch, module):
    """Wrap `module.cg_lanes` so that each CG solve records (reads in it,
    the steps in which some lane ran, dead steps)."""
    solves = []

    def wrapper(*a, **kw):
        syncs, dead = host_bool.syncs, cg_lanes.dead
        out = cg_lanes(*a, **kw)
        solves.append((host_bool.syncs - syncs, out[2], cg_lanes.dead - dead))
        return out

    monkeypatch.setattr(module, "cg_lanes", wrapper)
    return solves


@pytest.mark.parametrize("case,module", [
    ("sven primal", primal_newton), ("sven dual", dual_newton),
    ("sven_batch shared", primal_newton), ("sven_batch stacked", primal_newton)])
def test_reads_obey_the_block_bound(monkeypatch, case, module):
    """At the default k each CG solve of c live steps reads its test at
    most ceil((c + 1) / k) times and launches at most k - 1 dead steps; the
    Newton and line-search reads are those of k = 1, where each CG solve
    reads c + 1 times."""
    solves = _recording(monkeypatch, module)
    syncs = {}
    for k in (1, DEFAULT_K):
        monkeypatch.setattr(state, "CG_READ_EVERY", k)
        solves.clear()
        _reset()
        _solve(case)
        syncs[k] = (host_bool.syncs, sum(r for r, _, _ in solves), list(solves))
    total1, cg_reads1, solves1 = syncs[1]
    total, cg_reads, solves_k = syncs[DEFAULT_K]
    assert len(solves_k) == len(solves1) > 0
    assert all(r == c + 1 and dead == 0 for r, c, dead in solves1)
    for (r, c, dead), (_, c1, _) in zip(solves_k, solves1):
        assert c == c1 and r <= math.ceil((c + 1) / DEFAULT_K) and dead <= DEFAULT_K - 1
    assert total - cg_reads == total1 - cg_reads1   # the other reads are unchanged
    assert total < total1


def _counting_hinge(monkeypatch, ops):
    calls = dict.fromkeys(ops, 0)
    for op in ops:
        body = registry.lookup(op, "ref")

        def counting(*a, _op=op, _body=body):
            calls[_op] += 1
            return _body(*a)

        monkeypatch.setitem(registry._REGISTRY, (op, "ref"), counting)
    return calls


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", ["sven primal", "sven_path", "ElasticNet.fit"])
def test_single_hinge_launches_are_live_plus_dead(monkeypatch, case, k):
    """One launch of each single hinge pass per CG step launched: the CG
    count of the solves plus their dead steps."""
    monkeypatch.setattr(state, "CG_READ_EVERY", k)
    calls = _counting_hinge(monkeypatch, ("hinge_xtv", "hinge_xd"))
    _reset()
    _, _, cg = _solve(case)
    assert calls["hinge_xtv"] == calls["hinge_xd"] == sum(cg) + cg_lanes.dead
    assert cg_lanes.steps == calls["hinge_xtv"] and (k > 1 or cg_lanes.dead == 0)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", ["sven_batch shared", "sven_batch stacked"])
def test_lane_hinge_launches_are_live_plus_dead(monkeypatch, case, k):
    """One launch of each lane-batched hinge pass per batched CG step
    launched: the steps in which some lane ran plus the dead steps."""
    monkeypatch.setattr(state, "CG_READ_EVERY", k)
    solves = _recording(monkeypatch, primal_newton)
    calls = _counting_hinge(monkeypatch, ("hinge_xtv", "hinge_xd", "hinge_xtv_lanes",
                                          "hinge_xd_lanes"))
    _reset()
    _, _, cg = _solve(case)
    live = sum(c for _, c, _ in solves)
    assert calls["hinge_xtv"] == calls["hinge_xd"] == 0
    assert calls["hinge_xtv_lanes"] == calls["hinge_xd_lanes"] == cg_lanes.steps
    assert cg_lanes.steps == live + cg_lanes.dead
    assert max(cg) <= live <= sum(cg)
