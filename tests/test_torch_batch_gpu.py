"""The lane-batched solves (`sven_batch`, `enet_batch`) and the hinge
passes against single solves and single launches on freshly allocated
copies of each lane's operands, on the card. Every test is `gpu`-marked
and skips where there is no CUDA device. This module imports no JAX (run
it with `--noconftest`):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_batch_gpu.py

A fresh tensor from the CUDA caching allocator starts on a 512-byte
boundary; a lane of a dense (B, m) stack starts i m bytes past one, which
for odd m is another offset. PyTorch's vectorised reductions take a head
of elements up to the operand's vector alignment, so their order of sums
follows the address; the solver hands each per-lane op its lane laid out as
a fresh tensor (`core/svm/state.py::pitched`). The bound everywhere is
bitwise equality: beta by `torch.equal`, and equal Newton and CG counts.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import enet, enet_batch
from repro_torch.core.batch import cv_folds, en_grid, sven_batch
from repro_torch.core.sven import sven
from repro_torch.core.svm import pitched
from repro_torch.core.svm.state import LANE_PITCH
from repro_torch.kernels import hinge as thinge
from repro_torch.kernels import ops as tops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lane_stack(dev, B, n, p, precision, shared, seed=5):
    """(X, y, v, act_top, act_bot, t, C) of B lanes as the batched primal
    hands them to the lane passes: a stacked X laid out by `pitched` (X
    (n, p) and y (n,) when `shared`), v (B, n) and act (B, p) dense; t and
    C (B,) float64. Float64 for "f64", else float32 with X in the
    precision's storage."""
    rng = np.random.default_rng(seed)
    dtype = torch.float64 if precision == "f64" else torch.float32
    lead = () if shared else (B,)

    def tensor(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    X = tops._storage(tensor(rng.standard_normal(lead + (n, p)) / np.sqrt(n)), precision)
    if not shared:
        X = pitched(X)
    return (X, tensor(rng.standard_normal(lead + (n,))), tensor(rng.standard_normal((B, n))),
            tensor(rng.random((B, p)) > 0.4), tensor(rng.random((B, p)) > 0.6),
            torch.tensor(rng.uniform(0.5, 3.0, B), dtype=torch.float64, device=dev),
            torch.tensor(rng.uniform(0.1, 10.0, B), dtype=torch.float64, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(37, 4099), (37, 513), (144, 49_151)])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("precision", ["f32", "bf16", "f64"])
def test_cuda_lane_passes_bitwise_single_launches_on_fresh_copies(cuda_device, precision,
                                                                    shared, n, p):
    """Each lane of both lane passes, odd lanes of a stack of odd p among
    them, is bitwise a single launch on freshly allocated copies of that
    lane's operands, every one of which lies at another address than the
    lane's rows of the stacks."""
    B = 5
    X, y, v, at, ab, t, C = _lane_stack(cuda_device, B, n, p, precision, shared)
    d, e_part = thinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab)
    hv = thinge.hinge_xd_lanes_cuda(X, y, d, e_part, v, t, C)
    for i in range(B):
        Xi = (X if shared else X[i]).clone()
        yi = (y if shared else y[i]).clone()
        vi, ati, abi = v[i].clone(), at[i].clone(), ab[i].clone()
        di, ei = thinge.hinge_xtv_cuda(Xi, yi, vi, float(t[i]), ati, abi)
        assert torch.equal(d[i], di) and torch.equal(e_part[i], ei), f"pass 1, lane {i}"
        hvi = thinge.hinge_xd_cuda(Xi, yi, d[i].clone(), e_part[i].clone(), vi, float(t[i]),
                                   float(C[i]))
        assert torch.equal(hv[i], hvi), f"pass 2, lane {i}"


def _primal_stack(dev, shared, B=5, n=40, p=1001, seed=11):
    """A small primal problem stack (2p > n, p odd) on the card: B folds of
    their own X and y, or a (t, lambda2) grid on one X."""
    rng = np.random.default_rng(seed)
    lead = () if shared else (B,)
    beta = np.zeros(lead + (p,))
    beta[..., : p // 20] = rng.standard_normal(lead + (p // 20,))
    X = rng.standard_normal(lead + (n, p))
    y = np.einsum("...np,...p->...n", X, beta) + 0.1 * rng.standard_normal(lead + (n,))
    f64 = dict(dtype=torch.float64, device=dev)
    X, y = torch.tensor(X, **f64), torch.tensor(y, **f64)
    t = 0.5 * np.abs(beta).sum(-1).mean()
    if shared:
        t, l2 = en_grid(torch.tensor([0.5, 1.0], **f64) * t,
                        torch.tensor([0.5, 1.0, 4.0], **f64))
    else:
        t, l2 = torch.tensor(t, **f64), torch.tensor(1.0, **f64)
    return X, y, t, l2


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [True, False])
def test_cuda_sven_batch_lanes_bitwise_fresh_sequential_solves(cuda_device, shared):
    """`sven_batch` on a primal stack of odd p (stacked folds, or a
    (t, lambda2) grid on a shared X), default config (the float64 lane
    passes): every lane is bitwise `sven` on freshly allocated copies of
    its operands, with equal Newton and CG counts."""
    X, y, t, l2 = _primal_stack(cuda_device, shared)
    sol = sven_batch(X, y, t, l2)
    B = sol.beta.shape[0]
    assert sol.mode == "primal" and B >= 4
    for i in range(B):
        Xi = (X if shared else X[i]).clone()
        yi = (y if shared else y[i]).clone()
        s = sven(Xi, yi, float(t if t.dim() == 0 else t[i]),
                 float(l2 if l2.dim() == 0 else l2[i]))
        assert (int(sol.iters[i]), int(sol.cg_iters[i])) == (s.iters, s.cg_iters), f"lane {i}"
        assert torch.equal(sol.beta[i], s.beta), f"lane {i}"


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [True, False])
def test_cuda_enet_batch_lanes_bitwise_fresh_sequential_enets(cuda_device, shared):
    """`enet_batch` on a primal stack of odd p (stacked folds with one
    lambda1 each, or lambda1 x lambda2 pairs on a shared X), default
    config: every lane is bitwise `enet` on freshly allocated copies of its
    operands, with equal evaluations, Newton and CG counts."""
    X, y, _, _ = _primal_stack(cuda_device, shared)
    B = 6 if shared else X.shape[0]
    f64 = dict(dtype=torch.float64, device=cuda_device)
    if shared:
        head = 2.0 * (X.T @ y).abs().max().item()
        l1 = torch.tensor([0.4, 0.2, 0.1] * 2, **f64) * head
        l2 = torch.tensor([0.5] * 3 + [2.0] * 3, **f64)
    else:
        heads = torch.stack([2.0 * (X[i].T @ y[i]).abs().max() for i in range(B)])
        l1 = heads * torch.linspace(0.1, 0.5, B, **f64)
        l2 = torch.tensor(1.0, **f64)
    pts = enet_batch(X, y, l1, l2)
    assert len(pts.evals) == B and len(set(pts.evals)) > 1
    for i in range(B):
        Xi = (X if shared else X[i]).clone()
        yi = (y if shared else y[i]).clone()
        r = enet(Xi, yi, float(l1[i]), float(l2 if l2.dim() == 0 else l2[i]))
        assert (pts.evals[i], pts.sven_iters[i], pts.cg_iters[i]) == \
            (r.evals, r.sven_iters, r.cg_iters), f"lane {i}"
        assert torch.equal(pts.beta[i], r.beta) and torch.equal(pts.t[i], r.t), f"lane {i}"


@pytest.mark.gpu
def test_cuda_cv_folds_lay_out_each_fold_as_a_fresh_tensor(cuda_device):
    """`cv_folds` returns training folds of X whose lanes start on 512-byte
    boundaries, so `sven_batch` solves them without a copy."""
    X, y, _, _ = _primal_stack(cuda_device, shared=True, n=45, p=1001)
    Xtr, _, _, _ = cv_folds(X, y, 5)
    assert all(Xtr[i].data_ptr() % LANE_PITCH == 0 for i in range(5))
    assert pitched(Xtr) is Xtr


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bf16", "f64"])
def test_cuda_stacked_route_repeats_at_9b(cuda_device, precision):
    """The stacked route at the shape of cv_folds(X, y, 5) of GLA-BRA-180 (5
    x 144 x 49,151): three launches of each pass give the same bits, every
    ticket is 0 afterwards, and the first and last lanes are bitwise single
    launches."""
    B, n, p = 5, 144, 49_151
    X, y, v, at, ab, t, C = _lane_stack(cuda_device, B, n, p, precision, shared=False)
    assert thinge.plan(B, n, p, X.dtype, False).route == "stacked"
    d, e_part = thinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab)
    hv = thinge.hinge_xd_lanes_cuda(X, y, d, e_part, v, t, C)
    for _ in range(3):
        d2, e2 = thinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab)
        assert torch.equal(d2, d) and torch.equal(e2, e_part)
        assert torch.equal(thinge.hinge_xd_lanes_cuda(X, y, d2, e2, v, t, C), hv)
    torch.cuda.synchronize()
    assert all(int(b.abs().sum()) == 0 for b in thinge._TICKETS.values())
    for i in (0, B - 1):
        di, ei = thinge.hinge_xtv_cuda(X[i], y[i], v[i], float(t[i]), at[i], ab[i])
        assert torch.equal(d[i], di) and torch.equal(e_part[i], ei)
        assert torch.equal(hv[i], thinge.hinge_xd_cuda(X[i], y[i], di, ei, v[i],
                                                       float(t[i]), float(C[i])))
