"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test is `gpu`-marked and skips where there is no CUDA
device. This module imports no JAX, so that it runs on a machine without
it (tests/conftest.py imports JAX, hence `--noconftest`):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

Bounds: the float32, tf32 and bfloat16 Gram 1e-5 * scale (the plain
version sums the same operands, rounded to TF32 exactly as the kernel
rounds them or in bfloat16 storage, and their products are exact in
float32, so only the float32 sums differ: their order, and the tensor
cores' own rounding inside a product); the hinge passes in bfloat16
storage 2e-2 * scale (tests/test_kernels.py); the
float64 Gram 1e-10 * max|K| (float64 sums in another order: n eps is
1.1e-13 at n = 1000, 5.1e-11 at the YMSD shape's n = 463,715); the float64
hinge passes 1e-10 * max(1, |ref|) (p eps is 5.5e-12 at p = 49,151).
"""
import importlib

import numpy as np
import pytest
import torch

from _torch_parity import cpu, npy, problem
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import hinge as thinge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ths = importlib.import_module("repro_torch.kernels.hinge_stats")

SHAPES = [(33, 57), (96, 130), (57, 33), (48, 256)]
DTYPES = [("f32", 1e-5), ("bf16", 2e-2)]
F64 = ("f64", 1e-10)
#: the Gram's float32 modes: the plain version sums the kernel's operands
GRAM_TOL = {"f32": 1e-5, "tf32": 1e-5, "bf16": 1e-5}


def _inputs(n, p, seed=0):
    X, y = problem(n, p, seed=seed)
    rng = np.random.default_rng(seed + 1)
    v = rng.standard_normal(n)
    at = (rng.random(p) > 0.4).astype(np.float64)
    ab = (rng.random(p) > 0.6).astype(np.float64)
    return X, y, v, at, ab


def _f32(*arrays):
    return cpu(*arrays, dtype=torch.float32)


def _hinge_operands(dev, n, p, precision):
    """(X, y, v, act_top, act_bot) on `dev` as the primal hands them to the
    hinge passes: all float64 for "f64", else float32 with X in the
    precision's storage."""
    arrays = _inputs(n, p)
    if precision == "f64":
        return tuple(a.to(dev) for a in cpu(*arrays))
    X, y, v, at, ab = (a.to(dev) for a in _f32(*arrays))
    return (tops._storage(X, precision), y, v, at, ab)


def _assert_scaled(a, b, tol, floor=0.0):
    a, b = npy(a), npy(b)
    scale = max(floor, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", SHAPES + [(1000, 90)])
@pytest.mark.parametrize("precision,tol", list(GRAM_TOL.items()))
def test_cuda_gram_matches_plain(cuda_device, n, p, precision, tol):
    X, y, *_ = _inputs(n, p)
    Xs = tops._storage(_f32(X).to(cuda_device), precision)
    ys = tops._storage(_f32(y).to(cuda_device), precision)
    # at t = 1e6 the shift terms vanish, so X^T X is held at its own scale
    for t in (0.9, 1e6):
        before = tgram.shifted_gram_cuda.launches
        K = tgram.shifted_gram_cuda(Xs, ys, t, precision=precision)
        Kb = tgram.shifted_gram_cuda(Xs, ys, t, precision=precision, flatten=False)
        torch.cuda.synchronize()
        assert tgram.shifted_gram_cuda.launches == before + 2
        Kr = tref.flatten_gram(tref.gram_blocks_ref(Xs, ys, t, precision))
        _assert_scaled(K, Kr, tol)
        np.testing.assert_array_equal(npy(tref.flatten_gram(Kb)), npy(K))


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(33, 57), (1000, 130)])
def test_cuda_gram_f64_matches_plain(cuda_device, n, p):
    """Float64 operands at precision "f32" run the float64 body: K is
    float64, within 1e-10 * max|K| of the plain float64 Gram. 1000 x 130
    spans three 64-column tiles and many row splits."""
    X, y, *_ = _inputs(n, p)
    Xd, yd = (a.to(cuda_device) for a in cpu(X, y))
    for t in (0.9, 1e6):
        before = tgram.shifted_gram_cuda.launches
        K = tgram.shifted_gram_cuda(Xd, yd, t)
        Kb = tgram.shifted_gram_cuda(Xd, yd, t, flatten=False)
        torch.cuda.synchronize()
        assert tgram.shifted_gram_cuda.launches == before + 2
        assert K.dtype == torch.float64 and K.shape == (2 * p, 2 * p)
        _assert_scaled(K, tref.flatten_gram(tref.gram_blocks_ref(Xd, yd, t)), 1e-10)
        np.testing.assert_array_equal(npy(tref.flatten_gram(Kb)), npy(K))
        # the op hands float64 operands at "f32" to the same body
        np.testing.assert_array_equal(npy(tops.shifted_gram(Xd, yd, t)), npy(K))


@pytest.mark.gpu
def test_cuda_gram_f64_mma_layout(cuda_device):
    """The float64 body's fragment layout, on the card, before anything
    built on it: one diagonal and one off-diagonal warp tile of 4 rows
    through the kernel's own loads, m16n8k4 products and stores give S^T S
    at every entry i <= j of the first 32 rows, and nothing elsewhere."""
    S = torch.tensor(np.random.default_rng(5).standard_normal((4, 64)), device=cuda_device)
    D = npy(tgram.f64_mma_probe(S))
    Sn = npy(S)
    want = np.triu(Sn.T @ Sn)
    want[32:] = 0.0
    np.testing.assert_allclose(D, want, rtol=0, atol=1e-13 * np.abs(want).max())


#: the float64 body's edges: p + 1 across the 8-column groups, the 32-column
#: warp tiles and the 96-column tiles (p = 191: two tiles, three pairs; p =
#: 500: six tiles, 21 pairs); n below one 32-row stage, not a multiple of 4,
#: and 1000
F64_P = [1, 7, 8, 9, 90, 95, 96, 97, 191, 500]
F64_N = [13, 1003, 1000]


@pytest.mark.gpu
@pytest.mark.parametrize("p", F64_P)
@pytest.mark.parametrize("n", F64_N)
def test_cuda_gram_f64_edges(cuda_device, n, p):
    """The float64 Gram within 1e-10 * max|K| of the plain float64 Gram at
    the body's edges, in both layouts (the block one equal to the flat
    one)."""
    X, y, *_ = _inputs(n, p)
    Xd, yd = (a.to(cuda_device) for a in cpu(X, y))
    for t in (0.9, 1e6):
        K = tgram.shifted_gram_cuda(Xd, yd, t)
        Kb = tgram.shifted_gram_cuda(Xd, yd, t, flatten=False)
        torch.cuda.synchronize()
        assert K.dtype == torch.float64 and K.shape == (2 * p, 2 * p)
        _assert_scaled(K, tref.flatten_gram(tref.gram_blocks_ref(Xd, yd, t)), 1e-10)
        np.testing.assert_array_equal(npy(tref.flatten_gram(Kb)), npy(K))


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(1000, 90), (1003, 191), (13, 500)])
def test_cuda_gram_f64_repeats_exactly(cuda_device, n, p):
    """Three more launches give bitwise-equal K: every entry is summed in a
    fixed order, with no float atomics."""
    X, y, *_ = _inputs(n, p)
    Xd, yd = (a.to(cuda_device) for a in cpu(X, y))
    K = tgram.shifted_gram_cuda(Xd, yd, 0.9)
    for _ in range(3):
        assert torch.equal(tgram.shifted_gram_cuda(Xd, yd, 0.9), K)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(1003, 90), (13, 97)])
@pytest.mark.parametrize("flatten", [True, False])
def test_cuda_gram_f64_op_equals_wrapper(cuda_device, n, p, flatten):
    """`ops.shifted_gram` on float64 CUDA operands runs the float64 body:
    one launch, K equal to the wrapper's."""
    X, y, *_ = _inputs(n, p)
    Xd, yd = (a.to(cuda_device) for a in cpu(X, y))
    want = tgram.shifted_gram_cuda(Xd, yd, 0.9, flatten=flatten)
    before = tgram.shifted_gram_cuda.launches
    got = tops.shifted_gram(Xd, yd, 0.9, flatten=flatten)
    assert tgram.shifted_gram_cuda.launches == before + 1
    assert got.dtype == torch.float64
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_cuda_gram_tc_mma_layout(cuda_device, precision):
    """The tf32 and bf16 bodies' fragment layouts, on the card, before
    anything built on them: one step of rows (8 for tf32, 16 for bf16)
    through the kernel's own loads, tensor-core products and stores, for a
    diagonal pair of 96-column tiles and both halves of an off-diagonal one,
    gives S^T S (of the TF32-rounded or bfloat16 entries) at every entry i
    <= j of the first 96 rows, and nothing elsewhere. The products are exact
    in float32, so only the tensor cores' float32 sums of 8 or 16 terms
    differ."""
    rows = 8 if precision == "tf32" else 16
    S = torch.tensor(np.random.default_rng(6).standard_normal((rows, 192)),
                     dtype=torch.float32, device=cuda_device)
    S = tops._storage(S, precision)
    D = npy(tgram.tc_mma_probe(S))
    Sr = S.float() if precision == "bf16" else tref.round_tf32(S)
    Sn = npy(Sr).astype(np.float64)
    want = np.triu(Sn.T @ Sn)
    want[96:] = 0.0
    np.testing.assert_allclose(D, want, rtol=0, atol=1e-6 * np.abs(want).max())


#: the f32, tf32 and bf16 bodies' edges: p + 1 across the 8-column groups
#: (f32: the 8 x 8 register tiles), the 48-column warp tiles and the
#: 96-column tiles (p <= 95: one tile, rows staged flat; p = 96, 97, 191,
#: 500: per-row words, odd p for bf16's 2-byte alignment); n below one
#: stage, odd, and 1000
TC_P = [1, 7, 8, 9, 15, 16, 17, 33, 57, 90, 95, 96, 97, 191, 500]
TC_N = [13, 1003, 1000]
#: the float32 modes that share the staging of tc::gram_partial
TC_MODES = ["f32", "tf32", "bf16"]


def _gram_operands(dev, n, p, precision, offset=0):
    """X and y in the precision's storage on `dev`; with `offset`, each is a
    contiguous view `offset` elements into a larger buffer."""
    X, y, *_ = _inputs(n, p)
    Xs, ys = (tops._storage(a.to(dev), precision) for a in _f32(X, y))
    if offset:
        bx = torch.zeros(n * p + offset, dtype=Xs.dtype, device=dev)
        by = torch.zeros(n + offset, dtype=ys.dtype, device=dev)
        bx[offset:] = Xs.reshape(-1)
        by[offset:] = ys
        Xs, ys = bx[offset:].view(n, p), by[offset:]
        assert Xs.is_contiguous() and Xs.storage_offset() == offset
    return Xs, ys


@pytest.mark.gpu
@pytest.mark.parametrize("p", TC_P)
@pytest.mark.parametrize("n", TC_N)
@pytest.mark.parametrize("precision", TC_MODES)
def test_cuda_gram_tc_edges(cuda_device, precision, n, p):
    """The f32, tf32 and bf16 Gram within their bounds of the plain version
    at the body's edges, at t = 0.9 and at t = 1e6 (where K = +-X^T X, held
    at its own scale), in both layouts (the block one equal to the flat
    one)."""
    Xs, ys = _gram_operands(cuda_device, n, p, precision)
    for t in (0.9, 1e6):
        K = tgram.shifted_gram_cuda(Xs, ys, t, precision=precision)
        Kb = tgram.shifted_gram_cuda(Xs, ys, t, precision=precision, flatten=False)
        torch.cuda.synchronize()
        assert K.dtype == torch.float32 and K.shape == (2 * p, 2 * p)
        Kr = tref.flatten_gram(tref.gram_blocks_ref(Xs, ys, t, precision))
        _assert_scaled(K, Kr, GRAM_TOL[precision])
        np.testing.assert_array_equal(npy(tref.flatten_gram(Kb)), npy(K))


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,offset", [(200_000, 90, 0), (200_000, 95, 3),
                                        (200_000, 97, 1)])
@pytest.mark.parametrize("precision", TC_MODES)
def test_cuda_gram_tc_pipeline(cuda_device, precision, n, p, offset):
    """Many stages per split: at n = 200,000 each of the splits of the one
    tile (p = 90, 95: rows staged flat by the bulk copy) holds 12 bf16, 16
    f32 or 24 tf32 stages, and each of the 44 splits of p = 97's three tile
    pairs (per-row words) 36, 72 or 96, so every stage buffer (and f32's two
    repacked ones) is reused several times. K within the bound of the plain
    version at t = 0.9 and 1e6, the same K for the same values at offset 0,
    and three more launches give bitwise-equal K."""
    Xs, ys = _gram_operands(cuda_device, n, p, precision, offset=offset)
    for t in (0.9, 1e6):
        K = tgram.shifted_gram_cuda(Xs, ys, t, precision=precision)
        Kr = tref.flatten_gram(tref.gram_blocks_ref(Xs, ys, t, precision))
        _assert_scaled(K, Kr, GRAM_TOL[precision])
    if offset:
        want = tgram.shifted_gram_cuda(*_gram_operands(cuda_device, n, p, precision), t,
                                       precision=precision)
        assert torch.equal(K, want)
    for _ in range(3):
        assert torch.equal(tgram.shifted_gram_cuda(Xs, ys, t, precision=precision), K)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(1003, 90), (1000, 95), (1003, 97), (130, 191)])
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("precision", TC_MODES)
def test_cuda_gram_tc_storage_offset(cuda_device, precision, offset, n, p):
    """A contiguous X and y that start 1 or 3 elements into their storage
    (not 16-byte aligned; 2 bytes off a 4-byte word in bf16) give the same
    K as the same values at offset 0."""
    want = tgram.shifted_gram_cuda(*_gram_operands(cuda_device, n, p, precision), 0.9,
                                   precision=precision)
    Xs, ys = _gram_operands(cuda_device, n, p, precision, offset=offset)
    assert torch.equal(tgram.shifted_gram_cuda(Xs, ys, 0.9, precision=precision), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(1000, 90), (1003, 191), (13, 500)])
@pytest.mark.parametrize("precision", TC_MODES)
def test_cuda_gram_tc_repeats_exactly(cuda_device, precision, n, p):
    """Three more launches give bitwise-equal K: every entry is summed in a
    fixed order, with no float atomics."""
    Xs, ys = _gram_operands(cuda_device, n, p, precision)
    K = tgram.shifted_gram_cuda(Xs, ys, 0.9, precision=precision)
    for _ in range(3):
        assert torch.equal(tgram.shifted_gram_cuda(Xs, ys, 0.9, precision=precision), K)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(1003, 90), (13, 97)])
@pytest.mark.parametrize("precision", TC_MODES)
def test_cuda_gram_tc_op_equals_wrapper(cuda_device, precision, n, p):
    """`ops.shifted_gram` on float32 CUDA operands at "f32", "tf32" or
    "bf16" runs that mode's body: one launch, K equal to the wrapper's on
    the operands in the precision's storage."""
    X, y, *_ = _inputs(n, p)
    Xf, yf = (a.to(cuda_device) for a in _f32(X, y))
    want = tgram.shifted_gram_cuda(tops._storage(Xf, precision), tops._storage(yf, precision),
                                   0.9, precision=precision)
    before = tgram.shifted_gram_cuda.launches
    got = tops.shifted_gram(Xf, yf, 0.9, precision=precision)
    assert tgram.shifted_gram_cuda.launches == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


#: the widths the dual caches K at (2p <= kernel_cache_max_m = 8192): many
#: 96-column tiles (11, 22 and 43; up to 946 tile pairs, one split each)
WIDE_P = [1000, 2049, 4096]


@pytest.mark.gpu
@pytest.mark.parametrize("p", WIDE_P)
@pytest.mark.parametrize("precision", TC_MODES + ["f64"])
def test_cuda_gram_widths(cuda_device, precision, p):
    """Every body at the widths the dual caches K at, n = 300 (several
    stages, the last one part full): K within its bound of the plain version
    (f64: float64 operands at "f32", 1e-10) at t = 0.9 and 1e6, in both
    layouts."""
    if precision == "f64":
        X, y, *_ = _inputs(300, p)
        Xs, ys = (a.to(cuda_device) for a in cpu(X, y))
        mode, tol = "f32", 1e-10
    else:
        Xs, ys = _gram_operands(cuda_device, 300, p, precision)
        mode, tol = precision, GRAM_TOL[precision]
    for t in (0.9, 1e6):
        K = tgram.shifted_gram_cuda(Xs, ys, t, precision=mode)
        Kb = tgram.shifted_gram_cuda(Xs, ys, t, precision=mode, flatten=False)
        torch.cuda.synchronize()
        assert K.shape == (2 * p, 2 * p)
        _assert_scaled(K, tref.flatten_gram(tref.gram_blocks_ref(Xs, ys, t, mode)), tol)
        assert torch.equal(tref.flatten_gram(Kb), K)
        del K, Kb


#: pass 2's layouts: odd p >= 1024 in several 4,096-column chunks (the
#: GLA-BRA-180 shape among them), p >= 1024 in one chunk, and p < 1024 (one
#: warp per row); n not a multiple of the row group (4, or 8 below 1024);
#: and the primal's depth (2p > n) at n = 1,000 and 4,097, in each layout
XD_SHAPES = [(37, 4099), (180, 49_151), (37, 1500), (33, 57), (57, 33), (7, 513),
             (1000, 4099), (4097, 2049), (1000, 513)]
#: and a single row, and fewer columns than a warp
HINGE_SHAPES = XD_SHAPES + [(1, 4099), (1, 20), (9, 31)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", XD_SHAPES)
@pytest.mark.parametrize("precision,tol", DTYPES)
def test_cuda_hinge_xd_matches_plain(cuda_device, n, p, precision, tol):
    X, y, v, at, ab = (a.to(cuda_device) for a in _f32(*_inputs(n, p)))
    Xs = tops._storage(X, precision)
    dr, er = tref.hinge_xtv_ref(Xs, y, v, 1.1, at, ab)
    before = thinge.hinge_xd_cuda.launches
    hv = thinge.hinge_xd_cuda(Xs, y, dr, er.reshape(1), v, 1.1, 2.5)
    torch.cuda.synchronize()
    assert thinge.hinge_xd_cuda.launches == before + 1
    _assert_scaled(hv, tref.hinge_xd_ref(Xs, y, dr, er, v, 1.1, 2.5), tol, floor=1.0)
    # both passes, as the solver calls them
    d, e_part = thinge.hinge_xtv_cuda(Xs, y, v, 1.1, at, ab)
    _assert_scaled(thinge.hinge_xd_cuda(Xs, y, d, e_part, v, 1.1, 2.5),
                   tref.hessian_matvec_ref(Xs, y, 1.1, 2.5, at, ab, v), tol, floor=1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", HINGE_SHAPES)
@pytest.mark.parametrize("precision,tol", DTYPES + [F64])
def test_cuda_hinge_xtv_matches_plain(cuda_device, n, p, precision, tol):
    """Pass 1 alone: d and e against the plain version, in its summing
    dtype (float64 for float64 operands). e is a difference of sums, so it
    is held at the scale of its terms."""
    X, y, v, at, ab = _hinge_operands(cuda_device, n, p, precision)
    before = thinge.hinge_xtv_cuda.launches
    d, e_part = thinge.hinge_xtv_cuda(X, y, v, 1.1, at, ab)
    torch.cuda.synchronize()
    assert thinge.hinge_xtv_cuda.launches == before + 1
    assert d.dtype == e_part.dtype == y.dtype and d.shape == (p,)
    dr, er = tref.hinge_xtv_ref(X, y, v, 1.1, at, ab)
    _assert_scaled(d, dr, tol, floor=1.0)
    c, byv = tref._acc(X).T @ v, (y @ v) / 1.1
    terms = float((at * (c - byv)).abs().sum() + (ab * (c + byv)).abs().sum())
    assert abs(float(e_part.sum()) - float(er)) <= tol * max(1.0, terms)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", HINGE_SHAPES)
def test_cuda_hinge_f64_matches_plain(cuda_device, n, p):
    """Float64 operands run both passes' float64 bodies: pass 2 alone from
    the plain (d, e), and both passes as the solver calls them, within
    1e-10 * max(1, |H v|) of the plain float64 product."""
    X, y, v, at, ab = _hinge_operands(cuda_device, n, p, "f64")
    dr, er = tref.hinge_xtv_ref(X, y, v, 1.1, at, ab)
    hv = thinge.hinge_xd_cuda(X, y, dr, er.reshape(1), v, 1.1, 2.5)
    torch.cuda.synchronize()
    assert hv.dtype == torch.float64
    _assert_scaled(hv, tref.hinge_xd_ref(X, y, dr, er, v, 1.1, 2.5), 1e-10, floor=1.0)
    want = tref.hessian_matvec_ref(X, y, 1.1, 2.5, at, ab, v)
    _assert_scaled(tops.hinge_hessian_matvec(X, y, 1.1, 2.5, at, ab, v), want, 1e-10,
                   floor=1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(37, 4099), (180, 49_151), (9, 31)])
@pytest.mark.parametrize("precision", ["f32", "bf16", "f64"])
def test_cuda_hinge_repeats_exactly_in_every_mode(cuda_device, n, p, precision):
    """Three more launches of each pass give bitwise-equal d, e partials
    and H v: a fixed summation order in every mode."""
    X, y, v, at, ab = _hinge_operands(cuda_device, n, p, precision)
    d, e_part = thinge.hinge_xtv_cuda(X, y, v, 1.1, at, ab)
    hv = thinge.hinge_xd_cuda(X, y, d, e_part, v, 1.1, 2.5)
    for _ in range(3):
        d2, e2 = thinge.hinge_xtv_cuda(X, y, v, 1.1, at, ab)
        assert torch.equal(d2, d) and torch.equal(e2, e_part)
        assert torch.equal(thinge.hinge_xd_cuda(X, y, d2, e2, v, 1.1, 2.5), hv)


@pytest.mark.gpu
def test_cuda_hinge_rejects_mixed_float64_and_float32(cuda_device):
    """Float64 X takes float64 operands only, float32 or bfloat16 X float32
    ones only: nothing is cast."""
    X, y, v, at, ab = _hinge_operands(cuda_device, 33, 57, "f64")
    d, e_part = thinge.hinge_xtv_cuda(X, y, v, 1.1, at, ab)
    for i in range(5):   # each float64 operand of pass 1 in float32
        args = [X, y, v, at, ab]
        args[i] = args[i].float()
        with pytest.raises(TypeError):
            thinge.hinge_xtv_cuda(*args[:3], 1.1, *args[3:])
    for i in range(5):   # each operand of pass 2
        args = [X, y, d, e_part, v]
        args[i] = args[i].float()
        with pytest.raises(TypeError):
            thinge.hinge_xd_cuda(*args, 1.1, 2.5)
    for Xs in (X.float(), X.to(torch.bfloat16)):
        with pytest.raises(TypeError):
            thinge.hinge_xtv_cuda(Xs, y, v, 1.1, at, ab)
        with pytest.raises(TypeError):
            thinge.hinge_xd_cuda(Xs, y, d, e_part, v, 1.1, 2.5)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(37, 4099), (180, 49_151)])
def test_cuda_hinge_xd_repeats_exactly(cuda_device, n, p):
    """Launches in a row give equal H v (a fixed summation order, no float
    atomics) and leave the ticket counters at 0, so the next launch finds
    its last block again."""
    X, y, v, at, ab = (a.to(cuda_device) for a in _f32(*_inputs(n, p)))
    d, e_part = thinge.hinge_xtv_cuda(X, y, v, 1.1, at, ab)
    first = thinge.hinge_xd_cuda(X, y, d, e_part, v, 1.1, 2.5)
    for _ in range(3):
        assert torch.equal(thinge.hinge_xd_cuda(X, y, d, e_part, v, 1.1, 2.5), first)
    torch.cuda.synchronize()
    tickets = [b for (dev, _), b in thinge._TICKETS.items() if dev == X.device]
    assert tickets and all(int(b.abs().sum()) == 0 for b in tickets)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", SHAPES + [(180, 2000)])
@pytest.mark.parametrize("precision,tol", DTYPES)
def test_cuda_hinge_matches_plain(cuda_device, n, p, precision, tol):
    X, y, v, at, ab = (a.to(cuda_device) for a in _f32(*_inputs(n, p)))
    Xs = tops._storage(X, precision)
    d, e_part = thinge.hinge_xtv_cuda(Xs, y, v, 1.1, at, ab)
    hv = thinge.hinge_xd_cuda(Xs, y, d, e_part, v, 1.1, 2.5)
    torch.cuda.synchronize()
    dr, er = tref.hinge_xtv_ref(Xs, y, v, 1.1, at, ab)
    _assert_scaled(d, dr, tol, floor=1.0)
    _assert_scaled(hv, tref.hessian_matvec_ref(Xs, y, 1.1, 2.5, at, ab, v), tol,
                   floor=1.0)
    # pass 2 alone, from the plain (d, e)
    hv1 = thinge.hinge_xd_cuda(Xs, y, dr, er.reshape(1), v, 1.1, 2.5)
    _assert_scaled(hv1, tref.hinge_xd_ref(Xs, y, dr, er, v, 1.1, 2.5), tol, floor=1.0)


def _lane_operands(dev, B, n, p, precision, shared, offset):
    """(X, y, v, act_top, act_bot, t, C) of B lanes on `dev`, as the batched
    primal hands them to the lane-batched passes: X (n, p) and y (n,) when
    `shared`, else (B, n, p) and (B, n), X's data `offset` elements into its
    buffer; v (B, n), act (B, p); t and C (B,) float64. Float64 for "f64",
    else float32 with X in the precision's storage."""
    rng = np.random.default_rng(B * 1000 + n)
    dtype = torch.float64 if precision == "f64" else torch.float32
    lead = () if shared else (B,)
    Xd = rng.standard_normal(lead + (n, p)) / np.sqrt(n)
    buf = torch.empty(offset + Xd.size, device=dev,
                      dtype=torch.bfloat16 if precision == "bf16" else dtype)
    X = buf[offset:].view(Xd.shape)
    X.copy_(torch.tensor(Xd, dtype=dtype))

    def tensor(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    return (X, tensor(rng.standard_normal(lead + (n,))), tensor(rng.standard_normal((B, n))),
            tensor(rng.random((B, p)) > 0.4), tensor(rng.random((B, p)) > 0.6),
            torch.tensor(rng.uniform(0.5, 3.0, B), dtype=torch.float64, device=dev),
            torch.tensor(rng.uniform(0.1, 10.0, B), dtype=torch.float64, device=dev))


def _lane(x, i, shared):
    return x if shared else x[i]


#: (n, p) of the lane tests: every shape of the single passes' tests
LANE_SHAPES = HINGE_SHAPES
#: lane counts of the lane tests: G1 and G2 are the largest lane groups of
#: the shared-X route's pass 1 and pass 2 in the test's mode
LANE_COUNTS = ["1", "2", "5", "9", "G1", "G1+1", "G2", "G2+1", "17", "33"]
_PREC_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}


def _lane_count(label, precision):
    """The B of a LANE_COUNTS label in `precision`'s mode."""
    mode = thinge._MODES[_PREC_DTYPE[precision]]
    g1, g2 = (max(thinge._SHARED_G[k][mode]) for k in ("xtv", "xd"))
    return {"G1": g1, "G1+1": g1 + 1, "G2": g2, "G2+1": g2 + 1}.get(label) or int(label)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", LANE_SHAPES)
@pytest.mark.parametrize("B", LANE_COUNTS)
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("precision", ["f32", "bf16", "f64"])
def test_cuda_hinge_lanes_bitwise_single_launches(cuda_device, precision, shared, B, n, p):
    """Each lane of the lane-batched passes is bitwise a single launch on
    that lane's operands (the same addresses: the stacks' rows), with X and
    y shared (the shared-X route from two lanes on, in one or more lane
    groups) or stacked (the stacked route) and X at a storage offset; one
    lane-batched launch counts one launch."""
    B = _lane_count(B, precision)
    X, y, v, at, ab, t, C = _lane_operands(cuda_device, B, n, p, precision, shared,
                                           offset=3)
    before = (thinge.hinge_xtv_lanes_cuda.launches, thinge.hinge_xd_lanes_cuda.launches)
    d, e_part = thinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab)
    hv = thinge.hinge_xd_lanes_cuda(X, y, d, e_part, v, t, C)
    torch.cuda.synchronize()
    assert (thinge.hinge_xtv_lanes_cuda.launches,
            thinge.hinge_xd_lanes_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert d.shape == (B, p) and hv.shape == (B, n) and e_part.shape[0] == B
    for i in range(B):
        Xi, yi = _lane(X, i, shared), _lane(y, i, shared)
        di, ei = thinge.hinge_xtv_cuda(Xi, yi, v[i], float(t[i]), at[i], ab[i])
        assert torch.equal(d[i], di) and torch.equal(e_part[i], ei)
        assert torch.equal(hv[i], thinge.hinge_xd_cuda(Xi, yi, di, ei, v[i], float(t[i]),
                                                       float(C[i])))
    # and the plain lane-batched op, at the single passes' bounds
    tol = {"f32": 1e-5, "bf16": 2e-2, "f64": 1e-10}[precision]
    want = tref.hinge_xd_lanes_ref(X, y, *tref.hinge_xtv_lanes_ref(X, y, v, t, at, ab),
                                   v, t, C)
    _assert_scaled(hv, want, tol, floor=1.0)
    # three more launches of each give the same bits
    for _ in range(3):
        d2, e2 = thinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab)
        assert torch.equal(d2, d) and torch.equal(e2, e_part)
        assert torch.equal(thinge.hinge_xd_lanes_cuda(X, y, d2, e2, v, t, C), hv)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [9, 16])
@pytest.mark.parametrize("precision", ["f32", "bf16", "f64"])
def test_cuda_hinge_shared_route_repeats_at_glabra(cuda_device, precision, B):
    """The shared-X route at the GLA-BRA-180 shape (180 x 49,151, the
    batched primal's): three launches of each pass give the same bits, each
    lane is bitwise a single launch, and every ticket is 0 afterwards."""
    X, y, v, at, ab, t, C = _lane_operands(cuda_device, B, 180, 49_151, precision, True,
                                           offset=0)
    assert thinge.plan(B, 180, 49_151, X.dtype, True).route == "shared"
    d, e_part = thinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab)
    hv = thinge.hinge_xd_lanes_cuda(X, y, d, e_part, v, t, C)
    for _ in range(3):
        d2, e2 = thinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab)
        assert torch.equal(d2, d) and torch.equal(e2, e_part)
        assert torch.equal(thinge.hinge_xd_lanes_cuda(X, y, d2, e2, v, t, C), hv)
    torch.cuda.synchronize()
    assert all(int(b.abs().sum()) == 0 for b in thinge._TICKETS.values())
    for i in (0, B - 1):
        di, ei = thinge.hinge_xtv_cuda(X, y, v[i], float(t[i]), at[i], ab[i])
        assert torch.equal(d[i], di) and torch.equal(e_part[i], ei)
        assert torch.equal(hv[i], thinge.hinge_xd_cuda(X, y, di, ei, v[i], float(t[i]),
                                                       float(C[i])))


@pytest.mark.gpu
def test_cuda_hinge_shared_groups_match_library(cuda_device):
    """The lane-group sizes the plan picks from are the ones the library
    builds, and the library refuses any other G, a stacked X and one lane
    on the shared-X route."""
    lib = thinge._lib()
    for k, pass_ in (("xtv", 0), ("xd", 1)):
        for mode in (0, 1, 2):
            built = tuple(lib.sven_hinge_shared_group(pass_, mode, i) for i in (0, 1))
            assert built == thinge._SHARED_G[k][mode]
    X, y, v, at, ab, t, _ = _lane_operands(cuda_device, 3, 33, 57, "f64", True, 0)
    d = torch.empty_like(at)
    e_part = torch.empty((3, lib.sven_hinge_xtv_blocks(57)), dtype=torch.float64,
                         device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream

    def launch(x_stride, lanes, group):
        return lib.sven_hinge_xtv_lanes(X.data_ptr(), 2, x_stride, v.data_ptr(),
                                        y.data_ptr(), 0, at.data_ptr(), ab.data_ptr(),
                                        d.data_ptr(), e_part.data_ptr(), 33, 57, lanes,
                                        t.data_ptr(), group, stream)

    G = thinge._SHARED_G["xtv"][2][0]
    assert launch(0, 3, G) == 0
    for x_stride, lanes, group in ((0, 3, G + 1), (0, 3, 64), (33 * 57, 3, G), (0, 1, G)):
        assert launch(x_stride, lanes, group) != 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [True, False])
def test_cuda_hinge_lanes_op_equals_wrapper(cuda_device, shared):
    """`ops.hinge_hessian_matvec_lanes` on CUDA tensors is the two lane
    launches; its "ref" body on the same tensors lies within 1e-10."""
    X, y, v, at, ab, t, C = _lane_operands(cuda_device, 4, 180, 4099, "f64", shared, 0)
    hv = tops.hinge_hessian_matvec_lanes(X, y, t, C, at, ab, v)
    d, e_part = thinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab)
    assert torch.equal(hv, thinge.hinge_xd_lanes_cuda(X, y, d, e_part, v, t, C))
    _assert_scaled(hv, tops.hinge_hessian_matvec_lanes(X, y, t, C, at, ab, v,
                                                       backend="ref"), 1e-10, floor=1.0)


@pytest.mark.gpu
def test_cuda_hinge_lanes_reject_bad_operands(cuda_device):
    """Float64 X takes float64 lane operands only (nothing is cast), every
    operand lies on X's device, and the stacks agree on B."""
    X, y, v, at, ab, t, C = _lane_operands(cuda_device, 3, 33, 57, "f64", False, 0)
    d, e_part = thinge.hinge_xtv_lanes_cuda(X, y, v, t, at, ab)
    for i in range(5):   # each float64 operand of pass 1 in float32
        args = [X, y, v, at, ab]
        args[i] = args[i].float()
        with pytest.raises(TypeError):
            thinge.hinge_xtv_lanes_cuda(*args[:3], t, *args[3:])
    for i in range(5):   # each operand of pass 2
        args = [X, y, d, e_part, v]
        args[i] = args[i].float()
        with pytest.raises(TypeError):
            thinge.hinge_xd_lanes_cuda(*args, t, C)
    with pytest.raises(ValueError, match="is on cpu"):
        thinge.hinge_xtv_lanes_cuda(X, y.cpu(), v, t, at, ab)
    with pytest.raises(ValueError, match="is on cpu"):
        thinge.hinge_xd_lanes_cuda(X, y, d, e_part, v, t.cpu(), C)
    with pytest.raises(ValueError, match="lanes"):
        thinge.hinge_xtv_lanes_cuda(X[:2], y, v, t, at, ab)
    with pytest.raises(ValueError, match="shape"):
        thinge.hinge_xtv_lanes_cuda(X, y, v, t, at[:2], ab)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        thinge.hinge_xd_lanes_cuda(X, y, d, e_part, v, t[:2], C)
    with pytest.raises(ValueError, match="CUDA"):
        thinge.hinge_xtv_lanes_cuda(X.cpu(), y, v, t, at, ab)


def _stats_operands(dev, n, p, precision, offset=0):
    """(X, y, w) on `dev`: float32 y, w and X in the precision's storage,
    whose data start `offset` elements past the start of their buffer."""
    X, y, *_ = _inputs(n, p)
    w = np.random.default_rng(3).standard_normal(n) * 0.1
    Xf, yf, wf = (a.to(dev) for a in _f32(X, y, w))
    Xs = tops._storage(Xf, precision)
    if offset:
        buf = torch.empty(n * p + offset, dtype=Xs.dtype, device=dev)
        buf[offset:] = Xs.reshape(-1)
        Xs = buf[offset:].view(n, p)
        assert Xs.is_contiguous() and Xs.data_ptr() % 16 == offset * Xs.element_size()
    return Xs, yf, wf


def _assert_stats_match_plain(Xs, yf, wf, got):
    """Bounds: margin and galpha 1e-5 * S with S = max_j sum_i |X_ij w_i|
    (f32 rounding in any summation order), act equal outside that band
    around 1, loss to rtol 1e-5."""
    mt, mb, gt, gb, lp = got
    margin, act, loss, galpha = tref.hinge_stats_ref(Xs, yf, 1.3, wf, 2.0)
    S = float((Xs.float().abs().T @ wf.abs()).max())
    np.testing.assert_allclose(npy(torch.cat([mt, mb])), npy(margin), rtol=0,
                               atol=1e-5 * S)
    np.testing.assert_allclose(npy(torch.cat([gt, gb])), npy(galpha), rtol=0,
                               atol=1e-5 * S)
    clear = (margin - 1.0).abs() > 1e-5 * S
    assert torch.equal((torch.cat([mt, mb]) < 1.0)[clear], (act > 0)[clear])
    np.testing.assert_allclose(float(0.5 * (wf @ wf) + lp.sum()), float(loss), rtol=1e-5)
    return loss


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", SHAPES + [(180, 2000), (5000, 90), (20_000, 33)])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_hinge_stats_matches_plain(cuda_device, n, p, precision):
    """Both routes of the kernel against the plain version: the wide route
    (the SHAPES and 180 x 2000) and the tall route (5000 x 90 and 20,000 x
    33: ragged last block and stage)."""
    Xs, yf, wf = _stats_operands(cuda_device, n, p, precision)
    before = ths.hinge_stats_cuda.launches
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (ths.plan(n, p, sms) is not None) == (n >= 5000)
    got = ths.hinge_stats_cuda(Xs, yf, 1.3, wf, 2.0)
    torch.cuda.synchronize()
    assert ths.hinge_stats_cuda.launches == before + 1
    loss = _assert_stats_match_plain(Xs, yf, wf, got)
    # the public op on CUDA tensors runs the kernel
    Xf = Xs.float() if precision == "bf16" else Xs
    op = tops.hinge_stats(Xf, yf, 1.3, wf, 2.0, precision=precision)
    assert ths.hinge_stats_cuda.launches == before + 2
    np.testing.assert_allclose(float(op[2]), float(loss), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,offset,route", [
    (200_000, 90, 0, "tall"), (200_000, 95, 0, "tall"),  # many stages, ragged last
    (200_000, 90, 1, "tall"), (200_000, 95, 3, "tall"),  # X 1 and 3 elements past a line
    (20_000, 512, 0, "tall"), (20_000, 513, 1, "tall"),  # one column a thread, then slots
    (20_000, 2048, 3, "tall"), (20_000, 2049, 0, "wide"),  # the tall route's widest p
    (200_000, 1, 1, "tall"), (200_000, 7, 3, "tall"),
    (180, 49_151, 1, "wide"), (180, 2000, 3, "wide"), (33, 57, 1, "wide")])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_hinge_stats_tall_route(cuda_device, n, p, offset, route, precision):
    """The tall route, and the wide route past its widest p or at small n,
    against the plain version at the bounds above, X at a storage offset
    too; three launches bitwise equal, which also shows that each leaves the
    tall route's ticket at zero for the next."""
    Xs, yf, wf = _stats_operands(cuda_device, n, p, precision, offset)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tall = ths.plan(n, p, sms)
    assert (tall is not None) == (route == "tall")
    if tall is not None:
        assert tall[0] <= sms and tall[0] * tall[1] >= n
    runs = [ths.hinge_stats_cuda(Xs, yf, 1.3, wf, 2.0) for _ in range(3)]
    torch.cuda.synchronize()
    if tall is not None:
        assert int(ths._ticket(Xs.device)[0]) == 0
    _assert_stats_match_plain(Xs, yf, wf, runs[0])
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_operands(cuda_device):
    X, y, v, at, ab = (a.to(cuda_device) for a in _f32(*_inputs(33, 57)))
    # float64 operands run only at "f32" (the float64 body): nothing is cast
    for precision in ("tf32", "bf16"):
        with pytest.raises(TypeError):
            tgram.shifted_gram_cuda(X.double(), y.double(), 0.9, precision=precision)
    with pytest.raises(TypeError):
        tgram.shifted_gram_cuda(X.double(), y, 0.9)             # y must match X
    with pytest.raises(TypeError):
        tgram.shifted_gram_cuda(X, y, 0.9, precision="bf16")   # needs bf16 storage
    with pytest.raises(ValueError, match="contiguous"):
        thinge.hinge_xtv_cuda(X.t().contiguous().t(), y, v, 1.1, at, ab)
    with pytest.raises(ValueError, match="shape"):
        thinge.hinge_xd_cuda(X, y, at[:10], at[:2], v, 1.1, 2.5)
    with pytest.raises(ValueError, match="is on cpu"):
        thinge.hinge_xtv_cuda(X, y.cpu(), v, 1.1, at, ab)
    with pytest.raises(TypeError):
        ths.hinge_stats_cuda(X, y, 1.1, v.double(), 2.5)
    with pytest.raises(ValueError, match="shape"):
        ths.hinge_stats_cuda(X, y, 1.1, v[:5], 2.5)
