"""Port parity of the kernel ops: the plain PyTorch versions of
`repro_torch.kernels` against the JAX package's Pallas kernels run in
interpret mode (`backend="tpu_interpret"`) or its `ref` oracle, at the
reference's bounds (tests/test_kernels.py): float32 1e-5 * scale, bfloat16
storage 2e-2 * scale. Shapes include ragged edges.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_gpu.py.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu, npy, problem
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import hinge as thinge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the module: `repro_torch.kernels` re-exports the op under the same name
ths = importlib.import_module("repro_torch.kernels.hinge_stats")

SHAPES = [(33, 57), (96, 130), (57, 33), (48, 256)]
DTYPES = [("f32", 1e-5), ("bf16", 2e-2)]
TILES = dict(bm=32, bn=32, bk=32)


def _inputs(n, p, seed=0):
    X, y = problem(n, p, seed=seed)
    rng = np.random.default_rng(seed + 1)
    v = rng.standard_normal(n)
    at = (rng.random(p) > 0.4).astype(np.float64)
    ab = (rng.random(p) > 0.6).astype(np.float64)
    return X, y, v, at, ab


def _f32(*arrays):
    return cpu(*arrays, dtype=torch.float32)


def _assert_scaled(a, b, tol, floor=0.0):
    a, b = npy(a), npy(b)
    scale = max(floor, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("precision,tol", DTYPES)
def test_shifted_gram_matches_jax_interpret(n, p, precision, tol):
    X, y, *_ = _inputs(n, p)
    t = 0.9
    K = tops.shifted_gram(*_f32(X, y), t, precision=precision)   # CPU -> plain
    Kj = jops.shifted_gram(jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32),
                           t, backend="tpu_interpret", precision=precision, **TILES)
    assert K.shape == (2 * p, 2 * p) and K.dtype == torch.float32
    _assert_scaled(K, Kj, tol)
    Kb = tops.shifted_gram(*_f32(X, y), t, precision=precision, flatten=False)
    np.testing.assert_array_equal(npy(tref.flatten_gram(Kb)), npy(K))


def _reference_hinge_inputs(n, p):
    """v and the masks exactly as tests/test_kernels.py::test_hinge_matvec_sweep
    draws them (jax.random keys 0, 1, 2), as numpy arrays for both packages."""
    import jax
    X, y = problem(n, p)
    v = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32))
    at = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (p,)) > 0.4, np.float64)
    ab = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (p,)) > 0.6, np.float64)
    return X, y, v, at, ab


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("precision,tol", DTYPES)
def test_hinge_hessian_matvec_matches_jax_interpret(n, p, precision, tol):
    """On the reference test's own inputs. (On the numpy inputs of `_inputs`
    at (48, 256) the JAX f32 interpret kernel is 1.2e-5 * scale from the
    float64 value: e is a difference of sums ~250x larger than itself. The
    next test holds the port to the float64 value there.)"""
    X, y, v, at, ab = _reference_hinge_inputs(n, p)
    hv = tops.hinge_hessian_matvec(*_f32(X, y), 1.1, 2.5, *_f32(at, ab, v),
                                   precision=precision)
    hvj = jops.hinge_hessian_matvec(
        *(jnp.asarray(a, jnp.float32) for a in (X, y)), 1.1, 2.5,
        *(jnp.asarray(a, jnp.float32) for a in (at, ab, v)),
        bp=32, bn=32, bk=32, backend="tpu_interpret", precision=precision)
    assert hv.shape == (n,) and hv.dtype == torch.float32
    _assert_scaled(hv, hvj, tol, floor=1.0)


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("precision,tol", DTYPES)
def test_hinge_hessian_matvec_matches_float64_oracle(n, p, precision, tol):
    """The plain f32 H v against the JAX oracle evaluated in float64 on the
    same (storage-rounded) numpy inputs."""
    X, y, v, at, ab = _inputs(n, p)
    Xs = tops._storage(_f32(X), precision)
    hv = tops.hinge_hessian_matvec(*_f32(X, y), 1.1, 2.5, *_f32(at, ab, v),
                                   precision=precision)
    exact = [jnp.asarray(npy(a)) for a in (Xs, *_f32(y, at, ab, v))]
    hv64 = jref.hessian_matvec_ref(exact[0], exact[1], 1.1, 2.5, *exact[2:])
    _assert_scaled(hv, hv64, tol, floor=1.0)


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("precision,tol", DTYPES)
def test_hinge_passes_match_jax_oracle(n, p, precision, tol):
    """Pass 1 and pass 2 one at a time, in f32 on the storage-rounded X,
    against the JAX oracle evaluated in float64 on the same values."""
    X, y, v, at, ab = _inputs(n, p)
    Xs = tops._storage(_f32(X), precision)
    yf, vf, atf, abf = _f32(y, v, at, ab)
    Xj, yj, vj, atj, abj = (jnp.asarray(npy(a)) for a in (Xs, yf, vf, atf, abf))
    d, e = tref.hinge_xtv_ref(Xs, yf, vf, 1.1, atf, abf)
    dj, ej = jref.hinge_xtv_ref(Xj, yj, vj, 1.1, atj, abj)
    _assert_scaled(d, dj, tol, floor=1.0)
    _assert_scaled(e, ej, tol, floor=1.0)
    # pass 2 from the same f32 (d, e) on both sides
    d32, e32 = _f32(npy(dj), npy(ej))
    hv = tref.hinge_xd_ref(Xs, yf, d32, e32, vf, 1.1, 2.5)
    hvj = jref.hinge_xd_ref(Xj, yj, jnp.asarray(npy(d32)), jnp.asarray(npy(e32)),
                            vj, 1.1, 2.5)
    _assert_scaled(hv, hvj, tol, floor=1.0)


@pytest.mark.parametrize("n,p", [(57, 33), (30, 80)])
def test_hinge_stats_oracle_matches_jax(n, p):
    """The plain hinge-stats function against JAX's oracle, float64."""
    X, y = problem(n, p, seed=4)
    w = np.random.default_rng(5).standard_normal(n) * 0.1
    got = tref.hinge_stats_ref(*cpu(X, y), 0.8, cpu(w), 3.0)
    want = jref.hinge_stats_ref(jnp.asarray(X), jnp.asarray(y), 0.8, jnp.asarray(w), 3.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(npy(a), npy(b), rtol=0, atol=1e-12)


HSTAT_SHAPES = [(64, 64), (130, 150), (57, 33), (200, 40)]


@pytest.mark.parametrize("n,p", HSTAT_SHAPES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_hinge_stats_op_matches_jax_interpret(n, p, precision):
    """The op's plain body ("ref", the CPU default) against the JAX op at its
    CPU default (the Pallas kernel in interpret mode), on float32 inputs, at
    the bounds of tests/test_kernels.py::test_hinge_stats_sweep: margin and
    galpha 3e-6 * scale, act exactly, loss to rtol 1e-5."""
    X, y = problem(n, p, seed=3)
    w = np.random.default_rng(7).standard_normal(n) * 0.1
    Xf, yf, wf = _f32(X, y, w)
    got = tops.hinge_stats(Xf, yf, 1.3, wf, 2.0, precision=precision)
    want = jops.hinge_stats(*(jnp.asarray(npy(a), jnp.float32) for a in (Xf, yf)), 1.3,
                            jnp.asarray(npy(wf), jnp.float32), 2.0, bp=32, bk=32,
                            precision=precision)
    margin, act, loss, galpha = got
    assert margin.shape == act.shape == galpha.shape == (2 * p,)
    assert loss.shape == () and all(o.dtype == torch.float32 for o in got)
    scale = max(1.0, float(np.abs(npy(want[0])).max()))
    np.testing.assert_allclose(npy(margin), npy(want[0]), rtol=0, atol=3e-6 * scale)
    np.testing.assert_array_equal(npy(act), npy(want[1]))
    np.testing.assert_allclose(float(loss), float(want[2]), rtol=1e-5)
    np.testing.assert_allclose(npy(galpha), npy(want[3]), rtol=0, atol=3e-6 * scale)


def test_hinge_stats_op_returns_w_dtype_and_the_primal_objective():
    """float64 w and X: outputs come back in float64 (computed in float32, as
    the kernel does), and loss is the primal objective 0.5 w.w + C sum xi^2
    of the port's Newton solver at that w."""
    from repro_torch.core.reduction import SvenOperator
    from repro_torch.core.svm.primal_newton import _primal_obj
    X, y = cpu(*problem(40, 90, seed=6))
    w = cpu(np.random.default_rng(8).standard_normal(40) * 0.05)
    margin, act, loss, galpha = tops.hinge_stats(X, y, 0.7, w, 1.5)
    assert all(o.dtype == torch.float64 for o in (margin, act, loss, galpha))
    op = SvenOperator(X=X, y=y, t=0.7)
    yhat = torch.cat([X.new_ones(90), -X.new_ones(90)])
    obj = _primal_obj(op.xhat_matvec, yhat, w, 1.5)
    np.testing.assert_allclose(float(loss), float(obj), rtol=1e-5)
    np.testing.assert_allclose(npy(margin), npy(yhat * op.xhat_matvec(w)), rtol=0,
                               atol=1e-5 * max(1.0, float(margin.abs().max())))


@pytest.mark.parametrize("n,p,tall", [
    (463_715, 90, True), (180, 49_151, False), (180, 2000, False), (33, 57, False),
    (5000, 90, True), (20_000, 33, True), (200_000, 1, True), (100_000, 1000, True),
    (200_000, 2048, True), (200_000, 2049, False), (300, 7, True), (256, 7, False)])
def test_hinge_stats_row_split(n, p, tall):
    """The route: tall when p <= TALL_MAX_P and its row ranges give more
    blocks than the wide route's 32-column blocks. The tall route's row
    ranges cover n, every block has a row, and they are one wave: at most
    one block per SM, none under MIN_ROWS rows unless n forces it."""
    sms = 132
    got = ths.plan(n, p, sms)
    assert (got is not None) == tall
    if got is None:
        return
    blocks, rows = got
    assert 1 < blocks <= sms and blocks > -(-p // ths.WIDE_COLS)
    assert blocks * rows >= n > (blocks - 1) * rows
    assert blocks <= -(-n // ths.MIN_ROWS)
    assert ths.plan(n, p, 1) is None     # one SM: the wide route's blocks are as many


def test_tf32_rounding_is_round_to_nearest_away():
    x = torch.tensor([1.0, 1.0 + 2**-11, -(1.0 + 2**-11), 1.0 + 2**-12,
                      1.0 + 3 * 2**-12, 0.0, -2.5], dtype=torch.float32)
    want = [1.0, 1.0 + 2**-10, -(1.0 + 2**-10), 1.0, 1.0 + 2**-10, 0.0, -2.5]
    assert tref.round_tf32(x).tolist() == want


@pytest.mark.parametrize("n,p", [(33, 57), (96, 130)])
def test_tf32_gram_is_the_gram_of_rounded_operands(n, p):
    """tf32 mode = f32 sums of TF32-rounded X and y: within TF32's 2^-11
    relative rounding of the f32 Gram, and exactly the f32 Gram of the
    rounded operands (the products of 11-bit mantissas are exact)."""
    X, y, *_ = _inputs(n, p)
    Xf, yf = _f32(X, y)
    K32 = tops.shifted_gram(Xf, yf, 0.9)
    Ktf = tops.shifted_gram(Xf, yf, 0.9, precision="tf32")
    Krd = tops.shifted_gram(tref.round_tf32(Xf), tref.round_tf32(yf), 0.9)
    np.testing.assert_array_equal(npy(Ktf), npy(Krd))
    _assert_scaled(Ktf, K32, 2e-3)
    assert not torch.equal(Ktf, K32)


def test_wrappers_raise_on_cpu_tensors_instead_of_falling_back():
    X, y, v, at, ab = _f32(*_inputs(33, 57))
    with pytest.raises(ValueError, match="CUDA"):
        tgram.shifted_gram_cuda(X, y, 0.9)
    with pytest.raises(ValueError, match="CUDA"):
        thinge.hinge_xtv_cuda(X, y, v, 1.1, at, ab)
    with pytest.raises(ValueError, match="CUDA"):
        thinge.hinge_xd_cuda(X, y, at, at[:2], v, 1.1, 2.5)
    with pytest.raises(ValueError, match="CUDA"):
        ths.hinge_stats_cuda(X, y, 1.1, v, 2.5)
    # an explicit "cuda" body on CPU operands raises too: no silent plain run
    with pytest.raises(ValueError, match="CUDA"):
        tops.shifted_gram(X, y, 0.9, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.hinge_hessian_matvec(X, y, 1.1, 2.5, at, ab, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.hinge_stats(X, y, 1.1, v, 2.5, backend="cuda")
    with pytest.raises(ValueError, match="precision"):
        tops.shifted_gram(X, y, 0.9, precision="fp8")
    # tf32 rounds float32 only, in the plain version as in the kernel
    with pytest.raises(TypeError, match="float32"):
        tops.shifted_gram(X.double(), y.double(), 0.9, precision="tf32")


def test_plain_ops_launch_no_kernel():
    from repro_torch import kernels
    kernels.reset_launches()
    X, y, v, at, ab = _f32(*_inputs(33, 57))
    tops.shifted_gram(X, y, 0.9)
    tops.hinge_hessian_matvec(X, y, 1.1, 2.5, at, ab, v)
    tops.hinge_stats(X, y, 1.1, v, 2.5)
    lanes = torch.tensor([1.1, 1.3])
    tops.hinge_hessian_matvec_lanes(X, y, lanes, 2 * lanes, torch.stack([at, at]),
                                    torch.stack([ab, ab]), torch.stack([v, -v]))
    assert kernels.launches() == {"shifted_gram_cuda": 0, "hinge_xtv_cuda": 0,
                                  "hinge_xd_cuda": 0, "hinge_stats_cuda": 0,
                                  "hinge_xtv_lanes_cuda": 0, "hinge_xd_lanes_cuda": 0}


@pytest.mark.parametrize("n,p,sms", [(463715, 90, 132), (33, 57, 132), (10, 4096, 132),
                                     (7, 3, 1)])
def test_gram_f64_row_split_covers_all_rows(n, p, sms):
    """The float64 body's split: 96-column tile pairs, 32-row stages, one
    block per SM. Every row in exactly one split, whole stages, one wave
    (tile pairs x splits <= SMs, or one split when the pairs alone
    outnumber the SMs)."""
    rows, nsplit = tgram.split_rows_wave(n, p, sms, 96, 32)
    pairs = tgram._pairs(p, 96)
    assert rows % 32 == 0 and rows * nsplit >= n and rows * (nsplit - 1) < n
    assert pairs * nsplit <= sms or nsplit == 1
    assert 1 <= nsplit <= 65535
    if (n, p, sms) == (463715, 90, 132):   # the YMSD shape: one pair, 132 splits
        assert (pairs, nsplit, rows) == (1, 132, 3520)


@pytest.mark.parametrize("n,p,sms", [(463715, 90, 132), (33, 57, 132), (10, 4096, 132),
                                     (7, 3, 1)])
@pytest.mark.parametrize("step", [64, 96, 128])
def test_gram_tc_row_split_covers_all_rows(n, p, sms, step):
    """The tf32 (64-row stages), f32 (96-row stages; 48 on the wide route)
    and bf16 (128-row stages) bodies' split: 96-column tile pairs, one block
    per SM. Every row in exactly one split, whole stages, one wave (tile
    pairs x splits <= SMs, or one split when the pairs alone outnumber the
    SMs)."""
    rows, nsplit = tgram.split_rows_wave(n, p, sms, 96, step)
    pairs = tgram._pairs(p, 96)
    assert rows % step == 0 and rows * nsplit >= n and rows * (nsplit - 1) < n
    assert pairs * nsplit <= sms or nsplit == 1
    assert 1 <= nsplit <= 65535
    if (n, p, sms) == (463715, 90, 132):   # the YMSD shape: one pair
        assert (pairs, nsplit, rows) == {64: (1, 132, 3520), 96: (1, 131, 3552),
                                         128: (1, 130, 3584)}[step]


#: the lane counts the shared-X route's plan is held at, in each mode and
#: pass: G is the largest lane group the library builds for it
LANE_EDGES = ["1", "2", "G-1", "G", "G+1", "17", "33"]


def _stacked_cover(pl, B, n, p):
    """The (lane, strip) items of pass 1's blocks and the (lane, chunk, row)
    items of pass 2's on the stacked route, as `csrc/hinge.cu` cuts its
    grids: pass 1 a block per strip and lane (grid z); pass 2 a block per
    (lane, row block) and chunk, the lane the fastest index."""
    nstrip = -(-p // 128)
    xtv = [(lane, j) for lane in range(B) for j in range(nstrip)]
    chunks = -(-p // 4096) if p >= 1024 else 1
    lanes = thinge.lane_groups(B, pl.xd_group)
    xd = [(lane, c, r) for x in range(len(lanes) * -(-n // pl.xd_rows))
          for c in range(chunks) for lane in lanes[x % len(lanes)]
          for r in range((x // len(lanes)) * pl.xd_rows,
                         min(n, (x // len(lanes) + 1) * pl.xd_rows))]
    return xtv, nstrip, xd, chunks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("pass_", ["xtv", "xd"])
@pytest.mark.parametrize("edge", LANE_EDGES)
def test_lane_plan_covers_every_lane_once(dtype, pass_, edge):
    """`hinge.plan`: a stacked X, or one lane, takes the stacked route, whose
    grids take every (lane, strip of 128 columns) of pass 1 and every (lane,
    chunk, row) of pass 2 exactly once, a block of pass 2 on one lane and
    whole steps of R rows (R = 4 rows from p = 1,024, 8 below). A shared X
    with two or more lanes takes the shared-X route, which cuts the lanes
    into as few groups as the largest built G allows, each lane in exactly
    one group, each group of at most the chosen G (a built size) and sizes
    that differ by at most one, pass 2 taking whole passes of 4 R rows."""
    sizes = thinge._SHARED_G[pass_][thinge._MODES[dtype]]
    G = max(sizes)
    B = {"G-1": G - 1, "G": G, "G+1": G + 1}.get(edge) or int(edge)
    R_of = {True: 4, False: 8}
    for n, p in [(180, 49_151), (33, 57), (1000, 4099), (7, 513)]:
        R = R_of[p >= 1024]
        stacked = thinge.plan(B, n, p, dtype, shared=False)
        assert (stacked.route, stacked.xtv_group, stacked.xd_group) == ("stacked", 0, 1)
        assert stacked.xd_rows > 0 and stacked.xd_rows % R == 0
        xtv, nstrip, xd, chunks = _stacked_cover(stacked, B, n, p)
        if pass_ == "xtv":
            assert sorted(xtv) == [(i, j) for i in range(B) for j in range(nstrip)]
        else:
            assert sorted(xd) == [(i, c, r) for i in range(B) for c in range(chunks)
                                  for r in range(n)]
        pl = thinge.plan(B, n, p, dtype, shared=True)
        if B == 1:
            assert pl == stacked
            continue
        assert pl.route == "shared"
        g = pl.xtv_group if pass_ == "xtv" else pl.xd_group
        assert g in sizes
        groups = thinge.lane_groups(B, g)
        assert [i for r in groups for i in r] == list(range(B))
        assert len(groups) == -(-B // G)
        lens = [len(r) for r in groups]
        assert max(lens) <= g and max(lens) - min(lens) <= 1 and min(lens) >= 1
        assert pl.xd_rows > 0 and pl.xd_rows % (4 * R) == 0
    with pytest.raises(TypeError, match="dtype"):
        thinge.plan(B, 33, 57, torch.float16, shared=True)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n,p,B,dtype,sms", [
    (180, 49_151, 9, torch.float64, 132), (180, 49_151, 16, torch.float64, 132),
    (144, 49_151, 5, torch.float32, 132), (1000, 4099, 33, torch.bfloat16, 132),
    (37, 513, 3, torch.float64, 114), (4097, 2049, 17, torch.float32, 78),
    (144, 49_151, 5, torch.float64, 132), (33, 57, 9, torch.float32, 132)])
def test_lane_plan_rows_fill_the_waves(n, p, B, dtype, sms, shared):
    """Pass 2's rows per block on either route: whole steps (4 R rows on
    the shared route, R on the stacked one), and no other choice fills the
    grid's waves of blocks (one an SM on the shared route; on the stacked
    one three in float64, six in float32 and bf16) better, or as well with
    fewer blocks."""
    pl = thinge.plan(B, n, p, dtype, shared=shared, sms=sms)
    R = 4 if p >= 1024 else 8
    step = 4 * R if shared else R
    per_sm = 1 if shared else (3 if dtype == torch.float64 else 6)
    chunks = -(-p // 4096) if p >= 1024 else 1
    groups = len(thinge.lane_groups(B, pl.xd_group))

    def score(rows):
        blocks = groups * chunks * -(-n // rows)
        slots = per_sm * sms
        return round(blocks / (-(-blocks // slots) * slots), 6), -blocks

    assert pl.xd_rows % step == 0 and step <= pl.xd_rows <= -(-n // step) * step
    assert all(score(pl.xd_rows) >= score(k * step) for k in range(1, -(-n // step) + 1))
