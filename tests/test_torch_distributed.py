"""The port's multi-device layer on the CPU: `repro_torch.dist` (the mesh
and the rank launcher), `repro_torch.core.distributed` (the row-sharded
solves), the lane and fold fan-out of `core.batch`, `core.api.enet_batch`
and `core.cv`, and `kernels.ops.sharded_shifted_gram`.

- A mesh of one rank issues no collective and reproduces every
  single-device function bitwise; it lies within 1e-10 of JAX's functions on
  a one-device mesh.
- 2 and 4 gloo ranks (`dist.launch`: spawned processes, a `file://`
  rendezvous, one launch a rank count for the whole module, its results
  handed to parametrized cases): `sven_sharded` (dual with padded rows, and
  primal) and every route pin of `sven_routed` within 1e-10 of the port's
  `sven` (JAX's `TOL`); the Gram forms within 1e-12 x max|K| of
  `reduction.gram_blocks` / `gram_reference`; `sharded_hinge_stats` within
  1e-12 x the scale of each output of `hinge_stats_ref`; the lane fan-out
  of `sven_batch` / `enet_batch` and the fold fan-out of `cross_validate`
  bitwise their one-device runs (the gather adds zeros).
- 2 ranks against JAX at 2 forced host devices (one subprocess): the
  results both compute, within 1e-10.
- A rank that fails, or a collective that never completes, ends the launch
  with an error; no test can hang.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_ranks as R
from _subprocess import scrubbed_env
from repro_torch import dist
from repro_torch.core import distributed as tdist
from repro_torch.core import reduction as red
from repro_torch.core import routing
from repro_torch.core.sven import SvenConfig, sven
from repro_torch.kernels import ops
from repro_torch.kernels.ref import hinge_stats_ref

TOL = 1e-10
WORLDS = (2, 4)


_JAX_2DEV = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, "tests")
    import jax, jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    import _torch_ranks as R
    from repro import dist
    from repro.core import cross_validate, sven_batch, sven_sharded
    from repro.core.api import enet_batch
    from repro.core.distributed import shard_rows, sharded_hinge_stats
    from repro.core.routing import sven_routed

    mesh = dist.data_mesh()
    assert mesh.size == 2
    out = {}
    for name, (n, p, seed, t, l2) in (("dual", R.DUAL), ("primal", R.PRIMAL)):
        X, y = map(jnp.asarray, R.problem(n, p, seed))
        out["sharded_" + name] = sven_sharded(X, y, t, l2, mesh=mesh).beta.tolist()
        out["routed_" + name] = sven_routed(X, y, t, l2, mesh=mesh,
                                            route="sharded").beta.tolist()
    Xb, yb, tb, l2b, l1b = map(jnp.asarray, R.batch_problem())
    with dist.mesh_context(mesh):
        out["sven_batch"] = sven_batch(Xb, yb, tb, l2b, route="batch").beta.tolist()
        out["enet_batch"] = enet_batch(Xb, yb, l1b, l2b, route="batch").beta.tolist()
    n, p, seed, k, L = R.CV
    Xc, yc = map(jnp.asarray, R.problem(n, p, seed))
    out["cv"] = cross_validate(Xc, yc, k=k, n_lambdas=L, mesh=mesh).mse_path.tolist()
    X, y = map(jnp.asarray, R.problem(*R.DUAL[:3]))
    Xs, ys = shard_rows(mesh, X, y)
    w = jnp.asarray(R.hinge_w(Xs.shape[0]))
    out["hinge_stats"] = [np.asarray(o).reshape(-1).tolist()
                          for o in sharded_hinge_stats(mesh, Xs, ys, R.DUAL[3], w, 2.0)]
    print("RESULT=" + json.dumps(out))
""")


def _ranks_env(tmp_path_factory):
    """A private disk cache for the ranks (they inherit the environment)."""
    cache = tmp_path_factory.mktemp("rank-cache")
    old = os.environ.get("REPRO_CACHE_DIR")
    os.environ["REPRO_CACHE_DIR"] = str(cache)
    return old


def _restore(old):
    if old is None:
        os.environ.pop("REPRO_CACHE_DIR", None)
    else:
        os.environ["REPRO_CACHE_DIR"] = old


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """({W: rank 0's results of `_torch_ranks.solves` on W gloo ranks}, JAX's
    results at 2 forced host devices); JAX's subprocess runs meanwhile."""
    jax_run = subprocess.Popen([sys.executable, "-c", _JAX_2DEV], env=scrubbed_env(2),
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    old = _ranks_env(tmp_path_factory)
    try:
        got = {W: dist.launch(R.solves, W, device="cpu", threads=1, timeout=240,
                              collective_timeout=120) for W in WORLDS}
    finally:
        _restore(old)
        try:
            out, err = jax_run.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            jax_run.kill()
            out, err = jax_run.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT=")]
    assert lines, f"JAX at 2 host devices failed:\n{out}\n{err}"
    return got, json.loads(lines[-1][len("RESULT="):])


@pytest.fixture(scope="module")
def ranks(launched):
    return launched[0]


@pytest.fixture(scope="module")
def jax_two(launched):
    return launched[1]


def _dev(a, b) -> float:
    return float((a - b).abs().max())


# -- a mesh of one rank -------------------------------------------------------

def _one_rank_pairs():
    """(name, the one-rank call, its single-device function's result)."""
    m1 = dist.data_mesh(1)
    X, y = map(R._t, R.problem(*R.DUAL[:3]))
    Xp, yp = map(R._t, R.problem(*R.PRIMAL[:3]))
    w = R._t(R.hinge_w(X.shape[0]))
    pairs = []
    for cfg in (SvenConfig(), SvenConfig(backend="torch")):
        for name, (A, b, t, l2) in (("dual", (X, y, 1.5, 1.0)), ("primal", (Xp, yp, 0.8, 0.7))):
            pairs.append((f"sven_sharded_{name}_{cfg.backend}",
                          lambda A=A, b=b, t=t, l2=l2, cfg=cfg:
                          tdist.sven_sharded(A, b, t, l2, cfg, mesh=m1).beta,
                          lambda A=A, b=b, t=t, l2=l2, cfg=cfg: sven(A, b, t, l2, cfg).beta))
    for route in ("auto", "single", "sharded"):
        pairs.append((f"sven_routed_{route}",
                      lambda route=route: routing.sven_routed(X, y, 1.5, 1.0, mesh=m1,
                                                              route=route).beta,
                      lambda: sven(X, y, 1.5, 1.0).beta))
    blocks = lambda: red.gram_blocks(X, y, 1.5)    # noqa: E731
    pairs += [
        ("sharded_gram_stats", lambda: tdist.sharded_gram_stats(m1, X, y, 1.5), blocks),
        ("distributed_gram", lambda: tdist.distributed_gram(m1, X, y, 1.5), blocks),
        ("distributed_gram_rs", lambda: tdist.distributed_gram_rs(m1, X, y, 1.5), blocks),
        ("distributed_gram_rs_syrk", lambda: tdist.distributed_gram_rs_syrk(m1, X, y, 1.5),
         blocks),
        ("distributed_gram_paper", lambda: tdist.distributed_gram_paper(m1, X, y, 1.5),
         lambda: red.gram_reference(X, y, 1.5)),
        ("sharded_shifted_gram", lambda: ops.sharded_shifted_gram(m1, X, y, 1.5),
         lambda: ops.shifted_gram(X, y, 1.5)),
        ("sharded_hinge_stats", lambda: torch.cat([o.reshape(-1) for o in
                                                   tdist.sharded_hinge_stats(m1, X, y, 1.5,
                                                                             w, 2.0)]),
         lambda: torch.cat([o.reshape(-1) for o in hinge_stats_ref(X, y, 1.5, w, 2.0)])),
    ]
    return pairs


ONE_RANK = _one_rank_pairs()


@pytest.mark.parametrize("name,fn,ref", ONE_RANK, ids=[p[0] for p in ONE_RANK])
def test_one_rank_mesh_is_the_single_device_function(name, fn, ref):
    """No collective at all, and the single-device function's bits."""
    dist.all_reduce.calls = 0
    got = fn()
    assert dist.all_reduce.calls == 0
    assert torch.equal(got, ref()), name


def test_one_rank_mesh_matches_jax_on_one_device():
    """The one-rank forms against JAX's on a one-device mesh, within 1e-10
    (relative to each result's scale)."""
    import jax.numpy as jnp
    from repro import dist as jdist
    from repro.core import distributed as jd
    from repro.core import routing as jr

    jm = jdist.data_mesh(1)
    m1 = dist.data_mesh(1)
    Xn, yn = R.problem(*R.DUAL[:3])
    Xpn, ypn = R.problem(*R.PRIMAL[:3])
    X, y, Xp, yp = map(R._t, (Xn, yn, Xpn, ypn))
    wn = R.hinge_w(Xn.shape[0])
    pairs = [
        (tdist.sven_sharded(X, y, 1.5, 1.0, mesh=m1).beta,
         jd.sven_sharded(jnp.asarray(Xn), jnp.asarray(yn), 1.5, 1.0, mesh=jm).beta),
        (tdist.sven_sharded(Xp, yp, 0.8, 0.7, mesh=m1).beta,
         jd.sven_sharded(jnp.asarray(Xpn), jnp.asarray(ypn), 0.8, 0.7, mesh=jm).beta),
        (routing.sven_routed(X, y, 1.5, 1.0, mesh=m1, route="sharded").beta,
         jr.sven_routed(jnp.asarray(Xn), jnp.asarray(yn), 1.5, 1.0, mesh=jm,
                        route="sharded").beta),
        (tdist.sharded_gram_stats(m1, X, y, 1.5),
         jd.sharded_gram_stats(jm, jnp.asarray(Xn), jnp.asarray(yn), 1.5)),
        (tdist.distributed_gram(m1, X, y, 1.5),
         jd.distributed_gram(jm, jnp.asarray(Xn), jnp.asarray(yn), 1.5)),
        (tdist.distributed_gram_rs(m1, X, y, 1.5),
         jd.distributed_gram_rs(jm, jnp.asarray(Xn), jnp.asarray(yn), 1.5)),
        (tdist.distributed_gram_rs_syrk(m1, X, y, 1.5),
         jd.distributed_gram_rs_syrk(jm, jnp.asarray(Xn), jnp.asarray(yn), 1.5)),
        (tdist.distributed_gram_paper(m1, X, y, 1.5),
         jd.distributed_gram_paper(jm, jnp.asarray(Xn), jnp.asarray(yn), 1.5)),
    ]
    pairs += list(zip(tdist.sharded_hinge_stats(m1, X, y, 1.5, R._t(wn), 2.0),
                      jd.sharded_hinge_stats(jm, jnp.asarray(Xn), jnp.asarray(yn), 1.5,
                                             jnp.asarray(wn), 2.0)))
    for got, want in pairs:
        want = np.asarray(want, dtype=np.float64)
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got.numpy() - want).max()) <= TOL * scale


def test_mesh_context_nests_and_resolves_the_batch_axis():
    m1, m2 = dist.data_mesh(1), dist.Mesh(size=2, rank=1)
    assert dist.current_context() is None
    with dist.mesh_context(m2):
        with dist.mesh_context(m1, rules={"batch": None}) as inner:
            assert inner is m1 and dist.current_context()[1]["batch"] is None
        mesh, rules = dist.current_context()
        assert mesh is m2 and rules == dist.DEFAULT_RULES
        assert dist.resolve_spec(("batch", None), (6, 3), m2, rules) == ("data", None)
        assert dist.resolve_spec(("batch",), (5,), m2, rules) == (None,)
        assert torch.equal(dist.local_block(m2, torch.arange(6)), torch.tensor([3, 4, 5]))
    assert dist.current_context() is None
    assert dist.data_mesh().size == 1 and dist.data_mesh(1).group is None
    with pytest.raises(ValueError, match="n_devices"):
        dist.data_mesh(2)
    assert tdist.interleaved_labels(4, 2).tolist() == [1, 1, -1, -1, 1, 1, -1, -1]
    Xp, yp = tdist.pad_rows(torch.ones(5, 2), torch.ones(5), 4)
    assert Xp.shape == (8, 2) and float(Xp[5:].abs().sum() + yp[5:].abs().sum()) == 0.0


def test_topology_picks_the_backend(monkeypatch):
    """gloo on the CPU and for ranks sharing a card, NCCL with a card a rank."""
    assert dist.topology(4, "cpu") == (["cpu"] * 4, "gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert dist.topology(4, "cuda") == ([f"cuda:{r}" for r in range(4)], "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist.topology(2, "cuda") == (["cuda:0", "cuda:0"], "gloo")


# -- 2 and 4 gloo ranks -------------------------------------------------------

SHARDED = [(W, name, backend) for W in WORLDS for name in ("dual", "primal")
           for backend in ("auto", "torch")]


@pytest.mark.parametrize("W,name,backend", SHARDED)
def test_sven_sharded_matches_sven(ranks, W, name, backend):
    """Rows split over W ranks (padded where W does not divide n): beta
    within 1e-10 of `sven` on one device, the same Newton steps."""
    sh, one, mode = ranks[W][f"sharded_{name}_{backend}"]
    assert ranks[W]["size"] == W and ranks[W]["backend"] == "gloo"
    assert mode == name
    assert _dev(sh["beta"], one["beta"]) <= TOL
    assert sh["iters"] == one["iters"]


ROUTED = [(W, name, route) for W in WORLDS for name in ("dual", "primal")
          for route in ("auto", "single", "sharded")]


@pytest.mark.parametrize("W,name,route", ROUTED)
def test_every_route_pin_matches_sven(ranks, W, name, route):
    got, want = ranks[W][f"routed_{name}_{route}"]
    assert _dev(got, want) <= TOL


GRAMS = [(W, form) for W in WORLDS for form in
         ("distributed_gram", "distributed_gram_full", "distributed_gram_rs",
          "distributed_gram_rs_syrk", "distributed_gram_paper", "sharded_gram_stats")]


@pytest.mark.parametrize("W,form", GRAMS)
def test_gram_forms_match_the_one_device_gram(ranks, W, form):
    """Every rank's K rows, gathered in rank order, against
    `reduction.gram_blocks` (the rs forms: its feature-interleaved rows,
    labelled by `interleaved_labels`; the paper form against
    `gram_reference`), within 1e-12 x max|K|."""
    g = ranks[W]["gram"]
    K = g["gram_reference"] if form == "distributed_gram_paper" else g["gram_blocks"]
    if form.startswith("distributed_gram_rs"):
        p = K.shape[0] // 2
        rows = p // W
        order = [i for r in range(W) for half in (0, p)
                 for i in range(half + r * rows, half + (r + 1) * rows)]
        K = K[order]
        yhat = torch.cat([torch.ones(p), -torch.ones(p)]).to(K)[order]
        assert torch.equal(g["labels"], yhat)
    assert _dev(g[form], K) <= 1e-12 * float(K.abs().max())


@pytest.mark.parametrize("W", WORLDS)
def test_sharded_hinge_stats_matches_the_oracle(ranks, W):
    """One all-reduce of p + 2 floats: margin, act, loss and galpha within
    1e-12 x each output's scale of `hinge_stats_ref` on the padded rows."""
    got, want = ranks[W]["hinge_stats"]
    for g, w in zip(got, want):
        assert _dev(g, w) <= 1e-12 * max(1.0, float(w.abs().max()))
    assert torch.equal(got[1], want[1])     # the active set itself


FANOUT = [(W, case) for W in WORLDS
          for case in ("sven_batch_stacked", "sven_batch_shared", "enet_batch")]


@pytest.mark.parametrize("W,case", FANOUT)
def test_lane_fanout_is_bitwise_the_one_device_stack(ranks, W, case):
    """Each rank solves its block of lanes with no collective; the gathered
    lanes are the one-device stack's, bit for bit, counts included."""
    if case == "enet_batch":
        (fan_p, fan_c), (one_p, one_c) = ranks[W][case]
        for a, b in zip(fan_c, one_c):
            assert torch.equal(a, b)
        for f in ("beta", "t", "nu", "kkt", "keep", "n_kept", "gap"):
            assert torch.equal(getattr(fan_p, f), getattr(one_p, f)), f
        assert (fan_p.evals, fan_p.sven_iters, fan_p.cg_iters) == \
            (one_p.evals, one_p.sven_iters, one_p.cg_iters)
        return
    fan, one, auto = ranks[W][case]
    for f in ("beta", "alpha", "w", "iters", "opt_residual", "kkt", "cg_iters"):
        assert torch.equal(getattr(fan, f), getattr(one, f)), f
    assert fan.mode == one.mode
    if auto is not None:     # the router's own choice gives the same bits
        assert torch.equal(auto.beta, one.beta)


CV_CASES = [(W, case) for W in WORLDS for case in ("cv", "cv_nested")]


@pytest.mark.parametrize("W,case", CV_CASES)
def test_fold_fanout_is_bitwise_one_device(ranks, W, case):
    """k = 4 folds over W ranks against mesh=None: the same surface, bit for
    bit; k = 5 under a W-rank context with mesh="auto" declines the mesh."""
    a, b = ranks[W][case]
    for f in ("mse_path", "mean_mse", "n_kept", "evals", "beta", "intercept", "lambda1s"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.index_min, a.lambda_min) == (b.index_min, b.lambda_min)


# -- 2 ranks against JAX at 2 forced host devices ----------------------------



def _port_two(ranks, key):
    got = ranks[2]
    if key.startswith("sharded_"):
        return got[f"{key}_auto"][0]["beta"]
    if key.startswith("routed_"):
        return got[f"{key}_sharded"][0]
    if key == "sven_batch":
        return got["sven_batch_stacked"][0].beta
    if key == "enet_batch":
        return got["enet_batch"][0][0].beta
    if key == "cv":
        return got["cv"][0].mse_path
    return torch.cat([o.reshape(-1) for o in got["hinge_stats"][0]])


JAX_CASES = ("sharded_dual", "sharded_primal", "routed_dual", "routed_primal",
             "sven_batch", "enet_batch", "cv", "hinge_stats")


@pytest.mark.parametrize("key", JAX_CASES)
def test_two_ranks_match_jax_on_two_devices(ranks, jax_two, key):
    """The port's 2-rank results against JAX's at 2 forced host devices, within
    1e-10 x max(1, scale)."""
    want = jax_two[key]
    if key == "hinge_stats":
        want = [v for part in want for v in part]
    want = np.asarray(want, dtype=np.float64)
    got = _port_two(ranks, key).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * max(1.0, float(np.abs(want).max()))


# -- faults end a launch instead of hanging it --------------------------------

def test_a_failing_rank_ends_the_launch_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        dist.launch(R.fail_on_rank_1, 2, device="cpu", threads=1, timeout=120,
                    collective_timeout=30)


def test_a_collective_that_never_completes_times_out():
    """Rank 1 never joins rank 0's all-reduce: the group's timeout fails
    rank 0, and the launch ends with its error."""
    with pytest.raises(RuntimeError, match="rank 0"):
        dist.launch(R.stall_rank_1, 2, device="cpu", threads=1, timeout=60,
                    collective_timeout=3)


def test_ranks_that_outlive_the_deadline_are_killed():
    with pytest.raises(TimeoutError, match="outlived"):
        dist.launch(R.stall_rank_1, 2, device="cpu", threads=1, timeout=6,
                    collective_timeout=300)
