"""The port's cost-model router (`repro_torch.core.routing`) and the
scheduler's priced launches, on the CPU.

- One rank: nothing to route ("one device: nothing to route"), pins
  validated, the calibration measured once, cached in the process and on
  disk, and never measured by `estimate_batch_seconds` (the admission path).
- 2 and 4 gloo ranks (`dist.launch`, one launch a rank count): the
  calibration is finite, positive and the same on every call; JAX's routing
  property (`tests/test_dist_solve.py::test_routing_decisions_never_price_
  worse_than_single`): no decision prices worse than "single", pins are
  honoured, and a lone (64, 8) solve stays single.
- `ContinuousScheduler` calibrates when it is built and prices every
  launch: on one device by `estimate_batch_seconds` (which reads the disk
  once a process), under an auto mesh by `route_batch`'s price of the path
  it took; a pinned mesh fans the lanes out, and every request's beta is
  the same bits on one device, routed or fanned out. On more than one rank
  it refuses clock-driven launches and speculation, which would launch
  other batches on other ranks.
"""
import math
import os

import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro_torch import dist
from repro_torch.core import batch as tbatch
from repro_torch.core import cv as tcv
from repro_torch.core import routing
from repro_torch.core.sven import SvenConfig, _pick_mode
from repro_torch.obs.metrics import default_registry
from repro_torch.runtime import ContinuousScheduler

WORLDS = (2, 4)
EPS = 1e-12


@pytest.fixture(autouse=True)
def _fresh_router():
    routing.clear_calibration()
    yield
    routing.clear_calibration()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{W: rank 0's `_torch_ranks.routing_cases` on W gloo ranks}."""
    old = os.environ.get("REPRO_CACHE_DIR")
    os.environ["REPRO_CACHE_DIR"] = str(tmp_path_factory.mktemp("rank-cache"))
    try:
        return {W: dist.launch(R.routing_cases, W, device="cpu", threads=1, timeout=240,
                               collective_timeout=120) for W in WORLDS}
    finally:
        if old is None:
            os.environ.pop("REPRO_CACHE_DIR", None)
        else:
            os.environ["REPRO_CACHE_DIR"] = old


def test_route_one_device_trivial_and_validation():
    d = routing.route_solve(100, 24, mesh=dist.data_mesh(1))
    assert d.path == "single" and d.costs == {"single": 0.0}
    assert d.reason == "one device: nothing to route"
    d = routing.route_batch(48, 12, 8, dist.data_mesh(1), form="penalized")
    assert d.path == "single" and d.reason == "one device: nothing to route"
    with pytest.raises(ValueError, match="route must be"):
        routing.route_solve(100, 24, route="fastest")
    with pytest.raises(ValueError, match="route must be"):
        routing.route_batch(100, 24, 8, route="sharded")


def test_one_rank_calibration_is_measured_once_and_persisted(monkeypatch):
    cal = routing.calibrate(dist.data_mesh(1))
    assert cal.devices == 1 and cal.backend == "cpu" and cal.kernel_backend == "ref"
    assert cal.flops_per_s > 0 and cal.gram_flops_per_s == cal.flops_per_s
    assert (cal.psum_latency_s, cal.fanout_speedup, cal.replicated_slowdown) == (0.0, 1.0, 1.0)
    assert routing.calibrate(dist.data_mesh(1)) is cal          # the process cache

    def measured(*a, **k):
        raise AssertionError("measured again")

    monkeypatch.setattr(routing, "_measure", measured)
    routing.clear_calibration()
    assert routing.calibrate(dist.data_mesh(1)) == cal          # the disk cache
    with pytest.raises(AssertionError, match="measured again"):
        routing.calibrate(dist.data_mesh(1), force=True)


def test_estimate_batch_seconds_never_measures(monkeypatch):
    def measured(*a, **k):
        raise AssertionError("the admission path measured")

    monkeypatch.setattr(routing, "_measure", measured)
    small = routing.estimate_batch_seconds(32, 16, 2, device="cpu")
    big = routing.estimate_batch_seconds(256, 128, 8, device="cpu")
    pen = routing.estimate_batch_seconds(32, 16, 2, form="penalized", device="cpu")
    assert 0.0 < small < big and pen == routing.PENALIZED_EVALS * small


def test_estimate_batch_seconds_reads_the_disk_once(monkeypatch):
    reads = []

    def load(platform, ndev):
        reads.append((platform, ndev))
        return None

    monkeypatch.setattr(routing, "_load_disk_calibration", load)
    first = routing.estimate_batch_seconds(32, 16, 2, device="cpu")
    assert routing.estimate_batch_seconds(32, 16, 2, device="cpu") == first
    assert reads == [("cpu", 1)]            # the miss is kept in the process
    cal = routing.calibrate(dist.data_mesh(1))
    mode = _pick_mode(32, 16, SvenConfig())
    assert routing.estimate_batch_seconds(32, 16, 2, device="cpu") == \
        routing._batch_costs(32, 16, 2, mode, cal, 1)["single"]
    assert reads == [("cpu", 1)] * 2        # calibrate's own disk lookup


def test_fresh_decisions_count_on_the_registry():
    counter = default_registry().counter("route_decisions_total", "cost-model routing verdicts",
                                         ("path",))
    before = counter.value(path="single")
    cal = routing._SINGLE_DEVICE._replace(devices=2)
    d = routing._decide(routing._solve_costs(64, 8, "dual", cal), cal, None)
    assert d.path == "single" and d.reason.startswith("cost model: single wins")
    assert counter.value(path="single") == before + 1


def test_batch_mesh_declines_what_it_cannot_split():
    assert tbatch.batch_mesh(8) is None                          # no context
    with dist.mesh_context(dist.data_mesh(1)):
        assert tbatch.batch_mesh(8) is None                      # one rank
    two = dist.Mesh(size=2)
    with dist.mesh_context(two):
        assert tbatch.batch_mesh(3, route="batch") is None       # 2 does not divide 3
        assert tbatch.batch_mesh(4, route="batch") is two
        assert tbatch.batch_mesh(4, route="single") is None
    assert tcv._auto_fold_chunk(8, torch.device("cpu")) == 1
    assert tcv._auto_fold_chunk(8, torch.device("cpu"), dist.data_mesh(1)) == 1
    assert tcv._auto_fold_chunk(8, torch.device("cpu"), two) == 8
    assert tcv._resolve_cv_mesh(two, 5) is None and tcv._resolve_cv_mesh(two, 4) is two


def test_one_device_scheduler_prices_every_launch():
    X, y = R.problem(24, 10, 3)
    assert ("cpu", 1) not in routing._CALIBRATIONS
    s = ContinuousScheduler(max_batch=2, max_wait=None, device="cpu")
    assert s.mesh is None and routing._CALIBRATIONS[("cpu", 1)].backend == "cpu"
    s.submit(X, y, t=1.0, lambda2=1.0)
    s.submit(X, y, lambda1=0.5, lambda2=1.0)
    s.drain()
    recs = s.solve_log.records()
    assert recs and all(r.modeled_s > 0.0 and r.route_path == "single" for r in recs)
    report = s.solve_log.residual_report()
    assert report["n_unmodeled"] == 0 and set(report["by_path"]) == {"single"}


PROPERTY = [(W, shape) for W in WORLDS for shape in R.ROUTE_SHAPES]


@pytest.mark.parametrize("W,shape", PROPERTY)
def test_no_solve_decision_prices_worse_than_single(ranks, W, shape):
    d, single, sharded = ranks[W]["routes"]["solve"][shape]
    assert d.path in d.costs and d.costs[d.path] <= d.costs["single"] + EPS
    assert single.path == "single" and sharded.path == "sharded" and "sharded" in sharded.costs
    if shape == (64, 8):      # a tiny lone solve can never pay for the mesh
        assert d.path == "single"


@pytest.mark.parametrize("W", WORLDS)
def test_batch_decisions_and_the_calibration(ranks, W):
    got = ranks[W]["routes"]
    cal = got["cal"]
    assert cal.devices == W and cal == got["again"]
    for f in routing._NUMERIC:
        v = getattr(cal, f)
        assert math.isfinite(v) and (v > 0 or f in ("psum_per_byte_s",)), (f, v)
    for (n, p, B), (d, pinned) in got["batch"].items():
        assert d.costs[d.path] <= d.costs["single"] + EPS, (n, p, B, d)
        assert pinned.path == "batch"


@pytest.mark.parametrize("W", WORLDS)
def test_routed_and_fanned_scheduler_gives_the_one_device_bits(ranks, W):
    serve = ranks[W]["serve"]
    one, _ = serve["one"]
    for name in ("auto", "pinned"):
        betas, recs = serve[name]
        assert all(np.array_equal(a, b) for a, b in zip(betas, one)), name
        if name == "auto":      # routed: priced by route_batch on the path it took
            assert recs and all(r.modeled_s > 0.0 and r.route_path in ("single", "batch")
                                for r in recs)
        else:                   # pinned: fanned out, unpriced
            assert recs and all(r.route_path == "batch" and r.modeled_s == 0.0 for r in recs)


@pytest.mark.parametrize("W", WORLDS)
def test_ranks_refuse_clock_driven_launches(ranks, W):
    """max_wait, speculation and a request's deadline, under an auto and a
    pinned mesh of W ranks: each refused on every rank, none hanging."""
    got = ranks[W]["serve"]["refused"]
    assert len(got) == 6 and all(m is not None for m in got), got
    for i, m in enumerate(got):
        assert ("takes no deadline" if i % 3 == 2 else "max_wait must be None") in m, m
