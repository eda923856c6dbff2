"""The port's multi-host serving coordinator (`repro_torch.runtime.multihost`)
on the CPU: the twins of JAX's multihost cases (`tests/test_fault_tolerance.py`,
`tests/test_obs.py`) with `device="cpu"`, at JAX's sizes.

- A worker SIGKILLed while it holds dispatched batches loses no admitted
  request: each ends "ok", "deadline_exceeded" or "aborted", never silence.
- The shared spill tier warm-starts the survivors; the fleet's metric merge
  does not count a delivered request twice.
- Every "ok" beta, re-solved or not, lies within 1e-10 of the port's direct
  `sven` and of JAX's `sven` (backend "xla") on the same numpy inputs. A
  worker is another process, and CPU BLAS sums by thread count, so the
  bound is not bitwise.
- A worker busy with one batch never blocks the coordinator's send of the
  next: batches and results wider than a socket's buffer still drain.
- `python -m repro_torch.runtime.loadgen --hosts 2 --kill-host 0` runs on
  `--device cpu`: balanced accounting and warm hits.

Every coordinator a test builds is shut down by the fixture, so no worker
outlives its test.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import npy
from repro.core import sven as j_sven
from repro.core.sven import SvenConfig as JSvenConfig
from repro_torch.core.sven import sven
from repro_torch.obs import default_events
from repro_torch.runtime import loadgen
from repro_torch.runtime.multihost import MultiHostCoordinator

TOL = 1e-10


def _problem(seed=0, n=40, p=20):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, p)), rng.normal(size=n)


@pytest.fixture
def coordinator_factory():
    """Build MultiHostCoordinators on the CPU and reap their workers even
    when the test body fails mid-flight."""
    coords = []

    def make(**kw):
        c = MultiHostCoordinator(device="cpu", **kw)
        coords.append(c)
        return c

    yield make
    for c in coords:
        c.shutdown()


def _kill_mid_drain(make, seed, **kw):
    """8 requests on 2 hosts (two batches of 4), host 0 killed while it
    holds its batch: (coordinator, request ids, drained results, X, y)."""
    X, y = _problem(seed)
    coord = make(n_hosts=2, max_batch=4, **kw)
    ids = [coord.submit(X + 0.01 * k, y, t=1.0) for k in range(8)]
    coord.flush()                      # both hosts now hold in-flight work
    coord.kill_host(0)
    return coord, ids, coord.drain(), X, y


@pytest.mark.slow
def test_kill_host_mid_drain_loses_nothing(coordinator_factory):
    """SIGKILL a worker while it holds dispatched batches; every admitted
    request still completes "ok" (the requeue re-solves the dead host's
    work)."""
    coord, ids, out, _, _ = _kill_mid_drain(coordinator_factory, 0)
    assert sorted(out) == sorted(ids), "silent request drop on host kill"
    assert {r.status for r in out.values()} == {"ok"}
    assert coord.hosts_lost == 1
    assert coord.requeued_batches >= 1, "kill was not detected as a failure"
    for r in out.values():
        assert r.beta is not None and np.all(np.isfinite(np.asarray(r.beta)))
    stats = coord.shutdown()
    assert [s["device"] for s in stats] == ["cpu"]       # the survivor alone
    assert set(stats[0]["kernel_launches"]) >= {"hinge_xtv_cuda", "shifted_gram_cuda"}


@pytest.mark.slow
def test_kill_host_with_deadlines_terminal_statuses(coordinator_factory):
    """With deadlines armed, a killed host's requeued work whose deadline
    already passed terminates as "deadline_exceeded": a terminal status for
    every admitted request, solutions only for "ok"."""
    _, ids, out, _, _ = _kill_mid_drain(coordinator_factory, 1, max_wait=1e-3)
    assert sorted(out) == sorted(ids), "silent request drop on host kill"
    statuses = {rid: out[rid].status for rid in ids}
    assert set(statuses.values()) <= {"ok", "deadline_exceeded"}, statuses
    for rid in ids:
        if out[rid].status == "ok":
            assert np.all(np.isfinite(np.asarray(out[rid].beta)))
        else:
            assert out[rid].beta is None


@pytest.mark.slow
def test_all_hosts_dead_aborts_explicitly(coordinator_factory):
    """When no host survives, pending requests terminate as "aborted" and
    drain returns."""
    X, y = _problem(2)
    coord = coordinator_factory(n_hosts=1, max_batch=4)
    ids = [coord.submit(X, y + 0.1 * k, t=1.0) for k in range(4)]
    coord.kill_host(0)
    out = coord.drain(timeout=60.0)
    assert sorted(out) == sorted(ids)
    assert {r.status for r in out.values()} == {"aborted"}
    assert all(out[rid].beta is None for rid in ids)
    assert coord.accounting()["terminals"] == {"aborted": 4}


@pytest.mark.slow
def test_multihost_shared_spill_survives_host_loss(coordinator_factory, tmp_path):
    """Work a dead host completed before dying warm-starts the survivor
    through the shared persistent spill tier."""
    X, y = _problem(3)
    coord = coordinator_factory(n_hosts=2, max_batch=4, cache_dir=str(tmp_path / "spill"))
    first = [coord.submit(X, y, t=0.8 + 0.05 * k) for k in range(8)]
    out = coord.drain()
    assert {out[r].status for r in first} == {"ok"}
    coord.kill_host(0)                 # the half that solved some of wave 1
    again = [coord.submit(X, y, t=0.8 + 0.05 * k) for k in range(8)]
    out = coord.drain()
    assert sorted(out) == sorted(again)
    assert {out[r].status for r in again} == {"ok"}
    stats = coord.shutdown()
    # only the survivor reports; repeat traffic must have warm-started
    assert sum(s["cache_hits"] for s in stats) > 0


@pytest.mark.slow
def test_multihost_metric_merge_survives_kill(coordinator_factory):
    """The coordinator's books stay balanced, the fleet merge shows the
    delivered requests without counting one twice, and the host death shows
    in the coordinator's counters and the event ring."""
    deaths0 = default_events().counts().get("host_death", 0)
    coord, ids, out, _, _ = _kill_mid_drain(coordinator_factory, 3)
    assert sorted(out) == sorted(ids)
    assert {r.status for r in out.values()} == {"ok"}
    acct = coord.accounting()
    assert acct["admitted"] == 8
    assert acct["terminals"] == {"ok": 8}
    assert acct["balanced"] and acct["outstanding"] == 0
    fleet_reqs = int(coord.fleet.counter("runtime_requests_total", labelnames=()).total())
    assert fleet_reqs >= 8
    assert coord.requeued_batches >= 1
    assert coord.hosts_lost == 1
    assert int(coord.registry.counter("hosts_lost_total").total()) == 1
    snap = coord.metrics_snapshot()
    assert set(snap) == {"coordinator", "fleet", "hosts"}
    assert default_events().counts().get("host_death", 0) == deaths0 + 1


@pytest.mark.slow
def test_results_match_direct_solves_of_both_packages(coordinator_factory):
    """Every "ok" beta of a killed-host drain (cold: each request its own
    data set) within 1e-10 x max|beta| of the port's direct `sven` and of
    JAX's `sven` (backend "xla") on the same numpy inputs."""
    _, ids, out, X, y = _kill_mid_drain(coordinator_factory, 4)
    assert {out[rid].status for rid in ids} == {"ok"}
    for k, rid in enumerate(ids):
        Xk = X + 0.01 * k
        got = np.asarray(out[rid].beta)
        port = npy(sven(torch.tensor(Xk), torch.tensor(y), 1.0, 1.0).beta)
        ref = npy(j_sven(jnp.asarray(Xk), jnp.asarray(y), 1.0, 1.0,
                         JSvenConfig(backend="xla")).beta)
        for want in (port, ref):
            scale = max(float(np.abs(want).max()), 1e-300)
            assert float(np.abs(got - want).max()) <= TOL * scale


def test_warm_results_equal_sven_from_the_entry_their_worker_used(coordinator_factory,
                                                                  tmp_path):
    """A warm wave with host 0 killed mid-drain: each "ok" result names the
    point of the warm-start entry its worker started from (or None, cold)
    and carries that entry back; `sven` on the padded problem
    warm-started from it lies within 1e-10 of the result (JAX's
    `run_multihost` bound), and the cold direct `sven` within 1e-6."""
    X, y = _problem(6, n=30, p=40)
    ts = [0.6 + 0.05 * k for k in range(8)]
    coord = coordinator_factory(n_hosts=2, max_batch=4, cache_dir=str(tmp_path / "spill"))
    cold = [coord.submit(X, y, t=t) for t in ts]
    out = coord.drain()
    assert all(out[r].warm_from is None or out[r].warm_start is not None for r in cold)
    ids = [coord.submit(X, y, t=t + 0.01) for t in ts]
    coord.flush()
    coord.kill_host(0)
    out = coord.drain()
    assert {out[r].status for r in ids} == {"ok"}
    warm = 0
    for t, rid in zip(ts, ids):
        r = out[rid]
        (bn, bp), (n, p) = r.bucket, X.shape
        Xp, yp = np.zeros((bn, bp)), np.zeros(bn)
        Xp[:n, :p], yp[:n] = X, y
        kw = {}
        if r.warm_from is not None:
            warm += 1
            alpha, w = r.warm_start
            kw = {"warm_alpha": torch.tensor(alpha), "warm_w": torch.tensor(w)}
        again = npy(sven(torch.tensor(Xp), torch.tensor(yp), t + 0.01, 1.0, **kw).beta)[:p]
        assert float(np.abs(r.beta - again).max()) <= TOL
        direct = npy(sven(torch.tensor(X), torch.tensor(y), t + 0.01, 1.0).beta)
        assert float(np.abs(r.beta - direct).max()) <= 1e-6
    assert warm > 0


@pytest.mark.slow
def test_wide_batches_and_results_do_not_block_the_pipe(coordinator_factory):
    """Two batches of two 24 x 32,768 requests (a 12.6 MB message each) on
    one host, both in flight: the worker is still solving the first when
    the second is sent, and its result (two betas, 512 KB) outgrows the
    socket's buffer. A worker that read its pipe only between solves would
    leave both sides blocked on their sends; the drain runs on a thread
    here so that such a hang fails the test instead of stalling it."""
    rng = np.random.default_rng(5)
    X, y = rng.normal(size=(24, 32768)), rng.normal(size=24)
    coord = coordinator_factory(n_hosts=1, max_batch=2, max_inflight_per_host=2)
    out = {}

    def serve():
        ids = [coord.submit(X + 0.01 * k, y, t=0.5) for k in range(4)]
        out.update(coord.drain(timeout=120.0))
        out["ids"] = ids

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    th.join(timeout=150.0)
    hung = th.is_alive()
    if hung:                           # a killed worker frees both sends
        coord.kill_host(0)
        th.join(timeout=30.0)
    assert not hung, "the coordinator and the worker blocked on each other's sends"
    ids = out.pop("ids")
    assert sorted(out) == sorted(ids)
    assert {r.status for r in out.values()} == {"ok"}


@pytest.mark.slow
def test_loadgen_hosts_with_a_killed_host_on_cpu(capsys):
    """The CLI's multihost smoke: 2 hosts, host 0 killed before wave 1,
    every request accounted for, warm hits through the shared spill."""
    loadgen.main(["--hosts", "2", "--kill-host", "0", "--device", "cpu", "--requests", "8",
                  "--waves", "2"])
    text = capsys.readouterr().out
    assert "injected SIGKILL on host 0" in text
    assert "[loadgen] multihost OK: 2 hosts, 1 lost" in text
    assert "terminals={'ok': 16}" in text


def test_no_cuda_and_no_device_raises_before_spawning(monkeypatch):
    """The device rule: no device named and no CUDA device raises in the
    parent (no worker falls back to the CPU); a bfloat16 dtype is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiHostCoordinator(n_hosts=1)
    with pytest.raises(ValueError, match="dtype"):
        MultiHostCoordinator(n_hosts=1, device="cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="n_hosts"):
        MultiHostCoordinator(n_hosts=0, device="cpu")
