"""Port parity of Shotgun (`repro_torch.baselines.shotgun`) against JAX's
`repro.baselines.elastic_net_shotgun` and the port's coordinate descent.

The port draws its coordinates from a `torch.Generator`, so its rounds are
not JAX's `jax.random.choice` rounds. The comparison is made where the
draws agree:

- Given JAX's draws (the test computes them with `jax.random` as JAX's loop
  does and hands them to the port in place of `torch.randperm`), the port
  runs JAX's rounds: its beta within 1e-10 x max|beta| of JAX's, its round
  count within one (the last round's max |delta b| may fall on either side
  of tol by a rounding).
- With its own draws, a round that draws every coordinate (parallel >= p)
  is the same simultaneous update whatever the order of the draw, so the
  port meets JAX's at the same bounds.
- Against CD at tol 1e-12: with a full draw the stop rule certifies every
  coordinate, which bounds the distance to the optimum by a number of X,
  lambda2 and tol alone (`full_draw_bound`): one proximal step in the
  diagonal metric and the objective's 2 lambda2 strong convexity. With a
  partial draw the stop rule certifies the drawn coordinates only, and
  Shotgun (JAX's too) may stop while others still move: those rows are held
  to PARTIAL_TOL x max|beta|, what JAX's own Shotgun leaves at them.
- The stop rule holds on the last draw, and the same seed gives the same
  bits twice.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu, problem
from repro.baselines import elastic_net_shotgun as jax_shotgun
from repro_torch.baselines import elastic_net_cd, elastic_net_shotgun
from repro_torch.baselines import shotgun as tshotgun
from repro_torch.baselines.shotgun import (coordinate_steps, drawn_coordinates, error_bound,
                                          full_draw_bound, stop_rule_bounds)
from repro_torch.core import elastic_net as en

#: (n, p, parallel, lambda1 as a fraction of lambda1_max, lambda2)
CASES = [(60, 20, 8, 0.1, 1.0), (40, 80, 16, 0.2, 0.5), (120, 30, 30, 0.05, 2.0),
         (60, 20, 20, 0.1, 1.0)]
#: JAX's beta against the port's on the same rounds, relative to max|beta|
TOL = 1e-10
#: a partial draw's distance to CD, relative to max|beta| (JAX's own
#: Shotgun stops 7.1e-9 and 2.2e-2 x from CD at rows 1 and 2)
PARTIAL_TOL = 5e-2


def _full_draw_bound(X, l2, parallel) -> float:
    """With a full draw, the bound the stop rule grounds on ||beta - beta*||
    (`full_draw_bound`); with a partial one, none (inf)."""
    return full_draw_bound(X, l2) if parallel >= X.shape[1] else float("inf")


def _jax_draws(monkeypatch, p, parallel, seed=0, rounds=20000):
    """Make the port draw JAX's coordinates: round r's `torch.randperm`
    returns a permutation that starts with JAX's round-r choice (the key
    split once a round, as JAX's loop does)."""
    P = min(parallel, p)
    key = jax.random.PRNGKey(seed)
    state = {"key": key, "round": 0}

    def randperm(n, generator=None, device=None):
        assert n == p and state["round"] < rounds
        state["key"], sub = jax.random.split(state["key"])
        js = np.asarray(jax.random.choice(sub, p, shape=(P,), replace=False))
        rest = np.setdiff1d(np.arange(p), js)
        state["round"] += 1
        return torch.as_tensor(np.concatenate([js, rest]), device=device)

    monkeypatch.setattr(tshotgun.torch, "randperm", randperm)


def _jax_result(Xn, yn, l1, l2, parallel):
    res = jax_shotgun(jnp.asarray(Xn), jnp.asarray(yn), l1, l2, parallel=parallel)
    return cpu(np.asarray(res.beta)), int(res.rounds)


def _assert_same_rounds(got, jb, jrounds):
    scale = float(jb.abs().max())
    assert float((got.beta - jb).abs().max()) <= TOL * scale
    assert abs(got.rounds - jrounds) <= 1, (got.rounds, jrounds)


def _setup(n, p, frac, seed=0):
    Xn, yn = problem(n, p, seed=seed)
    X, y = cpu(Xn, yn)
    return Xn, yn, X, y, frac * float(en.lambda1_max(X, y))


@pytest.mark.parametrize("n,p,parallel,frac,l2", CASES)
def test_the_stop_rule_holds_on_the_last_draw(n, p, parallel, frac, l2):
    _, _, X, y, l1 = _setup(n, p, frac)
    res = elastic_net_shotgun(X, y, l1, l2, parallel=parallel)
    assert 0 < res.rounds < 20000 and res.delta <= 1e-10
    D = drawn_coordinates(p, parallel, res.rounds)
    s = coordinate_steps(X, y, res.beta, l1, l2)[D].abs()
    assert bool((s <= stop_rule_bounds(X, D, l2)).all())


@pytest.mark.parametrize("n,p,parallel,frac,l2", CASES)
def test_against_coordinate_descent_at_the_certificate(n, p, parallel, frac, l2):
    _, _, X, y, l1 = _setup(n, p, frac)
    sg = elastic_net_shotgun(X, y, l1, l2, parallel=parallel).beta
    cd = elastic_net_cd(X, y, l1, l2, tol=1e-12).beta
    scale = float(cd.abs().max())
    if parallel >= p:   # a bound of X, lambda2 and tol, whatever beta came out
        cert = _full_draw_bound(X, l2, parallel)
        assert cert < 1e-6 * scale      # small enough to tell a wrong beta
        assert float(torch.linalg.norm(sg - cd)) <= cert + error_bound(X, y, cd, l1, l2)
        assert error_bound(X, y, sg, l1, l2) <= cert
    else:
        assert float((sg - cd).abs().max()) <= PARTIAL_TOL * scale


@pytest.mark.parametrize("n,p,parallel,frac,l2", CASES)
def test_against_jax_shotgun_at_the_certificate(n, p, parallel, frac, l2):
    """On JAX's draws, the port's rounds are JAX's rounds."""
    Xn, yn, X, y, l1 = _setup(n, p, frac)
    jb, jrounds = _jax_result(Xn, yn, l1, l2, parallel)
    with pytest.MonkeyPatch.context() as mp:
        _jax_draws(mp, p, parallel)
        got = elastic_net_shotgun(X, y, l1, l2, parallel=parallel)
    _assert_same_rounds(got, jb, jrounds)
    # the certificate on the port's own draw stays an extra
    assert error_bound(X, y, got.beta, l1, l2) <= _full_draw_bound(X, l2, parallel)


@pytest.mark.parametrize("n,p,parallel,frac,l2", [c for c in CASES if c[2] >= c[1]])
def test_a_full_draw_needs_no_jax_draws(n, p, parallel, frac, l2):
    """parallel >= p: every round updates every coordinate at once, so the
    port's own draws give JAX's result."""
    Xn, yn, X, y, l1 = _setup(n, p, frac)
    jb, jrounds = _jax_result(Xn, yn, l1, l2, parallel)
    _assert_same_rounds(elastic_net_shotgun(X, y, l1, l2, parallel=parallel), jb, jrounds)


def test_same_seed_same_bits_and_the_draws_follow_the_seed():
    _, _, X, y, l1 = _setup(60, 20, 0.1)
    a = elastic_net_shotgun(X, y, l1, 1.0, parallel=8, seed=3)
    b = elastic_net_shotgun(X, y, l1, 1.0, parallel=8, seed=3)
    assert torch.equal(a.beta, b.beta) and (a.rounds, a.delta) == (b.rounds, b.delta)
    c = elastic_net_shotgun(X, y, l1, 1.0, parallel=8, seed=4)
    assert not torch.equal(drawn_coordinates(20, 8, 1, seed=3), drawn_coordinates(20, 8, 1, 4))
    assert c.rounds > 0


def test_round_limit_and_a_draw_wider_than_p():
    _, _, X, y, l1 = _setup(60, 20, 0.1)
    cut = elastic_net_shotgun(X, y, l1, 1.0, parallel=8, max_rounds=5)
    assert cut.rounds == 5 and cut.delta > 1e-10
    none = elastic_net_shotgun(X, y, l1, 1.0, max_rounds=0)
    assert none.rounds == 0 and none.delta == float("inf") and float(none.beta.abs().max()) == 0
    wide = elastic_net_shotgun(X, y, l1, 1.0, parallel=64)     # P = min(64, p) = p
    assert drawn_coordinates(20, 64, 1).sort().values.tolist() == list(range(20))
    assert wide.delta <= 1e-10
