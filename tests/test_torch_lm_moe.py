"""The port's MoE MLP (`repro_torch/models/moe.py`) against JAX's
(`repro/models/moe.py`) in float32, on JAX's weights and the same numpy
inputs: the chosen experts equal JAX's (asserted before any output is
compared, so that a flipped choice fails as a flip), each choice's rank
within its expert equal to a rank counted here in numpy, then the output
within 1e-5 x max|y| and the aux loss within 1e-5 x. Cases: mixtral's
8 experts top-2 at the default capacity; top-8 of 16 with a shared expert;
a capacity factor of 1.0 whose choices provably drop tokens (counted from
the numpy ranks); and a decode step (S = 1, the capacity floor of 8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMoE
from repro_torch.models import moe as TMoE

D = 32
REL = 1e-5
_j_apply_moe = jax.jit(JMoE.apply_moe, static_argnums=2)


def _weights(cfg, seed):
    jp = jax.jit(JMoE.init_moe, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(seed), D, JMoE.MoEConfig(*cfg), jnp.float32)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    return jp, tp


def _x(seed, B, S, skew=0.0, router=None):
    """numpy inputs; `skew` adds a shared component along the router's
    first column, which crowds expert 0."""
    x = np.random.default_rng(seed).standard_normal((B, S, D))
    if skew:
        col = np.asarray(router)[:, 0]
        x = x + skew * col / np.linalg.norm(col)
    return x.astype(np.float32)


def _jax_choices(jp, x, K):
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, K)[1])


def _numpy_ranks(top_e):
    """Each choice's position within its expert in token order, per row."""
    B = top_e.shape[0]
    flat = top_e.reshape(B, -1)
    ranks = np.zeros_like(flat)
    for b in range(B):
        seen: dict = {}
        for i, e in enumerate(flat[b]):
            ranks[b, i] = seen.get(int(e), 0)
            seen[int(e)] = ranks[b, i] + 1
    return ranks


def _check(cfg, x, jp, tp):
    """Choices, ranks, output and aux against JAX; returns (C, ranks)."""
    tcfg = TMoE.MoEConfig(*cfg)
    want_e = _jax_choices(jp, x, tcfg.top_k)
    _, _, top_e = TMoE.route(tp, torch.tensor(x), tcfg)
    assert np.array_equal(top_e.numpy(), want_e), "the chosen experts differ from JAX's"
    ranks = _numpy_ranks(want_e)
    assert np.array_equal(TMoE.ranks(top_e.reshape(x.shape[0], -1)).numpy(), ranks)

    jy, jaux = _j_apply_moe(jp, jnp.asarray(x), JMoE.MoEConfig(*cfg))
    ty, taux = TMoE.apply_moe(tp, torch.tensor(x), tcfg)
    jy = np.asarray(jy)
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    scale = np.abs(jy).max()
    assert np.abs(ty.numpy() - jy).max() <= REL * scale
    assert taux.dtype == torch.float32
    assert abs(float(taux) - float(jaux)) <= REL * abs(float(jaux))
    C = TMoE._capacity(x.shape[1], tcfg)
    assert C == JMoE._capacity(x.shape[1], JMoE.MoEConfig(*cfg))
    return C, ranks


@pytest.mark.parametrize("cfg,B,S", [
    ((8, 2, 48, 0, 0, 1.25), 2, 16),       # mixtral's router at the default capacity
    ((16, 8, 24, 1, 40, 1.25), 2, 12),     # top-8 of 16 and a shared expert
    ((4, 2, 48, 0, 0, 8.0), 3, 10),        # the SMOKE configs' ample capacity
])
def test_apply_moe_matches_jax(cfg, B, S):
    jp, tp = _weights(cfg, 0)
    _check(cfg, _x(1, B, S), jp, tp)


def test_apply_moe_drops_tokens_as_jax_does():
    """capacity_factor 1.0 with expert 0 crowded: at least one choice ranks
    at or past C (dropped) in the numpy count, and the port still matches."""
    cfg = (4, 2, 48, 0, 0, 1.0)
    jp, tp = _weights(cfg, 2)
    x = _x(3, 2, 32, skew=4.0, router=jp["router"])
    C, ranks = _check(cfg, x, jp, tp)
    dropped = int((ranks >= C).sum())
    assert C == 16 and dropped >= 1, (C, dropped)


def test_apply_moe_decode_step_matches_jax():
    """One token a row: C is the floor of 8, so nothing drops."""
    cfg = (8, 2, 48, 1, 16, 1.25)
    jp, tp = _weights(cfg, 4)
    C, ranks = _check(cfg, _x(5, 4, 1), jp, tp)
    assert C == 8 and int(ranks.max()) < C


def test_init_moe_layout():
    cfg = TMoE.MoEConfig(n_experts=6, top_k=2, d_ff_expert=20, n_shared=2, d_ff_shared=12)
    gen = torch.Generator().manual_seed(0)
    p = TMoE.init_moe(gen, D, cfg, torch.bfloat16, torch.device("cpu"))
    want = jax.eval_shape(lambda k: JMoE.init_moe(k, D, JMoE.MoEConfig(*cfg), jnp.bfloat16),
                          jax.random.PRNGKey(0))
    got_shapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), p)
    want_shapes = jax.tree.map(lambda a: (tuple(a.shape), "torch." + np.dtype(a.dtype).name),
                               want)
    assert got_shapes == want_shapes
    assert p["router"].dtype == torch.float32
