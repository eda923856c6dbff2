"""The port's multi-head latent attention (`repro_torch/models/mla.py`)
against JAX's (`repro/models/mla.py`) in float32, on JAX's weights and the
same numpy inputs: the expanded form with materialized scores and through
the chunked path (S > dense_max); the prefill's padded latent cache; the
absorbed decode steps after it, against JAX's and against the expanded
form over the whole sequence; and decode steps at and past the cache's
length, whose last slot both overwrite. Outputs within 1e-5 x their
scale, caches within 1e-6 x."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as JMLA
from repro_torch.models import mla as TMLA

D, THETA = 48, 1e4
CFG = (4, 24, 16, 16, 8, 12)    # heads, q rank, kv rank, nope, rope, v
REL = 1e-5
j_full = jax.jit(JMLA.mla_full, static_argnums=(2,), static_argnames=("rope_theta", "dense_max"))
j_prefill = jax.jit(JMLA.mla_prefill, static_argnums=(2,),
                    static_argnames=("rope_theta", "cache_len", "dense_max"))
j_decode = jax.jit(JMLA.mla_decode_step, static_argnums=(3,), static_argnames=("rope_theta",))


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    dev = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert dev <= rel * scale, f"max dev {dev:.3e} > {rel:.1e} x {scale:.3e}"


def _close_cache(tc, jc):
    _close(tc.c_kv, jc.c_kv, 1e-6)
    _close(tc.k_rope, jc.k_rope, 1e-6)
    assert tc.pos == int(jc.pos)


def _weights(seed):
    jp = jax.jit(JMLA.init_mla, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(seed), D, JMLA.MLAConfig(*CFG), jnp.float32)
    rng = np.random.default_rng(seed)
    # norm scales away from 1, so the norms' scales are exercised
    jp = dict(jp, q_norm={"scale": jnp.asarray(1 + 0.3 * rng.standard_normal(CFG[1]),
                                               jnp.float32)},
              kv_norm={"scale": jnp.asarray(1 + 0.3 * rng.standard_normal(CFG[2]),
                                            jnp.float32)})
    return jp, jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)


def _x(seed, B, S):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


@pytest.mark.parametrize("S,dense_max", [(12, 2048), (16, 8)])   # dense; chunked
def test_mla_full_matches_jax(S, dense_max):
    jp, tp = _weights(0)
    x = _x(1, 2, S)
    want = j_full(jp, jnp.asarray(x), JMLA.MLAConfig(*CFG), rope_theta=THETA,
                  dense_max=dense_max)
    got = TMLA.mla_full(tp, torch.tensor(x), TMLA.MLAConfig(*CFG), rope_theta=THETA,
                        dense_max=dense_max)
    _close(got, want)


def test_mla_prefill_and_absorbed_decode_match_jax():
    jp, tp = _weights(2)
    S, steps = 8, 4
    x = _x(3, 2, S + steps)
    jcfg, tcfg = JMLA.MLAConfig(*CFG), TMLA.MLAConfig(*CFG)
    jout, jc = j_prefill(jp, jnp.asarray(x[:, :S]), jcfg, rope_theta=THETA,
                         cache_len=S + steps + 2)
    tout, tc = TMLA.mla_prefill(tp, torch.tensor(x[:, :S]), tcfg, rope_theta=THETA,
                                cache_len=S + steps + 2)
    _close(tout, jout)
    _close_cache(tc, jc)
    full = TMLA.mla_full(tp, torch.tensor(x), tcfg, rope_theta=THETA)
    for s in range(S, S + steps):
        jout, jc = j_decode(jp, jnp.asarray(x[:, s:s + 1]), jc, jcfg, rope_theta=THETA)
        tout, tc = TMLA.mla_decode_step(tp, torch.tensor(x[:, s:s + 1]), tc, tcfg,
                                        rope_theta=THETA)
        _close(tout, jout)
        _close_cache(tc, jc)
        _close(tout, full[:, s:s + 1], 1e-4)       # absorbed against expanded


def test_mla_decode_past_the_cache_length_matches_jax():
    """A cache of S + 1 slots and 3 decode steps: the second and third
    write the last slot again, where JAX's `dynamic_update_slice` clamps."""
    jp, tp = _weights(4)
    S = 6
    x = _x(5, 2, S + 3)
    jcfg, tcfg = JMLA.MLAConfig(*CFG), TMLA.MLAConfig(*CFG)
    _, jc = j_prefill(jp, jnp.asarray(x[:, :S]), jcfg, rope_theta=THETA, cache_len=S + 1)
    _, tc = TMLA.mla_prefill(tp, torch.tensor(x[:, :S]), tcfg, rope_theta=THETA,
                             cache_len=S + 1)
    for s in range(S, S + 3):
        jout, jc = j_decode(jp, jnp.asarray(x[:, s:s + 1]), jc, jcfg, rope_theta=THETA)
        tout, tc = TMLA.mla_decode_step(tp, torch.tensor(x[:, s:s + 1]), tc, tcfg,
                                        rope_theta=THETA)
        _close(tout, jout)
        _close_cache(tc, jc)
    assert tc.pos == S + 3 and tc.c_kv.shape[1] == S + 1
