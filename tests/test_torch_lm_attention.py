"""The port's attention (`repro_torch/models/attention.py`) against JAX's
(`repro/models/attention.py`) on the same numpy weights and inputs, in
float32: full attention with GQA, with QKV bias and with a window; the
chunked online-softmax path at 8 x 8 chunks; prefill's cache, padded and
rolling; decode steps, through a rolling buffer and past a full cache
(whose last slot JAX overwrites). Outputs agree within 1e-5 x their scale,
caches within 1e-6 x."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.models import attention as TA

D, H, KV, HD, THETA = 32, 4, 2, 8, 1e4


def _weights(seed, bias, kv=KV):
    rng = np.random.default_rng(seed)
    w = {"wq": rng.standard_normal((D, H, HD)) * D ** -0.5,
         "wk": rng.standard_normal((D, kv, HD)) * D ** -0.5,
         "wv": rng.standard_normal((D, kv, HD)) * D ** -0.5,
         "wo": rng.standard_normal((H, HD, D)) * (H * HD) ** -0.5}
    if bias:
        w.update(bq=0.3 * rng.standard_normal((H, HD)), bk=0.3 * rng.standard_normal((kv, HD)),
                 bv=0.3 * rng.standard_normal((kv, HD)))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.tensor(v) for k, v in w.items()})


def _x(seed, B, S):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    dev = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert dev <= rel * scale, f"max dev {dev:.3e} > {rel:.1e} x {scale:.3e}"


def _close_cache(tc, jc):
    _close(tc.k, jc.k, 1e-6)
    _close(tc.v, jc.v, 1e-6)
    assert tc.pos == int(jc.pos)


@pytest.mark.parametrize("bias,kv,window,dense_max", [
    (False, KV, None, 2048),     # GQA, materialized scores
    (True, KV, None, 2048),      # QKV bias
    (False, H, 5, 2048),         # MHA, sliding window
    (True, KV, 6, 8),            # S > dense_max: the chunked path inside attend_full
])
def test_attend_full_matches_jax(bias, kv, window, dense_max):
    jw, tw = _weights(0, bias, kv)
    x = _x(1, 2, 16)
    kw = dict(n_heads=H, head_dim=HD, rope_theta=THETA, window=window, dense_max=dense_max)
    want = JA.attend_full(jw, jnp.asarray(x), **kw)
    got = TA.attend_full(tw, torch.tensor(x), **kw)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("window", [None, 12])
def test_sdpa_chunked_matches_jax_and_dense(window):
    rng = np.random.default_rng(2)
    B, S = 2, 32
    q, k, v = (rng.standard_normal((B, S, H, HD)).astype(np.float32) for _ in range(3))
    kw = dict(scale=HD ** -0.5, window=window, chunk_q=8, chunk_kv=8)
    want = JA.sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = TA.sdpa_chunked(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
    _close(got, want, 1e-5)
    pos = torch.arange(S)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    dense = TA._sdpa(torch.tensor(q), torch.tensor(k), torch.tensor(v), mask[None, None], HD)
    _close(got, dense.numpy(), 1e-5)
    with pytest.raises(ValueError, match="must divide"):
        TA.sdpa_chunked(torch.tensor(q), torch.tensor(k), torch.tensor(v), scale=1.0,
                        chunk_q=7, chunk_kv=8)


@pytest.mark.parametrize("window,cache_len", [
    (None, 24),      # buf >= S: the cache is padded
    (None, 10),      # buf == S
    (6, 24),         # S > window: a rolling buffer of the last 6 positions
])
def test_prefill_matches_jax(window, cache_len):
    jw, tw = _weights(3, True)
    x = _x(4, 2, 10)
    kw = dict(n_heads=H, head_dim=HD, rope_theta=THETA, window=window, cache_len=cache_len)
    jo, jc = JA.prefill(jw, jnp.asarray(x), **kw)
    to, tc = TA.prefill(tw, torch.tensor(x), **kw)
    _close(to, jo, 1e-5)
    _close_cache(tc, jc)


@pytest.mark.parametrize("window,cache_len,steps", [
    (None, 12, 3),   # room in the cache
    (None, 9, 4),    # a full cache: slot min(pos, S_buf - 1) overwrites the last slot
    (5, 24, 4),      # rolling buffer: slot pos % 5
])
def test_decode_steps_match_jax(window, cache_len, steps):
    jw, tw = _weights(5, True)
    x = _x(6, 2, 8)
    kw = dict(n_heads=H, head_dim=HD, rope_theta=THETA, window=window)
    _, jc = JA.prefill(jw, jnp.asarray(x), cache_len=cache_len, **kw)
    _, tc = TA.prefill(tw, torch.tensor(x), cache_len=cache_len, **kw)
    rng = np.random.default_rng(7)
    for _ in range(steps):
        xt = rng.standard_normal((2, 1, D)).astype(np.float32)
        jo, jc = JA.decode_step(jw, jnp.asarray(xt), jc, **kw)
        to, tc = TA.decode_step(tw, torch.tensor(xt), tc, **kw)
        _close(to, jo, 1e-5)
        _close_cache(tc, jc)
    if window is None and cache_len < 8 + steps:
        assert tc.pos > tc.k.shape[1]           # the clamp was exercised
