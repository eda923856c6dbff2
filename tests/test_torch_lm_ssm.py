"""The port's Mamba-2 SSD block (`repro_torch/models/ssm.py`) against
JAX's (`repro/models/ssm.py`) in float32, on JAX's weights and the same
numpy inputs: the chunked scan at 3 chunks (JAX's
`test_ssd_matches_naive_recurrence` shapes) against JAX's and against the
step-by-step recurrence; the block's forward and its cache (the pre-conv
tail, zero-padded when S < d_conv - 1, and the final state); decode steps
after it, against JAX's and the port's forward; a sequence the chunk does
not divide, refused; and the softplus form against JAX's at every
magnitude, to float32 rounding. Outputs and states within 1e-5 x their
scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as TS

D = 32
REL = 1e-5
CFG = (16, 4, 2, 8, 2, 8)    # d_state, d_conv, expand, head_dim, n_groups, chunk
j_forward = jax.jit(JS.ssm_forward, static_argnums=(2, 3), static_argnames=("return_cache",))
j_decode = jax.jit(JS.ssm_decode_step, static_argnums=(3, 4))


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    dev = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert dev <= rel * scale, f"max dev {dev:.3e} > {rel:.1e} x {scale:.3e}"


def _weights(seed, cfg=CFG):
    jp = jax.jit(JS.init_ssm, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(seed), D, JS.SSMConfig(*cfg), jnp.float32)
    rng = np.random.default_rng(seed)
    H = JS._dims(D, JS.SSMConfig(*cfg))[1]
    # nonzero biases and skips, so every term of the block is exercised
    jp = dict(jp, conv_b=jnp.asarray(0.1 * rng.standard_normal(jp["conv_b"].shape),
                                     jnp.float32),
              dt_bias=jnp.asarray(rng.standard_normal(H), jnp.float32),
              d_skip=jnp.asarray(1 + 0.5 * rng.standard_normal(H), jnp.float32))
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    return jp, tp


def _x(seed, B, S):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _scan_inputs(seed, B=2, S=24, H=3, P=8, ds=5):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P))
    dt_raw = rng.standard_normal((B, S, H))
    dtv = np.log1p(np.exp(dt_raw))
    A = -np.exp(rng.standard_normal(H) * 0.2)
    Bm = rng.standard_normal((B, S, H, ds))
    Cm = rng.standard_normal((B, S, H, ds))
    return [a.astype(np.float32) for a in (xh, dtv * A, dtv, Bm, Cm)]


def test_ssd_scan_matches_jax_and_the_recurrence():
    xh, a, dtv, Bm, Cm = _scan_inputs(0)
    cfg = (5, 4, 2, 8, 1, 8)                  # 24 positions in chunks of 8: 3 chunks
    jy, jh = JS._ssd_scan(*map(jnp.asarray, (xh, a, dtv, Bm, Cm)), JS.SSMConfig(*cfg))
    ty, th = TS._ssd_scan(*map(torch.tensor, (xh, a, dtv, Bm, Cm)), TS.SSMConfig(*cfg))
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)
    # the step-by-step recurrence, in float64
    B, S, H, P = xh.shape
    h = np.zeros((B, H, Bm.shape[-1], P))
    ys = []
    for t in range(S):
        h = np.exp(a[:, t])[:, :, None, None] * h + np.einsum(
            "bh,bhd,bhp->bhdp", dtv[:, t], Bm[:, t], xh[:, t])
        ys.append(np.einsum("bhd,bhdp->bhp", Cm[:, t], h))
    _close(ty, np.stack(ys, axis=1), 1e-4)
    _close(th, h, 1e-4)


def test_ssd_scan_refuses_a_sequence_the_chunk_does_not_divide():
    xh, a, dtv, Bm, Cm = (t[:, :12] for t in _scan_inputs(1))
    with pytest.raises(ValueError, match="does not divide"):
        TS._ssd_scan(*map(torch.tensor, (xh, a, dtv, Bm, Cm)), TS.SSMConfig(5, 4, 2, 8, 1, 8))
    with pytest.raises(AssertionError):
        JS._ssd_scan(*map(jnp.asarray, (xh, a, dtv, Bm, Cm)), JS.SSMConfig(5, 4, 2, 8, 1, 8))


@pytest.mark.parametrize("S", [16, 2, 5])     # 2 chunks; S < d_conv - 1; one chunk of 5
def test_ssm_forward_and_cache_match_jax(S):
    jp, tp = _weights(0)
    x = _x(1, 2, S)
    jout, jc = j_forward(jp, jnp.asarray(x), D, JS.SSMConfig(*CFG), return_cache=True)
    tout, tc = TS.ssm_forward(tp, torch.tensor(x), D, TS.SSMConfig(*CFG), return_cache=True)
    _close(tout, jout)
    assert tc.conv.shape == (2, CFG[1] - 1, jc.conv.shape[-1])
    _close(tc.conv, jc.conv)
    _close(tc.h, jc.h)
    _close(TS.ssm_forward(tp, torch.tensor(x), D, TS.SSMConfig(*CFG)), jout)


def test_ssm_decode_steps_match_jax_and_the_forward():
    jp, tp = _weights(2)
    S, steps = 8, 4
    x = _x(3, 2, 2 * S)
    jcfg, tcfg = JS.SSMConfig(*CFG), TS.SSMConfig(*CFG)
    _, jc = j_forward(jp, jnp.asarray(x[:, :S]), D, jcfg, return_cache=True)
    _, tc = TS.ssm_forward(tp, torch.tensor(x[:, :S]), D, tcfg, return_cache=True)
    full = TS.ssm_forward(tp, torch.tensor(x), D, tcfg)     # 2 chunks of 8
    for s in range(S, S + steps):
        jout, jc = j_decode(jp, jnp.asarray(x[:, s:s + 1]), jc, D, jcfg)
        tout, tc = TS.ssm_decode_step(tp, torch.tensor(x[:, s:s + 1]), tc, D, tcfg)
        _close(tout, jout)
        _close(tc.conv, jc.conv)
        _close(tc.h, jc.h)
        _close(tout, full[:, s:s + 1], 1e-4)


def test_softplus_matches_jax_at_every_magnitude():
    x = np.concatenate([np.linspace(-120, 120, 4801),
                        [-1e4, -88.7, -30, -20.5, 19.99, 20.0, 20.01, 35.0, 1e4]]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TS.softplus(torch.tensor(x)).numpy()
    # to float32 rounding; below the smallest normal number, JAX keeps
    # subnormal results that the CPU's torch flushes to zero
    np.testing.assert_allclose(got, want, rtol=2 * np.finfo(np.float32).eps,
                               atol=np.finfo(np.float32).tiny)
    # torch's own form returns x above its threshold, where JAX adds log1p(exp(-x))
    hi = torch.tensor([20.5], dtype=torch.float64)
    assert float(TS.softplus(hi) - hi) > 0 and float(torch.nn.functional.softplus(hi) - hi) == 0
