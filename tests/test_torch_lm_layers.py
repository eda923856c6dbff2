"""The port's LM base layers (`repro_torch/models/layers.py`) against JAX's
(`repro/models/layers.py`) on the same numpy inputs, made from a seed:
RMSNorm in float32, bfloat16 and float64, RoPE, the SwiGLU MLP, the
embedding and the tied head. Float32 results agree within 1e-6 x the
output's scale (1e-5 x after a matmul); bfloat16 ones within one bfloat16
step of the scale (2^-8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

BF16_STEP = 2.0 ** -8


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, rel):
    got = got.detach().to(torch.float64).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    dev = np.abs(got - want).max()
    assert dev <= rel * scale, f"max dev {dev:.3e} > {rel:.1e} x {scale:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_rms_norm_matches_jax(dtype):
    rng = _rng(1)
    x = (3.0 * rng.standard_normal((3, 5, 48))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JL.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt))
    got = TL.rms_norm(torch.tensor(x).to(tdt), torch.tensor(scale).to(tdt))
    assert got.dtype == tdt
    _close(got, np.asarray(want.astype(jnp.float64)), BF16_STEP if dtype == "bfloat16" else 1e-6)


def test_rms_norm_float64_input_normalises_in_float32():
    """A float64 input is normalised in float32, as JAX does: the result is
    the float32 input's result, widened (the scale is 1)."""
    x = _rng(2).standard_normal((4, 32))
    one = torch.ones(32, dtype=torch.float64)
    got = TL.rms_norm(torch.tensor(x), one)
    via32 = TL.rms_norm(torch.tensor(x, dtype=torch.float32), one.float()).double()
    direct = torch.tensor(x) / torch.sqrt(torch.mean(torch.tensor(x) ** 2, -1, keepdim=True)
                                          + 1e-6)
    assert got.dtype == torch.float64
    assert torch.allclose(got, via32, rtol=1e-6, atol=0)
    assert (got - direct).abs().max() > 1e-12      # float32 rounding is visible


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = _rng(3)
    hd, S = 16, 12
    pos = np.arange(S, dtype=np.int32) + 5
    jc, js = JL.rope_freqs(hd, theta, jnp.asarray(pos))
    tc, ts = TL.rope_freqs(hd, theta, torch.tensor(pos))
    assert tc.dtype == ts.dtype == torch.float32 and tc.shape == (S, hd // 2)
    _close(tc, np.asarray(jc), 1e-6)
    _close(ts, np.asarray(js), 1e-6)
    x = rng.standard_normal((2, S, 3, hd)).astype(np.float32)
    want = JL.apply_rope(jnp.asarray(x), jc, js)
    got = TL.apply_rope(torch.tensor(x), tc, ts)
    _close(got, np.asarray(want), 1e-6)
    # halves rotate: the first half of hd pairs with the second, not x[2i] with x[2i+1]
    x1, x2 = torch.tensor(x).chunk(2, dim=-1)
    assert torch.allclose(got[..., :hd // 2], x1 * tc[:, None] - x2 * ts[:, None], atol=1e-6)


def test_mlp_matches_jax():
    rng = _rng(4)
    d, f = 32, 80
    params = {"w_gate": rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5,
              "w_up": rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5,
              "w_down": rng.standard_normal((f, d)).astype(np.float32) * f ** -0.5}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    want = JL.apply_mlp({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    got = TL.apply_mlp({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x))
    _close(got, np.asarray(want), 1e-5)


def test_init_shapes_and_dtypes_match_jax():
    gen = torch.Generator().manual_seed(0)
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        jm = JL.init_mlp(jax.random.PRNGKey(0), 16, 40, jdt)
        tm = TL.init_mlp(gen, 16, 40, tdt, torch.device("cpu"))
        je = JL.init_embedding(jax.random.PRNGKey(1), 50, 16, jdt)
        te = TL.init_embedding(gen, 50, 16, tdt, torch.device("cpu"))
        for j, t in ((jm, tm), (je, te), (JL.init_rms_norm(16, jdt),
                                         TL.init_rms_norm(16, tdt, torch.device("cpu")))):
            assert j.keys() == t.keys()
            for k in j:
                assert tuple(j[k].shape) == tuple(t[k].shape) and t[k].dtype == tdt
        # the draws' scales are JAX's: std d^-0.5 for the gate, f^-0.5 for the down
        assert abs(tm["w_down"].float().std().item() - 40 ** -0.5) < 0.2 * 40 ** -0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_and_tied_head_match_jax(dtype):
    rng = _rng(5)
    V, d = 40, 24
    table = (rng.standard_normal((V, d)) * d ** -0.5).astype(np.float32)
    toks = rng.integers(0, V, (3, 6)).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {"table": jnp.asarray(table, jdt)}
    tp = {"table": torch.tensor(table).to(tdt)}
    je = JL.embed_tokens(jp, jnp.asarray(toks))
    te = TL.embed_tokens(tp, torch.tensor(toks))
    assert te.dtype == tdt
    assert np.array_equal(te.float().numpy(), np.asarray(je.astype(jnp.float32)))
    x = rng.standard_normal((3, 6, d)).astype(np.float32)
    jl = JL.logits_from_embedding(jp, jnp.asarray(x, jdt))
    tl = TL.logits_from_embedding(tp, torch.tensor(x).to(tdt))
    assert tl.dtype == torch.float32 and tl.shape == (3, 6, V)
    _close(tl, np.asarray(jl), 1e-5)
