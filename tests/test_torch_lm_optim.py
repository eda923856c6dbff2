"""The port's optimizers and schedules (`repro_torch/optim/`) against
JAX's (`repro/optim/`) on the same seeded trees, float32 and bfloat16
leaves mixed: the global norm and the clip (active and not), AdamW over 3
steps (lr a float and a schedule's tensor), both schedules, Adafactor over
3 steps on factored, vector, (1, n) and 3-D leaves. Bounds: float32
leaves within 1e-6 x the leaf's max|value|; bfloat16 leaves within one
bf16 ulp; counts equal. Also twins of `tests/test_train_serve.py`'s
numpy AdamW reference, schedule shape and Adafactor loss and memory
checks (Adafactor's state below 0.25 x AdamW's bytes)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adafactor as JAF
from repro.optim import adamw as JAW
from repro.optim import schedules as JS
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.models import model as M
from repro_torch.optim import adafactor as TAF
from repro_torch.optim import adamw as TAW
from repro_torch.optim import schedules as TS
from repro_torch.train.step import grads_and_metrics
from repro_torch.utils import tree_bytes, tree_leaves

REL = 1e-6

SHAPES = {"w": (8, 16), "b": (16,), "row": (1, 12), "stack": (3, 5, 7)}


def _tree(seed, bf16_keys=("b", "stack"), scale=1.0):
    """{name: torch tensor} drawn from a numpy generator; the leaves named
    in bf16_keys in bfloat16, the rest float32; "stack" sits in a list."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in SHAPES.items():
        t = torch.tensor(scale * rng.standard_normal(shape), dtype=torch.float32)
        out[k] = t.to(torch.bfloat16) if k in bf16_keys else t
    out["stack"] = [out["stack"]]
    return out


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jtree(tree):
    return jax.tree.map(_to_jax, tree)


def _ordered(bits):
    """bf16 bit patterns (int16) as integers ordered like their values."""
    b = bits.to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


def _close(got, want, what):
    """got (torch) against want (JAX): float32 within REL x max|want|,
    bfloat16 within one ulp, integers equal."""
    want = _to_torch(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    if got.numel() == 0:
        return
    if got.dtype == torch.bfloat16:
        gap = (_ordered(got.view(torch.int16)) - _ordered(want.view(torch.int16))).abs().max()
        assert int(gap) <= 1, f"{what}: {int(gap)} bf16 ulps apart"
    elif got.dtype.is_floating_point:
        dev = float((got.double() - want.double()).abs().max())
        bound = REL * float(want.double().abs().max())
        assert dev <= bound, f"{what}: max dev {dev:.3e} > {bound:.3e}"
    else:
        assert torch.equal(got, want), what


def _close_trees(got, want, what):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        _close(node, leaf, f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    g = _tree(1)
    jg = _jtree(g)
    _close(TAW.global_norm(g), JAW.global_norm(jg), "global_norm")
    clipped, norm = TAW.clip_by_global_norm(g, max_norm)
    jclipped, jnorm = JAW.clip_by_global_norm(jg, max_norm)
    _close(norm, jnorm, "norm")
    _close_trees(clipped, jclipped, "clipped")
    assert clipped["w"].dtype == torch.float32 and clipped["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("lr_kind", ["float", "schedule"])
def test_adamw_matches_jax_over_three_steps(lr_kind):
    params = _tree(0)
    state = TAW.adamw_init(params)
    jparams, jstate = _jtree(params), JAW.adamw_init(_jtree(params))
    assert all(m.dtype == torch.float32 for m in state.m["stack"] + [state.m["b"]])
    assert state.count.dtype == torch.int32 and int(state.count) == 0
    sched, jsched = TS.warmup_cosine(1e-2, 2, 10), JS.warmup_cosine(1e-2, 2, 10)
    for k in range(3):
        g = _tree(10 + k, scale=0.1)
        if lr_kind == "float":
            lr, jlr = 3e-3, 3e-3
        else:
            lr, jlr = sched(state.count), jsched(jstate.count)
            _close(lr, jlr, f"lr at step {k}")
        params, state = TAW.adamw_update(g, state, params, lr=lr)
        jparams, jstate = JAW.adamw_update(_jtree(g), jstate, jparams, lr=jlr)
        _close_trees(params, jparams, f"params step {k}")
        _close_trees(state.m, jstate.m, f"m step {k}")
        _close_trees(state.v, jstate.v, f"v step {k}")
        _close(state.count, jstate.count, "count")
    assert params["b"].dtype == torch.bfloat16


def test_schedules_match_jax():
    steps = torch.arange(0, 121, dtype=torch.int32)
    for t_fn, j_fn in ((TS.constant_lr(3e-4), JS.constant_lr(3e-4)),
                       (TS.warmup_cosine(3e-4, 10, 100), JS.warmup_cosine(3e-4, 10, 100)),
                       (TS.warmup_cosine(1.0, 0, 7, final_frac=0.3),
                        JS.warmup_cosine(1.0, 0, 7, final_frac=0.3))):
        for s in steps:
            got = t_fn(s)
            assert got.dtype == torch.float32 and got.shape == ()
            _close(got, jnp.asarray(j_fn(jnp.asarray(int(s), jnp.int32)), jnp.float32),
                   f"lr at {int(s)}")


def test_adafactor_matches_jax_over_three_steps():
    params = _tree(0)
    state = TAF.adafactor_init(params)
    jparams, jstate = _jtree(params), JAF.adafactor_init(_jtree(params))
    assert state.v_row["w"].shape == (8,) and state.v_col["w"].shape == (16,)
    assert state.v_row["row"].shape == (1, 12) and state.v_col["row"].shape == (0,)
    assert state.v_row["stack"][0].shape == (3, 5) and state.v_col["stack"][0].shape == (3, 7)
    for k in range(3):
        g = _tree(20 + k, scale=0.1)
        params, state = TAF.adafactor_update(g, state, params, lr=1e-2, weight_decay=0.01)
        jparams, jstate = JAF.adafactor_update(_jtree(g), jstate, jparams, lr=1e-2,
                                               weight_decay=0.01)
        _close_trees(params, jparams, f"params step {k}")
        _close_trees(state.v_row, jstate.v_row, f"v_row step {k}")
        _close_trees(state.v_col, jstate.v_col, f"v_col step {k}")
        _close(state.count, jstate.count, "count")


def test_adamw_matches_numpy_reference():
    """One AdamW step vs a hand-rolled numpy implementation (twin of
    `tests/test_train_serve.py::test_adamw_matches_numpy_reference`)."""
    rng = np.random.default_rng(0)
    p = {"w": torch.tensor(rng.standard_normal((5, 3)), dtype=torch.float32)}
    g = {"w": torch.tensor(rng.standard_normal((5, 3)), dtype=torch.float32)}
    state = TAW.adamw_init(p)
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.95, 1e-8, 0.1
    new_p, new_state = TAW.adamw_update(g, state, p, lr=lr, b1=b1, b2=b2, eps=eps,
                                        weight_decay=wd)
    gw = g["w"].double().numpy()
    m = (1 - b1) * gw
    v = (1 - b2) * gw * gw
    mhat = m / (1 - b1)
    vhat = v / (1 - b2)
    pw = p["w"].double().numpy()
    want = pw - lr * (mhat / (np.sqrt(vhat) + eps) + wd * pw)
    np.testing.assert_allclose(new_p["w"].numpy(), want, atol=1e-5)
    assert int(new_state.count) == 1


def test_warmup_cosine_schedule_shape():
    fn = TS.warmup_cosine(1.0, warmup_steps=10, total_steps=100)
    vals = [float(fn(torch.tensor(s))) for s in (0, 5, 10, 50, 100)]
    assert vals[0] == 0.0
    assert vals[1] == pytest.approx(0.5)
    assert vals[2] == pytest.approx(1.0, abs=0.1)
    assert vals[3] < vals[2]
    assert vals[4] == pytest.approx(0.1, abs=0.02)


def test_adafactor_reduces_loss_and_memory():
    """Twin of `tests/test_train_serve.py::test_adafactor_reduces_loss_and_memory`."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    params = M.init_model(cfg, device="cpu")
    state = TAF.adafactor_init(params)
    adamw_bytes = 2 * sum(p.numel() * 4 for p in tree_leaves(params))
    assert tree_bytes((state.v_row, state.v_col)) < 0.25 * adamw_bytes
    assert tree_bytes(TAW.adamw_init(params)[:2]) == adamw_bytes

    stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                        global_batch=8, seed=0), device="cpu")
    losses = []
    for _ in range(20):
        grads, metrics = grads_and_metrics(params, cfg, next(stream))
        params, state = TAF.adafactor_update(grads, state, params, lr=3e-3)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
