"""The port's LM training step (`repro_torch/train/step.py`, remat in
`models/model.py::forward`) against JAX's (`repro/train/step.py`, called
outside a mesh) on all ten SMOKE configs in float32, with JAX's weights
carried across by `convert.model_params_from_jax` and JAX's gradient trees
unstacked the same way.

- `lm_loss` and its gradients against `jax.value_and_grad(lm_loss)`: each
  MoE layer's chosen experts equal first (so a flipped choice fails as a
  flip), then the loss and metrics within 1e-5 relative and every
  gradient leaf within 1e-5 x the tree's max|g|.
- The step (microbatches 1 and 2) against JAX's jitted step, its AdamW
  update wrapped to capture the clipped gradients it is handed:
  metrics and `grad_norm` within 1e-5 relative, the clipped gradients
  within 1e-5 x max|g|; the port's clip and AdamW applied to JAX's
  gradients against JAX's new parameters and moments within 1e-6 x each
  leaf's max|value|.
- remat off, "full" and "dots" give the same gradients (1e-6 x), and
  "dots" re-runs no matmul in backward.
- A twin of `tests/test_train_serve.py::test_loss_decreases_tiny_model`.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as JC
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.optim import adamw as JAW
from repro.train import step as JS
from repro_torch import configs as TC
from repro_torch.convert import model_params_from_jax
from repro_torch.data import pipeline as TP
from repro_torch.models import moe as TMoE
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TAW
from repro_torch.train import step as TS
from repro_torch.utils import tree_leaves, tree_paths
from test_torch_lm_model import ARCHS

S = 12
REL = 1e-5       # loss, metrics, gradients against JAX
OPT_REL = 1e-6   # the optimizer on identical gradients; remat modes against each other


def _batch(cfg, batch, seed=0):
    """numpy inputs from the synthetic pipeline (bitwise JAX's): S
    positions, S - vision_tokens text tokens for "patches"."""
    s_txt = S - cfg.vision_tokens if cfg.frontend == "patches" else S
    dcfg = TP.DataConfig(vocab_size=cfg.vocab_size, seq_len=s_txt, global_batch=batch,
                         seed=seed,
                         n_codebooks=cfg.n_codebooks if cfg.frontend == "codebooks" else 0,
                         vision_tokens=cfg.vision_tokens if cfg.frontend == "patches" else 0,
                         d_model=cfg.d_model)
    return TP.synthetic_numpy(dcfg, 0)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_tree(jtree, cfg):
    """A JAX parameter-shaped tree (params, a gradient, a moment) in the
    port's layout on the CPU."""
    return model_params_from_jax(jax.tree.map(np.asarray, jtree), cfg, device="cpu")


def _close_trees(got, want, rel, what, per_leaf=False):
    """Every leaf of got within rel x max|want| (the tree's, or the leaf's
    when per_leaf); the same paths on both."""
    got, want = dict(tree_paths(got)), dict(tree_paths(want))
    assert got.keys() == want.keys(), what
    scale = max(float(w.abs().max()) for w in want.values())
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        s = float(w.abs().max()) if per_leaf else scale
        dev = float((g.double() - w.double()).abs().max())
        assert dev <= rel * s, f"{what} {path}: max dev {dev:.3e} > {rel:.0e} x {s:.3e}"


def _close_metrics(got, want, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        w, g = float(w), float(got[k])
        assert abs(g - w) <= REL * max(abs(w), 1e-6), f"{what} {k}: {g} vs JAX {w}"


def _port_choices(fn):
    """fn() with each MoE layer's top-k experts recorded."""
    seen = []
    route = TMoE.route

    def record(params, x, cfg):
        out = route(params, x, cfg)
        seen.append(out[2].detach().numpy())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TMoE, "route", record)
        out = fn()
    return out, seen


def _assert_same_choices(got, want):
    """The forward's choices equal JAX's; under remat, backward's recompute
    (the layers in reverse) chose the same again."""
    n = len(want)
    assert len(got) in (n, 2 * n), (len(got), n)
    for i, (g, w) in enumerate(zip(got[:n], want)):
        assert np.array_equal(g, w), f"MoE layer {i}: the chosen experts differ"
    for i, (g, w) in enumerate(zip(got[n:][::-1], want)):
        assert np.array_equal(g, w), f"MoE layer {i}: the recompute chose other experts"


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """JAX's SMOKE parameters of `arch` (PRNGKey(0)), initialized once."""
    jcfg = JC.get_config(arch, smoke=True)
    return jax.jit(lambda key: JM.init_model(key, jcfg))(jax.random.PRNGKey(0))


def _jax_choices(jparams, jcfg, batch):
    """Each MoE layer's top-k experts in JAX's forward (layers unrolled and
    not rematerialized, so each MoE layer is traced on its own), returned
    from one jitted call."""
    if all(jcfg.layer_spec(i)[1] != "moe" for i in range(jcfg.n_layers)):
        return []
    eager = dataclasses.replace(jcfg, remat=False, unroll_layers=True)
    apply_moe = JMoE.apply_moe

    def choices(params, b):
        seen = []

        def record(p, x, cfg):
            probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
            seen.append(jax.lax.top_k(probs, cfg.top_k)[1])
            return apply_moe(p, x, cfg)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JMoE, "apply_moe", record)
            JM.forward(params, eager, b)
        return seen

    return [np.asarray(c) for c in jax.jit(choices)(jparams, batch)]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """One JAX init a config, JAX's loss, metrics and gradients."""
    arch = request.param
    jcfg, tcfg = JC.get_config(arch, smoke=True), TC.get_config(arch, smoke=True)
    jparams = _jax_params(arch)
    batch = _batch(jcfg, 2)
    vg = jax.jit(lambda p, b: jax.value_and_grad(JS.lm_loss, has_aux=True)(p, jcfg, b))
    (loss, metrics), grads = vg(jparams, batch)
    return dict(arch=arch, cfg=tcfg, params=_port_tree(jparams, tcfg), batch=batch,
                choices=_jax_choices(jparams, jcfg, batch), loss=float(loss),
                metrics=dict(metrics, loss=loss), grads=_port_tree(grads, tcfg))


def test_loss_and_gradients_match_jax(case):
    cfg = case["cfg"]
    (grads, metrics), choices = _port_choices(
        lambda: TS.grads_and_metrics(case["params"], cfg, _t(case["batch"])))
    _assert_same_choices(choices, case["choices"])
    assert ("mtp_ce" in metrics) == (cfg.mtp_depth > 0)
    _close_metrics(metrics, case["metrics"], case["arch"])
    _close_trees(grads, case["grads"], REL, f"{case['arch']} gradient")
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))


def _jax_step(jcfg, jparams, batch, microbatches):
    """JAX's step under jit, and the clipped gradients its AdamW update is
    handed (returned from the jitted call beside the step's outputs)."""
    update = JS.adamw_update
    step = JS.make_train_step(jcfg, microbatches=microbatches, learning_rate=1e-3)

    def traced(params, opt, b):
        seen = {}

        def capture(grads, state, p, **kw):
            seen["grads"] = grads
            return update(grads, state, p, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JS, "adamw_update", capture)
            out = step(params, opt, b)
        return out + (seen["grads"],)

    return jax.jit(traced)(jparams, JAW.adamw_init(jparams), batch)


@pytest.mark.parametrize("arch,microbatches", [("internlm2_1_8b", 1), ("internlm2_1_8b", 2),
                                               ("mixtral_8x7b", 2)])
def test_step_matches_jax(arch, microbatches):
    jcfg, cfg = JC.get_config(arch, smoke=True), TC.get_config(arch, smoke=True)
    jparams = _jax_params(arch)
    params = _port_tree(jparams, cfg)
    batch = _batch(jcfg, 4, seed=1)
    j_new, j_opt, j_metrics, j_grads = _jax_step(jcfg, jparams, batch, microbatches)
    what = f"{arch} microbatches {microbatches}"

    # the gradient part, then the clip
    grads, metrics = TS.grads_and_metrics(params, cfg, _t(batch), microbatches)
    clipped, norm = TAW.clip_by_global_norm(grads, 1.0)
    _close_metrics(dict(metrics, grad_norm=norm), j_metrics, what)
    _close_trees(clipped, _port_tree(j_grads, cfg), REL, f"{what} clipped gradient")

    # the update on JAX's clipped gradients, against JAX's
    state = TAW.adamw_init(params)
    new, opt = TAW.adamw_update(_port_tree(j_grads, cfg), state, params, lr=1e-3)
    _close_trees(new, _port_tree(j_new, cfg), OPT_REL, f"{what} params", per_leaf=True)
    _close_trees(opt.m, _port_tree(j_opt.m, cfg), OPT_REL, f"{what} m", per_leaf=True)
    _close_trees(opt.v, _port_tree(j_opt.v, cfg), OPT_REL, f"{what} v", per_leaf=True)
    assert int(opt.count) == int(j_opt.count) == 1

    # the whole step_fn: the same metrics, the parameters it hands back
    step = TS.make_train_step(cfg, microbatches=microbatches, learning_rate=1e-3)
    new2, opt2, metrics2 = step(params, state, _t(batch))
    _close_metrics(metrics2, j_metrics, f"{what} step_fn")
    assert all(isinstance(v, torch.Tensor) and v.shape == () for v in metrics2.values())
    assert int(opt2.count) == 1 and tree_paths(new2)[0][0] == tree_paths(params)[0][0]


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in TM._DOTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x7b", "mamba2_130m",
                                  "deepseek_v3_671b"])
def test_remat_modes_give_the_same_gradients(arch):
    cfg = TC.get_config(arch, smoke=True)
    params = TM.init_model(cfg, device="cpu")
    batch = _t(_batch(cfg, 2, seed=2))
    out, counts = {}, {}
    for mode in ("off", "full", "dots"):
        c = dataclasses.replace(cfg, remat=mode != "off",
                                remat_policy="dots" if mode == "dots" else "full")
        with _CountMatmuls() as mm:
            out[mode] = TS.grads_and_metrics(params, c, batch)
        counts[mode] = mm.n
    for mode in ("full", "dots"):
        _close_trees(out[mode][0], out["off"][0], OPT_REL, f"{arch} remat {mode}")
        _close_metrics(out[mode][1], out["off"][1], f"{arch} remat {mode}")
    # "full" recomputes each layer's matmuls in backward; "dots" keeps them
    assert counts["dots"] == counts["off"] < counts["full"], counts
    # serving records nothing, so it takes no checkpoint
    with torch.inference_mode():
        logits, _ = TM.forward(params, cfg, batch)
    assert not logits.requires_grad


def test_microbatches_must_divide_the_batch():
    cfg = TC.get_config("internlm2_1_8b", smoke=True)
    params = TM.init_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        TS.grads_and_metrics(params, cfg, _t(_batch(cfg, 3)), microbatches=2)


def test_loss_decreases_tiny_model():
    """Twin of `tests/test_train_serve.py::test_loss_decreases_tiny_model`."""
    cfg = TC.get_config("internlm2-1.8b", smoke=True)
    params = TM.init_model(cfg, device="cpu")
    opt = TAW.adamw_init(params)
    step = TS.make_train_step(cfg, microbatches=1, learning_rate=3e-3)
    dcfg = TP.DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, seed=0)
    stream = TP.SyntheticStream(dcfg, device="cpu")
    losses = []
    for _ in range(25):
        params, opt, metrics = step(params, opt, next(stream))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
