"""The port's LM (`repro_torch/models/model.py`, `repro_torch/configs/`,
the LM half of `repro_torch/serve/engine.py`) against JAX's on all ten
SMOKE configs (float32), with JAX's weights carried across by
`convert.model_params_from_jax`: forward logits and hidden states, the
MoE aux loss and every MoE layer's chosen experts (equal, asserted before
any output is compared, so that a flipped choice fails as a flip), prefill
logits and caches (KV, MLA latent, SSM conv tail and state), 4
teacher-forced decode steps, each within 1e-4 x max|logits|; greedy
tokens equal to JAX's, where every step's top-2 logit gap exceeds twice
that bound (so a near-tie fails loudly); the port's own prefill + decode
against its forward at JAX's 2e-3; deepseek-v3's `mtp_logits`; every
config field and every input spec equal to JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serve.engine import greedy_generate as j_greedy
from repro.serve.engine import make_decode_step as j_decode_step
from repro.serve.engine import make_prefill_step as j_prefill_step
from repro_torch import configs as TC
from repro_torch.convert import model_params_from_jax
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.serve.engine import greedy_generate

ARCHS = ["internlm2_1_8b", "deepseek_7b", "phi3_medium_14b", "qwen2_5_14b",
         "musicgen_large", "internvl2_26b", "mixtral_8x7b", "mamba2_130m",
         "jamba_v0_1_52b", "deepseek_v3_671b"]
B, S, STEPS = 2, 12, 4
REL = 1e-4


def _inputs(cfg, seed):
    """numpy prompts of S positions (S - vision_tokens text tokens for
    "patches"), and STEPS teacher-forced next tokens."""
    rng = np.random.default_rng(seed)
    tail = (cfg.n_codebooks,) if cfg.frontend == "codebooks" else ()
    s_txt = S - cfg.vision_tokens if cfg.frontend == "patches" else S
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s_txt) + tail).astype(np.int32)}
    if cfg.frontend == "patches":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    nxt = rng.integers(0, cfg.vocab_size, (STEPS, B) + tail).astype(np.int32)
    return batch, nxt


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _cache_fields(c):
    """A layer's cache as {field: numpy array} plus its int pos (None for
    an SSM cache, which has none)."""
    arrays = {k: v for k, v in c._asdict().items() if k != "pos"}
    pos = getattr(c, "pos", None)
    return arrays, pos


def _unstack_caches(jcaches, cfg):
    """JAX's caches ({"prefix": [...], "body": [stacked]}) in the port's
    layer order: (fields, pos) a layer."""
    out = [None] * cfg.n_layers
    for i, c in enumerate(jcaches["prefix"]):
        arrays, pos = _cache_fields(c)
        out[i] = ({k: np.asarray(v) for k, v in arrays.items()},
                  None if pos is None else int(pos))
    for j, c in enumerate(jcaches["body"]):
        arrays, pos = _cache_fields(c)
        for r in range(cfg.n_periods):
            out[cfg.dense_prefix + r * cfg.period + j] = (
                {k: np.asarray(v)[r] for k, v in arrays.items()},
                None if pos is None else int(np.asarray(pos)[r]))
    return out


def _jax_choices(jparams, jcfg, batch):
    """JAX's forward (layers unrolled and not rematerialized, so each MoE
    layer runs on concrete arrays) and its MoE layers' top-k experts."""
    seen = []
    apply_moe = JMoE.apply_moe

    def record(params, x, cfg):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ params["router"], axis=-1)
        seen.append(np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]))
        return apply_moe(params, x, cfg)

    eager = dataclasses.replace(jcfg, remat=False, unroll_layers=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMoE, "apply_moe", record)
        out = JM.forward(jparams, eager, _j(batch), return_hidden=True)
    return out, seen


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """One JAX init a config and every JAX result the tests compare with."""
    arch = request.param
    jcfg, tcfg = JC.get_config(arch, smoke=True), TC.get_config(arch, smoke=True)
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    batch, nxt = _inputs(jcfg, 1)
    max_len = S + STEPS + 4
    (logits, aux, hidden), choices = _jax_choices(jparams, jcfg, batch)
    mtp = (np.asarray(JM.mtp_logits(jparams, jcfg, hidden, _j(batch)))
           if jcfg.mtp_depth else None)
    pre_logits, caches = JM.prefill(jparams, jcfg, _j(batch), max_len=max_len)
    pre_caches = _unstack_caches(caches, jcfg)
    decode = jax.jit(j_decode_step(jcfg))
    step_logits, step_caches = [], []
    for tok in nxt:
        lg, caches = decode(jparams, jnp.asarray(tok), caches)
        step_logits.append(np.asarray(lg))
        step_caches.append(_unstack_caches(caches, jcfg))
    # JAX's greedy path with its logits, for the top-2 gaps
    prefill = jax.jit(j_prefill_step(jcfg, max_len))
    lg, gcaches = prefill(jparams, _j(batch))
    greedy_logits = [np.asarray(lg)]
    for _ in range(STEPS):
        lg, gcaches = decode(jparams, jnp.argmax(lg, axis=-1).astype(jnp.int32), gcaches)
        greedy_logits.append(np.asarray(lg))
    return dict(
        arch=arch, jcfg=jcfg, cfg=tcfg, jparams=jparams, params=tparams, batch=batch,
        nxt=nxt, max_len=max_len, logits=np.asarray(logits), hidden=np.asarray(hidden),
        aux=float(aux), choices=choices, mtp=mtp,
        scale=float(np.abs(np.asarray(logits)).max()), pre_logits=np.asarray(pre_logits),
        pre_caches=pre_caches,
        step_logits=step_logits, step_caches=step_caches, greedy_logits=greedy_logits)


def _close(got, want, bound, what):
    got = got.detach().to(torch.float64).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    dev = np.abs(got - want).max()
    assert dev <= bound, f"{what}: max dev {dev:.3e} > {bound:.3e}"


def _close_caches(tcaches, jcaches, bound, what):
    assert len(tcaches["layers"]) == len(jcaches)
    for i, (tc, (arrays, pos)) in enumerate(zip(tcaches["layers"], jcaches)):
        got, tpos = _cache_fields(tc)
        assert got.keys() == arrays.keys(), (what, i)
        for k, want in arrays.items():
            _close(got[k], want, bound, f"{what} layer {i} {k}")
        assert tpos == pos, (what, i, tpos, pos)


def _port_forward(case):
    """The port's forward, with each MoE layer's top-k experts."""
    seen = []
    route = TMoE.route

    def record(params, x, cfg):
        out = route(params, x, cfg)
        seen.append(out[2].numpy())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TMoE, "route", record)
        out = TM.forward(case["params"], case["cfg"], _t(case["batch"]), return_hidden=True)
    return out, seen


def test_forward_logits_and_hidden_match_jax(case):
    (logits, aux, hidden), choices = _port_forward(case)
    n_moe = sum(case["cfg"].layer_spec(i)[1] == "moe" for i in range(case["cfg"].n_layers))
    assert len(choices) == len(case["choices"]) == n_moe
    for i, (got, want) in enumerate(zip(choices, case["choices"])):
        assert np.array_equal(got, want), f"MoE layer {i}: the chosen experts differ"
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    _close(aux, case["aux"], 1e-5 * max(abs(case["aux"]), 1.0), "aux")
    if not n_moe:
        assert float(aux) == 0.0
    bound = REL * case["scale"]
    _close(logits, case["logits"], bound, "logits")
    _close(hidden, case["hidden"], REL * np.abs(case["hidden"]).max(), "hidden")
    if case["mtp"] is not None:
        mtp = TM.mtp_logits(case["params"], case["cfg"], hidden, _t(case["batch"]))
        _close(mtp, case["mtp"], REL * np.abs(case["mtp"]).max(), "mtp_logits")


def test_prefill_and_teacher_forced_decode_match_jax(case):
    cfg, params, bound = case["cfg"], case["params"], REL * case["scale"]
    logits, caches = TM.prefill(params, cfg, _t(case["batch"]), max_len=case["max_len"])
    _close(logits, case["pre_logits"], bound, "prefill logits")
    _close_caches(caches, case["pre_caches"], bound, "prefill cache")
    for s, tok in enumerate(case["nxt"]):
        logits, caches = TM.decode_step(params, cfg, torch.tensor(tok), caches)
        _close(logits, case["step_logits"][s], bound, f"decode step {s} logits")
        _close_caches(caches, case["step_caches"][s], bound, f"decode step {s} cache")


def test_greedy_generate_matches_jax(case):
    bound = REL * case["scale"]
    for s, lg in enumerate(case["greedy_logits"]):
        top2 = np.sort(lg, axis=-1)[..., -2:]
        gap = (top2[..., 1] - top2[..., 0]).min()
        assert gap > 2 * bound, f"step {s}: top-2 logit gap {gap:.3e} <= 2 x {bound:.3e}"
    want = j_greedy(case["jparams"], case["jcfg"], _j(case["batch"]), steps=STEPS,
                    max_len=case["max_len"])
    got = greedy_generate(case["params"], case["cfg"], _t(case["batch"]), steps=STEPS,
                          max_len=case["max_len"])
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_own_prefill_decode_matches_own_forward(case):
    """JAX's arch-smoke check run on the port alone: decoding the last
    token after a prefill of the rest gives the forward's last logits."""
    cfg, params = case["cfg"], case["params"]
    batch = _t(case["batch"])
    full, _ = TM.forward(params, cfg, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    _, caches = TM.prefill(params, cfg, pre, max_len=S + 4)
    step, _ = TM.decode_step(params, cfg, batch["tokens"][:, -1], caches)
    torch.testing.assert_close(step, full[:, -1], atol=2e-3, rtol=2e-3)


def _same_field(jv, tv):
    if isinstance(tv, torch.dtype):
        return np.dtype(jv).name == str(tv).removeprefix("torch.")
    if isinstance(jv, tuple) and hasattr(jv, "_fields"):      # MoE/SSM/MLA configs
        return type(jv).__name__ == type(tv).__name__ and tuple(jv) == tuple(tv)
    return jv == tv


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_config_fields_match_jax(arch):
    assert TC.ARCHS == JC.ARCHS and TC.ALIASES == JC.ALIASES and TC.SHAPES == JC.SHAPES
    for smoke in (False, True):
        jc, tc = JC.get_config(arch, smoke), TC.get_config(arch, smoke)
        names = [f.name for f in dataclasses.fields(jc)]
        assert names == [f.name for f in dataclasses.fields(tc)]
        for name in names:
            assert _same_field(getattr(jc, name), getattr(tc, name)), (arch, smoke, name)
        assert (jc.period, jc.n_body) == (tc.period, tc.n_body)
        assert [jc.layer_spec(i) for i in range(jc.n_layers)] == \
            [tc.layer_spec(i) for i in range(tc.n_layers)]
    assert dataclasses.asdict(JC.get_meta(arch)) == dataclasses.asdict(TC.get_meta(arch))


@pytest.mark.parametrize("shape", list(JC.SHAPES))
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_input_specs_match_jax(arch, shape):
    jspec = JC.input_specs(JC.get_config(arch), shape)
    tspec = TC.input_specs(TC.get_config(arch), shape)
    assert jspec.keys() == tspec.keys()
    for k in jspec:
        assert tspec[k].device.type == "meta"
        assert tuple(jspec[k].shape) == tuple(tspec[k].shape)
        assert np.dtype(jspec[k].dtype).name == str(tspec[k].dtype).removeprefix("torch.")
