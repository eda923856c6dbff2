"""The port's prefill and decode steps on (data, model) meshes, in the
layouts of JAX's dry run (`launch/dryrun.py::_rules_for`), against JAX's
one-device `make_prefill_step` / `make_decode_step` on the CPU: 2 and 4
gloo ranks (`dist.launch`; the rank functions are in
tests/_torch_lm_ranks.py), float32 SMOKE configs on JAX's weights
(`convert.model_params_from_jax`):

- every SMOKE config on (1, 2) under the default rules (the config's
  `rules_override`); internlm2, mixtral, deepseek-v3 and jamba on (2, 2);
  internlm2 and qwen2.5 (KV heads 4 does not divide) on (1, 4);
- internlm2, mixtral, deepseek-v3, mamba2 and jamba on (2, 2) through a
  prefill in prefill_32k's layout (the cache split by sequence over
  "model") then decode in decode_32k's (flash decoding, heads whole, FSDP
  over "data");
- mixtral, mamba2 and jamba on (2, 2) in long_500k's layout at batch 1
  (the sequence over "data").

A sharded prefill (`run_prefill`) then 8 greedy decode steps
(`run_decode`), each against JAX's: every MoE layer's chosen experts equal
first, then the logits of every step within 1e-4 x max|logits|, the
tokens equal, every cache gathered from its records within 1e-4 x its
max after the prefill and after the last step, every rank's logits and
tokens the same bits; one layout's `greedy_generate` gives the same
tokens. The prompts put tokens in both halves of a split cache, and
mixtral's (window 64) ring buffer wraps during decode. Also: the rule
copy `repro_torch.launch.dryrun._rules_for` equals JAX's for every config
and shape; the caches' records in each shape's layout on the 16 x 16 mesh
are leaf for leaf JAX's, and `init_cache` with records allocates each
rank's blocks; a decode step started from JAX's own cache
(`convert.caches_from_jax`) matches JAX's on (2, 2).
"""
import dataclasses
import functools
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_ranks as R
from repro import configs as JC
from repro import dist as JDist
from repro.dist import shardings as JSh
from repro.launch import dryrun as JD
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serve.engine import make_decode_step as j_decode_step
from repro.serve.engine import make_prefill_step as j_prefill_step
from repro_torch import configs as TC
from repro_torch import dist
from repro_torch.convert import caches_from_jax
from repro_torch.dist import shardings as dsh
from repro_torch.launch import dryrun as TD
from repro_torch.models import model as TM
from repro_torch.utils import tree_leaves, tree_paths
from test_torch_lm_dist import _jax_records
from test_torch_lm_dist_train import _numpy
from test_torch_lm_model import ARCHS, _unstack_caches
from test_torch_lm_train import _jax_params

REL, STEPS, ROWS = 1e-4, 8, 4
#: arch -> (prompt positions, max_len): the prompt past the middle of a
#: split cache; mixtral's past its window (64), so the ring buffer wraps
PROMPTS = {a: (16, 24) for a in ARCHS}
PROMPTS["mixtral_8x7b"] = (60, 96)
LONG = ("mixtral_8x7b", "mamba2_130m", "jamba_v0_1_52b")
SPLIT = ("internlm2_1_8b", "mixtral_8x7b", "deepseek_v3_671b", "mamba2_130m", "jamba_v0_1_52b")
#: key -> (arch, (data, model), (prefill layout, decode layout), rows)
TWO = {f"{a}@1x2": (a, (1, 2), ("default", "default"), ROWS) for a in ARCHS}
FOUR = {
    **{f"{a}@2x2": (a, (2, 2), ("default", "default"), ROWS)
       for a in ("internlm2_1_8b", "mixtral_8x7b", "deepseek_v3_671b", "jamba_v0_1_52b")},
    **{f"{a}@1x4": (a, (1, 4), ("default", "default"), ROWS)
       for a in ("internlm2_1_8b", "qwen2_5_14b")},
    **{f"{a}@2x2/prefill_32k+decode_32k": (a, (2, 2), ("prefill_32k", "decode_32k"), ROWS)
       for a in SPLIT},
    **{f"{a}@2x2/long_500k": (a, (2, 2), ("long_500k", "long_500k"), 1) for a in LONG},
}
CASES = {**TWO, **FOUR}
#: the decode step started from JAX's cache: (arch, model axis, layout)
FROM_JAX = ("jamba_v0_1_52b", 2, "decode_32k")


def _batch(arch, rows, seed=1):
    """numpy prompts of the arch's prompt length (text tokens after the
    vision tokens for "patches")."""
    cfg = JC.get_config(arch, smoke=True)
    S, _ = PROMPTS[arch]
    rng = np.random.default_rng(seed)
    tail = (cfg.n_codebooks,) if cfg.frontend == "codebooks" else ()
    s_txt = S - cfg.vision_tokens if cfg.frontend == "patches" else S
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, s_txt) + tail).astype(np.int32)}
    if cfg.frontend == "patches":
        batch["patch_embeds"] = rng.standard_normal(
            (rows, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _recording(fn, seen):
    """fn under JAX's MoE with each layer's top-k experts appended to
    `seen` (traced inside the caller's jit)."""
    apply_moe = JMoE.apply_moe

    def record(p, x, cfg):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        seen.append(jax.lax.top_k(probs, cfg.top_k)[1])
        return apply_moe(p, x, cfg)

    def run(*args):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JMoE, "apply_moe", record)
            return fn(*args)

    return run


@functools.lru_cache(maxsize=None)
def _reference(arch, rows):
    """JAX's one-device greedy serve (layers unrolled, so each MoE layer's
    choices are recorded): per step the logits, tokens and choices; the
    caches after the prefill and after the last step (the port's layer
    order)."""
    jcfg = dataclasses.replace(JC.get_config(arch, smoke=True), unroll_layers=True)
    params = _jax_params(arch)
    _, max_len = PROMPTS[arch]
    batch = {k: jnp.asarray(v) for k, v in _batch(arch, rows).items()}

    @jax.jit
    def prefill(p, b):
        seen = []
        out = _recording(j_prefill_step(jcfg, max_len), seen)(p, b)
        return out, seen

    @jax.jit
    def decode(p, tok, caches):
        seen = []
        out = _recording(j_decode_step(jcfg), seen)(p, tok, caches)
        return out, seen

    (logits, caches), seen = prefill(params, batch)
    pre = _unstack_caches(caches, jcfg)
    out = dict(logits=[np.asarray(logits)], choices=[[np.asarray(c) for c in seen]],
               pre_caches=pre, jcaches=jax.tree.map(np.asarray, caches))
    toks = [np.asarray(jnp.argmax(logits, axis=-1))]
    for _ in range(STEPS):
        (logits, caches), seen = decode(params, jnp.argmax(logits, axis=-1).astype(jnp.int32),
                                        caches)
        out["logits"].append(np.asarray(logits))
        out["choices"].append([np.asarray(c) for c in seen])
        toks.append(np.asarray(jnp.argmax(logits, axis=-1)))
    out["tokens"] = np.stack(toks, axis=1)
    out["post_caches"] = _unstack_caches(caches, jcfg)
    return out


def _runs(table):
    out = {}
    for key, (arch, (_, model), layouts, rows) in table.items():
        out[key] = (arch, _numpy(_jax_params(arch)), _batch(arch, rows), PROMPTS[arch][1],
                    STEPS, model, layouts)
    return out


@pytest.fixture(scope="module")
def ranks():
    """The 2-rank and the 4-rank launch, run on a thread while this process
    computes JAX's references (the ranks need JAX's weights only)."""
    two, four = _runs(TWO), _runs(FOUR)
    arch, model, layout = FROM_JAX
    ref = _reference(arch, ROWS)        # the cache the 4-rank launch starts from
    from_jax = (arch, _numpy(_jax_params(arch)),
                caches_from_jax(ref["jcaches"], TC.get_config(arch, smoke=True), device="cpu"),
                ref["tokens"][:, 0], PROMPTS[arch][1], model, layout)
    out, failed = {}, []

    def launches():
        try:
            out.update(dist.launch(R.serve_cases, 2, args=(two,), device="cpu", threads=1,
                                   timeout=600))
            out.update(dist.launch(R.serve_cases, 4, args=(four, from_jax), device="cpu",
                                   threads=1, timeout=600))
        except Exception as e:      # raised again on the test's thread
            failed.append(e)

    thread = threading.Thread(target=launches)
    thread.start()
    for a, _, _, rows in CASES.values():
        _reference(a, rows)
    thread.join()
    if failed:
        raise failed[0]
    return out


def _close(got, want, bound, what):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    dev = np.abs(got - want).max() if want.size else 0.0
    assert dev <= bound, f"{what}: max dev {dev:.3e} > {bound:.3e}"


def _close_caches(got, want, what):
    """The port's whole caches ({"layers": [...]}) against JAX's unstacked
    (fields, pos) a layer, each field within 1e-4 x its max."""
    assert len(got["layers"]) == len(want)
    for i, (c, (arrays, pos)) in enumerate(zip(got["layers"], want)):
        for k, w in arrays.items():
            _close(getattr(c, k), w, REL * max(np.abs(w).max(), 1e-30), f"{what} layer {i} {k}")
        assert getattr(c, "pos", None) == pos, (what, i)


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_serve_matches_jax(ranks, key):
    arch, (data, model), layouts, rows = CASES[key]
    got, want = ranks[key], _reference(arch, rows)
    assert got["shape"] == {"data": data, "model": model}
    what = f"{arch} on (data {data}, model {model}), {layouts[0]} then {layouts[1]}"
    for s, (g, w) in enumerate(zip(got["choices"], want["choices"])):
        assert len(g) == len(w), (what, s)
        for i, (a, b) in enumerate(zip(g, w)):
            assert np.array_equal(a.numpy(), b), f"{what} step {s}: MoE layer {i} chose " \
                                                 "other experts"
    assert len(got["logits"]) == STEPS + 1
    for s, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        _close(g, w, REL * np.abs(w).max(), f"{what} step {s} logits")
    assert np.array_equal(got["tokens"].numpy(), want["tokens"]), what
    _close_caches(got["pre_caches"], want["pre_caches"], f"{what} prefill cache")
    _close_caches(got["post_caches"], want["post_caches"], f"{what} decode cache")
    sums = got["sums"]
    assert len(sums) == data * model and all(r == sums[0] for r in sums), what
    if "greedy" in got:
        assert torch.equal(got["greedy"], got["tokens"]), what
    cfg = TC.get_config(arch, smoke=True)
    held, blocks = got["held"]          # a rank holds its caches' blocks only
    full = sum(x.numel() for c in got["post_caches"]["layers"] for x in c
               if isinstance(x, torch.Tensor))
    assert held == blocks and (held < full or layouts[0] == "default"), (what, held, blocks)
    if layouts == ("default", "default") and cfg.frontend == "tokens" and \
            cfg.layer_spec(0) == ("attn", "dense") and cfg.n_heads % model == 0 and data == 1:
        # a decode step's "model" all-reduces: after `wo` and `w_down` a
        # layer, the embedding lookup's and the head's gather
        assert got["calls"].get("model", 0) == 2 * cfg.n_layers + 2, got["calls"]


def test_decode_from_jax_cache(ranks):
    """A decode step on (2, 2) in decode_32k's layout started from JAX's
    prefill cache, carried across by `convert.caches_from_jax`."""
    arch = FROM_JAX[0]
    want = _reference(arch, ROWS)
    _close(ranks["from_jax"], want["logits"][1], REL * np.abs(want["logits"][1]).max(),
           f"{arch}: the first decode step from JAX's cache")


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_rules_for_matches_jax(arch):
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    for shape in JC.SHAPES:
        assert TD._rules_for(cfg, shape) == JD._rules_for(jcfg, shape), (arch, shape)


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_cache_records_match_jax_in_the_serving_layouts(arch):
    """`M.cache_records` at each shape of the dry run (its global batch and
    sequence) on the 16 x 16 mesh under `_rules_for`, leaf for leaf JAX's
    `cache_shardings` of `init_cache`, whose stacked dim is never split;
    on a (2, 2) mesh, `init_cache(records=)` allocates each leaf's block."""
    jcfg, cfg = JC.get_config(arch), TC.get_config(arch)
    shape = {"data": 16, "model": 16}
    jmesh = SimpleNamespace(shape=shape)
    mesh = dist.Mesh(axes=tuple(shape), sizes=tuple(shape.values()))
    for name, sh in JC.SHAPES.items():
        B, S = sh["global_batch"], sh["seq_len"]
        rules = TD._rules_for(cfg, name)
        jcaches = jax.eval_shape(lambda: JM.init_cache(None, jcfg, B, S))
        with dist.mesh_context(mesh, rules=rules):
            got = dict(tree_paths(TM.cache_records(cfg, B, S)))
        want = dict(tree_paths(_jax_records(jcaches, jcfg, lambda leaf, names: tuple(
            JDist.resolve_spec(JSh._align(names, leaf.ndim), leaf.shape, jmesh, rules)))))
        assert got.keys() == want.keys(), (arch, name)
        for path, w in want.items():
            if path.endswith("pos"):        # a Python int here, a stacked array in JAX
                assert set(w.spec) <= {None} and got[path].spec == (), (arch, name, path)
                continue
            assert w.stack is None and tuple(got[path].spec) == w.spec, (arch, name, path)
    small = TC.get_config(arch, smoke=True)
    for name in JC.SHAPES:
        with dist.mesh_context(dist.Mesh(rank=3, axes=("data", "model"), sizes=(2, 2)),
                               rules=TD._rules_for(small, name)):
            recs = TM.cache_records(small, 4, 24)
        caches = TM.init_cache(None, small, 4, 24, records=recs, device="cpu")
        blocks = [tuple(x.shape) for x in tree_leaves(caches) if isinstance(x, torch.Tensor)]
        assert blocks == [dsh.block_shape(r) for r in tree_leaves(recs) if r.shape], (arch, name)
