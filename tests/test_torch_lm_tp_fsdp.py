"""The port's sharded train step with tensor parallelism over "model"
(`dist/tp.py`) and FSDP over "data" (`dist/fsdp.py`), on 2 and 4 gloo
ranks on the CPU (`dist.launch`; the rank functions are in
tests/_torch_lm_ranks.py), each mesh with its config's rules and `fsdp`
on "data":

- one 2-rank launch runs meshes (1, 2) and (2, 1) for every SMOKE config,
  one 4-rank launch (2, 2) for internlm2-1.8b, mixtral-8x7b (also in 2
  microbatches) and deepseek-v3-671b, and (1, 4) for internlm2-1.8b and
  qwen2.5-14b, whose KV heads 4 does not divide (the replicated-KV GQA
  case);
- each against JAX's `make_train_step` outside a mesh on the whole batch
  (`_jax_step`), at tests/test_torch_lm_dist_train.py's bounds: each MoE
  layer's chosen experts equal first, the metrics within 1e-5 relative,
  the clipped gradients (gathered from the ranks' blocks) within 1e-4 x
  max|g|; every rank's metrics equal;
- after a whole step (`run_sharded`, ZeRO-1 moments), the leaves no record
  splits over "model" (norms, the router, FSDP blocks, their moments) are
  bitwise equal across each model view; a rank holds H / M query heads;
  a layer's forward makes 2 "model" all-reduces; an FSDP rank holds part
  of the parameters;
- mamba2-130m and jamba-v0.1-52b on (1, 2) split the SSM's channels and
  heads over "model" (its packed leaves all-gathered, the norm's
  statistic and `w_out`'s outputs all-reduced: 2 "model" all-reduces and
  1 all-gather a mixer) and meet the same bounds;
- a TP + FSDP state written by the (2, 2) ranks restores bit for bit on
  those ranks, on one rank and through JAX's `restore_checkpoint`;
- the update with donated operands (`donate=True`, JAX's `donate_argnums`)
  is bitwise the functional one, on one process and on (2, 2).
"""
import functools
import threading

import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_lm_ranks as R
from repro import configs as JC
from repro.ckpt import checkpoint as JCk
from repro.optim import adamw as JAW
from repro_torch import configs as TC
from repro_torch import dist
from repro_torch.ckpt import checkpoint as TCk
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TAW
from repro_torch.utils import tree_leaves, tree_map
from test_torch_lm_dist_train import GRAD_REL, _bits, _numpy
from test_torch_lm_model import ARCHS
from test_torch_lm_train import (_assert_same_choices, _batch, _close_metrics, _close_trees,
                                 _jax_choices, _jax_params, _jax_step, _port_tree)

ROWS = 4
SSM = ("mamba2_130m", "jamba_v0_1_52b")
#: key -> (arch, microbatches, (data, model)); every mesh runs fsdp on "data"
TWO = {**{f"{a}@1x2": (a, 1, (1, 2)) for a in ARCHS},
       **{f"{a}@2x1": (a, 1, (2, 1)) for a in ARCHS}}
FOUR = {"internlm2_1_8b@2x2": ("internlm2_1_8b", 1, (2, 2)),
        "mixtral_8x7b@2x2": ("mixtral_8x7b", 1, (2, 2)),
        "mixtral_8x7b@2x2/mb2": ("mixtral_8x7b", 2, (2, 2)),
        "deepseek_v3_671b@2x2": ("deepseek_v3_671b", 1, (2, 2)),
        "internlm2_1_8b@1x4": ("internlm2_1_8b", 1, (1, 4)),
        "qwen2_5_14b@1x4": ("qwen2_5_14b", 1, (1, 4))}
CKPT_ARCH = "mixtral_8x7b"


@functools.lru_cache(maxsize=None)
def _reference(arch, microbatches):
    """JAX's one-device step on the whole batch: (metrics, clipped
    gradients in the port's layout, each MoE layer's chosen experts)."""
    jcfg = JC.get_config(arch, smoke=True)
    batch = _batch(jcfg, ROWS)
    _, _, metrics, grads = _jax_step(jcfg, _jax_params(arch), batch, microbatches)
    choices = _jax_choices(_jax_params(arch), jcfg, batch) if microbatches == 1 else None
    return metrics, _port_tree(grads, TC.get_config(arch, smoke=True)), choices


def _runs(table):
    out = {}
    for key, (arch, mb, (_, model)) in table.items():
        jcfg = JC.get_config(arch, smoke=True)
        out[key] = (arch, _numpy(_jax_params(arch)), _batch(jcfg, ROWS), mb, model, True)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 2-rank and the 4-rank launch, run on a thread while this process
    computes JAX's references (the ranks need JAX's weights only)."""
    ckpt = str(tmp_path_factory.mktemp("tp_fsdp") / "ckpt")
    jcfg = JC.get_config(CKPT_ARCH, smoke=True)
    two, four = _runs(TWO), _runs(FOUR)
    ckpt_args = (CKPT_ARCH, _numpy(_jax_params(CKPT_ARCH)), _batch(jcfg, ROWS), ckpt)
    out, failed = {}, []

    def launches():
        try:
            out.update(dist.launch(R.sharded_cases, 2, args=(two,), device="cpu", threads=1,
                                   timeout=600))
            out.update(dist.launch(R.sharded_cases, 4, args=(four, ckpt_args), device="cpu",
                                   threads=1, timeout=600))
        except Exception as e:      # raised again on the test's thread
            failed.append(e)

    thread = threading.Thread(target=launches)
    thread.start()
    for arch, mb, _ in {**TWO, **FOUR}.values():
        _reference(arch, mb)
    thread.join()
    if failed:
        raise failed[0]
    out["ckpt_dir"] = ckpt
    return out


@pytest.mark.parametrize("key", list(TWO) + list(FOUR))
def test_sharded_step_matches_jax(ranks, key):
    arch, mb, (data, model) = {**TWO, **FOUR}[key]
    got = ranks[key]
    assert got["shape"] == {"data": data, "model": model}
    assert got["split"] == (data > 1)
    metrics, grads, choices = _reference(arch, mb)
    if choices is not None:
        _assert_same_choices([c.numpy() for c in got["choices"]], choices)
    what = f"{arch} on a (data {data}, model {model}) mesh in {mb} microbatch(es)"
    _close_metrics(dict(got["metrics"], grad_norm=got["norm"]), metrics, what)
    _close_trees(got["grads"], grads, GRAD_REL, f"{what} gradient")
    per_rank = got["per_rank"]
    assert per_rank.shape[0] == data * model
    assert all(torch.equal(per_rank[0], r) for r in per_rank), per_rank
    # after the update: what no record splits over "model" is the same bits
    # on every rank of a model view
    sums = got["model_sums"]
    assert len(sums) == model and all(s == sums[0] for s in sums)
    cfg = TC.get_config(arch, smoke=True)
    if "wq_block" in got:
        heads = cfg.n_heads // model if cfg.n_heads % model == 0 else cfg.n_heads
        assert got["wq_block"] == (cfg.d_model, heads, cfg.head_dim), got["wq_block"]
    # one all-reduce after each of the first layer's modules that splits
    # (phi3-medium's 5 heads stay whole on 2 ranks, its MLP splits), 2 for
    # an SSM mixer (the norm's statistic, `w_out`), whose packed leaves come
    # by one all-gather
    if model > 1:
        mixer, mlp = cfg.layer_spec(0)
        calls = 2 if mixer == "ssm" else int(cfg.n_heads % model == 0)
        if mlp != "none":
            d_ff = (cfg.d_ff_dense or cfg.d_ff) if mlp == "dense" else cfg.moe.d_ff_expert
            calls += int(d_ff % model == 0)
        assert got["layer_calls"] == (calls, int(mixer == "ssm")), got["layer_calls"]
        assert calls == 2 or arch in ("phi3_medium_14b",) + SSM
    else:
        assert got["layer_calls"] == (0, 0)
    # a rank holds its blocks only: FSDP splits the layers over "data", and
    # the vocabulary splits over "model"
    total = sum(g.numel() for g in tree_leaves(grads))
    assert got["held"] < total, (got["held"], total)


def test_tp_fsdp_checkpoint_restores_on_one_rank_and_in_jax(ranks):
    c = ranks["ckpt"]
    assert c["restored_blocks_equal"] and c["both_axes"] > 0
    assert c["donated_equal"]       # the (2, 2) step with donated operands: the same bits
    want = c["global_state"]
    (p1, o1), step, extra = TCk.restore_checkpoint(ranks["ckpt_dir"], want)
    assert step == 1 and extra == {"arch": CKPT_ARCH}
    assert [_bits(a) for a in tree_leaves((p1, o1))] == [_bits(b) for b in tree_leaves(want)]
    rep_p = want[0]
    like = jax.tree.map(lambda x: jnp.zeros(x.shape, x.numpy().dtype), tree_map(lambda x: x,
                                                                               rep_p))
    j_state = JAW.AdamWState(m=jax.tree.map(lambda x: x.astype(jnp.float32), like),
                             v=jax.tree.map(lambda x: x.astype(jnp.float32), like),
                             count=jnp.zeros((), jnp.int32))
    (jp, jo), jstep, _ = JCk.restore_checkpoint(ranks["ckpt_dir"], (like, j_state))
    assert jstep == 1
    assert [_bits(a) for a in jax.tree.leaves((jp, jo))] == [_bits(b)
                                                              for b in tree_leaves(want)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_donated_update_is_bitwise_the_functional_one(dtype):
    cfg = TC.get_config("internlm2_1_8b", smoke=True)
    gen = torch.Generator().manual_seed(3)
    params = tree_map(lambda p: p.to(dtype), TM.init_model(cfg, device="cpu", generator=gen))
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen).to(dtype), params)
    state = TAW.adamw_init(params)
    for _ in range(2):      # the second from nonzero moments
        want_p, want_s = TAW.adamw_update(grads, state, params, lr=1e-3)
        got_p, got_s = TAW.adamw_update(grads, tree_map(torch.clone, state),
                                        tree_map(torch.clone, params), lr=1e-3, donate=True)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves((got_p, got_s)),
                                                      tree_leaves((want_p, want_s))))
        params, state = want_p, want_s
