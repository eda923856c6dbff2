"""The port's data-parallel LM training (`train/step.py` under a mesh,
`dist/shardings.py`, `dist/zero.py`, `dist/pipeline.py`, checkpoints and
the launcher across ranks) on 2 and 4 gloo ranks on the CPU
(`dist.launch`; the rank functions are in tests/_torch_lm_ranks.py):

- the 2-rank step's gradients and metrics (each rank its block of the
  batch, all-reduced) against JAX's `make_train_step` outside a mesh on the
  whole batch, for every SMOKE config in float32: each MoE layer's chosen
  experts equal first, then the loss and metrics within 1e-5 relative and
  the clipped gradients within 1e-4 x max|g|; the same at a batch 2 does
  not divide (every rank computes it whole) and in 2 microbatches; the
  ranks' metrics equal;
- ZeRO-1 (`run_sharded` with moments by `zero1_shardings`) bitwise the
  replicated 2-rank update over two bf16 steps, each rank holding its
  block of m and v; the same two steps with the parameters' records over
  "data" (FSDP: each rank its half of the layers) bitwise it too;
- the ZeRO-1 state checkpointed by 2 ranks, restored on 2 (the same
  blocks), on 1 rank, and by JAX's `restore_checkpoint`, bit for bit;
- `pipeline_apply` on 2 and 4 ranks against the port's and JAX's
  `sequential_reference` (1e-10, float64), M + S - 1 hand-offs;
- `dist.launch(train.train, 2, ...)`: a fault survived, checkpoints
  written once, and the step-10 checkpoint resumed on one rank and on the
  same 2 ranks, each within 1e-4 of the 2-rank run's losses.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_ranks as R
from repro import configs as JC
from repro.ckpt import checkpoint as JCk
from repro.dist import pipeline as JPipe
from repro.optim import adamw as JAW
from repro_torch import configs as TC
from repro_torch import dist
from repro_torch.ckpt import checkpoint as TCk
from repro_torch.dist import shardings as dsh
from repro_torch.dist.zero import zero1_shardings
from repro_torch.launch import train as launcher
from repro_torch.models import model as TM
from repro_torch.utils import tree_leaves, tree_map
from test_torch_lm_model import ARCHS
from test_torch_lm_train import (_assert_same_choices, _batch, _close_metrics, _close_trees,
                                 _jax_choices, _jax_params, _jax_step, _port_tree)

GRAD_REL = 1e-4      # x max|g|: the 2-rank gradients against JAX's one-device step
#: beyond every SMOKE config at batch 4 in one microbatch: (arch, batch,
#: microbatches), a batch 2 does not divide, and 2 microbatches of 2 rows
#: (a row a rank; the MoE's aux a microbatch over both ranks' rows)
MORE = {"odd": ("mixtral_8x7b", 3, 1), "mb2": ("internlm2_1_8b", 4, 2),
        "moe_mb2": ("mixtral_8x7b", 4, 2)}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_case(arch, rows):
    jcfg = JC.get_config(arch, smoke=True)
    return jcfg, _numpy(_jax_params(arch)), _batch(jcfg, rows)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One 2-rank launch: every SMOKE config's data-parallel step, the odd
    batch, ZeRO-1 and its checkpoint, the 2-stage pipeline; and one 4-rank
    launch of the 4-stage pipeline."""
    cases = {arch: (arch,) + _jax_case(arch, 4)[1:] + (1,) for arch in ARCHS}
    for key, (arch, rows, mb) in MORE.items():
        cases[key] = (arch,) + _jax_case(arch, rows)[1:] + (mb,)
    _, jparams, _ = _jax_case("internlm2_1_8b", 4)
    jcfg = JC.get_config("internlm2_1_8b", smoke=True)
    zero_batches = [_batch(jcfg, 4, seed=s) for s in (1, 2)]
    ckpt = str(tmp_path_factory.mktemp("zero1") / "ckpt")
    pipe2 = R.pipeline_problem(2)
    out = dist.launch(R.all_cases, 2, args=(cases, ("internlm2_1_8b", jparams, zero_batches,
                                                   ckpt), pipe2),
                      device="cpu", threads=1, timeout=600)
    pipe4 = R.pipeline_problem(4)
    out["pipe4"] = dist.launch(R.pipeline, 4, args=pipe4, device="cpu", threads=1,
                               timeout=240)
    out.update(ckpt=ckpt, pipe_inputs={2: pipe2, 4: pipe4}, zero_batches=zero_batches)
    return out


@pytest.mark.parametrize("key", ARCHS + list(MORE))
def test_data_parallel_step_matches_jax(ranks, key):
    arch, rows, mb = MORE.get(key, (key, 4, 1))
    jcfg, jparams, batch = _jax_case(arch, rows)
    cfg = TC.get_config(arch, smoke=True)
    got = ranks["dp"][key]
    assert got["split"] == (rows % 2 == 0)
    if mb == 1:
        _assert_same_choices([c.numpy() for c in got["choices"]],
                             _jax_choices(_jax_params(arch), jcfg, batch))
    _, _, j_metrics, j_grads = _jax_step(jcfg, _jax_params(arch), batch, mb)
    what = f"{arch} batch {rows} in {mb} microbatch(es) on 2 ranks"
    _close_metrics(dict(got["metrics"], grad_norm=got["norm"]), j_metrics, what)
    _close_trees(got["grads"], _port_tree(j_grads, cfg), GRAD_REL, f"{what} gradient")
    per_rank = got["per_rank"]
    assert per_rank.shape[0] == 2 and torch.equal(per_rank[0], per_rank[1]), per_rank


def test_zero1_is_bitwise_the_replicated_update(ranks):
    z = ranks["zero"]
    assert z["params_equal"] and z["moments_equal"]
    assert z["checksums"][0] == z["checksums"][1]
    rep_m, z_m = z["metrics"]
    assert all(torch.equal(rep_m[k], z_m[k]) for k in rep_m)
    # rank 0 holds its block of every moment: half of each widened leaf, and
    # every layer of its half of the stack (the widening lands there)
    cfg = TC.get_config("internlm2_1_8b", smoke=True)
    params = TM.init_model(cfg, device="meta", generator=torch.Generator())
    with dist.mesh_context(dist.Mesh(axes=("data", "model"), sizes=(2, 1))):
        m_sh = zero1_shardings(dsh.params_shardings(params, cfg), params)
    want = sum(int(np.prod(dsh.block_shape(r))) for r in tree_leaves(m_sh))
    held, total = z["moment_bytes"]
    assert held == want and 2 * held == total, (held, want, total)
    assert z["stacked_moments"] > 0
    # FSDP ran: the records split the layers over "data", a rank held half
    # of them, and the two steps' parameters, moments and metrics are the
    # replicated update's
    f = z["fsdp"]
    assert f["split"] >= f["leaves"] - 2 and f["held"] < f["total"], f
    assert all(f["equal"]), (f["dev"], f["equal"])
    rep_m, f_m = f["metrics"]
    assert all(torch.equal(rep_m[k], f_m[k]) for k in rep_m if k != "grad_norm")
    assert abs(float(rep_m["grad_norm"]) - float(f_m["grad_norm"])) <= 1e-6 * float(
        rep_m["grad_norm"])


def _bits(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return str(leaf.dtype).removeprefix("torch."), t.numpy().tobytes()
    a = np.asarray(leaf)
    return str(a.dtype), a.tobytes()


def test_checkpoint_moves_across_meshes(ranks):
    z = ranks["zero"]
    assert z["restored_blocks_equal"]
    assert sorted(os.listdir(ranks["ckpt"])) == ["step_00000002"]
    # on one rank, the global tree the two ranks held
    rep_p, rep_o = z["global"]
    (p1, o1), step, extra = TCk.restore_checkpoint(ranks["ckpt"], (rep_p, rep_o))
    assert step == 2 and extra == {"arch": "internlm2_1_8b"}
    want = tree_leaves((rep_p, rep_o))
    assert [_bits(a) for a in tree_leaves((p1, o1))] == [_bits(b) for b in want]
    # in JAX, into a tree of the same paths
    like = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.bfloat16 if x.dtype == torch.bfloat16
                                            else x.numpy().dtype),
                        tree_map(lambda x: x, rep_p))
    j_state = JAW.AdamWState(m=jax.tree.map(lambda x: x.astype(jnp.float32), like),
                             v=jax.tree.map(lambda x: x.astype(jnp.float32), like),
                             count=jnp.zeros((), jnp.int32))
    (jp, jo), jstep, _ = JCk.restore_checkpoint(ranks["ckpt"], (like, j_state))
    assert jstep == 2
    assert [_bits(a) for a in jax.tree.leaves((jp, jo))] == [_bits(b) for b in want]


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_matches_sequential(ranks, stages):
    got = ranks["pipe2"] if stages == 2 else ranks["pipe4"]
    params, x = ranks["pipe_inputs"][stages]
    n_mb = x.shape[0]
    assert got["calls"] == n_mb + stages - 1 + 1
    ref = got["ref"].numpy()
    jref = np.asarray(JPipe.sequential_reference(
        lambda p, v: jnp.tanh(v @ p["w"]) + p["b"], jax.tree.map(jnp.asarray, params),
        jnp.asarray(x)))
    out = got["out"].numpy()
    assert out.dtype == np.float64 and out.shape == x.shape
    assert np.abs(out - ref).max() <= 1e-10 and np.abs(out - jref).max() <= 1e-10


BASE = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--batch", "4",
        "--seq", "64", "--ckpt-every", "5", "--log-every", "5"]


def test_launcher_on_two_ranks_survives_a_fault_and_resumes_on_one(tmp_path, capfd):
    ckpt = str(tmp_path / "ckpt")
    argv = BASE + ["--ckpt-dir", ckpt, "--steps", "12", "--inject-fault-at", "8"]
    res = dist.launch(launcher.train, 2, args=(argv,), device="cpu", threads=1, timeout=300)
    out = capfd.readouterr().out
    assert out.count("[supervisor] step 8 failed (injected node failure); retry 1") == 2
    assert out.count("[train] done at step 12,") == 2
    lines = [ln for ln in out.splitlines() if ln.startswith("[train] step 10 loss")]
    assert len(lines) == 2 and lines[0].split(" (")[0] == lines[1].split(" (")[0]
    assert res.step == 12 and sorted(os.listdir(ckpt)) == [
        "step_00000005", "step_00000010", "step_00000012"]
    # the 2-rank checkpoint at step 10, resumed on one rank
    one = str(tmp_path / "one")
    os.makedirs(one)
    shutil.copytree(os.path.join(ckpt, "step_00000010"), os.path.join(one, "step_00000010"))
    resumed = launcher.train(BASE + ["--ckpt-dir", one, "--steps", "12"])
    assert "[train] resumed from step 10" in capfd.readouterr().out
    assert len(resumed.losses) == 2
    gaps = [abs(a - b) for a, b in zip(resumed.losses, res.losses[-2:])]
    assert max(gaps) < 1e-4, (resumed.losses, res.losses[-2:])
    # and on the same 2 ranks that wrote it
    two = str(tmp_path / "two")
    os.makedirs(two)
    shutil.copytree(os.path.join(ckpt, "step_00000010"), os.path.join(two, "step_00000010"))
    again = dist.launch(launcher.train, 2, args=(BASE + ["--ckpt-dir", two, "--steps", "12"],),
                        device="cpu", threads=1, timeout=300)
    assert capfd.readouterr().out.count("[train] resumed from step 10") == 2
    gaps = [abs(a - b) for a, b in zip(again.losses, res.losses[-2:])]
    assert len(again.losses) == 2 and max(gaps) < 1e-4, (again.losses, res.losses[-2:])
