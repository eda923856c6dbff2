"""The port's checkpointing (`repro_torch/ckpt/`) and token pipeline
(`repro_torch/data/pipeline.py`) against JAX's (`repro/ckpt/`,
`repro/data/pipeline.py`): twins of `tests/test_checkpoint_data.py`
(round trip with bf16 and int leaves, corruption detected, retention and
the tmp sweep, restore of the latest, restore onto a named device,
synthetic determinism and resume, host shards, memmap); a checkpoint of a
tree both packages hold (with an AdamW state) written by JAX and restored
by the port, and the reverse, bit for bit, with equal manifests; the
synthetic batches and memmap windows bit for bit JAX's for all three
front ends."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as JC
from repro.data import pipeline as JP
from repro.optim import adamw as JAW
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt import checkpoint as TC
from repro_torch.data import pipeline as TP
from repro_torch.optim import adamw as TAW
from repro_torch.utils import tree_leaves, tree_paths


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "nested": {"b": np.arange(12, dtype=np.int32).reshape(3, 4)},
            "lst": [np.ones((5,), np.float32),
                    rng.standard_normal((2, 2)).astype(ml_dtypes.bfloat16)]}


def _torch_leaf(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(leaf):
    """A leaf's raw bytes (a JAX array or a tensor), with its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.cpu()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().tobytes()
        return str(t.dtype).removeprefix("torch."), t.numpy().tobytes()
    a = np.asarray(leaf)
    return str(a.dtype), a.tobytes()


def _trees():
    """The same tree in both packages: (params, AdamW state)."""
    base = _numpy_tree()
    params_t = {"a": _torch_leaf(base["a"]), "nested": {"b": _torch_leaf(base["nested"]["b"])},
                "lst": [_torch_leaf(x) for x in base["lst"]]}
    params_j = jax.tree.map(jnp.asarray, base)
    return (params_t, TAW.adamw_init(params_t)), (params_j, JAW.adamw_init(params_j))


def _tree():
    return _trees()[0][0]


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_roundtrip(tmp_path):
    t = _tree()
    TC.save_checkpoint(str(tmp_path), 7, t, extra={"note": "x"})
    restored, step, extra = TC.restore_checkpoint(str(tmp_path), t)
    assert step == 7 and extra["note"] == "x"
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert restored["lst"][1].dtype == torch.bfloat16


def test_integrity_check_detects_corruption(tmp_path):
    t = _tree()
    path = TC.save_checkpoint(str(tmp_path), 1, t)
    victim = os.path.join(path, "leaf_00000.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-1] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="checksum mismatch"):
        TC.restore_checkpoint(str(tmp_path), t)


def test_shape_mismatch_raises(tmp_path):
    t = _tree()
    TC.save_checkpoint(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="shape"):
        TC.restore_checkpoint(str(tmp_path), dict(t, a=torch.zeros(4, 4)))


def test_retention_and_tmp_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, keep_every=2)
    t = _tree()
    # leave a fake torn write behind
    os.makedirs(os.path.join(tmp_path, "step_00000001.tmp-zzz"))
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, t)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000002", "step_00000004", "step_00000005"]


def test_restore_latest_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(5, t)
    mgr.save(9, {"a": t["a"] * 0, "nested": t["nested"], "lst": t["lst"]})
    assert mgr.latest_step() == 9
    restored, step, _ = mgr.restore(t)
    assert step == 9
    assert float(restored["a"].abs().sum()) == 0.0
    earlier, step, _ = mgr.restore(t, step=5)
    assert step == 5 and torch.equal(earlier["a"], t["a"])
    with pytest.raises(FileNotFoundError):
        TC.restore_checkpoint(str(tmp_path / "empty"), t)


def test_restore_onto_a_named_device(tmp_path):
    """Leaves land on the target's devices unless a device is named (the
    one-card counterpart of JAX's elastic restore onto shardings)."""
    t = _tree()
    TC.save_checkpoint(str(tmp_path), 3, t)
    on_meta = {"a": t["a"].to("meta"), "nested": t["nested"], "lst": t["lst"]}
    kept, _, _ = TC.restore_checkpoint(str(tmp_path), on_meta)
    assert kept["a"].device.type == "meta" and kept["nested"]["b"].device.type == "cpu"
    named, _, _ = TC.restore_checkpoint(str(tmp_path), on_meta, device="cpu")
    assert all(x.device.type == "cpu" for x in tree_leaves(named))
    assert torch.equal(named["a"], t["a"])


def test_leaf_paths_are_jaxs():
    (tree_t, state_t), (tree_j, state_j) = _trees()
    flat = jax.tree_util.tree_flatten_with_path((tree_j, state_j))[0]
    paths_j, _, _ = JC._flatten_with_paths((tree_j, state_j))
    assert [p for p, _ in tree_paths((tree_t, state_t))] == paths_j
    assert len(paths_j) == len(flat)


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    (tree_t, state_t), (tree_j, state_j) = _trees()
    key = jax.random.PRNGKey(3)
    tree_j = jax.tree.map(lambda x: x + jnp.ones_like(x), tree_j)   # differ from the target
    state_j = state_j._replace(m=jax.tree.map(
        lambda x: jax.random.normal(key, x.shape, jnp.float32), state_j.m),
        count=jnp.asarray(4, jnp.int32))
    JC.save_checkpoint(str(tmp_path), 4, (tree_j, state_j), extra={"arch": "x"})
    (got_tree, got_state), step, extra = TC.restore_checkpoint(str(tmp_path),
                                                               (tree_t, state_t))
    assert step == 4 and extra == {"arch": "x"}
    assert isinstance(got_state, TAW.AdamWState)
    want = jax.tree.leaves((tree_j, state_j))
    got = tree_leaves((got_tree, got_state))
    assert [_bits(a) for a in got] == [_bits(b) for b in want]


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    (tree_t, state_t), (tree_j, state_j) = _trees()
    gen = torch.Generator().manual_seed(5)
    state_t = state_t._replace(v={"a": torch.rand(8, 16, generator=gen), **{
        k: v for k, v in state_t.v.items() if k != "a"}}, count=state_t.count + 7)
    TC.save_checkpoint(str(tmp_path / "t"), 7, (tree_t, state_t), extra={"arch": "y"})
    (got_tree, got_state), step, extra = JC.restore_checkpoint(str(tmp_path / "t"),
                                                               (tree_j, state_j))
    assert step == 7 and extra == {"arch": "y"}
    got = jax.tree.leaves((got_tree, got_state))
    want = tree_leaves((tree_t, state_t))
    assert [_bits(a) for a in got] == [_bits(b) for b in want]
    # the same tree written by each package: the same manifest, the same files
    JC.save_checkpoint(str(tmp_path / "j"), 7, jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x)), (got_tree, got_state)), extra={"arch": "y"})
    mt = _manifest(tmp_path / "t" / "step_00000007")
    mj = _manifest(tmp_path / "j" / "step_00000007")
    assert mt == mj
    for e in mt["leaves"]:
        a = open(tmp_path / "t" / "step_00000007" / e["file"], "rb").read()
        b = open(tmp_path / "j" / "step_00000007" / e["file"], "rb").read()
        assert a == b, e["path"]


@pytest.mark.parametrize("front", ["tokens", "codebooks", "patches"])
def test_synthetic_batches_bitwise_jaxs(front):
    kw = {"tokens": {}, "codebooks": {"n_codebooks": 4},
          "patches": {"vision_tokens": 6, "d_model": 32}}[front]
    for seed, host in ((0, 0), (3, 1)):
        args = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=seed, n_hosts=2,
                    host_id=host, **kw)
        jcfg, tcfg = JP.DataConfig(**args), TP.DataConfig(**args)
        for step in (0, 1, 17):
            jb = JP.synthetic_batch(jcfg, step)
            tb = TP.synthetic_batch(tcfg, step, device="cpu")
            assert sorted(jb) == sorted(tb)
            for k in jb:
                assert tb[k].device.type == "cpu"
                assert _bits(tb[k]) == _bits(jb[k]), (front, seed, host, step, k)


def test_synthetic_determinism_and_resume():
    cfg = TP.DataConfig(vocab_size=1000, seq_len=64, global_batch=8, seed=3)
    s1 = TP.SyntheticStream(cfg, device="cpu")
    batches = [next(s1) for _ in range(5)]
    s2 = TP.SyntheticStream(cfg, start_step=3, device="cpu")  # resume at step 3
    assert torch.equal(next(s2)["tokens"], batches[3]["tokens"])
    assert not torch.equal(batches[0]["tokens"], batches[1]["tokens"])


def test_host_sharding_disjoint():
    h0 = TP.DataConfig(vocab_size=500, seq_len=32, global_batch=8, seed=1, n_hosts=2,
                       host_id=0)
    h1 = TP.DataConfig(vocab_size=500, seq_len=32, global_batch=8, seed=1, n_hosts=2,
                       host_id=1)
    b0 = next(TP.SyntheticStream(h0, device="cpu"))["tokens"]
    b1 = next(TP.SyntheticStream(h1, device="cpu"))["tokens"]
    assert b0.shape == (4, 32) and b1.shape == (4, 32)
    assert not torch.equal(b0, b1)
    with pytest.raises(ValueError, match="split"):
        TP.synthetic_batch(TP.DataConfig(vocab_size=500, seq_len=32, global_batch=7,
                                         n_hosts=2), 0, device="cpu")


def test_memmap_pipeline_bitwise_jaxs(tmp_path):
    toks = np.random.default_rng(0).integers(0, 777, size=10_000).astype(np.int32)
    path = str(tmp_path / "tokens.bin")
    TP.write_token_file(path, toks)
    cfg = TP.DataConfig(vocab_size=777, seq_len=128, global_batch=4, seed=2)
    ds = TP.MemmapTokens(path, cfg, device="cpu")
    b = next(ds)
    assert b["tokens"].shape == (4, 128) and b["tokens"].dtype == torch.int32
    assert int(b["tokens"].max()) < 777
    # resume determinism
    ds2 = TP.MemmapTokens(path, cfg, start_step=0, device="cpu")
    assert torch.equal(next(ds2)["tokens"], b["tokens"])
    jds = JP.MemmapTokens(path, JP.DataConfig(vocab_size=777, seq_len=128, global_batch=4,
                                              seed=2))
    for _ in range(3):
        assert _bits(next(jds)["tokens"]) == _bits(b["tokens"])
        b = next(ds)
