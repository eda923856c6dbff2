"""The port's LM distribution layer (`repro_torch/dist/`, `launch/mesh.py`)
against JAX's (`repro/dist/`, `repro/launch/mesh.py`) on the CPU, with no
ranks:

- the sharding records of every config at full width on the production
  meshes (16 x 16, 2 x 16 x 16) and on 1 x 1, leaf for leaf JAX's: JAX's
  `_walk`, `resolve_spec` and `_widen_spec` run on a mesh that is only a
  `SimpleNamespace(shape=...)` over `jax.eval_shape` trees, and its
  stacked body leaves are unstacked as `convert.model_params_from_jax`
  unstacks the weights, the stacked dim's entry compared with the port's
  `Sharding.stack`; the same for ZeRO-1's moments and for the `fsdp` rule;
- `batch_shardings` and `cache_shardings` on SMOKE trees, `mesh_context`
  precedence, `constrain`'s rank check, a spec-only mesh refusing a
  collective, a mesh of two split axes refused in execution;
- `compress` on seeded draws with no ties: bf16 bitwise, top-k as equal
  (index, value) sets and residuals at frac 0.01, 0.1 and 1.0;
- `make_local_mesh`, `mesh_chip_count` and `make_production_mesh` against
  JAX's on one device.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import dist as JD
from repro.dist import compress as JCmp
from repro.dist import shardings as JSh
from repro.dist import zero as JZ
from repro.launch import mesh as JMesh
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch import dist
from repro_torch.dist import compress as TCmp
from repro_torch.dist import shardings as dsh
from repro_torch.dist.zero import _widen_spec, zero1_shardings
from repro_torch.launch import mesh as TMesh
from repro_torch.models import model as TM
from repro_torch.train import step as TS
from repro_torch.utils import tree_leaves, tree_map, tree_paths

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x1": {"data": 1, "model": 1}}


class _Rec:
    """JAX's resolved spec of a leaf, in the port's terms: the stacked
    dim's entry apart from the others."""

    def __init__(self, spec, stack=None, index=None, size=None):
        self.spec, self.stack, self.index, self.size = tuple(spec), stack, index, size


def _jax_records(jtree, cfg, leaf_fn):
    """JAX's `_walk` over a JAX model tree, unstacked to the port's layout
    (dense prefix, then period r of body[j] at dense_prefix + r * period + j)."""
    # the leaves cross as namespaces: the port's tree helpers walk into tuples
    walked = JSh._walk(jtree, None, lambda leaf, names: SimpleNamespace(
        s=tuple(leaf_fn(leaf, names))))
    out = {k: tree_map(lambda ns: _Rec(ns.s), v) for k, v in walked.items()
           if k not in ("prefix", "body")}
    layers = [None] * cfg.n_layers
    for i, layer in enumerate(walked["prefix"]):
        layers[i] = tree_map(lambda ns: _Rec(ns.s), layer)
    for j, stacked in enumerate(walked["body"]):
        for r in range(cfg.n_periods):
            layers[cfg.dense_prefix + r * cfg.period + j] = tree_map(
                lambda ns, r=r: _Rec(ns.s[1:], ns.s[0], r, cfg.n_periods), stacked)
    out["layers"] = layers
    return out


def _assert_same(port, want, what):
    got, exp = dict(tree_paths(port)), dict(tree_paths(want))
    assert got.keys() == exp.keys(), what
    bad = []
    for path, w in exp.items():
        g = got[path]
        if g is None or w is None:
            assert g is w is None, (what, path)
            continue
        if (tuple(g.spec), g.stack, g.stack_index, g.stack_size) != \
                (w.spec, w.stack, w.index, w.size):
            bad.append(f"{path}: port {g.spec} stack {g.stack}@{g.stack_index}/"
                       f"{g.stack_size}, JAX {w.spec} stack {w.stack}@{w.index}/{w.size}")
    assert not bad, f"{what}: {len(bad)} leaves differ:\n" + "\n".join(bad[:10])


@pytest.fixture(scope="module")
def full_width():
    """Each config's JAX shape tree (`jax.eval_shape`) and the port's
    parameters on the meta device, at full width."""
    out = {}
    for arch in TC.ARCHS:
        jcfg = JC.get_config(arch)
        shapes = jax.eval_shape(lambda c=jcfg: JM.init_model(jax.random.PRNGKey(0), c))
        cfg = TC.get_config(arch)
        out[arch] = (shapes, cfg, TM.init_model(cfg, generator=torch.Generator(),
                                                device="meta"))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_param_and_zero1_records_match_jax(full_width, arch, mesh_name):
    shapes, cfg, params = full_width[arch]
    shape = MESHES[mesh_name]
    jmesh = SimpleNamespace(shape=shape)
    mesh = dist.Mesh(axes=tuple(shape), sizes=tuple(shape.values()))
    assert mesh.group is None and mesh.size == int(np.prod(list(shape.values())))
    for rules in ({**JD.DEFAULT_RULES, **cfg.rules_override},
                  {**JD.DEFAULT_RULES, **cfg.rules_override, "fsdp": "data"}):
        fsdp = rules.get("fsdp")

        def jax_spec(leaf, names, widen=fsdp):
            s = JD.resolve_spec(JSh._align(names, leaf.ndim), leaf.shape, jmesh, rules)
            if widen is not None and widen in jmesh.shape:
                s = JZ._widen_spec(s, leaf.shape, widen, jmesh)
            return s

        want = _jax_records(shapes, cfg, jax_spec)
        with dist.mesh_context(mesh, rules=rules):
            p_sh = dsh.params_shardings(params, cfg)
        what = f"{arch} on {mesh_name}, fsdp {fsdp}"
        _assert_same(p_sh, want, what)
        assert all(r.mesh is mesh for r in tree_leaves(p_sh))
        if "data" not in shape:
            continue
        # ZeRO-1: JAX widens each stacked leaf whole, the stacked dim first
        zero = _jax_records(shapes, cfg, lambda leaf, names: JZ._widen_spec(
            jax_spec(leaf, names), leaf.shape, "data", jmesh))
        _assert_same(zero1_shardings(p_sh, params), zero, f"{what}, ZeRO-1")


def test_the_stacked_trap_is_kept():
    """qwen2.5-14b on 16 x 16 with its fsdp rule: JAX puts "data" on dim 0
    of 13 of its 14 leaves, the stacked dim of all 12 body leaves among
    them, so the port's records of each layer do too, as `stack`, and
    leave the weight dims alone."""
    cfg = TC.get_config("qwen2.5-14b")
    params = TM.init_model(cfg, generator=torch.Generator(), device="meta")
    mesh = dist.Mesh(axes=("data", "model"), sizes=(16, 16))
    with dist.mesh_context(mesh, rules=cfg.rules_override):
        p_sh = dsh.params_shardings(params, cfg)
    layer0 = tree_leaves(p_sh["layers"][0])
    assert sum(r.stack == "data" for r in layer0) == len(layer0) == 12
    assert p_sh["final_norm"]["scale"].spec == ("data",)
    assert all("data" not in r.spec for r in layer0 if r.stack == "data")
    assert [r.stack_index for r in tree_leaves(p_sh["layers"][47])][0] == 47
    assert p_sh["layers"][0]["mixer"]["wq"].uses("data")


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_batch_and_cache_records_match_jax(arch):
    jcfg, cfg = JC.get_config(arch, smoke=True), TC.get_config(arch, smoke=True)
    jparams = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), jcfg))
    jcaches = jax.eval_shape(lambda p: JM.init_cache(p, jcfg, 4, 16), jparams)
    params = TM.init_model(cfg, generator=torch.Generator(), device="meta")
    caches = TM.init_cache(params, cfg, 4, 16)
    batch = {"tokens": torch.zeros((4, 16), dtype=torch.int32),
             "patch_embeds": torch.zeros((4, 3, cfg.d_model))}
    for shape in ({"data": 2, "model": 1}, MESHES["16x16"], {"data": 4, "model": 2}):
        jmesh = SimpleNamespace(shape=shape)
        mesh = dist.Mesh(axes=tuple(shape), sizes=tuple(shape.values()))
        rules = {**JD.DEFAULT_RULES, **cfg.rules_override}
        with dist.mesh_context(mesh, rules=rules):
            b_sh = dsh.batch_shardings(batch)
            c_sh = dsh.cache_shardings(caches, cfg)
            rep = dsh.replicated(batch)
        for k, x in batch.items():
            names = ("batch",) + (None,) * (x.dim() - 1)
            assert b_sh[k].spec == tuple(JD.resolve_spec(names, x.shape, jmesh, rules)), k
            assert b_sh[k].shape == tuple(x.shape) and rep[k].spec == ()
        want = _jax_records(jcaches, jcfg, lambda leaf, names: tuple(JD.resolve_spec(
            JSh._align(names, leaf.ndim), leaf.shape, jmesh, rules)))
        # a cache's pos is a Python int here and a (stacked) array in JAX:
        # JAX's spec of it holds only Nones, the port's record is ()
        for layer in want["layers"]:
            if hasattr(layer, "_fields") and "pos" in layer._fields:
                pos = getattr(layer, "pos")
                assert set(pos.spec) <= {None} and pos.stack is None
                pos.spec, pos.index, pos.size = (), None, None
        _assert_same(c_sh, want, f"{arch} caches on {shape}")


def test_mesh_context_precedence_and_resolution():
    two = dist.Mesh(axes=("data", "model"), sizes=(2, 1))
    with dist.mesh_context(two, rules={"heads": None}) as m:
        assert m is two and dist.current_context()[1]["heads"] is None
        assert dist.current_context()[1]["mlp"] == JD.DEFAULT_RULES["mlp"] == "model"
        with dist.mesh_context(dist.data_mesh(1)):
            assert dist.current_context()[1] == JD.DEFAULT_RULES == dist.DEFAULT_RULES
        # a merged table and a partial override give the same rules
        with dist.mesh_context(two, rules={**dist.DEFAULT_RULES, "heads": None}):
            merged = dist.current_context()[1]
        assert merged == dist.current_context()[1]
    assert dist.current_context() is None
    with pytest.raises(RuntimeError, match="mesh_context"):
        dsh.params_shardings({"embed": {"table": torch.zeros(4, 2)}})
    jmesh = SimpleNamespace(shape={"data": 2, "model": 4})
    mesh = dist.Mesh(axes=("data", "model"), sizes=(2, 4))
    rules = {**dist.DEFAULT_RULES, "batch": ("data", "model"), "embed": "data"}
    for names, shape in ((("batch", None), (8, 3)), (("batch", "embed"), (6, 4)),
                         (("vocab", "embed", "mlp"), (8, 6, 12)), (("heads",), (3,))):
        assert dist.resolve_spec(names, shape, mesh, rules) == tuple(
            JD.resolve_spec(names, shape, jmesh, rules)), names
    for spec, shape in (((None, None), (63, 9)), (("data", None), (64, 8)),
                        (("model", None), (64, 9)), ((None,), (6, 4))):
        assert _widen_spec(spec, shape, "data", mesh) == tuple(
            JZ._widen_spec(jax.sharding.PartitionSpec(*spec), shape, "data", jmesh)), spec


def test_constrain_checks_the_rank_and_is_the_identity():
    x = torch.ones(2, 3)
    for ctx in (None, dist.Mesh(axes=("data", "model"), sizes=(2, 1))):
        if ctx is None:
            assert dist.constrain(x, "batch", None) is x
        else:
            with dist.mesh_context(ctx):
                assert dist.constrain(x, "batch", None) is x
        with pytest.raises(ValueError, match="2 names for rank-1"):
            dist.constrain(torch.ones(2), "batch", None)
    with pytest.raises(ValueError, match="3 names for rank-2"):
        JD.constrain(jnp.ones((2, 3)), "batch", None, None)


def test_spec_only_meshes_and_two_split_axes_are_refused():
    spec_only = dist.Mesh(axes=("data", "model"), sizes=(16, 16))
    with pytest.raises(RuntimeError, match="resolves specs only"):
        dist.all_reduce(spec_only, torch.ones(2))
    with pytest.raises(RuntimeError, match="resolves specs only"):
        dist.all_reduce(spec_only.view("model"), torch.ones(2))
    # two split axes are executed now; their views are each axis's slice
    assert dist.split_axes(spec_only) == ("data", "model")
    assert dist.split_axes(dist.Mesh(axes=("data", "model"), sizes=(2, 1))) == ("data",)
    four = dist.Mesh(rank=3, axes=("data", "model"), sizes=(2, 2))
    assert (four.view("data").size, four.view("data").rank) == (2, 1)
    assert (four.view("model").size, four.view("model").rank) == (2, 1)
    assert spec_only.coord("model") == 0 and dist.Mesh(
        rank=5, axes=("data", "model"), sizes=(2, 4)).coord("model") == 1
    with pytest.raises(ValueError, match="pair up"):
        dist.Mesh(axes=("data",), sizes=(2, 2))
    # a parameter record over "data" (FSDP) runs its collectives: on a mesh
    # no process group backs, the step raises instead of computing it whole
    cfg = TC.get_config("internlm2_1_8b", smoke=True)
    params = TM.init_model(cfg, device="cpu")
    two = dist.Mesh(size=2)
    with dist.mesh_context(two, rules={"fsdp": "data"}):
        p_sh = dsh.params_shardings(params, cfg)
    step = TS.make_train_step(cfg, grad_shardings=p_sh)
    with pytest.raises(RuntimeError, match="resolves specs only"):
        step(params, None, {"tokens": torch.zeros((2, 8), dtype=torch.int64)},
             shardings=(p_sh, None, None))
    # the SSM's channels over "model" execute: the step is built, and on a
    # mesh no process group backs it reaches its collectives
    ssm = TC.get_config("mamba2_130m", smoke=True)
    s_params = TM.init_model(ssm, device="cpu")
    with dist.mesh_context(dist.Mesh(axes=("data", "model"), sizes=(1, 2))):
        s_sh = dsh.params_shardings(s_params, ssm)
    assert s_sh["layers"][0]["mixer"]["w_in"].spec == (None, "model")
    s_step = TS.make_train_step(ssm, grad_shardings=s_sh)
    with pytest.raises(RuntimeError, match="resolves specs only"):
        s_step(s_params, None, {"tokens": torch.zeros((2, 8), dtype=torch.int64)},
               shardings=(s_sh, None, None))


def _tree(seed, shapes=((40, 25), (1000,), (3, 7, 11))):
    """Float32 leaves with no two magnitudes equal (distinct integers
    times a power of two, shuffled, random signs)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, shape in enumerate(shapes):
        n = int(np.prod(shape))
        mags = (rng.permutation(n) + 1).astype(np.float32) * np.float32(2.0 ** -9)
        out[f"w{i}"] = (mags * rng.choice([-1, 1], n)).reshape(shape).astype(np.float32)
    return out


@pytest.mark.parametrize("frac", [0.01, 0.1, 1.0])
def test_compress_matches_jax(frac):
    g, r = _tree(0), _tree(1)
    r = {k: v * np.float32(0.25) for k, v in r.items()}
    gt, rt = tree_map(torch.from_numpy, g), tree_map(torch.from_numpy, r)
    gj, rj = jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r)
    # bf16 on the wire: the same bits
    wt, wj = TCmp.bf16_compress(gt), JCmp.bf16_compress(gj)
    for k in g:
        assert wt[k].dtype == torch.bfloat16
        assert np.array_equal(wt[k].float().numpy(), np.asarray(wj[k]).astype(np.float32))
        back = TCmp.bf16_decompress(wt, gt)[k]
        assert back.dtype == torch.float32 and torch.equal(back, wt[k].float())
    # top-k with error feedback, (g + r) free of ties
    vt, it, nt = TCmp.topk_compress(gt, rt, frac=frac)
    vj, ij, nj = JCmp.topk_compress(gj, rj, frac=frac)
    for k in g:
        got = dict(zip(it[k].tolist(), vt[k].tolist()))
        want = dict(zip(np.asarray(ij[k]).tolist(), np.asarray(vj[k]).tolist()))
        assert len(got) == len(want) == JCmp._k_for(g[k].size, frac) and got == want, k
        assert np.array_equal(nt[k].numpy(), np.asarray(nj[k])), k
        dense = TCmp.topk_decompress(vt, it, gt)[k]
        assert np.array_equal(dense.numpy(), np.asarray(
            JCmp.topk_decompress(vj, ij, gj)[k])), k
        if frac == 1.0:
            assert torch.equal(dense, gt[k] + rt[k]) and not nt[k].any()
    zero = TCmp.topk_init(gt)
    assert all(not z.any() and z.shape == gt[k].shape for k, z in zero.items())


def test_mesh_builders_match_jax():
    """Each package's mesh over whatever its process has: JAX's devices
    (one here, unless a test earlier in this worker forced host devices)
    and the port's ranks (one: no process group)."""
    n = len(jax.devices())
    jm, tm = JMesh.make_local_mesh(), TMesh.make_local_mesh()
    assert dict(jm.shape) == {"data": n, "model": 1} and JMesh.mesh_chip_count(jm) == n
    assert tm.shape == {"data": 1, "model": 1} and TMesh.mesh_chip_count(tm) == 1
    assert tm.group is None and tm.axes == ("data", "model")
    for multi_pod, chips in ((False, 256), (True, 512)):
        if n < chips:
            with pytest.raises(ValueError):
                JMesh.make_production_mesh(multi_pod=multi_pod)
        else:
            assert JMesh.mesh_chip_count(JMesh.make_production_mesh(multi_pod=multi_pod)) \
                == chips
        with pytest.raises(ValueError, match="ranks"):
            TMesh.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError, match="model_axis"):
        TMesh.make_local_mesh(model_axis=2)
    prod = dist.Mesh(axes=("pod", "data", "model"), sizes=(2, 16, 16))
    assert TMesh.mesh_chip_count(prod) == 512
    assert dist.data_mesh(axis_name="pipe").shape == {"pipe": 1}
    assert dataclasses.replace(tm, axes=("pipe",), sizes=(1,)).shape == {"pipe": 1}


def test_contexts_reach_the_recompute_on_another_thread():
    """A CUDA backward runs a checkpointed layer's recompute on autograd's
    own thread; the MoE there must still see the step's data-parallel mesh
    (else its load-balance fractions are the rank's own)."""
    import threading

    from torch.utils import checkpoint as ckpt

    two = dist.Mesh(axes=("data", "model"), sizes=(2, 1))
    seen = {}
    captured = {}
    real = ckpt.checkpoint

    def capture(fn, *args, context_fn=None, **kw):
        captured["contexts"] = context_fn()
        return fn(*args)

    cfg = TC.get_config("internlm2_1_8b", smoke=True)
    params = TM.init_model(cfg, device="cpu")
    with pytest.MonkeyPatch.context() as mp, dist.mesh_context(two), dist.data_parallel(two):
        mp.setattr(ckpt, "checkpoint", capture)
        with torch.enable_grad():
            TM._checkpointed(cfg, params["layers"][0], torch.zeros(1, 4, cfg.d_model),
                             *cfg.layer_spec(0))

    def recompute():
        seen["before"] = (dist.current_context(), dist.data_parallel_mesh())
        with captured["contexts"][1]:
            seen["in"] = (dist.current_context()[0], dist.data_parallel_mesh())
        seen["after"] = (dist.current_context(), dist.data_parallel_mesh())

    t = threading.Thread(target=recompute)
    t.start()
    t.join(30)
    assert not t.is_alive() and ckpt.checkpoint is real
    assert seen["before"] == (None, None) and seen["after"] == (None, None)
    assert seen["in"][0] is two and seen["in"][1] is two
