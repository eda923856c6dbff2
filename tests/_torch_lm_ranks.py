"""Rank functions of the LM's multi-rank CPU tests
(tests/test_torch_lm_dist_train.py), run by `repro_torch.dist.launch`.

Each spawned rank imports this module by name, so it imports torch, numpy
and the port only (no JAX). The test hands each rank JAX's weights and
batches as numpy arrays; every rank runs the same calls, and rank 0's
results (with what every rank must agree on, gathered) go back to the
test, which holds them to JAX's one-device step on the whole batch.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import dist
from repro_torch.ckpt import checkpoint as TC
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.dist import pipeline as TPipe
from repro_torch.dist import shardings as dsh
from repro_torch.dist.zero import zero1_shardings
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe as TMoE
from repro_torch.optim.adamw import AdamWState, adamw_init, clip_by_global_norm
from repro_torch.train import step as TS
from repro_torch.utils import tree_leaves, tree_map

#: JAX's pipeline test problem (tests/test_distributed.py): d, M, Bm, seed
PIPE = (16, 6, 3, 0)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _choices(fn):
    """fn() with each call of the MoE router's top-k experts recorded."""
    seen, route = [], TMoE.route

    def record(params, x, cfg):
        out = route(params, x, cfg)
        seen.append(out[2].detach().clone())
        return out

    TMoE.route = record
    try:
        return fn(), seen
    finally:
        TMoE.route = route


def _checksum(mesh, tree) -> list:
    """Each rank's per-leaf (sum, sum of squares) of the leaves' bits, in
    rank order: equal rows are equal trees but for a collision."""
    sums = []
    for x in tree_leaves(tree):
        bits = x.contiguous().view(torch.int16 if x.element_size() == 2 else torch.int32)
        b = bits.to(torch.int64)
        sums += [b.sum(), (b * b).sum()]
    mine = torch.stack(sums).to(torch.float64)[None]
    return dist.gather(mesh, mine).tolist()


def data_parallel_grads(mesh, cases):
    """For each (arch, numpy params, numpy batch, microbatches) of `cases`:
    the step's clipped gradients, norm and metrics under the local mesh (2
    ranks split the batch, or compute it whole where 2 does not divide it),
    each MoE layer's chosen experts (of the first microbatch) gathered over
    the ranks in row order, and every rank's metrics (they must agree)."""
    out = {}
    for key, (arch, jparams, batch, microbatches) in cases.items():
        cfg = get_config(arch, smoke=True)
        params = model_params_from_jax(jparams, cfg, device="cpu")
        with dist.mesh_context(make_local_mesh(), rules=cfg.rules_override):
            (grads, metrics), seen = _choices(
                lambda: TS.grads_and_metrics(params, cfg, _t(batch), microbatches))
            split = TS._split_of(dsh.batch_shardings(_t(batch))) is not None
        clipped, norm = clip_by_global_norm(grads, 1.0)
        n_moe = sum(cfg.layer_spec(i)[1] == "moe" for i in range(cfg.n_layers))
        choices = [dist.gather(mesh, c) if split else c for c in seen[:n_moe]]
        per_rank = dist.gather(mesh, torch.stack(
            [metrics[k] for k in sorted(metrics)])[None].to(torch.float64))
        out[key] = dict(grads=clipped, norm=norm, metrics=metrics, choices=choices,
                        split=split, per_rank=per_rank)
    return out


def zero1_and_checkpoint(mesh, arch, jparams, batches, ckpt_dir):
    """Two steps of `arch` (its SMOKE config in bfloat16) with ZeRO-1
    moments (`run_sharded`) against two replicated steps on the same ranks;
    a checkpoint of the ZeRO-1 state at step 2, written by both ranks and
    restored on both; a parameter record split over "data" refused."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    params = tree_map(lambda a: a.to(torch.bfloat16),
                      model_params_from_jax(jparams, cfg, device="cpu"))
    step = TS.make_train_step(cfg, learning_rate=1e-3)
    out = {}
    with dist.mesh_context(make_local_mesh(), rules=cfg.rules_override):
        p_sh = dsh.params_shardings(params, cfg)
        m_sh = zero1_shardings(p_sh, params)
        opt = adamw_init(params)
        o_sh = AdamWState(m=m_sh, v=m_sh, count=dsh.replicated(opt.count))
        b_sh = dsh.batch_shardings(_t(batches[0]))
        sharded = TS.make_train_step(cfg, learning_rate=1e-3, grad_shardings=p_sh)
        rep_p, rep_o = params, opt
        z_p, z_o = params, opt
        for b in batches:
            rep_p, rep_o, rep_m = step(rep_p, rep_o, _t(b))
            z_p, z_o, z_m = dsh.run_sharded(sharded, (p_sh, o_sh, b_sh), z_p, z_o, _t(b))
        out["params_equal"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(z_p),
                                                                    tree_leaves(rep_p)))
        out["moments_equal"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves((z_o.m, z_o.v)),
                                              tree_leaves(dsh.place((rep_o.m, rep_o.v),
                                                                    (m_sh, m_sh)))))
        out["metrics"] = (rep_m, z_m)
        out["moment_bytes"] = (sum(x.numel() for x in tree_leaves(z_o.m)),
                               sum(x.numel() for x in tree_leaves(rep_o.m)))
        out["checksums"] = _checksum(mesh, z_p)
        out["stacked_moments"] = sum(r.stack == "data" for r in tree_leaves(m_sh))

        # the checkpoint: gathered and written by rank 0, restored on each rank
        TC.save_checkpoint(ckpt_dir, 2, (z_p, z_o), extra={"arch": arch},
                           shardings=(p_sh, o_sh))
        (r_p, r_o), step_no, _ = TC.restore_checkpoint(ckpt_dir, (z_p, z_o),
                                                       shardings=(p_sh, o_sh))
        out["restored_blocks_equal"] = step_no == 2 and all(
            torch.equal(a, b) for a, b in zip(tree_leaves((r_p, r_o)),
                                              tree_leaves((z_p, z_o))))
        out["global"] = (rep_p, rep_o)

        # FSDP: the parameters' records over "data", executed: the same two
        # steps, each rank holding its blocks of the parameters and moments
        with dist.mesh_context(make_local_mesh(), rules={**cfg.rules_override,
                                                         "fsdp": "data"}):
            f_sh = dsh.params_shardings(params, cfg)
            fm_sh = zero1_shardings(f_sh, params)
            fo_sh = AdamWState(m=fm_sh, v=fm_sh, count=dsh.replicated(opt.count))
            f_step = TS.make_train_step(cfg, learning_rate=1e-3, grad_shardings=f_sh)
            f_p, f_o = params, opt
            for b in batches:
                f_p, f_o, f_m = dsh.run_sharded(f_step, (f_sh, fo_sh, b_sh), f_p, f_o, _t(b))
            whole = dsh.gather_tree((f_p, f_o.m, f_o.v), (f_sh, fm_sh, fm_sh))
        want = (rep_p, rep_o.m, rep_o.v)
        out["fsdp"] = dict(
            split=sum("data" in r.split_axes() for r in tree_leaves(f_sh)),
            leaves=len(tree_leaves(f_sh)),
            held=sum(x.numel() for x in tree_leaves(f_p)),
            total=sum(x.numel() for x in tree_leaves(rep_p)),
            equal=[torch.equal(a, b) for a, b in zip(tree_leaves(whole), tree_leaves(want))],
            dev=max(float((a.float() - b.float()).abs().max()) / max(
                float(b.float().abs().max()), 1e-30) for a, b in zip(tree_leaves(whole),
                                                                    tree_leaves(want))),
            metrics=(rep_m, f_m))
    return out


def pipe_stage(p, x):
    """JAX's test stage (tests/test_distributed.py): tanh(x @ w) + b."""
    return torch.tanh(x @ p["w"]) + p["b"]


def pipeline(mesh, params, x):
    """`pipeline_apply` on a ("pipe",) mesh of every rank, beside
    `sequential_reference` on this rank, and the all-reduces it made."""
    pmesh = dist.data_mesh(axis_name="pipe")
    params, x = tree_map(torch.from_numpy, params), torch.from_numpy(x)
    dist.all_reduce.calls = 0
    got = TPipe.pipeline_apply(pmesh, pipe_stage, params, x)
    return dict(out=got, calls=dist.all_reduce.calls,
                ref=TPipe.sequential_reference(pipe_stage, params, x))


def pipeline_problem(n_stages):
    """JAX's problem at `n_stages` stages, float64 numpy: (params, x)."""
    d, n_mb, bm, seed = PIPE
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((n_stages, d, d)) * 0.3,
              "b": rng.standard_normal((n_stages, d)) * 0.1}
    return params, rng.standard_normal((n_mb, bm, d))


def all_cases(mesh, cases, zero_args, pipe_args):
    """The 2-rank module of tests/test_torch_lm_dist_train.py in one launch."""
    return {"dp": data_parallel_grads(mesh, cases),
            "zero": zero1_and_checkpoint(mesh, *zero_args),
            "pipe2": pipeline(mesh, *pipe_args)}


# -- tensor parallelism and FSDP (tests/test_torch_lm_tp_fsdp.py) -------------

def _not_model_split_sums(view, tree, records) -> list:
    """Each rank of `view` (a "model" view) its checksums of the leaves
    that no record splits over "model" (norms, the router, FSDP blocks), in
    rank order: the rows must be equal."""
    leaves = [x for x, r in zip(tree_leaves(tree), tree_leaves(records))
              if "model" not in r.split_axes()]
    return _checksum(view, leaves)


def _layer_model_calls(params, cfg, records) -> tuple:
    """The "model" all-reduces and all-gathers of the first layer's
    forward (no gradient)."""
    from repro_torch.models import model as TM

    x = torch.zeros((1, 4, cfg.d_model), dtype=cfg.dtype)
    dist.reset_counts()
    with torch.no_grad():
        TM._apply_layer(params["layers"][0], x, cfg, *cfg.layer_spec(0), records["layers"][0])
    return dist.all_reduce.by_axis.get("model", 0), dist.all_gather.by_axis.get("model", 0)


def sharded_case(mesh, arch, jparams, batch, microbatches, model_axis, fsdp):
    """One config's step on make_local_mesh(model_axis) under its rules
    (with `fsdp` on "data" when asked), each rank on its blocks: the
    clipped gradients gathered whole, the norm and metrics, each MoE
    layer's chosen experts (the first microbatch's) gathered over the data
    view in row order, every rank's metrics; then a whole step
    (`run_sharded`, ZeRO-1 moments) and the checksums over each model view
    of the leaves no record splits over "model"; the first layer's "model"
    all-reduces in a forward and its `wq` block shape."""
    cfg = get_config(arch, smoke=True)
    rules = dict(cfg.rules_override, **({"fsdp": "data"} if fsdp else {}))
    lmesh = make_local_mesh(model_axis)
    params = model_params_from_jax(jparams, cfg, device="cpu")
    tb = _t(batch)
    with dist.mesh_context(lmesh, rules=rules):
        p_sh = dsh.params_shardings(params, cfg)
        b_sh = dsh.batch_shardings(tb)
        m_sh = zero1_shardings(p_sh, params)
        o_sh = AdamWState(m=m_sh, v=m_sh, count=dsh.replicated(torch.zeros((), dtype=torch.int32)))
        opt = dsh.place(adamw_init(params), o_sh)
        handed, update = {}, TS.zero1_update

        def capture(grads, *args):      # the clipped gradients the update is handed
            handed["grads"] = grads
            return update(grads, *args)

        TS.zero1_update = capture
        try:
            step = TS.make_train_step(cfg, microbatches=microbatches, learning_rate=1e-3,
                                      grad_shardings=p_sh)
            (new_p, new_o, metrics), seen = _choices(
                lambda: dsh.run_sharded(step, (p_sh, o_sh, b_sh), params, opt, tb))
        finally:
            TS.zero1_update = update
        norm = metrics.pop("grad_norm")
        full = dsh.gather_tree(handed["grads"], p_sh)
        blocks = dsh.place(params, p_sh)
        dview = lmesh.view("data")
        n_moe = sum(cfg.layer_spec(i)[1] == "moe" for i in range(cfg.n_layers))
        split = TS._split_of(b_sh) is not None
        choices = [dist.gather(dview, c) if split else c for c in seen[:n_moe]]
        per_rank = dist.gather(mesh, torch.stack(
            [metrics[k] for k in sorted(metrics)])[None].to(torch.float64))
        same = _not_model_split_sums(lmesh.view("model"), (new_p, new_o.m, new_o.v),
                                     (p_sh, m_sh, m_sh))
        out = dict(grads=full, norm=norm, metrics=metrics, choices=choices, split=split,
                   per_rank=per_rank, model_sums=same, shape=lmesh.shape,
                   layer_calls=_layer_model_calls(blocks, cfg, p_sh))
        mixer = blocks["layers"][0]["mixer"]
        if "wq" in mixer:
            out["wq_block"] = tuple(mixer["wq"].shape)
        out["held"] = sum(x.numel() for x in tree_leaves(new_p))
    return out


def sharded_cases(mesh, runs, ckpt=None):
    """`sharded_case` for each (key, (arch, jparams, batch, microbatches,
    model_axis, fsdp)) of `runs`; with `ckpt` (arch, jparams, batch,
    directory), a TP + FSDP state of one step on make_local_mesh(2) saved
    and restored on these ranks (`tp_fsdp_checkpoint`)."""
    out = {key: sharded_case(mesh, *args) for key, args in runs.items()}
    if ckpt is not None:
        out["ckpt"] = tp_fsdp_checkpoint(mesh, *ckpt)
    return out


def tp_fsdp_checkpoint(mesh, arch, jparams, batch, ckpt_dir):
    """One step of `arch` on make_local_mesh(2) with `fsdp` on "data" and
    ZeRO-1 moments, its state checkpointed (gathered by the corrected
    `gather_leaf`, written by rank 0) and restored into the same blocks;
    returns the global state (gathered) and whether the blocks came back
    bit for bit."""
    cfg = get_config(arch, smoke=True)
    params = model_params_from_jax(jparams, cfg, device="cpu")
    with dist.mesh_context(make_local_mesh(2), rules={**cfg.rules_override, "fsdp": "data"}):
        p_sh = dsh.params_shardings(params, cfg)
        m_sh = zero1_shardings(p_sh, params)
        opt = adamw_init(params)
        o_sh = AdamWState(m=m_sh, v=m_sh, count=dsh.replicated(opt.count))
        b_sh = dsh.batch_shardings(_t(batch))
        step = TS.make_train_step(cfg, learning_rate=1e-3, grad_shardings=p_sh)
        z_p, z_o, _ = dsh.run_sharded(step, (p_sh, o_sh, b_sh), params, opt, _t(batch))
        # the same step with its operands donated (overwritten in place)
        d_p, d_o = tree_map(torch.clone, (dsh.place(params, p_sh), dsh.place(opt, o_sh)))
        d_p, d_o, _ = dsh.run_sharded(step, (p_sh, o_sh, b_sh), d_p, d_o, _t(batch),
                                      donate=True)
        donated_equal = all(torch.equal(a, b) for a, b in zip(tree_leaves((d_p, d_o)),
                                                               tree_leaves((z_p, z_o))))
        TC.save_checkpoint(ckpt_dir, 1, (z_p, z_o), extra={"arch": arch},
                           shardings=(p_sh, o_sh))
        (r_p, r_o), step_no, _ = TC.restore_checkpoint(ckpt_dir, (z_p, z_o),
                                                       shardings=(p_sh, o_sh))
        equal = step_no == 1 and all(torch.equal(a, b) for a, b in zip(
            tree_leaves((r_p, r_o)), tree_leaves((z_p, z_o))))
        split = sum(len(r.split_axes()) == 2 for r in tree_leaves(p_sh))
        return dict(restored_blocks_equal=equal, both_axes=split, donated_equal=donated_equal,
                    global_state=dsh.gather_tree((z_p, z_o), (p_sh, o_sh)))


# -- prefill and decode on meshes (tests/test_torch_lm_tp_serve.py) -----------

def _serve_rules(cfg, layout):
    """The rule table of a serving layout: the config's rules under
    "default", else the dry run's `_rules_for(cfg, layout)`."""
    from repro_torch.launch.dryrun import _rules_for

    return dict(cfg.rules_override) if layout == "default" else _rules_for(cfg, layout)


def _rows_over_data(lmesh, records, seen):
    """Each recorded MoE choice (this rank's rows) gathered over the data
    view in row order when the rows split over it."""
    entry = records.spec[0] if records.spec else None
    if entry is None or lmesh.shape.get(entry, 1) == 1:
        return list(seen)
    return [dist.gather(lmesh.view(entry), c) for c in seen]


def serve_case(mesh, arch, jparams, batch, max_len, steps, model_axis, layouts):
    """`arch`'s SMOKE config on make_local_mesh(model_axis): the sharded
    prefill (`run_prefill`) in the layout `layouts[0]` ("default": the
    config's rules; else a shape of the dry run's `_rules_for`), then
    `steps` greedy decode steps (`run_decode`) in `layouts[1]`, the caches
    carried from one layout's records to the other's. Returns the whole
    logits and tokens of every step, each MoE layer's chosen experts a step
    (gathered over the data view), the caches gathered whole after the
    prefill and after the last step, every rank's checksums of its logits
    and tokens (the rows must be equal), the "model" collectives of the
    first decode step, and (one layout) `greedy_generate`'s tokens."""
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import greedy_generate, make_decode_step, make_prefill_step

    cfg = get_config(arch, smoke=True)
    lmesh = make_local_mesh(model_axis)
    params = model_params_from_jax(jparams, cfg, device="cpu")
    tb = _t(batch)
    rows = tb["tokens"].shape[0]
    prefill, decode = make_prefill_step(cfg, max_len), make_decode_step(cfg)
    with dist.mesh_context(lmesh, rules=_serve_rules(cfg, layouts[0])):
        p_sh, b_sh = dsh.params_shardings(params, cfg), dsh.batch_shardings(tb)
        (logits, caches), seen = _choices(
            lambda: dsh.run_prefill(prefill, (p_sh, b_sh), params, tb))
        c_sh = TM.cache_records(cfg, rows, max_len)
        pre_caches = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                              dsh.gather_tree(caches, c_sh))   # decode writes in place
        choices = [_rows_over_data(lmesh, b_sh["tokens"], seen)]
    tok = torch.argmax(logits, dim=-1)
    all_logits, all_tokens, calls = [logits], [tok], None
    with dist.mesh_context(lmesh, rules=_serve_rules(cfg, layouts[1])):
        p_sh = dsh.params_shardings(params, cfg)
        c_sh = TM.cache_records(cfg, rows, max_len)
        tok_sh = dsh.batch_shardings(tok)
        blocks, caches = dsh.place(params, p_sh), dsh.place(caches, c_sh)
        for s in range(steps):
            dist.reset_counts()
            (logits, caches), seen = _choices(
                lambda: dsh.run_decode(decode, (p_sh, tok_sh, c_sh), blocks, tok, caches))
            if s == 0:
                calls = dict(dist.all_reduce.by_axis)
            choices.append(_rows_over_data(lmesh, tok_sh, seen))
            tok = torch.argmax(logits, dim=-1)
            all_logits.append(logits)
            all_tokens.append(tok)
        post_caches = dsh.gather_tree(caches, c_sh)
        held = (sum(x.numel() for x in tree_leaves(caches) if isinstance(x, torch.Tensor)),
                sum(int(np.prod(dsh.block_shape(r))) for r in tree_leaves(c_sh) if r.shape))
    out = dict(logits=all_logits, tokens=torch.stack(all_tokens, dim=1), choices=choices,
               pre_caches=pre_caches, post_caches=post_caches, calls=calls, held=held,
               shape=lmesh.shape,
               sums=_checksum(mesh, [torch.stack(all_logits), torch.stack(all_tokens).float()]))
    if layouts[0] == layouts[1]:
        with dist.mesh_context(lmesh, rules=_serve_rules(cfg, layouts[0])):
            out["greedy"] = greedy_generate(params, cfg, tb, steps=steps, max_len=max_len,
                                            shardings=(dsh.params_shardings(params, cfg),
                                                       dsh.batch_shardings(tb)))
    return out


def decode_from(mesh, arch, jparams, caches, tokens, max_len, model_axis, layout):
    """One decode step (`run_decode`) of `arch` on make_local_mesh(model_axis)
    in `layout`, from whole caches (JAX's prefill cache, carried across by
    `convert.caches_from_jax`) cut to this rank's blocks: the whole
    logits."""
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import make_decode_step

    cfg = get_config(arch, smoke=True)
    params = model_params_from_jax(jparams, cfg, device="cpu")
    tok = torch.from_numpy(np.asarray(tokens))
    with dist.mesh_context(make_local_mesh(model_axis), rules=_serve_rules(cfg, layout)):
        shardings = (dsh.params_shardings(params, cfg), dsh.batch_shardings(tok),
                     TM.cache_records(cfg, tok.shape[0], max_len))
        logits, _ = dsh.run_decode(make_decode_step(cfg), shardings, params, tok, caches)
    return logits


def serve_cases(mesh, runs, from_jax=None):
    """`serve_case` for each (key, arguments) of `runs`, on these ranks;
    with `from_jax` (`decode_from`'s arguments), its logits as "from_jax"."""
    out = {key: serve_case(mesh, *args) for key, args in runs.items()}
    if from_jax is not None:
        out["from_jax"] = decode_from(mesh, *from_jax)
    return out


# -- the dry run's counts against executed steps (tests/test_torch_launch_tools.py)

def executed_counts(mesh, arch, model_axis, shape, microbatches):
    """`arch`'s SMOKE config (random weights, seed 0) on
    make_local_mesh(model_axis): one sharded train step (`run_sharded`,
    ZeRO-1 moments, `grad_shardings` = the parameters' records) under the
    train_4k rules, a prefill (`run_prefill`) under prefill_32k's and a
    decode step (`run_decode`) from fresh caches under decode_32k's, at the
    global batch and sequence `shape`. Returns rank 0's `dist.counts()` of
    each step and every rank's bytes of its parameter and moment blocks."""
    from repro_torch.launch.dryrun import _rules_for
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg = get_config(arch, smoke=True)
    lmesh = make_local_mesh(model_axis)
    B, S = shape
    params = TM.init_model(cfg, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=torch.Generator().manual_seed(1))}
    out = {}

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

    with dist.mesh_context(lmesh, rules=_rules_for(cfg, "train_4k")):
        p_sh = dsh.params_shardings(params, cfg)
        m_sh = zero1_shardings(p_sh, params)
        blocks = dsh.place(params, p_sh)
        zeros = lambda r: torch.zeros(dsh.block_shape(r))  # noqa: E731
        count = torch.zeros((), dtype=torch.int32)
        opt = AdamWState(m=tree_map(zeros, m_sh), v=tree_map(zeros, m_sh), count=count)
        o_sh = AdamWState(m=m_sh, v=m_sh, count=dsh.replicated(count))
        held = [nbytes(blocks), nbytes(opt.m) + nbytes(opt.v)]
        step = TS.make_train_step(cfg, microbatches=microbatches, learning_rate=1e-3,
                                  grad_shardings=p_sh)
        dist.reset_counts()
        dsh.run_sharded(step, (p_sh, o_sh, dsh.batch_shardings(batch)), blocks, opt, batch,
                        donate=True)
        out["train"] = dist.counts()
    with dist.mesh_context(lmesh, rules=_rules_for(cfg, "prefill_32k")):
        p_sh = dsh.params_shardings(params, cfg)
        dist.reset_counts()
        dsh.run_prefill(make_prefill_step(cfg, S), (p_sh, dsh.batch_shardings(batch)), params,
                        batch)
        out["prefill"] = dist.counts()
    with dist.mesh_context(lmesh, rules=_rules_for(cfg, "decode_32k")):
        p_sh = dsh.params_shardings(params, cfg)
        c_sh = TM.cache_records(cfg, B, S)
        caches = TM.init_cache(params, cfg, B, S, records=c_sh)
        tok = batch["tokens"][:, 0]
        dist.reset_counts()
        dsh.run_decode(make_decode_step(cfg), (p_sh, dsh.batch_shardings(tok), c_sh), params,
                       tok, caches)
        out["decode"] = dist.counts()
    out["held"] = dist.gather(mesh, torch.tensor([held], dtype=torch.float64)).tolist()
    return out


def executed_counts_cases(mesh, runs):
    """`executed_counts` for each (key, arguments) of `runs`, on these ranks."""
    return {key: executed_counts(mesh, *args) for key, args in runs.items()}


def ssm_odd_heads(mesh, steps):
    """mamba2-130m's SMOKE block at 3 heads of 32 channels (d_model 48) on
    make_local_mesh(2): the view divides d_inner (96) and not the heads,
    as 16 ranks do mamba2-130m's 24. Returns the largest deviations from
    one process on the same weights of a train step's loss and new
    parameters, and of a prefill's and `steps` decode steps' logits."""
    from repro_torch.models import model as TM
    from repro_torch.models.ssm import SSMConfig
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(get_config("mamba2_130m", smoke=True), d_model=48,
                              ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                                            n_groups=1, chunk=16))
    params = TM.init_model(cfg, device="cpu")
    B, S = 2, 16
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=torch.Generator().manual_seed(1))}
    step = TS.make_train_step(cfg, learning_rate=1e-3)
    one, _, m_one = step(params, adamw_init(params), batch)
    lmesh = make_local_mesh(2)
    out = {}
    with dist.mesh_context(lmesh, rules={**dist.DEFAULT_RULES, **cfg.rules_override}):
        p_sh = dsh.params_shardings(params, cfg)
        assert p_sh["layers"][0]["mixer"]["w_out"].spec[0] == "model"
        new, _, m = TS.make_train_step(cfg, learning_rate=1e-3, grad_shardings=p_sh)(
            dsh.place(params, p_sh), dsh.place(adamw_init(params), AdamWState(
                m=p_sh, v=p_sh, count=dsh.replicated(torch.zeros((), dtype=torch.int32)))),
            batch, shardings=(p_sh, AdamWState(m=p_sh, v=p_sh, count=dsh.replicated(
                torch.zeros((), dtype=torch.int32))), dsh.batch_shardings(batch)))
        whole = dsh.gather_tree(new, p_sh)
        out["loss"] = abs(float(m["loss"]) - float(m_one["loss"]))
        out["params"] = max(float((a - b).abs().max()) for a, b in
                            zip(tree_leaves(whole), tree_leaves(one)))
        prefill, decode = make_prefill_step(cfg, S + steps), make_decode_step(cfg)
        b_sh = dsh.batch_shardings(batch)
        logits, caches = dsh.run_prefill(prefill, (p_sh, b_sh), params, batch)
        ref, ref_c = prefill(params, batch)
        devs = [float((logits - ref).abs().max())]
        c_sh = TM.cache_records(cfg, B, S + steps)
        caches = dsh.place(caches, c_sh)
        tok = torch.argmax(ref, dim=-1)
        for _ in range(steps):
            logits, caches = dsh.run_decode(decode, (p_sh, dsh.batch_shardings(tok), c_sh),
                                            params, tok, caches)
            ref, ref_c = decode(params, tok, ref_c)
            devs.append(float((logits - ref).abs().max()))
            tok = torch.argmax(ref, dim=-1)
        out["logits"] = max(devs)
        out["scale"] = float(ref.abs().max())
    return out
