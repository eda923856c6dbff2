"""The dry run, counted: for every (architecture x input shape x mesh) cell,
rank 0's step on meta tensors on a mesh that no process group backs, and
the record of what it does: FLOPs, the bytes a rank holds and moves, and
every collective by kind and axis, one JSON a cell under
`experiments/torch_artifacts/` (resumable; `launch/roofline.py` reads
these records, and JAX's).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh both --include-sven --out experiments/torch_artifacts

The port of `repro/launch/dryrun.py`, which AOT-lowers and compiles each
cell on 512 forced XLA host devices and reads the compiler's cost and
memory analysis. torch has no AOT compile; the port runs the step itself,
eagerly, as each rank of a real mesh would, on tensors of the "meta"
device (shapes and dtypes, no data):

- the mesh is `spec_mesh`: the production (16, 16) or (2, 16, 16), with no
  process group. Its collectives of meta operands are counted, not run
  (`dist._counted`), in the counters the executed collectives keep;
- the parameters come from `init_model` on "meta" (JAX's `eval_shape`),
  each cell's step is the one phases 18-20 of `chip_smoke.py` execute:
  `run_sharded` of `make_train_step` (ZeRO-1 moments, `grad_shardings` the
  parameters' records), `run_prefill`, `run_decode` (the caches donated),
  in `dist.mesh_context(mesh, rules=_rules_for(cfg, shape))`;
- `flops` are the FLOPs `torch.utils.flop_counter.FlopCounterMode` counts
  on rank 0's step, the remat recompute included;
- `bytes_accessed` is a floor of the bytes a rank must move through HBM,
  from the records: train reads the parameters, writes the gradients,
  reads and writes the moments and writes the parameters; prefill reads
  the parameters and writes the caches; decode reads the parameters and
  the caches and writes the new slot (an SSM's state whole). Eager
  PyTorch's summed operand bytes would overcount what reaches HBM (an
  activation of a few MB stays in the H100's 50 MB L2), and no compiler
  says what it keeps on chip;
- `argument_size_in_bytes` and `peak_bytes_per_device` are the bytes a
  rank holds: its blocks of the parameters, the moments, the caches and
  the batch. XLA's temp bytes (activations, buffers) have no counterpart.

Layers run in a Python loop, so every count is whole: JAX's scan probes
(`_combine_probes`) and its HLO parser (`collective_bytes`) have no
counterpart, and `corrected_*` equal the counts. Two shortcuts keep the
cells countable on a CPU (a meta op costs ~0.1 ms of Python). Outside
autograd, the chunked attention (`models.attention.sdpa_chunked`, JAX's
double scan as two Python loops) runs its first query chunk on the meta
operands and counts the others as copies of it: every query chunk runs
the same ops on operands of the same shapes against every KV chunk (the
causal mask changes values, not work). A train step's microbatch loop
(`train.step._grads_of`) runs its first microbatch and counts the others
as copies of it: every microbatch runs the same ops and collectives on
blocks of the same shapes. So each count is the loop's. `collectives`
keep JAX's convention (an all-gather's bytes are its gathered result);
`collectives_by_axis` keep the counters as the ranks keep them (an
all-gather's bytes are the block a rank sends), by mesh axis.

Cells:
  train_4k    -> train step (fwd + bwd + AdamW, microbatched, remat, ZeRO-1)
  prefill_32k -> prefill step (logits + the caches built)
  decode_32k / long_500k -> decode step (1 token against a seq_len cache)
  sven_*      -> the paper's distributed hot ops (the Gram, H v), whose
                 FLOPs and bytes are floors by formula (`lower_sven_cell`)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import dist
from repro_torch.configs import ARCHS, SHAPES, get_config, get_meta, input_specs
from repro_torch.launch.mesh import mesh_chip_count

#: the production meshes: tag -> (axes, sizes), as `make_production_mesh`
PRODUCTION = {"pod16x16": (("data", "model"), (16, 16)),
              "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _rules_for(cfg, shape_name: str) -> dict:
    """The rule table of `shape_name`'s cell: DEFAULT_RULES, the config's
    `rules_override`, then the shape's serving layout:

    - prefill_32k: the KV cache written split by sequence over "model",
      compute head-split;
    - decode_32k: flash decoding: batch over "data", the cache's sequence
      over "model", heads whole in compute, FSDP over "data";
    - long_500k: batch 1: the sequence over "data", heads keep "model",
      no FSDP.

    Any other name ("default", "train_4k") gives the config's rules."""
    rules = dict(dist.DEFAULT_RULES)
    rules.update(cfg.rules_override)
    if shape_name == "prefill_32k":
        rules["seq_kv"] = "model"
        rules["kv_heads"] = None
    if shape_name == "decode_32k":
        rules["seq_kv"] = "model"
        rules["kv_heads"] = None
        rules["heads"] = None
        rules["fsdp"] = "data"
    if shape_name == "long_500k":
        rules["batch"] = None
        rules["seq_kv"] = "data"
        rules["kv_heads"] = None
        rules["fsdp"] = None
    return rules


def spec_mesh(multi_pod: bool = False, sizes: Optional[tuple] = None) -> dist.Mesh:
    """A (data, model) mesh of `sizes` ranks (the production (16, 16), or
    (2, 16, 16) over ("pod", "data", "model") with `multi_pod`) that no
    process group backs: this process is its rank 0, it resolves specs,
    and it counts the collectives of meta tensors."""
    if sizes is None:
        axes, sizes = PRODUCTION["pod2x16x16" if multi_pod else "pod16x16"]
    else:
        axes = PRODUCTION["pod16x16" if len(sizes) == 2 else "pod2x16x16"][0]
    return dist.Mesh(axes=axes, sizes=tuple(sizes))


def _bytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _held(tree, recs=None) -> int:
    """The bytes of this rank's blocks of `tree` by `recs` (the tree's own
    leaves when None)."""
    from repro_torch.dist import shardings as dsh
    from repro_torch.utils import tree_leaves, tree_map

    if recs is None:
        return sum(_bytes(x) for x in tree_leaves(tree))
    sizes = tree_map(lambda x, r: (math.prod(dsh.block_shape(r)) * x.element_size()
                                   if isinstance(x, torch.Tensor) and r is not None
                                   else _bytes(x)), tree, recs)
    return sum(v for v in tree_leaves(sizes) if isinstance(v, int))


def _slot_bytes(caches) -> int:
    """The bytes a decode step writes to this rank's blocks of the caches: a
    KV or latent cache one position (its block over its positions), an SSM
    cache whole."""
    out = 0
    for c in caches["layers"]:
        fields = c._fields
        if "h" in fields:            # SSMCache: the conv tail and the state
            out += _bytes(c.conv) + _bytes(c.h)
            continue
        for f in fields:
            x = getattr(c, f)
            if isinstance(x, torch.Tensor) and x.dim() >= 2 and x.shape[1]:
                out += _bytes(x) // x.shape[1]
    return out


def _collective_record(counted: dict, mesh: dist.Mesh) -> dict:
    """JAX's per-kind record from `dist.counts()`: an all-gather's bytes are
    its gathered result (the block a rank sends times the axes' size)."""
    out = {}
    for kind, e in counted.items():
        nbytes = e["bytes"]
        if kind == "all-gather":
            nbytes = sum(b * math.prod(mesh.shape[a] for a in key.split("+"))
                         for key, b in e["bytes_by_axis"].items())
        out[kind] = {"count": e["count"], "bytes": nbytes}
    return out


@contextlib.contextmanager
def _first_query_chunk(extra: dict):
    """Within it, a chunked attention of meta operands outside autograd
    runs its first query chunk and adds the FLOPs of the others, copies of
    it, to extra["flops"] (the module doc)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import attention, mla

    whole = attention.sdpa_chunked

    def counted(q, k, v, *, chunk_q: int = attention.CHUNK_Q, **kw):
        cq = min(chunk_q, q.shape[1])
        n_q = q.shape[1] // cq
        if not q.is_meta or n_q == 1 or torch.is_grad_enabled() or q.shape[1] % cq:
            return whole(q, k, v, chunk_q=chunk_q, **kw)
        with FlopCounterMode(display=False) as fc:
            first = whole(q[:, :cq], k, v, chunk_q=chunk_q, **kw)
        extra["flops"] += (n_q - 1) * fc.get_total_flops()
        return first.new_empty((q.shape[0], q.shape[1]) + tuple(first.shape[2:]))

    attention.sdpa_chunked = mla.sdpa_chunked = counted
    try:
        yield
    finally:
        attention.sdpa_chunked = mla.sdpa_chunked = whole


def _counters_since(before: dict) -> dict:
    """`dist.counts()` less `before` (an earlier `dist.counts()`)."""
    out = {}
    for kind, e in dist.counts().items():
        b = before.get(kind, {"count": 0, "bytes": 0, "by_axis": {}, "bytes_by_axis": {}})
        out[kind] = {"count": e["count"] - b["count"], "bytes": e["bytes"] - b["bytes"],
                     **{k: {ax: n - b[k].get(ax, 0) for ax, n in e[k].items()}
                        for k in ("by_axis", "bytes_by_axis")}}
    return out


def _add_counters(delta: dict) -> None:
    """Add a `_counters_since` record to the collectives' counters."""
    fns = dist._collectives()
    for kind, d in delta.items():
        fn = fns[kind]
        fn.calls += d["count"]
        fn.bytes += d["bytes"]
        for k, attr in (("by_axis", fn.by_axis), ("bytes_by_axis", fn.bytes_by_axis)):
            for ax, n in d[k].items():
                attr[ax] = attr.get(ax, 0) + n


@contextlib.contextmanager
def _first_microbatch(extra: dict):
    """Within it, the first `train.step._grads_of` of meta operands runs
    (its FLOPs and collectives recorded), and each later one returns meta
    gradients and metrics of the same shapes and adds the first's FLOPs
    to extra["flops"] and its collectives to the counters (the module
    doc)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train import step as train_step
    from repro_torch.utils import tree_map

    whole = train_step._grads_of
    first: dict = {}

    def counted(params, cfg, batch, records=None):
        if not batch["tokens"].is_meta:
            return whole(params, cfg, batch, records)
        if not first:
            before = dist.counts()
            with FlopCounterMode(display=False) as fc:
                grads, metrics = whole(params, cfg, batch, records)
            first.update(flops=fc.get_total_flops(), colls=_counters_since(before),
                         grads=grads, metrics=metrics)
            return grads, metrics
        extra["flops"] += first["flops"]
        _add_counters(first["colls"])
        return (tree_map(torch.empty_like, first["grads"]),
                {k: torch.empty_like(v) for k, v in first["metrics"].items()})

    train_step._grads_of = counted
    try:
        yield
    finally:
        train_step._grads_of = whole


@contextlib.contextmanager
def _counting():
    """Within it, the collectives' counters start at 0 and FLOPs are
    counted; yields a dict that holds "flops", "collectives" (the raw
    counters) and "seconds" on exit. The counters are restored after."""
    from torch.utils.flop_counter import FlopCounterMode

    fns = dist._collectives().values()
    saved = [(fn.calls, fn.bytes, fn.seconds, dict(fn.by_axis), dict(fn.bytes_by_axis))
             for fn in fns]
    dist.reset_counts()
    out: dict = {}
    extra = {"flops": 0}
    t0 = time.perf_counter()
    try:
        with (FlopCounterMode(display=False) as fc, _first_query_chunk(extra),
              _first_microbatch(extra)):
            yield out
        out["flops"] = float(fc.get_total_flops() + extra["flops"])
        out["collectives"] = dist.counts()
        out["seconds"] = time.perf_counter() - t0
    finally:
        for fn, (c, b, s, ax, bax) in zip(fns, saved):
            fn.calls, fn.bytes, fn.seconds, fn.by_axis, fn.bytes_by_axis = c, b, s, ax, bax


def _meta_blocks(recs, dtype=torch.float32):
    """Meta tensors of this rank's block shapes by `recs`."""
    from repro_torch.dist import shardings as dsh
    from repro_torch.utils import tree_map

    return tree_map(lambda r: torch.empty(dsh.block_shape(r), dtype=dtype, device="meta"),
                    recs)


def _lower_one(cfg, shape_name: str, mesh: dist.Mesh, rules: dict, *, microbatches: int,
               global_batch: Optional[int] = None, seq_len: Optional[int] = None) -> dict:
    """Count rank 0's step of `cfg` at a shape on `mesh` under `rules`;
    `global_batch` and `seq_len` override the shape's."""
    from repro_torch.dist import shardings as dsh
    from repro_torch.dist.zero import zero1_shardings
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    from repro_torch.train.step import make_train_step
    from repro_torch.utils import tree_leaves

    sh = dict(SHAPES[shape_name])
    if global_batch is not None:
        sh["global_batch"] = global_batch
    if seq_len is not None:
        sh["seq_len"] = seq_len
    B, S = sh["global_batch"], sh["seq_len"]
    with dist.mesh_context(mesh, rules=rules):
        specs = input_specs(cfg, shape_name, sh)
        params = M.init_model(cfg, device="meta")
        p_sh = dsh.params_shardings(params, cfg)
        P = _held(params, p_sh)
        if sh["kind"] == "train":
            m_sh = zero1_shardings(p_sh, params)
            count = torch.zeros((), dtype=torch.int32, device="meta")
            opt = AdamWState(m=_meta_blocks(m_sh), v=_meta_blocks(m_sh), count=count)
            o_sh = AdamWState(m=m_sh, v=m_sh, count=dsh.replicated(count))
            b_sh = dsh.batch_shardings(specs)
            step = make_train_step(cfg, microbatches=microbatches, learning_rate=1e-3,
                                   grad_shardings=p_sh)
            with _counting() as c:
                dsh.run_sharded(step, (p_sh, o_sh, b_sh), params, opt, specs, donate=True)
            moments = _held(opt.m) + _held(opt.v)
            grad_bytes = sum(math.prod(dsh.block_shape(r)) * (4 if microbatches > 1 else
                                                             x.element_size())
                             for x, r in zip(tree_leaves(params), tree_leaves(p_sh)))
            held_batch = _held(specs, b_sh)
            floor = 2 * P + grad_bytes + 2 * moments
            arg = P + moments + held_batch
            extra = {"moment_bytes": moments, "cache_bytes": 0}
        elif sh["kind"] == "prefill":
            b_sh = dsh.batch_shardings(specs)
            step = make_prefill_step(cfg, max_len=S)
            with _counting() as c:
                _, caches = dsh.run_prefill(step, (p_sh, b_sh), params, specs)
            C = _held(caches)
            held_batch = _held(specs, b_sh)
            floor = P + C
            arg = P + C + held_batch
            extra = {"moment_bytes": 0, "cache_bytes": C}
        else:
            caches = M.init_cache(None, cfg, B, S, device="meta")
            c_sh = M.cache_records(cfg, B, S)
            caches = dsh.place(caches, c_sh)
            tok_sh = dsh.batch_shardings(specs)["tokens"]
            step = make_decode_step(cfg)
            C = _held(caches)
            slot = _slot_bytes(caches)
            with _counting() as c:
                dsh.run_decode(step, (p_sh, tok_sh, c_sh), params, specs["tokens"], caches)
            held_batch = _held(specs["tokens"], tok_sh)
            floor = P + C + slot
            arg = P + C + held_batch
            extra = {"moment_bytes": 0, "cache_bytes": C}
    colls = _collective_record(c["collectives"], mesh)
    return dict(lower_s=round(c["seconds"], 2), flops=c["flops"], corrected_flops=c["flops"],
                bytes_accessed=float(floor), corrected_bytes=float(floor),
                collectives=colls, corrected_collectives=colls,
                collectives_by_axis=c["collectives"], argument_size_in_bytes=arg,
                peak_bytes_per_device=arg, param_bytes=P, global_batch=B, seq_len=S,
                **extra)


def lower_cell(arch: str, shape_name: str, mesh: dist.Mesh, *,
               opt_overrides: Optional[dict] = None, global_batch: Optional[int] = None,
               seq_len: Optional[int] = None, layout: Optional[str] = None) -> dict:
    """Count one (arch x shape) cell on `mesh` (a `spec_mesh`). As JAX's:
    `opt_overrides` holds "cfg" (config fields), "rules" (rule entries) and
    "microbatches". `global_batch` and `seq_len` override the shape's;
    `layout` names the shape whose rule table the step runs under (the
    cell's own by default; "default" is the config's rules)."""
    cfg = get_config(arch)
    if opt_overrides:
        cfg = dataclasses.replace(cfg, **opt_overrides.get("cfg", {}))
    meta = get_meta(arch)
    sh = SHAPES[shape_name]
    rules = _rules_for(cfg, shape_name if layout is None else layout)
    if opt_overrides:
        rules.update(opt_overrides.get("rules", {}))
    mb = ((opt_overrides or {}).get("microbatches", meta.train_microbatch)
          if sh["kind"] == "train" else 1)
    rec = _lower_one(cfg, shape_name, mesh, rules, microbatches=mb,
                     global_batch=global_batch, seq_len=seq_len)
    rec.update(arch=arch, shape=shape_name, mesh=dict(mesh.shape),
               chips=mesh_chip_count(mesh), kind=sh["kind"], microbatches=mb,
               n_periods=cfg.n_periods, period=cfg.period)
    return rec


# ------------------------------------------------------------- sven cells ---

#: JAX's shapes: (n, p) and how X is split over the flat mesh
SVEN_SHAPES = {"sven_gram_nggp": (1 << 20, 8192), "sven_hess_pggn": (4096, 1 << 20)}


def sven_floor(which: str, mesh_size: int, variant: str = "blocks") -> dict:
    """The per-device work of a sven cell, a floor by formula (the same for
    whatever implements the cell): the Gram does the symmetric half of
    A^T A, A = [X_loc, y_loc] (2 n_loc q(q + 1) / 2 FLOPs, q = p + 1),
    reads X_loc and y_loc and writes K (2p x 2p, float32); H v reads X's
    block once and does 4 n p_loc FLOPs. The plain product computes the
    full A^T A, twice the CUDA Gram's work, so FLOPs counted on it would
    let a Gram read above its bound."""
    n, p = SVEN_SHAPES[which]
    if which == "sven_gram_nggp":
        n_loc, q = n // mesh_size, p + 1
        item = 2 if variant == "blocks_bf16" else 4
        return {"flops": float(n_loc * q * (q + 1)),
                "bytes": float(n_loc * p * item + n_loc * item + (2 * p) ** 2 * 4),
                "n_loc": n_loc, "p": p}
    p_loc = p // mesh_size
    return {"flops": float(4 * n * p_loc), "bytes": float(n * p_loc * 4), "n": n,
            "p_loc": p_loc}


def lower_sven_cell(which: str, mesh: dist.Mesh, variant: str = "blocks") -> dict:
    """The paper's own distributed hot ops at genetics scale, rank 0's part
    on meta operands over the flat mesh (every rank along every axis):
    `sven_gram_nggp` is `distributed_gram` at n = 2^20, p = 8,192, rows
    split (variant "blocks"; "blocks_bf16" on bfloat16 X; "paper" the
    materialized Zhat, `distributed_gram_paper`); `sven_hess_pggn` is
    `make_distributed_hessian_matvec` at n = 4,096, p = 2^20, columns
    split. Both run `core/distributed.py`'s plain products, so no kernel
    body is looked up for the meta operands (the registry has none for
    them). Collectives come from the counting mode, FLOPs and bytes from
    `sven_floor`."""
    from repro_torch.core.distributed import (distributed_gram, distributed_gram_paper,
                                              make_distributed_hessian_matvec)

    n, p = SVEN_SHAPES[which]
    if which == "sven_gram_nggp":
        dtype = torch.bfloat16 if variant == "blocks_bf16" else torch.float32
        X = torch.empty((n, p), dtype=dtype, device="meta")
        y = torch.empty((n,), dtype=dtype, device="meta")
        fn = distributed_gram_paper if variant == "paper" else distributed_gram
        with _counting() as c:
            fn(mesh, X, y, 1.5)
    elif which == "sven_hess_pggn":
        X = torch.empty((n, p), dtype=torch.float32, device="meta")
        y = torch.empty((n,), dtype=torch.float32, device="meta")
        act = torch.empty((2 * p,), dtype=torch.float32, device="meta")
        v = torch.empty((n,), dtype=torch.float32, device="meta")
        with _counting() as c:
            make_distributed_hessian_matvec(mesh, X, y, 1.5, 10.0)(v, act)
    else:
        raise ValueError(which)
    floor = sven_floor(which, mesh.size, variant)
    colls = _collective_record(c["collectives"], mesh)
    return dict(lower_s=round(c["seconds"], 2), flops=floor["flops"],
                corrected_flops=floor["flops"], bytes_accessed=floor["bytes"],
                corrected_bytes=floor["bytes"], flops_counted_plain=c["flops"],
                collectives=colls, corrected_collectives=colls,
                collectives_by_axis=c["collectives"], arch=which, shape="paper",
                kind="sven", variant=variant, mesh=dict(mesh.shape),
                chips=mesh_chip_count(mesh))


SVEN_CELLS = ["sven_gram_nggp", "sven_hess_pggn"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/torch_artifacts")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--include-sven", action="store_true",
                    help="also count the sven cells (with any --arch)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    results = []
    t_all = time.perf_counter()
    for multi in meshes:
        mesh = spec_mesh(multi)
        mesh_tag = "pod2x16x16" if multi else "pod16x16"
        cells = [(a, "paper") if a in SVEN_CELLS else (a, s) for a in archs
                 for s in (["paper"] if a in SVEN_CELLS else shapes)]
        if args.include_sven:
            cells += [(a, "paper") for a in SVEN_CELLS if a not in archs]
        for a, s in dict.fromkeys(cells):
            if s == "long_500k" and not get_meta(a).long_500k:
                rec = {"arch": a, "shape": s, "mesh_tag": mesh_tag, "status": "skipped",
                       "reason": get_meta(a).long_500k_note}
                _write(args.out, a, s, mesh_tag, rec)
                print(f"[dryrun] SKIP {a} x {s} ({mesh_tag})", flush=True)
                continue
            path = _path(args.out, a, s, mesh_tag)
            if os.path.exists(path) and not args.force:
                try:
                    with open(path) as fh:
                        cached = json.load(fh)
                except (OSError, ValueError):
                    cached = {"status": "error"}
                if cached.get("status") != "error":
                    print(f"[dryrun] cached {a} x {s} ({mesh_tag})", flush=True)
                    continue
            print(f"[dryrun] counting {a} x {s} ({mesh_tag}) ...", flush=True)
            try:
                rec = lower_sven_cell(a, mesh) if a in SVEN_CELLS else lower_cell(a, s, mesh)
                rec["status"] = "ok"
                rec["mesh_tag"] = mesh_tag
                print(f"[dryrun] OK {a} x {s} ({mesh_tag}): flops={rec['flops']:.3e} "
                      f"held={rec.get('peak_bytes_per_device', 0) / 2**30:.2f}GiB "
                      f"count={rec['lower_s']}s", flush=True)
            except Exception as e:  # noqa: BLE001 — recorded, the run goes on
                rec = {"arch": a, "shape": s, "mesh_tag": mesh_tag, "status": "error",
                       "error": str(e), "traceback": traceback.format_exc()[-4000:]}
                print(f"[dryrun] FAIL {a} x {s} ({mesh_tag}): {e}", flush=True)
            _write(args.out, a, s, mesh_tag, rec)
            results.append(rec)
    n_err = sum(1 for r in results if r.get("status") == "error")
    print(f"[dryrun] finished: {len(results)} counted, {n_err} errors, "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    return 1 if n_err else 0


def _path(out, arch, shape, mesh_tag):
    return os.path.join(out, f"{arch}__{shape}__{mesh_tag}.json")


def _write(out, arch, shape, mesh_tag, rec):
    with open(_path(out, arch, shape, mesh_tag), "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    raise SystemExit(main())
