"""Tree -> sharding records through the logical rule table: the port of
`repro/dist/shardings.py`, and the placement that JAX's `jit` does with
`in_shardings`.

`params_shardings` walks a parameter tree (tensors, on the "meta" device
too: only shapes are read) and recognizes the module sub-dicts by their
key signatures (attention / MLA / MoE / dense MLP / SSM / embedding /
norm), applying each module's own `*_sharding()` logical spec. Unknown
leaves fall back to replicated; the `fsdp` rule (when set) then widens
every weight's first unsharded divisible dim (FSDP without per-arch spec
tables). Each leaf gets a `Sharding` record: its mesh, one entry per dim
(a mesh axis, a tuple of axes, or None) and the leaf's global shape.

**Stacked layers.** JAX stacks the body's layers across periods for its
`lax.scan` and resolves each stacked leaf (periods, ...) whole, so a
widening may land on the stacked dim: on a 16 x 16 mesh every body leaf
of qwen2.5-14b takes `fsdp` there, whole layers a block. The
port holds one dict a layer; given the config, a body layer's record
carries the stacked dim's entry apart (`stack`), with the layer's index
in its stack and the stack's size, so the port's tree gives, leaf for
leaf, the layout JAX gives (`convert.model_params_from_jax` unstacks the
same way). A rank holds a stacked leaf whole when its block of the stack
holds the layer, and nothing of it otherwise.

All resolvers require an active `dist.mesh_context`; the mesh and rule
table come from it, never from arguments. `place` keeps each rank's block
of a tree by its records, `reblock` cuts a block by one record to the
block of a record that splits more, `gather_leaf` / `gather_tree` rebuild
a leaf over the axes one record splits and another does not (over each
split axis's view only: on a (2, 2) mesh a leaf split over "model" alone
is gathered over its "model" view, not summed once per data replica),
`run_sharded` is `jax.jit(step_fn, in_shardings=...)` for a train
step: each rank keeps its blocks, the step runs on them, and the
parameters and moments come back in their records' layout. `run_prefill`
and `run_decode` are the dry run's two serving kinds
(`launch/dryrun.py`: `in_shardings=(p_sh, b_sh)`, and `(p_sh, tok_sh,
c_sh)` with the caches donated): the parameters, the batch rows and the
caches kept as each rank's blocks, the caches returned in their records'
layout, the last logits whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.dist import (Mesh, _axis_size, all_reduce_, broadcast, current_context,
                              resolve_spec)
from repro_torch.dist.zero import _widen_spec
from repro_torch.utils import tree_map

# cache NamedTuple field signatures -> per-field logical specs
_CACHE_SPECS = {
    ("k", "v", "pos"): {                      # attention KVCache
        "k": ("batch", "seq_kv", "kv_heads", None),
        "v": ("batch", "seq_kv", "kv_heads", None),
        "pos": ()},
    ("c_kv", "k_rope", "pos"): {              # MLACache (latent + rope keys)
        "c_kv": ("batch", "seq_kv", None),
        "k_rope": ("batch", "seq_kv", None),
        "pos": ()},
    ("conv", "h"): {                          # SSMCache
        "conv": ("batch", None, "ssm_inner"),
        "h": ("batch", "ssm_heads", None, None)},
}


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """How a leaf lies on `mesh`: `spec` holds one entry per dim of the
    leaf (a mesh axis, a tuple of axes, or None), `shape` is the global
    leaf's. A body layer's record also holds the entry JAX gives the
    stacked dim (`stack`), the layer's index in its stack and the stack's
    size (None off the stack)."""

    mesh: Mesh
    spec: tuple
    shape: tuple = ()
    stack: Any = None
    stack_index: Optional[int] = None
    stack_size: Optional[int] = None

    def uses(self, axis: str) -> bool:
        """Whether any dim, the stacked one included, is split over `axis`."""
        entries = self.spec + ((self.stack,) if self.stack_size is not None else ())
        return any(e == axis or (isinstance(e, tuple) and axis in e) for e in entries)

    def split_axes(self) -> tuple:
        """The axes of more than one rank that a dim (the stacked one
        included) is split over, in the mesh's order."""
        return tuple(a for a, n in self.mesh.shape.items() if n > 1 and self.uses(a))

    def only(self, axes) -> "Sharding":
        """This record with the entries over axes outside `axes` dropped
        (the stack's too): the layout once those axes are gathered."""
        keep = set(axes)

        def entry(e):
            if e is None:
                return None
            inside = {e} if isinstance(e, str) else set(e)
            if inside <= keep:
                return e
            if inside & keep:
                raise ValueError(f"a spec entry {e} splits a dim over axes in and out of "
                                 f"{sorted(keep)}")
            return None

        return dataclasses.replace(self, spec=tuple(entry(e) for e in self.spec),
                                   stack=entry(self.stack) if self.stack_size is not None
                                   else self.stack)


def _require_ctx():
    ctx = current_context()
    if ctx is None:
        raise RuntimeError("dist.shardings resolvers require an active "
                           "dist.mesh_context(mesh, rules=...)")
    return ctx


def _module_specs(d: dict):
    """Match a params sub-dict to its module's logical sharding spec."""
    from repro_torch.models.attention import attention_sharding
    from repro_torch.models.layers import mlp_sharding
    from repro_torch.models.mla import mla_sharding
    from repro_torch.models.moe import MoEConfig, moe_sharding
    from repro_torch.models.ssm import ssm_sharding

    keys = set(d)
    if {"w_dq", "w_uq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo"} <= keys:
        return mla_sharding(None)
    if {"wq", "wk", "wv", "wo"} <= keys:
        return attention_sharding(qkv_bias="bq" in keys)
    if {"router", "w_gate", "w_up", "w_down"} <= keys:
        return moe_sharding(MoEConfig(n_shared=int("shared" in keys)))
    if {"w_gate", "w_up", "w_down"} <= keys:
        return mlp_sharding()
    if {"w_in", "conv_w", "a_log"} <= keys:
        return ssm_sharding(None)
    if keys == {"table"}:
        return {"table": ("vocab", "embed")}
    if keys == {"scale"}:
        return {"scale": (None,)}
    return None


def _align(names, ndim: int) -> tuple:
    """Pad a logical spec to `ndim` dims (stacked leaves get leading Nones);
    a spec that cannot match the rank resolves fully replicated."""
    names = tuple(names) if names is not None else ()
    if len(names) > ndim:
        return (None,) * ndim
    return (None,) * (ndim - len(names)) + names


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _leaf_sharding(leaf, names, mesh, rules, fsdp=None, stack=None) -> Sharding:
    """The leaf's record; `stack` = (index, size) resolves it as JAX
    resolves its stacked leaf, the stack's dim first."""
    shape = _shape(leaf)
    full = shape if stack is None else (stack[1],) + shape
    spec = resolve_spec(_align(names, len(full)), full, mesh, rules)
    if fsdp is not None and fsdp in mesh.shape:
        spec = _widen_spec(spec, full, fsdp, mesh)
    if stack is None:
        return Sharding(mesh, tuple(spec), shape)
    return Sharding(mesh, tuple(spec[1:]), shape, stack=spec[0], stack_index=stack[0],
                    stack_size=stack[1])


def _walk(node, spec, leaf_fn):
    if node is None:
        return None
    if isinstance(node, dict):
        sub = spec if isinstance(spec, dict) else (_module_specs(node) or {})
        return {k: _walk(v, sub.get(k), leaf_fn) for k, v in node.items()}
    if hasattr(node, "_fields"):              # NamedTuple (cache containers)
        sub = _CACHE_SPECS.get(node._fields, spec if isinstance(spec, dict) else {})
        return type(node)(*(_walk(getattr(node, f), sub.get(f), leaf_fn)
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, spec, leaf_fn) for v in node)
    return leaf_fn(node, spec if isinstance(spec, (tuple, list)) else None)


def _walk_layers(tree, cfg, leaf_fn):
    """`_walk` over a tree of the port's layout; given `cfg`, each body
    layer of `tree["layers"]` resolves as its period stack in JAX's tree
    (`leaf_fn(leaf, names, stack)`). A depth cut whose body is not a whole
    number of periods has no stacked tree in JAX; its layers resolve one
    by one."""
    if (cfg is None or not isinstance(tree, dict) or "layers" not in tree
            or cfg.n_body % cfg.period):
        return _walk(tree, None, lambda leaf, names: leaf_fn(leaf, names, None))
    out = {k: _walk(v, None, lambda leaf, names: leaf_fn(leaf, names, None))
           for k, v in tree.items() if k != "layers"}
    layers = []
    for i, layer in enumerate(tree["layers"]):
        stack = None
        if i >= cfg.dense_prefix:
            stack = ((i - cfg.dense_prefix) // cfg.period, cfg.n_periods)
        layers.append(_walk(layer, None, lambda leaf, names, s=stack: leaf_fn(leaf, names, s)))
    out["layers"] = layers
    return {k: out[k] for k in tree}


def params_shardings(params, cfg=None):
    """Parameter tree -> Sharding tree. With the model's `cfg`, a body
    layer's leaves resolve as JAX's stacked leaves (`Sharding.stack`)."""
    mesh, rules = _require_ctx()
    fsdp = rules.get("fsdp")
    return _walk_layers(params, cfg, lambda leaf, names, stack: _leaf_sharding(
        leaf, names, mesh, rules, fsdp=fsdp, stack=stack))


def batch_shardings(batch):
    """Model-input tree -> records: dim 0 is the global batch ("batch"
    rule, normally the data axis), everything else replicated."""
    mesh, rules = _require_ctx()

    def leaf(x):
        names = ("batch",) + (None,) * (max(x.dim(), 1) - 1)
        return _leaf_sharding(x, names[:x.dim()], mesh, rules)

    return tree_map(leaf, batch)


def cache_shardings(caches, cfg=None):
    """Decode-cache tree -> records via the cache-container signatures
    (KVCache / MLACache / SSMCache); with `cfg`, body caches align as
    JAX's stacked ones. A cache's `pos` (a Python int) gets spec ()."""
    mesh, rules = _require_ctx()
    return _walk_layers(caches, cfg, lambda leaf, names, stack: _leaf_sharding(
        leaf, names, mesh, rules, stack=stack if hasattr(leaf, "shape") else None))


def replicated(x):
    """Fully replicated records on the active mesh, matching x."""
    mesh, _ = _require_ctx()
    return tree_map(lambda leaf: Sharding(mesh, (), _shape(leaf)), x)


# -- placement ------------------------------------------------------------------

def _coord(mesh: Mesh, entry) -> int:
    """This rank's block index along a spec entry (an axis or a tuple of
    axes, row-major)."""
    c = 0
    for a in (entry,) if isinstance(entry, str) else entry:
        c = c * mesh.shape[a] + mesh.coord(a)
    return c


def _owns(rec: Sharding) -> bool:
    """Whether this rank's block of the stack holds the record's layer."""
    if rec.stack is None or rec.stack_size is None:
        return True
    per = rec.stack_size // _axis_size(rec.mesh, rec.stack)
    return _coord(rec.mesh, rec.stack) == rec.stack_index // per


def _split(mesh: Mesh, entry) -> bool:
    return entry is not None and _axis_size(mesh, entry) > 1


def _narrow(x: torch.Tensor, have: Optional[Sharding], want: Sharding) -> torch.Tensor:
    """x, a block by `have` (the global leaf when None), narrowed to its
    block by `want` (a view), which splits every dim `have` splits alike."""
    h_stack = have.stack if have is not None else None
    if _split(want.mesh, h_stack) and h_stack != want.stack:
        raise ValueError(f"a block by {have.spec} / stack {h_stack} is not cut from one by "
                         f"{want.spec} / stack {want.stack}")
    if h_stack != want.stack and not _owns(want):
        x = x[:0]
    for d, entry in enumerate(want.spec):
        h = have.spec[d] if have is not None and d < len(have.spec) else None
        if h == entry:
            continue
        if _split(want.mesh, h):
            raise ValueError(f"a block by {have.spec} is not cut from one by {want.spec}")
        if entry is not None:
            n = x.shape[d] // _axis_size(want.mesh, entry)
            x = x.narrow(d, _coord(want.mesh, entry) * n, n)
    return x


def block(x: torch.Tensor, rec: Sharding) -> torch.Tensor:
    """This rank's block of the global leaf x (a view): each split dim
    narrowed to the rank's slot, and no rows of a stacked leaf whose layer
    lies in another rank's block of the stack (its other dims narrowed
    alike)."""
    return _narrow(x, None, rec)


def reblock(tree, have, want):
    """Each leaf of `tree`, a block by its record in `have` (global leaves
    when `have` is None: `place`), cut to its block by `want`, whose records
    split every dim `have`'s split alike and may split more (a parameter's
    block to its ZeRO-1 moments' block)."""
    if have is None:
        return place(tree, want)
    if want is None:
        return tree
    return tree_map(lambda x, h, w: x if w is None or not isinstance(x, torch.Tensor)
                    else _narrow(x, h, w), tree, have, want)


def block_shape(rec: Sharding) -> tuple:
    spec = tuple(rec.spec) + (None,) * (len(rec.shape) - len(rec.spec))
    shape = tuple(n // _axis_size(rec.mesh, e) if e is not None else n
                  for n, e in zip(rec.shape, spec))
    return shape if _owns(rec) else (0,) + shape[1:]


def place(tree, shardings):
    """Each rank's blocks of `tree` by its records (`jax.device_put`): a
    leaf of its record's global shape is cut to the rank's block (a copy of
    its own, so the global leaf can be freed), a leaf already of the
    block's shape is kept. A None record (or tree of records) keeps the
    leaves as they are."""
    if shardings is None:
        return tree

    def put(x, rec):
        if rec is None or not isinstance(x, torch.Tensor):
            return x
        if tuple(x.shape) == tuple(rec.shape):
            b = block(x, rec)
            return b if b.numel() == x.numel() else b.clone(memory_format=torch.contiguous_format)
        if tuple(x.shape) == block_shape(rec):
            return x
        raise ValueError(f"place: a leaf of shape {tuple(x.shape)} is neither the record's "
                         f"global shape {rec.shape} nor its block {block_shape(rec)}")

    return tree_map(put, tree, shardings)


def gather_leaf(x: torch.Tensor, rec: Sharding, to: Optional[Sharding] = None) -> torch.Tensor:
    """The block by `to` (the global leaf when None) from each rank's block
    x by `rec`, gathered over each axis `rec` splits and `to` does not, on
    that axis's view only. A stacked leaf gathered over its stack's axis
    alone is broadcast from the rank that owns the layer; otherwise each
    axis is an all-reduce of a zero-filled buffer holding this rank's
    block, exact (the other ranks add zeros; -0.0 becomes +0.0). x itself
    when there is nothing to gather."""
    to = rec.only(()) if to is None else to
    axes = [a for a in rec.split_axes() if a not in to.split_axes()]
    if not axes:
        return x
    if axes == [rec.stack]:
        view = rec.mesh.view(rec.stack)
        owner = rec.stack_index // (rec.stack_size // view.size)
        if _owns(rec):
            if tuple(x.shape) != block_shape(to):
                raise ValueError(f"gather_leaf: the owner's block {tuple(x.shape)} is not "
                                 f"the block {block_shape(to)} it is gathered to")
            return broadcast(view, x.contiguous(), owner)
        return broadcast(view, x.new_empty(block_shape(to)), owner)
    full = x.new_zeros(block_shape(to))
    if x.numel():
        _narrow(full, to, rec).copy_(x)
    for a in axes:
        full = all_reduce_(rec.mesh.view(a), full)
    return full


def gather_tree(tree, shardings):
    """The global tree on every rank from its blocks (`gather_leaf`)."""
    if shardings is None:
        return tree
    return tree_map(lambda x, rec: x if rec is None or not isinstance(x, torch.Tensor)
                    else gather_leaf(x, rec), tree, shardings)


def run_sharded(step_fn: Callable, in_shardings: tuple, params, opt_state, batch,
                donate: bool = False):
    """`jax.jit(step_fn, in_shardings=(p_sh, o_sh, b_sh))(params, opt_state,
    batch)` for a step of `train.step.make_train_step`: each rank keeps its
    blocks of the parameters and the optimizer state by their records
    (global operands are cut, blocks kept) and the step runs on them,
    returning the parameters and the moments in their records' layout: a
    rank under FSDP or tensor parallelism keeps only its blocks between
    steps, as JAX's donated operands do. The batch crosses whole: the step
    keeps each microbatch's block of it by `b_sh`, as JAX splits the
    global batch into microbatches first. `donate` is JAX's
    `donate_argnums=(0, 1)` (`launch/dryrun.py`): the step may overwrite
    the blocks it is handed, which the caller must not use again."""
    p_sh, o_sh, b_sh = in_shardings
    return step_fn(place(params, p_sh), place(opt_state, o_sh), batch,
                   shardings=(p_sh, o_sh, b_sh), donate=donate)


def cut_whole(x: torch.Tensor, rec: Optional[Sharding]) -> torch.Tensor:
    """x, which holds this rank's block of some dims and others whole (the
    global leaf's size), with each whole dim that `rec` splits narrowed to
    the rank's block (a view); x itself under a None record."""
    if rec is None:
        return x
    for d, entry in enumerate(rec.spec):
        if _split(rec.mesh, entry) and x.shape[d] == rec.shape[d]:
            n = x.shape[d] // _axis_size(rec.mesh, entry)
            x = x.narrow(d, _coord(rec.mesh, entry) * n, n)
    return x


def dim_view(rec: Optional[Sharding], dim: int) -> Optional[Mesh]:
    """The view of the one mesh axis of more than one rank that `rec`
    splits `dim` over, or None (a tuple of axes raises)."""
    entry = rec.spec[dim] if rec is not None and dim < len(rec.spec) else None
    if not _split(rec.mesh if rec is not None else None, entry):
        return None
    if not isinstance(entry, str):
        raise NotImplementedError(f"a dim split over the axes {entry} at once")
    return rec.mesh.view(entry)


def _rows(x: torch.Tensor, rec: Optional[Sharding]) -> torch.Tensor:
    """The global rows of x, this rank's block of rows by `rec` (a batch
    leaf's record; its other dims whole), on every rank; x when `rec` is
    None."""
    if rec is None:
        return x
    lead = Sharding(rec.mesh, rec.spec[:1], tuple(rec.shape[:1]) + tuple(x.shape[1:]))
    return gather_leaf(x, lead)


def run_prefill(step_fn: Callable, in_shardings: tuple, params, batch):
    """`jax.jit(prefill_step, in_shardings=(p_sh, b_sh))(params, batch)` for
    a step of `serve.engine.make_prefill_step`: each rank keeps its blocks
    of the parameters (global leaves are cut, blocks kept) and its rows of
    the batch, and the step runs on them. Returns (the last position's
    logits, whole: every row and the whole vocabulary, on every rank; the
    caches as this rank's blocks by `cache_shardings`). `in_shardings`
    None runs the step on the whole tensors."""
    p_sh, b_sh = in_shardings or (None, None)
    logits, caches = step_fn(place(params, p_sh), place(batch, b_sh), shardings=in_shardings)
    return _rows(logits, None if b_sh is None else b_sh["tokens"]), caches


def run_decode(step_fn: Callable, in_shardings: tuple, params, tokens, caches):
    """`jax.jit(decode_step, in_shardings=(p_sh, tok_sh, c_sh),
    donate_argnums=(2,))(params, tokens, caches)` for a step of
    `serve.engine.make_decode_step`: the parameters and the caches as
    this rank's blocks (global leaves cut, blocks kept), the tokens its
    rows. The caches are donated: the step writes the KV and latent blocks
    in place and returns the new caches in their records' layout. Returns
    (logits whole on every rank, caches); `in_shardings` None runs the step
    on the whole tensors."""
    p_sh, tok_sh, c_sh = in_shardings or (None, None, None)
    logits, caches = step_fn(place(params, p_sh), place(tokens, tok_sh), place(caches, c_sh),
                             shardings=in_shardings)
    return _rows(logits, tok_sh), caches
