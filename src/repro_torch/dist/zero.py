"""ZeRO-1 optimizer-state sharding: the port of `repro/dist/zero.py`.

Optimizer moments don't enter the forward/backward math, so they can shard
wider than the parameters they mirror: `_widen_spec` adds the data axis to
the first unsharded dim it divides. Each rank then holds its block of
AdamW's m and v, so optimizer memory a rank drops by the data axis's size
while the parameters' records stay as they are; the train step updates
each rank's block and gathers the parameters back
(`train/step.py`), where XLA inserts that gather for JAX.
"""
from __future__ import annotations

import dataclasses

from repro_torch.utils import tree_map


def _uses_axis(entry, axis: str) -> bool:
    if entry is None:
        return False
    if isinstance(entry, (tuple, list)):
        return axis in entry
    return entry == axis


def _widen_spec(spec: tuple, shape: tuple, axis: str, mesh) -> tuple:
    """Add `axis` to the FIRST unsharded dim of `spec` that it divides.

    Specs already using `axis`, and shapes with no unsharded dim divisible by
    the axis size, are returned unchanged. Only `mesh.shape` is consulted, so
    any object with a `.shape` axis->size mapping works.
    """
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(_uses_axis(e, axis) for e in entries):
        return spec
    size = mesh.shape[axis]
    for i, (entry, dim) in enumerate(zip(entries, shape)):
        if entry is None and dim % size == 0:
            entries[i] = axis
            return tuple(entries)
    return spec


def zero1_shardings(param_shardings, param_shapes, axis: str = "data"):
    """Sharding records for optimizer moments: each parameter's record
    widened over `axis` (ZeRO-1). The trees must match (`param_shapes`'
    leaves are anything with a `.shape`); meshes without `axis` pass
    through. A stacked leaf's record is widened over its stacked shape
    (the stack's dim first), as JAX widens the stacked leaf. A record that
    already splits a dim over `axis` (an FSDP leaf) is kept: its moments
    are its parameter blocks. A record split over "model" is widened on
    another dim, so each rank's moment block is a part of its parameter
    block."""

    def widen(sh, leaf):
        if axis not in sh.mesh.shape:
            return sh
        if sh.stack_size is None:
            return dataclasses.replace(
                sh, spec=_widen_spec(sh.spec, tuple(leaf.shape), axis, sh.mesh))
        stacked = _widen_spec((sh.stack,) + tuple(sh.spec),
                              (sh.stack_size,) + tuple(leaf.shape), axis, sh.mesh)
        return dataclasses.replace(sh, stack=stacked[0], spec=tuple(stacked[1:]))

    return tree_map(widen, param_shardings, param_shapes)
