"""Mesh builders: the port of `repro/launch/mesh.py`. Functions, not module
constants: importing this module touches no process group.

"Whatever this host has" is the world of the default process group
(`dist.launch` starts one a rank), or one rank when none is initialized.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch import dist


def make_production_mesh(*, multi_pod: bool = False) -> dist.Mesh:
    """16x16 = 256 chips/pod (data, model); multi_pod prepends a 2-pod axis.
    Raises ValueError over a world of another size, as `jax.make_mesh`
    does with too few devices. To resolve specs at this shape without the
    ranks, build `dist.Mesh(axes=..., sizes=...)`, which resolves specs
    only."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = dist.data_mesh()
    if mesh.size != math.prod(sizes):
        raise ValueError(f"make_production_mesh: a mesh of shape {sizes} needs "
                         f"{math.prod(sizes)} ranks, and this process group has "
                         f"{mesh.size}")
    return dist.with_views(dataclasses.replace(mesh, axes=axes, sizes=sizes))


def make_local_mesh(model_axis: int = 1) -> dist.Mesh:
    """Whatever this host has, as a (data, model) mesh of (n // model_axis,
    model_axis) ranks, with a process group for each slice along each axis
    (`dist.with_views`: on 4 ranks `make_local_mesh(2)` is (2, 2), its
    "data" views {0, 2} and {1, 3}, its "model" views {0, 1} and {2, 3}) —
    used by tests, examples and the train launcher (usually one rank).
    Every rank must call it alike."""
    mesh = dist.data_mesh()
    if mesh.size % model_axis:
        raise ValueError(f"make_local_mesh: model_axis {model_axis} does not divide "
                         f"{mesh.size} ranks")
    return dist.with_views(dataclasses.replace(mesh, axes=("data", "model"),
                                               sizes=(mesh.size // model_axis, model_axis)))


def mesh_chip_count(mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n
