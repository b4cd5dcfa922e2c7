"""Collectives over per-shard lists of tensors, in one process.

The JAX package runs its distributed join as one program under
``shard_map`` and exchanges data with ``lax`` collectives.  Here one
controller holds every shard: a distributed value is a list with one
tensor a shard (shard ``d`` on ``mesh.shard_devices[d]``), and these
functions give ``lax``'s semantics over such lists:

- a collective over ``axis`` (one axis name, or a tuple of names) acts
  within groups: the shards that share their coordinates on every other
  axis.  A member's index in its group (``axis_index``) is its row-major
  position over the named axes, in the order named.  On a ``(H, C)``
  mesh named ``("host", "chip")``, shard ``d = h*C + c``; its ``"chip"``
  group is ``(h, 0..C-1)``, its ``"host"`` group ``(0..H-1, c)``;
- ``all_to_all`` is ``lax.all_to_all(x, axis, split_axis=0,
  concat_axis=0)``: chunk ``j`` of member ``i`` goes to member ``j``, and
  each member concatenates what it receives in source order;
- ``all_gather``, ``psum`` and ``pmax`` give every member of a group the
  same value: it is made once per device and shared by the group's
  shards there, not copied once a shard.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch

from .mesh import Mesh


def _axis_dims(mesh: Mesh, axis) -> List[int]:
    names = axis if isinstance(axis, tuple) else (axis,)
    missing = [a for a in names if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axes {missing} are not mesh axes "
                         f"{mesh.axis_names}")
    return [mesh.axis_names.index(a) for a in names]


def groups(mesh: Mesh, axis) -> List[List[int]]:
    """The shard indices of each group over ``axis``, members in order."""
    dims = _axis_dims(mesh, axis)
    rest = [i for i in range(mesh.ndim) if i not in dims]
    ids = np.arange(mesh.size).reshape(mesh.shape).transpose(rest + dims)
    return ids.reshape(-1, math.prod(mesh.shape[i] for i in dims)).tolist()


def axis_index(mesh: Mesh, axis) -> List[int]:
    """Each shard's index in its group (``lax.axis_index``)."""
    out = [0] * mesh.size
    for g in groups(mesh, axis):
        for m, d in enumerate(g):
            out[d] = m
    return out


def all_to_all(xs: Sequence[torch.Tensor], mesh: Mesh,
               axis) -> List[torch.Tensor]:
    """Split each shard's tensor along dim 0 into one chunk a group member;
    member ``j`` receives chunk ``j`` of every member, concatenated along
    dim 0 in source order."""
    devices = mesh.shard_devices
    out: List[torch.Tensor] = [None] * len(xs)
    for g in groups(mesh, axis):
        for d in g:
            if xs[d].shape[0] % len(g):
                raise ValueError(f"dim 0 of {tuple(xs[d].shape)} does not "
                                 f"split into {len(g)} chunks")
        chunks = [xs[d].chunk(len(g)) for d in g]
        for j, d in enumerate(g):
            out[d] = torch.cat([c[j].to(devices[d]) for c in chunks])
    return out


def _replicated(xs: Sequence[torch.Tensor], mesh: Mesh, axis,
                combine: Callable[[List[torch.Tensor]], torch.Tensor]
                ) -> List[torch.Tensor]:
    """``combine`` of each group's tensors, made once per device of the
    group and shared by the group's shards on that device."""
    devices = mesh.shard_devices
    out: List[torch.Tensor] = [None] * len(xs)
    for g in groups(mesh, axis):
        made = {}
        for d in g:
            dev = devices[d]
            if dev not in made:
                made[dev] = combine([xs[s].to(dev) for s in g])
            out[d] = made[dev]
    return out


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, axis,
               tiled: bool = False) -> List[torch.Tensor]:
    """The group's tensors in member order: stacked on a new dim 0, or
    concatenated along dim 0 with ``tiled``.  Ragged tensors concatenate
    too (each shard's part of a residual buffer, say)."""
    return _replicated(xs, mesh, axis, torch.cat if tiled else torch.stack)


def psum(xs: Sequence[torch.Tensor], mesh: Mesh, axis) -> List[torch.Tensor]:
    """The group's elementwise sum."""
    return _replicated(xs, mesh, axis, lambda ts: torch.stack(ts).sum(0))


def pmax(xs: Sequence[torch.Tensor], mesh: Mesh, axis) -> List[torch.Tensor]:
    """The group's elementwise maximum."""
    return _replicated(xs, mesh, axis, lambda ts: torch.stack(ts).amax(0))
