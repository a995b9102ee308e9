"""Partition specs as DTensor placements, and trees placed or gathered.

A spec entry ``"model"`` on array dim ``d`` is ``Shard(d)`` on the mesh dim
named ``model``; ``("pod", "data")`` is ``Shard(d)`` on both, in mesh order,
so the dim is split pod-major as GSPMD splits it.  A dim that does not
divide (the planner's ``allow_uneven``) is split as DTensor and GSPMD both
split it: shards of ``ceil(n / k)`` and short (or empty) last ones.

Every rank holds the whole tree when it places one (each draws it from the
same seed, or reads the same checkpoint) and keeps its own slice: no
collective.  :func:`gather_full` is one ``all_gather_into_tensor`` a leaf,
over the ranks that hold its distinct pieces.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_group
from repro_torch.sharding.ctx import all_gather_flat
from repro_torch.sharding.spec import P, entry_axes

__all__ = ["placements", "local_slices", "shard_tensor", "shard_tree",
           "spec_of", "gather_full", "gather_tree", "local_rows"]


def _axis_dims(spec: tuple | None, ndim: int) -> list[tuple[str, ...]]:
    spec = tuple(spec or ())
    return [entry_axes(e) for e in spec + (None,) * (ndim - len(spec))]


def placements(spec: tuple | None, mesh, ndim: int | None = None) -> list:
    """The DTensor placements (one per mesh dim) of ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    ndim = len(spec or ()) if ndim is None else ndim
    for d, axes in enumerate(_axis_dims(spec, ndim)):
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} are not in mesh order "
                             f"{names}")
        for a in axes:
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            out[i] = Shard(d)
    return out


def local_slices(shape: tuple[int, ...], spec: tuple | None,
                 axes: dict[str, int], coord: dict[str, int]
                 ) -> tuple[slice, ...]:
    """The slice of an array of ``shape`` that the rank at ``coord`` (axis
    name → index) holds under ``spec``: each dim chunked over its axes in
    mesh order, ``ceil`` sized as ``torch.chunk`` cuts."""
    out = []
    for n, dim_axes in zip(shape, _axis_dims(spec, len(shape))):
        start, length = 0, n
        for a in dim_axes:
            c = -(-length // axes[a])
            s = min(coord[a] * c, length)
            start, length = start + s, min(c, length - s)
        out.append(slice(start, start + length))
    return tuple(out)


def _coord(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _axes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def shard_tensor(full: torch.Tensor, spec: tuple | None, mesh):
    """This rank's slice of ``full`` (the same on every rank) as a DTensor
    of the global shape: ``full`` itself where the rank holds all of it,
    else a copy of the slice (``full`` may then be freed)."""
    from torch.distributed.tensor import DTensor

    full = full.contiguous()
    local = full[local_slices(tuple(full.shape), spec, _axes(mesh),
                              _coord(mesh))]
    if local.numel() != full.numel():
        local = local.clone()
    return DTensor.from_local(local, mesh, placements(spec, mesh, full.dim()),
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """A nested dict of full tensors as DTensors on ``specs``' placements."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard_tensor(tree, specs, mesh)


def spec_of(x) -> P:
    """The partition spec of a DTensor's placements."""
    from torch.distributed.tensor import Shard

    spec: list = [None] * x.dim()
    for n, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(p, Shard):
            spec[p.dim] = entry_axes(spec[p.dim]) + (n,)
    return P(*spec)


def gather_full(x, over: tuple[str, ...] | None = None) -> torch.Tensor:
    """The tensor of a DTensor gathered over the mesh axes ``over`` (None:
    every axis, the whole tensor), on every rank: one all-gather over the
    ranks that hold its distinct pieces along those axes (each padded to
    the largest).  The result is this rank's slice over the other axes:
    over ``("pod", "data")`` a master sharded over ``data`` (FSDP) and
    ``model`` gives this rank's ``model`` shard, whole along ``data``.  A
    dim split over both a gathered and a kept axis is not taken."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    local = x.to_local()
    axes, coord = _axes(mesh), _coord(mesh)
    names = [n for n, p in zip(mesh.mesh_dim_names, x.placements)
             if isinstance(p, Shard) and axes[n] > 1
             and (over is None or n in over)]
    if not names:                      # no other rank holds a piece
        return local
    spec = spec_of(x)
    shape = tuple(x.shape)
    kept = []
    for e in spec:
        ax = entry_axes(e)
        gone = [a for a in ax if a in names]
        if gone and len(gone) != len(ax):
            raise ValueError(f"gather_full: dim spec {e} mixes gathered axes "
                             f"{names} with kept ones")
        kept.append(None if gone else e)
    region = local_slices(shape, tuple(kept), axes, coord)
    big = tuple(sl.stop - sl.start for sl in local_slices(
        shape, spec, axes, {n: 0 for n in axes}))
    padded = local.new_zeros(big)
    padded[tuple(slice(0, n) for n in local.shape)] = local
    group = axis_group(mesh, tuple(names))
    k = dist.get_world_size(group)
    out = local.new_empty((k * padded.numel(),))
    all_gather_flat(out, padded, group)
    out = out.view((k,) + big)
    full = local.new_empty(tuple(sl.stop - sl.start for sl in region))
    sizes = [axes[n] for n in names]
    for g in range(k):                 # group rank g: its coordinates
        c, rem = dict(coord), g
        for n, size in zip(reversed(names), reversed(sizes)):
            c[n], rem = rem % size, rem // size
        sl = local_slices(shape, spec, axes, c)
        full[tuple(slice(s.start - q.start, s.stop - q.start)
                   for s, q in zip(sl, region))] = out[g][tuple(
                       slice(0, s.stop - s.start) for s in sl)]
    return full


def gather_tree(tree: Any) -> Any:
    """A nested dict of DTensors as full tensors (on every rank)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    return gather_full(tree)


def local_rows(batch: dict, spec: tuple | None, mesh) -> dict:
    """This rank's slice of every leaf of a batch (the same on every rank)
    under ``spec`` (the leading dims; the rest whole)."""
    axes, coord = _axes(mesh), _coord(mesh)
    out = {}
    for key, x in batch.items():
        out[key] = x[local_slices(tuple(x.shape), spec, axes, coord)]
    return out
