"""Meshes on ``torch.distributed``.

The port of the JAX package's ``launch/mesh.py``.  Production meshes:

    single pod  (data=16, model=16)          256 ranks
    multi-pod   (pod=2, data=16, model=16)   512 ranks

The ``pod`` axis extends data parallelism: gradients reduce over (pod,
data), weights are never sharded across pods, so cross-pod traffic is
gradients only (optionally int8-EF compressed, :mod:`repro_torch.train.
compression`).

:func:`abstract_mesh` is the planner's mesh: a
:class:`~repro_torch.sharding.spec.MeshShape`, no process group.
:func:`make_mesh` is a ``DeviceMesh`` over the ranks of the default process
group (NCCL on the card, gloo on the CPU; :func:`init_group` starts one).
Nothing here touches a process group when the module is imported.
"""

from __future__ import annotations

import math
import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device
from repro_torch.sharding.spec import MeshShape

__all__ = ["abstract_mesh", "make_mesh", "make_production_mesh", "mesh_axes",
           "init_group", "axis_group", "PRODUCTION_SHAPES"]

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def abstract_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]
                  ) -> MeshShape:
    """A mesh the planner can read: axis sizes and names, no devices."""
    return MeshShape(tuple(shape), tuple(axis_names))


def init_group(device: torch.device | str | None = None, *,
               init_method: str | None = None, world_size: int = 1,
               rank: int = 0, backend: str | None = None) -> str:
    """Start the default process group unless one is running: NCCL on the
    card (this rank's card set current: ``LOCAL_RANK``'s under
    ``torchrun``), gloo on the CPU, or ``backend`` (gloo on the card lets
    several ranks share one card, which NCCL refuses).  With ``init_method`` (``file://...``,
    ``tcp://...``) it joins ``world_size`` ranks as ``rank``; without, it
    reads ``torchrun``'s variables (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ...) when they are set, else starts a group of this
    one rank on an in-process store.  Returns the backend."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_backend()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    torchrun = init_method is None and "WORLD_SIZE" in os.environ
    if torchrun:
        rank = int(os.environ["RANK"])
    kw: dict[str, Any] = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        card = torch.device("cuda", dev.index if dev.index is not None
                            else local % torch.cuda.device_count())
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw["device_id"] = card
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank, **kw)
    elif torchrun:
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                                rank=0, **kw)
    return backend


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
              device: torch.device | str | None = None):
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks, in
    rank order (the last axis minor)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str | None = None):
    """(data 16, model 16) or (pod 2, data 16, model 16); raises unless the
    process group has that many ranks."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    if not dist.is_initialized():
        raise RuntimeError(f"the production mesh {dict(zip(names, shape))} "
                           "needs a process group of "
                           f"{math.prod(shape)} ranks; none is running")
    return make_mesh(shape, names, device)


def mesh_axes(mesh: Any) -> dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_group(mesh, names: tuple[str, ...]):
    """The process group of this rank's ranks along ``names`` (the other
    coordinates fixed), flattened in mesh order: its group ranks are the
    (pod, data) index pod-major.  Every rank builds every such group on its
    first call (``new_group`` is collective)."""
    order = tuple(n for n in mesh.mesh_dim_names if n in names)
    groups = mesh.__dict__.setdefault("_axis_groups", {})
    if order not in groups:
        ranks = mesh.mesh.cpu().numpy()
        dims = [mesh.mesh_dim_names.index(n) for n in order]
        rest = [d for d in range(ranks.ndim) if d not in dims]
        rows = np.transpose(ranks, rest + dims).reshape(
            -1, math.prod(ranks.shape[d] for d in dims))
        me = dist.get_rank()
        if rows.shape[1] == dist.get_world_size():
            groups[order] = dist.group.WORLD
        else:
            for row in rows:
                group = dist.new_group([int(r) for r in row])
                if me in row:
                    groups[order] = group
    return groups[order]
