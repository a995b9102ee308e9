"""Sharding context: the installed mesh and activation-sharding hints.

The port of the JAX package's ``sharding/ctx.py``.  Model code calls
``shard_act`` with a logical activation name at the reference's points (the
embeddings' output and the residual stream before the final norm:
``"hidden"``; the logits: ``"logits"``), and the launcher installs the
plan's name → spec hints (``Plan.act_specs``).  GSPMD reads them as
constraints; in the port a layer's split is written out
(:mod:`repro_torch.sharding.tp`), so :func:`shard_act` checks instead:
under an installed mesh (:func:`use_mesh`) and hints, each dim that the
hint splits over ``model`` must hold this rank's piece of the model's
whole size, and every other dim but the rows (the caller's batch rows)
the whole size.  ``hidden`` is replicated over ``model``; ``logits`` are
the rank's vocabulary columns.  The values pass unchanged; outside a mesh
or without hints it is the identity.

:func:`use_mesh` also installs the ``DeviceMesh`` whose axes the
collectives of :mod:`repro_torch.train.compression` name, as the
reference's ``shard_map`` region binds its axis names.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Any, Iterator, Sequence

import torch

__all__ = ["use_activation_sharding", "shard_act", "use_mesh", "use_plan",
           "current_mesh", "use_token_group", "token_group", "all_gather_flat"]

_ACT: ContextVar[dict | None] = ContextVar("repro_torch_act_shardings",
                                           default=None)
_MESH: ContextVar[Any] = ContextVar("repro_torch_mesh", default=None)
_TOKENS: ContextVar[Any] = ContextVar("repro_torch_token_group", default=None)


@contextlib.contextmanager
def use_activation_sharding(specs: dict) -> Iterator[None]:
    """Install logical-name → spec hints for the enclosed block."""
    tok = _ACT.set(dict(specs))
    try:
        yield
    finally:
        _ACT.reset(tok)


def shard_act(x: torch.Tensor, name: str,
              full: Sequence[int | None] | None = None) -> torch.Tensor:
    """``x`` unchanged, after a check of its local shape against the hint
    ``name`` where a mesh and hints are installed: ``full`` is the model's
    whole size of each dim (None: not checked, as the rows)."""
    specs, mesh = _ACT.get(), _MESH.get()
    if specs is None or mesh is None or full is None or specs.get(name) is None:
        return x
    from repro_torch.sharding.tp import local_range

    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        return x
    m = dict(zip(names, mesh.shape))["model"]
    r = dict(zip(names, mesh.get_coordinate()))["model"]
    spec = specs[name]
    for d, n in enumerate(full):
        if n is None:
            continue
        a, b = local_range(n, spec, m, r, d)
        if x.shape[d] != b - a:
            raise ValueError(
                f"shard_act({name!r}): dim {d} holds {x.shape[d]}, the hint "
                f"{spec} on model = {m} gives rank {r} {b - a} of {n}")
    return x


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Install ``mesh`` for the enclosed block."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


@contextlib.contextmanager
def use_plan(mesh, act_specs: dict | None) -> Iterator[None]:
    """Install ``mesh`` and a plan's activation hints ``act_specs`` for the
    enclosed block where ``mesh`` is a ``DeviceMesh`` (None, or a
    ``MeshShape`` that only plans: nothing)."""
    if mesh is None or not hasattr(mesh, "get_coordinate"):
        yield
        return
    with use_mesh(mesh), use_activation_sharding(act_specs or {}):
        yield


def current_mesh():
    """The installed mesh; raises outside :func:`use_mesh`."""
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("no mesh is installed (sharding.ctx.use_mesh)")
    return mesh


@contextlib.contextmanager
def use_token_group(group) -> Iterator[None]:
    """Install ``group`` (a process group, or None: none) as the ranks
    whose rows together make one microbatch: the data-parallel ranks of a
    train step, over whose tokens the MoE layers route (the reference's
    GSPMD routes over the global microbatch)."""
    tok = _TOKENS.set(group)
    try:
        yield
    finally:
        _TOKENS.reset(tok)


def token_group() -> tuple[Any, int, int] | None:
    """(the installed token group, its size, this rank's index in it), or
    None where none is installed or it holds one rank."""
    group = _TOKENS.get()
    if group is None:
        return None
    import torch.distributed as dist

    n = dist.get_world_size(group)
    return None if n == 1 else (group, n, dist.get_rank(group))


def all_gather_flat(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` (1-D, group size × ``x.numel()``) ← every group rank's
    ``x`` in group-rank order: ``all_gather_into_tensor``, under the name
    newer PyTorch gives it."""
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.reshape(-1), group=group)
