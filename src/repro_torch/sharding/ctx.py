"""Sharding context: the installed mesh and activation-sharding hints.

The port of the JAX package's ``sharding/ctx.py``.  Model code stays
sharding-agnostic.  The reference calls ``shard_act`` with a logical
activation name at a few points (embeddings, the residual stream, logits)
and the launcher installs the plan's name → spec hints
(``Plan.act_specs``) for GSPMD.  In the port the train step runs each
layer on the rank's own batch rows with the layer's whole weights
(gathered from the plan's shards), so an activation is never split across
ranks: :func:`use_activation_sharding` records the hints and
:func:`shard_act` is the identity.  Splitting a layer's compute over
``model`` (heads, FFN columns, vocabulary, experts) is the next slice, and
the hints stay in ``Plan.act_specs`` for it.

:func:`use_mesh` installs the ``DeviceMesh`` whose axes the collectives of
:mod:`repro_torch.train.compression` name, as the reference's ``shard_map``
region binds its axis names.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Any, Iterator

import torch

__all__ = ["use_activation_sharding", "shard_act", "use_mesh",
           "current_mesh"]

_ACT: ContextVar[dict | None] = ContextVar("repro_torch_act_shardings",
                                           default=None)
_MESH: ContextVar[Any] = ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_activation_sharding(specs: dict) -> Iterator[None]:
    """Install logical-name → spec hints for the enclosed block."""
    tok = _ACT.set(dict(specs))
    try:
        yield
    finally:
        _ACT.reset(tok)


def shard_act(x: torch.Tensor, name: str) -> torch.Tensor:
    """The identity: activations are the rank's own rows (see above)."""
    return x


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Install ``mesh`` for the enclosed block."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh():
    """The installed mesh; raises outside :func:`use_mesh`."""
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("no mesh is installed (sharding.ctx.use_mesh)")
    return mesh
