"""Partition specs and mesh shapes without a framework.

:class:`P` is a tuple with ``jax.sharding.PartitionSpec``'s entries: per
array dim ``None`` (replicated), a mesh axis name, or a tuple of axis
names (the dim split over their product, the first axis major).
:class:`MeshShape` is an ordered mapping from axis names to sizes: the
planner's view of a mesh (the reference's ``AbstractMesh``), with no
devices and no process group behind it.
"""

from __future__ import annotations

import math
from typing import Any, Iterator, Mapping

__all__ = ["P", "MeshShape", "entry_axes", "shard_shape"]


class P(tuple):
    """A partition spec: ``P(None, "data", ("pod", "data"))``; a tuple of
    one axis is that axis, as ``PartitionSpec`` stores it."""

    def __new__(cls, *entries: Any) -> "P":
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1
                                     else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class MeshShape(Mapping[str, int]):
    """Axis name → size, in mesh order (major first)."""

    def __init__(self, shape: tuple[int, ...], names: tuple[str, ...]) -> None:
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} against axis names {names}")
        self._axes = dict(zip(names, (int(s) for s in shape)))

    def __getitem__(self, name: str) -> int:
        return self._axes[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._axes)

    def __len__(self) -> int:
        return len(self._axes)

    @property
    def size(self) -> int:
        return math.prod(self._axes.values())

    def __repr__(self) -> str:
        return f"MeshShape({self._axes})"


def entry_axes(entry: Any) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_shape(shape: tuple[int, ...], spec: tuple | None,
                axes: Mapping[str, int]) -> tuple[int, ...]:
    """The largest shard of an array of ``shape`` under ``spec``: each dim
    ``ceil(n / k)`` for the product k of its axes (GSPMD pads the last
    shards, DTensor leaves them short)."""
    entries = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
    return tuple(-(-n // math.prod(axes[a] for a in entry_axes(e)))
                 for n, e in zip(shape, entries))
