"""Atomic checkpoints in the JAX package's on-disk format.

The port of the JAX package's ``train/checkpoint.py``.  Layout, the same
bytes for the same tree::

    <dir>/step_<N>/manifest.json   leaf paths, shapes, dtypes, user metadata
    <dir>/step_<N>/arr_<i>.npy     one file per leaf (np.save)

Leaves are named as ``jax.tree_util.tree_leaves_with_path`` names them
(``.params/blocks/attn/wq`` for a field of a dataclass, then dict keys,
sorted), so a checkpoint that the JAX package writes restores here and the
reverse.  A save is written under ``<dir>/.tmp_step_<N>`` and published by
``os.replace``: a crash mid-save leaves the latest complete checkpoint
alone.  Restore reads leaves by path into the structure of a target tree
(values ignored) onto a device: the device's layout at save time does not
matter.  Metadata (the data pipeline's cursor, the step) rides in the
manifest.

On a mesh a save gathers each sharded leaf (a DTensor) whole onto every
rank, over every axis its plan splits, ``model`` included (a collective:
every rank calls :func:`save`), and rank 0 writes the same files; restore
into a target of DTensors places each leaf on the target's placements (the
caller's plan), whatever mesh wrote it: reshard on restore, as the
reference's ``device_put`` onto the caller's shardings.  A state trained
at (data 1, model 2) restores bitwise at (data 2, model 1) and in one
process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.placement import gather_full, shard_tensor, spec_of

__all__ = ["save", "restore", "latest_step", "available_steps"]


def _leaves_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves`` order: a dataclass's fields
    in order as ``.name``, a dict's keys sorted; None is no leaf."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pair for f in dataclasses.fields(tree)
                for pair in _leaves_with_paths(getattr(tree, f.name),
                                               f"{prefix}/.{f.name}")]
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in _leaves_with_paths(tree[key], f"{prefix}/{key}")]
    return [(prefix[1:], tree)]


def _unflatten(tree: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaves,
                               f"{prefix}/.{f.name}")
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {key: _unflatten(val, leaves, f"{prefix}/{key}")
                for key, val in tree.items()}
    return leaves[prefix[1:]]


def _numpy(leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        if _is_dtensor(leaf):
            leaf = gather_full(leaf)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def save(ckpt_dir: str, step: int, tree: Any, *,
         metadata: dict | None = None) -> str:
    """Write checkpoint for ``step``; returns the final directory path.
    With a process group running, every rank calls it and rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    pairs = _leaves_with_paths(tree)
    arrays = [_numpy(leaf) for _, leaf in pairs]   # gathers every shard
    if dist.is_initialized() and dist.get_rank() != 0:
        dist.barrier()
        return final
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {
        "step": step,
        "paths": [path for path, _ in pairs],
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [str(a.dtype) for a in arrays],
        "metadata": metadata or {},
    }
    for i, a in enumerate(arrays):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)           # atomic publish
    if dist.is_initialized():
        dist.barrier()
    return final


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            out.append(int(name[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, target: Any, *, step: int | None = None,
            device: torch.device | str | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``target`` (values ignored): each leaf
    a tensor on ``device`` (None: the target leaf's device, or the CPU),
    and where the target leaf is a DTensor, this rank's slice of it on the
    target's mesh and placements.  Returns (tree, metadata)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    want = _leaves_with_paths(target)
    have = {p: i for i, p in enumerate(manifest["paths"])}
    missing = [p for p, _ in want if p not in have]
    if missing:
        raise ValueError(f"checkpoint at step {step} missing leaves: {missing[:5]}")

    leaves = {}
    for path, tgt in want:
        arr = np.load(os.path.join(d, f"arr_{have[path]}.npy"))
        want_shape = tuple(tgt.shape if torch.is_tensor(tgt) else np.shape(tgt))
        if want_shape and tuple(arr.shape) != want_shape:
            raise ValueError(f"{path}: checkpoint shape {arr.shape} != target "
                             f"{want_shape}")
        dev = device if device is not None else (
            tgt.device if torch.is_tensor(tgt) else "cpu")
        leaves[path] = torch.from_numpy(arr).to(dev)
        if _is_dtensor(tgt):
            leaves[path] = shard_tensor(leaves[path], spec_of(tgt),
                                        tgt.device_mesh)
    return _unflatten(target, leaves), manifest["metadata"]
