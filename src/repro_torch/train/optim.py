"""AdamW + LR schedule + global-norm clipping over dicts of tensors.

The port of the JAX package's ``train/optim.py``: float32 master weights and
moments, decoupled weight decay, and clipping by ``min(1, clip / max(gnorm,
1e-9))`` with the raw norm reported.  Trees are (nested) dicts of tensors,
walked in the reference's leaf order (sorted keys, as ``jax.tree.leaves``
flattens a dict), and every update keeps the reference's order of
operations, so float32 results match it to rounding.  :func:`adamw_update`
updates the parameters and moments in place, a slice of each leaf at a
time (the port may: it saves copies of three full trees and keeps the
temporaries small), and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["OptConfig", "lr_at", "adamw_init", "adamw_update", "global_norm",
           "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


_CHUNK = 1 << 26          # elements a slice of a leaf updates at once


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a nested dict in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    return [tree]


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def lr_at(step: torch.Tensor, oc: OptConfig) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio·lr`` (float32)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = oc.lr * s / max(1, oc.warmup_steps)
    prog = torch.clamp((s - oc.warmup_steps)
                       / max(1, oc.total_steps - oc.warmup_steps), 0.0, 1.0)
    cos = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(s < oc.warmup_steps, warm, oc.lr * cos)


def adamw_init(params: Any) -> tuple[Any, Any]:
    """Zero float32 first and second moments shaped like ``params``."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return _tree_map(zeros, params), _tree_map(zeros, params)


def _slices(*xs: torch.Tensor):
    """Same-shaped leaves cut along their leading axis into views of about
    ``_CHUNK`` elements at most: the update is elementwise, so the slices
    give the same values with a slice's temporaries (a stacked leaf of
    qwen2.5-3b is 3 GB)."""
    if xs[0].dim() == 0:
        return [xs]
    if xs[0].numel() == 0:           # a rank's empty shard of an uneven dim
        return []
    rows = max(1, _CHUNK // max(1, xs[0][0].numel()))
    return zip(*(x.split(rows) for x in xs))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(params: Any, grads: Any, m: Any, v: Any,
                 step: torch.Tensor, oc: OptConfig,
                 gnorm: torch.Tensor | None = None
                 ) -> tuple[Any, Any, Any, dict[str, torch.Tensor]]:
    """One AdamW step (decoupled weight decay, global-norm clipping) on
    float32 ``params``, ``m`` and ``v``, updated in place.  ``gnorm`` is the
    clipping norm when ``grads`` are slices of the gradient it was taken on
    (a rank's shards); None takes it on ``grads``.  Returns (params, m, v,
    metrics)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(oc.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_at(step, oc).to(gnorm.device)
    t = torch.as_tensor(step).to(device=gnorm.device, dtype=torch.float32) + 1.0
    bc1 = 1.0 - torch.pow(oc.beta1, t)
    bc2 = 1.0 - torch.pow(oc.beta2, t)
    for leaves in zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(m), tree_leaves(v)):
        for p, g, m_, v_ in _slices(*leaves):
            g = g.float() * scale
            m_.mul_(oc.beta1).add_((1 - oc.beta1) * g)
            v_.mul_(oc.beta2).add_((1 - oc.beta2) * torch.square(g))
            del g
            delta = (m_ / bc1) / (torch.sqrt(v_ / bc2) + oc.eps)
            delta.add_(oc.weight_decay * p)
            p.sub_(lr * delta)
    return params, m, v, {"grad_norm": gnorm, "lr": lr}
