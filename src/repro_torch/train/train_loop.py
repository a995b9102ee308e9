"""The LM train step: microbatch gradient accumulation + AdamW on fp32
masters.

The port of the JAX package's ``train/train_loop.py`` on one device (no
mesh: ROADMAP.md, Queue A item 9).  :class:`TrainState` holds the float32
master parameters in the reference's tree and leaf names (``blocks/...``
stacked on a leading layer axis), the AdamW moments and the step, so that a
checkpoint has the reference's leaves.  The model
(:class:`~repro_torch.models.transformer.Transformer`) holds each weight in
its own dtype (matmul weights in the activation dtype), a cast of its
master.  A step of :func:`make_train_step`:

* splits the batch into ``n_microbatches``;
* per microbatch, takes the gradient of :func:`~repro_torch.models.
  transformer.lm_loss` against the model's weights and adds it, in float32,
  to an accumulator; the reference's gradient of a master that it casts at
  use is the cotangent of the cast weight, converted: the same values;
* takes the mean, runs AdamW on the masters (in place) and copies each
  master, cast, into the model's weight.

Every weight must receive a gradient: autograd raises if one is not on the
loss's path (a kernel without a backward would cut it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.transformer import (ModelConfig, Transformer,
                                            _flatten, _leaves, init_params,
                                            lm_loss, params_from_reference)
from repro_torch.train.optim import OptConfig, adamw_init, adamw_update

__all__ = ["TrainState", "init_state", "make_train_step", "load_masters"]


@dataclasses.dataclass
class TrainState:
    params: Any            # float32 masters, the reference's tree
    m: Any
    v: Any
    step: torch.Tensor     # int32 scalar
    ef: Any = None         # the reference's int8-EF residual: always None
                           # here (pod_reduce="int8_ef" is not ported)


def _nest(flat: dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in flat.items():
        *head, leaf = path.split("/")
        node = out
        for key in head:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def _master_tree(model: Transformer) -> dict:
    """The model's weights as float32 masters in the reference's tree (a
    copy; ``blocks/...`` stacked over the layers)."""
    flat = {}
    for path, ts in _leaves(model).items():
        flat[path] = (torch.stack([t.detach().float() for t in ts])
                      if path.startswith("blocks/") else
                      ts[0].detach().float().clone())
    return _nest(flat)


def load_masters(model: Transformer, params: dict) -> None:
    """Copy each master, cast to its weight's dtype, into the model."""
    flat = _flatten(params)
    with torch.no_grad():
        for path, ts in _leaves(model).items():
            src = flat[path]
            if path.startswith("blocks/"):
                for i, t in enumerate(ts):
                    t.copy_(src[i])
            else:
                ts[0].copy_(src)


def init_state(cfg: ModelConfig, seed: int = 0, *,
               device: torch.device | str | None = None,
               params: dict | None = None) -> tuple[Transformer, TrainState]:
    """(model, state): float32 masters drawn from ``seed`` as
    :func:`~repro_torch.models.transformer.init_params` draws them (or the
    JAX package's numpy tree ``params``), the model holding their casts,
    zero moments, step 0."""
    if cfg.param_dtype != "float32":
        raise ValueError(f"training keeps float32 masters: param_dtype "
                         f"{cfg.param_dtype!r}")
    if params is not None:
        model = params_from_reference(params, cfg, device)
        masters = _nest({path: torch.from_numpy(np.array(a, dtype=np.float32))
                         .to(model.device) for path, a in _flatten(params).items()})
    else:
        f32 = init_params(dataclasses.replace(cfg, act_dtype="float32"), seed,
                          device)
        masters = _master_tree(f32)
        del f32
        model = Transformer(cfg, device)
        load_masters(model, masters)
    m, v = adamw_init(masters)
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    return model, TrainState(masters, m, v, step)


def make_train_step(model: Transformer, oc: OptConfig, *,
                    n_microbatches: int = 1, pod_reduce: str = "fp32",
                    plain_attention: bool = False
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build ``train_step(state, batch) → (state, metrics)`` for ``model``;
    ``batch`` = {"tokens": (B, S)[, "prefix": (B, Np, D)]}, numpy or
    tensors.  ``metrics``: loss, grad_norm, lr (float32 scalars on the
    model's device).  ``plain_attention`` differentiates the attention's
    plain version instead of the kernels (a comparison)."""
    if pod_reduce == "int8_ef":
        raise ValueError("int8_ef pod reduce needs a mesh with a 'pod' axis")
    if pod_reduce != "fp32":
        raise ValueError(f"unknown pod_reduce {pod_reduce!r}")
    leaves = _leaves(model)
    weights = [t for ts in leaves.values() for t in ts]
    dev = model.device

    def accumulate_grads(batch: dict) -> tuple[dict, torch.Tensor]:
        tokens = batch["tokens"]              # lm_loss moves it to the card
        prefix = batch.get("prefix")
        if prefix is not None:
            prefix = torch.as_tensor(prefix).to(dev)
        B = tokens.shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} not divisible by {n_microbatches} "
                             "microbatches")
        mb = B // n_microbatches
        acc = {path: torch.zeros((len(ts),) + tuple(ts[0].shape)
                                 if path.startswith("blocks/")
                                 else tuple(ts[0].shape),
                                 dtype=torch.float32, device=dev)
               for path, ts in leaves.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_microbatches):
            rows = slice(i * mb, (i + 1) * mb)
            loss = lm_loss(model, tokens[rows], prefix_embeds=(
                None if prefix is None else prefix[rows]),
                plain_attention=plain_attention)
            grads = iter(torch.autograd.grad(loss, weights))
            for path, ts in leaves.items():
                a = acc[path]
                for j in range(len(ts)):
                    (a[j] if path.startswith("blocks/") else a).add_(next(grads))
            del grads
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / n_microbatches
        return _nest({p: a.mul_(inv) for p, a in acc.items()}), loss_sum * inv

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        grads, loss = accumulate_grads(batch)
        params, m, v, metrics = adamw_update(state.params, grads, state.m,
                                             state.v, state.step, oc)
        del grads
        load_masters(model, params)
        metrics["loss"] = loss
        return TrainState(params, m, v, state.step + 1, state.ef), metrics

    return train_step
