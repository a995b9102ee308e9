"""The LM train step: microbatch gradient accumulation + AdamW on fp32
masters.

The port of the JAX package's ``train/train_loop.py``.  :class:`TrainState`
holds the float32 master parameters in the reference's tree and leaf names
(``blocks/...`` stacked on a leading layer axis), the AdamW moments and
the step, so that a checkpoint has the reference's leaves.  The model
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

On a mesh (``make_train_step(mesh=...)``) the masters, moments and EF
residuals are DTensors on the plan's placements (:func:`state_specs`,
:func:`shard_state`), and each rank computes its own batch rows.  Where
the plan shards leaves over ``model`` (every family), the model is built
with the plan's :class:`~repro_torch.sharding.tp.ModelSplit` and holds
each such leaf as this rank's shard (gathered over the FSDP axis, never
over ``model``), and the layer's compute splits as Megatron splits it
(:mod:`repro_torch.sharding.tp`; the MoE family's experts and MLA heads,
Mamba2's SSM heads and zamba2's shared block too; the shared block's
weights collect the gradients of every application before the sums
below).  The MoE layers route over the whole microbatch, as the
reference's GSPMD does: the data-parallel ranks whose rows make one
microbatch (``pod`` × ``data``, or ``data`` within a pod under the int8
cross-pod reduce) are installed as the token group
(:func:`~repro_torch.sharding.ctx.use_token_group`), and with several
microbatches a rank's rows of microbatch i are the reference's (global rows
i·B/n + its share), gathered from the ranks' rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.transformer import (ModelConfig, Transformer,
                                            _flatten, _leaves, _nest, _put,
                                            init_params, lm_loss,
                                            params_from_reference)
from repro_torch.launch.mesh import axis_group
from repro_torch.sharding.ctx import (all_gather_flat, token_group, use_mesh,
                                      use_token_group)
from repro_torch.sharding.placement import (gather_full, gather_tree,
                                            local_slices, shard_tree)
from repro_torch.sharding.spec import P, entry_axes
from repro_torch.sharding.tp import ModelSplit
from repro_torch.train.compression import compressed_mean, divide, ef_init
from repro_torch.train.optim import (OptConfig, adamw_init, adamw_update,
                                     global_norm)

__all__ = ["TrainState", "init_state", "make_train_step", "load_masters",
           "state_specs", "shard_state", "gather_state"]


@dataclasses.dataclass
class TrainState:
    params: Any            # float32 masters, the reference's tree
    m: Any
    v: Any
    step: torch.Tensor     # int32 scalar
    ef: Any = None         # int8-EF residual (pod_reduce="int8_ef" only)


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
    """Copy each master (whole), cast to its weight's dtype, into the model
    (under its split, the rank's shard of it)."""
    flat = _flatten(params)
    with torch.no_grad():
        for path, ts in _leaves(model).items():
            src = flat[path]
            if path.startswith("blocks/"):
                for i, t in enumerate(ts):
                    _put(t, model.split, path, src[i])
            else:
                _put(ts[0], model.split, path, src)


def init_state(cfg: ModelConfig, seed: int = 0, *,
               device: torch.device | str | None = None,
               params: dict | None = None, ef: bool = False,
               split: ModelSplit | None = None
               ) -> tuple[Transformer, TrainState]:
    """(model, state): float32 masters drawn from ``seed`` as
    :func:`~repro_torch.models.transformer.init_params` draws them (or the
    JAX package's numpy tree ``params``), the model holding their casts
    (under ``split``, its shards: the masters stay whole, for
    :func:`shard_state`), zero moments (and with ``ef`` zero EF
    residuals), step 0."""
    if cfg.param_dtype != "float32":
        raise ValueError(f"training keeps float32 masters: param_dtype "
                         f"{cfg.param_dtype!r}")
    if params is not None:
        model = params_from_reference(params, cfg, device, split)
        masters = _nest({path: torch.from_numpy(np.array(a, dtype=np.float32))
                         .to(model.device) for path, a in _flatten(params).items()})
    else:
        f32 = init_params(dataclasses.replace(cfg, act_dtype="float32"), seed,
                          device)
        masters = _master_tree(f32)
        del f32
        model = Transformer(cfg, device, split)
        load_masters(model, masters)
    m, v = adamw_init(masters)
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    return model, TrainState(masters, m, v, step,
                             ef_init(masters) if ef else None)


def state_specs(plan, *, ef: bool = False) -> TrainState:
    """The spec tree of a :class:`TrainState` for a plan: masters, moments
    and the EF residual on the plan's parameter specs, the step
    replicated."""
    ps = plan.param_specs
    return TrainState(params=ps, m=ps, v=ps, step=P(), ef=ps if ef else None)


def shard_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """A state of whole tensors (the same on every rank) as DTensors on the
    specs' placements: each rank keeps its slice."""
    place = lambda tree, sp: None if tree is None else shard_tree(tree, sp, mesh)
    return TrainState(place(state.params, specs.params),
                      place(state.m, specs.m), place(state.v, specs.v),
                      state.step, place(state.ef, specs.ef))


def gather_state(state: TrainState) -> TrainState:
    """A sharded state as whole tensors on every rank (one all-gather a
    leaf)."""
    gather = lambda tree: None if tree is None else gather_tree(tree)
    return TrainState(gather(state.params), gather(state.m), gather(state.v),
                      state.step, gather(state.ef))


def _local(tree: Any) -> Any:
    """The local tensors of a nested dict of DTensors (the same storage)."""
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    return tree.to_local()


def _accumulator(model: Transformer, n_microbatches: int,
                 plain_attention: bool) -> Callable:
    """``accumulate(batch) → (gradient sums, loss sum)`` over the batch's
    microbatches: each weight's gradient added, in float32, to an
    accumulator in the reference's tree, in microbatch order."""
    leaves = _leaves(model)
    weights = [t for ts in leaves.values() for t in ts]
    dev = model.device

    def accumulate(batch: dict) -> tuple[dict, torch.Tensor]:
        tokens = batch["tokens"]              # lm_loss moves it to the card
        prefix = batch.get("prefix")
        if prefix is not None:
            prefix = torch.as_tensor(prefix).to(dev)
        B = tokens.shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} not divisible by {n_microbatches} "
                             "microbatches")
        group = token_group()
        if (group is not None and n_microbatches > 1
                and model.cfg.family == "moe"):
            tokens, prefix = (_microbatch_rows(x, group, n_microbatches, dev)
                              if x is not None else None
                              for x in (tokens, prefix))
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
        return acc, loss_sum

    return accumulate


def _microbatch_rows(x: Any, group: tuple, n_micro: int,
                     dev: torch.device) -> torch.Tensor:
    """This rank's rows of the reference's microbatches: microbatch i is
    global rows ``[i·b, (i + 1)·b)`` (b = B / n_micro) and this rank (index
    d of the n in ``group``) holds its d-th n-th of them, gathered from
    every rank's rows (rank d's are global rows ``[d·B/n, (d + 1)·B/n)``:
    ``local_rows`` under the plan's batch spec)."""
    pg, n, d = group
    x = torch.as_tensor(x).to(dev).contiguous()
    every = x.new_empty((n * x.numel(),))
    all_gather_flat(every, x, pg)
    every = every.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    mb = x.shape[0] // n_micro
    rows = torch.arange(n_micro, device=dev)[:, None] * (n * mb) + d * mb + \
        torch.arange(mb, device=dev)[None, :]
    return every[rows.reshape(-1)]


def make_train_step(model: Transformer, oc: OptConfig, *,
                    n_microbatches: int = 1, pod_reduce: str = "fp32",
                    plain_attention: bool = False, mesh=None,
                    grad_specs: Any | None = None
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build ``train_step(state, batch) → (state, metrics)`` for ``model``;
    ``batch`` = {"tokens": (B, S)[, "prefix": (B, Np, D)]}, numpy or
    tensors.  ``metrics``: loss, grad_norm, lr (float32 scalars on the
    model's device).  ``plain_attention`` differentiates the attention's
    plain version instead of the kernels (a comparison).

    With a ``mesh`` (a ``DeviceMesh``) the state is sharded on
    ``grad_specs`` (the plan's parameter specs; :func:`shard_state`) and
    ``batch`` is this rank's rows (``plan.batch_spec``,
    :func:`repro_torch.sharding.placement.local_rows`).  A step gathers
    each master over every axis but ``model`` into the model's weight
    (cast): the whole leaf, or where the plan shards it over ``model`` the
    rank's shard, which the model (built with the plan's
    :class:`~repro_torch.sharding.tp.ModelSplit`) holds.  It accumulates
    this rank's microbatches, sums the gradients and the loss over the
    data-parallel ranks (``pod`` × ``data``) in one all-reduce a leaf and
    divides by microbatches × ranks; a replicated leaf that a rank reads
    only in part (``ModelSplit.partial``: ``wk``/``wv``/``bk``/``bv`` kept
    whole beside split heads; Mamba2's ``w_dt``, ``A_log``, ``D``,
    ``dt_bias``, gate ``norm``, ``w_b``/``w_c`` and their convs beside
    split SSM heads) is summed over ``model`` too, while a
    ``model``-sharded leaf's gradient stays the rank's and a leaf every
    rank reads whole (the norms) has the whole gradient on every rank.
    With ``pod_reduce="int8_ef"`` the sum runs over ``data`` (and
    ``model`` where partial) and :func:`~repro_torch.train.compression.
    compressed_mean` takes the mean over ``pod`` (the reference's
    ``shard_map``; a ``model``-sharded leaf on the whole leaf's scale,
    its largest magnitude reduced over ``model``).  The ranks the sum runs
    over are the MoE layers' token group (they route over the whole
    microbatch).  The
    clipping norm sums the squares of the ``model``-sharded gradients over
    ``model`` and counts the replicated ones once; then each rank runs
    AdamW on its own slices."""
    if pod_reduce == "int8_ef" and (
            mesh is None or "pod" not in mesh.mesh_dim_names):
        raise ValueError("int8_ef pod reduce needs a mesh with a 'pod' axis")
    if pod_reduce not in ("fp32", "int8_ef"):
        raise ValueError(f"unknown pod_reduce {pod_reduce!r}")
    accumulate = _accumulator(model, n_microbatches, plain_attention)

    if mesh is None:
        def train_step(state: TrainState, batch: dict
                       ) -> tuple[TrainState, dict]:
            acc, loss_sum = accumulate(batch)
            inv = 1.0 / n_microbatches
            grads = _nest({p: a.mul_(inv) for p, a in acc.items()})
            params, m, v, metrics = adamw_update(state.params, grads, state.m,
                                                 state.v, state.step, oc)
            del grads, acc
            load_masters(model, params)
            metrics["loss"] = loss_sum * inv
            return TrainState(params, m, v, state.step + 1, state.ef), metrics

        return train_step

    if grad_specs is None:
        raise ValueError("a train step on a mesh needs grad_specs (the plan's "
                         "parameter specs)")
    names = mesh.mesh_dim_names
    axes = dict(zip(names, mesh.shape))
    coord = dict(zip(names, mesh.get_coordinate()))
    flat_specs = _flatten(grad_specs)
    leaves = _leaves(model)
    split = model.split
    on_model = {p for p, sp in flat_specs.items()
                if axes.get("model", 1) > 1
                and any("model" in entry_axes(e) for e in sp)}
    if on_model and split is None:
        raise ValueError(
            f"the plan shards {sorted(on_model)[:3]} over model = "
            f"{axes['model']}: build the model with the plan's split "
            "(sharding.tp.model_split) so that it holds those shards")
    partial = split.partial if split is not None else frozenset()
    # the sum runs over these axes; int8_ef then takes the mean over "pod"
    sum_axes = tuple(a for a in (("data",) if pod_reduce == "int8_ef"
                                 else ("pod", "data")) if a in axes)
    n_sum = math.prod(axes[a] for a in sum_axes)
    part_axes = tuple(a for a in names if a in sum_axes or a == "model")
    gather_over = tuple(a for a in names if a != "model")

    def all_reduce(t: torch.Tensor, over: tuple[str, ...]) -> None:
        if over:
            dist.all_reduce(t, group=axis_group(mesh, over))

    def own(path: str, a: torch.Tensor, whole: tuple[int, ...]) -> torch.Tensor:
        """This rank's slice of ``a``, the model's (its ``model`` shard, or
        the whole leaf) gradient or residual of a leaf of shape ``whole``."""
        spec = flat_specs[path]
        region = local_slices(whole, P(*(e if "model" in entry_axes(e) else None
                                         for e in spec)), axes, coord)
        sl = local_slices(whole, spec, axes, coord)
        return a[tuple(slice(x.start - r.start, x.stop - r.start)
                       for x, r in zip(sl, region))]

    def load_sharded(params: dict) -> None:
        flat = _flatten(params)
        with torch.no_grad():
            for path, ts in leaves.items():
                full = gather_full(flat[path], over=gather_over)
                for i, t in enumerate(ts):
                    t.copy_(full[i] if path.startswith("blocks/") else full)
                del full

    def norm(acc: dict) -> torch.Tensor:
        """The clipping norm: the reference's leaf order without a split;
        with one, the squares of the ``model``-sharded gradients summed
        over ``model``, the replicated ones' counted once."""
        if split is None:
            return global_norm(_nest(acc))
        sq = lambda ps: sum((torch.sum(torch.square(acc[p].float())) for p in ps),
                            torch.zeros((), device=model.device))
        sharded = sq(p for p in acc if p in on_model)
        all_reduce(sharded, ("model",))
        return torch.sqrt(sharded + sq(p for p in acc if p not in on_model))

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        whole = {p: tuple(x.shape) for p, x in _flatten(state.params).items()}
        load_sharded(state.params)
        tokens = axis_group(mesh, sum_axes) if n_sum > 1 else None
        with use_mesh(mesh), use_token_group(tokens):
            acc, loss_sum = accumulate(batch)
        inv = 1.0 / (n_microbatches * n_sum)
        for path, a in acc.items():
            all_reduce(a, part_axes if path in partial else sum_axes)
            a.mul_(inv)
        all_reduce(loss_sum, sum_axes)
        loss = loss_sum * inv
        if pod_reduce == "int8_ef":
            ef_full = _flatten(_nest({p: gather_full(e, over=gather_over)
                                      for p, e in _flatten(state.ef).items()}))
            scale_groups = ({p: split.group if p in on_model else None
                             for p in acc} if split is not None else None)
            with use_mesh(mesh):
                g_pod, ef_new = compressed_mean(acc, ef_full, "pod",
                                                scale_groups)
            del ef_full
            acc = g_pod
            all_reduce(loss, ("pod",))
            loss = divide(loss, axes["pod"])          # the reference's pmean
            ef = _flatten(_local(state.ef))
            with torch.no_grad():
                for path, e in ef.items():
                    e.copy_(own(path, ef_new[path], whole[path]))
            del ef_new
        gnorm = norm(acc)
        grads = _nest({path: own(path, a, whole[path]) for path, a in acc.items()})
        _, _, _, metrics = adamw_update(_local(state.params), grads,
                                        _local(state.m), _local(state.v),
                                        state.step, oc, gnorm=gnorm)
        del grads, acc
        metrics["loss"] = loss
        return TrainState(state.params, state.m, state.v, state.step + 1,
                          state.ef), metrics

    return train_step
