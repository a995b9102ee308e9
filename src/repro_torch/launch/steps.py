"""The step function, the specs and the abstract inputs of one (architecture
× shape cell × mesh), for the dry-run, the trainer and the server.

The port of the JAX package's ``launch/steps.py``.  :func:`build_cell`
returns a :class:`CellProgram`:

    fn            — the step, run on this rank's local state and batch
    args          — meta tensors (shapes and dtypes) of its whole inputs
    in_shardings  — :class:`~repro_torch.sharding.spec.P` trees congruent
                    with ``args``
    out_shardings — P trees of the outputs (None: not planned)
    donate        — argument indices the step updates in place

The reference's ``CellProgram.lower`` hands ``fn`` and the shardings to
``jax.jit`` and lowers it to HLO under the mesh; PyTorch has no
counterpart (nothing compiles a whole step ahead of running it), so there
is no ``lower``: the dry-run (:mod:`repro_torch.launch.dryrun`) reads the
plan, the arguments' shard shapes and the roofline terms it can count.

A train cell's ``fn`` is :func:`~repro_torch.train.train_loop.
make_train_step` on the mesh around the model the caller passes (without
one the cell only plans, and allocates nothing: deepseek-v2-236b's cells
plan on the host); its state is :func:`~repro_torch.train.train_loop.
shard_state`'s and its batch ``local_rows`` of the global batch.  Prefill
and decode cells' ``fn`` take the :class:`~repro_torch.models.transformer.
Transformer` and, to decode, its caches.  On a mesh whose plan shards
leaves over ``model`` every cell runs on the rank's model: the caller
builds it (and the caches) with :meth:`CellProgram.split`, the plan's
:class:`~repro_torch.sharding.tp.ModelSplit` (``init_state(...,
split=)``, ``init_params(..., split=)``, ``init_cache(..., split=)``);
its logits are the rank's vocabulary columns, as the plan's
``out_shardings`` say.  Where ``pod`` × ``data`` exceeds one rank, a
decode cell's ``fn`` takes the rank's rows (``in_shardings``' ``P(dp)``:
tokens, positions and the caches of :meth:`CellProgram.data`'s rows) and
routes the MoE layers over the whole batch (the data ranks installed as
the token group, as the engine's decode step does); under the plan's
FSDP the model is built with :meth:`CellProgram.data` as well
(``init_params(..., split=, data=)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.registry import ArchSpec, ShapeCell
from repro_torch.models.transformer import (ModelConfig, Transformer,
                                            abstract_params, init_cache)
from repro_torch.sharding.ctx import use_plan, use_token_group
from repro_torch.sharding.planner import Plan, plan_for
from repro_torch.sharding.spec import P
from repro_torch.sharding.tp import (DataSplit, ModelSplit, data_split,
                                     model_split)
from repro_torch.train.optim import OptConfig
from repro_torch.train.train_loop import (TrainState, make_train_step,
                                          state_specs)

__all__ = ["CellProgram", "build_cell", "abstract_train_state"]


@dataclasses.dataclass
class CellProgram:
    arch_id: str
    cell: ShapeCell
    kind: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate: tuple[int, ...]
    plan: Plan
    cfg: ModelConfig
    meta: dict[str, Any]

    def split(self, mesh) -> ModelSplit | None:
        """This rank's split of the cell's model on ``mesh`` (a
        ``DeviceMesh``): the plan's parameter specs, and to serve its cache
        specs; None where nothing is split over ``model``."""
        return model_split(self.cfg, self.plan.param_specs, mesh,
                           self.plan.cache_specs)

    def data(self, mesh) -> DataSplit | None:
        """This rank's data split of the cell on ``mesh`` (a
        ``DeviceMesh``): its rows of the caches' batch and the leaves the
        plan shards over ``data``; None where there is neither."""
        return data_split(self.cfg, self.plan, mesh)


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_train_state(cfg: ModelConfig, *, ef: bool = False) -> TrainState:
    """The train state's shapes and dtypes as meta tensors: float32 masters,
    moments (and EF residuals) in the parameter tree, an int32 step."""
    f32 = lambda tree: {k: f32(v) if isinstance(v, dict) else
                        _meta(tuple(v.shape), torch.float32)
                        for k, v in tree.items()}
    params = abstract_params(cfg)
    return TrainState(params=params, m=f32(params), v=f32(params),
                      step=_meta((), torch.int32),
                      ef=f32(params) if ef else None)


def _batch_abstract(cfg: ModelConfig, cell: ShapeCell, batch: int) -> dict:
    if cfg.modality == "vision_prefix":
        s_text = cell.seq_len - cfg.vision_prefix_len
        return {"tokens": _meta((batch, s_text), torch.int32),
                "prefix": _meta((batch, cfg.vision_prefix_len, cfg.d_model),
                                cfg.adt)}
    return {"tokens": _meta((batch, cell.seq_len), torch.int32)}


def _batch_pspec(plan: Plan, batch: int, abstract: dict) -> dict:
    dp = plan.dp_axes if plan.dp_size and batch % plan.dp_size == 0 else None
    return {k: P(dp, *([None] * (v.dim() - 1))) for k, v in abstract.items()}


def _no_model(state: TrainState, batch: dict):
    raise TypeError("this cell only plans: build it with model= (a "
                    "Transformer on the mesh's device) and a DeviceMesh to "
                    "run its step")


def build_cell(
    spec: ArchSpec,
    cell: ShapeCell,
    mesh: Any,
    *,
    pod_reduce: str = "fp32",
    microbatch_override: int | None = None,
    allow_uneven: bool = False,
    cfg_overrides: dict | None = None,
    oc: OptConfig | None = None,
    model: Transformer | None = None,
) -> CellProgram:
    """``mesh``: a ``DeviceMesh`` (to run ``fn``) or a ``MeshShape`` (to
    plan).  A train cell's step needs ``model`` (a :class:`Transformer` of
    the cell's config on the mesh's device, whose weights each step
    overwrites from the masters) and optimizes with ``oc`` (default
    ``OptConfig()``); without a model ``fn`` raises."""
    cfg = spec.cell_config(cell)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
        spec = dataclasses.replace(spec, model=cfg)
    plan = plan_for(
        spec, mesh, mode=cell.kind, cell=cell,
        cache_batch=cell.global_batch if cell.kind == "decode" else None,
        cache_len=cell.seq_len if cell.kind == "decode" else None,
        allow_uneven=allow_uneven,
        replicate_embed=pod_reduce == "int8_ef",
    )
    meta: dict[str, Any] = {"notes": list(plan.notes)}

    if cell.kind == "train":
        dp = max(1, plan.dp_size)
        n_micro = microbatch_override or spec.train_microbatches
        n_micro = max(1, min(n_micro, cell.global_batch // dp))
        meta["n_microbatches"] = n_micro
        plan.act_specs.setdefault("microbatches", P(None, plan.dp_axes, None))
        ef = pod_reduce == "int8_ef"
        step = _no_model if model is None else make_train_step(
            model, oc or OptConfig(), n_microbatches=n_micro,
            pod_reduce=pod_reduce, mesh=mesh, grad_specs=plan.param_specs)
        astate = abstract_train_state(cfg, ef=ef)
        abatch = _batch_abstract(cfg, cell, cell.global_batch)
        sspec = state_specs(plan, ef=ef)
        in_sh = (sspec, _batch_pspec(plan, cell.global_batch, abatch))
        out_sh = (sspec, {"loss": P(), "grad_norm": P(), "lr": P()})
        return CellProgram(
            arch_id=spec.arch_id, cell=cell, kind="train", fn=step,
            args=(astate, abatch), in_shardings=in_sh, out_shardings=out_sh,
            donate=(0,), plan=plan, cfg=cfg, meta=meta,
        )

    aparams = abstract_params(cfg)
    if cell.kind == "prefill":
        def prefill_step(model: Transformer, batch: dict):
            with use_plan(mesh, plan.act_specs):
                logits, caches, _ = model.forward_full(
                    batch["tokens"], prefix_embeds=batch.get("prefix"),
                    return_cache=True)
            return logits, caches

        abatch = _batch_abstract(cfg, cell, cell.global_batch)
        in_sh = (plan.param_specs, _batch_pspec(plan, cell.global_batch, abatch))
        cache_plan = plan_for(spec, mesh, mode="prefill", cell=cell,
                              cache_batch=cell.global_batch,
                              cache_len=cell.seq_len)
        return CellProgram(
            arch_id=spec.arch_id, cell=cell, kind="prefill", fn=prefill_step,
            args=(aparams, abatch), in_shardings=in_sh,
            out_shardings=(None, cache_plan.cache_specs), donate=(),
            plan=plan, cfg=cfg, meta=meta,
        )

    # ---- decode: 1 new token per sequence against a seq_len cache
    B = cell.global_batch
    # the rank's rows: the MoE layers route over every data rank's (a
    # MeshShape, which only plans, has no data split)
    ds = data_split(cfg, plan, mesh)
    group = ds.group if ds is not None and ds.batch else None

    def serve_step(model: Transformer, token, caches: dict, pos):
        with use_plan(mesh, plan.act_specs), use_token_group(group):
            return model.forward_decode(token, caches, pos)

    acache = init_cache(cfg, B, cell.seq_len, device="meta")
    atoken = _meta((B,), torch.int32)
    apos = _meta((B,), torch.int32)
    dp = plan.dp_axes if plan.dp_size and B % plan.dp_size == 0 else None
    in_sh = (plan.param_specs, P(dp), plan.cache_specs, P(dp))
    logits_spec = plan.act_specs.get("logits", P(dp, None))
    lg = P(dp, logits_spec[-1] if len(logits_spec) else None)
    return CellProgram(
        arch_id=spec.arch_id, cell=cell, kind="decode", fn=serve_step,
        args=(aparams, atoken, acache, apos), in_shardings=in_sh,
        out_shardings=(lg, plan.cache_specs), donate=(2,), plan=plan,
        cfg=cfg, meta=meta,
    )
