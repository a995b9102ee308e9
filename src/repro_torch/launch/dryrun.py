"""Multi-pod dry-run: plan every (architecture × shape × mesh) cell on the
production meshes, on the host, and count what a device would hold and do.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch all --shape all --mesh both --out experiments/dryrun_torch

The port of the JAX package's ``launch/dryrun.py``.  A cell plans on an
abstract mesh (:func:`repro_torch.launch.mesh.abstract_mesh`: 256 or 512
ranks, no process group) and, as the reference compiles every cell, the
CLI counts it (:func:`count_cell`; ``--no-count`` skips it, and
:func:`run_cell` counts with ``count=True``): a fake process
group of the mesh's size with this process as rank 0, a ``DeviceMesh``
over it, rank 0's model built on meta tensors through the cell's own
split and data split (nothing allocated), and the cell's step run once
under :func:`repro_torch.launch.op_analysis.analyze`: a whole train step
(the optimizer included), a prefill or a decode step.  Each cell writes
``<out>/<arch>__<shape>__<mesh>.json`` with the planning seconds
(``plan_s``), ``meta`` (the plan's notes, the microbatches),
``arg_bytes_per_device`` (the state and batch shards a rank holds: each
dim of each argument divided by its axes, rounded up), the counted
``flops``, ``bytes``, ``transcendentals`` and ``products`` of a device
(``count_s`` the seconds it took, ``kernels`` the hand-written kernels'
calls), the reference's ``collectives`` (``total_bytes``, ``by_kind``,
``counts``; ``sent``: the ring bytes the device sends) and the roofline
:mod:`repro_torch.launch.roofline` makes of them.  A cell whose count
fails is an error naming the op; nothing falls back to the model's
flops.  The record names the rank counted (``counted_rank``): rank 0,
which holds the largest piece of every split dim, also under the
planner's ``allow_uneven`` (GSPMD's pieces, ``ceil(n / m)`` from the first
rank on), unless another rank does more all the same (a rank whose query
heads cross KV groups reads more KV heads; the rank that masks the
vocabulary's padding): those ranks are counted too, and the record is
the one whose roofline step is longest, the rank that limits the step;
:func:`count_cell` counts any rank (``rank=``).  Without the count the closed forms
refuse a plan that splits a dim unevenly over ``model`` (its collectives
"not counted: ...").  The reference's ``lower_s``, ``compile_s``, ``mem_*``,
``xla_cost_*``, ``hlo_lines`` and ``unknown_trip_loops`` read XLA's
compiled program and its HLO; PyTorch compiles no whole step ahead of
running it, so they are absent, each named with the reason in the
record's ``absent``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.configs.registry import (ARCH_IDS, SHAPES, ArchSpec,
                                          ShapeCell, get_arch)
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, abstract_mesh, make_mesh,
                                     mesh_axes)
from repro_torch.launch.op_analysis import OpCost, analyze, collective_report
from repro_torch.launch.roofline import StepCost, model_flops, summarize
from repro_torch.launch.steps import CellProgram, build_cell
from repro_torch.models.transformer import Transformer, _flatten, init_cache
from repro_torch.sharding.placement import local_rows
from repro_torch.sharding.spec import P, entry_axes, shard_shape
from repro_torch.sharding.tp import plan_split
from repro_torch.train.train_loop import shard_state

__all__ = ["run_cell", "main", "args_bytes_per_device", "OPT_OVERRIDES",
           "ABSENT", "count_cell", "split_collective_bytes",
           "routing_collective_bytes", "uneven_leaves", "counted_rank"]

# Beyond-paper optimized-variant config overrides per arch (the reference's
# table): the per-arch knobs that change parameter layouts stay opt-in.
OPT_OVERRIDES: dict[str, dict] = {
    "musicgen-medium": {"head_pad_multiple": 16},   # 24 heads → 32, TP-able
}

_NO_HLO = ("XLA's compiled program and HLO have no PyTorch counterpart: "
           "nothing compiles a whole step ahead of running it")
ABSENT = {**{key: _NO_HLO for key in (
    "lower_s", "compile_s", "mem_argument_size_in_bytes",
    "mem_output_size_in_bytes", "mem_temp_size_in_bytes",
    "mem_generated_code_size_in_bytes", "mem_alias_size_in_bytes",
    "xla_cost_flops", "xla_cost_bytes", "hlo_lines")},
    "unknown_trip_loops": ("an eager step runs every layer: no loop body is "
                           "counted once, so no trip count is unknown")}
# what a cell planned without its count (count=False) lacks
_NOT_COUNTED = "not counted (count=False): the model's flops, the arguments' bytes"
# the ranges of a model split whose size sets a rank's work
_RANGES = ("heads", "kv", "ffn", "vocab_in", "vocab_out", "experts", "router",
           "shared")


def _pairs(args: Any, specs: Any) -> list[tuple[Any, Any]]:
    """(meta tensor, spec) pairs of congruent argument and spec trees;
    None arguments (an absent EF residual) hold nothing."""
    if args is None:
        return []
    if isinstance(specs, P) or specs is None:
        return [(args, specs)]
    if isinstance(args, dict):
        return [pair for k in sorted(args) for pair in _pairs(args[k], specs[k])]
    if isinstance(args, tuple):
        return [pair for a, s in zip(args, specs) for pair in _pairs(a, s)]
    # a dataclass (TrainState): field by field
    return [pair for f in args.__dataclass_fields__
            for pair in _pairs(getattr(args, f), getattr(specs, f))]


def _shard_bytes(x, spec, axes: dict[str, int]) -> int:
    return math.prod(shard_shape(tuple(x.shape), spec, axes)) * x.element_size()


def args_bytes_per_device(prog: CellProgram, axes: dict[str, int]) -> float:
    """The bytes of the shards of ``prog``'s arguments that one rank holds."""
    return float(sum(_shard_bytes(x, s, axes)
                     for x, s in _pairs(prog.args, prog.in_shardings)))


def _ring(n: int) -> float:
    """Bytes a rank sends, per byte reduced, in a ring all-reduce of n."""
    return 2 * (n - 1) / n if n > 1 else 0.0


def _rows(prog: CellProgram) -> int:
    """The sequences a rank runs: its share of the cell's global batch."""
    B, dp = prog.cell.global_batch, max(1, prog.plan.dp_size)
    return B // dp if B % dp == 0 else B


def _fsdp_serving(prog: CellProgram, axes: dict[str, int]) -> bool:
    """Whether a serving cell's plan shards a weight over ``data`` (more
    than one rank): FSDP serving (:class:`~repro_torch.sharding.tp.
    DataSplit`)."""
    if prog.cell.kind == "train" or axes.get("data", 1) == 1:
        return False
    return any("data" in entry_axes(e)
               for s in _flatten(prog.plan.param_specs).values()
               for e in (s or ()))


def _batch_over_data(prog: CellProgram) -> bool:
    """Whether the plan splits the caches' batch over the data ranks."""
    return any(len(s or ()) > 1 and bool(entry_axes(tuple(s)[1]))
               for s in _flatten(prog.plan.cache_specs or {}).values())


def split_collective_bytes(prog: CellProgram, axes: dict[str, int]) -> float:
    """Bytes a rank sends in the collectives of the split over ``model``
    (:mod:`repro_torch.sharding.tp`) in one step of the cell, ring
    algorithms over m = |model|, T the rank's tokens (rows × S; decode: one
    a row), D the width, E the experts, a the activation's bytes:

    * forward: per layer one all-reduce of T × D fp32 partial sums for the
      heads (GQA's or MLA's) and one for the FFN (the dense FFN's columns;
      MoE: the experts' combine, the shared experts' column partials
      folded in, or the shared experts' alone where the experts stay
      whole), where each is split; the router's fp32 logits (T × E/m a
      rank) all-gathered where its columns are split; and the
      vocab-parallel embedding's all-reduce of its tokens' rows (T less a
      vision prefix's, which comes embedded) × D × a;
    * train: the forward again in the remat recompute (blocks only), but
      for the dense FFN's all-reduce: ``torch.utils.checkpoint`` stops a
      block's recompute once the tensors the backward saved are made
      again, and that all-reduce, the block's last op, feeds none; the
      backward's all-reduce of the split inputs' gradients (T × D × a per
      layer input read in part: the attention's, the FFN's; and the
      head's input), the router logits' gradient summed (T × E fp32) where
      both the router's columns and the experts are split, and the loss's
      three reductions of the targets' fp32 statistics (the row max, the
      sum of exponentials, the gold logit; a row's tokens less one);
    * decode on a cache split over the sequence: per layer q gathered over
      ``model`` (B × H/m × dh × a; MLA: the fp32 latent and rope queries,
      B × H/m × (r + dr) × 4) and each rank's output (B × H × dh × a; MLA:
      the fp32 latent context, B × H × r × 4) and log-sum-exp (B × H fp32)
      gathered.

    The ``ssm`` and ``hybrid`` families, with the same conventions: per
    Mamba2 layer split over SSM heads ``out_proj``'s all-reduce (T × D
    fp32) and the gated norm's squares (T fp32); per application of
    zamba2's shared block one all-reduce of T × 2D fp32 for its heads and
    one for its FFN columns, where each is split; in training the
    recompute again but for ``out_proj``'s all-reduce (a Mamba2 layer's
    last op), and in the backward each Mamba2 layer's input gradient (T ×
    D × a) and its squares' (T fp32), and the shared block's split inputs'
    (T × 2D × a each).

    0 where nothing is split over ``model``; raises NotImplementedError for
    a split the port cannot run, for a serving cell under the plan's FSDP
    (weights sharded over ``data``: their gathers and the in-place leaves'
    activations are counted by :func:`count_cell` alone), and for a plan
    that splits a dim unevenly over ``model`` (:func:`uneven_leaves`: the
    padded gathers, K and V gathered where a rank's heads cross KV groups,
    the empty pieces; :func:`count_cell` counts such cells)."""
    cfg = prog.cfg
    m = axes.get("model", 1)
    if _fsdp_serving(prog, axes):
        raise NotImplementedError(
            "the closed form leaves out FSDP serving (weights sharded over "
            "data); count the cell (count_cell)")
    uneven = uneven_leaves(prog, m)
    if uneven:
        raise NotImplementedError(
            f"the closed forms do not model uneven pieces over model = {m} "
            f"({', '.join(uneven[:3])}); count the cell (count_cell)")
    sp = plan_split(cfg, prog.plan.param_specs, m, 0, prog.plan.cache_specs)
    if sp is None:
        return 0.0
    kind, rows = prog.cell.kind, _rows(prog)
    T = rows * (1 if kind == "decode" else prog.cell.seq_len)
    D, L, a = cfg.d_model, cfg.n_layers, cfg.adt.itemsize
    heads = sp.heads is not None
    if cfg.family in ("ssm", "hybrid"):
        M = cfg.n_mamba_layers if sp.ssm is not None else 0
        b = sp.block
        G = cfg.hybrid_groups if b is not None else 0
        nb = (b.heads is not None) + (b.ffn is not None) if b is not None else 0
        blocks = _ring(m) * (M * T * (D + 1) * 4 + G * nb * T * 2 * D * 4)
        last = _ring(m) * M * T * D * 4            # out_proj's, not replayed
        inputs = _ring(m) * (M * T * (D * a + 4) + G * nb * T * 2 * D * a)
    else:
        last = 0.0
        if cfg.family == "moe":
            ep, sh = sp.experts is not None, sp.shared is not None
            reduces = heads + ep + (sh and not ep)
            n_in = heads + (ep or sh or sp.router is not None)
            router = (L * (m - 1) * T * (cfg.n_experts // m) * 4
                      if sp.router is not None else 0.0)
        else:
            reduces = n_in = heads + (sp.ffn is not None)
            router = 0.0
            if sp.ffn is not None:                   # not replayed
                last = L * _ring(m) * T * D * 4
        blocks = L * reduces * _ring(m) * T * D * 4 + router
        inputs = L * n_in * _ring(m) * T * D * a
    # the tokens a rank embeds: a prefix's rows come embedded
    prefix = (cfg.vision_prefix_len
              if cfg.modality == "vision_prefix" and kind != "decode" else 0)
    text = T - rows * prefix
    embed = _ring(m) * text * D * a if sp.vocab_in is not None else 0.0
    sent = blocks + embed
    if kind == "train":
        sent += blocks - last if cfg.remat else 0.0
        sent += inputs
        if sp.router is not None and sp.experts is not None:
            sent += L * _ring(m) * T * cfg.n_experts * 4
        if sp.vocab_out is not None:
            sent += _ring(m) * T * D * a + 3 * _ring(m) * (text - rows) * 4
    elif kind == "decode" and sp.cache == "seq":
        H = cfg.n_heads_eff
        if cfg.use_mla:
            r, dr = cfg.kv_lora_rank, cfg.d_rope
            q = rows * (H // m) * (r + dr) * 4 if heads else 0.0
            ctx = rows * H * r * 4
        else:
            q = rows * (H // m) * cfg.d_head * a if heads else 0.0
            ctx = rows * H * cfg.d_head * a
        sent += L * (m - 1) * (q + ctx + rows * H * 4)
    return sent


def routing_collective_bytes(prog: CellProgram, axes: dict[str, int],
                             pod_reduce: str = "fp32") -> float:
    """Bytes a rank sends for the MoE layers' routing over the n ranks of
    the token group, per layer: the all-gather of the (k, E) int64 counts
    ((n − 1) × k × E × 8) and the all-reduce of f's and p's sums (2 × E
    fp32).  A train step (:mod:`repro_torch.models.moe`; the group pod ×
    data, or data under the int8 cross-pod reduce) sends both per
    microbatch, in the forward and again in the remat recompute, and the
    sums' all-reduce once more in the backward; with several
    microbatches, also the all-gather of the rank's token rows ((n − 1)
    × rows × S × 4).  A decode step whose plan splits the caches' batch
    over the data ranks (the group pod × data) sends both once.  0 for a
    family without experts, at n = 1, and for a prefill."""
    cfg = prog.cfg
    kind = prog.cell.kind
    if kind == "decode":
        n = (axes.get("pod", 1) * axes.get("data", 1)
             if _batch_over_data(prog) else 1)
    else:
        n = axes.get("data", 1) * (axes.get("pod", 1)
                                   if pod_reduce == "fp32" else 1)
    if cfg.family != "moe" or n == 1 or kind == "prefill":
        return 0.0
    E, k, L = cfg.n_experts, cfg.experts_per_token, cfg.n_layers
    forward = (n - 1) * k * E * 8 + _ring(n) * 2 * E * 4
    if kind == "decode":
        return L * forward
    micro = prog.meta.get("n_microbatches", 1)
    per = forward * (2 if cfg.remat else 1) + _ring(n) * 2 * E * 4
    regroup = ((n - 1) * _rows(prog) * prog.cell.seq_len * 4
               if micro > 1 else 0.0)
    return L * micro * per + regroup


def _train_collective_bytes(prog: CellProgram, axes: dict[str, int],
                            pod_reduce: str) -> float:
    """Bytes a rank sends in one step of the port's train step (ring
    algorithms): each master's all-gather over the axes but ``model``
    that shard it (a ``model``-sharded leaf stays the rank's shard), the
    gradients' all-reduce (of the rank's shards) over (pod, data) in
    float32 — over (pod, data, model) for the replicated leaves a rank
    reads in part —, or over data in float32 and an int8 all-gather (+ a
    float32 scale a leaf, a ``model``-sharded leaf's reduced over
    ``model``) over pod; the loss's float32 sum over the same ranks (and
    its mean over pod under the int8 reduce); the clipping norm's squares
    summed over ``model`` where the model is split; the split's own
    collectives (:func:`split_collective_bytes`) and the MoE routing's
    over the microbatch (:func:`routing_collective_bytes`)."""
    params = _flatten(prog.args[0].params)
    specs = _flatten(prog.in_shardings[0].params)
    m = axes.get("model", 1)
    sp = plan_split(prog.cfg, prog.plan.param_specs, m, 0)
    partial = sp.partial if sp is not None else frozenset()
    pods, data = axes.get("pod", 1), axes.get("data", 1)
    over = data if pod_reduce == "int8_ef" else pods * data
    sent = 0.0
    for path, x in params.items():
        s = specs[path]
        k = math.prod(axes[a] for e in (s or ()) for a in entry_axes(e)
                      if a != "model")
        sent += (k - 1) * _shard_bytes(x, s, axes)
        # the gradient of the rank's model shard, float32
        g = 4 * math.prod(shard_shape(tuple(x.shape), _model_only(s), axes))
        sent += _ring(over * (m if path in partial else 1)) * g
        if pod_reduce == "int8_ef":
            sent += (pods - 1) * (g / 4 + 4)      # int8 payload + a scale
            if any("model" in entry_axes(e) for e in (s or ())):
                sent += _ring(m) * 4              # the scale's max over model
    sent += _ring(over) * 4                       # the loss's sum
    if pod_reduce == "int8_ef":
        sent += _ring(pods) * 4                   # its mean over pod
    if sp is not None:
        sent += _ring(m) * 4                      # the norm's squares
    return (sent + split_collective_bytes(prog, axes)
            + routing_collective_bytes(prog, axes, pod_reduce))


def counted_rank(prog: CellProgram, axes: dict[str, int]) -> dict:
    """Which ranks of ``model`` :func:`run_cell` counts: rank 0, which
    holds the largest piece of every split dim (GSPMD's pieces,
    ``ceil(n / m)`` from the first rank on), and each rank that does more
    all the same: one whose query heads cross KV groups reads more KV heads
    than its piece of the query heads gives rank 0 (an uneven split of
    grouped heads), or one that masks the vocabulary's padding.
    ``others_do_no_more``: no rank's range of :data:`_RANGES` is larger
    than rank 0's; ``more``: why each of the others does more;
    ``ranks``: rank 0 and the first of those ranks with each set of range
    sizes, in order."""
    m = axes.get("model", 1)
    sps = [plan_split(prog.cfg, prog.plan.param_specs, m, r,
                      prog.plan.cache_specs) for r in range(m)] if m > 1 else []
    size = lambda x: None if x is None else x[1] - x[0]      # noqa: E731
    more, ranks, seen = [], [0], set()
    if sps and sps[0] is not None:
        for r, sp in enumerate(sps[1:], 1):
            n = len(more)
            for name in _RANGES:
                a, b = size(getattr(sps[0], name)), size(getattr(sp, name))
                if a is not None and b is not None and b > a:
                    more.append(f"rank {r}'s {name} {b} against rank 0's {a}")
            v = sp.vocab_out
            masks = v is not None and v[1] > prog.cfg.vocab_size >= sps[0].vocab_out[1]
            if masks:
                more.append(f"rank {r} masks the vocabulary's padding in the "
                            "loss")
            # one rank of each set of range sizes: the others repeat its work
            sizes = (masks,) + tuple(size(getattr(sp, k)) for k in _RANGES)
            if len(more) > n and sizes not in seen:
                seen.add(sizes)
                ranks.append(r)
    why = ("rank 0 holds the largest piece of every range the split computes "
           "(GSPMD's pieces: ceil(n / m) from the first rank on, the last "
           "short or empty); every collective moves the same bytes on each "
           "rank" + (": no other rank does more" if not more else
                     "; but " + "; ".join(more[:4]) + ": those ranks are "
                     "counted too, and the record is the one whose roofline "
                     "step is longest"))
    return dict(others_do_no_more=not more, more=more, ranks=ranks, why=why)


def uneven_leaves(prog: CellProgram, m: int) -> list[str]:
    """The leaves (``path (dim)``) whose plan splits a dim that does not
    divide a ``model`` axis of ``m`` ranks (the planner's
    ``allow_uneven``), in the parameter tree's order."""
    out = []
    for path, x in _flatten(prog.args[0].params if prog.cell.kind == "train"
                            else prog.args[0]).items():
        spec = _flatten(prog.plan.param_specs)[path]
        for n, e in zip(tuple(x.shape), tuple(spec or ())):
            if "model" in entry_axes(e) and n % m:
                out.append(f"{path} ({n})")
    return out


def _model_only(spec) -> P:
    """``spec`` with every axis but ``model`` dropped."""
    return P(*("model" if "model" in entry_axes(e) else None
               for e in (spec or ())))


def count_cell(spec: ArchSpec, cell: ShapeCell, shape: tuple[int, ...],
               names: tuple[str, ...], rank: int = 0, **build: Any
               ) -> tuple[CellProgram, OpCost]:
    """(the cell's program on the mesh, the step of ``rank`` counted): a
    fake process group of the mesh's size with this process as that rank
    and a ``DeviceMesh`` over it; the rank's model on meta tensors through
    the cell's split and data split; the cell's ``fn`` run once under
    :func:`~repro_torch.launch.op_analysis.analyze` on the rank's state and
    batch rows (a train step), batch rows (a prefill) or rows of tokens,
    positions and caches (a decode step).  Rank 0 (the default) holds the
    largest piece of every split dim; :func:`counted_rank` names the ranks
    that do more all the same.  ``build`` goes to
    :func:`~repro_torch.launch.steps.build_cell`.  Raises if a process
    group is already running; destroys its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("count_cell starts a fake process group of the "
                           "mesh's size; one is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        mesh = make_mesh(shape, names, "cpu")
        prog = build_cell(spec, cell, mesh, **build)
        split, data = prog.split(mesh), prog.data(mesh)
        if cell.kind == "train":
            model = Transformer(prog.cfg, "meta", split)
            prog = build_cell(spec, cell, mesh, model=model, **build)
            state = shard_state(prog.args[0], prog.in_shardings[0], mesh)
            args = (state, local_rows(prog.args[1],
                                      prog.in_shardings[1]["tokens"], mesh))
        else:
            model = Transformer(prog.cfg, "meta", split, data)
            if cell.kind == "prefill":
                args = (model, local_rows(prog.args[1],
                                          prog.in_shardings[1]["tokens"], mesh))
            else:
                B = cell.global_batch
                a, b = data.rows(B) if data is not None else (0, B)
                caches = init_cache(prog.cfg, B, cell.seq_len, device="meta",
                                    split=split, data=data)
                rows = torch.empty((b - a,), dtype=torch.int32, device="meta")
                args = (model, rows, caches, rows)
        return prog, analyze(prog.fn, *args)
    finally:
        dist.destroy_process_group()


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             pod_reduce: str = "fp32", allow_uneven: bool = False,
             cfg_overrides: dict | None = None, count: bool = False) -> dict:
    """The cell's record.  ``count`` counts the step of rank 0 and of each
    rank :func:`counted_rank` finds doing more (:func:`count_cell`), and
    keeps the one whose roofline step is longest (the rank that limits the
    step), as the reference compiles every cell: the CLI's default, off
    here so that callers that only plan (the planner's parity tests, a
    sweep of every cell in seconds) keep their time; without it the roofline reads the model's flops, the arguments'
    bytes and the closed-form collectives.  Raises if ``count`` and a
    process group is already running."""
    spec = get_arch(arch_id)
    cell = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "pod_reduce": pod_reduce, "status": "ok",
    }
    if shape_name in spec.skip_cells:
        rec["status"] = "skipped"
        rec["reason"] = spec.skip_cells[shape_name]
        return rec
    if count and dist.is_initialized():
        raise RuntimeError("run_cell(count=True) starts a fake process group "
                           "of the mesh's size; one is already running")
    build = dict(pod_reduce=pod_reduce, allow_uneven=allow_uneven,
                 cfg_overrides=cfg_overrides)
    try:
        shape, names = PRODUCTION_SHAPES[multi_pod]
        mesh = abstract_mesh(shape, names)
        axes = mesh_axes(mesh)
        n_chips = mesh.size
        t0 = time.perf_counter()
        prog = build_cell(spec, cell, mesh, **build)
        rec["plan_s"] = time.perf_counter() - t0
        rec["meta"] = prog.meta
        rec["arg_bytes_per_device"] = args_bytes_per_device(prog, axes)
        rec["absent"] = dict(ABSENT)
        if count:
            t0 = time.perf_counter()
            who = counted_rank(prog, axes)
            counts = {}
            for r in who["ranks"]:
                _, op = count_cell(spec, cell, shape, names, rank=r, **build)
                cost = StepCost(flops=op.flops, bytes=op.bytes,
                                collective_bytes=op.coll_sent, sources={
                    "flops": f"counted: rank {r}'s step on meta tensors "
                             "(op_analysis: products, elementwise ops, the "
                             "kernels' work over the pairs the mask keeps)",
                    "bytes": "counted: each op's inputs and outputs, views "
                             "and allocations free (op_analysis)",
                    "collective_bytes": f"counted: the bytes rank {r} sends "
                                        "in the step's collectives, ring "
                                        "algorithms over each group's size "
                                        "(op_analysis)"})
                counts[r] = (op, cost, summarize(prog.cfg, cell, cost, n_chips))
            # the rank that limits the step: the longest roofline step, the
            # lowest rank of equals
            r = max(counts, key=lambda r: (counts[r][2]["ideal_step_s"], -r))
            op, cost, rec["roofline"] = counts[r]
            rec["count_s"] = time.perf_counter() - t0
            rec["counted_rank"] = dict(
                who, rank=r, steps_s={q: c[2]["ideal_step_s"]
                                      for q, c in counts.items()})
            rec.update(flops=op.flops, bytes=op.bytes,
                       transcendentals=op.transcendentals,
                       products=op.products, kernels=op.kernels,
                       collectives=collective_report(op))
        else:
            for key in ("flops", "bytes", "transcendentals", "collectives"):
                rec["absent"][key] = _NOT_COUNTED
            cost = _closed_form(prog, axes, pod_reduce, n_chips,
                                rec["arg_bytes_per_device"])
            rec["roofline"] = summarize(prog.cfg, cell, cost, n_chips)
    except Exception as e:          # noqa: BLE001 — a cell's failure is its record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def _closed_form(prog: CellProgram, axes: dict[str, int], pod_reduce: str,
                 n_chips: int, arg_bytes: float) -> StepCost:
    """The roofline's inputs without a count: the model's flops, every
    argument shard read once, the closed-form collectives."""
    sources = {
        "flops": "model_flops / chips (6 or 2 x N_active x tokens)",
        "bytes": "arg_bytes_per_device: every argument shard read once",
    }
    coll = None
    try:
        if prog.cell.kind == "train":
            coll = _train_collective_bytes(prog, axes, pod_reduce)
            sources["collective_bytes"] = (
                "closed form of the port's train step "
                "(_train_collective_bytes), ring algorithms")
        else:
            coll = (split_collective_bytes(prog, axes)
                    + routing_collective_bytes(prog, axes))
            sources["collective_bytes"] = (
                "closed form of the split over model in one forward "
                "(split_collective_bytes) and a decode step's MoE routing "
                "over the data ranks, ring algorithms")
    except NotImplementedError as e:
        sources["collective_bytes"] = f"not counted: {e}"
    return StepCost(flops=model_flops(prog.cfg, prog.cell) / n_chips,
                    bytes=arg_bytes, collective_bytes=coll, sources=sources)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape cell, comma list, or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--pod-reduce", default="fp32", choices=["fp32", "int8_ef"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the beyond-paper per-arch overrides")
    ap.add_argument("--no-count", action="store_true",
                    help="plan only: the roofline from the model's flops, "
                         "the arguments' bytes, the closed-form collectives")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    if args.list:
        for a in archs:
            spec = get_arch(a)
            for s in shapes:
                state = "SKIP" if s in spec.skip_cells else "run"
                print(f"{a:20s} {s:12s} {state}")
        return 0

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for a in archs:
        for s in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                suffix = "" if args.pod_reduce == "fp32" else f"__{args.pod_reduce}"
                path = os.path.join(args.out, f"{a}__{s}__{mesh_name}{suffix}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {path}")
                    continue
                t0 = time.perf_counter()
                rec = run_cell(a, s, multi_pod=mp, pod_reduce=args.pod_reduce,
                               cfg_overrides=OPT_OVERRIDES.get(a) if args.opt
                               else None, count=not args.no_count)
                dt = time.perf_counter() - t0
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=float)
                tag = rec["status"].upper()
                extra = ""
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    coll = ("n/a" if r["collective_s"] is None
                            else f"{r['collective_s']:.4f}s")
                    extra = (f"dom={r['dominant']} comp={r['compute_s']:.4f}s "
                             f"mem={r['memory_s']:.4f}s coll={coll} "
                             f"useful={r['useful_flops_ratio']:.3f} "
                             f"args={rec['arg_bytes_per_device'] / 2**30:.2f}GiB")
                elif rec["status"] == "error":
                    failures += 1
                    extra = rec["error"][:160]
                print(f"[{tag}] {a} {s} {mesh_name} ({dt:.1f}s) {extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
