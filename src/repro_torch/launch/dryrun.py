"""Multi-pod dry-run: plan every (architecture × shape × mesh) cell on the
production meshes, on the host, and count what a device would hold and do.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch all --shape all --mesh both --out experiments/dryrun_torch

The port of the JAX package's ``launch/dryrun.py``.  The meshes are
abstract (:func:`repro_torch.launch.mesh.abstract_mesh`: 256 or 512 ranks,
no process group), and every argument is a meta tensor, so a cell
allocates nothing.  Each cell writes ``<out>/<arch>__<shape>__<mesh>.json``
with the planning seconds (``plan_s``), ``meta`` (the plan's notes, the
microbatches), ``arg_bytes_per_device`` (the state and batch shards a rank
holds: each dim of each argument divided by its axes, rounded up) and the
roofline terms :mod:`repro_torch.launch.roofline` can count.  The
reference's ``lower_s``, ``compile_s``, ``mem_*``, ``xla_cost_*``,
``hlo_*`` and ``collectives`` read XLA's compiled program and its HLO
(``launch/hlo_analysis.py``); PyTorch compiles no whole step ahead of
running it, so they are absent, each named with the reason in the record's
``absent``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any

from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_arch
from repro_torch.launch.mesh import PRODUCTION_SHAPES, abstract_mesh, mesh_axes
from repro_torch.launch.roofline import StepCost, model_flops, summarize
from repro_torch.launch.steps import CellProgram, build_cell
from repro_torch.models.transformer import _flatten
from repro_torch.sharding.spec import P, entry_axes, shard_shape
from repro_torch.sharding.tp import plan_split

__all__ = ["run_cell", "main", "args_bytes_per_device", "OPT_OVERRIDES",
           "ABSENT", "split_collective_bytes", "routing_collective_bytes"]

# Beyond-paper optimized-variant config overrides per arch (the reference's
# table): the per-arch knobs that change parameter layouts stay opt-in.
OPT_OVERRIDES: dict[str, dict] = {
    "musicgen-medium": {"head_pad_multiple": 16},   # 24 heads → 32, TP-able
}

_NO_HLO = ("XLA's compiled program and HLO have no PyTorch counterpart: "
           "nothing compiles a whole step ahead of running it")
ABSENT = {key: _NO_HLO for key in (
    "lower_s", "compile_s", "mem_argument_size_in_bytes",
    "mem_output_size_in_bytes", "mem_temp_size_in_bytes",
    "mem_generated_code_size_in_bytes", "mem_alias_size_in_bytes",
    "xla_cost_flops", "xla_cost_bytes", "hlo_lines", "collectives")}


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
      vocab-parallel embedding's all-reduce of T × D × a;
    * train: the forward again in the remat recompute (blocks only), the
      backward's all-reduce of the split inputs' gradients (T × D × a per
      layer input read in part: the attention's, the FFN's; and the
      head's input), the router logits' gradient summed (T × E fp32) where
      both the router's columns and the experts are split, and the loss's
      three reductions of T fp32 (the row max, the sum of exponentials,
      the gold logit);
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
    recompute again, and in the backward each Mamba2 layer's input
    gradient (T × D × a) and its squares' (T fp32), and the shared block's
    split inputs' (T × 2D × a each).

    0 where nothing is split over ``model``; raises NotImplementedError for
    a split the port cannot run."""
    cfg = prog.cfg
    m = axes.get("model", 1)
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
        inputs = _ring(m) * (M * T * (D * a + 4) + G * nb * T * 2 * D * a)
    else:
        if cfg.family == "moe":
            ep, sh = sp.experts is not None, sp.shared is not None
            reduces = heads + ep + (sh and not ep)
            n_in = heads + (ep or sh or sp.router is not None)
            router = (L * (m - 1) * T * (cfg.n_experts // m) * 4
                      if sp.router is not None else 0.0)
        else:
            reduces = n_in = heads + (sp.ffn is not None)
            router = 0.0
        blocks = L * reduces * _ring(m) * T * D * 4 + router
        inputs = L * n_in * _ring(m) * T * D * a
    embed = _ring(m) * T * D * a if sp.vocab_in is not None else 0.0
    sent = blocks + embed
    if kind == "train":
        sent += blocks if cfg.remat else 0.0
        sent += inputs
        if sp.router is not None and sp.experts is not None:
            sent += L * _ring(m) * T * cfg.n_experts * 4
        if sp.vocab_out is not None:
            sent += _ring(m) * T * D * a + 3 * _ring(m) * T * 4
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
                             pod_reduce: str) -> float:
    """Bytes a rank sends in one train step for the MoE layers' routing
    over the whole microbatch (:mod:`repro_torch.models.moe`), over the n
    ranks of the token group (pod × data, or data under the int8 cross-pod
    reduce), per layer and microbatch: the all-gather of the (k, E) int64
    counts ((n − 1) × k × E × 8) and the all-reduce of f's and p's sums (2
    × E fp32) in the forward and again in the remat recompute, and that
    all-reduce once more in the backward; with several microbatches, the
    all-gather of the rank's token rows ((n − 1) × rows × S × 4).  0 for a
    family without experts or at n = 1."""
    cfg = prog.cfg
    n = axes.get("data", 1) * (axes.get("pod", 1) if pod_reduce == "fp32" else 1)
    if cfg.family != "moe" or n == 1 or prog.cell.kind != "train":
        return 0.0
    E, k, L = cfg.n_experts, cfg.experts_per_token, cfg.n_layers
    micro = prog.meta.get("n_microbatches", 1)
    forward = (n - 1) * k * E * 8 + _ring(n) * 2 * E * 4
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
    ``model``) over pod; the split's own collectives
    (:func:`split_collective_bytes`) and the MoE routing's over the
    microbatch (:func:`routing_collective_bytes`)."""
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
    return (sent + split_collective_bytes(prog, axes)
            + routing_collective_bytes(prog, axes, pod_reduce))


def _model_only(spec) -> P:
    """``spec`` with every axis but ``model`` dropped."""
    return P(*("model" if "model" in entry_axes(e) else None
               for e in (spec or ())))


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             pod_reduce: str = "fp32", allow_uneven: bool = False,
             cfg_overrides: dict | None = None) -> dict:
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
    try:
        mesh = abstract_mesh(*PRODUCTION_SHAPES[multi_pod])
        axes = mesh_axes(mesh)
        n_chips = mesh.size
        t0 = time.perf_counter()
        prog = build_cell(spec, cell, mesh, pod_reduce=pod_reduce,
                          allow_uneven=allow_uneven, cfg_overrides=cfg_overrides)
        rec["plan_s"] = time.perf_counter() - t0
        rec["meta"] = prog.meta
        rec["arg_bytes_per_device"] = args_bytes_per_device(prog, axes)
        sources = {
            "flops": "model_flops / chips (6 or 2 x N_active x tokens)",
            "bytes": "arg_bytes_per_device: every argument shard read once",
        }
        coll = None
        try:
            if cell.kind == "train":
                coll = _train_collective_bytes(prog, axes, pod_reduce)
                sources["collective_bytes"] = (
                    "the port's train step: the masters' all-gather over the "
                    "axes but model, the gradients' all-reduce, the split's "
                    "all-reduces over model (2 a layer forward, again in the "
                    "recompute and the backward, the embedding's, the loss's "
                    "3; MoE: the router logits' gather; Mamba2: out_proj's "
                    "and the gated norm's squares a layer, the shared "
                    "block's 2 an application), the MoE routing's "
                    "counts and aux sums over the data ranks, ring "
                    "algorithms")
            else:
                coll = split_collective_bytes(prog, axes)
                sources["collective_bytes"] = (
                    "the split over model in one forward: 2 all-reduces a "
                    "layer (MoE: the router logits' gather; Mamba2: "
                    "out_proj's and the gated norm's squares a layer, the "
                    "shared block's 2 an application), the "
                    "embedding's; on a sequence-split cache q's, the "
                    "outputs' and the log-sum-exps' all-gathers a layer")
        except NotImplementedError as e:
            sources["collective_bytes"] = f"not counted: {e}"
        cost = StepCost(flops=model_flops(prog.cfg, cell) / n_chips,
                        bytes=rec["arg_bytes_per_device"],
                        collective_bytes=coll, sources=sources)
        rec["roofline"] = summarize(prog.cfg, cell, cost, n_chips)
        rec["absent"] = dict(ABSENT)
    except Exception as e:          # noqa: BLE001 — a cell's failure is its record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


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
                               else None)
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
                             f"args={rec['arg_bytes_per_device'] / 2**30:.2f}GiB")
                elif rec["status"] == "error":
                    failures += 1
                    extra = rec["error"][:160]
                print(f"[{tag}] {a} {s} {mesh_name} ({dt:.1f}s) {extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
