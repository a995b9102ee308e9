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
from repro_torch.sharding.spec import P, entry_axes, shard_shape

__all__ = ["run_cell", "main", "args_bytes_per_device", "OPT_OVERRIDES",
           "ABSENT"]

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


def _train_collective_bytes(prog: CellProgram, axes: dict[str, int],
                            pod_reduce: str) -> float:
    """Bytes a rank sends in one step of the port's train step (ring
    algorithms): each master's all-gather over the ranks that shard it,
    then the gradients' all-reduce over (pod, data) in float32, or over
    data in float32 and an int8 all-gather (+ a float32 scale a leaf) over
    pod."""
    masters = _pairs(prog.args[0].params, prog.in_shardings[0].params)
    sent = 0.0
    for x, s in masters:
        k = math.prod(axes[a] for e in (s or ()) for a in entry_axes(e))
        sent += (k - 1) * _shard_bytes(x, s, axes)
    grads = sum(math.prod(x.shape) for x, _ in masters)
    n_leaves = len(masters)
    ring = lambda n: 2 * (n - 1) / n if n > 1 else 0.0
    if pod_reduce == "int8_ef":
        pods = axes.get("pod", 1)
        sent += ring(axes.get("data", 1)) * 4 * grads
        sent += (pods - 1) * (grads + 4 * n_leaves)
    else:
        sent += ring(axes.get("pod", 1) * axes.get("data", 1)) * 4 * grads
    return sent


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
        if cell.kind == "train":
            coll = _train_collective_bytes(prog, axes, pod_reduce)
            sources["collective_bytes"] = (
                "the port's train step: the masters' all-gather and the "
                "gradients' all-reduce, ring algorithms")
        else:
            sources["collective_bytes"] = (
                "not counted: serving on a plan is the next slice")
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
