"""§Roofline terms of a step on a mesh of H100s.

The port of the JAX package's ``launch/roofline.py``.  The reference's
three terms read the compiled program's HLO through ``hlo_analysis``; the
port's read :mod:`repro_torch.launch.op_analysis`'s count of one rank's
step (the dry-run's default, :func:`repro_torch.launch.dryrun.
count_cell`), or without a count the model's flops, the arguments' bytes
and the closed-form collectives.  Each term's source is named in the
record:

    compute_s    = flops a device / 989e12 FLOP/s (the bf16 dense
                   tensor-core peak of one H100 SXM, NVIDIA's data sheet)
    memory_s     = bytes a device moves / 3.35e12 B/s (its HBM)
    collective_s = the bytes a device sends in the step's collectives (ring
                   algorithms) / 450e9 B/s (one direction of its NVLink)

plus the reference's ``MODEL_FLOPS`` = 6·N_active·tokens for a train step,
2·N_active·tokens for a forward (decode: one token a sequence), the
counted flops over all devices (``flops_global``) and the usefulness
ratio ``model_flops / flops_global`` (remat pushes it below 1 by design;
values far below 0.3 flag waste).

These are lower bounds on a step of the port's design, not a trace of one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.configs.registry import ShapeCell
from repro_torch.models.transformer import ModelConfig, abstract_params

__all__ = ["H100", "Chip", "StepCost", "n_active_params", "model_flops",
           "roofline_terms", "dominant_term", "summarize"]


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_flops_bf16: float   # FLOP/s
    hbm_bw: float            # bytes/s
    link_bw: float           # bytes/s, NVLink, one direction


H100 = Chip(name="NVIDIA H100 SXM (data sheet, 700 W)", peak_flops_bf16=989e12,
            hbm_bw=3.35e12, link_bw=450e9)


@dataclasses.dataclass
class StepCost:
    """Per-device work of one step and where each number came from."""
    flops: float
    bytes: float
    collective_bytes: float | None
    sources: dict[str, str]


def _leaves_with_keys(tree: Any, keys: tuple = ()) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_keys(tree[k], keys + (k,))]
    return [(keys, tree)]


def n_active_params(cfg: ModelConfig) -> int:
    """Non-embedding parameters, with routed experts scaled by k/E."""
    total = 0.0
    for keys, leaf in _leaves_with_keys(abstract_params(cfg)):
        if keys[-1] == "embed":
            continue
        n = math.prod(leaf.shape)
        if "moe" in keys and keys[-1] in ("w_gate", "w_up", "w_down") and leaf.dim() == 4:
            n *= cfg.experts_per_token / cfg.n_experts
        total += n
    return int(total)


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    n_act = n_active_params(cfg)
    if cell.kind == "train":
        return 6.0 * n_act * cell.seq_len * cell.global_batch
    if cell.kind == "prefill":
        return 2.0 * n_act * cell.seq_len * cell.global_batch
    # decode: one token per sequence (attention cache reads are the memory
    # term's job, not FLOPs)
    return 2.0 * n_act * cell.global_batch


def roofline_terms(flops: float, nbytes: float, collective_bytes: float | None,
                   n_chips: int, chip: Chip = H100) -> dict[str, float | None]:
    """The three terms in seconds, for whole-program work over ``n_chips``;
    an unknown collective volume leaves its term None."""
    return {
        "compute_s": flops / (n_chips * chip.peak_flops_bf16),
        "memory_s": nbytes / (n_chips * chip.hbm_bw),
        "collective_s": (None if collective_bytes is None
                         else collective_bytes / (n_chips * chip.link_bw)),
    }


def dominant_term(terms: dict[str, float | None]) -> str:
    known = {k: v for k, v in terms.items() if v is not None}
    return max(known, key=known.get)


def summarize(cfg: ModelConfig, cell: ShapeCell, cost: StepCost,
              n_chips: int, chip: Chip = H100) -> dict[str, Any]:
    """Roofline record of a per-device :class:`StepCost` (per-device work
    over one chip's peaks, the same as global work over all chips')."""
    terms = roofline_terms(cost.flops, cost.bytes, cost.collective_bytes, 1,
                           chip)
    known = [v for v in terms.values() if v is not None]
    bound, total = max(known), sum(known)
    mf, flops_global = model_flops(cfg, cell), cost.flops * n_chips
    return {
        **terms,
        "dominant": dominant_term(terms),
        "flops_per_device": cost.flops,
        "flops_global": flops_global,
        "bytes_per_device": cost.bytes,
        "collective_bytes_per_device": cost.collective_bytes,
        "model_flops": mf,
        "useful_flops_ratio": mf / flops_global if flops_global else float("nan"),
        "n_chips": n_chips,
        "chip": chip.name,
        "sources": dict(cost.sources),
        # step-time bounds: all-overlapped (max term) vs fully serial (sum)
        "ideal_step_s": bound,
        "serial_step_s": total,
        "overlap_headroom": bound / total if total else float("nan"),
    }
