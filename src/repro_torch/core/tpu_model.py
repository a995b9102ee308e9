"""TPU v5e hardware model — the adaptation target of this reproduction.

MAFIA's PF abstraction maps onto the TPU as the *sharding degree* of a node
across the ``model`` mesh axis (inter-chip parallelism) plus Pallas grid/block
parallelism (intra-chip).  This module supplies the roofline constants and the
per-node latency/resource callbacks the Best-PF estimator uses when compiling
for the TPU backend, replacing the FPGA LUT/DSP callbacks.

Hardware constants (per chip, TPU v5e — fixed by the assignment):
  * 197 TFLOP/s bf16 peak compute
  * 819 GB/s HBM bandwidth
  * ~50 GB/s/link ICI
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["TpuChip", "TPU_V5E", "TpuBudget", "node_latency_s", "roofline_terms"]


@dataclasses.dataclass(frozen=True)
class TpuChip:
    name: str
    peak_flops_bf16: float   # FLOP/s
    hbm_bw: float            # bytes/s
    ici_bw_per_link: float   # bytes/s, per link per direction
    hbm_bytes: float
    vmem_bytes: float
    kernel_overhead_s: float = 2e-6  # launch/fusion boundary overhead


TPU_V5E = TpuChip(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_bw_per_link=50e9,
    hbm_bytes=16 * 1024**3,
    vmem_bytes=128 * 1024**2,
)


@dataclasses.dataclass(frozen=True)
class TpuBudget:
    """Resource budget seen by the Best-PF estimator on the TPU backend.

    ``max_shard`` is the size of the mesh axis a node may be sharded over
    (the FPGA LUT budget analogue: the pool the optimizer allocates from).
    Chips are time-shared, so unlike LUTs the constraint is per-node
    (pf <= max_shard) plus a per-chip HBM capacity check, not a global sum.
    """

    chip: TpuChip = TPU_V5E
    max_shard: int = 16

    def cycles_to_us(self, seconds: float) -> float:  # symmetric API with FpgaBudget
        return seconds * 1e6


def node_latency_s(flops: float, mem_bytes: float, chip: TpuChip, pf: int,
                   reshard_bytes: float = 0.0) -> float:
    """Roofline latency of one DFG node sharded ``pf`` ways.

    max(compute, memory) per shard + any resharding collective the PF
    mismatch with the producer induces (the paper's data-shuffle cost,
    §IV-A, reincarnated as ICI traffic).
    """
    compute = flops / (pf * chip.peak_flops_bf16)
    memory = mem_bytes / (pf * chip.hbm_bw)
    shuffle = reshard_bytes / chip.ici_bw_per_link if reshard_bytes else 0.0
    return max(compute, memory) + shuffle + chip.kernel_overhead_s


def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    n_chips: int,
    chip: TpuChip = TPU_V5E,
) -> dict[str, float]:
    """The three §Roofline terms, in seconds (whole-program, n_chips-wide)."""
    return {
        "compute_s": hlo_flops / (n_chips * chip.peak_flops_bf16),
        "memory_s": hlo_bytes / (n_chips * chip.hbm_bw),
        "collective_s": collective_bytes / (n_chips * chip.ici_bw_per_link),
    }


def dominant_term(terms: dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
