"""PF-1 profiler (paper §IV-D).

For every node in the DFG, obtain Latency[1] and LUT[1] — in the paper by
synthesizing the node's template at PF=1 and simulating the whole design once.
Here "synthesis + simulation" is the evaluation of the template's ground-truth
cycle/LUT models (:mod:`repro_torch.core.node_types`); on the TPU backend, Latency[1]
is the single-chip roofline latency and the resource scalar is the node's
HBM-resident parameter footprint.

The profiler *tags the DFG in place* (``node.latency1``, ``node.lut1``) and
returns it, exactly mirroring the paper's pipeline stage.

Since the rewrite-first compile flow, the compiler hands this stage the
*canonical rewritten* graph (dead code pruned, constants folded, duplicate
subexpressions merged — see :func:`repro_torch.core.lowering.rewrite`), so every
profile entry corresponds to a node that actually executes.
"""

from __future__ import annotations

from repro_torch.core import node_types, tpu_model
from repro_torch.core.dfg import DFG

__all__ = ["profile_pf1"]


def profile_pf1(dfg: DFG, backend: str = "fpga",
                chip: tpu_model.TpuChip = tpu_model.TPU_V5E) -> DFG:
    for node in dfg.nodes.values():
        spec = node_types.get(node.op)
        if backend == "fpga":
            node.latency1 = float(spec.cycles(node.dims, 1))
            node.lut1 = float(spec.lut(node.dims, 1))
        elif backend == "tpu":
            node.latency1 = tpu_model.node_latency_s(
                spec.flops(node.dims), spec.mem_bytes(node.dims), chip, pf=1
            )
            node.lut1 = float(spec.mem_bytes(node.dims))
        else:
            raise ValueError(f"unknown backend {backend!r}")
    return dfg
