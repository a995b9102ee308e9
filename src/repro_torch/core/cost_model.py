"""Latency/resource estimation models (paper §IV-B).

For each op type we fit the paper's regression forms against PF sweeps of the
ground-truth template costs:

    Latency[PF] = (aL + bL*PF + cL/PF) * Latency[1]
    LUT[PF]     = (aLUT + bLUT*PF)     * LUT[1]
    DSP[PF]     = aDSP * PF                       (set by the template author)

Training data generation mirrors §IV-B: several sets of fixed input dimensions,
PF swept from 1 to the template's parallelization limit, "synthesize and
simulate" each point (here: evaluate the template's ground-truth cycle/LUT
model), then least-squares fit.  The fitted models are intentionally unable to
express the templates' log2 reduction-tree / crossbar terms, so — exactly as in
the paper — they carry real error (§VI-B) while remaining rank-correct, which
is all the Best-PF estimator needs.

Models are pre-trained once per "FPGA family" at tool-build time; we cache
them in-process (and they are cheap enough to refit on import).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from repro_torch.core import node_types

__all__ = ["OpEstimator", "EstimatorBank", "train_estimators", "default_bank",
           "chain_live_bytes"]


def chain_live_bytes(dfg, chain: list[str] | tuple[str, ...],
                     *, prev: str | None = None) -> float:
    """Peak live footprint of one fused stage chain, in bytes — the
    VMEM/live-extras model behind cost-guided chain splitting.

    A fused chain holds, simultaneously resident: the streaming tile, the
    output tile, one full tile per ``*_arr`` extra edge (a second DFG input
    to a binary stage) and one broadcast row per ``*_vec`` static operand —
    including ``const``-node operands, which the lowering embeds as static
    vec rows rather than streaming them as full extras.  The byte model
    mirrors the actual tiling of the pipeline kernel
    (:func:`repro_torch.kernels.linear_pipeline.chain_vmem_bytes`), so the budget
    is stated in the same units the launch really occupies.  ``prev`` is
    the element streaming into the chain's head when it continues a split
    predecessor (the previous sub-chain's terminal — the splitter passes
    it), None for a true chain head.
    """
    from repro_torch.kernels.linear_pipeline import chain_vmem_bytes

    n_vec = n_arr = 0
    for idx, nid in enumerate(chain):
        node = dfg.nodes[nid]
        if node.op in ("add", "sub", "hadamard"):
            if "vec" in node.params:
                n_vec += 1
            elif len(node.inputs) == 2:
                # the non-stream operand: the chain predecessor streams in;
                # at a true chain head the first input does (matching
                # lowering._lower_stage_float's stream selection)
                p = chain[idx - 1] if idx else prev
                rin = list(node.inputs)
                stream = p if p in rin else rin[0]
                other = [r for r in rin if r != stream]
                cnode = dfg.nodes.get(other[0]) if len(other) == 1 else None
                if cnode is not None and cnode.op == "const":
                    n_vec += 1     # embedded as a static vec row
                else:
                    n_arr += 1
    n = 1
    for s in dfg.out_shape(chain[-1]):
        n *= int(s)
    return float(chain_vmem_bytes(n, n_vec, n_arr))


# Representative dimension sets per op family used for model training
# (arbitrary fixed dims per §IV-B; several sets per op).
_TRAIN_DIMS: dict[str, list[dict[str, int]]] = {
    "gemv": [{"m": 16, "n": 64}, {"m": 30, "n": 400}, {"m": 64, "n": 784}, {"m": 10, "n": 1000}],
    "spmv": [
        {"m": 10, "n": 256, "nnz": 512},
        {"m": 30, "n": 400, "nnz": 2400},
        {"m": 20, "n": 784, "nnz": 3136},
        {"m": 15, "n": 1000, "nnz": 3000},
    ],
    "matmul": [{"m": 8, "k": 16, "n": 8}, {"m": 16, "k": 30, "n": 10}],
    "outer": [{"m": 16, "n": 16}, {"m": 30, "n": 10}],
    "sq_l2": [{"d": 10, "m": 20}, {"d": 15, "m": 60}, {"d": 30, "m": 40}],
    "add": [{"n": 64}, {"n": 400}, {"n": 1024}],
    "sub": [{"n": 64}, {"n": 400}, {"n": 1024}],
    "hadamard": [{"n": 64}, {"n": 400}, {"n": 1024}],
    "scalar_mul": [{"n": 64}, {"n": 512}],
    "relu": [{"n": 64}, {"n": 512}],
    "exp": [{"n": 32}, {"n": 256}],
    "sigmoid": [{"n": 32}, {"n": 256}],
    "tanh": [{"n": 32}, {"n": 256}],
    "dot": [{"n": 64}, {"n": 400}, {"n": 1024}],
    "reduce_sum": [{"n": 64}, {"n": 400}],
    "reduce_max": [{"n": 64}, {"n": 400}],
    "reduce_min": [{"n": 64}, {"n": 400}],
    "argmax": [{"n": 8}, {"n": 64}],
    "const": [{"n": 64}, {"n": 400}],
    "conv2d": [
        {"cout": 8, "cin": 1, "kh": 3, "kw": 3, "h": 28, "w": 28,
         "hout": 26, "wout": 26},
        {"cout": 16, "cin": 8, "kh": 3, "kw": 3, "h": 14, "w": 14,
         "hout": 12, "wout": 12, "bias": 1},
    ],
    "maxpool2d": [
        {"c": 8, "h": 26, "w": 26, "hout": 13, "wout": 13, "kh": 2, "kw": 2},
        {"c": 16, "h": 12, "w": 12, "hout": 6, "wout": 6, "kh": 2, "kw": 2},
    ],
    "avgpool2d": [
        {"c": 8, "h": 26, "w": 26, "hout": 13, "wout": 13, "kh": 2, "kw": 2},
        {"c": 16, "h": 12, "w": 12, "hout": 6, "wout": 6, "kh": 2, "kw": 2},
    ],
    "relu6": [{"n": 64}, {"n": 512}],
    "softmax": [{"n": 10}, {"n": 64}],
    "layernorm": [{"n": 64}, {"n": 256}],
    "flatten": [{"n": 256}, {"n": 1024}],
    "reshape": [{"n": 256}, {"n": 1024}],
}

_PF_SWEEP_POINTS = 24


@dataclasses.dataclass(frozen=True)
class OpEstimator:
    """Fitted estimation model for one op type."""

    op: str
    aL: float
    bL: float
    cL: float
    aLUT: float
    bLUT: float
    aDSP: float

    def latency(self, latency1: float, pf: int) -> float:
        return (self.aL + self.bL * pf + self.cL / pf) * latency1

    def lut(self, lut1: float, pf: int) -> float:
        return (self.aLUT + self.bLUT * pf) * lut1

    def dsp(self, pf: int) -> float:
        return self.aDSP * pf


def _sweep_pfs(max_pf: int) -> list[int]:
    if max_pf <= _PF_SWEEP_POINTS:
        return list(range(1, max_pf + 1))
    # geometric sweep so large templates still see the high-PF regime
    pts = sorted({int(round(max_pf ** (i / (_PF_SWEEP_POINTS - 1)))) for i in range(_PF_SWEEP_POINTS)})
    return [max(1, p) for p in pts]


def _fit_op(op: str, dim_sets: list[dict[str, int]]) -> OpEstimator:
    spec = node_types.get(op)
    lat_rows, lat_y = [], []
    lut_rows, lut_y = [], []
    for dims in dim_sets:
        max_pf = min(spec.max_pf(dims), 256)
        lat1 = spec.cycles(dims, 1)
        lut1 = spec.lut(dims, 1)
        for pf in _sweep_pfs(max_pf):
            # "synthesize and simulate" — evaluate ground-truth template cost
            lat_rows.append([1.0, pf, 1.0 / pf])
            lat_y.append(spec.cycles(dims, pf) / lat1)
            lut_rows.append([1.0, pf])
            lut_y.append(spec.lut(dims, pf) / lut1)
    (aL, bL, cL), *_ = np.linalg.lstsq(np.array(lat_rows), np.array(lat_y), rcond=None)
    (aLUT, bLUT), *_ = np.linalg.lstsq(np.array(lut_rows), np.array(lut_y), rcond=None)
    return OpEstimator(op=op, aL=float(aL), bL=float(bL), cL=float(cL),
                       aLUT=float(aLUT), bLUT=float(bLUT), aDSP=float(spec.dsp_per_pe))


@dataclasses.dataclass
class EstimatorBank:
    estimators: dict[str, OpEstimator]

    def latency(self, op: str, latency1: float, pf: int) -> float:
        return self.estimators[op].latency(latency1, pf)

    def lut(self, op: str, lut1: float, pf: int) -> float:
        return self.estimators[op].lut(lut1, pf)

    def dsp(self, op: str, pf: int) -> float:
        return self.estimators[op].dsp(pf)

    def errors(self) -> dict[str, dict[str, float]]:
        """Mean relative estimation error vs ground truth on a held-out sweep
        (dimension sets not used in training) — reproduces §VI-B."""
        rng = np.random.default_rng(0)
        out: dict[str, dict[str, float]] = {}
        for op, est in self.estimators.items():
            spec = node_types.get(op)
            train_sets = _TRAIN_DIMS[op]
            lat_err, lut_err, dsp_err, n = 0.0, 0.0, 0.0, 0
            for dims in train_sets:
                held = {k: max(2, int(v * (1.3 + 0.4 * rng.random()))) for k, v in dims.items()}
                if "nnz" in held:
                    held["nnz"] = min(held["nnz"], held["m"] * held["n"])
                max_pf = min(spec.max_pf(held), 256)
                lat1, lut1 = spec.cycles(held, 1), spec.lut(held, 1)
                for pf in _sweep_pfs(max_pf):
                    lat_err += abs(est.latency(lat1, pf) - spec.cycles(held, pf)) / spec.cycles(held, pf)
                    lut_err += abs(est.lut(lut1, pf) - spec.lut(held, pf)) / max(1.0, spec.lut(held, pf))
                    dsp_err += abs(est.dsp(pf) - spec.dsp(pf)) / max(1.0, spec.dsp(pf))
                    n += 1
            out[op] = {"latency": lat_err / n, "lut": lut_err / n, "dsp": dsp_err / n}
        return out


def train_estimators() -> EstimatorBank:
    return EstimatorBank({op: _fit_op(op, dims) for op, dims in _TRAIN_DIMS.items()})


@functools.lru_cache(maxsize=1)
def default_bank() -> EstimatorBank:
    """The pre-trained models shipped with the framework (paper: one-time
    effort per FPGA family, included as part of MAFIA)."""
    return train_estimators()
