"""Plain PyTorch versions of the port's kernels and their stage vocabulary.

Each function here is the numerical ground truth a hand-written kernel is
held against, run on the CPU by the tests and on the card by
``chip_smoke.py``: :func:`run_segment_ref` for the CUDA megakernel
(:mod:`repro_torch.kernels.megakernel`), :func:`linear_chain_ref` and
:func:`linear_chain_q_ref` for the chain kernels
(:mod:`repro_torch.kernels.linear_pipeline`), :func:`spmv_ref` for the
block-sparse product (:mod:`repro_torch.kernels.spmv`) and
:func:`gemv_ref`/:func:`matmul_ref` for the tiled matmul
(:mod:`repro_torch.kernels.gemv`).

Float reductions (matvec rows, squared distances, sums, dots) accumulate in
index order, one rounded multiply and one rounded add per term — the order
the kernel's threads use — so the plain version and the kernel agree bit
for bit on the card up to the transcendental functions, and a bucket gives
each sample exactly what a one-sample call gives it.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["spmv_ref", "gemv_ref", "matmul_ref", "apply_stage",
           "apply_stage_q", "linear_chain_ref", "linear_chain_q_ref",
           "run_segment_ref", "run_segment_grid_ref", "float_pe_outputs"]


def spmv_ref(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched SpMV: ``w`` dense-with-zeros (m, n), ``x`` (B, n) → (B, m)."""
    return x @ w.T


def gemv_ref(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched GEMV: ``w`` (m, n), ``x`` (B, n) → (B, m)."""
    return x @ w.T


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


# ------------------------------------------------------------- linear pipeline
# Float stage forms (op, operand):
#   ("scalar_mul", c)      x * c
#   ("add_vec", v)         x + v          (v broadcast over batch)
#   ("sub_vec", v)         x - v
#   ("hadamard_vec", v)    x * v
#   ("tanh"|"sigmoid"|"relu"|"exp", None)
#   ("add_arr"|"sub_arr"|"hadamard_arr", i)  — second operand is extras[i]
Stage = tuple[str, object]


def apply_stage(x: torch.Tensor, stage: Stage,
                extras: Sequence[torch.Tensor]) -> torch.Tensor:
    op, operand = stage
    if op == "scalar_mul":
        return x * operand
    if op == "add_vec":
        return x + operand
    if op == "sub_vec":
        return x - operand
    if op == "hadamard_vec":
        return x * operand
    if op == "tanh":
        return torch.tanh(x)
    if op == "sigmoid":
        return torch.sigmoid(x)
    if op == "relu":
        return torch.clamp_min(x, 0.0)
    if op == "exp":
        return torch.exp(x)
    if op == "add_arr":
        return x + extras[operand]
    if op == "sub_arr":
        return x - extras[operand]
    if op == "hadamard_arr":
        return x * extras[operand]
    raise ValueError(f"unknown stage op {op!r}")


def linear_chain_ref(x: torch.Tensor, stages: Sequence[Stage],
                     extras: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    for stage in stages:
        x = apply_stage(x, stage, extras)
    return x


# -------------------------------------------------- quantized linear pipeline
# The fixed-point twin on the int32 carrier; every stage ends in a static
# requantizing shift.  Stage forms (op, operand):
#   ("q_scalar_mul",   (c, rq))             requantize(x · c, rq)
#   ("q_add_vec",      (vi, sa, sb, rq))    requantize(sh(x,sa) + sh(v,sb), rq)
#   ("q_sub_vec",      (vi, sa, sb, rq))    requantize(sh(x,sa) − sh(v,sb), rq)
#   ("q_hadamard_vec", (vi, rq))            requantize(x · v, rq)
#   ("q_add_arr"|"q_sub_arr", (ai, sa, sb, rq))   — operand is extras[ai]
#   ("q_hadamard_arr", (ai, rq))
#   ("q_unary",        (name, e_in, e_out))  dequantize → float PE → quantize

# Float formulas of the table-based nonlinear PEs — the node templates'
# formulas (sigmoid is 1/(1+exp(-x)) here, unlike ``apply_stage``).
_UNARY_F = {
    "tanh": torch.tanh,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "exp": torch.exp,
}
UNARY_NAMES = tuple(_UNARY_F)


def _align(x: torch.Tensor, s: int) -> torch.Tensor:
    """Plain arithmetic align shift (no rounding)."""
    return x << s if s >= 0 else x >> (-s)


def apply_stage_q(x: torch.Tensor, stage: Stage, vecs: Sequence[torch.Tensor],
                  extras: Sequence[torch.Tensor], bits: int = 8) -> torch.Tensor:
    """One quantized stage on the int32 stream ``x``; ``vecs``/``extras``
    are int32-widened operands."""
    from repro_torch.core.quantize import quantize_core, requantize_core

    op, operand = stage
    if op == "q_scalar_mul":
        c, rq = operand
        return requantize_core(x * c, rq, bits)
    if op in ("q_add_vec", "q_sub_vec", "q_add_arr", "q_sub_arr"):
        idx, sa, sb, rq = operand
        b = vecs[idx] if op.endswith("_vec") else extras[idx]
        acc = _align(x, sa) + (1 if "add" in op else -1) * _align(b, sb)
        return requantize_core(acc, rq, bits)
    if op in ("q_hadamard_vec", "q_hadamard_arr"):
        idx, rq = operand
        b = vecs[idx] if op.endswith("_vec") else extras[idx]
        return requantize_core(x * b, rq, bits)
    if op == "q_unary":
        name, e_in, e_out = operand
        xf = x.to(torch.float32) * (2.0 ** (-e_in))
        return quantize_core(_UNARY_F[name](xf), e_out, bits)
    raise ValueError(f"unknown quantized stage op {op!r}")


def linear_chain_q_ref(x: torch.Tensor, stages: Sequence[Stage],
                       vecs: Sequence[torch.Tensor] = (),
                       extras: Sequence[torch.Tensor] = (),
                       bits: int = 8) -> torch.Tensor:
    """Widen to the int32 carrier, apply each stage, narrow on write."""
    out_dtype = x.dtype
    x = x.to(torch.int32)
    vecs = [v.to(torch.int32) for v in vecs]
    extras = [e.to(torch.int32) for e in extras]
    for stage in stages:
        x = apply_stage_q(x, stage, vecs, extras, bits)
    return x.to(out_dtype)


# ----------------------------------------------------------------- megakernel
_FLOAT_PE_OPS = ("SQL2", "REDUCE", "DOT")


def float_pe_outputs(seg: Any) -> tuple[bool, ...]:
    """Per output of ``seg``: whether a float PE lies on its path — a
    ``q_unary`` stage or an ``SQL2``/``REDUCE``/``DOT`` (dequantize → float
    → quantize on the integer lanes).  Only there may two implementations'
    transcendentals differ by an ulp and so an integer output by 1 LSB;
    every other integer output must agree exactly."""
    tainted: set[int] = set()
    outs = [False] * len(seg.out_refs)
    for ins in seg.instrs:
        if ins.op == "STORE":
            outs[ins.operand] = ins.src[0] in tainted
        elif ins.dst >= 0:
            pe = (ins.op in _FLOAT_PE_OPS or (ins.op == "ELEMENTWISE"
                                              and ins.operand[0][0] == "q_unary"))
            if pe or any(s in tainted for s in ins.src):
                tainted.add(ins.dst)
            else:
                tainted.discard(ins.dst)
    return tuple(outs)


def _pools(seg: Any, device: torch.device) -> tuple[list, list]:
    """The segment's const rows (carrier dtype, ``(1, n)``) and matrices as
    tensors on ``device``, converted once per segment and device."""
    from repro_torch.kernels.build import segment_cache

    def build():
        carrier = np.int32 if seg.quantized else np.float32
        crows = [torch.from_numpy(np.asarray(c, carrier).reshape(1, -1))
                 .to(device) for c in seg.consts]
        mats = [torch.from_numpy(np.ascontiguousarray(m)).to(device)
                for m in seg.matrices]
        return crows, mats

    return segment_cache("pools", seg, device, build)


def _seq_sum(terms) -> torch.Tensor:
    """Σ in index order, one rounded add per term (the kernel's order)."""
    acc = None
    for t in terms:
        acc = t if acc is None else acc + t
    return acc


def _reduce(x: torch.Tensor, kind: str) -> torch.Tensor:
    """(nb, n) → (nb, 1) sum/max/min over the row, sums in index order."""
    if kind == "sum":
        return _seq_sum(x[:, j:j + 1] for j in range(x.shape[1]))
    return (torch.amax if kind == "max" else torch.amin)(x, dim=1, keepdim=True)


def _segment_rows(seg: Any, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Execute the instruction stream on ``(nb, width)`` rows."""
    from repro_torch.core.quantize import (dequantize, quantize_core,
                                           requantize_core, requantize_rows)
    from repro_torch.kernels.megakernel import _seg_out_dtypes

    device = xs[0].device if xs else torch.device("cpu")
    nb = xs[0].shape[0] if xs else 1
    carrier = torch.int32 if seg.quantized else torch.float32
    crows, mats = _pools(seg, device)
    out_dts = _seg_out_dtypes(seg)

    def dq(x, e):
        return x if e is None else dequantize(x, e)

    def q(x, e):
        return x if e is None else quantize_core(x, e, seg.bits)

    slots: dict[int, torch.Tensor] = {}
    outs: dict[int, torch.Tensor] = {}
    for instr in seg.instrs:
        op = instr.op
        if op == "LOAD_VEC":
            kind, idx = instr.operand
            src = xs[idx] if kind == "in" else crows[idx].expand(nb, -1)
            slots[instr.dst] = src.to(carrier)
        elif op == "LOAD_MAT":
            pass                               # matrices are read in place
        elif op in ("MATVEC", "SPMV"):
            mi, bias_ci = instr.operand
            w, x = mats[mi], slots[instr.src[0]]
            if seg.quantized:                  # int32 wraps; order-free
                acc = (w[None] * x[:, None, :]).sum(-1, dtype=torch.int32)
            else:
                acc = _seq_sum(w[:, j][None, :] * x[:, j:j + 1]
                               for j in range(w.shape[1]))
                if acc is None:
                    acc = torch.zeros(nb, w.shape[0], device=device)
            if bias_ci is not None:
                acc = acc + crows[bias_ci]
            slots[instr.dst] = acc
        elif op == "REQUANTIZE":
            kind, sh = instr.operand
            x = slots[instr.src[0]]
            if kind == "rows":
                y = requantize_rows(x, crows[sh][0], seg.bits)
            else:
                y = requantize_core(x, sh, seg.bits)
            slots[instr.dst] = y.to(carrier)
        elif op == "ARGMAX":
            x = slots[instr.src[0]]
            slots[instr.dst] = torch.argmax(x, dim=1, keepdim=True).to(carrier)
        elif op == "REDUCE":
            kind, e_in, e_out = instr.operand
            r = _reduce(dq(slots[instr.src[0]], e_in), kind)
            slots[instr.dst] = q(r, e_out).to(carrier)
        elif op == "SQL2":
            mi, e_in, e_out = instr.operand
            pts = mats[mi]                     # (d, m)
            x = dq(slots[instr.src[0]], e_in)
            diffs = (pts[i][None, :] - x[:, i:i + 1] for i in range(pts.shape[0]))
            acc = _seq_sum(d * d for d in diffs)
            slots[instr.dst] = q(acc, e_out).to(carrier)
        elif op == "DOT":
            e_a, e_b, e_out = instr.operand
            a = dq(slots[instr.src[0]], e_a)
            b = dq(slots[instr.src[1]], e_b)
            r = _seq_sum(a[:, j:j + 1] * b[:, j:j + 1] for j in range(a.shape[1]))
            slots[instr.dst] = q(r, e_out).to(carrier)
        elif op == "ELEMENTWISE":
            stage, vec_cis = instr.operand
            x = slots[instr.src[0]]
            extras = [slots[s] for s in instr.src[1:]]
            if seg.quantized:
                vv = [crows[ci] for ci in vec_cis]
                slots[instr.dst] = apply_stage_q(x, stage, vv, extras, seg.bits)
            else:
                if stage[0] in ("add_vec", "sub_vec", "hadamard_vec"):
                    stage = (stage[0], crows[vec_cis[0]])
                slots[instr.dst] = apply_stage(x, stage, extras)
        elif op == "STORE":
            outs[instr.operand] = slots[instr.src[0]].to(out_dts[instr.operand])
        else:
            raise ValueError(f"unknown megakernel op {op!r}")
    return [outs[i].contiguous() for i in range(len(seg.out_refs))]


def run_segment_ref(seg: Any, inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.megakernel.run_segment`:
    one sample, inputs of any shape, one flat value per ``seg.out_refs``."""
    outs = _segment_rows(seg, [x.reshape(1, -1) for x in inputs])
    return [o[0] for o in outs]


def run_segment_grid_ref(seg: Any,
                         inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.megakernel.run_segment_grid`:
    a bucket with a leading batch axis, one ``(nb, width)`` value per output."""
    nb = int(inputs[0].shape[0])
    return _segment_rows(seg, [x.reshape(nb, -1) for x in inputs])
