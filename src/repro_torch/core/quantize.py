"""Fixed-point quantization pass — the workload class MAFIA targets.

PyTorch port of the SeeDot-style power-of-two quantizer: one exponent per
tensor (``value ≈ q · 2^-exp``, ``q`` an int8 or int16), symmetric ranges,
and every rescale a plain arithmetic shift.  The numeric helpers work on
torch tensors of any device and keep the reference semantics bit for bit:

* rounding is half-to-even (``torch.round``),
* the int32 carrier wraps on overflow like XLA's,
* right shifts are arithmetic, capped at ``_MAX_RSHIFT``; left shifts clamp
  the accumulator to ``±2^(30−lsh)`` first; results saturate at ``±q_max``.

:func:`calibrate` walks the DFG with the port's float templates on the CPU
over a calibration batch and infers the per-tensor exponents; the plan it
returns is plain numpy/int data, identical to the reference's for the same
graph and batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core import node_types
from repro_torch.core.dfg import DFG

__all__ = [
    "Q_MAX", "PRECISION_BITS", "NodeQuant", "QuantPlan", "q_max", "int_dtype",
    "torch_int_dtype", "pow2_exp", "quantize_np", "quantize_t",
    "quantize_core", "dequantize", "requantize_i32", "requantize_core",
    "requantize_rows", "calibration_inputs", "calibrate",
]

Q_MAX = 127          # symmetric int8 range ±127 (avoids the -128 asymmetry)
_EXP_CLAMP = 21      # |exp| bound: keeps every requantize shift int32-safe
_MAX_RSHIFT = 24     # beyond this a right shift of any int32 acc is ~0 anyway

PRECISION_BITS = {"int8": 8, "int16": 16}


def q_max(bits: int = 8) -> int:
    """Symmetric saturation bound at ``bits``: ±(2^(bits-1) − 1)."""
    return (1 << (bits - 1)) - 1


def align_cap(bits: int = 8) -> int:
    """Max left-shift when aligning two addends to a common scale (the
    shifted value must stay inside the int32 carrier)."""
    return min(20, 30 - bits)


def int_dtype(bits: int = 8) -> str:
    if bits not in (8, 16):
        raise ValueError(f"unsupported activation width {bits}")
    return f"int{bits}"


def torch_int_dtype(bits: int = 8) -> torch.dtype:
    return getattr(torch, int_dtype(bits))


# ------------------------------------------------------------------ helpers
def pow2_exp(max_abs: float, bits: int = 8) -> int:
    """Largest exponent ``e`` with ``max_abs · 2^e ≤ q_max(bits)`` (clamped)."""
    if not math.isfinite(max_abs) or max_abs <= 0.0:
        return 0
    e = int(math.floor(math.log2(q_max(bits) / max_abs)))
    return max(-_EXP_CLAMP, min(_EXP_CLAMP, e))


def quantize_np(x: np.ndarray, exp: int | np.ndarray, bits: int = 8) -> np.ndarray:
    """Host-side quantization of static parameters at ``2^-exp``.  ``exp`` may
    be a per-output-row array (per-channel scales)."""
    e = np.asarray(exp, np.float64)
    scale = 2.0 ** (e[:, None] if e.ndim == 1 else e)
    q = np.round(np.asarray(x, np.float64) * scale)
    qm = q_max(bits)
    return np.clip(q, -qm, qm).astype(int_dtype(bits))


def quantize_core(x: torch.Tensor, exp: int, bits: int = 8) -> torch.Tensor:
    """float → fixed point on the int32 carrier (round half to even)."""
    q = torch.round(x.to(torch.float32) * (2.0 ** exp))
    qm = q_max(bits)
    return torch.clamp(q, -qm, qm).to(torch.int32)


def quantize_t(x: torch.Tensor, exp: int, bits: int = 8) -> torch.Tensor:
    """float → narrow-int quantization (graph inputs, requant-on-write)."""
    return quantize_core(x, exp, bits).to(torch_int_dtype(bits))


def dequantize(q: torch.Tensor, exp: int) -> torch.Tensor:
    return q.to(torch.float32) * (2.0 ** (-exp))


def requantize_core(acc: torch.Tensor, shift: int, bits: int = 8) -> torch.Tensor:
    """int32 accumulator → saturated value at the output scale, kept int32:
    rounding arithmetic shift + clamp to ±q_max."""
    acc = acc.to(torch.int32)
    if shift > 0:
        s = min(shift, _MAX_RSHIFT)
        acc = (acc + (1 << (s - 1))) >> s
    elif shift < 0:
        lsh = min(-shift, bits)
        acc = torch.clamp(acc, -(1 << (30 - lsh)), 1 << (30 - lsh)) << lsh
    qm = q_max(bits)
    return torch.clamp(acc, -qm, qm)


def requantize_i32(acc: torch.Tensor, shift: int, bits: int = 8) -> torch.Tensor:
    """:func:`requantize_core` narrowed to the activation dtype."""
    return requantize_core(acc, shift, bits).to(torch_int_dtype(bits))


def requantize_rows(acc: torch.Tensor, shifts: Any, bits: int = 8) -> torch.Tensor:
    """Vectorized :func:`requantize_i32` with one static shift per output row
    (per-channel matvec scales); same semantics as the scalar path."""
    acc = acc.to(torch.int32)
    s = torch.as_tensor(np.asarray(shifts) if not torch.is_tensor(shifts)
                        else shifts, device=acc.device).to(torch.int32)
    rs = torch.clamp(s, 0, _MAX_RSHIFT)
    one = torch.ones_like(rs)
    round_add = torch.where(rs > 0, one << torch.clamp(rs - 1, min=0),
                            torch.zeros_like(rs))
    pos = (acc + round_add) >> rs
    lsh = torch.clamp(-s, 0, bits)
    bound = one << (30 - lsh)
    neg = torch.maximum(torch.minimum(acc, bound), -bound) << lsh
    qm = q_max(bits)
    out = torch.clamp(torch.where(s >= 0, pos, neg), -qm, qm)
    return out.to(torch_int_dtype(bits))


# --------------------------------------------------------------------- plan
@dataclasses.dataclass(frozen=True)
class NodeQuant:
    """Per-node fixed-point formats: one exponent per input (None = integer
    value), the output exponent (None = integer output, e.g. argmax), the
    quantized static parameters with their exponents, and the width."""

    in_exps: tuple[int | None, ...]
    out_exp: int | None
    params_q: dict[str, Any]
    param_exps: dict[str, Any]     # int, or per-output-row int array (matvec)
    bits: int = 8


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """Everything the lowering pipeline needs to run a DFG in fixed point."""

    input_exps: dict[str, int]
    nodes: dict[str, NodeQuant]
    bits: int = 8


def calibration_inputs(dfg: DFG, n: int = 64, seed: int = 0) -> dict[str, np.ndarray]:
    """Synthetic standard-normal calibration batch per graph input."""
    rng = np.random.default_rng(seed)
    return {
        name: rng.normal(size=(n,) + gi.shape).astype(np.float32)
        for name, gi in dfg.graph_inputs.items()
    }


def _acc_rowmax(node, spec, env, pname: str, arr: np.ndarray) -> np.ndarray:
    """Per-output-row bound on the int32 MAC accumulator observed on the
    calibration batch: ``Σ_j |W_ij · x_j|`` plus the folded ``|bias|``."""
    xb = np.abs(np.asarray(env[node.inputs[0]], np.float64))
    a = np.abs(arr)
    if pname == "matrix":
        xb = xb.reshape(xb.shape[0], -1)
        b1 = (xb @ a.T).max(axis=0) if xb.size and a.size else np.zeros(a.shape[0])
    else:                                  # conv2d kernel
        p = dict(node.params, kernel=a.astype(np.float32))
        p.pop("bias", None)
        xt = torch.from_numpy(xb.astype(np.float32))
        out = torch.func.vmap(lambda x: spec.fn([x], p, node.dims))(xt)
        b1 = out.numpy().astype(np.float64).max(axis=(0, 2, 3))
    if "bias" in node.params:
        b1 = b1 + np.abs(np.asarray(node.params["bias"], np.float64))
    return b1


def calibrate(
    dfg: DFG,
    calib: Mapping[str, Any] | np.ndarray | None = None,
    *,
    n_samples: int = 64,
    seed: int = 0,
    bits: int = 8,
    per_channel: bool = False,
) -> QuantPlan:
    """Walk the DFG over a calibration batch and infer per-tensor scales.

    ``calib`` is a dict of graph-input name → ``(N, *shape)`` batch, a bare
    batch array for a single-input DFG, or None for
    :func:`calibration_inputs`.  The walk runs the port's *float* templates
    on the CPU.  ``per_channel=True`` gives each gemv/spmv/conv weight one
    exponent per output row.
    """
    int_dtype(bits)  # validates the width
    if calib is None:
        calib = calibration_inputs(dfg, n=n_samples, seed=seed)
    if not isinstance(calib, Mapping):
        if len(dfg.graph_inputs) != 1:
            raise ValueError(
                f"bare calibration array needs a single-input DFG; "
                f"{dfg.name!r} has inputs {sorted(dfg.graph_inputs)}")
        (name,) = dfg.graph_inputs
        calib = {name: calib}
    missing = set(dfg.graph_inputs) - set(calib)
    if missing:
        raise ValueError(f"calibration missing graph inputs: {sorted(missing)}")

    env: dict[str, Any] = {}
    for name, gi in dfg.graph_inputs.items():
        arr = torch.from_numpy(np.array(calib[name], np.float32))
        if tuple(arr.shape[1:]) != tuple(gi.shape):
            raise ValueError(
                f"calibration batch for {name!r} has shape {tuple(arr.shape)}, "
                f"expected (N,) + {gi.shape}")
        env[name] = arr
    maxabs: dict[str, float] = {
        name: float(torch.max(torch.abs(v))) for name, v in env.items()
    }
    n_batch = next((int(v.shape[0]) for v in env.values()), 1)
    for nid in dfg.topo_order():
        node = dfg.nodes[nid]
        spec = node_types.get(node.op)
        fn = lambda *a, spec=spec, node=node: spec.fn(list(a), node.params,
                                                      node.dims)
        if node.inputs:
            out = torch.func.vmap(fn)(*[env[s] for s in node.inputs])
        else:   # zero-input node (const): one value, broadcast over the batch
            val = fn()
            out = val.expand((n_batch,) + tuple(val.shape))
        env[nid] = out
        if out.is_floating_point():
            maxabs[nid] = float(torch.max(torch.abs(out)))
    env = {k: v.numpy() for k, v in env.items()}

    exps = {name: pow2_exp(v, bits) for name, v in maxabs.items()}
    # overflow guard for dynamic-operand reductions (matmul): lower the
    # operand exponents until the observed |a|@|b| bound fits in 2^29.
    for node in dfg.nodes.values():
        if node.op != "matmul":
            continue
        a_ref, b_ref = node.inputs
        e_a, e_b = exps.get(a_ref), exps.get(b_ref)
        if e_a is None or e_b is None:
            continue
        av = np.abs(np.asarray(env[a_ref], np.float64))
        bv = np.abs(np.asarray(env[b_ref], np.float64))
        b1 = float((av @ bv).max())
        if b1 <= 0.0:
            continue
        excess = (e_a + e_b) - (29 - math.ceil(math.log2(b1)))
        while excess > 0 and (e_a > -_EXP_CLAMP or e_b > -_EXP_CLAMP):
            if e_a >= e_b and e_a > -_EXP_CLAMP:
                e_a -= 1
            else:
                e_b -= 1
            excess -= 1
        exps[a_ref], exps[b_ref] = e_a, e_b
    qm = q_max(bits)
    nodes: dict[str, NodeQuant] = {}
    for nid, node in dfg.nodes.items():
        spec = node_types.get(node.op)
        params_q: dict[str, Any] = {}
        param_exps: dict[str, int] = {}
        if spec.fn_q is not None:
            if "scalar" in node.params:
                s = float(node.params["scalar"])
                e = pow2_exp(abs(s), bits)
                params_q["scalar"] = int(np.clip(round(s * 2.0**e), -qm, qm))
                param_exps["scalar"] = e
            for pname in ("matrix", "kernel", "vec", "value"):
                if pname not in node.params:
                    continue
                arr = np.asarray(node.params[pname])
                if pname == "value" and not np.issubdtype(arr.dtype, np.floating):
                    continue            # integer constants pass through
                is_weight = pname in ("matrix", "kernel")
                if (is_weight and per_channel
                        and node.op in ("gemv", "spmv", "conv2d")):
                    a2 = arr.reshape(arr.shape[0], -1) if arr.size else arr
                    row_max = np.max(np.abs(a2), axis=1) if arr.size else np.zeros(arr.shape[0])
                    e_rows = np.array([pow2_exp(float(m), bits) for m in row_max],
                                      np.int64)
                    e_in = exps.get(node.inputs[0]) if node.inputs else None
                    if e_in is not None:
                        b1 = _acc_rowmax(node, spec, env, pname, arr)
                        cap_rows = b1 > 0.0
                        caps = np.full_like(e_rows, _EXP_CLAMP)
                        caps[cap_rows] = (29 - e_in - np.ceil(
                            np.log2(b1[cap_rows])).astype(np.int64))
                        e_rows = np.maximum(np.minimum(e_rows, caps), -_EXP_CLAMP)
                    params_q[pname] = quantize_np(
                        arr.reshape(arr.shape[0], -1), e_rows, bits
                    ).reshape(arr.shape)
                    param_exps[pname] = e_rows
                    continue
                e = pow2_exp(float(np.max(np.abs(arr))) if arr.size else 0.0,
                             bits)
                if is_weight and node.inputs:
                    # overflow-aware scale capping (SeeDot's static
                    # accumulator analysis): keep Σ_j |W_ij·x_j| (+|bias|)
                    # ≤ 2^29 at the quantized scales.
                    e_in = exps.get(node.inputs[0])
                    if e_in is not None:
                        b1v = _acc_rowmax(node, spec, env, pname, arr)
                        b1 = float(b1v.max()) if b1v.size else 0.0
                        if b1 > 0.0:
                            e = min(e, 29 - e_in - math.ceil(math.log2(b1)))
                            e = max(e, -_EXP_CLAMP)
                params_q[pname] = quantize_np(arr, e, bits)
                param_exps[pname] = e
            w_name = next((p for p in ("matrix", "kernel") if p in param_exps),
                          None)
            if "bias" in node.params and w_name is not None and node.inputs:
                # folded add-of-const: quantized at the accumulator scale
                # 2^-(e_w+e_in), added to the int32 carrier before the shift.
                e_in = exps.get(node.inputs[0])
                if e_in is not None:
                    bvec = np.asarray(node.params["bias"], np.float64)
                    e_acc = np.asarray(param_exps[w_name], np.int64) + int(e_in)
                    q = np.round(bvec * np.power(2.0, e_acc.astype(np.float64)))
                    params_q["bias"] = np.clip(
                        q, -(2**31 - 1), 2**31 - 1).astype(np.int32)
                    param_exps["bias"] = (
                        e_acc if np.ndim(e_acc) else int(e_acc))
        nodes[nid] = NodeQuant(
            in_exps=tuple(exps.get(s) for s in node.inputs),
            out_exp=exps.get(nid),
            params_q=params_q,
            param_exps=param_exps,
            bits=bits,
        )
    return QuantPlan(
        input_exps={name: exps[name] for name in dfg.graph_inputs},
        nodes=nodes,
        bits=bits,
    )
