"""Operation registry — MAFIA's Parameterized Matrix Template Library (paper §IV-A).

One :class:`OpSpec` per matrix-operation type.  Each spec bundles everything
every compiler stage needs to know about the op:

  * semantics        — a torch implementation (``fn``) used by the
                       executor, the calibrator and the constant folder,
                       plus an optional int8 variant (``fn_q``) taking
                       int8 inputs and a :class:`repro_torch.core.quantize.NodeQuant`
                       — int32 accumulation, requantize-on-write (the SeeDot
                       fixed-point arithmetic the paper's programs run in;
                       ops without one fall back to dequant→float→requant),
  * shape rules      — ``infer_dims`` / ``out_shape`` / ``validate``,
  * taxonomy         — ``linear_time`` (paper §IV-A: linear-time nodes must keep
                       input PF == execution PF == output PF; non-linear-time
                       nodes get data-shuffle logic around the execution unit),
  * FPGA templates   — ``cycles(dims, pf)`` / ``lut(dims, pf)`` / ``dsp(pf)``:
                       the ground-truth cost of the hand-written Verilog
                       template at parallelism factor ``pf`` (these play the
                       role of synthesize+simulate in the paper's PF-1
                       profiler and model-training flow),
  * TPU roofline     — ``flops(dims)`` / ``mem_bytes(dims)`` feeding the
                       TPU cost model in :mod:`repro_torch.core.tpu_model`,
  * ``max_pf(dims)`` — beyond which the template cannot be parallelized,
  * rewrite legality — metadata the front-end algebraic pass
    (:mod:`repro_torch.core.lowering`) consults: ``scale_param`` names a static
    param the op's output is homogeneous-linear in (scaling that param by a
    power of two scales the output bitwise-exactly, so an adjacent
    ``scalar_mul`` can fold into it); ``bias_foldable`` marks ops whose
    requantize-on-write can absorb an additive constant (``params["bias"]``
    is added to the int32 accumulator before the requantizing shift —
    MAFIA's write-back stage gains one adder per PE).

The FPGA cycle/LUT models are deliberately *not* of the exact functional form
the paper's regression models assume (they contain ``log2`` reduction-tree and
crossbar terms the regression cannot express) — so fitting the paper's models
against them produces realistic, imperfect-but-rank-correct estimators, just
as the paper reports in §VI-B.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import shapes as shp

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.dfg import DFG, Node

__all__ = ["OpSpec", "get", "all_ops", "register", "LINEAR_TIME_OPS", "NONLINEAR_TIME_OPS"]

# Fixed-point width assumed by the templates (SeeDot-style 16-bit quantization).
_BITS = 16
_BYTES = _BITS // 8

# Template micro-costs (LUTs), calibrated to small Artix-7 primitives.
_LUT_MAC = 48        # one 16-bit multiply-accumulate PE mapped to fabric+DSP
_LUT_ADD = 22        # one 16-bit adder PE
_LUT_CMP = 18        # one 16-bit comparator PE
_LUT_NONLIN = 210    # one table-based exp/sigmoid/tanh PE
_LUT_ROUTE = 6       # crossbar routing cost multiplier (× pf·log2(pf))
_FILL = 6            # pipeline fill cycles of every execution unit
_ARB = 0.30          # per-PE arbitration overhead cycles multiplier (the βL·PF truth term)


def _log2c(x: float) -> int:
    return max(0, math.ceil(math.log2(max(1.0, x))))


@dataclasses.dataclass(frozen=True)
class OpSpec:
    name: str
    linear_time: bool
    dsp_per_pe: int
    infer_dims: Callable[["DFG", "Node"], dict[str, int]] | None
    out_shape: Callable[["DFG", "Node"], tuple[int, ...]]
    fn: Callable[[list[Any], dict[str, Any], dict[str, int]], Any]
    flops: Callable[[dict[str, int]], float]
    mem_bytes: Callable[[dict[str, int]], float]
    cycles: Callable[[dict[str, int], int], float]
    lut: Callable[[dict[str, int], int], float]
    max_pf: Callable[[dict[str, int]], int]
    has_reduction: bool = False  # parallel exec followed by partial-sum reduction
    # int8 fixed-point variant: (int8 inputs, float params, dims, NodeQuant)
    # -> int8 output at NodeQuant.out_exp.  None = no integer template; the
    # executor runs dequantize -> fn -> requantize instead (lowering and
    # calibration pick the q/dq mode by ``is not None``).
    fn_q: Callable[[list[Any], dict[str, Any], dict[str, int], Any], Any] | None = None
    # Algebraic-rewrite legality (front-end `algebraic` pass): a static param
    # slot the output is homogeneous-linear in (None = scalar_mul cannot
    # fold into this op), and whether an adjacent add/sub-of-const folds
    # into the write-back as an accumulator bias (``params["bias"]``).
    scale_param: str | None = None
    bias_foldable: bool = False

    def dsp(self, pf: int) -> float:
        """DSP[PF] = alpha_DSP * PF (paper §IV-B) — exact by construction."""
        return float(self.dsp_per_pe * pf)

    def validate(self, dfg: "DFG", node: "Node") -> None:
        self.out_shape(dfg, node)  # raises on inconsistency


_REGISTRY: dict[str, OpSpec] = {}


def register(spec: OpSpec) -> OpSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate op {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> OpSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown op {name!r}; known: {sorted(_REGISTRY)}") from None


def all_ops() -> dict[str, OpSpec]:
    return dict(_REGISTRY)


# --------------------------------------------------------------------------- helpers
def _numel(shape: tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# Static params arrive as host numpy arrays.  Each is converted once per
# device and kept, with JAX's canonical dtypes (64-bit → 32-bit), so the
# templates compute in the same types as the reference's.
_PARAM_CACHE: dict[tuple[int, str], tuple[Any, torch.Tensor]] = {}
_CANON = {torch.float64: torch.float32, torch.int64: torch.int32}


def _t(value: Any, like: torch.Tensor | None = None, dtype=None) -> torch.Tensor:
    """A static param (or any array-like) as a tensor on ``like``'s device."""
    device = like.device if like is not None else torch.device("cpu")
    if torch.is_tensor(value):
        t = value.to(device)
    elif isinstance(value, np.ndarray):
        key = (id(value), str(device))
        hit = _PARAM_CACHE.get(key)
        if hit is not None and hit[0] is value:
            t = hit[1]
        else:
            t = torch.as_tensor(value)
            t = t.to(_CANON.get(t.dtype, t.dtype)).to(device)
            _PARAM_CACHE[key] = (value, t)
    else:
        t = torch.as_tensor(np.asarray(value))
        t = t.to(_CANON.get(t.dtype, t.dtype)).to(device)
    return t if dtype is None else t.to(dtype)


def _i32(x: Any, like: torch.Tensor | None = None) -> torch.Tensor:
    return _t(x, like, torch.int32)


def _i32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on int32 operands (1-D or 2-D, as ``jnp.matmul`` takes
    them), wrapping like the reference's int32 product.  There is no int32
    matmul on CUDA: broadcast-multiply and sum in int32 (an int32 sum
    promotes to int64 unless ``dtype`` is given — the carrier must wrap)."""
    a2 = a if a.dim() == 2 else a[None, :]
    b2 = b if b.dim() == 2 else b[:, None]
    acc = (a2[:, :, None] * b2[None, :, :]).sum(1, dtype=torch.int32)
    if b.dim() == 1:
        acc = acc[:, 0]
    return acc if a.dim() == 2 else acc[0]


# Per-row requantizing shifts (per-channel scales), one int32 tensor per
# (node, device), made on the first call: a call on the card copies nothing.
_SHIFT_CACHE: dict[tuple[int, str], tuple[Any, torch.Tensor]] = {}


def _row_shifts(nq: Any, param: str, like: torch.Tensor) -> torch.Tensor:
    """``param``'s per-row exponents plus the node's input exponent minus
    its output exponent, as int32 on ``like``'s device."""
    key = (id(nq), str(like.device))
    hit = _SHIFT_CACHE.get(key)           # holds nq: its id stays unique
    if hit is None:
        shifts = (np.asarray(nq.param_exps[param], np.int64)
                  + nq.in_exps[0] - nq.out_exp)
        hit = (nq, torch.as_tensor(shifts.astype(np.int32)).to(like.device))
        _SHIFT_CACHE[key] = hit
    return hit[1]


# -------------------------------------------------- integer template variants
def _requantize(acc, shift: int, bits: int = 8):
    from repro_torch.core.quantize import requantize_i32

    return requantize_i32(acc, shift, bits)


def _q_align(x, e: int, e_c: int):
    """Bring an int32 value from exponent ``e`` to common exponent ``e_c``."""
    return x << (e_c - e) if e_c >= e else x >> (e - e_c)


def _q_elementwise(kind: str) -> Callable:
    """int8 add/sub/hadamard: int32 combine at an aligned scale, then one
    requantizing shift to the output format."""

    def fn_q(inputs, params, dims, nq):
        a = inputs[0].to(torch.int32)
        e_a = nq.in_exps[0]
        if "vec" in nq.params_q:
            b = _i32(nq.params_q["vec"], a)
            e_b = nq.param_exps["vec"]
        else:
            b = inputs[1].to(torch.int32)
            e_b = nq.in_exps[1]
        if kind == "hadamard":
            return _requantize(a * b, e_a + e_b - nq.out_exp, nq.bits)
        # align addends to the finer scale before combining; cap the shift —
        # past it the finer operand is below the coarser one's resolution
        # (and the shifted coarser value would leave the int32 carrier).
        from repro_torch.core.quantize import align_cap

        e_c = min(max(e_a, e_b), min(e_a, e_b) + align_cap(nq.bits))
        acc = _q_align(a, e_a, e_c) + (1 if kind == "add" else -1) * _q_align(b, e_b, e_c)
        return _requantize(acc, e_c - nq.out_exp, nq.bits)

    return fn_q


def _q_scalar_mul(inputs, params, dims, nq):
    acc = inputs[0].to(torch.int32) * int(nq.params_q["scalar"])
    return _requantize(acc, nq.in_exps[0] + nq.param_exps["scalar"] - nq.out_exp,
                       nq.bits)


def _q_matvec(inputs, params, dims, nq):
    """Integer gemv/spmv: narrow×narrow MACs accumulated in int32 (the widened
    accumulator of the fixed-point MAC PE), one requantize per output row.

    With per-channel scales (``calibrate(per_channel=True)``) the matrix
    exponent is an array of one exponent per output row; each row's
    accumulator then takes its own static requantizing shift — still plain
    arithmetic shifts, just one constant per row instead of one per tensor."""
    x = inputs[0].to(torch.int32).reshape(-1)
    acc = _i32_matmul(_i32(nq.params_q["matrix"], x), x)
    if "bias" in nq.params_q:
        # folded add-of-const (algebraic rewrite): the bias rides the int32
        # carrier at the accumulator scale, added before the requantizing
        # shift — the write-back adder of the biased matvec template.
        acc = acc + _i32(nq.params_q["bias"], x)
    e_w = nq.param_exps["matrix"]
    if np.ndim(e_w):                       # per-channel (per-output-row)
        from repro_torch.core.quantize import requantize_rows

        return requantize_rows(acc, _row_shifts(nq, "matrix", acc), nq.bits)
    return _requantize(acc, e_w + nq.in_exps[0] - nq.out_exp, nq.bits)


def _q_matmul(inputs, params, dims, nq):
    acc = _i32_matmul(inputs[0].to(torch.int32), inputs[1].to(torch.int32))
    return _requantize(acc, nq.in_exps[0] + nq.in_exps[1] - nq.out_exp, nq.bits)


def _q_const(inputs, params, dims, nq):
    """Fixed-point constant: the pre-quantized value, aligned to the node's
    calibrated output format (the two exponents coincide in practice — both
    derive from the same max-abs — so this is usually a zero shift).  When
    the quant plan predates constant-folding (it was calibrated against the
    node's original op), quantize the folded value at the node's calibrated
    output scale instead."""
    if nq.out_exp is None:                 # integer constant passes through
        return _t(params["value"])
    if "value" in nq.params_q:
        q = _i32(nq.params_q["value"])
        return _requantize(q, nq.param_exps["value"] - nq.out_exp, nq.bits)
    from repro_torch.core.quantize import quantize_t

    return quantize_t(_t(params["value"]), nq.out_exp, nq.bits)


# ----------------------------------------------------------------- elementwise family
def _make_elementwise(
    name: str,
    fn_builder: Callable[[], Callable],
    *,
    binary: bool,
    cycles_per_elem: float = 1.0,
    lut_per_pe: int = _LUT_ADD,
    dsp_per_pe: int = 0,
    flops_per_elem: float = 1.0,
    fn_q: Callable | None = None,
    scale_param: str | None = None,
) -> OpSpec:
    def infer_dims(dfg: "DFG", node: "Node") -> dict[str, int]:
        shapes = dfg.in_shapes(node.id)
        if binary and "vec" not in node.params and len(shapes) != 2:
            raise ValueError(f"{name} expects 2 inputs, got {len(shapes)}")
        return {"n": _numel(shapes[0]), **node.dims}

    def out_shape(dfg: "DFG", node: "Node") -> tuple[int, ...]:
        shapes = dfg.in_shapes(node.id)
        if binary:
            other = node.params["vec"].shape if "vec" in node.params else shapes[1]
            return shp.elementwise_out(shapes[0], tuple(other))
        return shapes[0]

    def fn(inputs: list[Any], params: dict[str, Any], dims: dict[str, int]) -> Any:
        fn = fn_builder()
        if binary:
            b = _t(params["vec"], inputs[0]) if "vec" in params else inputs[1]
            return fn(inputs[0], b)
        return fn(inputs[0])

    def cycles(dims: dict[str, int], pf: int) -> float:
        # one element per PE per cycle, perfectly data-parallel (linear-time node)
        return math.ceil(dims["n"] * cycles_per_elem / pf) + _FILL

    def lut(dims: dict[str, int], pf: int) -> float:
        return 90 + lut_per_pe * pf  # control FSM + PEs; no shuffler (linear-time)

    return register(
        OpSpec(
            name=name,
            linear_time=True,
            dsp_per_pe=dsp_per_pe,
            infer_dims=infer_dims,
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: flops_per_elem * d["n"],
            mem_bytes=lambda d: ((3 if binary else 2) * d["n"]) * _BYTES,
            cycles=cycles,
            lut=lut,
            max_pf=lambda d: max(1, d["n"]),
            fn_q=fn_q,
            scale_param=scale_param,
        )
    )


_make_elementwise("add", lambda: torch.add, binary=True,
                  fn_q=_q_elementwise("add"))
_make_elementwise("sub", lambda: torch.sub, binary=True,
                  fn_q=_q_elementwise("sub"))
_make_elementwise(
    "hadamard",
    lambda: torch.mul,
    binary=True,
    lut_per_pe=_LUT_MAC,
    dsp_per_pe=1,
    fn_q=_q_elementwise("hadamard"),
    # x ⊙ v is homogeneous-linear in the static v: a pow2 scalar_mul folds
    # into the vec param (only the vec-param form has a static operand).
    scale_param="vec",
)
_make_elementwise("relu", lambda: (lambda a: torch.clamp_min(a, 0.0)), binary=False, lut_per_pe=_LUT_CMP)
_make_elementwise(
    "exp", lambda: torch.exp, binary=False,
    cycles_per_elem=4.0, lut_per_pe=_LUT_NONLIN, flops_per_elem=8.0,
)
_make_elementwise(
    "sigmoid",
    lambda: (lambda a: 1.0 / (1.0 + torch.exp(-a))),
    binary=False,
    cycles_per_elem=4.0, lut_per_pe=_LUT_NONLIN, flops_per_elem=10.0,
)
_make_elementwise(
    "tanh", lambda: torch.tanh, binary=False,
    cycles_per_elem=4.0, lut_per_pe=_LUT_NONLIN, flops_per_elem=10.0,
)


def _scalar_mul_spec() -> OpSpec:
    def fn(inputs, params, dims):
        return inputs[0] * params["scalar"]

    return register(
        OpSpec(
            name="scalar_mul",
            linear_time=True,
            dsp_per_pe=1,
            infer_dims=lambda dfg, node: {"n": _numel(dfg.in_shapes(node.id)[0])},
            out_shape=lambda dfg, node: dfg.in_shapes(node.id)[0],
            fn=fn,
            flops=lambda d: float(d["n"]),
            mem_bytes=lambda d: 2.0 * d["n"] * _BYTES,
            cycles=lambda d, pf: math.ceil(d["n"] / pf) + _FILL,
            lut=lambda d, pf: 90 + _LUT_MAC * pf,
            max_pf=lambda d: max(1, d["n"]),
            fn_q=_q_scalar_mul,
            scale_param="scalar",    # c·(s·x) composes into one scalar
        )
    )


_scalar_mul_spec()


def _const_spec() -> OpSpec:
    """Compile-time constant (``params['value']``): a ROM the controller
    streams out at PF elements per cycle.  Emitted by the constant-fold pass
    when a whole static-param subgraph evaluates at compile time; has no
    inputs, so it fires immediately in data-flow order."""

    def fn(inputs, params, dims):
        return _t(params["value"])

    return register(
        OpSpec(
            name="const",
            linear_time=True,
            dsp_per_pe=0,
            infer_dims=lambda dfg, node: {"n": int(np.asarray(node.params["value"]).size)},
            out_shape=lambda dfg, node: tuple(np.shape(node.params["value"])),
            fn=fn,
            flops=lambda d: 0.0,
            mem_bytes=lambda d: d["n"] * _BYTES,
            cycles=lambda d, pf: math.ceil(d["n"] / pf) + _FILL,
            lut=lambda d, pf: 40 + 2 * pf,    # ROM address FSM + output mux
            max_pf=lambda d: max(1, d["n"]),
            fn_q=_q_const,
        )
    )


_const_spec()


# ----------------------------------------------------------- reduction-flavoured ops
def _dot_spec() -> OpSpec:
    """Vector dot product — linear-time, but parallel execution is followed by a
    reduction of partial sums (the paper's own example motivating the γL/PF
    latency term, §IV-B)."""

    def out_shape(dfg, node):
        a, b = dfg.in_shapes(node.id)
        if a != b:
            raise ValueError(f"dot: {a} vs {b}")
        return (1,)

    def fn(inputs, params, dims):
        return torch.dot(inputs[0].reshape(-1), inputs[1].reshape(-1))[None]

    def cycles(d, pf):
        return math.ceil(d["n"] / pf) + 2 * _log2c(pf) + _FILL

    return register(
        OpSpec(
            name="dot",
            linear_time=True,
            has_reduction=True,
            dsp_per_pe=1,
            infer_dims=lambda dfg, node: {"n": _numel(dfg.in_shapes(node.id)[0])},
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: 2.0 * d["n"],
            mem_bytes=lambda d: 2.0 * d["n"] * _BYTES,
            cycles=cycles,
            lut=lambda d, pf: 100 + (_LUT_MAC + _LUT_ADD) * pf,
            max_pf=lambda d: max(1, d["n"] // 2),
        )
    )


_dot_spec()


def _reduce_sum_spec() -> OpSpec:
    def out_shape(dfg, node):
        s = dfg.in_shapes(node.id)[0]
        return s[:-1] if len(s) > 1 else (1,)

    def fn(inputs, params, dims):
        x = inputs[0]
        r = torch.sum(x, dim=-1)
        return r[None] if r.ndim == 0 else r

    return register(
        OpSpec(
            name="reduce_sum",
            linear_time=True,
            has_reduction=True,
            dsp_per_pe=0,
            infer_dims=lambda dfg, node: {"n": _numel(dfg.in_shapes(node.id)[0])},
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: float(d["n"]),
            mem_bytes=lambda d: d["n"] * _BYTES,
            cycles=lambda d, pf: math.ceil(d["n"] / pf) + 2 * _log2c(pf) + _FILL,
            lut=lambda d, pf: 90 + _LUT_ADD * pf,
            max_pf=lambda d: max(1, d["n"] // 2),
        )
    )


_reduce_sum_spec()


def _reduce_minmax_spec(name: str, fname: str) -> OpSpec:
    """reduce_max / reduce_min — same shape/cost contract as reduce_sum but a
    comparator tree instead of an adder tree (no DSPs, LUT compare lanes)."""

    def out_shape(dfg, node):
        s = dfg.in_shapes(node.id)[0]
        return s[:-1] if len(s) > 1 else (1,)

    def fn(inputs, params, dims):
        x = inputs[0]
        r = getattr(torch, fname)(x, dim=-1)
        return r[None] if r.ndim == 0 else r

    return register(
        OpSpec(
            name=name,
            linear_time=True,
            has_reduction=True,
            dsp_per_pe=0,
            infer_dims=lambda dfg, node: {"n": _numel(dfg.in_shapes(node.id)[0])},
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: float(d["n"]),
            mem_bytes=lambda d: d["n"] * _BYTES,
            cycles=lambda d, pf: math.ceil(d["n"] / pf) + 2 * _log2c(pf) + _FILL,
            lut=lambda d, pf: 90 + _LUT_CMP * pf,
            max_pf=lambda d: max(1, d["n"] // 2),
        )
    )


_reduce_minmax_spec("reduce_max", "amax")
_reduce_minmax_spec("reduce_min", "amin")


def _argmax_spec() -> OpSpec:
    def fn(inputs, params, dims):
        return torch.argmax(inputs[0].reshape(-1))[None].to(torch.int32)

    return register(
        OpSpec(
            name="argmax",
            linear_time=True,
            has_reduction=True,
            dsp_per_pe=0,
            infer_dims=lambda dfg, node: {"n": _numel(dfg.in_shapes(node.id)[0])},
            out_shape=lambda dfg, node: (1,),
            fn=fn,
            flops=lambda d: float(d["n"]),
            mem_bytes=lambda d: d["n"] * _BYTES,
            cycles=lambda d, pf: math.ceil(d["n"] / pf) + 2 * _log2c(pf) + _FILL,
            lut=lambda d, pf: 110 + _LUT_CMP * pf,
            max_pf=lambda d: max(1, d["n"] // 2),
        )
    )


_argmax_spec()


# ------------------------------------------------------------ matmul family (non-linear)
def _shuffle_lut(pf: int) -> float:
    """Data-interface shuffler around a non-linear-time execution unit
    (paper §IV-A / Fig. 2): crossbar grows ~ pf·log2(pf)."""
    return _LUT_ROUTE * pf * _log2c(pf + 1)


def _matvec_bias(dfg: "DFG", node: "Node") -> None:
    """Validate the optional folded-bias param of a matvec template."""
    if "bias" in node.params:
        b = np.asarray(node.params["bias"])
        m = int(np.asarray(node.params["matrix"]).shape[0])
        if b.shape != (m,):
            raise ValueError(
                f"{node.op}: bias {b.shape} vs output ({m},)")


def _gemv_spec() -> OpSpec:
    """Dense matrix(m,n) × vector(n) with the matrix as a static parameter.

    An optional ``bias`` param (placed by the algebraic rewrite pass, which
    folds an adjacent add-of-const into the write-back) adds one vector to
    the output — bitwise identical to the separate ``add`` node it
    replaces, one extra adder per PE in fabric."""

    def infer_dims(dfg, node):
        w = node.params["matrix"]
        d = {"m": int(w.shape[0]), "n": int(w.shape[1])}
        if "bias" in node.params:
            d["bias"] = 1
        return d

    def out_shape(dfg, node):
        (xs,) = dfg.in_shapes(node.id)
        out = shp.matvec_out(tuple(node.params["matrix"].shape), xs, op="gemv")
        _matvec_bias(dfg, node)
        return out

    def fn(inputs, params, dims):
        x = inputs[0].reshape(-1)
        out = _t(params["matrix"], x) @ x
        if "bias" in params:
            out = torch.add(out, _t(params["bias"], x))
        return out

    def cycles(d, pf):
        # element-parallel MAC array over the m·n products, partial sums reduced
        # per output row; arbitration grows with pf (the truth behind βL·PF).
        # The folded bias rides the write-back: zero extra cycles.
        work = d["m"] * d["n"]
        return math.ceil(work / pf) + 2 * _log2c(pf) + _ARB * pf + _FILL

    def lut(d, pf):
        return 140 + _LUT_MAC * pf + _shuffle_lut(pf) + (
            _LUT_ADD * pf if d.get("bias") else 0)

    return register(
        OpSpec(
            name="gemv",
            linear_time=False,
            dsp_per_pe=1,
            infer_dims=infer_dims,
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: 2.0 * d["m"] * d["n"] + (d["m"] if d.get("bias") else 0),
            mem_bytes=lambda d: (d["m"] * d["n"] + d["m"] + d["n"]
                                 + (d["m"] if d.get("bias") else 0)) * _BYTES,
            cycles=cycles,
            lut=lut,
            max_pf=lambda d: max(1, (d["m"] * d["n"]) // 4),
            fn_q=_q_matvec,
            scale_param="matrix",
            bias_foldable=True,
        )
    )


_gemv_spec()


def _spmv_spec() -> OpSpec:
    """Sparse matrix(m,n) × vector(n) — the dominant kernel of the paper's
    benchmarks.  ``params['matrix']`` is dense-with-zeros; nnz is derived."""

    def infer_dims(dfg, node):
        w = np.asarray(node.params["matrix"])
        nnz = int(np.count_nonzero(w))
        d = {"m": int(w.shape[0]), "n": int(w.shape[1]), "nnz": max(1, nnz)}
        if "bias" in node.params:
            d["bias"] = 1
        return d

    def out_shape(dfg, node):
        (xs,) = dfg.in_shapes(node.id)
        out = shp.matvec_out(tuple(np.shape(node.params["matrix"])), xs,
                             op="spmv")
        _matvec_bias(dfg, node)
        return out

    def fn(inputs, params, dims):
        x = inputs[0].reshape(-1)
        out = _t(params["matrix"], x) @ x
        if "bias" in params:
            out = torch.add(out, _t(params["bias"], x))
        return out

    def cycles(d, pf):
        return math.ceil(d["nnz"] / pf) + 2 * _log2c(pf) + _ARB * pf + _FILL + 8

    def lut(d, pf):
        # index-walking logic per PE is pricier than a dense MAC
        return 200 + (_LUT_MAC + 24) * pf + _shuffle_lut(pf) + (
            _LUT_ADD * pf if d.get("bias") else 0)

    return register(
        OpSpec(
            name="spmv",
            linear_time=False,
            dsp_per_pe=1,
            infer_dims=infer_dims,
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: 2.0 * d["nnz"] + (d["m"] if d.get("bias") else 0),
            mem_bytes=lambda d: (2 * d["nnz"] + d["m"] + d["n"]
                                 + (d["m"] if d.get("bias") else 0)) * _BYTES,
            cycles=cycles,
            lut=lut,
            max_pf=lambda d: max(1, d["nnz"] // 4),
            fn_q=_q_matvec,
            scale_param="matrix",
            bias_foldable=True,
        )
    )


_spmv_spec()


def _matmul_spec() -> OpSpec:
    def infer_dims(dfg, node):
        a, b = dfg.in_shapes(node.id)
        return {"m": a[0], "k": a[1], "n": b[1]}

    def out_shape(dfg, node):
        a, b = dfg.in_shapes(node.id)
        return shp.matmul_out(a, b)

    def fn(inputs, params, dims):
        return inputs[0] @ inputs[1]

    def cycles(d, pf):
        work = d["m"] * d["k"] * d["n"]
        return math.ceil(work / pf) + 2 * _log2c(pf) + _ARB * pf + _FILL

    return register(
        OpSpec(
            name="matmul",
            linear_time=False,
            dsp_per_pe=1,
            infer_dims=infer_dims,
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: 2.0 * d["m"] * d["k"] * d["n"],
            mem_bytes=lambda d: (d["m"] * d["k"] + d["k"] * d["n"] + d["m"] * d["n"]) * _BYTES,
            cycles=cycles,
            lut=lambda d, pf: 160 + _LUT_MAC * pf + _shuffle_lut(pf),
            max_pf=lambda d: max(1, (d["m"] * d["n"])),
            fn_q=_q_matmul,
        )
    )


_matmul_spec()


def _outer_spec() -> OpSpec:
    def out_shape(dfg, node):
        a, b = dfg.in_shapes(node.id)
        return (_numel(a), _numel(b))

    def fn(inputs, params, dims):
        return torch.outer(inputs[0].reshape(-1), inputs[1].reshape(-1))

    return register(
        OpSpec(
            name="outer",
            linear_time=False,
            dsp_per_pe=1,
            infer_dims=lambda dfg, node: {
                "m": _numel(dfg.in_shapes(node.id)[0]),
                "n": _numel(dfg.in_shapes(node.id)[1]),
            },
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: float(d["m"] * d["n"]),
            mem_bytes=lambda d: (d["m"] + d["n"] + d["m"] * d["n"]) * _BYTES,
            cycles=lambda d, pf: math.ceil(d["m"] * d["n"] / pf) + _ARB * pf + _FILL,
            lut=lambda d, pf: 120 + _LUT_MAC * pf + _shuffle_lut(pf),
            max_pf=lambda d: max(1, d["m"] * d["n"] // 2),
        )
    )


_outer_spec()


def _sq_l2_spec() -> OpSpec:
    """Squared L2 distance of input vector(d) to each column of params['points']
    (d, m) → (m,).  The distance kernel of ProtoNN's RBF similarity."""

    def infer_dims(dfg, node):
        b = node.params["points"]
        return {"d": int(b.shape[0]), "m": int(b.shape[1])}

    def out_shape(dfg, node):
        (xs,) = dfg.in_shapes(node.id)
        b = node.params["points"]
        if _numel(xs) != b.shape[0]:
            raise ValueError(f"sq_l2: points {b.shape} vs input {xs}")
        return (int(b.shape[1]),)

    def fn(inputs, params, dims):
        x = inputs[0].reshape(-1)
        diff = _t(params["points"], x) - x[:, None]
        return torch.sum(diff * diff, dim=0)

    def cycles(d, pf):
        work = 2 * d["d"] * d["m"]  # sub + mac per element
        return math.ceil(work / pf) + 2 * _log2c(pf) + _ARB * pf + _FILL

    return register(
        OpSpec(
            name="sq_l2",
            linear_time=False,
            dsp_per_pe=1,
            infer_dims=infer_dims,
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: 3.0 * d["d"] * d["m"],
            mem_bytes=lambda d: (d["d"] * d["m"] + d["d"] + d["m"]) * _BYTES,
            cycles=cycles,
            lut=lambda d, pf: 150 + (_LUT_MAC + _LUT_ADD) * pf + _shuffle_lut(pf),
            max_pf=lambda d: max(1, (d["d"] * d["m"]) // 4),
        )
    )


_sq_l2_spec()


# ============================================== rank-polymorphic tensor ops
# The MLPerf-Tiny workload class (KWS MLPs, small image-classification
# CNNs): conv/pool/normalization templates whose ``out_shape`` rules carry
# full tensors through :mod:`repro_torch.core.shapes` — the same helper every
# frontend uses — instead of the paper's implicit ``(1, n)`` vectors.
# Integer variants keep the SeeDot discipline: narrow inputs, int32
# accumulation, one static requantizing shift on write-back (per output
# channel for conv when calibrated ``per_channel`` — the same per-row
# machinery the matvec templates use).


def _conv_attrs(params: dict[str, Any]) -> tuple[tuple[int, int], tuple[int, int]]:
    return (shp.normalize_2d(params.get("stride", (1, 1)), "stride"),
            shp.normalize_2d(params.get("padding", (0, 0)), "padding"))


def _window_slices(x, kh: int, kw: int, sh: int, sw: int,
                   ph: int, pw: int, pad_value):
    """(C, H, W) -> (Kh*Kw, C, Hout, Wout) stack of strided window slices.
    Static Python loop over the (small) window — each slice is one strided
    view, so this jits to pure data movement (the FPGA template's line
    buffers)."""
    c, h, w = x.shape
    hout = shp.window_out(h, kh, sh, ph)
    wout = shp.window_out(w, kw, sw, pw)
    if ph or pw:
        x = torch.nn.functional.pad(x, (pw, pw, ph, ph), value=pad_value)
    cols = [
        x[:, i:i + (hout - 1) * sh + 1:sh, j:j + (wout - 1) * sw + 1:sw]
        for i in range(kh) for j in range(kw)
    ]
    return torch.stack(cols)


def _im2col(x, kh: int, kw: int, sh: int, sw: int, ph: int, pw: int,
            pad_value=0):
    """(Cin, H, W) -> (Cin*Kh*Kw, Hout*Wout) patch matrix whose row order
    matches ``kernel.reshape(Cout, -1)``'s (Cin, Kh, Kw) layout, so conv is
    one matmul over patches — the same MAC array dataflow as the matvec
    templates, which is what lets the integer variant reuse their
    requantize-on-write machinery."""
    pat = _window_slices(x, kh, kw, sh, sw, ph, pw, pad_value)
    cin = pat.shape[1]
    # (Kh*Kw, Cin, Hout, Wout) -> (Cin, Kh*Kw, Hout, Wout) -> flat
    return pat.permute(1, 0, 2, 3).reshape(cin * kh * kw, -1)


def _q_conv2d(inputs, params, dims, nq):
    """Integer conv2d: int8×int8 MACs accumulated in int32 over the im2col
    matmul, optional bias on the accumulator, one requantizing shift per
    output channel (per-channel scales) or per tensor on write-back."""
    kq = _i32(nq.params_q["kernel"], inputs[0])
    cout, cin, kh, kw = kq.shape
    (sh, sw), (ph, pw) = _conv_attrs(params)
    cols = _im2col(inputs[0].to(torch.int32), kh, kw, sh, sw, ph, pw)
    acc = _i32_matmul(kq.reshape(cout, -1), cols)   # (Cout, Hout*Wout) int32
    if "bias" in nq.params_q:
        acc = acc + _i32(nq.params_q["bias"], acc)[:, None]
    hout = shp.window_out(inputs[0].shape[1], kh, sh, ph)
    wout = shp.window_out(inputs[0].shape[2], kw, sw, pw)
    e_k = nq.param_exps["kernel"]
    if np.ndim(e_k):                             # per-channel row scales
        from repro_torch.core.quantize import requantize_rows

        out = requantize_rows(acc, _row_shifts(nq, "kernel", acc)[:, None],
                              nq.bits)
    else:
        out = _requantize(acc, int(e_k) + nq.in_exps[0] - nq.out_exp, nq.bits)
    return out.reshape(cout, hout, wout)


def _conv2d_spec() -> OpSpec:
    """2-D convolution, NCHW per-sample: input (Cin, H, W), static
    ``kernel`` (Cout, Cin, Kh, Kw), optional ``bias`` (Cout,), ``stride``/
    ``padding`` int-or-pair attrs.  Lowered as a MAC array over im2col
    patches — cost-wise a gemv of (Cout, Cin·Kh·Kw) against Hout·Wout
    patch columns."""

    def infer_dims(dfg, node):
        (xs,) = dfg.in_shapes(node.id)
        k = np.shape(node.params["kernel"])
        stride, padding = _conv_attrs(node.params)
        cout, hout, wout = shp.conv2d_out(xs, k, stride, padding)
        d = {"cout": int(k[0]), "cin": int(k[1]), "kh": int(k[2]),
             "kw": int(k[3]), "h": int(xs[1]), "w": int(xs[2]),
             "hout": hout, "wout": wout}
        if "bias" in node.params:
            d["bias"] = 1
        return d

    def out_shape(dfg, node):
        (xs,) = dfg.in_shapes(node.id)
        stride, padding = _conv_attrs(node.params)
        out = shp.conv2d_out(xs, np.shape(node.params["kernel"]),
                             stride, padding)
        if "bias" in node.params:
            b = np.shape(node.params["bias"])
            if b != (out[0],):
                raise ValueError(f"conv2d: bias {b} vs ({out[0]},) channels")
        return out

    def fn(inputs, params, dims):
        k = _t(params["kernel"], inputs[0])
        cout, cin, kh, kw = k.shape
        (sh, sw), (ph, pw) = _conv_attrs(params)
        cols = _im2col(inputs[0], kh, kw, sh, sw, ph, pw, pad_value=0.0)
        out = k.reshape(cout, -1) @ cols
        if "bias" in params:
            out = out + _t(params["bias"], inputs[0])[:, None]
        hout = shp.window_out(inputs[0].shape[1], kh, sh, ph)
        wout = shp.window_out(inputs[0].shape[2], kw, sw, pw)
        return out.reshape(cout, hout, wout)

    def work(d):
        return d["cout"] * d["hout"] * d["wout"] * d["cin"] * d["kh"] * d["kw"]

    def cycles(d, pf):
        return math.ceil(work(d) / pf) + 2 * _log2c(pf) + _ARB * pf + _FILL

    def lut(d, pf):
        return 180 + _LUT_MAC * pf + _shuffle_lut(pf) + (
            _LUT_ADD * pf if d.get("bias") else 0)

    return register(
        OpSpec(
            name="conv2d",
            linear_time=False,
            dsp_per_pe=1,
            infer_dims=infer_dims,
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: 2.0 * work(d) + (
                d["cout"] * d["hout"] * d["wout"] if d.get("bias") else 0),
            mem_bytes=lambda d: (
                d["cout"] * d["cin"] * d["kh"] * d["kw"]
                + d["cin"] * d["h"] * d["w"]
                + d["cout"] * d["hout"] * d["wout"]
                + (d["cout"] if d.get("bias") else 0)) * _BYTES,
            cycles=cycles,
            lut=lut,
            max_pf=lambda d: max(1, work(d) // 4),
            fn_q=_q_conv2d,
            scale_param="kernel",   # pow2·conv(x, K) ≡ conv(x, pow2·K)
        )
    )


_conv2d_spec()


def _pool_attrs(params: dict[str, Any]):
    k = shp.normalize_2d(params["ksize"], "ksize")
    s = shp.normalize_2d(params.get("stride", k), "stride")
    p = shp.normalize_2d(params.get("padding", (0, 0)), "padding")
    return k, s, p


def _q_maxpool2d(inputs, params, dims, nq):
    """Integer maxpool: max over the window directly on the narrow carrier
    (dequantize is a monotone pow2 scale, so the winner matches the float
    window max bitwise), one requantizing shift on write-back.  Strided
    int32 views, not ``F.max_pool2d``, which takes no int32 on CUDA."""
    (kh, kw), (sh, sw), (ph, pw) = _pool_attrs(params)
    pat = _window_slices(inputs[0].to(torch.int32), kh, kw, sh, sw,
                         ph, pw, pad_value=-(2**31 - 1))
    return _requantize(pat.amax(dim=0), nq.in_exps[0] - nq.out_exp, nq.bits)


def _q_avgpool2d(inputs, params, dims, nq):
    """Integer avgpool: int32 window sum, then a fixed-point reciprocal
    multiply (``round(2^s / k)`` — exact for power-of-two windows, the
    common case) folded into the requantizing shift: SeeDot's
    constant-division idiom, no integer divide in the datapath."""
    (kh, kw), (sh, sw), (ph, pw) = _pool_attrs(params)
    pat = _window_slices(inputs[0].to(torch.int32), kh, kw, sh, sw,
                         ph, pw, pad_value=0)
    acc = pat.sum(dim=0, dtype=torch.int32)
    k = kh * kw
    s = 30 - nq.bits                 # keeps |acc·recip| ≤ q_max·2^s < 2^31
    recip = int(round((1 << s) / k))
    return _requantize(acc * recip, nq.in_exps[0] + s - nq.out_exp, nq.bits)


def _make_pool(name: str, q_fn) -> OpSpec:
    is_max = name == "maxpool2d"

    def infer_dims(dfg, node):
        (xs,) = dfg.in_shapes(node.id)
        (kh, kw), stride, padding = _pool_attrs(node.params)
        c, hout, wout = shp.pool2d_out(xs, (kh, kw), stride, padding)
        return {"c": c, "h": int(xs[1]), "w": int(xs[2]),
                "hout": hout, "wout": wout, "kh": kh, "kw": kw}

    def out_shape(dfg, node):
        (xs,) = dfg.in_shapes(node.id)
        (kh, kw), stride, padding = _pool_attrs(node.params)
        return shp.pool2d_out(xs, (kh, kw), stride, padding)

    def fn(inputs, params, dims):
        (kh, kw), (sh, sw), (ph, pw) = _pool_attrs(params)
        pad = -math.inf if is_max else 0.0
        pat = _window_slices(inputs[0], kh, kw, sh, sw, ph, pw, pad_value=pad)
        return pat.amax(dim=0) if is_max else pat.sum(dim=0) / (kh * kw)

    def work(d):
        return d["c"] * d["hout"] * d["wout"] * d["kh"] * d["kw"]

    def cycles(d, pf):
        return math.ceil(work(d) / pf) + 2 * _log2c(pf) + _ARB * pf + _FILL

    return register(
        OpSpec(
            name=name,
            linear_time=False,
            dsp_per_pe=0 if is_max else 1,
            infer_dims=infer_dims,
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: float(work(d)),
            mem_bytes=lambda d: (d["c"] * d["h"] * d["w"]
                                 + d["c"] * d["hout"] * d["wout"]) * _BYTES,
            cycles=cycles,
            lut=lambda d, pf: 120 + (_LUT_CMP if is_max else _LUT_ADD) * pf
            + _shuffle_lut(pf),
            max_pf=lambda d: max(1, work(d) // 2),
            fn_q=q_fn,
        )
    )


_make_pool("maxpool2d", _q_maxpool2d)
_make_pool("avgpool2d", _q_avgpool2d)


def _q_relu6(inputs, params, dims, nq):
    """Integer relu6: clamp the carrier to [0, round(6·2^e_in)] (both bounds
    static), one requantizing shift on write-back."""
    q = inputs[0].to(torch.int32)
    six = int(round(6.0 * 2.0 ** nq.in_exps[0]))
    return _requantize(torch.clamp(q, 0, six), nq.in_exps[0] - nq.out_exp,
                       nq.bits)


_make_elementwise(
    "relu6",
    lambda: (lambda a: torch.clamp(a, 0.0, 6.0)),
    binary=False, lut_per_pe=_LUT_CMP, fn_q=_q_relu6,
)


def _softmax_spec() -> OpSpec:
    """Numerically-stable softmax over the last axis.  A normalizer, not a
    streaming op: two reductions (max, sum) bracket the exp lane, so the
    template is non-linear-time (shufflers around the reduction trees).
    No integer variant — like exp/sigmoid/tanh it runs the dq path
    (fixed-point in, table-based float core, fixed-point out)."""

    def fn(inputs, params, dims):
        x = inputs[0]
        e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
        return e / torch.sum(e, dim=-1, keepdim=True)

    return register(
        OpSpec(
            name="softmax",
            linear_time=False,
            has_reduction=True,
            dsp_per_pe=1,
            infer_dims=lambda dfg, node: {"n": _numel(dfg.in_shapes(node.id)[0])},
            out_shape=lambda dfg, node: dfg.in_shapes(node.id)[0],
            fn=fn,
            flops=lambda d: 12.0 * d["n"],
            mem_bytes=lambda d: 2.0 * d["n"] * _BYTES,
            cycles=lambda d, pf: math.ceil(6 * d["n"] / pf)
            + 4 * _log2c(pf) + _ARB * pf + _FILL,
            lut=lambda d, pf: 160 + _LUT_NONLIN * pf + _shuffle_lut(pf),
            max_pf=lambda d: max(1, d["n"] // 2),
        )
    )


_softmax_spec()


def _layernorm_spec() -> OpSpec:
    """Layer normalization over the last axis with static affine params
    ``gamma``/``beta`` (shape = last axis) and ``eps``.  Like softmax: a
    reduction-bracketed normalizer, dq on the fixed-point lanes."""

    def _affine(dfg, node):
        (xs,) = dfg.in_shapes(node.id)
        for p in ("gamma", "beta"):
            if p in node.params and np.shape(node.params[p]) != (int(xs[-1]),):
                raise ValueError(
                    f"layernorm: {p} {np.shape(node.params[p])} vs "
                    f"({int(xs[-1])},)")
        return xs

    def fn(inputs, params, dims):
        x = inputs[0]
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
        y = (x - mu) / torch.sqrt(var + float(params.get("eps", 1e-5)))
        if "gamma" in params:
            y = y * _t(params["gamma"], x)
        if "beta" in params:
            y = y + _t(params["beta"], x)
        return y

    return register(
        OpSpec(
            name="layernorm",
            linear_time=False,
            has_reduction=True,
            dsp_per_pe=1,
            infer_dims=lambda dfg, node: {"n": _numel(dfg.in_shapes(node.id)[0])},
            out_shape=_affine,
            fn=fn,
            flops=lambda d: 9.0 * d["n"],
            mem_bytes=lambda d: 4.0 * d["n"] * _BYTES,
            cycles=lambda d, pf: math.ceil(5 * d["n"] / pf)
            + 4 * _log2c(pf) + _ARB * pf + _FILL,
            lut=lambda d, pf: 170 + (_LUT_NONLIN + _LUT_MAC) * pf
            + _shuffle_lut(pf),
            max_pf=lambda d: max(1, d["n"] // 2),
        )
    )


_layernorm_spec()


def _q_reshape(inputs, params, dims, nq):
    """Integer flatten/reshape: pure data movement on the carrier plus the
    (normally zero — max-abs is reshape-invariant) requantizing shift."""
    q = inputs[0].to(torch.int32)
    shape = (tuple(int(x) for x in params["shape"]) if "shape" in params
             else (-1,))
    return _requantize(q.reshape(shape), nq.in_exps[0] - nq.out_exp, nq.bits)


def _make_view(name: str) -> OpSpec:
    """flatten / reshape: zero-FLOP layout views.  Costed as a streaming
    copy (the FPGA template re-addresses BRAM; the TPU lane is free), kept
    linear-time — a view never reorders the element stream."""
    is_flatten = name == "flatten"

    def out_shape(dfg, node):
        (xs,) = dfg.in_shapes(node.id)
        if is_flatten:
            return shp.flatten_out(xs)
        return shp.reshape_out(xs, tuple(int(x) for x in node.params["shape"]))

    def fn(inputs, params, dims):
        if is_flatten:
            return inputs[0].reshape(-1)
        return inputs[0].reshape(tuple(int(x) for x in params["shape"]))

    return register(
        OpSpec(
            name=name,
            linear_time=True,
            dsp_per_pe=0,
            infer_dims=lambda dfg, node: {"n": _numel(dfg.in_shapes(node.id)[0])},
            out_shape=out_shape,
            fn=fn,
            flops=lambda d: 0.0,
            mem_bytes=lambda d: 2.0 * d["n"] * _BYTES,
            cycles=lambda d, pf: math.ceil(d["n"] / pf) + _FILL,
            lut=lambda d, pf: 60 + 2 * pf,
            max_pf=lambda d: max(1, d["n"]),
            fn_q=_q_reshape,
        )
    )


_make_view("flatten")
_make_view("reshape")


LINEAR_TIME_OPS = frozenset(n for n, s in _REGISTRY.items() if s.linear_time)
NONLINEAR_TIME_OPS = frozenset(n for n, s in _REGISTRY.items() if not s.linear_time)
