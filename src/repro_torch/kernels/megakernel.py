"""Whole-program megakernel — one CUDA launch per bucket for a whole plan.

The lowering pipeline's linearize pass compiles the executable portion of an
:class:`~repro_torch.core.lowering.ExecutionPlan` down to a flat,
statically-scheduled instruction stream over a tiny ISA; this module holds
that program's data types and runs a segment in **one** launch of the
hand-written CUDA kernel ``csrc/megakernel.cu`` (a generic interpreter of
the packed stream, built for ``sm_90a`` with ``nvcc`` and bound with
``ctypes``).

ISA (all operands static — shapes, shifts and constants are resolved at
compile time by ``_pass_linearize``):

    ==============  ==========================================================
    ``LOAD_VEC``    ``reg[dst] ← consts[ci]`` or ``reg[dst] ← inputs[ii]``
    ``LOAD_MAT``    no-op on the card: matrices are read from global memory
                    (L2-resident); kept in the stream for its schedule
    ``MATVEC``      ``reg[dst] ← W @ reg[src0]`` (+ static bias)
    ``SPMV``        same compute on a sparse (dense-with-zeros) operand
    ``ELEMENTWISE`` one pipeline stage (float or ``q_*`` vocabulary of
                    :mod:`repro_torch.kernels.ref`)
    ``REQUANTIZE``  int lanes: requantizing shift of the int32 accumulator
                    (per tensor, or per row for per-channel scales)
    ``ARGMAX``      ``reg[dst] ← argmax(reg[src0])`` (first index wins; on
                    the int lanes directly on the carrier)
    ``REDUCE``      ``reg[dst] ← sum/max/min(reg[src0])``
    ``SQL2``        squared-L2 distances of ``reg[src0]`` to each column of a
                    points matrix (ProtoNN's RBF distance kernel)
    ``DOT``         ``reg[dst] ← reg[src0] · reg[src1]``
    ``STORE``       ``outputs[oi] ← reg[src0]`` (cast to that output's dtype)
    ==============  ==========================================================

:func:`run_segment_grid` launches the kernel with the bucket on the grid
(one block per sample); :func:`run_segment` is the same kernel at nb = 1, so
the two lanes are bitwise equal at every precision.  On a CPU tensor both
run the plain version (:func:`repro_torch.kernels.ref.run_segment_grid_ref`);
on a CUDA tensor they launch the kernel or raise — there is no fallback.
``LAUNCHES["megakernel"]`` counts launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.build import DTYPE_CODES as _DTYPE
from repro_torch.kernels.build import STAGE_CODES as _STAGE
from repro_torch.kernels.build import UNARY_CODES as _UNARY
from repro_torch.kernels.build import (LAUNCHES, check_launch, load,
                                       segment_cache)

__all__ = ["Instr", "MegakernelSegment", "MegakernelProgram", "run_segment",
           "run_segment_grid", "LAUNCHES"]

ISA_OPS = ("LOAD_VEC", "LOAD_MAT", "MATVEC", "SPMV", "ELEMENTWISE",
           "REQUANTIZE", "ARGMAX", "REDUCE", "SQL2", "DOT", "STORE")

@dataclasses.dataclass(frozen=True)
class Instr:
    """One megakernel instruction.  ``dst``/``src`` index register slots;
    ``operand`` is the op-specific static payload:

    * ``LOAD_VEC`` — ``("const", ci)`` or ``("in", ii)``
    * ``LOAD_MAT`` — ``mi`` (matrix index)
    * ``MATVEC``/``SPMV`` — ``(mi, bias_ci)`` with ``bias_ci`` a pool index
      or None (int lanes: the int32 bias at the accumulator scale)
    * ``ELEMENTWISE`` — ``(stage, vec_cis)``: a stage tuple in the
      :mod:`repro_torch.kernels.ref` vocabulary (``*_arr`` index remapped to
      0 → ``src[1]``); q-stage ``vi`` operand indices address ``vec_cis``
      positionally, a float ``*_vec`` stage's operand is ``vec_cis[0]``
    * ``REQUANTIZE`` — ``("tensor", shift)`` or ``("rows", shifts_ci)``
    * ``ARGMAX`` — None
    * ``REDUCE`` — ``(kind, e_in, e_out)``, exponents None on the float lane
    * ``SQL2`` — ``(mi, e_in, e_out)``
    * ``DOT`` — ``(e_a, e_b, e_out)``
    * ``STORE`` — ``oi`` (output index)
    """

    op: str
    dst: int = -1
    src: tuple[int, ...] = ()
    operand: Any = None
    nid: str = ""                    # DFG node realized (debug / tracing)


@dataclasses.dataclass(frozen=True)
class MegakernelSegment:
    """A maximal run of ISA-encodable plan steps, compiled to one launch."""

    instrs: tuple[Instr, ...]
    slot_widths: tuple[int, ...]          # exact feature length per register
    consts: tuple[Any, ...]               # array payload pool
    matrices: tuple[Any, ...]             # MATVEC/SPMV/SQL2 matrix operands
    in_refs: tuple[str, ...]              # env refs consumed, LOAD_VEC order
    out_refs: tuple[str, ...]             # env refs produced, STORE order
    out_widths: tuple[int, ...]
    out_shapes: tuple[tuple[int, ...], ...]
    quantized: bool = False
    bits: int = 8
    members: tuple[str, ...] = ()         # DFG nodes realized by this segment
    # per-output dtype names ("float32"/"int8"/.../"int32"); empty = uniform
    out_dtypes: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class MegakernelProgram:
    """The linearized plan: megakernel segments interleaved (plan order) with
    the indices of steps that have no ISA encoding — the interpreted islands
    of the hybrid fallback.  A fully encodable plan has one segment."""

    items: tuple[tuple[str, Any], ...]    # ("seg", segment) | ("step", idx)

    @property
    def segments(self) -> list[MegakernelSegment]:
        return [p for k, p in self.items if k == "seg"]

    @property
    def n_islands(self) -> int:
        return sum(1 for k, _ in self.items if k == "step")

    @property
    def n_instrs(self) -> int:
        return sum(len(s.instrs) for s in self.segments)

    def fingerprint(self) -> str:
        """Content digest of the linearized program: every instruction
        (opcode, slots, static operands) plus the const/matrix pools byte
        for byte.  Two programs with equal fingerprints execute the
        identical single-launch stream — this is what the artifact store
        validates on load: the re-linearized plan must reproduce exactly
        the stream that was serialized, else the artifact was produced by
        a different toolchain and must not silently serve."""
        import hashlib

        h = hashlib.sha256()
        for kind, payload in self.items:
            if kind == "step":
                h.update(repr(("step", payload)).encode())
                continue
            seg = payload
            h.update(repr(("seg", seg.slot_widths, seg.in_refs, seg.out_refs,
                           seg.out_widths, seg.out_shapes, seg.quantized,
                           seg.bits, seg.members, seg.out_dtypes)).encode())
            for ins in seg.instrs:
                h.update(repr((ins.op, ins.dst, ins.src, ins.operand,
                               ins.nid)).encode())
            for pool in (seg.consts, seg.matrices):
                for arr in pool:
                    a = np.asarray(arr)
                    h.update(repr((a.dtype.str, a.shape)).encode())
                    h.update(a.tobytes())
        return h.hexdigest()

    def summary(self) -> str:
        segs = self.segments
        return (f"MegakernelProgram({len(segs)} segments, "
                f"{self.n_instrs} instrs, "
                f"{sum(len(s.slot_widths) for s in segs)} slots, "
                f"{self.n_islands} interpreted islands)")


def _seg_out_dtypes(seg: MegakernelSegment) -> list[torch.dtype]:
    """Effective per-output dtypes: the segment's ``out_dtypes`` when set,
    else the uniform dtype (narrow activation dtype / float32)."""
    if seg.out_dtypes:
        return [getattr(torch, d) for d in seg.out_dtypes]
    if seg.quantized:
        from repro_torch.core.quantize import torch_int_dtype

        return [torch_int_dtype(seg.bits)] * len(seg.out_refs)
    return [torch.float32] * len(seg.out_refs)


# ------------------------------------------------------------------- build
def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pvp, pci = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    lib.mk_launch.argtypes = [vp, vp, ci, vp, vp, ci, ci, ci, ci,
                              pvp, pci, pci, ci, pvp, pci, pci, ci,
                              ci, ci, vp]
    lib.mk_launch.restype = ci
    lib.mk_max_io.restype = ci


def _lib() -> ctypes.CDLL:
    return load("megakernel", _declare)


# -------------------------------------------------------------------- pack
_NI, _NF = 12, 4
_OPC = {"LOAD_IN": 0, "LOAD_CONST": 1, "MATVEC": 2, "SPMV": 2, "REQ_T": 3,
        "REQ_ROWS": 4, "ARGMAX": 5, "REDUCE": 6, "SQL2": 7, "DOT": 8,
        "ELEMENTWISE": 9, "STORE": 10}
_REDUCE = {"sum": 0, "max": 1, "min": 2}
_THREADS = 256


@dataclasses.dataclass
class _Pack:
    """A segment packed for the kernel: tables and pools on one device."""

    instrs: torch.Tensor                 # (n, _NI) int32
    fparams: torch.Tensor                # (n, _NF) float32
    consts: torch.Tensor                 # 32-bit words
    mats: torch.Tensor                   # 32-bit words
    n_instr: int
    scratch_off: int
    smem_words: int
    in_widths: tuple[int, ...]
    out_dtypes: tuple[torch.dtype, ...]


def _words(arrs: list[np.ndarray]) -> tuple[np.ndarray, list[int]]:
    offs, n = [], 0
    for a in arrs:
        offs.append(n)
        n += a.size
    flat = (np.concatenate([a.reshape(-1).view(np.int32) for a in arrs])
            if arrs else np.zeros(0, np.int32))
    return (flat if flat.size else np.zeros(1, np.int32)), offs


def pack_segment(seg: MegakernelSegment) -> dict[str, Any]:
    """Host-side packing of ``seg`` into the kernel's int32 instruction
    table, float side-table and 32-bit const/matrix pools (numpy)."""
    carrier = np.int32 if seg.quantized else np.float32
    slot_off = np.concatenate([[0], np.cumsum(seg.slot_widths, dtype=np.int64)])
    widths = seg.slot_widths
    consts = [np.asarray(c, carrier).reshape(-1) for c in seg.consts]
    cwords, coff = _words(consts)
    mats: list[np.ndarray] = []
    moff: dict[tuple[int, bool], int] = {}
    mat_words = 0

    def mat(mi: int, transposed: bool, dtype) -> int:
        nonlocal mat_words
        key = (mi, transposed)
        if key not in moff:
            a = np.asarray(seg.matrices[mi], dtype)
            a = np.ascontiguousarray(a.T if transposed else a)
            moff[key] = mat_words
            mats.append(a)
            mat_words += a.size
        return moff[key]

    rows, frows = [], []
    scratch = 1
    in_w: dict[int, int] = {}
    for ins in seg.instrs:
        f = [0] * _NI
        g = [0.0] * _NF
        op, opd = ins.op, ins.operand
        dst = int(slot_off[ins.dst]) if ins.dst >= 0 else 0
        src = [int(slot_off[s]) for s in ins.src]
        f[1] = dst
        f[2] = src[0] if src else 0
        f[3] = src[1] if len(src) > 1 else 0
        if op == "LOAD_MAT":
            continue
        if op == "LOAD_VEC":
            kind, idx = opd
            f[4] = widths[ins.dst]
            if kind == "in":
                f[0], f[8] = _OPC["LOAD_IN"], idx
                in_w[idx] = widths[ins.dst]
            else:
                f[0], f[7] = _OPC["LOAD_CONST"], coff[idx]
                if consts[idx].size != widths[ins.dst]:
                    raise ValueError("const width does not match its slot")
        elif op in ("MATVEC", "SPMV"):
            mi, bias_ci = opd
            m, k = np.shape(seg.matrices[mi])
            f[0], f[4], f[5] = _OPC[op], m, k
            f[6] = mat(mi, True, np.int32 if seg.quantized else np.float32)
            f[7] = -1 if bias_ci is None else coff[bias_ci]
            scratch = max(scratch, m)
        elif op == "REQUANTIZE":
            kind, sh = opd
            f[4] = widths[ins.dst]
            if kind == "rows":
                f[0], f[7] = _OPC["REQ_ROWS"], coff[sh]
            else:
                f[0], f[9] = _OPC["REQ_T"], int(sh)
        elif op == "ARGMAX":
            f[0], f[5] = _OPC["ARGMAX"], widths[ins.src[0]]
        elif op in ("REDUCE", "SQL2", "DOT"):
            if op == "REDUCE":
                kind, e_in, e_out = opd
                f[0], f[5], f[8] = _OPC["REDUCE"], widths[ins.src[0]], _REDUCE[kind]
                exps = (e_in, None)
            elif op == "SQL2":
                mi, e_in, e_out = opd
                d, m = np.shape(seg.matrices[mi])
                f[0], f[4], f[5] = _OPC["SQL2"], m, d
                f[6] = mat(mi, False, np.float32)
                scratch = max(scratch, m)
                exps = (e_in, None)
            else:
                e_a, e_b, e_out = opd
                f[0], f[5] = _OPC["DOT"], widths[ins.src[0]]
                exps = (e_a, e_b)
            flags = 0
            for bit, e, gi in ((1, exps[0], 1), (2, exps[1], 2)):
                if e is not None:
                    flags |= bit
                    g[gi] = 2.0 ** (-e)
            if e_out is not None:
                flags |= 4
                g[3] = 2.0 ** e_out
            f[9] = flags
        elif op == "ELEMENTWISE":
            stage, vec_cis = opd
            name, sop = stage
            f[0], f[4], f[8] = _OPC["ELEMENTWISE"], widths[ins.dst], _STAGE[name]
            if name in ("add_vec", "sub_vec", "hadamard_vec"):
                f[7], f[5] = coff[vec_cis[0]], consts[vec_cis[0]].size
            elif name in ("add_arr", "sub_arr", "hadamard_arr"):
                f[3], f[5] = src[1 + sop], widths[ins.src[1 + sop]]
            elif name == "scalar_mul":
                g[0] = float(np.float32(sop))
            elif name == "q_scalar_mul":
                f[9], f[10] = int(sop[0]), int(sop[1])
            elif name in ("q_add_vec", "q_sub_vec", "q_add_arr", "q_sub_arr"):
                i, sa, sb, rq = sop
                f[9], f[10], f[11] = int(sa), int(sb), int(rq)
                if name.endswith("_vec"):
                    f[7], f[5] = coff[vec_cis[i]], consts[vec_cis[i]].size
                else:
                    f[3], f[5] = src[1 + i], widths[ins.src[1 + i]]
            elif name in ("q_hadamard_vec", "q_hadamard_arr"):
                i, rq = sop
                f[11] = int(rq)
                if name.endswith("_vec"):
                    f[7], f[5] = coff[vec_cis[i]], consts[vec_cis[i]].size
                else:
                    f[3], f[5] = src[1 + i], widths[ins.src[1 + i]]
            elif name == "q_unary":
                uname, e_in, e_out = sop
                f[9] = _UNARY[uname]
                g[1], g[3] = 2.0 ** (-e_in), 2.0 ** e_out
        elif op == "STORE":
            f[0], f[4], f[8] = _OPC["STORE"], seg.out_widths[opd], opd
        else:
            raise ValueError(f"unknown megakernel op {op!r}")
        rows.append(f)
        frows.append(g)
    mwords, _ = _words(mats)
    total = int(slot_off[-1])
    return dict(
        instrs=np.asarray(rows, np.int32).reshape(-1, _NI),
        fparams=np.asarray(frows, np.float32).reshape(-1, _NF),
        consts=cwords, mats=mwords, n_instr=len(rows), scratch_off=total,
        smem_words=total + scratch,
        in_widths=tuple(in_w[i] for i in range(len(seg.in_refs))))


def _packed(seg: MegakernelSegment, device: torch.device) -> _Pack:
    h = pack_segment(seg)
    return _Pack(
        instrs=torch.from_numpy(h["instrs"]).to(device),
        fparams=torch.from_numpy(h["fparams"]).to(device),
        consts=torch.from_numpy(h["consts"]).to(device),
        mats=torch.from_numpy(h["mats"]).to(device),
        n_instr=h["n_instr"], scratch_off=h["scratch_off"],
        smem_words=h["smem_words"], in_widths=h["in_widths"],
        out_dtypes=tuple(_seg_out_dtypes(seg)))


def _launch(seg: MegakernelSegment, xs: list[torch.Tensor], nb: int,
            device: torch.device) -> list[torch.Tensor]:
    """Check the inputs, allocate the outputs and launch one bucket."""
    pk = segment_cache("pack", seg, device, lambda: _packed(seg, device))
    if len(xs) != len(pk.in_widths):
        raise ValueError(f"segment takes {len(pk.in_widths)} inputs, got {len(xs)}")
    for x, w in zip(xs, pk.in_widths):
        if x.device != device:
            raise ValueError(f"input on {x.device}, segment on {device}")
        if x.dtype not in _DTYPE:
            raise TypeError(f"megakernel input dtype {x.dtype} not supported")
        if not x.is_contiguous() or tuple(x.shape) != (nb, w):
            raise ValueError(f"megakernel input must be a contiguous ({nb}, {w}) "
                             f"tensor, got {tuple(x.shape)}")
    outs = [torch.empty((nb, w), dtype=dt, device=device)
            for w, dt in zip(seg.out_widths, pk.out_dtypes)]
    lib = _lib()
    n_in, n_out = len(xs), len(outs)
    if max(n_in, n_out) > lib.mk_max_io():
        raise ValueError("segment has more inputs or outputs than the kernel takes")
    arr_p, arr_i = ctypes.c_void_p * max(1, n_in), ctypes.c_int * max(1, n_in)
    out_p, out_i = ctypes.c_void_p * max(1, n_out), ctypes.c_int * max(1, n_out)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.mk_launch(
        pk.instrs.data_ptr(), pk.fparams.data_ptr(), pk.n_instr,
        pk.consts.data_ptr(), pk.mats.data_ptr(), int(seg.quantized),
        int(seg.bits), pk.scratch_off, pk.smem_words,
        arr_p(*[x.data_ptr() for x in xs]), arr_i(*[_DTYPE[x.dtype] for x in xs]),
        arr_i(*[int(x.shape[1]) for x in xs]), n_in,
        out_p(*[o.data_ptr() for o in outs]), out_i(*[_DTYPE[o.dtype] for o in outs]),
        out_i(*[int(o.shape[1]) for o in outs]), n_out,
        nb, _THREADS, stream)
    check_launch("megakernel", err)
    return outs


def run_segment_grid(seg: MegakernelSegment, inputs: Sequence[torch.Tensor],
                     *, device: torch.device | str | None = None
                     ) -> list[torch.Tensor]:
    """Execute one segment for a whole bucket in a single launch.

    ``inputs`` are the batched env values of ``seg.in_refs`` (leading batch
    axis, any trailing shape — flattened to ``(nb, width)`` here).  Returns
    one ``(nb, width)`` value per ``seg.out_refs``.  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise.  ``device``
    places a segment with no inputs (None: the card, which must exist)."""
    if inputs:
        device = inputs[0].device
        nb = int(inputs[0].shape[0])
    else:
        device = resolve_device(device)
        nb = 1
    xs = [x.reshape(nb, -1) for x in inputs]
    if device.type == "cpu":
        from repro_torch.kernels.ref import _segment_rows

        return _segment_rows(seg, xs)
    if device.type != "cuda":
        raise ValueError(f"megakernel runs on cuda or cpu, not {device}")
    return _launch(seg, xs, nb, device)


def run_segment(seg: MegakernelSegment, inputs: Sequence[torch.Tensor],
                *, device: torch.device | str | None = None
                ) -> list[torch.Tensor]:
    """Execute one segment for one sample: the grid kernel at nb = 1.
    ``inputs`` may have any shape; returns one flat value per output."""
    outs = run_segment_grid(seg, [x.reshape(1, -1) for x in inputs],
                            device=device)
    return [o[0] for o in outs]
