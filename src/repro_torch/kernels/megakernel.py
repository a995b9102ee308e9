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
    ``LOAD_MAT``    start the copy of a matrix into one of two shared-memory
                    buffers (a bulk copy on the card); its MATVEC waits
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
    lib.mk_launch.argtypes = [vp, vp, ci, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                              pvp, pci, pci, ci, pvp, pci, pci, ci,
                              ci, ci, vp]
    lib.mk_launch.restype = ci
    lib.mk_max_io.restype = ci


def _lib() -> ctypes.CDLL:
    return load("megakernel", _declare)


# -------------------------------------------------------------------- pack
_NI, _NF = 16, 4
_OPC = {"LOAD_IN": 0, "LOAD_CONST": 1, "MATVEC": 2, "SPMV": 2, "REQ_T": 3,
        "REQ_ROWS": 4, "ARGMAX": 5, "REDUCE": 6, "SQL2": 7, "DOT": 8,
        "ELEMENTWISE": 9, "STORE": 10, "LOAD_MAT": 11}
_REDUCE = {"sum": 0, "max": 1, "min": 2}
_THREADS = 256
# f[12] flags of csrc/megakernel.cu: a barrier before the instruction; a
# MATVEC/SQL2 that writes its destination directly; a matrix streamed in
# chunks of columns through its buffer's two halves.
MK_SYNC, MK_DIRECT, MK_STREAM = 1, 2, 4
_MAXR = 4                         # rows a thread keeps over a streamed matrix
# the dynamic shared memory a block can have, beside the kernel's 32 bytes
# of mbarriers
SMEM_WORDS = (232448 - 64) // 4


@dataclasses.dataclass
class _Pack:
    """A segment packed for the kernel: tables and pools on one device."""

    instrs: torch.Tensor                 # (n, _NI) int32
    fparams: torch.Tensor                # (n, _NF) float32
    consts: torch.Tensor                 # 32-bit words
    mats: torch.Tensor                   # 32-bit words
    n_instr: int
    scratch_off: int
    buf_off: int
    bufw: int
    table_words: int
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pitch(k: int) -> int:
    """Words of a packed matrix row of k values: k rounded up to 16 bytes,
    and for k >= 64 an odd number of 16-byte words, so that the 16-byte
    loads of 8 consecutive rows at one column fall in distinct banks (a
    short row keeps its size: two-way conflicts cost less than a matrix
    that no longer fits its buffer)."""
    p = _cdiv(k, 4) * 4
    return p + 4 if p >= 64 and (p // 4) % 2 == 0 else p


def _mat_layout(seg: MegakernelSegment) -> dict[int, tuple[int, int, bool]]:
    """Matrix index → (n, k, transposed) as the kernel reads it: one row of
    k values per output; MATVEC/SPMV weights (m, k) as they are, SQL2
    points (d, m) transposed."""
    out: dict[int, tuple[int, int, bool]] = {}
    for ins in seg.instrs:
        if ins.op in ("MATVEC", "SPMV"):
            m, k = np.shape(seg.matrices[ins.operand[0]])
            out.setdefault(ins.operand[0], (m, k, False))
        elif ins.op == "SQL2":
            d, m = np.shape(seg.matrices[ins.operand[0]])
            out.setdefault(ins.operand[0], (m, d, True))
    return out


class _Hazards:
    """Which instructions need a barrier before them.  Every word of the
    register file (and one pseudo-word per matrix buffer) remembers the
    thread that wrote it and the threads that read it since the last
    barrier (-1 none, -2 several); an access by another thread needs one.
    Element i of an aligned access belongs to thread i % threads, of a
    "lane32" one to thread i % 32."""

    def __init__(self, words: int, threads: int) -> None:
        self.writer = np.full(words, -1, np.int64)
        self.readers = np.full(words, -1, np.int64)
        self.nt = threads

    def clear(self) -> None:
        self.writer[:] = -1
        self.readers[:] = -1

    def _threads(self, n: int, mode: str) -> np.ndarray:
        if mode in ("aligned", "lane32"):
            return np.arange(n) % (self.nt if mode == "aligned" else 32)
        return np.full(n, 0 if mode == "single" else -2)

    def conflict(self, reads, writes) -> bool:
        for off, n, mode in reads:
            th, w = self._threads(n, mode), self.writer[off:off + n]
            if ((w != -1) & ~((w == th) & (th >= 0))).any():
                return True
        for off, n, mode in writes:
            th = self._threads(n, mode)
            w, r = self.writer[off:off + n], self.readers[off:off + n]
            if ((w != -1) & ~((w == th) & (th >= 0))).any():
                return True
            if ((r != -1) & ~((r == th) & (th >= 0))).any():
                return True
        return False

    def apply(self, reads, writes) -> None:
        for off, n, mode in reads:
            th, r = self._threads(n, mode), self.readers[off:off + n]
            self.readers[off:off + n] = np.where((r == -1) | (r == th), th, -2)
        for off, n, mode in writes:
            self.writer[off:off + n] = self._threads(n, mode)


def pack_segment(seg: MegakernelSegment) -> dict[str, Any]:
    """Host-side packing of ``seg`` into the kernel's int32 instruction
    table, float side-table and 32-bit const/matrix pools (numpy), with
    the matrix buffers' sizes, each ``LOAD_MAT``'s buffer, each
    instruction's flags and each matrix's placement (``placements``:
    matrix index → ``"whole"``, ``"stream"`` or ``"global"``)."""
    carrier = np.int32 if seg.quantized else np.float32
    # every slot on 16 bytes, so that a row's chain loads 4 of its inputs at once
    padded_widths = [_cdiv(w, 4) * 4 for w in seg.slot_widths]
    slot_off = np.concatenate([[0], np.cumsum(padded_widths, dtype=np.int64)])
    widths = seg.slot_widths
    consts = [np.asarray(c, carrier).reshape(-1) for c in seg.consts]
    cwords, coff = _words(consts)

    # matrices row-major (one row of k values per output, SQL2 points
    # transposed to one row per point), rows padded by _pitch with zeros
    layout = _mat_layout(seg)

    def pitch_of(mi: int) -> int:
        return _pitch(layout[mi][1])

    def words_of(mi: int) -> int:
        return layout[mi][0] * pitch_of(mi)

    total = int(slot_off[-1])
    scratch = max([1] + [layout[ins.operand[0]][0] for ins in seg.instrs
                         if ins.op in ("MATVEC", "SPMV", "SQL2")])
    buf_off = _cdiv(total + scratch, 4) * 4
    loaded = {ins.operand for ins in seg.instrs
              if ins.op == "LOAD_MAT" and ins.operand in layout}
    table_words = _cdiv(len(seg.instrs) * (_NI + _NF), 4) * 4   # at most
    cap = (SMEM_WORDS - table_words - buf_off) // 2 // 8 * 8
    need = max([0] + [words_of(mi) for mi in loaded])
    bufw = max(0, min(cap, _cdiv(need, 8) * 8)) if loaded else 0

    def chunk(mi: int) -> int:
        """Columns of a streamed matrix's chunk: a multiple of 4 whose rows
        fit half a buffer (0: none)."""
        n, k = layout[mi][:2]
        ch = min(_cdiv(k, 4) * 4, (bufw // 2 // max(n, 1)) // 4 * 4)
        while ch > 0 and n * _pitch(ch) > bufw // 2:
            ch -= 4
        return ch

    def placement(mi: int) -> str:
        if words_of(mi) <= bufw:
            return "whole"
        if chunk(mi) > 0 and layout[mi][0] <= _MAXR * _THREADS:
            return "stream"
        return "global"

    # each matrix on 16 bytes; a streamed one as its chunks, one after the
    # other, each laid out as it sits in its half buffer (one copy a chunk)
    mats: list[np.ndarray] = []
    moff: dict[int, int] = {}
    mat_words = 0
    for mi, (n, k, transposed) in sorted(layout.items()):
        a = np.asarray(seg.matrices[mi], np.int32 if seg.quantized and not transposed
                       else np.float32)
        a = a.T if transposed else a
        if mi in loaded and placement(mi) == "stream":
            ch = chunk(mi)
            packed = np.zeros((_cdiv(k, ch), n, _pitch(ch)), a.dtype)
            for c in range(packed.shape[0]):
                cols = a[:, c * ch:(c + 1) * ch]
                packed[c, :, :cols.shape[1]] = cols
        else:
            packed = np.zeros((n, _pitch(k)), a.dtype)
            packed[:, :k] = a
        moff[mi] = mat_words
        mats.append(packed)
        mat_words += packed.size

    rows, frows = [], []
    in_w: dict[int, int] = {}
    phases = {(b, h): 0 for b in (0, 1) for h in (0, 1)}   # copies per mbarrier
    pending: dict[int, tuple[int, int]] = {}   # mi → (buffer, its parity)
    n_loads = 0
    haz = _Hazards(buf_off + 2, _THREADS)
    bufword = lambda b: buf_off + b              # noqa: E731 — pseudo-words
    for ins in seg.instrs:
        f = [0] * _NI
        g = [0.0] * _NF
        op, opd = ins.op, ins.operand
        dst = int(slot_off[ins.dst]) if ins.dst >= 0 else 0
        src = [int(slot_off[s]) for s in ins.src]
        f[1] = dst
        f[2] = src[0] if src else 0
        f[3] = src[1] if len(src) > 1 else 0
        reads, writes, issue = [], [], []
        post: list = []              # accesses after an internal barrier
        if op == "LOAD_MAT":
            mi = opd
            if mi not in layout or placement(mi) == "global":
                continue
            b = n_loads % 2
            if any(pb == b for pb, _ in pending.values()):
                continue                       # its buffer is still awaited
            n_loads += 1
            pending[mi] = (b, phases[b, 0] & 1)
            phases[b, 0] += 1
            f[0], f[6], f[14] = _OPC["LOAD_MAT"], moff[mi], b
            f[4] = (words_of(mi) if placement(mi) == "whole"       # or chunk 0
                    else layout[mi][0] * _pitch(chunk(mi)))
            issue.append((bufword(b), 1, "single"))
        elif op == "LOAD_VEC":
            kind, idx = opd
            f[4] = widths[ins.dst]
            if kind == "in":
                f[0], f[8] = _OPC["LOAD_IN"], idx
                in_w[idx] = widths[ins.dst]
            else:
                f[0], f[7] = _OPC["LOAD_CONST"], coff[idx]
                if consts[idx].size != widths[ins.dst]:
                    raise ValueError("const width does not match its slot")
            writes.append((dst, f[4], "aligned"))
        elif op in ("MATVEC", "SPMV", "SQL2"):
            mi = opd[0]
            n, k, _ = layout[mi]
            f[0], f[4], f[5] = _OPC[op], n, k
            f[6], f[13], f[14] = moff[mi], pitch_of(mi), -1
            if op == "SQL2":
                _, e_in, e_out = opd
                flags = 0
                if e_in is not None:
                    flags |= 1
                    g[1] = 2.0 ** (-e_in)
                if e_out is not None:
                    flags |= 4
                    g[3] = 2.0 ** e_out
                f[9] = flags
            else:
                bias_ci = opd[1]
                f[7] = -1 if bias_ci is None else coff[bias_ci]
            if mi in pending:
                b, par = pending.pop(mi)
                f[14], f[15] = b, par | ((phases[b, 1] & 1) << 1)
                reads.append((bufword(b), 1, "any"))
                if placement(mi) == "stream":
                    f[12] |= MK_STREAM
                    f[10], f[11] = chunk(mi), _pitch(chunk(mi))
                    nch = _cdiv(k, chunk(mi))
                    phases[b, 0] += (nch - 1) // 2
                    phases[b, 1] += nch // 2
            reads.append((src[0], k, "any"))
            if dst + n <= src[0] or src[0] + k <= dst:
                f[12] |= MK_DIRECT
                writes.append((dst, n, "aligned"))
            else:
                post.append((dst, n, "aligned"))
        elif op == "REQUANTIZE":
            kind, sh = opd
            f[4] = widths[ins.dst]
            if kind == "rows":
                f[0], f[7] = _OPC["REQ_ROWS"], coff[sh]
            else:
                f[0], f[9] = _OPC["REQ_T"], int(sh)
            reads.append((src[0], f[4], "aligned"))
            writes.append((dst, f[4], "aligned"))
        elif op == "ARGMAX":
            f[0], f[5] = _OPC["ARGMAX"], widths[ins.src[0]]
            reads.append((src[0], f[5], "lane32"))
            writes.append((dst, 1, "single"))
        elif op in ("REDUCE", "DOT"):
            if op == "REDUCE":
                kind, e_in, e_out = opd
                f[0], f[5], f[8] = _OPC["REDUCE"], widths[ins.src[0]], _REDUCE[kind]
                exps = (e_in, None)
            else:
                e_a, e_b, e_out = opd
                f[0], f[5] = _OPC["DOT"], widths[ins.src[0]]
                exps = (e_a, e_b)
                reads.append((src[1], f[5], "single"))
            flags = 0
            for bit, e, gi in ((1, exps[0], 1), (2, exps[1], 2)):
                if e is not None:
                    flags |= bit
                    g[gi] = 2.0 ** (-e)
            if e_out is not None:
                flags |= 4
                g[3] = 2.0 ** e_out
            f[9] = flags
            reads.append((src[0], f[5], "single"))
            writes.append((dst, 1, "single"))
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
            reads.append((src[0], f[4], "aligned"))
            if name.endswith("_arr"):
                reads.append((f[3], f[5], "aligned" if f[5] != 1 else "any"))
            writes.append((dst, f[4], "aligned"))
        elif op == "STORE":
            f[0], f[4], f[8] = _OPC["STORE"], seg.out_widths[opd], opd
            reads.append((src[0], f[4], "aligned"))
        else:
            raise ValueError(f"unknown megakernel op {op!r}")
        # a LOAD_MAT's copy must not start before its buffer's last reader
        # is done; its reader waits on the copy's mbarrier, not a barrier
        if haz.conflict(reads, writes + issue):
            f[12] |= MK_SYNC
            haz.clear()
        haz.apply(reads, [])
        if f[12] & MK_STREAM:
            haz.clear()                          # its trailing barrier
        haz.apply([], writes)
        if post:                                 # scratch, barrier, copy
            haz.clear()
            haz.apply([], post)
        rows.append(f)
        frows.append(g)
    mwords, _ = _words(mats)
    table_words = _cdiv(len(rows) * (_NI + _NF), 4) * 4
    # where each matrix is read from: whole in a buffer, streamed through one
    # in chunks of columns, or from global memory (too many rows to stream,
    # or no LOAD_MAT)
    placements = {mi: placement(mi) if mi in loaded else "global"
                  for mi in sorted(layout)}
    return dict(
        instrs=np.asarray(rows, np.int32).reshape(-1, _NI),
        fparams=np.asarray(frows, np.float32).reshape(-1, _NF),
        consts=cwords, mats=mwords, n_instr=len(rows), scratch_off=total,
        buf_off=buf_off, bufw=bufw, table_words=table_words,
        smem_words=table_words + buf_off + 2 * bufw,
        in_widths=tuple(in_w[i] for i in range(len(seg.in_refs))),
        placements=placements)


def _packed(seg: MegakernelSegment, device: torch.device) -> _Pack:
    h = pack_segment(seg)
    return _Pack(
        instrs=torch.from_numpy(h["instrs"]).to(device),
        fparams=torch.from_numpy(h["fparams"]).to(device),
        consts=torch.from_numpy(h["consts"]).to(device),
        mats=torch.from_numpy(h["mats"]).to(device),
        n_instr=h["n_instr"], scratch_off=h["scratch_off"],
        buf_off=h["buf_off"], bufw=h["bufw"], table_words=h["table_words"],
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
        int(seg.bits), pk.scratch_off, pk.buf_off, pk.bufw, pk.table_words,
        pk.smem_words,
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
