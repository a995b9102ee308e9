"""The megakernel's packed instruction table, checked on the CPU.

The CUDA kernel cannot run here, but what it reads can: ``pack_segment``
turns a segment into an int32 instruction table, a float side table and
32-bit const/matrix pools.  ``_emulate`` below walks that table with the
kernel's semantics (``csrc/megakernel.cu``: float sums in index order, one
rounding per multiply and per add; integer products and sums wrapping on
32 bits; rounding half to even) and must give what the plain version gives.
So a packing fault shows here before it reaches the card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.compiler import MafiaCompiler
from repro_torch.core.dfg import DFG
from repro_torch.core.quantize import quantize_t
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.ref import float_pe_outputs, run_segment_grid_ref
from repro_torch.serve.classical_engine import get_program

torch.set_num_threads(1)

_UNARY = [np.tanh, lambda x: np.float32(1) / (np.float32(1) + np.exp(-x)),
          lambda x: np.where(x < 0, np.float32(0), x), np.exp]
_DT = {0: np.float32, 1: np.int32, 2: np.int8, 3: np.int16}


def _requant(acc, shift, bits):
    acc = acc.astype(np.int64)
    shift = np.broadcast_to(np.asarray(shift, np.int64), acc.shape)
    s = np.minimum(shift, 24)
    pos = ((acc + (np.int64(1) << np.maximum(s - 1, 0))).astype(np.int32)
           .astype(np.int64) >> np.maximum(s, 0))
    lsh = np.minimum(-shift, bits)
    b = np.int64(1) << (30 - np.clip(lsh, 0, None))
    neg = (np.clip(acc, -b, b) << np.clip(lsh, 0, None)).astype(np.int32)
    out = np.where(shift > 0, pos, np.where(shift < 0, neg, acc))
    qm = (1 << (bits - 1)) - 1
    return np.clip(out, -qm, qm).astype(np.int32)


def _align(v, s):
    """Plain align shift: left (wrapping on 32 bits) or arithmetic right."""
    return (v.astype(np.int64) << s) if s >= 0 else (v.astype(np.int64) >> -s)


def _quant(y, scale, bits):
    q = np.rint((y * np.float32(scale)).astype(np.float32))
    qm = np.float32((1 << (bits - 1)) - 1)
    return np.clip(q, -qm, qm).astype(np.int32)


def _matrix(pool, f):
    """The (n, k) matrix a MATVEC/SQL2 row reads from the pool: rows of
    pitch f[13], or for a streamed one (MK_STREAM) chunks of f[10] columns,
    each n rows of pitch f[11], one after the other."""
    n, k, off = int(f[4]), int(f[5]), int(f[6])
    if not int(f[12]) & mk.MK_STREAM:
        p = int(f[13])
        return pool[off:off + n * p].reshape(n, p)[:, :k]
    ch, pc = int(f[10]), int(f[11])
    nch = -(-k // ch)
    blocks = pool[off:off + nch * n * pc].reshape(nch, n, pc)[:, :, :ch]
    return np.concatenate(list(blocks), axis=1)[:, :k]


def _emulate(seg, pk, xs):
    """Run the packed table for each sample, as one block of the kernel."""
    I, F = pk["instrs"], pk["fparams"]
    ci, mi = pk["consts"], pk["mats"]
    cf, mf = ci.view(np.float32), mi.view(np.float32)
    q, bits = seg.quantized, seg.bits
    nb = xs[0].shape[0]
    dts = [mk._DTYPE[d] for d in mk._seg_out_dtypes(seg)]
    outs = [np.zeros((nb, w), _DT[d]) for w, d in zip(seg.out_widths, dts)]
    for b in range(nb):
        ri = np.zeros(pk["smem_words"], np.int32)
        rf = ri.view(np.float32)
        for f, g in zip(I, F):
            op, dst, s0, s1, n, k = (int(v) for v in f[:6])
            if op == 0:                                   # LOAD_IN
                v = xs[f[8]][b, :n]
                if q:
                    ri[dst:dst + n] = v.astype(np.int32)
                else:
                    rf[dst:dst + n] = v.astype(np.float32)
            elif op == 1:                                 # LOAD_CONST
                ri[dst:dst + n] = ci[f[7]:f[7] + n]
            elif op == 2:                                 # MATVEC / SPMV
                W = _matrix(mi if q else mf, f).T
                if q:
                    acc = (W.astype(np.uint32) * ri[s0:s0 + k, None]
                           .astype(np.uint32)).sum(0, dtype=np.uint32)
                    acc = acc.view(np.int32)
                    if f[7] >= 0:
                        acc = (acc.astype(np.uint32)
                               + ci[f[7]:f[7] + n].astype(np.uint32)).view(np.int32)
                    ri[dst:dst + n] = acc
                else:
                    acc = W[0] * rf[s0]
                    for j in range(1, k):
                        acc = acc + W[j] * rf[s0 + j]
                    if f[7] >= 0:
                        acc = acc + cf[f[7]:f[7] + n]
                    rf[dst:dst + n] = acc
            elif op in (3, 4):                            # REQUANTIZE
                sh = f[9] if op == 3 else ci[f[7]:f[7] + n]
                ri[dst:dst + n] = _requant(ri[s0:s0 + n], sh, bits)
            elif op == 5:                                 # ARGMAX
                v = ri[s0:s0 + k] if q else rf[s0:s0 + k]
                idx = int(np.argmax(v))
                if q:
                    ri[dst] = idx
                else:
                    rf[dst] = idx
            elif op in (6, 7, 8):                         # REDUCE, SQL2, DOT
                def load(off, width, flag, scale):
                    return ((ri[off:off + width].astype(np.float32)
                             * np.float32(scale)) if f[9] & flag
                            else rf[off:off + width].copy())
                if op == 7:
                    P = _matrix(mf, f).T                  # a row per point
                    x = load(s0, k, 1, g[1])
                    acc = (P[0] - x[0]) * (P[0] - x[0])
                    for i in range(1, k):
                        acc = acc + (P[i] - x[i]) * (P[i] - x[i])
                else:
                    a = load(s0, k, 1, g[1])
                    if op == 8:
                        a = a * load(s1, k, 2, g[2])
                    acc = a[:1]
                    for j in range(1, k):
                        if op == 8 or f[8] == 0:
                            acc = acc + a[j:j + 1]
                        else:
                            acc = (np.maximum if f[8] == 1 else np.minimum)(acc, a[j:j + 1])
                w = acc.size
                if f[9] & 4:
                    ri[dst:dst + w] = _quant(acc, g[3], bits)
                else:
                    rf[dst:dst + w] = acc
            elif op == 9:                                 # ELEMENTWISE
                st, olen = int(f[8]), k
                oi = np.zeros(n, np.int64) if olen == 1 else np.arange(n)
                x, xi = rf[s0:s0 + n].copy(), ri[s0:s0 + n].copy()
                if st in (1, 2, 3, 17, 18, 19):           # *_vec operand
                    vf, vi = cf[f[7] + oi], ci[f[7] + oi]
                if st in (8, 9, 10, 20, 21, 22):          # *_arr operand
                    af, ai = rf[s1 + oi], ri[s1 + oi]
                p0, p1, p2 = (int(v) for v in f[9:12])
                if st < 16:
                    rf[dst:dst + n] = [
                        lambda: x * np.float32(g[0]), lambda: x + vf,
                        lambda: x - vf, lambda: x * vf,
                        *[lambda u=u: u(x) for u in _UNARY],
                        lambda: x + af, lambda: x - af, lambda: x * af][st]()
                elif st == 23:
                    y = _UNARY[p0](xi.astype(np.float32) * np.float32(g[1]))
                    ri[dst:dst + n] = _quant(y.astype(np.float32), g[3], bits)
                elif st == 16:                            # q_scalar_mul
                    acc = (xi.astype(np.int64) * p0).astype(np.int32)
                    ri[dst:dst + n] = _requant(acc, p1, bits)
                else:                                     # q_*_vec / q_*_arr
                    o = vi if st in (17, 18, 19) else ai
                    if st in (19, 22):                    # hadamard
                        acc = xi.astype(np.int64) * o
                    else:
                        sign = 1 if st in (17, 20) else -1
                        acc = _align(xi, p0) + sign * _align(o, p1)
                    ri[dst:dst + n] = _requant(acc.astype(np.int32), p2, bits)
            elif op == 10:                                # STORE
                o = f[8]
                src = ri[s0:s0 + n] if q else rf[s0:s0 + n]
                outs[o][b] = src.astype(outs[o].dtype)
    return outs


def _isa_dfg():
    """Every ISA op and every float stage (and so, on the fixed-point lanes,
    every ``q_*`` stage and both REQUANTIZE forms) in one graph."""
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    g = DFG("isa")
    g.add_input("x", (24,))
    a = g.add("gemv", "x", id="a", matrix=f(16, 24), bias=f(16))
    b = g.add("spmv", a, id="b", matrix=f(16, 16) * (rng.random((16, 16)) < 0.3))
    t = g.add("tanh", b, id="t")
    s = g.add("sigmoid", a, id="s")
    r = g.add("relu", g.add("sub", t, s, id="ts"), id="r")
    e = g.add("exp", g.add("scalar_mul", r, id="rs", scalar=-0.7), id="e")
    u = g.add("add", e, id="u", vec=f(16))
    w = g.add("hadamard", g.add("sub", u, id="uv", vec=f(16)), id="w", vec=f(16))
    q = g.add("add", g.add("hadamard", w, t, id="h"), s, id="q")
    d = g.add("sq_l2", q, id="d", points=f(16, 10))
    g.mark_output(g.add("reduce_sum", d, id="rsum"))
    g.mark_output(g.add("reduce_max", q, id="rmax"))
    g.mark_output(g.add("reduce_min", q, id="rmin"))
    g.mark_output(g.add("argmax", d, id="am"))
    g.mark_output(g.add("dot", q, t, id="dp"))
    g.mark_output(d)
    return g


def _segment(kind, precision, per_channel=False):
    if kind == "isa":
        calib = np.random.default_rng(9).standard_normal((64, 24))
        prog = MafiaCompiler(precision=precision, per_channel=per_channel,
                             exec_mode="megakernel_grid", device="cpu").compile(
            _isa_dfg(), calib=calib.astype(np.float32))
    else:
        prog = get_program(kind, precision=precision,
                           exec_mode="megakernel_grid", device="cpu")
    (seg,) = prog.plan.megakernel.segments
    (name, spec), = prog.dfg.graph_inputs.items()
    X = np.random.default_rng(2).standard_normal((3,) + tuple(spec.shape))
    x = torch.from_numpy(X.astype(np.float32)).reshape(3, -1)
    if precision != "float32":
        x = quantize_t(x, prog.plan.input_exps[name], prog.plan.bits)
    return seg, x


CASES = [(k, p, False) for k in ("bonsai/usps-b", "protonn/letter-m", "isa")
         for p in ("float32", "int8", "int16")] + [("isa", "int16", True)]


@pytest.mark.parametrize("kind,precision,per_channel", CASES)
def test_packed_table_runs_like_the_plain_version(kind, precision, per_channel):
    seg, x = _segment(kind, precision, per_channel)
    pk = mk.pack_segment(seg)
    assert pk["instrs"].shape == (pk["n_instr"], 16)
    assert ((pk["instrs"][:, 0] != 11).sum()
            == sum(i.op != "LOAD_MAT" for i in seg.instrs))
    got = _emulate(seg, pk, [x.numpy()])
    want = run_segment_grid_ref(seg, [x])
    for a, b, pe in zip(got, want, float_pe_outputs(seg)):
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        if b.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        elif pe and b.dtype != np.int32:
            assert np.abs(a.astype(np.int64) - b).max() <= 1
        else:
            np.testing.assert_array_equal(a, b)


def _chip_smoke():
    """The repo-root smoke script as a module (its helpers are tested here)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tie_segment_rounds_half_to_even():
    """The smoke script's tie segment: the plain version, the packed table
    and the CPU wrapper all give numpy's half-to-even results exactly, and
    only the ``q_unary`` output counts as downstream of a float PE."""
    seg, x, want = _chip_smoke().tie_segment()
    assert float_pe_outputs(seg) == (True, False)
    assert (np.asarray(want[0], np.float32) * 2 - np.maximum(x, 0)).min() < 0
    xt = torch.from_numpy(x)
    lanes = [[o.numpy() for o in run_segment_grid_ref(seg, [xt])],
             _emulate(seg, mk.pack_segment(seg), [x]),
             [o.numpy() for o in mk.run_segment_grid(seg, [xt])]]
    for got in lanes:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_float_pe_outputs_follow_the_slots():
    """A float PE taints what it reaches and no more: an output fed only by
    integer templates stays exact even when a slot is reused."""
    Instr = mk.Instr
    seg = mk.MegakernelSegment(
        instrs=(Instr("LOAD_VEC", dst=0, operand=("in", 0)),
                Instr("ELEMENTWISE", dst=1, src=(0,),
                      operand=(("q_unary", ("tanh", 4, 6)), ())),
                Instr("STORE", src=(1,), operand=0),
                Instr("ELEMENTWISE", dst=1, src=(0,),
                      operand=(("q_scalar_mul", (5, 2)), ())),
                Instr("STORE", src=(1,), operand=1),
                Instr("ELEMENTWISE", dst=0, src=(0, 1),
                      operand=(("q_add_arr", (0, 0, 0, 1)), ())),
                Instr("REDUCE", dst=1, src=(0,), operand=("sum", 6, 3)),
                Instr("STORE", src=(0,), operand=2),
                Instr("STORE", src=(1,), operand=3)),
        slot_widths=(8, 8), consts=(), matrices=(), in_refs=("x",),
        out_refs=("a", "b", "c", "d"), out_widths=(8, 8, 8, 1),
        out_shapes=((8,), (8,), (8,), (1,)), quantized=True, bits=8)
    assert float_pe_outputs(seg) == (True, False, False, True)


@pytest.mark.parametrize("bench", ["bonsai/usps-b", "protonn/letter-m"])
def test_bound_counts_narrow_values_at_their_width(bench):
    """The smoke script's bound reads int8/int16 weights at one/two bytes,
    though the compiler holds them as int32 words."""
    cs = _chip_smoke()
    work = {}
    for p in ("float32", "int8", "int16"):
        seg, _ = _segment(bench, p)
        work[p] = cs.segment_work(seg, 64)
        if seg.quantized:
            carrier = sum(np.asarray(m).nbytes for m in seg.matrices
                          if np.asarray(m).dtype == np.int32)
            assert carrier > 0
    f, i8, i16 = (work[p][0] for p in ("float32", "int8", "int16"))
    assert i8 < i16 < f
    assert i8 < 0.45 * f and i16 < 0.7 * f
    assert work["int8"][1] == work["int16"][1] > 0


def test_input_free_segment_needs_a_device_or_a_card():
    """With no inputs the device comes from the caller; None means the
    card, and with no card the wrapper raises instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    Instr = mk.Instr
    seg = mk.MegakernelSegment(
        instrs=(Instr("LOAD_VEC", dst=0, operand=("const", 0)),
                Instr("STORE", src=(0,), operand=0)),
        slot_widths=(3,), consts=(np.float32([1, 2, 3]),), matrices=(),
        in_refs=(), out_refs=("c",), out_widths=(3,), out_shapes=((3,),))
    with pytest.raises(RuntimeError, match="CUDA"):
        mk.run_segment_grid(seg, [])
    (out,) = mk.run_segment_grid(seg, [], device="cpu")
    np.testing.assert_array_equal(out.numpy(), [[1, 2, 3]])


def test_pack_rejects_unknown_ops_and_devices():
    seg, x = _segment("protonn/letter-m", "float32")
    bad = type(seg)(**{**seg.__dict__,
                       "instrs": seg.instrs + (mk.Instr("NOPE"),)})
    with pytest.raises(ValueError, match="NOPE"):
        mk.pack_segment(bad)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.run_segment_grid(seg, [x.to("meta")])
