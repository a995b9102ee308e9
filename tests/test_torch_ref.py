"""The port's plain versions against the JAX package's reference twins.

* every float and ``q_*`` stage of the fused-pipeline vocabulary, and the
  chains built from them;
* ``run_segment_ref`` — the plain version of the CUDA megakernel — on the
  compiled segments of four Table-I programs at float32/int8/int16 and on a
  DFG that uses ``REDUCE``, ``DOT`` and the ``*_vec`` stages.

Tolerances: float32 ``rtol=atol=1e-5`` (XLA and torch may sum a row in
another order).  Integer lanes are bitwise where every value comes from an
integer template; downstream of a dequantize → float → requantize op
(``q_unary``, ``SQL2``, ``REDUCE``, ``DOT``) transcendentals may differ by
an ulp, so at most 1 LSB per element is allowed there and the count is
reported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compiler import MafiaCompiler as JCompiler
from repro.core.dfg import DFG as JDFG
from repro.core.quantize import quantize_jnp
from repro.kernels import ref as jref
from repro.serve.classical_engine import get_program as jget
from repro_torch.core.compiler import MafiaCompiler as TCompiler
from repro_torch.core.dfg import DFG as TDFG
from repro_torch.kernels import megakernel as tmk
from repro_torch.kernels import ref as tref
from repro_torch.serve.classical_engine import get_program as tget

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BENCHES = ["bonsai/usps-b", "protonn/usps-b", "bonsai/letter-m",
           "protonn/letter-m"]
PRECISIONS = ["float32", "int8", "int16"]


def _rows(seed, n=64, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, n)) * scale).astype(np.float32)


# ----------------------------------------------------------------- stages
FLOAT_STAGES = [("scalar_mul", 0.37), ("add_vec", "v"), ("sub_vec", "v"),
                ("hadamard_vec", "v"), ("tanh", None), ("sigmoid", None),
                ("relu", None), ("exp", None), ("add_arr", 0),
                ("sub_arr", 0), ("hadamard_arr", 0)]


@pytest.mark.parametrize("stage", FLOAT_STAGES, ids=[s[0] for s in FLOAT_STAGES])
def test_apply_stage_matches(stage):
    x, e = _rows(1)
    v = _rows(2)[0, :1] if stage[0] == "hadamard_vec" else _rows(2)[0]
    op, opd = stage
    jopd = jnp.asarray(v) if opd == "v" else opd
    topd = torch.from_numpy(v) if opd == "v" else opd
    want = np.asarray(jref.apply_stage(jnp.asarray(x), (op, jopd), [jnp.asarray(e)]))
    got = tref.apply_stage(torch.from_numpy(x), (op, topd), [torch.from_numpy(e)])
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_linear_chain_matches():
    x, e = _rows(3)
    v = _rows(4)[0]
    stages_j = [("hadamard_vec", jnp.asarray(v)), ("tanh", None),
                ("add_arr", 0), ("scalar_mul", 0.5), ("sigmoid", None)]
    stages_t = [("hadamard_vec", torch.from_numpy(v)), ("tanh", None),
                ("add_arr", 0), ("scalar_mul", 0.5), ("sigmoid", None)]
    want = np.asarray(jref.linear_chain_ref(jnp.asarray(x), stages_j, [jnp.asarray(e)]))
    got = tref.linear_chain_ref(torch.from_numpy(x), stages_t, [torch.from_numpy(e)])
    np.testing.assert_allclose(got.numpy(), want, **F32)


Q_STAGES = [("q_scalar_mul", (-37, 5)), ("q_add_vec", (0, 2, -1, 3)),
            ("q_sub_vec", (1, -2, 4, 1)), ("q_hadamard_vec", (0, 6)),
            ("q_add_arr", (0, 0, 3, 2)), ("q_sub_arr", (0, 5, 0, -2)),
            ("q_hadamard_arr", (0, 30)),
            ("q_unary", ("tanh", 5, 7)), ("q_unary", ("sigmoid", 4, 7)),
            ("q_unary", ("relu", 5, 6)), ("q_unary", ("exp", 6, 3))]


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("stage", Q_STAGES,
                         ids=[f"{s[0]}-{s[1][0]}" for s in Q_STAGES])
def test_apply_stage_q_matches(stage, bits):
    rng = np.random.default_rng(bits)
    qm = (1 << (bits - 1)) - 1
    x, e, v0, v1 = (rng.integers(-qm, qm + 1, (3, 64)).astype(np.int32)
                    for _ in range(4))
    jv = [jnp.asarray(v0[:1]), jnp.asarray(v1[:1])]
    tv = [torch.from_numpy(v0[:1]), torch.from_numpy(v1[:1])]
    want = np.asarray(jref.apply_stage_q(jnp.asarray(x), stage, jv,
                                         [jnp.asarray(e)], bits))
    got = tref.apply_stage_q(torch.from_numpy(x), stage, tv,
                             [torch.from_numpy(e)], bits).numpy()
    assert got.dtype == want.dtype
    if stage[0] == "q_unary":       # float PE between dequantize/requantize
        assert np.abs(got.astype(np.int64) - want).max() <= 1
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 16])
def test_linear_chain_q_matches(bits):
    rng = np.random.default_rng(5)
    qm = (1 << (bits - 1)) - 1
    x = rng.integers(-qm, qm + 1, (4, 32)).astype(f"int{bits}")
    v = rng.integers(-qm, qm + 1, (1, 32)).astype(f"int{bits}")
    stages = [("q_hadamard_vec", (0, 4)), ("q_add_arr", (0, 1, 0, 1)),
              ("q_scalar_mul", (3, 1))]
    want = np.asarray(jref.linear_chain_q_ref(jnp.asarray(x), stages,
                                              [jnp.asarray(v)], [jnp.asarray(x)],
                                              bits))
    got = tref.linear_chain_q_ref(torch.from_numpy(x), stages,
                                  [torch.from_numpy(v)], [torch.from_numpy(x)],
                                  bits).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- segments
def _compare(seg, want, got):
    """Hold one segment's outputs to the tolerance rules above, output by
    output; returns the count of 1-LSB elements."""
    lsb = 0
    for a, b, pe in zip(want, got, tref.float_pe_outputs(seg)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if not seg.quantized:
            if np.issubdtype(a.dtype, np.integer):
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(b, a, **F32)
        elif pe:
            d = np.abs(a.astype(np.int64) - b.astype(np.int64))
            assert d.max(initial=0) <= 1
            lsb += int((d == 1).sum())
        else:
            np.testing.assert_array_equal(b, a)
    return lsb


def _seg_ops(seg):
    return ({i.op for i in seg.instrs}
            | {i.operand[0][0] for i in seg.instrs if i.op == "ELEMENTWISE"})


def _reference_rows(jseg, X):
    """The JAX reference on each row of ``X``: the per-sample function,
    vmapped and compiled once (its op-by-op eager run costs ~5x more)."""
    outs = jax.jit(jax.vmap(lambda x: jref.run_segment_ref(jseg, [x])))(
        jnp.asarray(X))
    return [[np.asarray(o[i]) for o in outs] for i in range(len(X))]


def _check_rows(jseg, tseg, X):
    """Port vs reference, sample by sample; returns the 1-LSB count."""
    lsb = 0
    for x, want in zip(X, _reference_rows(jseg, X)):
        xt = torch.from_numpy(np.array(x))
        got = [o.numpy() for o in tref.run_segment_ref(tseg, [xt])]
        lsb += _compare(tseg, want, got)
        # on the CPU the wrapper runs this same plain version
        for a, b in zip(got, tmk.run_segment(tseg, [xt])):
            np.testing.assert_array_equal(b.numpy(), a)
    return lsb


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("bench", BENCHES)
def test_run_segment_ref_on_table1(bench, precision):
    jp = jget(bench, precision=precision, exec_mode="megakernel_grid")
    tp = tget(bench, precision=precision, exec_mode="megakernel_grid",
              device="cpu")
    (jseg,), (tseg,) = jp.plan.megakernel.segments, tp.plan.megakernel.segments
    (name, spec), = jp.dfg.graph_inputs.items()
    X = np.random.default_rng(1).standard_normal((6,) + tuple(spec.shape))
    X = X.astype(np.float32)
    if precision != "float32":
        X = np.asarray(quantize_jnp(jnp.asarray(X), jp.plan.input_exps[name],
                                    jp.plan.bits))
    lsb = _check_rows(jseg, tseg, X)
    print(f"{bench}/{precision}: 1-LSB elements {lsb}")


def test_tie_segment_matches_reference():
    """Rounding ties (the smoke script's tie segment): the port's plain
    version and the JAX reference agree bit for bit."""
    from repro.kernels.megakernel import Instr, MegakernelSegment
    from test_torch_pack import _chip_smoke

    tseg, x, want = _chip_smoke().tie_segment()
    jseg = MegakernelSegment(
        **{**tseg.__dict__, "instrs": tuple(Instr(**i.__dict__)
                                            for i in tseg.instrs)})
    assert _check_rows(jseg, tseg, x) == 0
    for row, w0, w1 in zip(_reference_rows(jseg, x), *want):
        np.testing.assert_array_equal(row[0], w0)
        np.testing.assert_array_equal(row[1], w1)


def _isa_dfg(cls):
    """REDUCE (all kinds), DOT, ARGMAX and the *_vec stages in one graph."""
    rng = np.random.default_rng(3)
    g = cls("isa")
    g.add_input("x", (8,))
    a = g.add("gemv", "x", id="a", matrix=rng.normal(size=(6, 8)).astype(np.float32))
    t = g.add("tanh", a, id="t")
    u = g.add("add", t, id="u", vec=rng.normal(size=6).astype(np.float32))
    w = g.add("hadamard", u, id="w", vec=rng.normal(size=6).astype(np.float32))
    s = g.add("sigmoid", w, id="s")
    g.mark_output(g.add("reduce_sum", s, id="rs"))
    g.mark_output(g.add("reduce_max", t, id="rmax"))
    g.mark_output(g.add("reduce_min", u, id="rmin"))
    g.mark_output(g.add("argmax", w, id="am"))
    g.mark_output(g.add("dot", t, s, id="dp"))
    g.mark_output(s)
    return g


@pytest.mark.parametrize("precision", PRECISIONS)
def test_run_segment_ref_on_isa_dfg(precision):
    calib = np.random.default_rng(9).standard_normal((64, 8)).astype(np.float32)
    kw = dict(precision=precision, exec_mode="megakernel")
    jp = JCompiler(**kw).compile(_isa_dfg(JDFG), calib=calib)
    tp = TCompiler(device="cpu", **kw).compile(_isa_dfg(TDFG), calib=calib)
    assert jp.plan.megakernel.fingerprint() == tp.plan.megakernel.fingerprint()
    (jseg,), (tseg,) = jp.plan.megakernel.segments, tp.plan.megakernel.segments
    assert {"REDUCE", "DOT", "ARGMAX"} <= _seg_ops(jseg)
    X = np.stack([np.random.default_rng(20 + i).standard_normal(8)
                  for i in range(8)]).astype(np.float32)
    if precision != "float32":
        X = np.asarray(quantize_jnp(jnp.asarray(X), jp.plan.input_exps["x"],
                                    jp.plan.bits))
    lsb = _check_rows(jseg, tseg, X)
    print(f"isa/{precision}: 1-LSB elements {lsb}")


def test_grid_plain_version_is_per_sample_plain_version():
    """A bucket through the plain version gives each row what a one-sample
    call gives it, bit for bit (the kernel's two lanes promise the same)."""
    tp = tget("protonn/letter-m", precision="int8", exec_mode="megakernel_grid",
              device="cpu")
    (seg,) = tp.plan.megakernel.segments
    from repro_torch.core.quantize import quantize_t

    X = torch.from_numpy(np.random.default_rng(4).standard_normal((5, 16))
                         .astype(np.float32))
    x = quantize_t(X, tp.plan.input_exps["x"], tp.plan.bits)
    grid = tref.run_segment_grid_ref(seg, [x])
    for i in range(5):
        for g, p in zip(grid, tref.run_segment_ref(seg, [x[i]])):
            assert torch.equal(g[i], p)
