"""The port's op registry against the JAX package's, op by op.

For every one of the 27 ops: the metadata every compiler stage reads
(taxonomy, cost models, rewrite legality, whether an integer template
exists) is equal, and the torch float template agrees with the JAX one on
seeded inputs.  The integer templates the classical path uses are held
bitwise through a compiled int8 program; the ones not ported yet raise
``NotImplementedError`` naming their op (never ``None``: lowering picks the
q/dq mode by whether a template exists).
"""

import numpy as np
import pytest
import torch

from repro.core import node_types as jnt
from repro.core.compiler import MafiaCompiler as JCompiler
from repro.core.dfg import DFG as JDFG
from repro.core.executor import execute as jexecute
from repro_torch.core import node_types as tnt
from repro_torch.core.compiler import MafiaCompiler as TCompiler
from repro_torch.core.dfg import DFG as TDFG
from repro_torch.core.executor import execute as texecute

torch.set_num_threads(1)

_R = np.random.default_rng(11)


def _f(*shape):
    return _R.standard_normal(shape).astype(np.float32)


# op -> (input shapes, params); one node of the op over fresh graph inputs
CASES = {
    "add": ([(8,), (8,)], {}),
    "sub": ([(8,)], {"vec": _f(8)}),
    "hadamard": ([(8,), (8,)], {}),
    "scalar_mul": ([(8,)], {"scalar": 0.3}),
    "exp": ([(8,)], {}),
    "relu": ([(8,)], {}),
    "sigmoid": ([(8,)], {}),
    "tanh": ([(8,)], {}),
    "const": ([], {"value": _f(8)}),
    "dot": ([(8,), (8,)], {}),
    "reduce_sum": ([(8,)], {}),
    "reduce_max": ([(8,)], {}),
    "reduce_min": ([(8,)], {}),
    "argmax": ([(8,)], {}),
    "gemv": ([(8,)], {"matrix": _f(6, 8), "bias": _f(6)}),
    "spmv": ([(8,)], {"matrix": _f(6, 8) * (_R.random((6, 8)) < 0.3)}),
    "matmul": ([(4, 5), (5, 3)], {}),
    "outer": ([(4,), (6,)], {}),
    "sq_l2": ([(8,)], {"points": _f(8, 5)}),
    "conv2d": ([(3, 9, 9)], {"kernel": _f(4, 3, 3, 3), "bias": _f(4),
                             "stride": 2, "padding": 1}),
    "maxpool2d": ([(4, 8, 10)], {"ksize": (2, 2)}),
    "avgpool2d": ([(4, 8, 10)], {"ksize": (2, 2)}),
    "relu6": ([(6, 10)], {}),
    "softmax": ([(6, 10)], {}),
    "layernorm": ([(6, 10)], {"gamma": _f(10), "beta": _f(10), "eps": 1e-5}),
    "flatten": ([(3, 4, 5)], {}),
    "reshape": ([(3, 4, 5)], {"shape": (12, 5)}),
}
NOT_PORTED_Q = ["avgpool2d", "conv2d", "flatten", "matmul", "maxpool2d",
                "relu6", "reshape"]


def _graph(cls, op):
    shapes, params = CASES[op]
    g = cls(op)
    names = [f"x{i}" for i in range(len(shapes))]
    for n, s in zip(names, shapes):
        g.add_input(n, s)
    g.mark_output(g.add(op, *names, id="y", **params))
    return g


def _inputs(op, seed):
    rng = np.random.default_rng(seed)
    shapes, _ = CASES[op]
    return {f"x{i}": (rng.standard_normal(s) * 2).astype(np.float32)
            for i, s in enumerate(shapes)}


def test_registry_is_complete():
    assert set(CASES) == set(jnt.all_ops()) == set(tnt.all_ops())
    assert len(CASES) == 27


@pytest.mark.parametrize("op", sorted(CASES))
def test_metadata_matches(op):
    j, t = jnt.get(op), tnt.get(op)
    for field in ("linear_time", "dsp_per_pe", "has_reduction",
                  "scale_param", "bias_foldable"):
        assert getattr(t, field) == getattr(j, field), field
    assert (t.fn_q is None) == (j.jax_fn_q is None)
    jg, tg = _graph(JDFG, op), _graph(TDFG, op)
    dims = j.infer_dims(jg, jg.nodes["y"]) if j.infer_dims else {}
    assert (t.infer_dims(tg, tg.nodes["y"]) if t.infer_dims else {}) == dims
    assert tuple(t.out_shape(tg, tg.nodes["y"])) == tuple(j.out_shape(jg, jg.nodes["y"]))
    dims = {**jg.nodes["y"].dims, **dims}
    assert t.flops(dims) == j.flops(dims)
    assert t.mem_bytes(dims) == j.mem_bytes(dims)
    assert t.max_pf(dims) == j.max_pf(dims)
    for pf in (1, 2, 7, 32):
        assert t.cycles(dims, pf) == j.cycles(dims, pf)
        assert t.lut(dims, pf) == j.lut(dims, pf)
        assert t.dsp(pf) == j.dsp(pf)


@pytest.mark.parametrize("op", sorted(CASES))
def test_float_template_matches(op):
    xs = _inputs(op, seed=5)
    want = np.asarray(jexecute(_graph(JDFG, op), **xs)["y"])
    got = texecute(_graph(TDFG, op), device="cpu", **xs)["y"].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", NOT_PORTED_Q)
def test_unported_integer_templates_raise(op):
    fn_q = tnt.get(op).fn_q
    assert fn_q is not None
    with pytest.raises(NotImplementedError, match=op):
        fn_q([], {}, {}, None)


@pytest.mark.parametrize("op", ["add", "sub", "hadamard", "scalar_mul",
                                "gemv", "spmv", "const"])
@pytest.mark.parametrize("precision", ["int8", "int16"])
def test_integer_template_bitwise_through_program(op, precision):
    """A fixed-point program around the op, compiled by both packages and
    run on the same inputs: the integer templates agree bit for bit."""
    w2 = np.random.default_rng(8).standard_normal((8, 6)).astype(np.float32)

    def graph(cls):
        g = cls(op)
        g.add_input("x", (8,))
        h = g.add("gemv", "x", id="h", matrix=CASES["gemv"][1]["matrix"][:, :8])
        h = g.add("spmv", h, id="h2", matrix=w2)
        if op == "const":
            c = g.add("const", id="c", value=CASES["const"][1]["value"])
            y = g.add("add", h, c, id="y")
        elif op in ("add", "hadamard"):
            y = g.add(op, h, "x", id="y")
        elif op in ("gemv", "spmv"):
            y = g.add(op, h, id="y", matrix=CASES["gemv"][1]["matrix"][:, :8])
        else:
            y = g.add(op, h, id="y", **CASES[op][1])
        g.mark_output(y)
        return g

    calib = np.random.default_rng(2).standard_normal((64, 8)).astype(np.float32)
    pj = JCompiler(precision=precision).compile(graph(JDFG), calib=calib)
    pt = TCompiler(precision=precision, device="cpu").compile(graph(TDFG),
                                                              calib=calib)
    for i in range(4):
        x = np.random.default_rng(30 + i).standard_normal(8).astype(np.float32)
        a, b = np.asarray(pj(x=x)["y"]), pt(x=x)["y"].numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
