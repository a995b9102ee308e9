"""The port's op registry against the JAX package's, op by op.

For every one of the 27 ops: the metadata every compiler stage reads
(taxonomy, cost models, rewrite legality, whether an integer template
exists) is equal, and the torch float template agrees with the JAX one on
seeded inputs.  The integer templates the classical path uses are held
bitwise through a compiled int8 program; the seven tensor templates of the
MLPerf-Tiny programs (matmul, conv2d, maxpool2d, avgpool2d, relu6, flatten,
reshape) are held bitwise with the reference's template, called directly on
seeded int8/int16 carriers with the same formats.
"""

import numpy as np
import pytest
import torch

from repro.core import node_types as jnt
from repro.core.compiler import MafiaCompiler as JCompiler
from repro.core.dfg import DFG as JDFG
from repro.core.executor import execute as jexecute
from repro.core.quantize import NodeQuant as JNodeQuant
from repro_torch.core import node_types as tnt
from repro_torch.core.compiler import MafiaCompiler as TCompiler
from repro_torch.core.dfg import DFG as TDFG
from repro_torch.core.executor import execute as texecute
from repro_torch.core.quantize import NodeQuant as TNodeQuant

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
# the integer templates of the MLPerf-Tiny programs' tensor ops
TENSOR_Q = ["avgpool2d", "conv2d", "flatten", "matmul", "maxpool2d",
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


def _carrier(rng, shape, bits):
    qm = (1 << (bits - 1)) - 1
    return rng.integers(-qm, qm + 1, size=shape).astype(f"int{bits}")


def _q_case(op, bits, seed, variant=0):
    """(inputs, params, NodeQuant fields) of one call of ``op``'s integer
    template on seeded carriers at ``bits``; ``variant`` picks the shape,
    stride, padding and (conv2d) per-tensor or per-channel scales."""
    rng = np.random.default_rng(seed)
    q = dict(in_exps=(5,), out_exp=4, params_q={}, param_exps={}, bits=bits)
    if op == "matmul":
        m, k, n = ((5, 7, 3), (1, 9, 4), (6, 1, 2), (4, 33, 5))[variant % 4]
        ins = [_carrier(rng, (m, k), bits), _carrier(rng, (k, n), bits)]
        q.update(in_exps=(5, 6), out_exp=(3, 7, 11, 2)[variant % 4])
        return ins, {}, q
    if op == "conv2d":
        (cin, h, w), (cout, kh, kw), st, pd = (
            ((3, 9, 7), (4, 3, 3), 1, 1), ((2, 11, 5), (3, 3, 2), 2, 2),
            ((1, 5, 5), (5, 1, 1), 1, 0), ((4, 7, 9), (2, 3, 3), (2, 1), (1, 2)),
        )[variant % 4]
        kq = _carrier(rng, (cout, cin, kh, kw), bits)
        params = {"kernel": kq.astype(np.float32), "stride": st, "padding": pd}
        q["params_q"] = {"kernel": kq}
        if variant % 2 == 0:
            bias = rng.integers(-(1 << 12), 1 << 12, size=cout).astype(np.int32)
            params["bias"] = bias.astype(np.float32)
            q["params_q"]["bias"] = bias
        # per-channel scales on odd variants: one exponent per output row
        q["param_exps"] = {"kernel": (rng.integers(3, 9, size=cout)
                                      if variant % 2 else 6)}
        q["out_exp"] = 3
        return [_carrier(rng, (cin, h, w), bits)], params, q
    if op in ("maxpool2d", "avgpool2d"):
        shape, ks, st, pd = (((3, 9, 7), 2, 2, 0), ((2, 7, 11), 3, 1, 1),
                             ((4, 8, 9), (3, 2), (2, 1), (1, 1)),
                             ((1, 5, 5), 3, 2, 1))[variant % 4]
        params = {"ksize": ks, "stride": st, "padding": pd}
        q["out_exp"] = (5, 3, 6, 7)[variant % 4]
        return [_carrier(rng, shape, bits)], params, q
    if op == "relu6":
        q["in_exps"] = ((4,), (bits - 4,), (2,), (0,))[variant % 4]
        q["out_exp"] = q["in_exps"][0] - variant % 3 + 1
        return [_carrier(rng, (5, 9), bits)], {}, q
    x = _carrier(rng, (3, 5, 7), bits)
    q["out_exp"] = (5, 3, 7, 6)[variant % 4]
    if op == "reshape":
        return [x], {"shape": ((15, 7), (105,), (7, 15), (3, 35))[variant % 4]}, q
    return [x], {}, q


def _run_q(op, ins, params, q):
    import jax.numpy as jnp

    want = jnt.get(op).jax_fn_q([jnp.asarray(a) for a in ins], params, {},
                                JNodeQuant(**q))
    got = tnt.get(op).fn_q([torch.from_numpy(a) for a in ins], params, {},
                           TNodeQuant(**q))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("op", TENSOR_Q)
def test_unported_integer_templates_raise(op):
    """These templates were stubs that raised; each now exists and is
    bitwise with the reference's (int8, the first case of ``_q_case``)."""
    assert tnt.get(op).fn_q is not None
    got, want = _run_q(op, *_q_case(op, 8, seed=1))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("op", TENSOR_Q)
def test_tensor_integer_template_bitwise(op, bits, variant):
    """Each of the seven against the reference template, bit for bit, on
    seeded carriers over the whole int8/int16 range: odd spatial sizes,
    strides and paddings of 1-2, conv2d with per-tensor and per-channel
    scales, with and without bias, pools over non-power-of-two windows."""
    ins, params, q = _q_case(op, bits, seed=100 + variant, variant=variant)
    got, want = _run_q(op, ins, params, q)
    assert got.dtype == want.dtype == np.dtype(f"int{bits}")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_int32_matmul_wraps_like_the_reference():
    """The broadcast-sum int32 product wraps on overflow as the reference's
    int32 matmul does (no widening to int64)."""
    import jax.numpy as jnp

    a = np.full((2, 3), 2**20, np.int32)
    b = np.full((3, 2), 2**12, np.int32)
    want = np.asarray(jnp.asarray(a) @ jnp.asarray(b))
    got = tnt._i32_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


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
