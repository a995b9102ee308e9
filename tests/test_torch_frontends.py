"""The port's frontends and MLPerf-Tiny programs against the JAX package's.

The ports of ``tests/test_frontends.py`` (SeeDot DSL, TF subset) and
``tests/test_onnx_frontend.py`` (the protobuf codec, the opset-13 importer,
BatchNorm folding, rejected ops and attributes, lane parity, the int8
accuracy gate, serving, bit-identical regeneration), run on the port on the
CPU, plus parity with the reference:

* every imported or parsed DFG equals the reference's node for node (ids,
  ops, edges, dims and parameter values);
* both MLPerf-Tiny programs at float32, int8 and int8 per-channel, on the
  port's ``interpret`` and ``megakernel_grid`` lanes (the megakernel's plain
  version on the CPU), against the reference's ``interpret`` lane (its
  megakernel lanes cannot run in this image): float32 within
  ``rtol = atol = 1e-5``, int8 within 1 LSB of the output scale (the float
  ``softmax`` island dequantizes, exponentiates and requantizes);
* the plans: one megakernel segment, with 2 (``kws_mlp``) and 8
  (``tiny_cnn``) interpreted islands, as the reference's;
* the hybrid lanes inside the port: per-sample, ``map``, ``vmap`` and the
  grid, bitwise on the int8 lanes.
"""

import numpy as np
import pytest
import torch

from repro.configs import mlperf_tiny as jmt
from repro.core.compiler import MafiaCompiler as JCompiler
from repro.frontends import seedot as jseedot
from repro.frontends import tf_subset as jtf
from repro_torch.configs import mlperf_tiny as mt
from repro_torch.core.compiler import MafiaCompiler
from repro_torch.core.executor import execute
from repro_torch.frontends import onnx_proto as op_
from repro_torch.frontends import seedot
from repro_torch.frontends import tf_subset as tf
from repro_torch.frontends.onnx_importer import (
    OnnxImportError,
    UnsupportedOnnxOp,
    import_onnx,
)

torch.set_num_threads(1)

INT8_MAX_DROP = 0.015      # tests/test_onnx_frontend.py's gate
N_EVAL = 256
ISLANDS = {"kws_mlp": 2, "tiny_cnn": 8}
PRECISIONS = [("float32", False), ("int8", False), ("int8", True)]


def _run(g, **inputs):
    return list(execute(g, device="cpu", **inputs).values())[0].numpy()


def _same_dfg(j, t):
    """The reference's DFG ``j`` and the port's ``t`` node for node."""
    assert t.structural_hash() == j.structural_hash()
    assert list(t.nodes) == list(j.nodes)
    assert list(t.outputs) == list(j.outputs)
    for nid, jn in j.nodes.items():
        tn = t.nodes[nid]
        assert (tn.op, list(tn.inputs), tn.dims) == (jn.op, list(jn.inputs),
                                                     jn.dims), nid
        assert set(tn.params) == set(jn.params), nid
        for k, v in jn.params.items():
            a, b = np.asarray(tn.params[k]), np.asarray(v)
            assert a.dtype == b.dtype, (nid, k)
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- SeeDot / TF
def test_seedot_gemv_chain():
    W = np.arange(12, dtype=np.float32).reshape(3, 4)
    src, kw = "let y = W * x in tanh(y .* 0.5)", dict(inputs={"x": (4,)},
                                                      params={"W": W})
    g = seedot.parse(src, **kw)
    _same_dfg(jseedot.parse(src, **kw), g)
    x = np.ones(4, np.float32)
    np.testing.assert_allclose(_run(g, x=x), np.tanh(0.5 * (W @ x)), rtol=1e-5)


def test_seedot_sparse_and_rbf():
    W = np.zeros((5, 6), np.float32)
    W[0, 1] = 2.0
    B = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    src = "let p = W |*| x in exp(sq_l2(p, B) .* -0.1)"
    kw = dict(inputs={"x": (6,)}, params={"W": W, "B": B})
    g = seedot.parse(src, **kw)
    _same_dfg(jseedot.parse(src, **kw), g)
    x = np.arange(6, dtype=np.float32)
    p = W @ x
    ref = np.exp(-0.1 * ((B - p[:, None]) ** 2).sum(0))
    np.testing.assert_allclose(_run(g, x=x), ref, rtol=1e-4)
    assert any(n.op == "spmv" for n in g.nodes.values())


def test_seedot_add_vec_param_folds():
    v = np.ones(4, np.float32) * 3
    g = seedot.parse("x + v", inputs={"x": (4,)}, params={"v": v})
    (nid,) = [n.id for n in g.nodes.values()]
    assert g.nodes[nid].op == "add" and "vec" in g.nodes[nid].params


@pytest.mark.parametrize("src,err", [
    ("x * W", "row-major"),
    ("y + x", "unknown name"),
    ("let a = x in", "end of program"),
    ("x .* x", "scalar"),
])
def test_seedot_errors(src, err):
    with pytest.raises(seedot.SeeDotError, match=err):
        seedot.parse(src, inputs={"x": (4,)},
                     params={"W": np.ones((4, 4), np.float32)})


def test_tf_trace_matches_direct_numpy():
    rng = np.random.default_rng(1)
    W = rng.normal(size=(8, 16)).astype(np.float32)
    Zs = rng.normal(size=(4, 8)).astype(np.float32)

    def program(mod):
        return lambda x: mod.matmul_vec(
            Zs, mod.tanh(mod.scale(mod.matmul_vec(W, x), 0.25)))

    g = tf.trace(program(tf), inputs={"x": (16,)})
    _same_dfg(jtf.trace(program(jtf), inputs={"x": (16,)}), g)
    x = rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(_run(g, x=x), Zs @ np.tanh(0.25 * (W @ x)),
                               rtol=1e-4)


def test_tf_trace_two_hop_path_is_seedot():
    W = np.ones((4, 4), np.float32)

    def program(x):
        return tf.exp(tf.sparse_matmul_vec(W, x) * 0.5)

    g = tf.trace(program, inputs={"x": (4,)})
    assert sorted(n.op for n in g.nodes.values()) == ["exp", "scalar_mul",
                                                       "spmv"]


def test_tf_nested_trace_rejected():
    def inner(x):
        return tf.relu(x)

    def outer(x):
        tf.trace(inner, inputs={"y": (4,)})
        return x

    with pytest.raises(RuntimeError, match="nested"):
        tf.trace(outer, inputs={"x": (4,)})


# ------------------------------------------------------------- proto codec
def test_proto_model_round_trip():
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = np.asarray([2, 0, 1], np.int64)
    data = op_.build_model(
        graph_name="rt",
        nodes=[op_.make_node("Gemm", ["x", "w"], ["y"], name="g0",
                             alpha=1.0, transB=1),
               op_.make_node("Softmax", ["y"], ["p"], name="s0", axis=-1)],
        inputs=[op_.value_info("x", ("N", 4))],
        outputs=[op_.value_info("p", ("N", 3))],
        initializers=[op_.np_to_tensor("w", w), op_.np_to_tensor("idx", idx)],
    )
    g = op_.decode_model(data).graph
    assert [n.op_type for n in g.nodes] == ["Gemm", "Softmax"]
    assert g.nodes[0].attrs["alpha"] == 1.0
    assert g.nodes[0].attrs["transB"] == 1
    assert g.nodes[1].attrs["axis"] == -1
    np.testing.assert_array_equal(g.initializers["w"], w)
    np.testing.assert_array_equal(g.initializers["idx"], idx)
    assert g.initializers["idx"].dtype == np.int64
    assert g.inputs == {"x": ("N", 4)}
    assert g.outputs == ("p",)


def test_tensor_typed_fields_decode():
    t = (op_.MessageBuilder()
         .int(1, 2)
         .int(2, 1)
         .string(8, "a")
         .float32(4, 1.5).float32(4, -2.25))
    name, arr = op_.tensor_to_np(t.to_bytes())
    assert name == "a"
    np.testing.assert_array_equal(arr, np.float32([1.5, -2.25]))


# -------------------------------------------------------------- error paths
def _one_node_model(node, in_shape=(4,), out_name="y"):
    return op_.build_model(
        graph_name="err", nodes=[node],
        inputs=[op_.value_info("input", ("N",) + in_shape)],
        outputs=[op_.value_info(out_name, ("N", 4))],
        initializers=[])


def test_unsupported_op_names_node_and_op():
    data = _one_node_model(
        op_.make_node("LSTM", ["input"], ["y"], name="rnn0"))
    with pytest.raises(UnsupportedOnnxOp, match=r"'LSTM'.*'rnn0'"):
        import_onnx(data)


def test_unsupported_attr_names_node():
    data = op_.build_model(
        graph_name="err",
        nodes=[op_.make_node("Conv", ["input", "k"], ["y"], name="c0",
                             kernel_shape=(3, 3), group=2)],
        inputs=[op_.value_info("input", ("N", 4, 8, 8))],
        outputs=[op_.value_info("y", ("N", 4, 6, 6))],
        initializers=[op_.np_to_tensor(
            "k", np.zeros((4, 2, 3, 3), np.float32))])
    with pytest.raises(UnsupportedOnnxOp, match=r"'Conv'.*'c0'.*group"):
        import_onnx(data)


def test_softmax_batch_counted_axis_rejected():
    def mk(axis, in_shape):
        return op_.build_model(
            graph_name="sm",
            nodes=[op_.make_node("Softmax", ["input"], ["y"], name="s0",
                                 axis=axis)],
            inputs=[op_.value_info("input", ("N",) + in_shape)],
            outputs=[op_.value_info("y", ("N",) + in_shape)],
            initializers=[])

    import_onnx(mk(-1, (2, 8)))
    import_onnx(mk(2, (2, 8)))
    with pytest.raises(UnsupportedOnnxOp, match="axis=1"):
        import_onnx(mk(1, (2, 8)))
    import_onnx(mk(1, (8,)))
    with pytest.raises(UnsupportedOnnxOp, match="axis=0"):
        import_onnx(mk(0, (8,)))


@pytest.mark.parametrize("op,attrs,detail", [
    ("MaxPool", {"ceil_mode": 1}, "ceil_mode"),
    ("AveragePool", {"ceil_mode": 1}, "ceil_mode"),
    ("MaxPool", {"dilations": (2, 2)}, "dilations"),
    ("MaxPool", {"storage_order": 1}, "storage_order"),
])
def test_pool_unsupported_attrs_rejected(op, attrs, detail):
    data = op_.build_model(
        graph_name="pool",
        nodes=[op_.make_node(op, ["input"], ["y"], name="p0",
                             kernel_shape=(2, 2), **attrs)],
        inputs=[op_.value_info("input", ("N", 3, 8, 8))],
        outputs=[op_.value_info("y", ("N", 3, 4, 4))],
        initializers=[])
    with pytest.raises(UnsupportedOnnxOp, match=detail):
        import_onnx(data)


def test_symbolic_inner_dim_rejected():
    data = _one_node_model(op_.make_node("Relu", ["input"], ["y"], name="r"))
    bad = op_.build_model(
        graph_name="err",
        nodes=[op_.make_node("Relu", ["input"], ["y"], name="r")],
        inputs=[op_.value_info("input", ("N", "D"))],
        outputs=[op_.value_info("y", ("N", "D"))], initializers=[])
    import_onnx(data)
    with pytest.raises(OnnxImportError, match="symbolic"):
        import_onnx(bad)


# ------------------------------------------------------------ graph structure
@pytest.mark.parametrize("name", mt.WORKLOADS)
def test_imported_dfg_equals_the_reference(name):
    _same_dfg(jmt.build(name), mt.build(name))


def test_kws_mlp_structure():
    dfg = mt.build("kws_mlp")
    assert sorted({n.op for n in dfg.nodes.values()}) == [
        "add", "flatten", "gemv", "relu", "softmax"]
    assert list(dfg.graph_inputs) == ["input"]
    assert dfg.graph_inputs["input"].shape == (49, 10)


def test_tiny_cnn_batchnorm_folds_into_conv():
    dfg = mt.build("tiny_cnn")
    convs = [n for n in dfg.nodes.values() if n.op == "conv2d"]
    assert len(convs) == 2 and all("bias" in n.params for n in convs)
    assert not any(n.op in ("hadamard", "sub") for n in dfg.nodes.values())
    assert {"maxpool2d", "avgpool2d", "reshape", "gemv", "softmax"} <= {
        n.op for n in dfg.nodes.values()}


def test_batchnorm_not_folded_when_conv_has_other_consumers():
    rng = np.random.default_rng(0)
    cin, cout, hw = 3, 4, 5
    x = rng.standard_normal((cin, hw, hw)).astype(np.float32)
    k = rng.standard_normal((cout, cin, 1, 1)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    mean = rng.standard_normal(cout).astype(np.float32)
    var = rng.uniform(0.5, 2.0, cout).astype(np.float32)
    data = op_.build_model(
        graph_name="resid",
        nodes=[
            op_.make_node("Conv", ["input", "k"], ["c"], name="conv0",
                          kernel_shape=(1, 1)),
            op_.make_node("BatchNormalization",
                          ["c", "scale", "bias", "mean", "var"], ["bn"],
                          name="bn0", epsilon=1e-5),
            op_.make_node("Add", ["bn", "c"], ["y"], name="add0"),
        ],
        inputs=[op_.value_info("input", ("N", cin, hw, hw))],
        outputs=[op_.value_info("y", ("N", cout, hw, hw))],
        initializers=[op_.np_to_tensor("k", k),
                      op_.np_to_tensor("scale", scale),
                      op_.np_to_tensor("bias", bias),
                      op_.np_to_tensor("mean", mean),
                      op_.np_to_tensor("var", var)])
    dfg = import_onnx(data)
    conv = next(n for n in dfg.nodes.values() if n.op == "conv2d")
    np.testing.assert_array_equal(np.asarray(conv.params["kernel"]), k)
    assert any(n.op == "hadamard" for n in dfg.nodes.values())
    c_ref = np.einsum("oi,ihw->ohw", k[:, :, 0, 0], x)
    a = scale / np.sqrt(var + 1e-5)
    bn_ref = a[:, None, None] * c_ref + (bias - mean * a)[:, None, None]
    np.testing.assert_allclose(_run(dfg, input=x), bn_ref + c_ref,
                               rtol=1e-5, atol=1e-5)


def test_batchnorm_not_folded_when_conv_is_graph_output():
    k = np.ones((2, 2, 1, 1), np.float32)
    data = op_.build_model(
        graph_name="convout",
        nodes=[
            op_.make_node("Conv", ["input", "k"], ["c"], name="conv0",
                          kernel_shape=(1, 1)),
            op_.make_node("BatchNormalization",
                          ["c", "scale", "bias", "mean", "var"], ["bn"],
                          name="bn0"),
        ],
        inputs=[op_.value_info("input", ("N", 2, 3, 3))],
        outputs=[op_.value_info("bn", ("N", 2, 3, 3)),
                 op_.value_info("c", ("N", 2, 3, 3))],
        initializers=[op_.np_to_tensor("k", k),
                      op_.np_to_tensor("scale", np.ones(2, np.float32)),
                      op_.np_to_tensor("bias", np.zeros(2, np.float32)),
                      op_.np_to_tensor("mean", np.zeros(2, np.float32)),
                      op_.np_to_tensor("var", np.ones(2, np.float32))])
    dfg = import_onnx(data)
    conv = next(n for n in dfg.nodes.values() if n.op == "conv2d")
    np.testing.assert_array_equal(np.asarray(conv.params["kernel"]), k)


def test_fixtures_regenerate_bit_identically():
    for name in mt.WORKLOADS:
        data = mt.model_bytes(name)
        assert mt._GENERATORS[name]() == data, name
        assert data == jmt.model_bytes(name), name


# --------------------------------------------------------- end-to-end gates
@pytest.fixture(scope="module", params=mt.WORKLOADS)
def workload(request):
    name = request.param
    dfg = mt.build(name)
    prog = MafiaCompiler(use_pallas=True, device="cpu").compile(dfg)
    return name, dfg, prog


def _out(res):
    return next(iter(res.values())).numpy()


def test_float32_lane_parity(workload):
    name, _, prog = workload
    x = mt.sample_inputs(name, 32)
    per = np.stack([_out(prog(input=xi)) for xi in x])
    mp = _out(prog.batch(max_batch=8, mode="map")(input=x))
    vm = _out(prog.batch(max_batch=8, mode="vmap")(input=x))
    np.testing.assert_array_equal(per, mp)
    np.testing.assert_allclose(per, vm, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("per_channel", [False, True])
def test_int8_accuracy_drop_within_gate(workload, per_channel):
    name, dfg, prog = workload
    x = mt.sample_inputs(name, N_EVAL)
    labels = mt.teacher_labels(prog, x)
    calib = mt.sample_inputs(name, 128, seed=7)
    p8 = MafiaCompiler(use_pallas=True, precision="int8",
                       per_channel=per_channel, device="cpu").compile(
        dfg, calib={"input": calib})
    out8 = _out(p8.batch(max_batch=64, mode="map")(input=x))
    drop = 1.0 - float((out8.argmax(-1) == labels).mean())
    assert drop <= INT8_MAX_DROP, f"{name} int8 drop {drop:.4f}"
    np.testing.assert_array_equal(
        out8, _out(p8.batch(max_batch=64, mode="vmap")(input=x)))


def test_serves_through_classical_engine(workload):
    from repro_torch.serve.classical_engine import ClassicalServeEngine

    name, _, prog = workload
    x = mt.sample_inputs(name, 10)
    eng = ClassicalServeEngine(prog, max_batch=4, mode="map")
    ids = [eng.submit(xi) for xi in x]
    res = {r.rid: r for r in eng.run_to_completion()}
    for rid, xi in zip(ids, x):
        np.testing.assert_array_equal(
            next(iter(res[rid].outputs.values())), _out(prog(input=xi)))


# ------------------------------------- the port against the reference's lane
_REF: dict = {}


def _reference(name, precision, per_channel):
    """The reference's interpret-lane outputs on ``N_EVAL`` inputs (cached
    per program and precision) and its plan's island count."""
    key = (name, precision, per_channel)
    if key not in _REF:
        calib = ({"input": jmt.sample_inputs(name, 128, seed=7)}
                 if precision != "float32" else None)
        jp = JCompiler(precision=precision, per_channel=per_channel,
                       exec_mode="megakernel_grid").compile(jmt.build(name),
                                                            calib=calib)
        ref = JCompiler(precision=precision, per_channel=per_channel).compile(
            jmt.build(name), calib=calib)
        out = ref.batch(64, mode="vmap")(input=mt.sample_inputs(name, N_EVAL))
        _REF[key] = (np.asarray(next(iter(out.values()))),
                     jp.plan.megakernel.n_islands,
                     len(jp.plan.megakernel.segments), ref.plan.output_exps)
    return _REF[key]


@pytest.mark.parametrize("lane", ["interpret", "megakernel_grid"])
@pytest.mark.parametrize("precision,per_channel", PRECISIONS,
                         ids=["float32", "int8", "int8-per-channel"])
@pytest.mark.parametrize("name", mt.WORKLOADS)
def test_mlperf_tiny_matches_the_reference_interpret_lane(name, precision,
                                                          per_channel, lane):
    want, j_islands, j_segments, j_exps = _reference(name, precision,
                                                     per_channel)
    calib = ({"input": mt.sample_inputs(name, 128, seed=7)}
             if precision != "float32" else None)
    prog = MafiaCompiler(precision=precision, per_channel=per_channel,
                         exec_mode=lane, device="cpu").compile(
        mt.build(name), calib=calib)
    if lane == "megakernel_grid":
        mkp = prog.plan.megakernel
        assert (len(mkp.segments), mkp.n_islands) == (1, ISLANDS[name])
        assert (j_segments, j_islands) == (1, ISLANDS[name])
    got = _out(prog.batch(64, mode="vmap")(input=mt.sample_inputs(name, N_EVAL)))
    assert got.shape == want.shape and got.dtype == want.dtype
    if precision == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert prog.plan.output_exps == j_exps
        (e_out,) = j_exps.values()
        assert np.abs(got.astype(np.float64) - want).max() <= 2.0 ** -e_out


@pytest.mark.parametrize("precision,per_channel", PRECISIONS,
                         ids=["float32", "int8", "int8-per-channel"])
@pytest.mark.parametrize("name", mt.WORKLOADS)
def test_hybrid_lanes_agree(name, precision, per_channel):
    """Islands between megakernel segments on every lane: per-sample calls,
    ``map``, ``vmap`` (interpreted islands ``vmap``'d, the segment per
    sample) and the grid are bitwise on the int8 lanes; at float32
    per-sample == ``map`` bitwise and the grid within ``1e-5``."""
    calib = ({"input": mt.sample_inputs(name, 128, seed=7)}
             if precision != "float32" else None)
    progs = {lane: MafiaCompiler(precision=precision, per_channel=per_channel,
                                 exec_mode=lane, device="cpu").compile(
        mt.build(name), calib=calib) for lane in ("megakernel",
                                                   "megakernel_grid")}
    x = mt.sample_inputs(name, 8, seed=3)
    per = np.stack([_out(progs["megakernel"](input=xi)) for xi in x])
    lanes = {"map": _out(progs["megakernel"].batch(8, mode="map")(input=x)),
             "vmap": _out(progs["megakernel"].batch(8, mode="vmap")(input=x)),
             "grid": _out(progs["megakernel_grid"].batch(8)(input=x))}
    np.testing.assert_array_equal(lanes["map"], per)
    for lane in ("vmap", "grid"):
        if precision == "float32":
            np.testing.assert_allclose(lanes[lane], per, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(lanes[lane], per)
