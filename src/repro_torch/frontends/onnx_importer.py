"""ONNX frontend: lower an opset-13 subset to the canonical MAFIA DFG.

The importer reads a serialized ``ModelProto`` through the dependency-free
wire codec (:mod:`repro_torch.frontends.onnx_proto`), lowers each node to the
rank-polymorphic op registry (:mod:`repro_torch.core.node_types`), and returns a
per-sample :class:`~repro_torch.core.dfg.DFG` — the same IR the SeeDot and
TF-subset frontends produce, consumed unchanged by the rewrite pipeline,
quantizer, Best-PF optimizer and every execution lane.

Supported ops (defaults-domain, opset 13): ``Gemm``, ``MatMul``, ``Conv``,
``MaxPool``, ``AveragePool``, ``Relu``, ``Softmax``, ``Flatten``, ``Add``,
``Reshape``, ``BatchNormalization`` (folded into the producing conv, or
expanded to a per-element affine), plus ``Constant``/``Identity`` plumbing.
Anything else raises :class:`UnsupportedOnnxOp` naming the node and op.

Batch handling: ONNX graphs carry an explicit batch axis; the MAFIA DFG is
per-sample (batching is an execution-lane concern — vmap/map/serve).  The
importer strips a leading symbolic (``dim_param``) or size-1 batch axis
from every graph input and interprets ``Flatten``/``Reshape``/``Softmax``
axes relative to the remaining per-sample shape.

Shape inference routes through :mod:`repro_torch.core.shapes` — the same helper
the op registry's ``out_shape`` rules use — so the importer cannot accept
a graph the op layer would reject.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core import shapes as shp
from repro_torch.core.dfg import DFG
from repro_torch.frontends import onnx_proto as op_

__all__ = ["UnsupportedOnnxOp", "OnnxImportError", "load_onnx", "import_onnx"]


class OnnxImportError(ValueError):
    """Malformed or unsupported ONNX constructs (shape/attr level)."""


class UnsupportedOnnxOp(OnnxImportError):
    """An op outside the supported subset; names the node and op."""

    def __init__(self, node: op_.NodeP, detail: str | None = None) -> None:
        self.op_type = node.op_type
        self.node_name = node.name or "<unnamed>"
        msg = (f"unsupported ONNX op {node.op_type!r} "
               f"(node {self.node_name!r})")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def _sym(v: Any) -> bool:
    return not isinstance(v, int)


def _per_sample(shape: tuple[Any, ...], name: str) -> tuple[tuple[int, ...], bool]:
    """Strip the batch axis: leading symbolic or size-1 dim goes; everything
    left must be concrete.  Returns (per-sample shape, batch-axis stripped?)
    — axis attributes on downstream nodes count the stripped axis."""
    stripped = bool(shape) and (_sym(shape[0]) or shape[0] in (0, 1))
    if stripped:
        shape = shape[1:]
    if any(_sym(d) or int(d) <= 0 for d in shape):
        raise OnnxImportError(
            f"graph input {name!r}: per-sample shape {shape} has "
            f"symbolic/invalid dims (only the leading batch axis may be "
            f"symbolic)")
    return tuple(int(d) for d in shape), stripped


def _pair(node: op_.NodeP, attr: str, default: tuple[int, int]) -> tuple[int, int]:
    v = node.attrs.get(attr)
    if v is None:
        return default
    t = tuple(int(x) for x in v)
    if len(t) != 2:
        raise UnsupportedOnnxOp(node, f"{attr}={t} (2-D spatial ops only)")
    return t  # type: ignore[return-value]


def _sym_pads(node: op_.NodeP) -> tuple[int, int]:
    """ONNX pads = [h_begin, w_begin, h_end, w_end]; templates take one
    symmetric (ph, pw)."""
    if node.attrs.get("auto_pad", "NOTSET") not in ("NOTSET", ""):
        raise UnsupportedOnnxOp(
            node, f"auto_pad={node.attrs['auto_pad']!r} (explicit pads only)")
    pads = tuple(int(x) for x in node.attrs.get("pads", (0, 0, 0, 0)))
    if len(pads) != 4:
        raise UnsupportedOnnxOp(node, f"pads={pads} (2-D spatial ops only)")
    if pads[0] != pads[2] or pads[1] != pads[3]:
        raise UnsupportedOnnxOp(node, f"asymmetric pads {pads}")
    return pads[0], pads[1]


class _Importer:
    def __init__(self, model: op_.Model, name: str) -> None:
        self.model = model
        self.g = model.graph
        self.dfg = DFG(name or self.g.name or "onnx")
        self.consts: dict[str, np.ndarray] = dict(self.g.initializers)
        self.refs: dict[str, str] = {}        # ONNX value name → DFG ref
        self.producer: dict[str, op_.NodeP] = {}  # value name → producing node
        self.batch_offsets: set[int] = set()  # 1 per input that lost a batch axis

    # ------------------------------------------------------------- plumbing
    def shape_of(self, ref: str) -> tuple[int, ...]:
        if ref in self.dfg.graph_inputs:
            return self.dfg.graph_inputs[ref].shape
        return self.dfg.out_shape(ref)

    def dyn(self, node: op_.NodeP, vname: str) -> str:
        """DFG ref for a dynamic (non-initializer) ONNX value."""
        if vname in self.consts:
            # a static value where a dynamic one is needed: materialize it
            ref = self.dfg.add("const", value=np.asarray(
                self.consts[vname], np.float32))
            self.refs[vname] = ref
            del self.consts[vname]
            return ref
        if vname not in self.refs:
            raise OnnxImportError(
                f"node {node.name or node.op_type!r}: input {vname!r} is "
                f"not a graph input, initializer or prior node output")
        return self.refs[vname]

    def static(self, node: op_.NodeP, vname: str) -> np.ndarray:
        if vname not in self.consts:
            raise UnsupportedOnnxOp(
                node, f"input {vname!r} must be a static initializer")
        return np.asarray(self.consts[vname])

    # -------------------------------------------------------------- lowering
    def run(self) -> DFG:
        if self.model.opset and not (7 <= self.model.opset <= 21):
            raise OnnxImportError(
                f"unsupported default-domain opset {self.model.opset} "
                f"(importer targets opset 13)")
        for name, shape in self.g.inputs.items():
            if name in self.consts:
                continue                       # initializer listed as input
            ps, stripped = _per_sample(shape, name)
            self.batch_offsets.add(1 if stripped else 0)
            self.refs[name] = self.dfg.add_input(name, ps)
        for node in self.g.nodes:
            fn = getattr(self, f"op_{node.op_type}", None)
            if fn is None:
                raise UnsupportedOnnxOp(node)
            fn(node)
            for out in node.outputs:
                self.producer[out] = node
        outs = []
        for out in self.g.outputs:
            if out in self.consts:
                self.refs[out] = self.dfg.add(
                    "const", value=np.asarray(self.consts[out], np.float32))
            if out not in self.refs:
                raise OnnxImportError(f"graph output {out!r} never produced")
            outs.append(self.refs[out])
        self.dfg.mark_output(*outs)
        return self.dfg

    def emit(self, node: op_.NodeP, op: str, inputs: list[str],
             **params: Any) -> str:
        try:
            ref = self.dfg.add(op, *inputs, **params)
        except (ValueError, shp.ShapeError) as e:
            raise OnnxImportError(
                f"node {node.name or node.op_type!r} ({node.op_type}): "
                f"{e}") from e
        self.refs[node.outputs[0]] = ref
        return ref

    # --------------------------------------------------------- op handlers
    def op_Constant(self, node: op_.NodeP) -> None:
        val = node.attrs.get("value")
        if val is None:
            raise UnsupportedOnnxOp(node, "only the `value` attribute form")
        self.consts[node.outputs[0]] = np.asarray(val)

    def op_Identity(self, node: op_.NodeP) -> None:
        src = node.inputs[0]
        if src in self.consts:
            self.consts[node.outputs[0]] = self.consts[src]
        else:
            self.refs[node.outputs[0]] = self.dyn(node, src)

    def op_Gemm(self, node: op_.NodeP) -> None:
        alpha = float(node.attrs.get("alpha", 1.0))
        beta = float(node.attrs.get("beta", 1.0))
        if int(node.attrs.get("transA", 0)):
            raise UnsupportedOnnxOp(node, "transA=1")
        x = self.dyn(node, node.inputs[0])
        w = self.static(node, node.inputs[1]).astype(np.float32)
        if w.ndim != 2:
            raise UnsupportedOnnxOp(node, f"B must be 2-D, got {w.shape}")
        if not int(node.attrs.get("transB", 0)):
            w = w.T                           # Y = x @ B → (B.T) @ x
        mat = np.ascontiguousarray(alpha * w)
        params: dict[str, Any] = {"matrix": mat}
        if len(node.inputs) > 2 and node.inputs[2]:
            c = self.static(node, node.inputs[2]).astype(np.float32).ravel()
            if c.shape != (mat.shape[0],):
                raise UnsupportedOnnxOp(
                    node, f"C shape {c.shape} vs ({mat.shape[0]},)")
            params["bias"] = beta * c
        self.emit(node, "gemv", [x], **params)

    def op_MatMul(self, node: op_.NodeP) -> None:
        a_name, b_name = node.inputs[0], node.inputs[1]
        if b_name in self.consts and a_name not in self.consts:
            x = self.dyn(node, a_name)
            b = self.static(node, b_name).astype(np.float32)
            if b.ndim != 2:
                raise UnsupportedOnnxOp(node, f"B must be 2-D, got {b.shape}")
            if not shp.is_vector_like(self.shape_of(x)):
                raise UnsupportedOnnxOp(
                    node, f"A per-sample shape {self.shape_of(x)} is not a "
                    f"vector (only vector @ weight MatMuls)")
            self.emit(node, "gemv", [x],
                      matrix=np.ascontiguousarray(b.T))
            return
        a = self.dyn(node, a_name)
        b_ref = self.dyn(node, b_name)
        self.emit(node, "matmul", [a, b_ref])

    def op_Conv(self, node: op_.NodeP) -> None:
        if int(node.attrs.get("group", 1)) != 1:
            raise UnsupportedOnnxOp(node, f"group={node.attrs['group']}")
        if tuple(node.attrs.get("dilations", (1, 1))) != (1, 1):
            raise UnsupportedOnnxOp(
                node, f"dilations={node.attrs['dilations']}")
        x = self.dyn(node, node.inputs[0])
        k = self.static(node, node.inputs[1]).astype(np.float32)
        if k.ndim != 4:
            raise UnsupportedOnnxOp(node, f"kernel must be 4-D, got {k.shape}")
        params: dict[str, Any] = {
            "kernel": k,
            "stride": _pair(node, "strides", (1, 1)),
            "padding": _sym_pads(node),
        }
        if len(node.inputs) > 2 and node.inputs[2]:
            params["bias"] = self.static(
                node, node.inputs[2]).astype(np.float32).ravel()
        self.emit(node, "conv2d", [x], **params)

    def _pool(self, node: op_.NodeP, op: str) -> None:
        ksize = _pair(node, "kernel_shape", (0, 0))
        if ksize == (0, 0):
            raise UnsupportedOnnxOp(node, "kernel_shape is required")
        if int(node.attrs.get("ceil_mode", 0)):
            raise UnsupportedOnnxOp(node, "ceil_mode=1 (floor windows only)")
        padding = _sym_pads(node)
        if (op == "avgpool2d" and padding != (0, 0)
                and not int(node.attrs.get("count_include_pad", 0))):
            raise UnsupportedOnnxOp(
                node, "padded AveragePool with count_include_pad=0")
        x = self.dyn(node, node.inputs[0])
        self.emit(node, op, [x], ksize=ksize,
                  stride=_pair(node, "strides", ksize), padding=padding)

    def op_MaxPool(self, node: op_.NodeP) -> None:
        if tuple(int(d) for d in node.attrs.get("dilations", (1, 1))) != (1, 1):
            raise UnsupportedOnnxOp(
                node, f"dilations={tuple(node.attrs['dilations'])}")
        if int(node.attrs.get("storage_order", 0)):
            raise UnsupportedOnnxOp(node, "storage_order=1")
        if len(node.outputs) > 1 and node.outputs[1]:
            raise UnsupportedOnnxOp(node, "Indices output")
        self._pool(node, "maxpool2d")

    def op_AveragePool(self, node: op_.NodeP) -> None:
        self._pool(node, "avgpool2d")

    def op_Relu(self, node: op_.NodeP) -> None:
        self.emit(node, "relu", [self.dyn(node, node.inputs[0])])

    def op_Clip(self, node: op_.NodeP) -> None:
        lo = hi = None
        if len(node.inputs) > 1 and node.inputs[1]:
            lo = float(self.static(node, node.inputs[1]))
        if len(node.inputs) > 2 and node.inputs[2]:
            hi = float(self.static(node, node.inputs[2]))
        if (lo, hi) != (0.0, 6.0):
            raise UnsupportedOnnxOp(node, f"Clip({lo}, {hi}) — only relu6")
        self.emit(node, "relu6", [self.dyn(node, node.inputs[0])])

    def op_Softmax(self, node: op_.NodeP) -> None:
        x = self.dyn(node, node.inputs[0])
        rank = len(self.shape_of(x))
        axis = int(node.attrs.get("axis", -1))
        # ONNX axes count the stripped batch dim: the full-rank tensor has
        # rank + batch_offset axes, so "last" is spelled -1 or
        # rank - 1 + batch_offset.  Anything else (e.g. axis=rank-1 on a
        # batched rank>=2 per-sample tensor, or axis=0 naming the batch
        # axis itself) is NOT the last axis and must not silently lower.
        accepted = {-1}
        if len(self.batch_offsets) == 1:
            (off,) = self.batch_offsets
            accepted.add(rank - 1 + off)
        if axis not in accepted:
            raise UnsupportedOnnxOp(node, f"axis={axis} (last axis only)")
        self.emit(node, "softmax", [x])

    def op_Flatten(self, node: op_.NodeP) -> None:
        axis = int(node.attrs.get("axis", 1))
        if axis not in (0, 1):
            raise UnsupportedOnnxOp(
                node, f"axis={axis} (per-sample flatten is axis 0/1)")
        self.emit(node, "flatten", [self.dyn(node, node.inputs[0])])

    def op_Reshape(self, node: op_.NodeP) -> None:
        x = self.dyn(node, node.inputs[0])
        tgt = [int(v) for v in self.static(node, node.inputs[1]).ravel()]
        # drop the batch slot (leading -1/0/1): the DFG is per-sample
        if len(tgt) > 1 and tgt[0] in (-1, 0, 1):
            tgt = tgt[1:]
        in_shape = self.shape_of(x)
        # ONNX 0 = "copy the input dim at this position" (per-sample here)
        for i, v in enumerate(tgt):
            if v == 0:
                if i >= len(in_shape):
                    raise OnnxImportError(
                        f"node {node.name!r}: Reshape dim 0 at position {i} "
                        f"has no matching input dim in {in_shape}")
                tgt[i] = int(in_shape[i])
        self.emit(node, "reshape", [x], shape=tuple(tgt))

    def op_Add(self, node: op_.NodeP) -> None:
        a_name, b_name = node.inputs[0], node.inputs[1]
        stat = [n for n in (a_name, b_name) if n in self.consts]
        if len(stat) == 1:
            dyn_name = b_name if stat[0] == a_name else a_name
            x = self.dyn(node, dyn_name)
            v = self.static(node, stat[0]).astype(np.float32)
            xs = self.shape_of(x)
            if v.shape != xs:
                if v.size == shp.numel(xs):
                    v = v.reshape(xs)      # e.g. (1, n) bias vs (n,) value
                else:
                    raise UnsupportedOnnxOp(
                        node, f"Add operand {v.shape} does not match {xs} "
                        f"(no implicit broadcasting)")
            self.emit(node, "add", [x], vec=v)
            return
        a = self.dyn(node, a_name)
        b = self.dyn(node, b_name)
        self.emit(node, "add", [a, b])

    def op_BatchNormalization(self, node: op_.NodeP) -> None:
        x_name = node.inputs[0]
        scale = self.static(node, node.inputs[1]).astype(np.float64).ravel()
        b = self.static(node, node.inputs[2]).astype(np.float64).ravel()
        mean = self.static(node, node.inputs[3]).astype(np.float64).ravel()
        var = self.static(node, node.inputs[4]).astype(np.float64).ravel()
        eps = float(node.attrs.get("epsilon", 1e-5))
        a = scale / np.sqrt(var + eps)         # y = a·x + c, per channel
        c = b - mean * a
        prod = self.producer.get(x_name)
        ref = self.refs.get(x_name)
        # Folding rewrites the conv in place, so it is only legal when this
        # BatchNorm is the SOLE consumer of the conv output.  ONNX nodes are
        # topologically sorted, so later consumers (e.g. a residual Add) are
        # not in the DFG yet — count consumers across the whole graph, not
        # just already-imported successors.
        n_consumers = sum(n.inputs.count(x_name) for n in self.g.nodes)
        if (prod is not None and prod.op_type == "Conv" and ref is not None
                and n_consumers == 1
                and not self.dfg.successors(ref)
                and x_name not in self.g.outputs):
            # fold into the producing conv (the standard inference-time
            # rewrite): K'[o] = a[o]·K[o], bias' = a·bias + c
            from repro_torch.core import node_types

            cnode = self.dfg.nodes[ref]
            k = np.asarray(cnode.params["kernel"], np.float64)
            if k.shape[0] != a.shape[0]:
                raise OnnxImportError(
                    f"node {node.name!r}: BatchNorm over {a.shape[0]} "
                    f"channels, conv has {k.shape[0]}")
            cnode.params["kernel"] = (k * a[:, None, None, None]).astype(
                np.float32)
            bias = np.asarray(cnode.params.get("bias",
                                               np.zeros(k.shape[0])),
                              np.float64)
            cnode.params["bias"] = (a * bias + c).astype(np.float32)
            # the fold may add a bias the original conv lacked
            cnode.dims = node_types.get("conv2d").infer_dims(self.dfg, cnode)
            self.refs[node.outputs[0]] = ref
            return
        # standalone affine: per-channel over (C, ...) — expand to the full
        # tensor shape (the elementwise templates stream equal shapes)
        x = self.dyn(node, x_name)
        xs = self.shape_of(x)
        if not xs or xs[0] != a.shape[0]:
            raise UnsupportedOnnxOp(
                node, f"BatchNorm over first axis of {xs} "
                f"({a.shape[0]} channels)")
        bshape = (a.shape[0],) + (1,) * (len(xs) - 1)
        av = np.broadcast_to(a.reshape(bshape), xs).astype(np.float32)
        cv = np.broadcast_to(c.reshape(bshape), xs).astype(np.float32)
        h = self.emit(node, "hadamard", [x], vec=np.ascontiguousarray(av))
        self.refs[node.outputs[0]] = self.dfg.add(
            "add", h, vec=np.ascontiguousarray(cv))


def import_onnx(data: bytes, *, name: str = "") -> DFG:
    """Lower serialized ModelProto bytes to a per-sample MAFIA DFG."""
    return _Importer(op_.decode_model(data), name).run()


def load_onnx(path: Any, *, name: str = "") -> DFG:
    """Lower an ``.onnx`` file to a per-sample MAFIA DFG."""
    with open(path, "rb") as f:
        data = f.read()
    import os

    return import_onnx(
        data, name=name or os.path.splitext(os.path.basename(path))[0])
