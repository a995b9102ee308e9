"""Minimal ONNX protobuf wire codec — reader and writer, no deps.

The toolchain image does not ship the ``onnx`` package (and pulling it in
for one frontend would drag in protobuf), so this module speaks the
protobuf *wire format* directly for the small slice of ``onnx.proto`` the
importer needs: ``ModelProto → GraphProto → {NodeProto, TensorProto,
ValueInfoProto}``.  The wire format is stable by design (field numbers are
the protocol), which makes a hand-rolled codec safe: unknown fields are
skipped structurally, exactly as real protobuf parsers do.

Two layers:

* the generic wire layer — varints, tags, length-delimited fields
  (:func:`parse_message`, :class:`MessageBuilder`);
* the ONNX layer — typed views of the messages the importer consumes
  (:class:`Model`, :class:`Graph`, :class:`NodeP`, tensor ↔ numpy).

Writer support exists so the MLPerf-Tiny fixture generator can emit real
``.onnx`` files without the package either; files it writes round-trip
through ``onnx.load`` (field numbers and wire types follow onnx.proto).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Iterator

import numpy as np

__all__ = [
    "parse_message", "MessageBuilder", "Model", "Graph", "NodeP",
    "decode_model", "tensor_to_np", "np_to_tensor", "build_model",
    "make_node", "value_info",
]

# onnx.proto TensorProto.DataType → numpy (little-endian on the wire)
_DTYPES = {
    1: np.dtype("<f4"),    # FLOAT
    3: np.dtype("i1"),     # INT8
    6: np.dtype("<i4"),    # INT32
    7: np.dtype("<i8"),    # INT64
    11: np.dtype("<f8"),   # DOUBLE
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


# ============================================================== wire layer
def _uvarint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _svarint(v: int) -> int:
    """Interpret a wire varint as a signed int64 (two's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_message(buf: bytes | memoryview) -> dict[int, list[tuple[int, Any]]]:
    """Parse one message into ``{field: [(wire_type, value), ...]}``.

    Values: wire 0 → int (raw varint), wire 1 → 8 raw bytes, wire 2 →
    ``memoryview`` payload, wire 5 → 4 raw bytes.  Unknown fields are kept
    (callers just don't look at them); unknown wire types raise.
    """
    buf = memoryview(buf)
    out: dict[int, list[tuple[int, Any]]] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _uvarint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _uvarint(buf, pos)
            val: Any = v
        elif wire == 1:
            val, pos = bytes(buf[pos:pos + 8]), pos + 8
        elif wire == 2:
            n, pos = _uvarint(buf, pos)
            if pos + n > len(buf):
                raise ValueError(f"truncated field {field}")
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            val, pos = bytes(buf[pos:pos + 4]), pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        out.setdefault(field, []).append((wire, val))
    return out


def _first(msg: dict, field: int, default: Any = None) -> Any:
    vs = msg.get(field)
    return vs[0][1] if vs else default


def _all(msg: dict, field: int) -> Iterator[Any]:
    for _, v in msg.get(field, ()):
        yield v


class MessageBuilder:
    """Append-only protobuf message writer."""

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    @staticmethod
    def _varint(v: int) -> bytes:
        if v < 0:
            v += 1 << 64                   # int64 two's complement
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    def _tag(self, field: int, wire: int) -> None:
        self._parts.append(self._varint((field << 3) | wire))

    def int(self, field: int, v: int) -> "MessageBuilder":
        self._tag(field, 0)
        self._parts.append(self._varint(int(v)))
        return self

    def float32(self, field: int, v: float) -> "MessageBuilder":
        self._tag(field, 5)
        self._parts.append(struct.pack("<f", float(v)))
        return self

    def bytes_(self, field: int, b: bytes) -> "MessageBuilder":
        self._tag(field, 2)
        self._parts.append(self._varint(len(b)))
        self._parts.append(bytes(b))
        return self

    def string(self, field: int, s: str) -> "MessageBuilder":
        return self.bytes_(field, s.encode("utf-8"))

    def message(self, field: int, m: "MessageBuilder") -> "MessageBuilder":
        return self.bytes_(field, m.to_bytes())

    def to_bytes(self) -> bytes:
        return b"".join(self._parts)


# ============================================================== ONNX layer
@dataclasses.dataclass(frozen=True)
class NodeP:
    """One GraphProto.node, decoded."""

    op_type: str
    name: str
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    attrs: dict[str, Any]              # name → int | float | str | np.ndarray
                                       #        | tuple[int, ...] | tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class Graph:
    name: str
    nodes: tuple[NodeP, ...]
    initializers: dict[str, np.ndarray]
    inputs: dict[str, tuple[Any, ...]]   # name → shape (int, or str dim_param)
    outputs: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Model:
    graph: Graph
    opset: int                           # default-domain opset version
    ir_version: int
    producer: str


def tensor_to_np(buf: bytes | memoryview) -> tuple[str, np.ndarray]:
    """Decode a TensorProto to ``(name, array)``.  Accepts ``raw_data`` and
    the typed repeated fields (packed or not)."""
    msg = parse_message(buf)
    dims = tuple(int(v) for v in _all(msg, 1))
    code = int(_first(msg, 2, 1))
    if code not in _DTYPES:
        raise ValueError(f"unsupported TensorProto data_type {code}")
    dt = _DTYPES[code]
    name = bytes(_first(msg, 8, b"")).decode("utf-8")
    raw = _first(msg, 9)
    if raw is not None:
        arr = np.frombuffer(bytes(raw), dtype=dt)
    else:
        # typed fields: float_data=4 (f4/f8 promote), int32_data=5,
        # int64_data=7 — packed (one wire-2 blob) or repeated scalars
        field = {np.dtype("<f4"): 4, np.dtype("<f8"): 10,
                 np.dtype("i1"): 5, np.dtype("<i4"): 5,
                 np.dtype("<i8"): 7}[dt]
        vals: list[Any] = []
        for wire, v in msg.get(field, ()):
            if wire == 2:                            # packed
                unit = np.dtype("<f4") if field == 4 else (
                    np.dtype("<f8") if field == 10 else
                    np.dtype("<i8") if field == 7 else None)
                if unit is not None:
                    vals.extend(np.frombuffer(bytes(v), dtype=unit).tolist())
                else:                                # packed varints (int32)
                    mv, p = memoryview(v), 0
                    while p < len(mv):
                        x, p = _uvarint(mv, p)
                        vals.append(_svarint(x))
            elif wire == 0:
                vals.append(_svarint(v))
            elif wire == 5:
                vals.append(struct.unpack("<f", v)[0])
            elif wire == 1:
                vals.append(struct.unpack("<d", v)[0])
        arr = np.asarray(vals, dtype=dt)
    return name, arr.reshape(dims) if dims else arr


def np_to_tensor(name: str, arr: np.ndarray) -> MessageBuilder:
    """Encode an array as a TensorProto (``raw_data``, little-endian)."""
    arr = np.asarray(arr)
    dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
    canon = {np.dtype(np.float32): np.dtype("<f4"),
             np.dtype(np.float64): np.dtype("<f8"),
             np.dtype(np.int8): np.dtype("i1"),
             np.dtype(np.int32): np.dtype("<i4"),
             np.dtype(np.int64): np.dtype("<i8")}.get(np.dtype(dt))
    if canon is None:
        raise ValueError(f"unsupported tensor dtype {arr.dtype}")
    t = MessageBuilder()
    for d in arr.shape:
        t.int(1, int(d))
    t.int(2, _DTYPE_CODES[canon])
    t.string(8, name)
    t.bytes_(9, np.ascontiguousarray(arr, canon).tobytes())
    return t


# AttributeProto.type enum
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_FLOATS, _ATTR_INTS = 6, 7


def _decode_attr(buf: memoryview) -> tuple[str, Any]:
    msg = parse_message(buf)
    name = bytes(_first(msg, 1, b"")).decode("utf-8")
    atype = int(_first(msg, 20, 0))
    if atype == _ATTR_FLOAT or (not atype and 2 in msg):
        return name, struct.unpack("<f", _first(msg, 2))[0]
    if atype == _ATTR_INT or (not atype and 3 in msg):
        return name, _svarint(int(_first(msg, 3)))
    if atype == _ATTR_STRING or (not atype and 4 in msg):
        return name, bytes(_first(msg, 4)).decode("utf-8")
    if atype == _ATTR_TENSOR or (not atype and 5 in msg):
        return name, tensor_to_np(_first(msg, 5))[1]
    if atype == _ATTR_FLOATS or (not atype and 7 in msg):
        vals: list[float] = []
        for wire, v in msg.get(7, ()):
            if wire == 2:
                vals.extend(np.frombuffer(bytes(v), "<f4").tolist())
            else:
                vals.append(struct.unpack("<f", v)[0])
        return name, tuple(vals)
    if atype == _ATTR_INTS or (not atype and 8 in msg):
        ivals: list[int] = []
        for wire, v in msg.get(8, ()):
            if wire == 2:
                mv, p = memoryview(v), 0
                while p < len(mv):
                    x, p = _uvarint(mv, p)
                    ivals.append(_svarint(x))
            else:
                ivals.append(_svarint(v))
        return name, tuple(ivals)
    return name, None                      # graphs/strings-lists: unused here


def _decode_node(buf: memoryview) -> NodeP:
    msg = parse_message(buf)
    return NodeP(
        op_type=bytes(_first(msg, 4, b"")).decode("utf-8"),
        name=bytes(_first(msg, 3, b"")).decode("utf-8"),
        inputs=tuple(bytes(v).decode("utf-8") for v in _all(msg, 1)),
        outputs=tuple(bytes(v).decode("utf-8") for v in _all(msg, 2)),
        attrs=dict(_decode_attr(v) for v in _all(msg, 5)),
    )


def _decode_value_info(buf: memoryview) -> tuple[str, tuple[Any, ...]]:
    msg = parse_message(buf)
    name = bytes(_first(msg, 1, b"")).decode("utf-8")
    shape: list[Any] = []
    tp = _first(msg, 2)
    if tp is not None:
        tt = _first(parse_message(tp), 1)            # TypeProto.tensor_type
        if tt is not None:
            sh = _first(parse_message(tt), 2)        # Tensor.shape
            if sh is not None:
                for dim in _all(parse_message(sh), 1):
                    d = parse_message(dim)
                    if 1 in d:                       # dim_value
                        shape.append(int(_first(d, 1)))
                    elif 2 in d:                     # dim_param (symbolic)
                        shape.append(bytes(_first(d, 2)).decode("utf-8"))
                    else:
                        shape.append(None)
    return name, tuple(shape)


def decode_model(data: bytes) -> Model:
    """Decode a serialized ModelProto into the typed views above."""
    msg = parse_message(data)
    opset = 0
    for os_ in _all(msg, 8):                         # opset_import
        m = parse_message(os_)
        domain = bytes(_first(m, 1, b"")).decode("utf-8")
        if domain in ("", "ai.onnx"):
            opset = _svarint(int(_first(m, 2, 0)))
    gbuf = _first(msg, 7)
    if gbuf is None:
        raise ValueError("ModelProto has no graph")
    g = parse_message(gbuf)
    inits: dict[str, np.ndarray] = {}
    for t in _all(g, 5):
        name, arr = tensor_to_np(t)
        inits[name] = arr
    graph = Graph(
        name=bytes(_first(g, 2, b"")).decode("utf-8"),
        nodes=tuple(_decode_node(v) for v in _all(g, 1)),
        initializers=inits,
        inputs=dict(_decode_value_info(v) for v in _all(g, 11)),
        outputs=tuple(_decode_value_info(v)[0] for v in _all(g, 12)),
    )
    return Model(
        graph=graph,
        opset=opset,
        ir_version=_svarint(int(_first(msg, 1, 0))),
        producer=bytes(_first(msg, 2, b"")).decode("utf-8"),
    )


# ------------------------------------------------------------------ writer
def _attr(name: str, value: Any) -> MessageBuilder:
    a = MessageBuilder()
    a.string(1, name)
    if isinstance(value, bool):
        raise TypeError("use int for ONNX attributes")
    if isinstance(value, int):
        a.int(3, value).int(20, _ATTR_INT)
    elif isinstance(value, float):
        a.float32(2, value).int(20, _ATTR_FLOAT)
    elif isinstance(value, str):
        a.bytes_(4, value.encode("utf-8")).int(20, _ATTR_STRING)
    elif isinstance(value, np.ndarray):
        a.message(5, np_to_tensor(name + "_value", value)).int(20, _ATTR_TENSOR)
    elif isinstance(value, (tuple, list)):
        if all(isinstance(v, int) for v in value):
            for v in value:
                a.int(8, v)
            a.int(20, _ATTR_INTS)
        else:
            for v in value:
                a.float32(7, float(v))
            a.int(20, _ATTR_FLOATS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return a


def make_node(op_type: str, inputs: list[str], outputs: list[str],
              name: str = "", **attrs: Any) -> MessageBuilder:
    n = MessageBuilder()
    for i in inputs:
        n.string(1, i)
    for o in outputs:
        n.string(2, o)
    if name:
        n.string(3, name)
    n.string(4, op_type)
    for k, v in attrs.items():
        n.message(5, _attr(k, v))
    return n


def value_info(name: str, shape: tuple[Any, ...],
               elem_type: int = 1) -> MessageBuilder:
    """ValueInfoProto for a float tensor; str/None dims become dim_params."""
    sh = MessageBuilder()
    for d in shape:
        dim = MessageBuilder()
        if isinstance(d, str):
            dim.string(2, d)
        else:
            dim.int(1, int(d))
        sh.message(1, dim)
    tensor = MessageBuilder().int(1, elem_type).message(2, sh)
    tp = MessageBuilder().message(1, tensor)
    return MessageBuilder().string(1, name).message(2, tp)


def build_model(
    *,
    graph_name: str,
    nodes: list[MessageBuilder],
    inputs: list[MessageBuilder],
    outputs: list[MessageBuilder],
    initializers: list[MessageBuilder],
    opset: int = 13,
    producer: str = "mafia-repro",
) -> bytes:
    g = MessageBuilder()
    for n in nodes:
        g.message(1, n)
    g.string(2, graph_name)
    for t in initializers:
        g.message(5, t)
    for vi in inputs:
        g.message(11, vi)
    for vi in outputs:
        g.message(12, vi)
    m = MessageBuilder()
    m.int(1, 8)                                      # ir_version
    m.string(2, producer)
    m.message(7, g)
    m.message(8, MessageBuilder().string(1, "").int(2, opset))
    return m.to_bytes()
