"""TensorFlow-subset frontend (paper §III-A).

The paper supports "a subset of TensorFlow by converting the Tensorflow
program to SEEDOT and extracting the DFG".  We mirror that: a tiny tracing
API with TF-style op names; tracing a python function over symbolic tensors
emits mini-SeeDot source, which the SeeDot frontend then compiles to the DFG
— the exact two-hop path the paper describes.

Usage::

    import repro_torch.frontends.tf_subset as tf

    def program(x):
        z = tf.sparse_matmul_vec(W, x)          # SpMV
        s = tf.tanh(tf.scale(tf.matmul_vec(Theta, z), 0.5))
        return tf.argmax(tf.matmul_vec(Zs, tf.exp(tf.scale(s, -1.0))))

    dfg = tf.trace(program, inputs={"x": (256,)}, params={"W": W, ...})
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import numpy as np

from repro_torch.core import shapes as shp
from repro_torch.core.dfg import DFG
from repro_torch.frontends import seedot

__all__ = [
    "Sym", "trace", "matmul_vec", "sparse_matmul_vec", "matmul", "add", "sub",
    "multiply", "scale", "tanh", "sigmoid", "relu", "exp", "argmax",
    "reduce_sum", "dot", "outer", "squared_distance",
]


@dataclasses.dataclass(frozen=True)
class Sym:
    """A symbolic tensor: a name bound in the emitted SeeDot program."""

    expr: str

    # arithmetic sugar so traced programs read like TF/numpy
    def __add__(self, other: "Sym") -> "Sym":
        return _emit(f"{self.expr} + {_ref(other)}")

    def __sub__(self, other: "Sym") -> "Sym":
        return _emit(f"{self.expr} - {_ref(other)}")

    def __mul__(self, other: Any) -> "Sym":
        if isinstance(other, (int, float)):
            return _emit(f"{self.expr} .* {float(other)}")
        return _emit(f"{self.expr} <*> {_ref(other)}")

    __rmul__ = __mul__


class _TraceCtx(threading.local):
    def __init__(self) -> None:
        self.lines: list[str] | None = None
        self.params: dict[str, np.ndarray] | None = None
        self.counter = 0


_CTX = _TraceCtx()


def _ref(v: Any) -> str:
    if isinstance(v, Sym):
        return v.expr
    raise TypeError(f"expected a traced tensor, got {type(v)!r}")


def _param_name(arr: Any) -> str:
    """Register a parameter array under a stable generated name."""
    assert _CTX.params is not None
    for name, known in _CTX.params.items():
        if known is arr:
            return name
    name = f"p{len(_CTX.params)}"
    _CTX.params[name] = np.asarray(arr)
    return name


def _emit(expr: str) -> Sym:
    assert _CTX.lines is not None
    _CTX.counter += 1
    name = f"t{_CTX.counter}"
    _CTX.lines.append(f"let {name} = {expr} in")
    return Sym(name)


def _check_matrix(arr: Any, fn: str) -> None:
    """Trace-time operand check through the shared shape vocabulary: a
    malformed weight array fails here, at the call site, with the same
    :class:`~repro_torch.core.shapes.ShapeError` the op layer would raise —
    not three hops later inside the emitted SeeDot program."""
    shape = np.asarray(arr).shape
    if len(shape) != 2:
        raise shp.ShapeError(f"{fn}: weights must be 2-D, got {shape}")


# ------------------------------------------------------------------ op surface
def matmul_vec(w: Any, x: Sym) -> Sym:
    _check_matrix(w, "matmul_vec")
    return _emit(f"{_param_name(w)} * {_ref(x)}")


def sparse_matmul_vec(w: Any, x: Sym) -> Sym:
    _check_matrix(w, "sparse_matmul_vec")
    return _emit(f"{_param_name(w)} |*| {_ref(x)}")


def matmul(a: Sym, b: Sym) -> Sym:
    return _emit(f"{_ref(a)} * {_ref(b)}")


def add(a: Sym, b: Any) -> Sym:
    if isinstance(b, Sym):
        return _emit(f"{_ref(a)} + {_ref(b)}")
    return _emit(f"{_ref(a)} + {_param_name(b)}")


def sub(a: Sym, b: Any) -> Sym:
    if isinstance(b, Sym):
        return _emit(f"{_ref(a)} - {_ref(b)}")
    return _emit(f"{_ref(a)} - {_param_name(b)}")


def multiply(a: Sym, b: Sym) -> Sym:
    return _emit(f"{_ref(a)} <*> {_ref(b)}")


def scale(a: Sym, s: float) -> Sym:
    return _emit(f"{_ref(a)} .* {float(s)}")


def _fn1(name: str) -> Callable[[Sym], Sym]:
    def f(a: Sym) -> Sym:
        return _emit(f"{name}({_ref(a)})")

    f.__name__ = name
    return f


tanh = _fn1("tanh")
sigmoid = _fn1("sigmoid")
relu = _fn1("relu")
exp = _fn1("exp")
argmax = _fn1("argmax")
reduce_sum = _fn1("reduce_sum")


def dot(a: Sym, b: Sym) -> Sym:
    return _emit(f"dot({_ref(a)}, {_ref(b)})")


def outer(a: Sym, b: Sym) -> Sym:
    return _emit(f"outer({_ref(a)}, {_ref(b)})")


def squared_distance(x: Sym, points: Any) -> Sym:
    _check_matrix(points, "squared_distance")
    return _emit(f"sq_l2({_ref(x)}, {_param_name(points)})")


# ---------------------------------------------------------------------- tracer
def trace(
    fn: Callable[..., Sym],
    *,
    inputs: dict[str, tuple[int, ...]],
    name: str = "tf_program",
) -> DFG:
    """Trace ``fn`` (taking one Sym per declared input) into a DFG via SeeDot."""
    if _CTX.lines is not None:
        raise RuntimeError("nested tf_subset.trace is not supported")
    _CTX.lines, _CTX.params, _CTX.counter = [], {}, 0
    try:
        out = fn(*[Sym(n) for n in inputs])
        if not isinstance(out, Sym):
            raise TypeError("traced function must return a traced tensor")
        src = "\n".join([*_CTX.lines, out.expr])
        return seedot.parse(src, inputs=inputs, params=_CTX.params, name=name)
    finally:
        _CTX.lines, _CTX.params, _CTX.counter = None, None, 0
