"""Mini-SeeDot frontend (paper §III-A, §IV-C).

The paper's DFG generator consumes the SeeDot DSL (Gopinath et al., PLDI'19).
This module implements a small but faithful subset: ``let``-bound matrix
expressions over declared inputs and named model parameters, compiled
directly to the MAFIA matrix DFG.

Grammar (recursive descent)::

    program  := {letstmt} expr
    letstmt  := "let" NAME "=" expr "in"
    expr     := term {("+" | "-") term}
    term     := unary {("*" | "|*|" | "<*>" | ".*") unary}
    unary    := NAME "(" expr {"," expr} ")"   -- exp/tanh/sigmoid/relu/argmax/
                                                  dot/reduce_sum/sq_l2/outer
              | "(" expr ")"
              | NUMBER
              | NAME                            -- input, param, or let binding

Operator mapping (shape-directed, like SeeDot's type-directed lowering):
    ``a * b``    dense product   — gemv if one side is a param matrix and the
                                   other a vector; matmul if both are 2-D.
    ``a |*| b``  sparse product  — spmv (param matrix stored dense-with-zeros).
    ``a <*> b``  hadamard.
    ``a .* b``   scalar multiply (one side a literal or scalar param).
    ``a + b``, ``a - b``  elementwise add/sub (vec param folded as template arg).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np

from repro_torch.core import shapes as shp
from repro_torch.core.dfg import DFG

__all__ = ["parse", "SeeDotError"]


class SeeDotError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>-?\d+(?:\.\d+)?(?:e-?\d+)?)|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>\|\*\||<\*>|\.\*|[-+*(),=]))"
)

_FUNCS1 = {"exp", "tanh", "sigmoid", "relu", "argmax", "reduce_sum"}
_FUNCS2 = {"dot", "outer", "sq_l2"}


def _tokenize(src: str) -> list[tuple[str, str]]:
    toks: list[tuple[str, str]] = []
    pos = 0
    src = re.sub(r"#[^\n]*", "", src)  # comments
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m or m.end() == pos:
            if src[pos:].strip():
                raise SeeDotError(f"bad token at: {src[pos:pos+20]!r}")
            break
        pos = m.end()
        if m.group("num"):
            toks.append(("num", m.group("num")))
        elif m.group("name"):
            toks.append(("name", m.group("name")))
        else:
            toks.append(("op", m.group("op")))
    return toks


@dataclasses.dataclass
class _Val:
    """An expression value during lowering: a DFG node/input ref, a scalar
    literal, or a named parameter array (not yet materialized as a node)."""

    kind: str  # "ref" | "scalar" | "param"
    ref: str | None = None
    scalar: float | None = None
    param_name: str | None = None
    param: Any = None


class _Parser:
    def __init__(self, toks: list[tuple[str, str]], g: DFG, params: dict[str, np.ndarray],
                 sparse_params: set[str]) -> None:
        self.toks = toks
        self.i = 0
        self.g = g
        self.params = params
        self.sparse = sparse_params
        self.env: dict[str, _Val] = {}

    # ------------------------------------------------------------- token ops
    def peek(self) -> tuple[str, str] | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> tuple[str, str]:
        t = self.peek()
        if t is None:
            raise SeeDotError("unexpected end of program")
        self.i += 1
        return t

    def expect(self, kind: str, val: str | None = None) -> str:
        k, v = self.next()
        if k != kind or (val is not None and v != val):
            raise SeeDotError(f"expected {val or kind}, got {v!r}")
        return v

    # ------------------------------------------------------------ production
    def program(self) -> _Val:
        while self.peek() == ("name", "let"):
            self.next()
            name = self.expect("name")
            self.expect("op", "=")
            val = self.expr()
            self.expect("name", "in")
            self.env[name] = val
        out = self.expr()
        if self.peek() is not None:
            raise SeeDotError(f"trailing tokens: {self.toks[self.i:]}")
        return out

    def expr(self) -> _Val:
        left = self.term()
        while self.peek() in (("op", "+"), ("op", "-")):
            op = self.next()[1]
            right = self.term()
            left = self._binary("add" if op == "+" else "sub", left, right)
        return left

    def term(self) -> _Val:
        left = self.unary()
        while self.peek() in (("op", "*"), ("op", "|*|"), ("op", "<*>"), ("op", ".*")):
            op = self.next()[1]
            right = self.unary()
            if op == "*":
                left = self._product(left, right, sparse=False)
            elif op == "|*|":
                left = self._product(left, right, sparse=True)
            elif op == "<*>":
                left = self._binary("hadamard", left, right)
            else:  # .*
                left = self._scalar_mul(left, right)
        return left

    def unary(self) -> _Val:
        k, v = self.next()
        if k == "num":
            return _Val("scalar", scalar=float(v))
        if (k, v) == ("op", "("):
            e = self.expr()
            self.expect("op", ")")
            return e
        if k != "name":
            raise SeeDotError(f"unexpected {v!r}")
        if v in _FUNCS1 or v in _FUNCS2:
            self.expect("op", "(")
            args = [self.expr()]
            while self.peek() == ("op", ","):
                self.next()
                args.append(self.expr())
            self.expect("op", ")")
            return self._call(v, args)
        if v in self.env:
            return self.env[v]
        if v in self.g.graph_inputs or v in self.g.nodes:
            return _Val("ref", ref=v)
        if v in self.params:
            return _Val("param", param_name=v, param=self.params[v])
        raise SeeDotError(f"unknown name {v!r}")

    # -------------------------------------------------------------- lowering
    def _shape_of(self, ref: str) -> tuple[int, ...]:
        """Shape of a data ref — a graph input's declared shape or a node's
        inferred output shape (both ultimately derived through
        :mod:`repro_torch.core.shapes`)."""
        if ref in self.g.graph_inputs:
            return tuple(self.g.graph_inputs[ref].shape)
        return tuple(self.g.out_shape(ref))

    def _check(self, derive, *args, context: str):
        """Run one shared shape-inference rule, rewording its
        :class:`~repro_torch.core.shapes.ShapeError` as a frontend error."""
        try:
            return derive(*args)
        except shp.ShapeError as exc:
            raise SeeDotError(f"{context}: {exc}") from None

    def _as_ref(self, v: _Val) -> str:
        if v.kind == "ref":
            assert v.ref is not None
            return v.ref
        raise SeeDotError(
            f"parameter/scalar used where a data value is required "
            f"({v.param_name or v.scalar!r}); parameters may appear only as the "
            f"matrix side of '*', '|*|', '+', '-', 'sq_l2'"
        )

    def _call(self, fn: str, args: list[_Val]) -> _Val:
        if fn == "sq_l2":
            if len(args) != 2 or args[1].kind != "param":
                raise SeeDotError("sq_l2(x, Points) needs a param as 2nd arg")
            nid = self.g.add("sq_l2", self._as_ref(args[0]),
                             points=np.asarray(args[1].param, dtype=np.float32))
            return _Val("ref", ref=nid)
        if fn in _FUNCS2:
            if len(args) != 2:
                raise SeeDotError(f"{fn} takes 2 args")
            nid = self.g.add(fn, self._as_ref(args[0]), self._as_ref(args[1]))
            return _Val("ref", ref=nid)
        if len(args) != 1:
            raise SeeDotError(f"{fn} takes 1 arg")
        nid = self.g.add(fn, self._as_ref(args[0]))
        return _Val("ref", ref=nid)

    def _product(self, a: _Val, b: _Val, *, sparse: bool) -> _Val:
        op = "spmv" if sparse else "gemv"
        if a.kind == "param":
            w = np.asarray(a.param, dtype=np.float32)
            if w.ndim != 2:
                raise SeeDotError(f"matrix param {a.param_name!r} must be 2-D")
            xr = self._as_ref(b)
            self._check(shp.matvec_out, w.shape, self._shape_of(xr),
                        context=f"{a.param_name} * ...")
            nid = self.g.add(op, xr, matrix=w)
            return _Val("ref", ref=nid)
        if b.kind == "param":
            raise SeeDotError("write 'W * x', not 'x * W' (row-major matvec)")
        # both data values: dense matmul (2-D each)
        ar, br = self._as_ref(a), self._as_ref(b)
        self._check(shp.matmul_out, self._shape_of(ar), self._shape_of(br),
                    context="'*' of two data values")
        nid = self.g.add("matmul", ar, br)
        return _Val("ref", ref=nid)

    def _scalar_mul(self, a: _Val, b: _Val) -> _Val:
        if a.kind == "scalar" and b.kind == "ref":
            a, b = b, a
        if b.kind == "param" and np.asarray(b.param).size == 1:
            b = _Val("scalar", scalar=float(np.asarray(b.param).ravel()[0]))
        if a.kind == "ref" and b.kind == "scalar":
            nid = self.g.add("scalar_mul", a.ref, scalar=b.scalar)
            return _Val("ref", ref=nid)
        raise SeeDotError("'.*' needs one data value and one scalar")

    def _binary(self, op: str, a: _Val, b: _Val) -> _Val:
        if b.kind == "param":  # constant vector folded into the template
            ar = self._as_ref(a)
            vec = np.asarray(b.param, dtype=np.float32)
            self._check(shp.elementwise_out, self._shape_of(ar), vec.shape,
                        context=f"'{op}' with param {b.param_name}")
            nid = self.g.add(op, ar, vec=vec)
            return _Val("ref", ref=nid)
        if a.kind == "param":
            if op == "sub":
                raise SeeDotError("'param - x' unsupported; rewrite as (x .* -1) + param")
            br = self._as_ref(b)
            vec = np.asarray(a.param, dtype=np.float32)
            self._check(shp.elementwise_out, self._shape_of(br), vec.shape,
                        context=f"'{op}' with param {a.param_name}")
            nid = self.g.add(op, br, vec=vec)
            return _Val("ref", ref=nid)
        ar, br = self._as_ref(a), self._as_ref(b)
        self._check(shp.elementwise_out, self._shape_of(ar),
                    self._shape_of(br), context=f"'{op}'")
        nid = self.g.add(op, ar, br)
        return _Val("ref", ref=nid)


def parse(
    src: str,
    *,
    inputs: dict[str, tuple[int, ...]],
    params: dict[str, np.ndarray] | None = None,
    sparse_params: set[str] | None = None,
    name: str = "seedot",
) -> DFG:
    """Compile a mini-SeeDot program to a MAFIA DFG.

    ``inputs`` declares graph inputs (name -> shape); ``params`` are the model
    parameters referenced by name.  The final expression (and any ``argmax``
    node on the way) becomes the graph output.
    """
    g = DFG(name)
    for iname, shape in inputs.items():
        g.add_input(iname, shape)
    p = _Parser(_tokenize(src), g, params or {}, sparse_params or set())
    out = p.program()
    if out.kind != "ref":
        raise SeeDotError("program must end in a data expression")
    assert out.ref is not None
    g.mark_output(out.ref)
    g.validate()
    return g
