"""Shared shape inference — the single source of truth for tensor shapes.

Every place that derives an output shape from input shapes routes through
here: the op registry's ``OpSpec.out_shape`` rules (:mod:`repro_torch.core.
node_types`), the ONNX importer's shape propagation
(:mod:`repro_torch.frontends.onnx_importer`), and the SeeDot / TF-subset
frontends' operand-kind dispatch.  Keeping one implementation means a
frontend cannot accept a graph the op layer would reject (or vice versa),
and rank-polymorphic ops added here become visible to every consumer at
once.

All functions are pure over plain int tuples (no jax, no registry imports —
this module sits below everything) and raise :class:`ShapeError`
(a ``ValueError``) with the offending shapes spelled out.
"""

from __future__ import annotations

__all__ = [
    "ShapeError", "numel", "effective_rank", "is_vector_like",
    "normalize_2d", "window_out", "conv2d_out", "pool2d_out",
    "matvec_out", "matmul_out", "elementwise_out", "flatten_out",
    "reshape_out",
]


class ShapeError(ValueError):
    """Inconsistent operand shapes (raised by every helper here)."""


def numel(shape: tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def effective_rank(shape: tuple[int, ...]) -> int:
    """Rank after squeezing unit axes: ``(1, 400)`` and ``(400,)`` are both
    effectively 1-D; ``(3, 32, 32)`` is 3-D.  The chain decomposer and the
    megakernel encoder use this to decide what still behaves like the
    paper's ``(1, n)`` vectors."""
    return sum(1 for s in shape if int(s) != 1)


def is_vector_like(shape: tuple[int, ...]) -> bool:
    """True when a tensor of ``shape`` is safely treated as a flat vector
    (scalar included): at most one non-unit axis."""
    return effective_rank(shape) <= 1


def normalize_2d(v, name: str) -> tuple[int, int]:
    """Accept an int or an (h, w) pair for a spatial attribute; returns the
    pair.  Used for strides / kernel sizes / paddings."""
    if isinstance(v, (int,)):
        return (int(v), int(v))
    t = tuple(int(x) for x in v)
    if len(t) != 2:
        raise ShapeError(f"{name} must be an int or an (h, w) pair, got {v!r}")
    return t  # type: ignore[return-value]


def window_out(size: int, k: int, s: int, p: int) -> int:
    """Output extent of one sliding-window axis: floor((size+2p-k)/s)+1."""
    out = (int(size) + 2 * int(p) - int(k)) // int(s) + 1
    if out < 1:
        raise ShapeError(
            f"window does not fit: size={size} kernel={k} stride={s} pad={p}")
    return out


def conv2d_out(
    in_shape: tuple[int, ...],
    kernel_shape: tuple[int, ...],
    stride: tuple[int, int] = (1, 1),
    padding: tuple[int, int] = (0, 0),
) -> tuple[int, int, int]:
    """(Cin, H, W) conv (Cout, Cin, Kh, Kw) -> (Cout, Hout, Wout)."""
    if len(in_shape) != 3:
        raise ShapeError(f"conv2d input must be (C, H, W), got {in_shape}")
    if len(kernel_shape) != 4:
        raise ShapeError(
            f"conv2d kernel must be (Cout, Cin, Kh, Kw), got {kernel_shape}")
    cin, h, w = (int(x) for x in in_shape)
    cout, kcin, kh, kw = (int(x) for x in kernel_shape)
    if kcin != cin:
        raise ShapeError(
            f"conv2d: kernel expects {kcin} input channels, input has {cin} "
            f"(input {in_shape}, kernel {kernel_shape})")
    sh, sw = normalize_2d(stride, "stride")
    ph, pw = normalize_2d(padding, "padding")
    return (cout, window_out(h, kh, sh, ph), window_out(w, kw, sw, pw))


def pool2d_out(
    in_shape: tuple[int, ...],
    ksize: tuple[int, int],
    stride: tuple[int, int] | None = None,
    padding: tuple[int, int] = (0, 0),
) -> tuple[int, int, int]:
    """(C, H, W) pooled by a (Kh, Kw) window -> (C, Hout, Wout).  A None
    stride defaults to the window size (non-overlapping pooling)."""
    if len(in_shape) != 3:
        raise ShapeError(f"pool2d input must be (C, H, W), got {in_shape}")
    c, h, w = (int(x) for x in in_shape)
    kh, kw = normalize_2d(ksize, "ksize")
    sh, sw = normalize_2d(stride if stride is not None else (kh, kw), "stride")
    ph, pw = normalize_2d(padding, "padding")
    return (c, window_out(h, kh, sh, ph), window_out(w, kw, sw, pw))


def matvec_out(w_shape: tuple[int, ...], x_shape: tuple[int, ...],
               op: str = "gemv") -> tuple[int]:
    """(m, n) @ flat(x) -> (m,): the gemv/spmv contract — the input may be
    any shape with n elements."""
    if len(w_shape) != 2:
        raise ShapeError(f"{op}: matrix must be 2-D, got {w_shape}")
    if numel(x_shape) != int(w_shape[1]):
        raise ShapeError(f"{op}: matrix {tuple(w_shape)} vs input {x_shape}")
    return (int(w_shape[0]),)


def matmul_out(a: tuple[int, ...], b: tuple[int, ...]) -> tuple[int, int]:
    if len(a) != 2 or len(b) != 2 or int(a[1]) != int(b[0]):
        raise ShapeError(f"matmul: {a} @ {b}")
    return (int(a[0]), int(b[1]))


def elementwise_out(a: tuple[int, ...],
                    b: tuple[int, ...] | None = None) -> tuple[int, ...]:
    """Strict same-shape elementwise combine (no silent broadcasting — the
    FPGA templates stream equal-length element vectors)."""
    if b is not None and tuple(int(x) for x in a) != tuple(int(x) for x in b):
        raise ShapeError(f"elementwise shape mismatch: {tuple(a)} vs {tuple(b)}")
    return tuple(int(x) for x in a)


def flatten_out(shape: tuple[int, ...]) -> tuple[int]:
    return (numel(shape),)


def reshape_out(shape: tuple[int, ...],
                new_shape: tuple[int, ...]) -> tuple[int, ...]:
    """Resolve a reshape target (one -1 wildcard allowed) against ``shape``."""
    tgt = [int(x) for x in new_shape]
    if tgt.count(-1) > 1:
        raise ShapeError(f"reshape: more than one -1 in {new_shape}")
    n = numel(shape)
    if -1 in tgt:
        rest = 1
        for x in tgt:
            if x != -1:
                rest *= x
        if rest == 0 or n % rest:
            raise ShapeError(f"reshape: cannot infer -1 in {new_shape} "
                             f"from {shape}")
        tgt[tgt.index(-1)] = n // rest
    if numel(tuple(tgt)) != n:
        raise ShapeError(f"reshape: {shape} ({n} elements) -> {new_shape}")
    return tuple(tgt)
