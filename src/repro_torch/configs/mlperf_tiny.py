"""MLPerf-Tiny-shaped ONNX workloads — the workload class small-FPGA
toolchains are judged on (hls4ml / MLPerf-Tiny codesign, PAPERS.md).

Two synthetic-weight fixtures checked in as real ``.onnx`` graphs (emitted
by the dependency-free writer in :mod:`repro_torch.frontends.onnx_proto`, and
regenerable bit-for-bit with :func:`regenerate`):

* ``kws_mlp`` — keyword-spotting-style MLP over a 49×10 MFCC patch:
  Flatten → Gemm(490→128) → Relu → MatMul+Add(128→128) → Relu →
  Gemm(128→12) → Softmax.  Exercises Flatten / Gemm / MatMul / Add.

* ``tiny_cnn`` — small image classifier over 3×16×16:
  Conv(3→8, 3×3, pad 1) → BatchNorm → Relu → MaxPool 2×2 →
  Conv(8→16, 3×3, pad 1) → Relu → AveragePool 2×2 → Reshape → Gemm(256→10)
  → Softmax.  Exercises Conv / BatchNorm folding / both pools / Reshape.

Weights are deterministic (fixed seed, He-ish scaling) — these fixtures
gate the *compiler* (lane parity, int8 accuracy drop, serving), not model
quality.  ``sample_inputs`` draws the matching standardized input batches;
``teacher_labels`` labels a batch with the float32 model's argmax, the
reference the int8 accuracy-drop gate compares against.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from repro_torch.core.dfg import DFG
from repro_torch.frontends import onnx_proto as op_
from repro_torch.frontends.onnx_importer import import_onnx

__all__ = ["WORKLOADS", "fixture_path", "model_bytes", "build",
           "input_name", "sample_inputs", "teacher_labels", "regenerate"]

WORKLOADS = ("kws_mlp", "tiny_cnn")

_FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures",
                            "mlperf_tiny")

# (per-sample input shape, classes) per workload
_SHAPES: dict[str, tuple[tuple[int, ...], int]] = {
    "kws_mlp": ((49, 10), 12),
    "tiny_cnn": ((3, 16, 16), 10),
}


def fixture_path(name: str) -> str:
    if name not in WORKLOADS:
        raise KeyError(f"unknown MLPerf-Tiny workload {name!r}; "
                       f"have {WORKLOADS}")
    return os.path.join(_FIXTURE_DIR, f"{name}.onnx")


def model_bytes(name: str) -> bytes:
    with open(fixture_path(name), "rb") as f:
        return f.read()


def build(name: str) -> DFG:
    """Checked-in fixture → per-sample DFG through the ONNX importer."""
    return import_onnx(model_bytes(name), name=name)


def input_name(name: str) -> str:
    return "input"


def sample_inputs(name: str, n: int = 256, seed: int = 1) -> np.ndarray:
    """Deterministic standardized input batch ``(n, *per_sample_shape)``."""
    shape, _ = _SHAPES[name]
    rng = np.random.default_rng(seed + {w: i for i, w in
                                        enumerate(WORKLOADS)}[name] * 1000)
    return rng.standard_normal((n,) + shape).astype(np.float32)


def teacher_labels(program: Any, x: np.ndarray) -> np.ndarray:
    """Argmax labels of a compiled program over batch ``x`` — the float32
    teacher the int8 accuracy gate scores against."""
    out = program.batch(max_batch=len(x), mode="map")(input=x)
    (probs,) = out.values()
    return np.argmax(probs.cpu().numpy(), axis=-1)


# ============================================================== generator
def _glorot(rng: np.random.Generator, *shape: int) -> np.ndarray:
    fan_in = int(np.prod(shape[1:])) or 1
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def _kws_mlp() -> bytes:
    rng = np.random.default_rng(2107)
    shape, classes = _SHAPES["kws_mlp"]
    n_in = int(np.prod(shape))
    w1, b1 = _glorot(rng, 128, n_in), _glorot(rng, 128)
    w2, b2 = _glorot(rng, 128, 128), _glorot(rng, 128)
    # trained classifier heads separate classes decisively; raw random
    # weights don't.  Widen the head so the fixture's argmax is stable the
    # way a real model's is — the int8 gate scores label agreement, and a
    # near-tie head would measure tie-breaking noise, not quantization.
    w3, b3 = 3.0 * _glorot(rng, classes, 128), _glorot(rng, classes)
    nodes = [
        op_.make_node("Flatten", ["input"], ["flat"], name="flatten0", axis=1),
        op_.make_node("Gemm", ["flat", "w1", "b1"], ["h1"], name="fc1",
                      alpha=1.0, beta=1.0, transB=1),
        op_.make_node("Relu", ["h1"], ["a1"], name="relu1"),
        op_.make_node("MatMul", ["a1", "w2t"], ["h2"], name="fc2"),
        op_.make_node("Add", ["h2", "b2"], ["h2b"], name="fc2_bias"),
        op_.make_node("Relu", ["h2b"], ["a2"], name="relu2"),
        op_.make_node("Gemm", ["a2", "w3", "b3"], ["logits"], name="fc3",
                      alpha=1.0, beta=1.0, transB=1),
        op_.make_node("Softmax", ["logits"], ["probs"], name="softmax0",
                      axis=1),
    ]
    inits = [
        op_.np_to_tensor("w1", w1), op_.np_to_tensor("b1", b1),
        op_.np_to_tensor("w2t", np.ascontiguousarray(w2.T)),
        op_.np_to_tensor("b2", b2),
        op_.np_to_tensor("w3", w3), op_.np_to_tensor("b3", b3),
    ]
    return op_.build_model(
        graph_name="kws_mlp",
        nodes=nodes,
        inputs=[op_.value_info("input", ("N",) + shape)],
        outputs=[op_.value_info("probs", ("N", classes))],
        initializers=inits,
    )


def _tiny_cnn() -> bytes:
    rng = np.random.default_rng(653)
    shape, classes = _SHAPES["tiny_cnn"]
    k1 = _glorot(rng, 8, shape[0], 3, 3)
    bn_scale = (1.0 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    bn_b = (0.1 * rng.standard_normal(8)).astype(np.float32)
    bn_mean = (0.05 * rng.standard_normal(8)).astype(np.float32)
    bn_var = (1.0 + 0.1 * rng.random(8)).astype(np.float32)
    k2, c2b = _glorot(rng, 16, 8, 3, 3), _glorot(rng, 16)
    flat = 16 * (shape[1] // 4) * (shape[2] // 4)
    # widened head: see _kws_mlp — argmax stability like a trained model's
    w, b = 3.0 * _glorot(rng, classes, flat), _glorot(rng, classes)
    nodes = [
        op_.make_node("Conv", ["input", "k1"], ["c1"], name="conv1",
                      kernel_shape=(3, 3), strides=(1, 1),
                      pads=(1, 1, 1, 1)),
        op_.make_node("BatchNormalization",
                      ["c1", "bn_s", "bn_b", "bn_m", "bn_v"], ["n1"],
                      name="bn1", epsilon=1e-5),
        op_.make_node("Relu", ["n1"], ["a1"], name="relu1"),
        op_.make_node("MaxPool", ["a1"], ["p1"], name="pool1",
                      kernel_shape=(2, 2), strides=(2, 2)),
        op_.make_node("Conv", ["p1", "k2", "c2b"], ["c2"], name="conv2",
                      kernel_shape=(3, 3), strides=(1, 1),
                      pads=(1, 1, 1, 1)),
        op_.make_node("Relu", ["c2"], ["a2"], name="relu2"),
        op_.make_node("AveragePool", ["a2"], ["p2"], name="pool2",
                      kernel_shape=(2, 2), strides=(2, 2)),
        op_.make_node("Reshape", ["p2", "rshape"], ["flat"], name="reshape0"),
        op_.make_node("Gemm", ["flat", "w", "b"], ["logits"], name="fc",
                      alpha=1.0, beta=1.0, transB=1),
        op_.make_node("Softmax", ["logits"], ["probs"], name="softmax0",
                      axis=1),
    ]
    inits = [
        op_.np_to_tensor("k1", k1),
        op_.np_to_tensor("bn_s", bn_scale), op_.np_to_tensor("bn_b", bn_b),
        op_.np_to_tensor("bn_m", bn_mean), op_.np_to_tensor("bn_v", bn_var),
        op_.np_to_tensor("k2", k2), op_.np_to_tensor("c2b", c2b),
        op_.np_to_tensor("rshape", np.asarray([-1, flat], np.int64)),
        op_.np_to_tensor("w", w), op_.np_to_tensor("b", b),
    ]
    return op_.build_model(
        graph_name="tiny_cnn",
        nodes=nodes,
        inputs=[op_.value_info("input", ("N",) + shape)],
        outputs=[op_.value_info("probs", ("N", classes))],
        initializers=inits,
    )


_GENERATORS = {"kws_mlp": _kws_mlp, "tiny_cnn": _tiny_cnn}


def regenerate() -> dict[str, str]:
    """Rewrite the checked-in fixtures (deterministic — same bytes every
    run).  Returns name → path."""
    os.makedirs(_FIXTURE_DIR, exist_ok=True)
    out = {}
    for name, gen in _GENERATORS.items():
        path = fixture_path(name)
        with open(path, "wb") as f:
            f.write(gen())
        out[name] = path
    return out


if __name__ == "__main__":
    for name, path in regenerate().items():
        print(f"{name}: {path} ({os.path.getsize(path)} bytes)")
