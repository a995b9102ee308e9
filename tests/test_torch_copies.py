"""The port's verbatim copies stay verbatim.

Framework-free modules of the JAX package are carried into ``repro_torch``
unchanged apart from the package name in their imports; this guards them
against drifting apart from their originals.  One copy differs in one
stated place (``CHANGED``), and the MLPerf-Tiny fixtures are byte-equal.
"""

from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

COPIES = [
    "core/shapes.py", "core/dfg.py", "core/constraints.py",
    "core/fpga_model.py", "core/tpu_model.py", "core/cost_model.py",
    "core/profiler.py", "core/optimizer.py", "core/scheduler.py",
    "data/datasets.py", "configs/classical.py", "serve/scheduling.py",
    "serve/metrics.py", "frontends/onnx_proto.py",
    "frontends/onnx_importer.py", "frontends/seedot.py",
    "frontends/tf_subset.py", "configs/mlperf_tiny.py",
    "configs/qwen2_5_3b.py", "configs/granite_8b.py",
    "configs/codeqwen1_5_7b.py", "configs/olmoe_1b_7b.py",
    "configs/deepseek_v2_236b.py", "configs/mamba2_1_3b.py",
    "configs/zamba2_7b.py", "configs/musicgen_medium.py",
    "configs/command_r_35b.py", "configs/internvl2_26b.py",
    "data/tokens.py", "train/fault_tolerance.py",
]

# the one place a copy differs: ``teacher_labels`` reads the program's
# output, a torch tensor that may lie on the card, through ``.cpu()``
CHANGED = {
    "configs/mlperf_tiny.py": (
        "    return np.argmax(np.asarray(probs), axis=-1)\n",
        "    return np.argmax(probs.cpu().numpy(), axis=-1)\n"),
}

FIXTURES = ["configs/fixtures/mlperf_tiny/kws_mlp.onnx",
            "configs/fixtures/mlperf_tiny/tiny_cnn.onnx"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original(rel):
    original = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    want = original.replace("repro.", "repro_torch.")
    if rel in CHANGED:
        old, new = CHANGED[rel]
        assert want.count(old) == 1, f"{rel}: the changed line moved"
        want = want.replace(old, new)
    assert port == want, f"{rel} drifted from its original"


@pytest.mark.parametrize("rel", FIXTURES)
def test_fixture_equals_original(rel):
    original = (SRC / "repro" / rel).read_bytes()
    assert (SRC / "repro_torch" / rel).read_bytes() == original
    assert len(original) > 10_000
