"""The port's verbatim copies stay verbatim.

Framework-free modules of the JAX package are carried into ``repro_torch``
unchanged apart from the package name in their imports; this guards them
against drifting apart from their originals.
"""

from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

COPIES = [
    "core/shapes.py", "core/dfg.py", "core/constraints.py",
    "core/fpga_model.py", "core/tpu_model.py", "core/cost_model.py",
    "core/profiler.py", "core/optimizer.py", "core/scheduler.py",
    "data/datasets.py", "configs/classical.py", "serve/scheduling.py",
    "serve/metrics.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original(rel):
    original = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    assert port == original.replace("repro.", "repro_torch."), \
        f"{rel} drifted from its original"
