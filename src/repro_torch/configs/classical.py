"""The paper's own benchmark configs: 20 DFGs = {BONSAI, PROTONN} × 10
datasets (Table I).  Each entry builds (trains, if requested) the model and
returns its MAFIA DFG — the input of every Fig. 3 / Fig. 4 comparison.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.dfg import DFG
from repro_torch.data.datasets import TABLE_I, DatasetSpec, get_spec, make_dataset
from repro_torch.models import bonsai, protonn

__all__ = ["ClassicalBenchmark", "BENCHMARKS", "TRAIN_SPLIT", "build",
           "training_split"]

# Rows build(trained=True) fits on — int8 calibration and the quantization
# benchmark reuse this so their split is exactly the training split.
TRAIN_SPLIT = 1024


@dataclasses.dataclass(frozen=True)
class ClassicalBenchmark:
    name: str                # e.g. "bonsai/usps-b"
    algo: str                # bonsai | protonn
    dataset: DatasetSpec

    @property
    def mcu_baseline_us(self) -> float:
        return (self.dataset.mcu_bonsai_us if self.algo == "bonsai"
                else self.dataset.mcu_protonn_us)


BENCHMARKS: list[ClassicalBenchmark] = [
    ClassicalBenchmark(f"{algo}/{spec.name}", algo, spec)
    for algo in ("bonsai", "protonn")
    for spec in TABLE_I
]


def _resolve(bench: ClassicalBenchmark | str) -> ClassicalBenchmark:
    if isinstance(bench, str):
        algo, ds = bench.split("/")
        return ClassicalBenchmark(bench, algo, get_spec(ds))
    return bench


def training_split(bench: ClassicalBenchmark | str, seed: int = 0):
    """(X, y) of the exact rows — same draw, same standardization stats —
    that ``build(trained=True)`` fits on; the int8 calibration source."""
    bench = _resolve(bench)
    Xtr, ytr, _, _ = make_dataset(bench.dataset, n_train=TRAIN_SPLIT, seed=seed)
    return Xtr, ytr


def build(
    bench: ClassicalBenchmark | str,
    *,
    trained: bool = False,
    seed: int = 0,
) -> tuple[DFG, dict[str, Any], Any]:
    """Build (dfg, params, config) for one benchmark; optionally fit on the
    synthetic dataset first (slow — tests/benches default to random init,
    which exercises identical shapes/sparsity)."""
    bench = _resolve(bench)
    mod = bonsai if bench.algo == "bonsai" else protonn
    cfg = mod.from_spec(bench.dataset)
    if trained:
        Xtr, ytr = training_split(bench, seed=seed)
        params = mod.train(cfg, Xtr, ytr, steps=120, seed=seed)
    else:
        params = mod.init_params(cfg, seed=seed)
    return mod.build_dfg(params, cfg, name=bench.name.replace("/", "_")), params, cfg
