"""Benchmark datasets (paper §V-A, Table I).

The paper evaluates on ten standard datasets (binary + multiclass variants of
cifar, character-recognition, mnist, usps, letter, ward, curet).  The raw data
is not redistributable/offline here, so we generate *synthetic* datasets with
the exact feature counts and class counts of Table I (Gaussian class clusters
with controlled separation), and carry the paper's measured microcontroller
baseline latencies verbatim for the Fig. 3 comparison.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DatasetSpec", "TABLE_I", "make_dataset", "get_spec"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_features: int
    n_classes: int
    mcu_bonsai_us: float    # Table I BONSAI baseline latency (Arduino Uno)
    mcu_protonn_us: float   # Table I PROTONN baseline latency
    # model hyper-parameters used by the paper's EdgeML configs (KB-sized)
    bonsai_proj: int = 16
    bonsai_depth: int = 3
    protonn_proj: int = 12
    protonn_prototypes: int = 40


TABLE_I: list[DatasetSpec] = [
    DatasetSpec("cifar-b", 400, 2, 6121, 14112, bonsai_proj=20, protonn_prototypes=60),
    DatasetSpec("cr-b", 400, 2, 6263, 28446, bonsai_proj=20, protonn_prototypes=80),
    DatasetSpec("mnist-b", 784, 2, 11568, 15983, bonsai_proj=20, protonn_prototypes=40),
    DatasetSpec("usps-b", 256, 2, 4099, 9206, bonsai_proj=16, protonn_prototypes=40),
    DatasetSpec("ward-b", 1000, 2, 14733, 23241, bonsai_proj=24, protonn_prototypes=40),
    DatasetSpec("cr-m", 400, 62, 29030, 34667, bonsai_proj=24, bonsai_depth=4, protonn_prototypes=120),
    DatasetSpec("curet-m", 610, 61, 39731, 37769, bonsai_proj=24, bonsai_depth=4, protonn_prototypes=120),
    DatasetSpec("letter-m", 16, 26, 11161, 35377, bonsai_proj=10, bonsai_depth=4, protonn_prototypes=120),
    DatasetSpec("mnist-m", 784, 10, 16026, 18491, bonsai_proj=20, bonsai_depth=3, protonn_prototypes=80),
    DatasetSpec("usps-m", 256, 10, 9140, 14017, bonsai_proj=16, bonsai_depth=3, protonn_prototypes=80),
]

_BY_NAME = {s.name: s for s in TABLE_I}


def get_spec(name: str) -> DatasetSpec:
    return _BY_NAME[name]


def make_dataset(
    spec: DatasetSpec | str,
    n_train: int = 2048,
    n_test: int = 512,
    separation: float = 3.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic Gaussian-cluster stand-in with Table-I dims.

    Returns (X_train, y_train, X_test, y_test); features are standardized,
    matching SeeDot's fixed-point-friendly preprocessing.
    """
    if isinstance(spec, str):
        spec = get_spec(spec)
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(spec.n_classes, spec.n_features)) * separation / np.sqrt(spec.n_features)

    def sample(n: int) -> tuple[np.ndarray, np.ndarray]:
        y = rng.integers(0, spec.n_classes, size=n)
        x = centers[y] + rng.normal(size=(n, spec.n_features))
        return x.astype(np.float32), y.astype(np.int32)

    Xtr, ytr = sample(n_train)
    Xte, yte = sample(n_test)
    mu, sd = Xtr.mean(0), Xtr.std(0) + 1e-6
    return (Xtr - mu) / sd, ytr, (Xte - mu) / sd, yte
