"""ProtoNN (Gupta et al., ICML'17) — compressed kNN for resource-scarce devices.

The second model the paper compiles (§V-A).  ProtoNN learns a sparse
projection ``W``, a set of prototypes ``B`` in the projected space, and
per-prototype class score vectors ``Zs``:

    ŷ(x) = argmax_c  Σ_j  exp(−γ² ‖W x − b_j‖²) · Zs[c, j]

As a matrix DFG:   SpMV → sq_l2 → scalar_mul(−γ²) → exp → GEMV → argmax.
The (scalar_mul → exp) pair is a connected linear-time cluster, so MAFIA's
§IV-G pipelining fuses it — this model exercises the pipeline path, while
Bonsai exercises the branchy inter-node-parallel path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.dfg import DFG
from repro_torch.data.datasets import DatasetSpec

__all__ = ["ProtoNNConfig", "init_params", "predict", "build_dfg", "train",
           "from_spec", "params_from_reference", "accuracy"]


@dataclasses.dataclass(frozen=True)
class ProtoNNConfig:
    n_features: int
    n_classes: int
    proj_dim: int = 12
    n_prototypes: int = 40
    gamma: float = 1.0
    w_density: float = 0.3


def from_spec(spec: DatasetSpec) -> ProtoNNConfig:
    return ProtoNNConfig(
        n_features=spec.n_features,
        n_classes=spec.n_classes,
        proj_dim=spec.protonn_proj,
        n_prototypes=spec.protonn_prototypes,
    )


def init_params(cfg: ProtoNNConfig, seed: int = 0,
                X: np.ndarray | None = None, y: np.ndarray | None = None) -> dict[str, np.ndarray]:
    """Random sparse projection; prototypes seeded from projected class points
    when training data is given (the standard ProtoNN init)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((cfg.proj_dim, cfg.n_features)) < cfg.w_density
    W = (rng.normal(size=(cfg.proj_dim, cfg.n_features)) * mask / np.sqrt(
        max(1.0, cfg.w_density * cfg.n_features))).astype(np.float32)
    if X is not None and y is not None:
        proj = X @ W.T
        idx = rng.permutation(len(X))[: cfg.n_prototypes]
        B = proj[idx].T.astype(np.float32)                       # (proj_dim, m)
        Zs = np.zeros((cfg.n_classes, cfg.n_prototypes), dtype=np.float32)
        Zs[y[idx], np.arange(cfg.n_prototypes)] = 1.0
        # set the RBF width from the data (ProtoNN learns γ; the standard init
        # scales it so typical γ²·d² ≈ 1 rather than saturating exp(−d²))
        sub = proj[rng.permutation(len(proj))[:256]]
        d2 = ((sub[:, None, :] - B.T[None]) ** 2).sum(-1)
        gamma = np.float32(1.0 / np.sqrt(np.median(d2) + 1e-6))
    else:
        B = rng.normal(size=(cfg.proj_dim, cfg.n_prototypes)).astype(np.float32)
        Zs = (rng.normal(size=(cfg.n_classes, cfg.n_prototypes)) * 0.1).astype(np.float32)
        gamma = np.float32(cfg.gamma)
    return {"W": W, "B": B, "Zs": Zs, "gamma": np.asarray(gamma)}


_EXAMPLE = ProtoNNConfig(n_features=1, n_classes=2)


def param_shapes(cfg: ProtoNNConfig) -> dict[str, tuple[int, ...]]:
    """Name → shape of every parameter :func:`init_params` returns."""
    return {"W": (cfg.proj_dim, cfg.n_features),
            "B": (cfg.proj_dim, cfg.n_prototypes),
            "Zs": (cfg.n_classes, cfg.n_prototypes), "gamma": ()}


def params_from_reference(np_params: dict[str, Any],
                          cfg: ProtoNNConfig | None = None) -> dict[str, np.ndarray]:
    """The JAX package's ProtoNN parameters (as numpy arrays) as the port's:
    checks names, shapes (exactly, given ``cfg``; else their ranks) and
    dtypes (float32), and returns copies."""
    want = (param_shapes(cfg) if cfg is not None else
            {k: np.shape(v) for k, v in np_params.items()})
    ranks = {k: len(v) for k, v in param_shapes(_EXAMPLE).items()}
    if set(np_params) != set(ranks):
        raise ValueError(f"protonn params {sorted(np_params)} != {sorted(ranks)}")
    out = {}
    for k, shape in want.items():
        a = np.asarray(np_params[k])
        if a.shape != shape or a.ndim != ranks[k] or a.dtype != np.float32:
            raise ValueError(f"protonn param {k!r}: {a.dtype}{a.shape}, "
                             f"expected float32{shape}")
        out[k] = a.copy()
    return out


def predict(params: dict[str, Any], cfg: ProtoNNConfig,
            x: torch.Tensor) -> torch.Tensor:
    """x: (..., n_features) → logits (..., n_classes).  Same math as the DFG."""
    P = {k: torch.as_tensor(np.asarray(v), device=x.device) for k, v in params.items()}
    gamma = P.get("gamma", torch.tensor(cfg.gamma, dtype=torch.float32))
    proj = x @ P["W"].T                                        # (..., d)
    diff = proj[..., :, None] - P["B"]                         # (..., d, m)
    d2 = torch.sum(diff * diff, dim=-2)                        # (..., m)
    sim = torch.exp(-(gamma ** 2) * d2)
    return sim @ P["Zs"].T


def build_dfg(params: dict[str, Any], cfg: ProtoNNConfig, name: str = "protonn") -> DFG:
    g = DFG(name)
    g.add_input("x", (cfg.n_features,))
    wx = g.add("spmv", "x", id="Wx", matrix=np.asarray(params["W"]))
    d2 = g.add("sq_l2", wx, id="Dist2", points=np.asarray(params["B"]))
    gamma = float(np.asarray(params.get("gamma", cfg.gamma)))
    sc = g.add("scalar_mul", d2, id="GammaScale", scalar=-(gamma**2))
    sim = g.add("exp", sc, id="RBF")
    y = g.add("gemv", sim, id="ScoreSum", matrix=np.asarray(params["Zs"]))
    yhat = g.add("argmax", y, id="Pred")
    g.mark_output(y)
    g.mark_output(yhat)
    g.validate()
    return g


def train(cfg: ProtoNNConfig, X: np.ndarray, y: np.ndarray, steps: int = 300,
          lr: float = 0.5, seed: int = 0) -> dict[str, np.ndarray]:
    """Not ported yet: training comes with the training slice."""
    raise NotImplementedError("protonn.train is not ported to torch yet")


def accuracy(params: dict[str, Any], cfg: ProtoNNConfig, X: np.ndarray,
             y: np.ndarray) -> float:
    with torch.no_grad():
        logits = predict(params, cfg, torch.as_tensor(np.asarray(X, np.float32)))
    return float((logits.argmax(-1).numpy() == y).mean())
