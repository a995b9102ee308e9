"""BONSAI (Kumar et al., ICML'17) — decision-tree classifier for IoT devices.

One of the two state-of-the-art models the paper compiles (§V-A).  Bonsai
learns a sparse low-dim projection ``Z`` and a shallow tree whose node
predictors ``W_k ẑ ∘ tanh(σ V_k ẑ)`` are gated by path indicators derived from
branching hyperplanes ``Θ``.

We use the *leaf-scored, soft-indicator* matrix formulation so the whole model
is a static matrix DFG (the representation MAFIA compiles):

    ẑ   = Z x                                      (sparse projection, SpMV)
    s   = tanh(σθ · Θ ẑ)                           (branch scores, Ki internal)
    Iℓ  = ½(1 + Dℓ s)       for levels ℓ=0..d-1    (per-level leaf factors)
    I   = I0 ∘ I1 ∘ … ∘ I_{d-1}                    (leaf indicators, Kl leaves)
    H   = (W ẑ) ∘ tanh(σ · V ẑ)                    (leaf·class scores, Kl·L)
    y   = R (H ∘ E I),   ŷ = argmax y              (class aggregation)

where Dℓ maps each leaf to the ±orientation of its level-ℓ ancestor and
E/R are 0/1 expansion/reduction matrices (sparse — they lower to SpMV nodes).
`predict` computes the same math in torch, and `train` fits the model on a
dataset by plain full-batch gradient descent through ``torch.autograd`` —
on the card unless given ``device="cpu"``.  `params_from_reference`
carries the JAX package's trained or random parameters across as numpy
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.dfg import DFG
from repro_torch.data.datasets import DatasetSpec

__all__ = ["BonsaiConfig", "init_params", "predict", "build_dfg", "loss_fn",
           "train", "from_spec", "params_from_reference", "accuracy"]


@dataclasses.dataclass(frozen=True)
class BonsaiConfig:
    n_features: int
    n_classes: int
    proj_dim: int = 16
    depth: int = 3
    sigma: float = 1.0       # predictor tanh sharpness
    sigma_theta: float = 1.0  # branch tanh sharpness
    z_density: float = 0.2   # sparsity of the projection matrix

    @property
    def n_internal(self) -> int:
        return 2**self.depth - 1

    @property
    def n_leaves(self) -> int:
        return 2**self.depth


def from_spec(spec: DatasetSpec) -> BonsaiConfig:
    return BonsaiConfig(
        n_features=spec.n_features,
        n_classes=spec.n_classes,
        proj_dim=spec.bonsai_proj,
        depth=spec.bonsai_depth,
    )


def _level_matrices(cfg: BonsaiConfig) -> list[np.ndarray]:
    """Dℓ (n_leaves × n_internal): ±1 at each leaf's level-ℓ ancestor."""
    mats = []
    for level in range(cfg.depth):
        D = np.zeros((cfg.n_leaves, cfg.n_internal), dtype=np.float32)
        for leaf in range(cfg.n_leaves):
            # internal nodes are heap-indexed; the leaf's path from the root
            path = leaf + cfg.n_internal  # leaf's heap index
            anc = path
            dirs = []
            while anc > 0:
                parent = (anc - 1) // 2
                dirs.append((parent, +1.0 if anc == 2 * parent + 2 else -1.0))
                anc = parent
            dirs.reverse()
            node, sign = dirs[level]
            D[leaf, node] = sign
        mats.append(D)
    return mats


def _tensors(params: dict[str, Any], device: torch.device) -> dict[str, torch.Tensor]:
    """Parameters as tensors on ``device``: tensors as they are, arrays copied."""
    return {k: v.to(device) if torch.is_tensor(v)
            else torch.as_tensor(np.asarray(v), device=device)
            for k, v in params.items()}


def _expand_reduce(cfg: BonsaiConfig) -> tuple[np.ndarray, np.ndarray]:
    Kl, L = cfg.n_leaves, cfg.n_classes
    E = np.zeros((Kl * L, Kl), dtype=np.float32)   # leaf indicator -> leaf·class
    R = np.zeros((L, Kl * L), dtype=np.float32)    # leaf·class -> class
    for k in range(Kl):
        for c in range(L):
            E[k * L + c, k] = 1.0
            R[c, k * L + c] = 1.0
    return E, R


def init_params(cfg: BonsaiConfig, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    mask = rng.random((cfg.proj_dim, cfg.n_features)) < cfg.z_density
    Z = (rng.normal(size=(cfg.proj_dim, cfg.n_features)) * mask / np.sqrt(
        max(1.0, cfg.z_density * cfg.n_features))).astype(np.float32)
    scale = 1.0 / np.sqrt(cfg.proj_dim)
    return {
        "Z": Z,
        "W": (rng.normal(size=(cfg.n_leaves * cfg.n_classes, cfg.proj_dim)) * scale).astype(np.float32),
        "V": (rng.normal(size=(cfg.n_leaves * cfg.n_classes, cfg.proj_dim)) * scale).astype(np.float32),
        "Theta": (rng.normal(size=(cfg.n_internal, cfg.proj_dim)) * scale).astype(np.float32),
    }


_EXAMPLE = BonsaiConfig(n_features=1, n_classes=2)


def param_shapes(cfg: BonsaiConfig) -> dict[str, tuple[int, ...]]:
    """Name → shape of every parameter :func:`init_params` draws."""
    kl = cfg.n_leaves * cfg.n_classes
    return {"Z": (cfg.proj_dim, cfg.n_features), "W": (kl, cfg.proj_dim),
            "V": (kl, cfg.proj_dim), "Theta": (cfg.n_internal, cfg.proj_dim)}


def params_from_reference(np_params: dict[str, Any],
                          cfg: BonsaiConfig | None = None) -> dict[str, np.ndarray]:
    """The JAX package's Bonsai parameters (as numpy arrays) as the port's:
    checks names, shapes (exactly, given ``cfg``; else their ranks) and
    dtypes (float32), and returns copies."""
    want = (param_shapes(cfg) if cfg is not None else
            {k: np.shape(v) for k, v in np_params.items()})
    ranks = {k: len(v) for k, v in param_shapes(_EXAMPLE).items()}
    if set(np_params) != set(ranks):
        raise ValueError(f"bonsai params {sorted(np_params)} != {sorted(ranks)}")
    out = {}
    for k, shape in want.items():
        a = np.asarray(np_params[k])
        if a.shape != shape or a.ndim != ranks[k] or a.dtype != np.float32:
            raise ValueError(f"bonsai param {k!r}: {a.dtype}{a.shape}, "
                             f"expected float32{shape}")
        out[k] = a.copy()
    return out


def predict(params: dict[str, Any], cfg: BonsaiConfig,
            x: torch.Tensor) -> torch.Tensor:
    """x: (..., n_features) → logits (..., n_classes); the DFG's math.
    Tensor parameters are used as they are (so gradients reach them)."""
    P = _tensors(params, x.device)
    Dls = [torch.as_tensor(D, device=x.device) for D in _level_matrices(cfg)]
    E, R = (torch.as_tensor(a, device=x.device) for a in _expand_reduce(cfg))
    zhat = x @ P["Z"].T
    s = torch.tanh(cfg.sigma_theta * (zhat @ P["Theta"].T))
    I = torch.ones(s.shape[:-1] + (cfg.n_leaves,), dtype=x.dtype, device=x.device)
    for D in Dls:
        I = I * (0.5 * (1.0 + s @ D.T))
    H = (zhat @ P["W"].T) * torch.tanh(cfg.sigma * (zhat @ P["V"].T))
    G = H * (I @ E.T)
    return G @ R.T


def build_dfg(params: dict[str, Any], cfg: BonsaiConfig, name: str = "bonsai") -> DFG:
    """The matrix DFG MAFIA compiles — op-for-op the math of `predict`."""
    Dls = _level_matrices(cfg)
    E, R = _expand_reduce(cfg)
    g = DFG(name)
    g.add_input("x", (cfg.n_features,))
    zx = g.add("spmv", "x", id="Zx", matrix=np.asarray(params["Z"]))
    # --- branch-score path
    th = g.add("gemv", zx, id="ThetaZ", matrix=np.asarray(params["Theta"]))
    ths = g.add("scalar_mul", th, id="ThetaScale", scalar=float(cfg.sigma_theta))
    s = g.add("tanh", ths, id="BranchTanh")
    factors = []
    for lvl, D in enumerate(Dls):
        u = g.add("spmv", s, id=f"Dlvl{lvl}", matrix=D)  # ±1 selection, sparse
        b = g.add(
            "add", u, id=f"One{lvl}", vec=np.ones(cfg.n_leaves, dtype=np.float32)
        )
        f = g.add("scalar_mul", b, id=f"Half{lvl}", scalar=0.5)
        factors.append(f)
    ind = factors[0]
    for lvl in range(1, len(factors)):
        ind = g.add("hadamard", ind, factors[lvl], id=f"IndProd{lvl}")
    # --- predictor path
    wz = g.add("gemv", zx, id="WZ", matrix=np.asarray(params["W"]))
    vz = g.add("gemv", zx, id="VZ", matrix=np.asarray(params["V"]))
    vs = g.add("scalar_mul", vz, id="VScale", scalar=float(cfg.sigma))
    vt = g.add("tanh", vs, id="VTanh")
    h = g.add("hadamard", wz, vt, id="H")
    # --- combine
    ie = g.add("spmv", ind, id="ExpandI", matrix=E)
    gh = g.add("hadamard", h, ie, id="Gated")
    y = g.add("spmv", gh, id="ClassSum", matrix=R)
    yhat = g.add("argmax", y, id="Pred")
    g.mark_output(y)
    g.mark_output(yhat)
    g.validate()
    return g


def loss_fn(params: dict[str, Any], cfg: BonsaiConfig, X: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Mean NLL of ``log_softmax(predict)`` at the labels ``y``."""
    logp = torch.log_softmax(predict(params, cfg, X), dim=-1)
    return -torch.gather(logp, -1, y.long()[:, None]).mean()


def train(cfg: BonsaiConfig, X: np.ndarray, y: np.ndarray, steps: int = 300,
          lr: float = 0.3, seed: int = 0,
          device: torch.device | str | None = None,
          history: list[float] | None = None) -> dict[str, np.ndarray]:
    """Plain full-batch gradient descent; keeps Z's sparsity mask (IHT-style,
    like Bonsai's projected gradient on a sparse support).  The only
    randomness is :func:`init_params`'s numpy draw from ``seed``.  Runs on
    ``device`` (None: the card) and returns numpy arrays.  ``history``, if
    given, receives each step's loss (before the step), read back to the
    host."""
    return descend(init_params(cfg, seed),
                   lambda p, Xt, yt: loss_fn(p, cfg, Xt, yt), X, y,
                   mask_key="Z", steps=steps,
                   lr=dict.fromkeys(param_shapes(cfg), lr), device=device,
                   history=history)


def descend(init: dict[str, np.ndarray], loss, X: np.ndarray, y: np.ndarray,
            *, mask_key: str, steps: int, lr: dict[str, float],
            device: torch.device | str | None,
            history: list[float] | None) -> dict[str, np.ndarray]:
    """Full-batch gradient descent from ``init`` on ``loss(params, X, y)``
    through ``torch.autograd``, a step size per parameter, projecting
    ``mask_key`` back onto its initial support after every step (the
    reference's update, ``p - lr * g``).  Returns numpy arrays."""
    dev = resolve_device(device)
    params = {k: torch.as_tensor(v, device=dev) for k, v in init.items()}
    mask = (params[mask_key] != 0).to(torch.float32)
    Xt = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y), device=dev).long()
    for _ in range(steps):
        for p in params.values():
            p.requires_grad_(True)
        value = loss(params, Xt, yt)
        if history is not None:
            history.append(float(value.detach()))
        grads = torch.autograd.grad(value, list(params.values()))
        with torch.no_grad():
            params = {k: p - lr[k] * g
                      for (k, p), g in zip(params.items(), grads)}
            params[mask_key] = params[mask_key] * mask
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def accuracy(params: dict[str, Any], cfg: BonsaiConfig, X: np.ndarray,
             y: np.ndarray) -> float:
    with torch.no_grad():
        logits = predict(params, cfg, torch.as_tensor(np.asarray(X, np.float32)))
    return float((logits.argmax(-1).numpy() == y).mean())
