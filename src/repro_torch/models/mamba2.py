"""Mamba2 (SSD, state-space duality) block, in PyTorch: mamba2-1.3b and
zamba2-7b's backbone.

The port of the JAX package's ``models/mamba2.py``.  The recurrence, per
head, with a state h_t of (N, P):

    h_t = exp(a_t) · h_{t-1} + b_t ⊗ x_t            y_t = c_t · h_t

Prefill runs the chunked SSD algorithm (:func:`ssd_chunked`): chunks of Q
steps, the within-chunk part in the quadratic form with the decay matrix
L[t, s] = exp(A_t − A_s), the cross-chunk part through an O(S / Q) scan of
chunk-boundary states.  Decode (:func:`mamba2_decode`) is the O(1) step
against a carried (H, N, P) state, updated in place.  The reference has no
Pallas kernel here, so neither has the port: both are PyTorch ops, held
against the sequential oracle :func:`repro_torch.kernels.ref.
mamba2_ssd_ref`.

The projections are separate weights (``w_z``, ``w_x``, ``w_b``, ``w_c``,
``w_dt``) with one depthwise causal conv per component, under the
reference's leaf names.  Casting points are the reference's: each
projection is an fp32 product rounded to the activation dtype once
(``layers.dot_f32``); the convs run in the activation dtype; ``dt``, its
softplus, the decay, the scan and ``D·x`` run in float32; ``A_log``, ``D``
and ``dt_bias`` are float32 whatever the parameter dtype; the carried state
``h`` is float32 and the conv states are in the activation dtype.

Under a :class:`~repro_torch.sharding.tp.ModelSplit` with SSM heads
(``split.ssm``) a layer runs on this rank's heads: its input comes
through ``tp.copy_to_model``; ``w_z``/``w_x``/``conv_x_*`` give the local
channels (their shards, or slices of whole leaves); ``A_log``, ``D``,
``dt_bias`` and the gate ``norm`` are read at the local heads and
channels; ``w_dt``'s product is taken whole and its local heads' columns
kept (``dt`` is then the unsplit model's bitwise); ``w_b``/``w_c`` and
their convs are used whole (every rank computes the same b and c); the
scan needs no collective.  The gated RMSNorm spans the
whole ``d_inner``: its fp32 sum of squares over the local channels is
summed over ``model`` (:func:`~repro_torch.sharding.tp.sum_over_model`,
whose backward all-reduces too: every rank's output depends on every
rank's squares) and divided by the whole width; ``out_proj`` is
row-parallel, its fp32 partial sums all-reduced before the one rounding.
The states (``h`` over the local heads, ``conv_x`` over the local
channels) are the rank's.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dot_f32, he_init, normal_init, rms_norm
from repro_torch.sharding import tp

__all__ = ["init_mamba2", "ssd_chunked", "mamba2_prefill", "mamba2_decode",
           "gated_rms_norm"]


def init_mamba2(gen: torch.Generator, d_model: int, *, d_state: int,
                head_dim: int = 64, expand: int = 2, conv_width: int = 4,
                dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Random weights from ``gen`` with the reference's distribution:
    he-scaled projections, N(0, 0.1²) conv taps, zero conv biases, ``A_log``
    0 (A = −1), ``D`` 1, ``dt_bias`` 0 (float32), a unit gate norm."""
    d_inner = expand * d_model
    H, N, dev = d_inner // head_dim, d_state, gen.device

    def zeros(n, dt=dtype):
        return torch.zeros((n,), dtype=dt, device=dev)

    return {
        "w_z": he_init(gen, (d_model, d_inner), d_model, dtype),
        "w_x": he_init(gen, (d_model, d_inner), d_model, dtype),
        "w_b": he_init(gen, (d_model, N), d_model, dtype),
        "w_c": he_init(gen, (d_model, N), d_model, dtype),
        "w_dt": he_init(gen, (d_model, H), d_model, dtype),
        "conv_x_w": normal_init(gen, (conv_width, d_inner), 0.1, dtype),
        "conv_x_b": zeros(d_inner),
        "conv_b_w": normal_init(gen, (conv_width, N), 0.1, dtype),
        "conv_b_b": zeros(N),
        "conv_c_w": normal_init(gen, (conv_width, N), 0.1, dtype),
        "conv_c_b": zeros(N),
        "A_log": zeros(H, torch.float32),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": zeros(H, torch.float32),
        "norm": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": he_init(gen, (d_inner, d_model), d_inner, dtype),
    }


def _dims(p: Mapping[str, torch.Tensor]) -> tuple[int, int, int, int]:
    d_inner = p["w_z"].shape[1]
    H = p["A_log"].shape[0]
    return d_inner, H, p["w_b"].shape[1], d_inner // H


def _local(p: Mapping[str, torch.Tensor], split
           ) -> tuple[Mapping[str, torch.Tensor], object]:
    """(the leaves this rank reads, the split or None where the layer is
    not split over SSM heads)."""
    if split is None or split.ssm is None:
        return p, None
    out = dict(p.items())
    for name, (dim, what, _) in tp.SSM_LEAVES.items():
        out[name] = split.take(p, name, "ssm", dim, getattr(split, what))
    return out, split


def gated_rms_norm(u: torch.Tensor, weight: torch.Tensor, split=None,
                   eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of the gated output ``u`` over the whole ``d_inner``: under
    a split of the channels ``u`` and ``weight`` are this rank's and the
    fp32 sum of squares is summed over ``model`` before it is divided by
    the whole width (the local width × m)."""
    if split is None:
        return rms_norm(u, weight, eps)
    uf = u.float()
    ss = tp.sum_over_model(torch.sum(uf * uf, dim=-1, keepdim=True), split)
    var = ss / (uf.shape[-1] * split.m)
    return (uf * torch.rsqrt(var + eps) * weight.float()).to(u.dtype)


def _proj(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return dot_f32(x, w.to(x.dtype)).to(x.dtype)


def _dt_proj(p: Mapping[str, torch.Tensor], x: torch.Tensor, split
             ) -> torch.Tensor:
    """x's ``dt`` logits, of this rank's heads under a split: the product
    with the whole ``w_dt`` (H columns, a small product), then the local
    heads' columns, so that they are the unsplit model's bitwise (a
    product over fewer columns may sum in another order)."""
    dtr = _proj(p["w_dt"], x)
    return dtr if split is None else dtr[..., split.ssm[0]:split.ssm[1]]


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x · sigmoid(x)``, two roundings in x's dtype, as ``jax.nn.silu``."""
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` in the reference's form: max(x, 0) + log1p(e^−|x|)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(w: torch.Tensor, bias: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) by explicit shifts, in u's
    dtype, then SiLU."""
    wt = w.to(u.dtype)
    W, S = wt.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, W - 1, 0))
    out = up[:, 0:S, :] * wt[0]
    for j in range(1, W):
        out = out + up[:, j:j + S, :] * wt[j]
    return _silu(out + bias.to(u.dtype))


def _conv_step(w: torch.Tensor, bias: torch.Tensor, state: torch.Tensor,
               u_new: torch.Tensor) -> torch.Tensor:
    """One decode step of the depthwise conv: ``state`` (B, W − 1, C) is
    shifted in place to hold the newest W − 1 inputs; returns (B, 1, C).
    The taps are summed in float32 and rounded once, as the reference's
    einsum is (in bfloat16 now and then one ulp off the prefill's sum,
    which rounds after every tap)."""
    wt = w.to(u_new.dtype)
    window = torch.cat([state, u_new], dim=1)                  # (B, W, C)
    state.copy_(window[:, 1:])
    out = (window.float() * wt.float()).sum(1, keepdim=True).to(u_new.dtype)
    return _silu(out + bias.to(u_new.dtype))


# -------------------------------------------------------------- chunked SSD
def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, *, chunk: int = 128,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan of x (B, S, H, P) (dt-scaled inputs), a (B, S, H) (decay
    logits, <= 0), b and c (B, S, N), from the state ``h0`` (B, H, N, P)
    (None: zeros).  Returns (y (B, S, H, P) in x's dtype, the final state
    (B, H, N, P) float32); fp32 inside.  The causal mask selects the decay
    matrix's exponent, −inf above the diagonal, before it is exponentiated:
    there A_t − A_s > 0 overflows exp at long chunks, and a mask applied
    after it (the reference's ``where``) leaves a zero gradient times inf,
    NaN, in the backward (a product with the mask would give inf · 0 in the
    values too); the values are the same either way.  Every product is
    pairwise: no tensor of (Q, Q, H, P) is built."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xf = x.float().reshape(B, nc, Q, H, P)
    af = a.float().reshape(B, nc, Q, H)
    bf = b.float().reshape(B, nc, Q, N)
    cf = c.float().reshape(B, nc, Q, N)

    A = torch.cumsum(af, dim=2)                                 # inclusive
    # within-chunk decay L[t, s] = exp(A_t − A_s) for s <= t: (B, nc, t, s, H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None],
                              A[:, :, :, None, :] - A[:, :, None, :, :],
                              float("-inf")))
    scores = torch.einsum("bcqn,bcsn->bcqs", cf, bf)            # (B, nc, Q, Q)
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", scores[..., None] * L, xf)
    del L

    # chunk-boundary states and the scan over chunks
    decay_end = torch.exp(A[:, :, -1:, :] - A)                  # (B, nc, Q, H)
    S_c = torch.einsum("bcsn,bcshp->bchnp", bf, decay_end[..., None] * xf)
    a_tot = torch.exp(A[:, :, -1, :])                           # (B, nc, H)
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for i in range(nc):
        h_prev.append(h)                                        # before chunk i
        h = a_tot[:, i, :, None, None] * h + S_c[:, i]
    y_off = (torch.einsum("bcqn,bchnp->bcqhp", cf, torch.stack(h_prev, dim=1))
             * torch.exp(A)[..., None])
    y = (y_diag + y_off).reshape(B, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h


# ------------------------------------------------------------ block forward
def mamba2_prefill(p: Mapping[str, torch.Tensor], x: torch.Tensor, *,
                   chunk: int = 128, split=None
                   ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Full-sequence forward of x (B, S, D).  Returns (y (B, S, D), (the
    final SSM state (B, H, N, P) float32, and the conv states (B, W − 1, C)
    of x, b and c: the last W − 1 pre-conv inputs, left-padded with zeros
    when S < W − 1)); under a ``split`` H and x's C are the rank's."""
    p, split = _local(p, split)
    x = tp.copy_to_model(x, split)
    d_inner, H, N, P = _dims(p)
    dt_ = x.dtype
    B, S, _ = x.shape
    z = _proj(p["w_z"], x)
    xc_pre = _proj(p["w_x"], x)
    b_pre = _proj(p["w_b"], x)
    c_pre = _proj(p["w_c"], x)
    dtr = _dt_proj(p, x, split)
    xc = _causal_conv(p["conv_x_w"], p["conv_x_b"], xc_pre)
    b = _causal_conv(p["conv_b_w"], p["conv_b_b"], b_pre)
    c = _causal_conv(p["conv_c_w"], p["conv_c_b"], c_pre)

    dt = _softplus(dtr.float() + p["dt_bias"])                  # (B, S, H)
    a = -torch.exp(p["A_log"])[None, None, :] * dt
    xh = xc.reshape(B, S, H, P)
    y, h_final = ssd_chunked(xh.float() * dt[..., None], a, b, c, chunk=chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_inner)
    zf = z.float()
    y = gated_rms_norm((y * _silu(zf)).to(dt_), p["norm"], split)
    out = tp.reduce_from_model(dot_f32(y, p["out_proj"].to(dt_)), split).to(dt_)

    W1 = p["conv_x_w"].shape[0] - 1

    def tail(u: torch.Tensor) -> torch.Tensor:
        if S >= W1:
            return u[:, S - W1:, :]
        return F.pad(u, (0, 0, W1 - S, 0))

    return out, (h_final, tail(xc_pre), tail(b_pre), tail(c_pre))


def mamba2_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                  state: tuple[torch.Tensor, ...], split=None
                  ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """One recurrence step of x (B, 1, D) against ``state`` = (the SSM
    state (B, H, N, P) float32, the conv states of x, b and c; under a
    ``split`` the rank's heads and channels), all updated in place.
    Returns (y (B, 1, D), state)."""
    p, split = _local(p, split)
    x = tp.copy_to_model(x, split)
    d_inner, H, N, P = _dims(p)
    ssm, cx, cb, cc = state
    dt_ = x.dtype
    B = x.shape[0]
    z = _proj(p["w_z"], x)
    xc_pre = _proj(p["w_x"], x)
    b_pre = _proj(p["w_b"], x)
    c_pre = _proj(p["w_c"], x)
    dtr = _dt_proj(p, x, split)
    xc = _conv_step(p["conv_x_w"], p["conv_x_b"], cx, xc_pre)
    b = _conv_step(p["conv_b_w"], p["conv_b_b"], cb, b_pre)
    c = _conv_step(p["conv_c_w"], p["conv_c_b"], cc, c_pre)

    dt = _softplus(dtr[:, 0].float() + p["dt_bias"])            # (B, H)
    a = torch.exp(-torch.exp(p["A_log"])[None, :] * dt)
    xr = xc[:, 0].reshape(B, H, P).float()
    xh = xr * dt[..., None]
    bf, cf = b[:, 0].float(), c[:, 0].float()
    ssm.mul_(a[:, :, None, None]).add_(bf[:, None, :, None] * xh[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", cf, ssm)
    y = y + p["D"][None, :, None] * xr
    y = y.reshape(B, 1, d_inner)
    y = gated_rms_norm((y * _silu(z.float())).to(dt_), p["norm"], split)
    out = tp.reduce_from_model(dot_f32(y, p["out_proj"].to(dt_)), split).to(dt_)
    return out, state
