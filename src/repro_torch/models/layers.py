"""Common layers of the LM stack, in PyTorch.

The port of the JAX package's ``models/layers.py`` for the dense and MoE
families: vocabulary padding, RMSNorm with fp32 statistics, the SwiGLU MLP,
RoPE tables and the half-split rotation, and the he-scaled normal
initializer.
Parameters are plain tensors (``nn.Module``s hold them one level up, in
:mod:`repro_torch.models.transformer`).

Every product that the reference computes with
``preferred_element_type=float32`` goes through :func:`dot_f32` (or
:func:`bmm_f32`, over the MoE expert axis), so that a
bfloat16 activation meets a bfloat16 weight and gives an fp32 result without
being rounded to bfloat16 first.  Float32 products run in full float32: the
model turns TF32 off on the card.  On the card such a bfloat16 product is
``torch.mm``/``torch.bmm`` with ``out_dtype=torch.float32``, which autograd
cannot differentiate; :class:`ProductF32` wraps it with the reference's
gradient: XLA transposes ``dot_general(x, w) → f32`` on bfloat16 operands
into ``convert(dot_general(g_f32, w) → f32, bf16)``, an fp32 product of the
fp32 cotangent with the other operand upcast, rounded once (on the CPU its
forward upcasts both operands: the same values).  :func:`cross_entropy_loss`
is the reference's next-token loss.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

__all__ = ["pad_vocab", "he_init", "normal_init", "rms_norm", "dot_f32",
           "bmm_f32", "ProductF32", "init_mlp", "mlp_swiglu", "swiglu_partial",
           "rope_table",
           "apply_rope", "cross_entropy_loss", "MM_F32_ROUTE"]


def pad_vocab(vocab_size: int, multiple: int = 256) -> int:
    """Pad the vocabulary so embedding/logits shard evenly over the mesh."""
    return ((vocab_size + multiple - 1) // multiple) * multiple


def normal_init(gen: torch.Generator, shape: tuple[int, ...], scale: float,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``scale`` × a standard normal draw from ``gen``, made in float32 on
    the generator's device and then cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(scale).to(dtype)


def he_init(gen: torch.Generator, shape: tuple[int, ...], fan_in: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """He-scaled normal weights, standard deviation ``1/sqrt(fan_in)``."""
    return normal_init(gen, shape, 1.0 / math.sqrt(max(1, fan_in)), dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 statistics; returns in ``x.dtype``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


# Which route gave bfloat16 products an fp32 result on the card:
# "out_dtype" (torch.mm(..., out_dtype=torch.float32)) or "upcast" (fp32
# copies of both operands); set at the first such product.
MM_F32_ROUTE: dict[str, str] = {}


def _mm_bf16_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # meta tensors (a step counted, shapes only) take the out_dtype route
    route = MM_F32_ROUTE.get("bfloat16") if a.device.type == "cuda" else "out_dtype"
    if route is None:                  # probe once, on two tiny operands
        one = torch.ones((1, 1), dtype=torch.bfloat16, device=a.device)
        try:
            torch.mm(one, one, out_dtype=torch.float32)
            route = "out_dtype"
        except (TypeError, RuntimeError, NotImplementedError):
            route = "upcast"
        MM_F32_ROUTE["bfloat16"] = route
    if route == "out_dtype":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class ProductF32(torch.autograd.Function):
    """``a @ b`` of two bfloat16 operands, (M, K) × (K, N) or batched (E, M,
    K) × (E, K, N), with an fp32 result: on the card by the ``out_dtype``
    route, on the CPU by upcast operands.  The backward is the reference's:
    ``da = (g @ bᵀ.float())`` and ``db = (aᵀ.float() @ g)``, fp32 products
    rounded once to the operands' dtype (what autograd gives the upcast
    product).  On meta tensors (a step counted) the card's ``out_dtype``
    route."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        if a.numel() == 0 or b.numel() == 0:    # an empty piece of a split
            return a.new_zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
        if a.device.type == "cpu":
            return a.float() @ b.float()
        if a.dim() == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return _mm_bf16_f32(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (g @ b.float().mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = (a.float().mT @ g).to(b.dtype)
        return da, db


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` with an fp32 result, ``x``
    (..., K) and ``w`` (K, N) of one dtype: the reference's einsum with
    ``preferred_element_type=float32``.  A bfloat16 product is
    :class:`ProductF32`: on the CPU both operands are upcast (bfloat16
    products are exact in float32); on the card it keeps its operands and
    accumulates in fp32."""
    lead = x.shape[:-1]
    a = x.reshape(math.prod(lead), x.shape[-1])     # K may be 0: an empty piece
    if x.dtype == torch.float32:
        out = a @ w
    elif x.dtype == torch.bfloat16:
        out = ProductF32.apply(a, w)
    else:
        out = a.float() @ w.float()
    return out.reshape(*lead, w.shape[-1])


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over a leading batch axis, ``a`` (E, M, K) and ``b`` (E,
    K, N) of one dtype, with an fp32 result: the reference's
    ``einsum("ecd,edf->ecf", ..., preferred_element_type=float32)``.  A
    bfloat16 product is :class:`ProductF32`: on the card it keeps its
    operands (the (E, K, N) weight stacks are never upcast in the forward);
    on the CPU both are upcast."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.dtype == torch.bfloat16:
        return ProductF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


# -------------------------------------------------------------------- SwiGLU
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    return {
        "w_gate": he_init(gen, (d_model, d_ff), d_model, dtype),
        "w_up": he_init(gen, (d_model, d_ff), d_model, dtype),
        "w_down": he_init(gen, (d_ff, d_model), d_ff, dtype),
    }


def mlp_swiglu(p: dict[str, torch.Tensor], x: torch.Tensor,
               split: Any = None) -> torch.Tensor:
    """SwiGLU with the gate and up products in fp32, the hidden state
    rounded to ``x.dtype`` once, and the down product rounded once.  Under
    a :class:`~repro_torch.sharding.tp.ModelSplit` with FFN columns this
    rank computes its columns (``w_gate``/``w_up`` column-parallel,
    ``w_down`` row-parallel): the down product's fp32 partial sums are
    all-reduced over ``model`` before the one rounding."""
    dt = x.dtype
    if split is None or split.ffn is None:
        g = dot_f32(x, p["w_gate"].to(dt))
        u = dot_f32(x, p["w_up"].to(dt))
        h = (F.silu(g) * u).to(dt)
        return dot_f32(h, p["w_down"].to(dt)).to(dt)
    from repro_torch.sharding.tp import copy_to_model, reduce_from_model

    part = swiglu_partial(p, copy_to_model(x, split), split, split.ffn, "mlp")
    return reduce_from_model(part, split).to(dt)


def swiglu_partial(p: dict[str, torch.Tensor], x: torch.Tensor, split: Any,
                   rng: tuple[int, int], group: str) -> torch.Tensor:
    """This rank's fp32 partial sums of a SwiGLU split over its columns
    ``rng`` (the leaves of ``blocks/<group>/``, their shards or slices of
    the whole ones): ``x`` must come through ``tp.copy_to_model``, and
    the result be all-reduced over ``model`` before its one rounding."""
    dt = x.dtype
    g = dot_f32(x, split.take(p, "w_gate", group, 1, rng).to(dt))
    u = dot_f32(x, split.take(p, "w_up", group, 1, rng).to(dt))
    h = (F.silu(g) * u).to(dt)
    return dot_f32(h, split.take(p, "w_down", group, 0, rng).to(dt))


# ----------------------------------------------------------------------- RoPE
def rope_freqs(dim: int, theta: float, device: torch.device | None = None
               ) -> torch.Tensor:
    half = dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_table(seq_len: int, dim: int, theta: float = 1e4, offset: int = 0,
               *, device: torch.device | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(seq_len, dim/2) cos/sin tables starting at absolute position ``offset``."""
    freqs = rope_freqs(dim, theta, device)
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    ang = pos[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the last axis (not interleaved pairs);
    ``x``: (..., S, H, dim), tables: (S, dim/2) or (B, S, dim/2)."""
    half = x.shape[-1] // 2
    c = cos[..., :, None, :].float()
    s = sin[..., :, None, :].float()
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------- cross entropy
def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                       vocab_size: int,
                       mask: torch.Tensor | None = None,
                       split: Any = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood: ``logits`` (B, S, Vp),
    possibly vocab-padded (the padded columns masked to -1e30), ``targets``
    (B, S) integers; the log-sum-exp in float32; ``mask`` (B, S), 1.0 where
    a position counts.  Under a :class:`~repro_torch.sharding.tp.
    ModelSplit` whose head is split over the vocabulary, ``logits`` are this
    rank's columns ``split.vocab_out``: the row max, the sum of
    exponentials and the gold logit are each reduced over ``model``, and
    the padded columns are masked by their global index."""
    lf = logits.float()
    vocab_split = split is not None and split.vocab_out is not None
    v0 = split.vocab_out[0] if vocab_split else 0
    vp = lf.shape[-1]
    col = torch.arange(v0, v0 + vp, device=lf.device)
    if v0 + vp > vocab_size:
        lf = lf.masked_fill(col >= vocab_size, -1e30)
    if not vocab_split:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    else:
        from repro_torch.sharding.tp import max_over_model, reduce_from_model

        # an empty piece (an uneven split's trailing rank): a row max of
        # -inf, no exponentials, no gold logit (lf's empty sums keep it in
        # the graph)
        mx = max_over_model(lf.amax(dim=-1) if vp else
                            lf.new_full(lf.shape[:-1], -torch.inf), split)
        sumexp = reduce_from_model(torch.exp(lf - mx[..., None]).sum(dim=-1),
                                   split)
        logz = torch.log(sumexp) + mx
        t = targets.long() - v0
        mine = (t >= 0) & (t < vp)
        local = (torch.gather(lf, -1, t.clamp(0, vp - 1)[..., None])[..., 0]
                 if vp else lf.sum(dim=-1))
        gold = reduce_from_model(torch.where(mine, local, torch.zeros_like(local)),
                                 split)
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    m = mask.float()
    return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
