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
model turns TF32 off on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["pad_vocab", "he_init", "normal_init", "rms_norm", "dot_f32",
           "bmm_f32", "init_mlp", "mlp_swiglu", "rope_table", "apply_rope",
           "MM_F32_ROUTE"]


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
    route = MM_F32_ROUTE.get("bfloat16")
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


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` with an fp32 result, ``x``
    (..., K) and ``w`` (K, N) of one dtype: the reference's einsum with
    ``preferred_element_type=float32``.  On the CPU both operands are
    upcast (bfloat16 products are exact in float32); on the card a
    bfloat16 product keeps its operands and accumulates in fp32."""
    lead = x.shape[:-1]
    a = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = a @ w
    elif x.device.type == "cuda" and x.dtype == torch.bfloat16:
        out = _mm_bf16_f32(a, w)
    else:
        out = a.float() @ w.float()
    return out.reshape(*lead, w.shape[-1])


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over a leading batch axis, ``a`` (E, M, K) and ``b`` (E,
    K, N) of one dtype, with an fp32 result: the reference's
    ``einsum("ecd,edf->ecf", ..., preferred_element_type=float32)``.  On
    the card a bfloat16 product keeps its operands (the (E, K, N) weight
    stacks are never upcast); on the CPU both are upcast."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


# -------------------------------------------------------------------- SwiGLU
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    return {
        "w_gate": he_init(gen, (d_model, d_ff), d_model, dtype),
        "w_up": he_init(gen, (d_model, d_ff), d_model, dtype),
        "w_down": he_init(gen, (d_ff, d_model), d_ff, dtype),
    }


def mlp_swiglu(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU with the gate and up products in fp32, the hidden state
    rounded to ``x.dtype`` once, and the down product rounded once."""
    dt = x.dtype
    g = dot_f32(x, p["w_gate"].to(dt))
    u = dot_f32(x, p["w_up"].to(dt))
    h = (F.silu(g) * u).to(dt)
    return dot_f32(h, p["w_down"].to(dt)).to(dt)


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
