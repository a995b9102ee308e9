"""Mixture-of-Experts FFN with top-k routing and capacity dispatch, in PyTorch.

The port of the JAX package's ``models/moe.py`` (olmoe: 64 experts, top-8;
deepseek-v2: 2 shared + 160 routed, top-6), function for function:

* the router stays float32, whatever the activation or parameter dtype, at
  its weights and at its logits;
* top-k ties go to the lower expert index (``jax.lax.top_k``'s order): the
  choice is a stable descending sort, since ``torch.topk`` promises no order
  among equal values;
* the capacity ``cap`` is a host integer from the shape, and each (token,
  choice) pair gets the slot ``expert·cap + position`` from a choice-major
  running count per expert (one cumsum over the copies in that order);
  copies past ``cap`` are dropped to slot 0 with a zero contribution;
* the dispatch adds (``index_add_``), never assigns: dropped copies share
  slot 0, and each slot receives one non-zero term, so the buffer is the
  reference's exactly;
* the expert products are batched matrix products over the expert axis,
  bfloat16 operands with an fp32 result (``layers.bmm_f32``), as the
  reference's einsums outside any Pallas kernel;
* the combine gathers the expert outputs in the activation dtype with the
  weights ``top_g · keep``; shared experts are one dense SwiGLU; the aux
  loss is ``E · Σ_e f_e · p_e`` over first choices.

Nothing reads a value back to the host (no ``.item()``, no ``nonzero``, no
boolean indexing), so a decode step through it stays free of
synchronisation.  There is no ``shard_act`` (the identity outside a mesh).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import bmm_f32, he_init, mlp_swiglu

__all__ = ["init_moe", "moe_ffn", "capacity", "route"]


def init_moe(gen: torch.Generator, d_model: int, d_ff_expert: int,
             n_experts: int, *, n_shared: int = 0,
             dtype: torch.dtype = torch.float32) -> dict:
    E, D, Fe = n_experts, d_model, d_ff_expert
    p: dict = {
        "router": he_init(gen, (D, E), D, torch.float32),  # router stays fp32
        "w_gate": he_init(gen, (E, D, Fe), D, dtype),
        "w_up": he_init(gen, (E, D, Fe), D, dtype),
        "w_down": he_init(gen, (E, Fe, D), Fe, dtype),
    }
    if n_shared:
        Fs = n_shared * d_ff_expert
        p["shared"] = {
            "w_gate": he_init(gen, (D, Fs), D, dtype),
            "w_up": he_init(gen, (D, Fs), D, dtype),
            "w_down": he_init(gen, (Fs, D), Fs, dtype),
        }
    return p


def capacity(tokens: int, k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert for ``tokens`` tokens: ``max(k, ⌊T·k·cf / E⌋)``
    rounded up to a multiple of 4, computed on the host from the shape."""
    cap = max(k, int(tokens * k * capacity_factor / n_experts))
    return -(-cap // 4) * 4


def route(router: torch.Tensor, xt: torch.Tensor, k: int, cap: int):
    """The router's choices for ``xt`` (T, D): (gates (T, E) fp32, top_g
    (T, k) renormalised, top_i (T, k), slot (T, k), keep (T, k) bool)."""
    E = router.shape[-1]
    logits = xt.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)
    top_g, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_i = top_g[:, :k], top_i[:, :k]
    top_g = top_g / torch.clamp_min(top_g.sum(-1, keepdim=True), 1e-9)

    # slot assignment: a running count per expert in choice-major order
    # (every token's first choice, then every token's second, ...).  The
    # reference counts choice by choice, adding the earlier choices'
    # totals; one cumsum over the choice-major copies gives the same
    # integers.
    T = xt.shape[0]
    e = top_i.t().reshape(-1)                                   # (k·T,)
    onehot = (e[:, None] == torch.arange(E, device=xt.device)[None, :]).long()
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, e[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, e * cap + pos, torch.zeros_like(pos))
    return (gates, top_g, top_i, slot.reshape(k, T).t(),
            keep.reshape(k, T).t())


def moe_ffn(p: dict, x: torch.Tensor, *, k: int,
            capacity_factor: float = 1.25) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in ``x.dtype``, aux load-balance loss, a
    float32 scalar on ``x``'s device)."""
    B, S, D = x.shape
    E = p["router"].shape[-1]
    T = B * S
    cap = capacity(T, k, E, capacity_factor)
    dt = x.dtype

    xt = x.reshape(T, D)
    gates, top_g, top_i, slot, keep = route(p["router"], xt, k, cap)
    flat = slot.reshape(-1)

    # dispatch: one scatter-add of every token copy (dropped ones add zeros)
    contrib = (xt[:, None, :] * keep[..., None].to(dt)).reshape(T * k, D)
    buf = torch.zeros((E * cap, D), dtype=dt, device=x.device)
    buf.index_add_(0, flat, contrib)
    eb = buf.reshape(E, cap, D)

    # expert computation: batched SwiGLU over the expert axis
    g = bmm_f32(eb, p["w_gate"].to(dt))
    u = bmm_f32(eb, p["w_up"].to(dt))
    h = (F.silu(g) * u).to(dt)
    eo = bmm_f32(h, p["w_down"].to(dt)).to(dt)

    # combine: one gather of every choice's slot output, weighted in fp32
    # over exact products of the activation-dtype operands, rounded once
    gathered = torch.index_select(eo.reshape(E * cap, D), 0, flat).reshape(T, k, D)
    w = (top_g * keep.float()).to(dt)
    out = torch.einsum("tkd,tk->td", gathered.float(), w.float()).to(dt)

    if "shared" in p:                 # deepseek: always-on dense SwiGLU
        out = out + mlp_swiglu(p["shared"], xt)

    # aux loss: fraction dispatched (first choice) × mean router probability
    f = (top_i[:, 0:1] == torch.arange(E, device=x.device)[None, :]).float().mean(0)
    aux = E * torch.sum(f * gates.mean(0))
    return out.reshape(B, S, D), aux
