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

Split over ``model`` (a :class:`~repro_torch.sharding.tp.ModelSplit`):
every rank holds every token of its rows (the residual stream is whole
over ``model``), so the dispatch needs no all-to-all.  The router runs on
the whole tokens (its logits' columns all-gathered in fp32 before the
softmax where the plan splits it: bitwise the unsplit logits), so every
rank makes the same choices; a rank scatters into, and runs the expert
products on, only its experts' slots ``[e0·cap, e1·cap)``, and its
combine (zeros for the other experts' copies) is an fp32 partial sum that
one all-reduce over ``model`` completes, with the shared experts' column
partials folded in, before the one rounding.  The paths whose gradient is
partial read the input through ``tp.copy_to_model``; the aux loss is the
unsplit value on every rank, its gradient scaled by 1/m where the ranks'
gradients are summed.

Over the data-parallel ranks of a train step (``sharding.ctx.
token_group``: ``pod`` × ``data``, or ``data`` within a pod under the int8
cross-pod reduce) the layer routes over the whole microbatch, as the
reference's GSPMD does: the capacity comes from the group's tokens, each
copy's position adds the earlier ranks' per-choice, per-expert counts
(one all-gather of a (k, E) integer tensor), and the aux loss's ``f`` and
``p`` are summed over the group before their product.  A rank's buffer
has the group's capacity, so it holds every slot of its experts, and only
its own tokens' copies are non-zero: at data n a rank allocates, runs the
expert products on, and keeps for the backward about n times the slots of
its own tokens (the reference's GSPMD buffer is replicated over ``data``
as well).  The expert products are row by row, so the rank's slots hold
the reference's values.

Served under FSDP (``data``, a :class:`~repro_torch.sharding.tp.
DataSplit` whose plan shards the experts over ``data`` on ``d_model``) a
rank holds its ``d_model`` shard of the experts and moves the buffer, not
the weights: the token group's buffers are summed (each slot holds one
rank's copy, or none), each rank multiplies its shard of the buffer's
columns by its shard of ``w_gate``/``w_up`` and the fp32 partial sums are
summed over ``data``, and ``w_down``'s output columns are gathered over
``data``.  A decode step's buffer is a few rows an expert; the experts'
weights are most of the model.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.layers import (bmm_f32, he_init, mlp_swiglu,
                                       swiglu_partial)
from repro_torch.sharding.ctx import all_gather_flat, token_group
from repro_torch.sharding.tp import (copy_to_model, gather_from_model,
                                     reduce_from_model)

__all__ = ["init_moe", "moe_leaves", "moe_ffn", "capacity", "route"]


def init_moe(gen: torch.Generator, d_model: int, d_ff_expert: int,
             n_experts: int, *, n_shared: int = 0,
             dtype: torch.dtype = torch.float32) -> dict:
    p: dict = {}
    for path, t in moe_leaves(gen, d_model, d_ff_expert, n_experts,
                              n_shared=n_shared, dtype=dtype):
        *head, leaf = path.split("/")
        (p.setdefault(head[0], {}) if head else p)[leaf] = t
    return p


def moe_leaves(gen: torch.Generator, d_model: int, d_ff_expert: int,
               n_experts: int, *, n_shared: int = 0,
               dtype: torch.dtype = torch.float32):
    """:func:`init_moe`'s leaves one at a time, in its draw order, as
    (path under the layer's ``moe`` group, tensor): a caller that keeps a
    slice of each (a rank's experts) holds one whole leaf at a time."""
    E, D, Fe = n_experts, d_model, d_ff_expert
    yield "router", he_init(gen, (D, E), D, torch.float32)  # router stays fp32
    yield "w_gate", he_init(gen, (E, D, Fe), D, dtype)
    yield "w_up", he_init(gen, (E, D, Fe), D, dtype)
    yield "w_down", he_init(gen, (E, Fe, D), Fe, dtype)
    if n_shared:
        Fs = n_shared * d_ff_expert
        yield "shared/w_gate", he_init(gen, (D, Fs), D, dtype)
        yield "shared/w_up", he_init(gen, (D, Fs), D, dtype)
        yield "shared/w_down", he_init(gen, (Fs, D), Fs, dtype)


def capacity(tokens: int, k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert for ``tokens`` tokens: ``max(k, ⌊T·k·cf / E⌋)``
    rounded up to a multiple of 4, computed on the host from the shape."""
    cap = max(k, int(tokens * k * capacity_factor / n_experts))
    return -(-cap // 4) * 4


def route(router: torch.Tensor, xt: torch.Tensor, k: int, cap: int):
    """The router's choices for ``xt`` (T, D): (gates (T, E) fp32, top_g
    (T, k) renormalised, top_i (T, k), slot (T, k), keep (T, k) bool)."""
    return _route(xt.float() @ router.float(), k, cap)


def _route(logits: torch.Tensor, k: int, cap: int, tokens=None):
    """:func:`route` from the router's fp32 logits (T, E); with ``tokens``
    (a token group, :func:`~repro_torch.sharding.ctx.token_group`) each
    copy's position counts the group's earlier tokens too."""
    gates = torch.softmax(logits, dim=-1)
    top_g, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_i = top_g[:, :k], top_i[:, :k]
    top_g = top_g / torch.clamp_min(top_g.sum(-1, keepdim=True), 1e-9)
    slot, keep = _slots(top_i, logits.shape[1], cap, tokens)
    return gates, top_g, top_i, slot, keep


def _slots(top_i: torch.Tensor, E: int, cap: int, tokens=None):
    """Each (token, choice) pair's slot and whether it is kept, for the
    choices ``top_i`` (T, k) of ``E`` experts at capacity ``cap``: (slot
    (T, k), keep (T, k) bool)."""
    T, k = top_i.shape
    # slot assignment: a running count per expert in choice-major order
    # (every token's first choice, then every token's second, ...).  The
    # reference counts choice by choice, adding the earlier choices'
    # totals; one cumsum over the choice-major copies gives the same
    # integers.  Over a token group, the copies of choice j on rank d
    # follow every rank's copies of the earlier choices and the earlier
    # ranks' copies of choice j.
    e = top_i.t().reshape(-1)                                   # (k·T,)
    onehot = (e[:, None] == torch.arange(E, device=e.device)[None, :]).long()
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, e[:, None])[:, 0]
    if tokens is not None:
        group, n, me = tokens
        counts = onehot.reshape(k, T, E).sum(1)                 # (k, E)
        every = counts.new_empty((n * k * E,))
        all_gather_flat(every, counts.contiguous(), group)
        every = every.reshape(n, k, E)
        # the other ranks' copies of the earlier choices, and the earlier
        # ranks' of this one (this rank's own earlier choices are in pos)
        before = (torch.cumsum(every.sum(0) - counts, dim=0) - (
            every.sum(0) - counts)) + every[:me].sum(0)         # (k, E)
        pos = pos + before.reshape(-1)[
            torch.arange(k, device=e.device).repeat_interleave(T) * E + e]
    keep = pos < cap
    slot = torch.where(keep, e * cap + pos, torch.zeros_like(pos))
    return slot.reshape(k, T).t(), keep.reshape(k, T).t()


class _SumOverGroup(torch.autograd.Function):
    """An all-reduce over ``group`` whose backward all-reduces too: the
    derivative of a statistic every rank's loss reads."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def moe_ffn(p: dict, x: torch.Tensor, *, k: int,
            capacity_factor: float = 1.25, split=None, data=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in ``x.dtype``, aux load-balance loss, a
    float32 scalar on ``x``'s device).  Under a ``split`` over ``model``
    (see the module docstring) the output and the aux loss are the whole
    ones on every rank; with ``data`` the experts are this rank's
    ``d_model`` shard of them (FSDP, serving)."""
    B, S, D = x.shape
    ep = split is not None and split.experts is not None
    rs = split is not None and split.router is not None
    sh = split is not None and split.shared is not None and "shared" in p
    T = B * S
    tokens = token_group()
    dt = x.dtype

    xt = x.reshape(T, D)
    # the paths whose gradient a rank holds only in part read xs
    xs = copy_to_model(xt, split) if (ep or rs or sh) else xt
    logits = (xs if (ep or rs) else xt).float() @ p["router"].float()
    if rs:          # beside split experts the logits' gradient is partial
        logits = gather_from_model(logits, -1, split, grad_sum=ep, of="router")
    E = logits.shape[-1]
    cap = capacity(T * (tokens[1] if tokens else 1), k, E, capacity_factor)
    gates, top_g, top_i, slot, keep = _route(logits, k, cap, tokens)
    flat = slot.reshape(-1)
    e0, e1 = split.experts if ep else (0, E)
    if ep:      # this rank's experts' slots, at local indices
        keep = keep & (slot >= e0 * cap) & (slot < e1 * cap)
        flat = torch.where(keep, slot - e0 * cap, torch.zeros_like(slot)
                           ).reshape(-1)
    take = ((lambda name: split.take(p, name, "moe", 0, split.experts))
            if ep else p.__getitem__)

    # dispatch: one scatter-add of every token copy (dropped ones add zeros)
    xe = xs if ep else xt
    contrib = (xe[:, None, :] * keep[..., None].to(dt)).reshape(T * k, D)
    buf = torch.zeros(((e1 - e0) * cap, D), dtype=dt, device=x.device)
    if e1 > e0:
        buf.index_add_(0, flat, contrib)
    if data is not None and tokens is not None:   # every rank's copies
        whole = buf.float()
        dist.all_reduce(whole, group=tokens[0])
        buf = whole.to(dt)
    eb = buf.reshape(e1 - e0, cap, D)

    # expert computation: batched SwiGLU over the expert axis (under FSDP
    # on this rank's d_model columns, the partial sums summed over data)
    if data is None:
        g = bmm_f32(eb, take("w_gate").to(dt))
        u = bmm_f32(eb, take("w_up").to(dt))
    else:
        c0, c1 = data.cols(D)
        ebd = eb[..., c0:c1].contiguous()
        g = data.sum(bmm_f32(ebd, take("w_gate").to(dt)))
        u = data.sum(bmm_f32(ebd, take("w_up").to(dt)))
    h = (F.silu(g) * u).to(dt)
    if data is None:
        eo = bmm_f32(h, take("w_down").to(dt)).to(dt)
    else:           # every rank's slots: whole over data once gathered
        eo = data.gather_cols(bmm_f32(h, take("w_down").to(dt)).to(dt))

    # combine: one gather of every choice's slot output, weighted in fp32
    # over exact products of the activation-dtype operands, rounded once
    # (split: the fp32 partial sums all-reduced over `model` first; a rank
    # with no experts, an uneven split's trailing one, adds zeros: its
    # empty outputs' sum keeps them in the graph)
    if e1 > e0:
        gathered = torch.index_select(eo.reshape((e1 - e0) * cap, D), 0,
                                      flat).reshape(T, k, D)
        w = (top_g * keep.float()).to(dt)
        out = torch.einsum("tkd,tk->td", gathered.float(), w.float())
    else:
        out = eo.float().sum(dim=(0, 1)).expand(T, D)

    if sh:          # the shared experts' column partials ride along
        out = out + swiglu_partial(p["shared"], xs, split, split.shared,
                                   "moe/shared")
    if ep:
        out = reduce_from_model(out, split)
    out = out.to(dt)
    if "shared" in p and not sh:            # deepseek: always-on SwiGLU
        out = out + mlp_swiglu(p["shared"], xt)

    # aux loss: fraction dispatched (first choice) × mean router probability
    first = (top_i[:, 0:1] == torch.arange(E, device=x.device)[None, :]).float()
    if tokens is None:
        f, pr = first.mean(0), gates.mean(0)
    else:                             # over the whole microbatch
        n_tok = T * tokens[1]
        f, pr = _SumOverGroup.apply(torch.stack([first.sum(0), gates.sum(0)]),
                                    tokens[0]) / n_tok
    aux = E * torch.sum(f * pr)
    if ep:          # every rank's aux gradient is summed over `model`
        aux = _ScaleGrad.apply(aux, 1.0 / split.m)
    return out.reshape(B, S, D), aux
