"""Attention of the LM stack, in PyTorch: GQA and MLA.

The port of the JAX package's ``models/attention.py``: ``plain_attention``
(the materialised oracle), ``flash_attention`` (the streaming-softmax
formulation, a loop over KV chunks with fp32 running statistics),
``init_gqa``, ``gqa_prefill`` and ``gqa_decode``, and deepseek-v2's
multi-head latent attention, ``init_mla``, ``mla_prefill`` and
``mla_decode``.

On the served path the attention itself runs on the port's hand-written
kernels: ``gqa_prefill`` calls
:func:`repro_torch.kernels.flash_attention.flash_attention_fused` and
``gqa_decode`` calls :func:`repro_torch.kernels.decode_attention.
decode_attention`; on CPU tensors those run their plain versions.  Both keep
p in fp32 unless ``probs_bf16`` asks for the rounding, so they compute the
reference model's function.  ``probs_bf16`` rounds p and v to bfloat16 for
the P·V product with an fp32 result, as the reference does: v is rounded
before the kernel (exact in float32) and the kernel rounds p
(``round_p=torch.bfloat16``).  ``gqa_prefill(..., plain=True)`` runs the
flash kernel's plain version on any device instead (a comparison, never the
served path).

Training: when autograd needs the attention's gradient (grad enabled and
q, k or v requiring it), ``gqa_prefill`` and ``mla_prefill`` run
:func:`repro_torch.kernels.flash_attention.flash_attention_train` instead
(the same forward kernel with a hand-written backward on the card, the plain
version on CPU tensors).  With ``probs_bf16`` the backward is the gradient
of the rounded p (the reference's ``jax.grad`` with one KV chunk: the row
max attached, its argmax key taking the rounding's share), and dv reaches
a float32 v through ``_bf16_v``'s rounding, as the reference's cast does.

``mla_prefill`` materialises per-head keys of width ``dn + dr`` (the
latent's up-projection and the shared rope key) and values of width ``dn``,
and runs the same flash kernel: the kernel takes k and v of one width, so v
is padded with zeros to ``dn + dr`` and the first ``dn`` columns of the
output are kept (zero columns of v leave the others untouched), and its
``dh ** -0.5`` is MLA's ``(dn + dr) ** -0.5``.  ``mla_decode`` is the
reference's absorbed form in plain products (the reference has no Pallas
kernel there): one latent "head" of width ``r + dr`` shared by every query
head, values of width ``r``.  ``rms_norm`` of the latents uses its default
eps, as the reference's does.

Sliding windows (zamba2's shared block at long context): ``gqa_prefill``
passes ``window`` to the flash kernel, and ``gqa_decode`` takes a
ring-buffer cache of width W through ``write_pos = pos % W`` (the slot
written) and ``valid_len = min(pos + 1, W)`` (the slots attended, the
kernel's ``cache_len``): a ring fills from slot 0 and RoPE was applied at
the absolute position, so slot order does not matter.  A window on a
full-length decode cache (a dense or MoE config with ``attn_window``, as
the reference's ``init_cache`` makes it) attends keys ``[max(0, pos + 1 −
W), pos + 1)``: the starts are made on the card from ``pos`` and the
decode kernel's grid covers W keys a row, not the cache.
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention_fused,
                                                 flash_attention_train)
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models.layers import (apply_rope, bmm_f32, dot_f32, he_init,
                                       rms_norm)
from repro_torch.sharding.tp import (copy_to_model, gather_from_model,
                                     reduce_from_model)

__all__ = ["init_gqa", "gqa_prefill", "gqa_decode", "init_mla", "mla_prefill",
           "mla_decode", "flash_attention", "plain_attention", "merge_by_lse",
           "latent_piece"]

_NEG = -1e30


# ----------------------------------------------------------- core attention
def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Naive materialized attention — the oracle for ``flash_attention``."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, KV, G, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_chunk: int = 1024, scale: float | None = None,
                    probs_bf16: bool = False) -> torch.Tensor:
    """Streaming-softmax attention: a loop over KV chunks, fp32 running
    stats.  ``probs_bf16`` casts p (and v) to bf16 for the P·V product."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dhv = v.shape[-1]
    G = H // KV
    scale = dh ** -0.5 if scale is None else scale
    kv_chunk = min(kv_chunk, Sk)
    qg = (q.float() * scale).reshape(B, Sq, KV, G, dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, KV, G, Sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, dhv), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, kv_chunk):
        kc, vc = k[:, c0:c0 + kv_chunk], v[:, c0:c0 + kv_chunk]
        kpos = torch.arange(c0, c0 + kc.shape[1], device=q.device)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc.float())
        mask = torch.ones((Sq, kc.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        if probs_bf16:
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(torch.bfloat16).float(),
                              vc.to(torch.bfloat16).float())
        else:
            pv = torch.einsum("bkgqs,bskd->bkgqd", p, vc.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dhv).to(q.dtype)


# ------------------------------------------------------------------------ GQA
def init_gqa(gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
             d_head: int, *, bias: bool = False,
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    p = {
        "wq": he_init(gen, (d_model, n_heads, d_head), d_model, dtype),
        "wk": he_init(gen, (d_model, n_kv_heads, d_head), d_model, dtype),
        "wv": he_init(gen, (d_model, n_kv_heads, d_head), d_model, dtype),
        "wo": he_init(gen, (n_heads, d_head, d_model), n_heads * d_head, dtype),
    }
    if bias:
        dev = gen.device
        p["bq"] = torch.zeros((n_heads, d_head), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv_heads, d_head), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv_heads, d_head), dtype=dtype, device=dev)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) × (D, h, dh) → (B, S, h, dh), fp32 products rounded once."""
    D, h, dh = w.shape
    return dot_f32(x, w.to(x.dtype).reshape(D, h * dh)).to(x.dtype).reshape(
        *x.shape[:-1], h, dh)


def _qkv(p: Mapping[str, torch.Tensor], x: torch.Tensor, split=None,
         all_kv: bool = False
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, h, dh).  Under a split of the heads: q of this rank's
    heads (``wq``'s and ``bq``'s local columns), k and v of the KV heads
    those read (the local shards of ``wk``/``wv``/``bk``/``bv``, or their
    columns of the replicated leaves), or of every KV head with
    ``all_kv`` (a cache split over the sequence needs every head's row).
    Where the plan shards ``wk``/``wv`` and a rank's heads read KV heads
    its shard does not hold (:attr:`~repro_torch.sharding.tp.ModelSplit.
    kv_gather`), or every KV head is needed, k and v of the shard are
    gathered over ``model`` (GSPMD's pieces) and the range taken; their
    backward sums the ranks' partial gradients first."""
    dt = x.dtype
    gather = False
    if split is None or split.heads is None:
        take = lambda name, dim, rng: p[name]                 # noqa: E731
        hr = kr = None
    else:
        x = copy_to_model(x, split)
        take = lambda name, dim, rng: split.take(p, name, "attn", dim, rng)  # noqa: E731
        hr = split.heads
        gather = split.sharded(split.prefix + "attn/wk") and (
            all_kv or split.kv_gather)
        if gather:                      # the KV heads of the rank's shard
            held = split.local_slices(split.prefix + "attn/wk",
                                      (1, split.sizes["kv"], 1))[1]
            kr = (held.start, held.stop)
        else:
            kr = (0, p["wk"].shape[1]) if all_kv else split.kv
    q = _proj(x, take("wq", 1, hr))
    k, v = _proj(x, take("wk", 1, kr)), _proj(x, take("wv", 1, kr))
    if "bq" in p:
        q = q + take("bq", 0, hr).to(dt)
        k = k + take("bk", 0, kr).to(dt)
        v = v + take("bv", 0, kr).to(dt)
    if gather:
        k, v = (gather_from_model(t, 2, split, grad_sum=True, of="kv")
                for t in (k, v))
        if not all_kv:
            k, v = (t[:, :, split.kv[0]:split.kv[1]] for t in (k, v))
    return q, k, v


def _out(p: Mapping[str, torch.Tensor], ctx: torch.Tensor,
         dt: torch.dtype, split=None, data=None) -> torch.Tensor:
    """(B, S, H, dh) × wo (H, dh, D) → (B, S, D) in ``dt``.  Under a split
    of the heads ``ctx`` holds this rank's heads, read against their rows
    of ``wo``: the fp32 partial sums are all-reduced over ``model`` before
    the one rounding to ``dt``.  With ``data`` (a
    :class:`~repro_torch.sharding.tp.DataSplit` whose FSDP leaves ``wo`` on
    its output columns) the product gives this rank's columns, gathered
    over ``data``."""
    heads = split is not None and split.heads is not None
    wo = split.take(p, "wo", "attn", 0, split.heads) if heads else p["wo"]
    H, dh, D = wo.shape

    def product(c: torch.Tensor) -> torch.Tensor:
        out = dot_f32(c.to(dt).reshape(*c.shape[:2], H * dh),
                      wo.to(dt).reshape(H * dh, D))
        return reduce_from_model(out, split) if heads else out

    out = product(ctx) if data is None else data.apply(product, ctx, cols=True)
    return out.to(dt)


def gqa_prefill(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor, *, window: int = 0,
                probs_bf16: bool = False, plain: bool = False, split=None,
                data=None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal attention, with a sliding ``window`` > 0;
    returns (out, (k, v)) for the cache.  The reference's ``kv_chunk`` (the
    chunk of its jnp loop) has no counterpart: the kernel has its own
    tiles.  Under a :class:`~repro_torch.sharding.tp.ModelSplit` the flash
    kernels run on this rank's heads against the KV heads they read, and
    the cache rows are those KV heads' (every KV head's where the split's
    cache is over the sequence)."""
    seq = split is not None and split.cache == "seq"
    q, k, v = _qkv(p, x, split, all_kv=seq)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    ka, va = k, v
    if seq and split.heads is not None:
        k0, k1 = split.kv
        ka, va = k[:, :, k0:k1].contiguous(), v[:, :, k0:k1].contiguous()
    out = _attend(q, ka, _bf16_v(va, probs_bf16), window, probs_bf16, plain,
                  _groups(split))
    return _out(p, out, x.dtype, split, data), (k, v)


def _groups(split) -> dict:
    """The attention kernels' ``group`` and ``head_offset`` for a rank's
    query heads under ``split`` (a share of an uneven split need not hold
    whole KV groups); none without a split of the heads."""
    if split is None or split.heads is None:
        return {}
    return dict(group=split.kv_group, head_offset=split.head_offset())


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
            probs_bf16: bool, plain: bool, groups: dict | None = None
            ) -> torch.Tensor:
    """Causal flash attention: the plain version (``plain``), the kernel
    with its backward (autograd needs a gradient), or the kernel;
    ``groups``: :func:`_groups`."""
    kw = dict(causal=True, window=window, round_p=_p_rounding(probs_bf16),
              **(groups or {}))
    if plain:
        return flash_attention_ref(q, k, v, **kw)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention_train(q, k, v, **kw)
    return flash_attention_fused(q, k, v, **kw)


def _bf16_v(v: torch.Tensor, probs_bf16: bool) -> torch.Tensor:
    """v as the P·V product of ``probs_bf16`` reads it: rounded to
    bfloat16 (and held in v's dtype, exactly)."""
    return v.to(torch.bfloat16).to(v.dtype) if probs_bf16 else v


def _p_rounding(probs_bf16: bool) -> bool | torch.dtype:
    return torch.bfloat16 if probs_bf16 else False


def gqa_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, *, window: int = 0,
               write_pos: torch.Tensor | None = None,
               valid_len: torch.Tensor | None = None, cache_len=None,
               cache_start: torch.Tensor | None = None, split=None, data=None
               ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Single-token decode against the cache; returns (out, caches).  The
    new K/V row of each sequence is written in place at ``write_pos`` (B,)
    (default ``pos``: what the reference's one-hot rewrite computes), then
    the first ``cache_len`` positions are attended: ``valid_len`` for a
    ring-buffer cache of width W (``write_pos = pos % W``, ``valid_len =
    min(pos + 1, W)``), else ``pos + 1``.  ``cache_len`` may be passed on
    the host, where the kernel's wrapper checks it without a
    synchronisation.  A ``window`` W against a full-length cache (no
    ``valid_len``) attends from ``cache_start`` on (default ``max(0, pos +
    1 − W)``, made on the card from ``pos``), the last W keys.

    Under a :class:`~repro_torch.sharding.tp.ModelSplit` the caches are
    this rank's: of the KV heads its query heads read, or, where the split
    puts the cache over the sequence, every KV head at positions ``[r·Sl,
    (r + 1)·Sl)`` (Sl the local slots).  Then only the owner of ``pos``
    writes the new row, q is gathered over ``model``, the decode kernel
    runs on the local piece with its local lengths (0 included) and gives
    each row's fp32 output and log-sum-exp, and the ranks' outputs are
    merged by it in fp32 (:func:`_merge_pieces`) and rounded once to the
    activation dtype, as the unsplit decode rounds; a window's starts are
    local there too (``clamp(start − r·Sl, 0, Sl)``)."""
    B = x.shape[0]
    seq = split is not None and split.cache == "seq"
    q, k, v = _qkv(p, x, split, all_kv=seq)    # (B, 1, H/KV, dh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows = torch.arange(B, device=x.device)
    idx = (pos if write_pos is None else write_pos).to(device=x.device,
                                                        dtype=torch.long)
    if valid_len is not None:
        cache_len = valid_len
    elif cache_len is None:
        cache_len = pos.to(device=x.device, dtype=torch.long) + 1
    W = window if valid_len is None else 0     # a ring holds the window
    if W and cache_start is None:
        cache_start = (pos.to(device=x.device, dtype=torch.long)
                       + 1 - W).clamp_min(0)
    if not seq:
        k_cache[rows, idx] = k[:, 0]
        v_cache[rows, idx] = v[:, 0]
        ctx = decode_attention(q[:, 0], k_cache, v_cache, cache_len,
                               cache_start=cache_start if W else None,
                               window=W, round_p=False, **_groups(split))
        return _out(p, ctx[:, None], x.dtype, split, data), (k_cache, v_cache)
    Sl = k_cache.shape[1]
    c0 = split.r * Sl
    here = idx - c0
    mine = ((here >= 0) & (here < Sl))[:, None, None]
    here = here.clamp(0, Sl - 1)
    k_cache[rows, here] = torch.where(mine, k[:, 0], k_cache[rows, here])
    v_cache[rows, here] = torch.where(mine, v[:, 0], v_cache[rows, here])
    lens = torch.as_tensor(cache_len).to(device=x.device, dtype=torch.long)
    lens = (lens - c0).clamp(0, Sl)
    starts = None
    if W:
        starts = torch.as_tensor(cache_start).to(device=x.device,
                                                 dtype=torch.long)
        starts = (starts - c0).clamp(0, Sl)
    qa = q[:, 0] if split.heads is None else gather_from_model(
        q[:, 0], 1, split, of="heads")
    ctx, lse = decode_attention(qa.contiguous(), k_cache, v_cache, lens,
                                cache_start=starts, window=W, round_p=False,
                                return_lse=True)
    ctx = _merge_pieces(ctx, lse, split)
    if split.heads is not None:
        ctx = ctx[:, split.heads[0]:split.heads[1]]
    return _out(p, ctx[:, None], x.dtype, split, data), (k_cache, v_cache)


def _merge_pieces(out: torch.Tensor, lse: torch.Tensor, split) -> torch.Tensor:
    """Attention over the ranks' pieces of one sequence: each rank's fp32
    output (B, H, dh) and log-sum-exp (B, H) gathered over ``model`` and
    merged by :func:`merge_by_lse`, in fp32 (the caller rounds once)."""
    outs = gather_from_model(out[None], 0, split)
    lses = gather_from_model(lse[None], 0, split)
    return merge_by_lse(outs, lses)


def merge_by_lse(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Attention over pieces of the keys from each piece's normalised
    output (n, ..., dh) and log-sum-exp (n, ...): Σ_i e^(lse_i − M) out_i /
    Σ_i e^(lse_i − M), M = max_i lse_i, in fp32; a piece with no keys
    (lse −inf) weighs 0.  A plain elementwise merge, not ``da_combine``:
    that pass merges the kernel's unnormalised fp32 partials in its own
    workspace, while the ranks hold normalised fp32 rows, n × B × H × dh
    elements."""
    w = torch.exp(lses - lses.amax(dim=0, keepdim=True))
    return (w[..., None] * outs.float()).sum(dim=0) / w.sum(dim=0)[..., None]


# ------------------------------------------------------------------------ MLA
def init_mla(gen: torch.Generator, d_model: int, n_heads: int, *,
             kv_lora_rank: int, q_lora_rank: int, d_head: int, d_rope: int,
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """``d_head`` is the no-rope width of a query/key head, which is also
    the value width."""
    H, r, rq, dn, dr = n_heads, kv_lora_rank, q_lora_rank, d_head, d_rope
    dev = gen.device
    p = {
        "w_dkv": he_init(gen, (d_model, r), d_model, dtype),
        "norm_kv": torch.ones((r,), dtype=dtype, device=dev),
        "w_kr": he_init(gen, (d_model, dr), d_model, dtype),
        "w_uk": he_init(gen, (r, H, dn), r, dtype),
        "w_uv": he_init(gen, (r, H, dn), r, dtype),
        "wo": he_init(gen, (H, dn, d_model), H * dn, dtype),
    }
    if rq:
        p["w_dq"] = he_init(gen, (d_model, rq), d_model, dtype)
        p["norm_q"] = torch.ones((rq,), dtype=dtype, device=dev)
        p["w_uq"] = he_init(gen, (rq, H, dn), rq, dtype)
        p["w_qr"] = he_init(gen, (rq, H, dr), rq, dtype)
    else:
        p["w_uq"] = he_init(gen, (d_model, H, dn), d_model, dtype)
        p["w_qr"] = he_init(gen, (d_model, H, dr), d_model, dtype)
    return p


def _mla_take(p: Mapping[str, torch.Tensor], name: str, split,
              dim: int = 1) -> torch.Tensor:
    """An MLA head leaf (``w_uq``/``w_qr``/``w_uk``/``w_uv`` on dim 1,
    ``wo`` on dim 0): this rank's heads under a split of the heads."""
    if split is None or split.heads is None:
        return p[name]
    return split.take(p, name, "attn", dim, split.heads)


def _mla_q(p: Mapping[str, torch.Tensor], x: torch.Tensor, split=None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    dt = x.dtype
    if "w_dq" in p:
        cq = dot_f32(x, p["w_dq"].to(dt)).to(dt)
        cq = rms_norm(cq, p["norm_q"])
    else:
        cq = x
    return (_proj(cq, _mla_take(p, "w_uq", split)),
            _proj(cq, _mla_take(p, "w_qr", split)))


def _mla_latent(p: Mapping[str, torch.Tensor], x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    dt = x.dtype
    c_kv = rms_norm(dot_f32(x, p["w_dkv"].to(dt)).to(dt), p["norm_kv"])
    return c_kv, dot_f32(x, p["w_kr"].to(dt)).to(dt)


def mla_prefill(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor, *,
                probs_bf16: bool = False, plain: bool = False, split=None,
                data=None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Materialised-KV MLA for prefill; returns (out, (c_kv, k_rope)), the
    latent caches only.  ``plain`` runs the flash kernel's plain version.
    Under a :class:`~repro_torch.sharding.tp.ModelSplit` of the heads the
    flash kernels run on this rank's heads (``w_uq``/``w_qr``/``w_uk``/
    ``w_uv`` shards), their ``wo`` rows give fp32 partial sums all-reduced
    before the one rounding, and the latents (from the replicated
    ``w_dkv``/``w_kr``) are whole on every rank."""
    dt = x.dtype
    B, S, _ = x.shape
    if split is not None and split.heads is not None:
        x = copy_to_model(x, split)
    q_nope, q_rope = _mla_q(p, x, split)
    dn, dr = q_nope.shape[-1], q_rope.shape[-1]
    c_kv, k_rope = _mla_latent(p, x)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    k_nope = _proj(c_kv, _mla_take(p, "w_uk", split))
    v = _proj(c_kv, _mla_take(p, "w_uv", split))
    H = k_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    # zeros in v's columns dn.., outside the kernel: autograd drops their dv
    v = torch.nn.functional.pad(_bf16_v(v, probs_bf16), (0, dr))
    out = _attend(q, k, v, 0, probs_bf16, plain, _groups(split))[..., :dn]
    return _out(p, out, dt, split, data), (c_kv, k_rope)


def _per_head(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, H, i) × (H, i, o) → (B, H, o) fp32: one product per head."""
    return bmm_f32(a.transpose(0, 1), w).transpose(0, 1)


def _latent_scores(q_lat: torch.Tensor, q_rope: torch.Tensor,
                   ckv: torch.Tensor, kr: torch.Tensor, lens: torch.Tensor,
                   scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The absorbed decode's fp32 scores (B, H, S), the positions at or past
    ``lens`` (B,) masked, and the valid positions (B, S)."""
    s = torch.bmm(q_lat, ckv.transpose(1, 2))
    s = (s + torch.bmm(q_rope, kr.float().transpose(1, 2))) * scale
    valid = torch.arange(ckv.shape[1], device=s.device)[None, :] < lens[:, None]
    return s.masked_fill(~valid[:, None, :], _NEG), valid


def latent_piece(q_lat: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
                 kr: torch.Tensor, lens: torch.Tensor, scale: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The absorbed decode over one piece of the latent cache: the latent
    queries (B, H, r) and rope queries (B, H, dr) in fp32 against ``ckv``
    (B, S, r) fp32 and ``kr`` (B, S, dr) at the first ``lens`` (B,)
    positions.  Returns (the normalised latent context (B, H, r), the
    log-sum-exp (B, H)) in fp32: zeros and −inf where ``lens`` is 0, as
    :func:`merge_by_lse` reads them."""
    s, valid = _latent_scores(q_lat, q_rope, ckv, kr, lens, scale)
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.where(valid[:, None, :], torch.exp(s - mx), torch.zeros_like(s))
    l = e.sum(dim=-1)
    some = l > 0
    l1 = torch.where(some, l, torch.ones_like(l))
    lse = torch.where(some, mx[..., 0] + torch.log(l1),
                      torch.full_like(l, -torch.inf))
    return torch.bmm(e, ckv) / l1[..., None], lse


def mla_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
               ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
               pos: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               cache_len=None, split=None, data=None
               ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Absorbed-form decode, attention in the latent space: scores =
    (q_nope·W_uk)·c_kv + q_rope·k_rope, the caches (B, S, r) and (B, S, dr)
    written in place at ``pos`` (B,) on the card, the first ``cache_len =
    pos + 1`` positions attended.  Returns (out, caches).

    Under a :class:`~repro_torch.sharding.tp.ModelSplit` the query side
    runs on this rank's heads, and where the split puts the latents over
    the sequence (the plan's layout) the caches are this rank's positions
    ``[r·Sl, (r + 1)·Sl)``: the owner of ``pos`` writes the new rows
    (every rank computes them whole: ``w_dkv``/``w_kr`` are replicated),
    the latent queries ``q_nope·W_uk`` (B, H, r) and ``q_rope`` are
    gathered over the heads, every head attends the local positions (the
    local lengths, 0 included, give zeros and a log-sum-exp of −inf), the
    pieces are merged by :func:`merge_by_lse`, and ``w_uv`` and ``wo`` run
    on the local heads, their fp32 partial sums all-reduced.  With
    ``data`` ``wo`` holds this rank's output columns (FSDP), gathered over
    ``data`` after the product, as :func:`_out` does."""
    dt = x.dtype
    B = x.shape[0]
    heads = split is not None and split.heads is not None
    seq = split is not None and split.cache == "seq"
    q_nope, q_rope = _mla_q(p, x, split)                # (B, 1, H, dn / dr)
    q_rope = apply_rope(q_rope, cos, sin)
    c_kv, k_rope = _mla_latent(p, x)                    # (B, 1, r), (B, 1, dr)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    S = ckv_cache.shape[1]
    rows = torch.arange(B, device=x.device)
    idx = pos.to(device=x.device, dtype=torch.long)
    if cache_len is None:
        cache_len = idx + 1
    lens = torch.as_tensor(cache_len).to(device=x.device, dtype=torch.long)
    if seq:         # only the owner of pos writes; the local lengths
        c0 = split.r * S
        here = idx - c0
        mine = ((here >= 0) & (here < S))[:, None]
        here = here.clamp(0, S - 1)
        ckv_cache[rows, here] = torch.where(mine, c_kv[:, 0],
                                            ckv_cache[rows, here])
        krope_cache[rows, here] = torch.where(mine, k_rope[:, 0],
                                              krope_cache[rows, here])
        lens = (lens - c0).clamp(0, S)
    else:
        ckv_cache[rows, idx] = c_kv[:, 0]
        krope_cache[rows, idx] = k_rope[:, 0]
    dn, dr = q_nope.shape[-1], q_rope.shape[-1]
    ckv = ckv_cache.float()
    # absorb W_uk into the query: a latent-space query (B, H, r)
    q_lat = _per_head(q_nope[:, 0], _mla_take(p, "w_uk", split).to(dt)
                      .permute(1, 2, 0))
    qr = q_rope[:, 0].float()
    if seq and heads:           # every head attends this rank's positions
        q_lat = gather_from_model(q_lat, 1, split, of="heads")
        qr = gather_from_model(qr, 1, split, of="heads")
    if not seq:
        s, valid = _latent_scores(q_lat, qr, ckv, krope_cache, lens,
                                  (dn + dr) ** -0.5)
        ctx_lat = torch.bmm(torch.softmax(s, dim=-1), ckv)
    else:           # this piece's softmax, merged over the ranks' pieces
        ctx_lat = _merge_pieces(*latent_piece(q_lat, qr, ckv, krope_cache,
                                              lens, (dn + dr) ** -0.5), split)
        if heads:
            ctx_lat = ctx_lat[:, split.heads[0]:split.heads[1]]
    ctx = _per_head(ctx_lat, _mla_take(p, "w_uv", split).float().permute(1, 0, 2))
    wo = _mla_take(p, "wo", split, 0)
    H, _, D = wo.shape

    def product(c: torch.Tensor) -> torch.Tensor:
        y = c.reshape(c.shape[0], H * dn) @ wo.float().reshape(H * dn, D)
        return reduce_from_model(y, split) if heads else y

    y = product(ctx) if data is None else data.apply(product, ctx, cols=True)
    return y[:, None, :].to(dt), (ckv_cache, krope_cache)
