"""Plain PyTorch versions of the port's kernels and their stage vocabulary.

Each function here is the numerical ground truth a hand-written kernel is
held against, run on the CPU by the tests and on the card by
``chip_smoke.py``: :func:`run_segment_ref` for the CUDA megakernel
(:mod:`repro_torch.kernels.megakernel`), :func:`linear_chain_ref` and
:func:`linear_chain_q_ref` for the chain kernels
(:mod:`repro_torch.kernels.linear_pipeline`), :func:`spmv_ref` for the
block-sparse product (:mod:`repro_torch.kernels.spmv`),
:func:`gemv_ref`/:func:`matmul_ref` for the tiled matmul
(:mod:`repro_torch.kernels.gemv`), and :func:`flash_attention_ref` (and the gradient
:func:`flash_attention_bwd_ref`) and :func:`decode_attention_ref` for the
attention kernels
(:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.decode_attention`), and :func:`mamba2_ssd_ref`,
the sequential oracle of the chunked SSD scan (PyTorch ops in the port, as
in the reference: no TPU kernel computes it).

Float reductions (matvec rows, squared distances, sums, dots) accumulate in
index order, one rounded multiply and one rounded add per term — the order
the kernel's threads use — so the plain version and the kernel agree bit
for bit on the card up to the transcendental functions, and a bucket gives
each sample exactly what a one-sample call gives it.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["spmv_ref", "gemv_ref", "matmul_ref", "flash_attention_ref",
           "flash_attention_bwd_ref", "decode_attention_ref", "head_group",
           "pad_heads",
           "mamba2_ssd_ref", "apply_stage", "apply_stage_q",
           "linear_chain_ref", "linear_chain_q_ref", "run_segment_ref",
           "run_segment_grid_ref", "float_pe_outputs"]


def spmv_ref(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched SpMV: ``w`` dense-with-zeros (m, n), ``x`` (B, n) → (B, m)."""
    return x @ w.T


def gemv_ref(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched GEMV: ``w`` (m, n), ``x`` (B, n) → (B, m)."""
    return x @ w.T


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


# ------------------------------------------------------------------ attention
# The attention kernels' plain versions materialise the scores.  Both scale
# q in fp32 before the product (as the model's attention does), keep the
# scores and the softmax statistics in fp32, and divide by the row sum after
# P·V.  ``round_p`` rounds the unnormalised probabilities to v's dtype before
# P·V, as the TPU kernels do (``torch.bfloat16``: to bfloat16 whatever v's
# dtype); without it p stays fp32, as the model does.
_NEG = -1e30


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, eq: str,
                round_p: bool | torch.dtype) -> torch.Tensor:
    # With p in fp32 the row max only shifts the exponent: held constant
    # under autograd, as the gradient of a shift-invariant function allows.
    # A rounded p is no longer shift-invariant (the rounding is relative to
    # the max), so there the max stays attached and its gradient reaches
    # each row's argmax key (ties split evenly), as jax.grad of the
    # reference's ``flash_attention`` (one KV chunk) does.
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - (mx.detach() if round_p is False else mx))
    l = p.sum(dim=-1, keepdim=True)
    if round_p is not False:
        p = p.to(v.dtype if round_p is True else round_p).float()
    return torch.einsum(eq, p, v.float()) / l


def head_group(H: int, KV: int, group: int | None = None,
               head_offset: int = 0) -> int:
    """G, the query heads a KV head serves, for H query heads over KV KV
    heads: ``H / KV`` where ``group`` is None; else ``group``, the heads
    starting ``head_offset`` into their first KV head's group, so that
    head h reads KV head ``(head_offset + h) // G`` and the KV heads are
    exactly those the heads read (a rank's share of an uneven split:
    :meth:`repro_torch.sharding.tp.ModelSplit.head_offset`).  Raises
    ValueError for heads and KV heads that do not match so."""
    if group is None:
        if H == KV == 0 and not head_offset:     # no heads: nothing to read
            return 1
        if head_offset or KV < 1 or H % KV:
            raise ValueError(f"attention: {H} query heads over {KV} KV heads "
                             f"(offset {head_offset} needs a group)")
        return H // KV
    if group < 1 or not 0 <= head_offset < group or (
            H and KV != -(-(head_offset + H) // group)) or (not H and KV):
        raise ValueError(f"attention: {H} query heads from offset {head_offset} "
                         f"in groups of {group} do not read {KV} KV heads")
    return group


def pad_heads(x: torch.Tensor, dim: int, KV: int, G: int,
              head_offset: int) -> torch.Tensor:
    """``x``'s H heads (on ``dim``) as the KV · G heads of whole groups:
    ``head_offset`` zero heads before them and the rest after (autograd
    drops the padding's gradient)."""
    H = x.shape[dim]
    tail = KV * G - head_offset - H
    if head_offset == 0 and tail == 0:
        return x
    return F.pad(x, [0, 0] * (x.dim() - dim - 1) + [head_offset, tail])


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        round_p: bool | torch.dtype = False,
                        group: int | None = None,
                        head_offset: int = 0) -> torch.Tensor:
    """GQA attention, q (B, Sq, H, dh), k and v (B, Sk, KV, dh) → (B, Sq,
    H, dh) in q's dtype; query head h reads KV head h // (H / KV) (or, with
    ``group``, ``(head_offset + h) // group``: :func:`head_group`); causal
    masks ``kpos > qpos`` from the top-left corner, and a ``window`` > 0
    also ``kpos <= qpos - window``.  Heads that are not whole groups run
    padded to them with zero heads (:func:`pad_heads`), which the kernels'
    rows outside ``[0, H)`` match."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = head_group(H, KV, group, head_offset)
    s = _flash_scores(pad_heads(q, 2, KV, G, head_offset), k, causal, window, G)
    out = _softmax_pv(s, v, "bkgqs,bskd->bkgqd", round_p)   # (B, KV, G, Sq, dh)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * G, dh)
    return out[:, :, head_offset:head_offset + H].to(q.dtype)


def _flash_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: int, G: int | None = None) -> torch.Tensor:
    """The scaled, masked fp32 scores (B, KV, G, Sq, Sk) of
    :func:`flash_attention_ref` (q of KV · G heads, G = H / KV where None;
    no heads: an empty tensor, still in the graph)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV if G is None else G
    qg = (q.float() * dh ** -0.5).reshape(B, Sq, KV, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    if causal or window:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        masked = torch.zeros((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            masked |= kpos > qpos
        if window:
            masked |= kpos <= qpos - window
        s = s.masked_fill(masked, _NEG)
    return s


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            g: torch.Tensor, *, causal: bool = True,
                            window: int = 0,
                            round_p: bool | torch.dtype = False,
                            group: int | None = None, head_offset: int = 0
                            ) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`flash_attention_ref` (p in fp32, or rounded
    as ``round_p`` says; heads from ``head_offset`` in groups of
    ``group``) against the output gradient ``g`` (B, Sq, H, dh), by
    autograd: (dq, dk, dv) in the inputs' dtypes, and lse (B, H, Sq)
    float32, each row's log-sum-exp of its scaled, masked scores.  A KV
    head shared with another rank's heads gets this rank's heads' part of
    its dk and dv."""
    B, Sq, H, _ = q.shape
    KV = k.shape[2]
    G = head_group(H, KV, group, head_offset)
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_ref(qq, kk, vv, causal=causal, window=window,
                                  round_p=round_p, group=group,
                                  head_offset=head_offset)
        dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), g)
    with torch.no_grad():
        s = _flash_scores(pad_heads(q, 2, KV, G, head_offset), k, causal,
                          window, G)
        lse = torch.logsumexp(s, dim=-1)                      # (B, KV, G, Sq)
    lse = lse.reshape(B, KV * G, Sq)
    return dq, dk, dv, lse[:, head_offset:head_offset + H]


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_len: torch.Tensor, *, cache_start=None,
                         window: int = 0, round_p: bool = False,
                         return_lse: bool = False, group: int | None = None,
                         head_offset: int = 0):
    """One new token per sequence, q (B, H, dh), against the caches k and
    v (B, S, KV, dh), of which positions ``[cache_start[b], cache_len[b])``
    are valid (``cache_start`` None: from 0) → (B, H, dh) in q's dtype.  A
    ``window`` > 0 also masks the positions below ``cache_len[b] −
    window`` (the caller's promise that no row holds more; the kernel's
    grid covers that many keys).  A row with no valid position gives
    zeros.  With ``return_lse`` the output is float32, not rounded, and
    each row's log-sum-exp (B, H) float32 of its scaled valid scores comes
    beside it (-inf for a row with no valid position), as the kernel
    does.  ``group`` and ``head_offset``: :func:`head_group`."""
    B, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = head_group(H, KV, group, head_offset)
    qg = pad_heads(q.float(), 1, KV, G, head_offset).reshape(
        B, KV, G, dh) * dh ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    lens = torch.as_tensor(cache_len, device=q.device).reshape(B, 1).long()
    lens = lens.clamp(0, S)
    start = (torch.zeros_like(lens) if cache_start is None else
             torch.as_tensor(cache_start, device=q.device).reshape(B, 1).long())
    start = torch.minimum(start.clamp_min(0), lens)
    if window:
        start = torch.maximum(start, lens - window)
    kpos = torch.arange(S, device=q.device)[None, :]
    valid = (kpos < lens) & (kpos >= start)                          # (B, S)
    s = s.masked_fill(~valid[:, None, None, :], _NEG)
    out = _softmax_pv(s, v, "bkgs,bskd->bkgd", round_p)
    some = (start[:, 0] < lens[:, 0])[:, None, None]
    out = torch.where(some[..., None], out, torch.zeros_like(out))
    out = out.reshape(B, KV * G, dh)[:, head_offset:head_offset + H]
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.where(some, torch.logsumexp(s, dim=-1),
                      torch.full_like(s[..., 0], -torch.inf))
    return out.float(), lse.reshape(B, KV * G)[:, head_offset:head_offset + H]


# ----------------------------------------------------------------- mamba2 SSD
def mamba2_ssd_ref(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """Sequential state-space recurrence, the oracle of
    :func:`repro_torch.models.mamba2.ssd_chunked` → (B, S, H, P) in x's
    dtype.  x (B, S, H, P) are the dt-scaled inputs, a_log (B, S, H) the
    per-step decay logits (<= 0), b and c (B, S, N) the input and output
    projections shared across heads; in fp32, one step at a time:

        h_t = exp(a_t) * h_{t-1} + b_t ⊗ x_t        h ∈ (N, P) per head
        y_t = c_t @ h_t
    """
    Bsz, S, H, P = x.shape
    N = b.shape[-1]
    xf, af, bf, cf = x.float(), a_log.float(), b.float(), c.float()
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = (torch.exp(af[:, t])[:, :, None, None] * h
             + bf[:, t, None, :, None] * xf[:, t, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


# ------------------------------------------------------------- linear pipeline
# Float stage forms (op, operand):
#   ("scalar_mul", c)      x * c
#   ("add_vec", v)         x + v          (v broadcast over batch)
#   ("sub_vec", v)         x - v
#   ("hadamard_vec", v)    x * v
#   ("tanh"|"sigmoid"|"relu"|"exp", None)
#   ("add_arr"|"sub_arr"|"hadamard_arr", i)  — second operand is extras[i]
Stage = tuple[str, object]


def apply_stage(x: torch.Tensor, stage: Stage,
                extras: Sequence[torch.Tensor]) -> torch.Tensor:
    op, operand = stage
    if op == "scalar_mul":
        return x * operand
    if op == "add_vec":
        return x + operand
    if op == "sub_vec":
        return x - operand
    if op == "hadamard_vec":
        return x * operand
    if op == "tanh":
        return torch.tanh(x)
    if op == "sigmoid":
        return torch.sigmoid(x)
    if op == "relu":
        return torch.clamp_min(x, 0.0)
    if op == "exp":
        return torch.exp(x)
    if op == "add_arr":
        return x + extras[operand]
    if op == "sub_arr":
        return x - extras[operand]
    if op == "hadamard_arr":
        return x * extras[operand]
    raise ValueError(f"unknown stage op {op!r}")


def linear_chain_ref(x: torch.Tensor, stages: Sequence[Stage],
                     extras: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    for stage in stages:
        x = apply_stage(x, stage, extras)
    return x


# -------------------------------------------------- quantized linear pipeline
# The fixed-point twin on the int32 carrier; every stage ends in a static
# requantizing shift.  Stage forms (op, operand):
#   ("q_scalar_mul",   (c, rq))             requantize(x · c, rq)
#   ("q_add_vec",      (vi, sa, sb, rq))    requantize(sh(x,sa) + sh(v,sb), rq)
#   ("q_sub_vec",      (vi, sa, sb, rq))    requantize(sh(x,sa) − sh(v,sb), rq)
#   ("q_hadamard_vec", (vi, rq))            requantize(x · v, rq)
#   ("q_add_arr"|"q_sub_arr", (ai, sa, sb, rq))   — operand is extras[ai]
#   ("q_hadamard_arr", (ai, rq))
#   ("q_unary",        (name, e_in, e_out))  dequantize → float PE → quantize

# Float formulas of the table-based nonlinear PEs — the node templates'
# formulas (sigmoid is 1/(1+exp(-x)) here, unlike ``apply_stage``).
_UNARY_F = {
    "tanh": torch.tanh,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "exp": torch.exp,
}
UNARY_NAMES = tuple(_UNARY_F)


def _align(x: torch.Tensor, s: int) -> torch.Tensor:
    """Plain arithmetic align shift (no rounding)."""
    return x << s if s >= 0 else x >> (-s)


def apply_stage_q(x: torch.Tensor, stage: Stage, vecs: Sequence[torch.Tensor],
                  extras: Sequence[torch.Tensor], bits: int = 8) -> torch.Tensor:
    """One quantized stage on the int32 stream ``x``; ``vecs``/``extras``
    are int32-widened operands."""
    from repro_torch.core.quantize import quantize_core, requantize_core

    op, operand = stage
    if op == "q_scalar_mul":
        c, rq = operand
        return requantize_core(x * c, rq, bits)
    if op in ("q_add_vec", "q_sub_vec", "q_add_arr", "q_sub_arr"):
        idx, sa, sb, rq = operand
        b = vecs[idx] if op.endswith("_vec") else extras[idx]
        acc = _align(x, sa) + (1 if "add" in op else -1) * _align(b, sb)
        return requantize_core(acc, rq, bits)
    if op in ("q_hadamard_vec", "q_hadamard_arr"):
        idx, rq = operand
        b = vecs[idx] if op.endswith("_vec") else extras[idx]
        return requantize_core(x * b, rq, bits)
    if op == "q_unary":
        name, e_in, e_out = operand
        xf = x.to(torch.float32) * (2.0 ** (-e_in))
        return quantize_core(_UNARY_F[name](xf), e_out, bits)
    raise ValueError(f"unknown quantized stage op {op!r}")


def linear_chain_q_ref(x: torch.Tensor, stages: Sequence[Stage],
                       vecs: Sequence[torch.Tensor] = (),
                       extras: Sequence[torch.Tensor] = (),
                       bits: int = 8) -> torch.Tensor:
    """Widen to the int32 carrier, apply each stage, narrow on write."""
    out_dtype = x.dtype
    x = x.to(torch.int32)
    vecs = [v.to(torch.int32) for v in vecs]
    extras = [e.to(torch.int32) for e in extras]
    for stage in stages:
        x = apply_stage_q(x, stage, vecs, extras, bits)
    return x.to(out_dtype)


# ----------------------------------------------------------------- megakernel
_FLOAT_PE_OPS = ("SQL2", "REDUCE", "DOT")


def float_pe_outputs(seg: Any) -> tuple[bool, ...]:
    """Per output of ``seg``: whether a float PE lies on its path — a
    ``q_unary`` stage or an ``SQL2``/``REDUCE``/``DOT`` (dequantize → float
    → quantize on the integer lanes).  Only there may two implementations'
    transcendentals differ by an ulp and so an integer output by 1 LSB;
    every other integer output must agree exactly."""
    tainted: set[int] = set()
    outs = [False] * len(seg.out_refs)
    for ins in seg.instrs:
        if ins.op == "STORE":
            outs[ins.operand] = ins.src[0] in tainted
        elif ins.dst >= 0:
            pe = (ins.op in _FLOAT_PE_OPS or (ins.op == "ELEMENTWISE"
                                              and ins.operand[0][0] == "q_unary"))
            if pe or any(s in tainted for s in ins.src):
                tainted.add(ins.dst)
            else:
                tainted.discard(ins.dst)
    return tuple(outs)


def _pools(seg: Any, device: torch.device) -> tuple[list, list]:
    """The segment's const rows (carrier dtype, ``(1, n)``) and matrices as
    tensors on ``device``, converted once per segment and device."""
    from repro_torch.kernels.build import segment_cache

    def build():
        carrier = np.int32 if seg.quantized else np.float32
        crows = [torch.from_numpy(np.asarray(c, carrier).reshape(1, -1))
                 .to(device) for c in seg.consts]
        mats = [torch.from_numpy(np.ascontiguousarray(m)).to(device)
                for m in seg.matrices]
        return crows, mats

    return segment_cache("pools", seg, device, build)


def _seq_sum(terms) -> torch.Tensor:
    """Σ in index order, one rounded add per term (the kernel's order)."""
    acc = None
    for t in terms:
        acc = t if acc is None else acc + t
    return acc


def _reduce(x: torch.Tensor, kind: str) -> torch.Tensor:
    """(nb, n) → (nb, 1) sum/max/min over the row, sums in index order."""
    if kind == "sum":
        return _seq_sum(x[:, j:j + 1] for j in range(x.shape[1]))
    return (torch.amax if kind == "max" else torch.amin)(x, dim=1, keepdim=True)


def _segment_rows(seg: Any, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Execute the instruction stream on ``(nb, width)`` rows."""
    from repro_torch.core.quantize import (dequantize, quantize_core,
                                           requantize_core, requantize_rows)
    from repro_torch.kernels.megakernel import _seg_out_dtypes

    device = xs[0].device if xs else torch.device("cpu")
    nb = xs[0].shape[0] if xs else 1
    carrier = torch.int32 if seg.quantized else torch.float32
    crows, mats = _pools(seg, device)
    out_dts = _seg_out_dtypes(seg)

    def dq(x, e):
        return x if e is None else dequantize(x, e)

    def q(x, e):
        return x if e is None else quantize_core(x, e, seg.bits)

    slots: dict[int, torch.Tensor] = {}
    outs: dict[int, torch.Tensor] = {}
    for instr in seg.instrs:
        op = instr.op
        if op == "LOAD_VEC":
            kind, idx = instr.operand
            src = xs[idx] if kind == "in" else crows[idx].expand(nb, -1)
            slots[instr.dst] = src.to(carrier)
        elif op == "LOAD_MAT":
            pass                               # matrices are read in place
        elif op in ("MATVEC", "SPMV"):
            mi, bias_ci = instr.operand
            w, x = mats[mi], slots[instr.src[0]]
            if seg.quantized:                  # int32 wraps; order-free
                acc = (w[None] * x[:, None, :]).sum(-1, dtype=torch.int32)
            else:
                acc = _seq_sum(w[:, j][None, :] * x[:, j:j + 1]
                               for j in range(w.shape[1]))
                if acc is None:
                    acc = torch.zeros(nb, w.shape[0], device=device)
            if bias_ci is not None:
                acc = acc + crows[bias_ci]
            slots[instr.dst] = acc
        elif op == "REQUANTIZE":
            kind, sh = instr.operand
            x = slots[instr.src[0]]
            if kind == "rows":
                y = requantize_rows(x, crows[sh][0], seg.bits)
            else:
                y = requantize_core(x, sh, seg.bits)
            slots[instr.dst] = y.to(carrier)
        elif op == "ARGMAX":
            x = slots[instr.src[0]]
            slots[instr.dst] = torch.argmax(x, dim=1, keepdim=True).to(carrier)
        elif op == "REDUCE":
            kind, e_in, e_out = instr.operand
            r = _reduce(dq(slots[instr.src[0]], e_in), kind)
            slots[instr.dst] = q(r, e_out).to(carrier)
        elif op == "SQL2":
            mi, e_in, e_out = instr.operand
            pts = mats[mi]                     # (d, m)
            x = dq(slots[instr.src[0]], e_in)
            diffs = (pts[i][None, :] - x[:, i:i + 1] for i in range(pts.shape[0]))
            acc = _seq_sum(d * d for d in diffs)
            slots[instr.dst] = q(acc, e_out).to(carrier)
        elif op == "DOT":
            e_a, e_b, e_out = instr.operand
            a = dq(slots[instr.src[0]], e_a)
            b = dq(slots[instr.src[1]], e_b)
            r = _seq_sum(a[:, j:j + 1] * b[:, j:j + 1] for j in range(a.shape[1]))
            slots[instr.dst] = q(r, e_out).to(carrier)
        elif op == "ELEMENTWISE":
            stage, vec_cis = instr.operand
            x = slots[instr.src[0]]
            extras = [slots[s] for s in instr.src[1:]]
            if seg.quantized:
                vv = [crows[ci] for ci in vec_cis]
                slots[instr.dst] = apply_stage_q(x, stage, vv, extras, seg.bits)
            else:
                if stage[0] in ("add_vec", "sub_vec", "hadamard_vec"):
                    stage = (stage[0], crows[vec_cis[0]])
                slots[instr.dst] = apply_stage(x, stage, extras)
        elif op == "STORE":
            outs[instr.operand] = slots[instr.src[0]].to(out_dts[instr.operand])
        else:
            raise ValueError(f"unknown megakernel op {op!r}")
    return [outs[i].contiguous() for i in range(len(seg.out_refs))]


def run_segment_ref(seg: Any, inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.megakernel.run_segment`:
    one sample, inputs of any shape, one flat value per ``seg.out_refs``."""
    outs = _segment_rows(seg, [x.reshape(1, -1) for x in inputs])
    return [o[0] for o in outs]


def run_segment_grid_ref(seg: Any,
                         inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.megakernel.run_segment_grid`:
    a bucket with a leading batch axis, one ``(nb, width)`` value per output."""
    nb = int(inputs[0].shape[0])
    return _segment_rows(seg, [x.reshape(nb, -1) for x in inputs])
