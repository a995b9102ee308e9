"""GQA decode attention: one new token per sequence against a KV cache.

:func:`decode_attention` computes, for q (B, H, dh) and the caches k and v
(B, S, KV, dh) of which the first ``cache_len[b]`` positions are valid, the
attention of each query head h over KV head h // (H / KV) (or, for a
rank's share of an uneven split, ``(head_offset + h) // group``) → (B, H,
dh) in q's dtype.  On CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.decode_attention_ref`; on CUDA tensors the
hand-written kernel ``csrc/decode_attention.cu`` or it raises.  The kernel
reads the caches in this layout through their strides (a layer's slice of
a stacked cache needs no copy) and only their valid prefix.  It splits the
sequence over blocks and merges the splits in a second pass;
:func:`plan_decode` chooses the split from the shapes alone.
``LAUNCHES["decode_attention"]`` counts calls that launched the kernel
(with its combine pass, where there is one).

``return_lse`` also returns each row's log-sum-exp (B, H) float32 of its
scaled valid scores (natural log), written where the kernel's last pass
normalises the row (``da_kernel`` with one split, ``da_combine`` with
more): the statistic that merges attention over pieces of one sequence
(:func:`repro_torch.models.attention.gqa_decode` on a cache split over the
sequence).  A row of length 0 then gives zeros and -inf.  The output is
then float32, each row normalised in fp32 and not rounded: a caller that
merges such pieces rounds once, after its merge.

``cache_len`` must lie in [1, S] ([0, S] with ``return_lse``). Given on the
host (a CPU tensor, numpy array or sequence), it is checked there and
copied to the card once. Given on the card, it is not read back: the call
makes no synchronisation and can be captured in a CUDA graph, and checking
the lengths is the caller's job, as for the reference's
``decode_attention``. The kernel clamps each length into [0, S], so a bad
one never reads outside the cache; a length of 0 gives a zero row.
``round_p`` (default True, what the TPU kernel does) rounds the
probabilities to v's dtype before P·V; False keeps them fp32, as the
model's ``gqa_decode`` does.

A sliding window on a full-length cache (the reference's ``gqa_decode``
with ``window``: keys ``(pos − W, pos]``): ``cache_start`` (B,) gives each
row's first valid key, so keys ``[cache_start[b], cache_len[b])`` are
attended; it is taken as the lengths are (on the host: checked to lie in
[0, S] and copied once; on the card: not read back, clamped into [0,
len]).  ``window`` = W > 0 is a shape: the caller's promise that no row
attends more than W keys (a start below ``len − W`` is raised to it), so
the grid covers ``ceil(W / chunk) + 1`` splits from each row's first live
chunk and the work follows W, not S (:func:`plan_decode`).  A row whose
keys all lie below its start (a piece of a sequence split over ranks)
gives zeros and, with ``return_lse``, -inf.
On meta tensors (shapes only: :mod:`repro_torch.launch.op_analysis`
counting a step) the wrapper returns the kernel's outputs empty; there
and wherever it launches it hands the call's work
(:func:`decode_attention_work`) to :func:`repro_torch.kernels.build.
note_kernel`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.build import Work, check_launch, load, note_kernel
from repro_torch.kernels.ref import decode_attention_ref, head_group

__all__ = ["decode_attention", "plan_decode", "DecodePlan",
           "decode_attention_work"]

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/decode_attention.cu: keys per staged tile, its largest block (64
# query rows), the widest head of the served segments per lane and, with
# twice as many, the widest head it takes; the shared memory a block can have.
DA_TILE, DA_MAX_WARPS, DA_MAX_DH, DA_WIDE_DH = 32, 16, 256, 512
DA_GROUP = 4 * DA_MAX_WARPS
SMEM_PER_BLOCK = 232448
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class DecodePlan:
    """How ``csrc/decode_attention.cu`` runs one call: ``splits`` blocks
    per (b, KV head), block s taking keys ``[s * chunk, (s + 1) * chunk)``
    below the sequence's length (``windowed``: chunk ``first + s``, first
    the chunk of the row's start, so ``ceil(W / chunk) + 1`` blocks cover a
    window of W keys), ``warps`` warps of ``rows`` query rows each, over
    ``groups`` blocks of at most 64 query rows of a KV head (more than one
    only for G > 64); a second pass merges the splits when there are more
    than one."""

    chunk: int
    splits: int
    warps: int
    rows: int
    groups: int = 1
    windowed: bool = False

    def group_rows(self, G: int) -> int:
        """Query rows of a KV head per block."""
        return _cdiv(G, self.groups)

    def live(self, length: int, start: int = 0) -> range:
        """The grid's splits that hold keys ``[start, length)``: the ones
        the combine reads, in order."""
        if start >= length:
            return range(0)
        first = start // self.chunk
        base = first if self.windowed else 0
        return range(first - base, min(self.splits, _cdiv(length, self.chunk) - base))

    def live_splits(self, length: int, start: int = 0) -> int:
        """How many splits hold keys of a row of ``length`` keys from
        ``start`` on."""
        return len(self.live(length, start))


def plan_decode(B: int, KV: int, G: int, S: int, dh: int, dtype: torch.dtype,
                sms: int = H100_SMS, window: int = 0) -> DecodePlan:
    """The plan for q (B, KV * G, dh) against caches of S positions: the
    shapes alone decide it (the window W is one), never the lengths' values.

    The chunk starts at one tile (32 keys) and doubles while a cache filled
    to a quarter of S (of min(S, W) with a window) would still give every
    SM about one block with keys (B * KV * S / (4 * chunk) >= sms after
    doubling); so qwen2.5-3b's decode (B 8, KV 2, S 2048) takes 32-key
    chunks, 64 splits, and with a window of 256 9 splits a row from its
    start's chunk on (``windowed``).  Four warps share
    the query rows of a block, one, two or four each; beyond 16 rows, more
    warps of four.  G > 64 takes ``groups`` blocks of at most 64 rows each,
    balanced.  dh up to 512 is taken while two staged tiles of k and v fit
    in a block's shared memory (float32: dh <= 438 to 452, by G); beyond
    that it raises."""
    if dtype not in _DTYPE:
        raise TypeError(f"decode_attention: dtype {dtype} (float32 or bfloat16)")
    if window < 0:
        raise ValueError(f"decode_attention: window={window} (>= 0)")
    groups = _cdiv(G, DA_GROUP)
    gsz = _cdiv(G, groups)
    rows = next(r for r in (1, 2, 4) if r == 4 or 4 * r >= gsz)
    warps = max(4, _cdiv(gsz, rows))
    item = 4 if dtype == torch.float32 else 2
    pitch = _cdiv(dh, 16 // item) * (16 // item)
    smem = 4 * DA_TILE * pitch * item + warps * rows * DA_TILE * 4
    if not 1 <= dh <= DA_WIDE_DH or smem > SMEM_PER_BLOCK:
        raise ValueError(f"decode_attention: dh = {dh} not taken in {dtype} "
                         f"(dh <= {DA_WIDE_DH} and {smem} bytes of shared "
                         f"memory <= {SMEM_PER_BLOCK})")
    span = min(S, window) if window else S
    chunk = DA_TILE
    while chunk < span and B * KV * span >= 4 * sms * 2 * chunk:
        chunk *= 2
    splits = _cdiv(S, chunk)
    if window and _cdiv(window, chunk) + 1 < splits:
        return DecodePlan(chunk, _cdiv(window, chunk) + 1, warps, rows, groups,
                          True)
    return DecodePlan(chunk, splits, warps, rows, groups)


def decode_attention_work(B: int, S: int, H: int, KV: int, dh: int, item: int,
                          window: int = 0, return_lse: bool = False,
                          starts: bool = False) -> Work:
    """One call's work over the whole cache (the lengths are data; a
    ``window`` bounds the keys a row reads to W): q·kᵀ and p·v (4·dh flops
    a key and query head), an exponential a key, q, the caches' keys, the
    lengths (and starts) read and the output (and log-sum-exp) written
    once."""
    keys = min(window, S) if window else S
    out_item = 4 if return_lse else item
    nbytes = (item * (B * H * dh + 2 * B * keys * KV * dh) + 4 * B * (1 + starts)
              + B * H * dh * out_item + (4 * B * H if return_lse else 0))
    return Work(flops=4.0 * B * H * dh * keys, bytes=float(nbytes),
                transcendentals=float(B * H * keys))


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.da_launch.argtypes = ([vp] * 8 + [ci] * 7 + [cl] * 8 + [ctypes.c_float]
                              + [ci] * 10 + [vp])
    lib.da_launch.restype = ci


def _lengths(cache_len, B: int, S: int, least: int = 1,
             name: str = "cache_len") -> torch.Tensor:
    """``cache_len`` (or ``cache_start``) as an int32 tensor of B
    positions, on the device it was given on (the host for a sequence).
    Positions on the host are checked to lie in [least, S]; positions on
    the card are not read back."""
    lens = (cache_len if torch.is_tensor(cache_len)
            else torch.as_tensor(np.asarray(cache_len)))
    if lens.shape != (B,):
        raise ValueError(f"decode_attention: {name} of shape "
                         f"{tuple(lens.shape)}, expected ({B},)")
    lens = lens.to(torch.int32).contiguous()
    if lens.device.type == "cpu" and B and bool(((lens < least) | (lens > S)).any()):
        raise ValueError(f"decode_attention: {name} must lie in [{least}, {S}], "
                         f"got {lens.tolist()}")
    return lens


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, cache_start=None,
                     window: int = 0, round_p: bool = True,
                     return_lse: bool = False, group: int | None = None,
                     head_offset: int = 0):
    """One decode step of attention → (B, H, dh) in q's dtype, and with
    ``return_lse`` (out float32, log-sum-exp (B, H) float32); keys
    ``[cache_start[b], cache_len[b])``, at most the last ``window``.
    ``group`` and ``head_offset``: a rank's share of an uneven split, head
    h reading KV head ``(head_offset + h) // group``
    (:func:`~repro_torch.kernels.ref.head_group`): a block keeps its KV
    head's G query rows as ever, those outside ``[0, H)`` zero and never
    written.  No heads: nothing is launched."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q (B, H, dh) and caches (B, S, KV, "
                         f"dh) expected, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != dh:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} do "
                         f"not match q {tuple(q.shape)}")
    G = head_group(H, KV, group, head_offset)
    lens = _lengths(cache_len, B, S, least=0 if return_lse else 1)
    starts = (None if cache_start is None
              else _lengths(cache_start, B, S, 0, "cache_start"))
    if window < 0:
        raise ValueError(f"decode_attention: window={window} (>= 0)")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lens,
                                    cache_start=starts, window=window,
                                    round_p=round_p, return_lse=return_lse,
                                    group=group, head_offset=head_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on cuda, cpu or meta, not "
                         f"{q.device}")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("decode_attention: q and the caches must share a device")
    if q.dtype not in _DTYPE or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype} (float32 or bfloat16, all the same)")
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: the last axis of q and of the "
                         "caches must be contiguous")
    out = torch.empty((B, H, dh),
                      dtype=torch.float32 if return_lse else q.dtype,
                      device=q.device)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    note_kernel("decode_attention", decode_attention_work, B, S, H, KV, dh,
                q.element_size(), window, return_lse, starts is not None)
    if q.device.type == "meta":
        return (out, lse) if return_lse else out
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = plan_decode(B, KV, G, S, dh, q.dtype, sms, window=window)
    lib = load("decode_attention", _declare)
    lens = lens.to(q.device, non_blocking=True)
    if starts is not None:
        starts = starts.to(q.device, non_blocking=True)
    ws = (torch.empty(plan.splits * B * KV * G * (dh + 2), dtype=torch.float32,
                      device=q.device) if plan.splits > 1 else None)
    words = 16 // q.element_size()
    vec = all(t.data_ptr() % 16 == 0 and all(s % words == 0 for s in t.stride()[:3])
              for t in (k_cache, v_cache)) and dh % words == 0
    err = lib.da_launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        out.data_ptr(), lens.data_ptr(),
                        None if starts is None else starts.data_ptr(),
                        None if ws is None else ws.data_ptr(),
                        None if lse is None else lse.data_ptr(), B, S, H, KV, dh,
                        G, head_offset, q.stride(0), q.stride(1),
                        *k_cache.stride()[:3], *v_cache.stride()[:3],
                        dh ** -0.5, int(round_p),
                        int(vec), _DTYPE[q.dtype], plan.chunk, plan.splits,
                        plan.warps, plan.rows, plan.group_rows(G),
                        window, int(plan.windowed),
                        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attention", err)
    return (out, lse) if return_lse else out
