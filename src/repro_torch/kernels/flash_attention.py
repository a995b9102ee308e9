"""Fused flash attention (forward), GQA, causal or full.

:func:`flash_attention_fused` computes softmax(q kᵀ / sqrt(dh)) v with q
(B, Sq, H, dh), k and v (B, Sk, KV, dh), query head h reading KV head
h // (H / KV), the output (B, Sq, H, dh) in q's dtype.  A rank's share of
a split over ``model`` that does not divide the heads (the planner's
``allow_uneven``) passes ``group`` (G) and ``head_offset``: head h reads
KV head ``(head_offset + h) // group``, and every wrapper here (forward,
backward, :class:`FlashAttentionFn`) takes the pair; the kernels walk
each KV head's G rows as ever, those of heads outside the call's read as
zeros and never written (no repeat of K and V, no copy of q).  On CPU tensors it
runs the plain version :func:`repro_torch.kernels.ref.flash_attention_ref`;
on CUDA tensors a hand-written kernel of ``csrc/flash_attention.cu`` or it
raises.  :func:`flash_route` picks the kernel: bfloat16 runs on the tensor
cores (``fa_tc_kernel``: wgmma, TMA; row tiles of the whole tokens
:func:`tile_rows` states, so any G up to 64, or 128) wherever the shapes
allow it, float32 and the other bfloat16 shapes on the CUDA cores
(``fa_kernel``; TF32 would break the parity contract), with the tiling
:func:`plan_flash_simt` states (the kernel computes the same from the
shapes).
Both read q, k and v in this layout through their strides, so a strided
view needs no copy.  Any dh is taken: above 256 the CUDA-core kernel splits
the output columns over blocks.
``LAUNCHES["flash_attention_wgmma"]`` and ``LAUNCHES["flash_attention"]``
count the two kernels' launches.

The gradient, for training: :func:`flash_attention_bwd` gives dq, dk, dv
(and each row's log-sum-exp) of the attention with fp32 p from the output's
gradient, on CPU tensors by the plain version
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`, on the card by one
of two pairs of backward kernels of the same source (no atomics on floats,
two calls bitwise equal).  :func:`flash_bwd_route` picks the pair: dh a
multiple of 8 up to 256, G = H / KV up to 64 or 128 (float32 above dh 128:
up to 16), and 16-byte bases and strides runs on the tensor cores
(``fbt_dq_kernel``, then ``fbt_dkdv_kernel`` or ``fbt_dkdv2_kernel``:
wgmma, TMA, row tiles of whole tokens, each key tile's row walk cut into
the pieces :func:`plan_flash_bwd` states; bfloat16: p and ds as three bf16
terms; float32: every operand as two fp16 terms, hi and mid, of the
input scaled by a power of two (``fbs_amax_kernel``, then
``fbs_split_kernel`` for q, k, v and g; p and ds by each row's power),
each product hi.hi + hi.mid + mid.hi, the scores' hi.hi summed apart from
the cross pairs; float32 at DHP 256 in row tiles of 16 slots); dh not a
multiple of 8, unaligned views and the G the row tiles cannot hold on the
CUDA cores (``fb_dq_kernel``, then ``fb_dkdv_kernel``).
``round_p=torch.bfloat16`` gives the gradient of attention whose P·V
takes p rounded to bfloat16 (the model's ``probs_bf16``): the rounding is
relative to each row's max, so the max's gradient reaches the row's argmax
key.  Both pairs take it as a template flag: bfloat16 on the route the
fp32-p call of the same shapes takes, float32 always on the CUDA cores
(that gradient moves by a bf16 ulp wherever fp32 rounding flips r(), so
it holds float32's limit only when summed in the plain version's order).
The dq kernel streams the keys three times (the max must be known before
any p is rounded: the scores alone for m and l, then D and the argmax
share, then ds and dq) and hands each row's m, l, D / l and share to the
dkdv kernel through the scratch.  Both forward kernels round p against
the row's max too at dh <= 256 (a first pass over the keys for the max;
``fa_kernel``'s column split above dh 256 keeps a key tile's running
max), serving and training alike, so a model with ``probs_bf16`` trains
the function whose gradient the backward gives.
``LAUNCHES["flash_attention_bwd_wgmma"]`` and
``LAUNCHES["flash_attention_bwd"]`` count the two routes' calls, all the
kernels of a call as one.  :class:`FlashAttentionFn` is the forward kernel
with that backward, as autograd takes it; :func:`flash_attention_train` is
what the model's attention calls when it needs a gradient (the plain
version on the CPU, autograd through it).  There is no fallback on the
card: a build or launch that fails raises.

On meta tensors (shapes only: :mod:`repro_torch.launch.op_analysis`
counting a step) each wrapper returns its kernel's outputs empty, with the
shapes and dtypes of the plain version's; there and wherever it launches
it hands the call's work (:func:`flash_attention_work`,
:func:`flash_attention_bwd_work`: the products over the pairs the mask
keeps, :func:`kept_pairs`) to :func:`repro_torch.kernels.build.
note_kernel`, under its ``LAUNCHES`` key.

``round_p`` (default True, what the TPU kernel does) rounds the
probabilities to v's dtype before P·V; ``torch.bfloat16`` rounds them to
bfloat16 whatever v's dtype (the model's ``probs_bf16`` at float32); False
keeps them in fp32, as the model's own attention does.  ``window`` > 0
(causal only) masks the keys at or below ``qpos - window`` too, a sliding
window; both kernels skip the key tiles wholly below it.  The CUDA-core
kernel scales q in fp32 before
the product, the model's order; the tensor-core kernel multiplies the
unscaled bf16 q and scales the fp32 scores, which differs by fp32 rounding
only, and keeps an fp32 p as three bf16 terms (hi + mid + lo: all 24 bits).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.build import Work, check_launch, load, note_kernel
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, head_group)

__all__ = ["flash_attention_fused", "flash_route", "plan_flash_simt",
           "FlashSimtPlan", "flash_attention_bwd", "flash_bwd_route",
           "plan_flash_bwd", "FlashBwdPlan", "tile_rows",
           "FlashAttentionFn", "flash_attention_train", "kept_pairs",
           "flash_attention_work", "flash_attention_bwd_work"]

MAX_DH = 256          # the widest head the tensor-core kernel takes
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/flash_attention.cu, fa_kernel: (token, g) rows of a tile (4 a thread
# over 256 threads), output columns of a block when dh > 256.
SIMT_ROWS, SIMT_WIDE = 64, 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class FlashSimtPlan:
    """How ``fa_kernel`` runs one call: ``dhp`` columns of q, k and v in
    shared memory (dh padded to 64, 128 or 256), key tiles of ``keys``,
    ``tiles`` tiles of ``SIMT_ROWS`` (token, g) rows per (b, KV head), each
    split over ``col_chunks`` blocks of output columns (dh > 256, ``wide``),
    ``blocks`` in all, the heaviest causal tiles first, ``smem`` bytes of
    shared memory each (one block per SM)."""

    dhp: int
    keys: int
    wide: bool
    col_chunks: int
    tiles: int
    blocks: int
    smem: int


def plan_flash_simt(B: int, Sq: int, H: int, KV: int, dh: int,
                    group: int | None = None) -> FlashSimtPlan:
    """``fa_kernel``'s tiling for q (B, Sq, H, dh) over KV heads (``group``
    query heads each, ``H / KV`` where None), from the shapes alone:
    qwen2.5-3b's 1,024-token prefill (H 16, KV 2) runs 256 blocks of 64
    (token, g) rows, one an SM at a time."""
    if dh < 1 or KV < 1 or (group is None and H % KV):
        raise ValueError(f"flash_attention: H {H}, KV {KV}, dh {dh}")
    G = group or H // KV
    dhp = 64 if dh <= 64 else 128 if dh <= 128 else 256
    keys = 64 if dhp <= 128 else 32
    wide = dh > SIMT_WIDE
    col_chunks = _cdiv(dh, SIMT_WIDE) if wide else 1
    tiles = _cdiv(Sq * G, SIMT_ROWS)
    floats = (SIMT_ROWS * (dhp + 4) + 2 * keys * (dhp + 4) + 2 * keys * dhp
              + SIMT_ROWS * (keys + 4))
    return FlashSimtPlan(dhp, keys, wide, col_chunks, tiles,
                         B * KV * col_chunks * tiles, 4 * floats)


# csrc/flash_attention.cu, fbt_dq_kernel and fbt_dkdv_kernel: row slots of
# a dq block (two row tiles), keys of a dkdv block, row slots of a row tile
# (a wgmma's 64 rows), and of a row tile of float32 at DHP 256 (FbtGeo: its
# two fp16 terms weigh as a bfloat16 head of width 512); the widest head;
# the H100's SMs; the fewest row tiles a piece walks once a key tile's walk
# is cut; the shared memory a block may take.
BWD_QROWS, BWD_KEYS, BWD_KROWS, BWD_F32_WIDE_ROWS = 128, 64, 64, 16
BWD_MAX_DH, BWD_F32_MAX_DH = 256, 256
BWD_SMS = 132
BWD_MIN_TILES = 4
SMEM_MAX = 232448


def tile_rows(G: int, slots: int = BWD_KROWS) -> int:
    """(token, g) rows a row tile of the tensor-core kernels (forward and
    backward) holds: the whole tokens that fit its ``slots`` (``BWD_KROWS``:
    60 at G 6, 10 tokens, 4 slots left empty), or in 64 slots at G 128 half
    a token.  0 where neither fits (G 65..127, G > 128; in the 16 slots of
    float32 at DHP 256, ``BWD_F32_WIDE_ROWS``, G above 16): such calls stay
    on the CUDA cores."""
    if G <= slots:
        return G * (slots // G)
    return BWD_KROWS if slots == BWD_KROWS and G == 2 * BWD_KROWS else 0


def bwd_row_slots(dh: int, dtype: torch.dtype) -> int:
    """Row slots of a row tile of the tensor-core backward: 16 for float32
    at DHP 256 (``BWD_F32_WIDE_ROWS``), else ``BWD_KROWS``."""
    return BWD_F32_WIDE_ROWS if dtype == torch.float32 and dh > 128 else BWD_KROWS


@dataclass(frozen=True)
class FlashBwdPlan:
    """How the tensor-core backward runs one call.  ``terms``: 16-bit terms
    of each of q, k, v and g (1 bfloat16; 2 float32, fp16 hi and mid of the
    input scaled by a power of two, copied with the four inputs' largest
    magnitudes to ``terms_bytes`` of scratch by ``fbs_amax_kernel`` and
    ``fbs_split_kernel`` first).  Rows are
    (token, g) pairs, ``tile_rows`` of them to a row tile of ``row_slots``
    slots (the slots past them empty: zero in the operands, never written).
    ``dq_blocks`` blocks of ``fbt_dq_kernel``, ``dq_slots`` row slots each
    (two row tiles of 64; float32 at DHP 256 four of 16), k and v
    streamed ``dq_keys`` keys a stage, ``dq_smem`` bytes of shared memory;
    then ``dkdv_blocks`` of ``fbt_dkdv_kernel`` (``fbt_dkdv2_kernel``, two
    consumer warpgroups, where ``dhp`` x ``terms`` is above 128),
    ``dkdv_smem`` bytes each: ``key_tiles``
    tiles of ``BWD_KEYS`` keys per (b, KV head), each walking the row tiles
    ``row_tiles[kt]`` = [lo, hi) that can see one of its keys (a row tile a
    stage), cut into ``pieces`` runs (:meth:`piece`), ``per_sm`` blocks
    resident on an SM.
    ``scratch_bytes``: each slot's base-2 log-sum-exp and D (``rows_pad``
    slots per (b, KV head); p rounded: its max, l, D / l and the argmax
    share), and with ``pieces`` > 1 the pieces' fp32 partial dk and dv and
    one arrival counter per key tile."""

    dhp: int
    tile_rows: int
    dq_keys: int
    per_sm: int
    rows_pad: int
    key_tiles: int
    row_tiles: tuple[tuple[int, int], ...]
    pieces: int
    dq_blocks: int
    dkdv_blocks: int
    scratch_bytes: int
    terms: int
    dq_smem: int
    dkdv_smem: int
    terms_bytes: int
    row_slots: int
    dq_slots: int

    def piece(self, kt: int, p: int) -> tuple[int, int]:
        """Row tiles [lo, hi) that piece ``p`` of key tile ``kt`` walks."""
        lo, hi = self.row_tiles[kt]
        n = max(0, hi - lo)
        return lo + n * p // self.pieces, lo + n * (p + 1) // self.pieces


@functools.lru_cache(maxsize=256)
def plan_flash_bwd(B: int, Sq: int, Sk: int, H: int, KV: int, dh: int,
                   causal: bool = True, window: int = 0,
                   dtype: torch.dtype = torch.bfloat16,
                   round_p: bool = False,
                   group: int | None = None) -> FlashBwdPlan:
    """The tensor-core backward's plan, from the shapes, the mask and the
    dtype alone (the kernels take ``pieces`` from it and compute the rest
    alike).  ``dhp``: dh padded to 64, 128 or 256; float32 holds each
    operand as two fp16 terms, so its tiles weigh as a bfloat16 head of
    twice the width.  Where ``dhp`` x ``terms`` is above 128 a dq stage
    holds 32 keys (the 128-row q and g tiles take 128 KB) and one dkdv
    block (``fbt_dkdv2_kernel``) fills an SM (k, v, two stages of rows and
    P^T handed between its warpgroups: 208 KB), else 64 keys and two
    blocks; float32 at DHP 256 (512 in bfloat16 terms) cuts row tiles of
    16 slots (G up to 16): a dq block of 64 slots (four row tiles) over
    stages of 16 keys, a dkdv stage one row tile.
    The pieces a key tile's walk is cut into: enough that the longest walk,
    so cut, is no longer than the resident blocks (``per_sm`` x ``BWD_SMS``)
    take for the whole work, but no piece shorter than ``BWD_MIN_TILES`` row
    tiles.  qwen2.5-3b's heads at S 4,096, causal: 64 key tiles a KV head
    (128 in all), 5 pieces each.  ``round_p`` (p rounded to bfloat16,
    bfloat16 only): the same kernels with four statistics a row slot (m,
    l, D / l and the argmax share) in the scratch and in each dkdv stage,
    in place of two (lse and D).  ``group``: the query heads a KV head
    serves where the heads are a rank's share of an uneven split (None:
    ``H / KV``); the rows are each KV head's G (token, g) pairs, those
    outside the rank's heads zero (:func:`flash_attention_bwd`)."""
    ni = {torch.bfloat16: 1, torch.float32: 2}.get(dtype)
    widest = BWD_MAX_DH if ni == 1 else BWD_F32_MAX_DH
    if (ni is None or dh < 1 or dh > widest or KV < 1
            or (group is None and H % KV) or Sk < 1):
        raise ValueError(f"flash_attention_bwd: H {H}, KV {KV}, dh {dh}, Sk {Sk}, "
                         f"{dtype}")
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention_bwd: window={window} (>= 0, causal only)")
    if round_p and ni == 2:
        raise ValueError("flash_attention_bwd: p rounded on the tensor cores is "
                         "bfloat16 only")
    G = group or H // KV
    rs = bwd_row_slots(dh, dtype)
    rt = tile_rows(G, rs)
    if not rt:
        raise ValueError(f"flash_attention_bwd: G {G} (up to 64, or 128; "
                         f"float32 above dh 128: up to {BWD_F32_WIDE_ROWS})")
    nrows = Sq * G
    dhp = 64 if dh <= 64 else 128 if dh <= 128 else 256
    one = rs != BWD_KROWS                   # csrc FbtGeo::ONE
    dq_slots = BWD_KROWS if one else BWD_QROWS
    ntiles = _cdiv(nrows, rt)
    nqb = _cdiv(ntiles, dq_slots // rs)
    rows_pad = nqb * dq_slots
    nkt = _cdiv(Sk, BWD_KEYS)
    tiles = []
    for kt in range(nkt):
        k0 = kt * BWD_KEYS
        nk = min(BWD_KEYS, Sk - k0)
        lo = min(nrows, k0 * G) if causal else 0
        hi = min(nrows, (k0 + nk - 1 + window) * G) if window else nrows
        tiles.append((lo // rt, _cdiv(hi, rt)))
    walks = [max(0, hi - lo) for lo, hi in tiles]
    total, top = B * KV * sum(walks), max(walks)
    wide = dhp * ni > 128
    per_sm = 1 if wide else 2
    pieces = 1
    if total:
        pieces = max(1, min(_cdiv(top * per_sm * BWD_SMS, total),
                            top // BWD_MIN_TILES))
    nbkv = B * KV
    nst = 4 if round_p else 2             # statistics a row slot
    scratch = 4 * nst * nbkv * rows_pad
    if pieces > 1:
        scratch += 4 * nkt * nbkv * (pieces * 2 * BWD_KEYS * dhp + 1)
    dq_keys = 16 if one else 32 if wide else 64
    # csrc FbtQShape, FbtKShape: each term's q and g tiles and k and v
    # stages; k and v, two stages of rows, P^T (two warpgroups) and the
    # rows' statistics; then the mbarriers and 1 KB of alignment
    dq_smem = ni * 2 * dhp * 2 * (dq_slots + 2 * dq_keys) + 40 + 1024
    dkdv_smem = (ni * 2 * dhp * 2 * (BWD_KEYS + 2 * rs)
                 + (rs // 2 * 128 * 4 if wide else 0) + 2 * nst * rs * 4
                 + 56 + 1024)
    terms_bytes = (0 if ni == 1     # two fp16 terms of q, g, k, v; 4 maxima
                   else 2 * 2 * (2 * B * Sq * H * dh + 2 * B * Sk * KV * dh) + 16)
    return FlashBwdPlan(dhp, rt, dq_keys, per_sm, rows_pad, nkt, tuple(tiles),
                        pieces, nqb * nbkv, nkt * nbkv * pieces, scratch, ni,
                        dq_smem, dkdv_smem, terms_bytes, rs, dq_slots)


def bwd_kernel_facts(dh: int, dtype: torch.dtype = torch.bfloat16,
                     round_p: bool = False) -> dict:
    """The tensor-core backward kernels' own figures at head width ``dh``
    (``fbt_query``; builds the library, so on the card only), with p in
    fp32 or rounded to bfloat16 (``round_p``, bfloat16 only): the shared
    memory of a dq and of a dkdv block (what :func:`plan_flash_bwd` states
    as ``dq_smem`` and ``dkdv_smem``), and the products each kernel issues
    for each of the five products the gradient needs."""
    out = (ctypes.c_longlong * 4)()
    err = load("flash_attention", _declare).fbt_query(dh, _DTYPE[dtype],
                                                      int(round_p), out)
    if err:
        raise ValueError(f"fbt_query: dh {dh} {dtype} is not on the "
                         f"tensor-core route ({err})")
    return dict(dq_smem=out[0], dkdv_smem=out[1], dq_products=out[2],
                dkdv_products=out[3])


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fa_launch.argtypes = ([vp] * 4 + [ci] * 8 + [cl] * 9 + [ctypes.c_float]
                              + [ci] * 5 + [vp])
    lib.fa_launch.restype = ci
    lib.fa_tc_launch.argtypes = ([vp] * 4 + [ci] * 8 + [cl] * 9
                                 + [ctypes.c_float] + [ci] * 3 + [vp])
    lib.fa_tc_launch.restype = ci
    lib.fb_launch.argtypes = ([vp] * 9 + [ci] * 8 + [cl] * 12
                              + [ctypes.c_float] + [ci] * 4 + [vp])
    lib.fb_launch.restype = ci
    lib.fbt_launch.argtypes = ([vp] * 9 + [cl] + [ci] * 8 + [cl] * 12
                               + [ctypes.c_float] + [ci] * 5 + [vp] * 2)
    lib.fbt_launch.restype = ci
    lib.fbt_query.argtypes = [ci, ci, ci, ctypes.POINTER(cl)]
    lib.fbt_query.restype = ci


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                group: int | None = None) -> str:
    """``"wgmma"`` where ``fa_tc_kernel`` takes the call — bfloat16, dh a
    multiple of 8 up to 256, G (``group``, or H / KV) whose tokens a row
    tile can hold whole (up to 64) or halve (128: :func:`tile_rows`), and
    every base and every stride of q, k and v on 16 bytes (what TMA needs)
    — else ``"simt"`` (``fa_kernel``).  Reads shapes, strides and pointers
    only."""
    H, dh, KV = q.shape[2], q.shape[3], k.shape[2]
    if (q.dtype != torch.bfloat16 or dh % 8 or dh > MAX_DH
            or not tile_rows(group or H // KV)):
        return "simt"
    return "wgmma" if all(_aligned(t) for t in (q, k, v)) else "simt"


def _aligned(t: torch.Tensor) -> bool:
    """Base and the strides of the first three axes on 16 bytes (a multiple
    of 8 bf16 or 4 float32 elements): what TMA, and the float32 split's
    16-byte loads, need."""
    return t.data_ptr() % 16 == 0 and all((t.element_size() * s) % 16 == 0
                                          for s in t.stride()[:3])


def flash_bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    round_p: bool | torch.dtype = False,
                    group: int | None = None) -> str:
    """``"wgmma"`` where the tensor-core backward (``fbt_dq_kernel``, then
    ``fbt_dkdv_kernel`` or ``fbt_dkdv2_kernel``) takes the call — bfloat16
    with p in fp32 or rounded to bfloat16 (``round_p``: the same shapes
    either way), or float32 with p in fp32, dh a multiple of 8 up to 256,
    G = H / KV whose tokens row tiles can hold whole (up to 64) or halve
    (128: :func:`tile_rows`; float32 above dh 128, row tiles of 16 slots:
    up to 16), and every base and stride of q, k and v on 16 bytes — else
    ``"simt"`` (``fb_dq_kernel``, ``fb_dkdv_kernel``: dh not a multiple of
    8, unaligned views, the G the row tiles refuse, and float32 with p
    rounded, whose gradient holds float32's limit only when summed in the
    plain version's order: ``csrc/flash_attention.cu``, point 6).  Reads
    shapes, strides and pointers only."""
    if round_p is not False and round_p != torch.bfloat16:
        raise ValueError(f"flash_bwd_route: round_p={round_p!r} (False or "
                         "torch.bfloat16)")
    if round_p is not False and q.dtype == torch.float32:
        return "simt"
    H, dh, KV = q.shape[2], q.shape[3], k.shape[2]
    top = {torch.bfloat16: BWD_MAX_DH, torch.float32: BWD_F32_MAX_DH}.get(q.dtype, 0)
    if dh % 8 or dh > top or not tile_rows(group or H // KV,
                                           bwd_row_slots(dh, q.dtype)):
        return "simt"
    return "wgmma" if all(_aligned(t) for t in (q, k, v)) else "simt"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           group: int | None = None, head_offset: int = 0) -> int:
    """Check the shapes; return G, the query heads a KV head serves."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B, Sq, H, dh) and k, v (B, Sk, "
                         f"KV, dh) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    G = head_group(H, k.shape[2], group, head_offset)
    if k.shape[1] < 1:
        raise ValueError("flash_attention: no keys")
    return G


def _round_mode(round_p: bool | torch.dtype, dh: int) -> int:
    """The kernels' ``round_p`` at head width ``dh``: 0 fp32 p, 1 v's dtype,
    2 bfloat16, each against a key tile's running max; 3 bfloat16 against
    the row's max, found in a first pass over the keys
    (``torch.bfloat16`` on either kernel up to dh 256; above it only
    ``fa_kernel``'s column split takes the call, and keeps 2)."""
    if round_p is True or round_p is False:
        return int(round_p)
    if round_p == torch.bfloat16:
        return 3 if dh <= SIMT_WIDE else 2
    raise ValueError(f"flash_attention: round_p={round_p!r} (a bool or "
                     "torch.bfloat16)")


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          round_p: bool | torch.dtype = True,
                          group: int | None = None,
                          head_offset: int = 0) -> torch.Tensor:
    """Fused attention → (B, Sq, H, dh) in q's dtype.  With
    ``round_p=torch.bfloat16`` both kernels at dh <= 256 round p against
    each row's max, found in a first pass over the keys (the plain
    version's function, and the one the rounded-p backward
    differentiates); ``fa_kernel``'s column split above dh 256 against a
    key tile's running max.  ``group`` and ``head_offset``: a rank's share
    of an uneven split, head h reading KV head ``(head_offset + h) //
    group`` (:func:`~repro_torch.kernels.ref.head_group`); the kernels
    walk each KV head's G (token, g) rows as ever, read the rows of heads
    outside ``[0, H)`` as zeros (TMA's fill, or a masked load) and write
    none of them.  No heads: nothing is launched."""
    G = _check(q, k, v, group, head_offset)
    _round_mode(round_p, q.shape[3])     # round_p a bool or torch.bfloat16
    _check_window(causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   round_p=round_p, group=group,
                                   head_offset=head_offset)
    _on_card_or_meta(q)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share a device")
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} (float32 or bfloat16, all the same)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last axis of q, k and v must "
                         "be contiguous")
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    route = flash_route(q, k, v, G)
    note_kernel("flash_attention_wgmma" if route == "wgmma" else "flash_attention",
                flash_attention_work, B, Sq, Sk, H, KV, dh, q.element_size(),
                causal, window)
    if q.device.type == "meta":
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = load("flash_attention", _declare)
    mode = _round_mode(round_p, dh)
    if route == "wgmma":
        err = lib.fa_tc_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), B, Sq, Sk, H, KV, dh, G,
                               head_offset, *q.stride()[:3], *k.stride()[:3],
                               *v.stride()[:3], dh ** -0.5, int(causal),
                               mode, window, stream)
        check_launch("flash_attention_wgmma", err)
        return out
    words = 16 // q.element_size()
    vec = all(t.data_ptr() % 16 == 0 and all(s % words == 0 for s in t.stride()[:3])
              for t in (k, v)) and dh % words == 0
    err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        B, Sq, Sk, H, KV, dh, G, head_offset, *q.stride()[:3],
                        *k.stride()[:3],
                        *v.stride()[:3], dh ** -0.5, int(causal), mode,
                        int(vec), _DTYPE[q.dtype], window, stream)
    check_launch("flash_attention", err)
    return out


def _on_card_or_meta(q: torch.Tensor) -> None:
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                         f"{q.device}")


def kept_pairs(Sq: int, Sk: int, causal: bool = True, window: int = 0) -> int:
    """The (query, key) pairs of one head that the mask keeps: every pair
    unmasked, else keys ``[max(0, t − window + 1), min(t, Sk − 1)]`` of
    query t (the top-left causal mask; S(S + 1)/2 for square causal)."""
    if not causal:
        return Sq * Sk
    t = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(t - window + 1, 0) if window else 0
    return int(np.maximum(np.minimum(t, Sk - 1) - lo + 1, 0).sum())


def flash_attention_work(B: int, Sq: int, Sk: int, H: int, KV: int, dh: int,
                         item: int, causal: bool = True,
                         window: int = 0) -> Work:
    """One forward call's work: q·kᵀ and p·v over the pairs the mask keeps
    (4·dh flops a pair and query head), an exponential a pair, q, k and v
    (``item`` bytes an element) read and the output written once."""
    pairs = B * H * kept_pairs(Sq, Sk, causal, window)
    return Work(flops=4.0 * dh * pairs,
                bytes=float(item * (2 * B * Sq * H * dh + 2 * B * Sk * KV * dh)),
                transcendentals=float(pairs))


def flash_attention_bwd_work(B: int, Sq: int, Sk: int, H: int, KV: int,
                             dh: int, item: int, causal: bool = True,
                             window: int = 0) -> Work:
    """One backward call's work: the five products (s, dp, dv, dk, dq; 10·dh
    flops a kept pair and query head), p's exponential again, q, k, v and
    the output's gradient read, dq, dk, dv and the rows' float32
    log-sum-exp written once."""
    pairs = B * H * kept_pairs(Sq, Sk, causal, window)
    return Work(flops=10.0 * dh * pairs,
                bytes=float(item * (3 * B * Sq * H * dh + 4 * B * Sk * KV * dh)
                            + 4 * B * H * Sq),
                transcendentals=float(pairs))


def _check_window(causal: bool, window: int) -> None:
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention: window={window} (>= 0, causal only)")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, *, causal: bool = True,
                        window: int = 0, route: str | None = None,
                        round_p: bool | torch.dtype = False,
                        group: int | None = None, head_offset: int = 0
                        ) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`flash_attention_fused` with fp32 p
    (``round_p=False``) or p rounded to bfloat16 in P·V
    (``round_p=torch.bfloat16``: the gradient of the plain version's
    function, rounded against each row's max, as the reference's
    ``probs_bf16`` under ``jax.grad`` with one KV chunk) against the output
    gradient ``g`` (B, Sq, H, dh): (dq, dk, dv) in the inputs' dtype, and
    lse (B, H, Sq) float32, each row's log-sum-exp of its scaled, masked
    scores.  dh up to 256 on the card, on the kernels :func:`flash_bwd_route`
    picks; ``route="simt"`` runs the CUDA-core kernels on any call (to time
    them against the tensor cores).  ``group`` and ``head_offset`` as
    :func:`flash_attention_fused` takes them: the rows outside the heads
    are zeros (q and g alike), so they add nothing to dk and dv, and a KV
    head whose group other ranks share gets this rank's heads' part of its
    gradient (the model sums the parts over ``model``)."""
    G = _check(q, k, v, group, head_offset)
    _check_window(causal, window)
    if round_p is not False and round_p != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd: round_p={round_p!r} (False "
                         "or torch.bfloat16)")
    if g.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: g {tuple(g.shape)} is not "
                         f"q's shape {tuple(q.shape)}")
    if route not in (None, "simt"):
        raise ValueError(f"flash_attention_bwd: route={route!r} (None or "
                         "'simt')")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, g, causal=causal, window=window,
                                       round_p=round_p, group=group,
                                       head_offset=head_offset)
    _on_card_or_meta(q)
    if any(t.device != q.device for t in (k, v, g)):
        raise ValueError("flash_attention_bwd: q, k, v and g must share a device")
    if q.dtype not in _DTYPE or any(t.dtype != q.dtype for t in (k, v, g)):
        raise TypeError(f"flash_attention_bwd: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {g.dtype} (float32 or bfloat16, all the same)")
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if dh > MAX_DH:
        raise ValueError(f"flash_attention_bwd: dh {dh} > {MAX_DH} (no config "
                         "trains such heads)")
    if g.stride(-1) != 1:
        g = g.contiguous()
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_bwd: the last axis of q, k and v "
                         "must be contiguous")
    route = route or flash_bwd_route(q, k, v, round_p, G)
    dq = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KV, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_(), lse
    if route == "wgmma" and not _aligned(g):     # TMA reads g too
        g = torch.empty_like(g, memory_format=torch.contiguous_format).copy_(g)
    note_kernel("flash_attention_bwd_wgmma" if route == "wgmma"
                else "flash_attention_bwd", flash_attention_bwd_work, B, Sq, Sk,
                H, KV, dh, q.element_size(), causal, window)
    if q.device.type == "meta":
        return dq, dk, dv, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = load("flash_attention", _declare)
    if route == "wgmma":
        plan = plan_flash_bwd(B, Sq, Sk, H, KV, dh, causal, window, q.dtype,
                              round_p is not False, G)
        scratch = torch.empty(_cdiv(plan.scratch_bytes, 16) * 4,
                              dtype=torch.float32, device=q.device)
        terms = (torch.empty(plan.terms_bytes // 2, dtype=torch.bfloat16,
                             device=q.device) if plan.terms_bytes else None)
        err = lib.fbt_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                             dv.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                             plan.scratch_bytes, B, Sq, Sk, H, KV, dh, G,
                             head_offset, *q.stride()[:3], *k.stride()[:3],
                             *v.stride()[:3], *g.stride()[:3], dh ** -0.5,
                             int(causal), window,
                             plan.pieces, _DTYPE[q.dtype], int(round_p is not False),
                             None if terms is None else terms.data_ptr(), stream)
        check_launch("flash_attention_bwd_wgmma", err)
        return dq, dk, dv, lse
    rp = round_p is not False
    # each row's lse and D (round_p: D / l, m, l and the argmax key's
    # share), by the rows of whole groups: KV · G heads
    lse_g = lse if KV * G == H else torch.empty(
        (B, KV * G, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty((4 if rp else 1, B, KV * G, Sq), dtype=torch.float32,
                        device=q.device)
    err = lib.fb_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        lse_g.data_ptr(), delta.data_ptr(), B, Sq, Sk, H, KV,
                        dh, G, head_offset, *q.stride()[:3], *k.stride()[:3],
                        *v.stride()[:3], *g.stride()[:3], dh ** -0.5,
                        int(causal), window,
                        _DTYPE[q.dtype], int(rp), stream)
    check_launch("flash_attention_bwd", err)
    if lse_g is not lse:
        lse.copy_(lse_g[:, head_offset:head_offset + H])
    return dq, dk, dv, lse


class FlashAttentionFn(torch.autograd.Function):
    """Attention with fp32 p (or p rounded to bfloat16, ``round_p``) on
    the card's kernels, forward and backward: the forward saves q, k and v
    (the backward recomputes the scores and each row's statistics), the
    backward launches the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                round_p: bool | torch.dtype = False, group: int | None = None,
                head_offset: int = 0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.round_p = causal, window, round_p
        ctx.group, ctx.head_offset = group, head_offset
        return flash_attention_fused(q, k, v, causal=causal, window=window,
                                     round_p=round_p, group=group,
                                     head_offset=head_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv, _ = flash_attention_bwd(q, k, v, g, causal=ctx.causal,
                                            window=ctx.window,
                                            round_p=ctx.round_p,
                                            group=ctx.group,
                                            head_offset=ctx.head_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          round_p: bool | torch.dtype = False,
                          group: int | None = None, head_offset: int = 0
                          ) -> torch.Tensor:
    """Attention with fp32 p (or ``round_p=torch.bfloat16``) that autograd
    can differentiate: on CUDA (and meta) tensors :class:`FlashAttentionFn`
    (the kernels both ways), on CPU tensors the plain version; ``group``
    and ``head_offset`` as :func:`flash_attention_fused` takes them."""
    _check(q, k, v, group, head_offset)
    _check_window(causal, window)
    if round_p is not False and round_p != torch.bfloat16:
        raise ValueError(f"flash_attention_train: round_p={round_p!r} (False "
                         "or torch.bfloat16)")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   round_p=round_p, group=group,
                                   head_offset=head_offset)
    return FlashAttentionFn.apply(q, k, v, causal, window, round_p, group,
                                  head_offset)
