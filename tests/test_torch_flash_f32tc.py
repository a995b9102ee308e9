"""The float32 flash backward on the tensor cores, and the forward's row
tiles of whole tokens at any G up to 64, on the CPU.

``csrc/flash_attention.cu`` runs only on the card.  Here, for the float32
route of ``fbt_dq_kernel`` / ``fbt_dkdv_kernel`` / ``fbt_dkdv2_kernel``:
:func:`flash_bwd_route` at float32 (strides counted in float32 elements,
dh up to 256, DHP 256 in row tiles of 16 slots for G up to 16); the plan's
shared memory at float32 (two 16-bit terms of each operand, so a float32
head weighs as a bfloat16 head of twice the width) under a block's 227 KB;
the split of an fp32 operand, scaled by the power of two c that brings its
largest magnitude into [2^13, 2^14), into hi = fp16(c x) and mid = fp16(c x
- hi), and the three kept products hi.hi + hi.mid + mid.hi of every
product; and the kernels' arithmetic emulated tile by tile (``_emulate32``:
every operand, p and ds in two fp16 terms, each product issued k-step by
k-step into a model of the tensor cores' fp32 accumulator, the scores'
hi.hi summed apart from the cross pairs) against the plain version and
``jax.vjp`` of the reference's attention: dq, dk, dv within ``1e-4`` of
each one's largest magnitude and lse within ``1e-5`` (``chip_smoke.py``'s
``FLASH_BWD_F32_REL`` and ``FLASH_BWD_LSE_REL``), also with q and k five
times larger, where two bf16 terms miss them, and one term fewer of any
operand missing them; at DHP 256 (zamba2's dh 224, MLA's dh 192 with v
zero-padded).  With q and k eight and twelve times larger the plain
version is itself up to 1.3 of the limits away from the exact gradient
(float64), so there the kernels are held to the exact gradient, and one
accumulator for all of the scores' pairs (the arithmetic before the split)
misses it.  For ``fa_tc_kernel``: :func:`flash_route` at G 3 to 65, and
its slot tiling (row tiles of ``tile_rows(G)`` rows in 64 slots, two a
block, the empty slots zero) emulated at G 3, 5, 6 and 7 against
``flash_attention_ref`` and the reference's Pallas kernel in interpret
mode.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fused as j_flash_kernel
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.launch.profile_kernels import exact_flash_bwd
from test_torch_flash_grad import _inputs, _reference
from test_torch_flash_grad_tc import TERMS, _pow2, _terms, _terms16

F32_REL, LSE_REL = 1e-4, 1e-5       # chip_smoke.FLASH_BWD_F32_REL, _LSE_REL
NEG = -1e30
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------- the route
@pytest.mark.parametrize("dh,H,KV,want", [
    (128, 16, 2, "wgmma"),      # qwen2.5-3b
    (128, 16, 16, "wgmma"),     # olmoe-1b-7b
    (128, 32, 8, "wgmma"),      # granite-8b
    (128, 32, 32, "wgmma"),     # codeqwen1.5-7b
    (128, 64, 8, "wgmma"),      # command-r-35b
    (64, 24, 24, "wgmma"),      # musicgen-medium
    (128, 48, 8, "wgmma"),      # internvl2-26b: G 6
    (64, 128, 1, "wgmma"),      # G 128
    (8, 4, 1, "wgmma"),
    (192, 128, 128, "wgmma"),   # deepseek-v2's MLA: DHP 256, 16-slot row tiles
    (224, 32, 32, "wgmma"),     # zamba2-7b's shared block: DHP 256
    (136, 4, 4, "wgmma"),       # dh above 128
    (100, 12, 2, "simt"),       # dh not a multiple of 8
    (64, 96, 1, "simt"),        # G 96: no whole tokens
    (256, 16, 1, "wgmma"),      # DHP 256 at G 16: a token a row tile
    (200, 12, 2, "wgmma"),      # DHP 256 at G 6: 12 rows in 16 slots
    (224, 32, 1, "simt"),       # DHP 256 at G 32: no whole token in 16 slots
])
def test_float32_bwd_route(dh, H, KV, want):
    q = torch.zeros((1, 4, H, dh))
    k = torch.zeros((1, 4, KV, dh))
    assert fa.flash_bwd_route(q, k, k) == want


def test_float32_route_counts_strides_in_float32_elements():
    """TMA needs 16-byte bases and strides: 4 float32 elements, not 8."""
    for off, want in ((0, "wgmma"), (4, "wgmma"), (8, "wgmma"), (2, "simt")):
        qkv = torch.zeros((1, 8, 16 * 128 + 2 * 2 * 128 + 8))
        q = qkv[..., off:off + 2048].unflatten(-1, (16, 128))
        k = qkv[..., off + 2048:off + 2304].unflatten(-1, (2, 128))
        v = qkv[..., off + 2304:off + 2560].unflatten(-1, (2, 128))
        assert fa.flash_bwd_route(q, k, v) == want, off
    k = torch.zeros((1, 8, 2, 128))
    q = torch.zeros((1, 8, 16, 132))[..., :128]      # pitch 528 bytes
    assert fa.flash_bwd_route(q, k, k) == "wgmma"
    q = torch.zeros((1, 8, 16, 130))[..., :128]      # pitch 520 bytes
    assert fa.flash_bwd_route(q, k, k) == "simt"
    # the same pitch of 132 elements in bfloat16 is 264 bytes: refused
    q = torch.zeros((1, 8, 16, 132), dtype=torch.bfloat16)[..., :128]
    assert fa.flash_bwd_route(q, k.bfloat16(), k.bfloat16()) == "simt"


# ----------------------------------------------------------------- the plan
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plan_shared_memory_fits_a_block(dtype):
    """Every head the route takes: each kernel's shared memory under a
    block's 227 KB, and where two dkdv blocks share an SM, both under its
    228 KB; a float32 head weighs as a bfloat16 head of twice the width (up
    to DHP 128; float32 at DHP 256 has row tiles of its own, G up to 16)."""
    top = fa.BWD_MAX_DH if dtype == torch.bfloat16 else fa.BWD_F32_MAX_DH
    for dh in range(8, top + 1, 8):
        for G in (1, 2, 3, 6, 7, 8, 16, 64, 128):
            if not fa.tile_rows(G, fa.bwd_row_slots(dh, dtype)):
                with pytest.raises(ValueError):     # the route refuses it too
                    fa.plan_flash_bwd(1, 300, 300, 2 * G, 2, dh, dtype=dtype)
                assert dtype == torch.float32 and dh > 128 and G > 16
                continue
            p = fa.plan_flash_bwd(1, 300, 300, 2 * G, 2, dh, dtype=dtype)
            assert p.terms == (2 if dtype == torch.float32 else 1)
            assert p.dq_smem <= fa.SMEM_MAX and p.dkdv_smem <= fa.SMEM_MAX
            assert p.per_sm * p.dkdv_smem <= 228 * 1024
            if p.row_slots == fa.BWD_KROWS:
                twin = fa.plan_flash_bwd(1, 300, 300, 2 * G, 2, p.terms * p.dhp)
                assert (p.dq_smem, p.dkdv_smem, p.dq_keys, p.per_sm) == (
                    twin.dq_smem, twin.dkdv_smem, twin.dq_keys, twin.per_sm)
    f32 = fa.plan_flash_bwd(1, 4096, 4096, 16, 2, 128, dtype=torch.float32)
    # qwen2.5-3b's heads: q and g 128 rows x 2 terms (128 KB) and two stages
    # of 32 keys of k and v (64 KB); dkdv2: k and v (64 KB), two stages of
    # 64 rows of q and g (128 KB), P^T (16 KB); the terms' copy 72 MiB
    assert (f32.dq_smem, f32.dkdv_smem, f32.dq_keys, f32.per_sm) == (
        197672, 215096, 32, 1)
    # two fp16 terms of q, g, k and v, then their four largest magnitudes
    assert f32.terms_bytes == 2 * 2 * 2 * (4096 * 16 * 128 + 4096 * 2 * 128) + 16
    assert fa.plan_flash_bwd(1, 4096, 4096, 16, 2, 128).terms_bytes == 0
    # float32 at DHP 256 (zamba2's, MLA's heads): a dq block of one
    # warpgroup, 64 slots of q and g x 2 terms (128 KB) and two stages of 16
    # keys of k and v (64 KB); dkdv2: k and v (128 KB), two stages of a row
    # tile of 16 slots of q and g (64 KB), P^T 64 x 16 (4 KB)
    for dh in (136, 192, 224, 256):
        w = fa.plan_flash_bwd(1, 1024, 1024, 32, 32, dh, dtype=torch.float32)
        assert (w.dhp, w.row_slots, w.tile_rows, w.dq_slots, w.dq_keys, w.per_sm) == (
            256, 16, 16, 64, 16, 1)
        assert (w.dq_smem, w.dkdv_smem) == (197672, 202040)
        assert w.dq_blocks == 32 * 1024 // 64 and w.rows_pad == 1024
        assert w.row_tiles[0] == (0, 64) and w.row_tiles[-1] == (60, 64)
    g6 = fa.plan_flash_bwd(1, 100, 100, 12, 2, 200, dtype=torch.float32)
    assert (g6.tile_rows, g6.rows_pad) == (12, 64 * 13)    # 50 row tiles, 4 a block
    with pytest.raises(ValueError):                         # G 32
        fa.plan_flash_bwd(1, 64, 64, 32, 1, 224, dtype=torch.float32)
    with pytest.raises(ValueError):
        fa.plan_flash_bwd(1, 64, 64, 4, 4, 64, dtype=torch.float16)


# ---------------------------------------------------------------- the terms
def test_two_terms_and_the_kept_products_stay_in_their_budget():
    """With c the power of two of the largest magnitude, hi + mid of c x
    hold 22 bits: |x - hi - mid| <= 2^-23 |x| + 2^-25 / c (the floor: fp16's
    smallest subnormal).  The product hi.hi + hi.mid + mid.hi of two such
    operands is within 2^-21 |x y| of x y where both scaled values are at
    least 1, within 2^-20 |x y| + 2^-24 (|x| / c_y + |y| / c_x) everywhere;
    a dot product of 128 pairs within the sum of those bounds."""
    rng = np.random.default_rng(11)
    n = 200_000
    x, y = (torch.from_numpy((rng.standard_normal(n) * np.exp2(
        rng.uniform(-30, 30, n))).astype(np.float32)) for _ in range(2))
    cx, cy = _pow2(x.abs().max()), _pow2(y.abs().max())
    assert 2.0 ** 13 <= float(x.abs().max() * cx) < 2.0 ** 14
    hx, mx = _terms16(x, 2, cx)
    hy, my = _terms16(y, 2, cy)
    xd, yd, fx, fy = x.double(), y.double(), 2.0 ** -25 / float(cx), 2.0 ** -25 / float(cy)
    assert bool(((xd - hx.double() - mx.double()).abs()
                 <= 2.0 ** -23 * xd.abs() + fx).all())
    kept = hx.double() * hy.double() + hx.double() * my.double() + mx.double() * hy.double()
    err = (xd * yd - kept).abs()
    assert bool((err <= 2.0 ** -20 * (xd * yd).abs()
                 + 2.0 * (xd.abs() * fy + yd.abs() * fx)).all())
    big = (xd.abs() * float(cx) >= 1) & (yd.abs() * float(cy) >= 1)
    assert bool((err[big] <= 2.0 ** -21 * (xd * yd).abs()[big]).all())
    a, b = (torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
            for _ in range(2))
    ca, cb = _pow2(a.abs().max()), _pow2(b.abs().max())
    ta, tb = _terms16(a, 2, ca), _terms16(b.T, 2, cb)
    got = (ta[0].double() @ tb[0].double() + ta[0].double() @ tb[1].double()
           + ta[1].double() @ tb[0].double())
    exact = a.double() @ b.double().T
    A, Bt = a.double().abs(), b.double().abs().T
    bound = (2.0 ** -20 * (A @ Bt) + 2.0 ** -24 * (A.sum(1, keepdim=True) / float(cb)
                                                   + Bt.sum(0, keepdim=True) / float(ca)))
    assert bool(((got - exact).abs() <= bound).all())


# ------------------------------------------------- the kernels' arithmetic
def _rz(x: torch.Tensor) -> torch.Tensor:
    """fp64 -> fp32, cut toward zero: the 29 fraction bits fp32 lacks
    cleared, then an exact conversion (fp32 subnormals aside)."""
    return (x.view(torch.int64) & -(1 << 29)).view(torch.float64).float()


def _kblocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) as K / 16 exact fp64 partial products,
    one a k-step (K padded to 16): (..., K / 16, M, N)."""
    K = -(-a.shape[-1] // 16) * 16           # dh padded with zeros, as DHP
    a4 = torch.nn.functional.pad(a.double(), (0, K - a.shape[-1])).unflatten(-1, (K // 16, 16))
    b4 = torch.nn.functional.pad(b.double(), (0, 0, 0, K - b.shape[-2])).unflatten(-2, (K // 16, 16))
    return torch.einsum("...mks,...ksn->...kmn", a4, b4)


def _mma(steps, acc=None):
    """The model of the tensor cores' fp32 accumulator: each k-step's 16
    products summed exactly, added to the accumulator, the sum cut toward
    zero to fp32.  ``steps``: (..., M, N) fp64 k-step sums in issue order."""
    for blk in steps:
        acc = _rz(blk if acc is None else acc.double() + blk)
    return acc


def _emulate32(q, k, v, g, causal, window, drop=None, half=True, split=True):
    """fbt_dq_kernel and fbt_dkdv_kernel / fbt_dkdv2_kernel on the float32
    route, vectorised over the (b, KV head) pairs, row tiles and key tiles:
    rows in row tiles of ``plan.tile_rows`` whole-token rows at
    ``plan.row_slots`` slots each (16 at DHP 256), dq blocks of
    ``plan.dq_slots`` slots over stages of ``plan.dq_keys`` keys, a dkdv
    stage a row tile, the pieces' partial sums added in piece order, the
    statistics by slot; every operand (p and ds: ``p``) in two terms as
    ``_emulate`` splits it (``drop`` cuts one to its hi term; ``half``
    False: unscaled bf16 terms); every product issued as the kernels issue
    it, k-step by k-step into the accumulator model of :func:`_mma`, each
    row tile's (dq: each stage's) product summed apart and added with
    rounding; the scores (``split``) with hi.hi of the even and of the odd
    k-steps and the cross pairs in three accumulators, summed at the end
    (``fbt_ss_scores``), else all pairs in one.  Rows and key tiles the
    masks leave empty add exact zeros, so every block walks every stage."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, NB = H // KV, B * KV
    nrows = Sq * G
    plan = fa.plan_flash_bwd(B, Sq, Sk, H, KV, dh, causal, window, q.dtype)
    RT, RS, BQ, BK = plan.tile_rows, plan.row_slots, plan.dq_keys, fa.BWD_KEYS
    nterms = dict(TERMS[q.dtype])
    if drop:
        nterms[drop] = 1
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    scale = f32(dh ** -0.5)
    sl2 = scale * f32(LOG2E)
    tscale = {n: _pow2(t.abs().max()) for n, t in zip("qkvg", (q, k, v, g))}

    def split_(x, name):
        if not half:
            return _terms(x, nterms[name])
        c = _pow2(x.abs().amax(-1, keepdim=True)) if name == "p" else tscale[name]
        return _terms16(x, nterms[name], c)

    def pairs(ta, tb):
        top = max(len(ta), len(tb))
        return [(i, j) for i in range(len(ta)) for j in range(len(tb)) if i + j < top]

    def ss(a, na, b, nb, scores=False):
        """fbt_prod: A . B^T (b given transposed: (..., K, N)), term pair by
        term pair, k-steps inside."""
        ta, tb = split_(a, na), split_(b, nb)
        order = pairs(ta, tb)
        if scores and split and (0, 0) in order and len(order) > 1:
            hh = _kblocks(ta[0], tb[0])
            h0 = _mma(hh[..., 0::2, :, :].unbind(-3))
            h1 = _mma(hh[..., 1::2, :, :].unbind(-3))
            x = _mma([s for i, j in order if (i, j) != (0, 0)
                      for s in _kblocks(ta[i], tb[j]).unbind(-3)])
            return x + (h0 + h1)
        return _mma([s for i, j in order for s in _kblocks(ta[i], tb[j]).unbind(-3)])

    def rs(a, b, nb):
        """fbt_rs_terms: A (p or ds, row-scaled terms) . B (K-dim rows), the
        k-steps outermost, then B's terms, then A's."""
        ta, tb = split_(a, "p"), split_(b, nb)
        top = max(len(ta), len(tb))
        blocks = {(i, j): _kblocks(ta[i], tb[j]) for i in range(len(ta))
                  for j in range(len(tb)) if i + j < top}
        steps = [blocks[(i, j)][..., kk, :, :] for kk in range(a.shape[-1] // 16)
                 for j in range(len(tb)) for i in range(len(ta)) if (i, j) in blocks]
        return _mma(steps)

    def fma(s, c):       # fmaf(s, sl2, -c), one rounding
        return (s.double() * sl2.double() - c.double()).float()

    # slot -> row (-1: an empty slot, or past the last row)
    ntiles = -(-nrows // RT)
    slot_row = torch.full((plan.rows_pad,), -1)
    for t in range(ntiles):
        n = min(RT, nrows - t * RT)
        slot_row[t * RS:t * RS + n] = torch.arange(t * RT, t * RT + n)
    real = slot_row >= 0
    tok = torch.where(real, slot_row // G, 0)

    def hidden(keys):                       # (slots, keys)
        h = ~real[:, None] | (keys[None, :] >= Sk)
        if causal:
            h |= keys[None, :] > tok[:, None]
        if window:
            h |= keys[None, :] <= tok[:, None] - window
        return h

    heads = lambda t: (t.float().reshape(B, Sq, KV, G, dh)  # noqa: E731
                       .permute(0, 2, 1, 3, 4).reshape(NB, nrows, dh))
    Qs, Gs = (torch.zeros((NB, plan.rows_pad, dh)) for _ in range(2))
    Qs[:, real], Gs[:, real] = heads(q)[:, slot_row[real]], heads(g)[:, slot_row[real]]
    Skp = plan.key_tiles * BK
    Kk, Vk = (torch.nn.functional.pad(t.float().permute(0, 2, 1, 3).reshape(NB, Sk, dh),
                                      (0, 0, 0, Skp - Sk)) for t in (k, v))
    # dq: every warpgroup's 64 slots at once, (NB, W, 64, dh)
    W = plan.rows_pad // fa.BWD_KROWS
    Q4, G4 = (t.reshape(NB, W, fa.BWD_KROWS, dh) for t in (Qs, Gs))
    hid_all = hidden(torch.arange(Skp)).reshape(W, fa.BWD_KROWS, Skp)
    m2 = torch.full((NB, W, fa.BWD_KROWS), NEG)
    l_, pd = torch.zeros_like(m2), torch.zeros_like(m2)
    stages = [slice(j * BQ, j * BQ + BQ) for j in range(Skp // BQ)]
    for ks in stages:
        s = ss(Q4, "q", Kk[:, None, ks].transpose(-1, -2), "k", scores=True)
        dp = ss(G4, "g", Vk[:, None, ks].transpose(-1, -2), "v")
        hid = hid_all[None, :, :, ks]
        s = s.masked_fill(hid, NEG)
        m_new = torch.maximum(m2, s.amax(-1) * sl2)
        alpha = torch.exp2(m2 - m_new)
        m2 = m_new
        e = torch.exp2(fma(s, m2[..., None])).masked_fill(hid, 0.0)
        l_ = l_ * alpha + e.sum(-1)
        pd = pd * alpha + (e * dp).sum(-1)
    live = real.reshape(W, -1)[None] & (l_ > 0)
    lse2 = torch.where(live, m2 + torch.log2(l_), math.inf)
    D = torch.where(live, pd / l_, 0.0)
    acc = torch.zeros((NB, W, fa.BWD_KROWS, dh))
    for ks in stages:
        s = ss(Q4, "q", Kk[:, None, ks].transpose(-1, -2), "k", scores=True)
        dp = ss(G4, "g", Vk[:, None, ks].transpose(-1, -2), "v")
        p = torch.exp2(fma(s, lse2[..., None]))
        ds = (p * (dp - D[..., None])).masked_fill(hid_all[None, :, :, ks], 0.0)
        acc = acc + rs(ds, Kk[:, None, ks], "k")
    out = lambda x: (x.reshape(B, KV, Sq, G, *x.shape[2:])  # noqa: E731
                     .transpose(2, 3).reshape(B, H, Sq, *x.shape[2:]))
    rows = slot_row[real]
    dq = torch.zeros((NB, nrows, dh))
    dq[:, rows] = acc.reshape(NB, plan.rows_pad, dh)[:, real] * scale
    dq = out(dq).transpose(1, 2)
    lse = torch.zeros((NB, nrows))
    lse[:, rows] = lse2.reshape(NB, -1)[:, real] * f32(0.6931471805599453)
    lse = out(lse)
    lse2, D = lse2.reshape(NB, -1), D.reshape(NB, -1)
    # dkdv: every key tile at once, a row tile a stage
    K4, V4 = (t.reshape(NB, plan.key_tiles, BK, dh) for t in (Kk, Vk))
    hid_t = hidden(torch.arange(Skp)).T.reshape(plan.key_tiles, BK, -1)
    parts = torch.zeros((plan.pieces, 2, NB, plan.key_tiles, BK, dh))
    for r in range(ntiles):
        sl = slice(r * RS, r * RS + RS)
        Q, Gq = Qs[:, None, sl], Gs[:, None, sl]
        hid = hid_t[None, :, :, sl] & real[sl]
        sT = ss(K4, "k", Q.transpose(-1, -2), "q", scores=True)
        dpT = ss(V4, "v", Gq.transpose(-1, -2), "g")
        pT = torch.exp2(fma(sT, lse2[:, None, None, sl])).masked_fill(hid, 0.0)
        dsT = (pT * (dpT - D[:, None, None, sl])).masked_fill(hid, 0.0)
        xk, xv = rs(dsT, Q, "q"), rs(pT, Gq, "g")
        for kt in range(plan.key_tiles):
            for p_ in range(plan.pieces):
                lo, hi = plan.piece(kt, p_)
                if lo <= r < hi:
                    parts[p_, 0, :, kt] += xk[:, kt]
                    parts[p_, 1, :, kt] += xv[:, kt]
    sk, sv = parts[0]
    for p_ in range(1, plan.pieces):           # in piece order
        sk, sv = sk + parts[p_, 0], sv + parts[p_, 1]
    back = lambda x: (x.reshape(B, KV, Skp, dh)[:, :, :Sk]  # noqa: E731
                      .transpose(1, 2))
    return dq, back(sk * scale), back(sv), lse, plan


# (B, S, H, KV, dh, causal, window): G 2 at dh 128, causal and cut in
# pieces; G 1 at dh 64, full; G 6 at dh 64 with a window and at dh 128
# (internvl2's, 60-row tiles); G 8 at dh 128 (qwen2.5-3b's, 32-key dq
# stages); G 2 at dh 64, B 2, ragged
F32_CASES = [(1, 300, 4, 2, 128, True, 0), (1, 90, 4, 4, 64, False, 0),
             (1, 130, 12, 2, 64, True, 24), (1, 120, 6, 1, 128, True, 0),
             (1, 100, 16, 2, 128, True, 0), (2, 70, 4, 2, 64, True, 0)]
F32_IDS = ["g2-dh128-pieces", "g1-dh64-full", "g6-dh64-window", "g6-dh128",
           "g8-dh128", "g2-dh64-b2"]


def _f32_inputs(case, scale=1.0):
    B, S, H, KV, dh, causal, window = case
    q, k, v, g = _inputs(B, S, H, KV, dh, dh, seed=S + dh + H)
    return [torch.from_numpy(a * (scale if i < 2 else 1.0))
            for i, a in enumerate((q, k, v, g))]


def _errors(got, want):
    """Each of dq, dk, dv, lse: max abs error over its limit."""
    out = {}
    for name, a, b in zip(("dq", "dk", "dv", "lse"), got, want):
        top = float(b.abs().max())
        lim = LSE_REL * max(top, 1.0) if name == "lse" else F32_REL * top
        out[name] = float((a - b).abs().max()) / lim
    return out


@pytest.mark.parametrize("case", F32_CASES, ids=F32_IDS)
def test_emulated_float32_kernels_match_plain_and_jax(case):
    B, S, H, KV, dh, causal, window = case
    q, k, v, g = _f32_inputs(case)
    *got, lse, plan = _emulate32(q, k, v, g, causal, window)
    assert plan.terms == 2 and plan.dq_keys == (32 if dh > 64 else 64)
    if case is F32_CASES[0]:
        assert plan.pieces > 1
    if H // KV == 6:
        assert plan.tile_rows == 60
    want = flash_attention_bwd_ref(q, k, v, g, causal=causal, window=window)
    errs = _errors((*got, lse), want)
    assert max(errs.values()) <= 1.0, errs
    jax = _reference(*(t.numpy() for t in (q, k, v, g)), causal, window,
                     torch.float32)
    errs = _errors(got, [torch.from_numpy(c) for c in jax])
    assert max(errs.values()) <= 1.0, errs


@pytest.mark.parametrize("scale", [3.0, 5.0])
@pytest.mark.parametrize("case", [F32_CASES[0], F32_CASES[4]],
                         ids=["g2-dh128-pieces", "g8-dh128"])
def test_emulated_float32_kernels_hold_peaked_scores(case, scale):
    """q and k three and five times larger (scaled scores of standard
    deviation 9 and 25, attention on a few keys a row): still within the
    limits."""
    q, k, v, g = _f32_inputs(case, scale=scale)
    *got, lse, _ = _emulate32(q, k, v, g, True, 0)
    want = flash_attention_bwd_ref(q, k, v, g, causal=True)
    errs = _errors((*got, lse), want)
    assert max(errs.values()) <= 1.0, errs


# float32 at DHP 256, row tiles of 16 slots (B, S, H, KV, dh, dhv, causal,
# window): zamba2-7b's shared block (G 1, dh 224), deepseek-v2's MLA (dh
# 192, v and g zero-padded from 128), G 6 at dh 200 with a window (12 rows
# in 16 slots, cut in pieces)
WIDE_CASES = [(1, 160, 2, 2, 224, 224, True, 0), (1, 150, 2, 2, 192, 128, True, 0),
              (1, 100, 12, 2, 200, 200, True, 24)]
WIDE_IDS = ["zamba2-dh224", "mla-dh192", "g6-dh200-window"]


def _padded(case, scale, seed):
    B, S, H, KV, dh, dhv, causal, window = case
    return [torch.nn.functional.pad(torch.from_numpy(a * (scale if i < 2 else 1.0)),
                                    (0, dh - a.shape[-1]))
            for i, a in enumerate(_inputs(B, S, H, KV, dh, dhv, seed=seed))]


@pytest.mark.parametrize("scale", [1.0, 5.0])
@pytest.mark.parametrize("case", WIDE_CASES, ids=WIDE_IDS)
def test_emulated_float32_dhp256_matches_plain_and_jax(case, scale):
    """The DHP-256 geometry (dq blocks of four 16-slot row tiles over
    stages of 16 keys, a dkdv stage one row tile) within the limits of the
    plain version and of ``jax.vjp`` (dv's padded columns dropped, as
    autograd drops them), also with q and k five times larger."""
    B, S, H, KV, dh, dhv, causal, window = case
    q, k, v, g = _padded(case, scale, S + dh)
    *got, lse, plan = _emulate32(q, k, v, g, causal, window)
    assert (plan.dhp, plan.row_slots, plan.dq_slots, plan.dq_keys) == (256, 16, 64, 16)
    if window:
        assert plan.tile_rows == 12 and plan.pieces > 1
    want = flash_attention_bwd_ref(q, k, v, g, causal=causal, window=window)
    errs = _errors((*got, lse), want)
    assert max(errs.values()) <= 1.0, errs
    jax = _reference(q.numpy(), k.numpy(), v[..., :dhv].numpy(), g[..., :dhv].numpy(),
                     causal, window, torch.float32)
    errs = _errors((got[0], got[1], got[2][..., :dhv]),
                   [torch.from_numpy(np.array(c)) for c in jax])
    assert max(errs.values()) <= 1.0, errs


# q and k 8 and 12 times larger (scaled scores of standard deviation 64 and
# 144) at the head shapes of qwen2.5-3b (G 8), internvl2-26b (G 6),
# zamba2-7b (dh 224) and deepseek-v2's MLA (dh 192, v zero-padded): (H, KV,
# dh, dhv) at S 256
PEAK_HEADS = [(16, 2, 128, 128), (12, 2, 128, 128), (2, 2, 224, 224), (2, 2, 192, 128)]
PEAK_IDS = ["qwen-g8", "internvl2-g6", "zamba2-dh224", "mla-dh192"]


@pytest.mark.parametrize("scale", [8.0, 12.0])
@pytest.mark.parametrize("heads", PEAK_HEADS, ids=PEAK_IDS)
def test_emulated_float32_kernels_hold_scores_peaked_further(heads, scale):
    """Within the limits of the exact gradient (float64); at x8 also of the
    plain version.  At x12 the plain version is itself 0.4 to 0.8 of the
    limits away from the exact gradient here (1.3 at zamba2's head with 8
    KV heads and S 512), so the kernels' distance to it adds two errors."""
    H, KV, dh, dhv = heads
    q, k, v, g = _padded((1, 256, H, KV, dh, dhv, True, 0), scale, 256 + dh + H)
    *got, lse, _ = _emulate32(q, k, v, g, True, 0)
    errs = _errors((*got, lse), exact_flash_bwd(q, k, v, g))
    assert max(errs.values()) <= 1.0, errs
    if scale == 8.0:
        errs = _errors((*got, lse), flash_attention_bwd_ref(q, k, v, g, causal=True))
        assert max(errs.values()) <= 1.0, errs


def test_score_pairs_in_one_accumulator_miss_x16():
    """The repair: with every pair of the scores' terms in one accumulator
    (the arithmetic before it) zamba2's head with q and k sixteen times
    larger misses the exact gradient's limits, and lse is five times
    farther from it at every scale; hi.hi summed apart holds them."""
    q, k, v, g = _padded((1, 256, 2, 2, 224, 224, True, 0), 16.0, 256 + 224 + 2)
    exact = exact_flash_bwd(q, k, v, g)
    *got, lse, _ = _emulate32(q, k, v, g, True, 0, split=False)
    one = _errors((*got, lse), exact)
    *got, lse, _ = _emulate32(q, k, v, g, True, 0)
    apart = _errors((*got, lse), exact)
    assert max(one.values()) > 1.0 and max(apart.values()) <= 1.0, (one, apart)
    assert one["lse"] > 3 * apart["lse"], (one, apart)


def test_two_bf16_terms_miss_peaked_scores():
    """The same products over two bf16 terms (16 bits) of every operand,
    unscaled, hold unit-scale inputs but not q and k five times larger:
    why the float32 route takes fp16 terms (22 bits)."""
    case = F32_CASES[0]
    q, k, v, g = _f32_inputs(case)
    *got, lse, _ = _emulate32(q, k, v, g, True, 0, half=False)
    want = flash_attention_bwd_ref(q, k, v, g, causal=True)
    assert max(_errors((*got, lse), want).values()) <= 1.0
    q, k, v, g = _f32_inputs(case, scale=5.0)
    *got, lse, _ = _emulate32(q, k, v, g, True, 0, half=False)
    want = flash_attention_bwd_ref(q, k, v, g, causal=True)
    errs = _errors((*got, lse), want)
    assert max(errs.values()) > 1.0, errs


@pytest.mark.parametrize("drop", ["q", "k", "v", "g", "p"])
def test_one_term_fewer_misses_the_limits(drop):
    """Any operand (p and ds: ``p``) cut to its hi term alone puts a
    gradient over its limit: two terms of each are the fewest."""
    case = F32_CASES[0]
    q, k, v, g = _f32_inputs(case)
    *got, lse, _ = _emulate32(q, k, v, g, True, 0, drop=drop)
    want = flash_attention_bwd_ref(q, k, v, g, causal=True)
    errs = _errors((*got, lse), want)
    assert max(errs.values()) > 1.0, errs


# ------------------------------------------------- the forward at any G
@pytest.mark.parametrize("G,want", [(1, "wgmma"), (3, "wgmma"), (5, "wgmma"),
                                    (6, "wgmma"), (7, "wgmma"), (12, "wgmma"),
                                    (48, "wgmma"), (64, "wgmma"), (65, "simt"),
                                    (96, "simt"), (128, "wgmma"), (256, "simt")])
def test_flash_route_at_any_g_up_to_64(G, want):
    q = torch.zeros((1, 4, G, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 1, 64), dtype=torch.bfloat16)
    assert fa.flash_route(q, k, k) == want
    assert fa.tile_rows(G) == (G * (64 // G) if G <= 64 else 64 if G == 128 else 0)
    assert fa.flash_route(q.float(), k.float(), k.float()) == "simt"


def _emulate_fwd(q, k, v, causal, window, p_terms):
    """fa_tc_kernel in fp32 torch, block by block: two row tiles of
    ``tile_rows(G)`` (token, g) rows in 64 slots each (the empty slots
    zero, never written), 64-key tiles from the block's first window tile
    to its last row's token, the masks only on edge tiles, the online
    softmax in base 2 of the unscaled scores times scale log2(e), and P.V
    with p in ``p_terms`` bf16 terms (1: ``round_p``; 3: fp32 p)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    rt, nrows = fa.tile_rows(G), Sq * G
    sl2 = torch.tensor(dh ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    out = torch.zeros((B, Sq, H, dh))
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, 64))  # noqa: E731
    for b in range(B):
        for kvh in range(KV):
            Qr = q[b, :, kvh * G:(kvh + 1) * G].float().reshape(nrows, dh)
            Kk, Vk = pad(k[b, :, kvh]), pad(v[b, :, kvh])
            for blk in range(-(-(-(-nrows // rt)) // 2)):
                r0 = 2 * blk * rt
                last = min(r0 + 2 * rt, nrows) - 1
                kend = min(Sk, last // G + 1) if causal else Sk
                j0 = max(0, r0 // G - window + 1) // 64 if window else 0
                for w in range(2):
                    rw = r0 + w * rt
                    rows = rw + torch.arange(64)
                    filled = (torch.arange(64) < rt) & (rows < nrows)
                    Q = torch.zeros((64, dh))
                    Q[filled] = Qr[rows[filled]]
                    tok = rows // G
                    tok_lo, tok_hi = rw // G, (rw + rt - 1) // G
                    m = torch.full((64,), NEG)
                    l_, o = torch.zeros(64), torch.zeros((64, dh))
                    for j in range(j0, -(-kend // 64)):
                        keys = torch.arange(j * 64, j * 64 + 64)
                        s = Q @ Kk[j * 64:j * 64 + 64].T
                        edge = ((j + 1) * 64 > Sk or (causal and (j + 1) * 64 - 1 > tok_lo)
                                or (window and j * 64 <= tok_hi - window))
                        hid = torch.zeros((64, 64), dtype=torch.bool)
                        if edge:
                            hid = keys[None, :] >= Sk
                            if causal:
                                hid = hid | (keys[None, :] > tok[:, None])
                            if window:
                                hid = hid | (keys[None, :] <= tok[:, None] - window)
                            s = s.masked_fill(hid, NEG)
                        m_new = torch.maximum(m, s.max(1).values * sl2)
                        alpha = torch.exp2(m - m_new)
                        m = m_new
                        e = torch.exp2(s * sl2 - m[:, None]).masked_fill(hid, 0.0)
                        l_ = l_ * alpha + e.sum(1)
                        o = o * alpha[:, None] + sum(
                            t @ Vk[j * 64:j * 64 + 64] for t in _terms(e, p_terms))
                    res = o / torch.clamp(l_, min=1e-30)[:, None]
                    for i in torch.nonzero(filled).flatten().tolist():
                        t, gg = divmod(int(rows[i]), G)
                        out[b, t, kvh * G + gg] = res[i]
    return out.bfloat16()


def _ulp(x: torch.Tensor) -> float:
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


# (B, S, H, KV, dh, causal, window): G 6 at internvl2's heads cut to dh 32
# (60-row tiles), causal, full and with a window; G 3 at dh 64 (63 rows);
# G 5 ragged and full (60 rows); G 7 with B 2 (63 rows)
FWD_CASES = [(1, 90, 12, 2, 32, True, 0), (1, 90, 12, 2, 32, False, 0),
             (1, 120, 12, 2, 32, True, 40), (1, 70, 6, 2, 64, True, 0),
             (1, 53, 5, 1, 16, False, 0), (2, 40, 7, 1, 16, True, 0)]
FWD_IDS = ["g6-causal", "g6-full", "g6-window", "g3-dh64", "g5-full", "g7-b2"]


@pytest.mark.parametrize("round_p", [False, True], ids=["p-fp32", "p-rounded"])
@pytest.mark.parametrize("case", FWD_CASES, ids=FWD_IDS)
def test_emulated_slot_tiling_matches_plain_and_pallas(case, round_p):
    """Within one bf16 ulp of the output's largest magnitude of the plain
    version (the card's limit), and with ``round_p`` of the Pallas kernel
    in interpret mode (which has no window)."""
    B, S, H, KV, dh, causal, window = case
    q, k, v, _ = (torch.from_numpy(a).bfloat16()
                  for a in _inputs(B, S, H, KV, dh, dh, seed=S + H))
    got = _emulate_fwd(q, k, v, causal, window, 1 if round_p else 3)
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               round_p=round_p)
    assert float((got.float() - want.float()).abs().max()) <= _ulp(want)
    if round_p and not window:
        pallas = j_flash_kernel(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                  for t in (q, k, v)), causal=causal, bq=64, bk=64)
        pallas = torch.from_numpy(np.asarray(pallas, np.float32))
        assert float((got.float() - pallas).abs().max()) <= _ulp(pallas)
