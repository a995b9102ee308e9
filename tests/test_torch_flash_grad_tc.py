"""The tensor-core flash backward's plan, route and arithmetic, on the CPU.

``fbt_dq_kernel`` and ``fbt_dkdv_kernel`` (``csrc/flash_attention.cu``) run
only on the card.  Here: :func:`flash_bwd_route` on shapes and strides made
on the CPU; :func:`plan_flash_bwd` as a property over shapes, masks and
windows (every (key tile, visible row) pair lies in exactly one piece, the
pieces run in row order, the grids and the scratch follow the stated
formulas); the split of an fp32 p or ds into three bf16 terms, which must
sum back exactly; and the kernels' arithmetic emulated in torch — tiles,
base-2 statistics, three-term products, the pieces' partial sums added in
piece order — held against the plain version and against ``jax.vjp`` of
the reference's attention on the same bf16 inputs, within two bf16 ulps of
each gradient's largest magnitude (each side rounds one fp32 result once,
as on the card: ``FLASH_BWD_BF16_ULPS``) and lse within ``1e-5`` of its
largest magnitude.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_bwd_ref

NEG = -1e30
LOG2E = 1.4426950408889634


def _ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


# ---------------------------------------------------------------- the route
@pytest.mark.parametrize("dtype,dh,H,KV,want", [
    (torch.bfloat16, 128, 16, 2, "wgmma"),    # qwen2.5-3b
    (torch.bfloat16, 64, 24, 24, "wgmma"),    # musicgen-medium
    (torch.bfloat16, 128, 16, 16, "wgmma"),   # olmoe-1b-7b
    (torch.bfloat16, 64, 128, 1, "wgmma"),    # G 128
    (torch.bfloat16, 192, 128, 128, "wgmma"),  # deepseek-v2's MLA
    (torch.bfloat16, 224, 32, 32, "wgmma"),    # zamba2-7b's shared block
    (torch.bfloat16, 128, 48, 8, "wgmma"),     # internvl2-26b: G 6
    (torch.bfloat16, 256, 4, 4, "wgmma"),      # the widest head
    (torch.bfloat16, 64, 7, 1, "wgmma"),       # G 7: 63 rows a tile
    (torch.bfloat16, 264, 4, 4, "simt"),       # dh above 256
    (torch.bfloat16, 64, 96, 1, "simt"),       # G 96: no whole tokens
    (torch.bfloat16, 100, 12, 2, "simt"),      # dh not a multiple of 8
    (torch.float32, 128, 16, 2, "wgmma"),     # float32: two bf16 terms
    (torch.float32, 64, 8, 8, "wgmma"),
    (torch.float32, 192, 128, 128, "wgmma"),   # float32 at DHP 256: 16-slot row tiles
])
def test_bwd_route(dtype, dh, H, KV, want):
    q = torch.zeros((1, 4, H, dh), dtype=dtype)
    k = torch.zeros((1, 4, KV, dh), dtype=dtype)
    assert fa.flash_bwd_route(q, k, k) == want


def test_bwd_route_needs_aligned_views():
    # q, k, v as views of a fused projection: aligned at 8 columns, not at 4
    for off, want in ((0, "wgmma"), (8, "wgmma"), (4, "simt")):
        qkv = torch.zeros((1, 8, 16 * 128 + 2 * 2 * 128 + 8), dtype=torch.bfloat16)
        q = qkv[..., off:off + 16 * 128].unflatten(-1, (16, 128))
        k = qkv[..., off + 2048:off + 2304].unflatten(-1, (2, 128))
        v = qkv[..., off + 2304:off + 2560].unflatten(-1, (2, 128))
        assert fa.flash_bwd_route(q, k, v) == want
    q = torch.zeros((1, 8, 16, 136), dtype=torch.bfloat16)[..., :128]
    k = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    assert fa.flash_bwd_route(q, k, k) == "wgmma"      # pitch 272 bytes
    q = torch.zeros((1, 8, 16, 132), dtype=torch.bfloat16)[..., :128]
    assert fa.flash_bwd_route(q, k, k) == "simt"       # pitch 264 bytes
    # internvl2's G 6: q, k, v of a fused projection, at 8 and at 4 columns
    for off, want in ((8, "wgmma"), (4, "simt")):
        qkv = torch.zeros((1, 8, 64 * 128 + 8), dtype=torch.bfloat16)
        q = qkv[..., off:off + 48 * 128].unflatten(-1, (48, 128))
        k = qkv[..., off + 6144:off + 7168].unflatten(-1, (8, 128))
        v = qkv[..., off + 7168:off + 8192].unflatten(-1, (8, 128))
        assert fa.flash_bwd_route(q, k, v) == want


def test_bwd_route_argument_on_the_cpu():
    q = torch.randn((1, 8, 4, 16))
    k = torch.randn((1, 8, 2, 16))
    want = flash_attention_bwd_ref(q, k, k, q)
    for route in (None, "simt"):              # the CPU runs the plain version
        got = fa.flash_attention_bwd(q, k, k, q, route=route)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="route"):
        fa.flash_attention_bwd(q, k, k, q, route="wgmma")


# ----------------------------------------------------------------- the plan
def _visible_rows(Sq, Sk, G, causal, window, kt):
    """Rows (token, g) that can see a key of key tile kt."""
    k0 = kt * fa.BWD_KEYS
    keys = np.arange(k0, min(Sk, k0 + fa.BWD_KEYS))
    tok = np.arange(Sq * G) // G
    vis = np.ones((tok.size, keys.size), bool)
    if causal:
        vis &= keys[None, :] <= tok[:, None]
    if window:
        vis &= keys[None, :] > tok[:, None] - window
    return np.flatnonzero(vis.any(axis=1))


@settings(max_examples=120, deadline=None)
@given(B=st.integers(1, 2), S=st.integers(1, 700), Sk_extra=st.integers(-40, 40),
       G=st.sampled_from([1, 2, 3, 4, 5, 6, 7, 8, 16, 128]), KV=st.integers(1, 3),
       dh=st.integers(1, 32).map(lambda x: 8 * x),
       causal=st.booleans(), window=st.integers(0, 900))
def test_plan_pieces_cover_each_visible_row_once(B, S, Sk_extra, G, KV, dh,
                                                 causal, window):
    Sq = max(1, min(S, 30000 // G))
    Sk = max(1, Sq + Sk_extra)
    window = window if causal else 0
    H = G * KV
    plan = fa.plan_flash_bwd(B, Sq, Sk, H, KV, dh, causal, window)
    nrows = Sq * G
    RT, SL = plan.tile_rows, fa.BWD_KROWS
    # a row tile holds whole tokens (G 128: each token two whole tiles)
    assert RT == (G * (SL // G) if G <= SL else SL)
    assert RT % G == 0 if G <= SL else G % RT == 0
    ntiles = -(-nrows // RT)
    assert plan.key_tiles == -(-Sk // fa.BWD_KEYS)
    assert plan.rows_pad == -(-ntiles // 2) * fa.BWD_QROWS
    assert plan.dq_blocks == -(-ntiles // 2) * B * KV
    assert plan.dkdv_blocks == plan.key_tiles * B * KV * plan.pieces
    assert plan.dhp == (64 if dh <= 64 else 128 if dh <= 128 else 256)
    assert (plan.dq_keys, plan.per_sm) == ((32, 1) if dh > 128 else (64, 2))
    walks = [max(0, hi - lo) for lo, hi in plan.row_tiles]
    total, top = B * KV * sum(walks), max(walks)
    want = 1 if not total else max(1, min(
        -(-top * plan.per_sm * fa.BWD_SMS // total), top // fa.BWD_MIN_TILES))
    assert plan.pieces == want
    parts = (plan.key_tiles * B * KV * (plan.pieces * 2 * 64 * plan.dhp + 1)
             if plan.pieces > 1 else 0)
    assert plan.scratch_bytes == 4 * (2 * B * KV * plan.rows_pad + parts)
    for kt in range(plan.key_tiles):
        seen = np.zeros(nrows, int)
        prev_hi = plan.row_tiles[kt][0]
        for p in range(plan.pieces):
            lo, hi = plan.piece(kt, p)
            assert lo == prev_hi and lo <= hi           # in row order, no gap
            prev_hi = hi
            # a stage's slots lie inside the scratch the dq kernel writes
            assert hi * SL <= plan.rows_pad or lo == hi
            seen[lo * RT:min(hi * RT, nrows)] += 1
        lo, hi = plan.row_tiles[kt]
        assert prev_hi == max(lo, hi)
        vis = _visible_rows(Sq, Sk, G, causal, window, kt)
        assert (seen[vis] == 1).all(), f"key tile {kt}"


def test_plan_at_qwen_heads():
    """qwen2.5-3b's heads (16 / 2 / 128), causal: 64 key tiles a KV head at
    S 4,096 cut in 5 pieces (640 dkdv blocks over 264 slots), 16 at S 1,024
    in 16 pieces; the window of 256 (walks of 40 row tiles, 10 pieces) and
    full attention (128 row tiles, 9 pieces) at S 1,024."""
    p4 = fa.plan_flash_bwd(1, 4096, 4096, 16, 2, 128)
    assert (p4.key_tiles, p4.pieces, p4.dq_blocks, p4.dkdv_blocks) == (64, 5, 512, 640)
    assert p4.row_tiles[0] == (0, 512) and p4.row_tiles[-1] == (504, 512)
    p1 = fa.plan_flash_bwd(1, 1024, 1024, 16, 2, 128)
    assert (p1.pieces, p1.dq_blocks, p1.dkdv_blocks) == (16, 128, 512)
    pw = fa.plan_flash_bwd(1, 1024, 1024, 16, 2, 128, True, 256)
    assert pw.row_tiles[0] == (0, 40) and pw.pieces == 10
    pf = fa.plan_flash_bwd(1, 1024, 1024, 16, 2, 128, False)
    assert all(t == (0, 128) for t in pf.row_tiles) and pf.pieces == 9
    tiny = fa.plan_flash_bwd(1, 33, 33, 4, 1, 8)
    assert tiny.pieces == 1 and tiny.scratch_bytes == 4 * 2 * 256
    with pytest.raises(ValueError):
        fa.plan_flash_bwd(1, 64, 64, 32, 32, 264)       # dh above 256
    with pytest.raises(ValueError):
        fa.plan_flash_bwd(1, 64, 64, 96, 1, 64)         # G 96
    with pytest.raises(ValueError):
        fa.plan_flash_bwd(1, 64, 64, 16, 2, 128, False, 8)


def test_plan_at_the_new_heads():
    """The three head shapes this route took from the CUDA cores, causal:
    deepseek-v2's MLA (128 / 128 / 192) and zamba2's shared block (32 / 32 /
    224) at DHP 256 (32-key dq stages, one dkdv block an SM), internvl2's
    G 6 (48 / 8 / 128) in row tiles of 10 tokens (60 rows)."""
    mla = fa.plan_flash_bwd(1, 1024, 1024, 128, 128, 192)
    assert (mla.dhp, mla.dq_keys, mla.per_sm, mla.tile_rows) == (256, 32, 1, 64)
    assert (mla.key_tiles, mla.dq_blocks, mla.pieces) == (16, 1024, 1)
    z = fa.plan_flash_bwd(1, 4096, 4096, 32, 32, 224)
    assert (z.dhp, z.key_tiles, z.dq_blocks, z.pieces) == (256, 64, 1024, 1)
    zw = fa.plan_flash_bwd(1, 1024, 1024, 32, 32, 224, True, 256)
    assert zw.row_tiles[0] == (0, 5) and zw.row_tiles[-1] == (15, 16)
    iv = fa.plan_flash_bwd(1, 1024, 1024, 48, 8, 128)
    assert (iv.dhp, iv.tile_rows, iv.per_sm) == (128, 60, 2)
    # 6,144 rows in 103 tiles (the last 24 rows), 52 dq blocks a KV head
    assert iv.rows_pad == 52 * 128 and iv.dq_blocks == 8 * 52
    # key tile 1 (keys 64..127) first sees row 384: tile 6 (tokens 60..69)
    assert iv.row_tiles[1] == (6, 103) and iv.pieces == 4


# -------------------------------------------------------------- the terms
def _terms(x: torch.Tensor, n: int = 3) -> list[torch.Tensor]:
    """fbt_terms: term t is the bf16 rounding (to nearest even) of what
    terms 0 .. t-1 left of the fp32 x."""
    out = []
    for _ in range(n):
        t = x.to(torch.bfloat16).float()
        out.append(t)
        x = x - t
    return out


def _pow2(m: torch.Tensor) -> torch.Tensor:
    """fbt_pow2: 2^s with s = 13 - floor(log2 m) from m's exponent bits (at
    most 126), bringing the largest magnitude m into [2^13, 2^14)."""
    m = m.to(torch.float32)
    e = ((m.view(torch.int32) >> 23) & 0xFF) - 127
    return torch.ldexp(torch.ones_like(m), torch.clamp(13 - e, max=126))


def _terms16(x: torch.Tensor, n: int, c: torch.Tensor) -> list[torch.Tensor]:
    """The float32 route's terms (fbs_split_kernel, fbt_terms16): term t is
    the fp16 rounding of what terms 0 .. t-1 left of c x, c a power of two;
    returned divided by c (exactly), in fp32."""
    out, y = [], x * c
    for _ in range(n):
        t = y.to(torch.float16).float()
        out.append(t / c)
        y = y - t
    return out


@pytest.mark.parametrize("kind", ["p", "ds"])
def test_three_bf16_terms_sum_back_exactly(kind):
    """p in (0, 1] down to 2^-110, ds = p (dp - D) of either sign up to
    2^20: the three terms hold all 24 bits, exactly; two terms do not.
    Below 2^-110 the last term would fall under bf16's smallest subnormal:
    what is lost there is under 2^-134 absolute, against p's 1."""
    rng = np.random.default_rng(7)
    e = rng.uniform(-109, 0, 200_000)
    x = np.exp2(e) * rng.uniform(1, 2, e.size) / 2
    if kind == "ds":
        x = x * rng.choice([-1.0, 1.0], e.size) * np.exp2(rng.uniform(0, 20, e.size))
    x = torch.from_numpy(x.astype(np.float32))
    x = torch.cat([x, torch.tensor([1.0, 2.0 ** -110, 1 - 2.0 ** -24,
                                    1 + 2.0 ** -23], dtype=torch.float32)])
    t = _terms(x)
    total = t[0].double() + t[1].double() + t[2].double()
    assert torch.equal(total, x.double())
    two = t[0].double() + t[1].double()
    assert not torch.equal(two, x.double())
    tiny = torch.from_numpy(np.exp2(rng.uniform(-149, -110, 10_000)).astype(np.float32))
    t = _terms(tiny)
    lost = (t[0].double() + t[1].double() + t[2].double() - tiny.double()).abs()
    assert float(lost.max()) <= 2.0 ** -134


# ------------------------------------------------- the kernels' arithmetic
def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


# terms of each operand: the bf16 route's inputs are bf16 already, and p
# and ds take three bf16 terms; the float32 route splits every operand in
# two fp16 terms, scaled by powers of two
TERMS = {torch.bfloat16: dict(q=1, k=1, v=1, g=1, p=3),
         torch.float32: dict(q=2, k=2, v=2, g=2, p=2)}


def _emulate(q, k, v, g, causal, window):
    """fbt_dq_kernel and fbt_dkdv_kernel on the bfloat16 route in fp32
    torch, tile by tile: rows in row tiles of ``plan.tile_rows`` whole-token
    rows at ``BWD_KROWS`` slots each (the empty slots zero in q and g, lse
    +inf and D 0, as the kernels keep them; nothing written for them), dq
    stages of ``plan.dq_keys`` keys, the statistics by slot.  Each product
    A.B takes ``TERMS[dtype]`` bf16 terms of its operands (``p`` for p and
    ds) and keeps the pairs (i, j) with i + j below the larger count (the
    float32 route: ``test_torch_flash_f32tc._emulate32``)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    nrows = Sq * G
    plan = fa.plan_flash_bwd(B, Sq, Sk, H, KV, dh, causal, window, q.dtype)
    nterms = TERMS[q.dtype]

    def split(x, name):
        return _terms(x, nterms[name])
    scale = _f32(dh ** -0.5)
    sl2 = scale * _f32(LOG2E)
    RT, SL, BQ, BK = plan.tile_rows, fa.BWD_KROWS, plan.dq_keys, fa.BWD_KEYS
    ntiles = -(-nrows // RT)
    dq = torch.zeros((B, Sq, H, dh), dtype=q.dtype)
    dk = torch.zeros((B, Sk, KV, dh), dtype=q.dtype)
    dv = torch.zeros_like(dk)
    lse = torch.zeros((B, H, Sq))
    # slot -> row (-1: an empty slot, or past the last row)
    slot_row = torch.full((plan.rows_pad,), -1)
    for t in range(ntiles):
        n = min(RT, nrows - t * RT)
        slot_row[t * SL:t * SL + n] = torch.arange(t * RT, t * RT + n)
    real = slot_row >= 0

    def hidden(slots, keys):
        tok = slot_row[slots][:, None] // G
        h = ~real[slots][:, None] | (keys[None, :] >= Sk)
        if causal:
            h |= keys[None, :] > tok
        if window:
            h |= keys[None, :] <= tok - window
        return h

    def prod(a, na, b, nb):
        """a @ b over the kept pairs of their na and nb terms."""
        ta, tb = split(a, na), split(b, nb)
        top = max(len(ta), len(tb))
        return sum(x @ y for j, y in enumerate(tb) for i, x in enumerate(ta)
                   if i + j < top)

    for b in range(B):
        for kvh in range(KV):
            heads = slice(kvh * G, (kvh + 1) * G)
            Qr, Gr = (t[b, :, heads].float().reshape(nrows, dh) for t in (q, g))
            Qs, Gs = (torch.zeros((plan.rows_pad, dh)) for _ in range(2))
            Qs[real], Gs[real] = Qr[slot_row[real]], Gr[slot_row[real]]
            Kk = torch.nn.functional.pad(k[b, :, kvh].float(), (0, 0, 0, BK))
            Vk = torch.nn.functional.pad(v[b, :, kvh].float(), (0, 0, 0, BK))
            lse2 = torch.full((plan.rows_pad,), math.inf)
            D = torch.zeros(plan.rows_pad)
            for pair in range(plan.rows_pad // fa.BWD_QROWS):
                r0 = 2 * pair * RT
                last = min(r0 + 2 * RT, nrows) - 1
                kend = min(Sk, last // G + 1) if causal else Sk
                nt = -(-kend // BQ)
                j0 = max(0, r0 // G - window + 1) // BQ if window else 0
                for w in range(2):                  # a warpgroup a row tile
                    slots = torch.arange((2 * pair + w) * SL, (2 * pair + w + 1) * SL)
                    m2 = torch.full((SL,), NEG)
                    l_, pd = torch.zeros(SL), torch.zeros(SL)
                    Q, Gq = Qs[slots], Gs[slots]
                    for j in range(j0, nt):         # pass 1
                        keys = torch.arange(j * BQ, j * BQ + BQ)
                        s = prod(Q, "q", Kk[j * BQ:j * BQ + BQ].T, "k")
                        dp = prod(Gq, "g", Vk[j * BQ:j * BQ + BQ].T, "v")
                        hid = hidden(slots, keys)
                        s = s.masked_fill(hid, NEG)
                        m_new = torch.maximum(m2, s.max(1).values * sl2)
                        alpha = torch.exp2(m2 - m_new)
                        m2 = m_new
                        e = torch.exp2(s * sl2 - m2[:, None]).masked_fill(hid, 0.0)
                        l_ = l_ * alpha + e.sum(1)
                        pd = pd * alpha + (e * dp).sum(1)
                    live = real[slots] & (l_ > 0)
                    lse2[slots] = torch.where(live, m2 + torch.log2(l_), math.inf)
                    D[slots] = torch.where(live, pd / l_, 0.0)
                    acc = torch.zeros((SL, dh))
                    for j in range(j0, nt):         # pass 2
                        keys = torch.arange(j * BQ, j * BQ + BQ)
                        Kt = Kk[j * BQ:j * BQ + BQ]
                        s = prod(Q, "q", Kt.T, "k")
                        dp = prod(Gq, "g", Vk[j * BQ:j * BQ + BQ].T, "v")
                        p = torch.exp2(s * sl2 - lse2[slots, None])
                        ds = (p * (dp - D[slots, None])).masked_fill(
                            hidden(slots, keys), 0.0)
                        acc += prod(ds, "p", Kt, "k")
                    for i, sl in enumerate(slots.tolist()):
                        if real[sl]:
                            t, gg = divmod(int(slot_row[sl]), G)
                            dq[b, t, kvh * G + gg] = (acc[i] * scale).to(q.dtype)
                            lse[b, kvh * G + gg, t] = lse2[sl] * _f32(0.6931471805599453)
            for kt in range(plan.key_tiles):
                keys = torch.arange(kt * BK, kt * BK + BK)
                Kt, Vt = Kk[kt * BK:kt * BK + BK], Vk[kt * BK:kt * BK + BK]
                parts = []
                for p_ in range(plan.pieces):
                    lo, hi = plan.piece(kt, p_)
                    pk, pv = torch.zeros((BK, dh)), torch.zeros((BK, dh))
                    for rt in range(lo, hi):
                        slots = torch.arange(rt * SL, rt * SL + SL)
                        Q, Gq = Qs[slots], Gs[slots]
                        sT, dpT = prod(Kt, "k", Q.T, "q"), prod(Vt, "v", Gq.T, "g")
                        # the kernel masks real rows only: an empty slot's
                        # zero q, g and +inf lse give p = ds = 0 by arithmetic
                        hid = (hidden(slots, keys) & real[slots][:, None]).T
                        pT = torch.exp2(sT * sl2 - lse2[slots][None, :]).masked_fill(hid, 0.0)
                        dsT = (pT * (dpT - D[slots][None, :])).masked_fill(hid, 0.0)
                        pv += prod(pT, "p", Gq, "g")
                        pk += prod(dsT, "p", Q, "q")
                    parts.append((pk, pv))
                sk, sv = parts[0]
                for pk, pv in parts[1:]:            # in piece order
                    sk, sv = sk + pk, sv + pv
                n = min(BK, Sk - kt * BK)
                dk[b, kt * BK:kt * BK + n, kvh] = (sk[:n] * scale).to(q.dtype)
                dv[b, kt * BK:kt * BK + n, kvh] = sv[:n].to(q.dtype)
    return dq, dk, dv, lse, plan


# (B, S, H, KV, dh, dhv, causal, window): qwen's G 8 at a length cut in
# pieces, a window, full attention, G 1 with dh 64 and a ragged length, G
# 128; G 6 (internvl2's: 60-row tiles) cut in pieces and with a window, G 7
# and G 5 at dh 8 (63 and 60 rows); DHP 256: deepseek-v2's MLA (dh 192, v
# and g zero-padded from 128), zamba2's dh 224 with a window, dh 256 full
EMU_CASES = [(1, 300, 16, 2, 128, 128, True, 0), (1, 200, 16, 2, 32, 32, True, 40),
             (2, 90, 4, 2, 16, 16, False, 0), (1, 77, 3, 3, 64, 64, True, 0),
             (1, 40, 128, 1, 8, 8, True, 0), (1, 96, 12, 2, 32, 32, True, 0),
             (1, 90, 6, 1, 16, 16, True, 20), (1, 50, 14, 2, 8, 8, True, 0),
             (1, 41, 5, 1, 8, 8, False, 0), (1, 72, 4, 4, 192, 128, True, 0),
             (1, 80, 2, 2, 224, 224, True, 24), (1, 45, 3, 1, 256, 256, False, 0)]
EMU_IDS = ["gqa-pieces", "window", "full", "mha-ragged", "g128", "g6-pieces",
           "g6-window", "g7", "g5-full", "mla-dh192", "dh224-window", "dh256-full"]


@pytest.mark.parametrize("case", EMU_CASES, ids=EMU_IDS)
def test_emulated_kernels_match_plain_and_jax(case):
    from test_torch_flash_grad import _inputs, _reference

    B, S, H, KV, dh, dhv, causal, window = case
    qn, kn, vn, gn = _inputs(B, S, H, KV, dh, dhv, seed=S + dh)
    # the port's route: v and g zero-padded to q's width (mla_prefill)
    q, k, v, g = (torch.nn.functional.pad(torch.from_numpy(a), (0, dh - a.shape[-1]))
                  .bfloat16() for a in (qn, kn, vn, gn))
    *got, lse, plan = _emulate(q, k, v, g, causal, window)
    if case in (EMU_CASES[0], EMU_CASES[5]):
        assert plan.pieces > 1
    want = flash_attention_bwd_ref(q, k, v, g, causal=causal, window=window)
    jax = _reference(*(t.float().numpy() for t in (q[..., :dh], k, v[..., :dhv],
                                                    g[..., :dhv])),
                     causal, window, torch.bfloat16)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, jax):
        if name == "dv":                    # autograd drops the padded columns
            a, b = a[..., :dhv], b[..., :dhv]
        top = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2 * _ulp(top), f"{name} vs plain: {err}"
        err = float((a.float() - torch.from_numpy(c)).abs().max())
        assert err <= 2 * _ulp(top), f"{name} vs jax: {err}"
    top = float(want[3].abs().max())
    torch.testing.assert_close(lse, want[3], rtol=0, atol=1e-5 * max(top, 1.0))
