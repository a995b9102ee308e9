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
    (torch.bfloat16, 192, 128, 128, "simt"),  # deepseek-v2's MLA
    (torch.bfloat16, 224, 32, 32, "simt"),    # zamba2-7b's shared block
    (torch.bfloat16, 128, 48, 8, "simt"),     # internvl2-26b: G 6
    (torch.bfloat16, 100, 12, 2, "simt"),     # dh not a multiple of 8
    (torch.float32, 128, 16, 2, "simt"),
    (torch.float32, 64, 8, 8, "simt"),
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


@settings(max_examples=80, deadline=None)
@given(B=st.integers(1, 2), S=st.integers(1, 700), Sk_extra=st.integers(-40, 40),
       logG=st.integers(0, 7), KV=st.integers(1, 3),
       dh=st.integers(1, 16).map(lambda x: 8 * x),
       causal=st.booleans(), window=st.integers(0, 900))
def test_plan_pieces_cover_each_visible_row_once(B, S, Sk_extra, logG, KV, dh,
                                                 causal, window):
    G = 2 ** logG
    Sq = max(1, min(S, 30000 // G))
    Sk = max(1, Sq + Sk_extra)
    window = window if causal else 0
    H = G * KV
    plan = fa.plan_flash_bwd(B, Sq, Sk, H, KV, dh, causal, window)
    nrows = Sq * G
    R = fa.BWD_KROWS
    assert plan.key_tiles == -(-Sk // fa.BWD_KEYS)
    assert plan.dq_blocks == -(-nrows // fa.BWD_QROWS) * B * KV
    assert plan.dkdv_blocks == plan.key_tiles * B * KV * plan.pieces
    assert plan.rows_pad == -(-nrows // fa.BWD_QROWS) * fa.BWD_QROWS
    assert plan.dhp == (64 if dh <= 64 else 128)
    parts = (plan.key_tiles * B * KV * (plan.pieces * 2 * 64 * plan.dhp + 1)
             if plan.pieces > 1 else 0)
    assert plan.scratch_bytes == 4 * (2 * B * KV * plan.rows_pad + parts)
    assert plan.pieces >= 1
    for kt in range(plan.key_tiles):
        seen = np.zeros(nrows, int)
        prev_hi = plan.row_tiles[kt][0]
        for p in range(plan.pieces):
            lo, hi = plan.piece(kt, p)
            assert lo == prev_hi and lo <= hi           # in row order, no gap
            prev_hi = hi
            # a stage's rows lie inside the scratch the dq kernel writes
            assert hi * R <= plan.rows_pad or lo == hi
            seen[lo * R:min(hi * R, nrows)] += 1
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
        fa.plan_flash_bwd(1, 64, 64, 32, 32, 192)
    with pytest.raises(ValueError):
        fa.plan_flash_bwd(1, 64, 64, 16, 2, 128, False, 8)


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


def _emulate(q, k, v, g, causal, window):
    """fbt_dq_kernel and fbt_dkdv_kernel in fp32 torch, tile by tile."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    nrows = Sq * G
    plan = fa.plan_flash_bwd(B, Sq, Sk, H, KV, dh, causal, window)
    scale = _f32(dh ** -0.5)
    sl2 = scale * _f32(LOG2E)
    BM, BK, RM = fa.BWD_QROWS, fa.BWD_KEYS, fa.BWD_KROWS
    dq = torch.zeros((B, Sq, H, dh), dtype=torch.bfloat16)
    dk = torch.zeros((B, Sk, KV, dh), dtype=torch.bfloat16)
    dv = torch.zeros_like(dk)
    lse = torch.zeros((B, H, Sq))

    def hidden(rows, keys):
        tok = rows[:, None] // G
        h = (rows[:, None] >= nrows) | (keys[None, :] >= Sk)
        if causal:
            h |= keys[None, :] > tok
        if window:
            h |= keys[None, :] <= tok - window
        return h

    def terms_product(x, m):
        return sum(t @ m for t in _terms(x))

    for b in range(B):
        for kvh in range(KV):
            heads = slice(kvh * G, (kvh + 1) * G)
            pad = plan.rows_pad - nrows
            Qr, Gr = (torch.nn.functional.pad(
                t[b, :, heads].float().reshape(nrows, dh), (0, 0, 0, pad))
                for t in (q, g))
            Kk = torch.nn.functional.pad(k[b, :, kvh].float(), (0, 0, 0, BK))
            Vk = torch.nn.functional.pad(v[b, :, kvh].float(), (0, 0, 0, BK))
            lse2 = torch.full((plan.rows_pad,), math.inf)
            D = torch.zeros(plan.rows_pad)
            for r0 in range(0, nrows, BM):
                rows = torch.arange(r0, r0 + BM)
                last = min(r0 + BM, nrows) - 1
                kend = min(Sk, last // G + 1) if causal else Sk
                nt = -(-kend // BK)
                j0 = max(0, r0 // G - window + 1) // BK if window else 0
                m2 = torch.full((BM,), NEG)
                l_, pd = torch.zeros(BM), torch.zeros(BM)
                Q, Gq = Qr[r0:r0 + BM], Gr[r0:r0 + BM]
                for j in range(j0, nt):             # pass 1
                    keys = torch.arange(j * BK, j * BK + BK)
                    s = Q @ Kk[j * BK:j * BK + BK].T
                    dp = Gq @ Vk[j * BK:j * BK + BK].T
                    hid = hidden(rows, keys) & (rows[:, None] < nrows)
                    s = s.masked_fill(hid, NEG)
                    m_new = torch.maximum(m2, s.max(1).values * sl2)
                    alpha = torch.exp2(m2 - m_new)
                    m2 = m_new
                    e = torch.exp2(s * sl2 - m2[:, None]).masked_fill(hid, 0.0)
                    l_ = l_ * alpha + e.sum(1)
                    pd = pd * alpha + (e * dp).sum(1)
                live = (rows < nrows) & (l_ > 0)
                lse2[r0:r0 + BM] = torch.where(live, m2 + torch.log2(l_), math.inf)
                D[r0:r0 + BM] = torch.where(live, pd / l_, 0.0)
                acc = torch.zeros((BM, dh))
                for j in range(j0, nt):             # pass 2
                    keys = torch.arange(j * BK, j * BK + BK)
                    Kt = Kk[j * BK:j * BK + BK]
                    s, dp = Q @ Kt.T, Gq @ Vk[j * BK:j * BK + BK].T
                    p = torch.exp2(s * sl2 - lse2[r0:r0 + BM, None])
                    ds = (p * (dp - D[r0:r0 + BM, None])).masked_fill(
                        hidden(rows, keys) & (rows[:, None] < nrows), 0.0)
                    acc += terms_product(ds, Kt)
                for r in range(r0, min(r0 + BM, nrows)):
                    t, gg = divmod(r, G)
                    dq[b, t, kvh * G + gg] = (acc[r - r0] * scale).bfloat16()
                    lse[b, kvh * G + gg, t] = lse2[r] * _f32(0.6931471805599453)
            for kt in range(plan.key_tiles):
                keys = torch.arange(kt * BK, kt * BK + BK)
                Kt, Vt = Kk[kt * BK:kt * BK + BK], Vk[kt * BK:kt * BK + BK]
                parts = []
                for p_ in range(plan.pieces):
                    lo, hi = plan.piece(kt, p_)
                    pk, pv = torch.zeros((BK, dh)), torch.zeros((BK, dh))
                    for rt in range(lo, hi):
                        rows = torch.arange(rt * RM, rt * RM + RM)
                        Q, Gq = Qr[rt * RM:rt * RM + RM], Gr[rt * RM:rt * RM + RM]
                        sT, dpT = Kt @ Q.T, Vt @ Gq.T
                        hid = hidden(rows, keys).T
                        pT = torch.exp2(sT * sl2 - lse2[rows][None, :]).masked_fill(hid, 0.0)
                        dsT = (pT * (dpT - D[rows][None, :])).masked_fill(hid, 0.0)
                        pv += terms_product(pT, Gq)
                        pk += terms_product(dsT, Q)
                    parts.append((pk, pv))
                sk, sv = parts[0]
                for pk, pv in parts[1:]:            # in piece order
                    sk, sv = sk + pk, sv + pv
                n = min(BK, Sk - kt * BK)
                dk[b, kt * BK:kt * BK + n, kvh] = (sk[:n] * scale).bfloat16()
                dv[b, kt * BK:kt * BK + n, kvh] = sv[:n].bfloat16()
    return dq, dk, dv, lse, plan


# (B, S, H, KV, dh, causal, window): qwen's G 8 at a length cut in pieces,
# a window, full attention, G 1 with dh 64 and a ragged length, G 128
EMU_CASES = [(1, 300, 16, 2, 128, True, 0), (1, 200, 16, 2, 32, True, 40),
             (2, 90, 4, 2, 16, False, 0), (1, 77, 3, 3, 64, True, 0),
             (1, 40, 128, 1, 8, True, 0)]
EMU_IDS = ["gqa-pieces", "window", "full", "mha-ragged", "g128"]


@pytest.mark.parametrize("case", EMU_CASES, ids=EMU_IDS)
def test_emulated_kernels_match_plain_and_jax(case):
    from test_torch_flash_grad import _inputs, _reference

    B, S, H, KV, dh, causal, window = case
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in
                  _inputs(B, S, H, KV, dh, dh, seed=S + dh))
    *got, lse, plan = _emulate(q, k, v, g, causal, window)
    if case == EMU_CASES[0]:
        assert plan.pieces > 1
    want = flash_attention_bwd_ref(q, k, v, g, causal=causal, window=window)
    jax = _reference(*(t.float().numpy() for t in (q, k, v, g)), causal,
                     window, torch.bfloat16)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, jax):
        top = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2 * _ulp(top), f"{name} vs plain: {err}"
        err = float((a.float() - torch.from_numpy(c)).abs().max())
        assert err <= 2 * _ulp(top), f"{name} vs jax: {err}"
    top = float(want[3].abs().max())
    torch.testing.assert_close(lse, want[3], rtol=0, atol=1e-5 * max(top, 1.0))
