"""The float32 flash backward on the tensor cores, and the forward's row
tiles of whole tokens at any G up to 64, on the CPU.

``csrc/flash_attention.cu`` runs only on the card.  Here, for the float32
route of ``fbt_dq_kernel`` / ``fbt_dkdv_kernel`` / ``fbt_dkdv2_kernel``:
:func:`flash_bwd_route` at float32 (strides counted in float32 elements,
dh up to 128, DHP 256 on the CUDA cores); the plan's shared memory at
float32 (two 16-bit terms of each operand, so a float32 head weighs as a
bfloat16 head of twice the width) under a block's 227 KB; the split of an
fp32 operand, scaled by the power of two c that brings its largest
magnitude into [2^13, 2^14), into hi = fp16(c x) and mid = fp16(c x - hi),
and the three kept products hi.hi + hi.mid + mid.hi of every product; and
the kernels' arithmetic emulated tile by tile in fp32 torch
(``test_torch_flash_grad_tc._emulate`` with every operand, p and ds in two
fp16 terms) against the plain version and ``jax.vjp`` of the reference's
attention: dq, dk, dv within ``1e-4`` of each one's largest magnitude and
lse within ``1e-5`` (``chip_smoke.py``'s ``FLASH_BWD_F32_REL`` and
``FLASH_BWD_LSE_REL``), also with q and k five times larger, where two
bf16 terms miss them, and one term fewer of any operand missing them.
For ``fa_tc_kernel``: :func:`flash_route` at G 3 to 65, and its slot tiling
(row tiles of ``tile_rows(G)`` rows in 64 slots, two a block, the empty
slots zero) emulated at G 3, 5, 6 and 7 against ``flash_attention_ref`` and
the reference's Pallas kernel in interpret mode.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fused as j_flash_kernel
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref
from test_torch_flash_grad import _inputs, _reference
from test_torch_flash_grad_tc import _emulate, _pow2, _terms, _terms16

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
    (192, 128, 128, "simt"),    # deepseek-v2's MLA: DHP 256
    (224, 32, 32, "simt"),      # zamba2-7b's shared block: DHP 256
    (136, 4, 4, "simt"),        # dh above 128
    (100, 12, 2, "simt"),       # dh not a multiple of 8
    (64, 96, 1, "simt"),        # G 96: no whole tokens
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
    228 KB; a float32 head weighs as a bfloat16 head of twice the width."""
    top = fa.BWD_MAX_DH if dtype == torch.bfloat16 else fa.BWD_F32_MAX_DH
    for dh in range(8, top + 1, 8):
        for G in (1, 2, 3, 6, 7, 8, 16, 64, 128):
            p = fa.plan_flash_bwd(1, 300, 300, 2 * G, 2, dh, dtype=dtype)
            assert p.terms == (2 if dtype == torch.float32 else 1)
            assert p.dq_smem <= fa.SMEM_MAX and p.dkdv_smem <= fa.SMEM_MAX
            assert p.per_sm * p.dkdv_smem <= 228 * 1024
            twin = fa.plan_flash_bwd(1, 300, 300, 2 * G, 2, min(256, p.terms * p.dhp))
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
    for dh in (136, 192, 224, 256):
        with pytest.raises(ValueError):
            fa.plan_flash_bwd(1, 64, 64, 4, 4, dh, dtype=torch.float32)
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
    *got, lse, plan = _emulate(q, k, v, g, causal, window)
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
    *got, lse, _ = _emulate(q, k, v, g, True, 0)
    want = flash_attention_bwd_ref(q, k, v, g, causal=True)
    errs = _errors((*got, lse), want)
    assert max(errs.values()) <= 1.0, errs


def test_two_bf16_terms_miss_peaked_scores():
    """The same products over two bf16 terms (16 bits) of every operand,
    unscaled, hold unit-scale inputs but not q and k five times larger:
    why the float32 route takes fp16 terms (22 bits)."""
    case = F32_CASES[0]
    q, k, v, g = _f32_inputs(case)
    *got, lse, _ = _emulate(q, k, v, g, True, 0, half=False)
    want = flash_attention_bwd_ref(q, k, v, g, causal=True)
    assert max(_errors((*got, lse), want).values()) <= 1.0
    q, k, v, g = _f32_inputs(case, scale=5.0)
    *got, lse, _ = _emulate(q, k, v, g, True, 0, half=False)
    want = flash_attention_bwd_ref(q, k, v, g, causal=True)
    errs = _errors((*got, lse), want)
    assert max(errs.values()) > 1.0, errs


@pytest.mark.parametrize("drop", ["q", "k", "v", "g", "p"])
def test_one_term_fewer_misses_the_limits(drop):
    """Any operand (p and ds: ``p``) cut to its hi term alone puts a
    gradient over its limit: two terms of each are the fewest."""
    case = F32_CASES[0]
    q, k, v, g = _f32_inputs(case)
    *got, lse, _ = _emulate(q, k, v, g, True, 0, drop=drop)
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
