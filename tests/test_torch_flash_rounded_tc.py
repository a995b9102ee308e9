"""Training with ``attn_probs_bf16`` on the tensor cores, on the CPU.

``csrc/flash_attention.cu`` runs only on the card.  Here, for the rounded-p
instances of ``fbt_dq_kernel`` / ``fbt_dkdv_kernel`` / ``fbt_dkdv2_kernel``
(``round_p=torch.bfloat16``, the model's ``probs_bf16``, bfloat16 inputs)
and for ``fa_tc_kernel`` rounding p against each row's max:

* the kernels' arithmetic emulated in torch (``_emulate_rounded``): the
  scores and dP as exact bf16 products summed in fp32, the row's max m
  (raw scores, compared for the argmax) and l in base 2, dp~ = r(dP (1 /
  l)) with one reciprocal a row, D = sum r(p) dP / l and the argmax share
  from each key's rounding residuals, (r(p) - p) x + p (x - r(x)), split
  evenly over ties; ds = p (dp~ - D / l) + [s = m] share as three bf16
  terms of dQ's and dK's products, and dV's operand r(p) / l alike — held
  against ``jax.vjp`` of the reference's ``flash_attention(...,
  probs_bf16=True)`` with one KV chunk within two bfloat16 ulps of each
  gradient's largest (``FLASH_BWD_BF16_ULPS``, the card's limit), and lse
  within 1e-5 of the plain version's;
* the card's checks that those 2 ulps cannot make, on the emulation with
  and without a planted fault (p not rounded, the max detached, the argmax
  share left out of dk): over the whole tensor each gradient nearer the
  plain rounded gradient than either fault's (``profile_kernels.
  fault_shares``), and on one-hot attention (``argmax_inputs``) dq and dk
  the argmax shares alone;
* :func:`flash_bwd_route` with ``round_p`` taking the tensor cores exactly
  where the fp32-p backward does for bfloat16, and the CUDA cores for
  float32 (``csrc/flash_attention.cu``, point 6: only sums in the plain
  version's order hold float32's 1e-3 for this gradient);
* ``_round_mode``: mode 3 (the row's max) for every ``torch.bfloat16`` call
  up to dh 256, on either forward kernel;
* :func:`plan_flash_bwd`'s scratch and dkdv shared memory with ``round_p``
  (four statistics a row slot in place of two);
* ``fa_tc_kernel``'s forward with the row's max emulated on scores that
  rise along the keys (a row's running max moves in every key tile):
  within one bfloat16 ulp of the plain version, closer than the key
  tile's running max it rounded against before.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.launch.profile_kernels import (argmax_inputs, fault_shares,
                                                rounded_bwd_faults)
from test_torch_flash_grad_tc import _terms

torch.set_num_threads(1)

BF16 = torch.bfloat16
NEG = -1e30
LOG2E = 1.4426950408889634
# chip_smoke.FLASH_BWD_BF16_ULPS, FLASH_BWD_LSE_REL
FLASH_BWD_BF16_ULPS, LSE_REL = 2, 1e-5


def _ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _r(x: torch.Tensor) -> torch.Tensor:
    """att_round<__nv_bfloat16>: to bfloat16 (nearest even) and back."""
    return x.to(BF16).float()


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _emulate_rounded(q, k, v, g, causal=True, window=0, fault=None):
    """The rounded-p tensor-core backward's arithmetic on bfloat16 inputs,
    all rows of a (b, KV head) at once (the tiling only orders the fp32
    sums: the fp32-p emulation in ``test_torch_flash_grad_tc`` holds it).
    Returns dq, dk, dv in bfloat16 and lse (B, H, Sq).  ``fault`` plants
    one of ``FAULTS``: the argmax share left out of dk alone (what the dkdv
    kernels do where S^T is not bitwise the dq kernel's S) or of dq and dk
    (a detached max), or p and dp~ not rounded (fp32 p)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = _f32(dh ** -0.5)
    sl2 = scale * _f32(LOG2E)
    # (B, KV, G, S, dh) rows of q and g; (B, KV, 1, Sk, dh) keys
    qh, gh = (t.float().reshape(B, Sq, KV, G, dh).permute(0, 2, 3, 1, 4)
              for t in (q, g))
    kh, vh = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))

    def prod(a, b):                     # bf16 products, exact, summed in fp32
        return (a.double() @ b.double().transpose(-1, -2)).float()

    def rs(a, b):                       # fp32 A as three bf16 terms . B
        return sum(t.double() @ b.double() for t in _terms(a, 3)).float()

    s, dp = prod(qh, kh), prod(gh, vh)
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    hid = torch.zeros((Sq, Sk), dtype=torch.bool)
    if causal:
        hid |= kpos > qpos
    if window:
        hid |= kpos <= qpos - window
    s = s.masked_fill(hid, NEG)
    m = s.amax(-1, keepdim=True)                # the raw max: s_j = m is exact
    m2 = m * sl2
    # exp2f(fmaf(s, sl2, -m2)): one rounding before exp2
    p = (s.double() * sl2.double() - m2.double()).float().exp2().masked_fill(hid, 0.0)
    l = p.sum(-1, keepdim=True)
    il = 1.0 / l                                # each row's reciprocal, once
    x = dp * il
    rp, rx = (p, x) if fault == "fp32 p" else (_r(p), _r(x))
    tie = (s == m) & ~hid
    D = (rp * x).masked_fill(hid, 0.0).sum(-1, keepdim=True)
    e = ((rp - p) * x + p * (x - rx)).masked_fill(hid, 0.0).sum(-1, keepdim=True)
    share = torch.where(tie.any(-1, keepdim=True),
                        e / tie.sum(-1, keepdim=True).clamp_min(1), 0.0)
    ds = (p * (rx - D / l)).masked_fill(hid, 0.0)
    dsq = ds if fault == "detached max" else ds + tie * share
    dsk = ds if fault in ("detached max", "dk share") else ds + tie * share
    dq = (rs(dsq, kh) * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh)
    dk = (rs(dsk.transpose(-1, -2), qh) * scale).sum(2).permute(0, 2, 1, 3)
    dv = rs((rp * il).transpose(-1, -2), gh).sum(2).permute(0, 2, 1, 3)
    lse = ((m2 + l.log2()) * _f32(0.6931471805599453)).reshape(B, H, Sq)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), lse


def _inputs(B, S, H, KV, dh, dhv, seed, tie=False):
    """q, k, g as in ``test_torch_probs_bf16``, all bfloat16 values; v
    zero past ``dhv`` with g (MLA's padded v)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    g = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    if tie:   # keys 3 and 5 alike, the max of every row from token 5 on
        u = np.sign(rng.standard_normal(dh)).astype(np.float32)
        k = np.round(4 * k) / 4
        k[:, 3] = k[:, 5] = 2.0 * u
        q = np.round(8 * q) / 8
        q[:, 5:] += u
    v[..., dhv:] = 0
    g[..., dhv:] = 0
    return [torch.from_numpy(a).to(BF16).float().numpy() for a in (q, k, v, g)]


def _jax_grads(q, k, v, g, window):
    @jax.jit
    def grads(q_, k_, v_, g_):
        def f(a, b, c):
            return jatt.flash_attention(a, b, c, causal=True, window=window,
                                        kv_chunk=q.shape[1], probs_bf16=True)

        return jax.vjp(f, q_, k_, v_)[1](g_)

    return [torch.from_numpy(np.array(t.astype(jnp.float32))) for t in
            grads(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, g)))]


# (B, S, H, KV, dh, dhv, window, tie): GQA (G 4), a window, MLA's
# zero-padded v, keys tied at every row's max (dh 16: exact dyadic scores)
EMU_CASES = [(1, 96, 8, 2, 64, 64, 0, False), (2, 80, 6, 2, 48, 48, 16, False),
             (1, 72, 4, 4, 32, 16, 0, False), (1, 24, 2, 1, 16, 16, 0, True)]
EMU_IDS = ["gqa", "window", "mla-pad", "tie"]


@pytest.mark.parametrize("case", EMU_CASES, ids=EMU_IDS)
def test_emulated_rounded_kernels_match_jax_grad(case):
    B, S, H, KV, dh, dhv, window, tie = case
    q, k, v, g = _inputs(B, S, H, KV, dh, dhv, seed=S, tie=tie)
    if tie:
        s = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, H // KV, axis=2))
        assert (s[..., 5:, 3] == s[..., 5:, 5]).all()
        assert (s[..., 5:, 3] == np.where(np.tri(S, dtype=bool), s, -np.inf)
                [..., 5:, :].max(-1)).all()
    qt, kt, vt, gt = (torch.from_numpy(a).to(BF16) for a in (q, k, v, g))
    *got, lse = _emulate_rounded(qt, kt, vt, gt, window=window)
    want = _jax_grads(q, k, v[..., :dhv], g[..., :dhv], window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a = a.float()[..., :dhv] if name == "dv" else a.float()
        tol = FLASH_BWD_BF16_ULPS * _ulp(float(b.abs().max()))
        err = float((a - b).abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"
    plain = flash_attention_bwd_ref(qt, kt, vt, gt, window=window, round_p=BF16)[3]
    torch.testing.assert_close(lse, plain, rtol=0,
                               atol=LSE_REL * max(float(plain.abs().max()), 1.0))


# ----------------------------------------------------- the faults' shares
# chip_smoke.FLASH_BWD_FAULT_SHARE, FLASH_BWD_FAULT_NOISE, FLASH_BWD_ARGMAX_REL
FAULT_SHARE, FAULT_NOISE, ARGMAX_REL = 0.5, 0.1, 1e-3
FAULTS = ("fp32 p", "detached max", "dk share")


def _seen(shares) -> bool:
    """A gradient read that lies nearer a fault than the rounded one."""
    return any(x and x[1] <= FAULT_NOISE and x[0] > FAULT_SHARE
               for s in shares.values() for x in s.values())


@pytest.mark.parametrize("fault", (None,) + FAULTS,
                         ids=["sound", "fp32-p", "detached-max", "dk-share"])
@pytest.mark.parametrize("case", EMU_CASES[:3], ids=EMU_IDS[:3])
def test_fault_shares_tell_each_fault(case, fault):
    """Over the whole tensor, where each gradient's two bf16 ulps hide
    them: the emulated kernels lie nearer the plain rounded gradient than
    either fault's (``profile_kernels.fault_shares`` at most 1/2 where the
    output's own rounding moves it by at most 0.1), every fault is read in
    one gradient at least, and each planted fault (``_emulate_rounded``'s
    ``fault``: the rounding ignored, the max detached, the argmax share
    left out of dk alone) lies nearer its fault.  The planted fp32 p and
    detached max are the plain faults of ``rounded_bwd_faults`` within two
    bf16 ulps."""
    B, S, H, KV, dh, dhv, window, _ = case
    q, k, v, g = (torch.from_numpy(a).to(BF16) for a in
                  _inputs(B, S, H, KV, dh, dhv, seed=S))
    rounded, faults = rounded_bwd_faults(q, k, v, g, window=window)
    assert all(any(x and x[1] <= FAULT_NOISE for x in s.values())
               for s in fault_shares(rounded, rounded, faults).values())
    got = _emulate_rounded(q, k, v, g, window=window, fault=fault)[:3]
    assert _seen(fault_shares(got, rounded, faults)) == (fault is not None)
    if fault in faults:
        for a, b in zip(got, faults[fault]):
            assert float((a.float() - b).abs().max()) <= (
                FLASH_BWD_BF16_ULPS * _ulp(float(b.abs().max())))


@pytest.mark.parametrize("fault", (None, "dk share", "detached max"),
                         ids=["sound", "dk-share", "detached-max"])
@pytest.mark.parametrize("S,H,KV,dh", [(256, 4, 2, 64), (300, 4, 4, 128)],
                         ids=["g2-dh64", "g1-dh128"])
def test_one_hot_attention_shows_each_rows_share(S, H, KV, dh, fault):
    """``profile_kernels.argmax_inputs``: every row's p is 1 at one key and
    0 elsewhere (each score at least 150 below the row's max in base 2),
    on inexact fp32 score sums; the plain rounded gradient's dq and dk are
    0 and the detached max's are not; the emulated kernels' dq and dk lie
    within 1e-3 of the detached max's largest, and without a row's share,
    in dk alone or in both, they do not."""
    q, k, v, g = argmax_inputs(S, H, KV, dh, BF16, "cpu", seed=H + dh)
    G = H // KV
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(G, 2)) * dh ** -0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), NEG)
    top2 = s.topk(2, -1).values
    assert float((top2[..., 0] - top2[..., 1])[..., 1:].min()) * LOG2E > 150
    assert not torch.equal(s, s.round())                # inexact sums
    rounded, faults = rounded_bwd_faults(q, k, v, g)
    size = [float(t.abs().max()) for t in faults["detached max"][:2]]
    assert min(size) > 0 and max(float(t.abs().max()) for t in rounded[:2]) == 0
    got = _emulate_rounded(q, k, v, g, fault=fault)[:3]
    far = [float(a.float().abs().max()) > ARGMAX_REL * z for a, z in zip(got, size)]
    assert far == {None: [False, False], "dk share": [False, True],
                   "detached max": [True, True]}[fault]


# --------------------------------------------------------------- the route
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dh,H,KV", [
    (128, 16, 2), (128, 48, 8), (64, 128, 1), (192, 128, 128), (224, 32, 32),
    (8, 4, 1), (256, 16, 1), (100, 12, 2), (64, 96, 1), (224, 32, 1),
    (264, 4, 4)])
def test_rounded_route_is_the_fp32_route(dtype, dh, H, KV):
    """``round_p=torch.bfloat16`` takes the tensor cores exactly where the
    fp32-p backward does for bfloat16, on contiguous tensors and on views
    off 16 bytes; float32 takes the CUDA cores."""
    q = torch.zeros((1, 4, H, dh), dtype=dtype)
    k = torch.zeros((1, 4, KV, dh), dtype=dtype)
    want = fa.flash_bwd_route(q, k, k) if dtype == BF16 else "simt"
    assert fa.flash_bwd_route(q, k, k, BF16) == want
    wide = torch.zeros((1, 4, H, dh + 2), dtype=dtype)[..., 1:dh + 1]
    assert fa.flash_bwd_route(wide, k, k, BF16) == fa.flash_bwd_route(wide, k, k) == "simt"
    with pytest.raises(ValueError, match="round_p"):
        fa.flash_bwd_route(q, k, k, torch.float16)


def test_round_mode_is_the_row_max_on_both_forward_kernels():
    """Every ``torch.bfloat16`` call up to dh 256 rounds against the row's
    max (mode 3), on ``fa_tc_kernel`` and ``fa_kernel`` alike; only
    ``fa_kernel``'s column split above dh 256 keeps a key tile's running
    max (2); fp32 p (0) and the TPU kernel's own rounding (1) unchanged."""
    for dh in range(8, fa.MAX_DH + 1, 8):
        assert fa._round_mode(BF16, dh) == 3
    assert fa._round_mode(BF16, fa.MAX_DH + 8) == 2
    assert (fa._round_mode(False, 128), fa._round_mode(True, 128)) == (0, 1)
    with pytest.raises(ValueError, match="round_p"):
        fa._round_mode(torch.float16, 128)


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("dh", [64, 128, 192, 224, 256])
def test_plan_scratch_with_round_p(dh):
    """With ``round_p`` (bfloat16) the scratch holds four statistics a row
    slot (m, l, D / l, the argmax share) where fp32 p holds two (lse and
    D), and each dkdv stage stages them alike (2 x 2 x 4 bytes a slot
    more); the grids, pieces and the dq block are the same; every block
    still fits the card (227 KB a block, two dkdv blocks an SM at 228 KB).
    Float32 has no rounded-p plan: it runs on the CUDA cores."""
    for S, H, KV in ((4096, 16, 2), (300, 48, 8), (1024, 32, 32)):
        p = fa.plan_flash_bwd(1, S, S, H, KV, dh)
        r = fa.plan_flash_bwd(1, S, S, H, KV, dh, round_p=True)
        assert r.scratch_bytes - p.scratch_bytes == 4 * 2 * KV * p.rows_pad
        assert r.dkdv_smem - p.dkdv_smem == 2 * 2 * r.row_slots * 4
        assert (r.dq_smem, r.pieces, r.dq_blocks, r.dkdv_blocks, r.rows_pad) == (
            p.dq_smem, p.pieces, p.dq_blocks, p.dkdv_blocks, p.rows_pad)
        assert r.dkdv_smem <= fa.SMEM_MAX and r.per_sm * r.dkdv_smem <= 228 * 1024
    with pytest.raises(ValueError, match="bfloat16 only"):
        fa.plan_flash_bwd(1, 64, 64, 4, 4, dh, dtype=torch.float32, round_p=True)


# ------------------------------------------------------------- the forward
def _forward_tc(q, k, v, row_max: bool, bk: int = 64):
    """``fa_tc_kernel``'s forward with p rounded to bfloat16 at qwen-like
    bf16 inputs, causal: unscaled bf16 scores summed in fp32, base 2; with
    ``row_max`` (mode 3) every p against the row's max, else against the
    running max of each key tile of ``bk`` (rescaling the sums)."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    sl2 = _f32(dh ** -0.5) * _f32(LOG2E)
    qh = q.float().reshape(B, S, KV, G, dh).permute(0, 2, 3, 1, 4)
    kh, vh = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    s = (qh.double() @ kh.double().transpose(-1, -2)).float()
    hid = torch.arange(S)[None, :] > torch.arange(S)[:, None]
    s = s.masked_fill(hid, NEG)
    m2 = torch.full(s.shape[:-1] + (1,), NEG)
    if row_max:
        m2 = torch.maximum(m2, s.amax(-1, keepdim=True) * sl2)
    o = torch.zeros(qh.shape)
    lsum = torch.zeros(m2.shape)
    for j0 in range(0, S, bk):
        st = s[..., j0:j0 + bk]
        m_new = torch.maximum(m2, st.amax(-1, keepdim=True) * sl2)
        alpha = (m2 - m_new).exp2()
        m2 = m_new
        p = (st.double() * sl2.double() - m2.double()).float().exp2()
        p = p.masked_fill(hid[:, j0:j0 + bk], 0.0)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + (_r(p).double() @ vh[..., j0:j0 + bk, :].double()).float()
    out = (o / lsum).permute(0, 3, 1, 2, 4).reshape(B, S, H, dh)
    return out.to(q.dtype)


def test_forward_row_max_holds_rising_scores():
    """Scores rising along the keys: a row's running max moves in every key
    tile.  Against the plain version (the row's max, as the reference
    with one KV chunk): the row-max forward within one bf16 ulp of the
    output's largest and bitwise equal on more elements than the tile-max
    forward, which the row's max replaced."""
    S, H, KV, dh = 512, 4, 1, 64
    rng = np.random.default_rng(5)
    u = rng.standard_normal(dh).astype(np.float32)
    q = u + 0.3 * rng.standard_normal((1, S, H, dh)).astype(np.float32)
    k = (np.linspace(0, 4, S, dtype=np.float32)[None, :, None, None] * u
         + 0.3 * rng.standard_normal((1, S, KV, dh)).astype(np.float32))
    v = rng.standard_normal((1, S, KV, dh)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    plain = flash_attention_ref(q, k, v, round_p=BF16).float()
    rows = _forward_tc(q, k, v, row_max=True).float()
    tiles = _forward_tc(q, k, v, row_max=False).float()
    top = float(plain.abs().max())
    assert float((rows - plain).abs().max()) <= _ulp(top)
    assert float((rows == plain).float().mean()) > float((tiles == plain).float().mean())
