"""The split-sequence plan of the decode-attention kernel, on the CPU.

``csrc/decode_attention.cu`` cannot run here, so its order of work is
emulated in this file (not in the port): each (b, KV head) is cut into
``plan_decode``'s splits of ``chunk`` keys; each split runs an online
softmax over tiles of 32 keys (masked keys at -1e30, p rounded to v's
dtype against the split's own running max when ``round_p``) into a partial
(m, l, acc) in fp32; a split that starts at or past the sequence's length
is an empty partial (m = -inf, l = 0) that the combine never reads; the
combine merges the splits below ceil(len / chunk) in split order.  Inputs
are numpy seeds, at qwen2.5's SMOKE widths (H 8, KV 2, dh 8) and at
qwen2.5-3b's heads (H 16, KV 2, dh 128) with S = 2048 at the lengths the
served decode reaches (905 … 63 keys), with lengths of 1 and S, and at
G = 128, dh = 320, wider than any config (two groups of 64 query rows).

Limits: float32 ``rtol = atol = 1e-5`` against the port's plain version and
the Pallas kernel in interpret mode, whose sums run in another order (the
limit ``tests/test_torch_attention.py`` holds them to).  bfloat16 inputs:
one bf16 ulp of the output's largest magnitude, since the bf16 output of
sums taken in another order may round either way, and since with
``round_p`` each split (or Pallas tile) rounds p against its own running
max, so the rounded p differ by up to an ulp between the versions.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode_kernel
from repro_torch.kernels.decode_attention import DecodePlan, plan_decode
from repro_torch.kernels.ref import decode_attention_ref

torch.set_num_threads(1)

SERVED = [905, 689, 562, 319, 357, 88, 122, 63]   # qwen2.5-3b's last decode step
SMS = 132
TILE, NEG = 32, -1e30
# (B, S, H, KV, dh, lengths): SMOKE widths, then qwen2.5-3b's heads
CASES = [(3, 64, 8, 2, 8, [1, 64, 33]),
         (4, 100, 8, 2, 8, [100, 31, 32, 65]),
         (8, 2048, 16, 2, 128, SERVED),
         (8, 2048, 16, 2, 128, [1, 2048, 2047, 32, 33, 64, 65, 1]),
         (2, 64, 128, 1, 320, [64, 33])]           # G > 64, dh > 256
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(B, S, H, KV, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, dh), (B, S, KV, dh), (B, S, KV, dh)))
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v)]


def kernel_plan(q, k, v, lens, plan: DecodePlan, round_p: bool,
                starts=None, window: int = 0) -> torch.Tensor:
    """The kernel's split and combine order in float32 → (B, H, dh) in q's
    dtype.  With ``starts``/``window`` row b attends keys [st, n), st its
    start raised to n − window; a windowed plan's split s takes chunk
    st // chunk + s."""
    B, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qs = q.float().reshape(B, KV, G, dh) * dh ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty(B, KV, G, dh)
    for b in range(B):
        n = min(max(int(lens[b]), 0), S)
        st = 0 if starts is None else min(max(int(starts[b]), 0), n)
        if window:
            st = max(st, n - window)
        base = st // plan.chunk if plan.windowed else 0
        parts = []
        for s in range(plan.splits):
            ck = (base + s) * plan.chunk
            c0, c1 = max(ck, st), min(ck + plan.chunk, n)
            if c0 >= c1:                             # an empty partial
                parts.append((torch.full((KV, G), -math.inf),
                              torch.zeros(KV, G), None))
                continue
            m = torch.full((KV, G), NEG)
            l = torch.zeros(KV, G)
            acc = torch.zeros(KV, G, dh)
            for j0 in range(c0, c1, TILE):
                nk = min(TILE, c1 - j0)
                kt = kf[b, j0:j0 + nk].transpose(0, 1)          # (KV, nk, dh)
                vt = vf[b, j0:j0 + nk].transpose(0, 1)
                sc = torch.full((KV, G, TILE), NEG)
                sc[..., :nk] = torch.einsum("kgd,kjd->kgj", qs[b], kt)
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = l * alpha + p.sum(-1)
                if round_p:
                    p = p.to(v.dtype).float()
                acc = acc * alpha[..., None] + torch.einsum(
                    "kgj,kjd->kgd", p[..., :nk], vt)
                m = m_new
            parts.append((m, l, acc))
        if plan.splits == 1:
            m, l, acc = parts[0]
            out[b] = (0.0 if acc is None
                      else acc / torch.clamp(l, min=1e-30)[..., None])
            continue
        live = [parts[s] for s in plan.live(n, st)]  # the splits the combine reads
        assert all(a is not None for _, _, a in live)
        if not live:                                 # no key: a zero row
            out[b] = 0.0
            continue
        mx = torch.stack([m for m, _, _ in live]).amax(0)
        l = torch.zeros(KV, G)
        acc = torch.zeros(KV, G, dh)
        for m_s, l_s, acc_s in live:
            w = torch.exp(m_s - mx)
            l = l + w * l_s
            acc = acc + w[..., None] * acc_s
        out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, dh).to(q.dtype)


def _close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        w = want.float()
        ulp = 2.0 ** (math.floor(math.log2(float(w.abs().max()))) - 7)
        assert float((got.float() - w).abs().max()) <= ulp


@pytest.mark.parametrize("round_p", [False, True], ids=["p_fp32", "p_rounded"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,lens", CASES, ids=str)
def test_split_plan_matches_the_plain_version(B, S, H, KV, dh, lens, dtype,
                                              round_p):
    q, k, v = _inputs(B, S, H, KV, dh, dtype, seed=S + B)
    plan = plan_decode(B, KV, H // KV, S, dh, dtype, SMS)
    got = kernel_plan(q, k, v, lens, plan, round_p)
    _close(got, decode_attention_ref(q, k, v, torch.tensor(lens),
                                     round_p=round_p))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,lens", CASES, ids=str)
def test_split_plan_matches_the_pallas_kernel(B, S, H, KV, dh, lens, dtype):
    """The Pallas kernel rounds p to v's dtype (a no-op in float32)."""
    q, k, v = _inputs(B, S, H, KV, dh, dtype, seed=7 * S + B)
    plan = plan_decode(B, KV, H // KV, S, dh, dtype, SMS)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = j_decode_kernel(*(jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v)),
                           jnp.asarray(np.asarray(lens, np.int32)), interpret=True)
    want = torch.from_numpy(np.array(want, np.float32)).to(dtype)
    for round_p in ((False, True) if dtype == torch.float32 else (True,)):
        _close(kernel_plan(q, k, v, lens, plan, round_p), want)


def test_served_plan_puts_a_wave_of_blocks_on_keys():
    """qwen2.5-3b's decode at batch 8, S = 2048: 32-key chunks, 64 splits,
    and at the served lengths 200 blocks with keys to read, over one wave
    of the H100's 132 SMs (16 with one block per (b, KV head))."""
    for dtype in DTYPES:
        plan = plan_decode(8, 2, 8, 2048, 128, dtype, SMS)
        assert (plan.chunk, plan.splits, plan.warps, plan.rows) == (32, 64, 4, 2)
        assert 2 * sum(plan.live_splits(n) for n in SERVED) == 200 >= SMS
        assert [plan.live_splits(n) for n in (1, 32, 33, 2048)] == [1, 1, 2, 64]


def test_plan_depends_on_shapes_only():
    """The plan takes no lengths; the chunk doubles while a quarter-full
    cache still gives every SM a block, and the block's warps hold every
    query row of its KV head."""
    assert plan_decode(1, 8, 4, 32768, 128, torch.bfloat16, SMS).chunk == 256
    assert plan_decode(64, 8, 4, 32768, 128, torch.bfloat16, SMS).splits == 2
    assert plan_decode(2, 2, 4, 20, 64, torch.float32, SMS) == DecodePlan(
        32, 1, 4, 1)
    for G in range(1, 65):
        plan = plan_decode(8, 2, G, 2048, 128, torch.bfloat16, SMS)
        assert plan.warps * plan.rows >= G and plan.rows in (1, 2, 4)
        assert plan.warps == 4 or plan.rows == 4
    assert plan_decode(8, 2, 65, 2048, 128, torch.float32, SMS).groups == 2
    for bad in (dict(G=8, dh=513), dict(G=8, dh=460)):
        with pytest.raises(ValueError):
            plan_decode(8, 2, bad["G"], 2048, bad["dh"], torch.float32, SMS)
    with pytest.raises(TypeError):
        plan_decode(8, 2, 8, 2048, 128, torch.float16, SMS)


def test_empty_splits_are_never_combined():
    """Lengths far below S leave most splits empty: the combine reads only
    the splits with keys, so an empty partial's m = -inf never meets an
    accumulator and no NaN appears, even for a length of 1."""
    B, S, H, KV, dh = 4, 2048, 16, 2, 128
    q, k, v = _inputs(B, S, H, KV, dh, torch.float32, seed=3)
    plan = plan_decode(B, KV, H // KV, S, dh, torch.float32, SMS)
    lens = [1, 2, 31, 40]
    assert plan.splits == 64 and max(plan.live_splits(n) for n in lens) == 2
    got = kernel_plan(q, k, v, lens, plan, round_p=False)
    _close(got, decode_attention_ref(q, k, v, torch.tensor(lens)))
    w = torch.exp(torch.tensor(-math.inf) - torch.tensor(0.5))
    assert float(w) == 0.0 and math.isnan(float(w * torch.tensor(math.nan)))


# (B, S, H, KV, dh, W, lengths, starts): qwen2.5-3b's heads at S 2,048 with
# W 256 and 1,024 (a windowed grid of 9 and 33 splits) at lengths 1, W - 1,
# W, W + 1 and S; SMOKE widths with W 8 and a start past the window's; a
# piece of a sequence split over ranks (local starts, one wholly below its
# start, one at 0)
WINDOW_CASES = [
    (8, 2048, 16, 2, 128, 256, [1, 255, 256, 257, 2048, 1000, 33, 2047], None),
    (8, 2048, 16, 2, 128, 1024, [1, 1023, 1024, 1025, 2048, 1500, 33, 700], None),
    (4, 64, 8, 2, 8, 8, [1, 9, 64, 40], [0, 3, 60, 36]),
    (4, 512, 8, 2, 64, 100, [512, 0, 300, 512], [512, 0, 250, 450]),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,W,lens,starts", WINDOW_CASES, ids=str)
def test_window_plan_matches_the_plain_version(B, S, H, KV, dh, W, lens,
                                               starts, dtype):
    """A window on a full-length cache: the grid covers ceil(W / chunk) + 1
    splits from each row's start, the combine reads the ones with keys,
    and a row with none gives zeros (and lse -inf, in the plain version)."""
    q, k, v = _inputs(B, S, H, KV, dh, dtype, seed=W + B)
    plan = plan_decode(B, KV, H // KV, S, dh, dtype, SMS, window=W)
    assert plan.splits == min(-(-S // plan.chunk), -(-W // plan.chunk) + 1)
    want = decode_attention_ref(q, k, v, torch.tensor(lens),
                                cache_start=None if starts is None
                                else torch.tensor(starts), window=W,
                                round_p=False)
    _close(kernel_plan(q, k, v, lens, plan, False, starts, W), want)
    # the window is the start raised to len - W: the same keys as an
    # explicit start there, and a row with none gives zeros and lse -inf
    n = torch.tensor(lens)
    first = torch.maximum(torch.tensor(starts or [0] * B).clamp(min=0),
                          n - W).clamp(min=0)
    assert torch.equal(decode_attention_ref(q, k, v, n, cache_start=first,
                                            round_p=False), want)
    out, lse = decode_attention_ref(q, k, v, n, cache_start=first,
                                    return_lse=True)
    empty = first >= n
    assert bool((lse[empty] == -math.inf).all()) and not bool(out[empty].any())
    assert bool(torch.isfinite(lse[~empty]).all())


def test_window_plan_follows_w_not_s():
    """qwen2.5-3b's decode (B 8, S 2,048): 9 blocks a (b, KV head) with a
    window of 256 against 64 without; decode_32k's shape (S 32,768, W
    4,096): the grid spans 4,128 keys a row, not 32,768; a window as wide
    as the cache keeps the plain grid."""
    full = plan_decode(8, 2, 8, 2048, 128, torch.bfloat16, SMS)
    win = plan_decode(8, 2, 8, 2048, 128, torch.bfloat16, SMS, window=256)
    assert (full.splits, full.windowed) == (64, False)
    assert (win.chunk, win.splits, win.windowed) == (32, 9, True)
    assert [win.live_splits(n, max(0, n - 256)) for n in (1, 255, 256, 257, 2048)] \
        == [1, 8, 8, 9, 8]
    big = plan_decode(1, 8, 4, 32768, 128, torch.bfloat16, SMS)
    wbig = plan_decode(1, 8, 4, 32768, 128, torch.bfloat16, SMS, window=4096)
    assert big.splits * big.chunk == 32768 and wbig.splits * wbig.chunk == 4128
    assert plan_decode(8, 2, 8, 64, 128, torch.float32, SMS, window=256) == \
        plan_decode(8, 2, 8, 64, 128, torch.float32, SMS)
