"""The gradient of the port's flash attention, against the reference's.

The reference trains through its pure-jnp streaming attention
(``repro.models.attention.flash_attention``) and differentiates it with
XLA; the port's training attention is the flash kernel with a hand-written
backward (``kernels.flash_attention.FlashAttentionFn``), whose plain version
on the CPU is autograd through ``kernels.ref.flash_attention_ref``.  Here the
plain version's (dq, dk, dv) and each row's log-sum-exp are held against
``jax.vjp`` of the reference on the same numpy inputs: causal, sliding
window, full, GQA (G 1, 2, 4) and MLA's shape (v zero-padded to the q/k
width, the padded columns of dv dropped), float32 and bfloat16.

Tolerances: float32 ``rtol = atol = 1e-5`` of each gradient's largest
magnitude (the two sum the same fp32 terms in other orders); bfloat16: both
compute in fp32 and round each gradient once, so they agree within one bf16
ulp of the gradient's largest magnitude.

The card cases (``@pytest.mark.cuda``, skipped here) hold the backward
kernels against the plain version: float32 within ``1e-4`` of each
gradient's largest magnitude, bfloat16 within two bf16 ulps of it, and lse
within ``1e-5`` of its largest magnitude; two calls bitwise equal (no
atomics); each call on the route ``flash_bwd_route`` picks, as its launch
counter shows (dh a multiple of 8 up to 256, G up to 64 or 128, float32
above dh 128 up to 16, on the tensor cores, its key tiles' walks
cut into pieces at S 300 and 1,024, G 6 in row tiles of whole tokens), and
the CUDA-core route forced on the tensor-core cases; float32 at qwen2.5-3b's
and internvl2-26b's heads up to S 4,096, with q and k 8 and 12 times larger
against the exact gradient (float64), and at zamba2-7b's and the MLA's
(DHP 256); the forward at G 3, 5 and 6 on the tensor cores; the gradient
with p rounded to bfloat16 (``round_p``, the model's ``probs_bf16``) on
the tensor cores (bfloat16; forced onto the CUDA-core pair beside them)
and on the CUDA-core pair (float32) at qwen2.5-3b's, MLA's
and zamba2-7b's heads and with keys tied at the max, within 1e-3 of each
gradient's largest of the plain version (float32) or two bf16 ulps of it
(bfloat16), and in both nearer the rounded gradient than the fp32-p or
detached-max one over the whole tensor, which the fp32-p backward fails,
through ``FlashAttentionFn`` too; on one-hot attention, where dq and dk
are the argmax shares alone; the plan's shared memory with p rounded; and
``fa_tc_kernel`` rounding p against the row's max on scores that rise
along the keys, within one bf16 ulp and bitwise the plain version's on
0.92 of the outputs, which the key tile's running max fails.  JAX is
imported inside the reference's helper only, so that the card case runs
where JAX is not installed.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

# (B, S, H, KV, dh, dhv, causal, window): dhv < dh is MLA's shape
CASES = [
    (2, 40, 4, 2, 16, 16, True, 0),
    (1, 33, 4, 1, 8, 8, True, 0),
    (2, 40, 4, 2, 16, 16, True, 8),
    (1, 24, 2, 2, 16, 16, False, 0),
    (1, 37, 4, 4, 24, 16, True, 0),
]
IDS = ["gqa", "mqa-ragged", "window", "full", "mla-pad"]


def _inputs(B, S, H, KV, dh, dhv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dhv)).astype(np.float32)
    g = rng.standard_normal((B, S, H, dhv)).astype(np.float32)
    return q, k, v, g


def _ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _reference(q, k, v, g, causal, window, dtype):
    import jax
    import jax.numpy as jnp

    from repro.models import attention as jatt

    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(a).astype(jd) for a in (q, k, v)]

    def f(q_, k_, v_):
        return jatt.flash_attention(q_, k_, v_, causal=causal, window=window,
                                    kv_chunk=16)

    _, vjp = jax.vjp(f, *args)
    return [np.asarray(t.astype(jnp.float32)) for t in
            vjp(jnp.asarray(g).astype(jd))]


def _port(q, k, v, g, causal, window, dtype):
    """The port's route: v zero-padded to q's width (as ``mla_prefill``
    pads it), the plain backward, dv's padded columns dropped."""
    dhv = v.shape[-1]
    qt, kt, vt, gt = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    pad = q.shape[-1] - dhv
    vp = torch.nn.functional.pad(vt, (0, pad))
    gp = torch.nn.functional.pad(gt, (0, pad))
    dq, dk, dv, lse = flash_attention_bwd_ref(qt, kt, vp, gp, causal=causal,
                                              window=window)
    return [t.float().numpy() for t in (dq, dk, dv[..., :dhv])], lse


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_backward_matches_jax_grad(case, dtype):
    B, S, H, KV, dh, dhv, causal, window = case
    q, k, v, g = _inputs(B, S, H, KV, dh, dhv, seed=S)
    if dtype == torch.bfloat16:          # the same bf16 values on both sides
        q, k, v, g = (torch.from_numpy(a).to(dtype).float().numpy()
                      for a in (q, k, v, g))
    got, _ = _port(q, k, v, g, causal, window, dtype)
    want = _reference(q, k, v, g, causal, window, dtype)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        top = float(np.abs(b).max())
        tol = 1e-5 * max(top, 1.0) if dtype == torch.float32 else _ulp(top)
        err = float(np.abs(a - b).max())
        assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_is_the_rows_logsumexp(case):
    B, S, H, KV, dh, dhv, causal, window = case
    q, k, v, g = _inputs(B, S, H, KV, dh, dhv, seed=1)
    _, lse = _port(q, k, v, g, causal, window, torch.float32)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k, H // KV, axis=2).astype(np.float64)) * dh ** -0.5
    qpos, kpos = np.arange(S)[:, None], np.arange(S)[None, :]
    mask = np.ones((S, S), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = np.where(mask, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_train_attention_differentiates_on_the_cpu():
    """``flash_attention_train`` on CPU tensors is the plain version with
    autograd: its gradients are the plain backward's."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 20, 4, 2, 8, 8, 3))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = fa.flash_attention_train(q, k, v, causal=True, window=5)
    out.backward(g)
    want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), g,
                                   causal=True, window=5)
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_train(q, k, v, causal=False, window=5)


# ------------------------------------------------------------------ the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    if not (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("needs nvcc to build csrc/flash_attention.cu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (B, S, H, KV, dh, causal, window): qwen's heads, G 6 at dh 100, dh 64,
# 192, 224, 256, a window, full attention, a ragged length; qwen's heads at
# S 1,024 (16 pieces a key tile on the tensor cores) causal, with a window
# of 256 and full; G 128; one piece and dh 8; B 2 (olmoe's training
# batch); internvl2's G 6 (48 / 8 / 128) ragged and with a window
CARD_CASES = [(1, 300, 16, 2, 128, True, 0), (2, 130, 12, 2, 100, True, 0),
              (1, 200, 4, 4, 64, True, 0), (1, 160, 8, 8, 192, True, 0),
              (1, 300, 4, 4, 224, True, 64), (1, 97, 2, 1, 256, False, 0),
              (1, 257, 16, 2, 128, True, 33), (1, 1024, 16, 2, 128, True, 0),
              (1, 1024, 16, 2, 128, True, 256), (1, 1024, 16, 2, 128, False, 0),
              (1, 77, 128, 1, 64, True, 0), (1, 33, 4, 1, 8, True, 0),
              (2, 200, 16, 16, 128, True, 0), (1, 301, 48, 8, 128, True, 0),
              (2, 150, 12, 2, 64, True, 40)]


def _hold(got, want, again, dtype, f32_rel=1e-4):
    for name, a, b, c in zip(("dq", "dk", "dv", "lse"), got, want, again):
        assert torch.equal(a, c), f"{name}: two calls differ"
        top = float(b.float().abs().max())
        if name == "lse":
            tol = 1e-5 * max(top, 1.0)
        elif dtype == torch.float32:
            tol = f32_rel * top
        else:
            tol = 2 * _ulp(top)
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_kernels_match_plain(card, case, dtype):
    B, S, H, KV, dh, causal, window = case
    q, k, v, g = (torch.from_numpy(a).to(card, dtype) for a in
                  _inputs(B, S, H, KV, dh, dh, seed=S + dh))
    route = fa.flash_bwd_route(q, k, v)
    G = H // KV                          # float32 at DHP 256: row tiles of 16 slots
    tc = dh % 8 == 0 and dh <= 256 and (G <= 64 or G == 128) and not (
        dtype == torch.float32 and dh > 128 and G > 16)
    assert route == ("wgmma" if tc else "simt")
    key = "flash_attention_bwd_wgmma" if tc else "flash_attention_bwd"
    before = dict(LAUNCHES)
    got = fa.flash_attention_bwd(q, k, v, g, causal=causal, window=window)
    again = fa.flash_attention_bwd(q, k, v, g, causal=causal, window=window)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd", "flash_attention_bwd_wgmma"):
        assert LAUNCHES[name] == before[name] + (2 if name == key else 0)
    want = flash_attention_bwd_ref(q, k, v, g, causal=causal, window=window)
    _hold(got, want, again, dtype)
    if tc:                               # the CUDA-core route on the same call
        got = fa.flash_attention_bwd(q, k, v, g, causal=causal, window=window,
                                     route="simt")
        again = fa.flash_attention_bwd(q, k, v, g, causal=causal,
                                       window=window, route="simt")
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 2
        _hold(got, want, again, dtype)



@pytest.mark.cuda
@pytest.mark.parametrize("peak", [1.0, 5.0], ids=["unit", "peaked"])
@pytest.mark.parametrize("S,H,KV", [(1024, 16, 2), (4096, 16, 2), (1024, 48, 8),
                                    (4096, 48, 8)],
                         ids=["qwen-1024", "qwen-4096", "internvl2-1024",
                              "internvl2-4096"])
def test_float32_backward_on_the_tensor_cores_at_the_trained_heads(card, S, H, KV,
                                                                   peak):
    """qwen2.5-3b's and internvl2-26b's heads in float32: on
    ``flash_attention_bwd_wgmma`` (the split and the two kernels one call),
    within the float32 limits of the plain version and of the CUDA-core
    route on the same inputs, two calls bitwise equal; also with q and k
    five times larger (``peaked``: scaled scores of standard deviation 25).
    internvl2's at S 4,096 walks 410 row tiles a key tile in one piece: the
    longest sum."""
    q, k, v, g = (torch.from_numpy(a).to(card) for a in
                  _inputs(1, S, H, KV, 128, 128, seed=S + H))
    q, k = q * peak, k * peak
    assert fa.flash_bwd_route(q, k, v) == "wgmma"
    before = dict(LAUNCHES)
    got = fa.flash_attention_bwd(q, k, v, g)
    again = fa.flash_attention_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd_wgmma"] == before["flash_attention_bwd_wgmma"] + 2
    assert LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"]
    assert all(t.dtype == torch.float32 for t in got)
    _hold(got, flash_attention_bwd_ref(q, k, v, g), again, torch.float32)
    simt = fa.flash_attention_bwd(q, k, v, g, route="simt")
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    _hold(got, simt, again, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,dh,dhv", [(32, 32, 224, 224), (128, 128, 192, 128)],
                         ids=["zamba2-dh224", "mla-dh192"])
def test_float32_backward_at_dhp256_on_the_tensor_cores(card, H, KV, dh, dhv):
    """zamba2-7b's shared block and deepseek-v2's MLA (v and g zero past
    column 128, as the model pads v) in float32 at S 1,024: on
    ``flash_attention_bwd_wgmma`` (row tiles of 16 slots), within the
    float32 limits of the plain version and of the CUDA-core route on the
    same inputs, two calls bitwise equal."""
    q, k, v, g = (torch.nn.functional.pad(torch.from_numpy(a), (0, dh - a.shape[-1]))
                  .to(card) for a in _inputs(1, 1024, H, KV, dh, dhv, seed=dh + H))
    assert fa.flash_bwd_route(q, k, v) == "wgmma"
    before = dict(LAUNCHES)
    got = fa.flash_attention_bwd(q, k, v, g)
    again = fa.flash_attention_bwd(q, k, v, g)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd_wgmma"] == before["flash_attention_bwd_wgmma"] + 2
    assert LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"]
    _hold(got, flash_attention_bwd_ref(q, k, v, g), again, torch.float32)
    simt = fa.flash_attention_bwd(q, k, v, g, route="simt")
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    _hold(got, simt, again, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("peak", [8.0, 12.0])
@pytest.mark.parametrize("H,KV", [(16, 2), (48, 8)], ids=["qwen", "internvl2"])
def test_float32_backward_holds_scores_peaked_further(card, H, KV, peak):
    """qwen2.5-3b's and internvl2-26b's heads in float32 at S 1,024 with q
    and k 8 and 12 times larger: within the float32 limits of the exact
    gradient (float64 from the same inputs), at x8 also of the plain
    version (at x12 the plain version is itself up to 0.9 of the limits
    from the exact gradient on the card); two calls bitwise equal."""
    from repro_torch.launch.profile_kernels import exact_flash_bwd

    q, k, v, g = (torch.from_numpy(a).to(card) for a in
                  _inputs(1, 1024, H, KV, 128, 128, seed=1024 + H))
    q, k = q * peak, k * peak
    got = fa.flash_attention_bwd(q, k, v, g)
    again = fa.flash_attention_bwd(q, k, v, g)
    torch.cuda.synchronize()
    _hold(got, exact_flash_bwd(q, k, v, g), again, torch.float32)
    if peak == 8.0:
        _hold(got, flash_attention_bwd_ref(q, k, v, g), again, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plan_states_the_kernels_shared_memory(card, dtype):
    """``plan_flash_bwd``'s ``dq_smem`` and ``dkdv_smem`` are the kernels'
    own (``fbt_query``) at every head width the route takes, p in fp32 and
    (bfloat16) rounded to bfloat16 (the rounded-p instances: four
    statistics a slot), and the kernels issue 15 (bfloat16: p and ds in
    three terms) or 27 (float32: three of every product) products for the
    gradient's five, one score product more with p rounded (16: the dq
    kernel's pass for the rows' max); float32 has no rounded-p instance."""
    top = fa.BWD_MAX_DH if dtype == torch.bfloat16 else fa.BWD_F32_MAX_DH
    f32 = dtype == torch.float32
    for rp in (False, True):
        for dh in range(8, top + 1, 8):
            if rp and f32:
                with pytest.raises(ValueError):
                    fa.bwd_kernel_facts(dh, dtype, rp)
                continue
            plan = fa.plan_flash_bwd(1, 256, 256, 16, 2, dh, dtype=dtype,
                                     round_p=rp)
            facts = fa.bwd_kernel_facts(dh, dtype, rp)
            assert (plan.dq_smem, plan.dkdv_smem) == (facts["dq_smem"],
                                                      facts["dkdv_smem"]), (dh, rp)
            assert facts["dq_products"] + facts["dkdv_products"] == (
                16 if rp else 27 if f32 else 15)


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,KV,dh", [(1024, 48, 8, 128), (4096, 48, 8, 128),
                                       (300, 6, 2, 64), (257, 10, 2, 64)],
                         ids=["g6-1024", "g6-4096", "g3", "g5"])
def test_forward_at_any_g_on_the_tensor_cores(card, S, H, KV, dh):
    """internvl2-26b's G 6 and the odd G 3 and 5 on ``fa_tc_kernel`` (row
    tiles of whole tokens): counted there and not on ``fa_kernel``, within
    one bf16 ulp of the output's largest magnitude of the plain version,
    causal, full and with a window of 256, p rounded and fp32."""
    from repro_torch.kernels.ref import flash_attention_ref

    q, k, v, _ = (torch.from_numpy(a).to(card, torch.bfloat16) for a in
                  _inputs(1, S, H, KV, dh, dh, seed=S + H))
    assert fa.flash_route(q, k, v) == "wgmma"
    for causal, window in ((True, 0), (False, 0), (True, 256)):
        for rp in (True, False):
            before = dict(LAUNCHES)
            got = fa.flash_attention_fused(q, k, v, causal=causal, window=window,
                                           round_p=rp)
            torch.cuda.synchronize()
            assert LAUNCHES["flash_attention_wgmma"] == before["flash_attention_wgmma"] + 1
            assert LAUNCHES["flash_attention"] == before["flash_attention"]
            want = flash_attention_ref(q, k, v, causal=causal, window=window,
                                       round_p=rp)
            err = float((got.float() - want.float()).abs().max())
            assert err <= _ulp(float(want.float().abs().max())), (causal, window, rp)


# The rounded-p backward's float32 limit, of each gradient's largest: the
# kernels read up to about 2e-4 of it, the fp32-p gradient and a detached
# row max (the faults it must catch) 1.3e-3 and more
ROUNDED_F32_REL = 1e-3
# ... and in both dtypes over the whole tensor (chip_smoke's
# FLASH_BWD_FAULT_SHARE, FLASH_BWD_FAULT_NOISE, FLASH_BWD_ARGMAX_REL and
# FLASH_ROW_MAX_BITWISE): each gradient's share of the way towards each
# fault at most 1/2, read where the output's rounding moves it by at most
# 0.1; one-hot attention's dq and dk within 1e-3 of the argmax shares'
# largest; the row-max forward bitwise the plain version's on 0.92 of its
# outputs, which the key tile's running max fails
ROUNDED_FAULT_SHARE, ROUNDED_FAULT_NOISE, ROUNDED_ARGMAX_REL = 0.5, 0.1, 1e-3
ROW_MAX_BITWISE = 0.92


def _nearer_a_fault(shares) -> bool:
    return any(x and x[1] <= ROUNDED_FAULT_NOISE and x[0] > ROUNDED_FAULT_SHARE
               for sh in shares.values() for x in sh.values())
# (B, S, H, KV, dh, window): qwen2.5-3b's heads, with a window of 256;
# deepseek-v2's MLA (v zero past 128); zamba2-7b's shared block; a ragged
# G 4 at dh 16 with keys 3 and 5 tied at every row's max
ROUND_CASES = [(1, 300, 16, 2, 128, 0), (1, 1024, 16, 2, 128, 256),
               (1, 257, 128, 128, 192, 0), (1, 300, 32, 32, 224, 0),
               (2, 77, 4, 1, 16, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROUND_CASES,
                         ids=["qwen", "qwen-window", "mla", "zamba2", "tie"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rounded_backward_kernels_match_plain(card, case, dtype):
    """``round_p=torch.bfloat16`` on the route it takes (bfloat16: the
    tensor cores, ``fbt_dq_kernel`` + ``fbt_dkdv_kernel`` or
    ``fbt_dkdv2_kernel``, counted as ``flash_attention_bwd_wgmma``;
    float32: ``fb_dq_kernel`` + ``fb_dkdv_kernel``, counted as
    ``flash_attention_bwd``) and, bfloat16, forced onto the CUDA cores
    (``route="simt"``) against the plain version's gradient of the
    rounded p, two calls bitwise equal, dq, dk and dv within
    ``ROUNDED_F32_REL`` of each one's largest (float32) or two bf16 ulps of
    it (bfloat16: exp and the sums' order flip some roundings of p), and
    over the whole tensor nearer the rounded gradient than either fault's
    (``profile_kernels.fault_shares``: p in fp32, a detached max), where
    the fp32-p backward, run as a control, lies nearer its fault (and
    float32's beyond ``ROUNDED_F32_REL``); lse within 1e-5; the forward
    within float32's 1e-5 of the plain version
    (``fa_kernel`` rounds p against the row's max, as the plain version
    does) or one bf16 ulp (``fa_tc_kernel``, against the row's max too);
    ``FlashAttentionFn``'s output and gradients are the kernels'."""
    from repro_torch.launch.profile_kernels import fault_shares, rounded_bwd_faults

    B, S, H, KV, dh, window = case
    q, k, v, g = _inputs(B, S, H, KV, dh, dh, seed=S + dh)
    if dh == 16:            # dyadic scores (scale 1/4): the tie is exact
        u = np.sign(np.random.default_rng(0).standard_normal(dh)).astype(np.float32)
        k = np.round(4 * k) / 4
        k[:, 3] = k[:, 5] = 2.0 * u
        q = np.round(8 * q) / 8
        q[:, 5:] += u
    q, k, v, g = (torch.from_numpy(a).to(card, dtype) for a in (q, k, v, g))
    if H == 128:
        v[..., 128:] = 0
        g[..., 128:] = 0
    v = v.to(torch.bfloat16).to(dtype)          # as the model's _bf16_v
    bf = torch.bfloat16
    f32 = dtype == torch.float32
    assert fa.flash_bwd_route(q, k, v, bf) == ("simt" if f32 else "wgmma")
    want = flash_attention_bwd_ref(q, k, v, g, window=window, round_p=bf)
    rounded, faults = rounded_bwd_faults(q, k, v, g, window=window)
    # every fault read in one gradient at least, where the output's own
    # rounding moves its share by at most ROUNDED_FAULT_NOISE
    assert all(any(x and x[1] <= ROUNDED_FAULT_NOISE for x in sh.values())
               for sh in fault_shares(want[:3], rounded, faults).values())
    routes = ((None, "flash_attention_bwd"),) if f32 else (
        (None, "flash_attention_bwd_wgmma"), ("simt", "flash_attention_bwd"))
    for route, key in routes:
        before = dict(LAUNCHES)
        got = fa.flash_attention_bwd(q, k, v, g, window=window, round_p=bf,
                                     route=route)
        again = fa.flash_attention_bwd(q, k, v, g, window=window, round_p=bf,
                                       route=route)
        torch.cuda.synchronize()
        for name in ("flash_attention_bwd", "flash_attention_bwd_wgmma"):
            assert LAUNCHES[name] == before[name] + (2 if name == key else 0)
        _hold(got, want, again, dtype, f32_rel=ROUNDED_F32_REL)
        assert not _nearer_a_fault(fault_shares(got[:3], rounded, faults))
        if route is None:
            kernels = got
    # the control: the fp32-p backward lies nearer its fault, and float32's
    # is beyond the limit
    fp32 = fa.flash_attention_bwd(q, k, v, g, window=window)[:3]
    assert _nearer_a_fault(fault_shares(fp32, rounded, faults))
    if dtype == torch.float32:
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(fp32, want))
        assert rel > ROUNDED_F32_REL, rel
    fwd = fa.flash_attention_fused(q, k, v, window=window, round_p=bf)
    plain = flash_attention_ref(q, k, v, window=window, round_p=bf)
    if dtype == torch.float32:
        assert fa.flash_route(q, k, v) == "simt"
        torch.testing.assert_close(fwd, plain, rtol=1e-5, atol=1e-5)
    else:
        top = float(plain.float().abs().max())
        assert float((fwd.float() - plain.float()).abs().max()) <= _ulp(top)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fa.flash_attention_train(qq, kk, vv, window=window, round_p=bf)
    assert torch.equal(out, fwd)
    out.backward(g)
    for a, b in zip((qq.grad, kk.grad, vv.grad), kernels):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,dh", [(16, 2, 128), (128, 128, 192), (32, 32, 224)],
                         ids=["qwen", "mla", "zamba2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rounded_backward_lands_the_argmax_share(card, H, KV, dh, dtype):
    """One-hot attention (``profile_kernels.argmax_inputs``, S 1,024: every
    row's p is 1 at one key, on inexact score sums), where the rounded-p
    gradient's dq and dk are each row's argmax share and its residual
    alone, 0 up to fp32 rounding: on either route (bfloat16: the tensor
    cores, whose dq kernel finds m and the ties in one pass and adds the
    share in another, and whose dkdv kernels add it where S^T equals m;
    and forced onto ``fb_*``) dq and dk within 1e-3 of the largest the
    detached max gives them, dv within the limits of the plain version."""
    from repro_torch.launch.profile_kernels import argmax_inputs, rounded_bwd_faults

    bf = torch.bfloat16
    q, k, v, g = argmax_inputs(1024, H, KV, dh, dtype, card, seed=H + dh,
                               dhv=128 if dh == 192 else None)
    want = flash_attention_bwd_ref(q, k, v, g, round_p=bf)
    size = [float(t.abs().max()) for t in
            rounded_bwd_faults(q, k, v, g)[1]["detached max"][:2]]
    assert min(size) > 0
    for route in (None, "simt"):
        got = fa.flash_attention_bwd(q, k, v, g, round_p=bf, route=route)
        for a, z in zip(got[:2], size):
            assert float(a.float().abs().max()) <= ROUNDED_ARGMAX_REL * z
        top = float(want[2].float().abs().max())
        tol = 2 * _ulp(top) if dtype == bf else ROUNDED_F32_REL * top
        assert float((got[2].float() - want[2].float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1024, 4096])
def test_forward_rounds_against_the_row_max_on_the_tensor_cores(card, S):
    """Scores that rise along the keys (k_j = (j / S) 4 u, q = u + noise), so
    that a row's running max changes in every key tile: ``fa_tc_kernel``
    with ``round_p=torch.bfloat16`` (the row's max, a first pass over the
    keys) within one bf16 ulp of the output's largest of the plain
    version, causal and full, at qwen2.5-3b's heads, and bitwise equal to
    it on at least ``ROW_MAX_BITWISE`` of the outputs, where
    ``round_p=True`` on the same bfloat16 inputs, which rounds against
    each key tile's running max (the tile-max kernel that served
    ``torch.bfloat16`` before), falls below it."""
    from repro_torch.kernels.ref import flash_attention_ref

    H, KV, dh = 16, 2, 128
    rng = np.random.default_rng(5)
    u = rng.standard_normal(dh).astype(np.float32)
    q = (u + 0.3 * rng.standard_normal((1, S, H, dh))).astype(np.float32)
    k = (np.linspace(0, 4, S, dtype=np.float32)[None, :, None, None] * u
         + 0.3 * rng.standard_normal((1, S, KV, dh))).astype(np.float32)
    v = rng.standard_normal((1, S, KV, dh)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(card, torch.bfloat16) for a in (q, k, v))
    assert fa.flash_route(q, k, v) == "wgmma"
    for causal in (True, False):
        plain = flash_attention_ref(q, k, v, causal=causal, round_p=torch.bfloat16)
        before = dict(LAUNCHES)
        rows = fa.flash_attention_fused(q, k, v, causal=causal,
                                        round_p=torch.bfloat16)
        tiles = fa.flash_attention_fused(q, k, v, causal=causal, round_p=True)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention_wgmma"] == before["flash_attention_wgmma"] + 2
        top = float(plain.float().abs().max())
        err = float((rows.float() - plain.float()).abs().max())
        assert err <= _ulp(top), (causal, err)
        same, same_t = (float((x == plain).float().mean()) for x in (rows, tiles))
        assert same >= ROW_MAX_BITWISE > same_t, (causal, same, same_t)
