"""The tiling and order of sums of the CUDA-core flash kernel, on the CPU.

``csrc/flash_attention.cu``'s ``fa_kernel`` cannot run here, so its
arithmetic is emulated in float32 in this file (not in the port): q scaled
in fp32, each score a chain over d in index order; key tiles of
``plan_flash_simt(...).keys`` keys, causal tiles past a row tile's last
token skipped; per tile the row's max, p = exp(s - m) with masked keys at
-1e30, the row sum as the kernel takes it (each of 16 lanes sums its keys
tc, tc + 16, ... in order, then a butterfly over the 16 lanes), l = l·α +
sum, and O = O·α + p·v in key order; the output divided by max(l, 1e-30).
``plan_flash_simt`` is held to the choices the kernel makes: tiles of 64
(token, g) rows for qwen2.5-3b's served prefill, column chunks above
dh = 256, shared memory within a block's 227 KB.

Inputs are numpy seeds, at qwen2.5's SMOKE widths (H 8, KV 2, dh 8), at
qwen2.5-3b's heads (H 16, KV 2, dh 128) with S = 192, ragged and non-causal
shapes, G = 6 (what internvl2's bf16 prefill sends to this kernel) and
dh = 320.  Limit: float32 ``rtol = atol = 1e-5`` against the port's plain
version and the Pallas kernel in interpret mode, as
``tests/test_torch_attention.py`` holds them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fused as j_flash_kernel
from repro_torch.kernels.flash_attention import (SIMT_ROWS, FlashSimtPlan,
                                                 plan_flash_simt)
from repro_torch.kernels.ref import flash_attention_ref

torch.set_num_threads(1)

NEG = -1e30
SMEM_PER_BLOCK = 232448
TOL = dict(rtol=1e-5, atol=1e-5)
# (B, Sq, Sk, H, KV, dh, causal)
CASES = [(2, 64, 64, 8, 2, 8, True),
         (2, 50, 37, 8, 2, 8, False),
         (1, 70, 70, 8, 2, 8, True),
         (1, 192, 192, 16, 2, 128, True),
         (1, 40, 40, 12, 2, 64, True),
         (1, 24, 24, 4, 1, 320, True)]


def _inputs(B, Sq, Sk, H, KV, dh, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh))]


def _lane_sum(p: torch.Tensor) -> torch.Tensor:
    """Row sums of p (..., BN) as the kernel takes them: lane tc sums keys
    tc, tc + 16, ... in order, then xor-1, 2, 4, 8 butterflies."""
    n = p.shape[-1]
    lanes = torch.zeros(p.shape[:-1] + (16,))
    for j in range(n // 16):
        lanes = lanes + p[..., 16 * j:16 * j + 16]
    while lanes.shape[-1] > 1:
        lanes = lanes[..., 0::2] + lanes[..., 1::2]
    return lanes[..., 0]


def kernel_plan(q, k, v, causal: bool, plan: FlashSimtPlan) -> torch.Tensor:
    """fa_kernel's arithmetic in float32 → (B, Sq, H, dh)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, BN = H // KV, plan.keys
    rows = Sq * G
    qs = (q * dh ** -0.5).reshape(B, Sq, KV, G, dh).permute(0, 2, 1, 3, 4)
    qs = qs.reshape(B, KV, rows, dh)                  # (token, g) rows
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    s_all = torch.zeros(B, KV, rows, Sk)
    for d in range(dh):                               # one chain per score
        s_all = s_all + qs[..., d, None] * kf[..., None, :, d]
    tok = torch.arange(rows) // G
    out = torch.empty(B, KV, rows, dh)
    for r0 in range(0, rows, SIMT_ROWS):
        r1 = min(r0 + SIMT_ROWS, rows)
        kend = min(Sk, (r1 - 1) // G + 1) if causal else Sk
        m = torch.full((B, KV, r1 - r0), NEG)
        l = torch.zeros(B, KV, r1 - r0)
        acc = torch.zeros(B, KV, r1 - r0, dh)
        for j0 in range(0, kend, BN):
            nk = min(BN, Sk - j0)
            s = torch.full((B, KV, r1 - r0, BN), NEG)
            s[..., :nk] = s_all[:, :, r0:r1, j0:j0 + nk]
            if causal:
                key = j0 + torch.arange(BN)
                s = s.masked_fill(key[None, :] > tok[r0:r1, None], NEG)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + _lane_sum(p)
            acc = acc * alpha[..., None]
            for j in range(nk):                        # key order
                acc = acc + p[..., j, None] * vf[:, :, None, j0 + j]
            m = m_new
        out[:, :, r0:r1] = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, KV, Sq, G, dh).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Sq, H, dh)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,dh,causal", CASES, ids=str)
def test_simt_plan_matches_the_plain_version_and_the_pallas_kernel(
        B, Sq, Sk, H, KV, dh, causal):
    q, k, v = _inputs(B, Sq, Sk, H, KV, dh, seed=Sq + dh)
    got = kernel_plan(q, k, v, causal, plan_flash_simt(B, Sq, H, KV, dh))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(
        got, flash_attention_ref(q, k, v, causal=causal, round_p=False), **TOL)
    want = j_flash_kernel(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                          causal=causal, bq=64, bk=64)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


def test_served_prefill_plan():
    """qwen2.5-3b's 1,024-token prefill: 128 tiles of 64 (token, g) rows per
    KV head, 256 blocks of 184 KB of shared memory, one an SM."""
    plan = plan_flash_simt(1, 1024, 16, 2, 128)
    assert plan == FlashSimtPlan(dhp=128, keys=64, wide=False, col_chunks=1,
                                 tiles=128, blocks=256, smem=184320)
    assert plan.smem <= SMEM_PER_BLOCK < 2 * plan.smem
    assert plan_flash_simt(1, 100, 16, 2, 128).blocks == 26
    assert plan_flash_simt(2, 70, 8, 2, 320).blocks == 2 * 2 * 2 * 5   # B, KV, chunks, tiles


@pytest.mark.parametrize("dh", [1, 8, 64, 100, 128, 200, 256, 320, 640])
def test_plan_takes_any_head_width_in_shared_memory(dh):
    plan = plan_flash_simt(2, 300, 12, 2, dh)
    assert plan.dhp >= min(dh, 256) and plan.smem <= SMEM_PER_BLOCK
    assert plan.wide == (dh > 256)
    assert plan.col_chunks == (-(-dh // 256) if dh > 256 else 1)
    assert plan.keys in (32, 64) and plan.keys % 16 == 0
