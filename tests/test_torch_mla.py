"""The port's multi-head latent attention (MLA) against the JAX package's, on
the CPU.

``mla_prefill`` (its output and both latent caches) and ``mla_decode`` (its
output and the caches written in place) at deepseek-v2's SMOKE widths (D 64,
H 4, kv_lora 32, q_lora 24 or none, d_head 16, d_rope 8), with the weights
of the reference's ``init_mla`` and inputs from numpy seeds.  Then the
route prefill takes through the flash kernel: v zero-padded from ``dn`` to
``dn + dr`` columns, the flash kernel's plain version, the first ``dn``
columns kept, against ``plain_attention`` with v of width ``dn`` and the
scale ``(dn + dr) ** -0.5``.

Tolerance: float32 ``rtol = atol = 1e-5`` (measured: at most 9.5e-7 on the
prefill output, 5.4e-7 on the padded route against ``plain_attention``,
which sums in another order; the padded columns come out exactly zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro.models.layers import Initializer, rope_table as j_rope_table
from repro_torch.kernels.flash_attention import flash_attention_fused
from repro_torch.models import attention as tatt
from repro_torch.models.layers import rope_table

TOL = dict(rtol=1e-5, atol=1e-5)
D, H, R, DN, DR = 64, 4, 32, 16, 8


def _params(rq, seed=0):
    p = jatt.init_mla(Initializer(jax.random.key(seed)), D, H, kv_lora_rank=R,
                      q_lora_rank=rq, d_head=DN, d_rope=DR)
    rng = np.random.default_rng(seed)
    for n in ("norm_kv", "norm_q"):       # non-trivial norm weights
        if n in p:
            p[n] = jnp.asarray(1 + 0.1 * rng.standard_normal(p[n].shape),
                               jnp.float32)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


@pytest.mark.parametrize("rq", [24, 0])
def test_init_mla_has_the_reference_leaves(rq):
    pj, _ = _params(rq)
    pt = tatt.init_mla(torch.Generator().manual_seed(0), D, H, kv_lora_rank=R,
                       q_lora_rank=rq, d_head=DN, d_rope=DR)
    assert {k: tuple(v.shape) for k, v in pt.items()} == \
        {k: tuple(v.shape) for k, v in pj.items()}


@pytest.mark.parametrize("rq", [24, 0])
@pytest.mark.parametrize("B,S", [(1, 9), (2, 24)])
def test_mla_prefill_matches_reference(B, S, rq):
    pj, pt = _params(rq, seed=S)
    x = _x(B, S, seed=B)
    cj, sj = j_rope_table(S, DR, 1e4)
    ct, st = rope_table(S, DR, 1e4)
    yj, (ckv_j, kr_j) = jatt.mla_prefill(pj, jnp.asarray(x), cj, sj, kv_chunk=8)
    for plain in (False, True):
        yt, (ckv_t, kr_t) = tatt.mla_prefill(pt, torch.from_numpy(x), ct, st,
                                             plain=plain)
        assert yt.shape == (B, S, D) and ckv_t.shape == (B, S, R)
        assert kr_t.shape == (B, S, DR)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(ckv_t.numpy(), np.asarray(ckv_j), **TOL)
        np.testing.assert_allclose(kr_t.numpy(), np.asarray(kr_j), **TOL)


@pytest.mark.parametrize("rq", [24, 0])
def test_mla_decode_matches_reference(rq):
    pj, pt = _params(rq, seed=3)
    B, S = 3, 20
    rng = np.random.default_rng(4)
    ckv = rng.standard_normal((B, S, R)).astype(np.float32)
    kr = rng.standard_normal((B, S, DR)).astype(np.float32)
    pos = np.array([0, 7, S - 1], np.int32)
    x = _x(B, 1, seed=5)
    freqs = 1.0 / (1e4 ** (np.arange(DR // 2, dtype=np.float32) / (DR // 2)))
    ang = pos[:, None].astype(np.float32) * freqs[None, :]
    cos, sin = np.cos(ang)[:, None, :], np.sin(ang)[:, None, :]
    yj, (ckv_j, kr_j) = jatt.mla_decode(pj, jnp.asarray(x), jnp.asarray(ckv),
                                        jnp.asarray(kr), jnp.asarray(pos),
                                        jnp.asarray(cos), jnp.asarray(sin))
    ckv_t, kr_t = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    for cache_len in (None, torch.from_numpy(pos + 1)):
        yt, (c0, c1) = tatt.mla_decode(pt, torch.from_numpy(x), ckv_t, kr_t,
                                       torch.from_numpy(pos), torch.from_numpy(cos),
                                       torch.from_numpy(sin), cache_len=cache_len)
        assert c0 is ckv_t and c1 is kr_t          # written in place
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(ckv_t.numpy(), np.asarray(ckv_j), **TOL)
        np.testing.assert_allclose(kr_t.numpy(), np.asarray(kr_j), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S", [(1, 1), (2, 17), (1, 64)])
def test_zero_padded_v_through_the_flash_plain_version(B, S, causal):
    rng = np.random.default_rng(S)
    q = torch.from_numpy(rng.standard_normal((B, S, H, DN + DR)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, H, DN + DR)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, H, DN)).astype(np.float32))
    got = flash_attention_fused(q, k, torch.nn.functional.pad(v, (0, DR)),
                                causal=causal, round_p=False)
    assert torch.equal(got[..., DN:], torch.zeros_like(got[..., DN:]))
    want = tatt.plain_attention(q, k, v, causal=causal,
                                scale=(DN + DR) ** -0.5)
    np.testing.assert_allclose(got[..., :DN].numpy(), want.numpy(), **TOL)
    # and against the reference's own streaming attention with v of width dn
    ref = jatt.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()), causal=causal, kv_chunk=8,
                               scale=(DN + DR) ** -0.5)
    np.testing.assert_allclose(got[..., :DN].numpy(), np.asarray(ref), **TOL)
