"""The port's attention against the JAX package's, on the CPU.

The plain versions of the two attention kernels
(``repro_torch.kernels.ref.flash_attention_ref`` and
``decode_attention_ref``) are held against the Pallas kernels in interpret
mode (p rounded to v's dtype, as the TPU kernels do) and against the model's
own attention (p in fp32); ``gqa_prefill`` and ``gqa_decode`` against the JAX
functions.  Inputs come from numpy seeds.

Tolerances: float32 ``rtol = atol = 1e-5`` (measured: at most 1.2e-6 — the
port scales q before the product where the Pallas flash kernel scales the
product, and sums in another order).  bfloat16: one bf16 ulp of the largest
output magnitude (measured: half an ulp), since a value near a rounding
boundary may round either way.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode_kernel
from repro.kernels.flash_attention import flash_attention_fused as j_flash_kernel
from repro.models import attention as jatt
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_fused
from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref
from repro_torch.models import attention as tatt
from repro_torch.models.layers import rope_table

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(x).max()))) - 7)


# ------------------------------------------------------ flash (kernel 7)
@pytest.mark.parametrize("B,S,H,KV,dh", [
    (2, 64, 4, 4, 32), (1, 100, 8, 2, 64), (2, 33, 4, 1, 128), (1, 16, 2, 2, 256),
])
def test_flash_ref_matches_pallas_kernel(B, S, H, KV, dh):
    rng = np.random.default_rng(B * 1000 + S)
    q, k, v = _normal(rng, B, S, H, dh), _normal(rng, B, S, KV, dh), _normal(rng, B, S, KV, dh)
    want = j_flash_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, bq=32, bk=32)
    got = flash_attention_ref(*_t(q, k, v), causal=True, round_p=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_ref_matches_pallas_kernel_non_causal():
    rng = np.random.default_rng(40)
    q, k, v = (_normal(rng, 1, 40, 4, 32) for _ in range(3))
    want = j_flash_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, bq=16, bk=16)
    got = flash_attention_ref(*_t(q, k, v), causal=False, round_p=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_ref_rounds_p_as_the_pallas_kernel_in_bfloat16():
    rng = np.random.default_rng(7)
    q, k, v = (jnp.asarray(_normal(rng, 1, 100, 8 if i == 0 else 2, 64),
                           jnp.bfloat16) for i in range(3))
    want = np.asarray(j_flash_kernel(q, k, v, causal=True, bq=32, bk=32),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, causal=True, round_p=True)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= bf16_ulp(want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,chunk", [(37, 37, 16), (24, 40, 1024)])
def test_flash_ref_matches_model_attention(causal, Sq, Sk, chunk):
    """p in fp32: the function ``gqa_prefill`` is held against."""
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = _normal(rng, 2, Sq, 8, 16), _normal(rng, 2, Sk, 2, 16), _normal(rng, 2, Sk, 2, 16)
    want = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, kv_chunk=chunk)
    got = flash_attention_ref(*_t(q, k, v), causal=causal, round_p=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,q_offset,probs_bf16",
                         [(0, 0, False), (8, 0, False), (0, 5, False), (0, 0, True)])
def test_model_flash_and_plain_attention_match_reference(window, q_offset,
                                                         probs_bf16):
    rng = np.random.default_rng(window + q_offset)
    q, k, v = _normal(rng, 2, 29, 4, 16), _normal(rng, 2, 34, 2, 16), _normal(rng, 2, 34, 2, 16)
    J = [jnp.asarray(a) for a in (q, k, v)]
    kw = dict(causal=True, window=window, q_offset=q_offset)
    want = jatt.flash_attention(*J, kv_chunk=8, probs_bf16=probs_bf16, **kw)
    got = tatt.flash_attention(*_t(q, k, v), kv_chunk=8, probs_bf16=probs_bf16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tatt.plain_attention(*_t(q, k, v), **kw).numpy(),
                               np.asarray(jatt.plain_attention(*J, **kw)), **TOL)


def test_flash_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    q, k, v = _t(_normal(rng, 1, 20, 4, 8), _normal(rng, 1, 20, 1, 8),
                 _normal(rng, 1, 20, 1, 8))
    before = LAUNCHES["flash_attention"]
    got = flash_attention_fused(q, k, v, causal=True, round_p=False)
    assert LAUNCHES["flash_attention"] == before       # no kernel on the CPU
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True))
    with pytest.raises(ValueError, match="query heads"):
        flash_attention_fused(q[:, :, :3], k.expand(1, 20, 2, 8),
                              v.expand(1, 20, 2, 8))
    with pytest.raises(ValueError):
        flash_attention_fused(q, k[:, :, :, :4], v)


# ----------------------------------------------------- decode (kernel 8)
@pytest.mark.parametrize("B,S,H,KV,dh", [
    (2, 64, 8, 4, 32), (3, 100, 4, 1, 64), (1, 32, 16, 2, 128),
])
def test_decode_ref_matches_pallas_kernel_and_oracle(B, S, H, KV, dh):
    rng = np.random.default_rng(S)
    q, k, v = _normal(rng, B, H, dh), _normal(rng, B, S, KV, dh), _normal(rng, B, S, KV, dh)
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    lens[0], lens[-1] = 1, S
    J = [jnp.asarray(a) for a in (q, k, v, lens)]
    got = decode_attention_ref(*_t(q, k, v), torch.from_numpy(lens), round_p=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_decode_kernel(*J, bk=16)),
                               **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.decode_attention_ref(*J)),
                               **TOL)


def test_decode_ref_every_length():
    """Lengths 1 … S against the reference oracle, one sequence each."""
    rng = np.random.default_rng(11)
    S = 24
    q, k, v = _normal(rng, S, 4, 16), _normal(rng, S, S, 2, 16), _normal(rng, S, S, 2, 16)
    lens = np.arange(1, S + 1, dtype=np.int32)
    want = jref.decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v, lens)))
    got = decode_attention_ref(*_t(q, k, v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_wrapper_checks_lengths_and_runs_plain_on_cpu():
    rng = np.random.default_rng(5)
    q, k, v = _t(_normal(rng, 2, 4, 8), _normal(rng, 2, 10, 2, 8),
                 _normal(rng, 2, 10, 2, 8))
    before = LAUNCHES["decode_attention"]
    got = decode_attention(q, k, v, [3, 10], round_p=False)
    assert LAUNCHES["decode_attention"] == before
    assert torch.equal(got, decode_attention_ref(q, k, v, torch.tensor([3, 10])))
    for bad in ([0, 3], [3, 11]):
        with pytest.raises(ValueError, match="cache_len"):
            decode_attention(q, k, v, bad)
    with pytest.raises(ValueError, match="shape"):
        decode_attention(q, k, v, [1, 2, 3])


# ---------------------------------------------------------- GQA layers
def _gqa_params(rng, D=32, H=8, KV=2, dh=8):
    p = {"wq": _normal(rng, D, H, dh, scale=D ** -0.5),
         "wk": _normal(rng, D, KV, dh, scale=D ** -0.5),
         "wv": _normal(rng, D, KV, dh, scale=D ** -0.5),
         "wo": _normal(rng, H, dh, D, scale=(H * dh) ** -0.5),
         "bq": _normal(rng, H, dh, scale=0.1), "bk": _normal(rng, KV, dh, scale=0.1),
         "bv": _normal(rng, KV, dh, scale=0.1)}
    return p, {k: jnp.asarray(a) for k, a in p.items()}, dict(zip(p, _t(*p.values())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_prefill_matches_reference(dtype):
    rng = np.random.default_rng(21)
    _, pj, pt = _gqa_params(rng)
    x = _normal(rng, 2, 19, 32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(getattr(torch, dtype))
    cos, sin = rope_table(19, 8)
    yj, (kj, vj) = jatt.gqa_prefill(pj, xj, jnp.asarray(cos.numpy()),
                                    jnp.asarray(sin.numpy()), kv_chunk=8)
    yt, (kt, vt) = tatt.gqa_prefill(pt, xt, cos, sin)
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        assert got.dtype == xt.dtype
        g, w = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **TOL)
        else:
            assert np.abs(g - w).max() <= bf16_ulp(w)


def test_gqa_decode_matches_reference():
    rng = np.random.default_rng(22)
    _, pj, pt = _gqa_params(rng)
    B, S = 3, 16
    x = _normal(rng, B, 1, 32)
    kc, vc = _normal(rng, B, S, 2, 8), _normal(rng, B, S, 2, 8)
    pos = np.array([0, 7, S - 1], np.int32)
    freqs = 1.0 / (1e4 ** (np.arange(4, dtype=np.float32) / 4))
    ang = pos.astype(np.float32)[:, None] * freqs[None, :]
    cos, sin = np.cos(ang)[:, None, :], np.sin(ang)[:, None, :]
    yj, (kj, vj) = jatt.gqa_decode(pj, jnp.asarray(x), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pos),
                                   jnp.asarray(cos), jnp.asarray(sin))
    kt, vt = _t(kc, vc)
    yt, _ = tatt.gqa_decode(pt, *_t(x), kt, vt, torch.from_numpy(pos),
                            *_t(cos, sin), cache_len=torch.from_numpy(pos + 1))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    # the caches were written in place, one row per sequence
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
