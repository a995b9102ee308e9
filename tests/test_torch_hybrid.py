"""The ``hybrid`` family, sliding windows, ring caches, prefix embeddings and
bfloat16 probabilities at float32, against the JAX package, on the CPU.

* Attention: ``flash_attention_fused``'s plain path with a ``window``
  against the JAX ``flash_attention`` and ``plain_attention``;
  ``gqa_prefill`` with a window, and ``gqa_prefill``/``mla_prefill`` with
  ``probs_bf16`` at float32 (p and v rounded to bfloat16, an fp32 product),
  against the JAX functions; ``gqa_decode`` on a ring cache (``write_pos =
  pos % W``, ``valid_len = min(pos + 1, W)``) past the ring's width; a
  window on a full-length decode cache (once refused).
* zamba2-7b's SMOKE config (7 layers, a shared block after every 2 Mamba2
  layers, a tail of 1) through ``params_from_reference``:
  ``forward_full``/``forward_decode`` in float32 with a window (without a
  window in float32 and bfloat16, and the port's engine against the JAX
  engine's greedy tokens, with a window whose ring is shorter than the
  prompts: ``tests/test_torch_hybrid_serve.py``, which runs beside this
  file on another worker).
* ``prefix_embeds`` in ``forward_full`` against the JAX function, for a
  dense (internvl2), an ``ssm`` and a ``hybrid`` config.

Tolerances: float32 ``rtol = atol = 1e-5`` (measured: at most 3.6e-6 on
logits of magnitude 4).  With ``probs_bf16`` the JAX ``flash_attention``
runs one KV chunk (``kv_chunk`` >= S), so its p is rounded against the same
row maximum as the port's, but a p whose q·k was summed in another order
can round to the neighbouring bf16 value: ``atol = 2e-4`` there (measured:
5.8e-5, one such p), and the same output with p left unrounded must lie
beyond it (measured: 3.6e-3 to 5.8e-3).  bfloat16 model tensors within 8 bf16 ulps at their
largest magnitude and argmaxes at >= 90 % of positions: the Mamba2 layers
round as ``tests/test_torch_mamba2.py`` states, and the gap grows with
depth (measured: 0 ulps at the first layer's conv state, 6 at the fifth,
4.5 on the logits).  A bfloat16 decode step's logits lie within twice the
distance of the reference's own bfloat16 logits from its float32 ones, and
so do the caches after the steps (measured: the reference's gap 0.064–0.118, the port's 0.040–0.161 from
the reference's bf16 and 0.058–0.149 from its f32).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as jatt
from repro.models import transformer as jt
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.flash_attention import flash_attention_fused
from repro_torch.models import attention as tatt
from repro_torch.models.layers import rope_table
from repro_torch.models.transformer import (init_cache, init_params,
                                            params_from_reference)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "zamba2-7b"


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def bf16_ulp(x) -> float:
    return 2.0 ** (math.floor(math.log2(float(np.abs(x).max()))) - 7)


def _close(got, want, dtype="float32"):
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **TOL)
    else:
        assert np.abs(g - w).max() <= 8 * bf16_ulp(w)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("window", [1, 5, 16, 64])
@pytest.mark.parametrize("B,S,H,KV,dh", [(2, 40, 4, 4, 16), (1, 33, 8, 2, 8)])
def test_flash_window_matches_reference(B, S, H, KV, dh, window):
    rng = np.random.default_rng(window + S)
    q, k, v = _normal(rng, B, S, H, dh), _normal(rng, B, S, KV, dh), _normal(
        rng, B, S, KV, dh)
    got = flash_attention_fused(*_t(q, k, v), window=window, round_p=False)
    J = tuple(map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jatt.flash_attention(*J, window=window, kv_chunk=8)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jatt.plain_attention(*J, window=window)), **TOL)


def test_flash_wrapper_checks_window_and_rounding():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="window"):
        flash_attention_fused(q, q, q, causal=False, window=2)
    with pytest.raises(ValueError, match="window"):
        flash_attention_fused(q, q, q, window=-1)
    with pytest.raises(ValueError, match="round_p"):
        flash_attention_fused(q, q, q, round_p=torch.float16)


def _gqa_params(rng, D=32, H=8, KV=2, dh=8):
    p = {"wq": _normal(rng, D, H, dh, scale=D ** -0.5),
         "wk": _normal(rng, D, KV, dh, scale=D ** -0.5),
         "wv": _normal(rng, D, KV, dh, scale=D ** -0.5),
         "wo": _normal(rng, H, dh, D, scale=(H * dh) ** -0.5)}
    return {k: jnp.asarray(a) for k, a in p.items()}, dict(zip(p, _t(*p.values())))


@pytest.mark.parametrize("window,probs_bf16", [(4, False), (11, False),
                                               (0, True), (6, True)])
def test_gqa_prefill_window_and_bf16_probs_match_reference(window, probs_bf16):
    """float32 activations; ``probs_bf16`` rounds p and v to bfloat16 for
    the P·V product, as the reference does."""
    rng = np.random.default_rng(31 + window)
    pj, pt = _gqa_params(rng)
    x = _normal(rng, 2, 23, 32)
    cos, sin = rope_table(23, 8)
    yj, (kj, vj) = jatt.gqa_prefill(pj, jnp.asarray(x), jnp.asarray(cos.numpy()),
                                    jnp.asarray(sin.numpy()), window=window,
                                    probs_bf16=probs_bf16)
    yt, (kt, vt) = tatt.gqa_prefill(pt, *_t(x), cos, sin, window=window,
                                    probs_bf16=probs_bf16)
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=2e-4 if probs_bf16 else 1e-5)
    if probs_bf16:
        # p left unrounded lies beyond the limit (measured: 3.9e-3, 5.8e-3)
        y32, _ = tatt.gqa_prefill(pt, *_t(x), cos, sin, window=window)
        assert np.abs(y32.numpy() - np.asarray(yj)).max() > 2e-4


@pytest.mark.parametrize("B,S", [(1, 9), (2, 20)])
def test_mla_prefill_bf16_probs_at_float32_matches_reference(B, S):
    cfg = j_get_arch("deepseek-v2-236b").smoke
    tree = jax.tree.map(np.array, jt.init_params(cfg, jax.random.key(1)))
    attn = {k: v[0] for k, v in tree["blocks"]["attn"].items()}
    rng = np.random.default_rng(S)
    x = _normal(rng, B, S, cfg.d_model)
    cos, sin = rope_table(S, cfg.d_rope)
    yj, cj = jatt.mla_prefill({k: jnp.asarray(v) for k, v in attn.items()},
                              jnp.asarray(x), jnp.asarray(cos.numpy()),
                              jnp.asarray(sin.numpy()), probs_bf16=True)
    yt, ct = tatt.mla_prefill(dict(zip(attn, _t(*attn.values()))), *_t(x), cos,
                              sin, probs_bf16=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=2e-4)
    for got, want in zip(ct, cj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # p left unrounded lies beyond the limit (measured: 4.9e-3, 3.6e-3)
    y32, _ = tatt.mla_prefill(dict(zip(attn, _t(*attn.values()))), *_t(x), cos,
                              sin)
    assert np.abs(y32.numpy() - np.asarray(yj)).max() > 2e-4


def test_gqa_decode_on_a_ring_cache_matches_reference():
    """A ring of width 6 written at ``pos % 6`` and attended over
    ``min(pos + 1, 6)`` slots, at positions before, at and past its width."""
    rng = np.random.default_rng(41)
    pj, pt = _gqa_params(rng)
    B, W = 4, 6
    kc, vc = _normal(rng, B, W, 2, 8), _normal(rng, B, W, 2, 8)
    pos = np.array([0, 5, 6, 23], np.int32)
    wpos, vlen = pos % W, np.minimum(pos + 1, W)
    x = _normal(rng, B, 1, 32)
    freqs = 1.0 / (1e4 ** (np.arange(4, dtype=np.float32) / 4))
    ang = pos.astype(np.float32)[:, None] * freqs[None, :]
    cos, sin = np.cos(ang)[:, None, :], np.sin(ang)[:, None, :]
    yj, (kj, vj) = jatt.gqa_decode(pj, jnp.asarray(x), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pos),
                                   jnp.asarray(cos), jnp.asarray(sin),
                                   write_pos=jnp.asarray(wpos),
                                   valid_len=jnp.asarray(vlen))
    kt, vt = _t(kc, vc)
    yt, _ = tatt.gqa_decode(pt, *_t(x), kt, vt, torch.from_numpy(pos),
                            *_t(cos, sin), write_pos=torch.from_numpy(wpos),
                            valid_len=torch.from_numpy(vlen))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)


def test_gqa_decode_window_on_a_full_length_cache_raises():
    """Formerly refused; since the decode kernel takes each row's start, a
    window on a full-length cache is the reference's: keys (pos − W, pos]
    (``tests/test_torch_window_decode.py`` holds the engines)."""
    rng = np.random.default_rng(43)
    pj, pt = _gqa_params(rng)
    x = _normal(rng, 2, 1, 32)
    kc, vc = _normal(rng, 2, 9, 2, 8), _normal(rng, 2, 9, 2, 8)
    pos = np.array([1, 7], np.int32)
    cos = np.ones((2, 1, 4), np.float32)
    sin = np.zeros((2, 1, 4), np.float32)
    yj, _ = jatt.gqa_decode(pj, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(pos), jnp.asarray(cos), jnp.asarray(sin),
                            window=2)
    yt, _ = tatt.gqa_decode(pt, *_t(x, kc, vc), torch.from_numpy(pos),
                            *_t(cos, sin), window=2)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


# ----------------------------------------------------------- the family
@functools.lru_cache(maxsize=None)
def _tree(arch: str, seed: int = 0):
    tree = jax.tree.map(np.array, jt.init_params(j_get_arch(arch).smoke,
                                                 jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    ssm = tree["blocks"].get("ssm", {})
    for name in ("A_log", "D", "dt_bias"):
        if name in ssm:
            base = 1.0 if name == "D" else 0.0
            ssm[name] = (base + 0.3 * rng.standard_normal(ssm[name].shape)
                         ).astype(np.float32)
    return tree


def _models(arch=ARCH, **change):
    cfg_j = dataclasses.replace(j_get_arch(arch).smoke, **change)
    cfg = dataclasses.replace(get_arch(arch).smoke, **change)
    tree = _tree(arch)
    return (cfg_j, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_reference(tree, cfg, "cpu"))


def _prefill_caches(model, cfg, pj, cfg_j, toks, lens, S):
    """Caches of B sequences, sequence b prefilled with its first lens[b]
    tokens alone (a state integrates every position), in both packages."""
    cache_t = init_cache(cfg, len(lens), S, device="cpu")
    cache_j = jt.init_cache(cfg_j, len(lens), S)
    for b, n in enumerate(lens):
        _, cj, _ = jt.forward_full(pj, cfg_j, jnp.asarray(toks[b:b + 1, :n]),
                                   return_cache=True)
        _, ct, _ = model.forward_full(toks[b:b + 1, :n], return_cache=True)
        for key in cache_t:
            if key in ("k", "v"):
                win = cache_t[key].shape[2]
                idx = np.arange(max(0, n - win), n)
                cache_t[key][:, b, idx % win] = ct[key][:, 0, idx]
                cache_j[key] = cache_j[key].at[:, b, idx % win].set(cj[key][:, 0, idx])
            else:
                cache_t[key][:, b] = ct[key][:, 0]
                cache_j[key] = cache_j[key].at[:, b].set(cj[key][:, 0])
    return cache_t, cache_j


@pytest.mark.parametrize("dtype,window", [("float32", 8)])
def test_forward_full_and_decode_match_reference(dtype, window):
    """With ``attn_window = 8`` the shared cache is a ring of 8 slots and
    the decode steps run past it (without a window, in float32 and
    bfloat16: ``tests/test_torch_hybrid_serve.py``)."""
    forward_and_decode(dtype, window)


def forward_and_decode(dtype: str, window: int) -> None:
    """zamba2's SMOKE ``forward_full`` (logits, caches) and 4 decode steps
    from per-sequence prefills against the JAX package's."""
    cfg_j, pj, cfg, model = _models(act_dtype=dtype, attn_window=window)
    rng = np.random.default_rng(9)
    B, S = 2, 24
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lj, cj, _ = jt.forward_full(pj, cfg_j, jnp.asarray(toks), return_cache=True)
    lt, ct, _ = model.forward_full(toks, return_cache=True)
    _close(lt, lj, dtype)
    if dtype == "bfloat16":
        assert (lt.numpy().argmax(-1) == np.asarray(lj).argmax(-1)).mean() >= 0.9
    assert set(ct) == set(cj) == {"h", "conv_x", "conv_b", "conv_c", "k", "v"}
    assert ct["k"].shape == (cfg.hybrid_groups, B, S, cfg.n_kv_heads,
                             2 * cfg.d_model // cfg.n_heads)
    for key in ct:
        _close(ct[key], cj[key], dtype)

    pos = np.array([13, 9], np.int32)
    cache_t, cache_j = _prefill_caches(model, cfg, pj, cfg_j, toks, pos, S)
    assert cache_t["k"].shape[2] == (window or S)
    if dtype == "bfloat16":                 # the reference's own f32 steps
        cfg_f = dataclasses.replace(cfg_j, act_dtype="float32")
        _, cache_f = _prefill_caches(model, cfg, pj, cfg_f, toks, pos, S)
    for _ in range(4):
        tok = toks[np.arange(B), pos]
        dj, cache_j = jt.forward_decode(pj, cfg_j, jnp.asarray(tok), cache_j,
                                        jnp.asarray(pos))
        dt, cache_t = model.forward_decode(tok, cache_t, pos)
        if dtype == "float32":
            _close(dt, dj)
        else:
            df, cache_f = jt.forward_decode(pj, cfg_f, jnp.asarray(tok), cache_f,
                                            jnp.asarray(pos))
            gap = float(np.abs(np.asarray(dj) - np.asarray(df)).max())
            assert float(np.abs(dt.numpy() - np.asarray(dj)).max()) <= 2 * gap
        pos = pos + 1
    for key in cache_t:
        if dtype == "float32":
            _close(cache_t[key], cache_j[key])
        else:
            j = np.asarray(cache_j[key], np.float32)
            gap = float(np.abs(j - np.asarray(cache_f[key], np.float32)).max())
            assert float(np.abs(cache_t[key].float().numpy() - j).max()) <= 2 * gap


def test_decode_makes_one_ring_slot_and_length_for_every_application(monkeypatch):
    """The ring's slot and valid length are made once a step, with the
    positions, and every shared application attends with the same
    ``valid_len`` tensor, equal to min(pos + 1, W)."""
    _, _, cfg, model = _models(attn_window=8)
    caches = init_cache(cfg, 2, 32, device="cpu")
    seen = []
    real = tatt.decode_attention

    def spy(q, k, v, cache_len, **kw):
        seen.append(cache_len)
        return real(q, k, v, cache_len, **kw)

    monkeypatch.setattr(tatt, "decode_attention", spy)
    model.forward_decode(np.array([1, 2]), caches, np.array([3, 20], np.int32))
    assert len(seen) == cfg.hybrid_groups > 1
    assert all(t is seen[0] for t in seen) and seen[0].tolist() == [4, 8]
    with pytest.raises(ValueError, match="outside"):
        model.forward_decode(np.array([1, 2]), caches, np.array([-1, 2]))


@pytest.mark.parametrize("arch", ["internvl2-26b", "mamba2-1.3b", ARCH])
def test_prefix_embeddings_match_reference(arch):
    """A (B, Np, D) prefix before the tokens, every family: logits and
    caches over Np + S positions."""
    cfg_j, pj, cfg, model = _models(arch)
    rng = np.random.default_rng(2)
    Np = cfg.vision_prefix_len or 6
    prefix = _normal(rng, 2, Np, cfg.d_model, scale=0.02)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    lj, cj, _ = jt.forward_full(pj, cfg_j, jnp.asarray(toks),
                                prefix_embeds=jnp.asarray(prefix), return_cache=True)
    lt, ct, _ = model.forward_full(toks, prefix_embeds=torch.from_numpy(prefix),
                                   return_cache=True)
    assert lt.shape == (2, Np + 11, cfg.padded_vocab)
    _close(lt, lj)
    for key in ct:
        _close(ct[key], cj[key])


def test_random_init_has_the_shared_block_and_the_reference_order():
    """``init_params``: 5 Mamba2 layers and one shared block at 2 · d_model,
    unit norms; the state caches' layer axis is the reference's (the
    groups' layers, then the tail)."""
    cfg = get_arch(ARCH).smoke
    model = init_params(cfg, 0, "cpu")
    assert len(model.blocks) == cfg.n_mamba_layers == 5
    sa = model.shared_attn
    assert sa.attn["wq"].shape == (64, 4, 16) and sa.out.shape == (64, 32)
    assert torch.equal(sa.norm2, torch.ones(64))
    assert model._hybrid_layout() == [(0, 2), (2, 2), (4, 1)]
