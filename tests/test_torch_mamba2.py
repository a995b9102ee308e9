"""The port's Mamba2 block and the ``ssm`` family against the JAX package's,
on the CPU.

``ssd_chunked`` against the port's sequential twin
(``repro_torch.kernels.ref.mamba2_ssd_ref``) and against the JAX
``ssd_chunked``, with an initial state, S not a multiple of the chunk and
S below it; ``mamba2_prefill``/``mamba2_decode`` against the JAX functions
with prompts of 1, 2, 3 and 17 tokens (the conv states are left-padded
below ``conv_width − 1``); mamba2-1.3b's SMOKE ``forward_full`` and
``forward_decode`` through ``params_from_reference`` (``A_log``, ``D``,
``dt_bias`` and the biases set to random values first, so their paths are
exercised) in float32 and bfloat16; and the port's engine, which prefills
the exact prompt length, against the JAX engine's greedy tokens.  Inputs
come from numpy seeds.

Tolerances: float32 ``rtol = atol = 1e-5`` (measured: at most 1.9e-6 on
logits of magnitude 4); the chunked scan against the sequential one at
1e-5 of the largest |y|, and so against the JAX ``ssd_chunked`` (the JAX
package's own chunked-vs-sequential gap at B 1, S 1024, H 8, P 64, N 128 is
2.7e-6 of it), the final states at 1e-5 of their largest magnitude.
bfloat16: activations round after every product, conv tap and residual, at
places that agree between the two frameworks but on values XLA computes
with excess precision, so logits agree within 4 bf16 ulps at their largest
magnitude (measured: 3.1 ulps, 0.048 at 3.7) and argmaxes at >= 90 % of
positions.
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
from repro.kernels import ref as jref
from repro.models import mamba2 as jm
from repro.models import transformer as jt
from repro.models.layers import Initializer
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.ref import mamba2_ssd_ref
from repro_torch.models import mamba2 as tm
from repro_torch.models.transformer import (SSM_KEYS, init_cache, init_params,
                                            params_from_reference)
from repro_torch.serve.engine import ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "mamba2-1.3b"


def _ssd_inputs(rng, B, S, H, P, N):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = -np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.5
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, a, b, c


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def bf16_ulp(x) -> float:
    return 2.0 ** (math.floor(math.log2(float(np.abs(x).max()))) - 7)


# ---------------------------------------------------------------- the scan
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 32, 4, 8, 8, 8),          # S a multiple of the chunk
    (1, 37, 3, 4, 16, 8),         # a ragged last chunk
    (2, 5, 2, 8, 4, 16),          # S below the chunk
    (1, 1, 2, 4, 4, 8),           # one step
    (1, 128, 8, 64, 128, 64)])    # mamba2's head, state and a 2-chunk scan
def test_ssd_chunked_matches_sequential_twin_and_reference(B, S, H, P, N, chunk):
    x, a, b, c = _ssd_inputs(np.random.default_rng(S + H), B, S, H, P, N)
    y, h = tm.ssd_chunked(*_t(x, a, b, c), chunk=chunk)
    seq = mamba2_ssd_ref(*_t(x, a, b, c))
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    assert y.dtype == h.dtype == torch.float32
    scale = float(seq.abs().max())
    assert float((y - seq).abs().max()) <= 1e-5 * scale
    yj, hj = jm.ssd_chunked(*map(jnp.asarray, (x, a, b, c)), chunk=chunk)
    hj = np.asarray(hj)
    assert float(np.abs(y.numpy() - np.asarray(yj)).max()) <= 1e-5 * scale
    assert float(np.abs(h.numpy() - hj).max()) <= 1e-5 * float(np.abs(hj).max())
    # the twin is the reference's oracle
    np.testing.assert_allclose(
        seq.numpy(), np.asarray(jref.mamba2_ssd_ref(*map(jnp.asarray, (x, a, b, c)))),
        rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("S,split,chunk", [(40, 17, 8), (24, 8, 8), (9, 3, 16)])
def test_ssd_chunked_carries_an_initial_state(S, split, chunk):
    """From ``h0``: against the JAX function, and a sequence cut in two
    (the second part started from the first's final state) gives the whole
    sequence's outputs and state."""
    rng = np.random.default_rng(S)
    x, a, b, c = _ssd_inputs(rng, 2, S, 3, 4, 8)
    h0 = rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
    y, h = tm.ssd_chunked(*_t(x, a, b, c), chunk=chunk, h0=torch.from_numpy(h0))
    yj, hj = jm.ssd_chunked(*map(jnp.asarray, (x, a, b, c)), chunk=chunk,
                            h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **TOL)
    whole, h_whole = tm.ssd_chunked(*_t(x, a, b, c), chunk=chunk)
    parts = [arr[:, :split] for arr in (x, a, b, c)]
    rest = [arr[:, split:] for arr in (x, a, b, c)]
    y1, h1 = tm.ssd_chunked(*_t(*parts), chunk=chunk)
    y2, h2 = tm.ssd_chunked(*_t(*rest), chunk=chunk, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), whole, **TOL)
    torch.testing.assert_close(h2, h_whole, **TOL)


def test_ssd_chunked_masks_the_decay_before_it_overflows():
    """Strong decays make exp(A_t − A_s) overflow above the diagonal; the
    mask selects it away, so nothing is inf or NaN and the sequential twin
    agrees."""
    rng = np.random.default_rng(7)
    x, _, b, c = _ssd_inputs(rng, 1, 16, 2, 4, 4)
    a = np.full((1, 16, 2), -30.0, np.float32)
    y, h = tm.ssd_chunked(*_t(x, a, b, c), chunk=16)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, mamba2_ssd_ref(*_t(x, a, b, c)), **TOL)


def test_ssd_chunked_gradient_stays_finite_where_the_decay_overflows():
    """Strong decays in the backward: the exponent is masked before exp,
    so no zero gradient meets exp's inf above the diagonal (a mask after
    exp gives NaN there), and every input's gradient agrees with autograd
    through the sequential twin within 1e-4 of its largest magnitude: the
    exponents are differences of fp32 running sums of up to 140, each off
    by about 2^-24 of that (measured: 7.5e-6 on a's gradient, 4e-7 on the
    others')."""
    rng = np.random.default_rng(8)
    x, _, b, c = _ssd_inputs(rng, 1, 64, 2, 4, 4)
    # 3 to 4.5 a step: A_t - A_s reaches 93-140 above a chunk's diagonal
    a = (-3.0 - 1.5 * rng.random((1, 64, 2))).astype(np.float32)
    g = rng.standard_normal((1, 64, 2, 4)).astype(np.float32)
    grads = []
    for f in (functools.partial(tm.ssd_chunked, chunk=32), mamba2_ssd_ref):
        ins = [t.requires_grad_() for t in _t(x, a, b, c)]
        y = f(*ins)
        y = y[0] if isinstance(y, tuple) else y
        grads.append(torch.autograd.grad(y, ins, torch.from_numpy(g)))
    for name, got, want in zip("xabc", *grads):
        assert bool(torch.isfinite(got).all()), name
        top = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * top)


# ------------------------------------------------------------- the block
@functools.lru_cache(maxsize=None)
def _block(d_model=32, d_state=8, head_dim=8, seed=0):
    p = jm.init_mamba2(Initializer(jax.random.key(seed)), d_model,
                       d_state=d_state, head_dim=head_dim)
    p = {k: np.array(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    for name in ("A_log", "D", "dt_bias", "conv_x_b", "conv_b_b", "conv_c_b",
                 "norm"):
        base = 1.0 if name in ("D", "norm") else 0.0
        p[name] = (base + 0.3 * rng.standard_normal(p[name].shape)).astype(np.float32)
    return p


def test_init_mamba2_has_the_reference_leaves():
    gen = torch.Generator().manual_seed(0)
    got = tm.init_mamba2(gen, 32, d_state=8, head_dim=8, dtype=torch.bfloat16)
    want = jm.init_mamba2(Initializer(jax.random.key(0)), 32, d_state=8,
                          head_dim=8, dtype=jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} \
        == {k: (tuple(v.shape), v.dtype.name) for k, v in want.items()}
    assert torch.equal(got["D"], torch.ones(8)) and not got["A_log"].any()
    assert abs(float(got["conv_x_w"].float().std()) - 0.1) < 0.02


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_conv_steps_equal_the_prefill_conv_bitwise(dtype):
    """Stepping the depthwise conv one input at a time from a zero state
    against the JAX ``_conv_step``.  Both sum the taps in float32 and round
    once: in bfloat16 the port's step equals the reference's einsum followed
    by the port's bias and SiLU bit for bit, and the reference's whole step
    within 2 ulps of each element (XLA adds the bias and applies SiLU at
    excess precision; measured: 2).  float32 within ``TOL``, as is the
    prefill conv's output.  The state holds the newest W − 1 inputs."""
    g = torch.Generator().manual_seed(3)
    u = torch.randn((2, 9, 16), generator=g).to(dtype)
    w = (0.1 * torch.randn((4, 16), generator=g)).to(dtype)
    bias = (0.1 * torch.randn((16,), generator=g)).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    wj, bj, uj = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (w, bias, u))
    state, sj = torch.zeros((2, 3, 16), dtype=dtype), jnp.zeros((2, 3, 16), jdt)
    steps = []
    for t in range(9):
        taps = jnp.einsum("bwc,wc->bc", jnp.concatenate([sj, uj[:, t:t + 1]], 1), wj)
        got = tm._conv_step(w, bias, state, u[:, t:t + 1])
        want, sj = jm._conv_step(wj, bj, sj, uj[:, t:t + 1])
        want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
        if dtype == torch.bfloat16:
            taps = torch.from_numpy(np.asarray(taps.astype(jnp.float32))).to(dtype)
            assert torch.equal(got[:, 0], tm._silu(taps + bias))
            ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)
            assert bool(((got.float() - want).abs() <= 2 * ulp).all())
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        steps.append(got)
    assert torch.equal(state, u[:, -3:])
    if dtype == torch.float32:
        np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(),
                                   tm._causal_conv(w, bias, u).numpy(), **TOL)


@pytest.mark.parametrize("S", [1, 2, 3, 17])
def test_prefill_and_decode_match_reference(S):
    """A prompt of S tokens through ``mamba2_prefill``, then three decode
    steps from its states; the conv states of a prompt shorter than
    ``conv_width − 1`` are left-padded with zeros, as the reference's."""
    p = _block()
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = dict(zip(p, _t(*p.values())))
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S + 3, 32)).astype(np.float32)
    yj, stj = jm.mamba2_prefill(pj, jnp.asarray(x[:, :S]), chunk=8)
    yt, stt = tm.mamba2_prefill(pt, torch.from_numpy(x[:, :S]), chunk=8)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for got, want in zip(stt, stj):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if S < 3:
        assert not stt[1][:, :3 - S].any()
    state = tuple(t.clone() for t in stt)
    for i in range(S, S + 3):
        yj, stj = jm.mamba2_decode(pj, jnp.asarray(x[:, i:i + 1]), stj)
        yt, out = tm.mamba2_decode(pt, torch.from_numpy(x[:, i:i + 1]), state)
        assert all(a is b for a, b in zip(out, state))      # in place
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        for got, want in zip(state, stj):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------- the family
@functools.lru_cache(maxsize=None)
def _tree(seed: int = 0):
    tree = jax.tree.map(np.array, jt.init_params(j_get_arch(ARCH).smoke,
                                                 jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    ssm = tree["blocks"]["ssm"]
    for name in ("A_log", "D", "dt_bias", "conv_x_b", "conv_b_b", "conv_c_b"):
        base = 1.0 if name == "D" else 0.0
        ssm[name] = (base + 0.3 * rng.standard_normal(ssm[name].shape)
                     ).astype(np.float32)
    return tree


def _models(act_dtype="float32"):
    cfg_j = dataclasses.replace(j_get_arch(ARCH).smoke, act_dtype=act_dtype)
    cfg = dataclasses.replace(get_arch(ARCH).smoke, act_dtype=act_dtype)
    tree = _tree()
    return (cfg_j, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_reference(tree, cfg, "cpu"))


def _close(got, want, dtype):
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **TOL)
    else:
        assert np.abs(g - w).max() <= 4 * bf16_ulp(w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_full_and_decode_match_reference(dtype):
    cfg_j, pj, cfg, model = _models(dtype)
    rng = np.random.default_rng(5)
    B, S, P = 2, 20, 13
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lj, cj, _ = jt.forward_full(pj, cfg_j, jnp.asarray(toks), return_cache=True)
    lt, ct, aux = model.forward_full(toks, return_cache=True)
    assert lt.dtype == torch.float32 and float(aux) == 0.0
    _close(lt, lj, dtype)
    if dtype == "bfloat16":
        assert (lt.numpy().argmax(-1) == np.asarray(lj).argmax(-1)).mean() >= 0.9
    assert set(ct) == set(cj) == set(SSM_KEYS)
    assert ct["h"].dtype == torch.float32 and ct["conv_x"].dtype == cfg.adt
    for key in ct:
        _close(ct[key], cj[key], dtype)

    # three decode steps from the first P tokens' states
    _, cj, _ = jt.forward_full(pj, cfg_j, jnp.asarray(toks[:, :P]), return_cache=True)
    _, ct, _ = model.forward_full(toks[:, :P], return_cache=True)
    caches = init_cache(cfg, B, S, device="cpu")
    assert {k: tuple(v.shape) for k, v in caches.items()} == \
        {k: tuple(v.shape) for k, v in jt.init_cache(cfg_j, B, S).items()}
    for key in caches:
        caches[key].copy_(ct[key])
    pos = np.array([P, P], np.int32)
    for i in range(P, P + 3):
        dj, cj = jt.forward_decode(pj, cfg_j, jnp.asarray(toks[:, i]), cj,
                                   jnp.asarray(pos))
        dt, out = model.forward_decode(toks[:, i], caches, pos)
        assert out is caches
        _close(dt, dj, dtype)
        pos = pos + 1
    for key in caches:
        _close(caches[key], cj[key], dtype)


def test_engine_prefills_exact_lengths_and_matches_the_jax_engine(monkeypatch):
    """Prompts of 1, 2, 3 and 17 tokens: the port's engine runs each
    prefill at the prompt's own length (no padding reaches the state) and
    serves the JAX engine's greedy tokens."""
    cfg_j, pj, cfg, model = _models()
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in (1, 2, 3, 17)]
    ref = JServeEngine(cfg_j, pj, max_batch=3, max_len=64)
    eng = ServeEngine(cfg, model, max_batch=3, max_len=64, device="cpu")
    for p in prompts:
        ref.submit(p, max_new_tokens=6)
        eng.submit(p, max_new_tokens=6)
    want = [r.tokens for r in ref.run_to_completion()]
    seen = []
    real = model.forward_full

    def spy(tokens, **kw):
        seen.append(np.asarray(tokens).shape[1])
        return real(tokens, **kw)

    monkeypatch.setattr(model, "forward_full", spy)
    assert [r.tokens for r in eng.run_to_completion()] == want
    assert seen == [1, 2, 3, 17]


def test_decode_copies_the_tokens_once_and_reads_no_position(monkeypatch):
    """An ``ssm`` decode step reads no position: the tokens are its one
    host-to-device copy (here a ``.to`` of the stacked tokens), and the
    state caches are updated in place."""
    cfg = get_arch(ARCH).smoke
    model = init_params(cfg, 0, "cpu")
    caches = init_cache(cfg, 2, 8, device="cpu")
    before = {k: v.clone() for k, v in caches.items()}
    ptrs = {k: v.data_ptr() for k, v in caches.items()}
    logits, out = model.forward_decode(np.array([3, 4]), caches, pos=None)
    assert logits.shape == (2, cfg.padded_vocab) and out is caches
    assert {k: v.data_ptr() for k, v in caches.items()} == ptrs
    assert all(not torch.equal(before[k], caches[k]) for k in ("h", "conv_x"))
