"""Training with ``attn_probs_bf16``: the gradient of attention whose P·V
takes p rounded to bfloat16, against ``jax.grad`` of the reference, on the
CPU.

The reference's ``flash_attention(..., probs_bf16=True)`` rounds p = e^(s −
m) and v to bfloat16 for P·V (``repro/models/attention.py``), with m the
row's running max; with one KV chunk (the training cells' ``kv_chunk >=
S``) m is the row max.  The rounding is relative to m, so the function is
not shift-invariant: ``jax.grad`` flows through m into each row's argmax
key (ties split evenly, as the gradient of ``max`` does).  The port's
plain version (``kernels.ref._softmax_pv``) keeps the max attached when p
is rounded, and autograd through it is the oracle the card's backward
kernels are held to.  Held here, inputs from numpy seeds:

* the plain gradient against ``jax.vjp`` within ``1e-5`` of each
  gradient's largest magnitude (float32; dv, which both round to bfloat16
  as the reference's cast of v does, within one bfloat16 ulp of it) at
  shapes where XLA's and torch's ``exp`` give every p the same bfloat16
  rounding (checked in the test: where one p rounds the other way the two
  gradients part by that rounding), for GQA, MLA's zero-padded v and keys
  tied at the max.  A plain version that detaches the max (right only
  for fp32 p) puts dq 3.0e-3 to 4.4e-3 of its largest off, and fails it;
* wider shapes, float32 and bfloat16, a window, within two bfloat16 ulps of
  each gradient's largest magnitude (``FLASH_BWD_BF16_ULPS``): the
  reference rounds dV to bfloat16, and roundings of p that the two
  ``exp`` implementations flip move the gradients by about one ulp of p;
* the card's float32 limit for the rounded-p kernels (``1e-3`` of each
  gradient's largest) at the card's shapes: both faults it must catch, the
  fp32-p gradient and a detached max, lie beyond it;
* the model's route: ``gqa_prefill``/``mla_prefill`` under autograd with
  ``probs_bf16`` (formerly refused) equal to autograd through the plain
  version, and ``flash_attention_train(round_p=torch.bfloat16)`` on CPU
  tensors the plain version itself;
* ``lm_loss`` and every parameter's gradient of the SMOKE qwen2.5-3b and
  deepseek-v2-236b (MLA) with ``attn_probs_bf16`` against
  ``jax.value_and_grad`` of the reference's: loss ``rtol = 1e-4``,
  gradients within two bfloat16 ulps of each leaf's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as jatt
from repro.models import transformer as jt
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import (_flash_scores, flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.models import attention as tatt
from repro_torch.models import transformer as tt
from repro_torch.models.layers import rope_table
from repro_torch.train.train_loop import _master_tree

torch.set_num_threads(1)

FLASH_BWD_BF16_ULPS = 2
BF16 = torch.bfloat16


def _ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _inputs(B, S, H, KV, dh, dhv, seed, tie=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dhv)).astype(np.float32)
    g = rng.standard_normal((B, S, H, dhv)).astype(np.float32)
    if tie:   # keys 3 and 5 alike, the max of every row from token 5 on
        # dyadic q (1/8) and k (1/4), dh 16 (scale 1/4): every score is
        # exact, so the tie holds in any order of summation
        u = np.sign(rng.standard_normal(dh)).astype(np.float32)
        k = np.round(4 * k) / 4
        k[:, 3] = k[:, 5] = 2.0 * u
        q = np.round(8 * q) / 8
        q[:, 5:] += u
    return q, k, v, g


def _jax_grads(q, k, v, g, window, dtype):
    jd = jnp.bfloat16 if dtype == BF16 else jnp.float32

    @jax.jit
    def grads(q_, k_, v_, g_):
        def f(a, b, c):
            return jatt.flash_attention(a, b, c, causal=True, window=window,
                                        kv_chunk=q.shape[1], probs_bf16=True)

        return jax.vjp(f, q_, k_, v_)[1](g_)

    return [np.asarray(t.astype(jnp.float32)) for t in
            grads(*(jnp.asarray(a).astype(jd) for a in (q, k, v, g)))]


def _port_grads(q, k, v, g, window, dtype):
    """The model's route: v rounded to bfloat16 (``_bf16_v``: its gradient
    rounded too), zero-padded to q's width as ``mla_prefill`` pads it, the
    plain version with p rounded, dv's padded columns dropped."""
    dhv = v.shape[-1]
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (q, k, v))
    vp = torch.nn.functional.pad(tatt._bf16_v(vt, True), (0, q.shape[-1] - dhv))
    out = flash_attention_ref(qt, kt, vp, causal=True, window=window,
                              round_p=BF16)[..., :dhv]
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g).to(dtype))
    return [t.float().numpy() for t in grads]


def _roundings_agree(q, k, window) -> bool:
    """Whether every p = e^(s − m) rounds to the same bfloat16 value from
    JAX's scores and exp as from the port's."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = (jnp.asarray(q) * dh ** -0.5).reshape(B, S, KV, H // KV, dh)
    s = jnp.einsum("bqkgd,bskd->bkgqs", qg, jnp.asarray(k))
    pos = jnp.arange(S)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    s = jnp.where(mask, s, -1e30)
    pj = np.asarray(jnp.exp(s - s.max(-1, keepdims=True)).astype(jnp.bfloat16)
                    .astype(jnp.float32))
    st = _flash_scores(torch.from_numpy(q), torch.from_numpy(k), True, window)
    pt = torch.exp(st - st.amax(-1, keepdim=True)).to(BF16).float().numpy()
    return bool((pj == pt).all())


# (B, S, H, KV, dh, dhv, window, tie)
TIGHT = [(1, 64, 4, 2, 32, 32, 0, False), (1, 40, 4, 4, 24, 16, 0, False),
         (1, 24, 2, 1, 16, 16, 0, True)]
WIDE = [(2, 96, 6, 2, 48, 48, 16, False), (1, 72, 4, 4, 24, 16, 0, False)]


@pytest.mark.parametrize("case", TIGHT, ids=["gqa", "mla-pad", "tie"])
def test_plain_rounded_backward_matches_jax_grad(case):
    B, S, H, KV, dh, dhv, window, tie = case
    q, k, v, g = _inputs(B, S, H, KV, dh, dhv, seed=S, tie=tie)
    if tie:         # keys 3 and 5 share the max of every row from token 5 on
        s = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, H // KV, axis=2))
        s = np.where(np.tri(S, dtype=bool), s, -np.inf)
        assert (s[..., 5:, 3] == s[..., 5:, 5]).all()
        assert (s[..., 5:, 3] == s[..., 5:, :].max(-1)).all()
    assert _roundings_agree(q, k, window)
    got = _port_grads(q, k, v, g, window, torch.float32)
    want = _jax_grads(q, k, v, g, window, torch.float32)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        top = float(np.abs(b).max())
        tol = _ulp(top) if name == "dv" else 1e-5 * top
        err = float(np.abs(a - b).max())
        assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WIDE, ids=["gqa-window", "mla-pad"])
def test_plain_rounded_backward_within_two_bf16_ulps(case, dtype):
    B, S, H, KV, dh, dhv, window, tie = case
    q, k, v, g = _inputs(B, S, H, KV, dh, dhv, seed=S + 1)
    if dtype == BF16:                     # the same bf16 values on both sides
        q, k, v, g = (torch.from_numpy(a).to(BF16).float().numpy()
                      for a in (q, k, v, g))
    got = _port_grads(q, k, v, g, window, dtype)
    want = _jax_grads(q, k, v, g, window, dtype)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        tol = FLASH_BWD_BF16_ULPS * _ulp(float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= tol, f"{name}: {err} > {tol}"


def test_rounded_p_moves_the_gradient():
    """The fp32-p gradient is no stand-in: it lies further from the
    rounded one than the limit above."""
    q, k, v, g = _inputs(*WIDE[0][:6], seed=97)
    rounded = _port_grads(q, k, v, g, 0, torch.float32)
    fp32 = flash_attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k)),
                                   tatt._bf16_v(torch.from_numpy(v), True),
                                   torch.from_numpy(g))[:2]
    gap = max(float(np.abs(a - b.numpy()).max()) / float(np.abs(a).max())
              for a, b in zip(rounded, fp32))
    assert gap > 2e-3


# The card's float32 limit for the rounded-p backward kernels
# (chip_smoke.FLASH_BWD_ROUNDED_REL): of each gradient's largest magnitude
FLASH_BWD_ROUNDED_REL = 1e-3


def _detached_max_grads(q, k, v, g):
    """The rounded-p gradient with the row max held constant: the plain
    version's fault this slice closed (right only for fp32 p)."""
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    B, S, H, dh = q.shape
    s = _flash_scores(q, k, True, 0)
    p = torch.exp(s - s.amax(-1, keepdim=True).detach())
    out = (torch.einsum("bkgqs,bskd->bkgqd", p.to(BF16).float(), v)
           / p.sum(-1, keepdim=True))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh)
    return torch.autograd.grad(out, (q, k, v), g)


# (S, H, KV, dh): qwen2.5-3b's dh and G 8, deepseek-v2's MLA (v zero past
# 128), zamba2-7b's shared block, at the card cases' lengths
LIMIT_CASES = [(1024, 8, 1, 128), (300, 8, 1, 128), (1024, 4, 4, 192),
               (1024, 4, 4, 224)]


@pytest.mark.parametrize("case", LIMIT_CASES,
                         ids=["qwen", "qwen-300", "mla", "zamba2"])
def test_rounded_limit_sees_both_faults(case):
    """The card holds the float32 rounded-p kernels within
    ``FLASH_BWD_ROUNDED_REL`` of each gradient's largest (they read up to
    about 2e-4 there).  Both faults it must catch lie beyond it at the
    card's shapes: the fp32-p gradient, and the rounded gradient with the
    row max detached."""
    S, H, KV, dh = case
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, S, H, KV, dh, dh,
                                                       seed=S + dh))
    v = v.to(BF16).float()
    if dh == 192:
        v[..., 128:] = 0
        g[..., 128:] = 0
    want = flash_attention_bwd_ref(q, k, v, g, round_p=BF16)[:3]
    for fault in (flash_attention_bwd_ref(q, k, v, g)[:3],
                  _detached_max_grads(q, k, v, g)):
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(fault, want))
        assert rel > FLASH_BWD_ROUNDED_REL, rel


def test_model_route_differentiates_probs_bf16():
    """``gqa_prefill`` and ``mla_prefill`` with ``probs_bf16`` under
    autograd run ``flash_attention_train(round_p=torch.bfloat16)``, whose
    CPU version is the plain one: the same gradients as the ``plain``
    route."""
    rng = np.random.default_rng(3)
    D, H, KV, dh, S = 32, 4, 2, 8, 12
    p = {n: torch.from_numpy((rng.standard_normal(s) * D ** -0.5)
                             .astype(np.float32)).requires_grad_(True)
         for n, s in (("wq", (D, H, dh)), ("wk", (D, KV, dh)),
                      ("wv", (D, KV, dh)), ("wo", (H, dh, D)))}
    x = torch.from_numpy(rng.standard_normal((2, S, D)).astype(np.float32))
    cos, sin = rope_table(S, dh, 1e4)
    grads = []
    for plain in (False, True):
        y, _ = tatt.gqa_prefill(p, x, cos, sin, probs_bf16=True, plain=plain)
        grads.append(torch.autograd.grad(y.square().sum(), list(p.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    q, k, v, g = (torch.from_numpy(a).requires_grad_(True)
                  for a in _inputs(1, 20, 4, 2, 8, 8, 3))
    out = fa.flash_attention_train(q, k, v, round_p=BF16)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, round_p=BF16),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="round_p"):
        fa.flash_attention_train(q, k, v, round_p=torch.float16)
    # the rounded-p backward: float32 on the CUDA cores, bfloat16 on the
    # tensor cores where the fp32-p one is
    assert (fa.flash_bwd_route(q, k, v, BF16), fa.flash_bwd_route(q, k, v)) == ("simt", "wgmma")
    qb, kb, vb = (t.detach().bfloat16() for t in (q, k, v))
    assert fa.flash_bwd_route(qb, kb, vb, BF16) == "wgmma"
    # float32 runs on fa_kernel; both forward kernels round p against the
    # row's max (mode 3) up to dh 256, in serving as in training; a key
    # tile's running max (mode 2) only in fa_kernel's column split above it
    assert fa.flash_route(q, k, v) == "simt"
    assert (fa._round_mode(BF16, 8), fa._round_mode(BF16, 320)) == (3, 2)
    assert (fa._round_mode(False, 8), fa._round_mode(True, 8)) == (0, 1)
    torch.testing.assert_close(fa.flash_attention_fused(q, k, v, round_p=BF16),
                               out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="round_p"):
        fa.flash_attention_fused(q, k, v, round_p=torch.float16)


# ------------------------------------------------------------- the LM step
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b"])
def test_lm_loss_and_gradients_with_probs_bf16_match_reference(arch):
    cfg = dataclasses.replace(get_arch(arch).smoke, attn_probs_bf16=True)
    cfg_j = dataclasses.replace(j_get_arch(arch).smoke, attn_probs_bf16=True)
    tree = jax.tree.map(lambda t: t.numpy(),
                        _master_tree(tt.init_params(cfg, 0, "cpu")))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    assert cfg_j.kv_chunk >= toks.shape[1]           # one KV chunk
    want, jg = jax.jit(jax.value_and_grad(jt.lm_loss), static_argnums=1)(
        jax.tree.map(jnp.asarray, tree), cfg_j, jnp.asarray(toks))
    model = tt.params_from_reference(tree, cfg, "cpu")
    loss = tt.lm_loss(model, toks)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    flat = tt._flatten(jax.tree.map(np.asarray, jg))
    for path, ts in tt._leaves(model).items():
        g = (np.stack([t.grad.numpy() for t in ts]) if path.startswith("blocks/")
             else ts[0].grad.numpy())
        top = float(np.abs(flat[path]).max())
        err = float(np.abs(g - flat[path]).max())
        assert err <= FLASH_BWD_BF16_ULPS * _ulp(top), (path, err, top)
