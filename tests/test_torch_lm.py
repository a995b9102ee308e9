"""The port's dense LM against the JAX package's, on the CPU.

Layers (``rms_norm``, ``rope_table``, ``apply_rope``, ``mlp_swiglu``), and
``forward_full``/``forward_decode`` of qwen2.5's ``SMOKE`` config with the
JAX weights carried across by ``params_from_reference`` (the QKV biases set
to random values first, so that their path is exercised).  Inputs come from
numpy seeds.

Tolerances: float32 ``rtol = atol = 1e-5`` (measured: at most 4e-6 on
logits of magnitude 4).  The bfloat16 variant of ``SMOKE``: activations are
rounded to bf16 after every product and residual add, at places that agree
between the two frameworks but on values computed in another order, so a
rounding may land one bf16 ulp apart and propagate; its logits agree within
``atol = 0.0625``, two bf16 ulps at their magnitude of 4 (measured: 0.0427,
max over the positions), and the greedy tokens agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import registry
from repro_torch.configs.registry import SHAPES, get_arch
from repro_torch.models import layers as tl
from repro_torch.models.transformer import (Transformer, init_cache,
                                            init_params, params_from_reference)

TOL = dict(rtol=1e-5, atol=1e-5)
J_FULL = jax.jit(jt.forward_full, static_argnums=(1,),
                 static_argnames=("return_cache",))
J_DECODE = jax.jit(jt.forward_decode, static_argnums=(1,))
SMOKE = get_arch("qwen2.5-3b").smoke
J_SMOKE = j_get_arch("qwen2.5-3b").smoke


def _np_params(cfg_j, seed=0):
    tree = jax.tree.map(np.array, jt.init_params(cfg_j, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for b in ("bq", "bk", "bv"):
        a = tree["blocks"]["attn"][b]
        tree["blocks"]["attn"][b] = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return tree


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["model", "smoke"])
def test_config_equals_reference_field_by_field(which):
    port, ref = getattr(get_arch("qwen2.5-3b"), which), getattr(
        j_get_arch("qwen2.5-3b"), which)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert str(port.adt).split(".")[-1] == ref.adt.name
    assert str(port.pdt).split(".")[-1] == ref.pdt.name


def test_cell_configs_and_registry_match_reference():
    port, ref = get_arch("qwen2.5-3b"), j_get_arch("qwen2.5-3b")
    from repro.configs.registry import SHAPES as J_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for name in SHAPES:
        assert dataclasses.asdict(port.cell_config(SHAPES[name])) == \
            dataclasses.asdict(ref.cell_config(J_SHAPES[name]))
    assert [c.name for c in registry.cells_for(port)] == ["train_4k",
                                                         "prefill_32k",
                                                         "decode_32k"]
    for arch in registry.ARCH_IDS:
        if arch not in registry.PORTED:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                get_arch(arch)
    with pytest.raises(KeyError):
        get_arch("gpt-17")


# ---------------------------------------------------------------- layers
def test_rms_norm_rope_and_swiglu_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    for offset in (0, 13):
        cj, sj = jl.rope_table(7, 16, 1e4, offset=offset)
        ct, st = tl.rope_table(7, 16, 1e4, offset=offset)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
        np.testing.assert_allclose(
            tl.apply_rope(torch.from_numpy(x), ct, st).numpy(),
            np.asarray(jl.apply_rope(jnp.asarray(x), cj, sj)), **TOL)
    assert tl.pad_vocab(151936) == jl.pad_vocab(151936) == 152064
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (16, 40)), ("w_up", (16, 40)), ("w_down", (40, 16)))}
    h = rng.standard_normal((3, 5, 16)).astype(np.float32)
    pt = {k: torch.from_numpy(a) for k, a in p.items()}
    pj = {k: jnp.asarray(a) for k, a in p.items()}
    np.testing.assert_allclose(tl.mlp_swiglu(pt, torch.from_numpy(h)).numpy(),
                               np.asarray(jl.mlp_swiglu(pj, jnp.asarray(h))), **TOL)
    # bfloat16 in, fp32 gate/up products, one rounding of h and of the output
    hb = jnp.asarray(h, jnp.bfloat16)
    got = tl.mlp_swiglu(pt, torch.from_numpy(np.array(hb, np.float32)).to(torch.bfloat16))
    want = np.asarray(jl.mlp_swiglu(pj, hb), np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_dot_f32_keeps_an_fp32_result_from_bfloat16():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((64, 9)).astype(np.float32)).to(torch.bfloat16)
    got = tl.dot_f32(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.float() @ b.float(), rtol=0, atol=0)


# ----------------------------------------------------- forward, carried
def _models(dtype="float32"):
    cfg_j = dataclasses.replace(J_SMOKE, act_dtype=dtype)
    cfg = dataclasses.replace(SMOKE, act_dtype=dtype)
    tree = _np_params(cfg_j)
    return cfg_j, jax.tree.map(jnp.asarray, tree), cfg, params_from_reference(
        tree, cfg, "cpu")


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 0.0625)])
def test_forward_full_and_decode_match_reference(dtype, atol):
    cfg_j, pj, cfg, model = _models(dtype)
    rng = np.random.default_rng(3)
    B, S, P = 2, 40, 29
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lj, cj, _ = J_FULL(pj, cfg_j, jnp.asarray(toks), return_cache=True)
    lt, ct, aux = model.forward_full(toks, return_cache=True)
    assert lt.dtype == torch.float32 and lt.shape == (B, S, cfg.padded_vocab)
    assert float(aux) == 0.0
    tol = dict(rtol=1e-5 if dtype == "float32" else 0.0, atol=atol)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
    for key in ("k", "v"):
        assert ct[key].shape == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
        np.testing.assert_allclose(ct[key].float().numpy(),
                                   np.asarray(cj[key], np.float32), **tol)
    assert (lt.argmax(-1).numpy() == np.asarray(lj).argmax(-1)).all()

    # decode three steps from a prefix of P tokens, the second sequence
    # behind the first
    cache_j = jt.init_cache(cfg_j, B, S)
    cache_j = {k: v.at[:, :, :P].set(cj[k][:, :, :P]) for k, v in cache_j.items()}
    cache_t = init_cache(cfg, B, S, device="cpu")
    for k in cache_t:
        cache_t[k][:, :, :P] = ct[k][:, :, :P]
    pos = np.array([P, P - 9], np.int32)
    for step in range(3):
        tok = toks[np.arange(B), pos]
        dj, cache_j = J_DECODE(pj, cfg_j, jnp.asarray(tok), cache_j,
                               jnp.asarray(pos))
        dt, cache_t = model.forward_decode(tok, cache_t, pos)
        assert dt.shape == (B, cfg.padded_vocab)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **tol)
        # teacher forcing: decoding token pos gives the full forward's row
        np.testing.assert_allclose(dt.numpy(), lt.numpy()[np.arange(B), pos],
                                   **tol)
        pos = pos + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_t[key].float().numpy(),
                                   np.asarray(cache_j[key], np.float32), **tol)


def test_decode_rejects_positions_outside_the_cache():
    _, _, cfg, model = _models()
    cache = init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        model.forward_decode(np.array([1]), cache, np.array([8], np.int32))


# ---------------------------------------------------- parameter handling
def test_params_from_reference_rejects_unknown_missing_and_misshaped():
    tree = _np_params(J_SMOKE)
    extra = jax.tree.map(lambda a: a, tree)
    extra["blocks"]["attn"]["w_extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unknown leaves.*w_extra"):
        params_from_reference(extra, SMOKE, "cpu")
    missing = jax.tree.map(lambda a: a, tree)
    del missing["blocks"]["mlp"]["w_up"]
    with pytest.raises(ValueError, match="missing leaves.*w_up"):
        params_from_reference(missing, SMOKE, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["lm_head"] = bad["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="lm_head has shape"):
        params_from_reference(bad, SMOKE, "cpu")


def test_init_params_draws_the_reference_distribution():
    cfg = dataclasses.replace(SMOKE, d_model=128, d_ff=256, vocab_size=2048)
    a, b = init_params(cfg, 0, "cpu"), init_params(cfg, 0, "cpu")
    c = init_params(cfg, 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.lm_head, c.lm_head)
    blk = a.blocks[0]
    assert torch.equal(blk.norm1, torch.ones(128))
    assert not blk.attn["bq"].any()
    for t, std in ((a.embed, 0.02), (a.lm_head, 128 ** -0.5),
                   (blk.attn["wq"], 128 ** -0.5), (blk.attn["wo"], 64 ** -0.5),
                   (blk.mlp["w_down"], 256 ** -0.5)):
        assert abs(float(t.float().std()) / std - 1) < 0.1
    # the reference's tree, by name and shape
    tree = jax.eval_shape(lambda: jt.init_params(
        dataclasses.replace(J_SMOKE, d_model=128, d_ff=256, vocab_size=2048),
        jax.random.key(0)))
    flat = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat["lm_head"] == tuple(a.lm_head.shape)
    assert flat["blocks/attn/wq"] == (cfg.n_layers,) + tuple(blk.attn["wq"].shape)
    assert len(flat) == 3 + 2 + len(blk.attn) + len(blk.mlp)


def test_default_config_keeps_matmul_weights_in_the_activation_dtype():
    cfg = dataclasses.replace(SMOKE, act_dtype="bfloat16")
    m = Transformer(cfg, "cpu")
    assert m.embed.dtype == m.lm_head.dtype == m.blocks[0].attn["wq"].dtype \
        == torch.bfloat16
    assert m.final_norm.dtype == m.blocks[0].norm1.dtype == torch.float32
    assert init_cache(cfg, 2, 8, device="cpu")["k"].dtype == torch.bfloat16
