"""Every architecture of the port beside qwen2.5-3b against the JAX
package's, on the CPU: granite-8b (GQA, G 4), codeqwen1.5-7b (MHA, QKV
bias), command-r-35b (G 4, a 256k vocabulary), musicgen-medium (MHA over
audio tokens), internvl2-26b (G 4 behind a vision prefix), olmoe-1b-7b
(GQA + 64 routed experts, top-8), deepseek-v2-236b (MLA + 2 shared and
160 routed experts, top-6), mamba2-1.3b (attention-free Mamba2) and
zamba2-7b (Mamba2 with a shared attention block), each at its SMOKE config
with the JAX weights carried across by ``params_from_reference`` (norm
weights and QKV biases set to random values first, so that their paths are
exercised).  Inputs come from numpy seeds.

* ``forward_full`` (logits, caches, the MoE layers' summed aux loss) and
  three ``forward_decode`` steps against the JAX functions: float32
  ``rtol = atol = 1e-5`` (measured: at most 4.6e-6 on logits of magnitude
  4);
* the port's ``ServeEngine`` against ``repro.serve.engine.ServeEngine`` on
  the real SMOKE capacity, where the prefill buckets drop copies: identical
  greedy tokens;
* the configs field by field, the parameter tree by name and shape,
  ``get_arch`` taking all ten architectures, and the launcher serving each
  one on the CPU.

The ``ssm`` and ``hybrid`` caches hold a state that integrates every
position, so a decode test prefills each sequence's own prefix alone, as
the engines do.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe, transformer
from repro_torch.models.transformer import (init_cache, init_params,
                                            params_from_reference)
from repro_torch.serve.engine import ServeEngine

ARCHS = ["granite-8b", "codeqwen1.5-7b", "olmoe-1b-7b", "deepseek-v2-236b",
         "command-r-35b", "musicgen-medium", "internvl2-26b", "mamba2-1.3b",
         "zamba2-7b"]
TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _tree(arch: str, seed: int = 0):
    tree = jax.tree.map(np.array, jt.init_params(j_get_arch(arch).smoke,
                                                 jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    leaves = tree["blocks"].get("attn", {})
    for name in ("bq", "bk", "bv", "norm_kv", "norm_q"):
        if name in leaves:
            base = 1.0 if name.startswith("norm") else 0.0
            leaves[name] = (base + 0.1 * rng.standard_normal(leaves[name].shape)
                            ).astype(np.float32)
    return tree


def _models(arch):
    tree = _tree(arch)
    cfg = get_arch(arch).smoke
    return (j_get_arch(arch).smoke, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_reference(tree, cfg, "cpu"))


def _drop_spy(monkeypatch) -> list[tuple[int, int]]:
    """(tokens, dropped copies) of every MoE layer the port runs."""
    seen: list[tuple[int, int]] = []
    real = transformer.moe_ffn

    def spy(p, x, *, k, capacity_factor):
        T = x.shape[0] * x.shape[1]
        cap = moe.capacity(T, k, p["router"].shape[-1], capacity_factor)
        *_, keep = moe.route(p["router"], x.reshape(T, -1), k, cap)
        seen.append((T, int((~keep).sum())))
        return real(p, x, k=k, capacity_factor=capacity_factor)

    monkeypatch.setattr(transformer, "moe_ffn", spy)
    return seen


@pytest.mark.parametrize("which", ["model", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_by_field(arch, which):
    port, ref = getattr(get_arch(arch), which), getattr(j_get_arch(arch), which)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert str(port.adt).split(".")[-1] == ref.adt.name
    assert get_arch(arch).source == j_get_arch(arch).source
    assert get_arch(arch).skip_cells == j_get_arch(arch).skip_cells


def test_every_architecture_is_ported():
    assert sorted(registry.PORTED) == sorted(registry.ARCH_IDS)
    assert sorted(ARCHS + ["qwen2.5-3b"]) == sorted(registry.ARCH_IDS)
    for arch in registry.ARCH_IDS:
        assert get_arch(arch).arch_id == arch


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    cfg = get_arch(arch).smoke
    model = init_params(cfg, 0, "cpu")
    shapes = jax.eval_shape(lambda: jt.init_params(j_get_arch(arch).smoke,
                                                   jax.random.key(0)))
    want = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {path: ((len(ts),) if path.startswith("blocks/") else ())
           + tuple(ts[0].shape) for path, ts in transformer._leaves(model).items()}
    assert got == want
    blk = model.blocks[0]
    assert torch.equal(blk.norm1, torch.ones(cfg.d_model))
    if cfg.family == "moe":
        assert blk.moe["router"].dtype == torch.float32
        assert abs(float(blk.moe["w_gate"].std()) * cfg.d_model ** 0.5 - 1) < 0.1
    # the same seed gives the same weights, another seed others
    again = init_params(cfg, 0, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_full_and_decode_match_reference(arch):
    cfg_j, pj, cfg, model = _models(arch)
    rng = np.random.default_rng(3)
    B, S, P = 2, 24, 17
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lj, cj, aux_j = jt.forward_full(pj, cfg_j, jnp.asarray(toks), return_cache=True)
    lt, ct, aux_t = model.forward_full(toks, return_cache=True)
    assert lt.dtype == torch.float32 and lt.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert set(ct) == set(cj) == set(jt.init_cache(cfg_j, 1, 1))
    for key in ct:
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]), **TOL)
    assert aux_t.dtype == torch.float32 and aux_t.shape == ()
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    assert (float(aux_t) > 0) == (cfg.family == "moe")

    # decode three steps from a prefix of P tokens, the second sequence
    # behind the first
    pos = np.array([P, P - 5], np.int32)
    cache_j = jt.init_cache(cfg_j, B, S)
    cache_t = init_cache(cfg, B, S, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache_t.items()} == \
        {k: tuple(v.shape) for k, v in cache_j.items()}
    if cfg.family in ("dense", "moe"):
        cache_j = {k: v.at[:, :, :P].set(cj[k][:, :, :P])
                   for k, v in cache_j.items()}
        for k in cache_t:
            cache_t[k][:, :, :P] = ct[k][:, :, :P]
    else:
        # a state integrates every position: each sequence's prefix alone
        for b, n in enumerate(pos):
            _, cjb, _ = jt.forward_full(pj, cfg_j, jnp.asarray(toks[b:b + 1, :n]),
                                        return_cache=True)
            _, ctb, _ = model.forward_full(toks[b:b + 1, :n], return_cache=True)
            for k in cache_t:
                at = (slice(None), b) + ((slice(0, n),) if k in ("k", "v") else ())
                cache_j[k] = cache_j[k].at[at].set(cjb[k][:, 0])
                cache_t[k][at] = ctb[k][:, 0]
    for _ in range(3):
        tok = toks[np.arange(B), pos]
        dj, cache_j = jt.forward_decode(pj, cfg_j, jnp.asarray(tok), cache_j,
                                        jnp.asarray(pos))
        dt, cache_t = model.forward_decode(tok, cache_t, pos)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
        pos = pos + 1
    for key in cache_t:
        np.testing.assert_allclose(cache_t[key].numpy(), np.asarray(cache_j[key]),
                                   **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_the_jax_engine(arch, monkeypatch):
    cfg_j, pj, cfg, model = _models(arch)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in (5, 7, 12, 14)]
    ref = JServeEngine(cfg_j, pj, max_batch=3, max_len=64)
    eng = ServeEngine(cfg, model, max_batch=3, max_len=64, device="cpu")
    for p in prompts:
        ref.submit(p, max_new_tokens=6)
        eng.submit(p, max_new_tokens=6)
    want = [r.tokens for r in ref.run_to_completion()]
    seen = _drop_spy(monkeypatch)
    assert [r.tokens for r in eng.run_to_completion()] == want
    if cfg.family == "moe":
        # the prefill buckets (8 and 16 tokens) dropped copies; decode ran
        # every slot, idle ones included (T = max_batch)
        assert sum(d for T, d in seen if T > 3) > 0
        assert {T for T, _ in seen} == {8, 16, 3}


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_each_arch_on_the_cpu(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "2", "--max-new", "3",
                              "--max-batch", "2", "--layers", "1"]) == 0
    out = capsys.readouterr().out
    assert f"depth cut to 1 of {get_arch(arch).smoke.n_layers} layers" in out
    assert out.count("req ") == 2 and "2 requests, 6 tokens" in out
