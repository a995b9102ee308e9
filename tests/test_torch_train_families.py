"""``lm_loss`` and every parameter's gradient against the JAX package's, on
the SMOKE configs of the families beside qwen2.5's dense one.

olmoe-1b-7b (MoE: the router, capacity dispatch and the aux loss in the
loss), deepseek-v2-236b (MLA: v zero-padded into the flash attention, the
padded columns' gradient dropped), mamba2-1.3b (the chunked SSD scan),
zamba2-7b (the shared attention block with a sliding window of 8, applied
every few Mamba2 layers) and internvl2-26b (a prefix of embeddings before
the tokens, sliced off the loss).  The JAX weights are carried across with
``params_from_reference``, the tokens (and the prefix) come from numpy
seeds, and the reference is ``jax.value_and_grad(repro.models.transformer.
lm_loss)``.  Tolerances, float32: the loss ``rtol = 1e-5``, each gradient
``rtol = 1e-5`` with ``atol = 1e-5`` of its leaf's largest magnitude
(measured: at most 5e-6 of it, zamba2).

Remat: ``forward_train`` under each policy of the reference (``nothing``,
``dots``, ``dots_nobatch``) gives the loss and the gradients bit for bit as
without remat: the recomputed forward repeats the same operations.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt
from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer as tt

torch.set_num_threads(1)
J_VG = jax.jit(jax.value_and_grad(jt.lm_loss), static_argnums=1)
S = 24
# arch → what the SMOKE config is changed to on both sides
FAMILIES = {"olmoe-1b-7b": {}, "deepseek-v2-236b": {}, "mamba2-1.3b": {},
            "zamba2-7b": {"attn_window": 8}, "internvl2-26b": {}}


def _case(arch: str, seed: int = 0):
    cfg_j = dataclasses.replace(j_get_arch(arch).smoke, **FAMILIES[arch])
    cfg = dataclasses.replace(get_arch(arch).smoke, **FAMILIES[arch])
    tree = jax.tree.map(np.array, jt.init_params(cfg_j, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    prefix = None
    if cfg.modality == "vision_prefix":
        prefix = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    return cfg_j, cfg, tree, toks, prefix


def _port_loss(model, toks, prefix):
    loss = tt.lm_loss(model, toks, prefix_embeds=None if prefix is None
                      else torch.from_numpy(prefix))
    loss.backward()
    grads = {path: [t.grad.clone() for t in ts]
             for path, ts in tt._leaves(model).items()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_lm_loss_and_every_gradient_match_reference(arch):
    cfg_j, cfg, tree, toks, prefix = _case(arch)
    want, jg = J_VG(jax.tree.map(jnp.asarray, tree), cfg_j, jnp.asarray(toks),
                    prefix_embeds=None if prefix is None else jnp.asarray(prefix))
    model = tt.params_from_reference(tree, cfg, "cpu")
    loss, grads = _port_loss(model, toks, prefix)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    flat = tt._flatten(jax.tree.map(np.asarray, jg))
    assert set(grads) == set(flat)
    for path, gs in grads.items():
        got = torch.stack(gs).numpy() if path.startswith("blocks/") else gs[0].numpy()
        top = float(np.abs(flat[path]).max())
        np.testing.assert_allclose(got, flat[path], rtol=1e-5, atol=1e-5 * top,
                                   err_msg=path)


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_nobatch"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-7b"])
def test_remat_gives_the_same_loss_and_gradients(arch, policy):
    _, cfg, tree, toks, prefix = _case(arch, seed=1)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        out[remat] = _port_loss(tt.params_from_reference(tree, c, "cpu"),
                                toks, prefix)
    assert torch.equal(out[True][0], out[False][0])
    for path, gs in out[False][1].items():
        assert all(torch.equal(a, b) for a, b in zip(gs, out[True][1][path])), path


def test_probs_bf16_has_no_backward_yet():
    """Formerly refused (ROADMAP Queue A item 8.10); now the loss with
    ``attn_probs_bf16`` and its gradients are the reference's: loss ``rtol
    = 1e-4``, each gradient within two bf16 ulps of its leaf's largest
    magnitude (XLA's and torch's ``exp`` flip some bf16 roundings of p;
    ``tests/test_torch_probs_bf16.py``)."""
    cfg_j, cfg, tree, toks, _ = _case("olmoe-1b-7b")
    cfg_j = dataclasses.replace(cfg_j, attn_probs_bf16=True)
    model = tt.params_from_reference(
        tree, dataclasses.replace(cfg, attn_probs_bf16=True), "cpu")
    want, jg = J_VG(jax.tree.map(jnp.asarray, tree), cfg_j, jnp.asarray(toks))
    loss, grads = _port_loss(model, toks, None)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    flat = tt._flatten(jax.tree.map(np.asarray, jg))
    for path, gs in grads.items():
        g = np.stack([t.numpy() for t in gs]) if path.startswith("blocks/") \
            else gs[0].numpy()
        top = float(np.abs(flat[path]).max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        assert float(np.abs(g - flat[path]).max()) <= 2 * ulp, path
    with torch.no_grad():             # serving it is unchanged
        assert model.forward_full(toks)[0].isfinite().all()
