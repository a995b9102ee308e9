"""The port's MoE FFN against the JAX package's, on the CPU.

``repro_torch.models.moe.moe_ffn`` against ``repro.models.moe.moe_ffn`` at
olmoe's SMOKE widths (D 64, expert F 32, E 8, k 2), with the weights of the
reference's ``init_moe`` carried across and inputs from numpy seeds: T = 8
to 64 tokens at capacity factors that drop many copies (0.5), some (1.25,
the configs' own) and none (8.0), with 0 and 2 shared experts; a zero
router, whose gates all tie, which must pick experts 0 … k-1; bfloat16
activations and weights; and the router kept in float32.

Tolerances: float32 ``rtol = atol = 1e-5`` on the output and on the aux
loss (measured: at most 8.6e-7 and 1.2e-7).  bfloat16: one bf16 ulp of the
output's largest magnitude, since the expert products and the SwiGLU round
at the same places but may sum in another order (measured: bitwise equal).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.layers import Initializer
from repro_torch.configs.registry import get_arch
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import Transformer

TOL = dict(rtol=1e-5, atol=1e-5)
D, FE, E, K = 64, 32, 8, 2          # olmoe's SMOKE widths


def _params(n_shared=0, seed=0, dtype=jnp.float32):
    p = jmoe.init_moe(Initializer(jax.random.key(seed)), D, FE, E,
                      n_shared=n_shared, dtype=dtype)
    return p, jax.tree.map(_to_torch, p)


def _to_torch(a):
    a = np.asarray(a)
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _x(B, S, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(dtype)


def _drops(pt, x, cf):
    T = x.shape[0] * x.shape[1]
    cap = tmoe.capacity(T, K, E, cf)
    *_, keep = tmoe.route(pt["router"], torch.from_numpy(x).reshape(T, D), K, cap)
    return int((~keep).sum())


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("B,S", [(1, 8), (2, 8), (4, 8), (2, 32)])
def test_moe_ffn_matches_reference(B, S, cf, n_shared):
    pj, pt = _params(n_shared, seed=B * S)
    x = _x(B, S, seed=S + B)
    want, aux_j = jmoe.moe_ffn(pj, jnp.asarray(x), k=K, capacity_factor=cf)
    got, aux_t = tmoe.moe_ffn(pt, torch.from_numpy(x), k=K, capacity_factor=cf)
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    drops = _drops(pt, x, cf)
    if cf == 8.0:
        assert drops == 0
    elif cf == 0.5 and B * S > 8:
        assert drops > 0          # dropped copies share slot 0: added, not set


@pytest.mark.parametrize("T", [8, 13, 64, 100, 1024])
@pytest.mark.parametrize("k,E_,cf", [(2, 8, 1.25), (8, 64, 1.25), (6, 160, 1.25),
                                     (2, 8, 0.5), (6, 160, 8.0)])
def test_capacity_is_the_reference_formula(T, k, E_, cf):
    cap = max(k, int(T * k * cf / E_))
    assert tmoe.capacity(T, k, E_, cf) == -(-cap // 4) * 4
    assert tmoe.capacity(T, k, E_, cf) % 4 == 0


def _slots_choice_by_choice(top_i, E, cap):
    """The reference's slot loop (``repro/models/moe.py``), in numpy."""
    T, k = top_i.shape
    counts = np.zeros(E, np.int64)
    slots, keeps = [], []
    for j in range(k):
        onehot = np.eye(E, dtype=np.int64)[top_i[:, j]]
        pos = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1) + counts[top_i[:, j]]
        keep = pos < cap
        slots.append(np.where(keep, top_i[:, j] * cap + pos, 0))
        keeps.append(keep)
        counts = counts + onehot.sum(0)
    return np.stack(slots, 1), np.stack(keeps, 1)


@pytest.mark.parametrize("T,E_,k,cap", [(8, 8, 2, 4), (64, 8, 2, 8), (33, 4, 3, 4),
                                        (200, 64, 8, 28), (50, 160, 6, 8)])
def test_slot_assignment_equals_the_choice_by_choice_count(T, E_, k, cap):
    """One cumsum over the copies in choice-major order gives the
    reference's running count choice by choice, drops included."""
    rng = np.random.default_rng(T + E_)
    x = torch.from_numpy(rng.standard_normal((T, 16)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((16, E_)).astype(np.float32))
    router[:, 0] += 2.0                         # crowd expert 0: drops
    _, _, top_i, slot, keep = tmoe.route(router, x, k, cap)
    want_slot, want_keep = _slots_choice_by_choice(top_i.numpy(), E_, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    assert (~want_keep).any()


def test_tied_gates_pick_the_lowest_experts():
    """A zero router: every gate is 1/E, so the reference's top_k picks
    experts 0 … k-1 for every token; so must the port."""
    pj, pt = _params(n_shared=2, seed=5)
    pj["router"] = jnp.zeros_like(pj["router"])
    pt["router"] = torch.zeros_like(pt["router"])
    x = _x(2, 8, seed=6)
    _, top_g, top_i, _, keep = tmoe.route(pt["router"], torch.from_numpy(x).reshape(16, D),
                                          K, tmoe.capacity(16, K, E, 1.25))
    assert top_i.tolist() == [list(range(K))] * 16
    torch.testing.assert_close(top_g, torch.full((16, K), 1.0 / K))
    assert not keep.all()         # 16 tokens on 2 experts overflow cap 8
    want, aux_j = jmoe.moe_ffn(pj, jnp.asarray(x), k=K, capacity_factor=1.25)
    got, aux_t = tmoe.moe_ffn(pt, torch.from_numpy(x), k=K, capacity_factor=1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_ffn_bfloat16_within_one_ulp(cf, n_shared):
    pj, pt = _params(n_shared, seed=7, dtype=jnp.bfloat16)
    assert pj["router"].dtype == jnp.float32 and pt["router"].dtype == torch.float32
    assert pt["w_up"].dtype == torch.bfloat16
    xb = jnp.asarray(_x(2, 16, seed=8), jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb, np.float32)).to(torch.bfloat16)
    want, aux_j = jmoe.moe_ffn(pj, xb, k=K, capacity_factor=cf)
    got, aux_t = tmoe.moe_ffn(pt, xt, k=K, capacity_factor=cf)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp
    # the router ran in float32 on the same bf16 input: the same gates
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)


def test_router_stays_float32_under_bfloat16_parameters():
    cfg = dataclasses.replace(get_arch("deepseek-v2-236b").smoke,
                              act_dtype="bfloat16", param_dtype="bfloat16")
    blk = Transformer(cfg, "cpu").blocks[0]
    assert blk.moe["router"].dtype == torch.float32
    assert blk.moe["w_gate"].dtype == blk.shared["w_up"].dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, D, FE, E, n_shared=2, dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert {t.dtype for t in p["shared"].values()} == {torch.bfloat16}
    assert p["w_down"].shape == (E, FE, D) and p["shared"]["w_down"].shape == (2 * FE, D)
    # a bf16 router would round the logits' inputs: the port upcasts x, not
    # the router, and its logits equal an fp32 product of the bf16 input
    x = torch.randn(5, D, generator=gen).to(torch.bfloat16)
    gates, *_ = tmoe.route(p["router"], x, K, 8)
    torch.testing.assert_close(gates, torch.softmax(x.float() @ p["router"], -1),
                               rtol=0, atol=0)
