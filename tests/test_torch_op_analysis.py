"""The port's count of a step (``repro_torch/launch/op_analysis.py``, the
counterpart of ``repro/launch/hlo_analysis.py``) on the CPU.

* The reference's own cases (``tests/test_hlo_analysis.py``) in torch,
  beside ``analyze_hlo`` of their jitted JAX twins: a dot's flops exactly,
  a 12-trip and a 3 × 4 loop of ``tanh(c @ w)`` exactly 12 times one
  trip's products, exp's transcendentals, bytes that scale with the trips,
  no collective on one device; the reference's count within its own
  tests' windows of the port's.
* Products against closed forms: one step of the SMOKE configs of
  qwen2.5-3b, olmoe-1b-7b, deepseek-v2-236b (MLA) and internvl2-26b (a
  vision prefix) on meta tensors, train (the optimizer, the remat
  recompute, the flash kernels' work), prefill and decode, equal to the
  weights' products, the kernels' work over the pairs the mask keeps and
  the MLA decode's latent products, exactly; mamba2-1.3b and zamba2-7b at
  least their projections' (the SSD scan's products on top).
* The kernels' work: ``PERF.md``'s bounds (flash forward at qwen's 16/2/128,
  S 1,024, causal; the backward's five products at S 4,096), the masked
  pairs of a window, and on meta each wrapper's outputs of the plain
  version's shapes and dtypes, one kernel call recorded a call while an
  analysis listens and nothing otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.configs.registry import ShapeCell, get_arch
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_work)
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_bwd_work,
                                                 flash_attention_fused,
                                                 flash_attention_train,
                                                 flash_attention_work,
                                                 kept_pairs)
from repro_torch.kernels.ref import (decode_attention_ref,
                                     flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.launch.op_analysis import (ABSENT, COLLECTIVES, OpCost,
                                            analyze, collective_report)
from repro_torch.launch.steps import abstract_train_state
from repro_torch.models.moe import capacity
from repro_torch.models.transformer import Transformer, init_cache
from repro_torch.train.optim import OptConfig
from repro_torch.train.train_loop import make_train_step

B, S, MICRO = 4, 16, 4          # the SMOKE cell every count here runs
H100_BF16 = 989e12


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile()


# ----------------------------------------------------- the reference's cases
def test_dot_flops_exact():
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    cost = analyze(lambda: a @ b)
    assert cost.flops == cost.products == 2 * 32 * 48 * 16
    assert cost.bytes == 4 * (32 * 48 + 48 * 16 + 32 * 16)
    ref = analyze_hlo(_compile(lambda x, y: x @ y,
                               jax.ShapeDtypeStruct((32, 48), jnp.float32),
                               jax.ShapeDtypeStruct((48, 16), jnp.float32)
                               ).as_text())
    assert cost.flops <= ref.flops < cost.flops * 1.1


def _trips(x, w, n):
    for _ in range(n):
        x = torch.tanh(x @ w)
    return x


def test_loop_trips_multiply():
    x, w = torch.randn(64, 64), torch.randn(64, 64)
    one, twelve = analyze(_trips, x, w, 1), analyze(_trips, x, w, 12)
    assert twelve.products == 12 * one.products == 12 * 2 * 64 ** 3
    assert twelve.flops == 12 * one.flops and twelve.bytes == 12 * one.bytes
    assert twelve.transcendentals == 12 * 64 * 64

    def scanned(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=12)[0]

    sds = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    ref = analyze_hlo(_compile(scanned, sds, sds).as_text())
    assert abs(ref.flops - twelve.flops) / twelve.flops < 0.01
    assert ref.unknown_trip_loops == 0 and "unknown_trip_loops" in ABSENT


def test_nested_loops_multiply():
    x, w = torch.randn(32, 32), torch.randn(32, 32)
    cost = analyze(lambda: [_trips(x, w, 4) for _ in range(3)])
    assert cost.products == 12 * 2 * 32 ** 3

    def nested(x, w):
        def inner(c, _):
            return jnp.tanh(c @ w), None

        def outer(c, _):
            return jax.lax.scan(inner, c, None, length=4)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    sds = jax.ShapeDtypeStruct((32, 32), jnp.float32)
    ref = analyze_hlo(_compile(nested, sds, sds).as_text())
    assert abs(ref.flops - cost.flops) / cost.flops < 0.02


def test_bytes_scale_with_trips():
    x = torch.randn(256, 256)

    def trips(n):
        y = x
        for _ in range(n):
            y = y * 2.0 + 1.0
        return y

    one, ten = analyze(trips, 1), analyze(trips, 10)
    # each trip: a multiply and an add, each reading and writing 256² fp32
    assert one.bytes == 2 * 2 * 256 * 256 * 4 and ten.bytes == 10 * one.bytes
    assert ten.flops == 10 * 2 * 256 * 256


def test_transcendentals_counted():
    cost = analyze(torch.exp, torch.randn(128))
    assert cost.transcendentals == 128
    ref = analyze_hlo(_compile(jnp.exp, jax.ShapeDtypeStruct((128,), jnp.float32)
                               ).as_text())
    assert ref.transcendentals >= 128


def test_no_collectives_single_device():
    x = torch.randn(64, 64)
    cost = analyze(lambda: x @ x)
    assert cost.collective_bytes == 0 and cost.coll_sent == 0
    rep = collective_report(cost)
    assert rep["total_bytes"] == 0 and set(rep["by_kind"]) == set(COLLECTIVES)
    assert set(rep["counts"]) == set(COLLECTIVES)


def test_views_and_allocations_are_free_and_in_place_counts_its_writes():
    x = torch.randn(8, 16)
    assert analyze(lambda: x.view(16, 8).t().unsqueeze(0)[0, 3:]).bytes == 0
    # a reshape that must copy is a copy
    assert analyze(lambda: x.t().reshape(-1)).bytes == 2 * 8 * 16 * 4
    assert analyze(lambda: torch.zeros(1024) + torch.empty(1024)).bytes == (
        3 * 1024 * 4)                  # the add alone
    y = torch.randn(8, 16)
    # x += y reads x and y and writes x; x.copy_(y) reads y and writes x
    assert analyze(lambda: x.add_(y)).bytes == 3 * 8 * 16 * 4
    assert analyze(lambda: x.copy_(y)).bytes == 2 * 8 * 16 * 4
    # an index-driven write moves its rows, not the table
    table = torch.zeros(1000, 16)
    rows = torch.tensor([3, 7])
    cost = analyze(lambda: table.index_put_((rows,), torch.ones(2, 16)))
    assert cost.bytes == 2 * 2 * 16 * 4


# ------------------------------------------------------------ the kernels' work
def test_kernel_work_reproduces_the_bounds():
    """``PERF.md`` §6's bound arithmetic: qwen's heads (16 / 2 / 128)."""
    fwd = flash_attention_work(1, 1024, 1024, 16, 2, 128, 2, True)
    assert fwd.flops == 4 * 128 * 16 * 1024 * 1025 // 2 == 4299161600
    assert round(fwd.flops / H100_BF16 * 1e3, 6) == 0.004347
    assert fwd.bytes == 2 * (2 * 1024 * 16 * 128 + 2 * 1024 * 2 * 128)
    bwd = flash_attention_bwd_work(1, 4096, 4096, 16, 2, 128, 2, True)
    assert bwd.flops == 10 * 128 * 16 * 4096 * 4097 // 2
    assert f"{bwd.flops:.4g}" == "1.718e+11"
    assert round(bwd.flops / H100_BF16 * 1e3, 4) == 0.1738
    assert bwd.bytes == 2 * (3 * 4096 * 16 * 128 + 4 * 4096 * 2 * 128) + (
        4 * 16 * 4096)
    dec = decode_attention_work(8, 2048, 16, 2, 128, 2)
    assert dec.flops == 4 * 8 * 16 * 128 * 2048


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (1, 1, True, 0), (16, 16, True, 0), (16, 16, False, 0), (16, 16, True, 5),
    (7, 20, True, 3), (20, 7, True, 0), (20, 7, True, 4), (33, 33, True, 40)])
def test_kept_pairs_is_the_mask(Sq, Sk, causal, window):
    q = torch.arange(Sq)[:, None]
    k = torch.arange(Sk)[None, :]
    keep = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        keep &= k <= q
    if window:
        keep &= k > q - window
    assert kept_pairs(Sq, Sk, causal, window) == int(keep.sum())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_outputs_are_the_plain_versions(dtype):
    """Each wrapper on meta tensors returns its kernel's outputs empty, of
    the CPU plain version's shapes and dtypes; while an analysis listens
    it records one kernel call with the call's work, and none otherwise."""
    Bq, Sq, H, KV, dh = 2, 12, 8, 2, 16
    cpu = [torch.randn(Bq, Sq, n, dh).to(dtype) for n in (H, KV, KV)]
    meta = [t.to("meta") for t in cpu]
    g_cpu = torch.randn(Bq, Sq, H, dh).to(dtype)

    def same(got, want):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert [(tuple(t.shape), t.dtype, t.device.type) for t in got] == [
            (tuple(t.shape), t.dtype, "meta") for t in want]

    same(flash_attention_fused(*meta, window=5),
         flash_attention_ref(*cpu, window=5))
    same(flash_attention_bwd(*meta, g_cpu.to("meta")),
         flash_attention_bwd_ref(*cpu, g_cpu))
    qd = torch.randn(Bq, H, dh).to(dtype)
    kc = [torch.randn(Bq, 20, KV, dh).to(dtype) for _ in range(2)]
    lens = torch.tensor([3, 20])
    for lse in (False, True):
        same(decode_attention(qd.to("meta"), *(t.to("meta") for t in kc),
                              lens.to("meta"), return_lse=lse),
             decode_attention_ref(qd, *kc, lens, return_lse=lse))
    # nothing listens: no work is made, nothing recorded
    assert build.LISTENERS == []
    # under an analysis: the forward and backward kernels a call each, with
    # the work of their shapes (the route named as LAUNCHES names it)
    q, k, v = (t.clone().requires_grad_() for t in meta)
    cost = analyze(lambda: flash_attention_train(q, k, v).sum().backward())
    item = torch.tensor([], dtype=dtype).element_size()
    fwd = flash_attention_work(Bq, Sq, Sq, H, KV, dh, item)
    bwd = flash_attention_bwd_work(Bq, Sq, Sq, H, KV, dh, item)
    tc = "_wgmma" if dtype == torch.bfloat16 else ""
    assert cost.kernels == {
        "flash_attention" + tc: {"calls": 1, "flops": fwd.flops, "bytes": fwd.bytes},
        "flash_attention_bwd_wgmma": {"calls": 1, "flops": bwd.flops,
                                      "bytes": bwd.bytes}}
    dec = analyze(decode_attention, qd.to("meta"),
                  *(t.to("meta") for t in kc), lens.to("meta"))
    assert dec.kernels["decode_attention"]["flops"] == decode_attention_work(
        Bq, 20, H, KV, dh, item).flops
    assert build.LISTENERS == []


def test_cpu_wrappers_count_their_plain_versions():
    """On CPU tensors a wrapper runs its plain version: no kernel call, its
    ops counted one by one (the dry-run counts on meta)."""
    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    cost = analyze(flash_attention_fused, q, k, v)
    assert cost.kernels == {} and cost.products > 0


# ----------------------------------------------------- products, closed forms
def _cfg(arch: str, kind: str):
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, model=spec.smoke)
    return spec.cell_config(ShapeCell("count", kind, S, B))


def port_cost(arch: str, kind: str, micro: int = MICRO) -> OpCost:
    """One SMOKE step on meta tensors, no mesh: a train step (``micro``
    microbatches), a prefill of B × S, or a decode step against an S-slot
    cache."""
    cfg = _cfg(arch, kind)
    model = Transformer(cfg, "meta")
    Np = cfg.vision_prefix_len if cfg.modality == "vision_prefix" else 0
    tokens = torch.empty((B, S - Np), dtype=torch.int32, device="meta")
    prefix = (torch.empty((B, Np, cfg.d_model), dtype=cfg.adt, device="meta")
              if Np else None)
    if kind == "train":
        step = make_train_step(model, OptConfig(), n_microbatches=micro)
        batch = {"tokens": tokens} | ({"prefix": prefix} if Np else {})
        return analyze(step, abstract_train_state(cfg), batch)
    if kind == "prefill":
        return analyze(model.forward_full, tokens, prefix_embeds=prefix,
                       return_cache=True)
    rows = torch.empty((B,), dtype=torch.int32, device="meta")
    return analyze(model.forward_decode, rows,
                   init_cache(cfg, B, S, device="meta"), rows)


def closed_products(arch: str, kind: str, micro: int = MICRO) -> int:
    """The products of one step: 2 · tokens · |W| for every weight matrix a
    token meets (the experts' over their slots), the flash kernels' 4 · dh
    flops a kept pair and query head (the backward's 10), the decode
    kernel's over the whole cache, MLA's latent products, and the head; a
    train step takes every product three times (the forward, the input's
    and the weight's gradients), the remat recompute the blocks' forward
    again but a dense block's last product (``torch.utils.checkpoint``
    stops once the tensors the backward saved are made again), and the
    attention kernels' forward twice and backward once."""
    cfg = _cfg(arch, kind)
    D, L, V, H, dh = (cfg.d_model, cfg.n_layers, cfg.padded_vocab,
                      cfg.n_heads_eff, cfg.d_head)
    rows = B // micro if kind == "train" else B
    T = rows * (1 if kind == "decode" else S)
    attn_pairs = rows * H * (kept_pairs(S, S) if kind != "decode" else S)
    if cfg.use_mla:
        r, rq, dr = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.d_rope
        w = D * rq + rq * H * (dh + dr) + D * (r + dr) + H * dh * D
        if kind == "decode":      # absorbed: q·W_uk, the scores, ctx, W_uv
            attn = 2 * T * w + 2 * T * H * (dh * r + r * S + dr * S
                                             + S * r + r * dh)
            kernel = 0
        else:                     # k and v from the latent; v padded to dh + dr
            attn = 2 * T * (w + 2 * r * H * dh)
            kernel = 4 * (dh + dr) * attn_pairs
    else:
        attn = 2 * T * D * dh * (2 * H + 2 * cfg.n_kv_heads_eff)
        kernel = 4 * dh * attn_pairs
    last = 0
    if cfg.family == "moe":
        E, k, Fe = cfg.n_experts, cfg.experts_per_token, cfg.d_ff_expert
        cap = capacity(T, k, E, cfg.capacity_factor)
        ffn = (2 * T * D * E + 3 * 2 * E * cap * D * Fe + 2 * T * D * k
               + 3 * 2 * T * D * cfg.n_shared_experts * Fe)
    else:
        ffn = 3 * 2 * T * D * cfg.d_ff
        last = 2 * T * cfg.d_ff * D           # the down product
    blocks, head = L * (attn + ffn), 2 * T * D * V
    if kind != "train":
        return blocks + head + L * kernel
    return micro * (3 * (blocks + head) + blocks - L * last
                    + L * kernel * (1 + 1 + 10 / 4))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b",
                                  "deepseek-v2-236b", "internvl2-26b"])
def test_products_equal_closed_form(arch, kind):
    cost = port_cost(arch, kind)
    assert cost.products == closed_products(arch, kind)
    assert cost.flops > cost.products > 0 and cost.transcendentals > 0
    calls = {k: v["calls"] for k, v in cost.kernels.items()}
    L = _cfg(arch, kind).n_layers
    if kind == "train":
        assert calls == {"flash_attention": 2 * L * MICRO,
                         "flash_attention_bwd_wgmma": L * MICRO}
    elif kind == "prefill":
        assert calls == {"flash_attention": L}
    else:
        assert calls == ({} if arch == "deepseek-v2-236b"
                         else {"decode_attention": L})


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_ssm_products_cover_their_projections(arch, kind):
    """The SSM families: at least the projections' products (their scans'
    chunked products on top, not in closed form here)."""
    cfg = _cfg(arch, kind)
    D, E, N, Hs = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    T = (B // MICRO) * S if kind == "train" else B * (1 if kind == "decode" else S)
    proj = 2 * T * cfg.n_mamba_layers * (D * (2 * E + 2 * N + Hs) + E * D)
    head = 2 * T * D * cfg.padded_vocab
    cost = port_cost(arch, kind)
    floor = proj + head if kind != "train" else MICRO * 3 * (proj + head)
    assert cost.products > floor
