"""The LM of the JAX package's ``models/transformer.py``, in PyTorch.

:class:`ModelConfig` keeps the reference's fields (``adt``/``pdt`` are torch
dtypes here).  :class:`Transformer` covers the reference's four families
with an ``nn.ModuleList`` of blocks: ``dense`` (a pre-norm GQA transformer:
qwen2.5, granite, codeqwen, command-r, musicgen's and internvl2's
backbones), ``moe`` (GQA or MLA attention with top-k routed experts: olmoe,
deepseek-v2), ``ssm`` (an attention-free Mamba2 stack: mamba2) and
``hybrid`` (a Mamba2 backbone with one *shared* attention block at 2 ×
d_model over concat(hidden, initial embedding), applied after every
``hybrid_attn_every − 1`` Mamba2 layers: zamba2).  Two entry points:

* :meth:`Transformer.forward_full` — teacher-forced full-sequence forward,
  after an optional prefix of embeddings (internvl2's vision patches);
  with ``return_cache`` it also returns the serving caches (prefill), and
  the summed router aux loss of the MoE layers,
* :meth:`Transformer.forward_decode` — one new token per sequence against
  the caches of :func:`init_cache` (``k``/``v``, MLA's latent ``ckv``/
  ``kr``, or the Mamba2 layers' state ``h`` and conv states ``conv_x``/
  ``conv_b``/``conv_c`` beside the shared block's ``k``/``v``), updated in
  place,
* :meth:`Transformer.forward_train` — the same full forward with autograd
  on (both entry points above run under ``no_grad``), each block
  rematerialised in the backward as ``cfg.remat``/``cfg.remat_policy`` ask
  (the reference's ``_maybe_remat``: ``torch.utils.checkpoint`` without
  reentry; ``"nothing"`` saves nothing inside a block, ``"dots"`` saves
  every product's output and ``"dots_nobatch"`` those without a batch
  axis, by selective checkpointing), and :func:`lm_loss`, the reference's
  next-token loss on it.  Every parameter is trainable (``requires_grad``).

Prefill attention runs on the flash-attention kernel and GQA decode
attention on the decode-attention kernel (:mod:`repro_torch.models.
attention`; MLA decode is the reference's plain absorbed form).  The MoE
FFN is :mod:`repro_torch.models.moe`, the Mamba2 block
:mod:`repro_torch.models.mamba2` (PyTorch ops: the reference has no kernel
there).  The hybrid's shared cache is a ring of width ``min(max_len,
attn_window)`` when the config has a window (``long_500k``), written at
``pos % W``; its Mamba2 state caches are indexed in the reference's order,
group g's ``hybrid_attn_every − 1`` layers, then the tail.  Matmul weights, the embedding, the
biases and the head are held in the activation dtype (the reference casts
them on every einsum, which gives the same values); the norm weights keep
the parameter dtype, and so do MLA's ``w_uv`` and ``wo``, which the
reference's absorbed decode multiplies in float32; the MoE router is
float32 always.  Products the reference computes with an fp32 result keep
it (``layers.dot_f32``, ``layers.bmm_f32``).  On the card the model turns
TF32 off: float32 products run in full float32.

:func:`init_params` makes random weights with the reference's he-scaled
normal distribution directly on the device (not the JAX values: the two
generators differ); :func:`params_from_reference` carries a JAX parameter
tree across.

On a mesh whose plan shards leaves over ``model`` (a
:class:`~repro_torch.sharding.tp.ModelSplit`, every family) the
model holds each such leaf as this rank's shard and runs Megatron's split:
the attention on its query heads (against the KV heads they read; MLA on
its heads, its latent caches over the sequence), the FFN on its columns
(MoE: its experts' slots, the router's columns gathered, the shared
experts' columns), a Mamba2 layer on its SSM heads (the states over its
heads and channels), zamba2's shared block on its own heads, KV heads and
FFN columns at 2 · d_model (its cache over KV heads), the embedding as a lookup of its vocabulary rows (zeros
elsewhere) summed over ``model``, the head on its vocabulary columns: the
logits of :meth:`Transformer.forward_full`, :meth:`~Transformer.
forward_train` and :meth:`~Transformer.forward_decode` are then this
rank's columns (``tp.gather_from_model`` gives the whole row) and
:func:`lm_loss` reduces over the ranks.  :func:`init_params` and
:func:`params_from_reference` draw or read the whole tree on every rank and
keep each rank's shards; :func:`init_cache` gives the rank's caches.
``shard_act`` checks the residual stream (whole over ``model``) and the
logits (the rank's columns) against the plan's hints where they are
installed.

Served over data-parallel ranks (a :class:`~repro_torch.sharding.tp.
DataSplit`), :func:`init_cache` gives a rank its rows of the batch, and
the entry points run on whatever rows they are given.  Where the plan
shards weights over ``data`` too (FSDP), the model holds each such leaf as
the rank's ``data`` shard (of its ``model`` shard) and gathers one layer's
leaves over ``data`` just before that layer runs, dropping them after it,
but for the leaves it computes with on their shard (``tp.HELD``: the
embedding, the head, the routed experts and the attention's ``wo``), whose
products move the activations instead (``tp.DataSplit.apply``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.device import resolve_device
from repro_torch.models.attention import (gqa_decode, gqa_prefill, init_gqa,
                                          init_mla, mla_decode, mla_prefill)
from repro_torch.models.layers import (cross_entropy_loss, dot_f32, he_init,
                                       init_mlp, mlp_swiglu, normal_init,
                                       pad_vocab, rms_norm, rope_freqs,
                                       rope_table)
from repro_torch.models.mamba2 import init_mamba2, mamba2_decode, mamba2_prefill
from repro_torch.models.moe import moe_ffn, moe_leaves
from repro_torch.sharding.ctx import shard_act
from repro_torch.sharding.tp import (DataSplit, ModelSplit, copy_to_model,
                                     reduce_from_model)

__all__ = ["ModelConfig", "Transformer", "init_params", "init_cache",
           "abstract_params", "params_from_reference", "lm_loss"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
FAMILIES = ("dense", "moe", "ssm", "hybrid")
SSM_KEYS = ("h", "conv_x", "conv_b", "conv_c")    # a Mamba2 layer's caches


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    # --- MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    d_rope: int = 0
    # --- SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid (zamba2)
    hybrid_attn_every: int = 0
    attn_window: int = 0            # sliding window; 0 = full causal
    # --- misc
    qkv_bias: bool = False
    # pad MHA head counts up to a multiple (TP feasibility); the padded
    # output-projection rows are zero-initialized, so the function is
    # unchanged at init.  Only valid for MHA (n_kv_heads == n_heads).
    head_pad_multiple: int = 0
    # bf16 attention probabilities for the P·V product (fp32 softmax stats)
    attn_probs_bf16: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    modality: str = "text"          # text | audio_tokens | vision_prefix
    vision_prefix_len: int = 0
    act_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    vocab_pad_multiple: int = 256
    kv_chunk: int = 1024
    remat: bool = True
    remat_policy: str = "nothing"     # nothing | dots (save matmul outputs)

    # ------------------------------------------------------------ derived
    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size, self.vocab_pad_multiple)

    @property
    def adt(self) -> torch.dtype:
        return _DTYPES[self.act_dtype]

    @property
    def pdt(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def d_conv_ch(self) -> int:
        return self.d_inner + 2 * self.ssm_state

    @property
    def hybrid_groups(self) -> int:
        return self.n_layers // self.hybrid_attn_every if self.hybrid_attn_every else 0

    @property
    def hybrid_tail(self) -> int:
        return self.n_layers - self.hybrid_groups * self.hybrid_attn_every

    @property
    def n_mamba_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid":
            return self.hybrid_groups * (self.hybrid_attn_every - 1) + self.hybrid_tail
        return 0

    @property
    def uses_attention(self) -> bool:
        return self.family in ("dense", "moe", "hybrid")

    @property
    def n_heads_eff(self) -> int:
        if self.head_pad_multiple and not self.use_mla:
            if self.n_kv_heads != self.n_heads:
                raise ValueError("head padding is only function-preserving for MHA")
            m = self.head_pad_multiple
            return -(-self.n_heads // m) * m
        return self.n_heads

    @property
    def n_kv_heads_eff(self) -> int:
        if self.head_pad_multiple and not self.use_mla:
            return self.n_heads_eff if self.n_kv_heads == self.n_heads else self.n_kv_heads
        return self.n_kv_heads


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def _cache_keys(cfg: ModelConfig) -> tuple[str, str]:
    return ("ckv", "kr") if cfg.use_mla else ("k", "v")


def _shared_dh(cfg: ModelConfig) -> int:
    """The hybrid shared block's head width: 2 · d_model / n_heads."""
    return 2 * cfg.d_model // cfg.n_heads


def _shared_kv(cfg: ModelConfig, split: ModelSplit | None) -> int:
    """The KV heads of the hybrid's shared cache a rank holds."""
    b = split.block if split is not None else None
    return cfg.n_kv_heads if b is None or b.kv is None else b.kv[1] - b.kv[0]


def _rope_dim(cfg: ModelConfig) -> int:
    return cfg.d_rope if cfg.use_mla else cfg.d_head


def _param(shape: tuple[int, ...], dtype: torch.dtype,
           device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


_ATEN = torch.ops.aten
# the reference's remat policies as the products whose outputs a block
# keeps: every product ("dots"), or those without a batch axis
# ("dots_nobatch": the weight products; attention's scores live inside the
# flash kernels and are recomputed under every policy)
_SAVED_PRODUCTS = {
    "dots": (_ATEN.mm.default, _ATEN.mm.dtype, _ATEN.addmm.default,
             _ATEN.bmm.default, _ATEN.bmm.dtype, _ATEN.baddbmm.default),
    "dots_nobatch": (_ATEN.mm.default, _ATEN.mm.dtype, _ATEN.addmm.default),
}


def _keep_products(saved: tuple, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _block_runner(cfg: ModelConfig, train: bool) -> Callable:
    """How the full forward runs one block: directly, or (training, with
    ``cfg.remat``) under ``torch.utils.checkpoint`` with the policy's
    saved products."""
    if not (train and cfg.remat):
        return lambda fn, *args: fn(*args)
    if cfg.remat_policy == "nothing":
        kw = {}
    elif cfg.remat_policy in _SAVED_PRODUCTS:
        policy = functools.partial(_keep_products,
                                   _SAVED_PRODUCTS[cfg.remat_policy])
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, policy)}
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False,
                                        preserve_rng_state=False, **kw)


# ==================================================================== modules
class Block(nn.Module):
    """One pre-norm block: RMSNorm → attention → residual → RMSNorm → FFN →
    residual.  ``attn`` holds GQA's or MLA's leaves, and ``mlp`` (dense) or
    ``moe`` (with ``shared``, deepseek's shared experts, beside it) the
    FFN's, under the reference's leaf names."""

    NORMS = ("norm1", "norm2")

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 split: ModelSplit | None = None,
                 data: DataSplit | None = None) -> None:
        super().__init__()
        D, F, dh = cfg.d_model, cfg.d_ff, cfg.d_head
        H, KV = cfg.n_heads_eff, cfg.n_kv_heads_eff
        mdt, ndt = cfg.adt, cfg.pdt
        self.split = split
        # the leaves it computes with on their data shard (FSDP, tp.HELD)
        self.wo_data = _in_place(data, "blocks/attn/wo")
        self.moe_data = _in_place(data, "blocks/moe/w_gate")
        at = _local_shape(split, "blocks/", data)
        self.norm1 = _param((D,), ndt, device)
        self.norm2 = _param((D,), ndt, device)
        if cfg.use_mla:
            attn = _mla_params(cfg, mdt, ndt, device, at)
        else:
            attn = _gqa_params(D, H, KV, dh, cfg.qkv_bias, mdt, device, at)
        self.attn = nn.ParameterDict(attn)
        if cfg.family == "moe":
            E, Fe = cfg.n_experts, cfg.d_ff_expert
            self.moe = nn.ParameterDict({
                "router": _param(at("moe/router", (D, E)), torch.float32,
                                 device),
                "w_gate": _param(at("moe/w_gate", (E, D, Fe)), mdt, device),
                "w_up": _param(at("moe/w_up", (E, D, Fe)), mdt, device),
                "w_down": _param(at("moe/w_down", (E, Fe, D)), mdt, device)})
            if cfg.n_shared_experts:
                Fs = cfg.n_shared_experts * Fe
                self.shared = nn.ParameterDict(
                    {"w_gate": _param(at("moe/shared/w_gate", (D, Fs)), mdt,
                                      device),
                     "w_up": _param(at("moe/shared/w_up", (D, Fs)), mdt, device),
                     "w_down": _param(at("moe/shared/w_down", (Fs, D)), mdt,
                                      device)})
        else:
            self.mlp = nn.ParameterDict(
                {"w_gate": _param(at("mlp/w_gate", (D, F)), mdt, device),
                 "w_up": _param(at("mlp/w_up", (D, F)), mdt, device),
                 "w_down": _param(at("mlp/w_down", (F, D)), mdt, device)})

    def groups(self) -> dict[str, nn.ParameterDict]:
        """The reference tree's groups under a block, by path."""
        out = {"attn": self.attn}
        if hasattr(self, "moe"):
            out["moe"] = self.moe
            if hasattr(self, "shared"):
                out["moe/shared"] = self.shared
        else:
            out["mlp"] = self.mlp
        return out

    def _ffn(self, cfg: ModelConfig, h: torch.Tensor):
        if cfg.family != "moe":
            return mlp_swiglu(self.mlp, h, self.split), None
        p = dict(self.moe)
        if hasattr(self, "shared"):
            p["shared"] = self.shared
        kw = {} if self.split is None else {"split": self.split}
        if self.moe_data is not None:
            kw["data"] = self.moe_data
        return moe_ffn(p, h, k=cfg.experts_per_token,
                       capacity_factor=cfg.capacity_factor, **kw)

    def full(self, cfg: ModelConfig, x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, window: int, plain: bool):
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        if cfg.use_mla:
            a, cache = mla_prefill(self.attn, h, cos, sin,
                                   probs_bf16=cfg.attn_probs_bf16, plain=plain,
                                   split=self.split, data=self.wo_data)
        else:
            a, cache = gqa_prefill(self.attn, h, cos, sin, window=window,
                                   probs_bf16=cfg.attn_probs_bf16, plain=plain,
                                   split=self.split, data=self.wo_data)
        x = x + a
        f, aux = self._ffn(cfg, rms_norm(x, self.norm2, cfg.norm_eps))
        return x + f, cache, aux

    def decode(self, cfg: ModelConfig, x: torch.Tensor, c0: torch.Tensor,
               c1: torch.Tensor, pos: torch.Tensor, cache_len,
               cos: torch.Tensor, sin: torch.Tensor, cache_start=None):
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        if cfg.use_mla:
            a, _ = mla_decode(self.attn, h, c0, c1, pos, cos, sin,
                              cache_len=cache_len, split=self.split,
                              data=self.wo_data)
        else:
            a, _ = gqa_decode(self.attn, h, c0, c1, pos, cos, sin,
                              window=cfg.attn_window, cache_len=cache_len,
                              cache_start=cache_start, split=self.split,
                              data=self.wo_data)
        x = x + a
        f, _ = self._ffn(cfg, rms_norm(x, self.norm2, cfg.norm_eps))
        return x + f


def _gqa_params(D: int, H: int, KV: int, dh: int, bias: bool, mdt: torch.dtype,
                device: torch.device, at: Callable | None = None
                ) -> dict[str, nn.Parameter]:
    at = at or (lambda name, shape: shape)
    out = {"wq": _param(at("attn/wq", (D, H, dh)), mdt, device),
           "wk": _param(at("attn/wk", (D, KV, dh)), mdt, device),
           "wv": _param(at("attn/wv", (D, KV, dh)), mdt, device),
           "wo": _param(at("attn/wo", (H, dh, D)), mdt, device)}
    if bias:
        out.update(bq=_param(at("attn/bq", (H, dh)), mdt, device),
                   bk=_param(at("attn/bk", (KV, dh)), mdt, device),
                   bv=_param(at("attn/bv", (KV, dh)), mdt, device))
    return out


def _mla_params(cfg: ModelConfig, mdt: torch.dtype, ndt: torch.dtype,
                device: torch.device, at: Callable) -> dict[str, nn.Parameter]:
    """MLA's leaves (``w_uv`` and ``wo`` in the parameter dtype, which the
    reference's absorbed decode multiplies in float32), each of
    ``at(name, whole shape)``."""
    D, H, dh = cfg.d_model, cfg.n_heads_eff, cfg.d_head
    r, rq, dr = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.d_rope
    attn = {"w_dkv": _param(at("attn/w_dkv", (D, r)), mdt, device),
            "norm_kv": _param((r,), ndt, device),
            "w_kr": _param(at("attn/w_kr", (D, dr)), mdt, device),
            "w_uk": _param(at("attn/w_uk", (r, H, dh)), mdt, device),
            "w_uv": _param(at("attn/w_uv", (r, H, dh)), ndt, device),
            "wo": _param(at("attn/wo", (H, dh, D)), ndt, device)}
    q_in = rq or D
    if rq:
        attn.update(w_dq=_param(at("attn/w_dq", (D, rq)), mdt, device),
                    norm_q=_param((rq,), ndt, device))
    attn.update(w_uq=_param(at("attn/w_uq", (q_in, H, dh)), mdt, device),
                w_qr=_param(at("attn/w_qr", (q_in, H, dr)), mdt, device))
    return attn


def _in_place(data: DataSplit | None, path: str) -> DataSplit | None:
    """The data split a part computes with on its shard of the leaf at
    ``path`` (FSDP, ``tp.HELD``), else None (no split, or the leaf
    gathered a layer at a time)."""
    return None if data is None else data.in_place(path)


def _local_shape(split: ModelSplit | None, prefix: str = "",
                 data: DataSplit | None = None) -> Callable:
    """``at(name, whole shape)`` → the shape this rank holds of the leaf
    ``prefix + name`` (the whole shape without a split): its ``model``
    shard, and of that its ``data`` shard under FSDP."""
    def at(name: str, shape: tuple[int, ...]) -> tuple[int, ...]:
        if split is not None:
            shape = split.local_shape(prefix + name, shape)
        return shape if data is None else data.local_shape(prefix + name, shape)
    return at


class MambaBlock(nn.Module):
    """One Mamba2 layer: RMSNorm → Mamba2 → residual.  ``ssm`` holds the
    reference's leaves: the projections, conv taps and biases and
    ``out_proj`` in the activation dtype (the reference casts them on every
    use), the gate ``norm`` in the parameter dtype, ``A_log``, ``D`` and
    ``dt_bias`` in float32.  Under a ``split`` each leaf the plan shards
    over ``model`` is this rank's shard, and the layer runs on its SSM
    heads."""

    NORMS = ("norm1",)

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 split: ModelSplit | None = None,
                 data: DataSplit | None = None) -> None:
        super().__init__()
        D, E, N, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        H, mdt, f32 = cfg.ssm_heads, cfg.adt, torch.float32
        self.split = split
        at = _local_shape(split, "blocks/ssm/", data)
        self.norm1 = _param((D,), cfg.pdt, device)
        shapes = {"w_z": ((D, E), mdt), "w_x": ((D, E), mdt),
                  "w_b": ((D, N), mdt), "w_c": ((D, N), mdt),
                  "w_dt": ((D, H), mdt),
                  "conv_x_w": ((W, E), mdt), "conv_x_b": ((E,), mdt),
                  "conv_b_w": ((W, N), mdt), "conv_b_b": ((N,), mdt),
                  "conv_c_w": ((W, N), mdt), "conv_c_b": ((N,), mdt),
                  "A_log": ((H,), f32), "D": ((H,), f32),
                  "dt_bias": ((H,), f32), "norm": ((E,), cfg.pdt),
                  "out_proj": ((E, D), mdt)}
        self.ssm = nn.ParameterDict({k: _param(at(k, shape), dt, device)
                                     for k, (shape, dt) in shapes.items()})

    def groups(self) -> dict[str, nn.ParameterDict]:
        return {"ssm": self.ssm}

    def full(self, cfg: ModelConfig, x: torch.Tensor):
        y, state = mamba2_prefill(self.ssm, rms_norm(x, self.norm1, cfg.norm_eps),
                                  chunk=cfg.ssm_chunk, split=self.split)
        return x + y, state

    def decode(self, cfg: ModelConfig, x: torch.Tensor,
               state: tuple[torch.Tensor, ...]) -> torch.Tensor:
        y, _ = mamba2_decode(self.ssm, rms_norm(x, self.norm1, cfg.norm_eps),
                             state, self.split)
        return x + y


class SharedAttn(nn.Module):
    """zamba2's shared block at 2 · d_model over concat(hidden, initial
    embedding): RMSNorm → GQA (``n_heads`` / ``n_kv_heads`` heads of
    2 · d_model / ``n_heads``) → residual → RMSNorm → SwiGLU MLP →
    residual → the ``out`` projection back to d_model, added to the
    hidden state.  One set of weights serves every application.  Under a
    split with a ``block`` (the plan's ranges for the shared block) the
    attention runs on this rank's heads and the MLP on its columns,
    column- and row-parallel as a dense block's; ``out`` and the norms stay
    whole."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 split: ModelSplit | None = None,
                 data: DataSplit | None = None) -> None:
        super().__init__()
        d2, mdt, F = 2 * cfg.d_model, cfg.adt, cfg.d_ff
        self.split = split.block if split is not None else None
        self.wo_data = _in_place(data, "shared_attn/attn/wo")
        at = _local_shape(self.split, "shared_attn/", data)
        self.norm1 = _param((d2,), cfg.pdt, device)
        self.norm2 = _param((d2,), cfg.pdt, device)
        self.attn = nn.ParameterDict(_gqa_params(
            d2, cfg.n_heads, cfg.n_kv_heads, _shared_dh(cfg), False, mdt, device,
            at))
        self.mlp = nn.ParameterDict(
            {"w_gate": _param(at("mlp/w_gate", (d2, F)), mdt, device),
             "w_up": _param(at("mlp/w_up", (d2, F)), mdt, device),
             "w_down": _param(at("mlp/w_down", (F, d2)), mdt, device)})
        self.out = _param(at("out", (d2, cfg.d_model)), mdt, device)

    def groups(self) -> dict[str, nn.ParameterDict]:
        return {"attn": self.attn, "mlp": self.mlp}

    def _tail(self, cfg: ModelConfig, x: torch.Tensor, z: torch.Tensor,
              a: torch.Tensor) -> torch.Tensor:
        z = z + a
        z = z + mlp_swiglu(self.mlp, rms_norm(z, self.norm2, cfg.norm_eps),
                           self.split)
        return x + dot_f32(z, self.out.to(z.dtype)).to(z.dtype)

    def full(self, cfg: ModelConfig, x: torch.Tensor, emb0: torch.Tensor,
             cos: torch.Tensor, sin: torch.Tensor, window: int, plain: bool):
        z = torch.cat([x, emb0], dim=-1)
        a, cache = gqa_prefill(self.attn, rms_norm(z, self.norm1, cfg.norm_eps),
                               cos, sin, window=window, plain=plain,
                               split=self.split, data=self.wo_data)
        return self._tail(cfg, x, z, a), cache

    def decode(self, cfg: ModelConfig, x: torch.Tensor, emb0: torch.Tensor,
               kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
               write_pos: torch.Tensor, valid_len: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        z = torch.cat([x, emb0], dim=-1)
        a, _ = gqa_decode(self.attn, rms_norm(z, self.norm1, cfg.norm_eps),
                          kc, vc, pos, cos, sin, write_pos=write_pos,
                          valid_len=valid_len, split=self.split,
                          data=self.wo_data)
        return self._tail(cfg, x, z, a)


class Transformer(nn.Module):
    """The LM of any family; its parameters are allocated, not initialised
    (see :func:`init_params` and :func:`params_from_reference`).  With a
    ``split`` each leaf the plan shards over ``model`` is allocated as
    this rank's shard; with a ``data`` split that shards leaves over
    ``data`` (FSDP, serving only), each such leaf as this rank's ``data``
    shard of that, gathered whole for the run of its layer."""

    def __init__(self, cfg: ModelConfig,
                 device: torch.device | str | None = None,
                 split: ModelSplit | None = None,
                 data: DataSplit | None = None) -> None:
        super().__init__()
        _check_family(cfg)
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = dev
        self.split = split
        self.data = data
        at = _local_shape(split, "", data)
        Vp, D = cfg.padded_vocab, cfg.d_model
        self.embed = _param(at("embed", (Vp, D)), cfg.adt, dev)
        self.final_norm = _param((D,), cfg.pdt, dev)
        self.lm_head = _param(at("lm_head", (D, Vp)), cfg.adt, dev)
        if cfg.family in ("dense", "moe"):
            self.blocks = nn.ModuleList(Block(cfg, dev, split, data)
                                        for _ in range(cfg.n_layers))
        else:
            self.blocks = nn.ModuleList(MambaBlock(cfg, dev, split, data)
                                        for _ in range(cfg.n_mamba_layers))
        if cfg.family == "hybrid":
            self.shared_attn = SharedAttn(cfg, dev, split, data)
        self.embed_data = _in_place(data, "embed")
        self.head_data = _in_place(data, "lm_head")
        # the FSDP leaves of each part that runs as one (a block, the
        # shared block, the embedding, the head): (owner, name, path)
        self._fsdp: dict[Any, list] = {}
        if data is not None and data.fsdp:
            self._fsdp.update({name: [(self, name, name)] for name in
                               ("embed", "lm_head") if name in data.fsdp
                               and not data.held(name)})
            for mod, prefix in ([(b, "blocks/") for b in self.blocks]
                                + ([(self.shared_attn, "shared_attn/")]
                                   if cfg.family == "hybrid" else [])):
                owners = {"": mod, **{g + "/": pd for g, pd in mod.groups().items()}}
                self._fsdp[mod] = [
                    (owner, name, prefix + g + name)
                    for g, owner in owners.items()
                    for name, _ in owner.named_parameters(recurse=False)
                    if prefix + g + name in data.fsdp
                    and not data.held(prefix + g + name)]

    @contextlib.contextmanager
    def _gathered(self, part: Any):
        """Run the enclosed code with the FSDP leaves of ``part`` (a block,
        the shared block, or ``"embed"``/``"lm_head"``) gathered over
        ``data``: one all-gather a leaf, the gathered tensor dropped on
        exit and the rank's shard put back."""
        leaves = self._fsdp.get(part)
        if not leaves:
            yield
            return
        kept = [(owner, name, getattr(owner, name)) for owner, name, _ in leaves]
        try:
            for (owner, name, path), (_, _, t) in zip(leaves, kept):
                setattr(owner, name, nn.Parameter(self.data.gather(t, path),
                                                  requires_grad=False))
            yield
        finally:
            for owner, name, t in kept:
                setattr(owner, name, t)

    def _tokens(self, tokens: Any) -> torch.Tensor:
        t = tokens if torch.is_tensor(tokens) else torch.as_tensor(np.asarray(tokens))
        return t.to(device=self.device, dtype=torch.long)

    def _embed(self, tok: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tok``; vocab-parallel under a split of
        the embedding's rows: this rank's rows, zeros for the others'
        tokens, summed over ``model`` (one nonzero row: exact)."""
        sp, ds = self.split, self.embed_data

        def lookup(tok: torch.Tensor) -> torch.Tensor:
            if sp is None or sp.vocab_in is None:
                return self.embed[tok]
            v0, v1 = sp.vocab_in
            t = tok - v0
            # an empty piece: zero rows (the empty table's sum keeps it in
            # the graph)
            rows = (self.embed[t.clamp(0, v1 - v0 - 1)] if v1 > v0 else
                    self.embed.sum(0).expand(*tok.shape, self.embed.shape[1]))
            mine = ((t >= 0) & (t < v1 - v0))[..., None]
            return reduce_from_model(
                torch.where(mine, rows, torch.zeros_like(rows)), sp)

        if ds is not None:                          # this rank's columns
            return ds.apply(lookup, tok, cols=True)
        with self._gathered("embed"):
            return lookup(tok)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        D, Vp = self.cfg.d_model, self.cfg.padded_vocab
        x = rms_norm(shard_act(x, "hidden", (None, None, D)), self.final_norm,
                     self.cfg.norm_eps)
        sp = self.split
        if sp is not None and sp.vocab_out is not None:
            x = copy_to_model(x, sp)
        ds = self.head_data
        if ds is not None:                           # its rows: partial sums
            a, b = ds.cols(D)
            logits = ds.apply(lambda y: dot_f32(y[..., a:b], self.lm_head), x,
                              cols=False)
        else:
            with self._gathered("lm_head"):
                logits = dot_f32(x, self.lm_head)
        return shard_act(logits, "logits", (None, None, Vp))

    @torch.no_grad()
    def forward_full(self, tokens: Any, *,
                     prefix_embeds: torch.Tensor | None = None,
                     window: int | None = None, return_cache: bool = False,
                     plain_attention: bool = False
                     ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
        """Teacher-forced forward of ``tokens`` (B, S), after
        ``prefix_embeds`` (B, Np, D) where given (cast to the activation
        dtype and put before the tokens' embeddings, so positions count from
        the prefix).  Returns (logits (B, Np + S, Vp) fp32 — under a split
        of the head this rank's columns —, the caches or None, aux: the MoE
        layers' summed router loss, a float32 scalar, 0 for the other
        families).  Caches: {"k", "v"} of (L, B, S, KV, dh);
        under MLA {"ckv", "kr"} of (L, B, S, r) and (L, B, S, dr); for the
        Mamba2 layers {"h", "conv_x", "conv_b", "conv_c"} of (M, B, H, N, P)
        float32 and (M, B, W − 1, C), and the hybrid's shared block {"k",
        "v"} of (G, B, S, KV, dh).  ``window`` (None: the config's) is the
        attention's sliding window.  ``plain_attention`` runs the attention
        kernels' plain versions instead of the kernels (a comparison)."""
        return self._forward(tokens, prefix_embeds, window, return_cache,
                             plain_attention, train=False)

    def forward_train(self, tokens: Any, *,
                      prefix_embeds: torch.Tensor | None = None,
                      window: int | None = None,
                      plain_attention: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`forward_full` with autograd on and the config's remat:
        (logits (B, Np + S, Vp) fp32, aux).  Attention runs on the flash
        kernel with its backward kernels (``plain_attention``: the plain
        versions, autograd through them).  Not under FSDP (a serving
        layout: the gathered leaves take no gradient)."""
        if self.data is not None and self.data.fsdp:
            raise NotImplementedError(
                "forward_train on a model whose leaves are sharded over "
                "`data` (FSDP serving): training gathers its masters instead "
                "(train_loop.make_train_step)")
        logits, _, aux = self._forward(tokens, prefix_embeds, window, False,
                                       plain_attention, train=True)
        return logits, aux

    def _forward(self, tokens: Any, prefix_embeds: torch.Tensor | None,
                 window: int | None, return_cache: bool, plain: bool,
                 train: bool) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
        cfg = self.cfg
        run = _block_runner(cfg, train)
        window = cfg.attn_window if window is None else window
        x = self._embed(self._tokens(tokens))
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(device=self.device, dtype=cfg.adt),
                           x], dim=1)
        x = shard_act(x, "hidden", (None, None, cfg.d_model))
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.family == "ssm":
            states = [] if return_cache else None
            x = self._mamba_full(x, range(len(self.blocks)), states, run)
            caches = _stack_states(states) if return_cache else None
        elif cfg.family == "hybrid":
            x, caches = self._hybrid_full(x, window, return_cache, plain, run)
        else:
            cos, sin = rope_table(x.shape[1], _rope_dim(cfg), cfg.rope_theta,
                                  device=self.device)
            c0s, c1s = [], []
            for blk in self.blocks:
                with self._gathered(blk):
                    x, (c0, c1), a = run(functools.partial(blk.full, cfg), x,
                                         cos, sin, window, plain)
                if a is not None:
                    aux = aux + a
                if return_cache:
                    c0s.append(c0)
                    c1s.append(c1)
            caches = (dict(zip(_cache_keys(cfg), (torch.stack(c0s),
                                                  torch.stack(c1s))))
                      if return_cache else None)
        return self._logits(x), caches, aux

    def _mamba_full(self, x: torch.Tensor, layers, states: list | None,
                    run: Callable) -> torch.Tensor:
        """Mamba2 layers ``layers`` (indices into ``blocks``) over x, each
        by ``run``, their final states appended to ``states`` (None:
        dropped)."""
        for i in layers:
            with self._gathered(self.blocks[i]):
                x, st = run(functools.partial(self.blocks[i].full, self.cfg), x)
            if states is not None:
                states.append(st)
        return x

    def _hybrid_layout(self) -> list[tuple[int, int]]:
        """The reference's order of the hybrid's Mamba2 layers: for each
        group g, (the first layer index, the layer count), then the tail."""
        cfg = self.cfg
        k, G = cfg.hybrid_attn_every, cfg.hybrid_groups
        return ([(g * (k - 1), k - 1) for g in range(G)]
                + [(G * (k - 1), cfg.hybrid_tail)])

    def _hybrid_full(self, x: torch.Tensor, window: int, return_cache: bool,
                     plain: bool, run: Callable):
        cfg = self.cfg
        emb0 = x
        cos, sin = rope_table(x.shape[1], _shared_dh(cfg), cfg.rope_theta,
                              device=self.device)
        states = [] if return_cache else None
        kvs = []
        *groups, (t0, tail) = self._hybrid_layout()
        shared = functools.partial(self.shared_attn.full, cfg)
        for first, n in groups:
            x = self._mamba_full(x, range(first, first + n), states, run)
            with self._gathered(self.shared_attn):
                x, kv = run(shared, x, emb0, cos, sin, window, plain)
            if return_cache:
                kvs.append(kv)
        x = self._mamba_full(x, range(t0, t0 + tail), states, run)
        if not return_cache:
            return x, None
        caches = _stack_states(states)
        kv_shape = (0, x.shape[0], x.shape[1], _shared_kv(cfg, self.split),
                    _shared_dh(cfg))
        for i, key in enumerate(("k", "v")):
            caches[key] = (torch.stack([kv[i] for kv in kvs]) if kvs
                           else x.new_zeros(kv_shape))
        return x, caches

    @torch.no_grad()
    def forward_decode(self, token: Any, caches: dict[str, torch.Tensor],
                       pos: Any) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One decode step: ``token`` (B,) at positions ``pos`` (B,).
        Returns (logits (B, Vp) fp32 — under a split of the head this
        rank's columns —, caches), the caches updated in place.
        ``pos`` on the host (a numpy array, as the engine keeps it) is
        checked there and costs no synchronisation; with ``token`` on the
        host too, both reach the card in one copy, with what every layer
        needs made there: ``cache_len = pos + 1``, or for the hybrid's
        shared cache of width W the ring's slot ``pos % W`` and its valid
        length ``min(pos + 1, W)``.  ``pos`` on the card is not read back.
        The ``ssm`` family reads no position (its one copy is the tokens).
        """
        cfg = self.cfg
        tok = token if torch.is_tensor(token) else torch.as_tensor(np.asarray(token))
        if cfg.family == "ssm":
            tok = tok.reshape(-1).long()
            if tok.device.type == "cpu":
                tok = tok.to(self.device, non_blocking=True)
            x = self._embed(self._tokens(tok)[:, None])       # (B, 1, D)
            for blk, *st in zip(self.blocks, *(caches[k] for k in SSM_KEYS)):
                with self._gathered(blk):
                    x = blk.decode(cfg, x, tuple(st))
            return self._logits(x)[:, 0], caches
        p = pos if torch.is_tensor(pos) else torch.as_tensor(np.asarray(pos))
        hybrid = cfg.family == "hybrid"
        keys = ("k", "v") if hybrid else _cache_keys(cfg)
        S = caches[keys[0]].shape[2]
        if self.split is not None and self.split.cache == "seq":
            S *= self.split.m               # the ranks' pieces of the sequence
        # a full-length cache bounds the positions; a ring wraps
        limit = S if not (hybrid and cfg.attn_window) else None
        if p.device.type == "cpu":
            p = p.reshape(-1).long()
            if bool((p < 0).any()) or (limit is not None
                                      and bool((p >= limit).any())):
                raise ValueError(f"decode positions {p.tolist()} outside "
                                 f"[0, {limit if limit is not None else 'inf'})")
            rows = [p] + ([p % S, torch.clamp_max(p + 1, S)] if hybrid else [])
            if tok.device.type == "cpu":
                both = torch.stack([tok.reshape(-1).long()] + rows)
                tok, *rows = both.to(self.device, non_blocking=True)
            else:
                rows = list(torch.stack(rows).to(self.device, non_blocking=True))
        else:
            p = p.to(device=self.device, dtype=torch.long)
            rows = [p] + ([p % S, torch.clamp_max(p + 1, S)] if hybrid else [])
        p = rows[0].to(torch.int32)
        x = self._embed(self._tokens(tok)[:, None])           # (B, 1, D)
        dim = _shared_dh(cfg) if hybrid else _rope_dim(cfg)
        ang = p.float()[:, None] * rope_freqs(dim, cfg.rope_theta,
                                              self.device)[None, :]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        if hybrid:
            x = self._hybrid_decode(x, caches, p, rows[1],
                                    rows[2].to(torch.int32), cos, sin)
        else:
            cache_len = p + 1
            # a window on the full-length cache: each row's first key, on
            # the card, once a step
            start = ((cache_len - cfg.attn_window).clamp_min(0)
                     if cfg.attn_window and not cfg.use_mla else None)
            for blk, c0, c1 in zip(self.blocks, caches[keys[0]], caches[keys[1]]):
                with self._gathered(blk):
                    x = blk.decode(cfg, x, c0, c1, p, cache_len, cos, sin,
                                   start)
        return self._logits(x)[:, 0], caches

    def _hybrid_decode(self, x, caches, p, write_pos, valid_len, cos, sin):
        cfg = self.cfg
        emb0 = x
        state = list(zip(*(caches[k] for k in SSM_KEYS)))
        *groups, (t0, tail) = self._hybrid_layout()
        def mamba(i, x):
            with self._gathered(self.blocks[i]):
                return self.blocks[i].decode(cfg, x, state[i])

        for g, (first, n) in enumerate(groups):
            for i in range(first, first + n):
                x = mamba(i, x)
            with self._gathered(self.shared_attn):
                x = self.shared_attn.decode(cfg, x, emb0, caches["k"][g],
                                            caches["v"][g], p, write_pos,
                                            valid_len, cos, sin)
        for i in range(t0, t0 + tail):
            x = mamba(i, x)
        return x


def lm_loss(model: Transformer, tokens: Any, *,
            prefix_embeds: torch.Tensor | None = None,
            loss_mask: torch.Tensor | None = None,
            plain_attention: bool = False) -> torch.Tensor:
    """Next-token cross entropy (+ ``router_aux_weight`` · the router aux
    loss) of :meth:`Transformer.forward_train`: the prefix's positions are
    sliced off, targets are the tokens shifted by one, ``loss_mask`` (B,
    S − 1) over the target positions.  A float32 scalar with autograd."""
    cfg = model.cfg
    tok = model._tokens(tokens)
    logits, aux = model.forward_train(tok, prefix_embeds=prefix_embeds,
                                      plain_attention=plain_attention)
    Np = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    pred = logits[:, Np:, :][:, :-1]
    mask = None if loss_mask is None else torch.as_tensor(loss_mask).to(tok.device)
    ce = cross_entropy_loss(pred, tok[:, 1:], vocab_size=cfg.vocab_size,
                            mask=mask, split=model.split)
    return ce + cfg.router_aux_weight * aux


def _stack_states(states: list) -> dict[str, torch.Tensor]:
    """Per-layer Mamba2 states (h, conv_x, conv_b, conv_c) → the caches,
    stacked on a leading layer axis."""
    return dict(zip(SSM_KEYS, (torch.stack(s) for s in zip(*states))))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device | str | None = None,
               split: ModelSplit | None = None,
               data: DataSplit | None = None) -> dict[str, torch.Tensor]:
    """Zeroed serving caches: {"k", "v"} of (L, B, S, KV, dh), or under MLA
    the latents {"ckv", "kr"} of (L, B, S, r) and (L, B, S, dr), in the
    activation dtype; for the Mamba2 layers (``ssm``, ``hybrid``) the state
    "h" (M, B, H, N, P) in float32 and the conv states "conv_x", "conv_b",
    "conv_c" (M, B, W − 1, C) in the activation dtype, and the hybrid's
    shared {"k", "v"} of (G, B, W, n_kv_heads, 2 · d_model / n_heads), W =
    min(S, attn_window), or S without a window.  Under a ``split`` the
    rank's caches: its KV heads, or where the split puts the cache over the
    sequence (MLA's latents always) every KV head, or the whole latent, at
    ⌈S / m⌉ positions (the last rank's tail past S is never written nor
    read); "h" over its SSM heads, "conv_x" over its channels, and the
    shared block's KV heads.  Under a ``data`` split of the batch, every
    cache holds the rank's rows (:meth:`~repro_torch.sharding.tp.
    DataSplit.rows`): ``conv_b``/``conv_c`` too, which the reference's plan
    keeps whole (every rank decodes only its rows, so the other rows'
    states are the other ranks' to keep)."""
    _check_family(cfg)
    dev = resolve_device(device)
    rows = data.rows(batch) if data is not None else None
    adt, S = cfg.adt, max_len
    B = batch if rows is None else rows[1] - rows[0]

    def zeros(shape, dt=adt):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family in ("dense", "moe"):
        lead = (cfg.n_layers, B, S)
        if split is not None and split.cache == "seq":
            lead = (cfg.n_layers, B, -(-S // split.m))
        if cfg.use_mla:
            shapes = (lead + (cfg.kv_lora_rank,), lead + (cfg.d_rope,))
        else:
            kv = cfg.n_kv_heads_eff
            if split is not None and split.cache != "seq" and split.kv is not None:
                kv = split.kv[1] - split.kv[0]
            shapes = (lead + (kv, cfg.d_head),) * 2
        return {key: zeros(shape) for key, shape in zip(_cache_keys(cfg), shapes)}
    M, W1 = cfg.n_mamba_layers, cfg.ssm_conv - 1
    H, E = cfg.ssm_heads, cfg.d_inner
    if split is not None and split.ssm is not None:
        H, E = split.ssm[1] - split.ssm[0], split.inner[1] - split.inner[0]
    out = {"h": zeros((M, B, H, cfg.ssm_state, cfg.ssm_head_dim), torch.float32),
           "conv_x": zeros((M, B, W1, E)),
           "conv_b": zeros((M, B, W1, cfg.ssm_state)),
           "conv_c": zeros((M, B, W1, cfg.ssm_state))}
    if cfg.family == "hybrid":
        win = min(S, cfg.attn_window) if cfg.attn_window else S
        shape = (cfg.hybrid_groups, B, win, _shared_kv(cfg, split),
                 _shared_dh(cfg))
        out.update(k=zeros(shape), v=zeros(shape))
    return out


# ================================================================ parameters
def _leaves(model: Transformer) -> dict[str, list[torch.Tensor]]:
    """The reference tree's leaf paths → the port's tensors (one per layer
    under ``blocks/``, in layer order)."""
    out: dict[str, list[torch.Tensor]] = {
        "embed": [model.embed], "final_norm": [model.final_norm],
        "lm_head": [model.lm_head]}
    for blk in model.blocks:
        for name in blk.NORMS:
            out.setdefault(f"blocks/{name}", []).append(getattr(blk, name))
        for group, params in blk.groups().items():
            for name, t in params.items():
                out.setdefault(f"blocks/{group}/{name}", []).append(t)
    if hasattr(model, "shared_attn"):
        sa = model.shared_attn
        for name in ("norm1", "norm2", "out"):
            out[f"shared_attn/{name}"] = [getattr(sa, name)]
        for group in ("attn", "mlp"):
            for name, t in getattr(sa, group).items():
                out[f"shared_attn/{group}/{name}"] = [t]
    return out


def _nest(flat: dict[str, Any]) -> dict:
    """``{"a/b": x}`` → ``{"a": {"b": x}}``: the inverse of :func:`_flatten`."""
    out: dict = {}
    for path, t in flat.items():
        *head, leaf = path.split("/")
        node = out
        for key in head:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        flat: dict[str, Any] = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def abstract_params(cfg: ModelConfig) -> dict:
    """The reference's parameter tree as meta tensors (shapes and dtypes,
    nothing allocated): its leaf paths, ``blocks/...`` stacked on a leading
    layer axis, every leaf in the parameter dtype except those the model
    keeps in float32 always (the MoE router, Mamba2's ``A_log``, ``D``,
    ``dt_bias``), as the reference's ``abstract_params`` has them."""
    model = Transformer(dataclasses.replace(cfg, act_dtype=cfg.param_dtype),
                        "meta")
    flat = {}
    for path, ts in _leaves(model).items():
        lead = (len(ts),) if path.startswith("blocks/") else ()
        flat[path] = torch.empty(lead + tuple(ts[0].shape), dtype=ts[0].dtype,
                                 device="meta")
    return _nest(flat)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: torch.device | str | None = None,
                split: ModelSplit | None = None,
                data: DataSplit | None = None) -> Transformer:
    """A :class:`Transformer` with random weights from ``seed``, made on
    ``device`` (None: the card): the reference's distribution (embedding
    N(0, 0.02²), he-scaled normal matrices, unit norms, zero biases, the
    padded heads' output rows zeroed; Mamba2's N(0, 0.1²) conv taps, A = −1,
    D = 1), drawn in float32 by a ``torch.Generator`` and cast to each
    tensor's dtype (the MoE router and Mamba2's ``A_log``, ``D``,
    ``dt_bias`` stay float32).  Under a ``split`` (and a ``data`` split's
    FSDP) every rank draws the whole tree and keeps its shards."""
    model = Transformer(cfg, device, split, data)
    put = functools.partial(_put, data=data)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    D, Vp, F = cfg.d_model, cfg.padded_vocab, cfg.d_ff
    adt = cfg.adt
    with torch.no_grad():
        put(model.embed, split, "embed",
            normal_init(gen, (Vp, D), 0.02, model.embed.dtype))
        model.final_norm.fill_(1.0)
        put(model.lm_head, split, "lm_head",
            he_init(gen, (D, Vp), D, model.lm_head.dtype))
        for blk in model.blocks:
            for name in blk.NORMS:
                getattr(blk, name).fill_(1.0)
            if isinstance(blk, MambaBlock):
                _copy_into(blk.ssm, init_mamba2(
                    gen, D, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                    expand=cfg.ssm_expand, conv_width=cfg.ssm_conv, dtype=adt),
                    split, "blocks/ssm/", data)
                continue
            if cfg.use_mla:
                attn = init_mla(gen, D, cfg.n_heads,
                                kv_lora_rank=cfg.kv_lora_rank,
                                q_lora_rank=cfg.q_lora_rank, d_head=cfg.d_head,
                                d_rope=cfg.d_rope)  # float32: w_uv, wo keep pdt
            else:
                attn = init_gqa(gen, D, cfg.n_heads_eff, cfg.n_kv_heads_eff,
                                cfg.d_head, bias=cfg.qkv_bias, dtype=adt)
                if cfg.n_heads_eff != cfg.n_heads:
                    attn["wo"][cfg.n_heads:] = 0.0
            _copy_into(blk.attn, attn, split, "blocks/attn/", data)
            del attn
            if cfg.family == "moe":     # one whole leaf at a time
                for path, t in moe_leaves(gen, D, cfg.d_ff_expert,
                                          cfg.n_experts,
                                          n_shared=cfg.n_shared_experts,
                                          dtype=adt):
                    group, name = (blk.shared, path[7:]) if path.startswith(
                        "shared/") else (blk.moe, path)
                    put(group[name], split, "blocks/moe/" + path, t)
                    del t
            else:
                _copy_into(blk.mlp, init_mlp(gen, D, F, adt), split,
                           "blocks/mlp/", data)
        if cfg.family == "hybrid":
            sa, d2 = model.shared_attn, 2 * D
            sa.norm1.fill_(1.0)
            sa.norm2.fill_(1.0)
            _copy_into(sa.attn, init_gqa(gen, d2, cfg.n_heads, cfg.n_kv_heads,
                                         _shared_dh(cfg), dtype=adt),
                       split, "shared_attn/attn/", data)
            _copy_into(sa.mlp, init_mlp(gen, d2, F, adt), split,
                       "shared_attn/mlp/", data)
            put(sa.out, None, "shared_attn/out", he_init(gen, (d2, D), d2, adt))
    return model


def _copy_into(params: nn.ParameterDict, values: dict[str, torch.Tensor],
               split: ModelSplit | None = None, prefix: str = "",
               data: DataSplit | None = None) -> None:
    for name, t in values.items():
        _put(params[name], split, prefix + name, t, data)


def _put(param: torch.Tensor, split: ModelSplit | None, path: str,
         whole: torch.Tensor, data: DataSplit | None = None) -> None:
    """``param`` ← this rank's slice of the leaf's ``whole`` value (of
    its ``model`` shard, its ``data`` shard under FSDP)."""
    if split is not None:
        whole = whole[split.local_slices(path, tuple(whole.shape))]
    if data is not None:
        whole = whole[data.local_slices(path, tuple(whole.shape))]
    param.copy_(whole)


def params_from_reference(np_params: dict[str, Any], cfg: ModelConfig,
                          device: torch.device | str | None = None,
                          split: ModelSplit | None = None,
                          data: DataSplit | None = None) -> Transformer:
    """The JAX package's parameter tree (``jax.tree.map(np.asarray,
    init_params(cfg, key))``, blocks stacked on a leading L axis) as a
    :class:`Transformer` on ``device`` (under a ``split``, and a ``data``
    split's FSDP: each rank's shards of the whole tree).  Every leaf is
    used; an unknown or missing leaf, or a shape that does not match,
    raises ``ValueError``."""
    model = Transformer(cfg, device, split, data)
    want = _leaves(model)
    flat = _flatten(np_params)
    unknown, missing = sorted(set(flat) - set(want)), sorted(set(want) - set(flat))
    if unknown or missing:
        raise ValueError(f"params_from_reference: unknown leaves {unknown}, "
                         f"missing leaves {missing}")
    with torch.no_grad():
        for path, targets in want.items():
            a = np.asarray(flat[path])
            stacked = path.startswith("blocks/")
            lead = (len(targets),) if stacked else ()
            one = a.shape[len(lead):]
            if a.shape[:len(lead)] == lead:
                one = _local_shape(split, "", data)(path, tuple(one))
            shape = lead + tuple(targets[0].shape)
            if a.shape[:len(lead)] + tuple(one) != shape:
                raise ValueError(f"params_from_reference: {path} has shape "
                                 f"{a.shape}, expected {shape}")
            src = torch.from_numpy(np.array(a, dtype=np.float32))
            for i, t in enumerate(targets):
                _put(t, split, path, (src[i] if stacked else src).to(
                    device=t.device, dtype=t.dtype), data)
    return model
