"""The LM of the JAX package's ``models/transformer.py``, in PyTorch.

:class:`ModelConfig` keeps the reference's fields (``adt``/``pdt`` are torch
dtypes here).  :class:`Transformer` covers the reference's attention
families: ``dense`` (a pre-norm GQA transformer: qwen2.5, granite, codeqwen,
...) and ``moe`` (GQA or MLA attention with top-k routed experts: olmoe,
deepseek-v2), with an ``nn.ModuleList`` of blocks and two entry points,

* :meth:`Transformer.forward_full` — teacher-forced full-sequence forward;
  with ``return_cache`` it also returns the serving caches (prefill), and
  the summed router aux loss of the MoE layers,
* :meth:`Transformer.forward_decode` — one new token per sequence against
  the caches of :func:`init_cache` (``k``/``v``, or MLA's latent ``ckv``/
  ``kr``), updated in place.

Prefill attention runs on the flash-attention kernel and GQA decode
attention on the decode-attention kernel (:mod:`repro_torch.models.
attention`; MLA decode is the reference's plain absorbed form).  The MoE
FFN is :mod:`repro_torch.models.moe`.  Matmul weights, the embedding, the
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
tree across.  The SSM and hybrid families and prefix embeddings are not
ported (ROADMAP.md, Queue A item 8).  There is no ``shard_act`` (the
identity outside a mesh) and no remat (a training option).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.models.attention import (gqa_decode, gqa_prefill, init_gqa,
                                          init_mla, mla_decode, mla_prefill)
from repro_torch.models.layers import (dot_f32, he_init, init_mlp, mlp_swiglu,
                                       normal_init, pad_vocab, rms_norm,
                                       rope_freqs, rope_table)
from repro_torch.models.moe import init_moe, moe_ffn

__all__ = ["ModelConfig", "Transformer", "init_params", "init_cache",
           "params_from_reference"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_NOT_PORTED = "is not ported yet (ROADMAP.md, Queue A item 8)"


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


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"the {cfg.family!r} family {_NOT_PORTED}")


def _cache_keys(cfg: ModelConfig) -> tuple[str, str]:
    return ("ckv", "kr") if cfg.use_mla else ("k", "v")


def _rope_dim(cfg: ModelConfig) -> int:
    return cfg.d_rope if cfg.use_mla else cfg.d_head


def _param(shape: tuple[int, ...], dtype: torch.dtype,
           device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ==================================================================== modules
class Block(nn.Module):
    """One pre-norm block: RMSNorm → attention → residual → RMSNorm → FFN →
    residual.  ``attn`` holds GQA's or MLA's leaves, and ``mlp`` (dense) or
    ``moe`` (with ``shared``, deepseek's shared experts, beside it) the
    FFN's, under the reference's leaf names."""

    def __init__(self, cfg: ModelConfig, device: torch.device) -> None:
        super().__init__()
        D, F, dh = cfg.d_model, cfg.d_ff, cfg.d_head
        H, KV = cfg.n_heads_eff, cfg.n_kv_heads_eff
        mdt, ndt = cfg.adt, cfg.pdt
        self.norm1 = _param((D,), ndt, device)
        self.norm2 = _param((D,), ndt, device)
        if cfg.use_mla:
            r, rq, dr = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.d_rope
            attn = {"w_dkv": _param((D, r), mdt, device),
                    "norm_kv": _param((r,), ndt, device),
                    "w_kr": _param((D, dr), mdt, device),
                    "w_uk": _param((r, H, dh), mdt, device),
                    "w_uv": _param((r, H, dh), ndt, device),
                    "wo": _param((H, dh, D), ndt, device)}
            q_in = rq or D
            if rq:
                attn.update(w_dq=_param((D, rq), mdt, device),
                            norm_q=_param((rq,), ndt, device))
            attn.update(w_uq=_param((q_in, H, dh), mdt, device),
                        w_qr=_param((q_in, H, dr), mdt, device))
        else:
            attn = {"wq": _param((D, H, dh), mdt, device),
                    "wk": _param((D, KV, dh), mdt, device),
                    "wv": _param((D, KV, dh), mdt, device),
                    "wo": _param((H, dh, D), mdt, device)}
            if cfg.qkv_bias:
                attn.update(bq=_param((H, dh), mdt, device),
                            bk=_param((KV, dh), mdt, device),
                            bv=_param((KV, dh), mdt, device))
        self.attn = nn.ParameterDict(attn)
        if cfg.family == "moe":
            E, Fe = cfg.n_experts, cfg.d_ff_expert
            self.moe = nn.ParameterDict({
                "router": _param((D, E), torch.float32, device),
                "w_gate": _param((E, D, Fe), mdt, device),
                "w_up": _param((E, D, Fe), mdt, device),
                "w_down": _param((E, Fe, D), mdt, device)})
            if cfg.n_shared_experts:
                Fs = cfg.n_shared_experts * Fe
                self.shared = nn.ParameterDict(
                    {"w_gate": _param((D, Fs), mdt, device),
                     "w_up": _param((D, Fs), mdt, device),
                     "w_down": _param((Fs, D), mdt, device)})
        else:
            self.mlp = nn.ParameterDict({"w_gate": _param((D, F), mdt, device),
                                         "w_up": _param((D, F), mdt, device),
                                         "w_down": _param((F, D), mdt, device)})

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
            return mlp_swiglu(self.mlp, h), None
        p = dict(self.moe)
        if hasattr(self, "shared"):
            p["shared"] = self.shared
        return moe_ffn(p, h, k=cfg.experts_per_token,
                       capacity_factor=cfg.capacity_factor)

    def full(self, cfg: ModelConfig, x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, window: int, plain: bool):
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        if cfg.use_mla:
            a, cache = mla_prefill(self.attn, h, cos, sin,
                                   probs_bf16=cfg.attn_probs_bf16, plain=plain)
        else:
            a, cache = gqa_prefill(self.attn, h, cos, sin, window=window,
                                   probs_bf16=cfg.attn_probs_bf16, plain=plain)
        x = x + a
        f, aux = self._ffn(cfg, rms_norm(x, self.norm2, cfg.norm_eps))
        return x + f, cache, aux

    def decode(self, cfg: ModelConfig, x: torch.Tensor, c0: torch.Tensor,
               c1: torch.Tensor, pos: torch.Tensor, cache_len,
               cos: torch.Tensor, sin: torch.Tensor):
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        if cfg.use_mla:
            a, _ = mla_decode(self.attn, h, c0, c1, pos, cos, sin,
                              cache_len=cache_len)
        else:
            a, _ = gqa_decode(self.attn, h, c0, c1, pos, cos, sin,
                              window=cfg.attn_window, cache_len=cache_len)
        x = x + a
        f, _ = self._ffn(cfg, rms_norm(x, self.norm2, cfg.norm_eps))
        return x + f


class Transformer(nn.Module):
    """The dense LM; its parameters are allocated, not initialised (see
    :func:`init_params` and :func:`params_from_reference`)."""

    def __init__(self, cfg: ModelConfig,
                 device: torch.device | str | None = None) -> None:
        super().__init__()
        _check_ported(cfg)
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.device = dev
        Vp, D = cfg.padded_vocab, cfg.d_model
        self.embed = _param((Vp, D), cfg.adt, dev)
        self.final_norm = _param((D,), cfg.pdt, dev)
        self.lm_head = _param((D, Vp), cfg.adt, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev) for _ in range(cfg.n_layers))

    def _tokens(self, tokens: Any) -> torch.Tensor:
        t = tokens if torch.is_tensor(tokens) else torch.as_tensor(np.asarray(tokens))
        return t.to(device=self.device, dtype=torch.long)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return dot_f32(x, self.lm_head)

    @torch.no_grad()
    def forward_full(self, tokens: Any, *, prefix_embeds: Any = None,
                     window: int | None = None, return_cache: bool = False,
                     plain_attention: bool = False
                     ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
        """Teacher-forced forward of ``tokens`` (B, S).  Returns (logits
        (B, S, Vp) fp32, caches {"k", "v"} of (L, B, S, KV, dh) — under MLA
        {"ckv", "kr"} of (L, B, S, r) and (L, B, S, dr) — or None, aux: the
        MoE layers' summed router loss, a float32 scalar, 0 for dense).
        ``plain_attention`` runs the attention kernels' plain versions
        instead of the kernels (a comparison)."""
        if prefix_embeds is not None:
            raise NotImplementedError(f"prefix embeddings {_NOT_PORTED}")
        cfg = self.cfg
        window = cfg.attn_window if window is None else window
        x = self.embed[self._tokens(tokens)]
        S = x.shape[1]
        cos, sin = rope_table(S, _rope_dim(cfg), cfg.rope_theta,
                              device=self.device)
        c0s, c1s = [], []
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for blk in self.blocks:
            x, (c0, c1), a = blk.full(cfg, x, cos, sin, window, plain_attention)
            if a is not None:
                aux = aux + a
            if return_cache:
                c0s.append(c0)
                c1s.append(c1)
        caches = (dict(zip(_cache_keys(cfg), (torch.stack(c0s), torch.stack(c1s))))
                  if return_cache else None)
        return self._logits(x), caches, aux

    @torch.no_grad()
    def forward_decode(self, token: Any, caches: dict[str, torch.Tensor],
                       pos: Any) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One decode step: ``token`` (B,) at positions ``pos`` (B,).
        Returns (logits (B, Vp) fp32, caches), the caches updated in place.
        ``pos`` on the host (a numpy array, as the engine keeps it) is
        checked there and costs no synchronisation; with ``token`` on the
        host too, both reach the card in one copy, and every layer attends
        with the one ``cache_len = pos + 1`` made there.  ``pos`` on the card
        is not read back."""
        cfg = self.cfg
        keys = _cache_keys(cfg)
        S = caches[keys[0]].shape[2]
        p = pos if torch.is_tensor(pos) else torch.as_tensor(np.asarray(pos))
        tok = token if torch.is_tensor(token) else torch.as_tensor(np.asarray(token))
        if p.device.type == "cpu":
            if bool(((p < 0) | (p >= S)).any()):
                raise ValueError(f"decode positions {p.tolist()} outside [0, {S})")
            if tok.device.type == "cpu":
                both = torch.stack([tok.reshape(-1).long(), p.reshape(-1).long()])
                tok, p = both.to(self.device, non_blocking=True)
        p = p.to(device=self.device, dtype=torch.int32)
        cache_len = p + 1
        x = self.embed[self._tokens(tok)[:, None]]            # (B, 1, D)
        ang = p.float()[:, None] * rope_freqs(_rope_dim(cfg), cfg.rope_theta,
                                              self.device)[None, :]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        for blk, c0, c1 in zip(self.blocks, caches[keys[0]], caches[keys[1]]):
            x = blk.decode(cfg, x, c0, c1, p, cache_len, cos, sin)
        return self._logits(x)[:, 0], caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """Zeroed serving caches in the activation dtype: {"k", "v"} of (L, B,
    S, KV, dh), or under MLA the latents {"ckv", "kr"} of (L, B, S, r) and
    (L, B, S, dr)."""
    _check_ported(cfg)
    lead = (cfg.n_layers, batch, max_len)
    if cfg.use_mla:
        shapes = (lead + (cfg.kv_lora_rank,), lead + (cfg.d_rope,))
    else:
        shapes = (lead + (cfg.n_kv_heads_eff, cfg.d_head),) * 2
    dev = resolve_device(device)
    return {key: torch.zeros(shape, dtype=cfg.adt, device=dev)
            for key, shape in zip(_cache_keys(cfg), shapes)}


# ================================================================ parameters
def _leaves(model: Transformer) -> dict[str, list[torch.Tensor]]:
    """The reference tree's leaf paths → the port's tensors (one per layer
    under ``blocks/``, in layer order)."""
    out: dict[str, list[torch.Tensor]] = {
        "embed": [model.embed], "final_norm": [model.final_norm],
        "lm_head": [model.lm_head]}
    for blk in model.blocks:
        for name in ("norm1", "norm2"):
            out.setdefault(f"blocks/{name}", []).append(getattr(blk, name))
        for group, params in blk.groups().items():
            for name, t in params.items():
                out.setdefault(f"blocks/{group}/{name}", []).append(t)
    return out


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        flat: dict[str, Any] = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def init_params(cfg: ModelConfig, seed: int = 0,
                device: torch.device | str | None = None) -> Transformer:
    """A :class:`Transformer` with random weights from ``seed``, made on
    ``device`` (None: the card): the reference's distribution (embedding
    N(0, 0.02²), he-scaled normal matrices, unit norms, zero biases, the
    padded heads' output rows zeroed), drawn in float32 by a
    ``torch.Generator`` and cast to each tensor's dtype (the MoE router
    stays float32)."""
    model = Transformer(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    D, Vp, F = cfg.d_model, cfg.padded_vocab, cfg.d_ff
    adt = cfg.adt
    with torch.no_grad():
        model.embed.copy_(normal_init(gen, (Vp, D), 0.02, model.embed.dtype))
        model.final_norm.fill_(1.0)
        model.lm_head.copy_(he_init(gen, (D, Vp), D, model.lm_head.dtype))
        for blk in model.blocks:
            blk.norm1.fill_(1.0)
            blk.norm2.fill_(1.0)
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
            _copy_into(blk.attn, attn)
            del attn
            if cfg.family == "moe":
                ffn = init_moe(gen, D, cfg.d_ff_expert, cfg.n_experts,
                               n_shared=cfg.n_shared_experts, dtype=adt)
                if "shared" in ffn:
                    _copy_into(blk.shared, ffn.pop("shared"))
                _copy_into(blk.moe, ffn)
            else:
                _copy_into(blk.mlp, init_mlp(gen, D, F, adt))
    return model


def _copy_into(params: nn.ParameterDict, values: dict[str, torch.Tensor]) -> None:
    for name, t in values.items():
        params[name].copy_(t)


def params_from_reference(np_params: dict[str, Any], cfg: ModelConfig,
                          device: torch.device | str | None = None
                          ) -> Transformer:
    """The JAX package's parameter tree (``jax.tree.map(np.asarray,
    init_params(cfg, key))``, blocks stacked on a leading L axis) as a
    :class:`Transformer` on ``device``.  Every leaf is used; an unknown or
    missing leaf, or a shape that does not match, raises ``ValueError``."""
    model = Transformer(cfg, device)
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
            shape = ((len(targets),) if stacked else ()) + tuple(targets[0].shape)
            if a.shape != shape:
                raise ValueError(f"params_from_reference: {path} has shape "
                                 f"{a.shape}, expected {shape}")
            src = torch.from_numpy(np.array(a, dtype=np.float32))
            for i, t in enumerate(targets):
                t.copy_((src[i] if stacked else src).to(device=t.device,
                                                       dtype=t.dtype))
    return model
