"""Sharding planner — MAFIA's Best-PF estimator retargeted at mesh sharding.

The port of the JAX package's ``sharding/planner.py``, decision for
decision.  The paper's technique as a distribution feature: the per-node
*parallelism factor* of the FPGA compiler becomes the per-weight-class
*sharding degree* over the ``model`` mesh axis.

1.  :func:`layer_dfg` builds the matrix DFG of one transformer layer (+
    lm_head) for the architecture and shape cell: one ``matmul`` node per
    weight class, with that cell's token and feature dims.
2.  The PF-1 profiler tags each node with its single-chip roofline latency
    on the copied TPU v5e model (:mod:`repro_torch.core.tpu_model`, the
    reference's cost callbacks: the decision is the reference's, not a
    measurement of the H100).
3.  The greedy Best-PF estimator (the FPGA backend's optimizer with those
    callbacks, power-of-two PF steps capped at the axis size) gives each
    node a PF.
4.  A weight class whose node saturated the axis (PF == |model|), or any
    weight of 2^22 elements or more, gets its parallel dim sharded over
    ``model``; low-PF nodes (the router, small projections) stay
    replicated.  A dim that does not divide the axis is replicated, with a
    note, or under ``allow_uneven`` sharded unevenly.

:class:`Plan` carries :class:`~repro_torch.sharding.spec.P` specs for the
parameters (and so the optimizer state), the serving caches, batches and
activation hints.  The trees are nested dicts keyed as the reference's
parameter tree (:func:`~repro_torch.models.transformer.abstract_params`:
``blocks/...`` stacked on the layer axis), planned from meta tensors: no
allocation, so deepseek-v2-236b plans at all 60 layers.  ``plan_for``
reads a ``DeviceMesh`` or a :class:`~repro_torch.sharding.spec.MeshShape`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.configs.registry import ArchSpec, ShapeCell
from repro_torch.core.constraints import PFGroups
from repro_torch.core.dfg import DFG
from repro_torch.core.optimizer import CostContext, greedy_best_pf
from repro_torch.core.profiler import profile_pf1
from repro_torch.core.tpu_model import TpuBudget
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.transformer import (ModelConfig, abstract_params,
                                            init_cache)
from repro_torch.sharding.spec import P
from repro_torch.train.optim import tree_leaves

__all__ = ["Plan", "plan_for", "layer_dfg", "mafia_shard_report"]


# ------------------------------------------------------------ MAFIA layer DFG
def layer_dfg(cfg: ModelConfig, tokens: int, kv_len: int) -> DFG:
    """One layer of ``cfg`` as a matrix DFG (weights are graph inputs, so no
    allocation happens — shapes only)."""
    g = DFG(f"{cfg.name}-layer")
    T, D = tokens, cfg.d_model
    x = g.add_input("x", (T, D))

    if cfg.uses_attention and cfg.family != "hybrid":
        H, dh = cfg.n_heads, cfg.d_head
        if cfg.use_mla:
            r, rq = cfg.kv_lora_rank, cfg.q_lora_rank
            g.add_input("w_dq", (D, rq))
            g.add_input("w_uq", (rq, H * dh))
            g.add_input("w_dkv", (D, r))
            g.add_input("w_uk", (r, H * dh))
            g.add_input("w_uv", (r, H * dh))
            cq = g.add("matmul", x, "w_dq", id="mla_dq")
            q = g.add("matmul", cq, "w_uq", id="wq")
            g.add("matmul", x, "w_dkv", id="mla_dkv")
            g.add_input("kT", (H * dh, kv_len))
            s = g.add("matmul", q, "kT", id="attn_scores")
            g.add_input("vS", (kv_len, H * dh))
            ctx = g.add("matmul", s, "vS", id="attn_ctx")
        else:
            KV = cfg.n_kv_heads
            g.add_input("wq_w", (D, H * dh))
            g.add_input("wk_w", (D, KV * dh))
            g.add_input("wv_w", (D, KV * dh))
            q = g.add("matmul", x, "wq_w", id="wq")
            g.add("matmul", x, "wk_w", id="wk")
            g.add("matmul", x, "wv_w", id="wv")
            g.add_input("kT", (H * dh, kv_len))
            s = g.add("matmul", q, "kT", id="attn_scores")
            g.add_input("vS", (kv_len, H * dh))
            ctx = g.add("matmul", s, "vS", id="attn_ctx")
        g.add_input("wo_w", (H * dh, D))
        o = g.add("matmul", ctx, "wo_w", id="wo")

        if cfg.family == "moe":
            E, k, Fe = cfg.n_experts, cfg.experts_per_token, cfg.d_ff_expert
            g.add_input("router_w", (D, E))
            g.add("matmul", o, "router_w", id="router")
            Tk = max(1, int(T * k * cfg.capacity_factor))
            g.add_input("x_dispatch", (Tk, D))
            g.add_input("we_gate", (D, Fe))
            g.add_input("we_down", (Fe, D))
            eg = g.add("matmul", "x_dispatch", "we_gate", id="experts_in")
            last = g.add("matmul", eg, "we_down", id="experts_out")
        else:
            F = cfg.d_ff
            g.add_input("wg", (D, F))
            g.add_input("wd", (F, D))
            mg = g.add("matmul", o, "wg", id="mlp_in")
            last = g.add("matmul", mg, "wd", id="mlp_out")
    else:  # ssm / hybrid backbone layer
        di = cfg.d_inner
        g.add_input("wzx", (D, 2 * di))
        zx = g.add("matmul", x, "wzx", id="ssm_in")
        # SSD core ~ two (T, P, N)-ish contractions per head; model as matmul
        g.add_input("ssd_w", (2 * di, 2 * cfg.ssm_state))
        core = g.add("matmul", zx, "ssd_w", id="ssd_core")
        g.add_input("ssd_back", (2 * cfg.ssm_state, di))
        y = g.add("matmul", core, "ssd_back", id="ssd_core2")
        g.add_input("wout", (di, D))
        last = g.add("matmul", y, "wout", id="ssm_out")

    g.add_input("lm_w", (D, cfg.padded_vocab))
    lg = g.add("matmul", last, "lm_w", id="lm_head")
    g.mark_output(lg)
    g.validate()
    return g


def mafia_shard_report(cfg: ModelConfig, cell: ShapeCell, model_axis: int
                       ) -> dict[str, int]:
    """node id → PF chosen by the greedy Best-PF estimator (TPU backend)."""
    if cell.kind == "train":
        tokens = cell.seq_len * cell.global_batch // 64  # per-microbatch scale
    elif cell.kind == "prefill":
        tokens = cell.seq_len * cell.global_batch
    else:  # decode
        tokens = cell.global_batch
    dfg = layer_dfg(cfg, max(1, tokens), cell.seq_len)
    profile_pf1(dfg, backend="tpu")
    groups = PFGroups.build(dfg)
    ctx = CostContext(dfg, groups, TpuBudget(max_shard=model_axis), backend="tpu")
    res = greedy_best_pf(ctx, metric="latency")
    return dict(res.assignment)


# -------------------------------------------------------------------- plan
@dataclasses.dataclass
class Plan:
    arch_id: str
    mode: str                           # train | prefill | decode
    dp_axes: tuple[str, ...]            # batch axes, e.g. ("pod", "data")
    fsdp_axis: str | None               # weight-shard axis (None = replicate)
    model_axis: str
    model_size: int
    param_specs: Any                    # nested dict of P
    cache_specs: Any | None
    act_specs: dict[str, P]
    pf_report: dict[str, int]           # MAFIA optimizer output (per node)
    notes: list[str]
    dp_size: int = 1

    def batch_spec(self, batch_size: int, extra_dims: int = 1) -> P:
        dp = self.dp_axes if batch_size % self.dp_size == 0 else None
        return P(dp, *([None] * extra_dims))


def _map_with_path(fn, tree: dict, prefix: str = "") -> dict:
    """``fn(path, leaf)`` over a nested dict in ``jax.tree`` order (keys
    sorted), so that the notes ``fn`` appends come in the reference's
    order."""
    return {k: (_map_with_path(fn, tree[k], f"{prefix}{k}/")
                if isinstance(tree[k], dict) else fn(f"{prefix}{k}", tree[k]))
            for k in sorted(tree)}


def plan_for(
    spec: ArchSpec | ModelConfig,
    mesh: Any,
    *,
    mode: str,
    cell: ShapeCell | None = None,
    cache_batch: int | None = None,
    cache_len: int | None = None,
    allow_uneven: bool = False,
    replicate_embed: bool = False,
) -> Plan:
    cfg = spec.model if isinstance(spec, ArchSpec) else spec
    arch_id = spec.arch_id if isinstance(spec, ArchSpec) else cfg.name
    axes = mesh_axes(mesh)
    model_axis = "model"
    msize = axes.get(model_axis, 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    dp_size = math.prod(axes[a] for a in dp_axes) if dp_axes else 1
    notes: list[str] = []

    # ---- MAFIA PF pass: which weight classes deserve the full model axis
    cell = cell or ShapeCell("adhoc", mode, 4096, 8)
    pf = mafia_shard_report(cfg, cell, msize)
    saturated = {nid for nid, v in pf.items() if v >= msize}

    def class_sharded(node_id: str, weight_numel: int) -> bool:
        # MAFIA decision, with a floor: very large weights always shard
        # (the optimizer's per-microbatch view can under-rate them).
        return node_id in saturated or weight_numel >= (1 << 22)

    # ---- FSDP axis
    aparams = abstract_params(cfg)
    n_params = sum(math.prod(x.shape) for x in tree_leaves(aparams))
    if mode == "train":
        fsdp = "data" if "data" in axes else None
    else:
        bf16_per_chip = 2 * n_params / max(1, msize)
        fsdp = "data" if (bf16_per_chip > 8e9 and "data" in axes) else None
        if fsdp:
            notes.append(
                f"serve weights {2*n_params/1e9:.0f}GB bf16 exceed HBM at "
                f"TP-only; FSDP over 'data' enabled"
            )

    def m_if(n: int, node_id: str, numel: int) -> str | None:
        """'model' if the MAFIA pass wants it AND the dim divides the axis."""
        if n % msize != 0:
            if not class_sharded(node_id, numel):
                return None
            if allow_uneven and n > msize // 2:
                # GSPMD pads uneven shardings internally: a 24-head axis on a
                # 16-way mesh becomes ceil(24/16)=2 heads/device (25% padding
                # waste) instead of 16× replicated compute.
                notes.append(
                    f"{node_id}: dim {n} sharded UNEVENLY over model={msize} "
                    f"(GSPMD pads to {-(-n // msize) * msize})"
                )
                return model_axis
            notes.append(
                f"{node_id}: dim {n} not divisible by model={msize}; "
                f"replicated (feasibility constraint)"
            )
            return None
        return model_axis if class_sharded(node_id, numel) else None

    E, Vp, D = cfg.n_experts, cfg.padded_vocab, cfg.d_model

    def rule(path: str, shape: tuple[int, ...]) -> P:
        # per-layer weight size (exclude the stacked L axis for blocks/)
        numel = math.prod(shape[1:]) if path.startswith("blocks/") else math.prod(shape)
        f = fsdp
        # ---------- top level
        if path == "embed":
            if replicate_embed:
                # the reference's workaround for XLA-CPU inside its int8-EF
                # shard_map region, kept so that the plans agree
                return P(None, f)
            return P(m_if(Vp, "lm_head", numel), f)
        if path == "lm_head":
            return P(f, m_if(Vp, "lm_head", numel))
        if path == "final_norm":
            return P(None)
        # ---------- shared attention block (hybrid, unstacked)
        if path.startswith("shared_attn"):
            leaf = path.split("/")[-1]
            if leaf in ("wq", "wk", "wv"):
                return P(f, m_if(shape[1], "wq", numel), None)
            if leaf == "wo":
                return P(m_if(shape[0], "wo", numel), None, f)
            if leaf in ("w_gate", "w_up"):
                return P(f, m_if(shape[1], "mlp_in", numel))
            if leaf == "w_down":
                return P(m_if(shape[0], "mlp_out", numel), f)
            if leaf == "out":
                return P(f, None)
            return P(*([None] * len(shape)))
        # ---------- stacked blocks (leading L axis)
        if path.startswith("blocks/"):
            leaf = path.split("/")[-1]
            sub = shape[1:]
            if leaf in ("norm1", "norm2", "norm", "norm_kv", "norm_q",
                        "A_log", "D", "dt_bias", "conv_b_b", "conv_c_b"):
                return P(*([None] * len(shape)))
            if leaf == "wq":
                return P(None, f, m_if(sub[1], "wq", numel), None)
            if leaf in ("wk", "wv"):
                return P(None, f, m_if(sub[1], "wk", numel), None)
            if leaf in ("bq", "bk", "bv"):
                return P(None, m_if(sub[0], "wq", numel), None)
            if leaf == "wo":
                return P(None, m_if(sub[0], "wo", numel), None, f)
            # MLA
            if leaf in ("w_dq", "w_dkv", "w_kr"):
                return P(None, f, None)
            if leaf in ("w_uq", "w_qr", "w_uk", "w_uv"):
                return P(None, None, m_if(sub[1], "wq", numel), None)
            # dense/shared MLP
            if leaf in ("w_gate", "w_up"):
                if len(sub) == 3:  # moe experts (E, D, Fe)
                    return P(None, m_if(sub[0], "experts_in", numel), f, None)
                return P(None, f, m_if(sub[1], "mlp_in", numel))
            if leaf == "w_down":
                if len(sub) == 3:  # (E, Fe, D)
                    return P(None, m_if(sub[0], "experts_out", numel), None, f)
                return P(None, m_if(sub[0], "mlp_out", numel), f)
            if leaf == "router":
                return P(None, f, m_if(sub[1], "router", numel))
            # SSM
            if leaf in ("w_z", "w_x"):
                return P(None, f, m_if(sub[1], "ssm_in", numel))
            if leaf in ("w_b", "w_c", "w_dt"):
                return P(None, f, None)
            if leaf in ("conv_x_w",):
                return P(None, None, m_if(sub[1], "ssm_in", numel))
            if leaf in ("conv_x_b", "norm"):
                return P(None, m_if(sub[0], "ssm_in", numel))
            if leaf in ("conv_b_w", "conv_c_w"):
                return P(None, None, None)
            if leaf == "out_proj":
                return P(None, m_if(sub[0], "ssm_out", numel), f)
        # default: replicate
        return P(*([None] * len(shape)))

    param_specs = _map_with_path(lambda path, x: rule(path, tuple(x.shape)),
                                 aparams)

    # ---- caches (decode / prefill-with-cache)
    cache_specs = None
    if mode in ("prefill", "decode") and cache_batch is not None:
        acache = init_cache(cfg, cache_batch, cache_len or 1, device="meta")
        dp_b = dp_axes if cache_batch % max(1, dp_size) == 0 else None

        def cache_rule(path: str, shape: tuple[int, ...]) -> P:
            leaf = path.split("/")[-1]
            if leaf in ("k", "v"):
                kv_heads = shape[3]
                if kv_heads % msize == 0:
                    return P(None, dp_b, None, model_axis, None)
                # heads not shardable → shard the sequence dim instead
                # (flash-decoding-style partial softmax)
                return P(None, dp_b, model_axis, None, None)
            if leaf in ("ckv", "kr"):
                return P(None, dp_b, model_axis, None)
            if leaf == "h":   # SSM state (L,B,H,N,P)
                return P(None, dp_b, m_if(shape[2], "ssm_in", 1 << 30), None, None)
            if leaf == "conv_x":
                return P(None, dp_b, None, m_if(shape[3], "ssm_in", 1 << 30))
            return P(*([None] * len(shape)))

        cache_specs = _map_with_path(
            lambda path, x: cache_rule(path, tuple(x.shape)), acache)

    # ---- activation hints
    gb = cell.global_batch if cell else 8
    dp_b = dp_axes if gb % max(1, dp_size) == 0 else None
    act_specs = {
        "hidden": P(dp_b, None, None),
        "logits": P(dp_b, None, m_if(Vp, "lm_head", Vp * D)),
        "moe_buffer": P(m_if(E, "experts_in", 1 << 30), None, None) if E else None,
        "moe_buffer_flat": P(m_if(E, "experts_in", 1 << 30), None) if E else None,
    }
    act_specs = {k: v for k, v in act_specs.items() if v is not None}

    return Plan(
        arch_id=arch_id, mode=mode, dp_axes=dp_axes, fsdp_axis=fsdp,
        model_axis=model_axis, model_size=msize, param_specs=param_specs,
        cache_specs=cache_specs, act_specs=act_specs, pf_report=pf,
        notes=list(dict.fromkeys(notes)), dp_size=dp_size,
    )
