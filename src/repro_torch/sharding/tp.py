"""A layer's compute split over the mesh's ``model`` axis (Megatron's
scheme) for every LM family.

The reference leaves this split to GSPMD, which reads the plan's specs
and inserts the collectives; the port's kernels take plain tensors, so the
port writes the collectives out.  :class:`ModelSplit` reads the plan's
parameter specs (and, to serve, its cache specs) and says, for one rank,
which query heads, KV heads, FFN columns and vocabulary rows it computes:

* a leaf whose spec names ``model`` is held as this rank's shard only
  (:meth:`ModelSplit.local_shape`), never gathered whole;
* column-parallel products (``wq``, ``wk``/``wv`` where sharded,
  ``w_gate``/``w_up``, ``lm_head``) read their input through
  :func:`copy_to_model` (the identity; its backward all-reduces the
  input's gradient) and give local outputs;
* row-parallel products (``wo``, ``w_down``) give fp32 partial sums that
  :func:`reduce_from_model` completes (one all-reduce; its backward is the
  identity), before the one rounding to the activation dtype;
* a replicated leaf that a rank reads only in part (``wk``/``wv``/
  ``bk``/``bv`` when the plan keeps them whole: the KV heads of the local
  query heads, head h reading KV head h // G) is sliced at use; its
  gradient is then partial and the train step sums it over ``model``
  (:attr:`ModelSplit.partial`).  A replicated leaf every rank uses whole
  (the norms) has the whole gradient on every rank.

The MoE family (olmoe, deepseek-v2) adds, as the reference's plan lays
them out: the experts over ``model`` (``w_gate``/``w_up``/``w_down`` on
their expert axis: each rank runs its experts' capacity slots, and the
combine's fp32 partial sums are all-reduced as a row-parallel product's
are), the router's columns where the plan splits it (its fp32 logits
gathered before the softmax), the shared experts' FFN columns, MLA's heads
(``w_uq``/``w_qr``/``w_uk``/``w_uv`` on the head axis, ``wo`` on its
rows) and MLA's latent caches ``ckv``/``kr`` over the sequence.  MLA's
replicated ``w_dq``/``norm_q``/``w_dkv``/``norm_kv``/``w_kr`` feed only the
local heads, and a router kept whole beside split experts only the local
experts' combine: those are partial.

The ``ssm`` and ``hybrid`` families (mamba2, zamba2) add a Mamba2 layer
over its SSM heads: ``w_z``/``w_x`` on their columns and ``conv_x_w``/
``conv_x_b`` on their channels, a range of whole heads (``ssm_heads``
divides the axis), ``out_proj`` on its rows (row-parallel; sliced at use
and partial where the plan keeps it whole).  The scan runs on the local
heads and needs no collective; the gated RMSNorm over the whole
``d_inner`` sums its fp32 squares over ``model`` (:func:`sum_over_model`,
an all-reduce in the forward and in the backward).  The replicated leaves
read in part (``w_dt``'s columns, ``A_log``, ``D``, ``dt_bias``, the gated
``norm``) or used whole to feed only the local heads (``w_b``, ``w_c``,
their conv taps and biases) are partial.  The serving state ``h`` is
split over SSM heads and ``conv_x`` over channels, as the weights;
``conv_b``/``conv_c`` stay whole (every rank computes the same values).
zamba2's shared attention block (``shared_attn/...``, unstacked: no layer
axis) has ranges of its own, the dense split's heads, KV heads and FFN
columns at 2 · d_model, in :attr:`ModelSplit.block`; its cache is split
over KV heads (where the plan splits that cache and keeps the block's
weights whole, the block runs on the cache's heads, its weights sliced at
use).

At ``model = 1`` no split is made (:func:`model_split` returns None) and
no collective is issued.

A dim that does not divide the axis (the planner's ``allow_uneven``: a
model axis of 3, 5, 6 or 7 ranks, musicgen-medium's 24 heads over 16) is
split in GSPMD's pieces for the dense and MoE families: ``ceil(n / m)`` a
rank, the last short, trailing ranks' empty (4 heads over 3: 2, 2, 0).
A rank's query heads then need not be whole KV groups: the attention
kernels take the heads' offset into their first KV head's group
(:meth:`ModelSplit.head_offset`), and where ``wk``/``wv`` are split over
``model`` and a rank's query heads read KV heads its shard does not hold,
K and V are gathered over ``model`` (:attr:`ModelSplit.kv_gather`).  Every
gather of a split range pads each piece to ``ceil(n / m)`` and trims after
(:func:`gather_from_model`'s ``of``); a rank with an empty piece computes
zeros (an empty product, a −inf row max) and joins every collective.
The ``ssm`` and ``hybrid`` families refuse uneven pieces
(:data:`UNEVEN_SSM`).

Serving on a mesh whose ``pod`` × ``data`` exceeds one rank adds a
:class:`DataSplit` (:func:`data_split`) beside the ``model`` split: the
rank's rows of the caches' batch where the plan splits it over the
data-parallel axes (the reference's ``dp_b``), and, where the plan shards
the weights over ``data`` as well (FSDP: the serving plan of a model whose
weights a ``model`` rank cannot hold), the rank's ``data`` shard of each
such leaf, gathered over ``data`` (:meth:`DataSplit.gather`, one
all-gather a leaf) just before its layer runs and dropped after it.  The
heaviest leaves stay on their shard instead (:data:`HELD`: the embedding,
the head, the routed experts, the attention's output projection): their
product moves the activations, a decode batch's few rows, in place of the
weights, partial sums over the shard's inputs summed over ``data`` or the
shard's output columns gathered over it.  A layer asks one hook,
:meth:`DataSplit.in_place`, whether it computes with a leaf's shard; the
rest of its leaves are gathered around it.  Why two ways: ranks that share
one card over gloo move about 1 GB/s, and deepseek-v2's experts, embedding
and head are most of a forward's gathered bytes.  Where the data ranks are
cards joined by NCCL the table is to be measured again (a gather a layer
for every leaf may then cost less than moving the activations).  The
``model`` split runs unchanged inside each data rank.

The collectives are ``torch.distributed`` calls on the tensors as they
lie: gloo takes CUDA tensors as well as NCCL does.  No DTensor
redistribute is used.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_group
from repro_torch.sharding.placement import local_slices
from repro_torch.sharding.ctx import all_gather_flat, token_group
from repro_torch.sharding.spec import entry_axes

__all__ = ["ModelSplit", "model_split", "plan_split", "local_range",
           "copy_to_model", "reduce_from_model", "gather_from_model",
           "sum_over_model", "max_over_model", "DataSplit", "data_split"]

MODEL = "model"
DP_AXES = ("pod", "data")            # the data-parallel axes, major first
# the leaves a rank computes with on its `data` shard (FSDP) where the plan
# shards them on this dim (per layer), not gathered: the embedding's and
# the output projections' columns, the head's and the experts' gate and up
# products' inputs
HELD = {"embed": 1, "lm_head": 0, "blocks/moe/w_gate": 1,
        "blocks/moe/w_up": 1, "blocks/moe/w_down": 2, "blocks/attn/wo": 2,
        "shared_attn/attn/wo": 2}
_EXPERTS = ("blocks/moe/w_gate", "blocks/moe/w_up", "blocks/moe/w_down")
SSM = "blocks/ssm/"
SHARED = "shared_attn/"
# why the ssm and hybrid families refuse pieces that are not whole SSM heads
UNEVEN_SSM = ("uneven pieces of the ssm and hybrid families are not ported "
              "(ROADMAP.md, Queue A item 12: the channels regrouped into "
              "whole SSM heads before the scan, zamba2's shared block)")


def _names_model(spec: tuple | None) -> list[int]:
    """The dims of ``spec`` that name the ``model`` axis."""
    return [d for d, e in enumerate(spec or ()) if MODEL in entry_axes(e)]


def local_range(n: int, spec: tuple | None, m: int, r: int,
                dim: int = 0) -> tuple[int, int]:
    """This rank's ``[start, stop)`` of dim ``dim`` (size ``n``) under
    ``spec``, over the ``model`` axis alone (size ``m``, this rank's
    coordinate ``r``): the whole dim where the spec does not name
    ``model`` there."""
    spec = tuple(spec or ())
    entry = spec[dim] if dim < len(spec) else None
    only = MODEL if MODEL in entry_axes(entry) else None
    sl = local_slices((n,), (only,), {MODEL: m}, {MODEL: r})[0]
    return sl.start, sl.stop


# ------------------------------------------------------------- collectives
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, dim: int, group, m: int,
            total: int | None = None) -> torch.Tensor:
    """Every rank's piece of ``x`` along ``dim``, in rank order.  Pieces of
    one size where ``total`` is None; else GSPMD's pieces of a dim of
    ``total`` (``ceil(total / m)`` each, the last short or empty): each is
    padded to ``ceil(total / m)`` with zeros, gathered, and the padding
    trimmed (the pieces before the last nonempty one are full, so the
    first ``total`` rows are the dim in order)."""
    x = x.movedim(dim, 0)
    c = x.shape[0] if total is None else -(-total // m)
    if c != x.shape[0]:
        x = torch.cat([x, x.new_zeros((c - x.shape[0],) + tuple(x.shape[1:]))])
    x = x.contiguous()
    out = x.new_empty((m * x.numel(),))
    all_gather_flat(out, x, group)
    out = out.view((m * c,) + tuple(x.shape[1:]))
    if total is not None:
        out = out[:total]
    return out.movedim(0, dim)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, m, r, grad_sum, total):
        n = x.shape[dim]
        ctx.dim, ctx.n, ctx.group, ctx.grad_sum = dim, n, group, grad_sum
        # this rank's first index: r pieces of one size before it
        ctx.start = r * n if total is None else min(r * -(-total // m), total)
        return _gather(x, dim, group, m, total)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return (g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None, None,
                None, None)


def copy_to_model(x: torch.Tensor, split: "ModelSplit | None") -> torch.Tensor:
    """The input of column-parallel products: forward the identity,
    backward an all-reduce over ``model``."""
    if split is None:
        return x
    return _CopyToModel.apply(x, split.group)


def reduce_from_model(x: torch.Tensor, split: "ModelSplit | None"
                      ) -> torch.Tensor:
    """The partial sums of a row-parallel product: forward an all-reduce
    over ``model``, backward the identity."""
    if split is None:
        return x
    return _ReduceFromModel.apply(x, split.group)


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_model(x: torch.Tensor, split: "ModelSplit | None") -> torch.Tensor:
    """The sum over ``model`` of each rank's ``x``, where every rank's
    output depends on every rank's input (the gated norm's squares):
    forward an all-reduce, backward an all-reduce of the output's
    gradients (each rank's is partial)."""
    if split is None:
        return x
    return _SumOverModel.apply(x, split.group)


def gather_from_model(x: torch.Tensor, dim: int,
                      split: "ModelSplit | None", grad_sum: bool = False,
                      of: str | None = None) -> torch.Tensor:
    """Every rank's piece of ``x`` along ``dim``, in rank order: forward an
    all-gather over ``model``, backward the local slice (of the gradient
    summed over ``model`` first with ``grad_sum``: where what reads the
    gathered tensor is itself split, each rank's gradient is partial).
    ``of`` names the split's range that ``dim`` holds (``"heads"``,
    ``"kv"``, ``"vocab_out"`` or ``"router"``): the pieces are then
    GSPMD's of :attr:`ModelSplit.sizes` ``[of]``, padded for the gather
    and trimmed after it (an uneven split's short and empty pieces); None:
    every rank's piece has ``x``'s size."""
    if split is None:
        return x
    total = None if of is None else split.sizes[of]
    return _GatherFromModel.apply(x, dim % x.dim(), split.group, split.m,
                                  split.r, grad_sum, total)


def max_over_model(x: torch.Tensor, split: "ModelSplit | None"
                   ) -> torch.Tensor:
    """The elementwise max over ``model`` (no gradient)."""
    if split is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=split.group)
    return y


# ----------------------------------------------------------------- layout
@dataclasses.dataclass
class ModelSplit:
    """One rank's share of a dense or MoE model over ``model``.

    ``heads`` / ``kv`` / ``ffn`` / ``vocab_in`` / ``vocab_out`` are
    ``[start, stop)`` of the query heads (MLA's heads), the KV heads those
    read (GQA), the FFN columns, the embedding's rows and the head's
    columns that this rank computes (None: all of them, on every rank);
    ``experts`` / ``router`` / ``shared`` those of the routed experts, the
    router's logit columns and the shared experts' FFN columns; ``ssm`` /
    ``inner`` those of a Mamba2 layer's SSM heads and of its ``d_inner``
    channels (the same heads).  ``cache`` is how the serving caches are
    split: ``"heads"`` (KV heads; the Mamba2 states over SSM heads and
    channels), ``"seq"`` (positions; the plan's choice where KV heads do
    not divide the axis, and MLA's latents always) or None.  ``prefix``
    is the leaf paths' (``blocks/``; ``shared_attn/`` in ``block``, the
    split zamba2's shared block runs under, or None where it runs
    whole).

    The ranges are GSPMD's pieces (:func:`local_range`): a dim of n over
    m ranks in pieces of ``ceil(n / m)``, the last short, trailing ranks'
    empty where n does not divide (the planner's ``allow_uneven``).
    ``sizes`` holds the whole dim of each range a rank gathers
    (``heads``, ``kv``, ``vocab_out``, ``router``), by the range's name
    (:func:`gather_from_model`'s ``of``).  ``kv_group``: the query
    heads a KV head serves (G); the local query heads need not be whole
    groups (:meth:`head_offset`).  ``kv_gather``: the plan shards
    ``wk``/``wv`` over ``model`` and some rank's query heads read KV heads
    its shard does not hold (granite-8b at model 3: query heads 11, 11,
    10 read KV heads [0, 3), [2, 6), [5, 8), the shards hold [0, 3), [3,
    6), [6, 8)), so every rank gathers K and V (the projections' outputs,
    in padded pieces, as GSPMD does) and takes ``kv`` from them; the same
    gather gives every KV head where the cache is split over the
    sequence."""

    m: int
    r: int
    group: Any
    specs: dict[str, tuple]          # leaf path → spec (blocks/: per layer)
    heads: tuple[int, int] | None
    kv: tuple[int, int] | None
    ffn: tuple[int, int] | None
    vocab_in: tuple[int, int] | None
    vocab_out: tuple[int, int] | None
    cache: str | None = None
    partial: frozenset = frozenset()  # replicated leaves a rank reads in part
    experts: tuple[int, int] | None = None
    router: tuple[int, int] | None = None
    shared: tuple[int, int] | None = None
    ssm: tuple[int, int] | None = None
    inner: tuple[int, int] | None = None
    block: "ModelSplit | None" = None
    prefix: str = "blocks/"
    sizes: dict[str, int] = dataclasses.field(default_factory=dict)
    kv_group: int = 1
    kv_gather: bool = False

    def head_offset(self) -> int:
        """Where the local query heads start in the group of their first
        KV head: local head h reads local KV head ``(off + h) //
        kv_group`` (0 where the rank holds whole groups, or heads of one
        KV head each)."""
        if self.heads is None or self.kv is None:
            return 0
        return self.heads[0] - self.kv[0] * self.kv_group

    def sharded(self, path: str) -> bool:
        """Whether the plan shards the leaf at ``path`` over ``model``."""
        return bool(_names_model(self.specs.get(path)))

    def local_shape(self, path: str, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The shape this rank holds of the leaf at ``path`` (one layer's,
        for ``blocks/``) whose whole shape is ``shape``."""
        spec = self.specs.get(path)
        return tuple(b - a for a, b in (
            local_range(n, spec, self.m, self.r, d) for d, n in enumerate(shape)))

    def local_slices(self, path: str, shape: tuple[int, ...]
                     ) -> tuple[slice, ...]:
        """The slices of the whole leaf that this rank holds."""
        spec = self.specs.get(path)
        return tuple(slice(*local_range(n, spec, self.m, self.r, d))
                     for d, n in enumerate(shape))

    def take(self, p: Mapping[str, torch.Tensor], name: str, group: str,
             dim: int, rng: tuple[int, int]) -> torch.Tensor:
        """``p[name]`` over ``rng`` of ``dim``: the leaf itself where the
        plan shards it over ``model`` (it holds just that range), else a
        slice of the replicated leaf."""
        t = p[name]
        if self.sharded(f"{self.prefix}{group}/{name}"):
            return t
        return t.narrow(dim, rng[0], rng[1] - rng[0])


def _flat(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out: dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _per_layer(path: str, spec: tuple | None) -> tuple:
    spec = tuple(spec or ())
    return spec[1:] if path.startswith("blocks/") else spec


def model_split(cfg, param_specs: Any, mesh, cache_specs: Any = None
                ) -> ModelSplit | None:
    """The split of ``cfg`` that the plan's ``param_specs`` (and, to serve,
    ``cache_specs``) ask for on ``mesh`` (a ``DeviceMesh``), for this rank
    (:func:`plan_split` with the mesh's ``model`` group); None where the
    mesh has no ``model`` axis of more than one rank or the plan shards
    nothing over it."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if mesh is None or MODEL not in names:
        return None
    m = dict(zip(names, mesh.shape))[MODEL]
    r = dict(zip(names, mesh.get_coordinate()))[MODEL]
    split = plan_split(cfg, param_specs, m, r, cache_specs)
    if split is not None:
        split.group = axis_group(mesh, (MODEL,))
        if split.block is not None:
            split.block.group = split.group
    return split


def _gqa_axes(prefix: str, D: int, H: int, KV: int, dh: int, whole: dict,
              axis: dict) -> None:
    whole.update({prefix + "wq": (D, H, dh), prefix + "wk": (D, KV, dh),
                  prefix + "wv": (D, KV, dh), prefix + "wo": (H, dh, D),
                  prefix + "bq": (H, dh), prefix + "bk": (KV, dh),
                  prefix + "bv": (KV, dh)})
    axis.update({prefix + "wq": 1, prefix + "wk": 1, prefix + "wv": 1,
                 prefix + "wo": 0, prefix + "bq": 0, prefix + "bk": 0,
                 prefix + "bv": 0})


def _mlp_axes(prefix: str, D: int, F: int, whole: dict, axis: dict) -> None:
    whole.update({prefix + "w_gate": (D, F), prefix + "w_up": (D, F),
                  prefix + "w_down": (F, D)})
    axis.update({prefix + "w_gate": 1, prefix + "w_up": 1,
                 prefix + "w_down": 0})


def _leaf_axes(cfg) -> tuple[dict[str, tuple[int, ...]], dict[str, int]]:
    """(whole per-layer shape, the dim that may name ``model``) of each
    leaf of ``cfg`` that a split reads in part (the unstacked
    ``shared_attn/`` leaves: their whole shape)."""
    H, KV, dh, D = cfg.n_heads_eff, cfg.n_kv_heads_eff, cfg.d_head, cfg.d_model
    Vp = cfg.padded_vocab
    whole = {"embed": (Vp, D), "lm_head": (D, Vp)}
    axis = {"embed": 0, "lm_head": 1}
    if cfg.family in ("ssm", "hybrid"):
        E, W = cfg.d_inner, cfg.ssm_conv
        whole.update({SSM + "w_z": (D, E), SSM + "w_x": (D, E),
                      SSM + "conv_x_w": (W, E), SSM + "conv_x_b": (E,),
                      SSM + "out_proj": (E, D)})
        axis.update({SSM + n: dim for n, (dim, _, shards) in SSM_LEAVES.items()
                     if shards})
        if cfg.family == "hybrid":
            d2 = 2 * D
            _gqa_axes(SHARED + "attn/", d2, cfg.n_heads, cfg.n_kv_heads,
                      d2 // cfg.n_heads, whole, axis)
            _mlp_axes(SHARED + "mlp/", d2, cfg.d_ff, whole, axis)
        return whole, axis
    if cfg.use_mla:
        q_in, dr = cfg.q_lora_rank or D, cfg.d_rope
        r = cfg.kv_lora_rank
        whole.update({"blocks/attn/w_uq": (q_in, H, dh),
                      "blocks/attn/w_qr": (q_in, H, dr),
                      "blocks/attn/w_uk": (r, H, dh),
                      "blocks/attn/w_uv": (r, H, dh),
                      "blocks/attn/wo": (H, dh, D)})
        axis.update({p: 1 for p in ("blocks/attn/w_uq", "blocks/attn/w_qr",
                                     "blocks/attn/w_uk", "blocks/attn/w_uv")})
        axis["blocks/attn/wo"] = 0
    else:
        _gqa_axes("blocks/attn/", D, H, KV, dh, whole, axis)
    if cfg.family == "moe":
        E, Fe = cfg.n_experts, cfg.d_ff_expert
        whole.update({"blocks/moe/router": (D, E),
                      "blocks/moe/w_gate": (E, D, Fe),
                      "blocks/moe/w_up": (E, D, Fe),
                      "blocks/moe/w_down": (E, Fe, D)})
        axis.update({"blocks/moe/router": 1, "blocks/moe/w_gate": 0,
                     "blocks/moe/w_up": 0, "blocks/moe/w_down": 0})
        if cfg.n_shared_experts:
            _mlp_axes("blocks/moe/shared/", D, cfg.n_shared_experts * Fe,
                      whole, axis)
    else:
        _mlp_axes("blocks/mlp/", D, cfg.d_ff, whole, axis)
    return whole, axis


# the replicated MLA leaves that feed only the local heads
_MLA_SHARED = ("blocks/attn/w_dq", "blocks/attn/norm_q", "blocks/attn/w_dkv",
               "blocks/attn/norm_kv", "blocks/attn/w_kr")
# A Mamba2 layer's leaves that a split over SSM heads reads at the rank's
# channels ("inner") or heads ("ssm"): (the per-layer dim that holds them,
# which, whether the plan may shard the leaf over `model`; a leaf it keeps
# whole is sliced at use).  The other leaves feed only the local heads
# too: w_dt (its product taken whole, the local heads' columns kept), w_b,
# w_c and their convs (used whole).  Every leaf but the sharded ones is
# partial.
SSM_LEAVES = {"w_z": (1, "inner", True), "w_x": (1, "inner", True),
              "conv_x_w": (1, "inner", True), "conv_x_b": (0, "inner", True),
              "out_proj": (0, "inner", True), "norm": (0, "inner", False),
              "A_log": (0, "ssm", False), "D": (0, "ssm", False),
              "dt_bias": (0, "ssm", False)}
_SSM_SHARED = tuple(SSM + n for n in (
    *(n for n, (_, _, shards) in SSM_LEAVES.items() if not shards),
    "w_dt", "w_b", "w_c", "conv_b_w", "conv_b_b", "conv_c_w", "conv_c_b"))


def plan_split(cfg, param_specs: Any, m: int, r: int = 0,
               cache_specs: Any = None) -> ModelSplit | None:
    """The split of ``cfg`` over a ``model`` axis of ``m`` ranks that the
    plan's specs ask for, for the rank at ``r`` (no process group: the
    dry-run counts from it); None at ``m = 1`` or where the plan shards
    nothing over ``model``.  A dim that does not divide the axis is split
    in GSPMD's pieces (the planner's ``allow_uneven``) for the dense and
    MoE families.  Raises ``NotImplementedError`` for what the split
    cannot run: an uneven piece of the ``ssm`` and ``hybrid`` families
    (:data:`UNEVEN_SSM`), SSM channels that are not whole heads a rank,
    and combinations (``wk``/``wv``/``bk``/``bv`` split over other ranges
    than their KV heads' pieces, a head-split cache without split heads,
    MLA head leaves, expert leaves or a Mamba2 layer's ``w_x``/``w_z``/
    ``conv_x_*`` split over different ranges or one whole beside
    another split, a state cache whose range is not the weights')."""
    flat = {p: _per_layer(p, s) for p, s in _flat(param_specs).items()}
    flat_cache = ({p: tuple(s or ()) for p, s in _flat(cache_specs).items()}
                  if cache_specs is not None else None)
    on_model = sorted(p for p, s in flat.items() if _names_model(s))
    cache_on = flat_cache is not None and any(_names_model(s)
                                              for s in flat_cache.values())
    if m == 1 or not (on_model or cache_on):
        return None
    whole, axis = _leaf_axes(cfg)
    for p in on_model:
        dims = _names_model(flat[p])
        if (p not in axis or dims != [axis[p]]
                or entry_axes(flat[p][axis[p]]) != (MODEL,)):
            raise NotImplementedError(
                f"{p}: the {cfg.family} split takes `model` alone on dim "
                f"{axis.get(p)}, the plan's spec is {flat[p]}")
        n = whole[p][axis[p]]
        if n % m and cfg.family in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"{p}: dim {n} split unevenly over model = {m}: {UNEVEN_SSM}")

    def rng(p: str, at: int = r) -> tuple[int, int] | None:
        return (local_range(whole[p][axis[p]], flat[p], m, at, axis[p])
                if p in on_model else None)

    partial: set[str] = set()

    def follow(lead: str, rest: tuple[str, ...], what: str, want=None,
               whole_ok: bool = True) -> tuple[int, int] | None:
        """The range of ``lead``; each of ``rest`` split over it (or
        ``want(p)``), or, where ``whole_ok``, kept whole and partial."""
        got = rng(lead)
        if got is None:
            if any(p in on_model for p in rest):
                raise NotImplementedError(
                    f"the plan shards {[p for p in rest if p in on_model]} over "
                    f"`model` but not {lead}: not a split the {what} runs")
            return None
        for p in rest:
            if p in on_model:
                need = want(p) if want else got
                if rng(p) != need:
                    raise NotImplementedError(
                        f"{p}: the plan's shard {rng(p)} is not the range "
                        f"{need} the {what} reads")
            elif p in flat:
                if not whole_ok:
                    raise NotImplementedError(
                        f"{p} whole beside {lead} split over `model`: not a "
                        f"split the {what} runs")
                partial.add(p)
        return got

    def gqa(prefix: str, H: int, KV: int):
        """(query heads, KV heads they read, the KV heads of the rank's
        ``wk``/``wv`` shard or None where they are whole, whether K and V
        are gathered over ``model``) of the GQA leaves under ``prefix``."""
        G = H // KV
        reads = lambda h: (h[0] // G,                             # noqa: E731
                           max(h[0], h[1] - 1) // G + (h[1] > h[0]))
        heads, kv = rng(prefix + "wq"), None
        held, gather = rng(prefix + "wk"), False
        if heads is not None:
            kv = reads(heads)
            # a collective: every rank gathers where any rank must
            gather = held is not None and any(
                reads(rng(prefix + "wq", at)) != rng(prefix + "wk", at)
                for at in range(m))
        follow(prefix + "wq", tuple(prefix + n for n in (
            "wk", "wv", "wo", "bq", "bk", "bv")), "attention",
            want=lambda p: (heads if p.endswith(("/wo", "/bq"))
                            else held if held is not None else kv))
        return heads, kv, held, gather

    if cfg.family in ("ssm", "hybrid"):
        return _ssm_split(cfg, flat, flat_cache if cache_on else None, m, r,
                          rng, follow, gqa, partial)
    kv = held = None
    gather = False
    if cfg.use_mla:
        heads = follow("blocks/attn/w_uq", ("blocks/attn/w_qr",
                       "blocks/attn/w_uk", "blocks/attn/w_uv", "blocks/attn/wo"),
                       "MLA path", whole_ok=False)
        if heads is not None:
            partial.update(p for p in _MLA_SHARED if p in flat)
    else:
        heads, kv, held, gather = gqa("blocks/attn/", cfg.n_heads_eff,
                                      cfg.n_kv_heads_eff)
        if heads is None and cache_on and 3 in _names_model(
                flat_cache.get("k")):
            # the cache over KV heads, the attention's weights whole: it
            # runs on the cache's heads, its leaves sliced at use (as
            # zamba2's shared block does)
            G = cfg.n_heads_eff // cfg.n_kv_heads_eff
            kv = local_range(cfg.n_kv_heads_eff, flat_cache["k"], m, r, 3)
            heads = (kv[0] * G, kv[1] * G)
            partial.update(p for p in flat if p.startswith("blocks/attn/"))
    ffn = experts = router = shared = None
    if cfg.family == "moe":
        experts = follow("blocks/moe/w_gate", ("blocks/moe/w_up",
                         "blocks/moe/w_down"), "MoE path")
        router = rng("blocks/moe/router")
        if experts is not None and router is None:
            partial.add("blocks/moe/router")
        if cfg.n_shared_experts:
            shared = follow("blocks/moe/shared/w_gate", (
                "blocks/moe/shared/w_up", "blocks/moe/shared/w_down"),
                "shared experts")
            if shared is not None and experts is None:
                raise NotImplementedError(
                    "the plan splits the shared experts over model and keeps "
                    "the routed experts whole: their partials ride on the "
                    "experts' all-reduce, which this layout does not run")
    else:
        ffn = follow("blocks/mlp/w_gate", ("blocks/mlp/w_up",
                     "blocks/mlp/w_down"), "dense FFN")
    cache = None
    if cache_on:
        cache = _cache_split(cfg, flat_cache, heads, kv, m, r)
    return ModelSplit(m=m, r=r, group=None, specs=flat, heads=heads, kv=kv,
                      ffn=ffn, vocab_in=rng("embed"), vocab_out=rng("lm_head"),
                      cache=cache, partial=frozenset(partial), experts=experts,
                      router=router, shared=shared, sizes=_sizes(cfg),
                      kv_group=cfg.n_heads_eff // cfg.n_kv_heads_eff,
                      kv_gather=gather)


def _sizes(cfg) -> dict[str, int]:
    """The whole dim of each of :class:`ModelSplit`'s ranges of ``cfg``
    that a rank gathers (:func:`gather_from_model`'s ``of``)."""
    out = {"heads": cfg.n_heads_eff, "kv": cfg.n_kv_heads_eff,
           "vocab_out": cfg.padded_vocab}
    if cfg.family == "moe":
        out["router"] = cfg.n_experts
    return out


def _ssm_split(cfg, flat: dict, flat_cache: dict | None, m: int, r: int,
               rng, follow, gqa, partial: set) -> ModelSplit:
    """:func:`plan_split` for the ``ssm`` and ``hybrid`` families: the
    Mamba2 layers' SSM heads, zamba2's shared block (:attr:`ModelSplit.
    block`) and the state caches."""
    P, Hs = cfg.ssm_head_dim, cfg.ssm_heads
    if rng(SSM + "w_x") is not None and Hs % m:
        raise NotImplementedError(
            f"{SSM}w_x: dim 1 ({cfg.d_inner} channels, {Hs} SSM heads of {P}) "
            f"over model = {m} is not whole heads a rank: {UNEVEN_SSM}")
    inner = follow(SSM + "w_x", (SSM + "w_z", SSM + "conv_x_w",
                                 SSM + "conv_x_b"), "Mamba2 layer",
                   whole_ok=False)
    follow(SSM + "w_x", (SSM + "out_proj",), "Mamba2 layer")
    ssm = None
    if inner is not None:
        ssm = (inner[0] // P, inner[1] // P)
        partial.update(p for p in _SSM_SHARED if p in flat)
    block = None
    if cfg.family == "hybrid":
        A = SHARED + "attn/"
        H, KV = cfg.n_heads, cfg.n_kv_heads
        heads, kv, _, _ = gqa(A, H, KV)
        ffn = follow(SHARED + "mlp/w_gate", (SHARED + "mlp/w_up",
                                             SHARED + "mlp/w_down"),
                     "shared block's FFN")
        kv_c = (_cache_range(flat_cache, "k", KV, 3, m, r)
                if flat_cache is not None else None)
        cache = None
        if kv_c is not None:
            _same_range("v", _cache_range(flat_cache, "v", KV, 3, m, r), kv_c)
            if heads is None:
                # the block's weights whole: it runs on the cache's KV
                # heads, its leaves sliced at use
                kv, heads = kv_c, (kv_c[0] * (H // KV), kv_c[1] * (H // KV))
                partial.update(p for p in (A + "wq", A + "wk", A + "wv",
                                           A + "wo") if p in flat)
            else:
                _same_range("k", kv_c, kv)
            cache = "heads"
        elif flat_cache is not None and heads is not None:
            raise NotImplementedError(
                f"cache specs {flat_cache}: the shared block's heads are split "
                "over `model`, so its cache must be split over KV heads alike")
        if heads is not None or ffn is not None:
            block = ModelSplit(m=m, r=r, group=None, specs=flat, heads=heads,
                               kv=kv, ffn=ffn, vocab_in=None, vocab_out=None,
                               cache=cache, prefix=SHARED, kv_group=H // KV)
    cache = None
    if flat_cache is not None:
        _same_range("h", _cache_range(flat_cache, "h", Hs, 2, m, r), ssm)
        _same_range("conv_x", _cache_range(flat_cache, "conv_x", cfg.d_inner,
                                           3, m, r), inner)
        for key in ("conv_b", "conv_c"):
            _same_range(key, _cache_range(flat_cache, key, cfg.ssm_state, 3,
                                          m, r), None)
        cache = "heads"
    return ModelSplit(m=m, r=r, group=None, specs=flat, heads=None, kv=None,
                      ffn=None, vocab_in=rng("embed"), vocab_out=rng("lm_head"),
                      cache=cache, partial=frozenset(partial), ssm=ssm,
                      inner=inner, block=block, sizes=_sizes(cfg))


def _cache_range(flat_cache: dict, key: str, n: int, dim: int, m: int,
                 r: int) -> tuple[int, int] | None:
    """This rank's range of dim ``dim`` (size ``n``) of the cache ``key``
    (None: whole); raises where the plan splits it on another dim or
    unevenly."""
    spec = flat_cache.get(key)
    dims = _names_model(spec)
    if not dims:
        return None
    if dims != [dim] or entry_axes(spec[dim]) != (MODEL,) or n % m:
        seq = key in ("k", "v") and 2 in dims
        raise NotImplementedError(
            f"cache {key}: spec {spec} over model = {m}: the split serves it "
            f"over `model` alone on dim {dim}, evenly"
            + ("; a sequence-split shared cache is not ported (no plan asks "
               "for one)" if seq else ""))
    return local_range(n, spec, m, r, dim)


def _same_range(key: str, got, want) -> None:
    if got != want:
        raise NotImplementedError(
            f"cache {key}: this rank's range {got} is not the range {want} its "
            "weights compute (None: whole)")


def _cache_split(cfg, flat_cache: dict, heads, kv, m: int, r: int) -> str:
    """How the plan's cache specs split the serving caches: ``"heads"`` or
    ``"seq"``; raises for what the split cannot serve."""
    if cfg.use_mla:
        dims = {_names_model(flat_cache.get(p)) and _names_model(
            flat_cache[p])[0] for p in ("ckv", "kr")}
        if dims != {2}:
            raise NotImplementedError(
                f"cache specs {flat_cache}: the MLA split serves its latents "
                "over the sequence")
        return "seq"
    k_dims = _names_model(flat_cache.get("k"))
    cache = {3: "heads", 2: "seq"}.get(k_dims[0] if k_dims else -1)
    if cache is None or any(p in flat_cache for p in ("ckv", "h")):
        raise NotImplementedError(
            f"cache specs {flat_cache}: the split serves caches over KV heads "
            "or over the sequence")
    if cache == "heads" and (heads is None or local_range(
            cfg.n_kv_heads_eff, flat_cache["k"], m, r, 3) != kv):
        raise NotImplementedError(
            "a cache split over KV heads needs the query heads split alike")
    return cache


# ------------------------------------------------------------ data ranks
@dataclasses.dataclass
class DataSplit:
    """One serving rank's share over the data-parallel axes ``pod`` ×
    ``data``: ``n`` ranks (pod-major), this rank the ``d``-th, joined by
    ``group``.  ``batch``: the plan splits the caches' batch over them, so
    the rank holds and decodes the rows :meth:`rows` gives (else every
    row).  ``fsdp``: the dims (per layer, for ``blocks/``) of the leaves
    the plan shards over ``data`` (``f`` ranks, this rank the ``fr``-th,
    joined by ``fsdp_group``): the rank holds its ``data`` shard of each
    (of its ``model`` shard, where the plan also splits the leaf over
    ``model``, on another dim) and :meth:`gather` makes the whole of it
    for one layer's run."""

    n: int
    d: int
    batch: bool
    fsdp: dict[str, int] = dataclasses.field(default_factory=dict)
    f: int = 1
    fr: int = 0
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    fsdp_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)

    def rows(self, batch: int) -> tuple[int, int] | None:
        """This rank's ``[start, stop)`` of ``batch`` cache rows, or None
        where it holds every row."""
        if not self.batch:
            return None
        if batch % self.n:
            raise ValueError(f"a batch of {batch} rows over {self.n} data "
                             "ranks: the plan leaves such a batch whole")
        k = batch // self.n
        return self.d * k, (self.d + 1) * k

    def local_shape(self, path: str, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The shape this rank holds of a leaf (one layer's) whose shape
        under the ``model`` split is ``shape``."""
        return tuple(b - a for a, b in ((s.start, s.stop) for s in
                                        self.local_slices(path, shape)))

    def local_slices(self, path: str, shape: tuple[int, ...]
                     ) -> tuple[slice, ...]:
        """The slices of ``shape`` (the leaf under the ``model`` split) that
        this rank holds: its ``data`` shard of the FSDP dim."""
        dim = self.fsdp.get(path)
        out = [slice(0, n) for n in shape]
        if dim is not None:
            n = shape[dim]
            if n % self.f:
                raise NotImplementedError(
                    f"{path}: dim {dim} ({n}) split unevenly over data = "
                    f"{self.f} is not ported")
            out[dim] = slice(*self.cols(n))
        return tuple(out)

    def gather(self, t: torch.Tensor, path: str) -> torch.Tensor:
        """The leaf at ``path`` whole along its FSDP dim (this rank's
        ``model`` shard): every ``data`` rank's shard ``t``, in order."""
        return _gather(t, self.fsdp[path], self.fsdp_group, self.f)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x`` (dim 0), in row order."""
        return _gather(x, 0, self.group, self.n) if self.batch else x

    def held(self, path: str) -> bool:
        """Whether the model computes with its shard of the leaf at
        ``path`` in place (:data:`HELD`) rather than gathering it (the
        routed experts' three leaves only together)."""
        group = _EXPERTS if path in _EXPERTS else (path,)
        return all(p in HELD and self.fsdp.get(p) == HELD[p] for p in group)

    def in_place(self, path: str) -> "DataSplit | None":
        """This split where the model computes with its shard of the leaf
        at ``path`` in place (:meth:`held`), else None: the one hook a
        layer asks, handing the split to the product over that leaf."""
        return self if self.held(path) else None

    def cols(self, n: int) -> tuple[int, int]:
        """This rank's ``[start, stop)`` of a dim of ``n`` sharded over
        ``data``."""
        return self.fr * n // self.f, (self.fr + 1) * n // self.f

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """Every ``data`` rank's columns of ``x`` (its last dim), in order:
        a product over a held leaf's output columns made whole."""
        return _gather(x, x.dim() - 1, self.fsdp_group, self.f)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ``data`` of each rank's ``x``: a product over a held
        leaf's input shard made whole (fp32 partial sums)."""
        y = x.contiguous().clone()
        dist.all_reduce(y, group=self.fsdp_group)
        return y

    def apply(self, fn, x: torch.Tensor, cols: bool) -> torch.Tensor:
        """``fn(x)``, a product over a held leaf, made whole: ``fn`` gives
        this rank's output columns (``cols``: the leaf split on its output
        dim), gathered over ``data``, or fp32 partial sums (the leaf split
        on its input dim), summed over it.  Where the data ranks hold other
        rows (a decode step: the token group installed) ``fn`` runs on
        every ``data`` rank's rows of ``x`` (dim 0), and this rank's rows
        of the result are returned."""
        n = x.shape[0]
        spread = token_group() is not None
        if spread:
            x = _gather(x, 0, self.fsdp_group, self.f)
        y = fn(x)
        y = self.gather_cols(y) if cols else self.sum(y)
        return y.narrow(0, self.fr * n, n) if spread else y


def data_split(cfg, plan, mesh) -> DataSplit | None:
    """This rank's :class:`DataSplit` under ``plan`` (its cache and
    parameter specs) on ``mesh`` (a ``DeviceMesh``); None where the mesh
    has one data-parallel rank, or the plan neither splits the caches'
    batch nor shards a weight over ``data``.  Raises
    ``NotImplementedError`` for a spec the split does not serve: a cache
    whose batch is split over other axes than ``pod`` × ``data``, a weight
    sharded over ``pod`` or over ``data`` on two dims."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    axes = dict(zip(names, getattr(mesh, "shape", ())))
    dp = tuple(a for a in DP_AXES if a in axes)
    n = math.prod(axes[a] for a in dp)
    if mesh is None or n == 1:
        return None
    coord = dict(zip(names, mesh.get_coordinate()))
    d = 0
    for a in dp:
        d = d * axes[a] + coord[a]
    batch = False
    for path, spec in _flat(plan.cache_specs or {}).items():
        on = entry_axes(tuple(spec or ())[1]) if len(spec or ()) > 1 else ()
        if on and on != dp:
            raise NotImplementedError(
                f"cache {path}: spec {spec} splits the batch over {on}; the "
                f"data split serves it over {dp} or whole")
        batch = batch or bool(on)
    fsdp: dict[str, int] = {}
    for path, spec in _flat(plan.param_specs).items():
        spec = _per_layer(path, spec)
        dims = [i for i, e in enumerate(spec)
                if set(entry_axes(e)) & set(DP_AXES)]
        if not dims:
            continue
        if len(dims) > 1 or entry_axes(spec[dims[0]]) != ("data",):
            raise NotImplementedError(
                f"{path}: spec {spec}; the data split serves weights sharded "
                "over `data` alone, on one dim")
        if axes.get("data", 1) > 1:
            fsdp[path] = dims[0]
    if not (batch or fsdp):
        return None
    return DataSplit(n=n, d=d, batch=batch, fsdp=fsdp, f=axes.get("data", 1),
                     fr=coord.get("data", 0), group=axis_group(mesh, dp),
                     fsdp_group=(axis_group(mesh, ("data",)) if fsdp
                                 else None))
