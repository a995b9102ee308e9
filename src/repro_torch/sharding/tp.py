"""A layer's compute split over the mesh's ``model`` axis (Megatron's
scheme) for the dense and MoE families.

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

At ``model = 1`` no split is made (:func:`model_split` returns None) and
no collective is issued.  The collectives are ``torch.distributed`` calls
on the tensors as they lie: gloo takes CUDA tensors as well as NCCL does.
No DTensor redistribute is used.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_group
from repro_torch.sharding.placement import local_slices
from repro_torch.sharding.ctx import all_gather_flat
from repro_torch.sharding.spec import entry_axes

__all__ = ["ModelSplit", "model_split", "plan_split", "local_range",
           "copy_to_model", "reduce_from_model", "gather_from_model",
           "max_over_model", "ROADMAP_ITEMS"]

MODEL = "model"
# what the port cannot split yet, by family: the ROADMAP items that cite it
ROADMAP_ITEMS = {
    "ssm": "ROADMAP.md, Queue A item 10g (SSM heads and state over `model`)",
    "hybrid": "ROADMAP.md, Queue A item 10g (SSM heads and state, zamba2's "
              "shared block, over `model`)",
}


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


def _gather(x: torch.Tensor, dim: int, group, m: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((m * x.numel(),))
    all_gather_flat(out, x, group)
    out = out.view((m * x.shape[0],) + tuple(x.shape[1:]))
    return out.movedim(0, dim)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, m, r, grad_sum):
        ctx.dim, ctx.n, ctx.r = dim, x.shape[dim], r
        ctx.group, ctx.grad_sum = group, grad_sum
        return _gather(x, dim, group, m)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return (g.narrow(ctx.dim, ctx.r * ctx.n, ctx.n), None, None, None,
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


def gather_from_model(x: torch.Tensor, dim: int,
                      split: "ModelSplit | None", grad_sum: bool = False
                      ) -> torch.Tensor:
    """Every rank's equal piece of ``x`` along ``dim``, in rank order:
    forward an all-gather over ``model``, backward the local slice (of the
    gradient summed over ``model`` first with ``grad_sum``: where what
    reads the gathered tensor is itself split, each rank's gradient is
    partial)."""
    if split is None:
        return x
    return _GatherFromModel.apply(x, dim % x.dim(), split.group, split.m,
                                  split.r, grad_sum)


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
    router's logit columns and the shared experts' FFN columns.  ``cache``
    is how the serving caches are split: ``"heads"`` (KV heads), ``"seq"``
    (positions; the plan's choice where KV heads do not divide the axis,
    and MLA's latents always) or None."""

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
        if self.sharded(f"blocks/{group}/{name}"):
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
    return split


def _leaf_axes(cfg) -> tuple[dict[str, tuple[int, ...]], dict[str, int]]:
    """(whole per-layer shape, the dim that may name ``model``) of each
    leaf of ``cfg`` that a split reads in part."""
    H, KV, dh, D = cfg.n_heads_eff, cfg.n_kv_heads_eff, cfg.d_head, cfg.d_model
    Vp = cfg.padded_vocab
    whole = {"embed": (Vp, D), "lm_head": (D, Vp)}
    axis = {"embed": 0, "lm_head": 1}
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
        whole.update({"blocks/attn/wq": (D, H, dh), "blocks/attn/wk": (D, KV, dh),
                      "blocks/attn/wv": (D, KV, dh), "blocks/attn/wo": (H, dh, D),
                      "blocks/attn/bq": (H, dh), "blocks/attn/bk": (KV, dh),
                      "blocks/attn/bv": (KV, dh)})
        axis.update({"blocks/attn/wq": 1, "blocks/attn/wk": 1,
                     "blocks/attn/wv": 1, "blocks/attn/wo": 0,
                     "blocks/attn/bq": 0, "blocks/attn/bk": 0,
                     "blocks/attn/bv": 0})
    if cfg.family == "moe":
        E, Fe = cfg.n_experts, cfg.d_ff_expert
        whole.update({"blocks/moe/router": (D, E),
                      "blocks/moe/w_gate": (E, D, Fe),
                      "blocks/moe/w_up": (E, D, Fe),
                      "blocks/moe/w_down": (E, Fe, D)})
        axis.update({"blocks/moe/router": 1, "blocks/moe/w_gate": 0,
                     "blocks/moe/w_up": 0, "blocks/moe/w_down": 0})
        if cfg.n_shared_experts:
            Fs = cfg.n_shared_experts * Fe
            whole.update({"blocks/moe/shared/w_gate": (D, Fs),
                          "blocks/moe/shared/w_up": (D, Fs),
                          "blocks/moe/shared/w_down": (Fs, D)})
            axis.update({"blocks/moe/shared/w_gate": 1,
                         "blocks/moe/shared/w_up": 1,
                         "blocks/moe/shared/w_down": 0})
    else:
        F = cfg.d_ff
        whole.update({"blocks/mlp/w_gate": (D, F), "blocks/mlp/w_up": (D, F),
                      "blocks/mlp/w_down": (F, D)})
        axis.update({"blocks/mlp/w_gate": 1, "blocks/mlp/w_up": 1,
                     "blocks/mlp/w_down": 0})
    return whole, axis


# the replicated MLA leaves that feed only the local heads
_MLA_SHARED = ("blocks/attn/w_dq", "blocks/attn/norm_q", "blocks/attn/w_dkv",
               "blocks/attn/norm_kv", "blocks/attn/w_kr")


def plan_split(cfg, param_specs: Any, m: int, r: int = 0,
               cache_specs: Any = None) -> ModelSplit | None:
    """The split of ``cfg`` over a ``model`` axis of ``m`` ranks that the
    plan's specs ask for, for the rank at ``r`` (no process group: the
    dry-run counts from it); None at ``m = 1`` or where the plan shards
    nothing over ``model``.  Raises ``NotImplementedError`` for what is not
    ported: the ``ssm`` and ``hybrid`` families with a leaf over ``model``,
    a dim that does not divide the axis, and combinations the split cannot
    run (a KV-head range the local query heads do not read, a head-split
    cache without split heads, MLA head leaves or expert leaves split over
    different ranges)."""
    flat = {p: _per_layer(p, s) for p, s in _flat(param_specs).items()}
    flat_cache = ({p: tuple(s or ()) for p, s in _flat(cache_specs).items()}
                  if cache_specs is not None else None)
    on_model = sorted(p for p, s in flat.items() if _names_model(s))
    cache_on = flat_cache is not None and any(_names_model(s)
                                              for s in flat_cache.values())
    if m == 1 or not (on_model or cache_on):
        return None
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"splitting the {cfg.family} family's compute over `model` is not "
            f"ported yet ({ROADMAP_ITEMS[cfg.family]}): the plan shards "
            f"{on_model[:4]} over model = {m}; run it at model = 1")
    whole, axis = _leaf_axes(cfg)
    for p in on_model:
        dims = _names_model(flat[p])
        if (p not in axis or dims != [axis[p]]
                or entry_axes(flat[p][axis[p]]) != (MODEL,)):
            raise NotImplementedError(
                f"{p}: the {cfg.family} split takes `model` alone on dim "
                f"{axis.get(p)}, the plan's spec is {flat[p]}")
        n = whole[p][axis[p]]
        if n % m:
            raise NotImplementedError(
                f"{p}: dim {n} split unevenly over model = {m} is not ported "
                "(the planner's allow_uneven)")

    def rng(p: str) -> tuple[int, int] | None:
        return (local_range(whole[p][axis[p]], flat[p], m, r, axis[p])
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

    kv = None
    if cfg.use_mla:
        heads = follow("blocks/attn/w_uq", ("blocks/attn/w_qr",
                       "blocks/attn/w_uk", "blocks/attn/w_uv", "blocks/attn/wo"),
                       "MLA path", whole_ok=False)
        if heads is not None:
            partial.update(p for p in _MLA_SHARED if p in flat)
    else:
        H, KV = cfg.n_heads_eff, cfg.n_kv_heads_eff
        heads = rng("blocks/attn/wq")
        if heads is not None:
            G, hl = H // KV, heads[1] - heads[0]
            if hl % G and G % hl:
                raise NotImplementedError(
                    f"{hl} query heads a rank against G = {G}: the local heads "
                    "do not read whole KV heads")
            kv = (heads[0] // G, (heads[1] - 1) // G + 1)
        follow("blocks/attn/wq", ("blocks/attn/wk", "blocks/attn/wv",
               "blocks/attn/wo", "blocks/attn/bq", "blocks/attn/bk",
               "blocks/attn/bv"), "attention",
               want=lambda p: heads if p in ("blocks/attn/wo", "blocks/attn/bq")
               else kv)
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
        cache = _cache_split(cfg, flat_cache, flat, on_model, heads, kv, m, r)
    return ModelSplit(m=m, r=r, group=None, specs=flat, heads=heads, kv=kv,
                      ffn=ffn, vocab_in=rng("embed"), vocab_out=rng("lm_head"),
                      cache=cache, partial=frozenset(partial), experts=experts,
                      router=router, shared=shared)


def _cache_split(cfg, flat_cache: dict, flat: dict, on_model: list,
                 heads, kv, m: int, r: int) -> str:
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
    if cache == "seq" and "blocks/attn/wk" in on_model:
        raise NotImplementedError(
            "a cache split over the sequence needs wk/wv whole on every rank "
            "(each rank writes the new row of every KV head)")
    return cache
