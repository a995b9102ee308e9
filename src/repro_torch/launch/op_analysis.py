"""Count what one device does in one call of a step: flops, bytes,
transcendentals and collectives, op by op.

The counterpart of the JAX package's ``launch/hlo_analysis.py``.  The
reference reads the optimized per-device HLO of a compiled step; PyTorch
compiles no whole step ahead of running it, so :func:`analyze` runs the
step once with every op under a ``TorchDispatchMode`` and counts each as
it reaches the dispatcher, eager op for HLO instruction.  Run on meta
tensors (shapes only, nothing allocated) it counts a step of any size on
the host: the dry-run (:mod:`repro_torch.launch.dryrun`) builds a rank's
model on meta under a fake process group of the mesh's size and counts
rank 0's step.  Run on the card it counts the same step as it launches.

The rules mirror ``analyze_hlo``'s:

* **products** — 2 · numel(result) · K for ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``matmul``, ``linear`` (einsum reaches the dispatcher as
  these) and ``convolution``; their sum is ``products``, and ``flops``
  holds them too;
* **elementwise** — one flop per result element of the reference's
  arithmetic set (add, subtract, multiply, divide, maximum, minimum,
  select, compare, negate, abs, as torch names them; ``pow`` by 2 is
  jnp's square, a multiply), and the flops of the ops PyTorch keeps fused
  at the dispatcher (``silu``, ``_softmax``, ``logsumexp`` and their
  backward ops) as the reference's instructions would count them;
* **transcendentals** — per result element of exp, tanh, log, rsqrt,
  sqrt, pow, sigmoid, sin, cos, expm1 (and inside those fused ops);
* **bytes** — each op's tensor inputs plus its outputs.  Views and
  allocations move nothing (the counterpart of ``_FREE_OPS``): an op
  whose result aliases its input, and factories (``empty``, ``zeros``,
  ``arange``, ``*_like``, ``new_*``).  An in-place op counts what it
  writes (its mutated arguments once, read as well unless it only
  overwrites them: ``copy_``, ``fill_``, ``zero_``).  Index-driven ops
  count the elements they move, twice, as ``gather``/``scatter`` and
  ``dynamic-update-slice`` do there: ``index``, ``gather``,
  ``index_select`` their result, ``index_put``, ``scatter*``,
  ``index_add`` their source, the backward of a slice or a select its
  gradient;
* **kernels** — a hand-written kernel is a ctypes call no dispatch mode
  sees: its wrapper hands its work, a function of its shapes, to
  :func:`repro_torch.kernels.build.note_kernel` where it launches, or on
  meta tensors where it returns the kernel's empty outputs, and the call
  counts as one op with that work (``kernels``: name → calls, flops,
  bytes), as a Pallas call counts in the reference's HLO; on CPU tensors
  the wrappers run their plain versions, which count op by op;
* **collectives** — the ``c10d`` ops ``sharding/tp.py``, the MoE layers
  and the train step issue: their operand bytes by the reference's five
  kinds (``coll_bytes``, ``coll_counts``: ``allreduce_``;
  ``_allgather_base_``, ``allgather_``, ``allgather_into_tensor_coalesced_``;
  ``reduce_scatter_``, ``_reduce_scatter_base_``; ``alltoall_``,
  ``alltoall_base_``; ``send``/``recv_`` as collective-permute), and
  ``coll_sent``, the bytes this rank sends by ring algorithms over each
  group's size (all-reduce 2(n − 1)/n of its operand, all-gather (n − 1)
  times its piece, reduce-scatter and all-to-all (n − 1)/n).  Any other
  collective raises, naming itself: nothing is skipped.

Two of the reference's outputs have no counterpart (:data:`ABSENT`):
``unknown_trip_loops`` (an eager step runs every layer: no loop is
counted once) and ``xla_cost_analysis`` (XLA's own per-program count).
:func:`collective_report` takes the place of ``parse_hlo_collectives``
and ``collective_bytes``.  Counts are of one device; multiply by the
devices for global numbers.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import build

__all__ = ["COLLECTIVES", "ABSENT", "OpCost", "analyze", "collective_report"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

ABSENT = {
    "unknown_trip_loops": "an eager step runs every layer: no loop body is "
                          "counted once, so no trip count is unknown",
    "xla_cost_analysis": "XLA's per-program cost analysis reads a compiled "
                         "program; nothing compiles a whole PyTorch step",
}

# c10d op → (kind, the argument holding what this rank contributes, the
# ring's bytes sent per operand byte at group size n)
_C10D: dict[str, tuple[str, str, Callable[[int], float]]] = {
    "allreduce_": ("all-reduce", "tensors", lambda n: 2 * (n - 1) / n),
    "_allgather_base_": ("all-gather", "input_tensor", lambda n: n - 1),
    "allgather_": ("all-gather", "input_tensors", lambda n: n - 1),
    "allgather_into_tensor_coalesced_": ("all-gather", "inputs",
                                         lambda n: n - 1),
    "reduce_scatter_": ("reduce-scatter", "input_tensors",
                        lambda n: (n - 1) / n),
    "_reduce_scatter_base_": ("reduce-scatter", "input_tensor",
                              lambda n: (n - 1) / n),
    "alltoall_": ("all-to-all", "input_tensors", lambda n: (n - 1) / n),
    "alltoall_base_": ("all-to-all", "input", lambda n: (n - 1) / n),
    "send": ("collective-permute", "tensors", lambda n: 1.0),
    "recv_": ("collective-permute", "tensors", lambda n: 0.0),
}

_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "matmul", "linear"}
_ARITH = {"add", "sub", "rsub", "mul", "div", "maximum", "minimum", "where",
          "masked_fill", "tril", "triu", "eq", "ne", "lt", "le", "gt", "ge",
          "neg", "abs", "clamp_min", "clamp_max", "relu", "reciprocal"}
_TRANS = {"exp", "tanh", "log", "rsqrt", "sqrt", "sigmoid", "sin", "cos",
          "expm1"}
# ops PyTorch keeps whole at the dispatcher: (flops, transcendentals) a
# result element, as their decompositions count
_FUSED = {"silu": (1, 1), "silu_backward": (5, 1), "sigmoid_backward": (3, 0),
          "tanh_backward": (3, 0), "_softmax": (2, 1),
          "_softmax_backward_data": (3, 0), "_log_softmax": (2, 1),
          "_log_softmax_backward_data": (3, 1)}
_FACTORIES = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
              "ones_like", "new_ones", "full", "full_like", "new_full",
              "arange", "scalar_tensor", "lift_fresh", "_unsafe_view",
              "resize_", "set_"}
_OVERWRITE = {"copy_", "fill_", "zero_"}
_GATHER = {"index", "gather", "index_select", "embedding", "take"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
            "scatter_reduce_", "index_add", "index_add_", "index_copy",
            "index_copy_"}
_UPDATE = {"slice_backward", "select_backward", "slice_scatter",
           "select_scatter", "diagonal_scatter", "as_strided_scatter"}


def _tensors(x: Any) -> list[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (what this rank holds), else ``t``."""
    return getattr(t, "_local_tensor", t)


def _nbytes(x: Any) -> int:
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(x))


def _numel(x: Any) -> int:
    return sum(_local(t).numel() for t in _tensors(x))


@dataclasses.dataclass
class OpCost:
    """One device's work in one call: the reference ``HloCost``'s fields
    (``flops``, ``bytes``, ``transcendentals``, ``coll_bytes`` and
    ``coll_counts`` by kind), ``products`` (the flops of products alone),
    ``coll_sent`` (bytes this rank sends by ring algorithms), ``kernels``
    (a hand-written kernel's name → calls, flops, bytes) and ``by_op``
    (each op's name → calls, flops, bytes)."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    products: float = 0.0
    coll_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_counts: dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    coll_sent: float = 0.0
    kernels: dict[str, dict[str, float]] = dataclasses.field(default_factory=dict)
    by_op: dict[str, dict[str, float]] = dataclasses.field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    def _add(self, table: dict, name: str, flops: float, nbytes: float,
             calls: int = 1) -> None:
        row = table.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        row["calls"] += calls
        row["flops"] += calls * flops
        row["bytes"] += calls * nbytes

    def count(self, name: str, flops: float, nbytes: float,
              trans: float = 0.0, products: float = 0.0, *,
              calls: int = 1) -> None:
        """``calls`` ops of ``name``, each of this work."""
        self.flops += calls * flops
        self.bytes += calls * nbytes
        self.transcendentals += calls * trans
        self.products += calls * products
        self._add(self.by_op, name, flops, nbytes, calls)

    def kernel(self, name: str, work: build.Work) -> None:
        """One call of a hand-written kernel with ``work``: one op, whose
        flops are all products."""
        self.count(name, work.flops, work.bytes, work.transcendentals,
                   work.flops)
        self._add(self.kernels, name, work.flops, work.bytes)


def _product_flops(name: str, args: tuple, out: torch.Tensor) -> float:
    """2 · numel(result) · K: K the contracted size (a convolution's input
    channels a group times its window)."""
    if name == "convolution":
        w = _local(args[1])
        return 2.0 * _numel(out) * math.prod(w.shape[1:])
    a = _local(args[1] if name in ("addmm", "baddbmm") else args[0])
    return 2.0 * _numel(out) * a.shape[-1]


def _collective(cost: OpCost, func, args: tuple, kwargs: dict,
                out: Any) -> None:
    name = func._schema.name.split("::")[1]
    if name not in _C10D:
        raise NotImplementedError(
            f"op_analysis: the collective {func} is not counted (counted: "
            f"{', '.join(sorted(_C10D))})")
    kind, arg, per_byte = _C10D[name]
    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs)
    n = torch.distributed.ProcessGroup.unbox(bound["process_group"]).size()
    operand = _nbytes(bound[arg])
    cost.coll_bytes[kind] += operand
    cost.coll_counts[kind] += 1
    cost.coll_sent += per_byte(n) * operand if n > 1 else 0.0
    cost.count(str(func), 0.0, float(operand + _nbytes(out)))


class _Rule(NamedTuple):
    """What an op's schema says for its count: its name, whether it is a
    view or an allocation (free), its arguments' names, the ones it
    mutates, whether a meta result may be made afresh from its signature's
    first (no view, no alias, nothing mutated), and its full name."""

    name: str
    free: bool
    names: tuple[str, ...]
    mutated: tuple[str, ...]
    fresh: bool
    label: str


@functools.cache
def _rule(func) -> _Rule:
    schema = func._schema
    name = func._overloadpacket.__name__
    mutated = tuple(a.name for a in schema.arguments
                    if a.alias_info is not None and a.alias_info.is_write)
    return _Rule(name=name,
                 free=func.is_view or name in _FACTORIES or name == "detach",
                 names=tuple(a.name for a in schema.arguments),
                 mutated=mutated,
                 fresh=not (func.is_view or mutated or any(
                     r.alias_info is not None for r in schema.returns)),
                 label=str(func))


def _count(func, args: tuple, kwargs: dict, out: Any
           ) -> tuple[float, float, float, float] | None:
    """(flops, bytes, transcendentals, products) of one op; None for a
    view or an allocation."""
    name, free, names, mutated = _rule(func)[:4]
    if free:
        return None
    bound = dict(zip(names, args))
    bound.update(kwargs)
    if name in _GATHER:
        return 0.0, 2.0 * _nbytes(out), 0.0, 0.0
    if name in _SCATTER or name in _UPDATE:
        src = next((bound[k] for k in ("values", "src", "source", "grad_output",
                                       "grad", "value")
                    if isinstance(bound.get(k), torch.Tensor)), None)
        moved = _nbytes(src) if src is not None else _nbytes(bound.get("index"))
        return 0.0, 2.0 * moved, 0.0, 0.0
    if mutated:
        result = [bound[k] for k in mutated if bound.get(k) is not None]
        reads = [v for k, v in bound.items() if k not in mutated]
        nbytes = _nbytes(reads) + _nbytes(result)
        if name not in _OVERWRITE and "self" in mutated:
            nbytes += _nbytes(bound["self"])
    else:
        nbytes = _nbytes(list(bound.values())) + _nbytes(out)
        result = out
    base = name.rstrip("_")
    n = _numel(result)
    flops = trans = products = 0.0
    if base in _PRODUCTS or base == "convolution":
        products = _product_flops(base, args, _tensors(result)[0])
        flops = products + (n if base in ("addmm", "baddbmm") else 0)
    elif base == "pow":
        square = (len(args) > 1 and not isinstance(args[1], torch.Tensor)
                  and args[1] == 2)
        flops, trans = (n, 0.0) if square else (0.0, n)
    elif base == "clamp":
        flops = n * sum(a is not None for a in args[1:3])
    elif base == "mean":
        flops = n
    elif base == "logsumexp":
        m = _numel(args[0])
        flops, trans = m + n, m + n
    elif base in _ARITH:
        flops = n
    elif base in _TRANS:
        trans = n
    elif base in _FUSED:
        f, t = _FUSED[base]
        flops, trans = f * n, t * n
    return flops, float(nbytes), trans, products


def _sig(xs: Any) -> tuple:
    """What an op's result shapes and its count depend on, for its
    arguments ``xs``: each tensor's shape, strides and dtype, the other
    arguments (a factory's device among them) as they are.  Raises
    TypeError on an argument that cannot key a table (a tensor subclass
    such as a DTensor, an unhashable value)."""
    out = []
    for x in xs:
        t = type(x)
        if t is torch.Tensor or t is torch.nn.Parameter:
            out.append((x.shape, x.stride(), x.dtype, x.device.type))
        elif t is list or t is tuple:
            out.append(_sig(x))
        elif isinstance(x, torch.Tensor):
            raise TypeError(f"a {t.__name__}")
        else:
            hash(x)
            out.append(x)
    return tuple(out)


def _template(out: Any) -> Any:
    """An op's meta result as (shape, strides, dtype), or a list or tuple
    of them; raises TypeError on anything else."""
    if isinstance(out, torch.Tensor) and out.is_meta:
        return torch.Size(out.shape), out.stride(), out.dtype
    if isinstance(out, (list, tuple)) and all(
            isinstance(t, torch.Tensor) for t in out):
        return [_template(t) for t in out], type(out)
    raise TypeError("not tensors")


def _afresh(tmpl: Any) -> Any:
    """New meta tensors of a :func:`_template`."""
    if isinstance(tmpl[0], torch.Size):
        return torch.empty_strided(tmpl[0], tmpl[1], dtype=tmpl[2],
                                   device="meta")
    return tmpl[1](_afresh(t) for t in tmpl[0])


class _Counter(TorchDispatchMode):
    """Counts each op into ``cost``.  An op's count depends on its
    signature (:func:`_sig`) alone, so it is worked out once a signature
    and its calls are tallied (:meth:`flush` adds them up); on meta
    tensors so is its result's shape, and a repeated signature's result is
    made afresh from the first one's (a layer's ops repeat in every layer
    and microbatch, and a meta op's shape function is far slower than the
    lookup)."""

    def __init__(self, cost: OpCost) -> None:
        super().__init__()
        self.cost = cost
        # signature → [count or None, result template or None, calls]
        self.seen: dict[Any, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in ("c10d", "_c10d_functional"):
            out = func(*args, **kwargs)
            _collective(self.cost, func, args, kwargs, out)
            return out
        try:
            key = (func, _sig(args), tuple(kwargs), _sig(kwargs.values()))
        except TypeError:
            key = None
        hit = self.seen.get(key) if key is not None else None
        if hit is not None:
            hit[2] += 1
            return _afresh(hit[1]) if hit[1] is not None else func(*args,
                                                                   **kwargs)
        out = func(*args, **kwargs)
        count = _count(func, args, kwargs, out)
        if key is None:
            if count is not None:
                self.cost.count(_rule(func).label, *count)
            return out
        tmpl = None
        if _rule(func).fresh:
            try:
                tmpl = _template(out)
            except TypeError:
                tmpl = None
        self.seen[key] = [count, tmpl, 1]
        return out

    def flush(self) -> None:
        """Add the tallied signatures' counts to ``cost``."""
        for key, (count, _, calls) in self.seen.items():
            if count is not None:
                self.cost.count(_rule(key[0]).label, *count, calls=calls)
        self.seen.clear()


def analyze(fn: Callable, *args: Any, **kw: Any) -> OpCost:
    """The :class:`OpCost` of one call ``fn(*args, **kw)`` on this device
    (its result is dropped)."""
    cost = OpCost()
    counter = _Counter(cost)
    build.LISTENERS.append(cost.kernel)
    try:
        with counter:
            fn(*args, **kw)
    finally:
        build.LISTENERS.remove(cost.kernel)
    counter.flush()
    return cost


def collective_report(cost: OpCost) -> dict[str, Any]:
    """The reference dry-run's ``collectives`` record of a count:
    ``total_bytes`` (operand bytes), ``by_kind``, ``counts``, and the
    port's ``sent`` (ring bytes this rank sends)."""
    return {"total_bytes": cost.collective_bytes,
            "by_kind": dict(cost.coll_bytes), "counts": dict(cost.coll_counts),
            "sent": cost.coll_sent}
