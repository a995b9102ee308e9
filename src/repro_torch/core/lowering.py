"""Compile-time lowering: front-end graph rewrite + back-end plan pipeline.

MAFIA's pitch (paper §IV, Fig. 1) is that ML-specific *compile-time* analysis
— not runtime dispatch — is what beats general HLS.  This module is that
spine, split in two so every later stage consumes one canonical graph:

**Front-end rewrite pipeline** (:func:`rewrite`) — runs *before* the PF-1
profiler, Best-PF optimizer and scheduler, and materializes the canonical
rewritten DFG those stages score::

    validate → prune → constant-fold → algebraic → CSE → hoist

* **validate** — structural DFG validation (shapes, acyclicity).
* **prune** — dead-node elimination (nodes unreachable from the outputs)
  and identity folding: ``scalar_mul`` by exactly 1.0, ``add``/``sub`` of
  an all-zero constant and ``hadamard`` by an all-ones constant forward
  their input (float lanes only, where each is bitwise the identity —
  modulo the usual IEEE ``-0.0 + 0.0 = +0.0`` corner of add-of-zero).
* **constant-fold** — evaluates any node whose inputs are all ``const``
  nodes at compile time (static-param subgraphs collapse to one ``const``
  per needed value; interior constants die).
* **algebraic** — strength reduction over the op registry's rewrite
  legality metadata (:class:`repro_torch.core.node_types.OpSpec.scale_param` /
  ``bias_foldable``): a ``scalar_mul`` by an exact power of two folds into
  an adjacent node's static param (producer *or* consumer side — the
  weight matrix of a gemv/spmv, the vec of a hadamard, the scalar of
  another scalar_mul), and an ``add``/``sub`` of a constant following a
  matvec folds into that matvec's write-back as a ``bias`` param — on the
  int lanes this lands the constant on the int32 accumulator *before* the
  requantizing shift (one adder per PE instead of a whole add node).
  Power-of-two scaling is exact in IEEE arithmetic and a fused bias is the
  same torch add, so every fold is bitwise-neutral at float32; the fixed
  point lanes re-calibrate the folded params (per-channel included).
* **cse** — common-subexpression elimination: nodes with identical
  ``(op, inputs, params, dims)`` merge into one (first in topo order wins;
  output nodes are never merged away so output names survive).
* **hoist** — common-*chain* hoisting across outputs: an output node that
  duplicates an existing node *and* sits at the tail of a CSE-merged run
  (≥ 2 duplicated nodes) aliases into the computed-once chain — its name
  still publishes, via the alias map, but the duplicate chain is gone.
  Lone duplicated outputs keep their own node (their names are the API).

The result is a *new* DFG containing only nodes that execute — PF
assignments, schedules and LUT/DSP reports refer to nothing else, and every
estimator query shrinks with the graph.

**Back-end plan pipeline** (the rest of :func:`lower`) — consumes the
rewritten graph plus the scheduler's decisions and emits the static
:class:`ExecutionPlan` the executor interprets::

    quantize-rewrite → cluster → chain-decompose → plan → linearize

* **quantize-rewrite** — binds each node to its execution mode: ``float``,
  ``q`` (integer template ``OpSpec.fn_q``, int32 accumulate +
  requantize-on-write) or ``dq`` (dequantize → float template → requantize,
  MAFIA's table-based PEs).
* **cluster** — collapses the scheduler's §IV-G pipeline clusters into atoms
  and fixes the atom execution order (a cluster fires once all external
  inputs are ready; a cycle *through* a cluster splits it back into nodes).
* **chain-decompose** — decomposes each fused atom into stage *chains* (one
  kernel launch each) plus direct member steps, via the same structural
  decomposition (:func:`cluster_chains`) the scheduler's pipelined-latency
  model uses — estimated and simulated latency therefore agree with what
  executes.  **Cost-guided chain splitting**: a VMEM/live-extras model
  (:func:`repro_torch.core.cost_model.chain_live_bytes`, built on the pipeline
  kernel's actual tiling) bounds each chain's footprint; a chain over the
  ``chain_split_bytes`` budget is split at the cheapest edge (the cut that
  best balances the two halves' footprints), recursively.
* **plan** — flattens atoms into the final step list and checks the plan
  invariants (every node produced exactly once; chain intermediates
  suppressed only when provably unconsumed; every output resolvable).
* **linearize** — compiles the step list to a *megakernel program*
  (:mod:`repro_torch.kernels.megakernel`): a flat instruction stream over a tiny
  VLIW-ish ISA with a liveness-allocated VMEM register file, executed one
  kernel launch per segment (one launch total when every step encodes;
  non-encodable steps become interpreted islands of a plan-ordered hybrid).
  The executor's ``mode="megakernel"`` runs it; per-step interpretation
  stays the oracle.

Both pipelines run under a :class:`PassManager` that records per-pass wall
time (``ExecutionPlan.pass_timings``) and, with ``debug=True``, a per-pass
dump of the evolving graph (``ExecutionPlan.dump``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import node_types
from repro_torch.core import shapes as shp
from repro_torch.core.dfg import DFG, Node

__all__ = [
    "NodeStep", "ChainStep", "ExecutionPlan", "RewriteResult", "PassManager",
    "rewrite", "lower", "cluster_chains", "split_chain",
    "FRONTEND_PASSES", "BACKEND_PASSES", "PASS_NAMES", "STAGEABLE_OPS",
    "DEFAULT_CHAIN_SPLIT_BYTES",
]

# DFG ops expressible as fused pipeline stages (elementwise, no reduction).
STAGEABLE_OPS = frozenset(
    {"scalar_mul", "add", "sub", "hadamard", "tanh", "sigmoid", "relu", "exp"})
_BIN_ARR = {"add": "add_arr", "sub": "sub_arr", "hadamard": "hadamard_arr"}
_BIN_VEC = {"add": "add_vec", "sub": "sub_vec", "hadamard": "hadamard_vec"}
_Q_BIN_ARR = {"add": "q_add_arr", "sub": "q_sub_arr", "hadamard": "q_hadamard_arr"}
_Q_BIN_VEC = {"add": "q_add_vec", "sub": "q_sub_vec", "hadamard": "q_hadamard_vec"}
_UNARY_OPS = ("tanh", "sigmoid", "relu", "exp")

FRONTEND_PASSES = ("validate", "prune", "constant-fold", "algebraic", "cse",
                   "hoist")
BACKEND_PASSES = ("quantize-rewrite", "cluster", "chain-decompose", "plan",
                  "linearize")
PASS_NAMES = FRONTEND_PASSES + BACKEND_PASSES

# Default per-chain footprint budget for cost-guided splitting: a quarter of
# a ~16 MB VMEM, leaving room for double buffering and the matvec operands
# that share the core.  None disables splitting.
DEFAULT_CHAIN_SPLIT_BYTES: float = 4 * 1024 * 1024


# ------------------------------------------------------------- pass manager
class PassManager:
    """Tiny orchestrator: runs named passes, records per-pass wall time and
    (optionally) a one-line debug dump of the state after each pass."""

    def __init__(self, debug: bool = False) -> None:
        self.debug = debug
        self.timings: list[tuple[str, float]] = []
        self.dumps: list[str] = []

    def run(self, name: str, fn: Callable[[Any], Any], state: Any) -> Any:
        t0 = time.perf_counter()
        out = fn(state)
        self.timings.append((name, time.perf_counter() - t0))
        if self.debug:
            desc = getattr(state, "describe", lambda: "")()
            self.dumps.append(f"{name}: {desc}")
        return out


# ------------------------------------------------------------------- steps
@dataclasses.dataclass(frozen=True)
class NodeStep:
    """Execute one node through its resolved template function.

    ``fn`` is pre-bound at lowering time: the float template, the integer
    template with its :class:`~repro_torch.core.quantize.NodeQuant`, or the
    dequantize→float→requantize wrapper — the interpreter never consults the
    op registry or the quant plan again.
    """

    nid: str
    inputs: tuple[str, ...]          # env refs (graph inputs or node ids)
    fn: Callable[..., Any]
    mode: str = "float"              # float | q | dq


@dataclasses.dataclass(frozen=True)
class ChainStep:
    """Execute a pre-lowered linear-time stage chain in one fused kernel.

    ``stages`` is the static stage program (float vocabulary with embedded
    vec operands, or the ``q_*`` vocabulary indexing ``vecs``); ``extras``
    are env refs streamed in as full arrays.  ``dead`` members are published
    as ``None`` — the lowering proved no step ever reads them (that is the
    point of fusion); ``terminal`` carries the chain's value.
    """

    members: tuple[str, ...]
    stream: str                      # env ref of the streaming input
    stages: tuple[Any, ...]
    extras: tuple[str, ...]          # env refs for *_arr stage operands
    vecs: tuple[Any, ...]            # static vec operands (quantized chains)
    terminal: str
    dead: tuple[str, ...]
    quantized: bool


@dataclasses.dataclass
class ExecutionPlan:
    """Static execution plan: everything the interpreter needs, resolved.

    ``dfg`` is the canonical *rewritten* graph — the same graph the
    optimizer and scheduler scored.  The plan is per (DFG, fused_clusters,
    use_pallas, precision) — the per-sample, vmap and map lanes all
    interpret the same plan, which is what makes them agree (bitwise at
    fixed point)."""

    dfg: DFG                         # canonical rewritten graph
    steps: tuple[NodeStep | ChainStep, ...]
    outputs: tuple[str, ...]         # original output names (pre-rewrite)
    precision: str
    bits: int | None                 # activation width (int lanes), else None
    qplan: Any | None
    use_pallas: bool
    input_exps: dict[str, int] | None     # input quantization (int lanes)
    output_exps: dict[str, int | None] | None  # None exp = integer passthrough
    alias: dict[str, str]            # rewritten-away node id -> env ref
    pruned: tuple[str, ...]          # dead node ids never executed
    cluster_splits: int              # clusters split by the cycle fallback
    folded: tuple[str, ...] = ()     # nodes evaluated away at compile time
    chain_splits: int = 0            # chains cut by the cost-guided splitter
    pass_timings: tuple[tuple[str, float], ...] = ()
    dump: tuple[str, ...] = ()       # per-pass debug dump (debug=True only)
    algebraic: tuple[str, ...] = ()  # nodes eliminated by algebraic rewrites
    hoisted: tuple[str, ...] = ()    # output dups merged by chain hoisting
    megakernel: Any | None = None    # MegakernelProgram (linearize pass)

    @property
    def chain_steps(self) -> list[ChainStep]:
        return [s for s in self.steps if isinstance(s, ChainStep)]

    @property
    def node_steps(self) -> list[NodeStep]:
        return [s for s in self.steps if isinstance(s, NodeStep)]

    def summary(self) -> str:
        ch = self.chain_steps
        return (f"ExecutionPlan({self.dfg.name!r}: {len(self.node_steps)} node "
                f"steps, {len(ch)} fused chains "
                f"({sum(len(c.members) for c in ch)} nodes), "
                f"{len(self.pruned)} pruned, {len(self.alias)} aliased, "
                f"{len(self.folded)} const-folded, "
                f"{len(self.algebraic)} algebraic, "
                f"{len(self.hoisted)} hoisted, "
                f"{self.chain_splits} chain splits, "
                f"precision={self.precision})")

    def verify(self) -> None:
        """Assert the compile-time invariants the old executor re-derived at
        trace time: complete single-assignment coverage of the rewritten
        graph, chain intermediates suppressed only when provably unconsumed,
        and — the one a pass bug would otherwise turn into a KeyError deep
        in the executor — every output resolving to a produced value."""
        produced: list[str] = []
        for step in self.steps:
            if isinstance(step, NodeStep):
                produced.append(step.nid)
            else:
                produced.extend(step.members)
        dup = {n for n in produced if produced.count(n) > 1}
        if dup:
            raise AssertionError(f"plan produces nodes twice: {sorted(dup)}")
        live = set(self.dfg.nodes)
        if set(produced) != live:
            raise AssertionError(
                f"plan covers {sorted(set(produced))} but live set is {sorted(live)}")
        # every output must resolve (through the rewrite alias) to a value
        # the interpreter will hold: a produced node or a graph input.
        dangling = sorted(
            out for out in self.outputs
            if _resolve(self.alias, out) not in live
            and _resolve(self.alias, out) not in self.dfg.graph_inputs)
        if dangling:
            raise ValueError(
                f"outputs {dangling} resolve to values the plan never "
                f"produces (alias chain ends outside the rewritten graph) — "
                f"a rewrite pass dropped a node an output depends on")
        # consumers over the rewritten graph's edges
        consumers: dict[str, set[str]] = {}
        for nid in live:
            for src in self.dfg.nodes[nid].inputs:
                consumers.setdefault(src, set()).add(nid)
        out_refs = {_resolve(self.alias, out) for out in self.outputs}
        for step in self.chain_steps:
            for i, nid in enumerate(step.dead):
                nxt = step.members[step.members.index(nid) + 1]
                outside = consumers.get(nid, set()) - {nxt}
                if nid in out_refs or outside:
                    raise AssertionError(
                        f"chain suppresses {nid!r} but it is consumed by "
                        f"{sorted(outside) or 'outputs'}")
        # per-node shape audit: the declared out_shape rule must match what
        # the float template actually produces — a mismatched rule surfaces
        # here with the node named, instead of as a cryptic broadcast error
        # deep inside the executor.
        for nid in live:
            node = self.dfg.nodes[nid]
            declared = tuple(self.dfg.out_shape(nid))
            actual = _template_out_shape(node, self.dfg.in_shapes(nid))
            if actual is not None and actual != declared:
                raise ValueError(
                    f"node {nid!r} ({node.op}): declared out_shape "
                    f"{declared} does not match the template's output "
                    f"{actual}")


def _resolve(alias: dict[str, str], ref: str) -> str:
    while ref in alias:
        ref = alias[ref]
    return ref


_TEMPLATE_SHAPE_CACHE: dict[tuple, tuple | None] = {}


def _param_sig(params: dict[str, Any]) -> tuple:
    """Hashable abstract signature of a node's static params — scalar attrs
    by value (they steer shapes: strides, paddings, reshape targets), arrays
    by shape/dtype only (their values never do)."""
    sig = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, (int, float, bool, str)):
            sig.append((k, v))
        elif isinstance(v, (tuple, list)) and all(
                isinstance(x, (int, float)) for x in v):
            sig.append((k, tuple(v)))
        else:
            try:
                a = np.asarray(v)
                sig.append((k, "arr", tuple(a.shape), str(a.dtype)))
            except Exception:
                sig.append((k, "obj", type(v).__name__))
    return tuple(sig)


def _template_out_shape(node: Node, in_shapes: list) -> tuple | None:
    """Output shape the node's float template actually produces, from one
    run of the torch template on float32 zeros on the CPU.  Memoized on the
    node's abstract signature so the plan-time audit costs one run per
    distinct layer shape per process, not one per compile.  Returns None
    when the template cannot run on float32 placeholders — the audit then
    skips the node."""
    key = (node.op, tuple(tuple(s) for s in in_shapes),
           _param_sig(node.params))
    if key in _TEMPLATE_SHAPE_CACHE:
        return _TEMPLATE_SHAPE_CACHE[key]
    spec = node_types.get(node.op)
    try:
        with torch.no_grad():
            out = spec.fn([torch.zeros(tuple(s), dtype=torch.float32)
                           for s in in_shapes], node.params, node.dims)
        shape: tuple | None = tuple(out.shape)
    except Exception:
        shape = None
    _TEMPLATE_SHAPE_CACHE[key] = shape
    return shape


# ================================================================ front-end
@dataclasses.dataclass
class RewriteResult:
    """Outcome of the front-end rewrite pipeline.

    ``dfg`` is the canonical graph every later stage consumes; node ids are
    preserved from ``source`` (constant-folding rewrites a node in place to
    ``const``, it never invents ids), so external PF assignments and the
    quant plan remain addressable."""

    source: DFG
    dfg: DFG
    alias: dict[str, str]            # removed node id -> surviving env ref
    pruned: tuple[str, ...]          # dead code (unreachable from outputs)
    folded: tuple[str, ...]          # evaluated away at compile time
    timings: list[tuple[str, float]] = dataclasses.field(default_factory=list)
    dumps: list[str] = dataclasses.field(default_factory=list)
    algebraic: tuple[str, ...] = ()  # nodes eliminated by algebraic rewrites
    hoisted: tuple[str, ...] = ()    # output dups merged by chain hoisting


class _Rewrite:
    """Mutable front-end state; the source DFG is never modified — const
    rewrites live in ``repl`` until materialization."""

    def __init__(self, dfg: DFG, precision: str) -> None:
        self.source = dfg
        self.precision = precision
        self.repl: dict[str, Node] = {}      # const-fold rewrites, by id
        self.alias: dict[str, str] = {}
        self.live: set[str] = set()
        self.topo: list[str] = []
        self.pruned: set[str] = set()
        self.folded: set[str] = set()
        self.algebraic: set[str] = set()
        self.cse: set[str] = set()       # nodes merged away by the CSE pass
        self.hoisted: set[str] = set()

    def node(self, nid: str) -> Node:
        return self.repl.get(nid) or self.source.nodes[nid]

    def ref(self, src: str) -> str:
        return _resolve(self.alias, src)

    def rinputs(self, nid: str) -> list[str]:
        return [self.ref(s) for s in self.node(nid).inputs]

    def recompute_live(self) -> None:
        live: set[str] = set()
        stack = [self.ref(o) for o in self.source.outputs]
        while stack:
            nid = stack.pop()
            if nid in live or nid not in self.source.nodes:
                continue
            live.add(nid)
            stack.extend(self.rinputs(nid))
        self.live = live
        self.topo = [n for n in self.source.topo_order() if n in live]

    def describe(self) -> str:
        return (f"{len(self.live)} live / {len(self.source.nodes)} nodes, "
                f"{len(self.alias)} aliased, {len(self.folded)} folded")


def _fe_validate(st: _Rewrite) -> None:
    st.source.validate()


def _const_value(dfg: DFG, ref: str) -> np.ndarray | None:
    """The value of ``ref`` if it is a ``const`` node of ``dfg``, else None."""
    node = dfg.nodes.get(ref)
    if node is not None and node.op == "const":
        return np.asarray(node.params["value"])
    return None


def _identity_fold_target(dfg: DFG, node: Node) -> str | None:
    """Env ref an identity node forwards to, or None if not an identity.

    Covered identities (all bitwise in float32, with the one IEEE corner
    that ``x + (±0.0)`` maps an input of ``-0.0`` to ``+0.0``):
    ``scalar_mul`` by 1.0; ``add``/``sub`` of an all-zero constant (const
    node or ``vec`` param; for sub only the right operand); ``hadamard``
    by an all-ones constant (either operand)."""
    if node.op == "scalar_mul":
        return node.inputs[0] if float(node.params["scalar"]) == 1.0 else None
    if node.op not in ("add", "sub", "hadamard"):
        return None
    neutral = 1.0 if node.op == "hadamard" else 0.0
    if "vec" in node.params and len(node.inputs) == 1:
        vec = np.asarray(node.params["vec"])
        return node.inputs[0] if np.all(vec == neutral) else None
    if len(node.inputs) != 2:
        return None
    # sub is not commutative: only x - 0 folds, 0 - x negates
    positions = (0, 1) if node.op in ("add", "hadamard") else (1,)
    for pos in positions:
        val = _const_value(dfg, node.inputs[pos])
        if val is not None and np.all(val == neutral):
            return node.inputs[1 - pos]
    return None


def _fe_prune(st: _Rewrite) -> None:
    dfg = st.source
    if st.precision == "float32":
        # identity folds: forward the untouched input (float lanes only —
        # fixed-point lanes keep the node: its requantize can change scale).
        for nid, node in dfg.nodes.items():
            if nid in dfg.outputs:
                continue
            tgt = _identity_fold_target(dfg, node)
            if tgt is not None:
                st.alias[nid] = tgt
    st.recompute_live()
    st.pruned = set(dfg.nodes) - st.live - set(st.alias)


def _fe_constant_fold(st: _Rewrite) -> None:
    """Evaluate static-param subgraphs at compile time: any node whose
    (resolved) inputs are all ``const`` nodes becomes a ``const`` holding
    its value; interior constants lose their last consumer and die.  The
    evaluation runs the port's torch templates on the CPU and stores the
    value as a numpy array."""
    from repro_torch.core.node_types import _t

    before = set(st.live)
    for nid in st.topo:
        node = st.node(nid)
        if node.op == "const" or not node.inputs:
            continue
        rin = st.rinputs(nid)
        if not all(r in st.source.nodes and st.node(r).op == "const"
                   for r in rin):
            continue
        spec = node_types.get(node.op)
        vals = [_t(st.node(r).params["value"]) for r in rin]
        with torch.no_grad():
            out = spec.fn(vals, node.params, node.dims).numpy()
        st.repl[nid] = Node(id=nid, op="const", dims={"n": int(out.size)},
                            inputs=[], params={"value": out})
    st.recompute_live()
    # constants consumed into a fold are *folded*, not dead code
    st.folded = before - st.live


def _pow2_rescale(value: Any, c: float) -> Any | None:
    """``value * c`` if ``c`` is a finite, nonzero power of two and the
    rescale is lossless (every element scales exactly — no overflow, no
    precision loss in the subnormal range), else None.

    Power-of-two scaling is the legality gate that keeps the algebraic
    folds bitwise-neutral at float32: multiplying by 2^k only moves IEEE
    exponents, so it is exact on each element and distributes exactly over
    the sums and products inside a matvec."""
    if not math.isfinite(c) or c == 0.0 or math.frexp(abs(c))[0] != 0.5:
        return None
    if isinstance(value, (int, float)):
        out = float(value) * c
        return out if math.isfinite(out) and out / c == float(value) else None
    arr = np.asarray(value)
    if not np.issubdtype(arr.dtype, np.floating):
        return None
    cc = arr.dtype.type(c)
    out = arr * cc
    if not np.all(np.isfinite(out)) or not np.array_equal(out / cc, arr):
        return None
    return out


def _pow2_rescale_rows(value: Any, v: Any) -> Any | None:
    """Row-wise analogue of :func:`_pow2_rescale`: row *i* of ``value``
    times ``v[i]`` (element *i* for a 1-D ``value``), if **every** ``v[i]``
    is a finite nonzero power of two and every row rescales losslessly —
    else None.  This is the legality gate for folding a hadamard-by-const
    into a matvec: ``v ⊙ (W@x + b) = (diag(v)·W)@x + v⊙b`` is bitwise at
    float32 exactly when each row scale only moves IEEE exponents."""
    arr = np.asarray(value)
    vv = np.asarray(v).ravel()
    if (not np.issubdtype(arr.dtype, np.floating)
            or not np.issubdtype(vv.dtype, np.floating)
            or arr.ndim not in (1, 2) or vv.shape[0] != arr.shape[0]):
        return None
    mant, _ = np.frexp(np.abs(vv))
    if not (np.all(np.isfinite(vv)) and np.all(vv != 0.0)
            and np.all(mant == 0.5)):
        return None
    col = vv.astype(arr.dtype).reshape(-1, 1) if arr.ndim == 2 else (
        vv.astype(arr.dtype))
    out = arr * col
    if not np.all(np.isfinite(out)) or not np.array_equal(out / col, arr):
        return None
    return out


def _rw_const_value(st: _Rewrite, ref: str) -> np.ndarray | None:
    """Value of ``ref`` if it resolves to a ``const`` node (including nodes
    the constant-fold pass rewrote in place), else None."""
    if ref in st.source.nodes:
        node = st.node(ref)
        if node.op == "const":
            return np.asarray(node.params["value"])
    return None


def _fe_algebraic(st: _Rewrite) -> None:
    """Algebraic strength reduction over the op registry's rewrite-legality
    metadata, run to a fixpoint (each fold can expose the next — e.g.
    Bonsai's per-level ``spmv → +1 → ×0.5`` collapses into one biased,
    rescaled spmv in two steps):

    * **scalar sink** — ``scalar_mul`` by an exact power of two whose sole
      producer has a ``scale_param`` (gemv/spmv matrix, hadamard vec,
      another scalar_mul's scalar) folds into that param; the producer's
      rescaled output *is* the scalar_mul's old value, so the node aliases
      away (its bias, if already folded, rescales too).
    * **scalar hoist** — ``scalar_mul`` feeding a sole ``scale_param``
      consumer with one dynamic input folds forward: ``W @ (c·x) ≡
      (c·W) @ x`` bitwise for pow2 ``c``; the consumer rewires past it.
    * **bias fold** — ``add``/``sub`` of a constant (a ``vec`` param or a
      ``const`` node) whose other operand is a sole-consumer
      ``bias_foldable`` matvec becomes that matvec's ``bias`` param — at
      float32 the same torch add; on the int lanes the constant lands on the
      int32 accumulator *before* the requantizing shift (the "following
      requantize's bias stage"), re-calibrated with the folded weights.
    * **scalar distribute** — ``scalar_mul`` by a pow2 ``c`` over a
      sole-consumer ``add``/``sub`` whose operands can all absorb the
      scale statically (consts, or sole-consumer nodes with a
      ``scale_param``) pushes ``c`` through: ``c·(a±b) = c·a ± c·b`` is
      exact for pow2 ``c`` (exponent shifts distribute over the sum), so
      the scalar_mul aliases to the add/sub and the scale lands on leaf
      params — exposing further sinks (``c·(W@x + V@y)`` becomes two
      rescaled matvecs in one sweep each).
    * **row scale** — ``hadamard`` by a constant vector (a ``vec`` param
      or a ``const`` operand) over a sole-consumer matvec folds into the
      weight rows: ``v ⊙ (W@x + b) = (diag(v)·W)@x + v⊙b``, gated on
      every ``v[i]`` being a lossless pow2 row rescale
      (:func:`_pow2_rescale_rows`); the hadamard aliases to the matvec.

    Every fold is gated so it is bitwise-neutral at float32; targets that
    would change a published output (output nodes, shared consumers) are
    left alone."""
    bias_consts: set[str] = set()

    def consumers() -> dict[str, list[str]]:
        cons: dict[str, list[str]] = {}
        for nid in st.topo:
            for r in st.rinputs(nid):
                cons.setdefault(r, []).append(nid)
        return cons

    def scale_node(pid: str, c: float, *, scale_bias: bool) -> bool:
        """Rescale ``pid``'s scale_param by ``c``.  ``scale_bias`` says
        whether an existing folded bias scales too: sinking a scalar_mul
        that consumes the node scales its whole output, bias included
        (c·(W@x + b) = (cW)@x + c·b); hoisting one that feeds it scales
        only the matvec term (W@(c·x) + b = (cW)@x + b), so the bias must
        stay untouched."""
        p = st.node(pid)
        spec = node_types.get(p.op)
        if spec.scale_param is None or spec.scale_param not in p.params:
            return False
        new_params = dict(p.params)
        scaled = _pow2_rescale(p.params[spec.scale_param], c)
        if scaled is None:
            return False
        new_params[spec.scale_param] = scaled
        if scale_bias and "bias" in p.params:
            scaled_b = _pow2_rescale(p.params["bias"], c)
            if scaled_b is None:
                return False
            new_params["bias"] = scaled_b
        st.repl[pid] = dataclasses.replace(
            p, params=new_params, dims=dict(p.dims), inputs=list(p.inputs))
        return True

    def try_scalar(nid: str, cons, outputs) -> bool:
        node = st.node(nid)
        if node.op != "scalar_mul":
            return False
        c = float(node.params["scalar"])
        src = st.ref(node.inputs[0])
        # sink into the producer (nid may be an output: it aliases to the
        # rescaled producer, whose value is exactly nid's old value)
        if (src in st.source.nodes and src not in outputs
                and set(cons.get(src, ())) == {nid}
                and scale_node(src, c, scale_bias=True)):
            st.alias[nid] = src
            st.algebraic.add(nid)
            return True
        # hoist into the sole consumer (nid's value vanishes, so it must
        # not be an output itself)
        users = cons.get(nid, [])
        if nid not in outputs and len(set(users)) == 1:
            q = users[0]
            qn = st.node(q)
            if len(qn.inputs) == 1 and scale_node(q, c, scale_bias=False):
                st.repl[q].inputs[0] = node.inputs[0]
                st.folded.add(nid)
                st.algebraic.add(nid)
                return True
        return False

    def try_bias(nid: str, cons, outputs) -> bool:
        node = st.node(nid)
        if node.op not in ("add", "sub"):
            return False
        # (target ref, bias vector, const-node ref or None)
        cand: tuple[str, np.ndarray, str | None] | None = None
        if "vec" in node.params and len(node.inputs) == 1:
            vec = np.asarray(node.params["vec"])
            cand = (st.ref(node.inputs[0]),
                    np.negative(vec) if node.op == "sub" else vec, None)
        elif len(node.inputs) == 2:
            rin = [st.ref(s) for s in node.inputs]
            # sub is not commutative: only the right operand is a bias
            for pos in ((1, 0) if node.op == "add" else (1,)):
                val = _rw_const_value(st, rin[pos])
                if val is not None and np.issubdtype(val.dtype, np.floating):
                    cand = (rin[1 - pos],
                            np.negative(val) if node.op == "sub" else val,
                            rin[pos])
                    break
        if cand is None:
            return False
        tgt, bias, cref = cand
        if tgt not in st.source.nodes or tgt in outputs:
            return False
        p = st.node(tgt)
        spec = node_types.get(p.op)
        if (not spec.bias_foldable or "bias" in p.params
                or set(cons.get(tgt, ())) != {nid}):
            return False
        st.repl[tgt] = dataclasses.replace(
            p, params={**p.params, "bias": bias},
            dims={**p.dims, "bias": 1}, inputs=list(p.inputs))
        st.alias[nid] = tgt
        st.algebraic.add(nid)
        if cref is not None:
            bias_consts.add(cref)
        return True

    def can_scale_operand(rid: str, c: float) -> bool:
        """Dry-run: can ``rid``'s value be rescaled by ``c`` statically
        (const value, or scale_param + folded bias), losslessly?"""
        p = st.node(rid)
        if p.op == "const":
            return _pow2_rescale(p.params["value"], c) is not None
        spec = node_types.get(p.op)
        return (spec.scale_param is not None
                and spec.scale_param in p.params
                and _pow2_rescale(p.params[spec.scale_param], c) is not None
                and ("bias" not in p.params
                     or _pow2_rescale(p.params["bias"], c) is not None))

    def scale_operand(rid: str, c: float) -> bool:
        p = st.node(rid)
        if p.op == "const":
            scaled = _pow2_rescale(p.params["value"], c)
            if scaled is None:
                return False
            st.repl[rid] = dataclasses.replace(
                p, params={**p.params, "value": scaled},
                dims=dict(p.dims), inputs=list(p.inputs))
            return True
        return scale_node(rid, c, scale_bias=True)

    def try_distribute(nid: str, cons, outputs) -> bool:
        node = st.node(nid)
        if node.op != "scalar_mul":
            return False
        c = float(node.params["scalar"])
        src = st.ref(node.inputs[0])
        if src not in st.source.nodes or src in outputs:
            return False
        s = st.node(src)
        if s.op not in ("add", "sub") or set(cons.get(src, ())) != {nid}:
            return False
        vec_scaled = None
        if "vec" in s.params:          # add/sub-by-static-vec form
            vec_scaled = _pow2_rescale(s.params["vec"], c)
            if vec_scaled is None:
                return False
        # every dynamic operand must absorb the scale (all-or-nothing):
        # scaling changes its value, so it must be private to the add/sub.
        rins = set(st.ref(r) for r in s.inputs)
        for r in rins:
            if (r not in st.source.nodes or r in outputs
                    or set(cons.get(r, ())) != {src}
                    or not can_scale_operand(r, c)):
                return False
        for r in rins:
            scale_operand(r, c)
        if vec_scaled is not None:
            sv = st.node(src)
            st.repl[src] = dataclasses.replace(
                sv, params={**sv.params, "vec": vec_scaled},
                dims=dict(sv.dims), inputs=list(sv.inputs))
        st.alias[nid] = src
        st.algebraic.add(nid)
        return True

    def try_rowscale(nid: str, cons, outputs) -> bool:
        node = st.node(nid)
        if node.op != "hadamard":
            return False
        # (target ref, row-scale vector, const-node ref or None)
        cand: tuple[str, np.ndarray, str | None] | None = None
        if "vec" in node.params and len(node.inputs) == 1:
            cand = (st.ref(node.inputs[0]),
                    np.asarray(node.params["vec"]), None)
        elif len(node.inputs) == 2:
            rin = [st.ref(s) for s in node.inputs]
            for pos in (1, 0):         # hadamard is commutative
                val = _rw_const_value(st, rin[pos])
                if val is not None and np.issubdtype(val.dtype, np.floating):
                    cand = (rin[1 - pos], val, rin[pos])
                    break
        if cand is None:
            return False
        tgt, v, cref = cand
        if tgt not in st.source.nodes or tgt in outputs:
            return False
        p = st.node(tgt)
        spec = node_types.get(p.op)
        if (spec.scale_param != "matrix" or not spec.bias_foldable
                or set(cons.get(tgt, ())) != {nid}):
            return False
        new_w = _pow2_rescale_rows(p.params["matrix"], v)
        if new_w is None:
            return False
        new_params = {**p.params, "matrix": new_w}
        if "bias" in p.params:
            new_b = _pow2_rescale_rows(p.params["bias"], v)
            if new_b is None:
                return False
            new_params["bias"] = new_b
        # pow2 row scales never flip a zero, so spmv's derived nnz (and
        # every other dim) is unchanged — dims carry over verbatim.
        st.repl[tgt] = dataclasses.replace(
            p, params=new_params, dims=dict(p.dims), inputs=list(p.inputs))
        st.alias[nid] = tgt
        st.algebraic.add(nid)
        if cref is not None:
            bias_consts.add(cref)
        return True

    # One fold per sweep, maps rebuilt in between: the sole-consumer and
    # output-ref checks then never run against stale state.  Quadratic in
    # fold count, but Table-I graphs are tens of nodes and the whole pass
    # stays ~1 ms — correctness over a micro-optimization here.
    changed = True
    while changed:
        changed = False
        st.recompute_live()
        cons = consumers()
        outputs = {st.ref(o) for o in st.source.outputs}
        for nid in st.topo:
            if (try_scalar(nid, cons, outputs)
                    or try_bias(nid, cons, outputs)
                    or try_distribute(nid, cons, outputs)
                    or try_rowscale(nid, cons, outputs)):
                changed = True
                break
    # a const consumed into a bias (and nothing else) was folded, not dead
    for cref in bias_consts:
        if cref not in st.live:
            st.folded.add(cref)
            st.algebraic.add(cref)


def _fe_cse(st: _Rewrite) -> None:
    """Value-number the live graph: nodes computing the identical
    ``(op, inputs, params, dims)`` merge into the first occurrence.  Output
    nodes are never merged away (their names must survive)."""
    seen: dict[Any, str] = {}
    outputs = set(st.source.outputs)
    for nid in st.topo:
        node = st.node(nid)
        key = (node.op, tuple(st.rinputs(nid)),
               tuple(sorted(node.dims.items())), _fingerprint(node.params))
        rep = seen.get(key)
        if rep is not None and nid not in outputs:
            st.alias[nid] = rep
            st.cse.add(nid)
        elif rep is None:
            seen[key] = nid
    st.recompute_live()


def _fe_hoist(st: _Rewrite) -> None:
    """Common-*chain* hoisting across outputs.  CSE cascades through
    duplicated interior nodes but never merges output nodes (their names
    are the API), so an output at the tail of a chain identical to one
    computed elsewhere kept a private copy of the final node.  This pass
    merges exactly those: an *output* node that (a) duplicates another node
    — output or interior — and (b) sits at the tail of a CSE-merged run
    (one of its raw inputs was merged away *by the CSE pass specifically* —
    i.e. the duplicated region is a chain of ≥ 2 nodes, not a lone node
    whose input merely resolved through a prune/algebraic alias) aliases
    into the computed-once chain.  Its name still publishes through the
    alias map; the duplicate chain is gone.  The representative need not be
    an output itself: materialize records every resolved output target in
    ``DFG.published``, which the back-end's needed-outside analysis
    consults alongside ``dfg.outputs``, so an interior shared tail stays
    live (never buried inside a fused chain)."""
    seen: dict[Any, str] = {}
    outputs = set(st.source.outputs)
    for nid in st.topo:
        node = st.node(nid)
        key = (node.op, tuple(st.rinputs(nid)),
               tuple(sorted(node.dims.items())), _fingerprint(node.params))
        rep = seen.get(key)
        if rep is None:
            seen[key] = nid
        elif nid in outputs and any(s in st.cse for s in node.inputs):
            st.alias[nid] = rep
            st.hoisted.add(nid)
    st.recompute_live()


def _fingerprint(params: dict[str, Any]) -> tuple:
    items: list[tuple] = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, (int, float, bool, str)):
            items.append((k, type(v).__name__, v))
        else:
            a = np.asarray(v)
            items.append((k, a.dtype.str, a.shape, a.tobytes()))
    return tuple(items)


def _fe_materialize(st: _Rewrite) -> DFG:
    """Build the canonical rewritten DFG: live nodes only, inputs resolved
    through the alias map, profiler/optimizer tags reset."""
    new = DFG(st.source.name)
    new.graph_inputs = dict(st.source.graph_inputs)
    for nid in st.topo:
        node = st.node(nid)
        new.nodes[nid] = dataclasses.replace(
            node, dims=dict(node.dims), inputs=[st.ref(s) for s in node.inputs],
            latency1=None, lut1=None, pf=1)
    new.outputs = list(st.source.outputs)
    # resolved output targets: the nodes that actually publish each output
    # value (differs from ``outputs`` when a hoisted output aliases into an
    # interior chain tail) — liveness analyses consult this alongside
    # ``outputs`` so a shared tail is never buried inside a fused chain.
    new.published = frozenset(st.ref(o) for o in st.source.outputs)
    return new


def rewrite(dfg: DFG, *, precision: str = "float32",
            pm: PassManager | None = None) -> RewriteResult:
    """Run the front-end rewrite pipeline and materialize the canonical
    graph.  This is the *first* thing :meth:`MafiaCompiler.compile` does —
    the profiler, optimizer, scheduler and quantizer all consume the
    result, so their PF assignments, schedules and resource reports refer
    only to nodes that actually execute."""
    pm = pm or PassManager()
    st = _Rewrite(dfg, precision)
    pm.run("validate", _fe_validate, st)
    pm.run("prune", _fe_prune, st)
    pm.run("constant-fold", _fe_constant_fold, st)
    pm.run("algebraic", _fe_algebraic, st)
    pm.run("cse", _fe_cse, st)
    pm.run("hoist", _fe_hoist, st)
    new = _fe_materialize(st)
    # pruned = original nodes gone for any reason except alias/fold
    pruned = set(dfg.nodes) - set(new.nodes) - set(st.alias) - st.folded
    return RewriteResult(
        source=dfg, dfg=new, alias=dict(st.alias),
        pruned=tuple(sorted(pruned)), folded=tuple(sorted(st.folded)),
        timings=list(pm.timings), dumps=list(pm.dumps),
        algebraic=tuple(sorted(st.algebraic)),
        hoisted=tuple(sorted(st.hoisted)))


# ===================================================== structural chains
def _needed_outside(dfg: DFG, succ: dict[str, list[str]], nid: str,
                    chain_next: str | None) -> bool:
    """True if ``nid``'s value is consumed anywhere other than ``chain_next``
    (outputs — including aliased output targets in ``dfg.published`` —
    always count)."""
    if nid in dfg.outputs or nid in dfg.published:
        return True
    return any(s != chain_next for s in succ.get(nid, []))


def split_chain(dfg: DFG, chain: list[str], budget: float | None,
                *, prev: str | None = None) -> list[list[str]]:
    """Cost-guided chain splitting: while a chain's modeled live footprint
    (:func:`repro_torch.core.cost_model.chain_live_bytes`) exceeds ``budget``,
    cut it at the cheapest edge — the cut that minimizes the larger half's
    footprint (ties to the earliest edge) — and recurse.  ``budget=None``
    keeps chains maximal (the pre-split behaviour).  ``prev`` is the
    element streaming into this chain's head when it continues a split
    predecessor, threaded through the recursion so each sub-chain is
    costed with the same stream selection the lowering will use."""
    if budget is None or len(chain) < 2:
        return [chain]
    from repro_torch.core.cost_model import chain_live_bytes

    if chain_live_bytes(dfg, chain, prev=prev) <= budget:
        return [chain]
    best_i, best_cost = 1, None
    for i in range(1, len(chain)):
        cost = max(chain_live_bytes(dfg, chain[:i], prev=prev),
                   chain_live_bytes(dfg, chain[i:], prev=chain[i - 1]))
        if best_cost is None or cost < best_cost:
            best_i, best_cost = i, cost
    return (split_chain(dfg, chain[:best_i], budget, prev=prev)
            + split_chain(dfg, chain[best_i:], budget, prev=chain[best_i - 1]))


def _chainable(dfg: DFG, nid: str) -> bool:
    """Stageable AND still shaped like the paper's ``(1, n)`` vectors.  The
    fused pipeline kernel streams flat element vectors (vec operands are
    reshaped ``(1, -1)``), so a rank>1 node — a conv output map, a pooled
    feature plane — executes as a direct node instead of joining a chain:
    the decomposition declines it cleanly rather than crashing the kernel."""
    if dfg.nodes[nid].op not in STAGEABLE_OPS:
        return False
    return all(
        shp.is_vector_like(s)
        for s in (*dfg.in_shapes(nid), dfg.out_shape(nid)))


def cluster_chains(
    dfg: DFG,
    members: list[str] | tuple[str, ...],
    *,
    succ: dict[str, list[str]],
    topo_idx: dict[str, int],
    split_bytes: float | None = None,
) -> list[tuple[str, tuple[tuple[str, ...], ...]]]:
    """Structural §IV-G decomposition of one fused cluster into pipeline
    chains and direct nodes, in data-ready order.

    Shared by the back-end chain-decompose pass (which lowers each chain to
    a stage program) and the scheduler's pipelined-latency model (which
    costs each unit) — the single source of truth that keeps estimated and
    executed latency consistent.  Returns units:

    * ``("node", ((nid,),))`` — a direct (non-stageable) member;
    * ``("chain", (sub1, sub2, ...))`` — one maximal grown chain, already
      cut into sub-chains by cost-guided splitting (``split_bytes``); an
      unsplit chain has exactly one sub-chain.  Each sub-chain is one
      kernel launch; ``sub_k+1`` streams from ``sub_k``'s terminal.
    """
    mset = set(members)
    topo = sorted(members, key=topo_idx.__getitem__)
    units: list[tuple[str, tuple[tuple[str, ...], ...]]] = []
    produced: set[str] = set()

    def deps(nid: str) -> list[str]:
        return [p for p in dfg.nodes[nid].inputs if p in dfg.nodes]

    def ready(nid: str) -> bool:
        return all((p not in mset) or (p in produced) for p in deps(nid))

    pending = list(topo)
    while pending:
        head = next(n for n in pending if ready(n))
        pending.remove(n := head)
        if not _chainable(dfg, n):
            units.append(("node", ((n,),)))
            produced.add(n)
            continue
        # ---- grow a maximal chain starting at `n` (static: order only)
        chain = [n]
        while True:
            tail = chain[-1]
            nxts = [
                s
                for s in succ.get(tail, [])
                if s in mset
                and s in pending
                and _chainable(dfg, s)
                and all(
                    p == tail or (p not in mset) or (p in produced)
                    for p in dfg.nodes[s].inputs
                )
            ]
            if len(set(nxts)) != 1:
                break
            nxt = nxts[0]
            # the tail's value must not be needed anywhere except `nxt`
            if _needed_outside(dfg, succ, tail, chain_next=nxt):
                break
            chain.append(nxt)
            pending.remove(nxt)
        subs = tuple(tuple(s) for s in split_chain(dfg, chain, split_bytes))
        units.append(("chain", subs))
        produced.update(chain)
    return units


# ================================================================= back-end
class _Lowering:
    """Mutable back-end state over the canonical rewritten graph; each pass
    reads the previous one's fields and fills its own."""

    def __init__(self, rw: RewriteResult, fused_clusters, use_pallas: bool,
                 precision: str, qplan, chain_split_bytes: float | None) -> None:
        self.rw = rw
        self.dfg = rw.dfg
        self.fused_clusters = [list(c) for c in (fused_clusters or [])]
        self.use_pallas = use_pallas
        self.precision = precision
        self.qplan = qplan
        self.chain_split_bytes = chain_split_bytes
        self.bits: int | None = None
        self.mode: dict[str, str] = {}
        self.topo: list[str] = self.dfg.topo_order()
        self.succ: dict[str, list[str]] = {}
        for nid in self.topo:
            for r in self.dfg.nodes[nid].inputs:
                self.succ.setdefault(r, []).append(nid)
        self.atoms: list[tuple[str, ...]] = []
        self.cluster_splits = 0
        self.chain_splits = 0
        self.steps: list[NodeStep | ChainStep] = []

    def rinputs(self, nid: str) -> list[str]:
        return list(self.dfg.nodes[nid].inputs)

    def deps(self, nid: str) -> set[str]:
        """Node-dependencies of ``nid`` (graph inputs excluded)."""
        return {r for r in self.rinputs(nid) if r in self.dfg.nodes}

    def describe(self) -> str:
        ch = [s for s in self.steps if isinstance(s, ChainStep)]
        return (f"{len(self.atoms)} atoms, {len(self.steps)} steps "
                f"({len(ch)} chains), {self.chain_splits} chain splits")


# pass: quantize-rewrite --------------------------------------------------
def _pass_quantize_rewrite(st: _Lowering) -> None:
    if st.precision == "float32":
        st.mode = {nid: "float" for nid in st.topo}
        return
    from repro_torch.core import quantize as qm

    if st.precision not in qm.PRECISION_BITS:
        raise ValueError(f"unknown precision {st.precision!r}")
    if st.qplan is None:
        raise ValueError(
            f"precision={st.precision!r} requires a QuantPlan — see "
            "repro_torch.core.quantize.calibrate")
    st.bits = getattr(st.qplan, "bits", qm.PRECISION_BITS[st.precision])
    for nid in st.topo:
        spec = node_types.get(st.dfg.nodes[nid].op)
        st.mode[nid] = "q" if spec.fn_q is not None else "dq"


# pass: cluster -----------------------------------------------------------
def _pass_cluster(st: _Lowering) -> None:
    """Fix the atom execution order: a fused cluster fires only once all of
    its external inputs are available (§IV-G pipeline start condition); a
    cycle *through* a cluster splits it back into per-node atoms."""
    alias = st.rw.alias
    clusters: list[list[str]] = []
    topo_idx = {nid: i for i, nid in enumerate(st.topo)}
    for mem in st.fused_clusters:
        mem_live = sorted({_resolve(alias, n) for n in mem} & set(st.dfg.nodes),
                          key=topo_idx.__getitem__)
        if len(mem_live) >= 2:
            clusters.append(mem_live)
    cluster_of: dict[str, int] = {}
    for ci, mem in enumerate(clusters):
        for nid in mem:
            cluster_of[nid] = ci
    order: list[tuple[str, ...]] = []
    emitted: set[int] = set()
    for nid in st.topo:
        ci = cluster_of.get(nid)
        if ci is None:
            order.append((nid,))
        elif ci not in emitted:
            emitted.add(ci)
            order.append(tuple(clusters[ci]))
    done: set[str] = set()
    atoms: list[tuple[str, ...]] = []
    pending = list(order)
    while pending:
        for i, atom in enumerate(pending):
            mem = set(atom)
            ext = {d for nid in atom for d in st.deps(nid)} - mem
            if ext <= done:
                pending.pop(i)
                break
        else:  # cycle through a cluster: split it back into nodes
            atom = pending.pop(0)
            st.cluster_splits += 1
            pending = [(nid,) for nid in atom if nid not in done] + pending
            continue
        atoms.append(atom)
        done.update(atom)
    st.atoms = atoms


# pass: chain-decompose ---------------------------------------------------
def _node_step(st: _Lowering, nid: str) -> NodeStep:
    node = st.dfg.nodes[nid]
    spec = node_types.get(node.op)
    mode = st.mode[nid]
    if mode == "float":
        fn = lambda *a: spec.fn(list(a), node.params, node.dims)
    elif mode == "q":
        nq = st.qplan.nodes[nid]
        fn = lambda *a: spec.fn_q(list(a), node.params, node.dims, nq)
    else:  # dq: no integer template (nonlinearities, reductions) — MAFIA's
        # table-based PEs: fixed-point in, fixed-point out, float in between.
        from repro_torch.core import quantize as qm

        nq = st.qplan.nodes[nid]
        bits = st.bits or 8

        def fn(*a: Any) -> Any:
            fa = [x if e is None else qm.dequantize(x, e)
                  for x, e in zip(a, nq.in_exps)]
            out = spec.fn(fa, node.params, node.dims)
            if nq.out_exp is None:          # integer output (argmax)
                return out
            return qm.quantize_t(out, nq.out_exp, bits)

    return NodeStep(nid=nid, inputs=tuple(st.rinputs(nid)), fn=fn, mode=mode)


def _canon(value: Any) -> np.ndarray:
    """``value`` as numpy with JAX's canonical dtypes (64-bit → 32-bit), so
    the const pools match the reference's byte for byte."""
    a = np.asarray(value)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


def _lower_stage_float(st: _Lowering, nid: str, prev: str | None,
                       stream_src: str | None, extras: list[str]):
    """Lower one float chain node → (stage, stream_src) or None to bail.
    Vec operands stay numpy, with JAX's canonical 32-bit dtypes."""
    nd = st.dfg.nodes[nid]
    if nd.op == "scalar_mul":
        return ("scalar_mul", float(nd.params["scalar"])), stream_src
    if nd.op in _UNARY_OPS:
        return (nd.op, None), stream_src
    if nd.op in _BIN_VEC and "vec" in nd.params:
        return (_BIN_VEC[nd.op], _canon(nd.params["vec"])), stream_src
    if nd.op in _BIN_ARR and len(nd.inputs) == 2:
        rin = st.rinputs(nid)
        stream_in = prev if prev in rin else rin[0]
        other = [i for i in rin if i != stream_in]
        if len(other) != 1:
            return None
        # sub is not commutative: stream must be the left operand
        if nd.op == "sub" and stream_in != rin[0]:
            return None
        if prev is None:
            stream_src = stream_in
        onode = st.dfg.nodes.get(other[0])
        if onode is not None and onode.op == "const":
            # const operand: embed as a static vec row instead of streaming
            # a full extra array (same torch op, bitwise-identical broadcast)
            return (_BIN_VEC[nd.op],
                    _canon(onode.params["value"])), stream_src
        extras.append(other[0])
        return (_BIN_ARR[nd.op], len(extras) - 1), stream_src
    return None


def _lower_stage_q(st: _Lowering, nid: str, prev: str | None,
                   stream_src: str | None, extras: list[str],
                   vecs: list[Any]):
    """Lower one fixed-point chain node → (q_stage, stream_src) or None.

    Every shift is computed from the calibrated exponents exactly as the
    per-node integer templates compute it, so the fused chain is bitwise
    identical to per-node eval."""
    from repro_torch.core.quantize import align_cap

    cap = align_cap(st.bits or 8)
    nd = st.dfg.nodes[nid]
    nq = st.qplan.nodes[nid]
    out_e = nq.out_exp
    if out_e is None:
        return None
    if nd.op == "scalar_mul":
        if nq.in_exps[0] is None or "scalar" not in nq.params_q:
            return None
        rq = nq.in_exps[0] + nq.param_exps["scalar"] - out_e
        return ("q_scalar_mul", (int(nq.params_q["scalar"]), rq)), stream_src
    if nd.op in _UNARY_OPS:
        if nq.in_exps[0] is None:
            return None
        return ("q_unary", (nd.op, nq.in_exps[0], out_e)), stream_src
    if nd.op in _Q_BIN_VEC and "vec" in nd.params:
        e_a, e_b = nq.in_exps[0], nq.param_exps["vec"]
        if e_a is None:
            return None
        vecs.append(nq.params_q["vec"])
        vi = len(vecs) - 1
        if nd.op == "hadamard":
            return ("q_hadamard_vec", (vi, e_a + e_b - out_e)), stream_src
        e_c = min(max(e_a, e_b), min(e_a, e_b) + cap)
        return (_Q_BIN_VEC[nd.op],
                (vi, e_c - e_a, e_c - e_b, e_c - out_e)), stream_src
    if nd.op in _Q_BIN_ARR and len(nd.inputs) == 2:
        rin = st.rinputs(nid)
        stream_in = prev if prev in rin else rin[0]
        other = [i for i in rin if i != stream_in]
        if len(other) != 1:
            return None
        if nd.op == "sub" and stream_in != rin[0]:
            return None
        pos_s, pos_o = rin.index(stream_in), rin.index(other[0])
        e_s, e_o = nq.in_exps[pos_s], nq.in_exps[pos_o]
        if e_s is None or e_o is None:
            return None
        if prev is None:
            stream_src = stream_in
        onode = st.dfg.nodes.get(other[0])
        if onode is not None and onode.op == "const":
            # const operand: embed the exact narrow-int value the per-node
            # const step would publish (same template fn → bit-identical),
            # as a static vec row with the same align/requantize shifts the
            # *_arr form would use.
            oq = st.qplan.nodes[other[0]]
            cval = node_types.get("const").fn_q(
                [], onode.params, onode.dims, oq).numpy()
            vecs.append(cval)
            vi = len(vecs) - 1
            if nd.op == "hadamard":
                return ("q_hadamard_vec", (vi, e_s + e_o - out_e)), stream_src
            e_c = min(max(e_s, e_o), min(e_s, e_o) + cap)
            return (_Q_BIN_VEC[nd.op],
                    (vi, e_c - e_s, e_c - e_o, e_c - out_e)), stream_src
        extras.append(other[0])
        ai = len(extras) - 1
        if nd.op == "hadamard":
            return ("q_hadamard_arr", (ai, e_s + e_o - out_e)), stream_src
        e_c = min(max(e_s, e_o), min(e_s, e_o) + cap)
        return (_Q_BIN_ARR[nd.op],
                (ai, e_c - e_s, e_c - e_o, e_c - out_e)), stream_src
    return None


def _lower_chain(st: _Lowering, chain: tuple[str, ...],
                 hint: str | None) -> ChainStep | None:
    """Lower one structural chain to a static stage program.  ``hint`` is
    the env ref feeding the chain when it continues a split predecessor
    (the previous sub-chain's terminal); None for a chain head."""
    quantized = st.precision != "float32"
    first = st.dfg.nodes[chain[0]]
    if hint is not None:
        stream_src: str | None = hint
        prev: str | None = hint
    else:
        stream_src = st.rinputs(chain[0])[0] if first.inputs else None
        prev = None
    stages: list[Any] = []
    extras: list[str] = []
    vecs: list[Any] = []
    for nid in chain:
        lowered = (
            _lower_stage_q(st, nid, prev, stream_src, extras, vecs)
            if quantized else
            _lower_stage_float(st, nid, prev, stream_src, extras))
        if lowered is None:
            return None
        stage, stream_src = lowered
        stages.append(stage)
        prev = nid
    if stream_src is None:
        return None
    dead = tuple(chain[:-1])
    for i, nid in enumerate(dead):
        # provably never read: growth only extended past `nid` after
        # checking its sole consumer is the next chain element, and
        # splitting always publishes sub-chain terminals.
        assert not _needed_outside(st.dfg, st.succ, nid, chain_next=chain[i + 1])
    return ChainStep(
        members=tuple(chain), stream=stream_src, stages=tuple(stages),
        extras=tuple(extras), vecs=tuple(vecs), terminal=chain[-1],
        dead=dead, quantized=quantized)


def _decompose_atom(st: _Lowering, atom: tuple[str, ...],
                    topo_idx: dict[str, int]) -> list[NodeStep | ChainStep]:
    """Decompose a fused cluster into stage chains (one kernel launch each)
    plus direct steps, using the structural decomposition shared with the
    scheduler's latency model (:func:`cluster_chains`)."""
    if not any(_chainable(st.dfg, n) for n in atom):
        topo = sorted(atom, key=topo_idx.__getitem__)
        return [_node_step(st, nid) for nid in topo]
    units = cluster_chains(st.dfg, atom, succ=st.succ, topo_idx=topo_idx,
                           split_bytes=st.chain_split_bytes)
    steps: list[NodeStep | ChainStep] = []
    for kind, subs in units:
        if kind == "node":
            steps.append(_node_step(st, subs[0][0]))
            continue
        st.chain_splits += len(subs) - 1
        hint: str | None = None          # sub_k+1 streams from sub_k's tail
        for sub in subs:
            chain_step = _lower_chain(st, sub, hint)
            if chain_step is None:
                # bail out: evaluate the whole sub-chain node-by-node
                steps.extend(_node_step(st, nid) for nid in sub)
            else:
                steps.append(chain_step)
            hint = sub[-1]
    return steps


def _pass_chain_decompose(st: _Lowering) -> None:
    topo_idx = {nid: i for i, nid in enumerate(st.topo)}
    for atom in st.atoms:
        if len(atom) > 1 and st.use_pallas:
            st.steps.extend(_decompose_atom(st, atom, topo_idx))
        else:
            for nid in sorted(atom, key=topo_idx.__getitem__):
                st.steps.append(_node_step(st, nid))


# pass: plan --------------------------------------------------------------
def _pass_plan(st: _Lowering) -> ExecutionPlan:
    input_exps = output_exps = None
    alias = st.rw.alias
    if st.precision != "float32":
        input_exps = dict(st.qplan.input_exps)
        output_exps = {
            o: st.qplan.nodes[_resolve(alias, o)].out_exp
            for o in st.dfg.outputs
        }
    plan = ExecutionPlan(
        dfg=st.dfg,
        steps=tuple(st.steps),
        outputs=tuple(st.dfg.outputs),
        precision=st.precision,
        bits=st.bits,
        qplan=st.qplan,
        use_pallas=st.use_pallas,
        input_exps=input_exps,
        output_exps=output_exps,
        alias=dict(alias),
        pruned=tuple(st.rw.pruned),
        cluster_splits=st.cluster_splits,
        folded=tuple(st.rw.folded),
        chain_splits=st.chain_splits,
        algebraic=tuple(st.rw.algebraic),
        hoisted=tuple(st.rw.hoisted),
    )
    plan.verify()
    return plan


# pass: linearize ---------------------------------------------------------
_ISA_MATVEC = {"gemv": "MATVEC", "spmv": "SPMV"}
_ISA_REDUCE = {"reduce_sum": "sum", "reduce_max": "max", "reduce_min": "min"}
_FLOAT_VEC_STAGES = ("add_vec", "sub_vec", "hadamard_vec")
_FLOAT_ARR_STAGES = ("add_arr", "sub_arr", "hadamard_arr")


def _mk_schedule_mats(body: list) -> list:
    """Double-buffered DMA schedule: ``LOAD_MAT[0]`` opens the segment and
    ``LOAD_MAT[k]`` issues immediately before ``MATVEC[k-1]`` — at most two
    HBM→VMEM copies in flight, and copy ``k`` overlaps matvec ``k-1``.
    SQL2 rides the same schedule: its ``operand[0]`` is the matrix index of
    the ProtoNN points tile, waited exactly like a MATVEC weight tile."""
    from repro_torch.kernels.megakernel import Instr

    mv = [(i, ins) for i, ins in enumerate(body)
          if ins.op in ("MATVEC", "SPMV", "SQL2")]
    loads_at: dict[int, list] = {}
    for k, (pos, ins) in enumerate(mv):
        at = 0 if k == 0 else mv[k - 1][0]
        loads_at.setdefault(at, []).append(
            Instr("LOAD_MAT", operand=ins.operand[0], nid=ins.nid))
    out: list = []
    for i, ins in enumerate(body):
        out.extend(loads_at.get(i, ()))
        out.append(ins)
    return out


def _mk_alloc_slots(body: list, widths: dict[str, int]):
    """Liveness-based scratch-slot allocation: linear scan over the final
    instruction order, freeing each value's slot at its last read (frees are
    processed before the same instruction's definition, so a stage whose
    stream dies at that stage reuses the slot in place).  The free list is
    keyed by exact width — slots are exact-shape VMEM rows, never padded,
    which is what keeps the float32 lane bitwise."""
    from repro_torch.kernels.megakernel import Instr

    last_use: dict[str, int] = {}
    for i, ins in enumerate(body):
        for s in ins.src:
            last_use[s] = i
    slot_of: dict[str, int] = {}
    slot_widths: list[int] = []
    free: dict[int, list[int]] = {}
    out: list = []
    for i, ins in enumerate(body):
        src_slots = tuple(slot_of[s] for s in ins.src)
        # dedup in positional order, NOT set(): set iteration is hash-seed
        # dependent, and the free-list order decides slot reuse — the
        # emitted stream must be identical across processes (the artifact
        # store validates a relinearize against the serialized stream)
        for s in dict.fromkeys(ins.src):
            if last_use[s] == i:
                free.setdefault(widths[s], []).append(slot_of[s])
        dst = -1
        if ins.dst not in (None, -1):
            w = widths[ins.dst]
            pool = free.get(w, [])
            if pool:
                dst = pool.pop()
            else:
                dst = len(slot_widths)
                slot_widths.append(w)
            slot_of[ins.dst] = dst
        out.append(Instr(ins.op, dst=dst, src=src_slots,
                         operand=ins.operand, nid=ins.nid))
    return out, slot_widths


def _pass_linearize(st: _Lowering, plan: ExecutionPlan) -> None:
    """Compile the plan's step list to a :class:`MegakernelProgram`: a flat
    instruction stream over the megakernel ISA, executed one kernel launch
    per segment (one launch total when every step encodes).

    The walk is greedy: consecutive encodable steps accumulate into the
    current segment; a step with no ISA encoding (reductions, argmax, dot,
    ...) flushes the segment and becomes an interpreted *island*, giving the
    plan-ordered hybrid the executor's ``mode="megakernel"`` runs.  Chain
    steps always encode (their stage programs are already the kernel
    vocabulary); node steps encode when they are const loads, gemv/spmv
    matvecs (float or integer template, per-tensor or per-channel
    requantize), or stageable elementwise ops.

    Values are in SSA form during encoding (env refs plus ``#acc``
    temporaries between a MATVEC and its REQUANTIZE); slot allocation then
    maps them onto a minimal register file of exact-width VMEM rows with
    liveness-based reuse.  A ref is STOREd only if a step outside the
    segment (or a program output) reads it — chain intermediates and
    purely-internal values never leave VMEM."""
    from repro_torch.kernels.megakernel import (Instr, MegakernelProgram,
                                          MegakernelSegment)

    dfg = st.dfg
    qz = st.precision != "float32"

    def shape_of(ref: str) -> tuple:
        if ref in dfg.graph_inputs:
            return tuple(dfg.graph_inputs[ref].shape)
        return tuple(dfg.out_shape(ref))

    def width(ref: str) -> int:
        return max(1, int(np.prod(shape_of(ref), dtype=np.int64)))

    # step-level consumer map: which plan steps read each env ref
    consumers: dict[str, set[int]] = {}
    for i, s in enumerate(plan.steps):
        rs = set(s.inputs) if isinstance(s, NodeStep) else {s.stream, *s.extras}
        for r in rs:
            consumers.setdefault(r, set()).add(i)
    out_refs = {_resolve(plan.alias, o) for o in plan.outputs}
    # refs holding integer *values* (ARGMAX indices): any step consuming one
    # must island — the float32 carrier (float lane) and the exponent-tagged
    # int32 carrier (quantized lane) would both silently mistype them.
    int_refs: set[str] = set()

    class _Seg:
        """One in-flight segment: symbolic instructions (dst/src are value
        names), const/matrix pools, and bookkeeping for the flush."""

        def __init__(self) -> None:
            self.body: list = []
            self.consts: list[np.ndarray] = []
            self.mats: list[np.ndarray] = []
            self.in_refs: list[str] = []
            self.widths: dict[str, int] = {}
            self.order: list[str] = []       # definition order
            self.steps: set[int] = set()
            self.members: list[str] = []
            self.dtypes: dict[str, str] = {}  # per-ref STORE dtype overrides

        def emit(self, op, dst=None, src=(), operand=None, nid="") -> None:
            self.body.append(Instr(op, dst=dst, src=tuple(src),
                                   operand=operand, nid=nid))

        def define(self, ref: str, w: int) -> None:
            self.widths[ref] = w
            self.order.append(ref)

        def pool(self, arr) -> int:
            self.consts.append(np.asarray(arr))
            return len(self.consts) - 1

        def mat(self, arr) -> int:
            self.mats.append(np.asarray(arr))
            return len(self.mats) - 1

        def use(self, ref: str) -> str:
            if ref not in self.widths:
                ii = len(self.in_refs)
                self.in_refs.append(ref)
                self.define(ref, width(ref))
                self.emit("LOAD_VEC", dst=ref, operand=("in", ii), nid=ref)
            return ref

    def remap_stage(b: _Seg, stage, get_vec, get_extra):
        """Remap one chain-vocabulary stage for the ISA: vec operands move
        into the const pool (``vec_cis``), ``*_arr`` operand indices remap
        to 0 (the operand rides as ``src[1]``)."""
        op, operand = stage
        vec_cis: tuple[int, ...] = ()
        extra_srcs: list[str] = []
        if op in _FLOAT_VEC_STAGES:
            vec_cis = (b.pool(operand),)
            stage = (op, None)
        elif op in _FLOAT_ARR_STAGES:
            extra_srcs.append(b.use(get_extra(operand)))
            stage = (op, 0)
        elif op in ("q_add_vec", "q_sub_vec"):
            vi, sa, sb, rq = operand
            vec_cis = (b.pool(get_vec(vi)),)
            stage = (op, (0, sa, sb, rq))
        elif op == "q_hadamard_vec":
            vi, rq = operand
            vec_cis = (b.pool(get_vec(vi)),)
            stage = (op, (0, rq))
        elif op in ("q_add_arr", "q_sub_arr"):
            ai, sa, sb, rq = operand
            extra_srcs.append(b.use(get_extra(ai)))
            stage = (op, (0, sa, sb, rq))
        elif op == "q_hadamard_arr":
            ai, rq = operand
            extra_srcs.append(b.use(get_extra(ai)))
            stage = (op, (0, rq))
        return stage, vec_cis, extra_srcs

    def emit_stage(b: _Seg, dst: str, stream_ref: str, stage,
                   get_vec, get_extra) -> None:
        s0 = b.use(stream_ref)
        stage2, vec_cis, extra_srcs = remap_stage(b, stage, get_vec, get_extra)
        b.emit("ELEMENTWISE", dst=dst, src=(s0, *extra_srcs),
               operand=(stage2, vec_cis), nid=dst)
        b.define(dst, b.widths[s0])

    def enc_node(b: _Seg, step: NodeStep) -> bool:
        """Encode one node step, or return False (no mutation) to island."""
        nid = step.nid
        node = dfg.nodes[nid]
        op = node.op
        if op == "const":
            if qz:
                nq = st.qplan.nodes[nid]
                if nq.out_exp is None:       # integer passthrough const
                    return False
                val = node_types.get("const").fn_q(
                    [], node.params, node.dims, nq).numpy()
            else:
                val = node_types.get("const").fn(
                    [], node.params, node.dims).numpy()
                if not np.issubdtype(val.dtype, np.floating):
                    return False
            b.emit("LOAD_VEC", dst=nid, operand=("const", b.pool(val)),
                   nid=nid)
            b.define(nid, width(nid))
            return True
        if op in _ISA_MATVEC:
            kind = _ISA_MATVEC[op]
            x = step.inputs[0]
            if qz:
                nq = st.qplan.nodes[nid]
                if (nq.out_exp is None or nq.in_exps[0] is None
                        or "matrix" not in nq.params_q):
                    return False
                xr = b.use(x)
                # widen weights to the int32 carrier host-side: the in-kernel
                # dot then accumulates in int32, like the integer template.
                mi = b.mat(np.asarray(nq.params_q["matrix"], np.int32))
                bci = (b.pool(np.asarray(nq.params_q["bias"], np.int32))
                       if "bias" in nq.params_q else None)
                acc = nid + "#acc"
                b.emit(kind, dst=acc, src=(xr,), operand=(mi, bci), nid=nid)
                b.define(acc, width(nid))
                e_w = nq.param_exps["matrix"]
                if np.ndim(e_w):             # per-channel row scales
                    shifts = (np.asarray(e_w, np.int64)
                              + nq.in_exps[0] - nq.out_exp).astype(np.int32)
                    b.emit("REQUANTIZE", dst=nid, src=(acc,),
                           operand=("rows", b.pool(shifts)), nid=nid)
                else:
                    rq = int(e_w) + nq.in_exps[0] - nq.out_exp
                    b.emit("REQUANTIZE", dst=nid, src=(acc,),
                           operand=("tensor", rq), nid=nid)
            else:
                xr = b.use(x)
                mi = b.mat(np.asarray(node.params["matrix"], np.float32))
                bci = (b.pool(np.asarray(node.params["bias"], np.float32))
                       if "bias" in node.params else None)
                b.emit(kind, dst=nid, src=(xr,), operand=(mi, bci), nid=nid)
            b.define(nid, width(nid))
            return True
        if op == "argmax":
            # ARGMAX runs directly on the carrier: dequantize is a strictly
            # monotone pow2 scale, so the winning index (ties included)
            # matches argmax over the dequantized floats bitwise.  The index
            # is an integer *value* — dtype int32 on STORE, and the ref is
            # poisoned for further in-segment consumption (int_refs).
            if qz:
                nq = st.qplan.nodes[nid]
                if nq.in_exps[0] is None or nq.out_exp is not None:
                    return False
            xr = b.use(step.inputs[0])
            b.emit("ARGMAX", dst=nid, src=(xr,), nid=nid)
            b.define(nid, width(nid))
            b.dtypes[nid] = "int32"
            int_refs.add(nid)
            return True
        if op in _ISA_REDUCE:
            # only effectively-1-D inputs: the kernel reduces the flattened
            # slot, the per-node op reduces axis -1 — identical iff the
            # input has a single non-unit leading structure.
            sh = shape_of(step.inputs[0])
            if not sh or int(np.prod(sh, dtype=np.int64)) != int(sh[-1]):
                return False
            if qz:
                nq = st.qplan.nodes[nid]
                if nq.out_exp is None or nq.in_exps[0] is None:
                    return False
                e_in, e_out = nq.in_exps[0], nq.out_exp
            else:
                e_in = e_out = None
            xr = b.use(step.inputs[0])
            b.emit("REDUCE", dst=nid, src=(xr,),
                   operand=(_ISA_REDUCE[op], e_in, e_out), nid=nid)
            b.define(nid, width(nid))
            return True
        if op == "sq_l2":
            if qz:
                nq = st.qplan.nodes[nid]
                if nq.out_exp is None or nq.in_exps[0] is None:
                    return False
                e_in, e_out = nq.in_exps[0], nq.out_exp
            else:
                e_in = e_out = None
            xr = b.use(step.inputs[0])
            # the points matrix stays float32 on every lane: sq_l2 has no
            # integer template, so the per-node quantized path dequantizes
            # the stream and subtracts the *float* points (dq fallback) —
            # the pooled tile must match that bit for bit.
            mi = b.mat(np.asarray(node.params["points"], np.float32))
            b.emit("SQL2", dst=nid, src=(xr,), operand=(mi, e_in, e_out),
                   nid=nid)
            b.define(nid, width(nid))
            return True
        if op == "dot":
            if qz:
                nq = st.qplan.nodes[nid]
                if (nq.out_exp is None or nq.in_exps[0] is None
                        or nq.in_exps[1] is None):
                    return False
                e_a, e_b, e_out = nq.in_exps[0], nq.in_exps[1], nq.out_exp
            else:
                e_a = e_b = e_out = None
            ra = b.use(step.inputs[0])
            rb = b.use(step.inputs[1])
            b.emit("DOT", dst=nid, src=(ra, rb),
                   operand=(e_a, e_b, e_out), nid=nid)
            b.define(nid, width(nid))
            return True
        if op in STAGEABLE_OPS:
            # the kernel streams flattened slots; a rank>1 elementwise node
            # (tensor-shaped operands) islands instead — same policy as the
            # chain decomposition's _chainable guard.
            if not all(shp.is_vector_like(shape_of(r))
                       for r in (*step.inputs, nid)):
                return False
            extras: list[str] = []
            vecs: list[Any] = []
            low = (_lower_stage_q(st, nid, None, None, extras, vecs) if qz
                   else _lower_stage_float(st, nid, None, None, extras))
            if low is None:
                return False
            stage, stream_src = low
            if stream_src is None:
                rin = st.rinputs(nid)
                if not rin:
                    return False
                stream_src = rin[0]
            emit_stage(b, nid, stream_src, stage,
                       get_vec=vecs.__getitem__, get_extra=extras.__getitem__)
            return True
        return False

    def enc_chain(b: _Seg, step: ChainStep) -> None:
        """Chains always encode: their stage programs already are the kernel
        vocabulary — one ELEMENTWISE per stage, streaming in place."""
        cur = b.use(step.stream)
        for nid, stage in zip(step.members, step.stages):
            emit_stage(b, nid, cur, stage,
                       get_vec=lambda i: step.vecs[i],
                       get_extra=lambda i: step.extras[i])
            cur = nid

    items: list[tuple[str, Any]] = []
    b = _Seg()

    def flush() -> None:
        nonlocal b
        if not b.body:
            return
        loaded = set(b.in_refs)
        stores = [r for r in b.order
                  if r not in loaded and "#" not in r
                  and (r in out_refs
                       or (consumers.get(r, set()) - b.steps))]
        for oi, r in enumerate(stores):
            b.emit("STORE", src=(r,), operand=oi, nid=r)
        body = _mk_schedule_mats(b.body)
        instrs, slot_widths = _mk_alloc_slots(body, b.widths)
        from repro_torch.core.quantize import int_dtype

        default_dt = (np.dtype(int_dtype(st.bits or 8)).name if qz
                      else "float32")
        items.append(("seg", MegakernelSegment(
            instrs=tuple(instrs),
            slot_widths=tuple(slot_widths),
            consts=tuple(b.consts),
            matrices=tuple(b.mats),
            in_refs=tuple(b.in_refs),
            out_refs=tuple(stores),
            out_widths=tuple(b.widths[r] for r in stores),
            out_shapes=tuple(shape_of(r) for r in stores),
            quantized=qz,
            bits=st.bits or 8,
            members=tuple(b.members),
            out_dtypes=tuple(b.dtypes.get(r, default_dt) for r in stores),
        )))
        b = _Seg()

    for idx, step in enumerate(plan.steps):
        reads = (({step.stream, *step.extras}) if isinstance(step, ChainStep)
                 else set(step.inputs))
        if reads & int_refs:
            # consumes an integer-valued ref (ARGMAX index): island it —
            # the carrier has no integer lane for downstream arithmetic.
            ok = False
        elif isinstance(step, ChainStep):
            enc_chain(b, step)
            ok = True
        else:
            ok = enc_node(b, step)
        if ok:
            b.steps.add(idx)
            b.members.extend(step.members if isinstance(step, ChainStep)
                             else (step.nid,))
        else:
            flush()
            items.append(("step", idx))
    flush()
    plan.megakernel = MegakernelProgram(items=tuple(items))


# ------------------------------------------------------------------- entry
def lower(
    dfg: DFG,
    *,
    fused_clusters: list[list[str]] | None = None,
    use_pallas: bool = False,
    precision: str = "float32",
    qplan: Any | None = None,
    rewritten: RewriteResult | None = None,
    chain_split_bytes: float | None = DEFAULT_CHAIN_SPLIT_BYTES,
    debug: bool = False,
) -> ExecutionPlan:
    """Run the full pass pipeline and return the static execution plan.

    ``rewritten`` short-circuits the front-end when the caller (the
    compiler) already ran :func:`rewrite` — the optimizer and scheduler
    consumed that exact graph, so re-running the front-end here could only
    disagree.  Direct callers (tests, ``build_callable`` without a plan)
    get the front-end implicitly.
    """
    if precision != "float32":
        from repro_torch.core import quantize as qm

        if precision not in qm.PRECISION_BITS:
            raise ValueError(f"unknown precision {precision!r}")
    pm = PassManager(debug=debug)
    if rewritten is None:
        rewritten = rewrite(dfg, precision=precision, pm=pm)
    st = _Lowering(rewritten, fused_clusters, use_pallas, precision, qplan,
                   chain_split_bytes)
    pm.run("quantize-rewrite", _pass_quantize_rewrite, st)
    pm.run("cluster", _pass_cluster, st)
    pm.run("chain-decompose", _pass_chain_decompose, st)
    plan = pm.run("plan", _pass_plan, st)
    pm.run("linearize", lambda s: _pass_linearize(s, plan), st)
    # front-end timings come first, whether run here or by the compiler
    fe = [t for t in rewritten.timings if t[0] in FRONTEND_PASSES]
    be = [t for t in pm.timings if t[0] in BACKEND_PASSES]
    plan.pass_timings = tuple(fe + be)
    plan.dump = tuple(rewritten.dumps + [d for d in pm.dumps
                                         if d.split(":")[0] in BACKEND_PASSES])
    return plan
