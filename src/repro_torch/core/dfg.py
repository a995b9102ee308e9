"""Matrix data-flow-graph IR — the core representation of MAFIA (paper §III, §IV-C).

A program is a DAG of matrix operations.  Each node is annotated with
  * the operation type (registered in :mod:`repro_torch.core.node_types`),
  * the input dimensions of the operation,
  * any static model parameters (weights) the operation consumes.

The DFG is the single IR every later stage consumes: the PF-1 profiler tags
nodes with measured latency/resource numbers, the Best-PF estimator assigns a
parallelism factor to every node, the scheduler derives the data-flow-order
execution schedule, and the executor/codegen walk it to produce a JAX callable.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Iterable, Sequence

__all__ = ["Node", "DFG", "GraphInput"]


@dataclasses.dataclass
class GraphInput:
    """A named external input of the program (e.g. the feature vector)."""

    name: str
    shape: tuple[int, ...]
    dtype: str = "float32"


@dataclasses.dataclass
class Node:
    """One matrix operation in the DFG.

    ``dims`` is an op-specific dict (e.g. ``{"m": 64, "n": 400, "nnz": 1600}``
    for SpMV).  ``inputs`` are node ids or graph-input names, in positional
    order.  ``params`` maps template parameter slots (e.g. ``"matrix"``) to
    host arrays supplied at compile time (static model parameters).
    """

    id: str
    op: str
    dims: dict[str, int]
    inputs: list[str] = dataclasses.field(default_factory=list)
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    # Filled in by the PF-1 profiler (paper §IV-D):
    latency1: float | None = None  # cycles (FPGA) or seconds (TPU) at PF=1
    lut1: float | None = None      # LUTs (FPGA) or HBM-resident bytes (TPU) at PF=1
    # Filled in by the Best-PF estimator (paper §IV-E):
    pf: int = 1

    def __hash__(self) -> int:  # allow use in sets keyed by identity
        return hash(self.id)


class DFG:
    """A DAG of :class:`Node` with helpers used by every compiler stage."""

    def __init__(self, name: str = "dfg") -> None:
        self.name = name
        self.nodes: dict[str, Node] = {}
        self.graph_inputs: dict[str, GraphInput] = {}
        self.outputs: list[str] = []
        # node ids whose value is published externally *through the rewrite
        # alias map* — i.e. the resolved targets of ``outputs``.  On a
        # hand-built graph this is empty (outputs name their own nodes); the
        # front-end's materialize pass fills it so liveness analyses
        # (``_needed_outside``) keep a hoisted chain's shared tail alive
        # even when the representative node is not itself an output.
        self.published: frozenset[str] = frozenset()

    # ------------------------------------------------------------------ build
    def add_input(self, name: str, shape: Sequence[int], dtype: str = "float32") -> str:
        if name in self.graph_inputs or name in self.nodes:
            raise ValueError(f"duplicate input name {name!r}")
        self.graph_inputs[name] = GraphInput(name, tuple(shape), dtype)
        return name

    def add(
        self,
        op: str,
        *inputs: str,
        id: str | None = None,
        dims: dict[str, int] | None = None,
        **params: Any,
    ) -> str:
        """Append a node; returns its id."""
        from repro_torch.core import node_types  # local import to avoid cycle

        spec = node_types.get(op)  # validates op name
        nid = id or f"{op}_{len(self.nodes)}"
        if nid in self.nodes or nid in self.graph_inputs:
            raise ValueError(f"duplicate node id {nid!r}")
        for src in inputs:
            if src not in self.nodes and src not in self.graph_inputs:
                raise ValueError(f"node {nid!r}: unknown input {src!r}")
        node = Node(id=nid, op=op, dims=dict(dims or {}), inputs=list(inputs), params=params)
        self.nodes[nid] = node  # insert first: infer_dims may query in_shapes
        try:
            if spec.infer_dims is not None:
                node.dims = spec.infer_dims(self, node)
        except Exception:
            del self.nodes[nid]
            raise
        return nid

    def mark_output(self, *node_ids: str) -> None:
        for nid in node_ids:
            if nid not in self.nodes:
                raise ValueError(f"unknown node {nid!r}")
            if nid not in self.outputs:
                self.outputs.append(nid)

    # ------------------------------------------------------------ structure
    def predecessors(self, nid: str) -> list[str]:
        return [i for i in self.nodes[nid].inputs if i in self.nodes]

    def successors(self, nid: str) -> list[str]:
        return [n.id for n in self.nodes.values() if nid in n.inputs]

    def in_shapes(self, nid: str) -> list[tuple[int, ...]]:
        shapes = []
        for src in self.nodes[nid].inputs:
            if src in self.graph_inputs:
                shapes.append(self.graph_inputs[src].shape)
            else:
                shapes.append(self.out_shape(src))
        return shapes

    def out_shape(self, nid: str) -> tuple[int, ...]:
        from repro_torch.core import node_types

        node = self.nodes[nid]
        return node_types.get(node.op).out_shape(self, node)

    def topo_order(self) -> list[str]:
        order: list[str] = []
        seen: set[str] = set()

        def visit(nid: str, stack: tuple[str, ...]) -> None:
            if nid in seen:
                return
            if nid in stack:
                raise ValueError(f"cycle through {nid!r}")
            for src in self.predecessors(nid):
                visit(src, stack + (nid,))
            seen.add(nid)
            order.append(nid)

        for nid in self.nodes:
            visit(nid, ())
        return order

    # --------------------------------------------------------- path analysis
    def critical_path(self, latency: Callable[[Node], float]) -> tuple[list[str], float]:
        """Longest path under per-node ``latency`` (paper §IV-B: program latency
        = sum of node latencies along the critical path)."""
        order = self.topo_order()
        dist: dict[str, float] = {}
        best_pred: dict[str, str | None] = {}
        for nid in order:
            node = self.nodes[nid]
            lat = latency(node)
            preds = self.predecessors(nid)
            if preds:
                p = max(preds, key=lambda x: dist[x])
                dist[nid] = dist[p] + lat
                best_pred[nid] = p
            else:
                dist[nid] = lat
                best_pred[nid] = None
        end = max(dist, key=lambda x: dist[x])
        path = [end]
        while best_pred[path[-1]] is not None:
            path.append(best_pred[path[-1]])  # type: ignore[arg-type]
        path.reverse()
        return path, dist[end]

    def all_paths(self, limit: int = 20000) -> list[list[str]]:
        """Enumerate all source→sink paths (for the black-box integer program,
        paper §IV-E-1).  Capped at ``limit`` paths."""
        sources = [nid for nid in self.nodes if not self.predecessors(nid)]
        sinks = [nid for nid in self.nodes if not self.successors(nid)]
        sink_set = set(sinks)
        paths: list[list[str]] = []

        def walk(nid: str, acc: list[str]) -> None:
            if len(paths) >= limit:
                return
            acc = acc + [nid]
            if nid in sink_set:
                paths.append(acc)
                return
            for nxt in self.successors(nid):
                walk(nxt, acc)

        for s in sources:
            walk(s, [])
        return paths

    # ------------------------------------------------------------- utilities
    def structural_hash(self, *, include_dims: bool = True) -> str:
        """Deterministic digest of the graph *structure*: node ids, ops,
        edges, dims (optional), graph-input signatures and the output list.

        Static parameter *values* are deliberately excluded — every quantity
        the PF search consumes (template cycle/LUT models, PF caps, path
        structure) derives from ops, edges and dims alone, so two graphs
        with equal hashes are guaranteed the same Best-PF problem.  This is
        what the compiler's rewrite-aware warm-start cache keys on: a doped
        or edited variant that canonicalizes to a seen graph hashes equal
        and reuses the prior :class:`~repro_torch.core.optimizer.PFResult`.
        ``include_dims=False`` gives the coarser *near-hit* key (same ids,
        ops and wiring; node dims and graph-input shapes may differ) used
        to seed the search instead of short-circuiting it."""
        import hashlib

        h = hashlib.sha256()
        # repr of tuples, not joined strings: ids are arbitrary, so naive
        # ':'/',' delimiters would let differently-structured graphs
        # collide (an input literally named "a,b" vs two inputs a and b)
        for name in sorted(self.graph_inputs):
            gi = self.graph_inputs[name]
            sig = (gi.shape, gi.dtype) if include_dims else ()
            h.update(repr(("in", name, sig)).encode())
        for nid in sorted(self.nodes):
            node = self.nodes[nid]
            dims = tuple(sorted(node.dims.items())) if include_dims else ()
            h.update(repr(("n", nid, node.op, tuple(node.inputs),
                           dims)).encode())
        h.update(repr(("out", tuple(self.outputs))).encode())
        return h.hexdigest()

    def validate(self) -> None:
        from repro_torch.core import node_types

        self.topo_order()  # raises on cycles
        for node in self.nodes.values():
            spec = node_types.get(node.op)
            spec.validate(self, node)

    def subgraph_of_connected(
        self, member: Callable[[Node], bool]
    ) -> list[set[str]]:
        """Connected components (over DFG edges, undirected) of nodes matching
        ``member`` — used for linear-time PF clusters (paper §IV-A) and
        pipelining clusters (paper §IV-G)."""
        ids = [nid for nid, n in self.nodes.items() if member(n)]
        idset = set(ids)
        parent = {i: i for i in ids}

        def find(x: str) -> str:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a: str, b: str) -> None:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        for nid in ids:
            for nbr in itertools.chain(self.predecessors(nid), self.successors(nid)):
                if nbr in idset:
                    union(nid, nbr)
        comps: dict[str, set[str]] = {}
        for nid in ids:
            comps.setdefault(find(nid), set()).add(nid)
        return list(comps.values())

    def __repr__(self) -> str:
        return f"DFG({self.name!r}, {len(self.nodes)} nodes, {len(self.graph_inputs)} inputs)"
