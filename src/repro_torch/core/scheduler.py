"""Scheduler generator + discrete-event simulator (paper §IV-F, §IV-G).

MAFIA executes the DFG in *data-flow order*: every node carries start/done
signalling and fires as soon as all its producers are done, so data-independent
nodes run concurrently — the inter-node parallelism C-HLS cannot express.

``simulate`` is the cycle-level discrete-event model of that controller, using
the *ground-truth* template cycle costs (the role synthesis+simulation plays in
the paper's evaluation).  It supports:

  * ``order='dataflow'``   — MAFIA's controller (ASAP firing),
  * ``order='sequential'`` — the C-HLS execution model (one node at a time, in
    topological order), used by the Vivado-family baselines in Fig. 3,
  * ``pipelining=True``    — §IV-G: connected equal-PF linear-time clusters
    execute as a super-node pipeline (elements stream through the stages, no
    intermediate buffers): latency = bottleneck-stage cycles + sum of stage
    fill overheads, instead of the sum of full stage latencies.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Sequence

from repro_torch.core import node_types
from repro_torch.core.constraints import PFGroups
from repro_torch.core.dfg import DFG

__all__ = ["Schedule", "simulate", "pipeline_clusters"]

_FILL = 6  # must match node_types._FILL (stage fill cycles)


@dataclasses.dataclass
class Schedule:
    """Result of simulating one execution of the DFG."""

    total_cycles: float
    start: dict[str, float]
    end: dict[str, float]
    order: str
    pipelined_clusters: list[list[str]]

    def as_intervals(self) -> list[tuple[str, float, float]]:
        return sorted(
            ((nid, self.start[nid], self.end[nid]) for nid in self.start),
            key=lambda t: t[1],
        )


def pipeline_clusters(dfg: DFG, groups: PFGroups, assignment: dict[str, int]) -> list[list[str]]:
    """Clusters eligible for §IV-G pipelining: connected linear-time nodes.
    The PF constraints already force one PF per cluster; assert it."""
    clusters = []
    topo_idx = {nid: i for i, nid in enumerate(dfg.topo_order())}
    for mem in groups.linear_clusters():
        if len(mem) < 2:
            continue
        pfs = {assignment[nid] for nid in mem}
        assert len(pfs) == 1, f"linear cluster {mem} has mixed PFs {pfs}"
        if _reentrant(dfg, set(mem)):
            # a path leaves the cluster and re-enters it: collapsing it to a
            # super-node would create a cycle (the pipeline could never
            # satisfy its own start condition) — skip pipelining it.
            continue
        clusters.append(sorted(mem, key=topo_idx.__getitem__))
    return clusters


def _reentrant(dfg: DFG, mem: set[str]) -> bool:
    """True if some path exits ``mem`` through a non-member and returns."""
    frontier = [
        s for nid in mem for s in dfg.successors(nid) if s not in mem
    ]
    seen: set[str] = set()
    while frontier:
        nid = frontier.pop()
        if nid in seen:
            continue
        seen.add(nid)
        for s in dfg.successors(nid):
            if s in mem:
                return True
            if s not in seen:
                frontier.append(s)
    return False


def _node_cycles(dfg: DFG, nid: str, assignment: dict[str, int],
                 node_cost: Callable | None = None) -> float:
    node = dfg.nodes[nid]
    if node_cost is not None:
        return float(node_cost(node, assignment[nid]))
    return node_types.get(node.op).cycles(node.dims, assignment[nid])


def _chain_cost_of(dfg: DFG, sub: Sequence[str], assignment: dict[str, int],
                   node_cost: Callable | None,
                   chain_cost: Callable | None) -> float:
    """Cost of one fused sub-chain: the measured ``chain_cost`` override
    when installed (one launch regardless of PF), else the paper's
    pipeline model over the (possibly overridden) per-node costs."""
    if chain_cost is not None:
        return float(chain_cost([dfg.nodes[nid] for nid in sub],
                                [assignment[nid] for nid in sub]))
    stage = [max(0.0, _node_cycles(dfg, nid, assignment, node_cost) - _FILL)
             for nid in sub]
    return max(stage) + _FILL * len(sub)


def _pipelined_cycles(dfg: DFG, cluster: list[str], assignment: dict[str, int],
                      node_cost: Callable | None = None,
                      chain_cost: Callable | None = None) -> float:
    """Super-node latency: elements stream through all stages concurrently —
    bottleneck stage's streaming time + per-stage fill.  A stage shorter than
    its own fill overhead streams for 0 cycles, never a negative number (a
    negative bottleneck would understate the cluster below its fill total)."""
    return _chain_cost_of(dfg, cluster, assignment, node_cost, chain_cost)


def _decomposed_cycles(dfg: DFG, cluster: list[str], assignment: dict[str, int],
                       split_bytes: float | None,
                       topo_idx: dict[str, int],
                       succ: dict[str, list[str]],
                       node_cost: Callable | None = None,
                       chain_cost: Callable | None = None) -> float:
    """Pipelined-cluster latency under the *same* structural decomposition
    the chain-decompose pass lowers (``decompose_chains=True``): each grown
    chain — after cost-guided splitting — is one pipeline (bottleneck
    streaming time + per-stage fill) and reduction-flavoured members run as
    direct nodes.  The units are scheduled ASAP over their intra-cluster
    data edges, mirroring the data-flow controller at unit granularity:
    *independent* sub-chains of a decomposed cluster (e.g. the branches of
    a fan-out that chain-growing split apart) overlap instead of summing
    serially, while dependent units still run back to back.  Estimated and
    executed latency therefore agree on the plan the executor actually
    interprets — the critical *unit path*, not the unit total."""
    from repro_torch.core.lowering import cluster_chains

    units = cluster_chains(dfg, cluster, succ=succ, topo_idx=topo_idx,
                           split_bytes=split_bytes)
    # flatten to scheduling atoms: one per direct node / per split sub-chain
    atoms: list[tuple[tuple[str, ...], float]] = []
    atom_of: dict[str, int] = {}
    for kind, subs in units:
        for sub in subs:
            if kind == "node":
                dur = _node_cycles(dfg, sub[0], assignment, node_cost)
            else:
                dur = _chain_cost_of(dfg, sub, assignment,
                                     node_cost, chain_cost)
            ai = len(atoms)
            atoms.append((tuple(sub), dur))
            for nid in sub:
                atom_of[nid] = ai
    # ASAP: a unit fires when every in-cluster producer unit has drained
    # (units arrive in data-ready order, so producers precede consumers);
    # inputs from outside the cluster were ready when the cluster started.
    end: list[float] = []
    for ai, (mem, dur) in enumerate(atoms):
        t = 0.0
        for nid in mem:
            for src in dfg.nodes[nid].inputs:
                pa = atom_of.get(src)
                if pa is not None and pa != ai:
                    t = max(t, end[pa])
        end.append(t + dur)
    return max(end) if end else 0.0


def simulate(
    dfg: DFG,
    assignment: dict[str, int],
    *,
    order: str = "dataflow",
    pipelining: bool = True,
    groups: PFGroups | None = None,
    decompose_chains: bool = False,
    chain_split_bytes: float | None = None,
    node_cost: Callable | None = None,
    chain_cost: Callable | None = None,
) -> Schedule:
    """Cycle-level discrete-event model of the data-flow controller.

    ``decompose_chains=True`` prices each pipelined cluster through the same
    structural chain decomposition — including cost-guided splitting at
    ``chain_split_bytes`` — that the lowering pipeline emits for the
    executor, so the simulated latency matches the chain-split plan (the
    compiler sets this whenever the fused Pallas path is active).  The
    default keeps the paper's single-pipeline §IV-G model.

    ``node_cost(node, pf)`` / ``chain_cost(nodes, pfs)`` override the
    template cycle model with measured costs (profile-guided mode): direct
    nodes are priced by ``node_cost`` and each fused sub-chain by
    ``chain_cost`` — the event-driven controller itself is unchanged, only
    the unit durations (and hence the schedule's *units*: µs instead of
    cycles) come from the calibration."""
    groups = groups or PFGroups.build(dfg)
    clusters = pipeline_clusters(dfg, groups, assignment) if pipelining else []
    cluster_of: dict[str, int] = {}
    for ci, mem in enumerate(clusters):
        for nid in mem:
            cluster_of[nid] = ci

    # Build the atom graph: pipelined clusters collapse to a single atom.
    atoms: list[tuple[str, list[str]]] = []  # (atom id, member node ids)
    atom_of: dict[str, int] = {}
    for nid in dfg.topo_order():
        if nid in cluster_of:
            ci = cluster_of[nid]
            aid = f"cluster{ci}"
            found = next((i for i, (a, _) in enumerate(atoms) if a == aid), None)
            if found is None:
                atoms.append((aid, [nid]))
                atom_of[nid] = len(atoms) - 1
            else:
                atoms[found][1].append(nid)
                atom_of[nid] = found
        else:
            atoms.append((nid, [nid]))
            atom_of[nid] = len(atoms) - 1

    if decompose_chains:
        # one topo/successor map, shared by every cluster decomposition
        _topo_idx = {nid: i for i, nid in enumerate(dfg.topo_order())}
        _succ: dict[str, list[str]] = {}
        for nid in _topo_idx:
            for r in dfg.nodes[nid].inputs:
                _succ.setdefault(r, []).append(nid)

    def atom_cycles(ai: int) -> float:
        aid, mem = atoms[ai]
        if len(mem) > 1:
            if decompose_chains:
                return _decomposed_cycles(dfg, mem, assignment,
                                          chain_split_bytes, _topo_idx, _succ,
                                          node_cost, chain_cost)
            return _pipelined_cycles(dfg, mem, assignment,
                                     node_cost, chain_cost)
        return _node_cycles(dfg, mem[0], assignment, node_cost)

    def atom_preds(ai: int) -> set[int]:
        _, mem = atoms[ai]
        preds = set()
        for nid in mem:
            for src in dfg.predecessors(nid):
                pa = atom_of[src]
                if pa != ai:
                    preds.add(pa)
        return preds

    n_atoms = len(atoms)
    preds = [atom_preds(i) for i in range(n_atoms)]
    start: dict[int, float] = {}
    end: dict[int, float] = {}

    if order == "dataflow":
        # ASAP event-driven firing (§IV-F): a pipeline starts only when ALL
        # nodes supplying its inputs are done (§IV-G) — preds is exactly that.
        remaining = {i: len(preds[i]) for i in range(n_atoms)}
        ready = [(0.0, i) for i in range(n_atoms) if remaining[i] == 0]
        heapq.heapify(ready)
        earliest = {i: 0.0 for i in range(n_atoms)}
        succs: dict[int, list[int]] = {i: [] for i in range(n_atoms)}
        for i in range(n_atoms):
            for p in preds[i]:
                succs[p].append(i)
        while ready:
            t, ai = heapq.heappop(ready)
            start[ai] = t
            end[ai] = t + atom_cycles(ai)
            for s in succs[ai]:
                earliest[s] = max(earliest[s], end[ai])
                remaining[s] -= 1
                if remaining[s] == 0:
                    heapq.heappush(ready, (earliest[s], s))
        total = max(end.values()) if end else 0.0
    elif order == "sequential":
        # C-HLS model: one node at a time in topological order.
        t = 0.0
        for ai in range(n_atoms):
            start[ai] = t
            t += atom_cycles(ai)
            end[ai] = t
        total = t
    else:
        raise ValueError(f"unknown order {order!r}")

    node_start = {nid: start[atom_of[nid]] for nid in dfg.nodes}
    node_end = {nid: end[atom_of[nid]] for nid in dfg.nodes}
    return Schedule(
        total_cycles=total,
        start=node_start,
        end=node_end,
        order=order,
        pipelined_clusters=clusters,
    )
