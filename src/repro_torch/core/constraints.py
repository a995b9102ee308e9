"""PF constraint propagation (paper §IV-A, Fig. 2).

Rules:
  * linear-time nodes: input PF == execution PF == output PF (no shufflers);
  * non-linear-time nodes: shuffle logic before/after the execution unit
    decouples their execution PF from their edge PFs;
  * producer output PF == consumer input PF.

Consequence (exploited by §IV-G pipelining): any connected subgraph of
linear-time nodes shares a single PF.  We therefore materialize PF *groups*:
one group per linear-time cluster, one group per non-linear-time node.
Bumping a group's PF bumps every member node.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import node_types
from repro_torch.core.dfg import DFG

__all__ = ["PFGroups"]


@dataclasses.dataclass
class PFGroups:
    dfg: DFG
    group_of: dict[str, int]           # node id -> group index
    members: list[list[str]]           # group index -> node ids

    @classmethod
    def build(cls, dfg: DFG) -> "PFGroups":
        clusters = dfg.subgraph_of_connected(
            lambda n: node_types.get(n.op).linear_time
        )
        group_of: dict[str, int] = {}
        members: list[list[str]] = []
        for cluster in clusters:
            idx = len(members)
            members.append(sorted(cluster))
            for nid in cluster:
                group_of[nid] = idx
        for nid, node in dfg.nodes.items():
            if nid not in group_of:  # each non-linear-time node is its own group
                group_of[nid] = len(members)
                members.append([nid])
        return cls(dfg=dfg, group_of=group_of, members=members)

    def max_pf(self, group: int) -> int:
        """A group can only be parallelized as far as its most constrained member."""
        return min(
            node_types.get(self.dfg.nodes[nid].op).max_pf(self.dfg.nodes[nid].dims)
            for nid in self.members[group]
        )

    def assignment(self, group_pfs: list[int]) -> dict[str, int]:
        return {nid: group_pfs[g] for nid, g in self.group_of.items()}

    def apply(self, group_pfs: list[int]) -> None:
        for nid, g in self.group_of.items():
            self.dfg.nodes[nid].pf = group_pfs[g]

    def linear_clusters(self) -> list[list[str]]:
        """Groups that are linear-time clusters (candidates for §IV-G pipelining)."""
        out = []
        for mem in self.members:
            if all(node_types.get(self.dfg.nodes[nid].op).linear_time for nid in mem):
                out.append(mem)
        return out
