"""Best-PF estimator (paper §IV-E): greedy and black-box strategies.

Both strategies optimize over PF *groups* (see :mod:`repro_torch.core.constraints`)
using the fitted estimation models of :mod:`repro_torch.core.cost_model` — never the
ground truth — mirroring the paper, where the optimizer only sees regression
estimates and the final numbers come from synthesis/simulation.

The compiler invokes both strategies on the *canonical rewritten* graph
(:func:`repro_torch.core.lowering.rewrite` has already pruned dead code, folded
constants and merged duplicate subexpressions), so no LUT budget is ever
spent parallelizing a node the executor would never run, the critical path
never threads through a to-be-deleted duplicate, and the black-box
formulation's path/constraint matrices shrink with the graph.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Literal

import numpy as np

from repro_torch.core import node_types, tpu_model
from repro_torch.core.constraints import PFGroups
from repro_torch.core.cost_model import EstimatorBank, default_bank
from repro_torch.core.dfg import DFG
from repro_torch.core.fpga_model import FpgaBudget

__all__ = ["CostContext", "greedy_best_pf", "blackbox_best_pf", "PFResult"]

Metric = Literal["latency", "latency_per_lut"]


@dataclasses.dataclass
class PFResult:
    group_pfs: list[int]
    assignment: dict[str, int]           # node id -> pf
    est_latency: float                   # estimated critical-path latency
    est_lut: float
    est_dsp: float
    solve_time_s: float
    iterations: int


class CostContext:
    """Latency/resource evaluation callbacks for one (DFG, budget) pair.

    ``backend='fpga'`` constrains sum(LUT) and sum(DSP) against the board
    budget (exclusive spatial resources).  ``backend='tpu'`` constrains each
    group's PF to the mesh-axis size (time-shared chips) and steps PFs through
    powers of two (sharding degrees must divide the axis).
    """

    def __init__(
        self,
        dfg: DFG,
        groups: PFGroups,
        budget,
        backend: str = "fpga",
        bank: EstimatorBank | None = None,
    ) -> None:
        self.dfg = dfg
        self.groups = groups
        self.budget = budget
        self.backend = backend
        self.bank = bank or default_bank()
        for node in dfg.nodes.values():
            if node.latency1 is None:
                raise ValueError("DFG must be PF-1-profiled before optimization")

    # ------------------------------------------------------------ PF stepping
    def next_pf(self, pf: int) -> int:
        return pf * 2 if self.backend == "tpu" else pf + 1

    def max_pf(self, group: int) -> int:
        cap = self.groups.max_pf(group)
        if self.backend == "tpu":
            cap = min(cap, self.budget.max_shard)
        return cap

    # --------------------------------------------------------------- latency
    def node_latency(self, nid: str, pf: int) -> float:
        node = self.dfg.nodes[nid]
        if self.backend == "tpu":
            spec = node_types.get(node.op)
            return tpu_model.node_latency_s(
                spec.flops(node.dims), spec.mem_bytes(node.dims), self.budget.chip, pf
            )
        return self.bank.latency(node.op, node.latency1, pf)

    def critical(self, group_pfs: list[int]) -> tuple[list[str], float]:
        asn = self.groups.assignment(group_pfs)
        return self.dfg.critical_path(lambda n: self.node_latency(n.id, asn[n.id]))

    # -------------------------------------------------------------- resources
    def lut_total(self, group_pfs: list[int]) -> float:
        asn = self.groups.assignment(group_pfs)
        return sum(
            self.bank.lut(n.op, n.lut1, asn[n.id]) for n in self.dfg.nodes.values()
        )

    def dsp_total(self, group_pfs: list[int]) -> float:
        asn = self.groups.assignment(group_pfs)
        return sum(self.bank.dsp(n.op, asn[n.id]) for n in self.dfg.nodes.values())

    def fits(self, group_pfs: list[int]) -> bool:
        for g, pf in enumerate(group_pfs):
            if pf > self.max_pf(g):
                return False
        if self.backend == "tpu":
            return True  # chips are time-shared; per-group cap is the constraint
        if not isinstance(self.budget, FpgaBudget):
            # a hard error, not an assert: under `python -O` a bare assert
            # strips and a TpuBudget (no .luts) would surface as a cryptic
            # AttributeError deep inside the search loop instead.
            raise TypeError(
                f"backend 'fpga' requires an FpgaBudget, got "
                f"{type(self.budget).__name__}")
        return (
            self.lut_total(group_pfs) <= self.budget.luts
            and self.dsp_total(group_pfs) <= self.budget.dsps
        )


def _feasible_start(ctx: CostContext, warm: list[int]) -> list[int]:
    """Clamp a warm-start PF vector into the feasible region: respect the
    per-group caps (and the tpu power-of-two grid), then walk the largest
    PF down until the budget fits — mirroring the black-box rounding's
    repair loop.  Falls back to all-ones when the vector is unusable (wrong
    length — e.g. a near-hit whose group structure drifted — or still
    infeasible at the floor)."""
    import math as _math

    G = len(ctx.groups.members)
    if len(warm) != G:
        return [1] * G
    pfs = [min(max(1, int(p)), ctx.max_pf(g)) for g, p in enumerate(warm)]
    if ctx.backend == "tpu":
        pfs = [1 << max(0, int(_math.floor(_math.log2(max(1, p))))) for p in pfs]
    while not ctx.fits(pfs) and max(pfs) > 1:
        g = max(range(G), key=lambda i: pfs[i])
        pfs[g] = pfs[g] // 2 if ctx.backend == "tpu" else pfs[g] - 1
    return pfs if ctx.fits(pfs) else [1] * G


# ------------------------------------------------------------------- greedy (§IV-E-2)
def _greedy_climb(ctx: CostContext, metric: Metric,
                  pfs: list[int]) -> tuple[list[int], int]:
    """One greedy hill climb from ``pfs`` (the paper's §IV-E-2 loop):
    repeatedly bump the best-scoring critical-path group until no move on
    the critical path improves latency within budget."""
    iters = 0
    while True:
        iters += 1
        path, total = ctx.critical(pfs)
        best: tuple[tuple[float, float], list[int], float] | None = None
        tried: set[int] = set()
        for nid in path:
            g = ctx.groups.group_of[nid]
            if g in tried:
                continue
            tried.add(g)
            nxt = ctx.next_pf(pfs[g])
            if nxt > ctx.max_pf(g):
                continue
            cand = list(pfs)
            cand[g] = nxt
            if not ctx.fits(cand):
                continue
            _, new_total = ctx.critical(cand)
            dlat = total - new_total
            if dlat <= 0:
                continue
            if metric == "latency":
                score = (0.0, dlat)
            else:
                dlut = ctx.lut_total(cand) - ctx.lut_total(pfs)
                # A move that adds no LUTs (dlut <= 0) is *free*: strictly
                # prefer it over any paid move, and rank free moves among
                # themselves by latency gain.  (Dividing by an epsilon-clamped
                # dlut instead lets a paid move outscore a small free one and
                # collapses LUT-reducing moves onto the same inflated ratio.)
                score = (1.0, dlat) if dlut <= 0 else (0.0, dlat / dlut)
            if best is None or score > best[0]:
                best = (score, cand, new_total)
        if best is None:
            # paper: if no node on the critical path can be improved, exit —
            # parallelizing non-critical nodes cannot help in data-flow order.
            break
        pfs = best[1]
    return pfs, iters


def greedy_best_pf(ctx: CostContext, metric: Metric = "latency_per_lut",
                   warm_start: list[int] | None = None) -> PFResult:
    """``warm_start`` (rewrite-aware PF warm-start, per group) additionally
    climbs from a prior solution.  The climb only ever *increases* PFs, so
    an over-parallelized seed could strand the search past the optimum; the
    cold all-ones climb therefore always runs too and the better endpoint
    wins — warm starts improve quality when the seed sits in a better
    basin, and can never regress below the cold result."""
    t0 = time.perf_counter()
    pfs, iters = _greedy_climb(ctx, metric, [1] * len(ctx.groups.members))
    if warm_start is not None:
        seed = _feasible_start(ctx, warm_start)
        if seed != [1] * len(ctx.groups.members):
            wpfs, witers = _greedy_climb(ctx, metric, seed)
            iters += witers
            better = ctx.critical(wpfs)[1] < ctx.critical(pfs)[1] or (
                ctx.critical(wpfs)[1] == ctx.critical(pfs)[1]
                and ctx.lut_total(wpfs) < ctx.lut_total(pfs))
            if better:
                pfs = wpfs
    _, lat = ctx.critical(pfs)
    return PFResult(
        group_pfs=pfs,
        assignment=ctx.groups.assignment(pfs),
        est_latency=lat,
        est_lut=ctx.lut_total(pfs),
        est_dsp=ctx.dsp_total(pfs),
        solve_time_s=time.perf_counter() - t0,
        iterations=iters,
    )


# ----------------------------------------------------------------- black-box (§IV-E-1)
def blackbox_best_pf(
    ctx: CostContext,
    max_paths: int = 4000,
    n_starts: int = 1,
    rounding_budget: int = 0,
    warm_start: list[int] | None = None,
) -> PFResult:
    """Min-max formulation: minimize target latency T s.t. every path's summed
    latency <= T and resources fit.  The integer program is relaxed to reals
    (scipy SLSQP) and PFs are rounded *down* — exactly the paper's pipeline
    (§VI-C: "we round down all the PF numbers...; optimal rounding is itself
    NP-hard"), which is why greedy beats it on quality.

    Beyond-paper knobs: ``n_starts > 1`` multi-starts the nonconvex min-max
    relaxation; ``rounding_budget > 0`` spends a bounded branch-and-bound on
    the NP-hard rounding step ({floor, ceil} per group).  With those enabled
    the black-box matches/beats greedy quality at ~an order of magnitude
    more solve time — the quality gap the paper measures is the *rounding*
    gap (see benchmarks/greedy_vs_blackbox)."""
    from scipy import optimize

    t0 = time.perf_counter()
    G = len(ctx.groups.members)
    paths = ctx.dfg.all_paths(limit=max_paths)
    node_ids = list(ctx.dfg.nodes)
    gid = np.array([ctx.groups.group_of[nid] for nid in node_ids])
    lat1 = np.array([ctx.dfg.nodes[nid].latency1 for nid in node_ids])
    ops = [ctx.dfg.nodes[nid].op for nid in node_ids]
    aL = np.array([ctx.bank.estimators[op].aL for op in ops])
    bL = np.array([ctx.bank.estimators[op].bL for op in ops])
    cL = np.array([ctx.bank.estimators[op].cL for op in ops])
    lut1 = np.array([ctx.dfg.nodes[nid].lut1 for nid in node_ids])
    aLUT = np.array([ctx.bank.estimators[op].aLUT for op in ops])
    bLUT = np.array([ctx.bank.estimators[op].bLUT for op in ops])
    aDSP = np.array([ctx.bank.estimators[op].aDSP for op in ops])
    path_masks = np.zeros((len(paths), len(node_ids)))
    idx_of = {nid: i for i, nid in enumerate(node_ids)}
    for p, path in enumerate(paths):
        for nid in path:
            path_masks[p, idx_of[nid]] = 1.0

    def node_lats(pf_groups: np.ndarray) -> np.ndarray:
        pf = pf_groups[gid]
        return (aL + bL * pf + cL / pf) * lat1

    def cons_paths(x: np.ndarray) -> np.ndarray:
        T, pfg = x[0], x[1:]
        return T - path_masks @ node_lats(pfg)

    def cons_res(x: np.ndarray) -> np.ndarray:
        pf = x[1:][gid]
        lut = float(np.sum((aLUT + bLUT * pf) * lut1))
        dsp = float(np.sum(aDSP * pf))
        if ctx.backend == "tpu":
            return np.array([1.0, 1.0])
        return np.array([ctx.budget.luts - lut, ctx.budget.dsps - dsp])

    caps = np.array([ctx.max_pf(g) for g in range(G)], dtype=float)
    bounds = [(0.0, None)] + [(1.0, float(c)) for c in caps]
    rng = np.random.default_rng(0)
    best_real: np.ndarray | None = None
    best_T = np.inf
    total_nit = 0
    for s in range(max(1, n_starts)):
        if s == 0:
            # the primary start: a warm-start vector (rewrite-aware PF
            # cache near-hit) when available, else the PF-1 point
            if warm_start is not None and len(warm_start) == G:
                pf0 = np.clip(np.asarray(warm_start, float), 1.0, caps)
            else:
                pf0 = np.ones(G)
        else:
            pf0 = 1.0 + rng.random(G) * (caps - 1.0)
        x0 = np.concatenate([[float(ctx.critical([1] * G)[1])], pf0])
        res = optimize.minimize(
            lambda x: x[0],
            x0,
            jac=lambda x: np.concatenate([[1.0], np.zeros(G)]),
            bounds=bounds,
            constraints=[
                {"type": "ineq", "fun": cons_paths},
                {"type": "ineq", "fun": cons_res},
            ],
            method="SLSQP",
            options={"maxiter": 400, "ftol": 1e-9},
        )
        total_nit += int(res.nit)
        feas = (np.min(cons_paths(res.x)) > -1e-6
                and np.min(cons_res(res.x)) > -1e-6)
        if feas and res.x[0] < best_T:
            best_T = float(res.x[0])
            best_real = np.clip(res.x[1:], 1.0, caps)
    if best_real is None:
        best_real = np.ones(G)

    def snap(pfs: list[int]) -> list[int]:
        if ctx.backend == "tpu":
            return [1 << max(0, int(np.floor(np.log2(max(1, p))))) for p in pfs]
        return pfs

    # round *down* first — guaranteed inside the budget (§VI-C) — then a
    # bounded branch-and-bound over {floor, ceil} per group (optimal
    # rounding is NP-hard; this is the generic-solver best effort).
    floor_pfs = snap([max(1, int(np.floor(p))) for p in best_real])
    while not ctx.fits(floor_pfs):
        g = int(np.argmax(floor_pfs))
        if floor_pfs[g] == 1:
            break
        floor_pfs[g] = floor_pfs[g] - 1 if ctx.backend != "tpu" else floor_pfs[g] // 2
    best_pfs = list(floor_pfs)
    _, best_lat = ctx.critical(best_pfs)

    frac = [g for g in range(G)
            if int(np.ceil(best_real[g])) != int(np.floor(best_real[g]))
            and ctx.backend != "tpu"]
    explored = 0
    stackq: list[tuple[int, list[int]]] = [(0, list(floor_pfs))]
    while stackq and explored < rounding_budget:
        i, pfs = stackq.pop()
        if i >= len(frac):
            continue
        explored += 1
        g = frac[i]
        up = list(pfs)
        up[g] = min(int(caps[g]), int(np.ceil(best_real[g])))
        for cand in (pfs, up):
            if ctx.fits(cand):
                _, lat = ctx.critical(cand)
                if lat < best_lat:
                    best_lat, best_pfs = lat, list(cand)
                stackq.append((i + 1, list(cand)))
    pfs = best_pfs
    lat = best_lat
    return PFResult(
        group_pfs=pfs,
        assignment=ctx.groups.assignment(pfs),
        est_latency=lat,
        est_lut=ctx.lut_total(pfs),
        est_dsp=ctx.dsp_total(pfs),
        solve_time_s=time.perf_counter() - t0,
        iterations=total_nit,
    )
