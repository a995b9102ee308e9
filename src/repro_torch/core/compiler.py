"""MafiaCompiler — the end-to-end flow of Fig. 1, rewrite-first, on PyTorch.

input DFG → **front-end rewrite** (prune → constant-fold → algebraic → CSE →
hoist) → PF-1 profiler → Best-PF estimator → scheduler generator → back-end
plan pipeline (quantize-rewrite → cluster → chain-decompose → plan →
linearize) → a callable over the static plan + the simulated
latency/resource report.

The host-side compile (rewrite, PF search, schedule, calibration, lowering)
is device-free and identical to the JAX package's; ``device`` only says
where the emitted callables run — the card unless the caller asks for the
CPU.  ``exec_mode="megakernel_grid"`` serves each bucket through one launch
of the CUDA megakernel; ``use_pallas=True`` on the ``interpret`` lane runs
each fused §IV-G chain through one launch of the CUDA chain kernel.

Not ported yet (they raise ``NotImplementedError``): the persistent
artifact store, and profile-guided compilation (``cost_source="measured"``,
``calibration``, ``autotune``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import node_types
from repro_torch.core.constraints import PFGroups
from repro_torch.core.cost_model import EstimatorBank, default_bank
from repro_torch.core.device import as_tensor, resolve_device
from repro_torch.core.dfg import DFG
from repro_torch.core.executor import build_callable
from repro_torch.core.fpga_model import ARTY_A7, FpgaBudget
from repro_torch.core.lowering import (
    DEFAULT_CHAIN_SPLIT_BYTES,
    ExecutionPlan,
    RewriteResult,
    _resolve,
    lower,
    rewrite,
)
from repro_torch.core.optimizer import (
    CostContext,
    PFResult,
    blackbox_best_pf,
    greedy_best_pf,
)
from repro_torch.core.profiler import profile_pf1
from repro_torch.core.scheduler import Schedule, pipeline_clusters, simulate
from repro_torch.core.tpu_model import TpuBudget

__all__ = ["MafiaCompiler", "CompiledProgram", "BatchedProgram"]


@dataclasses.dataclass
class CompiledProgram:
    dfg: DFG                     # canonical rewritten graph (what executes)
    fn: Callable[..., dict[str, Any]]
    assignment: dict[str, int]   # PFs over the rewritten graph's nodes only
    pf_result: PFResult | None
    schedule: Schedule
    lut_true: float
    dsp_true: float
    backend: str
    budget: Any
    fused_clusters: list[list[str]] = dataclasses.field(default_factory=list)
    use_pallas: bool = False
    precision: str = "float32"
    qplan: Any | None = None     # QuantPlan on the fixed-point lanes
    plan: ExecutionPlan | None = None  # static plan every lane interprets
    # "interpret" | "megakernel" (one launch per sample) | "megakernel_grid"
    # (one launch per bucket)
    exec_mode: str = "interpret"
    source_dfg: DFG | None = None      # the pre-rewrite graph, for reference
    rewrite_result: RewriteResult | None = None
    # "cold" (fresh search), "near" (seeded by a cached result for the same
    # wiring), "exact" (cache hit — no search ran) or "external"
    pf_source: str = "cold"
    chain_split_bytes: float | None = DEFAULT_CHAIN_SPLIT_BYTES
    cost_source: str = "analytic"
    device: torch.device | None = None   # None: the card, which must exist

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    @property
    def latency_cycles(self) -> float:
        return self.schedule.total_cycles

    @property
    def latency_us(self) -> float:
        return self.budget.cycles_to_us(self.schedule.total_cycles)

    def __call__(self, **inputs: Any) -> dict[str, Any]:
        return self.fn(**inputs)

    def batch(self, max_batch: int = 64, *, mode: str = "vmap",
              exec_mode: str | None = None) -> "BatchedProgram":
        """Batched execution of this program (the serving path).

        Batch sizes round up to power-of-two *buckets* (capped at
        ``max_batch``); larger batches split into ``max_batch`` chunks.
        ``mode="vmap"`` runs the batched lane (``torch.func.vmap`` over the
        node templates, or one grid launch per bucket under
        ``exec_mode="megakernel_grid"``); ``mode="map"`` runs the per-sample
        program once per sample — bitwise identical to per-sample calls.
        ``exec_mode`` defaults to the mode the program was compiled with.
        """
        return BatchedProgram.build(
            self, max_batch=max_batch, mode=mode,
            exec_mode=self.exec_mode if exec_mode is None else exec_mode)


@dataclasses.dataclass
class BatchedProgram:
    """Bucketed batched callable over a :class:`CompiledProgram`.
    ``stats`` counts forwards per bucket size."""

    program: CompiledProgram
    max_batch: int
    mode: str
    fn: Callable[[dict[str, Any]], dict[str, Any]]
    exec_mode: str = "interpret"
    stats: dict[int, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, program: CompiledProgram, *, max_batch: int = 64,
              mode: str = "vmap",
              exec_mode: str | None = None) -> "BatchedProgram":
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if exec_mode is None:
            exec_mode = program.exec_mode
        kw: dict[str, Any] = dict(
            fused_clusters=program.fused_clusters,
            use_pallas=program.use_pallas, precision=program.precision,
            qplan=program.qplan, plan=program.plan, mode=exec_mode,
            device=program.device)
        if mode == "vmap":
            inner = build_callable(program.dfg, batch=True, **kw)

            def fn(inputs: dict[str, Any]) -> dict[str, Any]:
                return inner(**inputs)
        elif mode == "map":
            single = build_callable(program.dfg, **kw)

            def fn(inputs: dict[str, Any]) -> dict[str, Any]:
                n = next(iter(inputs.values())).shape[0]
                per = [single(**{k: v[i] for k, v in inputs.items()})
                       for i in range(n)]
                return {k: torch.stack([p[k] for p in per]) for k in per[0]}
        else:
            raise ValueError(f"unknown batch mode {mode!r}")
        return cls(program=program, max_batch=max_batch, mode=mode, fn=fn,
                   exec_mode=exec_mode)

    def bucket(self, n: int) -> int:
        """Smallest power-of-two ≥ n, capped at ``max_batch``."""
        if n < 1:
            raise ValueError("empty batch")
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def __call__(self, **inputs: Any) -> dict[str, Any]:
        dev = self.program.device
        arrays = {k: as_tensor(v, dev) for k, v in inputs.items()}
        allowed = set(self.program.dfg.graph_inputs)
        unknown = set(arrays) - allowed
        if unknown:  # mirror the per-sample path: extras are a caller bug
            raise TypeError(f"unknown graph inputs: {sorted(unknown)}")
        missing = allowed - set(arrays)
        if missing:
            raise TypeError(f"missing graph inputs: {sorted(missing)}")
        sizes = {int(v.shape[0]) for v in arrays.values()}
        if len(sizes) != 1:
            raise ValueError(f"inconsistent batch sizes: {sorted(sizes)}")
        (B,) = sizes
        chunks: list[dict[str, Any]] = []
        start = 0
        while start < B:
            stop = min(start + self.max_batch, B)
            nb = stop - start
            bkt = self.bucket(nb)
            pad = bkt - nb
            chunk = {
                k: torch.cat([v[start:stop],
                              v.new_zeros((pad,) + tuple(v.shape[1:]))])
                for k, v in arrays.items()
            }
            out = self.fn(chunk)
            self.stats[bkt] = self.stats.get(bkt, 0) + 1
            chunks.append({k: v[:nb] for k, v in out.items()})
            start = stop
        if len(chunks) == 1:
            return chunks[0]
        return {k: torch.cat([c[k] for c in chunks], dim=0) for k in chunks[0]}


class MafiaCompiler:
    def __init__(
        self,
        *,
        backend: str = "fpga",
        budget: FpgaBudget | TpuBudget | None = None,
        strategy: str = "greedy",
        metric: str = "latency_per_lut",
        order: str = "dataflow",
        pipelining: bool = True,
        use_pallas: bool = False,
        bank: EstimatorBank | None = None,
        precision: str = "float32",
        calib_samples: int = 64,
        per_channel: bool = False,
        chain_split_bytes: float | None = DEFAULT_CHAIN_SPLIT_BYTES,
        warm_start: bool = True,
        exec_mode: str = "interpret",
        artifact_store: Any | None = None,
        cost_source: str = "analytic",
        autotune: bool = False,
        calibration: Any | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        """Knobs as in the JAX package's compiler: ``precision="int8"`` /
        ``"int16"`` emits the fixed-point program (calibrated power-of-two
        scales, int32 accumulation, float in / float out);
        ``per_channel`` gives matvec weights one scale per row;
        ``chain_split_bytes`` bounds fused chains; ``warm_start`` reuses
        Best-PF results across recompiles of the same canonical graph;
        ``exec_mode`` picks the execution lane.  ``device`` is where the
        emitted callables run (None: the card)."""
        if backend not in ("fpga", "tpu"):
            raise ValueError(f"unknown backend {backend!r}")
        if precision not in ("float32", "int8", "int16"):
            raise ValueError(f"unknown precision {precision!r}")
        if exec_mode not in ("interpret", "megakernel", "megakernel_grid"):
            raise ValueError(f"unknown exec_mode {exec_mode!r}")
        if cost_source not in ("analytic", "measured"):
            raise ValueError(f"unknown cost_source {cost_source!r}")
        if artifact_store is not None:
            raise NotImplementedError("the artifact store is not ported yet")
        if (cost_source != "analytic" or autotune or calibration is not None
                or chain_split_bytes == "auto"):
            raise NotImplementedError(
                "profile-guided compilation is not ported yet")
        self.backend = backend
        self.budget = budget or (ARTY_A7 if backend == "fpga" else TpuBudget())
        self.strategy = strategy
        self.metric = metric
        self.order = order
        self.pipelining = pipelining
        self.use_pallas = use_pallas
        self.bank = bank or default_bank()
        self.precision = precision
        self.calib_samples = calib_samples
        self.per_channel = per_channel
        self.chain_split_bytes = chain_split_bytes
        self.warm_start = warm_start
        self.exec_mode = exec_mode
        self.cost_source = cost_source
        self.device = resolve_device(device)
        # rewrite-aware PF warm-start caches, keyed on the canonical
        # rewritten graph's structural hash (exact / dims-blind near).
        self._pf_cache: dict[str, PFResult] = {}
        self._near_cache: dict[str, PFResult] = {}

    def optimize(
        self, dfg: DFG, warm_assignment: dict[str, int] | None = None
    ) -> tuple[PFResult, PFGroups]:
        """Run the Best-PF search, optionally seeded at a prior solution."""
        profile_pf1(dfg, backend=self.backend)
        groups = PFGroups.build(dfg)
        ctx = CostContext(dfg, groups, self.budget, backend=self.backend, bank=self.bank)
        warm: list[int] | None = None
        if warm_assignment is not None:
            warm = [max((int(warm_assignment.get(nid, 1)) for nid in mem),
                        default=1)
                    for mem in groups.members]
        if self.strategy == "greedy":
            res = greedy_best_pf(ctx, metric=self.metric,  # type: ignore[arg-type]
                                 warm_start=warm)
        elif self.strategy == "blackbox":
            res = blackbox_best_pf(ctx, warm_start=warm)
        elif self.strategy == "none":
            pfs = [1] * len(groups.members)
            res = PFResult(pfs, groups.assignment(pfs), ctx.critical(pfs)[1],
                           ctx.lut_total(pfs), ctx.dsp_total(pfs), 0.0, 0)
        else:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        groups.apply(res.group_pfs)
        return res, groups

    def compile(
        self,
        dfg: DFG,
        assignment: dict[str, int] | None = None,
        *,
        calib: Any | None = None,
    ) -> CompiledProgram:
        """Full flow; pass ``assignment`` to impose external PFs (baselines).
        ``calib`` (fixed-point lanes only) is the calibration batch."""
        rw = rewrite(dfg, precision=self.precision)
        rdfg = rw.dfg
        pf_result: PFResult | None = None
        pf_source = "external"
        if assignment is None:
            exact_key = near_key = None
            cached: PFResult | None = None
            if self.warm_start:
                exact_key = rdfg.structural_hash()
                near_key = rdfg.structural_hash(include_dims=False)
                cached = self._pf_cache.get(exact_key)
            if cached is not None:
                pf_source = "exact"
                pf_result = cached
                profile_pf1(rdfg, backend=self.backend)
                groups = PFGroups.build(rdfg)
                assignment = dict(pf_result.assignment)
                for nid in rdfg.nodes:
                    rdfg.nodes[nid].pf = assignment[nid]
            else:
                near = (self._near_cache.get(near_key)
                        if self.warm_start else None)
                pf_source = "near" if near is not None else "cold"
                pf_result, groups = self.optimize(
                    rdfg,
                    warm_assignment=near.assignment if near else None)
                assignment = dict(pf_result.assignment)
                if self.warm_start:
                    self._pf_cache[exact_key] = pf_result
                    self._near_cache[near_key] = pf_result
        else:
            unknown = set(assignment) - set(dfg.nodes)
            if unknown:
                raise ValueError(
                    f"assignment names unknown nodes: {sorted(unknown)}")
            eff: dict[str, int] = {}
            for nid, pf in assignment.items():
                rid = _resolve(rw.alias, nid)
                if rid in rdfg.nodes:
                    eff[rid] = max(eff.get(rid, 1), int(pf))
            assignment = {nid: eff.get(nid, 1) for nid in rdfg.nodes}
            profile_pf1(rdfg, backend=self.backend)
            groups = PFGroups.build(rdfg)
            for nid, pf in assignment.items():
                rdfg.nodes[nid].pf = pf
        # with the fused chain kernels active, price pipelined clusters
        # through the same chain decomposition (and cost-guided splits) the
        # plan will execute
        sim_kw: dict[str, Any] = dict(order=self.order, groups=groups)
        if self.use_pallas:
            sim_kw.update(decompose_chains=True,
                          chain_split_bytes=self.chain_split_bytes)
        if self.pipelining == "auto":
            sched_p = simulate(rdfg, assignment, pipelining=True, **sim_kw)
            sched_n = simulate(rdfg, assignment, pipelining=False, **sim_kw)
            use_pipe = sched_p.total_cycles <= sched_n.total_cycles
            sched = sched_p if use_pipe else sched_n
        else:
            use_pipe = bool(self.pipelining)
            sched = simulate(rdfg, assignment, pipelining=use_pipe, **sim_kw)
        fused = pipeline_clusters(rdfg, groups, assignment) if use_pipe else []
        qplan = None
        if self.precision != "float32":
            from repro_torch.core import quantize as quantize_mod

            qplan = quantize_mod.calibrate(
                rdfg, calib, n_samples=self.calib_samples,
                bits=quantize_mod.PRECISION_BITS[self.precision],
                per_channel=self.per_channel)
        plan = lower(rdfg, fused_clusters=fused, use_pallas=self.use_pallas,
                     precision=self.precision, qplan=qplan, rewritten=rw,
                     chain_split_bytes=self.chain_split_bytes)
        fn = build_callable(rdfg, plan=plan, mode=self.exec_mode,
                            device=self.device)
        lut_true = sum(
            node_types.get(n.op).lut(n.dims, assignment[n.id])
            for n in rdfg.nodes.values()
        )
        dsp_true = sum(
            node_types.get(n.op).dsp(assignment[n.id])
            for n in rdfg.nodes.values()
        )
        return CompiledProgram(
            dfg=rdfg,
            fn=fn,
            assignment=assignment,
            pf_result=pf_result,
            schedule=sched,
            lut_true=lut_true,
            dsp_true=dsp_true,
            backend=self.backend,
            budget=self.budget,
            fused_clusters=fused,
            use_pallas=self.use_pallas,
            precision=self.precision,
            qplan=qplan,
            plan=plan,
            exec_mode=self.exec_mode,
            source_dfg=dfg,
            rewrite_result=rw,
            pf_source=pf_source,
            chain_split_bytes=self.chain_split_bytes,
            cost_source=self.cost_source,
            device=self.device,
        )
