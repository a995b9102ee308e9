"""Profile-guided compilation: microbenchmark, fit, autotune — on the card.

The analytic cost model (:mod:`repro_torch.core.cost_model`) prices nodes in
*paper cycles*, a regression over the FPGA templates that has never seen
the device the port runs on.  There the dominant cost of a small classical
program is per-launch overhead, not MAC work.  This module measures the
device and fits a cost model to it:

* **Microbenchmark harness** — :func:`bench_op` times one op's template
  (``OpSpec.fn``) on tensors on the device; :func:`bench_chain` times the
  fused-chain kernel (``csrc/linear_chain.cu`` on a card) over chains of
  varying depth and width; :func:`bench_segments` times the per-sample
  megakernel lane (``csrc/megakernel.cu`` at nb = 1) on compiled Table-I
  programs.  Every observation is a :class:`MicrobenchSample` keyed by
  ``(op, dims-bucket, pf, precision, exec_mode, device_class)``.
* **:class:`CalibrationTable`** — the samples plus autotuned knobs,
  persisted through :mod:`repro_torch.core.artifacts`, keyed by device
  class, so profiling is paid once per machine class.
* **:class:`CalibratedCostModel`** — an :class:`EstimatorBank` fitted from
  the samples: per-op ``wall_us ≈ t_op + s_op · cycles`` (the intercept is
  the launch and dispatch overhead the analytic model lacks), with a global
  fit for ops the table never measured.  The PF curve keeps the analytic
  coefficients, which ``blackbox_best_pf`` reads.
* **Autotuner** — :func:`autotune_knobs` sweeps ``chain_split_bytes`` on
  the device through the chain-kernel path of a ``use_pallas=True``
  compile and records the winner in the table's ``knobs``.  The JAX
  package also sweeps the chain kernel's ``(bb, bn)`` tiles; the CUDA chain
  kernel ignores them (:func:`~repro_torch.kernels.linear_pipeline.
  plan_chain` cuts the stream), so such a sweep would time identical
  launches and its noise would reach the chain splitter through
  ``set_tuned_tiles``.  Tables made here record no ``bb``/``bn``; a table
  that carries them is still applied as the JAX package applies it.

Times are wall time of one call from the host's point of view, the
wrapper's dispatch included: the device is synchronised before the first
repeat and after each call, and the least of the repeats is kept.

``MafiaCompiler(cost_source="measured", autotune=…)`` is the consumer.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import platform
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import node_types
from repro_torch.core.cost_model import _TRAIN_DIMS, EstimatorBank, default_bank
from repro_torch.core.device import resolve_device

__all__ = [
    "CalibratedCostModel",
    "CalibrationTable",
    "MicrobenchSample",
    "autotune_knobs",
    "bench_chain",
    "bench_op",
    "bench_segments",
    "default_calibration",
    "device_class",
    "dims_bucket",
    "profile_device",
]

# fill cycles of the template pipeline model — must match node_types._FILL
_FILL = 6.0


def device_class(device: torch.device | str | None = None) -> str:
    """Stable identifier of ``device``'s class (None: the card):
    ``cuda:<card name>`` or ``cpu:<machine>``, lowercased, ``_`` for
    spaces.  A calibration table is only valid on the class it was made
    on."""
    dev = resolve_device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else platform.machine() or "host")
    return f"{dev.type}:{kind}".replace(" ", "_").lower()


def _bucket(v: int) -> int:
    """Power-of-two dims bucket: shapes within 2× share a sample key."""
    return 1 << max(0, int(v) - 1).bit_length()


def dims_bucket(dims: dict[str, int]) -> tuple[tuple[str, int], ...]:
    return tuple(sorted((k, _bucket(v)) for k, v in dims.items()))


@dataclasses.dataclass(frozen=True)
class MicrobenchSample:
    """One timed observation of an op template / chain / segment shape."""

    op: str                                  # op name, "__chain__", "__segment__"
    dims_bucket: tuple[tuple[str, int], ...]
    pf: int
    precision: str
    exec_mode: str                           # "op" | "chain" | "megakernel"
    device_class: str
    wall_us: float                           # min-of-repeats wall time
    work_cycles: float                       # analytic template cycles (regressor)
    extent: float = 0.0                      # chain depth / segment instrs


@dataclasses.dataclass
class CalibrationTable:
    """Raw microbenchmark samples + autotuned knobs for one device class,
    persisted through :mod:`repro_torch.core.artifacts` (``.mafia-calib``:
    the program-artifact LRU sweep never evicts it)."""

    device_class: str
    samples: list[MicrobenchSample] = dataclasses.field(default_factory=list)
    knobs: dict[str, Any] = dataclasses.field(default_factory=dict)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        # creation stamp, gated by MafiaCompiler(max_age_days=...); kept
        # out of digest() so artifact keys do not churn per run
        self.meta.setdefault("created_at", time.time())

    @property
    def created_at(self) -> float:
        """Unix time the measurements were taken."""
        return float(self.meta["created_at"])

    def age_days(self, now: float | None = None) -> float:
        now = time.time() if now is None else now
        return max(0.0, (now - self.created_at) / 86400.0)

    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(self.device_class.encode())
        for s in self.samples:
            h.update(repr((s.op, s.dims_bucket, s.pf, s.precision,
                           s.exec_mode, round(s.wall_us, 3))).encode())
        h.update(repr(sorted(self.knobs.items())).encode())
        return h.hexdigest()


# ------------------------------------------------------------ deterministic cases
def _op_case(op: str, dims: dict[str, int],
             rng: np.random.Generator) -> tuple[list[np.ndarray], dict[str, Any]]:
    """Deterministic inputs/params exercising one op template at ``dims``."""
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    if op in ("gemv", "spmv"):
        w = f32(dims["m"], dims["n"])
        if op == "spmv":
            # thin the matrix to ~the requested nnz so the analytic
            # regressor (nnz-driven) matches the measured operand
            keep = min(1.0, dims.get("nnz", w.size) / w.size)
            w = np.where(rng.random(w.shape) < keep, w, 0.0).astype(np.float32)
            w.flat[0] = 1.0                       # nnz >= 1
        return [f32(dims["n"])], {"matrix": w}
    if op == "matmul":
        return [f32(dims["m"], dims["k"]), f32(dims["k"], dims["n"])], {}
    if op == "outer":
        return [f32(dims["m"]), f32(dims["n"])], {}
    if op == "sq_l2":
        return [f32(dims["d"])], {"points": f32(dims["d"], dims["m"])}
    if op in ("add", "sub", "hadamard", "dot"):
        return [f32(dims["n"]), f32(dims["n"])], {}
    if op == "scalar_mul":
        return [f32(dims["n"])], {"scalar": 1.5}
    if op == "const":
        return [], {"value": f32(dims["n"])}
    if op == "conv2d":
        params: dict[str, Any] = {
            "kernel": f32(dims["cout"], dims["cin"], dims["kh"], dims["kw"])}
        if dims.get("bias"):
            params["bias"] = f32(dims["cout"])
        return [f32(dims["cin"], dims["h"], dims["w"])], params
    if op in ("maxpool2d", "avgpool2d"):
        return ([f32(dims["c"], dims["h"], dims["w"])],
                {"ksize": (dims["kh"], dims["kw"])})
    if op == "layernorm":
        return [f32(dims["n"])], {"gamma": f32(dims["n"]),
                                  "beta": f32(dims["n"])}
    if op == "reshape":
        return [f32(dims["n"])], {"shape": (dims["n"],)}
    # unary elementwise (relu6/softmax/flatten included) + reductions + argmax
    return [f32(dims["n"])], {}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_us(fn: Callable[[], Any], *, warmup: int, reps: int,
             device: torch.device) -> float:
    """Least wall µs of ``reps`` calls of ``fn``: the device synchronised
    before the first repeat and after each call, so a call's time is what
    its caller waits for, the wrapper's dispatch included."""
    with torch.no_grad():
        for _ in range(max(0, warmup)):
            fn()
        _sync(device)
        best = float("inf")
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            best = min(best, time.perf_counter() - t0)
    return best * 1e6


def bench_op(op: str, dims: dict[str, int], *, pf: int = 1,
             precision: str = "float32", warmup: int = 1, reps: int = 3,
             device: torch.device | str | None = None) -> MicrobenchSample:
    """Time one op template (``OpSpec.fn``, the template every lane runs)
    on deterministic tensors on ``device`` (None: the card).  ``pf`` is
    recorded in the key; the time is PF-independent, since the device has
    no parallelization-factor axis."""
    dev = resolve_device(device)
    spec = node_types.get(op)
    inputs, params = _op_case(op, dims, np.random.default_rng(0))
    args = [torch.from_numpy(a).to(dev) for a in inputs]
    wall = _time_us(lambda: spec.fn(args, params, dims), warmup=warmup,
                    reps=reps, device=dev)
    return MicrobenchSample(
        op=op, dims_bucket=dims_bucket(dims), pf=pf, precision=precision,
        exec_mode="op", device_class=device_class(dev),
        wall_us=wall, work_cycles=float(spec.cycles(dims, pf)))


def bench_chain(n: int, depth: int, *, warmup: int = 1, reps: int = 3,
                device: torch.device | str | None = None) -> MicrobenchSample:
    """Time one fused-chain call of ``depth`` relu stages over an
    ``n``-wide stream — the unit the chain splitter prices.  This is
    :func:`~repro_torch.kernels.linear_pipeline.fused_linear_chain` with
    its :class:`~repro_torch.kernels.linear_pipeline.Chain` held across the
    calls, as a compiled program's chain step holds it: on a card one
    launch of the chain kernel per call (``LAUNCHES["linear_chain"]``)."""
    from repro_torch.kernels.linear_pipeline import Chain, run_chain

    dev = resolve_device(device)
    x = torch.from_numpy(np.random.default_rng(0)
                         .standard_normal(n).astype(np.float32)).to(dev)
    chain = Chain((("relu", None),) * max(1, depth))
    wall = _time_us(lambda: run_chain(chain, x), warmup=warmup, reps=reps,
                    device=dev)
    spec = node_types.get("relu")
    return MicrobenchSample(
        op="__chain__", dims_bucket=dims_bucket({"n": n}), pf=1,
        precision="float32", exec_mode="chain",
        device_class=device_class(dev), wall_us=wall,
        work_cycles=float(depth * spec.cycles({"n": n}, 1)),
        extent=float(depth))


def bench_segments(benches: Sequence[str] = ("bonsai/usps-b",), *,
                   warmup: int = 1, reps: int = 3,
                   device: torch.device | str | None = None
                   ) -> list[MicrobenchSample]:
    """Time whole megakernel segments of compiled Table-I programs on the
    per-sample lane (``exec_mode="megakernel"``: on a card one launch of
    the megakernel at nb = 1 per call), keyed by instruction count."""
    from repro_torch.configs.classical import build
    from repro_torch.core.compiler import MafiaCompiler

    dev = resolve_device(device)
    dc = device_class(dev)
    out: list[MicrobenchSample] = []
    for bench in benches:
        dfg, _, _ = build(bench)
        prog = MafiaCompiler(use_pallas=True, exec_mode="megakernel",
                             device=dev).compile(dfg)
        (gi, spec), = prog.dfg.graph_inputs.items()
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            tuple(spec.shape)).astype(np.float32)).to(dev)
        wall = _time_us(lambda: prog.fn(**{gi: x}), warmup=warmup, reps=reps,
                        device=dev)
        mk = prog.plan.megakernel
        out.append(MicrobenchSample(
            op="__segment__", dims_bucket=dims_bucket(
                {"instrs": mk.n_instrs}), pf=1, precision="float32",
            exec_mode="megakernel", device_class=dc, wall_us=wall,
            work_cycles=float(prog.schedule.total_cycles),
            extent=float(mk.n_instrs)))
    return out


def profile_device(*, quick: bool = True, ops: Sequence[str] | None = None,
                   include_chains: bool = True,
                   include_segments: bool = True,
                   reps: int | None = None,
                   device: torch.device | str | None = None
                   ) -> CalibrationTable:
    """Run the microbenchmark harness on ``device`` (None: the card) and
    return a fresh table.  ``quick=True`` limits each op to two dimension
    sets and three repeats; the full mode sweeps every training set."""
    dev = resolve_device(device)
    reps = reps if reps is not None else (3 if quick else 7)
    table = CalibrationTable(device_class=device_class(dev),
                             meta={"quick": quick, "reps": reps})
    for op in (ops if ops is not None else sorted(_TRAIN_DIMS)):
        for dims in _TRAIN_DIMS[op][: 2 if quick else None]:
            table.samples.append(bench_op(op, dims, reps=reps, device=dev))
    if include_chains:
        for n in ((64, 400) if quick else (64, 400, 1024)):
            for depth in (1, 4):
                table.samples.append(
                    bench_chain(n, depth, reps=reps, device=dev))
    if include_segments:
        benches = ("bonsai/usps-b",) if quick else (
            "bonsai/usps-b", "protonn/usps-b", "bonsai/cifar-b")
        table.samples.extend(bench_segments(benches, reps=reps, device=dev))
    return table


# ----------------------------------------------------------------- fitted model
def _affine_fit(xs: Sequence[float], ys: Sequence[float],
                fallback: tuple[float, float]) -> tuple[float, float]:
    """Nonnegative affine fit ``y ≈ t + s·x`` (least squares, clamped).
    A negative slope (noise on near-constant data) degrades to the mean
    wall time as pure overhead — monotonicity in work is preserved."""
    xs_a, ys_a = np.asarray(xs, float), np.asarray(ys, float)
    if xs_a.size == 0:
        return fallback
    if xs_a.size == 1 or float(np.ptp(xs_a)) == 0.0:
        return (float(ys_a.mean()), 0.0)
    A = np.stack([np.ones_like(xs_a), xs_a], axis=1)
    (t, s), *_ = np.linalg.lstsq(A, ys_a, rcond=None)
    if s < 0.0:
        return (float(ys_a.mean()), 0.0)
    return (max(0.0, float(t)), float(s))


@dataclasses.dataclass
class CalibratedCostModel(EstimatorBank):
    """Measurement-fitted cost bank, drop-in compatible with the analytic
    :class:`EstimatorBank`.

    ``estimators`` keeps the analytic per-op PF-curve coefficients; latency
    magnitudes come from the measured fits:

    * ``lat1_us(op, cycles1)`` — measured PF-1 latency in µs, written into
      ``node.latency1`` after profiling in measured mode;
    * ``latency(op, lat1_us, pf)`` — only the work term above the dispatch
      overhead ``t_op`` rides the PF curve;
    * ``node_us`` / ``chain_us`` / ``segment_us`` — the scheduler-facing
      costs (``simulate``'s ``node_cost`` / ``chain_cost``).

    Ops the table never measured fall back to the global fit.
    """

    device_class: str = ""
    op_fit: dict[str, tuple[float, float]] = dataclasses.field(
        default_factory=dict)                 # op -> (t_us, us_per_cycle)
    global_fit: tuple[float, float] = (0.0, 1.0)
    chain_fit: tuple[float, float] = (0.0, 0.0)   # (launch_us, per_stage_us)
    segment_fit: tuple[float, float] = (0.0, 0.0)  # (launch_us, per_instr_us)
    knobs: dict[str, Any] = dataclasses.field(default_factory=dict)
    table_digest: str = ""
    created_at: float = 0.0                   # source table's creation stamp

    @classmethod
    def fit(cls, table: CalibrationTable,
            bank: EstimatorBank | None = None) -> "CalibratedCostModel":
        bank = bank or default_bank()
        by_op: dict[str, tuple[list[float], list[float]]] = {}
        chain_x: list[list[float]] = []
        chain_y: list[float] = []
        seg_x: list[float] = []
        seg_y: list[float] = []
        for s in table.samples:
            if s.exec_mode == "op":
                xs, ys = by_op.setdefault(s.op, ([], []))
                xs.append(s.work_cycles)
                ys.append(s.wall_us)
            elif s.exec_mode == "chain":
                chain_x.append([1.0, s.extent])
                chain_y.append(s.wall_us)
            elif s.exec_mode == "megakernel":
                seg_x.append(s.extent)
                seg_y.append(s.wall_us)
        all_x = [x for xs, _ in by_op.values() for x in xs]
        all_y = [y for _, ys in by_op.values() for y in ys]
        global_fit = _affine_fit(all_x, all_y, (0.0, 1.0))
        op_fit = {op: _affine_fit(xs, ys, global_fit)
                  for op, (xs, ys) in by_op.items()}
        if chain_x:
            (c0, c1), *_ = np.linalg.lstsq(
                np.asarray(chain_x), np.asarray(chain_y), rcond=None)
            chain_fit = (max(0.0, float(c0)), max(0.0, float(c1)))
            if chain_fit == (0.0, 0.0):
                chain_fit = (float(np.mean(chain_y)), 0.0)
        else:
            chain_fit = (global_fit[0], 0.0)
        segment_fit = _affine_fit(seg_x, seg_y, (global_fit[0], 0.0))
        return cls(
            estimators=dict(bank.estimators),
            device_class=table.device_class,
            op_fit=op_fit, global_fit=global_fit, chain_fit=chain_fit,
            segment_fit=segment_fit, knobs=dict(table.knobs),
            table_digest=table.digest(),
            created_at=float(table.meta.get("created_at", 0.0)))

    # --------------------------------------------------------------- latency
    def _fit_for(self, op: str) -> tuple[float, float]:
        return self.op_fit.get(op, self.global_fit)

    def lat1_us(self, op: str, lat1_cycles: float) -> float:
        t, s = self._fit_for(op)
        return t + s * float(lat1_cycles)

    def latency(self, op: str, latency1: float, pf: int) -> float:
        """``latency1`` is measured µs here; only the work share above the
        dispatch overhead scales with the PF curve."""
        t, _ = self._fit_for(op)
        est = self.estimators[op]
        work = max(0.0, float(latency1) - t)
        return t + (est.aL + est.bL * pf + est.cL / pf) * work

    # ------------------------------------------------------- scheduler costs
    def node_us(self, node: Any, pf: int) -> float:
        t, s = self._fit_for(node.op)
        return t + s * float(node_types.get(node.op).cycles(node.dims, pf))

    def chain_us(self, nodes: Sequence[Any], pfs: Sequence[int]) -> float:
        """One fused-chain launch: the measured launch overhead, a cost per
        stage, and the bottleneck stage's measured streaming work.  A fused
        chain is one launch whatever the PFs."""
        c0, c1 = self.chain_fit
        work = 0.0
        for node, pf in zip(nodes, pfs):
            t, s = self._fit_for(node.op)
            cyc = node_types.get(node.op).cycles(node.dims, pf)
            work = max(work, s * max(0.0, float(cyc) - _FILL))
        return c0 + c1 * len(nodes) + work

    def segment_us(self, n_instrs: int) -> float:
        c0, c1 = self.segment_fit
        return c0 + c1 * float(n_instrs)


# ---------------------------------------------------------------- autotuner
_SPLIT_SWEEP = (256 * 1024, 1024 * 1024, 4 * 1024 * 1024, None)


def autotune_knobs(table: CalibrationTable, *, bench: str = "bonsai/usps-b",
                   reps: int = 3,
                   device: torch.device | str | None = None
                   ) -> CalibrationTable:
    """Sweep ``chain_split_bytes`` on ``device`` (None: the card) and record
    the winner in ``table.knobs`` (with every candidate's µs in
    ``split_sweep_us``).  Each candidate compiles ``bench`` with
    ``use_pallas=True`` and times the per-sample program, whose fused chains
    run on the chain kernel.  Chain cuts never change per-element
    arithmetic, so applying the winner is always safe.  No ``(bb, bn)``
    tiles are swept (see the module docstring)."""
    from repro_torch.configs.classical import build
    from repro_torch.core.compiler import MafiaCompiler

    dev = resolve_device(device)
    if table.device_class != device_class(dev):
        raise ValueError(f"table of {table.device_class!r} cannot be tuned on "
                         f"{device_class(dev)!r}")
    sweep: list[tuple[float | None, float]] = []
    for split in _SPLIT_SWEEP:
        dfg, _, _ = build(bench)
        prog = MafiaCompiler(use_pallas=True, chain_split_bytes=split,
                             device=dev).compile(dfg)
        (gi, spec), = prog.dfg.graph_inputs.items()
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            tuple(spec.shape)).astype(np.float32)).to(dev)
        sweep.append((split, _time_us(lambda: prog.fn(**{gi: x}), warmup=1,
                                      reps=reps, device=dev)))
    best_split, best_us = min(sweep, key=lambda c: c[1])
    table.knobs.update(chain_split_bytes=best_split, split_us=best_us,
                       split_sweep_us=tuple(sweep), autotune_bench=bench)
    return table


# -------------------------------------------------------- in-process default
@functools.lru_cache(maxsize=4)
def _cached_profile(device: torch.device, quick: bool) -> CalibrationTable:
    return profile_device(quick=quick, device=device)


def default_calibration(*, quick: bool = True, store: Any | None = None,
                        autotune: bool = False,
                        device: torch.device | str | None = None
                        ) -> CalibratedCostModel:
    """``device``'s calibrated cost model (None: the card): the table
    published for its device class in ``store``, else a quick profile on
    ``device`` (cached per device in this process), published back to
    ``store``.  With ``autotune=True`` a fresh table also runs
    :func:`autotune_knobs` before publication."""
    dev = resolve_device(device)
    table: CalibrationTable | None = None
    if store is not None:
        table = store.load_calibration(device_class(dev))
    if table is None:
        table = _cached_profile(dev, quick)
        if autotune and "chain_split_bytes" not in table.knobs:
            autotune_knobs(table, device=dev)
        if store is not None:
            store.save_calibration(table)
    return CalibratedCostModel.fit(table)
