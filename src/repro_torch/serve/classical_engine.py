"""Batched serving engine for compiled classical MAFIA programs.

Classical inference (Bonsai / ProtoNN, paper §V-A) is single-shot: here the
enqueue→batch→drain design batches whole *requests* — ``submit()`` queues a
feature vector, ``step()`` drains up to ``max_batch`` queued requests,
stacks them, pads the stack to the program's power-of-two bucket, runs one
batched forward through the compiled DFG
(:meth:`repro_torch.core.compiler.CompiledProgram.batch`), and scatters the
per-request outputs back.

:class:`ClassicalServeEngine` is the **synchronous adapter** over the
multi-tenant continuous-batching core
(:class:`repro_torch.serve.async_engine.AsyncServeEngine`): it registers one
model and drives forced bucket flushes, so its device path — and therefore
its outputs, bitwise — is exactly the async tier's.

Programs are cached per ``(benchmark, trained, seed, backend, strategy,
metric, pipelining, use_pallas, precision, per_channel, chain_split_bytes,
exec_mode, device, artifact-store root)``; the cache is thread-safe with single-flight
compilation: concurrent ``get_program`` calls for the same key produce one
compile.

``exec_mode="megakernel_grid"`` serves each bucket through one launch of the
CUDA megakernel (the whole linearized program, the bucket on the grid) —
the serving-path realization of MAFIA's whole-program compilation claim.
``precision="int8"`` (or ``"int16"``) serves the fixed-point program,
calibrated from the benchmark's training split; requests still carry float
feature vectors.  ``device`` is where programs run: the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from repro_torch.configs.classical import ClassicalBenchmark, build, training_split
from repro_torch.core.compiler import BatchedProgram, CompiledProgram, MafiaCompiler
from repro_torch.core.device import default_device, resolve_device
from repro_torch.core.lowering import DEFAULT_CHAIN_SPLIT_BYTES
from repro_torch.serve.scheduling import InferRequest

_CALIB_SAMPLES = 256     # training-split rows used for int8 scale calibration

__all__ = ["ClassicalServeEngine", "InferRequest", "get_program",
           "clear_program_cache"]


# ----------------------------------------------------------- program cache
_PROGRAM_CACHE: dict[tuple, CompiledProgram] = {}
_CACHE_LOCK = threading.Lock()
# single-flight: key -> Event set when that key's compile finishes (either
# into the cache, or by failing — waiters re-check and may retry as leader)
_IN_FLIGHT: dict[tuple, threading.Event] = {}


def get_program(
    bench: ClassicalBenchmark | str,
    *,
    trained: bool = False,
    seed: int = 0,
    backend: str = "fpga",
    strategy: str = "greedy",
    metric: str = "latency_per_lut",
    pipelining: bool | str = True,
    use_pallas: bool = False,
    precision: str = "float32",
    per_channel: bool = False,
    chain_split_bytes: float | None = DEFAULT_CHAIN_SPLIT_BYTES,
    exec_mode: str = "interpret",
    device: torch.device | str | None = None,
    artifact_store: Any | None = None,
) -> CompiledProgram:
    """Compile (or fetch from cache) one classical benchmark program.

    ``build()`` is deterministic given ``(bench, trained, seed)`` and the
    compiler is deterministic given its knobs, so the tuple of all the
    arguments — ``device`` included — keys the cache exactly.  With a
    fixed-point ``precision`` the scales are calibrated from the
    benchmark's seeded training split.  Thread-safe, with single-flight
    compiles; a failed leader lets one waiter retry.

    ``artifact_store`` (a :class:`repro_torch.core.artifacts.ArtifactStore`)
    goes to the compiler: a cache miss consults the store before the
    Best-PF search and publishes its result.  The store's root is part of
    the cache key.
    """
    name = bench if isinstance(bench, str) else bench.name
    dev = resolve_device(device)
    key = (name, trained, seed, backend, strategy, metric, pipelining,
           use_pallas, precision, per_channel, chain_split_bytes, exec_mode,
           str(dev), None if artifact_store is None else str(artifact_store.root))
    while True:
        with _CACHE_LOCK:
            prog = _PROGRAM_CACHE.get(key)
            if prog is not None:
                return prog
            event = _IN_FLIGHT.get(key)
            if event is None:
                event = _IN_FLIGHT[key] = threading.Event()
                leader = True
            else:
                leader = False
        if not leader:
            event.wait()
            continue
        try:
            with default_device(dev):     # trained=True trains on dev
                dfg, _, _ = build(bench, trained=trained, seed=seed)
            calib = None
            if precision != "float32":   # fixed-point lanes (int8 / int16)
                Xtr, _ = training_split(bench, seed=seed)
                calib = Xtr[:_CALIB_SAMPLES]
            compiler = MafiaCompiler(
                backend=backend, strategy=strategy, metric=metric,
                pipelining=pipelining, use_pallas=use_pallas,
                precision=precision, per_channel=per_channel,
                chain_split_bytes=chain_split_bytes, exec_mode=exec_mode,
                artifact_store=artifact_store, device=dev)
            prog = compiler.compile(dfg, calib=calib)
            with _CACHE_LOCK:
                _PROGRAM_CACHE[key] = prog
            return prog
        finally:
            with _CACHE_LOCK:
                _IN_FLIGHT.pop(key, None)
            event.set()


def clear_program_cache() -> None:
    with _CACHE_LOCK:
        _PROGRAM_CACHE.clear()


# ------------------------------------------------------------------- engine
class ClassicalServeEngine:
    """Request-batching inference server over one compiled classical program.

    ``program`` is a :class:`CompiledProgram`, or a benchmark name like
    ``"bonsai/usps-b"`` resolved through the program cache (compile knobs
    pass through ``**compile_kw`` — e.g. ``precision="int8"``,
    ``exec_mode="megakernel_grid"``, ``device="cpu"``).  ``mode`` picks the
    batched execution strategy: ``"vmap"`` (the batched lane) or ``"map"``
    (per-sample, bitwise identical to one call per request).
    """

    def __init__(
        self,
        program: CompiledProgram | ClassicalBenchmark | str,
        *,
        max_batch: int = 64,
        mode: str = "vmap",
        **compile_kw: Any,
    ) -> None:
        from repro_torch.serve.async_engine import AsyncServeEngine

        if not isinstance(program, (CompiledProgram, str)):
            program = program.name      # ClassicalBenchmark spec
        self._core = AsyncServeEngine()
        self._model = self._core.register_model(
            "default", program, max_batch=max_batch, mode=mode, **compile_kw)
        self.program: CompiledProgram = self._model.program
        self.batched: BatchedProgram = self._model.batched
        self.max_batch = max_batch
        self._input_name = self._model.input_name
        self._in_shape = self._model.in_shape

    # --------------------------------------------------------- bookkeeping
    def submit(self, x: np.ndarray) -> int:
        return self._core.submit("default", x).rid

    @property
    def pending(self) -> int:
        return len(self._model.queue)

    @property
    def device_s(self) -> float:
        """Wall-clock spent in batched forwards."""
        return self._model.metrics.device_s

    @property
    def served(self) -> int:
        return self._model.metrics.served

    # ----------------------------------------------------------------- step
    def step(self) -> dict[int, InferRequest]:
        """Drain up to ``max_batch`` queued requests through one batched
        forward.  Returns {request id: finished request}."""
        return {r.rid: r for r in self._core.flush("default")}

    # --------------------------------------------------------------- driver
    def run_to_completion(self) -> list[InferRequest]:
        """Drain the queue; returns the finished requests in submission
        order, each exactly once."""
        while self._model.queue:
            self.step()
        done, self._model.finished = self._model.finished, []
        return sorted(done, key=lambda r: r.rid)

    def reset_stats(self) -> None:
        """Zero the throughput counters and per-bucket forward counts."""
        self._model.metrics.reset()
        self._core.metrics.reset()
        self.batched.stats.clear()

    def metrics(self) -> dict:
        """Latency/occupancy snapshot of the underlying serving core."""
        return self._model.metrics.snapshot()

    def throughput(self) -> float:
        """Requests/sec over the batched forwards issued so far."""
        return self._model.metrics.device_rps()
