"""Async multi-tenant serving tier: continuous batching over many programs.

The sync :class:`~repro_torch.serve.classical_engine.ClassicalServeEngine` drains
its queue only when the caller says ``step()`` — fine for offline sweeps,
wrong for a server where requests arrive staggered and each carries a
latency SLO.  This module is the production tier on top of the same batched
forward:

* **Multi-tenant**: many models registered by name, each with its own
  admission queue, SLO deadline, bucket cap and batch mode.  Requests are
  routed by model name; the device is shared.
* **Continuous batching**: :meth:`poll` flushes any *full* bucket
  immediately, and flushes a *partially-empty* bucket as soon as waiting
  longer would either miss the oldest request's SLO deadline (margin = the
  model's expected batch latency) or exceed the model's ``batch_wait`` —
  so occupancy climbs above 1 under staggered arrivals without ever
  trading an unbounded wait for it.
* **Bounded admission**: each model's queue has a limit; a full queue
  rejects at ``submit`` (:class:`~repro_torch.serve.scheduling.QueueFull`) —
  backpressure, not unbounded memory.
* **LRU residency**: at most ``max_resident`` programs keep their compiled
  callables alive.  The least-recently-served model is evicted into the
  persistent artifact store (:class:`~repro_torch.core.artifacts.
  ArtifactStore`) and restored from it on its next request, on the device
  it was served on — a load re-binds callables instead of re-running
  Best-PF.  Without a store it is recompiled through its loader.
* **Metrics**: per-model and engine-wide
  :class:`~repro_torch.serve.metrics.ServeMetrics` — enqueue→complete p50/p99,
  rps, batch occupancy, SLO misses, artifact cache hits/misses.

The scheduling core is deliberately **synchronous and clock-injectable**:
``submit`` / ``poll`` / ``flush`` take an explicit ``now`` and never sleep,
so tests drive deadlines with a fake clock and every decision is
deterministic.  The asyncio surface — ``submit_async`` / ``result`` /
``run`` — is a thin wrapper that owns the wake/sleep bookkeeping; the sync
:class:`ClassicalServeEngine` adapter drives the same core with
``flush(..., force=True)`` and no event loop at all.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable

import numpy as np

from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduling import AdmissionQueue, InferRequest, QueueFull

__all__ = ["AsyncServeEngine", "ModelState"]

_DEFAULT_BATCH_WAIT_S = 0.002   # flush horizon when no SLO is configured


class ModelState:
    """One registered model: program residency + queue + SLO + metrics."""

    def __init__(self, name: str, *, slo_s: float | None, batch_wait_s: float,
                 max_batch: int, mode: str, queue_limit: int | None,
                 loader: Callable[[], Any] | None) -> None:
        self.name = name
        self.slo_s = slo_s
        self.batch_wait_s = batch_wait_s
        self.max_batch = max_batch
        self.mode = mode
        self.queue = AdmissionQueue(queue_limit)
        self.loader = loader          # recompile path when no artifact hits
        self.program: Any | None = None
        self.batched: Any | None = None
        self.art_key: str | None = None   # content-addressed store key
        self.device: Any | None = None    # where the program is served
        self.input_name: str = ""
        self.in_shape: tuple[int, ...] = ()
        self.output_names: tuple[str, ...] = ()
        self.metrics = ServeMetrics()
        self.finished: list[InferRequest] = []   # sync-adapter handoff
        self.last_used = 0                       # engine tick, for LRU
        # rolling estimate of one batched forward's wall time — the SLO
        # margin: flush when deadline - now <= this, or we'd miss it
        self.est_batch_s = 0.0

    @property
    def resident(self) -> bool:
        return self.batched is not None

    def bind(self, program: Any, max_batch: int, mode: str) -> None:
        """Make ``program`` the resident compiled form of this model."""
        gi = program.dfg.graph_inputs
        if len(gi) != 1:
            raise ValueError(
                f"serving engine handles single-input DFGs; got {sorted(gi)}")
        self.program = program
        self.device = program.device
        self.batched = program.batch(max_batch, mode=mode)
        self.input_name = next(iter(gi))
        self.in_shape = gi[self.input_name].shape
        plan = getattr(program, "plan", None)
        self.output_names = (tuple(plan.outputs) if plan is not None
                             else tuple(program.dfg.outputs))


class AsyncServeEngine:
    """Multi-tenant continuous-batching engine (see module docstring).

    ``artifact_store`` enables both halves of persistence: compiles
    through a benchmark name publish artifacts, and LRU eviction parks
    programs there instead of discarding the compile.  ``clock`` is
    injectable for deterministic tests.
    """

    def __init__(self, *, max_resident: int = 8,
                 artifact_store: Any | None = None,
                 queue_limit: int | None = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_resident < 1:
            raise ValueError(f"max_resident must be >= 1, got {max_resident}")
        self.max_resident = max_resident
        self.artifact_store = artifact_store
        self.queue_limit = queue_limit
        self.clock = clock
        self.metrics = ServeMetrics()        # engine-wide aggregate
        self._models: dict[str, ModelState] = {}
        self._next_rid = 0
        self._tick = 0                       # LRU counter
        self._running = False
        self._wake: asyncio.Event | None = None

    # ----------------------------------------------------------- registration
    def register_model(
        self,
        name: str,
        program: Any,
        *,
        slo_ms: float | None = None,
        batch_wait_ms: float | None = None,
        max_batch: int = 64,
        mode: str = "vmap",
        queue_limit: int | None = None,
        **compile_kw: Any,
    ) -> ModelState:
        """Register ``program`` under ``name``.

        ``program`` is a :class:`~repro_torch.core.compiler.CompiledProgram` or a
        benchmark name resolved through
        :func:`~repro_torch.serve.classical_engine.get_program` (compile knobs,
        ``device`` included, in ``**compile_kw``; the engine's artifact
        store is passed through).  ``slo_ms`` is the per-request deadline; a partially-empty
        bucket flushes early rather than miss it.  ``batch_wait_ms`` caps
        how long the oldest request waits for its bucket to fill (default:
        ``slo/4``, or 2 ms without an SLO).
        """
        from repro_torch.core.compiler import CompiledProgram

        if name in self._models:
            raise ValueError(f"model {name!r} already registered")
        slo_s = None if slo_ms is None else slo_ms / 1e3
        if batch_wait_ms is not None:
            wait_s = batch_wait_ms / 1e3
        elif slo_s is not None:
            wait_s = slo_s / 4
        else:
            wait_s = _DEFAULT_BATCH_WAIT_S
        loader: Callable[[], Any] | None = None
        if isinstance(program, CompiledProgram):
            if compile_kw:
                raise TypeError("compile kwargs only apply when passing a "
                                "benchmark name")
            prog = program
        else:
            bench = program
            store = self.artifact_store

            def loader() -> Any:
                from repro_torch.serve.classical_engine import get_program

                return get_program(bench, artifact_store=store, **compile_kw)

            prog = loader()
        state = ModelState(
            name, slo_s=slo_s, batch_wait_s=wait_s, max_batch=max_batch,
            mode=mode,
            queue_limit=self.queue_limit if queue_limit is None
            else queue_limit,
            loader=loader)
        self._models[name] = state
        self._make_resident(state, prog)
        return state

    @property
    def models(self) -> tuple[str, ...]:
        return tuple(self._models)

    @property
    def resident_models(self) -> tuple[str, ...]:
        return tuple(n for n, m in self._models.items() if m.resident)

    def _model(self, name: str) -> ModelState:
        try:
            return self._models[name]
        except KeyError:
            raise KeyError(f"unknown model {name!r}; registered: "
                           f"{sorted(self._models)}") from None

    # -------------------------------------------------------------- residency
    def _make_resident(self, state: ModelState, prog: Any) -> None:
        state.bind(prog, state.max_batch, state.mode)
        if self.artifact_store is not None and state.art_key is None:
            from repro_torch.core import artifacts

            state.art_key = artifacts.program_self_key(prog)
        state.last_used = self._tick
        self._evict_over_budget(keep=state.name)

    def _evict_over_budget(self, *, keep: str) -> None:
        resident = [m for m in self._models.values() if m.resident]
        while len(resident) > self.max_resident:
            victim = min(
                (m for m in resident if m.name != keep),
                key=lambda m: m.last_used, default=None)
            if victim is None:
                return
            self.evict(victim.name)
            resident.remove(victim)

    def evict(self, name: str) -> None:
        """Drop ``name``'s compiled callables; park the program in the
        artifact store (if any) so restoring it skips Best-PF."""
        state = self._model(name)
        if not state.resident:
            return
        if (self.artifact_store is not None and state.art_key is not None
                and not self.artifact_store.contains(state.art_key)):
            self.artifact_store.save(state.art_key, state.program)
        state.program = None
        state.batched = None
        state.metrics.evictions += 1
        self.metrics.evictions += 1

    def _ensure_resident(self, state: ModelState) -> None:
        if state.resident:
            state.last_used = self._tick
            return
        prog = None
        if self.artifact_store is not None and state.art_key is not None:
            prog = self.artifact_store.load(state.art_key, state.device)
            for m in (state.metrics, self.metrics):
                if prog is not None:
                    m.cache_hits += 1
                else:
                    m.cache_misses += 1
        if prog is None:
            if state.loader is None:
                raise RuntimeError(
                    f"model {state.name!r} was evicted and has no loader "
                    f"or artifact to restore from")
            prog = state.loader()
        self._make_resident(state, prog)

    # -------------------------------------------------------------- admission
    def submit(self, model: str, x: np.ndarray, *,
               now: float | None = None) -> InferRequest:
        """Enqueue one request; raises
        :class:`~repro_torch.serve.scheduling.QueueFull` when the model's
        admission queue is at its bound."""
        state = self._model(model)
        x = np.asarray(x, np.float32)
        if x.shape != state.in_shape:
            raise ValueError(
                f"request shape {x.shape} != program input {state.in_shape}")
        t = self.clock() if now is None else now
        req = InferRequest(
            self._next_rid, x, model=model, t_submit=t,
            deadline=None if state.slo_s is None else t + state.slo_s)
        try:
            state.queue.push(req)
        except QueueFull:
            state.metrics.rejected += 1
            self.metrics.rejected += 1
            raise
        self._next_rid += 1
        return req

    def pending(self, model: str | None = None) -> int:
        if model is not None:
            return len(self._model(model).queue)
        return sum(len(m.queue) for m in self._models.values())

    # ------------------------------------------------------------- scheduling
    def flush(self, model: str, n: int | None = None) -> list[InferRequest]:
        """Drain up to ``n`` (default: one full bucket) queued requests of
        ``model`` through one batched forward.  The device path is exactly
        the sync engine's: stack → pad-to-bucket → batched forward → scatter."""
        state = self._model(model)
        if not state.queue:
            return []
        self._tick += 1
        self._ensure_resident(state)
        batch = state.queue.take(state.max_batch if n is None else n)
        X = np.stack([r.x for r in batch])
        t0 = time.perf_counter()
        out = state.batched(**{state.input_name: X})
        out = {k: v.cpu().numpy() for k, v in out.items()}
        dev = time.perf_counter() - t0
        # rolling one-batch latency estimate drives the SLO flush margin
        state.est_batch_s = (dev if state.est_batch_s == 0.0
                             else 0.5 * state.est_batch_s + 0.5 * dev)
        done = self.clock()
        for i, req in enumerate(batch):
            req.outputs = {k: v[i] for k, v in out.items()}
            req.output_names = state.output_names
            req.t_done = done
            missed = req.deadline is not None and done > req.deadline
            for m in (state.metrics, self.metrics):
                m.record_request(done - req.t_submit, t_submit=req.t_submit,
                                 t_done=done, missed_slo=missed)
            state.finished.append(req)
            if req.future is not None and not req.future.done():
                req.future.set_result(req)
        for m in (state.metrics, self.metrics):
            m.record_batch(len(batch), dev)
        return batch

    def poll(self, now: float | None = None, *,
             force: bool = False) -> list[InferRequest]:
        """One continuous-batching round over every model: flush each full
        bucket, plus any partial bucket whose oldest request is *due* —
        its SLO deadline within one estimated batch latency, or its
        ``batch_wait`` exhausted.  ``force`` drains everything."""
        t = self.clock() if now is None else now
        completed: list[InferRequest] = []
        for state in self._models.values():
            while len(state.queue) >= state.max_batch:
                completed.extend(self.flush(state.name))
            if state.queue and (force or state.queue.due(
                    t, margin=state.est_batch_s,
                    max_wait=state.batch_wait_s)):
                completed.extend(self.flush(state.name))
        return completed

    def next_due_in(self, now: float | None = None) -> float | None:
        """Seconds until some model's queue becomes due — the run loop's
        sleep horizon.  None when every queue is empty."""
        t = self.clock() if now is None else now
        horizons = [
            m.queue.next_due_in(t, margin=m.est_batch_s,
                                max_wait=m.batch_wait_s)
            for m in self._models.values()
        ]
        horizons = [h for h in horizons if h is not None]
        return min(horizons) if horizons else None

    def drain(self) -> list[InferRequest]:
        """Synchronously run every queue dry (sync driver / shutdown path)."""
        completed: list[InferRequest] = []
        while self.pending():
            completed.extend(self.poll(force=True))
        return completed

    # ------------------------------------------------------------ async layer
    async def submit_async(self, model: str, x: np.ndarray) -> InferRequest:
        """Enqueue from a coroutine; the returned request carries a future
        resolved at completion (``await engine.result(req)``)."""
        req = self.submit(model, x)
        req.future = asyncio.get_running_loop().create_future()
        if self._wake is not None:
            self._wake.set()
        return req

    async def result(self, req: InferRequest) -> InferRequest:
        """Wait for ``req`` to complete.  Requests submitted via the sync
        path (no future) fall back to polling the ``done`` flag."""
        if req.future is not None:
            return await req.future
        while not req.done:
            await asyncio.sleep(0)
        return req

    async def run(self) -> None:
        """The serving loop: poll, then sleep until the next deadline
        horizon or a new submission wakes it.  Runs until :meth:`stop`."""
        self._running = True
        self._wake = asyncio.Event()
        try:
            while self._running:
                self.poll()
                horizon = self.next_due_in()
                try:
                    if horizon is None:           # idle: wait for a submit
                        await self._wake.wait()
                    elif horizon > 0:
                        await asyncio.wait_for(self._wake.wait(), horizon)
                    else:                         # due now — yield only
                        await asyncio.sleep(0)
                except asyncio.TimeoutError:
                    pass
                self._wake.clear()
        finally:
            self._running = False
            if self.pending():                    # never strand requests
                self.drain()

    def stop(self) -> None:
        self._running = False
        if self._wake is not None:
            self._wake.set()

    # ---------------------------------------------------------------- metrics
    def stats(self) -> dict:
        """Engine-wide + per-model metric snapshots (see
        :meth:`repro_torch.serve.metrics.ServeMetrics.snapshot`)."""
        snap = self.metrics.snapshot()
        snap["models"] = {n: m.metrics.snapshot()
                          for n, m in self._models.items()}
        snap["resident"] = list(self.resident_models)
        return snap
