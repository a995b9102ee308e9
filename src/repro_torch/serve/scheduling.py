"""Shared scheduling primitives for both serving engines.

The token-level transformer engine (:mod:`repro_torch.serve.engine`) and the
classical request engines (:mod:`repro_torch.serve.classical_engine`,
:mod:`repro_torch.serve.async_engine`) used to each carry their own copies of the
same three mechanisms: power-of-two bucket selection, slot/free-list
bookkeeping, and a request queue drained in FIFO order.  This module is the
single home for those primitives, plus the request record and admission
policy the async tier adds:

* :func:`bucket_for` — power-of-two bucket selection with a floor and cap
  (the transformer engine buckets prompt lengths from 8 up to ``max_len``;
  the classical engines bucket batch sizes from 1 up to ``max_batch``).
* :class:`SlotPool` — boolean slot occupancy with a free list, the decode
  engine's slot array.
* :class:`InferRequest` — one classification request.  Carries the
  submit/complete timestamps and the per-model SLO deadline the async
  engine schedules against; the sync engine leaves those at their defaults.
* :class:`AdmissionQueue` — bounded FIFO with deadline bookkeeping:
  ``push`` enforces the admission limit (:class:`QueueFull` on overflow),
  ``take`` drains in arrival order, and ``due`` answers the continuous
  batching question "must a partially-empty bucket flush *now* to meet the
  oldest request's deadline?".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np

__all__ = ["bucket_for", "SlotPool", "InferRequest", "AdmissionQueue",
           "QueueFull"]


def bucket_for(n: int, cap: int, *, floor: int = 1) -> int:
    """Smallest power-of-two ≥ ``n`` within ``[floor, cap]``.

    Power-of-two bucketing is what bounds jit recompiles: arbitrary sizes
    touch only ``log2(cap / floor) + 1`` compiled shapes."""
    if n < 1:
        raise ValueError("empty batch")
    b = floor
    while b < n:
        b *= 2
    return min(b, cap)


class SlotPool:
    """Boolean slot occupancy over a fixed capacity.

    ``flags`` is the raw numpy mask — the decode engine indexes it directly
    as the per-slot active mask of its batched decode step."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.flags = np.zeros(capacity, bool)

    def __len__(self) -> int:
        return len(self.flags)

    def free(self) -> list[int]:
        """Indices of unoccupied slots, ascending."""
        return [i for i in range(len(self.flags)) if not self.flags[i]]

    def acquire(self, slot: int) -> None:
        if self.flags[slot]:
            raise ValueError(f"slot {slot} already occupied")
        self.flags[slot] = True

    def release(self, slot: int) -> None:
        self.flags[slot] = False

    @property
    def any_active(self) -> bool:
        return bool(self.flags.any())


@dataclasses.dataclass
class InferRequest:
    """One classification request: a feature vector in, DFG outputs back.

    ``output_names`` is the serving program's *declared* output order
    (``CompiledProgram.dfg.outputs``) — :attr:`pred` resolves the class
    prediction against it, so multi-output DFGs are unambiguous.  The async
    engine additionally stamps ``t_submit``/``t_done`` (enqueue→complete
    latency) and ``deadline`` (the per-model SLO); the sync engine leaves
    them at their defaults.
    """

    rid: int
    x: np.ndarray
    outputs: dict[str, np.ndarray] | None = None
    output_names: tuple[str, ...] | None = None
    model: str = "default"
    t_submit: float = 0.0
    t_done: float | None = None
    deadline: float | None = None
    future: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def done(self) -> bool:
        return self.outputs is not None

    @property
    def latency_s(self) -> float | None:
        """Enqueue→complete wall time, once finished (async engine only)."""
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def pred(self) -> int | None:
        """Predicted class, resolved against the program's declared outputs.

        The DFG's argmax output is an *integer* output; a multi-output
        program may publish several (or none).  Resolution is therefore by
        the program's declared output-name order (``output_names``, the
        order of ``dfg.outputs``): the first integer-dtype output in
        declared order is the class prediction.  Fallback, documented: a
        program with no integer output yields the argmax over its *first
        declared* output (the score vector, for every Table-I benchmark).
        When the engine predates ``output_names`` the dict's insertion
        order — which the batched forward builds in declared order — is
        used instead.
        """
        if self.outputs is None:
            return None
        names = [n for n in (self.output_names or tuple(self.outputs))
                 if n in self.outputs]
        if not names:
            return None
        for name in names:
            v = np.asarray(self.outputs[name])
            if np.issubdtype(v.dtype, np.integer):
                return int(v.ravel()[0])
        return int(np.asarray(self.outputs[names[0]]).argmax())


class QueueFull(RuntimeError):
    """Raised by :meth:`AdmissionQueue.push` when the bound is hit — the
    admission-control signal callers turn into backpressure (reject or
    retry-later)."""


class AdmissionQueue:
    """Bounded FIFO of :class:`InferRequest` with deadline bookkeeping."""

    def __init__(self, limit: int | None = None) -> None:
        if limit is not None and limit < 1:
            raise ValueError(f"queue limit must be >= 1, got {limit}")
        self.limit = limit
        self._items: list[InferRequest] = []
        self.rejected = 0                 # pushes refused by the bound

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def push(self, req: InferRequest) -> None:
        if self.limit is not None and len(self._items) >= self.limit:
            self.rejected += 1
            raise QueueFull(
                f"admission queue full ({self.limit} pending requests)")
        self._items.append(req)

    def take(self, n: int) -> list[InferRequest]:
        """Drain up to ``n`` requests in arrival order."""
        batch, self._items = self._items[:n], self._items[n:]
        return batch

    def oldest(self) -> InferRequest | None:
        return self._items[0] if self._items else None

    def due(self, now: float, *, margin: float = 0.0,
            max_wait: float | None = None) -> bool:
        """Must the queue flush *now*?  True when the oldest request's SLO
        deadline is within ``margin`` seconds (the expected batch latency —
        waiting longer would miss it), or when it has already waited
        ``max_wait`` seconds for the bucket to fill (continuous refill:
        a partially-empty bucket never waits unboundedly)."""
        head = self.oldest()
        if head is None:
            return False
        if head.deadline is not None and head.deadline - now <= margin:
            return True
        return max_wait is not None and now - head.t_submit >= max_wait

    def next_due_in(self, now: float, *, margin: float = 0.0,
                    max_wait: float | None = None) -> float | None:
        """Seconds until :meth:`due` flips True, or None for an empty
        queue — the async loop's sleep horizon."""
        head = self.oldest()
        if head is None:
            return None
        horizons: list[float] = []
        if head.deadline is not None:
            horizons.append(head.deadline - margin - now)
        if max_wait is not None:
            horizons.append(head.t_submit + max_wait - now)
        return max(0.0, min(horizons)) if horizons else 0.0
