"""Fault-tolerance machinery: elastic re-mesh, preemption save, stragglers.

Designed for 1000+ node fleets; everything that can be exercised without
real hardware is implemented and unit-tested here (mesh refactorization,
policy logic, signal-driven save); the pieces that need a real control
plane (health probes, task restart) are documented hooks.

* **Elastic re-mesh** — after a failure, the job restarts on however many
  hosts survive.  :func:`elastic_mesh_shape` refactorizes the surviving
  device count into the closest (pod, data, model) grid (model axis
  preserved when possible — TP degree is baked into weight layouts far less
  than DP is), and checkpoint restore resharding (:mod:`.checkpoint`) moves
  the state onto the new mesh.  No resharding code is arch-specific.

* **Preemption save** — :class:`PreemptionHandler` hooks SIGTERM/SIGINT; the
  train loop polls ``should_save`` and writes a final checkpoint inside the
  grace window.

* **Straggler mitigation** — :class:`StragglerPolicy` implements
  deadline-based backup dispatch: it tracks a robust step-time estimate
  (EMA of median) and flags a step whose wall time exceeds
  ``factor × estimate``; the runner's reaction (re-dispatching the
  microbatch to a hot spare, or excluding the slow host at the next
  re-mesh) is a control-plane hook.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import statistics
from typing import Any

__all__ = ["elastic_mesh_shape", "PreemptionHandler", "StragglerPolicy"]


def elastic_mesh_shape(
    n_devices: int,
    *,
    prefer_model: int = 16,
    min_model: int = 4,
) -> tuple[dict[str, int], int]:
    """Best (pod, data, model) grid for ``n_devices`` surviving devices.

    Keeps the model axis at ``prefer_model`` when it divides the fleet;
    otherwise walks down through divisors (≥ ``min_model``).  Returns
    (axis dict, devices used) — devices beyond the grid are left idle
    (reported, so the control plane can schedule them as hot spares).
    """
    if n_devices < 1:
        raise ValueError("no devices")
    model = prefer_model
    while model > min_model and (n_devices % model or n_devices // model == 0):
        model //= 2
    if n_devices < model:
        model = 1 << int(math.floor(math.log2(n_devices)))
        model = max(1, model)
    rest = n_devices // model
    # split rest into pod × data: pods of ≤16 data groups
    pod = 1
    data = rest
    for cand in (16, 8, 4, 2):
        if rest % cand == 0 and rest // cand > 1:
            data, pod = cand, rest // cand
            break
    used = pod * data * model
    axes = {"pod": pod, "data": data, "model": model}
    if pod == 1:
        axes = {"data": data, "model": model}
    return axes, used


class PreemptionHandler:
    """SIGTERM/SIGINT → request a final checkpoint before the kill."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)) -> None:
        self._requested = False
        self._old = {}
        for s in signals:
            try:
                self._old[s] = signal.signal(s, self._on_signal)
            except ValueError:       # not in main thread (tests)
                pass

    def _on_signal(self, signum, frame) -> None:
        self._requested = True

    @property
    def should_save(self) -> bool:
        return self._requested

    def restore(self) -> None:
        for s, h in self._old.items():
            signal.signal(s, h)


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based backup dispatch decision.

    ``observe(step_time)`` returns True when the step blew through the
    deadline (estimate × ``factor``) — the caller should re-dispatch that
    microbatch to a backup and/or mark the host suspect.  ``suspects``
    counts consecutive flags; ``should_exclude`` recommends dropping the
    host at the next elastic re-mesh.
    """

    factor: float = 2.0
    warmup: int = 5
    exclude_after: int = 3
    _history: list = dataclasses.field(default_factory=list)
    _consecutive: int = 0

    def estimate(self) -> float | None:
        if len(self._history) < self.warmup:
            return None
        return statistics.median(self._history[-50:])

    def observe(self, step_time: float) -> bool:
        est = self.estimate()
        flagged = est is not None and step_time > self.factor * est
        # slow steps do not poison the estimate (median of recent history)
        self._history.append(step_time)
        if flagged:
            self._consecutive += 1
        else:
            self._consecutive = 0
        return bool(flagged)

    @property
    def should_exclude(self) -> bool:
        return self._consecutive >= self.exclude_after

    def state(self) -> dict[str, Any]:
        return {"history": list(self._history[-50:]),
                "consecutive": self._consecutive}
