"""The port's continuous-batching tier on the megakernel grid lane.

Same contracts as the JAX package's async tier, driven with a fake clock so
every batching decision is deterministic: partial buckets wait for
``batch_wait``, full buckets flush at once, an SLO forces a partial flush,
admission is bounded, an evicted model comes back through its loader, and
two models served side by side answer exactly as the synchronous engine.
"""

import numpy as np
import pytest
import torch

from repro_torch.data.datasets import get_spec, make_dataset
from repro_torch.serve.async_engine import AsyncServeEngine
from repro_torch.serve.classical_engine import ClassicalServeEngine, get_program
from repro_torch.serve.scheduling import QueueFull

torch.set_num_threads(1)

BENCH = "bonsai/usps-b"
KW = dict(exec_mode="megakernel_grid", device="cpu")


def _requests(n):
    _, _, Xte, _ = make_dataset(get_spec("usps-b"), n_train=16, n_test=n)
    return Xte


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _prog():
    return get_program(BENCH, **KW)


def test_partial_bucket_waits_then_flushes():
    clock = FakeClock()
    eng = AsyncServeEngine(clock=clock)
    eng.register_model("m", _prog(), max_batch=16, batch_wait_ms=10.0)
    X = _requests(5)
    for x in X[:3]:
        eng.submit("m", x)
    assert eng.poll() == []
    clock.t = 0.005
    for x in X[3:]:
        eng.submit("m", x)
    assert eng.poll() == []
    clock.t = 0.011
    assert len(eng.poll()) == 5
    assert eng.metrics.batch_occupancy() == 5.0


def test_full_buckets_flush_immediately_in_order():
    eng = AsyncServeEngine(clock=FakeClock())
    eng.register_model("m", _prog(), max_batch=4, batch_wait_ms=1e6)
    for x in _requests(9):
        eng.submit("m", x)
    done = eng.poll()
    assert [r.rid for r in done] == list(range(8))
    assert eng.pending("m") == 1


def test_slo_forces_partial_flush():
    clock = FakeClock()
    eng = AsyncServeEngine(clock=clock)
    eng.register_model("m", _prog(), max_batch=64, slo_ms=20.0,
                       batch_wait_ms=1e6)
    eng.submit("m", _requests(1)[0])
    assert eng.poll() == []
    clock.t = 0.021
    (req,) = eng.poll()
    assert req.latency_s > 0.02 and eng.metrics.slo_misses == 1


def test_admission_bound_and_shape_checks():
    eng = AsyncServeEngine(clock=FakeClock())
    eng.register_model("m", _prog(), queue_limit=2, batch_wait_ms=1e6)
    X = _requests(3)
    eng.submit("m", X[0])
    eng.submit("m", X[1])
    with pytest.raises(QueueFull):
        eng.submit("m", X[2])
    with pytest.raises(ValueError, match="request shape"):
        eng.submit("m", np.zeros(7, np.float32))
    with pytest.raises(KeyError, match="unknown model"):
        eng.submit("ghost", X[0])
    assert len(eng.drain()) == 2


def test_eviction_restores_through_loader():
    eng = AsyncServeEngine(clock=FakeClock(), max_resident=1)
    eng.register_model("a", BENCH, strategy="none", batch_wait_ms=1e6, **KW)
    eng.register_model("b", "protonn/usps-b", strategy="none",
                       batch_wait_ms=1e6, **KW)
    assert eng.resident_models == ("b",) and eng.metrics.evictions == 1
    eng.submit("a", _requests(1)[0])
    assert len(eng.flush("a")) == 1
    assert eng._models["a"].resident
    with pytest.raises(NotImplementedError):
        AsyncServeEngine(artifact_store=object())


def test_two_tenants_answer_like_the_sync_engine():
    X = _requests(20)
    eng = AsyncServeEngine(clock=FakeClock())
    for b in (BENCH, "protonn/usps-b"):
        eng.register_model(b, b, max_batch=8, batch_wait_ms=1e6, **KW)
    for i, x in enumerate(X):
        eng.submit(BENCH if i % 2 else "protonn/usps-b", x)
    done = {(r.model, r.rid): r for r in eng.drain()}
    for b in (BENCH, "protonn/usps-b"):
        sync = ClassicalServeEngine(b, max_batch=8, **KW)
        rows = X[1::2] if b == BENCH else X[0::2]
        for x in rows:
            sync.submit(x)
        want = sync.run_to_completion()
        got = sorted((r for (m, _), r in done.items() if m == b),
                     key=lambda r: r.rid)
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            for k in w.outputs:
                np.testing.assert_array_equal(g.outputs[k], w.outputs[k])
