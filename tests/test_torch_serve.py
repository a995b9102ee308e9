"""The whole slice on the CPU: a Table-I name into the port's serving
engine, one megakernel step per bucket, predictions out — held against the
JAX package's ``interpret`` lane on the same inputs and weights.

Float32 outputs agree to ``rtol=atol=1e-5``; the fixed-point lanes agree bit
for bit on their outputs (at most 1 LSB where a float PE sits between a
dequantize and a requantize) and exactly on the predictions.  Inside the
port the three megakernel lanes — per sample, bucket on the grid, and the
``map`` batch mode — are bitwise equal.

The second path, ``use_pallas=True`` on the ``interpret`` lane, runs each
fused §IV-G chain as one chain-kernel step per bucket; it is held against
the reference engine with the same knobs under the same tolerances.
"""

import numpy as np
import pytest
import torch

from repro.serve.classical_engine import get_program as jget
from repro_torch.kernels import megakernel as tmk
from repro_torch.serve.classical_engine import ClassicalServeEngine, get_program

torch.set_num_threads(1)

BENCHES = ["bonsai/usps-b", "protonn/usps-b"]
N_REQ = 100


def _requests(bench, n, seed=0):
    prog = get_program(bench, device="cpu")
    (spec,) = prog.dfg.graph_inputs.values()
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + tuple(spec.shape)).astype(np.float32)


@pytest.mark.parametrize("precision", ["float32", "int8", "int16"])
@pytest.mark.parametrize("bench", BENCHES)
def test_engine_serves_like_reference_interpret_lane(bench, precision):
    X = _requests(bench, N_REQ)
    eng = ClassicalServeEngine(bench, exec_mode="megakernel_grid", max_batch=32,
                               precision=precision, device="cpu")
    for x in X:
        eng.submit(x)
    done = eng.run_to_completion()
    assert [r.rid for r in done] == sorted(r.rid for r in done)
    assert len(done) == N_REQ and eng.served == N_REQ
    assert eng.batched.stats == {32: 3, 4: 1}

    ref = jget(bench, precision=precision).batch(32, mode="vmap")(x=X)
    out_exp = None
    if precision != "float32":
        out_exp = eng.program.plan.output_exps
    for name, want in ref.items():
        want = np.asarray(want)
        got = np.stack([np.asarray(r.outputs[name]) for r in done])
        assert got.dtype == want.dtype and got.shape == want.shape
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        elif precision == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            lsb = 2.0 ** -out_exp[name]
            assert np.abs(got - want).max() <= lsb
    preds = np.array([r.pred for r in done])
    np.testing.assert_array_equal(preds, np.asarray(ref["Pred"]).reshape(-1))


@pytest.mark.parametrize("precision", ["float32", "int8", "int16"])
@pytest.mark.parametrize("bench", BENCHES)
def test_megakernel_lanes_bitwise(bench, precision):
    X = _requests(bench, 11, seed=4)
    prog = get_program(bench, precision=precision,
                       exec_mode="megakernel_grid", device="cpu")
    grid = prog.batch(8)(x=X)
    per_sample = prog.batch(8, exec_mode="megakernel")(x=X)
    mapped = prog.batch(8, mode="map")(x=X)
    single = [prog(x=x) for x in X]
    for k, v in grid.items():
        assert torch.equal(v, per_sample[k]) and torch.equal(v, mapped[k])
        assert torch.equal(v, torch.stack([s[k] for s in single]))


def test_grid_lane_is_one_step_per_bucket(monkeypatch):
    """The serving path runs the whole program as one megakernel step per
    bucket: one segment, no interpreted island, one call per bucket."""
    from repro_torch.kernels import ref

    prog = get_program("bonsai/usps-b", exec_mode="megakernel_grid",
                       device="cpu")
    mk = prog.plan.megakernel
    assert len(mk.segments) == 1 and mk.n_islands == 0
    calls, orig = [], ref._segment_rows
    launched = tmk.LAUNCHES["megakernel"]

    def counting(seg, xs):
        calls.append(int(xs[0].shape[0]))
        return orig(seg, xs)

    monkeypatch.setattr(ref, "_segment_rows", counting)
    prog.batch(16)(x=_requests("bonsai/usps-b", 40))
    assert calls == [16, 16, 8]
    assert tmk.LAUNCHES["megakernel"] == launched   # CPU: plain version only


def test_default_device_is_the_card():
    """No device and no card: entry points refuse instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_program("protonn/usps-b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ClassicalServeEngine("protonn/usps-b", exec_mode="megakernel_grid")


def test_get_program_store_in_the_cache_key(tmp_path):
    """The store's root is part of ``get_program``'s key: one store and its
    absence give distinct programs, the same root the cached one; a fresh
    process (emptied cache) loads the published artifact, equal bitwise."""
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.serve import classical_engine as ce

    kw = dict(exec_mode="megakernel_grid", precision="int8", device="cpu")
    s1, s2 = ArtifactStore(tmp_path / "one"), ArtifactStore(tmp_path / "two")
    plain = get_program("protonn/usps-b", **kw)
    p1 = get_program("protonn/usps-b", artifact_store=s1, **kw)
    assert p1 is not plain and s1.saves == 1 and s1.misses == 1
    assert get_program("protonn/usps-b", artifact_store=s1, **kw) is p1
    assert get_program("protonn/usps-b",
                       artifact_store=ArtifactStore(tmp_path / "one"),
                       **kw) is p1
    p2 = get_program("protonn/usps-b", artifact_store=s2, **kw)
    assert p2 is not p1 and s2.saves == 1
    X = _requests("protonn/usps-b", 8)
    want = p1.batch(8)(x=X)
    ce.clear_program_cache()
    back = get_program("protonn/usps-b", artifact_store=s1, **kw)
    assert back.pf_source == "artifact" and s1.hits == 1
    for k, v in back.batch(8)(x=X).items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("precision", ["float32", "int8"])
@pytest.mark.parametrize("bench", BENCHES)
def test_use_pallas_engine_serves_like_reference(bench, precision):
    X = _requests(bench, 64, seed=1)
    eng = ClassicalServeEngine(bench, use_pallas=True, exec_mode="interpret",
                               max_batch=32, precision=precision, device="cpu")
    for x in X:
        eng.submit(x)
    done = eng.run_to_completion()
    assert len(done) == 64 and eng.batched.stats == {32: 2}
    ref = jget(bench, precision=precision, use_pallas=True,
               exec_mode="interpret").batch(32, mode="vmap")(x=X)
    for name, want in ref.items():
        want = np.asarray(want)
        got = np.stack([np.asarray(r.outputs[name]) for r in done])
        assert got.dtype == want.dtype and got.shape == want.shape
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        elif precision == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            lsb = 2.0 ** -eng.program.plan.output_exps[name]
            assert np.abs(got - want).max() <= lsb
    np.testing.assert_array_equal(np.array([r.pred for r in done]),
                                  np.asarray(ref["Pred"]).reshape(-1))


@pytest.mark.parametrize("precision", ["float32", "int8"])
@pytest.mark.parametrize("bench", BENCHES)
def test_use_pallas_lanes(bench, precision, monkeypatch):
    """One chain step per chain per bucket on the batched lane.  ``map``
    is bitwise with per-sample calls; the batched lane is bitwise with the
    per-node walk of the same program (a fused chain computes what its
    members compute) and, on the integer lane, with per-sample calls.  At
    float32 the batched lane's non-chain templates sum in another order
    than per-sample calls, as in the ``use_pallas=False`` interpret lane."""
    from repro_torch.core import executor

    X = _requests(bench, 11, seed=4)
    prog = get_program(bench, precision=precision, use_pallas=True,
                       device="cpu")
    per_node = get_program(bench, precision=precision, device="cpu")
    n_chains = sum(type(s).__name__ == "ChainStep" for s in prog.plan.steps)
    assert n_chains == (2 if bench.startswith("bonsai") else 1)
    rows, orig = [], executor.run_chain
    monkeypatch.setattr(executor, "run_chain",
                        lambda c, x, e: rows.append(x.shape[0]) or orig(c, x, e))
    batched = prog.batch(8)(x=X)
    assert rows == [8] * n_chains + [4] * n_chains      # buckets of 8 and 4
    monkeypatch.setattr(executor, "run_chain", orig)
    mapped = prog.batch(8, mode="map")(x=X)
    single = [prog(x=x) for x in X]
    unfused = per_node.batch(8)(x=X)
    for k, v in batched.items():
        s = torch.stack([o[k] for o in single])
        assert torch.equal(mapped[k], s)
        assert torch.equal(v, unfused[k])
        if precision == "float32":
            torch.testing.assert_close(v, s, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(v, s)
