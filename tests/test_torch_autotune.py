"""The port's profile-guided compilation, held against the JAX package's.

The contracts of the JAX package's own tests (persistence round-trips,
device-class gating, version invalidation, the analytic fallback, the
staleness gate, outputs bitwise identical across cost sources), run here on
the CPU where the harness times the plain versions; and parity: one
hand-built table of samples fits to the JAX package's coefficients
(``rtol 1e-12``) and, stamped with each package's own ``device_class()``,
compiles in measured mode to the JAX package's PF assignment and schedule
total.  The card's timings come from ``chip_smoke.py``.
"""

import dataclasses
import time as time_mod
import warnings

import numpy as np
import pytest
import torch

from repro.configs.classical import build as jbuild
from repro.core import autotune as jat
from repro.core.compiler import MafiaCompiler as JCompiler
from repro_torch.configs.classical import build, training_split
from repro_torch.core import artifacts
from repro_torch.core import autotune as at
from repro_torch.core.artifacts import ArtifactError, ArtifactStore
from repro_torch.core.autotune import (
    CalibratedCostModel,
    CalibrationTable,
    MicrobenchSample,
    bench_op,
    device_class,
    dims_bucket,
    profile_device,
)
from repro_torch.core.compiler import MafiaCompiler
from repro_torch.kernels import linear_pipeline as lp

torch.set_num_threads(1)

CPU = "cpu"
_OPS = ("gemv", "add", "relu")


@pytest.fixture(scope="module")
def table():
    return profile_device(quick=True, ops=_OPS, include_segments=False,
                          reps=2, device=CPU)


@pytest.fixture(scope="module")
def model(table):
    return CalibratedCostModel.fit(table)


@pytest.fixture(autouse=True)
def _default_tiles():
    """A table carrying tiles installs them process-wide; start and end
    every test at the built-in tiles."""
    lp.set_tuned_tiles()
    yield
    lp.set_tuned_tiles()


def _compile(bench, **kw):
    dfg, _, _ = build(bench)
    prec = kw.get("precision", "float32")
    calib = None if prec == "float32" else training_split(bench, seed=0)[0][:64]
    return MafiaCompiler(device=CPU, **kw).compile(dfg, calib=calib)


# --------------------------------------------------------------- harness
def test_bench_op_sample_key():
    s = bench_op("add", {"n": 400}, reps=1, warmup=0, device=CPU)
    assert s.op == "add" and s.exec_mode == "op"
    assert s.device_class == device_class(CPU)
    assert s.dims_bucket == dims_bucket({"n": 400}) == (("n", 512),)
    assert s.wall_us > 0 and s.work_cycles > 0


def test_device_class_is_explicit():
    """The class names the device it is asked about: on the CPU
    ``cpu:<machine>``; with no device the card, which must exist."""
    assert device_class(CPU).startswith("cpu:")
    assert device_class(torch.device("cpu")) == device_class(CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            device_class()


def test_profile_device_covers_requested_ops(table):
    ops = {s.op for s in table.samples}
    assert set(_OPS) <= ops
    assert "__chain__" in ops
    assert "__segment__" not in ops
    assert all(s.device_class == table.device_class == device_class(CPU)
               for s in table.samples)


def test_bench_chain_and_segments_sample_keys():
    c = at.bench_chain(64, 4, reps=1, warmup=0, device=CPU)
    assert (c.op, c.exec_mode, c.extent) == ("__chain__", "chain", 4.0)
    (s,) = at.bench_segments(("protonn/usps-b",), reps=1, warmup=0,
                             device=CPU)
    assert (s.op, s.exec_mode) == ("__segment__", "megakernel")
    assert s.extent > 0 and s.wall_us > 0


@pytest.mark.parametrize("op", sorted(at._TRAIN_DIMS))
def test_every_profiled_op_runs_its_template(op):
    """profile_device's full op list: each template runs on its case."""
    s = bench_op(op, at._TRAIN_DIMS[op][0], reps=1, warmup=0, device=CPU)
    assert s.op == op and np.isfinite(s.wall_us) and s.wall_us > 0


# ---------------------------------------------------------- fitted model
def test_calibrated_model_units_and_fallback(table, model):
    from repro_torch.core.cost_model import default_bank

    assert model.device_class == table.device_class
    assert model.table_digest == table.digest()
    assert "gemv" in model.op_fit and "matmul" not in model.op_fit
    assert model._fit_for("matmul") == model.global_fit
    assert model.lat1_us("matmul", 100.0) >= 0.0
    assert model.lat1_us("gemv", 2000.0) >= model.lat1_us("gemv", 100.0)
    assert set(model.estimators) == set(default_bank().estimators)


def test_chain_cost_charges_one_launch(model):
    dfg, _, _ = build("bonsai/usps-b")
    nodes = [n for n in dfg.nodes.values() if n.op in _OPS][:3] or list(
        dfg.nodes.values())[:3]
    one = model.chain_us(nodes[:1], [1])
    three = model.chain_us(nodes[:3], [1, 1, 1])
    assert three < 3 * one


def _samples(cls, dc):
    """One hand-built table's samples, as ``cls`` (either package's)."""
    rng = np.random.default_rng(5)
    out = []
    for op, cycles in (("gemv", (70.0, 406.0, 790.0)), ("add", (70.0, 406.0)),
                       ("relu", (70.0, 518.0)), ("tanh", (38.0,)),
                       ("sq_l2", (150.0, 900.0)), ("exp", (262.0, 38.0))):
        for c in cycles:
            out.append(cls(op=op, dims_bucket=(("n", 64),), pf=1,
                           precision="float32", exec_mode="op",
                           device_class=dc, wall_us=float(8 + rng.random()
                                                          * 4 + c / 300),
                           work_cycles=c))
    for n, depth in ((64, 1), (64, 4), (400, 1), (400, 4)):
        out.append(cls(op="__chain__", dims_bucket=(("n", n),), pf=1,
                       precision="float32", exec_mode="chain",
                       device_class=dc,
                       wall_us=float(20 + 1.5 * depth + rng.random()),
                       work_cycles=float(depth * (n + 6)), extent=float(depth)))
    for instrs in (24.0, 31.0, 41.0):
        out.append(cls(op="__segment__", dims_bucket=(("instrs", 32),), pf=1,
                       precision="float32", exec_mode="megakernel",
                       device_class=dc, wall_us=float(60 + instrs
                                                      + rng.random()),
                       work_cycles=2000.0, extent=instrs))
    return out


def _tables(stamp=None):
    """The hand-built table in each package, stamped with its own
    ``device_class()`` (or ``stamp``) and one creation time."""
    now = time_mod.time()
    tdc = stamp or device_class(CPU)
    jdc = stamp or jat.device_class()
    t = CalibrationTable(device_class=tdc, samples=_samples(MicrobenchSample,
                                                            tdc),
                         meta={"created_at": now})
    j = jat.CalibrationTable(device_class=jdc,
                             samples=_samples(jat.MicrobenchSample, jdc),
                             meta={"created_at": now})
    return t, j


def test_fit_matches_the_reference():
    t, j = _tables()
    tm, jm = CalibratedCostModel.fit(t), jat.CalibratedCostModel.fit(j)
    assert tm.op_fit.keys() == jm.op_fit.keys()
    for op in jm.op_fit:
        np.testing.assert_allclose(tm.op_fit[op], jm.op_fit[op], rtol=1e-12)
    for f in ("global_fit", "chain_fit", "segment_fit"):
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f), rtol=1e-12)
    assert tm.estimators.keys() == jm.estimators.keys()
    dfg, _, _ = build("bonsai/usps-b")
    nodes = list(dfg.nodes.values())
    for op in ("gemv", "matmul", "relu", "sq_l2"):
        for c in (10.0, 400.0):
            np.testing.assert_allclose(tm.lat1_us(op, c), jm.lat1_us(op, c),
                                       rtol=1e-12)
            for pf in (1, 4):
                np.testing.assert_allclose(tm.latency(op, c + 20, pf),
                                           jm.latency(op, c + 20, pf),
                                           rtol=1e-12)
    for k in (1, 3, len(nodes)):
        np.testing.assert_allclose(tm.chain_us(nodes[:k], [2] * k),
                                   jm.chain_us(nodes[:k], [2] * k), rtol=1e-12)
        np.testing.assert_allclose(tm.node_us(nodes[k - 1], 2),
                                   jm.node_us(nodes[k - 1], 2), rtol=1e-12)
    for n in (1, 31, 100):
        np.testing.assert_allclose(tm.segment_us(n), jm.segment_us(n),
                                   rtol=1e-12)


@pytest.mark.parametrize("precision", ["float32", "int8"])
@pytest.mark.parametrize("bench", ["bonsai/usps-b", "protonn/usps-b",
                                   "bonsai/curet-m"])
def test_measured_compile_matches_the_reference(bench, precision):
    """Stamped with each package's own device class, the table compiles in
    measured mode to the JAX package's assignment and schedule total."""
    t, j = _tables()
    tp = _compile(bench, use_pallas=True, cost_source="measured",
                  calibration=t, precision=precision)
    jdfg, _, _ = jbuild(bench)
    from repro.configs.classical import training_split as jsplit

    calib = None if precision == "float32" else jsplit(bench, seed=0)[0][:64]
    jp = JCompiler(use_pallas=True, cost_source="measured", calibration=j,
                   precision=precision).compile(jdfg, calib=calib)
    assert tp.cost_source == jp.cost_source == "measured"
    assert tp.assignment == jp.assignment
    assert tp.schedule.total_cycles == jp.schedule.total_cycles
    assert tp.fused_clusters == jp.fused_clusters
    assert tp.plan.chain_splits == jp.plan.chain_splits
    assert tp.plan.megakernel.fingerprint() == jp.plan.megakernel.fingerprint()


# ------------------------------------------------------------ persistence
def test_calibration_store_round_trip(tmp_path, table):
    store = ArtifactStore(tmp_path)
    store.save_calibration(table)
    back = store.load_calibration(table.device_class)
    assert back is not None
    assert back.device_class == table.device_class
    assert back.digest() == table.digest()
    assert back.samples == table.samples
    assert back.knobs == table.knobs


def test_calibration_store_device_class_mismatch_is_a_miss(tmp_path, table):
    store = ArtifactStore(tmp_path)
    store.save_calibration(table)
    assert store.load_calibration("cuda:nvidia_h100_80gb_hbm3") is None
    assert store.load_calibration(table.device_class) is not None


def test_calibration_version_bump_invalidates(tmp_path, table, monkeypatch):
    path = tmp_path / "calib.mafia-calib"
    store = ArtifactStore(tmp_path)
    artifacts.save_calibration(table, path)
    store.save_calibration(table)
    assert artifacts.load_calibration(path).digest() == table.digest()
    monkeypatch.setattr(artifacts, "CALIBRATION_VERSION",
                        artifacts.CALIBRATION_VERSION + 1)
    with pytest.raises(ArtifactError, match="version"):
        artifacts.load_calibration(path)
    assert store.load_calibration(table.device_class) is None


def test_calibration_corruption_detected(tmp_path, table):
    path = tmp_path / "calib.mafia-calib"
    artifacts.save_calibration(table, path)
    blob = path.read_bytes()
    path.write_bytes(blob[:-7] + bytes(7))
    with pytest.raises(ArtifactError):
        artifacts.load_calibration(path)


def test_reference_calibration_is_refused(tmp_path):
    """A table the JAX package wrote, at the path the port's store reads,
    is a miss on its magic; neither package loads the other's."""
    from repro.core import artifacts as jart

    t, j = _tables(stamp=device_class(CPU))
    store = ArtifactStore(tmp_path)
    jart.save_calibration(j, store.calibration_path(j.device_class))
    assert store.load_calibration(j.device_class) is None
    with pytest.raises(ArtifactError, match="bad magic"):
        artifacts.load_calibration(store.calibration_path(j.device_class))
    store.save_calibration(t)
    with pytest.raises(jart.ArtifactError):
        jart.load_calibration(store.calibration_path(t.device_class))


def test_calibration_survives_program_lru_sweep(tmp_path, table):
    store = ArtifactStore(tmp_path, max_bytes=1)   # evict every program
    store.save_calibration(table)
    _compile("bonsai/usps-b", use_pallas=True, artifact_store=store)
    _compile("protonn/usps-b", use_pallas=True, artifact_store=store)
    assert store.evictions == 1
    assert store.load_calibration(table.device_class) is not None


# --------------------------------------------------------- compiler knob
def test_measured_mode_falls_back_on_device_mismatch(table):
    foreign = dataclasses.replace(table, device_class="cuda:nvidia_h100")
    comp = MafiaCompiler(use_pallas=True, cost_source="measured",
                         calibration=foreign, device=CPU)
    assert comp.cost_source == "analytic" and comp.calibrated is None
    fitted = CalibratedCostModel.fit(foreign)
    comp = MafiaCompiler(use_pallas=True, cost_source="measured",
                         calibration=fitted, device=CPU)
    assert comp.cost_source == "analytic" and comp.calibrated is None


def test_cost_source_validated():
    with pytest.raises(ValueError, match="cost_source"):
        MafiaCompiler(cost_source="vibes", device=CPU)
    with pytest.raises(TypeError, match="calibration"):
        MafiaCompiler(cost_source="measured", calibration={}, device=CPU)


@pytest.mark.parametrize("precision", ["float32", "int8", "int16"])
@pytest.mark.parametrize("bench", ["bonsai/usps-b", "bonsai/curet-m"])
def test_cost_sources_bitwise_identical_outputs(model, bench, precision):
    """The assignment and chain cuts may differ under the measured model;
    the emitted numerics may not, per sample and on a bucket."""
    tuned = dataclasses.replace(model, knobs={"chain_split_bytes": 256 * 1024})
    pa = _compile(bench, use_pallas=True, precision=precision)
    pm = _compile(bench, use_pallas=True, cost_source="measured",
                  calibration=tuned, autotune=True, chain_split_bytes="auto",
                  precision=precision)
    assert pa.cost_source == "analytic" and pm.cost_source == "measured"
    assert pm.chain_split_bytes == 256 * 1024
    assert pm.latency_us == pm.schedule.total_cycles
    (gi, spec), = pa.dfg.graph_inputs.items()
    X = np.random.default_rng(0).standard_normal(
        (16,) + tuple(spec.shape)).astype(np.float32)
    for oa, om in ((pa(**{gi: X[0]}), pm(**{gi: X[0]})),
                   (pa.batch(16)(**{gi: X}), pm.batch(16)(**{gi: X}))):
        assert set(oa) == set(om)
        for k in oa:
            assert torch.equal(oa[k], om[k]), k


def test_measured_mode_artifact_key_disjoint(tmp_path, model):
    store = ArtifactStore(tmp_path)
    _compile("protonn/usps-b", use_pallas=True, artifact_store=store)
    prog = _compile("protonn/usps-b", use_pallas=True, cost_source="measured",
                    calibration=model, artifact_store=store)
    assert store.misses == 2
    assert prog.cost_source == "measured"
    again = _compile("protonn/usps-b", use_pallas=True,
                     cost_source="measured", calibration=model,
                     artifact_store=store)
    assert again.pf_source == "artifact" and store.hits == 1


def test_program_round_trip_preserves_cost_source(tmp_path, model):
    prog = _compile("bonsai/usps-b", use_pallas=True, cost_source="measured",
                    calibration=model)
    path = tmp_path / "prog.mafia"
    artifacts.save_program(prog, path)
    assert artifacts.load_program(path, CPU).cost_source == "measured"


def test_chain_split_auto_resolves_from_knobs(table):
    tuned = dataclasses.replace(
        table, knobs={**table.knobs, "chain_split_bytes": 123456})
    comp = MafiaCompiler(use_pallas=True, cost_source="measured",
                         calibration=tuned, chain_split_bytes="auto",
                         device=CPU)
    assert comp.chain_split_bytes == 123456
    bare = dataclasses.replace(table, knobs={})
    comp = MafiaCompiler(use_pallas=True, cost_source="measured",
                         calibration=bare, chain_split_bytes="auto",
                         device=CPU)
    from repro_torch.core.lowering import DEFAULT_CHAIN_SPLIT_BYTES

    assert comp.chain_split_bytes == DEFAULT_CHAIN_SPLIT_BYTES


def test_autotune_sweeps_the_split_only(tmp_path, table):
    """autotune_knobs sweeps chain_split_bytes on the device and records
    every candidate; no (bb, bn) tile is swept or recorded.  A table of
    another device class cannot be tuned here."""
    t = dataclasses.replace(table, knobs={}, samples=list(table.samples))
    at.autotune_knobs(t, reps=1, device=CPU)
    assert t.knobs["chain_split_bytes"] in at._SPLIT_SWEEP
    assert [c for c, _ in t.knobs["split_sweep_us"]] == list(at._SPLIT_SWEEP)
    assert t.knobs["split_us"] == min(us for _, us in t.knobs["split_sweep_us"])
    assert "bb" not in t.knobs and "bn" not in t.knobs
    comp = MafiaCompiler(use_pallas=True, cost_source="measured",
                         calibration=t, autotune=True,
                         chain_split_bytes="auto", device=CPU)
    assert comp.chain_split_bytes == t.knobs["chain_split_bytes"]
    assert lp.tuned_tiles() == (lp.DEFAULT_BB, lp.DEFAULT_BN)
    with pytest.raises(ValueError, match="cannot be tuned"):
        at.autotune_knobs(dataclasses.replace(t, device_class="cuda:x"),
                          device=CPU)


def test_table_tiles_applied_and_bitwise_neutral(table):
    """A table that carries (bb, bn), as the JAX package's tables do, is
    applied as there: the tiles are installed process-wide and price the
    chain splitter; the outputs do not move."""
    tiled = dataclasses.replace(
        table, knobs={"chain_split_bytes": 1 << 20, "bb": 128, "bn": 256})
    before = lp.chain_vmem_bytes(400, 1, 1)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(400)
                         .astype(np.float32))
    stages = (("relu", None), ("scalar_mul", 1.5), ("sigmoid", None))
    ref = lp.fused_linear_chain(x, stages)
    MafiaCompiler(use_pallas=True, cost_source="measured", calibration=tiled,
                  autotune=True, device=CPU)
    assert lp.tuned_tiles() == (128, 256)
    assert lp.chain_vmem_bytes(400, 1, 1) < before
    assert torch.equal(lp.fused_linear_chain(x, stages), ref)


def test_default_calibration_is_store_first(tmp_path, monkeypatch, table):
    """The table the store holds for the device's class is used without
    profiling; a miss profiles the device once and publishes."""
    calls = []
    real = at.profile_device

    def counted(**kw):
        calls.append(kw)
        return real(ops=_OPS, include_segments=False, reps=1, **kw)

    monkeypatch.setattr(at, "profile_device", counted)
    at._cached_profile.cache_clear()
    store = ArtifactStore(tmp_path)
    store.save_calibration(table)
    m = at.default_calibration(store=store, device=CPU)
    assert calls == [] and m.table_digest == table.digest()
    empty = ArtifactStore(tmp_path / "empty")
    comp = MafiaCompiler(cost_source="measured", artifact_store=empty,
                         device=CPU)
    assert len(calls) == 1 and calls[0]["device"] == torch.device("cpu")
    assert comp.cost_source == "measured"
    assert empty.load_calibration(device_class(CPU)) is not None
    at._cached_profile.cache_clear()


# ------------------------------------------------------- staleness gating
def test_calibration_table_stamped_and_round_trips(table, tmp_path):
    assert table.created_at > 0
    path = tmp_path / "c.mafia-calib"
    artifacts.save_calibration(table, path)
    assert artifacts.load_calibration(path).created_at == table.created_at
    restamped = dataclasses.replace(
        table, meta={**table.meta, "created_at": 1.0})
    assert restamped.digest() == table.digest()


def test_stale_calibration_falls_back_to_analytic(table):
    stale = dataclasses.replace(
        table, meta={**table.meta,
                     "created_at": time_mod.time() - 90 * 86400})
    with pytest.warns(UserWarning, match="90.0 days old"):
        comp = MafiaCompiler(use_pallas=True, cost_source="measured",
                             calibration=stale, max_age_days=30, device=CPU)
    assert comp.cost_source == "analytic" and comp.calibrated is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = MafiaCompiler(use_pallas=True, cost_source="measured",
                              calibration=stale, max_age_days=30, device=CPU)
    assert again.cost_source == "analytic"
    off = MafiaCompiler(use_pallas=True, cost_source="measured",
                        calibration=stale, max_age_days=None, device=CPU)
    assert off.cost_source == "measured"


def test_fresh_calibration_passes_default_age_gate(model):
    comp = MafiaCompiler(use_pallas=True, cost_source="measured",
                         calibration=model, device=CPU)
    assert comp.cost_source == "measured" and comp.calibrated is model
