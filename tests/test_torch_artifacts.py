"""The port's compile-artifact store, held against the JAX package's.

The port keys artifacts as the JAX package does: ``params_digest``,
``calib_digest`` and ``DFG.structural_hash`` are string-equal on the same
graphs.  A program saved to the store and loaded back — with a fresh
compiler, or in a fresh interpreter — skips Best-PF (``pf_source ==
"artifact"``), relinearizes to the JAX package's megakernel fingerprint,
equals the port's cold compile bitwise on every lane, and matches the JAX
package's ``interpret`` lane (float32 ``rtol = atol = 1e-5``, int8/int16
bitwise).  The JAX package's megakernel lanes cannot launch in this image,
so its interpret lane is the reference.  Corrupt, version-skewed and
foreign artifacts are refused; a JAX-package artifact is refused on its
magic before any of it is unpickled.
"""

import io
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.classical import build as jbuild
from repro.configs.classical import training_split as jsplit
from repro.core import artifacts as jart
from repro.core.compiler import MafiaCompiler as JCompiler
from repro.core.lowering import rewrite as jrewrite
from repro_torch.configs.classical import build, training_split
from repro_torch.core import artifacts
from repro_torch.core.artifacts import (ARTIFACT_VERSION, ArtifactError,
                                        ArtifactStore, load_program,
                                        program_self_key, save_program)
from repro_torch.core.compiler import CompiledProgram, MafiaCompiler
from repro_torch.core.lowering import rewrite

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
BENCH = "bonsai/usps-b"
PRECISIONS = ["float32", "int8", "int16"]
LANES = ["interpret", "megakernel", "megakernel_grid"]


def _dfg(bench=BENCH):
    dfg, _, _ = build(bench, trained=False, seed=0)
    return dfg


def _calib(precision, bench=BENCH, split=training_split):
    if precision == "float32":
        return None
    Xtr, _ = split(bench, seed=0)
    return Xtr[:64]


def _probe(dfg, n=None, seed=7):
    name, gi = next(iter(dfg.graph_inputs.items()))
    shape = tuple(gi.shape) if n is None else (n,) + tuple(gi.shape)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return name, x


def _np(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


_REF: dict = {}


def _reference(precision):
    """The JAX package's program for BENCH (use_pallas, interpret lane) and
    its outputs on the probe, compiled once per precision."""
    if precision not in _REF:
        prog = JCompiler(use_pallas=True, precision=precision,
                         calib_samples=64).compile(
            jbuild(BENCH, trained=False, seed=0)[0],
            calib=_calib(precision, split=jsplit))
        name, x = _probe(prog.dfg)
        _REF[precision] = prog, {k: np.asarray(v)
                                 for k, v in prog(**{name: x}).items()}
    return _REF[precision]


# ------------------------------------------------------------------ digests
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("bench", ["bonsai/usps-b", "protonn/usps-b",
                                   "bonsai/curet-m", "protonn/cifar-b"])
def test_digests_equal_the_reference(bench, precision):
    """structural_hash, params_digest and calib_digest: string-equal to the
    JAX package's, on the source graphs and on the rewritten ones."""
    tdfg, jdfg = _dfg(bench), jbuild(bench, trained=False, seed=0)[0]
    for t, j in ((tdfg, jdfg), (rewrite(tdfg, precision=precision).dfg,
                                jrewrite(jdfg, precision=precision).dfg)):
        assert t.structural_hash() == j.structural_hash()
        assert (t.structural_hash(include_dims=False)
                == j.structural_hash(include_dims=False))
        assert artifacts.params_digest(t) == jart.params_digest(j)
    for calib in (_calib(precision, bench),
                  {"x": _calib("int8", bench)}, None):
        assert (artifacts.calib_digest(calib, n_samples=64)
                == jart.calib_digest(calib, n_samples=64))


# -------------------------------------------------------------- round trip
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("exec_mode", LANES)
def test_roundtrip_bitwise_and_skips_best_pf(tmp_path, precision, exec_mode):
    """compile → save → load on a fresh compiler: pf_source 'artifact', the
    saved assignment, schedule and quant plan, the JAX package's
    fingerprint, outputs bitwise equal to the cold compile (per sample and
    a bucket) and to the JAX package's interpret lane within its limit."""
    store = ArtifactStore(tmp_path / "store")
    kw = dict(use_pallas=True, precision=precision, exec_mode=exec_mode,
              calib_samples=64, artifact_store=store, device="cpu")
    p1 = MafiaCompiler(**kw).compile(_dfg(), calib=_calib(precision))
    assert store.saves == 1 and store.misses == 1
    p2 = MafiaCompiler(**kw).compile(_dfg(), calib=_calib(precision))
    assert store.hits == 1
    assert p1.pf_source == "cold" and p2.pf_source == "artifact"
    assert p2.device == torch.device("cpu")
    assert p2.assignment == p1.assignment
    assert p2.schedule.total_cycles == p1.schedule.total_cycles
    if precision != "float32":
        assert p2.qplan.input_exps == p1.qplan.input_exps
        assert all(p2.qplan.nodes[n].out_exp == p1.qplan.nodes[n].out_exp
                   for n in p1.qplan.nodes)
    jprog, jout = _reference(precision)
    assert (p2.plan.megakernel.fingerprint()
            == p1.plan.megakernel.fingerprint()
            == jprog.plan.megakernel.fingerprint())
    name, x = _probe(p1.dfg)
    o1, o2 = _np(p1(**{name: x})), _np(p2(**{name: x}))
    _same(o1, o2)
    _, X = _probe(p1.dfg, n=16, seed=3)
    _same(_np(p1.batch(16)(**{name: X})), _np(p2.batch(16)(**{name: X})))
    for k, want in jout.items():
        assert o2[k].dtype == want.dtype and o2[k].shape == want.shape, k
        if precision == "float32":
            np.testing.assert_allclose(o2[k], want, rtol=1e-5, atol=1e-5)
        else:                              # integer lanes: bitwise
            assert np.array_equal(o2[k], want), k


def test_save_load_via_compiled_program_methods(tmp_path):
    path = tmp_path / "prog.mafia"
    p1 = MafiaCompiler(use_pallas=True, device="cpu").compile(_dfg())
    p1.save(path)
    p2 = CompiledProgram.load(path, device="cpu")
    assert p2.pf_source == "artifact" and p2.device == torch.device("cpu")
    name, x = _probe(p1.dfg)
    _same(_np(p1(**{name: x})), _np(p2(**{name: x})))


def test_load_defaults_to_the_card(tmp_path):
    """An entry point runs on the card unless asked: with no device and no
    card a load raises instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    path = tmp_path / "prog.mafia"
    MafiaCompiler(device="cpu").compile(_dfg()).save(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_program(path)
    assert ArtifactStore(tmp_path).load("prog", "cpu") is not None


def test_weights_participate_in_the_key(tmp_path):
    """Two trainings of one architecture must not collide: the structural
    hash ignores parameter values, the artifact key does not."""
    store = ArtifactStore(tmp_path / "store")
    kw = dict(use_pallas=True, artifact_store=store, device="cpu")
    dfg_a, dfg_b = _dfg(), _dfg()
    node = next(
        n for n in dfg_b.nodes.values()
        if any(np.issubdtype(np.asarray(v).dtype, np.floating)
               and np.asarray(v).size for v in n.params.values()))
    key = next(k for k, v in node.params.items()
               if np.issubdtype(np.asarray(v).dtype, np.floating)
               and np.asarray(v).size)
    node.params[key] = np.asarray(node.params[key]) * 1.5
    assert dfg_a.structural_hash() == dfg_b.structural_hash()
    pa = MafiaCompiler(**kw).compile(dfg_a)
    pb = MafiaCompiler(**kw).compile(dfg_b)
    assert store.hits == 0 and store.saves == 2
    assert program_self_key(pa) != program_self_key(pb)
    name, x = _probe(pa.dfg)
    oa, ob = _np(pa(**{name: x})), _np(pb(**{name: x}))
    assert any(not np.array_equal(oa[k], ob[k]) for k in oa)


# ------------------------------------------------------------- trust checks
def test_corrupt_artifact_is_rejected_and_store_treats_it_as_miss(tmp_path):
    path = tmp_path / "prog.mafia"
    save_program(MafiaCompiler(device="cpu").compile(_dfg()), path)
    blob = bytearray(path.read_bytes())
    blob[-1] ^= 0xFF                       # flip one payload byte
    path.write_bytes(bytes(blob))
    with pytest.raises(ArtifactError, match="digest mismatch"):
        load_program(path, "cpu")
    store = ArtifactStore(tmp_path)
    assert store.load("prog", "cpu") is None
    assert store.misses == 1


def test_version_skew_is_rejected(tmp_path):
    path = tmp_path / "prog.mafia"
    save_program(MafiaCompiler(device="cpu").compile(_dfg()), path)
    blob = path.read_bytes()
    old = f"version={ARTIFACT_VERSION} ".encode()
    new = f"version={ARTIFACT_VERSION + 1} ".encode()
    path.write_bytes(blob.replace(old, new, 1))
    with pytest.raises(ArtifactError, match="version"):
        load_program(path, "cpu")


def test_fingerprint_drift_is_rejected(tmp_path):
    """A payload whose saved stream differs from what the toolchain
    relinearizes (another toolchain's artifact) is refused."""
    prog = MafiaCompiler(device="cpu").compile(_dfg())
    state = artifacts.program_state(prog)
    state["megakernel_fp"] = "0" * 64
    with pytest.raises(ArtifactError, match="fingerprint"):
        artifacts.restore_program(state, "cpu")


def test_reference_artifact_is_refused_before_unpickling(tmp_path,
                                                         monkeypatch):
    """An artifact the JAX package wrote pickles that package's classes:
    the port refuses it on its magic without unpickling a byte, the store
    counts a miss, and the JAX package refuses the port's in turn."""
    jpath = tmp_path / "ref.mafia"
    jprog = JCompiler(use_pallas=True).compile(jbuild(BENCH)[0])
    jart.save_program(jprog, jpath)
    tpath = tmp_path / "port.mafia"
    save_program(MafiaCompiler(use_pallas=True, device="cpu").compile(_dfg()),
                 tpath)

    def refuse(*a, **k):
        raise AssertionError("a foreign payload reached the unpickler")

    monkeypatch.setattr(pickle, "loads", refuse)
    with pytest.raises(ArtifactError, match="bad magic"):
        load_program(jpath, "cpu")
    store = ArtifactStore(tmp_path)
    assert store.load("ref", "cpu") is None and store.misses == 1
    monkeypatch.undo()
    with pytest.raises(jart.ArtifactError, match="bad magic"):
        jart.load_program(tpath)


def test_payload_is_pure_data(tmp_path):
    """No callable, no tensor, no class of the JAX package: the payload
    unpickles with nothing but numpy, builtins and the port's modules, and
    a tensor anywhere is refused at save time."""
    prog = MafiaCompiler(use_pallas=True, precision="int8",
                         device="cpu").compile(_dfg(), calib=_calib("int8"))
    state = artifacts.program_state(prog)
    assert "fn" not in state
    blob = artifacts._dumps(state)
    modules: set[str] = set()

    class Spy(pickle.Unpickler):
        def find_class(self, module, name):
            modules.add(module)
            return super().find_class(module, name)

    Spy(io.BytesIO(blob)).load()
    roots = {m.split(".")[0] for m in modules}
    assert roots <= {"repro_torch", "numpy", "builtins", "collections",
                     "_codecs", "copyreg"}, roots
    with pytest.raises(ArtifactError, match="torch.Tensor"):
        artifacts._dumps({**state, "stray": torch.zeros(3)})
    # a DFG param held as a tensor is written as a numpy array
    node = next(n for n in prog.dfg.nodes.values() if "matrix" in n.params)
    node.params["matrix"] = torch.from_numpy(np.asarray(node.params["matrix"]))
    save_program(prog, tmp_path / "t.mafia")
    back = load_program(tmp_path / "t.mafia", "cpu")
    assert isinstance(back.dfg.nodes[node.id].params["matrix"], np.ndarray)


# -------------------------------------------------------------------- store
def test_store_gc_evicts_lru_under_size_bound(tmp_path):
    """With ``max_bytes`` set, saves sweep least-recently-*used* artifacts:
    a load refreshes recency, the just-saved file is never evicted."""
    prog = MafiaCompiler(use_pallas=True, device="cpu").compile(_dfg())
    one = ArtifactStore(tmp_path / "probe").save("probe", prog).stat().st_size
    store = ArtifactStore(tmp_path / "store", max_bytes=int(2.5 * one))
    store.save("a", prog)
    store.save("b", prog)
    assert store.evictions == 0 and set(store.keys()) == {"a", "b"}
    time.sleep(0.05)
    assert store.load("a", "cpu") is not None
    time.sleep(0.05)
    store.save("c", prog)
    assert store.evictions == 1
    assert set(store.keys()) == {"a", "c"}
    assert store.size_bytes() <= store.max_bytes
    tiny = ArtifactStore(tmp_path / "tiny", max_bytes=1)
    tiny.save("only", prog)
    assert tiny.keys() == ["only"]
    assert tiny.load("only", "cpu") is not None


def test_store_unbounded_by_default(tmp_path):
    store = ArtifactStore(tmp_path / "store")
    assert store.max_bytes is None
    prog = MafiaCompiler(device="cpu").compile(_dfg())
    for k in ("a", "b", "c"):
        store.save(k, prog)
    assert store.evictions == 0 and len(store.keys()) == 3


def _run(script):
    """``script`` in a fresh interpreter with the port on its path."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_cross_process_store_coherence(tmp_path):
    """Two writer processes race one key while a reader loads it: the
    reader may miss but never sees a torn file, and the final file loads."""
    store = ArtifactStore(tmp_path / "store")
    prog = MafiaCompiler(use_pallas=True, device="cpu").compile(_dfg())
    save_program(prog, tmp_path / "seed.mafia")
    writer = f"""
import pathlib
from repro_torch.core.artifacts import _write_atomic
blob = pathlib.Path({str(tmp_path / 'seed.mafia')!r}).read_bytes()
target = pathlib.Path({str(store.path('race'))!r})
for _ in range(200):
    _write_atomic(target, blob)
print("WRITER-OK")
"""
    reader = f"""
from repro_torch.core.artifacts import ArtifactError, load_program
hits = 0
for _ in range(100):
    try:
        load_program({str(store.path('race'))!r}, "cpu")
        hits += 1
    except FileNotFoundError:
        continue
    except ArtifactError as exc:
        print("TORN:", exc)
        raise SystemExit(2)
print("READER-OK", hits)
"""
    procs = [_run(src) for src in (writer, writer, reader)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)
    assert "WRITER-OK" in outs[0][0] and "WRITER-OK" in outs[1][0]
    assert "READER-OK" in outs[2][0]
    assert store.load("race", "cpu") is not None


def test_fresh_process_cold_start(tmp_path):
    """A new interpreter loads the artifact with a fresh compiler, skips
    Best-PF and reproduces the saving process's outputs bit for bit."""
    store = ArtifactStore(tmp_path / "store")
    kw = dict(use_pallas=True, exec_mode="megakernel_grid",
              precision="int8", device="cpu")
    prog = MafiaCompiler(artifact_store=store, **kw).compile(
        _dfg(), calib=_calib("int8"))
    name, X = _probe(prog.dfg, n=8)
    ref = _np(prog.batch(8)(**{name: X}))
    np.savez(tmp_path / "ref.npz", x=X, **{f"out_{k}": v
                                           for k, v in ref.items()})
    script = f"""
import numpy as np
from repro_torch.configs.classical import build, training_split
from repro_torch.core.artifacts import ArtifactStore
from repro_torch.core.compiler import MafiaCompiler

dfg, _, _ = build({BENCH!r}, trained=False, seed=0)
store = ArtifactStore({str(store.root)!r})
prog = MafiaCompiler(artifact_store=store, **{kw!r}).compile(
    dfg, calib=training_split({BENCH!r}, seed=0)[0][:64])
assert prog.pf_source == "artifact", prog.pf_source
assert store.hits == 1
data = np.load({str(tmp_path / 'ref.npz')!r})
out = prog.batch(8)(**{{{name!r}: data["x"]}})
for key in data.files:
    if key.startswith("out_"):
        got = out[key[4:]].numpy()
        assert got.dtype == data[key].dtype, key
        assert np.array_equal(got, data[key]), key
print("FRESH-PROCESS-OK")
"""
    p = _run(script)
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err
    assert "FRESH-PROCESS-OK" in out
