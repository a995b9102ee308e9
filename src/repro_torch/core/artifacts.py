"""Persistent compile-artifact store — shared cold-starts for the serve fleet.

The PF warm-start cache dies with the process: every fresh worker re-runs
the Best-PF search (and int-lane calibration) for programs an identical
worker already compiled.  This module serializes everything expensive about
a :class:`~repro_torch.core.compiler.CompiledProgram` to a **versioned
on-disk artifact** so a fleet of workers cold-starts from a shared store.

What is serialized — data only: numpy arrays and the port's dataclasses of
scalars, never a ``torch.Tensor`` on any device (the pickler refuses one):

* the canonical **rewritten DFG** (nodes, params, graph inputs, outputs,
  published set) and the rewrite's **alias map**,
* the **PFResult** and node→PF assignment (the Best-PF search output), the
  simulated :class:`~repro_torch.core.scheduler.Schedule` and the LUT/DSP
  totals,
* the **QuantPlan** (int lanes), fused clusters, and every compiler knob the
  plan depends on,
* the **linearized megakernel stream**, as its fingerprint and as data.

What is **not** serialized: callables, and the device data the kernel
wrappers derive from a program (a segment's or a chain's pack, made once per
device by :func:`repro_torch.kernels.build.segment_cache`).
:func:`restore_program` re-runs the cheap back-end plan pipeline over the
saved graph and binds the callables on the device it is given; the packs are
rebuilt when the program first runs there.  An artifact written on the card
therefore loads on the CPU, and the other way round.  Best-PF, scheduling
and calibration are not re-run.  A restored program is validated two ways:

* a sha256 **content digest** over the payload, checked before unpickling;
* the relinearized megakernel's :meth:`fingerprint` must equal the saved
  one, else the artifact came from another toolchain and is refused
  (:class:`ArtifactError`; :meth:`ArtifactStore.load` counts a miss).

The port's artifacts carry their own magic (``MAFIA-TORCH-ARTIFACT``) and
version.  An artifact written by the JAX package pickles that package's
classes, so unpickling it would import JAX: it is refused on its magic,
before a byte of it is unpickled.

Keys (:func:`program_key`) combine the canonical graph's
``structural_hash``, a digest of its parameter values, the compiler-knob
fingerprint and the calibration-data digest.  Writes are atomic (temp file
+ ``os.replace``).
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import tempfile
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["ARTIFACT_VERSION", "CALIBRATION_VERSION", "ArtifactError",
           "ArtifactStore", "calib_digest", "params_digest", "program_key",
           "program_self_key", "program_state", "restore_program",
           "save_program", "load_program", "save_calibration",
           "load_calibration"]

# Bump on any change to the payload schema, the plan/ISA semantics or the
# numeric templates: the version is in both the key and the header check.
ARTIFACT_VERSION = 1

# Calibration tables version independently of program artifacts.
CALIBRATION_VERSION = 1

_MAGIC = b"MAFIA-TORCH-ARTIFACT\n"
_CALIB_MAGIC = b"MAFIA-TORCH-CALIB\n"


class ArtifactError(RuntimeError):
    """A persisted artifact exists but cannot be trusted: bad magic or
    version, content-digest mismatch, a payload that holds a tensor, or a
    relinearize that does not reproduce the saved megakernel stream."""


def _host(v: Any) -> Any:
    """``v`` as host data: a tensor becomes a numpy array."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


# ----------------------------------------------------------------- hashing
def _digest_array(h: "hashlib._Hash", v: Any) -> None:
    a = np.asarray(_host(v))
    h.update(repr((a.dtype.str, a.shape)).encode())
    h.update(a.tobytes())


def params_digest(dfg) -> str:
    """sha256 over every node's static parameter values, in canonical
    order.  ``DFG.structural_hash`` excludes values; the artifact key must
    include them — the emitted program is the weights."""
    h = hashlib.sha256()
    for nid in sorted(dfg.nodes):
        node = dfg.nodes[nid]
        for k in sorted(node.params):
            h.update(repr((nid, k)).encode())
            v = node.params[k]
            if isinstance(v, (int, float, bool, str)):
                h.update(repr((type(v).__name__, v)).encode())
            else:
                _digest_array(h, v)
    return h.hexdigest()


def calib_digest(calib: Any, *, n_samples: int) -> str:
    """Digest of the calibration source: the batch's bytes, or the synthetic
    fallback's identity (deterministic in ``n_samples``)."""
    if calib is None:
        return f"synthetic:{n_samples}"
    h = hashlib.sha256()
    if isinstance(calib, Mapping):
        for k in sorted(calib):
            h.update(repr(k).encode())
            _digest_array(h, calib[k])
    else:
        _digest_array(h, calib)
    return h.hexdigest()


def program_key(rdfg, knobs: Mapping[str, Any], calib_dig: str) -> str:
    """Artifact key for one (canonical graph, weights, knobs, calibration)
    quadruple: any process computing the same quadruple lands on it."""
    h = hashlib.sha256()
    h.update(repr(("torch-version", ARTIFACT_VERSION)).encode())
    h.update(rdfg.structural_hash().encode())
    h.update(params_digest(rdfg).encode())
    h.update(repr(tuple(sorted((str(k), repr(v))
                               for k, v in knobs.items()))).encode())
    h.update(calib_dig.encode())
    return h.hexdigest()


def program_self_key(prog) -> str:
    """Store key computed from a *compiled* program alone — what the serving
    tier evicts and restores under: the canonical graph, its weights, every
    knob the plan records and the megakernel stream's fingerprint."""
    h = hashlib.sha256()
    h.update(repr(("torch-version", ARTIFACT_VERSION)).encode())
    h.update(prog.dfg.structural_hash().encode())
    h.update(params_digest(prog.dfg).encode())
    h.update(repr((prog.backend, repr(prog.budget), prog.use_pallas,
                   prog.precision, prog.exec_mode,
                   prog.chain_split_bytes)).encode())
    if prog.plan is not None and prog.plan.megakernel is not None:
        h.update(prog.plan.megakernel.fingerprint().encode())
    return h.hexdigest()


# ----------------------------------------------------- DFG (de)serialization
def _dfg_state(dfg) -> dict:
    return {
        "name": dfg.name,
        "graph_inputs": [(gi.name, tuple(gi.shape), gi.dtype)
                         for gi in dfg.graph_inputs.values()],
        "nodes": [
            {"id": n.id, "op": n.op, "dims": dict(n.dims),
             "inputs": list(n.inputs),
             "params": {k: _host(v) for k, v in n.params.items()},
             "latency1": n.latency1, "lut1": n.lut1, "pf": n.pf}
            for n in dfg.nodes.values()
        ],
        "outputs": list(dfg.outputs),
        "published": sorted(dfg.published),
    }


def _dfg_restore(state: dict):
    from repro_torch.core.dfg import DFG, GraphInput, Node

    dfg = DFG(state["name"])
    for name, shape, dtype in state["graph_inputs"]:
        dfg.graph_inputs[name] = GraphInput(name, tuple(shape), dtype)
    for nd in state["nodes"]:
        dfg.nodes[nd["id"]] = Node(
            id=nd["id"], op=nd["op"], dims=dict(nd["dims"]),
            inputs=list(nd["inputs"]), params=dict(nd["params"]),
            latency1=nd["latency1"], lut1=nd["lut1"], pf=nd["pf"])
    dfg.outputs = list(state["outputs"])
    dfg.published = frozenset(state["published"])
    return dfg


# ------------------------------------------------- program (de)serialization
def program_state(prog) -> dict:
    """Reduce a :class:`CompiledProgram` to a picklable payload — data only,
    no callables, no tensors, no device."""
    rw = prog.rewrite_result
    plan = prog.plan
    if plan is None:
        raise ArtifactError(
            "program has no ExecutionPlan — pre-plan programs cannot be "
            "persisted; recompile with MafiaCompiler.compile()")
    return {
        "version": ARTIFACT_VERSION,
        "dfg": _dfg_state(prog.dfg),
        "alias": dict(rw.alias) if rw is not None else {},
        "pruned": tuple(rw.pruned) if rw is not None else (),
        "folded": tuple(rw.folded) if rw is not None else (),
        "algebraic": tuple(rw.algebraic) if rw is not None else (),
        "hoisted": tuple(rw.hoisted) if rw is not None else (),
        "assignment": dict(prog.assignment),
        "pf_result": prog.pf_result,
        "schedule": prog.schedule,
        "lut_true": prog.lut_true,
        "dsp_true": prog.dsp_true,
        "backend": prog.backend,
        "budget": prog.budget,
        "fused_clusters": [list(c) for c in prog.fused_clusters],
        "use_pallas": prog.use_pallas,
        "precision": prog.precision,
        "qplan": prog.qplan,
        "exec_mode": prog.exec_mode,
        "chain_split_bytes": prog.chain_split_bytes,
        "cost_source": prog.cost_source,
        "megakernel_fp": plan.megakernel.fingerprint(),
        "megakernel": plan.megakernel,
    }


def restore_program(state: dict, device: torch.device | str | None = None):
    """Rebuild a :class:`CompiledProgram` from a payload on ``device`` (None:
    the card, which must exist): re-run the back-end plan pipeline over the
    saved graph, require the relinearized megakernel stream to match the
    saved fingerprint, and bind the callables there.  The saved Best-PF,
    schedule and quantization outputs are reused verbatim."""
    from repro_torch.core.compiler import CompiledProgram
    from repro_torch.core.device import resolve_device
    from repro_torch.core.executor import build_callable
    from repro_torch.core.lowering import RewriteResult, lower

    if state.get("version") != ARTIFACT_VERSION:
        raise ArtifactError(
            f"artifact version {state.get('version')!r} != "
            f"supported {ARTIFACT_VERSION}")
    dev = resolve_device(device)
    rdfg = _dfg_restore(state["dfg"])
    rw = RewriteResult(
        source=rdfg, dfg=rdfg, alias=dict(state["alias"]),
        pruned=tuple(state["pruned"]), folded=tuple(state["folded"]),
        algebraic=tuple(state["algebraic"]),
        hoisted=tuple(state["hoisted"]))
    plan = lower(
        rdfg, fused_clusters=state["fused_clusters"],
        use_pallas=state["use_pallas"], precision=state["precision"],
        qplan=state["qplan"], rewritten=rw,
        chain_split_bytes=state["chain_split_bytes"])
    if plan.megakernel.fingerprint() != state["megakernel_fp"]:
        raise ArtifactError(
            "relinearized megakernel stream does not match the serialized "
            "fingerprint — the artifact was produced by an incompatible "
            "toolchain; delete it and recompile")
    fn = build_callable(rdfg, plan=plan, mode=state["exec_mode"], device=dev)
    return CompiledProgram(
        dfg=rdfg, fn=fn,
        assignment=dict(state["assignment"]),
        pf_result=state["pf_result"],
        schedule=state["schedule"],
        lut_true=state["lut_true"],
        dsp_true=state["dsp_true"],
        backend=state["backend"],
        budget=state["budget"],
        fused_clusters=[list(c) for c in state["fused_clusters"]],
        use_pallas=state["use_pallas"],
        precision=state["precision"],
        qplan=state["qplan"],
        plan=plan,
        exec_mode=state["exec_mode"],
        source_dfg=rdfg,
        rewrite_result=rw,
        pf_source="artifact",
        chain_split_bytes=state["chain_split_bytes"],
        cost_source=state["cost_source"],
        device=dev,
    )


# ------------------------------------------------------------------ file IO
class _DataPickler(pickle.Pickler):
    """Pickles data only: a tensor anywhere in the payload is refused."""

    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor):
            raise ArtifactError(
                "artifact payloads hold numpy arrays, never a torch.Tensor "
                f"(found one on {obj.device})")
        return NotImplemented


def _dumps(state: Any) -> bytes:
    buf = io.BytesIO()
    _DataPickler(buf, protocol=4).dump(state)
    return buf.getvalue()


def _write_atomic(path: Path, blob: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, path)        # atomic publish: readers never see torn
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _write(path: Path, magic: bytes, version: int, state: Any) -> str:
    """Magic line, one fixed-format header line ``version=<int>
    digest=<sha256hex>``, then the pickled payload; returns the digest."""
    payload = _dumps(state)
    digest = hashlib.sha256(payload).hexdigest()
    header = f"version={version} digest={digest}\n".encode()
    _write_atomic(Path(path), magic + header + payload)
    return digest


def _read(path: Path, magic: bytes, version: int, what: str) -> Any:
    """The payload of ``path``, after its magic, version and digest checked
    out — nothing is unpickled before all three have."""
    blob = Path(path).read_bytes()
    if not blob.startswith(magic):
        raise ArtifactError(f"{path}: not a {what} of this package (bad magic)")
    rest = blob[len(magic):]
    nl = rest.find(b"\n")
    if nl < 0:
        raise ArtifactError(f"{path}: truncated header")
    fields = dict(p.split(b"=", 1) for p in rest[:nl].split(b" ") if b"=" in p)
    try:
        got = int(fields[b"version"])
        digest = fields[b"digest"].decode()
    except (KeyError, ValueError) as exc:
        raise ArtifactError(f"{path}: malformed header") from exc
    if got != version:
        raise ArtifactError(
            f"{path}: {what} version {got} != supported {version}")
    payload = rest[nl + 1:]
    if hashlib.sha256(payload).hexdigest() != digest:
        raise ArtifactError(f"{path}: content digest mismatch (corrupt file)")
    return pickle.loads(payload)


def save_program(prog, path: str | Path) -> str:
    """Serialize ``prog`` to ``path``; returns the payload's sha256."""
    return _write(Path(path), _MAGIC, ARTIFACT_VERSION, program_state(prog))


def load_program(path: str | Path, device: torch.device | str | None = None):
    """Load, validate and restore a program from ``path`` onto ``device``
    (None: the card).  Raises :class:`ArtifactError` on any trust failure,
    ``FileNotFoundError`` when absent."""
    return restore_program(
        _read(Path(path), _MAGIC, ARTIFACT_VERSION, "program artifact"),
        device)


# -------------------------------------------------------- calibration tables
def save_calibration(table, path: str | Path) -> str:
    """Serialize a :class:`~repro_torch.core.autotune.CalibrationTable`
    (own magic and version, so the two kinds never cross-load)."""
    return _write(Path(path), _CALIB_MAGIC, CALIBRATION_VERSION, {
        "version": CALIBRATION_VERSION,
        "device_class": table.device_class,
        "samples": list(table.samples),
        "knobs": dict(table.knobs),
        "meta": dict(table.meta)})


def load_calibration(path: str | Path):
    """Load and validate a calibration table; :class:`ArtifactError` on any
    trust failure, ``FileNotFoundError`` when absent."""
    from repro_torch.core.autotune import CalibrationTable

    state = _read(Path(path), _CALIB_MAGIC, CALIBRATION_VERSION,
                  "calibration table")
    return CalibrationTable(
        device_class=state["device_class"], samples=list(state["samples"]),
        knobs=dict(state["knobs"]), meta=dict(state["meta"]))


# -------------------------------------------------------------------- store
class ArtifactStore:
    """Directory of compiled-program artifacts, one file per key.

    Every worker pointing at the same ``root`` cold-starts from artifacts
    any one of them published.  ``load`` is tolerant: absent, corrupt,
    foreign or incompatible artifacts count as misses and the caller
    compiles as usual.  ``hits``/``misses``/``saves``/``evictions`` feed the
    serving metrics.

    ``max_bytes`` bounds the footprint: after every save the store sweeps
    the least recently *used* artifacts (file mtime; a load touches it)
    until the total fits.  The just-saved artifact is never evicted, and
    calibration tables (their own extension) never are.
    """

    def __init__(self, root: str | Path,
                 max_bytes: int | None = None) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.saves = 0
        self.evictions = 0

    def path(self, key: str) -> Path:
        return self.root / f"{key}.mafia"

    def contains(self, key: str) -> bool:
        return self.path(key).exists()

    def load(self, key: str, device: torch.device | str | None = None):
        """The program for ``key`` on ``device`` (None: the card), or None
        (counted as a miss)."""
        path = self.path(key)
        try:
            prog = load_program(path, device)
        except (FileNotFoundError, ArtifactError):
            self.misses += 1
            return None
        try:
            os.utime(path)                 # LRU recency: a hit is a use
        except OSError:
            pass                           # raced an eviction/rewrite
        self.hits += 1
        return prog

    def save(self, key: str, prog) -> Path:
        path = self.path(key)
        save_program(prog, path)
        self.saves += 1
        self._sweep(keep=path)
        return path

    def size_bytes(self) -> int:
        return sum(self._stat_sizes().values())

    def _stat_sizes(self) -> dict[Path, int]:
        sizes: dict[Path, int] = {}
        for p in self.root.glob("*.mafia"):
            try:
                sizes[p] = p.stat().st_size
            except OSError:
                continue                   # raced a concurrent eviction
        return sizes

    def _sweep(self, keep: Path | None = None) -> None:
        """Evict least-recently-used artifacts until the store fits
        ``max_bytes``.  ``keep`` (the artifact just saved) is exempt."""
        if self.max_bytes is None:
            return
        sizes = self._stat_sizes()
        total = sum(sizes.values())
        if total <= self.max_bytes:
            return

        def mtime(p: Path) -> float:
            try:
                return p.stat().st_mtime
            except OSError:
                return float("inf")        # gone already: skip via sort end

        for p in sorted(sizes, key=mtime):
            if total <= self.max_bytes:
                break
            if keep is not None and p == keep:
                continue
            try:
                p.unlink()
            except OSError:
                continue                   # another process got there first
            total -= sizes[p]
            self.evictions += 1

    # ---------------------------------------------------------- calibration
    # Tables live beside the programs under their own extension: the sweep
    # globs ``*.mafia`` only, so a table is never evicted for programs.

    def calibration_path(self, device_class: str) -> Path:
        slug = "".join(c if c.isalnum() or c in "._-" else "-"
                       for c in device_class)
        return self.root / f"calib-{slug}.mafia-calib"

    def save_calibration(self, table) -> Path:
        path = self.calibration_path(table.device_class)
        save_calibration(table, path)
        self.saves += 1
        return path

    def load_calibration(self, device_class: str):
        """The table published for ``device_class``, or None (missing,
        corrupt, foreign, wrong version, or recorded for another device
        class — all misses)."""
        try:
            table = load_calibration(self.calibration_path(device_class))
        except (FileNotFoundError, ArtifactError):
            self.misses += 1
            return None
        if table.device_class != device_class:
            self.misses += 1
            return None
        self.hits += 1
        return table

    def keys(self) -> list[str]:
        return sorted(p.stem for p in self.root.glob("*.mafia"))

    def __repr__(self) -> str:
        return (f"ArtifactStore({str(self.root)!r}: {len(self.keys())} "
                f"artifacts, {self.hits} hits / {self.misses} misses, "
                f"{self.evictions} evicted)")
