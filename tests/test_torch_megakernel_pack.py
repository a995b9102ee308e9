"""The megakernel's pack — LOAD_MAT buffers and barrier marks — on the CPU.

``csrc/megakernel.cu`` copies each matrix into one of two shared-memory
buffers when its ``LOAD_MAT`` comes (the reference's DMA schedule), waits
for the copy at the instruction that reads it, and runs ``__syncthreads``
only before the instructions the packer marks.  The card is needed to run
it, but what it reads is checked here, on all 20 Table-I programs × 3
precisions:

* the packed stream is the reference's instruction stream, ``LOAD_MAT``
  included, in the same order (the JAX package's own compile);
* every ``LOAD_MAT`` fills the buffer its consumer reads, the buffers
  alternate, no copy overwrites a buffer whose matrix is still to be read,
  each consumer waits for the phase of its own copy on the buffer's
  mbarriers, and the table, registers and both buffers fit in a block's
  shared memory;
* the barrier marks leave no race: an independent replay of the kernel's
  accesses, word by word and thread by thread, between consecutive
  barriers finds no word written by one thread and touched by another;
* the packed table, walked with the kernel's semantics
  (``tests/test_torch_pack.py``'s emulator), gives the plain version's
  outputs, and the plain version gives the JAX reference's
  (``repro.kernels.ref.run_segment_ref``): float32 within ``1e-5``, the
  integer lanes exactly but for 1 LSB downstream of a float PE.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import quantize_jnp
from repro.kernels import ref as jref
from repro.serve.classical_engine import get_program as jget
from repro_torch.configs.classical import BENCHMARKS
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.ref import float_pe_outputs, run_segment_grid_ref
from repro_torch.serve.classical_engine import get_program as tget

torch.set_num_threads(1)

PROGRAMS = [b.name for b in BENCHMARKS]
PRECISIONS = ["float32", "int8", "int16"]
OPS = {v: k for k, v in mk._OPC.items() if k not in ("SPMV",)}
SMEM_BYTES = 232448


@functools.lru_cache(maxsize=1)
def _pack_module():
    path = Path(__file__).resolve().parent / "test_torch_pack.py"
    spec = importlib.util.spec_from_file_location("_torch_pack_emulator", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream_name(ins) -> str:
    """The packed opcode's name of a reference instruction."""
    if ins.op == "LOAD_VEC":
        return "LOAD_IN" if ins.operand[0] == "in" else "LOAD_CONST"
    if ins.op == "REQUANTIZE":
        return "REQ_ROWS" if ins.operand[0] == "rows" else "REQ_T"
    return "MATVEC" if ins.op == "SPMV" else ins.op


def _accesses(f, nt: int, scratch_off: int):
    """The kernel's accesses of one packed row, as a list of events:
    ("sync",) or (word offset, length, thread mode, "r" | "w").  Thread
    mode "aligned": element i by thread i % nt; "lane32": by thread i % 32;
    "single": thread 0; "all": every thread.  Matrix buffer b is the
    pseudo-word -1 - b: its copy is written by thread 0's bulk load, and a
    reader's wait on the copy's mbarrier ("acquire") orders it after."""
    op, dst, s0, s1, n, k = (int(v) for v in f[:6])
    flags, buf = int(f[12]), int(f[14])
    ev = [("sync",)] if flags & mk.MK_SYNC else []
    name = OPS[op]
    if name == "LOAD_MAT":
        ev.append((-1 - buf, 1, "single", "w"))
    elif name in ("LOAD_IN", "LOAD_CONST"):
        ev.append((dst, n, "aligned", "w"))
    elif name in ("MATVEC", "SQL2"):
        if buf >= 0:
            ev.append(("acquire", -1 - buf))
            ev.append((-1 - buf, 1, "all", "r"))
        ev.append((s0, k, "all", "r"))
        if flags & mk.MK_STREAM:
            ev.append(("sync",))
        if flags & mk.MK_DIRECT:
            ev.append((dst, n, "aligned", "w"))
        else:
            ev += [(scratch_off, n, "aligned", "w"), ("sync",),
                   (scratch_off, n, "aligned", "r"), (dst, n, "aligned", "w")]
    elif name in ("REQ_T", "REQ_ROWS"):
        ev += [(s0, n, "aligned", "r"), (dst, n, "aligned", "w")]
    elif name == "ARGMAX":
        ev += [(s0, k, "lane32", "r"), (dst, 1, "single", "w")]
    elif name in ("REDUCE", "DOT"):
        ev.append((s0, k, "single", "r"))
        if name == "DOT":
            ev.append((s1, k, "single", "r"))
        ev.append((dst, 1, "single", "w"))
    elif name == "ELEMENTWISE":
        ev.append((s0, n, "aligned", "r"))
        if int(f[8]) in (8, 9, 10, 20, 21, 22):          # *_arr stages
            ev.append((s1, k, "aligned" if k != 1 else "all", "r"))
        ev.append((dst, n, "aligned", "w"))
    elif name == "STORE":
        ev.append((s0, n, "aligned", "r"))
    return ev


def _races(pk, nt: int = mk._THREADS) -> list[str]:
    """Replay the accesses between barriers; a word written by one thread
    and read or written by another in the same epoch is a race."""
    races, touched = [], {}
    for p, f in enumerate(pk["instrs"]):
        for e in _accesses(f, nt, pk["scratch_off"]):
            if e == ("sync",):
                touched = {}
                continue
            if e[0] == "acquire":
                touched.pop(e[1], None)
                continue
            off, n, mode, rw = e
            for i in range(n):
                th = (i % nt if mode == "aligned" else i % 32 if mode == "lane32"
                      else 0 if mode == "single" else -1)
                seen = touched.setdefault(off + i, [])
                for th2, rw2 in seen:
                    if (rw == "w" or rw2 == "w") and (th != th2 or th < 0):
                        races.append(f"instr {p} word {off + i}")
                        break
                seen.append((th, rw))
    return races


def _segments(bench, precision):
    jp = jget(bench, precision=precision, exec_mode="megakernel_grid")
    tp = tget(bench, precision=precision, exec_mode="megakernel_grid",
              device="cpu")
    (jseg,), (tseg,) = jp.plan.megakernel.segments, tp.plan.megakernel.segments
    return jp, jseg, tseg


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("bench", PROGRAMS)
def test_pack_follows_the_reference_stream_without_races(bench, precision):
    jp, jseg, tseg = _segments(bench, precision)
    (name, spec), = jp.dfg.graph_inputs.items()
    X = np.random.default_rng(4).standard_normal((2,) + tuple(spec.shape))
    X = X.astype(np.float32)
    if precision != "float32":
        X = np.asarray(quantize_jnp(jnp.asarray(X), jp.plan.input_exps[name],
                                    jp.plan.bits))
    _check_pack(jseg, tseg, X.reshape(2, -1))


def _check_pack(jseg, tseg, X):
    """The pack of the port's segment ``tseg`` follows the reference's
    ``jseg``, leaves no race, and its table, walked with the kernel's
    semantics, gives the plain version's and the reference's outputs on the
    rows of ``X`` (the segment's input)."""
    pk = mk.pack_segment(tseg)
    rows = pk["instrs"]
    assert [OPS[int(f[0])] for f in rows] == [_stream_name(i) for i in jseg.instrs]
    assert 4 * pk["smem_words"] <= SMEM_BYTES - 32         # 32: the mbarriers
    assert pk["table_words"] >= len(rows) * 20
    assert pk["buf_off"] % 4 == 0 and pk["bufw"] % 8 == 0

    # each LOAD_MAT fills the buffer its consumer reads, in turn; the
    # consumer waits for the parity of that copy's phase on the buffer's
    # mbarrier (half 0), and a streamed one for each of its halves' copies
    loads, awaited, done = [], {}, {(b, h): 0 for b in (0, 1) for h in (0, 1)}
    for p, f in enumerate(rows):
        name = OPS[int(f[0])]
        if name == "LOAD_MAT":
            b = int(f[14])
            assert b not in awaited.values(), "a buffer overwritten before use"
            assert int(f[4]) % 4 == 0 and int(f[6]) % 4 == 0   # 16-byte copies
            loads.append(b)
            awaited[int(f[6])] = b
        elif name in ("MATVEC", "SQL2") and int(f[14]) >= 0:
            b = int(f[14])
            assert awaited.pop(int(f[6])) == b
            assert int(f[15]) & 1 == done[b, 0] % 2
            done[b, 0] += 1
            if int(f[12]) & mk.MK_STREAM:
                ch, pc = int(f[10]), int(f[11])
                assert ch % 4 == 0 and pc >= ch and int(f[4]) * pc <= pk["bufw"] // 2
                for c in range(1, -(-int(f[5]) // ch)):
                    h = c % 2
                    assert (int(f[15]) >> h) + c // 2 & 1 == done[b, h] % 2
                    done[b, h] += 1
            else:
                assert int(f[4]) * int(f[13]) <= pk["bufw"]
            assert int(f[13]) % 4 == 0 and int(f[13]) >= int(f[5])
    assert loads == [i % 2 for i in range(len(loads))]
    assert len(loads) == sum(i.op == "LOAD_MAT" for i in jseg.instrs) > 0
    assert not awaited
    assert _races(pk) == []
    assert int((rows[:, 12] & mk.MK_SYNC).astype(bool).sum()) < len(rows)

    # the packed table and the plain version, against the reference
    x = torch.from_numpy(np.array(X))
    plain = run_segment_grid_ref(tseg, [x])
    emulated = _pack_module()._emulate(tseg, pk, [x.numpy()])
    for i in range(len(X)):
        want = jref.run_segment_ref(jseg, [jnp.asarray(X[i])])
        for a, b, c, pe in zip(emulated, plain, want, float_pe_outputs(tseg)):
            for got in (a[i], b[i].numpy()):
                ref = np.asarray(c).reshape(got.shape)
                if ref.dtype == np.float32:
                    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
                elif pe and ref.dtype != np.int32:
                    assert np.abs(got.astype(np.int64) - ref).max() <= 1
                else:
                    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("precision,per_channel", [
    ("float32", False), ("int8", False), ("int8", True)],
    ids=["float32", "int8", "int8-per-channel"])
@pytest.mark.parametrize("name", ["kws_mlp", "tiny_cnn"])
def test_mlperf_tiny_pack_follows_the_reference(name, precision, per_channel):
    """The MLPerf-Tiny segments (between interpreted islands), packed as
    the card runs them: ``kws_mlp``'s 128 x 490 first matrix does not fit a
    buffer whole and streams in chunks of columns; the others fit whole."""
    from repro.configs import mlperf_tiny as jmt
    from repro.core.compiler import MafiaCompiler as JCompiler
    from repro_torch.configs import mlperf_tiny as mt
    from repro_torch.core.compiler import MafiaCompiler as TCompiler

    calib = ({"input": mt.sample_inputs(name, 128, seed=7)}
             if precision != "float32" else None)
    kw = dict(precision=precision, per_channel=per_channel,
              exec_mode="megakernel_grid")
    jp = JCompiler(**kw).compile(jmt.build(name), calib=calib)
    tp = TCompiler(device="cpu", **kw).compile(mt.build(name), calib=calib)
    (jseg,), (tseg,) = jp.plan.megakernel.segments, tp.plan.megakernel.segments
    pk = mk.pack_segment(tseg)
    shapes = {tuple(np.shape(tseg.matrices[mi])): pl
              for mi, pl in pk["placements"].items()}
    assert shapes == ({(128, 490): "stream", (128, 128): "whole",
                       (12, 128): "whole"} if name == "kws_mlp"
                      else {(10, 256): "whole"})
    (width,) = pk["in_widths"]
    rng = np.random.default_rng(6)
    if precision == "float32":
        X = rng.standard_normal((3, width)).astype(np.float32)
    else:
        X = rng.integers(-127, 128, size=(3, width)).astype(np.int8)
    _check_pack(jseg, tseg, X)


def test_race_replay_finds_a_missing_barrier():
    """The replay is not vacuous: dropping every mark of a program whose
    stream needs them gives races."""
    _, _, tseg = _segments("bonsai/curet-m", "float32")
    pk = mk.pack_segment(tseg)
    assert _races(pk) == []
    pk["instrs"] = pk["instrs"].copy()
    pk["instrs"][:, 12] &= ~mk.MK_SYNC
    assert _races(pk)
