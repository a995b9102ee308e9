"""The plan and the packed parameters of the chain kernels, on the CPU.

``csrc/linear_chain.cu`` cannot run here, so its order of work is emulated
in this file (not in the port), from the bytes the wrapper hands it: the
stage table and the vec pool (``pack_chain``) and the ``LcChain`` and
``LcPlan`` structs (``_plan_struct``, which runs ``plan_chain``), each
decoded by a numpy mirror of the C layout written here.  Block b takes
elements ``[b * chunk, (b + 1) * chunk)``; each operand's elements from its
``head`` on arrive by one bulk copy of whole 16-byte units into its region
of shared memory, the rest by the threads' own loads; the threads then walk
the stage table over runs of ``LC_RUN`` elements, the column of a run found
once and stepped.  Checked: every element of every operand is copied
exactly once; every bulk copy is 16-byte aligned at both ends, a multiple
of 16 bytes and inside its tensor and its region; the elements left to the
threads are the ones before an operand's first 16-byte boundary and after
its last; shared memory fits the block's grant.

The emulated result is held against the plain version (exactly; the float
``sigmoid`` stage to ``1e-6``: the kernel computes ``1 / (1 + exp(-x))``,
the plain version ``torch.sigmoid``) and against
``repro.kernels.linear_pipeline.fused_linear_chain`` / ``_q`` in Pallas
interpret mode at ``tests/test_torch_linear_chain.py``'s tolerances
(float32 ``rtol = atol = 1e-5``; integers exact, 1 LSB only at a
``q_unary`` stage, held stage by stage in ``_check``).  Inputs: the served
chains of bonsai/curet-m and protonn/curet-m at float32, int8 and int16,
and seeded random chains, with operands at storage offsets of 0-15 bytes,
a 1-element stream, length-1 vecs (against the plain version: the Pallas
kernel takes (n,) vecs only), mixed operand dtypes, 16 extras and 64
stages.
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core.lowering import ChainStep
from repro_torch.kernels import linear_pipeline as tlp
from repro_torch.kernels.decode_attention import SMEM_PER_BLOCK
from repro_torch.serve.classical_engine import get_program
from test_torch_linear_chain import STAGE, _compare, _jax, _rows, _walk
from test_torch_pack import _chip_smoke

torch.set_num_threads(1)

CS = _chip_smoke()
SMS = 132
# csrc/linear_chain.cu's LcOp, LcPlan and LcChain; the dtype codes' sizes
OP = np.dtype([("dt", "<i4"), ("sh", "<i4"), ("head", "<i4"), ("off", "<i4")])
PLAN = np.dtype([("chunk", "<i4"), ("blocks", "<i4"), ("threads", "<i4"),
                 ("smem", "<i4"), ("n_ops", "<i4"), ("vec_at", "<i4"),
                 ("op", OP, 17)])
CHAIN = np.dtype([("table", "<u8"), ("vecs", "<u8"), ("n_stages", "<i4"),
                  ("bits", "<i4"), ("table_bytes", "<i4"), ("vec_bytes", "<i4"),
                  ("quantized", "<i4"), ("pad", "<i4")])
CODE = {np.dtype(np.float32): 0, np.dtype(np.int32): 1, np.dtype(np.int8): 2,
        np.dtype(np.int16): 3}
# the kernel's static shared memory: the stage table (64 rows), the
# operands' bases and dtypes, the mbarrier
STATIC_SMEM = 64 * STAGE.itemsize + 2 * 17 * 4 + 8


def kernel_order(chain, x, extras, offsets):
    """The kernel's result for numpy operands whose data start ``offsets``
    bytes past a 16-byte boundary, with every check of the module
    docstring made along the way."""
    ops = [x] + list(extras)
    numel, n = x.size, (x.shape[-1] if x.ndim else 1)
    pk = tlp.pack_chain(chain)
    T, V = _rows(pk)
    C = np.frombuffer(bytes(pk["params"]), CHAIN)[0]
    assert (C["n_stages"], C["bits"], C["quantized"]) == (
        len(chain.stages), chain.bits, int(chain.quantized))
    sig = [CODE[a.dtype] << 4 | off for a, off in zip(ops, offsets)]
    P = np.frombuffer(bytes(tlp._plan_struct(numel, sig, int(C["vec_bytes"]))),
                      PLAN)[0]
    chunk, n_ops = int(P["chunk"]), int(P["n_ops"])
    assert n_ops == len(ops)
    assert P["blocks"] == max(1, -(-numel // chunk))
    assert P["threads"] % 32 == 0 and P["threads"] <= tlp.LC_THREADS
    assert P["smem"] <= tlp.LC_SMEM and P["smem"] + STATIC_SMEM <= SMEM_PER_BLOCK
    staged = 0 < C["vec_bytes"] <= tlp.LC_VEC_SMEM
    assert (P["vec_at"] >= 0) == staged
    regions = []
    for k, a in enumerate(ops):
        op = P["op"][k]
        assert op["dt"] == CODE[a.dtype] and op["sh"] == offsets[k]
        assert (chunk * a.itemsize) % 16 == 0 and op["off"] % 16 == 0
        assert op["head"] * a.itemsize == (16 - offsets[k]) % 16
        regions.append((int(op["off"]), int(op["off"]) + chunk * a.itemsize + 16))
    if staged:
        regions.append((int(P["vec_at"]), int(P["vec_at"]) + int(C["vec_bytes"])))
    for (_, e), (s, _) in zip(sorted(regions), sorted(regions)[1:]):
        assert e <= s                                        # disjoint regions
    assert max(e for _, e in regions) <= P["smem"]
    # each operand's bytes as they lie in memory, from a 16-byte boundary
    mem = []
    for a, off in zip(ops, offsets):
        buf = np.zeros(off + a.nbytes + 16, np.uint8)
        buf[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        mem.append(buf)
    copies = [np.zeros(numel, np.int64) for _ in ops]
    carrier = np.int32 if chain.quantized else np.float32
    out = np.zeros(numel, x.dtype)
    for b in range(int(P["blocks"])):
        c0 = b * chunk
        ln = min(chunk, numel - c0)
        smem = np.zeros(int(P["smem"]), np.uint8)
        for k, a in enumerate(ops):
            op, it = P["op"][k], a.itemsize
            base = int(op["off"] + op["sh"])             # element 0 of the chunk
            lo = int(op["head"])
            nb = (max(ln - lo, 0) * it) & ~15
            hi = lo + nb // it
            if nb:
                g = offsets[k] + (c0 + lo) * it
                assert g % 16 == 0 and (base + lo * it) % 16 == 0 and nb % 16 == 0
                assert (c0 + lo) * it + nb <= a.nbytes
                assert base + lo * it + nb <= regions[k][1]
                smem[base + lo * it:base + lo * it + nb] = mem[k][g:g + nb]
                copies[k][c0 + lo:c0 + hi] += 1
            edges = [j for j in range(ln) if not lo <= j < hi]
            assert len(edges) < 2 * 16 // it
            assert all(j < lo for j in edges[:min(lo, ln)])
            for j in edges:
                g = offsets[k] + (c0 + j) * it
                smem[base + j * it:base + (j + 1) * it] = mem[k][g:g + it]
                copies[k][c0 + j] += 1
        if staged:
            vat = int(P["vec_at"])
            smem[vat:vat + int(C["vec_bytes"])] = pk["vecs"]
            vecs = smem[vat:vat + int(C["vec_bytes"])].view(V.dtype)
        else:
            vecs = V
        vals = []
        for k, a in enumerate(ops):
            base = int(P["op"][k]["off"] + P["op"][k]["sh"])
            vals.append(smem[base:base + ln * a.itemsize].view(a.dtype))
        # runs of LC_RUN elements: the column found once a run, then stepped
        cols = np.empty(ln, np.int64)
        for j0 in range(0, ln, tlp.LC_RUN):
            col = (c0 + j0) % n
            for j in range(j0, min(j0 + tlp.LC_RUN, ln)):
                cols[j] = col
                col = 0 if col + 1 == n else col + 1
        v = _walk(T, vecs, vals[0].astype(carrier), cols, vals[1:], chain.bits)
        out[c0:c0 + ln] = v.astype(x.dtype)
    for k, c in enumerate(copies):
        assert (c == 1).all(), f"operand {k}: elements copied {set(c.tolist())} times"
    return out.reshape(x.shape)


def _pallas(chain, x, extras):
    """``chain`` through the Pallas kernel in interpret mode."""
    stages = [(op, np.asarray(tlp._host(v), np.float32)
               if op.endswith("_vec") and not chain.quantized else v)
              for op, v in chain.stages]
    return _jax(stages, [tlp._host(v) for v in chain.vecs], x, extras,
                chain.bits if chain.quantized else None)


def _check(chain, x, extras, offsets):
    """The emulated kernel against the plain version (exactly) and against
    the Pallas kernel.  Against Pallas, a fixed-point chain with
    ``q_unary`` stages is held stage by stage: at each ``q_unary`` the two
    agree within 1 LSB wherever every earlier ``q_unary`` agreed exactly,
    and the chain's result agrees exactly wherever every ``q_unary`` did
    (its other stages are integer arithmetic, which may amplify that one
    LSB: a later ``q_hadamard`` by a 16-bit operand turns it into 2).
    Returns the elements where a ``q_unary`` differed."""
    got = kernel_order(chain, x, extras, offsets)
    xs = [torch.from_numpy(e) for e in extras]
    plain = tlp.run_chain(chain, torch.from_numpy(x), xs).numpy()
    if not chain.quantized and any(op == "sigmoid" for op, _ in chain.stages):
        np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, plain)
    units = [i for i, (op, _) in enumerate(chain.stages) if op == "q_unary"]
    if not chain.quantized or not units:
        return _compare(got, _pallas(chain, x, extras), chain.stages)
    agree = np.ones(x.shape, bool)
    for u in units:
        head = tlp.Chain(chain.stages[:u + 1], chain.vecs, True, chain.bits)
        mine = tlp.run_chain(head, torch.from_numpy(x), xs).numpy().astype(np.int64)
        theirs = _pallas(head, x, extras).astype(np.int64)
        assert (np.abs(mine - theirs)[agree] <= 1).all()
        agree &= mine == theirs
    np.testing.assert_array_equal(got[agree], _pallas(chain, x, extras)[agree])
    return int((~agree).sum())


def test_layout_mirrors_match_the_wrapper():
    """The numpy mirrors here and the wrapper's ctypes structs agree; the
    kernel checks the ctypes side against its own at load."""
    assert CHAIN.itemsize == ctypes.sizeof(tlp.LcChain)
    assert PLAN.itemsize == ctypes.sizeof(tlp.LcPlan)
    assert PLAN.fields["op"][1] == tlp.LcPlan.op.offset
    assert CHAIN.fields["n_stages"][1] == tlp.LcChain.n_stages.offset


@pytest.mark.parametrize("numel,items", [
    (1024, (4, 4, 4, 4)), (64 * 976, (4, 4, 4)), (64 * 976, (1, 1, 1)),
    (64 * 120, (2,)), (1, (1,)), (0, (4,)), (5, (1, 2, 4)),
    (10 ** 6, (4,) * 17), (4 * 16 * 976, (4, 1, 2)), (1025, (2, 2))],
    ids=str)
def test_plan_covers_every_element_once(numel, items):
    """Chunks tile the stream with one wave at most, whole 16-byte units of
    every operand; regions are disjoint and fit the budget."""
    g = 16 // min(items)
    for offsets in ((0,) * len(items), tuple((3 * k + 1) * s % 16
                                             for k, s in enumerate(items))):
        p = tlp.plan_chain(numel, items, offsets, sms=SMS)
        assert p.chunk % g == 0 and p.chunk >= g
        assert p.blocks == max(1, -(-numel // p.chunk))
        # one wave, unless a larger chunk would not fit the budget
        assert (numel <= tlp.LC_THREADS * tlp.LC_RUN or p.blocks <= SMS
                or p.smem + g * sum(items) > tlp.LC_SMEM)
        assert p.smem <= tlp.LC_SMEM
        assert p.heads == tuple((16 - o) % 16 // s for o, s in zip(offsets, items))
        ends = [r + p.chunk * s + 16 for r, s in zip(p.regions, items)]
        assert all(e <= r for e, r in zip(ends, p.regions[1:])) and ends[-1] == p.smem


def test_plan_gives_a_served_chain_one_block_and_a_large_one_every_sm():
    """(64, 16) is one block; (4, 16, 976) is one wave over (almost) every
    SM; a vec pool that fits is staged, a larger one read in place."""
    assert tlp.plan_chain(64 * 16, (4,) * 4, (0,) * 4, sms=SMS).blocks == 1
    assert tlp.plan_chain(64 * 16, (1,) * 4, (0,) * 4, sms=SMS).blocks == 1
    for item in (4, 2, 1):
        p = tlp.plan_chain(4 * 16 * 976, (item,) * 3, (0,) * 3, sms=SMS)
        assert SMS - 1 <= p.blocks <= SMS
    assert tlp.plan_chain(4 * 16 * 976, (4,) * 3, (0,) * 3, sms=SMS).blocks == SMS
    assert tlp.plan_chain(100, (4,), (0,), vec_bytes=4096).vec_at >= 0
    assert tlp.plan_chain(100, (4,), (0,), vec_bytes=tlp.LC_VEC_SMEM + 16).vec_at == -1
    with pytest.raises(ValueError):
        tlp.plan_chain(100, (4,), (2,))               # not on an element boundary


SERVED = [(b, p) for b in ("bonsai/curet-m", "protonn/curet-m")
          for p in ("float32", "int8", "int16")]


@pytest.mark.parametrize("bench,precision", SERVED, ids=lambda v: str(v))
def test_served_chains(bench, precision):
    prog = get_program(bench, precision=precision, use_pallas=True, device="cpu")
    steps = [s for s in prog.plan.steps if isinstance(s, ChainStep)]
    assert steps
    bits = prog.plan.bits
    for i, step in enumerate(steps):
        shape = (CS.BUCKET,) + tuple(prog.dfg.out_shape(step.terminal))
        rng = np.random.default_rng(i)
        x, *extras = [CS.random_stream(rng, shape, bits)
                      for _ in range(1 + len(step.extras))]
        chain = tlp.Chain(step.stages, step.vecs, step.quantized, bits or 8)
        _check(chain, x, extras, (0,) * (1 + len(extras)))


CASES = [(bits, shape, off) for bits, item in ((None, 4), (8, 1), (16, 2))
         for shape in ((4, 16, 976), (3, 5, 40), (1,))
         for off in (0, item, 16 - item, (7 * item) % 16)]


@pytest.mark.parametrize("bits,shape,off", CASES, ids=str)
def test_random_chains_at_storage_offsets(bits, shape, off):
    """Every stage of the vocabulary in a seeded order; the stream at
    ``off`` bytes past a 16-byte boundary and each extra at another offset.
    The same chain with a length-1 vec stage appended (the port broadcasts
    it; the Pallas kernel takes (n,) vecs only) against the plain version."""
    rng = np.random.default_rng(len(shape) * 100 + off + (bits or 0))
    pool = CS.FLOAT_STAGES if bits is None else CS.Q_STAGES
    stages, vecs, n_arr = CS.random_chain(rng, list(rng.permutation(pool)),
                                          shape[-1], bits)
    x, *extras = [CS.random_stream(rng, shape, bits) for _ in range(1 + n_arr)]
    item = x.itemsize
    offsets = tuple((off + 5 * k * item) % 16 for k in range(1 + n_arr))
    chain = tlp.Chain(tuple(stages), tuple(vecs), bits is not None, bits or 8)
    print(f"elements where a q_unary differs from Pallas: "
          f"{_check(chain, x, extras, offsets)}")
    if bits is None:
        stages.append(("add_vec", np.float32([0.25])))
    else:
        vecs.append(np.asarray([3], f"int{bits}"))
        stages.append(("q_add_vec", (len(vecs) - 1, 0, 1, 1)))
    chain = tlp.Chain(tuple(stages), tuple(vecs), bits is not None, bits or 8)
    got = kernel_order(chain, x, extras, offsets)
    want = tlp.run_chain(chain, torch.from_numpy(x),
                         [torch.from_numpy(e) for e in extras]).numpy()
    if bits is None and "sigmoid" in [op for op, _ in stages]:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_mixed_dtypes_and_sixteen_extras():
    """An int8 stream with int16 and int32 extras, 16 extras and 64 stages:
    the plan's largest case."""
    rng = np.random.default_rng(7)
    arr = [op for op in CS.Q_STAGES if op.endswith("_arr")]
    names = [arr[i % len(arr)] for i in range(16)] + list(
        rng.choice([op for op in CS.Q_STAGES if not op.endswith("_arr")], 48))
    rng.shuffle(names)
    stages, vecs, n_arr = CS.random_chain(rng, names, 129, 8)
    assert (len(stages), n_arr) == (64, 16)
    x = CS.random_stream(rng, (3, 129), 8)
    extras = [CS.random_stream(rng, (3, 129), 16 if k % 3 else 8).astype(
        np.int32 if k % 5 == 0 else (np.int16 if k % 3 else np.int8))
        for k in range(16)]
    offsets = tuple((k * e.itemsize) % 16 for k, e in enumerate([x] + extras))
    chain = tlp.Chain(tuple(stages), tuple(vecs), True, 8)
    got = kernel_order(chain, x, extras, offsets)
    plain = tlp.run_chain(chain, torch.from_numpy(x),
                          [torch.from_numpy(e) for e in extras]).numpy()
    np.testing.assert_array_equal(got, plain)
