"""The fused chain functions, on the CPU, against the JAX package's.

The same seeded stage programs and inputs go through
``repro.kernels.linear_pipeline.fused_linear_chain``/``_q`` (Pallas in
interpret mode) and the port's (on a CPU tensor, the plain version).
Float32 agrees to ``rtol=atol=1e-5``; integer outputs agree exactly, except
that a chain with a ``q_unary`` stage may differ by 1 LSB (XLA's and
torch's transcendentals may differ by an ulp); the count is printed.

The CUDA kernel cannot run here, but what it reads can: ``pack_chain``
turns a chain into a stage table, a float side table and a vec pool, and
``_emulate`` below walks them with the kernel's semantics
(``csrc/linear_chain.cu``).  It must equal the plain version exactly (the
float ``sigmoid`` stage to ``1e-6``: the kernel computes
``1 / (1 + exp(-x))``, the plain version ``torch.sigmoid``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import linear_pipeline as jlp
from repro_torch.kernels import linear_pipeline as tlp
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.ref import linear_chain_q_ref, linear_chain_ref
from test_torch_pack import _align, _chip_smoke, _requant

torch.set_num_threads(1)

CS = _chip_smoke()
SHAPES = [(976,), (3, 40), (2, 3, 40)]
_T_UNARY = [torch.tanh, lambda x: 1.0 / (1.0 + torch.exp(-x)),
            lambda x: torch.clamp_min(x, 0.0), torch.exp]


def _program(seed, bits, shape):
    """Every stage of the vocabulary, in a seeded order, plus a second
    seeded draw: programs of 2x the vocabulary's length."""
    rng = np.random.default_rng(seed)
    pool = CS.FLOAT_STAGES if bits is None else CS.Q_STAGES
    names = list(rng.permutation(pool)) + list(rng.choice(pool, len(pool)))
    stages, vecs, n_arr = CS.random_chain(rng, names, shape[-1], bits)
    x = CS.random_stream(rng, shape, bits)
    extras = [CS.random_stream(rng, shape, bits) for _ in range(n_arr)]
    return stages, vecs, x, extras


def _jax(stages, vecs, x, extras, bits):
    if bits is None:
        st = [(op, jnp.asarray(v) if op.endswith("_vec") else v)
              for op, v in stages]
        return np.asarray(jlp.fused_linear_chain(
            jnp.asarray(x), st, [jnp.asarray(e) for e in extras]))
    return np.asarray(jlp.fused_linear_chain_q(
        jnp.asarray(x), stages, [jnp.asarray(v) for v in vecs],
        [jnp.asarray(e) for e in extras], bits=bits))


def _port(stages, vecs, x, extras, bits):
    xs = [torch.from_numpy(e) for e in extras]
    if bits is None:
        return tlp.fused_linear_chain(torch.from_numpy(x), stages, xs).numpy()
    return tlp.fused_linear_chain_q(torch.from_numpy(x), stages, vecs, xs,
                                    bits=bits).numpy()


def _compare(got, want, stages):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return 0
    d = np.abs(got.astype(np.int64) - want)
    if any(op == "q_unary" for op, _ in stages):
        assert d.max() <= 1
        return int((d == 1).sum())
    np.testing.assert_array_equal(got, want)
    return 0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"rank{len(s)}")
@pytest.mark.parametrize("bits", [None, 8, 16], ids=["float", "int8", "int16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_chain_matches_reference(seed, bits, shape):
    stages, vecs, x, extras = _program(seed, bits, shape)
    got = _port(stages, vecs, x, extras, bits)
    lsb = _compare(got, _jax(stages, vecs, x, extras, bits), stages)
    print(f"1-LSB elements: {lsb}")


@pytest.mark.parametrize("bits", [None, 8, 16], ids=["float", "int8", "int16"])
def test_chain_with_three_extras(bits):
    """Three ``*_arr`` operands, read in stage order, beside a vec stage."""
    names = (["hadamard_arr", "add_arr", "tanh", "sub_arr", "add_vec"]
             if bits is None else
             ["q_hadamard_arr", "q_add_arr", "q_unary", "q_sub_arr",
              "q_add_vec"])
    rng = np.random.default_rng(5)
    stages, vecs, n_arr = CS.random_chain(rng, names, 976, bits)
    assert n_arr == 3
    x = CS.random_stream(rng, (64, 976), bits)
    extras = [CS.random_stream(rng, (64, 976), bits) for _ in range(3)]
    got = _port(stages, vecs, x, extras, bits)
    _compare(got, _jax(stages, vecs, x, extras, bits), stages)


# ------------------------------------------------------ packed stage table
def _emulate(pk, x, extras, quantized, bits):
    """Walk the packed stage table over the flattened stream, as the
    kernel's threads do (one element each, same stage order)."""
    T, F, V = pk["table"], pk["ftable"], pk["vecs"]
    n = x.shape[-1]
    col = np.arange(x.size) % n
    flat = [e.reshape(-1) for e in extras]
    v = x.reshape(-1).astype(np.int32 if quantized else np.float32)
    for t, g in zip(T, F):
        st, opnd, vlen, p0, p1, p2 = (int(a) for a in t)
        o = None
        if st in (1, 2, 3, 17, 18, 19):                      # *_vec
            o = V[opnd + (0 if vlen == 1 else col)]
        elif st in (8, 9, 10, 20, 21, 22):                   # *_arr
            o = flat[opnd].astype(V.dtype)
        if st < 16:
            vt = torch.from_numpy(v)
            v = {0: lambda: v * np.float32(g[0]), 1: lambda: v + o,
                 2: lambda: v - o, 3: lambda: v * o, 8: lambda: v + o,
                 9: lambda: v - o, 10: lambda: v * o,
                 }.get(st, lambda: _T_UNARY[st - 4](vt).numpy())()
        elif st == 23:                                       # q_unary
            y = _T_UNARY[p0](torch.from_numpy(v.astype(np.float32))
                             * float(g[1])).numpy()
            with np.errstate(over="ignore"):             # exp → inf saturates
                q = np.rint(y * np.float32(g[2]))
            qm = np.float32((1 << (bits - 1)) - 1)
            v = np.clip(q, -qm, qm).astype(np.int32)
        elif st == 16:                                       # q_scalar_mul
            v = _requant((v.astype(np.int64) * p0).astype(np.int32), p1, bits)
        elif st in (19, 22):                                 # q_hadamard
            v = _requant((v.astype(np.int64) * o).astype(np.int32), p2, bits)
        else:                                                # q_add / q_sub
            sign = 1 if st in (17, 20) else -1
            acc = _align(v, p0) + sign * _align(o, p1)
            v = _requant(acc.astype(np.int32), p2, bits)
    return v.astype(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("bits", [None, 8, 16], ids=["float", "int8", "int16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_table_runs_like_the_plain_version(seed, bits):
    stages, vecs, x, extras = _program(seed, bits, (3, 40))
    if bits is None:                       # a length-1 vec broadcasts
        stages.append(("add_vec", np.float32([0.25])))
    else:
        vecs.append(np.asarray([3], f"int{bits}"))
        stages.append(("q_add_vec", (len(vecs) - 1, 0, 1, 1)))
    chain = tlp.Chain(tuple(stages), tuple(vecs), bits is not None, bits or 8)
    pk = tlp.pack_chain(chain)
    assert pk["table"].shape == (len(stages), 6)
    got = _emulate(pk, x, extras, bits is not None, bits)
    xs = [torch.from_numpy(e) for e in extras]
    want = tlp.run_chain(chain, torch.from_numpy(x), xs).numpy()
    assert got.dtype == want.dtype
    if bits is None and any(op == "sigmoid" for op, _ in stages):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_plain_version_is_the_ref_and_launches_nothing():
    """On a CPU tensor the wrappers run ``linear_chain_ref``/``_q_ref`` and
    count no launch; another device type raises."""
    before = dict(LAUNCHES)
    for bits in (None, 8):
        stages, vecs, x, extras = _program(3, bits, (4, 40))
        xt, xs = torch.from_numpy(x), [torch.from_numpy(e) for e in extras]
        got = _port(stages, vecs, x, extras, bits)
        if bits is None:
            st = [(op, torch.from_numpy(v) if op.endswith("_vec") else v)
                  for op, v in stages]
            want = linear_chain_ref(xt, st, xs)
        else:
            want = linear_chain_q_ref(xt, stages,
                                      [torch.from_numpy(v) for v in vecs], xs,
                                      bits=bits)
        np.testing.assert_array_equal(got, want.numpy())
        with pytest.raises(ValueError, match="cuda or cpu"):
            tlp.run_chain(tlp.Chain(tuple(stages), tuple(vecs),
                                    bits is not None), xt.to("meta"), [])
    assert dict(LAUNCHES) == before


def test_pack_rejects_a_stage_of_the_other_vocabulary():
    with pytest.raises(ValueError, match="fixed-point"):
        tlp.pack_chain(tlp.Chain((("tanh", None),), (), True))
    with pytest.raises(ValueError, match="float"):
        tlp.pack_chain(tlp.Chain((("q_scalar_mul", (3, 1)),)))
