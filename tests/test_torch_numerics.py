"""Fixed-point helpers of the port, bit for bit against the JAX package.

Random int32 accumulators (small, large and near the carrier's edges) go
through ``repro.core.quantize`` and ``repro_torch.core.quantize`` alike:
right shifts above and at the 24-bit cap, left shifts at and past the
``30 − lsh`` clamp, saturation at ±q_max, and half-to-even ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.classical import build as jbuild
from repro.configs.classical import training_split
from repro.core import quantize as jq
from repro_torch.configs.classical import build as tbuild
from repro_torch.core import quantize as tq

torch.set_num_threads(1)

BITS = [8, 16]
SHIFTS = [-40, -17, -9, -8, -1, 0, 1, 2, 7, 23, 24, 25, 31]


def _accs(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    parts = [rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64),
             rng.integers(-300, 300, n),
             rng.integers(-(2**20), 2**20, n),
             np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**30, -(2**30),
                       127, -127, 128, -128, 32767, -32768])]
    return np.concatenate(parts).astype(np.int32)


def test_scalar_helpers_match():
    for bits in BITS:
        assert tq.q_max(bits) == jq.q_max(bits)
        assert tq.align_cap(bits) == jq.align_cap(bits)
        assert tq.int_dtype(bits) == jq.int_dtype(bits)
    for m in [0.0, -1.0, float("inf"), float("nan"), 1e-9, 0.37, 1.0, 127.0,
              128.0, 3e5, 1e12]:
        for bits in BITS:
            assert tq.pow2_exp(m, bits) == jq.pow2_exp(m, bits), m
    with pytest.raises(ValueError):
        tq.int_dtype(4)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shift", SHIFTS)
def test_requantize_core_bitwise(bits, shift):
    acc = _accs(seed=shift + 100 * bits)
    want = np.asarray(jq.requantize_core(jnp.asarray(acc), shift, bits))
    got = tq.requantize_core(torch.from_numpy(acc), shift, bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_n = np.asarray(jq.requantize_i32(jnp.asarray(acc), shift, bits))
    got_n = tq.requantize_i32(torch.from_numpy(acc), shift, bits).numpy()
    assert got_n.dtype == want_n.dtype
    np.testing.assert_array_equal(got_n, want_n)


@pytest.mark.parametrize("bits", BITS)
def test_requantize_rows_bitwise(bits):
    acc = _accs(seed=7 + bits).reshape(-1)[:4096 * 3].reshape(3, -1)
    rng = np.random.default_rng(bits)
    shifts = rng.choice(SHIFTS, size=acc.shape[1]).astype(np.int64)
    want = np.asarray(jq.requantize_rows(jnp.asarray(acc), shifts, bits))
    got = tq.requantize_rows(torch.from_numpy(acc), shifts, bits).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("exp", [-21, -3, 0, 4, 9, 21])
def test_quantize_and_dequantize_bitwise(bits, exp):
    rng = np.random.default_rng(exp + 50)
    x = np.concatenate([
        rng.standard_normal(2048) * 2.0 ** (-exp) * 40,
        # exact half-way points at this scale: ties go to even
        (np.arange(-40, 40) + 0.5) * 2.0 ** (-exp),
        [0.0, -0.0, 1e30, -1e30],
    ]).astype(np.float32)
    want = np.asarray(jq.quantize_core(jnp.asarray(x), exp, bits))
    got = tq.quantize_core(torch.from_numpy(x), exp, bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_t = np.asarray(jq.quantize_jnp(jnp.asarray(x), exp, bits))
    got_t = tq.quantize_t(torch.from_numpy(x), exp, bits).numpy()
    assert got_t.dtype == want_t.dtype
    np.testing.assert_array_equal(got_t, want_t)
    q = want_t.astype(np.int32)
    np.testing.assert_array_equal(
        tq.dequantize(torch.from_numpy(q), exp).numpy(),
        np.asarray(jq.dequantize(jnp.asarray(q), exp)))
    ties = (np.arange(-40, 40) + 0.5)
    np.testing.assert_array_equal(
        tq.quantize_core(torch.from_numpy((ties * 2.0 ** (-exp)).astype(np.float32)),
                         exp, bits).numpy(),
        np.clip(np.round(ties), -tq.q_max(bits), tq.q_max(bits)))


def test_quantize_np_matches():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    for bits in BITS:
        for e in (-2, 0, 5, np.array([0, 1, 2, 3, 4])):
            a, b = tq.quantize_np(w, e, bits), jq.quantize_np(w, e, bits)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bench", ["bonsai/usps-b", "protonn/letter-m"])
@pytest.mark.parametrize("bits,per_channel", [(8, False), (16, True)])
def test_calibrate_matches_reference(bench, bits, per_channel):
    """Calibration walks the DFG with the port's float templates on the CPU
    and lands on the reference's exponents and quantized parameters."""
    jdfg, _, _ = jbuild(bench)
    tdfg, _, _ = tbuild(bench)
    X, _ = training_split(bench)
    jp = jq.calibrate(jdfg, X[:128], bits=bits, per_channel=per_channel)
    tp = tq.calibrate(tdfg, X[:128], bits=bits, per_channel=per_channel)
    assert tp.input_exps == jp.input_exps and tp.bits == jp.bits
    assert tp.nodes.keys() == jp.nodes.keys()
    for nid, jn in jp.nodes.items():
        tn = tp.nodes[nid]
        assert tn.in_exps == jn.in_exps and tn.out_exp == jn.out_exp, nid
        assert tn.params_q.keys() == jn.params_q.keys(), nid
        for k in jn.params_q:
            a, b = np.asarray(tn.params_q[k]), np.asarray(jn.params_q[k])
            assert a.dtype == b.dtype, (nid, k)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(np.asarray(tn.param_exps[k]),
                                          np.asarray(jn.param_exps[k]))
