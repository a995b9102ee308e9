"""The port's ``kernels.ops`` spmv, gemv and matmul, on the CPU, against
the JAX package's (Pallas in interpret mode), at the shapes and tolerances
of ``tests/test_kernels.py``: the host packer exactly, the products to
``rtol=5e-4, atol=1e-4`` (spmv), ``1e-3`` (gemv, float32), ``3e-2``
(gemv, bfloat16) and ``1e-4`` (matmul) against the float32 product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.build import LAUNCHES

torch.set_num_threads(1)


def _sparse(m, n, density, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, n)).astype(np.float32)
    w[rng.random((m, n)) >= density] = 0.0
    return w


def _same_pack(w, bm, bk):
    j = jops.pack_bcsr(w, bm=bm, bk=bk)
    t = ops.pack_bcsr(w, bm=bm, bk=bk, device="cpu")
    for name in ("data", "col_idx", "valid"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)
    assert (t.m, t.n, t.bm, t.bk, t.j_max, t.row_blocks) == \
        (j.m, j.n, j.bm, j.bk, j.j_max, j.row_blocks)
    assert t.density == j.density
    return t, j


@pytest.mark.parametrize("m,n,density", [
    (16, 24, 0.2), (100, 300, 0.1), (64, 64, 1.0), (33, 130, 0.4), (8, 8, 0.0),
])
def test_pack_bcsr_matches_reference(m, n, density):
    _same_pack(_sparse(m, n, density, seed=m), 16, 16)


def test_pack_bcsr_single_tile_and_density():
    w = np.zeros((256, 256), np.float32)
    w[0, 0] = 1.0
    t, _ = _same_pack(w, 32, 32)
    assert t.j_max == 1
    w = np.zeros((64, 64), np.float32)
    w[:16, :16] = 1.0
    t, _ = _same_pack(w, 16, 16)
    assert t.density == pytest.approx(1 / 16)


@pytest.mark.parametrize("m,n,density", [
    (16, 24, 0.2), (100, 300, 0.1), (64, 64, 1.0), (33, 130, 0.4), (8, 8, 0.0),
])
@pytest.mark.parametrize("batch", [1, 5, 32])
def test_spmv_matches_reference(m, n, density, batch):
    w = _sparse(m, n, density, seed=m + batch)
    x = np.random.default_rng(batch).normal(size=(batch, n)).astype(np.float32)
    t, j = _same_pack(w, 16, 16)
    got = ops.spmv(t, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (batch, m)
    want = np.asarray(jops.spmv(j, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x @ w.T, rtol=5e-4, atol=1e-4)


@pytest.mark.parametrize("m,n", [(8, 8), (128, 128), (60, 200), (255, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemv_matches_reference(m, n, dtype):
    rng = np.random.default_rng(m * n)
    w32 = rng.normal(size=(m, n)).astype(np.float32)
    x32 = rng.normal(size=(4, n)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jw, jx = jnp.asarray(w32, jdt), jnp.asarray(x32, jdt)
    want = np.asarray(jops.gemv(jw, jx).astype(jnp.float32))
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = ops.gemv(tw, tx)
    assert got.dtype == tw.dtype and got.shape == (4, m)
    ref = tx.float() @ tw.float().T
    tol = 1e-3 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(16, 16, 16), (64, 128, 32), (129, 65, 70)])
def test_matmul_matches_reference(shape):
    m, k, n = shape
    rng = np.random.default_rng(k)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    bt = rng.normal(size=(n, k)).astype(np.float32)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.matmul(a, b)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-4, atol=1e-4)
    got_t = ops.matmul(torch.from_numpy(a), torch.from_numpy(bt), transpose_b=True)
    np.testing.assert_allclose(
        got_t.numpy(), np.asarray(jops.matmul(a, bt, transpose_b=True)),
        rtol=1e-4, atol=1e-4)


def test_entry_points_check_shapes_and_launch_nothing_on_the_cpu():
    before = dict(LAUNCHES)
    t = ops.pack_bcsr(np.eye(8, dtype=np.float32), bm=4, bk=4, device="cpu")
    with pytest.raises(ValueError, match="packed n"):
        ops.spmv(t, torch.zeros(2, 7))
    with pytest.raises(ValueError, match="contraction"):
        ops.matmul(torch.zeros(3, 4), torch.zeros(5, 6))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.gemv(torch.zeros(3, 4, device="meta"), torch.zeros(2, 4, device="meta"))
    np.testing.assert_array_equal(ops.spmv(t, torch.ones(2, 8)).numpy(),
                                  np.ones((2, 8), np.float32))
    assert dict(LAUNCHES) == before
