"""The split-tile plan of the spmv kernel, on the CPU.

``csrc/spmv.cu`` cannot run here, so its order of work is emulated in this
file (not in the port): ``plan_spmv`` gives blocks only to the 64-row
slices of a row block that hold rows below m, and below one wave of blocks
splits each row block's kept tiles into slices of whole tiles
(``SpmvPlan.tile_bounds``); each slice sums x's gathered columns times its
tiles in j order into an fp32 partial, and the partials are summed in slice
order.  A slice with no tile, or a row block with no kept tile, gives
zeros.  Inputs are numpy seeds: bonsai/curet-m's Zx shape (24 × 610 at
128² tiles), ragged shapes at 16² tiles, a 512² weight at 10 % of its 128²
tiles, and a weight with an all-zero row block.

Limits: ``rtol = 5e-4, atol = 1e-4`` against the Pallas kernel in interpret
mode and against the dense ``x @ W.T`` (``tests/test_kernels.py``'s spmv
tolerance): the sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import spmv as jspmv
from repro_torch.kernels.spmv import PackedSpmv, SpmvPlan, pack_bcsr, plan_spmv

torch.set_num_threads(1)

SMS = 132
TOL = dict(rtol=5e-4, atol=1e-4)


def _weight(m, n, density, b, seed, zero_row_block=None):
    """A seeded (m, n) weight whose (b × b) tiles are each kept with
    probability ``density``."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, n)).astype(np.float32)
    keep = rng.random((-(-m // b), -(-n // b))) < density
    if zero_row_block is not None:
        keep[zero_row_block] = False
    return w * np.kron(keep, np.ones((b, b), np.float32))[:m, :n]


def kernel_plan(packed: PackedSpmv, x: torch.Tensor, plan: SpmvPlan) -> torch.Tensor:
    """The kernel's order of sums in float32 → (B, m)."""
    B, bm, bk = x.shape[0], packed.bm, packed.bk
    xp = torch.nn.functional.pad(x, (0, -packed.n % bk))
    out = torch.zeros(B, packed.row_blocks * bm)
    valid, cols = packed.valid.numpy(), packed.col_idx.numpy()
    for r in range(packed.row_blocks):
        kept = [j for j in range(packed.j_max) if valid[r, j]]
        parts = []
        for t0, t1 in plan.tile_bounds(len(kept)):
            acc = torch.zeros(B, bm)
            for j in kept[t0:t1]:
                c = int(cols[r, j])
                acc = acc + xp[:, c * bk:(c + 1) * bk] @ packed.data[r, j].float().T
            parts.append(acc)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        out[:, r * bm:(r + 1) * bm] = total
    return out[:, :packed.m]


CASES = [  # (m, n, density, tile, B, zero row block)
    (24, 610, 1.0, 128, 64, None), (24, 610, 1.0, 128, 1, None),
    (100, 300, 0.3, 16, 5, 2), (33, 130, 0.4, 16, 37, None),
    (512, 512, 0.1, 128, 64, None), (256, 384, 0.5, 128, 64, 0),
    (8, 8, 0.0, 16, 3, None)]


@pytest.mark.parametrize("m,n,density,tile,B,zero", CASES, ids=str)
def test_split_plan_matches_pallas_and_dense(m, n, density, tile, B, zero):
    w = _weight(m, n, density, tile, seed=m + n, zero_row_block=zero)
    x = np.random.default_rng(B).standard_normal((B, n)).astype(np.float32)
    packed = pack_bcsr(w, bm=tile, bk=tile, device="cpu")
    plan = plan_spmv(B, m, tile, packed.j_max, SMS)
    got = kernel_plan(packed, torch.from_numpy(x), plan).numpy()
    want = np.asarray(jspmv.spmv(jspmv.pack_bcsr(w, bm=tile, bk=tile),
                                 jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, x @ w.T, **TOL)
    if zero is not None:
        assert not packed.valid[zero].any()
        np.testing.assert_array_equal(got[:, zero * tile:(zero + 1) * tile], 0.0)


def test_slices_beyond_m_get_no_block():
    """Zx (24 rows at bm = 128) takes one 64-row slice, not two; a row
    block cut by m keeps only its slices below m."""
    assert plan_spmv(64, 24, 128, 5, SMS).slices == 1
    assert plan_spmv(64, 128, 128, 5, SMS).slices == 2
    assert plan_spmv(64, 300, 128, 3, SMS).slices == 2 + 2 + 1
    assert plan_spmv(64, 4096, 128, 7, SMS).slices == 64
    assert plan_spmv(5, 100, 16, 3, SMS).slices == 7      # one per 16-row block


@pytest.mark.parametrize("B,m,bm,j_max", [
    (64, 24, 128, 5), (1, 24, 128, 5), (64, 4096, 128, 7), (64, 4096, 128, 1),
    (37, 1000, 64, 16), (300, 4096, 128, 7), (5, 100, 16, 3), (1, 16384, 128, 9)])
def test_split_counts_follow_the_wave_rule(B, m, bm, j_max):
    """Splits only below one wave of blocks: enough for one wave, at most
    one per tile slot; the slices partition the kept tiles in order."""
    plan = plan_spmv(B, m, bm, j_max, SMS)
    tiles = plan.batch_tiles * plan.slices
    assert plan.batch_tiles == -(-B // 32)
    if tiles >= SMS:
        assert plan.splits == 1
    else:
        assert plan.splits == min(j_max, -(-SMS // tiles))
    for kept in range(j_max + 1):
        bounds = plan.tile_bounds(kept)
        assert len(bounds) == plan.splits and bounds[0][0] == 0
        assert bounds[-1][1] == kept
        assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(bounds, bounds[1:]))


def test_served_shapes():
    """Zx at B = 64: two batch tiles, one slice, its 5 kept tiles one per
    slice (10 blocks, 2 in PR 14's kernel); 4096² at B = 64: 128 blocks
    before the split, so 2 slices of kept tiles each."""
    assert plan_spmv(64, 24, 128, 5, SMS) == SpmvPlan(2, 1, 5)
    assert plan_spmv(64, 4096, 128, 7, SMS) == SpmvPlan(2, 64, 2)
