"""The matmul planner (``repro_torch.kernels.gemv.plan_matmul``) on the CPU.

The plan is pure Python over shapes, dtype, pointers and the SM count, so
its choices can be held here at the shapes the card tests and
``chip_smoke.py``'s report use, at the H100's 132 SMs: the split-K slices
partition K into whole k-tiles in order, split-K is chosen only when the
output has fewer tiles than SMs, TMA staging only for 16-byte-aligned bases
and pitches, and bfloat16 always routes to the wgmma kernel.
"""

import pytest
import torch

from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.gemv import MatmulPlan, matmul, plan_matmul

SMS = 132
# (M, K, N): tests/test_torch_kernel_cuda.py's and chip_smoke.py's shapes
SHAPES = [(129, 65, 70), (8, 8, 8), (255, 33, 60), (64, 610, 24),
          (128, 128, 128), (1024, 1024, 1024), (64, 4096, 4096),
          (2048, 1020, 2100), (4096, 4096, 4096), (16, 16, 16),
          (64, 128, 32)]
DTYPES = [torch.float32, torch.bfloat16]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_splits_k_into_whole_tiles_only_when_tiles_are_few(shape, dtype,
                                                                  transpose_b):
    M, K, N = shape
    plan = plan_matmul(M, N, K, dtype, transpose_b, 0, 1 << 20, SMS)
    assert plan.tiles == _cdiv(M, plan.bm) * _cdiv(N, plan.bn)
    assert plan.k_tiles == _cdiv(K, plan.bk)
    bounds = plan.k_bounds()
    assert len(bounds) == plan.splits
    assert bounds[0][0] == 0 and bounds[-1][1] == plan.k_tiles
    for (_, hi), (lo, _) in zip(bounds, bounds[1:]):
        assert hi == lo                          # in order, no gap, no overlap
    assert all(hi > lo for lo, hi in bounds)      # every slice has a tile
    assert (plan.splits > 1) == (plan.tiles < SMS and plan.k_tiles > 1)
    if plan.splits > 1:                          # one wave, or one slice per tile
        assert (plan.tiles * plan.splits >= SMS
                or plan.splits == plan.k_tiles)
    assert plan.bm == (64 if M <= 64 else 128)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bfloat16_always_routes_to_wgmma_and_float32_to_the_cuda_cores(shape):
    M, K, N = shape
    for tb in (False, True):
        for a_ptr in (0, 2, 6):
            plan = plan_matmul(M, N, K, torch.bfloat16, tb, a_ptr, 0, SMS)
            assert (plan.kernel, plan.bn, plan.bk) == ("wgmma", 128, 64)
            assert plan.staging in ("tma", "threads")
            plan = plan_matmul(M, N, K, torch.float32, tb, a_ptr, 0, SMS)
            assert (plan.kernel, plan.staging, plan.bk) == ("simt", "cp.async",
                                                            16)


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("a_ptr,b_ptr", [(0, 0), (512, 4096), (2, 0),
                                         (0, 8), (16, 48)])
def test_tma_staging_only_for_16_byte_aligned_bases_and_pitches(
        shape, transpose_b, a_ptr, b_ptr):
    M, K, N = shape
    plan = plan_matmul(M, N, K, torch.bfloat16, transpose_b, a_ptr, b_ptr, SMS)
    pitch_b = K if transpose_b else N
    aligned = (a_ptr % 16 == 0 and b_ptr % 16 == 0 and (2 * K) % 16 == 0
               and (2 * pitch_b) % 16 == 0)
    assert plan.staging == ("tma" if aligned else "threads")


def test_served_shapes_plans():
    """The report's rows: gemv 4096² and 24 × 610 at B = 64, matmul 4096³."""
    gemv_4k = plan_matmul(64, 4096, 4096, torch.bfloat16, True, 0, 0, SMS)
    assert gemv_4k == MatmulPlan("wgmma", "tma", 64, 128, 64, 32, 64, 5)
    gemv_zx = plan_matmul(64, 24, 610, torch.bfloat16, True, 0, 0, SMS)
    assert gemv_zx == MatmulPlan("wgmma", "threads", 64, 128, 64, 1, 10, 10)
    assert plan_matmul(4096, 4096, 4096, torch.bfloat16, False, 0, 0,
                       SMS).splits == 1
    f32 = plan_matmul(64, 4096, 4096, torch.float32, True, 0, 0, SMS)
    assert (f32.bm, f32.tiles, f32.splits) == (64, 32, 5)
    zx = plan_matmul(64, 24, 610, torch.float32, True, 0, 0, SMS)
    assert zx.splits == zx.k_tiles == 39
    assert plan_matmul(4096, 4096, 4096, torch.float32, False, 0, 0,
                       SMS).splits == 1


def test_plan_rejects_other_dtypes_and_cpu_matmul_launches_nothing():
    with pytest.raises(TypeError):
        plan_matmul(4, 4, 4, torch.float16, False, 0, 0, SMS)
    before = dict(LAUNCHES)
    a = torch.randn(5, 0)
    assert torch.equal(matmul(a, torch.randn(0, 3)), torch.zeros(5, 3))
    got = matmul(torch.ones(3, 4, dtype=torch.bfloat16),
                 torch.ones(2, 4, dtype=torch.bfloat16), transpose_b=True)
    assert got.dtype == torch.bfloat16 and torch.equal(got.float(),
                                                       torch.full((3, 2), 4.0))
    assert dict(LAUNCHES) == before
