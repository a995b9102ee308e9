// Block-sparse (block-CSR) batched product out = x @ W.T for Hopper (sm_90a).
//
// Replaces the TPU kernel `_spmv_kernel` (src/repro/kernels/spmv.py:95),
// launched through `_spmv_call` (:114, pallas_call at :118) by `spmv`
// (:135).  W is packed by `pack_bcsr` into the non-zero (bm x bk) tiles of
// each row block: data (rb, J, bm, bk), with the column block of each tile
// in col_idx (rb, J) and 1 in valid (rb, J) for a real tile.
//
// Design:
//   * One block of 256 threads per (64 batch rows, 64 rows of one row
//     block): grid = (ceil(B / 64), rb * ceil(bm / 64)).  Each thread keeps
//     a 4 x 4 micro-tile of fp32 sums in registers.
//   * A loop over j < J takes the place of the TPU's sequential grid axis.
//     The block reads valid[rb, j] and col_idx[rb, j] itself (no scalar
//     prefetch) and skips an invalid tile: zero tiles are never read.
//   * Inside a tile, 16-deep slices of x (at the tile's column block) and of
//     the tile are staged in shared memory, k-major.  Each output sums a
//     tile's k in index order and the tiles in j order, with fmaf.
//   * x is float32 (the wrapper casts it, as the reference does); the
//     ragged edges of x and of the output are masked, not padded.
//
// Bound: each kept tile is read once (the saving that PackedSpmv.density
// reports) and gives 2 * B flops per float, B / 2 per byte.  The fp32 ridge
// is 67e12 / 3.35e12 = 20 flops per byte, so below B = 40 bytes bound it
// and at B = 64 operations do, on the CUDA cores.  Tensor cores (wgmma on
// staged tiles) are the redesign.

#include <cuda_runtime.h>

#define SP_BB 64
#define SP_BR 64
#define SP_BK 16
#define SP_THREADS 256

__global__ void __launch_bounds__(SP_THREADS)
sp_kernel(const float* __restrict__ x, const float* __restrict__ data,
          const int* __restrict__ col_idx, const int* __restrict__ valid,
          float* __restrict__ out, int B, int n, int m, int J, int bm, int bk) {
  __shared__ float Xs[SP_BK][SP_BB + 4];
  __shared__ float Ws[SP_BK][SP_BR + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int sub = (bm + SP_BR - 1) / SP_BR;          // 64-row slices per row block
  const int rb = blockIdx.y / sub, r0 = (blockIdx.y % sub) * SP_BR;
  const int b0 = blockIdx.x * SP_BB;
  float acc[4][4] = {};
  for (int j = 0; j < J; ++j) {
    if (valid[rb * J + j] == 0) continue;            // uniform across the block
    const int c0 = col_idx[rb * J + j] * bk;
    const float* tile = data + ((long)rb * J + j) * bm * bk;
    for (int k0 = 0; k0 < bk; k0 += SP_BK) {
      for (int e = tid; e < SP_BB * SP_BK; e += SP_THREADS) {
        const int r = e / SP_BK, kk = e % SP_BK;
        const int bi = b0 + r, k = k0 + kk, col = c0 + k;
        Xs[kk][r] = (bi < B && k < bk && col < n) ? x[(long)bi * n + col] : 0.0f;
      }
      for (int e = tid; e < SP_BR * SP_BK; e += SP_THREADS) {
        const int r = e / SP_BK, kk = e % SP_BK;
        const int row = r0 + r, k = k0 + kk;
        Ws[kk][r] = (row < bm && k < bk) ? tile[(long)row * bk + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < SP_BK; ++kk) {
        float xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xs[kk][ty * 4 + i];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = Ws[kk][tx * 4 + q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(xv[i], wv[q], acc[i][q]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int bi = b0 + ty * 4 + i;
    if (bi >= B) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + tx * 4 + q, row = rb * bm + r;
      if (r < bm && row < m) out[(long)bi * m + row] = acc[i][q];
    }
  }
}

// out (B, m) = x (B, n) @ W.T from the packed tiles; all contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int sp_launch(const void* x, const void* data, const void* col_idx,
                         const void* valid, void* out, int B, int n, int m,
                         int rb, int J, int bm, int bk, void* stream) {
  const int sub = (bm + SP_BR - 1) / SP_BR;
  dim3 grid((B + SP_BB - 1) / SP_BB, rb * sub);
  if (grid.x == 0 || grid.y == 0) return 0;
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  sp_kernel<<<grid, SP_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)data, (const int*)col_idx,
      (const int*)valid, (float*)out, B, n, m, J, bm, bk);
  return (int)cudaGetLastError();
}
