// Block-sparse (block-CSR) batched product out = x @ W.T for Hopper (sm_90a).
//
// Replaces the TPU kernel `_spmv_kernel` (src/repro/kernels/spmv.py:95),
// launched through `_spmv_call` (:114, pallas_call at :118) by `spmv`
// (:135).  W is packed by `pack_bcsr` into the non-zero (bm x bk) tiles of
// each row block: data (rb, J, bm, bk), with the column block of each tile
// in col_idx (rb, J) and 1 in valid (rb, J) for a real tile.
//
// Bound: each kept tile is read once (the saving that PackedSpmv.density
// reports) and gives 2 * B flops per float, B / 2 per byte.  The fp32 ridge
// is 67e12 / 3.35e12 = 20 flops per byte, so below B = 40 bytes bound it
// and at B = 64 operations do, on the CUDA cores (TF32 stays off by the
// port's parity contract).  At the served sizes the work is small (one row
// block of 24 rows for bonsai/curet-m's Zx; ~100 kept tiles at 4096^2 and
// 10 %), so what bounds the kernel is how many SMs it keeps busy.
//
// Design:
//   * The grid covers only work that exists: blockIdx.x takes 32 batch
//     rows, blockIdx.y one 64-row slice of a row block among the slices
//     that hold rows below m (Zx: one slice, not two), blockIdx.z one slice
//     of the row block's kept tiles.
//   * Where batch tiles x row slices fall below one wave, the kept tiles of
//     each row block are split into `splits` slices of whole tiles (as
//     gemv.cu splits K); each slice writes fp32 partial sums to a workspace
//     and sp_reduce sums them in slice order: deterministic, no atomics.  A
//     slice with no tile, or a row block with no kept tile, writes zeros.
//   * A block counts its row block's kept tiles and lists its slice's share
//     in shared memory (valid and col_idx read together, SP_THREADS slots
//     at a time), then walks them in j order in 128-deep k steps (a whole
//     tile at the default bk = 128), two stages in flight by cp.async: x's gathered columns and the tile's rows as
//     16-byte copies where aligned (x's rows with n % 4 == 0, the tiles with
//     bk % 4 == 0), 4-byte ones with zero fill else (Zx: n = 610); rows past
//     m and columns past n or bk are zero-filled, never read.
//   * 128 threads, 4 batch rows x 4 W rows of fp32 sums each in registers,
//     fed by 16-byte shared loads of 4 k at a time: 8 loads per 64 FMAs.
//     Timed on the card against 64 x 64 blocks, 8 x 4 and 8 x 8 sums per
//     thread, 32- and 64-deep k steps and three or four stages: each step
//     waits on its loads, so fewer, deeper steps and more, smaller blocks
//     cut the time most.
//     Each output sums a tile's k in index order, the tiles in j order, and
//     the slices in order, with fmaf.
//   * x is float32 (the wrapper casts it, as the reference does).

#include "hopper.cuh"

#define SP_BB 32          // batch rows per block
#define SP_BR 64          // W rows per block: one slice of a row block
#define SP_BK 128         // k per stage
#define SP_PAD 4          // padded rows, still 16-byte aligned
#define SP_THREADS 128
#define SP_STAGE_FLOATS ((SP_BB + SP_BR) * (SP_BK + SP_PAD))

struct SpArgs {
  const float* x; const float* data; const int* col_idx; const int* valid;
  float* out;                      // out, or the workspace when split
  int B, n, m, J, bm, bk, sub, splits, cap, vx, vw;
};

__global__ void __launch_bounds__(SP_THREADS)
sp_kernel(SpArgs a) {
  typedef float Row[SP_BK + SP_PAD];
  extern __shared__ __align__(16) float smem[];
  Row* Xs = reinterpret_cast<Row*>(smem);             // [2][SP_BB] x rows
  Row* Ws = Xs + 2 * SP_BB;                           // [2][SP_BR] tile rows
  int* tab = reinterpret_cast<int*>(Ws + 2 * SP_BR);  // [cap] j, [cap] column
  __shared__ int wsum[SP_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % 16, ty = tid / 16;
  const int r = blockIdx.y / a.sub, r0 = (blockIdx.y % a.sub) * SP_BR;
  const int b0 = blockIdx.x * SP_BB, z = blockIdx.z;
  const int rows = min(SP_BR, min(a.bm, a.m - r * a.bm) - r0);   // >= 1
  const int* valid = a.valid + (long long)r * a.J;
  const int* cols = a.col_idx + (long long)r * a.J;

  // The row block's kept tiles, counted SP_THREADS slots at a time (the
  // first slots' valid and col_idx loaded together), then the slice's
  // share [t0, t1) of them listed in j order in shared memory.
  const bool v0 = tid < a.J && valid[tid] != 0;
  const int col0 = tid < a.J ? cols[tid] : 0;
  int kept = __syncthreads_count(v0);
  for (int c = SP_THREADS; c < a.J; c += SP_THREADS)
    kept += __syncthreads_count(c + tid < a.J && valid[c + tid] != 0);
  const int t0 = (int)((long long)z * kept / a.splits);
  const int t1 = (int)((long long)(z + 1) * kept / a.splits);
  for (int c = 0, base = 0; c < a.J && base < t1; c += SP_THREADS) {
    const int j = c + tid;
    const bool v = c == 0 ? v0 : (j < a.J && valid[j] != 0);
    const unsigned mask = __ballot_sync(0xffffffffu, v);
    if (lane == 0) wsum[warp] = __popc(mask);
    __syncthreads();
    int t = base + __popc(mask & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < SP_THREADS / 32; ++w) {
      t += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
    if (v && t >= t0 && t < t1) {
      tab[t - t0] = j;
      tab[a.cap + t - t0] = c == 0 ? col0 : cols[j];
    }
    base += total;
    __syncthreads();
  }
  const int nks = (a.bk + SP_BK - 1) / SP_BK;
  const int steps = (t1 - t0) * nks;

  // Stage k step `step`: SP_BK columns of tile step / nks.
  auto stage = [&](int buf, int step) {
    const int i = step / nks, k0 = (step - i * nks) * SP_BK;
    const int c0 = tab[a.cap + i] * a.bk + k0;
    const float* tile = a.data + ((long long)r * a.J + tab[i]) * a.bm * a.bk;
    if (a.vx) {
      for (int c = tid; c < SP_BB * (SP_BK / 4); c += SP_THREADS) {
        const int bi = b0 + c / (SP_BK / 4), kq = (c % (SP_BK / 4)) * 4;
        const bool ok = bi < a.B && k0 + kq < a.bk && c0 + kq < a.n;
        hp_cp16(&Xs[buf * SP_BB + bi - b0][kq],
                ok ? a.x + (long long)bi * a.n + c0 + kq : a.x, ok);
      }
    } else {
      for (int c = tid; c < SP_BB * SP_BK; c += SP_THREADS) {
        const int bi = b0 + c / SP_BK, kk = c % SP_BK;
        const bool ok = bi < a.B && k0 + kk < a.bk && c0 + kk < a.n;
        hp_cp4(&Xs[buf * SP_BB + bi - b0][kk],
               ok ? a.x + (long long)bi * a.n + c0 + kk : a.x, ok);
      }
    }
    if (a.vw) {
      for (int c = tid; c < SP_BR * (SP_BK / 4); c += SP_THREADS) {
        const int ri = c / (SP_BK / 4), kq = (c % (SP_BK / 4)) * 4;
        const bool ok = ri < rows && k0 + kq < a.bk;
        hp_cp16(&Ws[buf * SP_BR + ri][kq],
                ok ? tile + (long long)(r0 + ri) * a.bk + k0 + kq : a.data, ok);
      }
    } else {
      for (int c = tid; c < SP_BR * SP_BK; c += SP_THREADS) {
        const int ri = c / SP_BK, kk = c % SP_BK;
        const bool ok = ri < rows && k0 + kk < a.bk;
        hp_cp4(&Ws[buf * SP_BR + ri][kk],
               ok ? tile + (long long)(r0 + ri) * a.bk + k0 + kk : a.data, ok);
      }
    }
    hp_cp_commit();
  };

  // 4 batch rows (ty * 4 + i) x 4 W rows (tx + 16 q) per thread
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  if (steps > 0) stage(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      stage(buf ^ 1, step + 1);
      hp_cp_wait<1>();
    } else {
      hp_cp_wait<0>();
    }
    __syncthreads();
    const int k0 = (step % nks) * SP_BK;
    const int kend = min(SP_BK, a.bk - k0);        // columns past it are zeros
#pragma unroll 4
    for (int kg = 0; kg < kend; kg += 4) {
      float xv[4][4], wv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(xv[i]) =
            *reinterpret_cast<const float4*>(&Xs[buf * SP_BB + ty * 4 + i][kg]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(wv[q]) =
            *reinterpret_cast<const float4*>(&Ws[buf * SP_BR + tx + 16 * q][kg]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[i][q] = fmaf(xv[i][kk], wv[q][kk], acc[i][q]);
    }
    __syncthreads();
  }

  float* o = a.out + (long long)z * a.B * a.m;       // slice z when split
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int bi = b0 + ty * 4 + i;
    if (bi >= a.B) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int rr = tx + 16 * q;
      if (rr < rows) o[(long long)bi * a.m + r * a.bm + r0 + rr] = acc[i][q];
    }
  }
}

// out[i] = sum over slices z, in order, of ws[z][i].
__global__ void sp_reduce(const float* __restrict__ ws, float* __restrict__ out,
                          long long total, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += ws[z * total + i];
    out[i] = s;
  }
}

// The 64-row slices that hold rows below m: every row block but the last
// has ceil(bm / 64), the last only those below m.
static int sp_slices(int m, int bm, int sub) {
  const int rb = (m + bm - 1) / bm;
  return (rb - 1) * sub + (m - (rb - 1) * bm + SP_BR - 1) / SP_BR;
}

// out (B, m) = x (B, n) @ W.T from the packed tiles; all contiguous, x and
// data float32.  `splits` slices of each row block's kept tiles (1: no
// split); with more, ws holds splits * B * m floats.  Returns
// cudaGetLastError() after the launches (0 = launched), or the error of a
// refused shared-memory grant.
extern "C" int sp_launch(const void* x, const void* data, const void* col_idx,
                         const void* valid, void* out, void* ws, int B, int n,
                         int m, int rb, int J, int bm, int bk, int splits,
                         void* stream) {
  if (B == 0 || m == 0) return 0;
  if (rb != (m + bm - 1) / bm || J < 1 || splits < 1 || splits > J ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int sub = (bm + SP_BR - 1) / SP_BR;
  dim3 grid((B + SP_BB - 1) / SP_BB, sp_slices(m, bm, sub), splits);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const int cap = (J + splits - 1) / splits;      // tiles of a slice, at most
  const int smem = (2 * SP_STAGE_FLOATS + 2 * cap) * (int)sizeof(float);
  static int granted[HP_MAX_DEVICES] = {0};
  int e = hp_grant_smem((const void*)sp_kernel, smem, granted);
  if (e) return e;
  const bool vx = (uintptr_t)x % 16 == 0 && n % 4 == 0 && bk % 4 == 0;
  const bool vw = (uintptr_t)data % 16 == 0 && bk % 4 == 0;
  SpArgs a{(const float*)x, (const float*)data, (const int*)col_idx,
           (const int*)valid, (float*)(splits > 1 ? ws : out), B, n, m, J, bm,
           bk, sub, splits, cap, vx, vw};
  cudaStream_t s = (cudaStream_t)stream;
  sp_kernel<<<grid, SP_THREADS, smem, s>>>(a);
  e = (int)cudaGetLastError();
  if (e || splits == 1) return e;
  const long long total = (long long)B * m;
  const int blocks = (int)((total + 255) / 256 < 1184 ? (total + 255) / 256 : 1184);
  sp_reduce<<<blocks, 256, 0, s>>>((const float*)ws, (float*)out, total, splits);
  return (int)cudaGetLastError();
}
