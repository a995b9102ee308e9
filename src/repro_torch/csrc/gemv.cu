// Dense matmul / batched GEMV for Hopper (sm_90a).
//
// Replaces the TPU kernel `_matmul_kernel` (src/repro/kernels/gemv.py:25),
// launched through `_matmul_call` (:51, pallas_call at :59) by `matmul`
// (:74) and `gemv` (:97): c = a @ b or a @ b.T with fp32 accumulation, the
// result cast to a's dtype (float32 or bfloat16).  The TPU kernel's
// sequential k grid axis becomes a loop inside each block; where the output
// has fewer tiles than the card has SMs, K is split in whole k-tiles over
// blockIdx.z, each slice writes fp32 partial sums to a workspace, and
// gm_reduce sums the slices in slice order (deterministic, no atomics).
// The choice of kernel, tile, staging and split is made on the host by
// repro_torch.kernels.gemv.plan_matmul.
//
// bfloat16: tc_kernel, on the tensor cores.
//   * 128 x 128 output tiles (64 x 128 when M <= 64), one consumer
//     warpgroup per 64 rows, each running m64n128k16 wgmma on tiles 64 deep
//     in k (128-byte rows, 128-byte swizzle) and keeping the fp32 sums in
//     registers; one producer warpgroup (its registers given up with
//     setmaxnreg) fills a ring of 4 stages that the consumers wait on
//     through mbarriers, and the consumers hand each stage back the same way.
//   * The producer fills the ring by TMA where a and b have 16-byte-aligned
//     bases and row pitches (TMA's zero fill covers the ragged edge), and
//     else with its own masked loads into the same swizzled layout (K = 610
//     in bf16 has a 1,220-byte pitch): one kernel, two ways of filling.
//   * b as (N, K) (transpose_b, the GEMV case) is K-major like a; b as
//     (K, N) is read MN-major through wgmma's transpose bit.
//   * The epilogue casts the sums to bf16 and stores them under a mask.
// float32: sg_kernel, on the CUDA cores.  TF32 would change the result
// (the port's parity contract keeps float32 products in full fp32), so the
// fp32 path stays off the tensor cores: 128 x 128 tiles (64 x 128 when
// M <= 64), 8 x 8 (4 x 8) sums per thread in index order of k (fmaf), two
// stages of 16-deep slices filled by cp.async while the other stage
// computes (16-byte copies of rows along k, or along n for b as (K, N),
// where the operand is aligned; 4-byte ones with zero fill else), and
// 16-byte shared loads of 4 k at a time: 16 loads feed 256 FMAs.
//
// Bound: operations for a square product (4096^3: 2 * 4096^3 flops is
// 0.139 ms at 989 TFLOP/s bf16, 2.05 ms at 67 TFLOP/s fp32); bytes for a
// GEMV at batch 64 (reading the weight once).

#include "hopper.cuh"

// ------------------------------------------------------- split-K reduce
template <typename T> __device__ __forceinline__ T gm_out(float v);
template <> __device__ __forceinline__ float gm_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 gm_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// c[i] = sum over slices z, in order, of ws[z][i].
template <typename T>
__global__ void gm_reduce(const float* __restrict__ ws, T* __restrict__ c,
                          long long mn, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    c[i] = gm_out<T>(s);
  }
}

// The k-tiles [kt0, kt1) of slice z of `splits`.
__device__ __forceinline__ void gm_slice(int z, int splits, int nkt, int& kt0,
                                         int& kt1) {
  kt0 = (int)((long long)z * nkt / splits);
  kt1 = (int)((long long)(z + 1) * nkt / splits);
}

// -------------------------------------------------- bf16: wgmma kernel
#define TC_BN 128
#define TC_BK 64
#define TC_STAGES 4

struct TcArgs {
  const __nv_bfloat16* a; const __nv_bfloat16* b;
  void* out;                 // bf16 c, or the fp32 workspace when split
  int M, N, K, splits, nkt;
};

template <int BM>
struct TcShape {
  static constexpr int NWG = BM / 64;                 // consumer warpgroups
  static constexpr int THREADS = (NWG + 1) * 128;     // + one producer
  static constexpr int A_BYTES = BM * 128;            // BM rows of 64 k
  static constexpr int B_BYTES = TC_BN * 128;         // 128 n x 64 k
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = TC_STAGES * STAGE + 2 * TC_STAGES * 8 + 1024;
};

// Thread-staged fill of one stage by the producer warpgroup's 128 threads:
// masked element loads written in the swizzled layout TMA would give.
template <int BM, int TB>
__device__ __forceinline__ void tc_fill(const TcArgs& p, uint8_t* A, uint8_t* Bt,
                                        int m0, int n0, int k0, int pt) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int e = pt; e < BM * TC_BK; e += 128) {
    const int r = e >> 6, c = e & 63, m = m0 + r, k = k0 + c;
    *reinterpret_cast<__nv_bfloat16*>(A + hp_swz(r, c)) =
        (m < p.M && k < p.K) ? p.a[(long long)m * p.K + k] : zero;
  }
  if (TB == 0) {                                      // b (N, K)
    for (int e = pt; e < TC_BN * TC_BK; e += 128) {
      const int r = e >> 6, c = e & 63, n = n0 + r, k = k0 + c;
      *reinterpret_cast<__nv_bfloat16*>(Bt + hp_swz(r, c)) =
          (n < p.N && k < p.K) ? p.b[(long long)n * p.K + k] : zero;
    }
  } else {                                            // b (K, N)
    for (int e = pt; e < TC_BK * TC_BN; e += 128) {
      const int r = e >> 7, nn = e & 127, k = k0 + r, n = n0 + nn;
      *reinterpret_cast<__nv_bfloat16*>(Bt + (nn >> 6) * (TC_BK * 128) +
                                        hp_swz(r, nn & 63)) =
          (k < p.K && n < p.N) ? p.b[(long long)k * p.N + n] : zero;
    }
  }
}

template <int BM, int TB, bool TMA>
__global__ void __launch_bounds__(TcShape<BM>::THREADS, 1)
tc_kernel(const __grid_constant__ CUtensorMap ma,
          const __grid_constant__ CUtensorMap mb, TcArgs p) {
  using S = TcShape<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hp_smem(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TC_STAGES * S::STAGE);
  uint64_t* empty = full + TC_STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TC_BN;
  int kt0, kt1;
  gm_slice(blockIdx.z, p.splits, p.nkt, kt0, kt1);
  const int nt = kt1 - kt0;
  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      hp_bar_init(&full[s], TMA ? 1 : 128);
      hp_bar_init(&empty[s], S::NWG * 4);
    }
    hp_bar_init_fence();
  }
  __syncthreads();

  if (wg == S::NWG) {
    // ----------------------------------------------------- producer
    if constexpr (S::NWG == 2) hp_regs_dec<40>();
    const int pt = tid - S::NWG * 128;
    if (TMA && pt != 0) return;
    for (int i = 0; i < nt; ++i) {
      const int s = i % TC_STAGES;
      if (i >= TC_STAGES) hp_bar_wait(&empty[s], ((i / TC_STAGES) - 1) & 1);
      uint8_t* A = smem + s * S::STAGE;
      uint8_t* Bt = A + S::A_BYTES;
      const int k0 = (kt0 + i) * TC_BK;
      if (TMA) {
        hp_bar_expect_tx(&full[s], S::STAGE);
        hp_tma_2d(A, &ma, &full[s], k0, m0);
        if (TB == 0) {
          hp_tma_2d(Bt, &mb, &full[s], k0, n0);
        } else {
          hp_tma_2d(Bt, &mb, &full[s], n0, k0);
          hp_tma_2d(Bt + TC_BK * 128, &mb, &full[s], n0 + 64, k0);
        }
      } else {
        tc_fill<BM, TB>(p, A, Bt, m0, n0, k0, pt);
        hp_fence_async_smem();
        hp_bar_arrive(&full[s]);
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    if constexpr (S::NWG == 2) hp_regs_inc<232>();
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    for (int i = 0; i < nt; ++i) {
      const int s = i % TC_STAGES;
      hp_bar_wait(&full[s], (i / TC_STAGES) & 1);
      const uint8_t* A = smem + s * S::STAGE + wg * 64 * 128;
      const uint8_t* Bt = smem + s * S::STAGE + S::A_BYTES;
      hp_fence_regs(acc);
      hp_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const uint64_t da = hp_desc(A + kk * 32, 16, 1024);
        const uint64_t db = TB == 0 ? hp_desc(Bt + kk * 32, 16, 1024)
                                    : hp_desc(Bt + kk * 2048, TC_BK * 128, 1024);
        hp_wgmma_ss<128, TB>(acc, da, db, 1);
      }
      hp_wgmma_commit();
      hp_wgmma_wait<0>();
      hp_fence_regs(acc);
      if (lane == 0) hp_bar_arrive(&empty[s]);
    }
    // ---------------------------------------------------- epilogue
    const int rbase = m0 + wg * 64 + warp * 16 + lane / 4;
    const int cbase = n0 + 2 * (lane % 4);
    const bool split = p.splits > 1;
    float* ws = static_cast<float*>(p.out) + (long long)blockIdx.z * p.M * p.N;
    __nv_bfloat16* c = static_cast<__nv_bfloat16*>(p.out);
    const bool pairs = (p.N % 2) == 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + 8 * h, col = cbase + 8 * j;
        if (row >= p.M || col >= p.N) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const long long o = (long long)row * p.N + col;
        if (split) {
          ws[o] = v0;
          if (col + 1 < p.N) ws[o + 1] = v1;
        } else if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(c + o) = __floats2bfloat162_rn(v0, v1);
        } else {
          c[o] = __float2bfloat16_rn(v0);
          if (col + 1 < p.N) c[o + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int BM, int TB, bool TMA>
static int tc_run(const TcArgs& p, cudaStream_t s) {
  using S = TcShape<BM>;
  static int granted[HP_MAX_DEVICES] = {0};
  int e = hp_grant_smem((const void*)tc_kernel<BM, TB, TMA>, S::SMEM, granted);
  if (e) return e;
  CUtensorMap ma{}, mb{};
  if (TMA) {
    const uint64_t da[2] = {(uint64_t)p.K, (uint64_t)p.M};
    const uint64_t sa[1] = {(uint64_t)p.K * 2};
    const uint32_t ba[2] = {TC_BK, BM};
    if ((e = hp_encode_bf16(&ma, p.a, 2, da, sa, ba))) return e;
    if (TB == 0) {
      const uint64_t db[2] = {(uint64_t)p.K, (uint64_t)p.N};
      const uint64_t sb[1] = {(uint64_t)p.K * 2};
      const uint32_t bb[2] = {TC_BK, TC_BN};
      if ((e = hp_encode_bf16(&mb, p.b, 2, db, sb, bb))) return e;
    } else {
      const uint64_t db[2] = {(uint64_t)p.N, (uint64_t)p.K};
      const uint64_t sb[1] = {(uint64_t)p.N * 2};
      const uint32_t bb[2] = {64, TC_BK};
      if ((e = hp_encode_bf16(&mb, p.b, 2, db, sb, bb))) return e;
    }
  }
  dim3 grid((p.N + TC_BN - 1) / TC_BN, (p.M + BM - 1) / BM, p.splits);
  tc_kernel<BM, TB, TMA><<<grid, S::THREADS, S::SMEM, s>>>(ma, mb, p);
  return (int)cudaGetLastError();
}

// TB (wgmma's transpose bit for B) is 0 for b (N, K), 1 for b (K, N).
template <int BM>
static int tc_dispatch(const TcArgs& p, int transpose_b, int tma, cudaStream_t s) {
  if (transpose_b)
    return tma ? tc_run<BM, 0, true>(p, s) : tc_run<BM, 0, false>(p, s);
  return tma ? tc_run<BM, 1, true>(p, s) : tc_run<BM, 1, false>(p, s);
}

// ----------------------------------------------- float32: CUDA cores
#define SG_BN 128
#define SG_BK 16
#define SG_THREADS 256
#define SG_PAD 4              // padded rows, still 16-byte aligned

// Stage rows [r0, r0 + rows) x k [k0, k0 + 16) of a row-major (R, K)
// matrix into dst[rows][SG_BK + SG_PAD], zeros outside; 16-byte copies
// where `vec` (base 16-byte aligned, K % 4 == 0), else 4-byte ones.
template <int ROWS>
__device__ __forceinline__ void sg_stage_rk(float (*dst)[SG_BK + SG_PAD],
                                            const float* __restrict__ src,
                                            int R, int K, int r0, int k0,
                                            bool vec) {
  for (int c = threadIdx.x; c < ROWS * 4; c += SG_THREADS) {
    const int r = c >> 2, kq = (c & 3) * 4, row = r0 + r, k = k0 + kq;
    const float* p = src + (long long)row * K + k;
    if (vec) {
      const bool ok = row < R && k < K;
      hp_cp16(&dst[r][kq], ok ? p : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row < R && k + e < K;
        hp_cp4(&dst[r][kq + e], ok ? p + e : src, ok);
      }
    }
  }
}

// BM rows (64 or 128) x 128 columns per block; each thread keeps TM = BM /
// 16 rows x 8 columns of sums, k in index order.  a is staged row-major
// (m, k); b as (n, k) when TB (b is (N, K)), else as (k, n).  Each thread
// reads its rows' k in 16-byte groups of 4.
template <int BM, int TB>
__global__ void __launch_bounds__(SG_THREADS)
sg_kernel(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ out, int M, int N, int K, int splits, int nkt,
          int va, int vb) {
  constexpr int TM = BM / 16;
  constexpr int BR = TB ? SG_BN : SG_BK;              // rows of a b stage
  constexpr int BC = TB ? SG_BK + SG_PAD : SG_BN + SG_PAD;
  __shared__ __align__(16) float As[2][BM][SG_BK + SG_PAD];
  __shared__ __align__(16) float Bs[2][BR][BC];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * SG_BN;
  int kt0, kt1;
  gm_slice(blockIdx.z, splits, nkt, kt0, kt1);

  auto stage = [&](int buf, int kt) {
    const int k0 = kt * SG_BK;
    sg_stage_rk<BM>(As[buf], a, M, K, m0, k0, va);
    if (TB) {
      sg_stage_rk<SG_BN>(reinterpret_cast<float (*)[SG_BK + SG_PAD]>(Bs[buf]),
                         b, N, K, n0, k0, vb);
    } else {
      for (int c = tid; c < SG_BK * (SG_BN / 4); c += SG_THREADS) {
        const int kr = c / (SG_BN / 4), nq = (c % (SG_BN / 4)) * 4;
        const int k = k0 + kr, n = n0 + nq;
        const float* p = b + (long long)k * N + n;
        float* d = &Bs[buf][kr][nq];
        if (vb) {
          const bool ok = k < K && n < N;
          hp_cp16(d, ok ? p : b, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = k < K && n + e < N;
            hp_cp4(d + e, ok ? p + e : b, ok);
          }
        }
      }
    }
    hp_cp_commit();
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  if (kt0 < kt1) stage(0, kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      stage(buf ^ 1, kt + 1);
      hp_cp_wait<1>();
    } else {
      hp_cp_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kg = 0; kg < SG_BK; kg += 4) {
      float av[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(av[i]) = *reinterpret_cast<const float4*>(
            &As[buf][64 * (i / 4) + ty * 4 + i % 4][kg]);
      if (TB) {
        float bv[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float4*>(bv[j]) =
              *reinterpret_cast<const float4*>(&Bs[buf][tx + 16 * j][kg]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i][kk], bv[j][kk], acc[i][j]);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[8];
          *reinterpret_cast<float4*>(bv) =
              *reinterpret_cast<const float4*>(&Bs[buf][kg + kk][tx * 4]);
          *reinterpret_cast<float4*>(bv + 4) =
              *reinterpret_cast<const float4*>(&Bs[buf][kg + kk][64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  float* c = out + (long long)blockIdx.z * M * N;    // slice z when split
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + 64 * (i / 4) + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (TB ? tx + 16 * j : 64 * (j / 4) + tx * 4 + j % 4);
      if (n < N) c[(long long)m * N + n] = acc[i][j];
    }
  }
}

template <int BM>
static int sg_run(const float* a, const float* b, float* dst, int M, int N,
                  int K, int tb, int splits, int nkt, cudaStream_t s) {
  dim3 grid((N + SG_BN - 1) / SG_BN, (M + BM - 1) / BM, splits);
  const bool va = (uintptr_t)a % 16 == 0 && K % 4 == 0;
  const bool vb = (uintptr_t)b % 16 == 0 && (tb ? K : N) % 4 == 0;
  if (tb)
    sg_kernel<BM, 1><<<grid, SG_THREADS, 0, s>>>(a, b, dst, M, N, K, splits,
                                                 nkt, va, vb);
  else
    sg_kernel<BM, 0><<<grid, SG_THREADS, 0, s>>>(a, b, dst, M, N, K, splits,
                                                 nkt, va, vb);
  return (int)cudaGetLastError();
}

// c (M, N) = a (M, K) @ b, b (K, N) or with transpose_b (N, K); all
// contiguous.  dtype 0 = float32 (sg_kernel), 1 = bfloat16 (tc_kernel, with
// TMA staging where tma is 1); bm, 64 or 128, is the tile's rows.  splits > 1 splits K
// into that many slices of whole k-tiles: their fp32 partials go to ws
// (splits * M * N floats) and gm_reduce writes c.  Returns
// cudaGetLastError() after the launches (0 = launched), or the error of a
// refused grant or tensor-map encoding.
extern "C" int gm_launch(const void* a, const void* b, void* c, void* ws,
                         int M, int N, int K, int transpose_b, int dtype,
                         int bm, int tma, int splits, void* stream) {
  if (M == 0 || N == 0) return 0;
  const int bk = dtype == 0 ? SG_BK : TC_BK;
  const int nkt = (K + bk - 1) / bk;
  if (splits < 1 || splits > nkt || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((M + 63) / 64 > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  void* dst = splits > 1 ? ws : c;
  int e;
  if (dtype == 0) {
    const float *fa = (const float*)a, *fb = (const float*)b;
    float* fc = (float*)dst;
    if (bm == 64) e = sg_run<64>(fa, fb, fc, M, N, K, transpose_b, splits, nkt, s);
    else if (bm == 128) e = sg_run<128>(fa, fb, fc, M, N, K, transpose_b, splits, nkt, s);
    else return (int)cudaErrorInvalidValue;
  } else {
    TcArgs p{(const __nv_bfloat16*)a, (const __nv_bfloat16*)b, dst, M, N, K,
             splits, nkt};
    if (bm == 64) e = tc_dispatch<64>(p, transpose_b, tma, s);
    else if (bm == 128) e = tc_dispatch<128>(p, transpose_b, tma, s);
    else e = (int)cudaErrorInvalidValue;
  }
  if (e || splits == 1) return e;
  const long long mn = (long long)M * N;
  const int blocks = (int)((mn + 255) / 256 < 1184 ? (mn + 255) / 256 : 1184);
  if (dtype == 0)
    gm_reduce<float><<<blocks, 256, 0, s>>>((const float*)ws, (float*)c, mn, splits);
  else
    gm_reduce<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        (const float*)ws, (__nv_bfloat16*)c, mn, splits);
  return (int)cudaGetLastError();
}
