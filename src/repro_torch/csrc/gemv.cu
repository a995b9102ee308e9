// Tiled dense matmul / batched GEMV for Hopper (sm_90a).
//
// Replaces the TPU kernel `_matmul_kernel` (src/repro/kernels/gemv.py:25),
// launched through `_matmul_call` (:51, pallas_call at :59) by `matmul`
// (:74) and `gemv` (:97): c = a @ b or a @ b.T with fp32 accumulation, the
// result cast to a's dtype (float32 or bfloat16).
//
// Design (a simple kernel that is right; wgmma/TMA come later):
//   * One block of 256 threads per 64 x 64 output tile; each thread keeps a
//     4 x 4 micro-tile of fp32 sums in registers.
//   * The contraction walks 16-deep slices: each slice of a and of b is
//     staged in shared memory (k-major, so the inner product reads
//     neighbouring words), then every thread does 16 x 16 multiply-adds.
//     The TPU's sequential k grid axis becomes this loop inside the block.
//   * Ragged edges are masked on load (zeros) and on store; nothing is
//     padded in device memory.
//   * Each output sums its k terms in index order with fmaf.
//
// Bound: operations at the served shapes' sizes (4096^3: 2 * 4096^3 flops
// over 67 TFLOP/s of fp32 outside the tensor cores is 2.05 ms; its bytes
// take 0.06 ms); a GEMV at batch 64 is bound by reading the weight.  This
// kernel uses no tensor cores, so it runs well below the card's bf16 peak;
// wgmma with TMA-fed staged tiles is the redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define GM_BM 64
#define GM_BN 64
#define GM_BK 16
#define GM_THREADS 256

template <typename T> __device__ __forceinline__ float gm_in(T v);
template <> __device__ __forceinline__ float gm_in<float>(float v) { return v; }
template <> __device__ __forceinline__ float gm_in<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T gm_out(float v);
template <> __device__ __forceinline__ float gm_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 gm_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(GM_THREADS)
gm_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
          int M, int N, int K, int transpose_b) {
  __shared__ float As[GM_BK][GM_BM + 4];
  __shared__ float Bs[GM_BK][GM_BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;           // 16 x 16 threads
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    for (int e = tid; e < GM_BM * GM_BK; e += GM_THREADS) {
      const int r = e / GM_BK, kk = e % GM_BK;        // k fastest: a is row-major
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? gm_in<T>(a[(long)m * K + k]) : 0.0f;
    }
    for (int e = tid; e < GM_BN * GM_BK; e += GM_THREADS) {
      int col, kk;
      if (transpose_b) { col = e / GM_BK; kk = e % GM_BK; }   // b is (N, K)
      else { kk = e / GM_BN; col = e % GM_BN; }              // b is (K, N)
      const int n = n0 + col, k = k0 + kk;
      float v = 0.0f;
      if (n < N && k < K)
        v = gm_in<T>(transpose_b ? b[(long)n * K + k] : b[(long)k * N + n]);
      Bs[kk][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GM_BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) c[(long)m * N + n] = gm_out<T>(acc[i][j]);
    }
  }
}

// c (M, N) = a (M, K) @ b, b (K, N) or with transpose_b (N, K); all
// contiguous.  dtype 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int gm_launch(const void* a, const void* b, void* c, int M, int N,
                         int K, int transpose_b, int dtype, void* stream) {
  dim3 grid((N + GM_BN - 1) / GM_BN, (M + GM_BM - 1) / GM_BM);
  if (grid.x == 0 || grid.y == 0) return 0;
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    gm_kernel<float><<<grid, GM_THREADS, 0, s>>>(
        (const float*)a, (const float*)b, (float*)c, M, N, K, transpose_b);
  else
    gm_kernel<__nv_bfloat16><<<grid, GM_THREADS, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)c,
        M, N, K, transpose_b);
  return (int)cudaGetLastError();
}
