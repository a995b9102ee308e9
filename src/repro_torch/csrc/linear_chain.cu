// Fused §IV-G stage chains for Hopper (sm_90a): a whole linear-time cluster
// applied to a stream in one pass, one load and one store per element.
//
// Replaces the TPU kernels `_chain_kernel` (float,
// src/repro/kernels/linear_pipeline.py:142) and `_chain_kernel_q` (int32
// carrier, :197), both launched through `_tiled_chain_call` (:93,
// pallas_call at :127).  The Pallas kernels unroll the stage tuple at trace
// time; here one generic elementwise kernel per variant walks a small packed
// stage table, so every chain shares one binary (no build per chain).
//
// Design:
//   * One thread per element of the flattened (rows, n) stream, grid-stride;
//     the ragged edge is masked by the element count, with no padding copy.
//   * The stage table (LC_NI ints and LC_NF floats per stage) is copied into
//     shared memory once per block; every thread reads the same entries.
//   * `*_vec` operands are read at the element's column from one pool of
//     32-bit words (a length-1 vec broadcasts); `*_arr` extras are read at
//     the element's own offset, each at its own dtype.
//   * The float variant applies ref.apply_stage (float_stage); the integer
//     variant widens to int32 once, applies ref.apply_stage_q (q_stage) and
//     writes back by a narrowing cast of the already saturated value, as
//     the Pallas kernel's astype does.
//
// Bound: bytes.  A chain reads the stream and each extra once and writes
// once; the served chains move at most ~1 MB (bonsai/curet-m's (64, 976)
// float chain), ~0.3 us at 3.35 TB/s, so launch latency bounds them, not
// the kernel's body.  Tiling does not change per-element arithmetic, so the
// TPU's (bb, bn) tiles have no counterpart here.

#include "fixed_point.cuh"

#define LC_NI 6          // int fields per stage: code, operand, vec len, p0..p2
#define LC_NF 4          // float fields per stage: scalar, s_in, s_out, -
#define LC_MAX_STAGES 64
#define LC_MAX_ARR 16
#define LC_THREADS 256
#define LC_MAX_BLOCKS 8192

struct LcArrs {
  const void* p[LC_MAX_ARR];
  int dt[LC_MAX_ARR];
};

__device__ __forceinline__ void lc_load_table(const int* table, const float* ftable,
                                              int n_stages, int* s_t, float* s_f) {
  for (int i = threadIdx.x; i < n_stages * LC_NI; i += blockDim.x) s_t[i] = table[i];
  for (int i = threadIdx.x; i < n_stages * LC_NF; i += blockDim.x) s_f[i] = ftable[i];
  __syncthreads();
}

__global__ void lc_float_kernel(const int* __restrict__ table,
                                const float* __restrict__ ftable, int n_stages,
                                const float* __restrict__ vecs,
                                const float* __restrict__ x, float* __restrict__ out,
                                LcArrs arrs, long total, int n) {
  __shared__ int s_t[LC_MAX_STAGES * LC_NI];
  __shared__ float s_f[LC_MAX_STAGES * LC_NF];
  lc_load_table(table, ftable, n_stages, s_t, s_f);
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const int col = (int)(e % n);
    float v = x[e];
    for (int s = 0; s < n_stages; ++s) {
      const int* t = s_t + s * LC_NI;
      const int st = t[0];
      float o = s_f[s * LC_NF];
      if (stage_reads_vec(st)) o = vecs[t[1] + (t[2] == 1 ? 0 : col)];
      else if (stage_reads_arr(st)) o = load_f(arrs.p[t[1]], arrs.dt[t[1]], e);
      v = float_stage(st, v, o);
    }
    out[e] = v;
  }
}

__global__ void lc_q_kernel(const int* __restrict__ table,
                            const float* __restrict__ ftable, int n_stages,
                            const int* __restrict__ vecs, const void* x,
                            void* out, int dt, LcArrs arrs, long total, int n,
                            int bits) {
  __shared__ int s_t[LC_MAX_STAGES * LC_NI];
  __shared__ float s_f[LC_MAX_STAGES * LC_NF];
  lc_load_table(table, ftable, n_stages, s_t, s_f);
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const int col = (int)(e % n);
    int v = load_i(x, dt, e);
    for (int s = 0; s < n_stages; ++s) {
      const int* t = s_t + s * LC_NI;
      const int st = t[0];
      int o = 0;
      if (stage_reads_vec(st)) o = vecs[t[1] + (t[2] == 1 ? 0 : col)];
      else if (stage_reads_arr(st)) o = load_i(arrs.p[t[1]], arrs.dt[t[1]], e);
      v = q_stage(st, v, o, t[3], t[4], t[5], s_f[s * LC_NF + 1],
                  s_f[s * LC_NF + 2], bits);
    }
    if (dt == DT_I8) ((int8_t*)out)[e] = (int8_t)v;
    else if (dt == DT_I16) ((int16_t*)out)[e] = (int16_t)v;
    else ((int*)out)[e] = v;
  }
}

static int lc_arrs(LcArrs* arrs, const void* const* arr_ptrs,
                   const int* arr_dtypes, int n_arr) {
  if (n_arr > LC_MAX_ARR) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_arr; ++i) {
    arrs->p[i] = arr_ptrs[i];
    arrs->dt[i] = arr_dtypes[i];
  }
  return 0;
}

static unsigned lc_blocks(long total) {
  long b = (total + LC_THREADS - 1) / LC_THREADS;
  return (unsigned)(b < 1 ? 1 : (b > LC_MAX_BLOCKS ? LC_MAX_BLOCKS : b));
}

extern "C" int lc_max_stages() { return LC_MAX_STAGES; }
extern "C" int lc_max_arr() { return LC_MAX_ARR; }

// Float chain over `total` = rows * n elements.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int lc_launch_float(const void* table, const void* ftable, int n_stages,
                               const void* vecs, const void* x, void* out,
                               const void* const* arr_ptrs, const int* arr_dtypes,
                               int n_arr, long total, int n, void* stream) {
  LcArrs arrs = {};
  if (n_stages > LC_MAX_STAGES || lc_arrs(&arrs, arr_ptrs, arr_dtypes, n_arr))
    return (int)cudaErrorInvalidValue;
  lc_float_kernel<<<lc_blocks(total), LC_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)table, (const float*)ftable, n_stages, (const float*)vecs,
      (const float*)x, (float*)out, arrs, total, n);
  return (int)cudaGetLastError();
}

// Fixed-point chain: `x` and `out` share the dtype code `dt`.
extern "C" int lc_launch_q(const void* table, const void* ftable, int n_stages,
                           const void* vecs, const void* x, void* out, int dt,
                           const void* const* arr_ptrs, const int* arr_dtypes,
                           int n_arr, long total, int n, int bits, void* stream) {
  LcArrs arrs = {};
  if (n_stages > LC_MAX_STAGES || lc_arrs(&arrs, arr_ptrs, arr_dtypes, n_arr))
    return (int)cudaErrorInvalidValue;
  lc_q_kernel<<<lc_blocks(total), LC_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)table, (const float*)ftable, n_stages, (const int*)vecs, x, out,
      dt, arrs, total, n, bits);
  return (int)cudaGetLastError();
}
