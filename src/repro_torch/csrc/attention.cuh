// Helpers shared by the attention kernels (flash_attention.cu,
// decode_attention.cu): conversions between the storage types (float32,
// bfloat16) and the fp32 the kernels compute in, and a loader that stages
// rows of a (rows, dh) slice of q, k or v in shared memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define ATT_NEG (-1e30f)   // the masked score of the TPU kernels

template <typename T> __device__ __forceinline__ float att_in(T v);
template <> __device__ __forceinline__ float att_in<float>(float v) { return v; }
template <> __device__ __forceinline__ float att_in<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T att_out(float v);
template <> __device__ __forceinline__ float att_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 att_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// p rounded to the storage type T (v's dtype) and back: what the TPU
// kernels' `p.astype(v.dtype)` does before P.V.
template <typename T> __device__ __forceinline__ float att_round(float p) {
  return att_in<T>(att_out<T>(p));
}

// Stage `nrows` rows of `dh` elements, row r at src + r * rs (elements,
// contiguous along dh), calling store(r, d, value) for each element.  With
// `vec` (dh and rs multiples of 16 bytes' worth of T, src 16-byte aligned)
// each thread issues up to 8 16-byte loads before it stores any, so that
// enough bytes are in flight to keep the memory busy; else one element per
// load.  Rows beyond `nrows` are not touched.
template <typename T, typename Store>
__device__ __forceinline__ void att_load_rows(const T* __restrict__ src,
                                              long long rs, int nrows, int dh,
                                              bool vec, Store store) {
  const int nt = blockDim.x, tid = threadIdx.x;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int U = 8;
    const int per_row = dh / V;
    const int total = nrows * per_row;
    for (int e0 = tid; e0 < total; e0 += U * nt) {
      uint4 buf[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * nt;
        if (e < total) {
          const int r = e / per_row, c = (e - r * per_row) * V;
          buf[u] = __ldg(reinterpret_cast<const uint4*>(src + r * rs + c));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * nt;
        if (e < total) {
          const int r = e / per_row, c = (e - r * per_row) * V;
          const T* vals = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
          for (int i = 0; i < V; ++i) store(r, c + i, att_in<T>(vals[i]));
        }
      }
    }
  } else {
    const int total = nrows * dh;
    for (int e = tid; e < total; e += nt) {
      const int r = e / dh, d = e - r * dh;
      store(r, d, att_in<T>(src[r * rs + d]));
    }
  }
}
