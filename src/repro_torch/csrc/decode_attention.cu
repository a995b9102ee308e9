// GQA decode attention for Hopper (sm_90a): one new token per sequence
// against a length-masked KV cache.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/decode_attention.py
// (:32), launched by `decode_attention` (:68, pallas_call at :96): q (B, H,
// dh), caches k and v (B, S, KV, dh), cache_len (B,) int32 -> out (B, H, dh)
// in q's dtype, float32 or bfloat16.  Query head h reads KV head h / G; key
// positions >= cache_len[b] are masked.  q is scaled in fp32 first, scores,
// statistics and the accumulator are fp32; `round_p` rounds p to v's dtype
// before P.V, as the TPU kernel does, else p stays fp32, as the model's
// `gqa_decode` does.  No fast math: expf, and fmaf sums in index order.
//
// Design (simple and right; a split over the sequence comes later):
//   * One block of 256 threads per (b, kv head) holds the G scaled query
//     rows, the running max and sum and the (G, dh) accumulator in shared
//     memory, and loops over the cache in tiles of BK keys, up to
//     cache_len[b] only: the tiles at or beyond it are skipped, which is
//     exact (at least key 0 is valid, so such a tile would give alpha = 1
//     and p = 0).  cache_len is read by the block itself (no scalar
//     prefetch); cache_len[b] must be >= 1 (the wrapper checks).
//   * Each k and v tile is staged in shared memory with up to eight 16-byte
//     loads in flight per thread; the caches are read in the model's own
//     layout through their strides, never transposed or copied.
//   * One warp per query row runs the online softmax of the tile.
//
// Bound: bytes.  The valid prefix of k and v is read once (2 * sum(len) *
// KV * dh elements) for 4 * sum(len) * H * dh flops: one flop per byte in
// float32, two in bfloat16, far below either ridge.  With one block per
// (b, kv head) only B * KV SMs pull from memory (16 of 132 at B = 8, KV = 2),
// so the kernel cannot reach the card's memory rate; splitting the
// sequence across blocks (flash-decoding) is the redesign.

#include "attention.cuh"

#define DA_THREADS 256

struct DaArgs {
  const void* q; const void* k; const void* v; void* o; const int* lens;
  int B, S, H, KV, dh, bk;
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
  int round_p, vec;
};

static int da_smem_floats(int G, int dh, int bk) {
  return G * dh + bk * (dh + 1) + bk * dh + G * bk + G * dh + 3 * G;
}

template <typename T>
__global__ void __launch_bounds__(DA_THREADS)
da_kernel(DaArgs a) {
  extern __shared__ float smem[];
  const int G = a.H / a.KV, dh = a.dh, BK = a.bk, LK = dh + 1;
  float* Qs = smem;              // [G][dh]   scaled q
  float* Ks = Qs + G * dh;       // [BK][LK]  k tile
  float* Vs = Ks + BK * LK;      // [BK][dh]  v tile
  float* Ps = Vs + BK * dh;      // [G][BK]   scores, then p
  float* Acc = Ps + G * BK;      // [G][dh]   accumulator
  float* Ms = Acc + G * dh;      // running max per row
  float* Ls = Ms + G;            // running sum per row
  float* As = Ls + G;            // this tile's alpha per row

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
  const int len = a.lens[b];
  const T* q = static_cast<const T*>(a.q) + b * a.qsb + kvh * G * a.qsh;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  for (int e = tid; e < G * dh; e += DA_THREADS) {
    const int g = e / dh, d = e - g * dh;
    Qs[e] = att_in<T>(q[g * a.qsh + d]) * a.scale;
    Acc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += DA_THREADS) { Ms[g] = ATT_NEG; Ls[g] = 0.0f; }

  for (int j0 = 0; j0 < len; j0 += BK) {
    const int nk = min(BK, len - j0);
    __syncthreads();
    att_load_rows<T>(k + j0 * a.kss, a.kss, nk, dh, a.vec,
                     [&](int c, int d, float x) { Ks[c * LK + d] = x; });
    att_load_rows<T>(v + j0 * a.vss, a.vss, nk, dh, a.vec,
                     [&](int c, int d, float x) { Vs[c * dh + d] = x; });
    __syncthreads();

    for (int e = tid; e < G * BK; e += DA_THREADS) {
      const int g = e / BK, c = e - g * BK;
      float s = ATT_NEG;
      if (c < nk) {
        const float* qr = Qs + g * dh;
        const float* kr = Ks + c * LK;
        float acc = 0.0f;
#pragma unroll 4
        for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc;
      }
      Ps[e] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += DA_THREADS / 32) {
      float* pr = Ps + g * BK;
      float mx = ATT_NEG;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, pr[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = a.round_p ? att_round<T>(p) : p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        Ms[g] = m_new;
        Ls[g] = Ls[g] * alpha + sum;
        As[g] = alpha;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * dh; e += DA_THREADS) {
      const int g = e / dh, col = e - g * dh;
      const float* pr = Ps + g * BK;
      float acc = Acc[e] * As[g];
      for (int j = 0; j < nk; ++j) acc = fmaf(pr[j], Vs[j * dh + col], acc);
      Acc[e] = acc;
    }
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o) + ((long long)b * a.H + kvh * G) * dh;
  for (int e = tid; e < G * dh; e += DA_THREADS) {
    const int g = e / dh;
    o[e] = att_out<T>(Acc[e] / fmaxf(Ls[g], 1e-30f));
  }
}

// The largest key tile (64, 32 or 16) whose shared memory fits in 227 KB,
// or 0 when none does.
extern "C" int da_tile(int G, int dh) {
  for (int bk = 64; bk >= 16; bk /= 2)
    if (da_smem_floats(G, dh, bk) * (long long)sizeof(float) <= 232448) return bk;
  return 0;
}

// q (B, H, dh) with strides qsb, qsh; k and v (B, S, KV, dh) with strides
// in elements, the last axis contiguous; lens (B,) int32 on the card, each
// in [1, S].  dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int da_launch(const void* q, const void* k, const void* v, void* o,
                         const void* lens, int B, int S, int H, int KV, int dh,
                         long long qsb, long long qsh, long long ksb,
                         long long kss, long long ksh, long long vsb,
                         long long vss, long long vsh, float scale,
                         int round_p, int vec, int dtype, void* stream) {
  if (B == 0) return 0;
  if (S < 1 || KV < 1 || H % KV != 0 || dh < 1) return (int)cudaErrorInvalidValue;
  const int G = H / KV, bk = da_tile(G, dh);
  if (bk == 0) return (int)cudaErrorInvalidValue;
  const int smem = da_smem_floats(G, dh, bk) * (int)sizeof(float);
  DaArgs a{q, k, v, o, (const int*)lens, B, S, H, KV, dh, bk, qsb, qsh, ksb,
           kss, ksh, vsb, vss, vsh, scale, round_p, vec};
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = B * KV;
  static int granted[2] = {0, 0};   // dynamic shared memory allowed so far
  if (smem > granted[dtype != 0]) {
    cudaError_t e = cudaFuncSetAttribute(
        dtype == 0 ? (const void*)da_kernel<float>
                   : (const void*)da_kernel<__nv_bfloat16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    granted[dtype != 0] = smem;
  }
  if (dtype == 0)
    da_kernel<float><<<grid, DA_THREADS, smem, s>>>(a);
  else
    da_kernel<__nv_bfloat16><<<grid, DA_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}
