// Fused flash attention forward (GQA, causal or full) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/flash_attention.py
// (:39), launched by `flash_attention_fused` (:80, pallas_call at :118):
// q (B, Sq, H, dh), k and v (B, Sk, KV, dh) -> out (B, Sq, H, dh) in q's
// dtype, float32 or bfloat16.  Query head h reads KV head h / G (G = H/KV);
// the q rows of one KV head are the (token, g) pairs, interleaved as in the
// TPU kernel.  Scores, the softmax statistics and the output accumulator are
// fp32; `round_p` rounds p to v's dtype before P.V, as the TPU kernel does,
// else p stays fp32, as the model's own attention does.  q is scaled in fp32
// before the product (the model's order; the TPU kernel scales the product).
// No fast math: expf, and fmaf sums in index order.
//
// Design (a simple kernel that is right; wgmma, TMA and staged rings come
// later):
//   * One block of 256 threads per (b * KV + kv head, tile of 64 q rows),
//     the heaviest causal tiles first.  The tile's scaled q rows stay in
//     shared memory (dh-major) for the whole key loop.
//   * A loop over key tiles of BK takes the place of the TPU's sequential kv
//     grid axis: k (dh-major) and v (key-major) are staged in shared memory,
//     each thread computes a 4 x BK/16 block of scores with fp32 FMAs, four
//     threads per row update the running max and sum (online softmax), and
//     each thread rescales and accumulates a 4 x DHP/16 block of the output
//     in registers.
//   * Causal tiles above the diagonal are skipped: the loop stops at the
//     tile's last token.  That is exact: such a tile gives m_new = m_prev,
//     alpha = 1 and p = 0 in the TPU kernel, since key 0 is valid for every
//     row.  Ragged Sq and Sk are masked, not padded; q, k and v are read in
//     the model's own layout through their strides (no transpose).
//
// Bound: operations.  4 * Sq * Sk * H * dh flops (half of it under the
// causal mask) against reading q, k, v and writing the output once; at the
// served shapes (Sq = Sk >= 100, dh = 128) that is well above the fp32 and
// bf16 ridges.  This kernel runs on the CUDA cores, not the tensor cores.

#include "attention.cuh"

#define FA_THREADS 256
#define FA_ROWS 64

struct FaArgs {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Sk, H, KV, dh;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
  int causal, round_p, vec;
};

template <int DHP, int BK>
constexpr int fa_smem_floats() {
  return DHP * (FA_ROWS + 1) + DHP * (BK + 1) + BK * DHP + FA_ROWS * (BK + 1)
         + 3 * FA_ROWS;
}

template <typename T, int DHP, int BK>
__global__ void __launch_bounds__(FA_THREADS)
fa_kernel(FaArgs a) {
  extern __shared__ float smem[];
  constexpr int LQ = FA_ROWS + 1, LK = BK + 1, LP = BK + 1;
  float* Qs = smem;                  // [DHP][LQ]  scaled q, dh-major
  float* Ks = Qs + DHP * LQ;         // [DHP][LK]  k tile, dh-major
  float* Vs = Ks + DHP * LK;         // [BK][DHP]  v tile, key-major
  float* Ps = Vs + BK * DHP;         // [FA_ROWS][LP] scores, then p
  float* Ms = Ps + FA_ROWS * LP;     // running max per row
  float* Ls = Ms + FA_ROWS;          // running sum per row
  float* As = Ls + FA_ROWS;          // this tile's alpha per row

  const int tid = threadIdx.x;
  const int G = a.H / a.KV;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * FA_ROWS;
  const int nrows = a.Sq * G;
  const int dh = a.dh;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;
  T* o = static_cast<T*>(a.o);

  // q rows (token t, group g) of this tile, scaled; zeros past the end
  for (int e = tid; e < FA_ROWS * DHP; e += FA_THREADS) {
    const int r = e / DHP, d = e % DHP, row = r0 + r;
    float val = 0.0f;
    if (row < nrows && d < dh) {
      const int t = row / G, g = row % G;
      val = att_in<T>(q[b * a.qsb + t * a.qss + (kvh * G + g) * a.qsh + d])
            * a.scale;
    }
    Qs[d * LQ + r] = val;
  }
  if (tid < FA_ROWS) { Ms[tid] = ATT_NEG; Ls[tid] = 0.0f; }

  const int rg = tid / 16, cg = tid % 16;   // rows rg + 16 i, columns cg + 16 j
  constexpr int NJ = BK / 16, NC = DHP / 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;

  const int last_row = min(r0 + FA_ROWS, nrows) - 1;
  const int kend = a.causal ? min(a.Sk, last_row / G + 1) : a.Sk;
  __syncthreads();

  for (int j0 = 0; j0 < kend; j0 += BK) {
    const int nk = min(BK, a.Sk - j0);
    att_load_rows<T>(k + j0 * a.kss, a.kss, nk, dh, a.vec,
                     [&](int c, int d, float x) { Ks[d * LK + c] = x; });
    att_load_rows<T>(v + j0 * a.vss, a.vss, nk, dh, a.vec,
                     [&](int c, int d, float x) { Vs[c * DHP + d] = x; });
    __syncthreads();

    // scores of rows rg + 16 i against keys cg + 16 j, masked
    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[d * LQ + rg + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[d * LK + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i, tok = (r0 + r) / G;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cg + 16 * j, key = j0 + c;
        const bool ok = c < nk && (!a.causal || key <= tok);
        Ps[r * LP + c] = ok ? s[i][j] : ATT_NEG;
      }
    }
    __syncthreads();

    // online softmax, four threads per row
    {
      const int r = tid / 4, part = tid % 4;
      float mx = ATT_NEG;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, Ps[r * LP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int c = part; c < BK; c += 4) {
        const float p = expf(Ps[r * LP + c] - m_new);
        sum += p;
        Ps[r * LP + c] = a.round_p ? att_round<T>(p) : p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + sum;
        As[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v over this tile's keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = As[rg + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= al;
    }
    for (int j = 0; j < nk; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg + 16 * i) * LP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * DHP + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i, row = r0 + r;
    if (row >= nrows) continue;
    const int t = row / G, g = row % G;
    const float l = fmaxf(Ls[r], 1e-30f);
    T* dst = o + (((long long)b * a.Sq + t) * a.H + kvh * G + g) * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cg + 16 * c;
      if (col < dh) dst[col] = att_out<T>(acc[i][c] / l);
    }
  }
}

template <typename T, int DHP, int BK>
static int fa_run(const FaArgs& a, cudaStream_t s) {
  const int smem = fa_smem_floats<DHP, BK>() * (int)sizeof(float);
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_kernel<T, DHP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int G = a.H / a.KV;
  dim3 grid((a.Sq * G + FA_ROWS - 1) / FA_ROWS, a.B * a.KV);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  fa_kernel<T, DHP, BK><<<grid, FA_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int fa_dispatch(const FaArgs& a, cudaStream_t s) {
  if (a.dh <= 64) return fa_run<T, 64, 64>(a, s);
  if (a.dh <= 128) return fa_run<T, 128, 64>(a, s);
  if (a.dh <= 256) return fa_run<T, 256, 32>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Strides in elements; the last axis of q, k and v is contiguous.  dtype 0 =
// float32, 1 = bfloat16 (q, k, v and out alike); vec = 1 when every row of
// k and v starts on a 16-byte boundary and dh fills whole 16-byte words.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Sk, int H, int KV, int dh,
                         long long qsb, long long qss, long long qsh,
                         long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh,
                         float scale, int causal, int round_p, int vec,
                         int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Sk < 1 || KV < 1 || H % KV != 0 || dh < 1) return (int)cudaErrorInvalidValue;
  FaArgs a{q, k, v, o, B, Sq, Sk, H, KV, dh, qsb, qss, qsh, ksb, kss, ksh,
           vsb, vss, vsh, scale, causal, round_p, vec};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? fa_dispatch<float>(a, s) : fa_dispatch<__nv_bfloat16>(a, s);
}
