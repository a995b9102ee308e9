// Fused flash attention forward (GQA, causal or full) for Hopper (sm_90a),
// and its backward for training (fb_dq_kernel, fb_dkdv_kernel and the
// tensor-core fbt_* kernels: at the end).
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/flash_attention.py
// (:39), launched by `flash_attention_fused` (:80, pallas_call at :118):
// q (B, Sq, H, dh), k and v (B, Sk, KV, dh) -> out (B, Sq, H, dh) in q's
// dtype, float32 or bfloat16.  Query head h reads KV head h / G (G = H/KV);
// the q rows of one KV head are the (token, g) pairs, interleaved as in the
// TPU kernel.  Scores, the softmax statistics and the output accumulator are
// fp32; `round_p` 1 rounds p to v's dtype before P.V, as the TPU kernel
// does, 2 rounds it to bfloat16 whatever v's dtype (the model's
// `probs_bf16` at float32), 0 keeps it fp32, as the model's own attention
// does.  1 and 2 round against the running max of each key tile, as the
// TPU kernel does; 3 rounds to bfloat16 against each row's max (dh <= 256,
// either kernel: a first pass over the key tiles finds it), the function
// the rounded-p backward differentiates (training with `probs_bf16`), and
// the reference's with one KV chunk.  `window` > 0 (causal only) also masks the keys at or below
// qpos - window, a sliding window: key tiles wholly below the window of a
// block's first row are not loaded, the edge tiles are masked.  No fast
// math: expf, or exp2f of pre-scaled scores in the tensor-core kernel.
// A rank's share of a split over `model` that does not divide its heads
// (GSPMD's uneven pieces) need not hold whole groups: then G and `off` are
// given, head h reads KV head (off + h) / G, and every kernel below walks
// each KV head's G rows as ever, row (t, g) being head kvh * G + g - off;
// the rows of heads outside [0, H) read q (and g) as zeros (a masked load,
// or TMA's fill of a box's coordinates outside the tensor) and write
// nothing, so they add nothing to dk and dv.
// Two kernels; repro_torch.kernels.flash_attention.flash_route picks one
// from the dtype and the shapes:
//
// fa_tc_kernel, bfloat16 on the tensor cores (dh a multiple of 8 up to 256,
// G up to 64, or 128; 16-byte-aligned bases and strides):
//   * One block per (b * KV + kv head, pair of row tiles), the heaviest
//     causal pairs first: two consumer warpgroups of one row tile each and
//     one producer warpgroup (registers moved to the consumers by
//     setmaxnreg).  A row tile is a wgmma's 64 row slots holding a.rt =
//     G * floor(64 / G) (token, g) rows of whole tokens (60 at internvl2's
//     G 6: 10 tokens, 4 slots empty), or at G 128 half a token; the empty
//     slots are zeroed once and never written.
//   * The producer's TMA loads read q, k and v in the model's own strided
//     layout through 4-D tensor maps (dh, head, token, batch): the q rows
//     once (where G divides 128 one box of G heads x 128 / G tokens, the
//     block's 128 rows in order; else a box of G heads x floor(64 / G)
//     tokens a row tile), then keys and values in a ring of 2 stages of 64
//     keys, each completed on an mbarrier and handed back on another.  dh
//     is padded to 64, 128 or 256 in shared memory by TMA's zero fill.
//   * S = Q.K^T by wgmma from shared memory into fp32 registers.  The
//     unscaled bf16 q goes into the product and the fp32 scores are scaled
//     after it (rounding a scaled q to bf16 would change the inputs); against
//     the plain version, which scales q in fp32 first, this moves the result
//     by fp32 rounding only.
//   * Masking on token positions (row / G, a row being its tile's first
//     row plus its slot), only in the tiles that cross
//     the diagonal or the end of the keys, then the online softmax in
//     registers, in base 2 (exp2f of the scores times scale * log2(e), one
//     FMA before each exp2f; the same function as expf of the scaled
//     scores up to fp32 rounding): the four lanes that share a row of the
//     accumulator fragment reduce its max and sum by shuffles.  Causal tiles
//     above the diagonal are not loaded.
//   * round_p 3: first a pass over the same key tiles that loads k alone
//     and keeps each row's max of its masked scores; the main pass then
//     starts from that max, so no tile raises it (alpha = 1, nothing is
//     rescaled) and every p is rounded against it.
//   * P.V by wgmma with P as the register operand, converted from the score
//     fragment, and V read MN-major through the transpose bit.  round_p: one
//     bf16 P.  Else the fp32 p is split into three bf16 terms, p_hi =
//     bf16(p), p_mid = bf16(p - p_hi), p_lo = bf16(p - p_hi - p_mid), and
//     the three products accumulate: p keeps its 24 significant bits, so the
//     output matches a CUDA-core fp32 P.V (the decode kernel's) up to the
//     order of the sums.  Two terms (16 bits) held every kernel case within
//     one bf16 ulp but flipped more bf16 served tokens against the
//     teacher-forced forward (PERF.md).
//   * The output is divided by max(l, 1e-30) and written in place, masked.
//
// fa_kernel, on the CUDA cores: float32 (the tensor cores would mean TF32,
// which the port's parity contract forbids) and the bf16 shapes the tensor
// cores cannot take (G 65..127 or above 128, unaligned views, dh > 256).
// Redesigned for this card; what bounded the first version was shared
// memory, not the FMAs (scalar 4-byte loads, 8 for 16 FMAs), one 8-warp
// block per SM over two waves, and three barriers per key tile.
//   * One block of 256 threads per (b * KV + kv head, tile of 64 (token, g)
//     rows), the heaviest causal tiles of all heads first, so the blocks
//     that start last are the light ones (the served prefill, B 1, S 1024,
//     H 16, KV 2: 256 blocks, one an SM).  Pairing tiles t and n - 1 - t in
//     one block, to run a single wave of equal blocks, timed no faster.
//     repro_torch.kernels.flash_attention.plan_flash_simt states the tiling
//     from the shapes, for the tests.
//   * The tile's q rows, scaled in fp32, stay in shared memory row-major
//     (pitch dh + 4) for the whole key loop; k and v tiles of BN keys go
//     through a 2-stage ring: for float32 with dh = 64, 128 or 256 and
//     16-byte bases and strides by 16-byte cp.async (rows past the keys
//     zero-filled), so tile j + 1 loads while tile j computes; else by
//     element loads converted to fp32.
//   * Thread (tr, tc) of a 16 x 16 grid owns rows tr + 16 i (i < 4), keys
//     tc + 16 j (j < BN / 16) and columns 64 h + 4 tc + e: S = Q.K^T from
//     float4 shared loads of 4 d's (q: 4 loads, k: BN / 16, for 4 x 4 x 4
//     FMAs), each score an fmaf chain over d in index order.
//   * The online softmax stays in registers: each row's 16 owners sit in
//     one half-warp and reduce its max and sum by shuffles (xor 1, 2, 4, 8).
//     p goes to shared memory row-major, read back by the same half-warp as
//     float4s of 4 keys for O += P.V (v tile key-major, float4 loads of 4
//     columns), fmaf in key order.  Two barriers per key tile.
//   * Causal tiles above the diagonal are skipped: the loop stops at the
//     tile's last token.  That is exact: such a tile gives m_new = m_prev,
//     alpha = 1 and p = 0 in the TPU kernel, since key 0 is valid for every
//     row.  Ragged Sq and Sk are masked, not padded; q, k and v are read in
//     the model's own layout through their strides (no transpose).
//   * dh > 256 (WIDE): the output columns are split over blocks in chunks
//     of 256.  Such a block streams q and k through shared memory in
//     256-wide chunks of d for the full-dh scores (the same fmaf chain) and
//     accumulates only its chunk of P.V.
//
// Bound: operations.  4 * Sq * Sk * H * dh flops (half of it under the
// causal mask) against reading q, k, v and writing the output once; at the
// served shapes (Sq = Sk >= 100, dh = 128) that is well above the fp32 and
// bf16 ridges.

#include "attention.cuh"
#include "hopper.cuh"
#include <cuda_fp16.h>

#define FA_THREADS 256
#define FA_ROWS 64          // (token, g) rows of a tile, 4 per thread
#define FA_WIDE 256         // output columns of a block when dh > 256

struct FaArgs {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Sk, H, KV, dh, G, off;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
  int causal, round_p, vec, window;
};

// fa_kernel<T, DHP, BN>'s shared memory, in floats: q [FA_ROWS][QP], the k
// ring [2][BN][KP], the v ring [2][BN][VP], p [FA_ROWS][PP].  The pitches
// of q, k and p are padded by 16 bytes so that the float4 loads of a warp
// meet no bank conflict beyond the two wavefronts of 256 bytes.
template <int DHP, int BN>
struct FaShape {
  static constexpr int QP = DHP + 4, KP = DHP + 4, VP = DHP, PP = BN + 4;
  static constexpr int Q = FA_ROWS * QP, K = BN * KP, V = BN * VP;
  static constexpr int FLOATS = Q + 2 * K + 2 * V + FA_ROWS * PP;
};

// Stage `rows` rows of w columns of a (rows, dh) slice of k or v as fp32,
// row r from src + r * rs into dst + r * pitch, by element loads: zeros for
// rows at or past `nvalid` and for the columns [w, w rounded up to 4).
template <typename T>
__device__ __forceinline__ void fa_fill(float* dst, int pitch, const T* src,
                                        long long rs, int nvalid, int rows,
                                        int w) {
  const int w4 = (w + 3) & ~3;
  for (int e = threadIdx.x; e < rows * w4; e += FA_THREADS) {
    const int r = e / w4, d = e - r * w4;
    dst[r * pitch + d] = (r < nvalid && d < w) ? att_in<T>(src[r * rs + d]) : 0.0f;
  }
}

// The same for float32 rows of dh = 4 * SEGS on 16-byte boundaries, by
// 16-byte cp.async (rows at or past `nvalid` zero-filled): each thread
// keeps one 16-byte column of the rows (SEGS divides FA_THREADS).
template <int SEGS>
__device__ __forceinline__ void fa_copy(float* dst, int pitch,
                                              const float* src, long long rs,
                                              int nvalid, int rows) {
  const int d = (threadIdx.x % SEGS) * 4;
  for (int r = threadIdx.x / SEGS; r < rows; r += FA_THREADS / SEGS) {
    const bool ok = r < nvalid;
    hp_cp16(dst + r * pitch + d, ok ? src + r * rs + d : src, ok);
  }
}

// Rows r0 .. r0 + FA_ROWS of the tile's (token, g) rows of q (head h0 + g),
// columns [dc, dc + w), scaled in fp32; zeros past the rows, for heads
// outside [0, H) and in [w, w4).  A warp takes a row at a time, its lanes
// along d.
template <typename T>
__device__ __forceinline__ void fa_fill_q(float* Qs, int pitch, const T* q,
                                          const FaArgs& a, int G, int h0,
                                          int r0, int dc, int w) {
  const int w4 = (w + 3) & ~3, nrows = a.Sq * G, lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < FA_ROWS; r += FA_THREADS / 32) {
    const int row = r0 + r, t = row / G, h = h0 + row - t * G;
    const bool live = row < nrows && h >= 0 && h < a.H;
    const T* src = q + t * a.qss + (long long)(live ? h : 0) * a.qsh + dc;
    for (int d = lane; d < w4; d += 32)
      Qs[r * pitch + d] = (live && d < w) ? att_in<T>(src[d]) * a.scale : 0.0f;
  }
}

// s[i][j] += q(row tr + 16 i) . k(key tc + 16 j) over d in [0, d4), one
// fmaf chain per score in index order, from float4 loads of 4 d's.
template <int TN>
__device__ __forceinline__ void fa_scores(float (&s)[4][TN], const float* Qs,
                                          int qp, const float* Ks, int kp,
                                          int d4, int tr, int tc) {
#pragma unroll 2
  for (int d = 0; d < d4; d += 4) {
    float4 qa[4], kb[TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qa[i] = *reinterpret_cast<const float4*>(Qs + (tr + 16 * i) * qp + d);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      kb[j] = *reinterpret_cast<const float4*>(Ks + (tc + 16 * j) * kp + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
        s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
        s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
        s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
      }
  }
}

__device__ __forceinline__ float fa_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <typename T, int DHP, int BN, bool WIDE>
__global__ void __launch_bounds__(FA_THREADS, 1)
fa_kernel(FaArgs a) {
  using S = FaShape<DHP, BN>;
  constexpr int TN = BN / 16, NH = DHP / 64;      // keys, float4 columns a thread
  constexpr bool CP = !WIDE && sizeof(T) == 4;    // cp.async where a.vec
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                               // [FA_ROWS][QP] scaled q
  float* Ks = Qs + S::Q;                          // [2][BN][KP]
  float* Vs = Ks + 2 * S::K;                      // [2][BN][VP]
  float* Ps = Vs + 2 * S::V;                      // [FA_ROWS][PP] p

  const int tid = threadIdx.x, lane = tid & 31;
  const int tr = (tid >> 5) * 2 + (lane >> 4), tc = lane & 15;
  const int G = a.G, nrows = a.Sq * G, dh = a.dh;
  const int nt = (nrows + FA_ROWS - 1) / FA_ROWS;
  const int ncz = WIDE ? (dh + FA_WIDE - 1) / FA_WIDE : 1;
  const int nbkv = a.B * a.KV;
  const int cz = blockIdx.x % ncz, rest = blockIdx.x / ncz;
  const int bkv = rest % nbkv, rank = rest / nbkv;   // heaviest first
  const int r0 = (nt - 1 - rank) * FA_ROWS;
  const int b = bkv / a.KV, kvh = bkv - b * a.KV;
  const int c0 = cz * FA_WIDE, wc = WIDE ? min(FA_WIDE, dh - c0) : dh;
  const int dh4 = (dh + 3) & ~3;
  const bool cp = CP && a.vec && dh == DHP;
  const int h0 = kvh * G - a.off;                 // the head of row g: h0 + g
  const T* q = static_cast<const T*>(a.q) + b * a.qsb;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh + c0;
  T* o = static_cast<T*>(a.o);

  // Stage key tile j0 into ring slot buf (the whole tile for !WIDE; v only
  // for WIDE, whose k goes by chunks of d).
  auto stage = [&](int buf, int j0) {
    const int nk = min(BN, a.Sk - j0);
    float* kd = Ks + buf * S::K;
    float* vd = Vs + buf * S::V;
    if (WIDE) {
      fa_fill<T>(vd, S::VP, v + j0 * a.vss, a.vss, nk, BN, wc);
    } else if (cp) {
      fa_copy<DHP / 4>(kd, S::KP, reinterpret_cast<const float*>(k) + j0 * a.kss,
                       a.kss, nk, BN);
      fa_copy<DHP / 4>(vd, S::VP, reinterpret_cast<const float*>(v) + j0 * a.vss,
                       a.vss, nk, BN);
      hp_cp_commit();
    } else {
      fa_fill<T>(kd, S::KP, k + j0 * a.kss, a.kss, nk, BN, dh);
      fa_fill<T>(vd, S::VP, v + j0 * a.vss, a.vss, nk, BN, dh);
    }
  };

  const int last_row = min(r0 + FA_ROWS, nrows) - 1;
  const int kend = a.causal ? min(a.Sk, last_row / G + 1) : a.Sk;
  const int nkt = (kend + BN - 1) / BN;
  // the first key tile that holds a key inside the window of the tile's
  // first row (later rows' windows start later)
  const int jt0 = a.window > 0 ? max(0, r0 / G - a.window + 1) / BN : 0;
  int tok[4];
  float m[4], l[4], acc[4][NH][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tok[i] = (r0 + tr + 16 * i) / G;
    m[i] = ATT_NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;
  }
  if (!WIDE) {
    fa_fill_q<T>(Qs, S::QP, q, a, G, h0, r0, 0, dh);
    if (a.round_p == 3) {
      // each row's max over its visible keys first, so the main loop
      // rounds every p against it (there alpha = 1: no tile raises m)
      for (int jt = jt0; jt < nkt; ++jt) {
        const int j0 = jt * BN, nk = min(BN, a.Sk - j0);
        stage(0, j0);
        if (cp) hp_cp_wait<0>();
        __syncthreads();
        float s[4][TN];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
        fa_scores<TN>(s, Qs, S::QP, Ks, S::KP, dh4, tr, tc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int c = tc + 16 * j, key = j0 + c;
            if (c < nk && (!a.causal || key <= tok[i]) &&
                (a.window <= 0 || key > tok[i] - a.window))
              m[i] = fmaxf(m[i], s[i][j]);
          }
        __syncthreads();             // slot 0 is staged again
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
    }
    stage(0, jt0 * BN);
  }

  for (int jt = jt0; jt < nkt; ++jt) {
    const int j0 = jt * BN, nk = min(BN, a.Sk - j0);
    const int buf = WIDE ? 0 : (jt - jt0) & 1;
    float s[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
    if (WIDE) {
      // full-dh scores from chunks of q and k, then this block's v columns
      for (int dc = 0; dc < dh; dc += FA_WIDE) {
        const int w = min(FA_WIDE, dh - dc);
        __syncthreads();
        fa_fill_q<T>(Qs, S::QP, q, a, G, h0, r0, dc, w);
        fa_fill<T>(Ks, S::KP, k + j0 * a.kss + dc, a.kss, nk, BN, w);
        __syncthreads();
        fa_scores<TN>(s, Qs, S::QP, Ks, S::KP, (w + 3) & ~3, tr, tc);
      }
      stage(0, j0);
      __syncthreads();
    } else {
      if (jt + 1 < nkt) {
        stage(buf ^ 1, j0 + BN);
        if (cp) hp_cp_wait<1>();
      } else if (cp) {
        hp_cp_wait<0>();
      }
      __syncthreads();
      fa_scores<TN>(s, Qs, S::QP, Ks + buf * S::K, S::KP, dh4, tr, tc);
    }

    // mask, then the online softmax of each row in registers: its 16
    // owners (one half-warp) reduce the max and the sum by shuffles
    float mx[4], sum[4], alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = ATT_NEG;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tc + 16 * j, key = j0 + c;
        const bool ok = c < nk && (!a.causal || key <= tok[i]) &&
                        (a.window <= 0 || key > tok[i] - a.window);
        s[i][j] = ok ? s[i][j] : ATT_NEG;
        mx[i] = fmaxf(mx[i], s[i][j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    float* P = Ps + tr * S::PP;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      sum[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum[i] += p;
        P[16 * i * S::PP + tc + 16 * j] =
            a.round_p == 1 ? att_round<T>(p)
            : a.round_p >= 2 ? att_round<__nv_bfloat16>(p) : p;
      }
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h][e] *= alpha[i];
    }
    __syncwarp();

    // acc += p . v over this tile's keys, in key order (p and v are 0
    // past the keys)
    const float* Vt = Vs + buf * S::V + 4 * tc;
    const int nk4 = (nk + 3) & ~3;
#pragma unroll 2
    for (int j = 0; j < nk4; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(P + 16 * i * S::PP + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 vb[NH];
#pragma unroll
        for (int h = 0; h < NH; ++h)
          vb[h] = *reinterpret_cast<const float4*>(Vt + (j + e) * S::VP + 64 * h);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = fa_at(pa[i], e);
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            acc[i][h][0] = fmaf(pe, vb[h].x, acc[i][h][0]);
            acc[i][h][1] = fmaf(pe, vb[h].y, acc[i][h][1]);
            acc[i][h][2] = fmaf(pe, vb[h].z, acc[i][h][2]);
            acc[i][h][3] = fmaf(pe, vb[h].w, acc[i][h][3]);
          }
        }
      }
    }
    __syncthreads();     // the ring slot, q (WIDE) and p are free again
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + tr + 16 * i;
    if (row >= nrows) continue;
    const int t = row / G, h = h0 + row - t * G;
    if (h < 0 || h >= a.H) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = o + (((long long)b * a.Sq + t) * a.H + h) * dh + c0;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * h + 4 * tc + e;
        if (col < wc) dst[col] = att_out<T>(acc[i][h][e] / den);
      }
  }
}

template <typename T, int DHP, int BN, bool WIDE>
static int fa_run(const FaArgs& a, cudaStream_t s) {
  const int smem = FaShape<DHP, BN>::FLOATS * (int)sizeof(float);
  static int granted[HP_MAX_DEVICES] = {0};
  const int e = hp_grant_smem((const void*)fa_kernel<T, DHP, BN, WIDE>, smem, granted);
  if (e) return e;
  const long long nt = ((long long)a.Sq * a.G + FA_ROWS - 1) / FA_ROWS;
  const long long ncz = WIDE ? (a.dh + FA_WIDE - 1) / FA_WIDE : 1;
  const long long blocks = nt * a.B * a.KV * ncz;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fa_kernel<T, DHP, BN, WIDE><<<(unsigned)blocks, FA_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int fa_dispatch(const FaArgs& a, cudaStream_t s) {
  if (a.dh <= 64) return fa_run<T, 64, 64, false>(a, s);
  if (a.dh <= 128) return fa_run<T, 128, 64, false>(a, s);
  if (a.dh <= 256) return fa_run<T, 256, 32, false>(a, s);
  return fa_run<T, 256, 32, true>(a, s);
}

// H query heads read KV heads through groups of G from `off` on (G = H /
// KV and off 0 for whole groups): KV must be ceil((off + H) / G).
static bool fa_groups(int H, int KV, int G, int off) {
  return KV >= 1 && G >= 1 && off >= 0 && off < G && KV == (off + H + G - 1) / G;
}

// Strides in elements; the last axis of q, k and v is contiguous.  dtype 0 =
// float32, 1 = bfloat16 (q, k, v and out alike); vec = 1 when every row of
// k and v starts on a 16-byte boundary and dh fills whole 16-byte words
// (float32 then stages k and v by cp.async); round_p 0 to 3 (3: dh <= 256)
// and window (0: none; else causal only) as above.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Sk, int H, int KV, int dh, int G,
                         int off, long long qsb, long long qss, long long qsh,
                         long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh,
                         float scale, int causal, int round_p, int vec,
                         int dtype, int window, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (Sk < 1 || !fa_groups(H, KV, G, off) || dh < 1 || round_p < 0 || round_p > 3 ||
      (round_p == 3 && dh > 256) || window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  FaArgs a{q, k, v, o, B, Sq, Sk, H, KV, dh, G, off, qsb, qss, qsh, ksb, kss,
           ksh, vsb, vss, vsh, scale, causal, round_p, vec, window};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? fa_dispatch<float>(a, s) : fa_dispatch<__nv_bfloat16>(a, s);
}

// ------------------------------------------- bf16 on the tensor cores
#define FT_BM 128         // q rows per block: two consumer warpgroups
#define FT_BK 64          // keys per stage
#define FT_STAGES 2
#define FT_THREADS 384

template <int DHP>
struct FtShape {
  static constexpr int Q_BYTES = FT_BM * DHP * 2;    // DHP / 64 chunks of rows
  static constexpr int KV_BYTES = FT_BK * DHP * 2;   // of 128 bytes each
  static constexpr int BARS = Q_BYTES + FT_STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BARS + (1 + 2 * FT_STAGES) * 8 + 1024;
};

struct FtArgs {
  __nv_bfloat16* o;
  int B, Sq, Sk, H, KV, dh, G, off;
  int rt;                // rows of a row tile: whole tokens, or half of one
  float scale;
  int causal, window;
};

template <int DHP, int RP>
__global__ void __launch_bounds__(FT_THREADS, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap mq,
             const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv, FtArgs a) {
  using S = FtShape<DHP>;
  constexpr int NSC = FT_BK / 2, NO = DHP / 2;      // fragment registers
  constexpr int NP = RP ? 1 : 3;                    // bf16 terms of p
  constexpr int NPASS = RP == 3 ? 2 : 1;            // passes over the keys
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hp_smem(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + S::Q_BYTES;       // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + FT_STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int G = a.G, RT = a.rt;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int h0 = kvh * G - a.off;         // the head of row g (TMA fills h < 0)
  const int r0 = (gridDim.x - 1 - blockIdx.x) * 2 * RT;   // the block's first row
  const int nrows = a.Sq * G;
  const int last_row = min(r0 + 2 * RT, nrows) - 1;
  const int kend = a.causal ? min(a.Sk, last_row / G + 1) : a.Sk;
  const int nt = (kend + FT_BK - 1) / FT_BK;
  // the first key tile inside the window of the block's first row
  const int j0 = a.window > 0 ? max(0, r0 / G - a.window + 1) / FT_BK : 0;
  const int nj = max(0, nt - j0);                   // key tiles a pass
  if (tid == 0) {
    hp_bar_init(q_full, 1);
    for (int s = 0; s < FT_STAGES; ++s) {
      hp_bar_init(&full[s], 1);
      hp_bar_init(&empty[s], 8);          // one arrival per consumer warp
    }
    hp_bar_init_fence();
  }
  if (RT < 64) {                          // the empty slots of both row tiles
    const int dead = 64 - RT, n16 = 2 * (DHP / 64) * dead * 8;
    for (int i = tid; i < n16; i += FT_THREADS) {
      const int u = i % 8, r = (i / 8) % dead, c = i / (8 * dead);
      *reinterpret_cast<uint4*>(Qs + c * 64 * 128 + (RT + r) * 128 + u * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    hp_fence_async_smem();
  }
  __syncthreads();

  if (wg == 2) {
    // ----------------------------------------------------- producer
    hp_regs_dec<40>();
    if (tid != 256) return;
    if (RT == 64) {                       // G divides 128: one box of 128 rows
      hp_bar_expect_tx(q_full, S::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DHP / 64; ++c)
        hp_tma_4d(Qs + c * FT_BM * 128, &mq, q_full, c * 64, h0, r0 / G, b);
    } else {                              // a box of whole tokens a row tile
      hp_bar_expect_tx(q_full, 2 * (DHP / 64) * RT * 128);
#pragma unroll
      for (int c = 0; c < DHP / 64; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          hp_tma_4d(Qs + c * FT_BM * 128 + h * 64 * 128, &mq, q_full, c * 64,
                    h0, (r0 + h * RT) / G, b);
    }
    // the key tiles once a pass; RP 3's first pass (the rows' max) takes k alone
    for (int n = 0; n < NPASS * nj; ++n) {
      const int j = j0 + n % nj, s = n % FT_STAGES;
      const bool with_v = RP != 3 || n >= nj;
      if (n >= FT_STAGES) hp_bar_wait(&empty[s], ((n / FT_STAGES) - 1) & 1);
      uint8_t* Kt = KVs + s * 2 * S::KV_BYTES;
      uint8_t* Vt = Kt + S::KV_BYTES;
      hp_bar_expect_tx(&full[s], (with_v ? 2 : 1) * S::KV_BYTES);
#pragma unroll
      for (int c = 0; c < DHP / 64; ++c) {
        hp_tma_4d(Kt + c * FT_BK * 128, &mk, &full[s], c * 64, kvh, j * FT_BK, b);
        if (with_v)
          hp_tma_4d(Vt + c * FT_BK * 128, &mv, &full[s], c * 64, kvh, j * FT_BK, b);
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    hp_regs_inc<232>();
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int sl = warp * 16 + lane / 4;              // slots sl and sl + 8
    const int rw = r0 + wg * RT;                      // this row tile's first row
    const int tok[2] = {(rw + sl) / G, (rw + sl + 8) / G};
    const int tok_lo = rw / G;                        // this row tile's first
    const int tok_hi = (rw + RT - 1) / G;             // and last token
    const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    float mrow[2] = {ATT_NEG, ATT_NEG}, lrow[2] = {0.0f, 0.0f};
    // S = Q . K^T of key tile j over the padded depth, unscaled, masked
    // (only where the tile crosses the diagonal, the end of the keys or the
    // window's lower edge); edge says whether it was
    auto scores = [&](int j, const uint8_t* Kt, float (&sc)[NSC], bool& edge) {
#pragma unroll
      for (int i = 0; i < NSC; ++i) sc[i] = 0.0f;
      hp_fence_regs(sc);
      hp_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        const int c = kk / 4, kin = (kk % 4) * 32;
        hp_wgmma_ss<FT_BK, 0>(
            sc, hp_desc(Qs + c * FT_BM * 128 + wg * 64 * 128 + kin, 16, 1024),
            hp_desc(Kt + c * FT_BK * 128 + kin, 16, 1024), 1);
      }
      hp_wgmma_commit();
      hp_wgmma_wait<0>();
      hp_fence_regs(sc);
      edge = (j + 1) * FT_BK > a.Sk ||
             (a.causal && (j + 1) * FT_BK - 1 > tok_lo) ||
             (a.window > 0 && j * FT_BK <= tok_hi - a.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < NSC; ++i) {
          const int h = (i / 2) % 2;
          const int key = j * FT_BK + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          if (key >= a.Sk || (a.causal && key > tok[h]) ||
              (a.window > 0 && key <= tok[h] - a.window))
            sc[i] = ATT_NEG;
        }
      }
    };
    hp_bar_wait(q_full, 0);
    if constexpr (RP == 3) {
      // each row's max over its visible keys first (k alone), so that the
      // pass below rounds every p against it: there no tile raises mrow
      // (the same scores, and the product's rounding keeps their order), so
      // alpha = 1 and nothing is rescaled
      float mx[2] = {ATT_NEG, ATT_NEG};
      for (int n = 0; n < nj; ++n) {
        const int s = n % FT_STAGES;
        hp_bar_wait(&full[s], (n / FT_STAGES) & 1);
        float sc[NSC];
        bool edge;
        scores(j0 + n, KVs + s * 2 * S::KV_BYTES, sc, edge);
        if (lane == 0) hp_bar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < NSC; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        mrow[h] = fmaxf(mrow[h], mx[h] * sl2);
      }
    }
    for (int n = (NPASS - 1) * nj; n < NPASS * nj; ++n) {
      const int j = j0 + n % nj, s = n % FT_STAGES;
      hp_bar_wait(&full[s], (n / FT_STAGES) & 1);
      const uint8_t* Kt = KVs + s * 2 * S::KV_BYTES;
      const uint8_t* Vt = Kt + S::KV_BYTES;
      float sc[NSC];
      bool edge;
      scores(j, Kt, sc, edge);

      // the online softmax in base 2 of the scores scaled by scale * log2(e)
      float mx[2] = {ATT_NEG, ATT_NEG};
#pragma unroll
      for (int i = 0; i < NSC; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(mrow[h], mx[h] * sl2);
        alpha[h] = exp2f(mrow[h] - m_new);
        mrow[h] = m_new;
      }
      // a masked score gives p = 0 exactly: in a row that has met no key
      // yet (a window's first tiles), mrow is the masked score's own scaled
      // value, and the fmaf's residual would give exp2f of +-2^72
#pragma unroll
      for (int i = 0; i < NSC; ++i) {
        const int h = (i / 2) % 2;
        const float e = exp2f(fmaf(sc[i], sl2, -mrow[h]));
        sc[i] = (edge && sc[i] == ATT_NEG) ? 0.0f : e;
        rs[h] += sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        lrow[h] = lrow[h] * alpha[h] + rs[h];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];

      // P in the A-operand layout: k-step kk holds keys 16 kk .. 16 kk + 15;
      // term t is the bf16 rounding of what terms 0 .. t-1 left of p
      uint32_t pp[NP][FT_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < FT_BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
#pragma unroll
          for (int t = 0; t < NP; ++t) {
            const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
            pp[t][kk][r] = *reinterpret_cast<const uint32_t*>(&b);
            x0 -= __low2float(b);
            x1 -= __high2float(b);
          }
        }

      // O += P . V, one product per term of p
      hp_fence_regs(o);
      hp_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FT_BK / 16; ++kk) {
        const uint64_t dv = hp_desc(Vt + kk * 2048, FT_BK * 128, 1024);
#pragma unroll
        for (int t = 0; t < NP; ++t) hp_wgmma_rs<DHP, 1>(o, pp[t][kk], dv, 1);
      }
      hp_wgmma_commit();
      hp_wgmma_wait<0>();
      hp_fence_regs(o);
      if (lane == 0) hp_bar_arrive(&empty[s]);
    }

    // ------------------------------------------------------ epilogue
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rw + sl + 8 * h;
      if (sl + 8 * h >= RT || row >= nrows) continue;
      const int t = row / G, hd = h0 + row % G;
      if (hd < 0 || hd >= a.H) continue;
      const float l = fmaxf(lrow[h], 1e-30f);
      __nv_bfloat16* dst = a.o + (((long long)b * a.Sq + t) * a.H + hd) * a.dh;
#pragma unroll
      for (int n8 = 0; n8 < DHP / 8; ++n8) {
        const int col = 8 * n8 + 2 * (lane % 4);
        if (col < a.dh)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
              o[4 * n8 + 2 * h] / l, o[4 * n8 + 2 * h + 1] / l);
      }
    }
  }
}

template <int DHP, int RP>
static int fa_tc_run(const FtArgs& a, const CUtensorMap& mq,
                     const CUtensorMap& mk, const CUtensorMap& mv,
                     cudaStream_t s) {
  static int granted[HP_MAX_DEVICES] = {0};
  const int smem = FtShape<DHP>::SMEM;
  const int e = hp_grant_smem((const void*)fa_tc_kernel<DHP, RP>, smem, granted);
  if (e) return e;
  const long long ntile = ((long long)a.Sq * a.G + a.rt - 1) / a.rt;
  dim3 grid((unsigned)((ntile + 1) / 2), a.B * a.KV);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  fa_tc_kernel<DHP, RP><<<grid, FT_THREADS, smem, s>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

// round_p 0: fp32 p; 1 and 2 alike (v is bfloat16): a key tile's running
// max; 3: the row's max
template <int DHP>
static int fa_tc_mode(int round_p, const FtArgs& a, const CUtensorMap& mq,
                      const CUtensorMap& mk, const CUtensorMap& mv,
                      cudaStream_t s) {
  if (round_p == 3) return fa_tc_run<DHP, 3>(a, mq, mk, mv, s);
  return round_p ? fa_tc_run<DHP, 1>(a, mq, mk, mv, s)
                 : fa_tc_run<DHP, 0>(a, mq, mk, mv, s);
}

// The 4-D map (dh, head, token, batch) of a (B, S, heads, dh) bf16 view with
// element strides sb, ss, sh, boxes of 64 x bh heads x bs tokens.
static int fa_tc_map(CUtensorMap* m, const void* base, int B, int S, int heads,
                     int dh, long long sb, long long ss, long long sh, int bh,
                     int bs) {
  const uint64_t dims[4] = {(uint64_t)dh, (uint64_t)heads, (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)ss * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {64, (uint32_t)bh, (uint32_t)bs, 1};
  return hp_encode_bf16(m, base, 4, dims, strides, box);
}

// bfloat16 q, k, v and out; strides in elements, every one a multiple of 8
// and every base 16-byte aligned; dh a multiple of 8 up to 256; G up to 64,
// or 128, and off as fa_launch's (q's map holds the H heads: a box that
// starts at kvh * G - off reads the heads outside them as zeros);
// round_p 0 to 3 as fa_launch's (1 and 2 alike: v is bfloat16); window as
// fa_launch's.
// Returns cudaGetLastError() after the launch (0 = launched), or the error
// of a refused grant or tensor-map encoding.
extern "C" int fa_tc_launch(const void* q, const void* k, const void* v, void* o,
                            int B, int Sq, int Sk, int H, int KV, int dh, int G,
                            int off, long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            float scale, int causal, int round_p, int window,
                            void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (Sk < 1 || !fa_groups(H, KV, G, off) || dh < 8 || dh % 8 != 0 || dh > 256 ||
      window < 0 || (window > 0 && !causal) || round_p < 0 || round_p > 3)
    return (int)cudaErrorInvalidValue;
  // a row tile: the whole tokens of 64 slots, or at G 128 half a token
  const int rt = G <= 64 ? G * (64 / G) : G == 128 ? 64 : 0;
  if (rt == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap mq{}, mk{}, mv{};
  int e;
  // where G divides 128 one box holds both row tiles, else one a box
  const int bq = FT_BM % G == 0 ? FT_BM / G : 64 / G;
  if ((e = fa_tc_map(&mq, q, B, Sq, H, dh, qsb, qss, qsh, G, bq))) return e;
  if ((e = fa_tc_map(&mk, k, B, Sk, KV, dh, ksb, kss, ksh, 1, FT_BK))) return e;
  if ((e = fa_tc_map(&mv, v, B, Sk, KV, dh, vsb, vss, vsh, 1, FT_BK))) return e;
  FtArgs a{(__nv_bfloat16*)o, B, Sq, Sk, H, KV, dh, G, off, rt, scale, causal,
           window};
  cudaStream_t s = (cudaStream_t)stream;
  if (dh <= 64) return fa_tc_mode<64>(round_p, a, mq, mk, mv, s);
  if (dh <= 128) return fa_tc_mode<128>(round_p, a, mq, mk, mv, s);
  return fa_tc_mode<256>(round_p, a, mq, mk, mv, s);
}

// ------------------------------------------- backward, on the CUDA cores
//
// The gradient of the forward with fp32 p (round_p 0, the model's own
// attention), for training: dq, dk and dv in q's dtype from q, k, v and
// the output's gradient g (all (B, S, heads, dh), read through their
// strides; dq, dk and dv written contiguous).  It stands in for what XLA
// derives by autodiff from the reference model's training attention,
// src/repro/models/attention.py:70 `flash_attention` (pure jnp: the Pallas
// kernel `_kernel` has no backward and is not on the reference's training
// path).  Masks as the forward: causal from the top-left corner, a window
// > 0 also masks the keys at or below qpos - window; key tiles and row
// tiles that the masks leave empty are skipped.  dh up to 256 (padded to
// 64, 128 or 256 in shared memory).  Deterministic: no atomics; every sum
// is one thread's fmaf chain in a fixed order; fp32 inside, each result
// rounded once to the input dtype.  The route of the calls the tensor
// cores do not take (repro_torch.kernels.flash_attention.flash_bwd_route):
// dh not a multiple of 8, views off 16 bytes, G 65..127 or above 128 (and
// float32 at DHP 256 above G 16), and any call forced onto it (`route=
// "simt"`), with p in fp32 or rounded to bfloat16 (`round_p`, below: the
// tensor cores take it for bfloat16, their point 6; float32 stays here).
// Two kernels, launched in this order:
//
// fb_dq_kernel: one block per (b * KV + kv head, tile of QM (token, g)
//   rows), the heaviest causal tiles first.  Pass 1 over the tile's key
//   tiles recomputes s = (q * scale) . k and dp = g . v and keeps, per
//   row, the online max m, l = sum exp(s - m) and sum exp(s - m) * dp:
//   lse = m + log l and D = sum_j p_j dp_j, which equals rowsum(g o out)
//   for the unrounded out (a bf16 out would move D by its rounding; one
//   more product buys the exact value).  lse and D go to (B, H, Sq) fp32
//   scratch for the second kernel (lse is also returned).  Pass 2
//   recomputes s and dp, p = exp(s - lse), ds = p (dp - D) into shared
//   memory, and dq += ds . k; dq = scale * that.
// fb_dkdv_kernel: one block per (b * KV + kv head, tile of KN keys), key
//   tile 0 (under the causal mask the heaviest) first.  For each tile of
//   KM (token, g) rows that can see the keys (causal: tokens from the
//   first key on; window: tokens before the last key + window), in order:
//   s and dp transposed (keys x rows), p and ds from the rows' lse and D,
//   then dv += p^T . g and dk += ds^T . (q * scale).  The G query heads of
//   the KV head are rows of the same walk, so their sum needs no atomics.
// round_p (the template flag RP): the gradient of the forward whose P.V
// takes p rounded to bfloat16, the model's `probs_bf16` (the reference's
// `flash_attention` with one KV chunk under jax.grad).  With m the row max,
// p_j = e^(s_j - m), l = sum p_j and r() the rounding, out = sum r(p_j) v_j
// / l.  The rounding is relative to m, so the function is not
// shift-invariant and m's gradient reaches the row's argmax key:
//   dp~_j = r((g / l) . v_j)   (the reference's order: g / l, then the dot)
//   D = sum_j r(p_j) (g / l) . v_j = g . out
//   ds_j = p_j (dp~_j - D / l) + [s_j = m] (D - sum_i p_i dp~_i) / n_ties
//   dv_j = sum_rows r(p_j) g / l
// (ties at the max split the share evenly, as jax.grad of max does; the
// scores are bitwise alike in both kernels, so s_j = m is exact).  The
// rounding needs the final m before any p is rounded, so fb_dq_kernel runs
// three passes: m and l; then D, the share's D - sum p dp~ (summed from
// each key's rounding residuals, (r(p) - p) x + p (x - r(x)) with x =
// (g / l) . v: the difference of the two sums cancels to a few fp32 ulps of
// them) and the ties, with the g rows divided by l in shared memory; then
// ds and dq.  It leaves each row's m,
// l, D / l and the argmax share in four (B, H, Sq) planes of the scratch,
// and fb_dkdv_kernel stages g / l by them.
// Thread (tr, tc) of a 16 x 16 grid owns score rows tr + 16 i and columns
// tc + 16 j, accumulator rows tr + 16 i and columns 64 h + 4 tc + e, as
// fa_kernel; each row's 16 owners (one half-warp) reduce its statistics by
// shuffles.  Every operand is staged in shared memory as fp32 by element
// loads (row pitch padded by 16 bytes); one stage, two barriers per tile.
//
// Bound: operations.  The gradient needs 5 products of 2 Sq Sk H dh flops
// (s, dp, dv, dk, dq; halved under the causal mask); these kernels run 9
// (pass 1's two, pass 2's three, dkdv's four) on the fp32 CUDA cores, 10
// with round_p (pass 1's one, pass 2's two, pass 3's three, dkdv's four).

#define FB_THREADS 256
#define FB_INF __int_as_float(0x7f800000)   // the lse of a row that sees no key

struct FbArgs {
  const void* q; const void* k; const void* v; const void* g;
  void* dq; void* dk; void* dv; float* lse;
  float* delta;     // (B, KV * G, Sq) D; round_p: D / l, m, l, the argmax share
  int B, Sq, Sk, H, KV, dh, G, off;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, gsb, gss, gsh;
  float scale;
  int causal, window;
};

// s[i][j] += a(row tr + 16 i) . b(row tc + 16 j) over d in [0, d4), one
// fmaf chain per element in index order, from float4 loads of 4 d's.
template <int TI, int TJ>
__device__ __forceinline__ void fb_dots(float (&s)[TI][TJ], const float* A,
                                        int ap, const float* Bm, int bp,
                                        int d4, int tr, int tc) {
#pragma unroll 2
  for (int d = 0; d < d4; d += 4) {
    float4 x[TI], y[TJ];
#pragma unroll
    for (int i = 0; i < TI; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (tr + 16 * i) * ap + d);
#pragma unroll
    for (int j = 0; j < TJ; ++j)
      y[j] = *reinterpret_cast<const float4*>(Bm + (tc + 16 * j) * bp + d);
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

// acc[i][h][e] += sum_n w(row tr + 16 i, n) * m(n, 64 h + 4 tc + e) over
// n in [0, n4), fmaf in n order: w row-major (pitch wp), m row-major
// (pitch mp), both read as float4s.
template <int TI, int NH>
__device__ __forceinline__ void fb_accum(float (&acc)[TI][NH][4],
                                         const float* W, int wp,
                                         const float* M, int mp, int n4,
                                         int tr, int tc) {
  const float* Mt = M + 4 * tc;
#pragma unroll 2
  for (int n = 0; n < n4; n += 4) {
    float4 w[TI];
#pragma unroll
    for (int i = 0; i < TI; ++i)
      w[i] = *reinterpret_cast<const float4*>(W + (tr + 16 * i) * wp + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 mb[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h)
        mb[h] = *reinterpret_cast<const float4*>(Mt + (n + e) * mp + 64 * h);
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const float we = fa_at(w[i], e);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          acc[i][h][0] = fmaf(we, mb[h].x, acc[i][h][0]);
          acc[i][h][1] = fmaf(we, mb[h].y, acc[i][h][1]);
          acc[i][h][2] = fmaf(we, mb[h].z, acc[i][h][2]);
          acc[i][h][3] = fmaf(we, mb[h].w, acc[i][h][3]);
        }
      }
    }
  }
}

// Rows r0 .. r0 + R of one KV head's (token, g) rows of a (B, S, H, dh)
// tensor (base at batch b; row g is head h0 + g; token and head strides ss,
// sh) as fp32 times mul into dst (pitch), columns [0, DHP): zeros past
// nrows, for heads outside [0, H) and past dh.  A warp takes a row at a
// time, its lanes along d.
// With `div` (shared memory, one value a row) each row is divided by its
// value: g / l for round_p.
template <typename T, int DHP>
__device__ __forceinline__ void fb_fill_rows(float* dst, int pitch,
                                             const T* base, long long ss,
                                             long long sh, int G, int h0,
                                             int H, int r0, int R, int nrows,
                                             int dh, float mul,
                                             const float* div = nullptr) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += FB_THREADS / 32) {
    const int row = r0 + r, t = row / G, h = h0 + row - t * G;
    const bool live = row < nrows && h >= 0 && h < H;
    const T* src = base + t * ss + (long long)(live ? h : 0) * sh;
    for (int d = lane; d < DHP; d += 32) {
      const float x = (live && d < dh) ? att_in<T>(src[d]) * mul : 0.0f;
      dst[r * pitch + d] = div ? x / div[r] : x;
    }
  }
}

// `rows` rows of a key tile (row r at src + r * rs) as fp32, columns
// [0, DHP): zeros for rows at or past nvalid and past dh.
template <typename T, int DHP>
__device__ __forceinline__ void fb_fill_keys(float* dst, int pitch,
                                             const T* src, long long rs,
                                             int nvalid, int rows, int dh) {
  for (int e = threadIdx.x; e < rows * DHP; e += FB_THREADS) {
    const int r = e / DHP, d = e - r * DHP;
    dst[r * pitch + d] = (r < nvalid && d < dh) ? att_in<T>(src[r * rs + d]) : 0.0f;
  }
}

__device__ __forceinline__ bool fb_visible(const FbArgs& a, int key, int tok) {
  return key < a.Sk && (!a.causal || key <= tok) &&
         (a.window <= 0 || key > tok - a.window);
}

// fb_dq_kernel's shared memory, in floats: q * scale and g [QM][P], k and
// v [QN][P], ds [QM][QN + 4].
template <int DHP, int QM, int QN>
struct FbQShape {
  static constexpr int P = DHP + 4, SP = QN + 4;
  static constexpr int FLOATS = 2 * QM * P + 2 * QN * P + QM * SP;
};

template <typename T, int DHP, int QM, int QN, bool RP>
__global__ void __launch_bounds__(FB_THREADS, 1)
fb_dq_kernel(FbArgs a) {
  using S = FbQShape<DHP, QM, QN>;
  constexpr int TI = QM / 16, TJ = QN / 16, NH = DHP / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [QM][P] q * scale
  float* Gs = Qs + QM * S::P;             // [QM][P] g (round_p: g / l from pass 2)
  float* Ks = Gs + QM * S::P;             // [QN][P]
  float* Vs = Ks + QN * S::P;             // [QN][P]
  float* Ds = Vs + QN * S::P;             // [QM][SP] ds

  const int tid = threadIdx.x, lane = tid & 31;
  const int tr = (tid >> 5) * 2 + (lane >> 4), tc = lane & 15;
  const int G = a.G, nrows = a.Sq * G, dh = a.dh;
  const int dh4 = (dh + 3) & ~3;
  const int nt = (nrows + QM - 1) / QM, nbkv = a.B * a.KV;
  const int bkv = blockIdx.x % nbkv, rank = blockIdx.x / nbkv;   // heaviest first
  const int r0 = (nt - 1 - rank) * QM;
  const int b = bkv / a.KV, kvh = bkv - b * a.KV;
  const int h0 = kvh * G - a.off;                 // the head of row g: h0 + g
  const T* q = static_cast<const T*>(a.q) + b * a.qsb;
  const T* go = static_cast<const T*>(a.g) + b * a.gsb;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  const int last_row = min(r0 + QM, nrows) - 1;
  const int kend = a.causal ? min(a.Sk, last_row / G + 1) : a.Sk;
  const int nkt = (kend + QN - 1) / QN;
  const int jt0 = a.window > 0 ? max(0, r0 / G - a.window + 1) / QN : 0;

  fb_fill_rows<T, DHP>(Qs, S::P, q, a.qss, a.qsh, G, h0, a.H, r0, QM, nrows, dh,
                       a.scale);
  fb_fill_rows<T, DHP>(Gs, S::P, go, a.gss, a.gsh, G, h0, a.H, r0, QM, nrows, dh,
                       1.0f);

  int tok[TI];
  bool live[TI];
  float m[TI], l[TI], pd[TI];
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int row = r0 + tr + 16 * i;
    tok[i] = row / G;
    live[i] = row < nrows;
    m[i] = ATT_NEG;
    l[i] = 0.0f;
    pd[i] = 0.0f;
  }

  // scores and (with_dp) dp of key tile jt into s and dp (k and v staged
  // first)
  auto tile = [&](int jt, float (&s)[TI][TJ], float (&dp)[TI][TJ], bool with_dp) {
    const int j0 = jt * QN, nk = min(QN, a.Sk - j0);
    __syncthreads();                      // the last tile's readers are done
    fb_fill_keys<T, DHP>(Ks, S::P, k + j0 * a.kss, a.kss, nk, QN, dh);
    if (with_dp) fb_fill_keys<T, DHP>(Vs, S::P, v + j0 * a.vss, a.vss, nk, QN, dh);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) s[i][j] = dp[i][j] = 0.0f;
    fb_dots<TI, TJ>(s, Qs, S::P, Ks, S::P, dh4, tr, tc);
    if (with_dp) fb_dots<TI, TJ>(dp, Gs, S::P, Vs, S::P, dh4, tr, tc);
  };

  // pass 1: the rows' softmax statistics and (p in fp32) D, online
  for (int jt = jt0; jt < nkt; ++jt) {
    float s[TI][TJ], dp[TI][TJ];
    tile(jt, s, dp, !RP);
    const int j0 = jt * QN;
    float mx[TI], ps[TI], pds[TI];
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      mx[i] = ATT_NEG;
#pragma unroll
      for (int j = 0; j < TJ; ++j)
        if (live[i] && fb_visible(a, j0 + tc + 16 * j, tok[i]))
          mx[i] = fmaxf(mx[i], s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
#pragma unroll
      for (int i = 0; i < TI; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    float alpha[TI];
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      ps[i] = 0.0f;
      pds[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < TJ; ++j)
        if (live[i] && fb_visible(a, j0 + tc + 16 * j, tok[i])) {
          const float p = expf(s[i][j] - m_new);
          ps[i] += p;
          if (!RP) pds[i] = fmaf(p, dp[i][j], pds[i]);
        }
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], off);
        if (!RP) pds[i] += __shfl_xor_sync(0xffffffffu, pds[i], off);
      }
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      l[i] = l[i] * alpha[i] + ps[i];
      pd[i] = pd[i] * alpha[i] + pds[i];
    }
  }
  float lse[TI], D[TI], share[TI];
  const long long plane = (long long)a.B * a.KV * G * a.Sq;   // rows of whole groups
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    // a row that sees no key (none of the model's) gets p = 0 everywhere
    lse[i] = l[i] > 0.0f ? m[i] + logf(l[i]) : FB_INF;
    D[i] = l[i] > 0.0f && !RP ? pd[i] / l[i] : 0.0f;
    share[i] = 0.0f;
  }

  if (RP) {
    // pass 2: g / l in place (each row by the 16 threads that own it), then
    // D = sum r(p) (g / l) . v, the argmax share's D - sum p r((g / l) . v)
    // and the ties at m
    __syncthreads();                      // pass 1's readers of Gs are done
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      float* gr = Gs + (tr + 16 * i) * S::P;
      if (l[i] > 0.0f)
        for (int d = tc; d < DHP; d += 16) gr[d] = gr[d] / l[i];
    }
    float e[TI], ties[TI];
#pragma unroll
    for (int i = 0; i < TI; ++i) e[i] = ties[i] = 0.0f;
    for (int jt = jt0; jt < nkt; ++jt) {
      float s[TI][TJ], dp[TI][TJ];
      tile(jt, s, dp, true);
      const int j0 = jt * QN;
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j)
          if (live[i] && fb_visible(a, j0 + tc + 16 * j, tok[i])) {
            // D - sum p r(dp) from each term's rounding residuals (exact in
            // fp32), not as the difference of the two sums, which cancel
            const float p = expf(s[i][j] - m[i]), rp = att_round<__nv_bfloat16>(p);
            const float x = dp[i][j], rx = att_round<__nv_bfloat16>(x);
            D[i] = fmaf(rp, x, D[i]);
            e[i] = fmaf(rp - p, x, fmaf(p, x - rx, e[i]));
            ties[i] += s[i][j] == m[i] ? 1.0f : 0.0f;
          }
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        D[i] += __shfl_xor_sync(0xffffffffu, D[i], off);
        e[i] += __shfl_xor_sync(0xffffffffu, e[i], off);
        ties[i] += __shfl_xor_sync(0xffffffffu, ties[i], off);
      }
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      share[i] = ties[i] > 0.0f ? e[i] / ties[i] : 0.0f;
      D[i] = l[i] > 0.0f ? D[i] / l[i] : 0.0f;       // D / l from here on
    }
  }
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int row = r0 + tr + 16 * i;
    if (tc == 0 && live[i]) {
      const int g = row - tok[i] * G;
      const long long at = ((long long)bkv * G + g) * a.Sq + tok[i];
      a.lse[at] = lse[i];
      a.delta[at] = D[i];
      if (RP) {
        a.delta[plane + at] = l[i] > 0.0f ? m[i] : FB_INF;
        a.delta[2 * plane + at] = l[i] > 0.0f ? l[i] : 1.0f;
        a.delta[3 * plane + at] = share[i];
      }
    }
  }

  // the last pass: ds into shared memory, dq += ds . k
  float acc[TI][NH][4];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;
  float* Drow = Ds + tr * S::SP;
  for (int jt = jt0; jt < nkt; ++jt) {
    float s[TI][TJ], dp[TI][TJ];
    tile(jt, s, dp, true);
    const int j0 = jt * QN;
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const bool ok = live[i] && fb_visible(a, j0 + tc + 16 * j, tok[i]);
        float ds = 0.0f;
        if (ok && RP) {
          ds = expf(s[i][j] - m[i]) * (att_round<__nv_bfloat16>(dp[i][j]) - D[i]);
          if (s[i][j] == m[i]) ds += share[i];
        } else if (ok) {
          ds = expf(s[i][j] - lse[i]) * (dp[i][j] - D[i]);
        }
        Drow[16 * i * S::SP + tc + 16 * j] = ds;
      }
    __syncwarp();                         // a row's ds come from its half-warp
    fb_accum<TI, NH>(acc, Ds, S::SP, Ks, S::P, QN, tr, tc);
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int h = h0 + r0 + tr + 16 * i - tok[i] * G;
    if (!live[i] || h < 0 || h >= a.H) continue;
    T* dst = dq + (((long long)b * a.Sq + tok[i]) * a.H + h) * dh;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * h + 4 * tc + e;
        if (col < dh) dst[col] = att_out<T>(acc[i][h][e] * a.scale);
      }
  }
}

// fb_dkdv_kernel's shared memory, in floats: k and v [KN][P], q * scale
// and g [KM][P], p and ds transposed [KN][KM + 4], lse and D [KM] (round_p:
// m and D / l, then l and the argmax share [KM]).
template <int DHP, int KN, int KM>
struct FbKShape {
  static constexpr int P = DHP + 4, SP = KM + 4;
  static constexpr int FLOATS = 2 * KN * P + 2 * KM * P + 2 * KN * SP + 4 * KM;
};

template <typename T, int DHP, int KN, int KM, bool RP>
__global__ void __launch_bounds__(FB_THREADS, 1)
fb_dkdv_kernel(FbArgs a) {
  using S = FbKShape<DHP, KN, KM>;
  constexpr int TK = KN / 16, TR = KM / 16, NH = DHP / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // [KN][P]
  float* Vs = Ks + KN * S::P;             // [KN][P]
  float* Qs = Vs + KN * S::P;             // [KM][P] q * scale
  float* Gs = Qs + KM * S::P;             // [KM][P] g
  float* Pt = Gs + KM * S::P;             // [KN][SP] p, key-major
  float* St = Pt + KN * S::SP;            // [KN][SP] ds, key-major
  float* Ls = St + KN * S::SP;            // [KM] lse (round_p: m)
  float* Dl = Ls + KM;                    // [KM] D (round_p: D / l)
  float* Ll = Dl + KM;                    // [KM] round_p: l
  float* Sh = Ll + KM;                    // [KM] round_p: the argmax share

  const int tid = threadIdx.x, lane = tid & 31;
  const int tr = (tid >> 5) * 2 + (lane >> 4), tc = lane & 15;
  const int G = a.G, nrows = a.Sq * G, dh = a.dh;
  const int dh4 = (dh + 3) & ~3;
  const int nbkv = a.B * a.KV;
  const int bkv = blockIdx.x % nbkv, kt = blockIdx.x / nbkv;
  const int b = bkv / a.KV, kvh = bkv - b * a.KV;
  const int j0 = kt * KN, nk = min(KN, a.Sk - j0);
  const int h0 = kvh * G - a.off;                 // the head of row g: h0 + g
  const T* q = static_cast<const T*>(a.q) + b * a.qsb;
  const T* go = static_cast<const T*>(a.g) + b * a.gsb;
  fb_fill_keys<T, DHP>(Ks, S::P, static_cast<const T*>(a.k) + b * a.ksb +
                       kvh * a.ksh + j0 * a.kss, a.kss, nk, KN, dh);
  fb_fill_keys<T, DHP>(Vs, S::P, static_cast<const T*>(a.v) + b * a.vsb +
                       kvh * a.vsh + j0 * a.vss, a.vss, nk, KN, dh);

  // the rows that can see a key of this tile
  const int row_lo = a.causal ? min(nrows, j0 * G) : 0;
  const int row_hi = a.window > 0
      ? (int)min((long long)nrows, (long long)(j0 + nk - 1 + a.window) * G)
      : nrows;
  float accK[TK][NH][4], accV[TK][NH][4];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) accK[i][h][e] = accV[i][h][e] = 0.0f;
  const long long plane = (long long)nbkv * G * a.Sq;     // rows of whole groups
  const float* del_bh = a.delta + (long long)bkv * G * a.Sq;
  const float* lse_bh = RP ? del_bh + plane : a.lse + (long long)bkv * G * a.Sq;

  for (int r0 = row_lo; r0 < row_hi; r0 += KM) {
    __syncthreads();                      // the last tile's readers are done
    for (int r = tid; r < KM; r += FB_THREADS) {
      const int row = r0 + r, t = row / G, g = row - t * G;
      const bool live = row < nrows;
      const long long at = (long long)g * a.Sq + t;
      Ls[r] = live ? lse_bh[at] : FB_INF;
      Dl[r] = live ? del_bh[at] : 0.0f;
      if (RP) {
        Ll[r] = live ? del_bh[2 * plane + at] : 1.0f;
        Sh[r] = live ? del_bh[3 * plane + at] : 0.0f;
      }
    }
    if (RP) __syncthreads();              // g / l reads the rows' l
    fb_fill_rows<T, DHP>(Qs, S::P, q, a.qss, a.qsh, G, h0, a.H, r0, KM, nrows,
                         dh, a.scale);
    fb_fill_rows<T, DHP>(Gs, S::P, go, a.gss, a.gsh, G, h0, a.H, r0, KM, nrows,
                         dh, 1.0f, RP ? Ll : nullptr);
    __syncthreads();
    float s[TK][TR], dp[TK][TR];
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) s[i][j] = dp[i][j] = 0.0f;
    fb_dots<TK, TR>(s, Ks, S::P, Qs, S::P, dh4, tr, tc);
    fb_dots<TK, TR>(dp, Vs, S::P, Gs, S::P, dh4, tr, tc);
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int r = tc + 16 * j, row = r0 + r;
        const bool ok = tr + 16 * i < nk && row < nrows &&
                        fb_visible(a, j0 + tr + 16 * i, row / G);
        const float p = ok ? expf(s[i][j] - Ls[r]) : 0.0f;
        float ds = 0.0f;
        if (ok && RP) {
          ds = p * (att_round<__nv_bfloat16>(dp[i][j]) - Dl[r]);
          if (s[i][j] == Ls[r]) ds += Sh[r];
        } else if (ok) {
          ds = p * (dp[i][j] - Dl[r]);
        }
        Pt[(tr + 16 * i) * S::SP + r] = RP ? att_round<__nv_bfloat16>(p) : p;
        St[(tr + 16 * i) * S::SP + r] = ds;
      }
    __syncwarp();                         // a key's p and ds come from its half-warp
    fb_accum<TK, NH>(accV, Pt, S::SP, Gs, S::P, KM, tr, tc);
    fb_accum<TK, NH>(accK, St, S::SP, Qs, S::P, KM, tr, tc);
  }

  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    if (tr + 16 * i >= nk) continue;
    const long long at = (((long long)b * a.Sk + j0 + tr + 16 * i) * a.KV + kvh) * dh;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * h + 4 * tc + e;
        if (col < dh) {
          dk[at + col] = att_out<T>(accK[i][h][e]);
          dv[at + col] = att_out<T>(accV[i][h][e]);
        }
      }
  }
}

template <typename T, int DHP, int QM, int QN, int KN, int KM, bool RP>
static int fb_run(const FbArgs& a, cudaStream_t s) {
  static int granted_q[HP_MAX_DEVICES] = {0}, granted_k[HP_MAX_DEVICES] = {0};
  const int smq = FbQShape<DHP, QM, QN>::FLOATS * (int)sizeof(float);
  const int smk = FbKShape<DHP, KN, KM>::FLOATS * (int)sizeof(float);
  int e = hp_grant_smem((const void*)fb_dq_kernel<T, DHP, QM, QN, RP>, smq, granted_q);
  if (e) return e;
  e = hp_grant_smem((const void*)fb_dkdv_kernel<T, DHP, KN, KM, RP>, smk, granted_k);
  if (e) return e;
  const long long nbkv = (long long)a.B * a.KV;
  const long long bq = ((long long)a.Sq * a.G + QM - 1) / QM * nbkv;
  const long long bk = ((long long)a.Sk + KN - 1) / KN * nbkv;
  if (bq > 0x7fffffffLL || bk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fb_dq_kernel<T, DHP, QM, QN, RP><<<(unsigned)bq, FB_THREADS, smq, s>>>(a);
  e = (int)cudaGetLastError();
  if (e) return e;
  fb_dkdv_kernel<T, DHP, KN, KM, RP><<<(unsigned)bk, FB_THREADS, smk, s>>>(a);
  return (int)cudaGetLastError();
}

// Tiles: dq blocks of QM rows over key tiles of QN, dkdv blocks of KN keys
// over row tiles of KM; 32 keys a dkdv block (twice the blocks of 64, and
// half the longest block's walk under the causal mask).
template <typename T, bool RP>
static int fb_dispatch(const FbArgs& a, cudaStream_t s) {
  if (a.dh <= 64) return fb_run<T, 64, 64, 64, 32, 64, RP>(a, s);
  if (a.dh <= 128) return fb_run<T, 128, 64, 64, 32, 64, RP>(a, s);
  return fb_run<T, 256, 32, 32, 32, 32, RP>(a, s);
}

// q (B, Sq, H, dh), k and v (B, Sk, KV, dh) and g (B, Sq, H, dh) with
// element strides (last axis contiguous), head h reading KV head (off + h)
// / G as fa_launch's; dq, dk, dv contiguous in the same dtype (0 float32,
// 1 bfloat16); lse and delta (B, KV * G, Sq) float32 scratch, the rows of
// whole groups (delta four such planes with round_p), lse left holding the
// rows' log-sum-exp (head h at row off + h); dh <= 256; causal and window
// as fa_launch's; round_p 1: p rounded to bfloat16 in P.V.  Launches
// fb_dq_kernel, then fb_dkdv_kernel.
// Returns the first cudaGetLastError() that is not 0, else 0.
extern "C" int fb_launch(const void* q, const void* k, const void* v,
                         const void* g, void* dq, void* dk, void* dv,
                         float* lse, float* delta,
                         int B, int Sq, int Sk, int H, int KV, int dh, int G,
                         int off, long long qsb, long long qss, long long qsh,
                         long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh,
                         long long gsb, long long gss, long long gsh,
                         float scale, int causal, int window, int dtype,
                         int round_p, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (Sk < 1 || !fa_groups(H, KV, G, off) || dh < 1 || dh > 256 || window < 0 ||
      (window > 0 && !causal) || dtype < 0 || dtype > 1 || round_p < 0 || round_p > 1)
    return (int)cudaErrorInvalidValue;
  FbArgs a{q, k, v, g, dq, dk, dv, lse, delta, B, Sq, Sk, H, KV, dh, G, off,
           qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, gsb, gss, gsh,
           scale, causal, window};
  cudaStream_t s = (cudaStream_t)stream;
  if (round_p)
    return dtype == 0 ? fb_dispatch<float, true>(a, s)
                      : fb_dispatch<__nv_bfloat16, true>(a, s);
  return dtype == 0 ? fb_dispatch<float, false>(a, s)
                    : fb_dispatch<__nv_bfloat16, false>(a, s);
}

// ----------------------------------------- backward on the tensor cores
//
// fbt_dq_kernel, then fbt_dkdv_kernel (fbt_dkdv2_kernel where DHP x NI is
// above 128): the same gradient as fb_dq_kernel and fb_dkdv_kernel (fp32 p,
// the model's own attention; with the template flag RP, bfloat16 only, p
// rounded to bfloat16, the model's `probs_bf16`: point 6) for bfloat16 q, k, v and g (NI = 1) or
// float32 (NI = 2, point 2), dq, dk and dv in that dtype, lse (B, H, Sq)
// fp32; causal, full or causal with a window, masked as fa_tc_kernel masks;
// dh a multiple of 8 up to 256 (padded to DHP 64, 128 or 256), G = H / KV
// up to 64, or 128 (float32 at DHP 256: up to 16, point 5).  They
// replace no TPU kernel: the reference's gradient is XLA's autodiff of
// src/repro/models/attention.py:70 `flash_attention`, and the Pallas
// `_kernel` has no backward.  Deterministic: no atomics on floats; every
// sum runs in an order fixed by the shapes.
//
// Bound: operations.  Five products of 2 Sq Sk H dh flops (s, dp, dv, dk,
// dq; the pairs the mask keeps), chip_smoke.flash_bwd_work; at qwen2.5-3b's
// trained shape that is 60x the bytes' time.  What the design does:
//   1. Every product is a wgmma.  A producer warp's TMA loads bring q, g, k
//      and v in the model's own strided layout into 128-byte-swizzled
//      shared memory through 4-D tensor maps (fa_tc_map), completed on
//      mbarriers (full/empty, as fa_tc_kernel).
//      * Rows are (token, g) pairs.  A row tile is a wgmma's 64 row slots
//        holding the a.rt = G * floor(64 / G) rows of whole tokens (60 at
//        internvl2's G 6: 10 tokens of 6 heads), one TMA box of G heads x
//        floor(64 / G) tokens; at G 128 it holds half a token (box 64
//        heads x 1 token).  The slots past a.rt are never loaded: the dkdv
//        kernel zeroes them once in every stage, their statistics are lse
//        = +inf and D = 0 (so p = ds = 0 there), and nothing is written
//        for them.  Where G divides 64 (or is 128) a.rt = 64 and no slot
//        is empty.
//      * fbt_dq_kernel: one block per (b * KV + kv head, pair of row
//        tiles), the heaviest causal pairs of all heads first, two consumer
//        warpgroups of one row tile each; the q and g tiles load once, k
//        and v stream through a ring of BK-key stages, twice (BK 64, or 32
//        at DHP 256: 128 rows of q and g then take 128 KB).  Pass 1: S =
//        q.k^T and dP = g.v^T (_ss, both K-major), the online max m, l =
//        sum exp(s - m) and sum exp(s - m) dp, in base 2 as the forward:
//        lse = m + log l and D = sum p dp, written to fp32 scratch by slot
//        (lse also to its (B, H, Sq) output).  Pass 2: S and dP again, p =
//        exp(s scale - lse), ds = p (dp - D) formed in S's registers, dQ +=
//        dS.K with dS from registers in the accumulator layout and K read
//        MN-major (transpose bit) from the same swizzled tile.  As
//        fa_tc_kernel, the unscaled bf16 q goes into the product and the
//        fp32 scores are scaled after it (fp32 rounding apart from the
//        plain version, which scales q first); dq = scale * the sum.
//      * fbt_dkdv_kernel (fbt_dkdv2_kernel at DHP 256, point 3): one block
//        per (b * KV + kv head, tile of FBT_BK keys, piece).  k and v load once; row tiles of q and g stream
//        through the ring with their slots' lse and D (bulk copies from the
//        scratch).  S^T = K.q^T and dP^T = V.g^T (_ss, K-major); P^T and
//        dS^T form in the accumulator layout; dV += P^T.g and dK += dS^T.q
//        with A from registers and B the row tile read MN-major: the tile
//        that fed S^T K-major, no second copy.  dk = scale * its sum.  The G
//        query heads of the KV head are rows of the same walk, so their sum
//        needs no atomics.
//   2. p and ds are fp32 A operands: each is split into NT bf16 terms (hi,
//      then what hi left, then what both left), one wgmma a term, as
//      fa_tc_kernel splits p: three terms carry all 24 bits, so the products
//      that take p or ds keep the plain version's fp32 operands.  7 products
//      in dq and 8 in dkdv against the bound's 5: the price of fp32
//      fidelity, still on the tensor cores.  Float32 inputs (no TF32):
//      fbs_split_kernel first copies q, g, k and v as NI = 2 fp16 terms of
//      the input scaled by a power of two 2^s (its largest magnitude into
//      [2^13, 2^14): fp16's range is narrow), hi = fp16(2^s x) and mid =
//      fp16(2^s x - hi) (22 bits), into a [2][B][S][heads][dh] block the
//      tensor maps read as batch b + t B; p and ds take NT = 2 fp16 terms
//      too, each row scaled by its own power of two (fbt_terms16), and
//      every product keeps the pairs hi.hi, hi.mid and mid.hi on fp16
//      wgmma (fbt_ss_terms, fbt_accum), its sum times the inverse powers:
//      15 products in dq and 12 in dkdv.  Two bf16 terms (16 bits) held
//      unit-scale inputs but not peaked scores (q and k five times larger:
//      dq 1.9x its limit); two fp16 terms hold every gradient within 1e-4
//      of its largest magnitude and lse within 1e-5 (one term of any
//      operand does not: tests/test_torch_flash_f32tc.py) once each row
//      tile's (dq: each key stage's) products are summed apart and added to
//      the running sum with rounding (fbt_accum).  At peaked scores (q and
//      k 8 to 16 times larger, scaled scores in the hundreds) what moves
//      the gradients is the rounding of the score's own fp32 sum, not the
//      terms' 22 bits (a third term of q and k changes nothing there):
//      the tensor cores add each k-step to the accumulator with rounding
//      that does not reach round-to-nearest, and the cross pairs, 2^-11 of
//      the score, went through the same accumulator.  So the score
//      products (S, S^T) keep hi.hi in two accumulators of their own (the
//      even and the odd k-steps) and the cross pairs in a third, summed
//      once at the end (fbt_ss_scores): the same products, no data read,
//      and the gradients' error against the exact one falls to a half or
//      a third (the CPU emulation's model of the accumulator, tests/
//      test_torch_flash_f32tc.py; the card, PERF.md).  The terms are
//      copied once in device memory because fp32 landing tiles beside the
//      terms do not fit a block's shared memory (the dq block's two terms
//      of 128 rows of q and g alone take 128 KB).  A float32 head's tiles
//      weigh as a bfloat16 head of twice the width, so DHP 128 runs the
//      DHP 256 geometry (32-key dq stages, fbt_dkdv2_kernel), and DHP 256
//      a geometry of its own (point 5).
//   3. Registers: a consumer has 232.  fbt_dkdv_kernel (DHP <= 128: one
//      consumer warpgroup, two blocks an SM): dK and dV 64 + 64, S^T and
//      dP^T 32 + 32, the terms 48 exceed them at once; so P^T's terms go
//      first and their products retire before dS^T's terms (formed from
//      dP^T's registers) are made.  At DHP 256 dK and dV alone would take
//      256, so fbt_dkdv2_kernel's two consumer warpgroups share the work by
//      output: warpgroup 0 computes S^T, P^T and dV (128 registers),
//      warpgroup 1 dP^T, dS^T and dK (128), each product over the whole
//      DHP; P^T alone crosses, through 16 KB of shared memory (two named
//      barriers a row tile).  Each does four of the eight products, and
//      neither needs the other's accumulator.  Splitting dh instead (each
//      warpgroup 128 columns of both, S^T and dP^T swapped) spilled (ptxas:
//      164 B, wgmma serialised) and ran 6-9 % slower.  k, v (32 KB each),
//      two stages of q and g rows (128 KB) and P^T fill one SM.  dq at DHP
//      256: dQ 128 registers, S and dP 16 + 16 at 32 keys a stage, ds's
//      terms 24.
//   4. 132 SMs: at B 1, KV 2, S 4,096 there are only 128 key tiles, and the
//      causal mask gives the first 64 times the rows of the last.  Each key
//      tile's walk is cut into `pieces` runs of row tiles of equal count
//      (repro_torch.kernels.flash_attention.plan_flash_bwd, which sizes it
//      by the blocks resident on an SM: 2, or 1 at DHP 256); each piece
//      writes fp32 partial dk and dv to scratch, and the last piece of a key
//      tile to arrive (an integer counter) sums all of them in piece order
//      and rounds once: the sum's order never depends on arrival.
//   5. Float32 at DHP 256 (zamba2's dh 224, deepseek-v2's MLA dh 192): two
//      fp16 terms of a row (or key) of one operand take 1 KB, so the
//      DHP-256 bfloat16 geometry would need 384 KB.  Row tiles of 16 slots
//      instead (FbtGeo: a.rt = G floor(16 / G) rows, G up to 16): a dq
//      block is one consumer warpgroup of 64 slots, four row tiles of q
//      and g (128 KB), with k and v in two stages of 16 keys (64 KB): 193
//      KB; a fbt_dkdv2_kernel block k and v of its 64 keys (128 KB), two
//      stages of one row tile of q and g (64 KB) and P^T of 64 x 16 (4 KB):
//      197 KB.  Every wgmma of the scores and of dP is then 64 x 16 (N 16),
//      the ones of dQ, dV and dK 64 x 256 over a single k-step.
//   6. p rounded to bfloat16 (RP, training with `probs_bf16`), bfloat16
//      inputs: the function fb_*'s RP computes (its comment gives the
//      gradient: dp~ = r((g / l) . v), D = sum r(p) (g / l) . v, ds = p (dp~
//      - D / l) plus the argmax share, dv = sum r(p) g / l), on the same
//      geometry.
//      * m must be final before any p is rounded, so fbt_dq_kernel streams
//        the keys three times: S alone (k alone is loaded) for each row's
//        max m, kept raw for the argmax test, and l online in base 2; then
//        S and dP for D = sum r(p) x, x = dP (1 / l) (dP from the products,
//        times the row's reciprocal after, not divided score by score: a
//        few fp32 ulps off the reference's (g / l) . v before r(), which
//        moves a rare r(x) by one bf16 ulp), the share's D - sum p r(x)
//        from each key's rounding residuals, (r(p) - p) x + p (x - r(x))
//        (as a difference of two sums it cancelled in fb_*), and the ties
//        at m; then S, dP and dQ.  Saving m and l from the forward would
//        keep two passes, but flash_attention_bwd called alone must
//        recompute them all the same: one path, not two, for one product of
//        the dq kernel's eight.
//      * The scratch holds four statistics a row slot (m, l, D / l, the
//        share; FbtArgs.stats), and each dkdv stage stages the four
//        (FbtKShape::NST).  The dkdv kernels form p from m as the dq
//        kernel does (m sl2, then exp2f(fmaf(s, sl2, -m sl2))), dS^T from
//        r(dP^T / l), and add the share where S^T equals m: S^T = K.q^T and
//        S = q.k^T take the same exact bf16 products in the same k-step
//        order, and come out bitwise equal (chip_smoke.py's one-hot cases:
//        there dq and dk are each row's share alone).  fbt_dkdv2_kernel's P^T crosses to warpgroup 1 with its
//        sign flipped at the max.
//      * r(p) is one bf16 term, exact in D's sums; dV's operand is r(p) / l
//        in three terms (l runs along the contraction, so it can join
//        neither r(p) nor the TMA-loaded g), and ds keeps its terms.
//      Bound as fp32 p; the dq kernel issues one score product more (8).
//      Float32 inputs stay on fb_*: this function's gradient moves by up to
//      one bf16 ulp of p or of dp~ times its other factors wherever fp32
//      rounding flips r(), and fb_* sums in the plain version's order
//      (q scale, then the dot; g / l, then the dot), so it flips as the
//      plain version does.  The fp16-term products here cannot: the RP
//      instances at NI 2 read deepseek-v2's MLA heads at S 1,024 2.1e-3 of
//      dq's largest from the plain version, against the float32 limit of
//      1e-3 that fb_* holds at 1.1e-4, and the same products summed
//      exactly read 1.4e-3 at zamba2-7b's heads
//      (tools/rounded_f32_emulation.py; PERF.md §6).
// G 65..127 and above 128 stay on the CUDA cores (a row tile holds neither
// whole tokens nor a whole part of one), and so does float32 at DHP 256
// with G above 16.

#define FBT_BK 64          // keys a dkdv block
#define FBT_RM 64          // row slots a consumer warpgroup holds (a wgmma's 64 rows)
#define FBT_STAGES 2
#define FBT_LOG2E 1.4426950408889634f
#define FBT_LN2 0.6931471805599453f

struct FbtArgs {
  void* dq; void* dk; void* dv;    // bfloat16 (NI 1) or float32 (NI 2)
  float* lse;            // (B, H, Sq): natural log-sum-exp of each row
  float* stats;          // [2][B * KV][rows_pad]: base-2 lse, then D, by slot;
                         // RP [4]: m, l, D / l, the argmax share (point 6)
  float* part;           // [B * KV * key tiles * pieces][DHP * 128]: registers
                         // by consumer thread
  int* count;            // [key tiles * B * KV] pieces arrived
  int B, Sq, Sk, H, KV, dh, G, off, rows_pad, pieces;
  int rt;                // rows of a row tile: whole tokens, or half of one
  float scale;
  int causal, window;
  // float32: the largest magnitudes of q, g, k and v (their bits), whose
  // powers of two scaled the inputs' fp16 terms (fbs_split_kernel)
  const unsigned* amax;
};

// Where the row slots lie.  A row tile is RS slots holding a.rt rows of
// whole tokens; a dq block holds WGQ consumer warpgroups of FBT_RM slots
// (TILES row tiles), a dkdv stage one row tile.  The float32 route at DHP
// 256 (ONE, point 5) cuts row tiles of 16 slots, one warpgroup a dq block;
// every other instance row tiles of 64 slots, two a dq block.
template <int DHP, int NI>
struct FbtGeo {
  static constexpr bool ONE = DHP == 256 && NI == 2;
  static constexpr int RS = ONE ? 16 : FBT_RM;
  static constexpr int WGQ = ONE ? 1 : 2;
  static constexpr int TILES = WGQ * FBT_RM / RS;
};

// NI: 16-bit terms of each of q, k, v and g, 1 (bfloat16) or 2 (float32: fp16);
// every tile below holds one term, the NI terms of an operand side by side.
template <int DHP, int NI = 1>
struct FbtQShape {
  using Geo = FbtGeo<DHP, NI>;
  static constexpr int BK = Geo::ONE ? 16 : DHP * NI > 128 ? 32 : 64;  // keys a stage
  static constexpr int SLOTS = Geo::WGQ * FBT_RM;      // row slots a block
  static constexpr int THREADS = 128 * (Geo::WGQ + 1);
  static constexpr int ROW_BYTES = SLOTS * DHP * 2;    // the q or g tile
  static constexpr int KV_BYTES = BK * DHP * 2;        // a k or v stage
  static constexpr int BARS = NI * (2 * ROW_BYTES + FBT_STAGES * 2 * KV_BYTES);
  static constexpr int SMEM = BARS + (1 + 2 * FBT_STAGES) * 8 + 1024;
};

template <int DHP, int NI = 1, bool RP = false>
struct FbtKShape {
  static constexpr int RS = FbtGeo<DHP, NI>::RS;       // row slots a stage
  static constexpr int WG = DHP * NI > 128 ? 2 : 1;    // consumer warpgroups
  static constexpr int THREADS = 128 * (WG + 1);
  static constexpr int KV_BYTES = FBT_BK * DHP * 2;    // the block's k or v
  static constexpr int ROW_BYTES = RS * DHP * 2;       // a stage's q or g rows
  static constexpr int NST = RP ? 4 : 2;               // statistics a row (point 6)
  static constexpr int PT = NI * (2 * KV_BYTES + FBT_STAGES * 2 * ROW_BYTES);
  static constexpr int STATS = PT + (WG - 1) * (RS / 2) * 128 * 4;   // WG 2: P^T
  static constexpr int BARS = STATS + FBT_STAGES * NST * RS * 4;
  static constexpr int SMEM = BARS + (1 + 2 * FBT_STAGES) * 8 + 16 + 1024;
};

// The A operands of the KS k-steps of a 64 x 16 KS fp32 accumulator
// fragment x (the keys, or rows, of k-step kk are 16 kk .. 16 kk + 15):
// term t is the bf16 rounding of what terms 0 .. t-1 left of x.
template <int NT, int KS>
__device__ __forceinline__ void fbt_terms(uint32_t (&a)[NT][KS][4],
                                          const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
        a[t][kk][r] = *reinterpret_cast<const uint32_t*>(&b);
        x0 -= __low2float(b);
        x1 -= __high2float(b);
      }
    }
}

// The float32 route's scales: the power 2^s that brings a largest
// magnitude m into [2^13, 2^14) (s at most 126, so that 2^-s is normal),
// and 2^s itself.
__device__ __forceinline__ int fbt_pow2(float m) {
  return min(13 - ((int)((__float_as_uint(m) >> 23) & 0xff) - 127), 126);
}
__device__ __forceinline__ float fbt_exp2i(int s) {
  return __uint_as_float((unsigned)(s + 127) << 23);
}

// fbt_terms on the float32 route: each row of the fragment x times 2^s of
// its largest magnitude (over the quad that holds the row), in NT fp16
// terms; inv[h] = 2^-s of row half h.
template <int NT, int KS>
__device__ __forceinline__ void fbt_terms16(uint32_t (&a)[NT][KS][4],
                                            const float (&x)[8 * KS],
                                            float (&inv)[2]) {
  float m[2] = {0.0f, 0.0f}, c[2];
#pragma unroll
  for (int i = 0; i < 8 * KS; ++i) m[(i / 2) % 2] = fmaxf(m[(i / 2) % 2], fabsf(x[i]));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    const int e = fbt_pow2(m[h]);
    c[h] = fbt_exp2i(e);
    inv[h] = fbt_exp2i(-e);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float x0 = x[8 * kk + 2 * r] * c[r % 2], x1 = x[8 * kk + 2 * r + 1] * c[r % 2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const __half2 b = __floats2half2_rn(x0, x1);
        a[t][kk][r] = *reinterpret_cast<const uint32_t*>(&b);
        x0 -= __low2float(b);
        x1 -= __high2float(b);
      }
    }
}

// d (64 x N) += sum over the terms of a (64 x 16 KS) . B, B a tile of 16 KS
// rows read MN-major (its rows are the contraction index; the next 64 of
// its N columns `lbo` bytes on).  With NI terms of B (`bt` bytes apart), the
// pairs (a's t, B's j) with t + j < max(NT, NI): NI 1, every term of a;
// NT = NI = 2, hi.hi, hi.mid and mid.hi.
template <int N, int NT, int KS, int NI>
__device__ __forceinline__ void fbt_rs_terms(float (&d)[N / 2],
                                             const uint32_t (&a)[NT][KS][4],
                                             const uint8_t* tile, int lbo,
                                             int bt) {
  constexpr int ORDER = NT > NI ? NT : NI;
  const uint64_t d0 = hp_desc(tile, lbo, 1024);
  hp_fence_regs(d);
  hp_wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const uint64_t db = NI == 2 ? d0 + ((j * bt + kk * 2048) >> 4)   // as fbt_ss's
                                  : hp_desc(tile + j * bt + kk * 2048, lbo, 1024);
#pragma unroll
      for (int t = 0; t + j < ORDER && t < NT; ++t)
        hp_wgmma_rs<N, 1, NI == 2>(d, a[t][kk], db, 1);
    }
  }
  hp_wgmma_commit();
  hp_wgmma_wait<0>();
  hp_fence_regs(d);
}

// fbt_rs_terms into d.  At NI 2 (float32) the products go to a fresh
// accumulator, added to d by rounded fp32 adds, row half h times f[h] (the
// inverse scales of a's row and of B): the tensor cores' own fp32
// accumulation, carried over a walk of hundreds of row tiles, drifted dk
// and dv to 1.7-1.9x the float32 limit (internvl2's heads at S 4,096, one
// piece a key tile), where the same products summed with rounding stay
// under a tenth of it.
// At N 256 (float32, DHP 256) the fresh accumulator covers 64 columns at a
// time (the next 64 of B `lbo` bytes on): a second 128 registers beside d's
// spilled more.  Each column's products run in the same order either way.
template <int N, int NT, int KS, int NI = 1>
__device__ __forceinline__ void fbt_accum(float (&d)[N / 2],
                                          const uint32_t (&a)[NT][KS][4],
                                          const uint8_t* tile, int lbo,
                                          int bt = 0, float f0 = 1.0f,
                                          float f1 = 1.0f) {
  if constexpr (NI == 1) {
    fbt_rs_terms<N, NT, KS, NI>(d, a, tile, lbo, bt);
  } else {
    constexpr int NC = N > 128 ? 64 : N;            // columns a fresh accumulator
#pragma unroll
    for (int c = 0; c < N / NC; ++c) {
      float x[NC / 2];
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) x[i] = 0.0f;
      fbt_rs_terms<NC, NT, KS, NI>(x, a, tile + c * (NC / 64) * lbo, lbo, bt);
#pragma unroll
      for (int i = 0; i < NC / 2; ++i)
        d[c * NC / 2 + i] += x[i] * ((i / 2) % 2 ? f1 : f0);
    }
  }
}

// Issue x (64 x N) += A . B^T over DHP: A 64 rows at a (chunks of 64
// columns `ap` bytes apart), B N rows at b (chunks `bp` apart), K-major.
// On the float32 route (F16) every descriptor is its tile's first plus
// the byte offset / 16 (the start address field, shared memory below 256
// KB): one add a k-step, where building each whole took registers the DHP
// 256 instances lack (ptxas spilled more).
template <int DHP, int N, bool F16 = false>
__device__ __forceinline__ void fbt_ss(float (&x)[N / 2], const uint8_t* a,
                                       const uint8_t* b, int ap, int bp) {
  const uint64_t da = hp_desc(a, 16, 1024), db = hp_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    const int o = (kk / 4), kin = (kk % 4) * 32;
    if constexpr (F16)
      hp_wgmma_ss<N, 0, F16>(x, da + ((o * ap + kin) >> 4), db + ((o * bp + kin) >> 4), 1);
    else
      hp_wgmma_ss<N, 0, F16>(x, hp_desc(a + o * ap + kin, 16, 1024),
                        hp_desc(b + o * bp + kin, 16, 1024), 1);
  }
}

// x += A . B^T over NI terms of each (A's `at` bytes apart, B's `bt`): the
// pairs (i, j) with i + j < NI, so at NI 2 hi.hi, hi.mid and mid.hi (the
// mid.mid product is below the terms' own 2^-16).
template <int DHP, int N, int NI>
__device__ __forceinline__ void fbt_ss_terms(float (&x)[N / 2], const uint8_t* a,
                                             const uint8_t* b, int ap, int bp,
                                             int at, int bt) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; i + j < NI; ++j)
      fbt_ss<DHP, N, NI == 2>(x, a + i * at, b + j * bt, ap, bp);
}

// The float32 route's scores, A . B^T over the terms' pairs hi.hi, hi.mid
// and mid.hi, as three accumulators: hi.hi of the even k-steps into h0, of
// the odd ones into h1, the two cross pairs (2^-11 of it) into x; summed
// after, h0 + h1 + x (point 2).
template <int DHP, int N>
__device__ __forceinline__ void fbt_ss_scores(float (&x)[N / 2], float (&h0)[N / 2],
                                              float (&h1)[N / 2], const uint8_t* a,
                                              const uint8_t* b, int ap, int bp,
                                              int at, int bt) {
  const uint64_t da = hp_desc(a, 16, 1024), db = hp_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {       // as fbt_ss's descriptors
    const int o = (kk / 4), kin = (kk % 4) * 32;
    const uint64_t dak = da + ((o * ap + kin) >> 4), dbk = db + ((o * bp + kin) >> 4);
    if (kk % 2) hp_wgmma_ss<N, 0, true>(h1, dak, dbk, 1);
    else hp_wgmma_ss<N, 0, true>(h0, dak, dbk, 1);
  }
  fbt_ss<DHP, N, true>(x, a, b + bt, ap, bp);
  fbt_ss<DHP, N, true>(x, a + at, b, ap, bp);
}

// x = A . B^T (64 x N over DHP, as fbt_ss lays it out), and with PAIR y =
// C . D^T alike, over NI terms as fbt_ss_terms; at NI 2 times fx and fy
// (the inverse scales of the operands' terms), x as scores (SCORES:
// fbt_ss_scores).
template <int DHP, int N, int NI, bool SCORES, bool PAIR>
__device__ __forceinline__ void fbt_prod(float (&x)[N / 2], float (&y)[N / 2],
                                         const uint8_t* a, const uint8_t* b,
                                         const uint8_t* c, const uint8_t* d,
                                         int ap, int bp, int at, int bt,
                                         float fx, float fy) {
  constexpr bool SPLIT = NI == 2 && SCORES;
  float h0[SPLIT ? N / 2 : 1], h1[SPLIT ? N / 2 : 1];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = 0.0f;
  hp_fence_regs(x);
  if constexpr (PAIR) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) y[i] = 0.0f;
    hp_fence_regs(y);
  }
  if constexpr (SPLIT) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h0[i] = h1[i] = 0.0f;
    hp_fence_regs(h0);
    hp_fence_regs(h1);
  }
  hp_wgmma_fence();
  if constexpr (SPLIT) fbt_ss_scores<DHP, N>(x, h0, h1, a, b, ap, bp, at, bt);
  else fbt_ss_terms<DHP, N, NI>(x, a, b, ap, bp, at, bt);
  if constexpr (PAIR) fbt_ss_terms<DHP, N, NI>(y, c, d, ap, bp, at, bt);
  hp_wgmma_commit();
  hp_wgmma_wait<0>();
  hp_fence_regs(x);
  if constexpr (PAIR) hp_fence_regs(y);
  if constexpr (SPLIT) {
    hp_fence_regs(h0);
    hp_fence_regs(h1);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) x[i] += h0[i] + h1[i];
  }
  if constexpr (NI == 2) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      x[i] *= fx;
      if constexpr (PAIR) y[i] *= fy;
    }
  }
}

// S = q.k^T (or S^T = K.q^T) and dP = g.v^T (dP^T = V.g^T), 64 x N each.
template <int DHP, int N, int NI = 1>
__device__ __forceinline__ void fbt_pair(float (&x)[N / 2], float (&y)[N / 2],
                                         const uint8_t* a, const uint8_t* b,
                                         const uint8_t* c, const uint8_t* d,
                                         int ap, int bp, int at = 0, int bt = 0,
                                         float fx = 1.0f, float fy = 1.0f) {
  fbt_prod<DHP, N, NI, true, true>(x, y, a, b, c, d, ap, bp, at, bt, fx, fy);
}

// x = A . B^T alone (64 x N), scores (S, S^T) or not (dP^T).
template <int DHP, int N, int NI, bool SCORES>
__device__ __forceinline__ void fbt_one(float (&x)[N / 2], const uint8_t* a,
                                        const uint8_t* b, int ap, int bp,
                                        int at = 0, int bt = 0, float fx = 1.0f) {
  float y[N / 2];
  fbt_prod<DHP, N, NI, SCORES, false>(x, y, a, b, nullptr, nullptr, ap, bp, at,
                                      bt, fx, 1.0f);
}

// Two adjacent outputs at element `at` of out: bfloat16 on the bf16 route
// (NI 1), float32 on the float32 one (NI 2).
template <int NI>
__device__ __forceinline__ void fbt_out2(void* out, long long at, float x0,
                                         float x1) {
  if constexpr (NI == 1)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) =
        __floats2bfloat162_rn(x0, x1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(x0, x1);
}

// The float32 route's inverse scales of q.k, g.v, q, g and k: 2^-s of
// each input's largest magnitude (fbt_pow2), as fbs_split_kernel scaled
// their terms; all 1 at NI 1.
struct FbtInv {
  float qk = 1.0f, gv = 1.0f, q = 1.0f, g = 1.0f, k = 1.0f;
};
template <int NI>
__device__ __forceinline__ FbtInv fbt_inv(const FbtArgs& a) {
  FbtInv f;
  if constexpr (NI == 2) {
    f.q = fbt_exp2i(-fbt_pow2(__uint_as_float(a.amax[0])));
    f.g = fbt_exp2i(-fbt_pow2(__uint_as_float(a.amax[1])));
    f.k = fbt_exp2i(-fbt_pow2(__uint_as_float(a.amax[2])));
    f.qk = f.q * f.k;
    f.gv = f.g * fbt_exp2i(-fbt_pow2(__uint_as_float(a.amax[3])));
  }
  return f;
}

// Named barrier `id` over the first `n` threads (the consumer warpgroups).
template <int ID, int N>
__device__ __forceinline__ void fbt_bar() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(ID), "n"(N) : "memory");
}

template <int DHP, int NT, int NI, bool RP>
__global__ void __launch_bounds__(FbtQShape<DHP, NI>::THREADS, 1)
fbt_dq_kernel(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mg,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, FbtArgs a) {
  using S = FbtQShape<DHP, NI>;
  using Geo = FbtGeo<DHP, NI>;
  constexpr int BK = S::BK, NSC = BK / 2, KS = BK / 16, RS = Geo::RS;
  constexpr int NO = DHP / 2;                       // dq fragment registers
  constexpr int TPW = FBT_RM / RS;                  // row tiles a warpgroup
  constexpr int NPASS = RP ? 3 : 2;                 // passes over the keys
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hp_smem(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Gs = smem + NI * S::ROW_BYTES;          // term t at t * ROW_BYTES
  uint8_t* KVs = Gs + NI * S::ROW_BYTES;            // stage s: K's terms, then V's
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + FBT_STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int G = a.G, nrows = a.Sq * G, nbkv = a.B * a.KV, RT = a.rt;
  const int nblk = ((nrows + RT - 1) / RT + Geo::TILES - 1) / Geo::TILES;  // a head
  const int bkv = blockIdx.x % nbkv, rank = blockIdx.x / nbkv;   // heaviest first
  const int blk = nblk - 1 - rank;
  const int r0 = blk * Geo::TILES * RT;             // the block's first row
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int last_row = min(r0 + Geo::TILES * RT, nrows) - 1;
  const int kend = a.causal ? min(a.Sk, last_row / G + 1) : a.Sk;
  const int nt = (kend + BK - 1) / BK;
  // the first key tile inside the window of the block's first row
  const int j0 = a.window > 0 ? max(0, r0 / G - a.window + 1) / BK : 0;
  const int nj = max(0, nt - j0);                   // key tiles a pass
  if (tid == 0) {
    hp_bar_init(q_full, 1);
    for (int s = 0; s < FBT_STAGES; ++s) {
      hp_bar_init(&full[s], 1);
      hp_bar_init(&empty[s], 4 * Geo::WGQ);   // one arrival per consumer warp
    }
    hp_bar_init_fence();
  }
  __syncthreads();

  // setmaxnreg moves registers to two consumer warpgroups; with one, the
  // 256 threads' 255 each fit the register file as they are
  if (wg == Geo::WGQ) {
    // ----------------------------------------------------- producer
    if constexpr (Geo::WGQ > 1) hp_regs_dec<40>();
    if (tid != 128 * Geo::WGQ) return;
    // term t of batch b is batch b + t B of the maps (float32: the terms'
    // copy; bfloat16: t = 0, the inputs themselves)
    hp_bar_expect_tx(q_full, 2 * NI * (DHP / 64) * Geo::TILES * RT * 128);
#pragma unroll
    for (int t = 0; t < NI; ++t)
#pragma unroll
      for (int h = 0; h < Geo::TILES; ++h) {   // row tile h into slots RS h ..
        const int rr = r0 + h * RT;
#pragma unroll
        for (int c = 0; c < DHP / 64; ++c) {
          const int at = t * S::ROW_BYTES + c * S::SLOTS * 128 + h * RS * 128;
          hp_tma_4d(Qs + at, &mq, q_full, c * 64, kvh * G - a.off + rr % G, rr / G,
                    b + t * a.B);
          hp_tma_4d(Gs + at, &mg, q_full, c * 64, kvh * G - a.off + rr % G, rr / G,
                    b + t * a.B);
        }
      }
    // the key tiles, once a pass; RP's first pass (m and l) takes k alone
    for (int n = 0; n < NPASS * nj; ++n) {
      const int j = j0 + n % nj, s = n % FBT_STAGES;
      const bool with_v = !RP || n >= nj;
      if (n >= FBT_STAGES) hp_bar_wait(&empty[s], ((n / FBT_STAGES) - 1) & 1);
      uint8_t* Kt = KVs + s * 2 * NI * S::KV_BYTES;
      uint8_t* Vt = Kt + NI * S::KV_BYTES;
      hp_bar_expect_tx(&full[s], (with_v ? 2 : 1) * NI * S::KV_BYTES);
#pragma unroll
      for (int t = 0; t < NI; ++t)
#pragma unroll
        for (int c = 0; c < DHP / 64; ++c) {
          const int at = t * S::KV_BYTES + c * BK * 128;
          hp_tma_4d(Kt + at, &mk, &full[s], c * 64, kvh, j * BK, b + t * a.B);
          if (with_v)
            hp_tma_4d(Vt + at, &mv, &full[s], c * 64, kvh, j * BK, b + t * a.B);
        }
    }
    return;
  }
  // ------------------------------------------------------ consumers
  if constexpr (Geo::WGQ > 1) hp_regs_inc<232>();
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int sl = warp * 16 + lane / 4;              // slots sl and sl + 8
  const int rw = r0 + wg * TPW * RT;                // the warpgroup's first row
  // slot s of the warpgroup: slot s % RS of its row tile s / RS
  const int row[2] = {rw + (sl / RS) * RT + sl % RS,
                      rw + ((sl + 8) / RS) * RT + (sl + 8) % RS};
  const bool filled[2] = {sl % RS < RT, (sl + 8) % RS < RT};
  const int tok[2] = {row[0] / G, row[1] / G};
  const int tok_lo = rw / G;                        // the warpgroup's first
  const int tok_hi = (rw + TPW * RT - 1) / G;       // and last token
  const float sl2 = a.scale * FBT_LOG2E;
  const uint8_t* Qw = Qs + wg * FBT_RM * 128;
  const uint8_t* Gw = Gs + wg * FBT_RM * 128;
  const FbtInv f = fbt_inv<NI>(a);
  const long long plane = (long long)nbkv * a.rows_pad;
  // a tile that crosses the diagonal, the end of the keys or the window's
  // lower edge, and the keys it hides from row half h
  auto edge_of = [&](int j) {
    return (j + 1) * BK > a.Sk || (a.causal && (j + 1) * BK - 1 > tok_lo) ||
           (a.window > 0 && j * BK <= tok_hi - a.window);
  };
  auto hidden = [&](int j, int i) {
    const int h = (i / 2) % 2;
    const int key = j * BK + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
    return key >= a.Sk || (a.causal && key > tok[h]) ||
           (a.window > 0 && key <= tok[h] - a.window);
  };
  // the ring's stage n (passes in order), S = q.k^T and with V dP = g.v^T
  auto stage = [&](int n, float (&sc)[NSC], float (&dp)[NSC], bool with_v) {
    const int s = n % FBT_STAGES;
    hp_bar_wait(&full[s], (n / FBT_STAGES) & 1);
    const uint8_t* Kt = KVs + s * 2 * NI * S::KV_BYTES;
    if (with_v)
      fbt_pair<DHP, BK, NI>(sc, dp, Qw, Kt, Gw, Kt + NI * S::KV_BYTES,
                            S::SLOTS * 128, BK * 128, S::ROW_BYTES, S::KV_BYTES,
                            f.qk, f.gv);
    else
      fbt_one<DHP, BK, NI, true>(sc, Qw, Kt, S::SLOTS * 128, BK * 128,
                                 S::ROW_BYTES, S::KV_BYTES, f.qk);
    return Kt;
  };
  // statistic k of row half h, by slot
  auto put = [&](int k, int h, float x) {
    a.stats[k * plane + (long long)bkv * a.rows_pad + blk * S::SLOTS +
            wg * FBT_RM + sl + 8 * h] = x;
  };
  hp_bar_wait(q_full, 0);

  // pass 1: the rows' max m and l = sum exp(s - m), online in base 2 (and
  // with p in fp32, sum exp(s - m) dp for D)
  float mr[2] = {ATT_NEG, ATT_NEG}, m2[2] = {ATT_NEG, ATT_NEG};
  float l[2] = {0.0f, 0.0f}, pd[2] = {0.0f, 0.0f};
  for (int n = 0; n < nj; ++n) {
    const int j = j0 + n;
    float sc[NSC], dp[NSC];
    stage(n, sc, dp, !RP);
    if (lane == 0) hp_bar_arrive(&empty[n % FBT_STAGES]);   // the stage is read
    const bool edge = edge_of(j);
    if (edge) {
#pragma unroll
      for (int i = 0; i < NSC; ++i)
        if (hidden(j, i)) sc[i] = ATT_NEG;
    }
    float mx[2] = {ATT_NEG, ATT_NEG};
#pragma unroll
    for (int i = 0; i < NSC; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2], rs[2] = {0.0f, 0.0f}, rd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mr[h] = fmaxf(mr[h], mx[h]);
      const float m_new = fmaxf(m2[h], mx[h] * sl2);
      alpha[h] = exp2f(m2[h] - m_new);
      m2[h] = m_new;
    }
    // a hidden score gives p = 0 exactly (see fa_tc_kernel)
#pragma unroll
    for (int i = 0; i < NSC; ++i) {
      const int h = (i / 2) % 2;
      float e = exp2f(fmaf(sc[i], sl2, -m2[h]));
      e = (edge && sc[i] == ATT_NEG) ? 0.0f : e;
      rs[h] += e;
      if constexpr (!RP) rd[h] = fmaf(e, dp[i], rd[h]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * alpha[h] + rs[h];
      if constexpr (!RP) {
        rd[h] += __shfl_xor_sync(0xffffffffu, rd[h], 1);
        rd[h] += __shfl_xor_sync(0xffffffffu, rd[h], 2);
        pd[h] = pd[h] * alpha[h] + rd[h];
      }
    }
  }
  // a row that sees no key (none of the model's), the rows past the last
  // token and the empty slots get p = 0 everywhere
  bool live[2];
  float lse2[2], D[2], share[2] = {0.0f, 0.0f}, il[2];   // RP: il = 1 / l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool real = filled[h] && row[h] < nrows;
    live[h] = real && l[h] > 0.0f;
    lse2[h] = live[h] ? m2[h] + log2f(l[h]) : FB_INF;
    D[h] = live[h] && !RP ? pd[h] / l[h] : 0.0f;
    const int hd = kvh * G - a.off + row[h] % G;  // the row's head
    if (lane % 4 == 0 && real && hd >= 0 && hd < a.H)
      a.lse[((long long)b * a.H + hd) * a.Sq + row[h] / G] = lse2[h] * FBT_LN2;
  }
  if constexpr (RP) {
    // pass 2 (point 6): with x = (g . v_j) / l, D = sum r(p) x, the argmax
    // share's D - sum p r(x) from each key's rounding residuals and the
    // ties at m
    float e[2] = {0.0f, 0.0f}, ties[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m2[h] = mr[h] * sl2;                           // as the dkdv kernels form it
      if (!live[h]) l[h] = 1.0f;
      il[h] = 1.0f / l[h];
    }
    for (int n = nj; n < 2 * nj; ++n) {
      const int j = j0 + n - nj;
      float sc[NSC], dp[NSC];
      stage(n, sc, dp, true);
      if (lane == 0) hp_bar_arrive(&empty[n % FBT_STAGES]);
      const bool edge = edge_of(j);
#pragma unroll
      for (int i = 0; i < NSC; ++i) {
        const int h = (i / 2) % 2;
        if (edge && hidden(j, i)) continue;
        const float p = exp2f(fmaf(sc[i], sl2, -m2[h]));
        const float rp = att_round<__nv_bfloat16>(p);
        const float x = dp[i] * il[h], rx = att_round<__nv_bfloat16>(x);
        D[h] = fmaf(rp, x, D[h]);
        e[h] = fmaf(rp - p, x, fmaf(p, x - rx, e[h]));
        ties[h] += sc[i] == mr[h] ? 1.0f : 0.0f;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o *= 2) {
        D[h] += __shfl_xor_sync(0xffffffffu, D[h], o);
        e[h] += __shfl_xor_sync(0xffffffffu, e[h], o);
        ties[h] += __shfl_xor_sync(0xffffffffu, ties[h], o);
      }
      share[h] = live[h] && ties[h] > 0.0f ? e[h] / ties[h] : 0.0f;
      D[h] = live[h] ? D[h] / l[h] : 0.0f;          // D / l from here on
      if (lane % 4 == 0) {
        put(0, h, live[h] ? mr[h] : FB_INF);
        put(1, h, l[h]);
        put(2, h, D[h]);
        put(3, h, share[h]);
      }
    }
  } else if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      put(0, h, lse2[h]);
      put(1, h, D[h]);
    }
  }

  // the last pass: dQ += dS . K
  float dqa[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.0f;
  for (int n = (NPASS - 1) * nj; n < NPASS * nj; ++n) {
    const int j = j0 + n % nj;
    float sc[NSC], dp[NSC];
    const uint8_t* Kt = stage(n, sc, dp, true);
    const bool edge = edge_of(j);
#pragma unroll
    for (int i = 0; i < NSC; ++i) {
      const int h = (i / 2) % 2;
      float d;
      if constexpr (RP) {
        const float p = exp2f(fmaf(sc[i], sl2, -m2[h]));
        d = p * (att_round<__nv_bfloat16>(dp[i] * il[h]) - D[h]);
        if (sc[i] == mr[h]) d += share[h];
      } else {
        d = exp2f(fmaf(sc[i], sl2, -lse2[h])) * (dp[i] - D[h]);
      }
      sc[i] = (edge && hidden(j, i)) ? 0.0f : d;
    }
    uint32_t ds[NT][KS][4];
    if constexpr (NI == 2) {
      float inv[2];
      fbt_terms16<NT, KS>(ds, sc, inv);
      fbt_accum<DHP, NT, KS, NI>(dqa, ds, Kt, BK * 128, S::KV_BYTES,
                                 inv[0] * f.k, inv[1] * f.k);
    } else {
      fbt_terms<NT, KS>(ds, sc);
      fbt_accum<DHP, NT, KS, NI>(dqa, ds, Kt, BK * 128, S::KV_BYTES);
    }
    if (lane == 0) hp_bar_arrive(&empty[n % FBT_STAGES]);
  }

  // ------------------------------------------------------ epilogue
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row[h] / G, hd = kvh * G - a.off + row[h] % G;
    if (!filled[h] || row[h] >= nrows || hd < 0 || hd >= a.H) continue;
    const long long at = (((long long)b * a.Sq + t) * a.H + hd) * a.dh;
#pragma unroll
    for (int n8 = 0; n8 < DHP / 8; ++n8) {
      const int col = 8 * n8 + 2 * (lane % 4);
      if (col < a.dh)
        fbt_out2<NI>(a.dq, at + col, dqa[4 * n8 + 2 * h] * a.scale,
                     dqa[4 * n8 + 2 * h + 1] * a.scale);
    }
  }
}

// Row tiles [lo, hi) that can see a key of key tile kt (causal: tokens
// from its first key on; window: tokens before its last key + window), as
// plan_flash_bwd states them.
__device__ __forceinline__ int2 fbt_row_tiles(const FbtArgs& a, int kt) {
  const int G = a.G, nrows = a.Sq * G;
  const int k0 = kt * FBT_BK, nk = min(FBT_BK, a.Sk - k0);
  const long long lo = a.causal ? min((long long)nrows, (long long)k0 * G) : 0;
  const long long hi = a.window > 0
      ? min((long long)nrows, (long long)(k0 + nk - 1 + a.window) * G) : nrows;
  return make_int2((int)(lo / a.rt), (int)((hi + a.rt - 1) / a.rt));
}

// The dkdv kernels' start: the barriers, and the empty slots of every
// stage's q and g chunks (TMA never writes them) zeroed, so that they add
// nothing to S^T, dP^T, dV or dK.  Every thread of the block calls it.
template <int DHP, int NI>
__device__ __forceinline__ void fbt_kv_init(uint8_t* Rs, uint64_t* kv_full,
                                            uint64_t* full, uint64_t* empty,
                                            int rt, int tid) {
  using S = FbtKShape<DHP, NI>;
  if (tid == 0) {
    hp_bar_init(kv_full, 1);
    for (int s = 0; s < FBT_STAGES; ++s) {
      hp_bar_init(&full[s], 1);
      hp_bar_init(&empty[s], 4 * S::WG);  // one arrival per consumer warp
    }
    hp_bar_init_fence();
  }
  if (rt < S::RS) {
    const int dead = S::RS - rt, n16 = FBT_STAGES * 2 * NI * (DHP / 64) * dead * 8;
    for (int i = tid; i < n16; i += S::THREADS) {
      const int u = i % 8, r = (i / 8) % dead, c = i / (8 * dead);
      *reinterpret_cast<uint4*>(Rs + c * S::RS * 128 + (rt + r) * 128 + u * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    hp_fence_async_smem();
  }
  __syncthreads();
}

// The dkdv kernels' producer (one thread): k and v of the block once, then
// row tiles p_lo .. p_hi - 1 of q and g through the ring, each with its
// slots' statistics (lse and D; RP: m, l, D / l and the share); each
// tile's NI terms (batch b + t B of the maps).
template <int DHP, int NI, bool RP>
__device__ __forceinline__ void fbt_kv_load(
    const FbtArgs& a, const CUtensorMap* mq, const CUtensorMap* mg,
    const CUtensorMap* mk, const CUtensorMap* mv, uint8_t* Ks, uint8_t* Vs,
    uint8_t* Rs, float* stat, uint64_t* kv_full, uint64_t* full,
    uint64_t* empty, int bkv, int k0, int p_lo, int p_hi) {
  using S = FbtKShape<DHP, NI, RP>;
  const int G = a.G, nbkv = a.B * a.KV, b = bkv / a.KV, kvh = bkv % a.KV;
  hp_bar_expect_tx(kv_full, 2 * NI * S::KV_BYTES);
#pragma unroll
  for (int t = 0; t < NI; ++t)
#pragma unroll
    for (int c = 0; c < DHP / 64; ++c) {
      const int at = t * S::KV_BYTES + c * FBT_BK * 128;
      hp_tma_4d(Ks + at, mk, kv_full, c * 64, kvh, k0, b + t * a.B);
      hp_tma_4d(Vs + at, mv, kv_full, c * 64, kvh, k0, b + t * a.B);
    }
  const float* st = a.stats + (long long)bkv * a.rows_pad;
  for (int r = p_lo; r < p_hi; ++r) {
    const int n = r - p_lo, s = n % FBT_STAGES, r0 = r * a.rt;
    if (n >= FBT_STAGES) hp_bar_wait(&empty[s], ((n / FBT_STAGES) - 1) & 1);
    uint8_t* Qt = Rs + s * 2 * NI * S::ROW_BYTES;
    uint8_t* Gt = Qt + NI * S::ROW_BYTES;
    hp_bar_expect_tx(&full[s], 2 * NI * (DHP / 64) * a.rt * 128 + S::NST * S::RS * 4);
#pragma unroll
    for (int t = 0; t < NI; ++t)
#pragma unroll
      for (int c = 0; c < DHP / 64; ++c) {
        const int at = t * S::ROW_BYTES + c * S::RS * 128;
        hp_tma_4d(Qt + at, mq, &full[s], c * 64, kvh * G - a.off + r0 % G, r0 / G,
                  b + t * a.B);
        hp_tma_4d(Gt + at, mg, &full[s], c * 64, kvh * G - a.off + r0 % G, r0 / G,
                  b + t * a.B);
      }
#pragma unroll
    for (int k = 0; k < S::NST; ++k)
      hp_bulk_load(stat + (s * S::NST + k) * S::RS,
                   st + k * (long long)nbkv * a.rows_pad + r * S::RS, S::RS * 4,
                   &full[s]);
  }
}

// DHP 64 and 128 (float32: 64): one consumer warpgroup holds dK and dV; two
// blocks an SM.
template <int DHP, int NT, int NI, bool RP>
__global__ void __launch_bounds__(256, 2)
fbt_dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mg,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, FbtArgs a) {
  using S = FbtKShape<DHP, NI, RP>;
  static_assert(S::WG == 1 && S::RS == FBT_RM, "fbt_dkdv_kernel: DHP * NI up to 128");
  constexpr int NO = DHP / 2;                       // dk, dv fragment registers
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hp_smem(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = smem;                               // term t at t * KV_BYTES
  uint8_t* Vs = smem + NI * S::KV_BYTES;
  uint8_t* Rs = Vs + NI * S::KV_BYTES;              // stage s: q's terms, then g's
  float* stat = reinterpret_cast<float*>(smem + S::STATS);   // stage s: NST planes
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + FBT_STAGES;
  int* last = reinterpret_cast<int*>(empty + FBT_STAGES);

  const int tid = threadIdx.x;
  const int G = a.G, nrows = a.Sq * G, nbkv = a.B * a.KV, RT = a.rt;
  const int piece = blockIdx.x % a.pieces, tile = blockIdx.x / a.pieces;
  const int bkv = tile % nbkv, kt = tile / nbkv;    // key tile 0 (causal: the heaviest) first
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int k0 = kt * FBT_BK;
  const int2 rt = fbt_row_tiles(a, kt);
  const int nrt = max(0, rt.y - rt.x);
  const int p_lo = rt.x + (int)((long long)nrt * piece / a.pieces);
  const int p_hi = rt.x + (int)((long long)nrt * (piece + 1) / a.pieces);
  fbt_kv_init<DHP, NI>(Rs, kv_full, full, empty, RT, tid);

  if (tid >= 128) {
    // ----------------------------------------------------- producer
    hp_regs_dec<24>();
    if (tid == 128)
      fbt_kv_load<DHP, NI, RP>(a, &mq, &mg, &mk, &mv, Ks, Vs, Rs, stat, kv_full,
                               full, empty, bkv, k0, p_lo, p_hi);
    return;
  }
  // ------------------------------------------------------- consumer
  hp_regs_inc<232>();
  const int warp = tid / 32, lane = tid % 32;
  const int kl = warp * 16 + lane / 4;              // keys k0 + kl and + 8
  const float sl2 = a.scale * FBT_LOG2E;
  const FbtInv f = fbt_inv<NI>(a);
  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.0f;
  hp_bar_wait(kv_full, 0);
  for (int r = p_lo; r < p_hi; ++r) {
    const int n = r - p_lo, s = n % FBT_STAGES, r0 = r * RT;
    hp_bar_wait(&full[s], (n / FBT_STAGES) & 1);
    const uint8_t* Qt = Rs + s * 2 * NI * S::ROW_BYTES;
    const uint8_t* Gt = Qt + NI * S::ROW_BYTES;
    // lse and D (RP: m, l, D / l and the share) of the stage's slots
    const float* Ls = stat + s * S::NST * FBT_RM;
    const float* Ds = Ls + FBT_RM;
    float sc[32], dp[32];                           // S^T, dP^T: keys x slots
    fbt_pair<DHP, 64, NI>(sc, dp, Ks, Qt, Vs, Gt, FBT_BK * 128, FBT_RM * 128,
                          S::KV_BYTES, S::ROW_BYTES, f.qk, f.gv);
    // the tile crosses the diagonal, the window's lower edge, the end of
    // the keys or of the rows (empty slots need no mask: zero q and g give
    // s = dp = 0, and their lse +inf and D 0 give p = ds = 0)
    const int t_lo = r0 / G, t_hi = (r0 + RT - 1) / G;
    const bool edge = k0 + FBT_BK > a.Sk || r0 + RT > nrows ||
                      (a.causal && k0 + FBT_BK - 1 > t_lo) ||
                      (a.window > 0 && k0 <= t_hi - a.window);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n8 + 2 * (lane % 4) + e;    // slot col: row r0 + col
        const float L = Ls[col], Dr = Ds[col], il = RP ? 1.0f / Dr : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * n8 + 2 * h + e;
          bool hide = false;
          if (edge) {
            const int row = r0 + col, t = row / G, key = k0 + kl + 8 * h;
            hide = col >= RT || row >= nrows || key >= a.Sk ||
                   (a.causal && key > t) || (a.window > 0 && key <= t - a.window);
          }
          if constexpr (RP) {
            // point 6 (L is m, Dr is l, il = 1 / l): P^T's operand r(p) / l,
            // dS^T from r(dP^T / l), D / l and the share where S^T is m
            const float p = hide ? 0.0f : exp2f(fmaf(sc[i], sl2, -L * sl2));
            float d = p * (att_round<__nv_bfloat16>(dp[i] * il) -
                           Ds[FBT_RM + col]);
            if (sc[i] == L) d += Ds[2 * FBT_RM + col];
            dp[i] = hide ? 0.0f : d;
            sc[i] = att_round<__nv_bfloat16>(p) * il;
          } else {
            const float p = hide ? 0.0f : exp2f(fmaf(sc[i], sl2, -L));
            dp[i] = hide ? 0.0f : p * (dp[i] - Dr);
            sc[i] = p;
          }
        }
      }
    if constexpr (NI == 2) {
      float inv[2];
      uint32_t pt[NT][4][4];
      fbt_terms16<NT, 4>(pt, sc, inv);
      fbt_accum<DHP, NT, 4, NI>(dva, pt, Gt, FBT_RM * 128, S::ROW_BYTES,
                                inv[0] * f.g, inv[1] * f.g);
      uint32_t dst[NT][4][4];
      fbt_terms16<NT, 4>(dst, dp, inv);
      fbt_accum<DHP, NT, 4, NI>(dka, dst, Qt, FBT_RM * 128, S::ROW_BYTES,
                                inv[0] * f.q, inv[1] * f.q);
    } else {
      {
        uint32_t pt[NT][4][4];
        fbt_terms<NT, 4>(pt, sc);
        // dV += P^T . g
        fbt_accum<DHP, NT, 4, NI>(dva, pt, Gt, FBT_RM * 128, S::ROW_BYTES);
      }
      {
        uint32_t dst[NT][4][4];
        fbt_terms<NT, 4>(dst, dp);
        // dK += dS^T . q
        fbt_accum<DHP, NT, 4, NI>(dka, dst, Qt, FBT_RM * 128, S::ROW_BYTES);
      }
    }
    if (lane == 0) hp_bar_arrive(&empty[s]);
  }

  // ------------------------------------------------------ epilogue
  if (a.pieces > 1) {
    // this piece's partial sums, [dk | dv][register][thread]; the last piece
    // of the key tile to arrive adds them all in piece order
    const long long per = 2LL * NO * 128;
    float* base = a.part + (long long)tile * a.pieces * per;
    float* mine = base + piece * per;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      mine[i * 128 + tid] = dka[i];
      mine[(NO + i) * 128 + tid] = dva[i];
    }
    __threadfence();
    fbt_bar<1, 128>();
    if (tid == 0) *last = atomicAdd(&a.count[tile], 1) == a.pieces - 1;
    fbt_bar<1, 128>();
    if (!*last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      dka[i] = __ldcg(base + i * 128 + tid);
      dva[i] = __ldcg(base + (NO + i) * 128 + tid);
    }
    for (int p = 1; p < a.pieces; ++p) {
      const float* part = base + p * per;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        dka[i] += __ldcg(part + i * 128 + tid);
        dva[i] += __ldcg(part + (NO + i) * 128 + tid);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kl + 8 * h;
    if (key >= a.Sk) continue;
    const long long at = (((long long)b * a.Sk + key) * a.KV + kvh) * a.dh;
#pragma unroll
    for (int n8 = 0; n8 < DHP / 8; ++n8) {
      const int col = 8 * n8 + 2 * (lane % 4);
      if (col < a.dh) {
        fbt_out2<NI>(a.dk, at + col, dka[4 * n8 + 2 * h] * a.scale,
                     dka[4 * n8 + 2 * h + 1] * a.scale);
        fbt_out2<NI>(a.dv, at + col, dva[4 * n8 + 2 * h], dva[4 * n8 + 2 * h + 1]);
      }
    }
  }
}

// DHP 256 (float32: 128): two consumer warpgroups, one block an SM.
// Warpgroup 0 computes
// S^T and P^T, hands P^T to warpgroup 1 (once it has read the last row
// tile's) and accumulates dV += P^T . g; warpgroup 1 computes dP^T, dS^T =
// P^T (dP^T - D) (a hidden pair's p is 0) and accumulates dK += dS^T . q.
// RP (point 6): P^T crosses with its sign flipped where the score is the
// row's max (p is near 1 there, never 0), so that warpgroup 1 adds the
// argmax share; warpgroup 0's dV takes r(p) / l.
// acc: the warpgroup's dV or dK, all DHP columns.
template <int DHP, int NT, int NI, bool RP>
__global__ void __launch_bounds__(384, 1)
fbt_dkdv2_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mg,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, FbtArgs a) {
  constexpr int NO = DHP / 2;
  using S = FbtKShape<DHP, NI, RP>;
  constexpr int RS = S::RS, NX = RS / 2, KS = RS / 16;   // a stage's slots
  static_assert(S::WG == 2, "fbt_dkdv2_kernel: DHP * NI above 128");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hp_smem(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = smem;                               // term t at t * KV_BYTES
  uint8_t* Vs = smem + NI * S::KV_BYTES;
  uint8_t* Rs = Vs + NI * S::KV_BYTES;              // stage s: q's terms, then g's
  float* Ps = reinterpret_cast<float*>(smem + S::PT);        // P^T, handed over
  float* stat = reinterpret_cast<float*>(smem + S::STATS);   // stage s: NST planes
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + FBT_STAGES;
  int* last = reinterpret_cast<int*>(empty + FBT_STAGES);

  const int tid = threadIdx.x, wg = tid / 128;
  const int G = a.G, nrows = a.Sq * G, nbkv = a.B * a.KV, RT = a.rt;
  const int piece = blockIdx.x % a.pieces, tile = blockIdx.x / a.pieces;
  const int bkv = tile % nbkv, kt = tile / nbkv;
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int k0 = kt * FBT_BK;
  const int2 rt = fbt_row_tiles(a, kt);
  const int nrt = max(0, rt.y - rt.x);
  const int p_lo = rt.x + (int)((long long)nrt * piece / a.pieces);
  const int p_hi = rt.x + (int)((long long)nrt * (piece + 1) / a.pieces);
  fbt_kv_init<DHP, NI>(Rs, kv_full, full, empty, RT, tid);

  if (wg == 2) {
    // ----------------------------------------------------- producer
    hp_regs_dec<24>();
    if (tid == 256)
      fbt_kv_load<DHP, NI, RP>(a, &mq, &mg, &mk, &mv, Ks, Vs, Rs, stat, kv_full,
                               full, empty, bkv, k0, p_lo, p_hi);
    return;
  }
  // ------------------------------------------------------ consumers
  hp_regs_inc<232>();
  const int ct = tid % 128, warp = ct / 32, lane = tid % 32;
  const int kl = warp * 16 + lane / 4;              // keys k0 + kl and + 8
  const float sl2 = a.scale * FBT_LOG2E;
  const FbtInv f = fbt_inv<NI>(a);
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  hp_bar_wait(kv_full, 0);
  for (int r = p_lo; r < p_hi; ++r) {
    const int n = r - p_lo, s = n % FBT_STAGES, r0 = r * RT;
    hp_bar_wait(&full[s], (n / FBT_STAGES) & 1);
    const uint8_t* Qt = Rs + s * 2 * NI * S::ROW_BYTES;
    const uint8_t* Gt = Qt + NI * S::ROW_BYTES;
    // lse and D (RP: m, l, D / l and the share) of the stage's slots
    const float* Ls = stat + s * S::NST * RS;
    const float* Ds = Ls + RS;
    float x[NX];                                    // S^T, or dP^T
    if (wg == 0) {
      fbt_one<DHP, RS, NI, true>(x, Ks, Qt, FBT_BK * 128, RS * 128, S::KV_BYTES,
                                 S::ROW_BYTES, f.qk);
      // as fbt_dkdv_kernel masks
      const int t_lo = r0 / G, t_hi = (r0 + RT - 1) / G;
      const bool edge = k0 + FBT_BK > a.Sk || r0 + RT > nrows ||
                        (a.causal && k0 + FBT_BK - 1 > t_lo) ||
                        (a.window > 0 && k0 <= t_hi - a.window);
#pragma unroll
      for (int n8 = 0; n8 < RS / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n8 + 2 * (lane % 4) + e;    // slot col: row r0 + col
          const float L = Ls[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * n8 + 2 * h + e;
            bool hide = false;
            if (edge) {
              const int row = r0 + col, t = row / G, key = k0 + kl + 8 * h;
              hide = col >= RT || row >= nrows || key >= a.Sk ||
                     (a.causal && key > t) || (a.window > 0 && key <= t - a.window);
            }
            if constexpr (RP) {             // L is m: p, signed at the max
              const float p = hide ? 0.0f : exp2f(fmaf(x[i], sl2, -L * sl2));
              x[i] = !hide && x[i] == L ? -p : p;
            } else {
              x[i] = hide ? 0.0f : exp2f(fmaf(x[i], sl2, -L));
            }
          }
        }
      if (n > 0) fbt_bar<2, 256>();
#pragma unroll
      for (int i = 0; i < NX; ++i) Ps[i * 128 + ct] = x[i];
      fbt_bar<2, 256>();
      if constexpr (RP) {                 // dV's operand r(p) / l
#pragma unroll
        for (int n8 = 0; n8 < RS / 8; ++n8)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float il = 1.0f / Ds[8 * n8 + 2 * (lane % 4) + e];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * n8 + 2 * h + e;
              x[i] = att_round<__nv_bfloat16>(fabsf(x[i])) * il;
            }
          }
      }
      uint32_t pt[NT][KS][4];
      // dV += P^T . g
      if constexpr (NI == 2) {
        float inv[2];
        fbt_terms16<NT, KS>(pt, x, inv);
        fbt_accum<DHP, NT, KS, NI>(acc, pt, Gt, RS * 128, S::ROW_BYTES,
                                   inv[0] * f.g, inv[1] * f.g);
      } else {
        fbt_terms<NT, KS>(pt, x);
        fbt_accum<DHP, NT, KS, NI>(acc, pt, Gt, RS * 128, S::ROW_BYTES);
      }
    } else {
      fbt_one<DHP, RS, NI, false>(x, Vs, Gt, FBT_BK * 128, RS * 128, S::KV_BYTES,
                                  S::ROW_BYTES, f.gv);
      if (n > 0) fbt_bar<2, 256>();
      fbt_bar<2, 256>();
#pragma unroll
      for (int n8 = 0; n8 < RS / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n8 + 2 * (lane % 4) + e;
          const float Dr = Ds[col], il = RP ? 1.0f / Dr : 0.0f;   // RP: Dr is l
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * n8 + 2 * h + e;
            const float p = Ps[i * 128 + ct];
            if constexpr (RP) {
              x[i] = fabsf(p) * (att_round<__nv_bfloat16>(x[i] * il) - Ds[RS + col]) +
                     (p < 0.0f ? Ds[2 * RS + col] : 0.0f);
            } else {
              x[i] = p * (x[i] - Dr);
            }
          }
        }
      uint32_t dst[NT][KS][4];
      // dK += dS^T . q
      if constexpr (NI == 2) {
        float inv[2];
        fbt_terms16<NT, KS>(dst, x, inv);
        fbt_accum<DHP, NT, KS, NI>(acc, dst, Qt, RS * 128, S::ROW_BYTES,
                                   inv[0] * f.q, inv[1] * f.q);
      } else {
        fbt_terms<NT, KS>(dst, x);
        fbt_accum<DHP, NT, KS, NI>(acc, dst, Qt, RS * 128, S::ROW_BYTES);
      }
    }
    if (lane == 0) hp_bar_arrive(&empty[s]);
  }

  // ------------------------------------------------------ epilogue
  if (a.pieces > 1) {
    // as fbt_dkdv_kernel's, [register][consumer thread] of acc
    const long long per = (long long)NO * 256;
    float* base = a.part + (long long)tile * a.pieces * per;
#pragma unroll
    for (int i = 0; i < NO; ++i) base[piece * per + i * 256 + tid] = acc[i];
    __threadfence();
    fbt_bar<1, 256>();
    if (tid == 0) *last = atomicAdd(&a.count[tile], 1) == a.pieces - 1;
    fbt_bar<1, 256>();
    if (!*last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = __ldcg(base + i * 256 + tid);
    for (int p = 1; p < a.pieces; ++p)
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] += __ldcg(base + p * per + i * 256 + tid);
  }
  const float sk = wg == 0 ? 1.0f : a.scale;       // dk = scale * the sum
  void* out = wg == 0 ? a.dv : a.dk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kl + 8 * h;
    if (key >= a.Sk) continue;
    const long long at = (((long long)b * a.Sk + key) * a.KV + kvh) * a.dh;
#pragma unroll
    for (int n8 = 0; n8 < DHP / 8; ++n8) {
      const int col = 8 * n8 + 2 * (lane % 4);
      if (col < a.dh)
        fbt_out2<NI>(out, at + col, acc[4 * n8 + 2 * h] * sk,
                     acc[4 * n8 + 2 * h + 1] * sk);
    }
  }
}

// The bf16 terms of p and ds: 3 keep all 24 bits of the fp32 operands
// (bfloat16 inputs).  On the float32 route every operand, q, k, v and g as
// well as p and ds, enters as FBT_F32_TERMS scaled fp16 terms and each
// product keeps hi.hi, hi.mid and mid.hi (fbt_ss_terms, fbt_accum).
#define FBT_TERMS 3
#define FBT_F32_TERMS 2

// float32 -> its two fp16 terms for the float32 route: with 2^s the power
// that brings the input's largest magnitude into [2^13, 2^14) (fbt_pow2),
// hi = fp16(2^s x) and mid = fp16(2^s x - hi), 22 bits; each of q, g, k
// and v ((B, S, heads, dh) through its element strides; dh, the strides
// and the base on 16 bytes) into a contiguous [2][B][S][heads][dh] block,
// hi first, that the backward's tensor maps read as a batch of 2 B.
// fbs_amax_kernel first finds each input's largest magnitude (an integer
// maximum of the bits, so any order gives the same).  Two passes, bound by
// bytes.
struct FbsPart {
  const float* x;
  __half* t;
  long long sb, ss, sh;
  int S, heads;
};
struct FbsArgs {
  FbsPart p[4];
  int B, dh;
  unsigned* amax;        // [4], zeroed before fbs_amax_kernel
};

// Calls f(x, r, d) on the float4 of part p at (b, s, head) row r, column d.
template <typename F>
__device__ __forceinline__ void fbs_each(const FbsArgs& a, const FbsPart& p, F f) {
  const int d4 = a.dh / 4;
  const long long rows = (long long)a.B * p.S * p.heads, n = rows * d4;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const long long r = i / d4;               // the (b, s, head) row
    const int d = (int)(i - r * d4) * 4, h = (int)(r % p.heads);
    const long long bs = r / p.heads;
    const int s = (int)(bs % p.S), b = (int)(bs / p.S);
    f(*reinterpret_cast<const float4*>(p.x + b * p.sb + s * p.ss + h * p.sh + d),
      r, d);
  }
}

__global__ void __launch_bounds__(256)
fbs_amax_kernel(const __grid_constant__ FbsArgs a) {
  __shared__ float wm[8];
  float m = 0.0f;
  fbs_each(a, a.p[blockIdx.y], [&](const float4& x, long long, int) {
    m = fmaxf(m, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w))));
  });
#pragma unroll
  for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) wm[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < 8; ++w) m = fmaxf(m, wm[w]);
    atomicMax(a.amax + blockIdx.y, __float_as_uint(m));
  }
}

__global__ void __launch_bounds__(256)
fbs_split_kernel(const __grid_constant__ FbsArgs a) {
  const FbsPart& p = a.p[blockIdx.y];
  const long long rows = (long long)a.B * p.S * p.heads;
  const float c = fbt_exp2i(fbt_pow2(__uint_as_float(a.amax[blockIdx.y])));
  fbs_each(a, p, [&](const float4& x4, long long r, int d) {
    const float4 x = make_float4(x4.x * c, x4.y * c, x4.z * c, x4.w * c);
    const __half2 h01 = __floats2half2_rn(x.x, x.y);
    const __half2 h23 = __floats2half2_rn(x.z, x.w);
    const __half2 m01 = __floats2half2_rn(x.x - __low2float(h01),
                                          x.y - __high2float(h01));
    const __half2 m23 = __floats2half2_rn(x.z - __low2float(h23),
                                          x.w - __high2float(h23));
    uint2 hi, mid;
    hi.x = *reinterpret_cast<const uint32_t*>(&h01);
    hi.y = *reinterpret_cast<const uint32_t*>(&h23);
    mid.x = *reinterpret_cast<const uint32_t*>(&m01);
    mid.y = *reinterpret_cast<const uint32_t*>(&m23);
    *reinterpret_cast<uint2*>(p.t + r * a.dh + d) = hi;
    *reinterpret_cast<uint2*>(p.t + (rows + r) * a.dh + d) = mid;
  });
}

// q, g (both kernels' row tiles), k, v (dq stages), k, v (dkdv blocks)
template <int DHP, int NI, bool RP>
static int fbt_run(const FbtArgs& a, const CUtensorMap (&m)[6], cudaStream_t s) {
  using SQ = FbtQShape<DHP, NI>;
  using SK = FbtKShape<DHP, NI, RP>;
  constexpr int NT = NI == 1 ? FBT_TERMS : FBT_F32_TERMS;
  static int granted_q[HP_MAX_DEVICES] = {0}, granted_k[HP_MAX_DEVICES] = {0};
  const void* kv;
  if constexpr (SK::WG == 2) kv = (const void*)fbt_dkdv2_kernel<DHP, NT, NI, RP>;
  else kv = (const void*)fbt_dkdv_kernel<DHP, NT, NI, RP>;
  int e = hp_grant_smem((const void*)fbt_dq_kernel<DHP, NT, NI, RP>, SQ::SMEM,
                        granted_q);
  if (e) return e;
  e = hp_grant_smem(kv, SK::SMEM, granted_k);
  if (e) return e;
  const long long nbkv = (long long)a.B * a.KV;
  const long long ntile = ((long long)a.Sq * a.G + a.rt - 1) / a.rt;
  constexpr int TILES = FbtGeo<DHP, NI>::TILES;
  const long long bq = (ntile + TILES - 1) / TILES * nbkv;
  const long long nkt = ((long long)a.Sk + FBT_BK - 1) / FBT_BK;
  const long long bk = nkt * nbkv * a.pieces;
  if (bq > 0x7fffffffLL || bk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (a.pieces > 1) {
    e = (int)cudaMemsetAsync(a.count, 0, nkt * nbkv * sizeof(int), s);
    if (e) return e;
  }
  fbt_dq_kernel<DHP, NT, NI, RP><<<(unsigned)bq, SQ::THREADS, SQ::SMEM, s>>>(
      m[0], m[1], m[2], m[3], a);
  e = (int)cudaGetLastError();
  if (e) return e;
  if constexpr (SK::WG == 2)
    fbt_dkdv2_kernel<DHP, NT, NI, RP><<<(unsigned)bk, SK::THREADS, SK::SMEM, s>>>(
        m[0], m[1], m[4], m[5], a);
  else
    fbt_dkdv_kernel<DHP, NT, NI, RP><<<(unsigned)bk, SK::THREADS, SK::SMEM, s>>>(
        m[0], m[1], m[4], m[5], a);
  return (int)cudaGetLastError();
}

// p rounded (RP): bfloat16 only (point 6)
template <bool RP>
static int fbt_dispatch(int dhp, int dtype, const FbtArgs& a,
                        const CUtensorMap (&m)[6], cudaStream_t s) {
  if constexpr (!RP) {
    if (dtype == 0)
      return dhp == 64 ? fbt_run<64, 2, false>(a, m, s)
           : dhp == 128 ? fbt_run<128, 2, false>(a, m, s)
           : fbt_run<256, 2, false>(a, m, s);
  }
  return dhp == 64 ? fbt_run<64, 1, RP>(a, m, s)
       : dhp == 128 ? fbt_run<128, 1, RP>(a, m, s) : fbt_run<256, 1, RP>(a, m, s);
}

// Products of a 64-row tile over DHP a kernel issues: fbt_ss_terms keeps
// the term pairs i + j < NI, fbt_rs_terms the (t, j) with t < NT, j < NI
// and t + j < max(NT, NI).
constexpr int fbt_ss_pairs(int ni) { return ni * (ni + 1) / 2; }
constexpr int fbt_rs_pairs(int nt, int ni) {
  int n = 0;
  for (int j = 0; j < ni; ++j)
    for (int t = 0; t < nt && t + j < (nt > ni ? nt : ni); ++t) ++n;
  return n;
}

template <int DHP, int NI, bool RP>
static void fbt_facts(long long* out) {
  constexpr int NT = NI == 1 ? FBT_TERMS : FBT_F32_TERMS;
  out[0] = FbtQShape<DHP, NI>::SMEM;
  out[1] = FbtKShape<DHP, NI, RP>::SMEM;
  // dq: S and dP in each of its two passes (RP: S alone first, then two
  // passes of both), then dQ; dkdv: S^T, dP^T, dV, dK
  out[2] = (RP ? 5 : 4) * fbt_ss_pairs(NI) + fbt_rs_pairs(NT, NI);
  out[3] = 2 * fbt_ss_pairs(NI) + 2 * fbt_rs_pairs(NT, NI);
}

// The tensor-core backward's figures at head width dh, dtype and round_p
// (as fbt_launch's), for the plan and the report to read: out[0] and
// out[1] the shared memory of a dq and of a dkdv block, out[2] and out[3]
// the products the dq and the dkdv kernel issue for each product the
// gradient needs.  Returns cudaErrorInvalidValue for a call the route does
// not take.
extern "C" int fbt_query(int dh, int dtype, int round_p, long long* out) {
  if (dh < 8 || dh % 8 != 0 || dh > 256 || dtype < 0 || dtype > 1 ||
      round_p < 0 || round_p > 1 || (round_p && dtype == 0))
    return (int)cudaErrorInvalidValue;
  const int dhp = dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
  if (round_p && dhp == 64) fbt_facts<64, 1, true>(out);
  else if (round_p && dhp == 128) fbt_facts<128, 1, true>(out);
  else if (round_p) fbt_facts<256, 1, true>(out);
  else if (dtype == 0 && dhp == 64) fbt_facts<64, 2, false>(out);
  else if (dtype == 0 && dhp == 128) fbt_facts<128, 2, false>(out);
  else if (dtype == 0) fbt_facts<256, 2, false>(out);
  else if (dhp == 64) fbt_facts<64, 1, false>(out);
  else if (dhp == 128) fbt_facts<128, 1, false>(out);
  else fbt_facts<256, 1, false>(out);
  return 0;
}

// q (B, Sq, H, dh), k and v (B, Sk, KV, dh), g (B, Sq, H, dh) with element
// strides, every one on 16 bytes, every base 16-byte aligned; dtype 1
// bfloat16 or 0 float32, dh a multiple of 8 up to 256; G up to 64, or 128
// (float32 at dh above 128: up to 16), and off as fa_launch's (the maps of q
// and g hold the H heads: boxes from kvh * G - off read the heads outside
// them as zeros); dq, dk, dv contiguous in that
// dtype; lse (B, H, Sq)
// float32; `scratch` of `scratch_bytes` (16-byte aligned) for the slots'
// statistics, and with pieces > 1 the partial sums and the arrival
// counters, as plan_flash_bwd sizes it; float32: `terms`, 4 (B Sq H dh + B
// Sk KV dh) fp16 elements (16-byte aligned) for the inputs' two terms
// (fbs_split_kernel), then 16 bytes for their largest magnitudes, else
// unused; causal and window as fa_launch's; round_p 1 (bfloat16 only): p
// rounded to bfloat16 in P.V (point 6), else 0.  Launches (float32)
// fbs_amax_kernel and fbs_split_kernel, then fbt_dq_kernel, then fbt_dkdv_kernel
// (fbt_dkdv2_kernel at DHP 256, and at float32 DHP 128 and 256).
// Returns the first error (a refused grant or tensor-map encoding,
// cudaGetLastError()), else 0.
extern "C" int fbt_launch(const void* q, const void* k, const void* v,
                          const void* g, void* dq, void* dk, void* dv,
                          float* lse, void* scratch, long long scratch_bytes,
                          int B, int Sq, int Sk, int H, int KV, int dh, int G,
                          int off, long long qsb, long long qss, long long qsh,
                          long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh,
                          long long gsb, long long gss, long long gsh,
                          float scale, int causal, int window, int pieces,
                          int dtype, int round_p, void* terms, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (Sk < 1 || !fa_groups(H, KV, G, off) || dh < 8 || dh % 8 != 0 || dh > 256 ||
      window < 0 || (window > 0 && !causal) || pieces < 1 || dtype < 0 ||
      dtype > 1 || (dtype == 0 && terms == nullptr) || round_p < 0 || round_p > 1 ||
      (round_p && dtype == 0))
    return (int)cudaErrorInvalidValue;
  const int dhp = dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
  // FbtGeo: float32 at DHP 256 cuts row tiles of 16 slots, four a dq block
  const bool one = dtype == 0 && dhp == 256;
  const int rs = one ? FbtGeo<256, 2>::RS : FBT_RM;
  const int tiles = one ? FbtGeo<256, 2>::TILES : FbtGeo<128, 1>::TILES;
  // a row tile: the whole tokens of rs slots, or at G 128 (64 slots) half a token
  const int rt = G <= rs ? G * (rs / G) : (!one && G == 2 * FBT_RM) ? FBT_RM : 0;
  if (rt == 0) return (int)cudaErrorInvalidValue;
  const long long nbkv = (long long)B * KV, nkt = (Sk + FBT_BK - 1) / FBT_BK;
  const long long ntile = ((long long)Sq * G + rt - 1) / rt;
  const long long rows_pad = (ntile + tiles - 1) / tiles * (tiles * rs);
  const long long stats = (round_p ? 4 : 2) * nbkv * rows_pad * 4;
  const long long parts = pieces > 1 ? nkt * nbkv * pieces * 2LL * FBT_BK * dhp * 4 : 0;
  const long long counts = pieces > 1 ? nkt * nbkv * 4 : 0;
  if (scratch_bytes < stats + parts + counts || rows_pad > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  uint8_t* sp = static_cast<uint8_t*>(scratch);
  FbtArgs a{dq, dk, dv, lse,
            reinterpret_cast<float*>(sp), reinterpret_cast<float*>(sp + stats),
            reinterpret_cast<int*>(sp + stats + parts),
            B, Sq, Sk, H, KV, dh, G, off, (int)rows_pad, pieces, rt, scale,
            causal, window, nullptr};
  cudaStream_t s = (cudaStream_t)stream;
  int e;
  // float32: the maps read the inputs' terms, contiguous, as batches 0..2B-1
  int Bm = B;
  if (dtype == 0) {
    const long long nq = (long long)B * Sq * H * dh, nk = (long long)B * Sk * KV * dh;
    __half* tq = static_cast<__half*>(terms);
    __half* tg = tq + 2 * nq;
    __half* tk = tg + 2 * nq;
    __half* tv = tk + 2 * nk;
    unsigned* amax = reinterpret_cast<unsigned*>(tv + 2 * nk);
    FbsArgs sa{{{(const float*)q, tq, qsb, qss, qsh, Sq, H},
                {(const float*)g, tg, gsb, gss, gsh, Sq, H},
                {(const float*)k, tk, ksb, kss, ksh, Sk, KV},
                {(const float*)v, tv, vsb, vss, vsh, Sk, KV}}, B, dh, amax};
    a.amax = amax;
    const long long most = (nq > nk ? nq : nk) / 4;
    const unsigned gx = (unsigned)(most < 256LL * 1056 ? (most + 255) / 256 : 1056);
    if ((e = (int)cudaMemsetAsync(amax, 0, 4 * sizeof(unsigned), s))) return e;
    fbs_amax_kernel<<<dim3(gx, 4), 256, 0, s>>>(sa);
    if ((e = (int)cudaGetLastError())) return e;
    fbs_split_kernel<<<dim3(gx, 4), 256, 0, s>>>(sa);
    if ((e = (int)cudaGetLastError())) return e;
    q = tq; g = tg; k = tk; v = tv;
    qsb = gsb = (long long)Sq * H * dh; qss = gss = (long long)H * dh; qsh = gsh = dh;
    ksb = vsb = (long long)Sk * KV * dh; kss = vss = (long long)KV * dh; ksh = vsh = dh;
    Bm = 2 * B;
  }
  const int gh = G < rs ? G : rs;                   // a row tile's TMA box
  const int bkq = dtype == 0 ? (dhp == 256 ? FbtQShape<256, 2>::BK
                                : dhp == 128 ? FbtQShape<128, 2>::BK
                                : FbtQShape<64, 2>::BK)
                             : dhp == 256 ? FbtQShape<256>::BK : FbtQShape<128>::BK;
  CUtensorMap m[6];
  if ((e = fa_tc_map(&m[0], q, Bm, Sq, H, dh, qsb, qss, qsh, gh, rs / gh))) return e;
  if ((e = fa_tc_map(&m[1], g, Bm, Sq, H, dh, gsb, gss, gsh, gh, rs / gh))) return e;
  if ((e = fa_tc_map(&m[2], k, Bm, Sk, KV, dh, ksb, kss, ksh, 1, bkq))) return e;
  if ((e = fa_tc_map(&m[3], v, Bm, Sk, KV, dh, vsb, vss, vsh, 1, bkq))) return e;
  if ((e = fa_tc_map(&m[4], k, Bm, Sk, KV, dh, ksb, kss, ksh, 1, FBT_BK))) return e;
  if ((e = fa_tc_map(&m[5], v, Bm, Sk, KV, dh, vsb, vss, vsh, 1, FBT_BK))) return e;
  return round_p ? fbt_dispatch<true>(dhp, dtype, a, m, s)
                 : fbt_dispatch<false>(dhp, dtype, a, m, s);
}
