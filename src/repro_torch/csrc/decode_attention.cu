// GQA decode attention for Hopper (sm_90a): one new token per sequence
// against a length-masked KV cache.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/decode_attention.py
// (:32), launched by `decode_attention` (:68, pallas_call at :96): q (B, H,
// dh), caches k and v (B, S, KV, dh), cache_len (B,) int32 -> out (B, H, dh)
// in q's dtype, float32 or bfloat16.  Query head h reads KV head h / G (G =
// H / KV; for a rank's share of an uneven split over `model`, (off + h) / G
// with G and off given: a block keeps its KV head's G rows, those of heads
// outside [0, H) zero and never written); key positions >= cache_len[b] are
// masked.  q is scaled in fp32 first, scores,
// statistics and the accumulator are fp32; `round_p` rounds p to v's dtype
// before P.V, as the TPU kernel does, else p stays fp32, as the model's
// `gqa_decode` does.  No fast math: expf, and fmaf.
//
// Bound: bytes.  The valid prefix of k and v is read once (2 * sum(len) *
// KV * dh elements) for 4 * sum(len) * H * dh flops: one flop per byte in
// float32, two in bfloat16, far below either ridge.  Only many blocks with
// loads in flight reach the card's memory rate, and one block per (b, KV
// head) gives 16 at B = 8, KV = 2.
//
// Design (flash-decoding, two passes):
//   * da_kernel: one block per (b, KV head, split of the sequence).  Split
//     s takes keys [s * chunk, (s + 1) * chunk) up to cache_len[b]; a block
//     whose chunk starts at or beyond cache_len[b] writes an empty partial
//     (m = -inf, l = 0) and exits.  The plan (chunk, splits, warps) depends
//     on the shapes only, never on the lengths' values, so lengths on the
//     card need no synchronisation and the launch can be captured in a CUDA
//     graph; repro_torch.kernels.decode_attention.plan_decode makes it.
//   * The block keeps the G query rows of its KV head, so each k and v row
//     is read once for all G heads: warp w owns rows g = w, w + warps, ...
//     (RW of them: 1, 2 or 4), each held scaled in registers, spread over
//     the lanes by 16-byte segments of dh.  A group of R lanes (a power of
//     two, 8 to 32, at least the row's segments where it can) takes R keys
//     of a tile: each lane sums its segments' products for every key and
//     row, and a reduce-scatter over the group (NB - 1 shuffles for NB
//     keys) leaves each key's dot product on one lane.
//     R and RW are template parameters, so every loop and butterfly is
//     unrolled and the rows' shuffles interleave.  Each warp runs the
//     online softmax of its own rows (one lane per key of a tile) and P.V
//     into per-lane fp32 accumulators over its segments, the keys of a
//     tile spread over the warp's 32 / R lane groups, which a butterfly
//     sums at the end of the chunk.
//   * k and v are staged in tiles of DA_TILE keys by cp.async, two tiles in
//     flight: 16-byte copies where the caches' bases, strides and dh allow
//     (`vec`), else element loads; rows past the chunk's last key are
//     zero-filled.  The caches are read in the model's own layout through
//     their strides, never transposed or copied.  The grid runs split-major,
//     so the blocks of the first splits, which every sequence has, are
//     dispatched first.
//   * With one split the block writes the output; with more it writes its
//     fp32 partial (m, l, acc[G][dh]) to a workspace, and da_combine merges
//     the splits that hold keys (s < ceil(cache_len[b] / chunk)) in split
//     order: m = max m_s, l = sum e^(m_s - m) l_s, acc = sum e^(m_s - m)
//     acc_s, out = acc / l in q's dtype.  No atomics: two calls give
//     bitwise equal outputs.
//   * With `lse` (not null) the pass that normalises a row also writes its
//     log-sum-exp m + log(l) (fp32, natural log; -inf for a length of 0):
//     da_kernel with one split, da_combine with more.  A caller that splits
//     one sequence's keys over ranks merges their outputs by it, so the
//     output is then fp32, not rounded: the merge rounds once.
//   * With `round_p`, each split rounds p against its own running max, as
//     the TPU kernel rounds against its running max of each tile.
//   * Lengths are read on the card and clamped into [0, S], so a bad length
//     never reads outside the cache; a length of 0 gives a zero row (the
//     output is divided by max(l, 1e-30)).  Checking them is the caller's
//     job, as for the TPU kernel.
//   * A sliding window on a full-length cache (the reference's gqa_decode
//     with `window`): `starts` (B,) int32, or null, gives each row's first
//     valid key, so keys [start, len) are attended (the start clamped into
//     [0, len] on the card).  `window` > 0 is a shape, the caller's promise
//     that a row attends at most W keys (a start below len - W is raised
//     to it).  With `rel` the grid holds ceil(W / chunk) + 1 splits a (b,
//     KV head), split s taking chunk start / chunk + s, so the grid
//     follows W and not S (at S 32,768 and W 4,096 it spans 4,128 keys a
//     row, not 32,768); else split s
//     takes chunk s and the splits wholly below the start write the empty
//     partial.  Either way the combine reads only the splits that hold
//     keys, and a row whose keys all lie below its start (a piece of a
//     sequence split over ranks) gives zeros and lse -inf, as a length of
//     0 does.  The plan still depends on shapes only (W is one).
//   * Wider shapes than the served ones: G > 64 takes a second grid axis
//     over groups of at most 64 query rows of a KV head (each group reads
//     the chunk's k and v again); dh > 256 takes twice the 16-byte segments
//     per lane (SPL), up to dh = 512 and the shared memory a block can have.
//     At G <= 64 and dh <= 256 the code is the one the served shapes run.

#include "attention.cuh"
#include "hopper.cuh"

#define DA_TILE 32        // keys per staged tile (one per lane in the softmax)
#define DA_MAX_WARPS 16   // <= 64 query rows a block
#define DA_MAX_DH 256     // the served segments per lane (SPL) take dh <= 256
#define DA_WIDE_DH 512    // twice the segments per lane
#define DA_BATCH 16       // the combine's loads in flight per thread

struct DaArgs {
  const void* q; const void* k; const void* v; void* o; const int* lens;
  const int* starts;  // (B,) first valid keys, or null (0)
  float* ws;        // splits > 1: (B * KV, splits, G) x (m, l), then
                    // (B * KV, splits, G, dh) accumulators
  float* lse;       // (B, H) row log-sum-exps, or null
  int B, S, H, KV, dh, chunk, splits, warps;
  int gsz;          // query rows of a KV head per block (blockIdx.y a group)
  int G, off;       // query rows a KV head serves; head h is its KV head's
                    // row off + h (a rank's share of an uneven split)
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
  int round_p, vec;
  int window;       // > 0: at most the last `window` keys of a row
  int rel;          // the grid's split 0 is the chunk of each row's start
};

// Row b's valid keys [st, len) (the length clamped into [0, S], the start
// into [0, len] and, with a window, to at least len - window) and the
// chunk of the grid's split 0.
struct DaRow { int len, st, base; };

__device__ __forceinline__ DaRow da_row(const DaArgs& a, int b) {
  DaRow r;
  r.len = min(max(a.lens[b], 0), a.S);
  r.st = a.starts ? min(max(a.starts[b], 0), r.len) : 0;
  if (a.window > 0) r.st = max(r.st, r.len - a.window);
  r.base = a.rel ? r.st / a.chunk : 0;
  return r;
}

// Elements of a dh row padded to whole 16-byte segments.
template <typename T>
__host__ __device__ __forceinline__ int da_pitch(int dh) {
  constexpr int V = 16 / sizeof(T);
  return (dh + V - 1) / V * V;
}

// Element i of the output: fp32 with `lse` (the caller merges pieces of one
// sequence and rounds once, after its merge), else rounded once to T.
template <typename T>
__device__ __forceinline__ void da_store(const DaArgs& a, long long i, float x) {
  if (a.lse) static_cast<float*>(a.o)[i] = x;
  else static_cast<T*>(a.o)[i] = att_out<T>(x);
}

template <typename T>
static int da_smem_bytes(int dh, int warps, int rows) {
  return 2 * 2 * DA_TILE * da_pitch<T>(dh) * (int)sizeof(T)
         + warps * rows * DA_TILE * (int)sizeof(float);
}

template <typename T>
__device__ __forceinline__ void da_seg(const T* src, float (&f)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = att_in<T>(e[i]);
}

// Reduce-scatter over groups of R lanes: v[r][i] holds a lane's partial
// sums of NB keys for each of RW rows; afterwards v[r][0] holds the whole
// sum of key i = (lane % R) / (R / NB).  log2(NB) halving steps (each lane
// keeps the half of the keys its slot bit selects and adds its partner's
// partial of that half), then log2(R / NB) butterfly steps.
template <int R, int NB, int RW>
__device__ __forceinline__ void da_scatter(float (&v)[RW][NB], int lane) {
#pragma unroll
  for (int st = 0; (NB >> st) > 1; ++st) {
    const int half = (NB >> st) / 2, o = (R / 2) >> st;
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) {
        if (i >= half) continue;
        const float send = up ? v[r][i] : v[r][i + half];
        const float keep = up ? v[r][i + half] : v[r][i];
        v[r][i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
  }
#pragma unroll
  for (int o = R / NB / 2; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < RW; ++r)
      v[r][0] += __shfl_xor_sync(0xffffffffu, v[r][0], o);
}

// Segments per lane, at most, for the dh <= 256 kernels.
template <typename T>
constexpr int da_spl() { return (DA_MAX_DH / (16 / (int)sizeof(T)) + 31) / 32; }

// R lanes per key (a power of two, 8 to 32), RW query rows per warp, SPL
// 16-byte segments of dh per lane at most.
template <typename T, int R, int RW, int SPL>
__global__ void __launch_bounds__(DA_MAX_WARPS * 32)
da_kernel(DaArgs a) {
  constexpr int V = 16 / sizeof(T);                 // elements per segment
  constexpr int KPW = 32 / R;                       // keys per warp at once
  constexpr int NB = R * RW > 32 ? 32 / RW : R;     // keys per reduce-scatter
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = a.G, dh = a.dh, nw = a.warps;
  const int dhp = da_pitch<T>(dh), nseg = dhp / V;
  T* Ks = reinterpret_cast<T*>(smem);               // [2][DA_TILE][dhp]
  T* Vs = Ks + 2 * DA_TILE * dhp;                   // [2][DA_TILE][dhp]
  float* Pw = reinterpret_cast<float*>(Vs + 2 * DA_TILE * dhp);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // split-major: the first splits, which every sequence has, go out first
  const int nbkv = a.B * a.KV;
  const int split = blockIdx.x / nbkv, bkv = blockIdx.x - split * nbkv;
  const int b = bkv / a.KV, kvh = bkv - b * a.KV;
  const int g0 = blockIdx.y * a.gsz, gn = min(a.gsz, G - g0);  // this group's rows
  const int h0 = kvh * G - a.off;    // the head of row g is h0 + g, if in [0, H)
  const DaRow row = da_row(a, b);
  const int ck = (row.base + split) * a.chunk;      // this split's chunk
  const int c0 = max(ck, row.st), c1 = min(ck + a.chunk, row.len);
  float* ws_ml = a.ws + ((long long)bkv * a.splits + split) * G * 2;
  if (c0 >= c1) {                  // no keys: an empty partial, never combined
    if (a.splits > 1) {
      for (int g = g0 + tid; g < g0 + gn; g += blockDim.x) {
        ws_ml[2 * g] = -INFINITY;
        ws_ml[2 * g + 1] = 0.0f;
      }
    } else {                       // a length of 0: zero rows
      for (int e = tid; e < gn * dh; e += blockDim.x) {
        const int h = h0 + g0 + e / dh;
        if (h >= 0 && h < a.H)
          da_store<T>(a, ((long long)b * a.H + h) * dh + e % dh, 0.0f);
      }
      if (a.lse)
        for (int g = tid; g < gn; g += blockDim.x)
          if (h0 + g0 + g >= 0 && h0 + g0 + g < a.H)
            a.lse[(long long)b * a.H + h0 + g0 + g] = -INFINITY;
    }
    return;
  }

  // Stage keys [j0, j0 + DA_TILE) of k and v; rows at or past c1 are zeros.
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;
  auto stage = [&](int buf, int j0) {
    T* kd = Ks + buf * DA_TILE * dhp;
    T* vd = Vs + buf * DA_TILE * dhp;
    if (a.vec) {                                    // dhp == dh
      for (int c = tid; c < 2 * DA_TILE * nseg; c += blockDim.x) {
        const int isv = c >= DA_TILE * nseg, cc = c - isv * DA_TILE * nseg;
        const int r = cc / nseg, off = (cc - r * nseg) * V;
        const bool ok = j0 + r < c1;
        const T* src = isv ? vb + (j0 + r) * a.vss : kb + (j0 + r) * a.kss;
        hp_cp16((isv ? vd : kd) + r * dhp + off, ok ? src + off : kb, ok);
      }
    } else {                                        // zeros in [dh, dhp)
      for (int c = tid; c < 2 * DA_TILE * dhp; c += blockDim.x) {
        const int isv = c >= DA_TILE * dhp, cc = c - isv * DA_TILE * dhp;
        const int r = cc / dhp, d = cc - r * dhp;
        const T* src = isv ? vb + (j0 + r) * a.vss : kb + (j0 + r) * a.kss;
        (isv ? vd : kd)[r * dhp + d] =
            (d < dh && j0 + r < c1) ? src[d] : att_out<T>(0.0f);
      }
    }
    hp_cp_commit();
  };
  stage(0, c0);

  // This warp's rows g = g0 + warp + nw * r, their scaled q in registers:
  // lane (slot sg of its group) holds segments sg, sg + R, ... of each row.
  const int rows = max(0, min(RW, (gn - warp + nw - 1) / nw));
  const int sg = lane % R, key = lane / R;
  // (rows of heads outside [0, H) are zeros: their output is not written)
  const T* q = static_cast<const T*>(a.q) + b * a.qsb;
  float qr[RW][SPL][V], acc[RW][SPL][V];
  float m[RW], l[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = ATT_NEG;
    l[r] = 0.0f;
    const int h = h0 + g0 + warp + nw * r;
    const bool live = r < rows && h >= 0 && h < a.H;
#pragma unroll
    for (int s = 0; s < SPL; ++s)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int d = (sg + R * s) * V + e;
        qr[r][s][e] = (live && sg + R * s < nseg && d < dh)
                          ? att_in<T>(q[(long long)h * a.qsh + d]) * a.scale : 0.0f;
        acc[r][s][e] = 0.0f;
      }
  }
  float* P = Pw + warp * RW * DA_TILE;              // [RW][DA_TILE]

  int it = 0;
  for (int j0 = c0; j0 < c1; j0 += DA_TILE, ++it) {
    const int buf = it & 1, nk = min(DA_TILE, c1 - j0);
    if (j0 + DA_TILE < c1) {
      stage(buf ^ 1, j0 + DA_TILE);
      hp_cp_wait<1>();
    } else {
      hp_cp_wait<0>();
    }
    __syncthreads();
    const T* kt = Ks + buf * DA_TILE * dhp;
    const T* vt = Vs + buf * DA_TILE * dhp;
    if (rows > 0) {
      // scores: lane group `key` takes keys j = jj * KPW + key, NB at a
      // time; each lane sums its segments (in index order) for every key,
      // then a reduce-scatter over the group's R lanes leaves each key's
      // score on one lane (on R / NB lanes alike when NB < R)
#pragma unroll
      for (int jb = 0; jb < R; jb += NB) {
        float v[RW][NB];
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
          for (int i = 0; i < NB; ++i) v[r][i] = 0.0f;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int j = (jb + i) * KPW + key;
#pragma unroll
          for (int s = 0; s < SPL; ++s) {
            if (sg + R * s >= nseg) continue;
            float kf[V];
            da_seg<T>(kt + j * dhp + (sg + R * s) * V, kf);
#pragma unroll
            for (int r = 0; r < RW; ++r)
#pragma unroll
              for (int e = 0; e < V; ++e) v[r][i] = fmaf(qr[r][s][e], kf[e], v[r][i]);
          }
        }
        da_scatter<R, NB, RW>(v, lane);
        const int i = sg / (R / NB), j = (jb + i) * KPW + key;
        if (sg % (R / NB) == 0)
#pragma unroll
          for (int r = 0; r < RW; ++r)
            if (r < rows) P[r * DA_TILE + j] = j < nk ? v[r][0] : ATT_NEG;
      }
      __syncwarp();
      // online softmax of each row, lane = key
      float alpha[RW], sc[RW], mx[RW], sum[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) mx[r] = sc[r] = P[r * DA_TILE + lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < RW; ++r)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);
        sum[r] = expf(sc[r] - m_new);
        m[r] = m_new;
        if (r < rows) P[r * DA_TILE + lane] = a.round_p ? att_round<T>(sum[r]) : sum[r];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < RW; ++r)
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
#pragma unroll
      for (int r = 0; r < RW; ++r) l[r] = l[r] * alpha[r] + sum[r];
      __syncwarp();
      // P.V: lane group `key` takes keys key, key + KPW, ... (the rows past
      // nk are zeros, and their p is 0)
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int s = 0; s < SPL; ++s)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[r][s][e] *= alpha[r];
#pragma unroll 4
      for (int jj = 0; jj < DA_TILE / KPW; ++jj) {
        const int j = jj * KPW + key;
        float pj[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) pj[r] = P[r * DA_TILE + j];
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          if (sg + R * s >= nseg) continue;
          float vf[V];
          da_seg<T>(vt + j * dhp + (sg + R * s) * V, vf);
#pragma unroll
          for (int r = 0; r < RW; ++r)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[r][s][e] = fmaf(pj[r], vf[e], acc[r][s][e]);
        }
      }
      __syncwarp();
    }
    __syncthreads();               // the next stage overwrites this buffer
  }
  if (rows == 0) return;

  // sum the lane groups' accumulators; group 0 (lanes < R) writes
#pragma unroll
  for (int off = 16; off >= R; off >>= 1)
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int s = 0; s < SPL; ++s)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[r][s][e] += __shfl_xor_sync(0xffffffffu, acc[r][s][e], off);
  if (key != 0) return;
  const bool split_out = a.splits > 1;
  float* ws_acc = a.ws + (long long)a.B * a.KV * a.splits * G * 2
                  + ((long long)bkv * a.splits + split) * G * dh;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (r >= rows) continue;
    const int g = g0 + warp + nw * r, h = h0 + g;
    const float den = fmaxf(l[r], 1e-30f);
    if (split_out && sg == 0) {
      ws_ml[2 * g] = m[r];
      ws_ml[2 * g + 1] = l[r];
    }
    if (!split_out && (h < 0 || h >= a.H)) continue;
    const long long o = ((long long)b * a.H + h) * dh;
    if (!split_out && a.lse && sg == 0)
      a.lse[(long long)b * a.H + h] = l[r] > 0.0f ? m[r] + logf(l[r]) : -INFINITY;
#pragma unroll
    for (int s = 0; s < SPL; ++s)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int d = (sg + R * s) * V + e;
        if (sg + R * s >= nseg || d >= dh) continue;
        if (split_out) ws_acc[g * dh + d] = acc[r][s][e];
        else da_store<T>(a, o + d, acc[r][s][e] / den);
      }
  }
}

// One block per (b, query head): merge the splits that hold keys (from the
// start's chunk to the length's), in order.  The splits' m and l are read once, in parallel, into shared
// memory with their weights e^(m_s - m); each thread then sums its
// elements of the accumulators over the splits in order.
template <typename T>
__global__ void da_combine(DaArgs a) {
  extern __shared__ float cw[];                     // [ns] weights, [ns] l
  __shared__ float red[32];
  const int G = a.G, tid = threadIdx.x;
  const int b = blockIdx.x / a.H, h = blockIdx.x - b * a.H + a.off;
  const int bkv = b * a.KV + h / G, g = h % G;     // h: the head's row of its groups
  const DaRow row = da_row(a, b);
  const int lo = row.st / a.chunk - row.base;
  const int ns = row.st < row.len
      ? min(a.splits, (row.len + a.chunk - 1) / a.chunk - row.base) - lo : 0;
  const float* ml = a.ws + ((long long)bkv * a.splits + lo) * G * 2 + 2 * g;
  const float* accs = a.ws + (long long)a.B * a.KV * a.splits * G * 2
                      + (((long long)bkv * a.splits + lo) * G + g) * a.dh;
  float mx = -INFINITY;
  for (int s = tid; s < ns; s += blockDim.x) {
    cw[s] = ml[s * G * 2];
    cw[ns + s] = ml[s * G * 2 + 1];
    mx = fmaxf(mx, cw[s]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) mx = fmaxf(mx, red[w]);
  for (int s = tid; s < ns; s += blockDim.x) cw[s] = expf(cw[s] - mx);
  __syncthreads();
  float l = 0.0f;
  for (int s = 0; s < ns; ++s) l = fmaf(cw[s], cw[ns + s], l);
  const float den = fmaxf(l, 1e-30f);
  if (a.lse && tid == 0) a.lse[blockIdx.x] = l > 0.0f ? mx + logf(l) : -INFINITY;
  const long long o = (long long)blockIdx.x * a.dh;
  for (int d = tid; d < a.dh; d += blockDim.x) {
    float acc = 0.0f;
    for (int s0 = 0; s0 < ns; s0 += DA_BATCH) {   // DA_BATCH loads in flight
      float x[DA_BATCH];
#pragma unroll
      for (int i = 0; i < DA_BATCH; ++i)
        x[i] = s0 + i < ns ? accs[(long long)(s0 + i) * G * a.dh + d] : 0.0f;
#pragma unroll
      for (int i = 0; i < DA_BATCH; ++i)
        if (s0 + i < ns) acc = fmaf(cw[s0 + i], x[i], acc);
    }
    da_store<T>(a, o + d, acc / den);
  }
}

template <typename T, int R, int RW, int SPL>
static int da_run(const DaArgs& a, int smem, cudaStream_t s) {
  static int granted[HP_MAX_DEVICES] = {0};
  int e = hp_grant_smem((const void*)da_kernel<T, R, RW, SPL>, smem, granted);
  if (e) return e;
  const dim3 grid(a.B * a.KV * a.splits, (a.G + a.gsz - 1) / a.gsz);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  da_kernel<T, R, RW, SPL><<<grid, a.warps * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int R, int SPL = da_spl<T>()>
static int da_rows(const DaArgs& a, int rows, int smem, cudaStream_t s) {
  if (rows == 1) return da_run<T, R, 1, SPL>(a, smem, s);
  if (rows == 2) return da_run<T, R, 2, SPL>(a, smem, s);
  return da_run<T, R, 4, SPL>(a, smem, s);
}

template <typename T>
static int da_dispatch(const DaArgs& a, int rows, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int nseg = da_pitch<T>(a.dh) / V;
  const int smem = da_smem_bytes<T>(a.dh, a.warps, rows);
  int e;
  if (nseg <= 8) e = da_rows<T, 8>(a, rows, smem, s);
  else if (nseg <= 16) e = da_rows<T, 16>(a, rows, smem, s);
  else if (nseg <= 32 * da_spl<T>()) e = da_rows<T, 32>(a, rows, smem, s);
  else e = da_rows<T, 32, 2 * da_spl<T>()>(a, rows, smem, s);
  if (e || a.splits == 1) return e;
  static int granted[HP_MAX_DEVICES] = {0};
  const int cbytes = 2 * a.splits * (int)sizeof(float);
  e = hp_grant_smem((const void*)da_combine<T>, cbytes, granted);
  if (e) return e;
  const int threads = a.dh >= 256 ? 256 : (a.dh + 31) / 32 * 32;
  da_combine<T><<<a.B * a.H, threads, cbytes, s>>>(a);
  return (int)cudaGetLastError();
}

// q (B, H, dh) with strides qsb, qsh, head h reading KV head (off + h) / G
// (off 0 and G = H / KV but for a rank's share of an uneven split; KV =
// ceil((off + H) / G)); k and v (B, S, KV, dh) with strides
// in elements, the last axis contiguous; lens (B,) int32 on the card (each
// clamped into [0, S]); starts (B,) int32 on the card or null, window >= 0
// and rel as DaArgs states; out (B, H, dh) contiguous.  The plan: `chunk`
// keys per block (a multiple of DA_TILE), `splits` = ceil(S / chunk)
// blocks per (b, KV head) (with rel: ceil(window / chunk) + 1, fewer) and
// group of `gsz` query rows, `warps` warps of `rows` query
// rows (1, 2 or 4; gsz <= warps * rows); ws holds B * KV * splits * G * (dh + 2) floats when splits > 1;
// lse (B, H) floats, or null; with lse, out is float32 (each row normalised
// in fp32 and not rounded), else q's dtype.
// `vec`: 16-byte copies of the caches.  dtype 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int da_launch(const void* q, const void* k, const void* v, void* o,
                         const void* lens, const void* starts, void* ws,
                         void* lse, int B, int S, int H,
                         int KV, int dh, int G, int off, long long qsb,
                         long long qsh,
                         long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh,
                         float scale, int round_p, int vec, int dtype,
                         int chunk, int splits, int warps, int rows, int gsz,
                         int window, int rel, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (S < 1 || KV < 1 || G < 1 || off < 0 || off >= G ||
      KV != (off + H + G - 1) / G || dh < 1 || dh > DA_WIDE_DH || window < 0)
    return (int)cudaErrorInvalidValue;
  if (warps < 1 || warps > DA_MAX_WARPS || (rows != 1 && rows != 2 && rows != 4) ||
      gsz < 1 || gsz > warps * rows || chunk < DA_TILE || chunk % DA_TILE != 0 ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int full = (S + chunk - 1) / chunk;
  if (rel ? (window < 1 || splits != min(full, (window + chunk - 1) / chunk + 1))
          : splits != full)
    return (int)cudaErrorInvalidValue;
  DaArgs a{q, k, v, o, (const int*)lens, (const int*)starts, (float*)ws, (float*)lse,
           B, S, H, KV, dh, chunk, splits, warps, gsz, G, off, qsb, qsh, ksb,
           kss, ksh, vsb, vss, vsh, scale, round_p, vec, window, rel};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? da_dispatch<float>(a, rows, s)
                    : da_dispatch<__nv_bfloat16>(a, rows, s);
}
