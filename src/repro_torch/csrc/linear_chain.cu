// Fused §IV-G stage chains for Hopper (sm_90a): a whole linear-time cluster
// applied to a stream in one pass, one load and one store per element.
//
// Replaces the TPU kernels `_chain_kernel` (float,
// src/repro/kernels/linear_pipeline.py:142) and `_chain_kernel_q` (int32
// carrier, :197), both launched through `_tiled_chain_call` (:93,
// pallas_call at :127).  The Pallas kernels unroll the stage tuple at trace
// time; here one generic kernel per variant walks a packed stage table, so
// every chain shares one binary (no build per chain).
//
// Bound: bytes, and at the served sizes (at most ~1 MB, bonsai/curet-m's
// (64, 976) float chain: ~0.3 us at 3.35 TB/s) the launch and one memory
// round trip.  The design spends exactly one round trip:
//   * Block b owns elements [b * chunk, (b + 1) * chunk) of the flattened
//     stream and the same elements of every extra (extras have the stream's
//     shape).  One 1-D bulk copy of the stage table, of each operand's
//     16-byte-aligned middle and of the vec pool (when it is staged) goes
//     into shared memory, issued by several warps at once, all on one
//     mbarrier with the bytes expected once; the few elements before an
//     operand's first 16-byte boundary or after its last are loaded by the
//     threads that own them, in the same kernel, so a view at any storage
//     offset is taken.  Every thread then waits once.
//   * The parameters carry the plan, read at fixed offsets only (see
//     lc_kernel); the stage table travels with the operands.
//   * The walk reads the table and the operands from shared memory (the vec
//     pool from global memory, through the same pointer, when it is too
//     large to stage), so no load waits on the previous stage's result.  A
//     thread takes LC_RUN consecutive elements at a time: their columns are
//     found with one division, the stage's code and the extra's dtype are
//     decoded once for the LC_RUN elements, and the result is stored with
//     one vector store when the output is aligned (it is: the wrapper
//     allocates it).  The stream's dtype is a template parameter:
//     lc_kernel<float, false, N> is the float variant, lc_kernel<int8_t |
//     int16_t | int32_t, true, N> the fixed-point one; N bounds the
//     operands (LC_FEW_OPS or LC_MAX_OPS).
//   * The plan (chunk, grid, threads, where each operand sits in shared
//     memory) comes from kernels/linear_pipeline.plan_chain; the CPU tests
//     emulate it.
//
// The arithmetic is the plain version's: float_stage (ref.apply_stage) and
// q_stage (ref.apply_stage_q) of fixed_point.cuh, __fmul_rn/__fadd_rn,
// tanhf/expf, no fast math; the integer variant widens to int32 once and
// writes back by a narrowing cast of the already saturated value, as the
// Pallas kernel's astype does.

#include <cstddef>
#include <type_traits>

#include "fixed_point.cuh"
#include "hopper.cuh"

#define LC_MAX_STAGES 64
#define LC_MAX_ARR 16
#define LC_MAX_OPS (LC_MAX_ARR + 1)   // the stream, then the extras
#define LC_FEW_OPS 4                  // a kernel instance for up to 3 extras
#define LC_THREADS 256
#define LC_RUN 4                      // consecutive elements a thread takes

// One stage, a row of the packed table (kernels/linear_pipeline.pack_chain):
// code, operand (extra index or vec pool offset), vec length, p0..p2; f:
// scalar, s_in, s_out, -.
struct LcStage {
  int code, opnd, vlen, p0, p1, p2;
  float f[4];
};

// Fixed per chain and device: packed once by the wrapper.  The stage table
// and the vec pool live in global memory, each a multiple of 16 bytes.
struct LcChain {
  const void* table;
  const void* vecs;        // float32 or int32 words
  int n_stages, bits, table_bytes, vec_bytes, quantized, pad;
};

// One operand of a plan: its dtype code, its base address mod 16 (sh), the
// elements of a chunk before its first 16-byte boundary (head) and its
// region of shared memory (off).  Element j of a block's chunk sits at
// shared byte off + sh + j * itemsize, so elements head.. start on a
// 16-byte boundary.
struct LcOp {
  int dt, sh, head, off;
};

// Fixed per (shape, dtypes, base addresses mod 16): ChainPlan with the
// operands' dtype codes, the stream first.
struct LcPlan {
  int chunk, blocks, threads, smem, n_ops, vec_at;
  LcOp op[LC_MAX_OPS];
};

// One operand of a call, as the kernel reads it (16 bytes): its address,
// where its element 0 of a chunk sits in shared memory (the region plus the
// base address mod 16), and meta = dtype code | log2(itemsize) << 4 |
// head << 8.
struct LcOpArg {
  const void* src;
  int off, meta;
};

// The kernel's parameter block, laid out so that a call with up to
// LC_FEW_OPS operands reads two 64-byte lines of it: everything but the
// operands, then the operands (the stream first).
struct LcArgs {
  const void* table;
  const void* vecs;
  void* out;
  long long total;
  int n, n_stages, bits, table_bytes, vec_bytes, chunk, n_ops, vec_at;
  LcOpArg op[LC_MAX_OPS];
};

template <typename T>
struct alignas(sizeof(T) * LC_RUN) LcVec {
  T v[LC_RUN];
};

#define LC_BIT(st) (1u << (st))
#define LC_VEC_STAGES (LC_BIT(ST_ADD_VEC) | LC_BIT(ST_SUB_VEC) | LC_BIT(ST_HAD_VEC) | \
                       LC_BIT(ST_Q_ADD_VEC) | LC_BIT(ST_Q_SUB_VEC) | LC_BIT(ST_Q_HAD_VEC))
#define LC_ARR_STAGES (LC_BIT(ST_ADD_ARR) | LC_BIT(ST_SUB_ARR) | LC_BIT(ST_HAD_ARR) | \
                       LC_BIT(ST_Q_ADD_ARR) | LC_BIT(ST_Q_SUB_ARR) | LC_BIT(ST_Q_HAD_ARR))

// A stage applied to a thread's LC_RUN elements with its code known at
// compile time.  The walk picks one per stage by bit tests: a switch on the
// runtime code (float_stage's and q_stage's own) compiles to a jump table
// read from the constant bank at every dispatch, which made each stage
// several times slower (launch/profile_kernels.py times it as the variant
// "a switch per element").  Codes that share a formula in float_stage and
// q_stage share an instance.
template <int ST>
__device__ __forceinline__ void lc_float(float (&v)[LC_RUN], const float (&o)[LC_RUN]) {
#pragma unroll
  for (int j = 0; j < LC_RUN; ++j) v[j] = float_stage(ST, v[j], o[j]);
}

__device__ __forceinline__ void lc_float_step(int code, float (&v)[LC_RUN],
                                              const float (&o)[LC_RUN], const LcStage&,
                                              int) {
  const uint32_t m = LC_BIT(code);
  if (m & (LC_BIT(ST_SCALAR_MUL) | LC_BIT(ST_HAD_VEC) | LC_BIT(ST_HAD_ARR)))
    lc_float<ST_HAD_ARR>(v, o);
  else if (m & (LC_BIT(ST_ADD_VEC) | LC_BIT(ST_ADD_ARR))) lc_float<ST_ADD_ARR>(v, o);
  else if (m & (LC_BIT(ST_SUB_VEC) | LC_BIT(ST_SUB_ARR))) lc_float<ST_SUB_ARR>(v, o);
  else if (m & LC_BIT(ST_TANH)) lc_float<ST_TANH>(v, o);
  else if (m & LC_BIT(ST_SIGMOID)) lc_float<ST_SIGMOID>(v, o);
  else if (m & LC_BIT(ST_RELU)) lc_float<ST_RELU>(v, o);
  else lc_float<ST_EXP>(v, o);
}

// U >= 0: q_unary's unary code, else the stage's own p0.
template <int ST, int U = -1>
__device__ __forceinline__ void lc_q(int (&v)[LC_RUN], const int (&o)[LC_RUN],
                                     const LcStage& st, int bits) {
#pragma unroll
  for (int j = 0; j < LC_RUN; ++j)
    v[j] = q_stage(ST, v[j], o[j], U >= 0 ? U : st.p0, st.p1, st.p2, st.f[1], st.f[2],
                   bits);
}

__device__ __forceinline__ void lc_q_step(int code, int (&v)[LC_RUN],
                                          const int (&o)[LC_RUN], const LcStage& st,
                                          int bits) {
  const uint32_t m = LC_BIT(code);
  if (m & LC_BIT(ST_Q_SCALAR_MUL)) lc_q<ST_Q_SCALAR_MUL>(v, o, st, bits);
  else if (m & (LC_BIT(ST_Q_ADD_VEC) | LC_BIT(ST_Q_ADD_ARR)))
    lc_q<ST_Q_ADD_ARR>(v, o, st, bits);
  else if (m & (LC_BIT(ST_Q_SUB_VEC) | LC_BIT(ST_Q_SUB_ARR)))
    lc_q<ST_Q_SUB_ARR>(v, o, st, bits);
  else if (m & (LC_BIT(ST_Q_HAD_VEC) | LC_BIT(ST_Q_HAD_ARR)))
    lc_q<ST_Q_HAD_ARR>(v, o, st, bits);
  else {                                           // q_unary, by its unary code
    const uint32_t u = LC_BIT(st.p0 & 3);
    if (u & 1u) lc_q<ST_Q_UNARY, 0>(v, o, st, bits);
    else if (u & 2u) lc_q<ST_Q_UNARY, 1>(v, o, st, bits);
    else if (u & 4u) lc_q<ST_Q_UNARY, 2>(v, o, st, bits);
    else lc_q<ST_Q_UNARY, 3>(v, o, st, bits);
  }
}

// The parameter block is read by value at fixed offsets only (loops over
// operands are unrolled to NOPS, LC_FEW_OPS or LC_MAX_OPS): a read at a
// runtime index, or through its address, makes the compiler copy it to
// local memory or read it with generic loads.  What the walk indexes at run
// time (the stage table, each operand's shared-memory base and dtype) it
// reads from shared memory.
template <typename T, bool Q, int NOPS>
__global__ void __launch_bounds__(LC_THREADS) lc_kernel(const LcArgs a) {
  using C = typename std::conditional<Q, int, float>::type;   // the carrier
  extern __shared__ __align__(16) unsigned char lc_smem[];
  __shared__ __align__(16) LcStage s_st[LC_MAX_STAGES];
  __shared__ int s_base[NOPS], s_dt[NOPS];
  __shared__ __align__(8) uint64_t bar;
  const int n_ops = a.n_ops;
  const long long c0 = (long long)blockIdx.x * a.chunk;
  const int len = (int)min((long long)a.chunk, a.total - c0);
  const int tid = threadIdx.x;
  const int step = blockDim.x * LC_RUN;
  // each operand's bulk range within the chunk, [lo, hi) elements: from
  // its head on, whole 16-byte units (none past the operands)
  int lo[NOPS], hi[NOPS];
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    const int meta = a.op[k].meta, lg = (meta >> 4) & 3;
    lo[k] = meta >> 8;
    hi[k] = lo[k] + (k < n_ops ? ((max(len - lo[k], 0) << lg) & ~15) >> lg : 0);
  }

  if (tid == 0) {
    hp_bar_init(&bar, 1);
    hp_bar_init_fence();
  }
  __syncthreads();              // the barrier's init, before any copy
  // thread 0 expects the bytes and copies the table and the vecs; operand k
  // is copied by lane 0 of warp (k + 1) mod warps, so the copies issue in
  // parallel (a bulk copy may complete before the bytes are expected: the
  // phase cannot end before thread 0 arrives)
  if (tid == 0) {
    uint32_t bytes = a.table_bytes + (a.vec_at >= 0 ? a.vec_bytes : 0);
#pragma unroll
    for (int k = 0; k < NOPS; ++k) bytes += (uint32_t)(hi[k] - lo[k]) << ((a.op[k].meta >> 4) & 3);
    hp_bar_expect_tx(&bar, bytes);
    if (a.table_bytes) hp_bulk_load(s_st, a.table, a.table_bytes, &bar);
    if (a.vec_at >= 0) hp_bulk_load(lc_smem + a.vec_at, a.vecs, a.vec_bytes, &bar);
  }
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    if (k >= n_ops) break;
    if (tid != (k + 1) % warps * 32) continue;
    const LcOpArg o = a.op[k];
    const int lg = (o.meta >> 4) & 3;
    if (hi[k] > lo[k])
      hp_bulk_load(lc_smem + o.off + (lo[k] << lg),
                   (const unsigned char*)o.src + ((c0 + lo[k]) << lg),
                   (uint32_t)(hi[k] - lo[k]) << lg, &bar);
    s_base[k] = o.off;
    s_dt[k] = o.meta & 15;
  }
  // the elements outside each operand's bulk range, by the thread that owns
  // them; they share no 16-byte unit with a bulk range
  int lo_max = 0, hi_min = len;
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    if (k >= n_ops) break;
    lo_max = max(lo_max, lo[k]);
    hi_min = min(hi_min, hi[k]);
  }
  for (int j0 = tid * LC_RUN; j0 < len; j0 += step) {
    const int j1 = min(j0 + LC_RUN, len);
    if (j0 >= lo_max && j1 <= hi_min) continue;
#pragma unroll
    for (int k = 0; k < NOPS; ++k) {
      if (k >= n_ops) break;
      if (j0 >= lo[k] && j1 <= hi[k]) continue;
      const int lg = (a.op[k].meta >> 4) & 3;
      const unsigned char* g = (const unsigned char*)a.op[k].src + (c0 << lg);
      unsigned char* s = lc_smem + a.op[k].off;
      for (int j = j0; j < j1; ++j) {
        if (j >= lo[k] && j < hi[k]) continue;
        if (lg == 0) s[j] = g[j];
        else if (lg == 1) ((uint16_t*)s)[j] = ((const uint16_t*)g)[j];
        else ((uint32_t*)s)[j] = ((const uint32_t*)g)[j];
      }
    }
  }
  // what the walk reads of the parameter block, read before the barrier
  const int n = a.n, n_stages = a.n_stages, bits = a.bits;
  const C* vecs = (const C*)(a.vec_at >= 0 ? lc_smem + a.vec_at
                                           : (const unsigned char*)a.vecs);
  const T* xs = (const T*)(lc_smem + a.op[0].off);
  T* out = (T*)a.out + c0;
  const bool vec_out = ((uintptr_t)a.out % sizeof(LcVec<T>)) == 0;
  const bool narrow = a.total <= 0x7fffffffLL;
  const int col0 = narrow ? (int)(c0 + tid * LC_RUN) % n : (int)((c0 + tid * LC_RUN) % n);
  __syncthreads();              // s_base and s_dt
  hp_bar_wait(&bar, 0);

  for (int j0 = tid * LC_RUN; j0 < len; j0 += step) {
    int cols[LC_RUN];
    int col = j0 == tid * LC_RUN ? col0 : (narrow ? (int)(c0 + j0) % n
                                                  : (int)((c0 + j0) % n));
#pragma unroll
    for (int j = 0; j < LC_RUN; ++j) {
      cols[j] = col;
      col = col + 1 == n ? 0 : col + 1;
    }
    // elements past `len` read the chunk's unused shared bytes: computed,
    // never stored
    C v[LC_RUN];
#pragma unroll
    for (int j = 0; j < LC_RUN; ++j) v[j] = (C)xs[j0 + j];
    LcStage st = s_st[0];        // each stage's row is read a stage ahead
    for (int s = 0; s < n_stages; ++s) {
      const LcStage next = s_st[s + 1 < n_stages ? s + 1 : s];
      const int code = st.code;
      const uint32_t m = LC_BIT(code);
      C o[LC_RUN];
      if (m & LC_VEC_STAGES) {
        const C* vp = vecs + st.opnd;
#pragma unroll
        for (int j = 0; j < LC_RUN; ++j) o[j] = vp[st.vlen == 1 ? 0 : cols[j]];
      } else if (m & LC_ARR_STAGES) {
        const int k = st.opnd + 1;
        const unsigned char* ap = lc_smem + s_base[k];
        if constexpr (Q) {
          const int dt = s_dt[k];
          if (dt == DT_I8) {
#pragma unroll
            for (int j = 0; j < LC_RUN; ++j) o[j] = ((const int8_t*)ap)[j0 + j];
          } else if (dt == DT_I16) {
#pragma unroll
            for (int j = 0; j < LC_RUN; ++j) o[j] = ((const int16_t*)ap)[j0 + j];
          } else {
#pragma unroll
            for (int j = 0; j < LC_RUN; ++j) o[j] = ((const int*)ap)[j0 + j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < LC_RUN; ++j) o[j] = ((const float*)ap)[j0 + j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < LC_RUN; ++j) o[j] = Q ? (C)0 : (C)st.f[0];
      }
      if constexpr (Q) lc_q_step(code, v, o, st, bits);
      else lc_float_step(code, v, o, st, bits);
      st = next;
    }
    if (vec_out && j0 + LC_RUN <= len) {
      LcVec<T> r;
#pragma unroll
      for (int j = 0; j < LC_RUN; ++j) r.v[j] = (T)v[j];
      *(LcVec<T>*)(out + j0) = r;
    } else {
      for (int j = 0; j < LC_RUN && j0 + j < len; ++j) out[j0 + j] = (T)v[j];
    }
  }
}

// The launch floor: an empty kernel with the same parameter block.
__global__ void lc_empty_kernel(const LcArgs a) {}

template <typename T, bool Q>
static int lc_run(const LcArgs& a, const LcPlan& p, cudaStream_t s) {
  static int granted[2][HP_MAX_DEVICES] = {};
  const bool few = a.n_ops <= LC_FEW_OPS;
  void (*kernel)(LcArgs) = few ? lc_kernel<T, Q, LC_FEW_OPS> : lc_kernel<T, Q, LC_MAX_OPS>;
  const int e = hp_grant_smem((const void*)kernel, p.smem, granted[few]);
  if (e) return e;
  kernel<<<p.blocks, p.threads, p.smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The layout the wrapper's ctypes and numpy mirrors must match, read once
// per load: sizes and an offset of each struct, then the limits.
extern "C" void lc_layout(int* out) {
  out[0] = (int)sizeof(LcChain);
  out[1] = (int)offsetof(LcChain, n_stages);
  out[2] = (int)sizeof(LcPlan);
  out[3] = (int)offsetof(LcPlan, op);
  out[4] = (int)sizeof(LcStage);
  out[5] = LC_MAX_STAGES;
  out[6] = LC_MAX_ARR;
}

// One chain call over `total` elements of rows of `n`: `chain` and `plan`
// as packed by the wrapper, `arr` the plan's n_ops - 1 extras.  The
// stream's dtype is plan->op[0].dt.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int lc_launch(const LcChain* chain, const LcPlan* plan, const void* x,
                         void* out, const void* const* arr, long long total, int n,
                         void* stream) {
  if (plan->n_ops < 1 || plan->n_ops > LC_MAX_OPS || chain->n_stages > LC_MAX_STAGES ||
      chain->table_bytes != ((chain->n_stages * (int)sizeof(LcStage) + 15) & ~15) || n < 1)
    return (int)cudaErrorInvalidValue;
  LcArgs a = {};
  a.table = chain->table;
  a.vecs = chain->vecs;
  a.out = out;
  a.total = total;
  a.n = n;
  a.n_stages = chain->n_stages;
  a.bits = chain->bits;
  a.table_bytes = chain->table_bytes;
  a.vec_bytes = chain->vec_bytes;
  a.chunk = plan->chunk;
  a.n_ops = plan->n_ops;
  a.vec_at = plan->vec_at;
  for (int k = 0; k < plan->n_ops; ++k) {
    const LcOp& o = plan->op[k];
    if (o.dt < DT_F32 || o.dt > DT_I16 || o.head < 0 || o.head > plan->chunk)
      return (int)cudaErrorInvalidValue;
    const int lg = o.dt == DT_I8 ? 0 : (o.dt == DT_I16 ? 1 : 2);
    a.op[k] = {k == 0 ? x : arr[k - 1], o.off + o.sh, o.dt | lg << 4 | o.head << 8};
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int dt = plan->op[0].dt;
  if (!chain->quantized)
    return dt == DT_F32 ? lc_run<float, false>(a, *plan, s) : (int)cudaErrorInvalidValue;
  switch (dt) {
    case DT_I8: return lc_run<int8_t, true>(a, *plan, s);
    case DT_I16: return lc_run<int16_t, true>(a, *plan, s);
    case DT_I32: return lc_run<int32_t, true>(a, *plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch of the empty kernel with the chain kernels' parameter block.
extern "C" int lc_launch_empty(void* stream) {
  LcArgs a = {};
  lc_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
