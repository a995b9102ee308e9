// Whole-program megakernel for Hopper (sm_90a): one launch runs a whole
// linearized MAFIA program for a bucket of samples.
//
// Replaces the TPU kernel `kernels/megakernel.py::_segment_kernel` of the
// JAX package (src/repro/kernels/megakernel.py:230), launched there by
// `_build_launch` :371 (per sample) and `_build_launch_grid` :409 (bucket
// on the Pallas grid).  The Pallas kernel unrolls the instruction stream
// at trace time; here one generic interpreter walks a packed instruction
// table instead, so every program and precision shares one binary (no
// per-program compile).
//
// Design:
//   * grid = (nb,): one block of 256 threads per sample, on the caller's
//     stream.  The per-sample lane is the same kernel at nb = 1, so both
//     lanes run the same code with the same reduction order and agree bit
//     for bit.
//   * Shared memory holds the instruction table (read once per launch, so
//     decoding an instruction costs no global load), the register file
//     (exact-width slots, one 32-bit word per value: int32 carrier on the
//     integer lanes, float32 on the float lane), a scratch row for
//     MATVEC/SQL2 results whose destination overlaps their source, and two
//     matrix buffers.
//   * LOAD_MAT is the reference's DMA (src/repro/kernels/megakernel.py:17,
//     56, 286): one thread starts a bulk copy (the TMA engine's 1-D
//     cp.async.bulk) of matrix mi into one of two buffers, sized by the
//     packer from the segment's largest matrix within what a block can
//     have, completed on that buffer's mbarrier.  The lowering issues
//     LOAD_MAT[k] just before MATVEC[k-1], so a matrix's copy overlaps the
//     instruction before it; the MATVEC/SPMV/SQL2 that reads it waits on
//     the mbarrier's phase (the packer counts the parities).  A matrix
//     larger than a buffer streams through the buffer's two halves in
//     chunks of columns (packed chunk by chunk as a half holds them), each
//     half on its own mbarrier, the next chunk loading while this one
//     computes; one whose rows do not fit even so is read from global
//     memory.
//   * MATVEC/SPMV/SQL2: one thread per output row, summing over k in index
//     order from 16-byte loads of 4 weights and 4 inputs, the next 8 steps'
//     operands in flight while this 8 add, so a row's chain is bound by its
//     dependent adds.  Matrices are packed row-major (SQL2's points
//     transposed to a row per point), rows padded to 16 bytes (and to an
//     odd number of 16-byte words from 64 values up, against bank
//     conflicts); register slots start on 16 bytes.  SPMV is the
//     dense-with-zeros opcode of the reference.
//   * A barrier only where it is needed: the packer marks each instruction
//     that touches a word another thread wrote or read since the last
//     barrier, or whose copy would overwrite a buffer still being read
//     (MK_SYNC), and each MATVEC/SQL2 whose destination does not overlap
//     its source writes it directly (MK_DIRECT).
//   * ARGMAX runs on warp 0 (strided walks, then a butterfly of (value,
//     index) pairs: the first NaN, else the first maximum, as the one-thread
//     walk); REDUCE and DOT stay on one thread, since their float sums must
//     keep their index order.
//
// Bound: a bucket moves well under 1 MB (inputs, outputs, matrices once),
// so at 3.35 TB/s the byte bound is well below a microsecond; the launch,
// each block's copy of the matrices from L2 and the longest row chain (k
// dependent adds) bound this kernel.
//
// Integer semantics follow XLA's bit for bit: products, sums and left
// shifts are done on uint32_t and cast back (they wrap like XLA's int32),
// right shifts are arithmetic, rounding to the nearest even uses rintf,
// requantize keeps the 24-bit right-shift cap, the 30-lsh clamp and the
// ±q_max saturation.  Float sums use __fmul_rn/__fadd_rn so that no
// multiply-add is contracted: each term is rounded twice, as in the plain
// PyTorch version.  Build without --use_fast_math (expf/tanhf, not __expf).

#include "fixed_point.cuh"
#include "hopper.cuh"

#define MK_NI 16        // int32 fields per instruction
#define MK_NF 4         // float fields per instruction
#define MK_MAX_IO 16
#define MK_MAXR 4       // rows a thread keeps over the halves of a streamed matrix

enum {
  OP_LOAD_IN = 0, OP_LOAD_CONST = 1, OP_MATVEC = 2, OP_REQ_T = 3,
  OP_REQ_ROWS = 4, OP_ARGMAX = 5, OP_REDUCE = 6, OP_SQL2 = 7, OP_DOT = 8,
  OP_ELEM = 9, OP_STORE = 10, OP_LOAD_MAT = 11
};

// f[12]: flags; f[13]: a matrix's k-row pitch in words; f[14]: its buffer
// (-1: global memory); f[15]: the phase parities its reader waits for on
// the buffer's two mbarriers (bit 0: the first half or the whole matrix,
// bit 1: the second half of a streamed one).
enum { MK_SYNC = 1, MK_DIRECT = 2, MK_STREAM = 4 };

struct MkIO {
  const void* in[MK_MAX_IO];
  void* out[MK_MAX_IO];
  int in_dtype[MK_MAX_IO];
  int in_width[MK_MAX_IO];
  int out_dtype[MK_MAX_IO];
  int out_width[MK_MAX_IO];
};

// The row chains, each over j = 0 .. k-1 in index order, w the row's k
// values and x the input slot, both on 16 bytes: 4 steps' operands per
// 16-byte load.  MATVEC float: each product and each sum rounded once (acc
// starts at -0, so the first sum is the first product exactly); integer:
// wrapping uint32; SQL2: acc += (w_i - x_i)^2, x_i dequantized by `sc`
// from the int carrier where `deq`.
#define MK_STEPS4(ACC, W4, X4, STEP)                                           \
  ACC = STEP(ACC, W4.x, X4.x); ACC = STEP(ACC, W4.y, X4.y);                    \
  ACC = STEP(ACC, W4.z, X4.z); ACC = STEP(ACC, W4.w, X4.w);

__device__ __forceinline__ float mk_step_f(float a, float w, float v) {
  return __fadd_rn(a, __fmul_rn(w, v));
}
__device__ __forceinline__ float mk_step_l2(float a, float p, float v) {
  const float d = __fsub_rn(p, v);
  return __fadd_rn(a, __fmul_rn(d, d));
}

// Each chain keeps the next 8 steps' operands in flight while it adds this
// 8 (a dependent add takes 4-5 cycles, a shared load about 30).
template <typename T, typename V, typename Step>
__device__ __forceinline__ T mk_row(T acc, const T* w, const T* x, int k, Step step) {
  int j = 0;
  if (k >= 16) {
    V a0 = *reinterpret_cast<const V*>(w), a1 = *reinterpret_cast<const V*>(w + 4);
    V b0 = *reinterpret_cast<const V*>(x), b1 = *reinterpret_cast<const V*>(x + 4);
    for (; j + 16 <= k; j += 16) {
      const V c0 = *reinterpret_cast<const V*>(w + j + 8);
      const V c1 = *reinterpret_cast<const V*>(w + j + 12);
      const V d0 = *reinterpret_cast<const V*>(x + j + 8);
      const V d1 = *reinterpret_cast<const V*>(x + j + 12);
      MK_STEPS4(acc, a0, b0, step)
      MK_STEPS4(acc, a1, b1, step)
      if (j + 24 <= k) {
        a0 = *reinterpret_cast<const V*>(w + j + 16);
        a1 = *reinterpret_cast<const V*>(w + j + 20);
        b0 = *reinterpret_cast<const V*>(x + j + 16);
        b1 = *reinterpret_cast<const V*>(x + j + 20);
      }
      MK_STEPS4(acc, c0, d0, step)
      MK_STEPS4(acc, c1, d1, step)
    }
    if (j + 8 <= k) {
      MK_STEPS4(acc, a0, b0, step)
      MK_STEPS4(acc, a1, b1, step)
      j += 8;
    }
  }
  for (; j < k; ++j) acc = step(acc, w[j], x[j]);
  return acc;
}

__device__ __forceinline__ float mk_row_f(float acc, const float* w, const float* x, int k) {
  return mk_row<float, float4>(acc, w, x, k, mk_step_f);
}

__device__ __forceinline__ uint32_t mk_row_i(uint32_t acc, const int* w, const int* x, int k) {
  return mk_row<uint32_t, uint4>(acc, reinterpret_cast<const uint32_t*>(w),
                                 reinterpret_cast<const uint32_t*>(x), k,
                                 [](uint32_t a, uint32_t wv, uint32_t xv) { return a + wv * xv; });
}

__device__ __forceinline__ float mk_deq(const int* xi, int j, bool deq, float sc) {
  return deq ? __fmul_rn((float)xi[j], sc) : ((const float*)xi)[j];
}

__device__ __forceinline__ float4 mk_deq4(const int* xi, int j, bool deq, float sc) {
  if (!deq) return *reinterpret_cast<const float4*>(xi + j);
  const int4 q = *reinterpret_cast<const int4*>(xi + j);
  return make_float4(__fmul_rn((float)q.x, sc), __fmul_rn((float)q.y, sc),
                     __fmul_rn((float)q.z, sc), __fmul_rn((float)q.w, sc));
}

__device__ __forceinline__ float mk_row_l2(float acc, const float* p, const int* xi,
                                           bool deq, float sc, int k) {
  int j = 0;
  if (k >= 8) {
    float4 a0 = *reinterpret_cast<const float4*>(p), b0 = mk_deq4(xi, 0, deq, sc);
    for (; j + 8 <= k; j += 4) {
      const float4 c0 = *reinterpret_cast<const float4*>(p + j + 4);
      const float4 d0 = mk_deq4(xi, j + 4, deq, sc);
      MK_STEPS4(acc, a0, b0, mk_step_l2)
      a0 = c0;
      b0 = d0;
    }
    MK_STEPS4(acc, a0, b0, mk_step_l2)
    j += 4;
  }
  for (; j < k; ++j) acc = mk_step_l2(acc, p[j], mk_deq(xi, j, deq, sc));
  return acc;
}

// Warp 0's argmax over k values: the first NaN if there is one, else the
// first maximum (the order of the one-thread walk it replaces).  Each lane
// walks j = lane, lane + 32, ..., then a butterfly keeps the better of two
// (value, index) pairs, which is a total order, so every lane ends equal.
__device__ __forceinline__ int mk_argmax(const int* reg_i, int s0, int k, bool quantized) {
  const float* reg_f = (const float*)reg_i;
  const int lane = threadIdx.x & 31;
  int bi = -1, bq = 0;
  float bf = 0.0f;
  for (int j = lane; j < k; j += 32) {
    if (quantized) {
      const int v = reg_i[s0 + j];
      if (bi < 0 || v > bq) { bq = v; bi = j; }
    } else {
      const float v = reg_f[s0 + j];
      if (bi < 0 || (!isnan(bf) && (isnan(v) || v > bf))) { bf = v; bi = j; }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    const int oq = __shfl_xor_sync(0xffffffffu, bq, off);
    const float of = __shfl_xor_sync(0xffffffffu, bf, off);
    bool take;
    if (oi < 0) take = false;
    else if (bi < 0) take = true;
    else if (quantized) take = oq > bq || (oq == bq && oi < bi);
    else if (isnan(of) || isnan(bf)) take = isnan(of) && (!isnan(bf) || oi < bi);
    else take = of > bf || (of == bf && oi < bi);
    if (take) { bi = oi; bq = oq; bf = of; }
  }
  return bi < 0 ? 0 : bi;
}

__global__ void mk_segment_kernel(const int* __restrict__ instrs,
                                  const float* __restrict__ fparams,
                                  int n_instr,
                                  const int* __restrict__ consts_i,
                                  const int* __restrict__ mats_i,
                                  int quantized, int bits, int scratch_off,
                                  int buf_off, int bufw, int table_words,
                                  MkIO io) {
  extern __shared__ __align__(16) int smem_i[];
  __shared__ __align__(8) uint64_t mbar[4];       // [buffer][half]
  int* tab = smem_i;                               // the instruction table
  float* tabf = (float*)(smem_i + n_instr * MK_NI);
  int* reg_i = smem_i + table_words;               // register file, scratch
  float* reg_f = (float*)reg_i;
  int* bufs = reg_i + buf_off;                     // [2][bufw] matrices
  const float* consts_f = (const float*)consts_i;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = tid; i < n_instr * MK_NI; i += nt) tab[i] = instrs[i];
  for (int i = tid; i < n_instr * MK_NF; i += nt) tabf[i] = fparams[i];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) hp_bar_init(&mbar[i], 1);
    hp_bar_init_fence();
  }
  __syncthreads();

  for (int p = 0; p < n_instr; ++p) {
    const int* f = tab + p * MK_NI;
    const float* g = tabf + p * MK_NF;
    const int op = f[0], dst = f[1], s0 = f[2], s1 = f[3], n = f[4], k = f[5];
    const int flags = f[12];
    if (flags & MK_SYNC) __syncthreads();
    switch (op) {
      case OP_LOAD_IN: {
        const int ii = f[8];
        const void* src = io.in[ii];
        const int dt = io.in_dtype[ii];
        const long base = (long)b * io.in_width[ii];
        for (int i = tid; i < n; i += nt) {
          if (quantized) reg_i[dst + i] = load_i(src, dt, base + i);
          else reg_f[dst + i] = load_f(src, dt, base + i);
        }
        break;
      }
      case OP_LOAD_CONST: {
        const int c = f[7];
        for (int i = tid; i < n; i += nt) reg_i[dst + i] = consts_i[c + i];
        break;
      }
      case OP_LOAD_MAT:
        // one bulk copy of n words into the buffer (the whole matrix, or the
        // first chunk of a streamed one), completed on its first mbarrier
        if (tid == 0) {
          uint64_t* bar = &mbar[2 * f[14]];
          hp_bar_expect_tx(bar, 4u * n);
          hp_bulk_load(bufs + f[14] * bufw, mats_i + f[6], 4u * n, bar);
        }
        break;
      case OP_MATVEC:
      case OP_SQL2: {
        // row r of the matrix (MATVEC weights; SQL2 point r's coordinates)
        // at r * pitch, its k values contiguous
        const int mat = f[6], pitch = f[13], buf = f[14], par = f[15];
        const bool sql2 = op == OP_SQL2;
        const int qflags = f[9];
        const bool deq = sql2 && (qflags & 1);
        const int out = (flags & MK_DIRECT) ? dst : scratch_off;
        auto finish = [&](int r, uint32_t acc_i, float acc_f) {
          if (sql2) {
            if (qflags & 4) reg_i[out + r] = quant(acc_f, g[3], bits);
            else reg_f[out + r] = acc_f;
          } else if (quantized) {
            const int bias = f[7];
            int a = (int)acc_i;
            if (bias >= 0) a = wrap_add(a, consts_i[bias + r]);
            reg_i[out + r] = a;
          } else {
            const int bias = f[7];
            float acc = acc_f;
            if (bias >= 0) acc = __fadd_rn(acc, consts_f[bias + r]);
            reg_f[out + r] = acc;
          }
        };
        if (flags & MK_STREAM) {
          // chunks of ch columns (packed one after the other, each as n rows
          // of pitch pc) through the two halves of buffer `buf`: the next
          // chunk loads while this one computes
          const int ch = f[10], pc = f[11], half = bufw / 2;
          const int nch = (k + ch - 1) / ch;
          int* B0 = bufs + buf * bufw;
          float af[MK_MAXR];
          uint32_t ai[MK_MAXR];
#pragma unroll
          for (int u = 0; u < MK_MAXR; ++u) { af[u] = -0.0f; ai[u] = 0u; }
          for (int c = 0; c < nch; ++c) {
            const int j0 = c * ch, kk = min(ch, k - j0);
            if (c + 1 < nch && tid == 0) {       // chunk c + 1, laid out as in smem
              uint64_t* bar = &mbar[2 * buf + ((c + 1) & 1)];
              hp_bar_expect_tx(bar, 4u * n * pc);
              hp_bulk_load(B0 + ((c + 1) & 1) * half, mats_i + mat + (c + 1) * n * pc,
                           4u * n * pc, bar);
            }
            hp_bar_wait(&mbar[2 * buf + (c & 1)], ((par >> (c & 1)) + (c >> 1)) & 1);
            const int* W = B0 + (c & 1) * half;
#pragma unroll
            for (int u = 0; u < MK_MAXR; ++u) {
              const int r = tid + u * nt;
              if (r >= n) continue;
              if (sql2) af[u] = mk_row_l2(af[u], (const float*)W + r * pc, reg_i + s0 + j0,
                                          deq, g[1], kk);
              else if (quantized) ai[u] = mk_row_i(ai[u], W + r * pc, reg_i + s0 + j0, kk);
              else af[u] = mk_row_f(af[u], (const float*)W + r * pc, reg_f + s0 + j0, kk);
            }
            __syncthreads();   // the half is free for the copy after next
          }
#pragma unroll
          for (int u = 0; u < MK_MAXR; ++u)
            if (tid + u * nt < n) finish(tid + u * nt, ai[u], af[u]);
        } else if (buf >= 0) {
          hp_bar_wait(&mbar[2 * buf], par & 1);
          const int* W = bufs + buf * bufw;
          for (int r = tid; r < n; r += nt) {
            if (sql2) finish(r, 0u, mk_row_l2(-0.0f, (const float*)W + r * pitch, reg_i + s0,
                                             deq, g[1], k));
            else if (quantized) finish(r, mk_row_i(0u, W + r * pitch, reg_i + s0, k), 0.0f);
            else finish(r, 0u, mk_row_f(-0.0f, (const float*)W + r * pitch, reg_f + s0, k));
          }
        } else {
          const int* W = mats_i + mat;
          for (int r = tid; r < n; r += nt) {
            if (sql2) finish(r, 0u, mk_row_l2(-0.0f, (const float*)W + (long long)r * pitch,
                                             reg_i + s0, deq, g[1], k));
            else if (quantized)
              finish(r, mk_row_i(0u, W + (long long)r * pitch, reg_i + s0, k), 0.0f);
            else
              finish(r, 0u, mk_row_f(-0.0f, (const float*)W + (long long)r * pitch,
                                     reg_f + s0, k));
          }
        }
        if (!(flags & MK_DIRECT)) {
          __syncthreads();
          for (int r = tid; r < n; r += nt) reg_i[dst + r] = reg_i[scratch_off + r];
        }
        break;
      }
      case OP_REQ_T: {
        const int sh = f[9];
        for (int i = tid; i < n; i += nt) reg_i[dst + i] = requant(reg_i[s0 + i], sh, bits);
        break;
      }
      case OP_REQ_ROWS: {
        const int c = f[7];
        for (int i = tid; i < n; i += nt)
          reg_i[dst + i] = requant(reg_i[s0 + i], consts_i[c + i], bits);
        break;
      }
      case OP_ARGMAX: {
        if (tid < 32) {
          const int best_i = mk_argmax(reg_i, s0, k, quantized);
          if (tid == 0) {
            if (quantized) reg_i[dst] = best_i;
            else reg_f[dst] = (float)best_i;
          }
        }
        break;
      }
      case OP_REDUCE: {
        if (tid == 0) {
          const int kind = f[8], flags = f[9];
          float acc = 0.0f;
          for (int j = 0; j < k; ++j) {
            float v = (flags & 1) ? __fmul_rn((float)reg_i[s0 + j], g[1]) : reg_f[s0 + j];
            if (j == 0) acc = v;
            else if (kind == 0) acc = __fadd_rn(acc, v);
            else if (!isnan(acc) && (isnan(v) || (kind == 1 ? v > acc : v < acc))) acc = v;
          }
          if (flags & 4) reg_i[dst] = quant(acc, g[3], bits);
          else reg_f[dst] = acc;
        }
        break;
      }
      case OP_DOT: {
        if (tid == 0) {
          const int flags = f[9];
          float acc = 0.0f;
          for (int j = 0; j < k; ++j) {
            float a = (flags & 1) ? __fmul_rn((float)reg_i[s0 + j], g[1]) : reg_f[s0 + j];
            float c = (flags & 2) ? __fmul_rn((float)reg_i[s1 + j], g[2]) : reg_f[s1 + j];
            float t = __fmul_rn(a, c);
            acc = j == 0 ? t : __fadd_rn(acc, t);
          }
          if (flags & 4) reg_i[dst] = quant(acc, g[3], bits);
          else reg_f[dst] = acc;
        }
        break;
      }
      case OP_ELEM: {
        // the stage is picked once, outside the loop over the elements
        const int stage = f[8], vec = f[7], olen = f[5];
        const int p0 = f[9], p1 = f[10], p2 = f[11];
        const bool v = stage_reads_vec(stage), a = stage_reads_arr(stage);
        auto each_f = [&](auto fn) {
          for (int i = tid; i < n; i += nt) {
            const int oi = olen == 1 ? 0 : i;
            const float o = v ? consts_f[vec + oi] : a ? reg_f[s1 + oi] : g[0];
            reg_f[dst + i] = fn(reg_f[s0 + i], o);
          }
        };
        auto each_q = [&](auto fn) {
          for (int i = tid; i < n; i += nt) {
            const int oi = olen == 1 ? 0 : i;
            const int o = v ? consts_i[vec + oi] : a ? reg_i[s1 + oi] : 0;
            reg_i[dst + i] = fn(reg_i[s0 + i], o);
          }
        };
        auto q_unary = [&](auto un) {
          each_q([&](int x, int) { return quant(un(__fmul_rn((float)x, g[1])), g[3], bits); });
        };
        switch (stage) {
          case ST_SCALAR_MUL: case ST_HAD_VEC: case ST_HAD_ARR:
            each_f([](float x, float o) { return __fmul_rn(x, o); }); break;
          case ST_ADD_VEC: case ST_ADD_ARR:
            each_f([](float x, float o) { return __fadd_rn(x, o); }); break;
          case ST_SUB_VEC: case ST_SUB_ARR:
            each_f([](float x, float o) { return __fsub_rn(x, o); }); break;
          case ST_TANH: each_f([](float x, float) { return unary(0, x); }); break;
          case ST_SIGMOID: each_f([](float x, float) { return unary(1, x); }); break;
          case ST_RELU: each_f([](float x, float) { return unary(2, x); }); break;
          case ST_EXP: each_f([](float x, float) { return unary(3, x); }); break;
          case ST_Q_UNARY:
            if (p0 == 0) q_unary([](float x) { return unary(0, x); });
            else if (p0 == 1) q_unary([](float x) { return unary(1, x); });
            else if (p0 == 2) q_unary([](float x) { return unary(2, x); });
            else q_unary([](float x) { return unary(3, x); });
            break;
          default:
            each_q([&](int x, int o) { return q_stage(stage, x, o, p0, p1, p2, g[1], g[3], bits); });
            break;
        }
        break;
      }
      case OP_STORE: {
        const int oi = f[8];
        const int dt = io.out_dtype[oi];
        const long base = (long)b * io.out_width[oi];
        for (int i = tid; i < n; i += nt) {
          const long at = base + i;
          if (dt == DT_F32) {
            ((float*)io.out[oi])[at] = quantized ? (float)reg_i[s0 + i] : reg_f[s0 + i];
          } else {
            const int v = quantized ? reg_i[s0 + i] : (int)reg_f[s0 + i];
            if (dt == DT_I32) ((int*)io.out[oi])[at] = v;
            else if (dt == DT_I8) ((int8_t*)io.out[oi])[at] = (int8_t)v;
            else ((int16_t*)io.out[oi])[at] = (int16_t)v;
          }
        }
        break;
      }
      default:
        break;
    }
  }
}

extern "C" int mk_max_io() { return MK_MAX_IO; }

// Launch one bucket.  Host arrays describe the inputs and outputs; every
// pointer is a device pointer except the arrays themselves.  Shared memory
// holds the instruction table (table_words), then the register file and
// scratch (buf_off words), then the two matrix buffers of bufw words each
// (smem_words in all).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int mk_launch(const void* instrs, const void* fparams, int n_instr,
                         const void* consts, const void* mats, int quantized,
                         int bits, int scratch_off, int buf_off, int bufw,
                         int table_words, int smem_words,
                         const void* const* in_ptrs, const int* in_dtypes,
                         const int* in_widths, int n_in,
                         void* const* out_ptrs, const int* out_dtypes,
                         const int* out_widths, int n_out,
                         int nb, int threads, void* stream) {
  if (n_in > MK_MAX_IO || n_out > MK_MAX_IO) return (int)cudaErrorInvalidValue;
  MkIO io = {};
  for (int i = 0; i < n_in; ++i) {
    io.in[i] = in_ptrs[i];
    io.in_dtype[i] = in_dtypes[i];
    io.in_width[i] = in_widths[i];
  }
  for (int i = 0; i < n_out; ++i) {
    io.out[i] = out_ptrs[i];
    io.out_dtype[i] = out_dtypes[i];
    io.out_width[i] = out_widths[i];
  }
  size_t smem = (size_t)smem_words * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mk_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mk_segment_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
      (const int*)instrs, (const float*)fparams, n_instr, (const int*)consts,
      (const int*)mats, quantized, bits, scratch_off, buf_off, bufw, table_words, io);
  return (int)cudaGetLastError();
}
