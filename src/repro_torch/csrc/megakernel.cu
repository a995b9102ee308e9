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
//   * grid = (nb,): one block per sample, on the caller's stream.  The
//     per-sample lane is the same kernel at nb = 1, so both lanes run the
//     same code with the same reduction order and agree bit for bit.
//   * The register file (exact-width slots) lives in dynamic shared memory,
//     one 32-bit word per value (int32 carrier on the integer lanes,
//     float32 on the float lane), plus a scratch row for MATVEC/SQL2
//     results (a destination slot may reuse its source's slot).
//   * MATVEC/SPMV/SQL2: one thread per output row, summing over k in index
//     order.  MATVEC matrices are packed transposed (k-major) so that the
//     threads of a warp read neighbouring words.  SPMV is the dense-with-
//     zeros opcode of the reference.
//   * LOAD_MAT is a no-op: matrices are read from global memory, where a
//     whole pool (< 1 MB for every Table-I program) stays in L2.  Staging
//     them through cp.async/TMA into shared memory is later work.
//   * ARGMAX/REDUCE/DOT run on one thread in index order.
//
// Bound: a bucket moves well under 1 MB (inputs, outputs, matrices once
// through L2), so at 3.35 TB/s the byte bound is well below a microsecond;
// the launch latency and the serial instruction walk (one __syncthreads
// per instruction) bound this kernel, not bytes or operations.
//
// Integer semantics follow XLA's bit for bit: products, sums and left
// shifts are done on uint32_t and cast back (they wrap like XLA's int32),
// right shifts are arithmetic, rounding to the nearest even uses rintf,
// requantize keeps the 24-bit right-shift cap, the 30-lsh clamp and the
// ±q_max saturation.  Float sums use __fmul_rn/__fadd_rn so that no
// multiply-add is contracted: each term is rounded twice, as in the plain
// PyTorch version.  Build without --use_fast_math (expf/tanhf, not __expf).

#include "fixed_point.cuh"

#define MK_NI 12        // int32 fields per instruction
#define MK_NF 4         // float fields per instruction
#define MK_MAX_IO 16

enum {
  OP_LOAD_IN = 0, OP_LOAD_CONST = 1, OP_MATVEC = 2, OP_REQ_T = 3,
  OP_REQ_ROWS = 4, OP_ARGMAX = 5, OP_REDUCE = 6, OP_SQL2 = 7, OP_DOT = 8,
  OP_ELEM = 9, OP_STORE = 10
};

struct MkIO {
  const void* in[MK_MAX_IO];
  void* out[MK_MAX_IO];
  int in_dtype[MK_MAX_IO];
  int in_width[MK_MAX_IO];
  int out_dtype[MK_MAX_IO];
  int out_width[MK_MAX_IO];
};

__global__ void mk_segment_kernel(const int* __restrict__ instrs,
                                  const float* __restrict__ fparams,
                                  int n_instr,
                                  const int* __restrict__ consts_i,
                                  const int* __restrict__ mats_i,
                                  int quantized, int bits, int scratch_off,
                                  MkIO io) {
  extern __shared__ int reg_i[];
  float* reg_f = (float*)reg_i;
  const float* consts_f = (const float*)consts_i;
  const float* mats_f = (const float*)mats_i;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int p = 0; p < n_instr; ++p) {
    const int* f = instrs + p * MK_NI;
    const float* g = fparams + p * MK_NF;
    const int op = f[0], dst = f[1], s0 = f[2], s1 = f[3], n = f[4], k = f[5];
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
      case OP_MATVEC: {
        // matrix packed transposed: element (r, j) at mat + j * n + r
        const int mat = f[6], bias = f[7];
        for (int r = tid; r < n; r += nt) {
          if (quantized) {
            uint32_t acc = 0u;
            for (int j = 0; j < k; ++j)
              acc += (uint32_t)mats_i[mat + j * n + r] * (uint32_t)reg_i[s0 + j];
            int a = (int)acc;
            if (bias >= 0) a = wrap_add(a, consts_i[bias + r]);
            reg_i[scratch_off + r] = a;
          } else {
            float acc = 0.0f;
            for (int j = 0; j < k; ++j) {
              float t = __fmul_rn(mats_f[mat + j * n + r], reg_f[s0 + j]);
              acc = j == 0 ? t : __fadd_rn(acc, t);
            }
            if (bias >= 0) acc = __fadd_rn(acc, consts_f[bias + r]);
            reg_f[scratch_off + r] = acc;
          }
        }
        __syncthreads();
        for (int r = tid; r < n; r += nt) reg_i[dst + r] = reg_i[scratch_off + r];
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
        if (tid == 0) {
          int best_i = 0;
          if (quantized) {
            int best = reg_i[s0];
            for (int j = 1; j < k; ++j)
              if (reg_i[s0 + j] > best) { best = reg_i[s0 + j]; best_i = j; }
            reg_i[dst] = best_i;
          } else {
            float best = reg_f[s0];
            for (int j = 1; j < k; ++j) {
              float v = reg_f[s0 + j];
              if (!isnan(best) && (isnan(v) || v > best)) { best = v; best_i = j; }
            }
            reg_f[dst] = (float)best_i;
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
      case OP_SQL2: {
        // points (d = k, m = n) row-major: element (i, c) at mat + i * n + c
        const int mat = f[6], flags = f[9];
        for (int c = tid; c < n; c += nt) {
          float acc = 0.0f;
          for (int i = 0; i < k; ++i) {
            float x = (flags & 1) ? __fmul_rn((float)reg_i[s0 + i], g[1]) : reg_f[s0 + i];
            float d = __fsub_rn(mats_f[mat + i * n + c], x);
            float t = __fmul_rn(d, d);
            acc = i == 0 ? t : __fadd_rn(acc, t);
          }
          if (flags & 4) reg_i[scratch_off + c] = quant(acc, g[3], bits);
          else reg_f[scratch_off + c] = acc;
        }
        __syncthreads();
        for (int c = tid; c < n; c += nt) reg_i[dst + c] = reg_i[scratch_off + c];
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
        const int stage = f[8], vec = f[7], olen = f[5];
        const int p0 = f[9], p1 = f[10], p2 = f[11];
        const bool v = stage_reads_vec(stage), a = stage_reads_arr(stage);
        for (int i = tid; i < n; i += nt) {
          const int oi = olen == 1 ? 0 : i;
          if (stage < ST_Q_SCALAR_MUL) {
            const float o = v ? consts_f[vec + oi] : a ? reg_f[s1 + oi] : g[0];
            reg_f[dst + i] = float_stage(stage, reg_f[s0 + i], o);
          } else {
            const int o = v ? consts_i[vec + oi] : a ? reg_i[s1 + oi] : 0;
            reg_i[dst + i] = q_stage(stage, reg_i[s0 + i], o, p0, p1, p2, g[1],
                                     g[3], bits);
          }
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
    __syncthreads();
  }
}

extern "C" int mk_max_io() { return MK_MAX_IO; }

// Launch one bucket.  Host arrays describe the inputs and outputs; every
// pointer is a device pointer except the arrays themselves.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int mk_launch(const void* instrs, const void* fparams, int n_instr,
                         const void* consts, const void* mats, int quantized,
                         int bits, int scratch_off, int smem_words,
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
      (const int*)mats, quantized, bits, scratch_off, io);
  return (int)cudaGetLastError();
}
