// Shared by the port's CUDA kernels (megakernel.cu, linear_chain.cu): the
// stage codes of the packed tables, the I/O dtype codes, the integer and
// float helpers that give XLA's semantics bit for bit, and one stage of the
// float and fixed-point pipeline vocabularies (kernels/ref.py).
//
// Integer products, sums and left shifts are done on uint32_t and cast back
// (they wrap like XLA's int32); right shifts are arithmetic; rounding to the
// nearest even uses rintf; requantize keeps the 24-bit right-shift cap, the
// 30 - lsh clamp and the +-q_max saturation.  Build without
// --use_fast_math (expf/tanhf, not __expf).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

enum {
  ST_SCALAR_MUL = 0, ST_ADD_VEC = 1, ST_SUB_VEC = 2, ST_HAD_VEC = 3,
  ST_TANH = 4, ST_SIGMOID = 5, ST_RELU = 6, ST_EXP = 7, ST_ADD_ARR = 8,
  ST_SUB_ARR = 9, ST_HAD_ARR = 10,
  ST_Q_SCALAR_MUL = 16, ST_Q_ADD_VEC = 17, ST_Q_SUB_VEC = 18,
  ST_Q_HAD_VEC = 19, ST_Q_ADD_ARR = 20, ST_Q_SUB_ARR = 21, ST_Q_HAD_ARR = 22,
  ST_Q_UNARY = 23
};

enum { DT_F32 = 0, DT_I32 = 1, DT_I8 = 2, DT_I16 = 3 };

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int shl(int a, int s) {
  return (int)((uint32_t)a << s);
}
// plain arithmetic align shift: left if s >= 0, else arithmetic right
__device__ __forceinline__ int align_shift(int x, int s) {
  return s >= 0 ? shl(x, s) : (x >> (-s));
}

// quantize/requantize.requantize_core (and requantize_rows, element-wise)
__device__ __forceinline__ int requant(int acc, int shift, int bits) {
  if (shift > 0) {
    int s = min(shift, 24);
    acc = wrap_add(acc, 1 << (s - 1)) >> s;
  } else if (shift < 0) {
    int lsh = min(-shift, bits);
    int b = 1 << (30 - lsh);
    acc = shl(max(-b, min(acc, b)), lsh);
  }
  int qm = (1 << (bits - 1)) - 1;
  return max(-qm, min(acc, qm));
}

// quantize.quantize_core: round half to even, saturate; NaN stays NaN
// through the clamp (as torch.clamp) and converts to 0.
__device__ __forceinline__ int quant(float y, float scale, int bits) {
  float q = rintf(__fmul_rn(y, scale));
  float qm = (float)((1 << (bits - 1)) - 1);
  if (!isnan(q)) q = fminf(fmaxf(q, -qm), qm);
  return (int)q;
}

__device__ __forceinline__ float unary(int code, float x) {
  switch (code) {
    case 0: return tanhf(x);
    case 1: return 1.0f / (1.0f + expf(-x));
    case 2: return isnan(x) ? x : (x < 0.0f ? 0.0f : x);
    default: return expf(x);
  }
}

__device__ __forceinline__ float load_f(const void* p, int dt, long i) {
  switch (dt) {
    case DT_F32: return ((const float*)p)[i];
    case DT_I32: return (float)((const int*)p)[i];
    case DT_I8: return (float)((const int8_t*)p)[i];
    default: return (float)((const int16_t*)p)[i];
  }
}
__device__ __forceinline__ int load_i(const void* p, int dt, long i) {
  switch (dt) {
    case DT_F32: return (int)((const float*)p)[i];
    case DT_I32: return ((const int*)p)[i];
    case DT_I8: return (int)((const int8_t*)p)[i];
    default: return (int)((const int16_t*)p)[i];
  }
}

__device__ __forceinline__ bool stage_reads_vec(int st) {
  return st == ST_ADD_VEC || st == ST_SUB_VEC || st == ST_HAD_VEC ||
         st == ST_Q_ADD_VEC || st == ST_Q_SUB_VEC || st == ST_Q_HAD_VEC;
}
__device__ __forceinline__ bool stage_reads_arr(int st) {
  return st == ST_ADD_ARR || st == ST_SUB_ARR || st == ST_HAD_ARR ||
         st == ST_Q_ADD_ARR || st == ST_Q_SUB_ARR || st == ST_Q_HAD_ARR;
}

// One float stage (ref.apply_stage).  `o` is the stage's scalar, vec
// element or arr element.  __fmul_rn/__fadd_rn keep a multiply and a
// following add from being contracted into one rounding.
__device__ __forceinline__ float float_stage(int st, float x, float o) {
  switch (st) {
    case ST_SCALAR_MUL: case ST_HAD_VEC: case ST_HAD_ARR: return __fmul_rn(x, o);
    case ST_ADD_VEC: case ST_ADD_ARR: return __fadd_rn(x, o);
    case ST_SUB_VEC: case ST_SUB_ARR: return __fsub_rn(x, o);
    case ST_TANH: return tanhf(x);
    case ST_SIGMOID: return 1.0f / (1.0f + expf(-x));
    case ST_RELU: return unary(2, x);
    default: return expf(x);                                 // ST_EXP
  }
}

// One fixed-point stage on the int32 carrier (ref.apply_stage_q).  `o` is
// the vec or arr element; p0..p2 are the stage's static fields (q_scalar_mul:
// c, rq; q_add/q_sub: sa, sb, rq; q_hadamard: -, -, rq; q_unary: the unary
// code), s_in/s_out q_unary's dequantize and quantize scales.
__device__ __forceinline__ int q_stage(int st, int x, int o, int p0, int p1,
                                       int p2, float s_in, float s_out,
                                       int bits) {
  switch (st) {
    case ST_Q_SCALAR_MUL: return requant(wrap_mul(x, p0), p1, bits);
    case ST_Q_ADD_VEC: case ST_Q_ADD_ARR:
      return requant(wrap_add(align_shift(x, p0), align_shift(o, p1)), p2, bits);
    case ST_Q_SUB_VEC: case ST_Q_SUB_ARR:
      return requant(wrap_sub(align_shift(x, p0), align_shift(o, p1)), p2, bits);
    case ST_Q_HAD_VEC: case ST_Q_HAD_ARR: return requant(wrap_mul(x, o), p2, bits);
    default:                                                 // ST_Q_UNARY
      return quant(unary(p0, __fmul_rn((float)x, s_in)), s_out, bits);
  }
}
