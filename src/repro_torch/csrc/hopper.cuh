// Hopper (sm_90a) building blocks shared by the kernels of csrc/: cp.async
// copies (gemv.cu, spmv.cu, decode_attention.cu, flash_attention.cu),
// mbarriers, TMA tile loads and 1-D bulk copies (megakernel.cu),
// the wgmma shared-memory descriptor for the 128-byte swizzle, the wgmma
// fences, the m64nNk16 bf16 -> fp32 instructions (A from shared memory or
// from registers), the encoding of a CUtensorMap on the host, and the
// per-device grant of dynamic shared memory.
//
// Layouts.  Every tile these kernels hand to wgmma is a stack of 128-byte
// rows (64 bf16) with the 128-byte swizzle: in each 1024-byte atom of 8 rows
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8).  TMA writes it so
// with CU_TENSOR_MAP_SWIZZLE_128B; a thread that stages a tile itself writes
// the same layout through hp_swz.  Tiles start on 1024-byte boundaries.
//   * K-major operand (the contraction runs along the 128-byte row): rows
//     are the M (or N) index; a k16 step advances the start address by 32
//     bytes inside the row; 8-row groups are 1024 bytes apart (SBO).
//   * MN-major operand (B with N contiguous, read through the transpose
//     bit): rows are the K index, 64 N values each; a k16 step advances by
//     16 rows (2048 bytes); 8-row groups of K are 1024 bytes apart (SBO) and
//     the next 64 N values sit in the next block of rows (LBO).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// ------------------------------------------------------------ addresses
__device__ __forceinline__ uint32_t hp_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col) of a 128-byte-swizzled tile of bf16
// rows (col < 64).
__device__ __forceinline__ uint32_t hp_swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// -------------------------------------------------------------- cp.async
// Asynchronous copies of 4 or 16 bytes from device to shared memory (both
// addresses aligned to the size); with `ok` false nothing is read and the
// bytes are zeroed, so `src` need only be a valid address.  A thread's
// copies since its last commit form a group; hp_cp_wait<N> waits until at
// most N of its groups are still in flight.
__device__ __forceinline__ void hp_cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(hp_smem(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void hp_cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(hp_smem(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void hp_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void hp_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void hp_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(hp_smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void hp_bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void hp_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(hp_smem(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void hp_bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(hp_smem(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase differs from `parity`.  A wait that lasts
// beyond HP_WAIT_CYCLES of the SM clock (about 10 s) traps: a pipeline
// whose counts are wrong faults the launch instead of hanging the card.
#define HP_WAIT_CYCLES 20000000000LL
__device__ __forceinline__ void hp_bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = hp_smem(bar);
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > HP_WAIT_CYCLES) __trap();
  }
}

// Make this thread's plain shared-memory stores visible to the async proxy
// (wgmma, TMA) before it signals a barrier.
__device__ __forceinline__ void hp_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ TMA loads
// One contiguous copy of `bytes` (a multiple of 16; both addresses on 16
// bytes) from global to shared memory, completed on `bar` like a TMA load.
__device__ __forceinline__ void hp_bulk_load(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(hp_smem(dst)), "l"(src), "r"(bytes), "r"(hp_smem(bar)) : "memory");
}

__device__ __forceinline__ void hp_tma_2d(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(hp_smem(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(hp_smem(bar)), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void hp_tma_4d(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(hp_smem(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(hp_smem(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1 in bits
// 62-63); the byte offsets are stored in 16-byte units.
__device__ __forceinline__ uint64_t hp_desc(const void* tile, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((hp_smem(tile) & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void hp_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void hp_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void hp_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of a wgmma accumulator
// across the fences and waits above.
template <int R>
__device__ __forceinline__ void hp_fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int DEC>
__device__ __forceinline__ void hp_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(DEC));
}

template <int INC>
__device__ __forceinline__ void hp_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(INC));
}

// d (64 x N, fp32, the accumulator fragment of one warpgroup) += A (64 x 16,
// bf16) . B (16 x N, bf16), or = when scale_d is 0; with F16, A and B are
// fp16 (the same layouts and rate).  _ss (N = 16, 32, 64, 128)
// reads A from shared memory through descriptor da (K-major); _rs (N = 64,
// 128, 256: the flash kernel's head widths) takes A from registers, in
// the accumulator fragment's layout (a[0]: row g, k 2c..2c+1; a[1]: row g+8;
// a[2]: row g, k 2c+8..; a[3]: row g+8, k 2c+8.., with g = lane / 4 + 16 *
// warp, c = lane % 4).  TB is the transpose bit of B: 0 K-major, 1
// MN-major.  The accumulator's element i of thread (warp w, lane) is row
// 16 w + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.

#define HP_WGMMA_SS_N16_ASM(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7" \
  "}, %8, %9, p, 1, 1, 0, %11;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
  : "l"(da), "l"(db), "r"(scale_d), "n"(TB))
template <int TB, bool F16 = false>
__device__ __forceinline__ void hp_wgmma_ss_n16(float (&d)[8], uint64_t da,
                                                uint64_t db, int scale_d) {
  if constexpr (F16) HP_WGMMA_SS_N16_ASM("f16");
  else HP_WGMMA_SS_N16_ASM("bf16");
}

#define HP_WGMMA_SS_N32_ASM(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15" \
  "}, %16, %17, p, 1, 1, 0, %19;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
  : "l"(da), "l"(db), "r"(scale_d), "n"(TB))
template <int TB, bool F16 = false>
__device__ __forceinline__ void hp_wgmma_ss_n32(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  if constexpr (F16) HP_WGMMA_SS_N32_ASM("f16");
  else HP_WGMMA_SS_N32_ASM("bf16");
}

#define HP_WGMMA_SS_N64_ASM(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" \
  "}, %32, %33, p, 1, 1, 0, %35;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
  : "l"(da), "l"(db), "r"(scale_d), "n"(TB))
template <int TB, bool F16 = false>
__device__ __forceinline__ void hp_wgmma_ss_n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  if constexpr (F16) HP_WGMMA_SS_N64_ASM("f16");
  else HP_WGMMA_SS_N64_ASM("bf16");
}

#define HP_WGMMA_RS_N64_ASM(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), \
  "n"(TB))
template <int TB, bool F16 = false>
__device__ __forceinline__ void hp_wgmma_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  if constexpr (F16) HP_WGMMA_RS_N64_ASM("f16");
  else HP_WGMMA_RS_N64_ASM("bf16");
}

#define HP_WGMMA_SS_N128_ASM(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" \
  "}, %64, %65, p, 1, 1, 0, %67;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
  : "l"(da), "l"(db), "r"(scale_d), "n"(TB))
template <int TB, bool F16 = false>
__device__ __forceinline__ void hp_wgmma_ss_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  if constexpr (F16) HP_WGMMA_SS_N128_ASM("f16");
  else HP_WGMMA_SS_N128_ASM("bf16");
}

#define HP_WGMMA_RS_N128_ASM(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), \
  "n"(TB))
template <int TB, bool F16 = false>
__device__ __forceinline__ void hp_wgmma_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  if constexpr (F16) HP_WGMMA_RS_N128_ASM("f16");
  else HP_WGMMA_RS_N128_ASM("bf16");
}

#define HP_WGMMA_RS_N256_ASM(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127" \
  "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), \
  "n"(TB))
template <int TB, bool F16 = false>
__device__ __forceinline__ void hp_wgmma_rs_n256(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  if constexpr (F16) HP_WGMMA_RS_N256_ASM("f16");
  else HP_WGMMA_RS_N256_ASM("bf16");
}

template <int N, int TB, bool F16 = false>
__device__ __forceinline__ void hp_wgmma_ss(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "hp_wgmma_ss: N is 16, 32, 64 or 128");
  if constexpr (N == 16) hp_wgmma_ss_n16<TB, F16>(d, da, db, scale_d);
  else if constexpr (N == 32) hp_wgmma_ss_n32<TB, F16>(d, da, db, scale_d);
  else if constexpr (N == 64) hp_wgmma_ss_n64<TB, F16>(d, da, db, scale_d);
  else hp_wgmma_ss_n128<TB, F16>(d, da, db, scale_d);
}

template <int N, int TB, bool F16 = false>
__device__ __forceinline__ void hp_wgmma_rs(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256,
                "hp_wgmma_rs: N is 64, 128 or 256");
  if constexpr (N == 64) hp_wgmma_rs_n64<TB, F16>(d, a, db, scale_d);
  else if constexpr (N == 128) hp_wgmma_rs_n128<TB, F16>(d, a, db, scale_d);
  else hp_wgmma_rs_n256<TB, F16>(d, a, db, scale_d);
}

// ------------------------------------------------------------- host side
// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint) so
// that the libraries link against the CUDA runtime alone.
typedef CUresult (*HpEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// A launch function's error when cuTensorMapEncodeTiled refuses a tensor
// map: HP_ENCODE_ERROR + the CUresult (distinct from the runtime's codes).
#define HP_ENCODE_ERROR 100000

static inline HpEncodeTiled hp_encoder() {
  static HpEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<HpEncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first; strides in bytes
// of dimensions 1.., each a multiple of 16), boxes of `box` elements stored
// with the 128-byte swizzle; reads outside the tensor fill zeros.  Returns
// 0 or an error code.
static inline int hp_encode_bf16(CUtensorMap* map, const void* base, int rank,
                                 const uint64_t* dims, const uint64_t* strides,
                                 const uint32_t* box) {
  HpEncodeTiled fn = hp_encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                  const_cast<void*>(base), (const cuuint64_t*)dims,
                  (const cuuint64_t*)strides, (const cuuint32_t*)box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : HP_ENCODE_ERROR + (int)r;
}

// Grant `kernel` `bytes` of dynamic shared memory on the current device,
// once per device: the attribute is per device, so a grant made on one
// card does not carry to another.  `granted` is the caller's table, one
// per kernel.  Returns 0 or the CUDA error.
#define HP_MAX_DEVICES 64
static inline int hp_grant_smem(const void* kernel, int bytes,
                                 int (&granted)[HP_MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= HP_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (granted[dev] >= bytes) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return (int)e;
  granted[dev] = bytes;
  return 0;
}
