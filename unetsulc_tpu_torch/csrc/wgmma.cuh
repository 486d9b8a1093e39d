// Hopper (sm_90a) building blocks for kernels A, C and D and the probe's dot
// kernels, in raw PTX: cp.async with zero fill, the async-proxy fence, and
// wgmma.mma_async with both operands in shared memory, read through matrix
// descriptors.
//
// Shared-memory operand layout. Every tile that wgmma reads is made of
// 128-byte rows (64 bf16) with the 128-byte swizzle: the 16-byte piece p of
// row r sits at piece p ^ (r & 7), r counted from a 1024-byte boundary, so
// this is the hardware's SWIZZLE_128B pattern (address bits 4-6 XOR bits
// 7-9). Because the pattern is a function of the absolute address, a
// descriptor may start at any whole row of such a buffer: a tile shifted
// by a few rows (a conv tap) is read as it was written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte piece p of 128-byte row r under the swizzle
__device__ __forceinline__ uint32_t swz(int r, int p) {
  return (uint32_t)(r * 128 + ((p ^ (r & 7)) << 4));
}

// floor(q / d) for 0 <= q < 2^31 with q / d < 2^22, given inv = 1.0f / d:
// a float estimate within one of the quotient, then corrected
__device__ __forceinline__ int div_pos(int q, int d, float inv) {
  int t = __float2int_rz(__int2float_rn(q) * inv);
  t -= (t * d > q) ? 1 : 0;
  t += ((t + 1) * d <= q) ? 1 : 0;
  return t;
}

// 16 bytes global -> shared; only the first src_bytes (0 or 16) are read,
// the rest is filled with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) before later async-proxy reads (wgmma's operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src)
               : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Matrix descriptor of a 128-byte-swizzled tile at shared address addr
// (any whole 128-byte row of a 1024-aligned buffer): start address and the
// two byte offsets in 16-byte units, layout 1 (B128), base offset 0.
// K-major (rows = M or N, 64 K each): only the 8-row group stride (1024 B)
// is read. MN-major (rows = K, 64 M or N each) with M or N = 64: only the
// stride between 8-row K groups (1024 B) is read. Both offsets are set to
// 1024 B, so either reading of the two fields finds it.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  const uint64_t start = (addr & 0x3FFFFu) >> 4;
  const uint64_t off = 1024 >> 4;
  return start | (off << 16) | (off << 32) | (1ull << 62);
}

// Matrix descriptor of an MN-major 128-byte-swizzled operand wider than 64
// (rows = K, 64 M or N each), stored as 64-column atoms of such rows,
// atom_bytes apart (a multiple of 1024). For the MN-major swizzled layouts
// the two fields mean what CUTLASS's canonical GMMA layout for B128 says,
// Swizzle<3,4,3> o ((8, n), (8, k)) : ((1, LBO), (8, SBO)) in 16-byte
// units: the leading byte offset is the stride between 64-wide atoms along
// M or N, the stride byte offset that between 8-row K groups (1024 B).
// desc_sw128 describes a single atom, whose leading offset is never used,
// so its readers (kernel D's N = 64 tiles) are unaffected.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr,
                                                  uint32_t atom_bytes) {
  const uint64_t start = (addr & 0x3FFFFu) >> 4;
  const uint64_t lead = (atom_bytes & 0x3FFFFu) >> 4;
  const uint64_t stride = 1024 >> 4;
  return start | (lead << 16) | (stride << 32) | (1ull << 62);
}

// D (64 x 32 f32) += A (64 x 16 bf16, shared memory, descriptor) x B
// (16 x 32 bf16, shared memory, descriptor); TA / TB: A / B is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 64 f32) += A (64 x 16 bf16, shared memory, descriptor) x B
// (16 x 64 bf16, shared memory, descriptor); TA / TB: A / B is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 128 f32) += A (64 x 16 bf16, shared memory, descriptor) x B
// (16 x 128 bf16, shared memory, descriptor); TA / TB: A / B is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 192 f32) += A (64 x 16 bf16, shared memory, descriptor) x B
// (16 x 192 bf16, shared memory, descriptor); TA / TB: A / B is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n192k16(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x N f32, N / 2 registers a thread) += A (64 x 16) x B (16 x N),
// both bf16 in shared memory: 128-byte-swizzled tiles of 128-byte rows
// (TA = 0: A's rows are M, 64 K each; TA = 1: rows are K, 64 M each; TB
// likewise for B's N), each descriptor at any whole row (desc_sw128; an
// MN-major operand wider than 64: desc_sw128_mn).
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64k16(float* d, uint64_t da,
                                                uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 192, "wgmma width");
  if constexpr (N == 32)
    wgmma_ss_m64n32k16<TA, TB>(d, da, db);
  else if constexpr (N == 64)
    wgmma_ss_m64n64k16<TA, TB>(d, da, db);
  else if constexpr (N == 128)
    wgmma_ss_m64n128k16<TA, TB>(d, da, db);
  else
    wgmma_ss_m64n192k16<TA, TB>(d, da, db);
}

}  // namespace hopper
