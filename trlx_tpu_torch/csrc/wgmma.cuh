// Hopper (sm_90a) building blocks in raw PTX: warpgroup matrix multiply
// (wgmma) with its shared-memory descriptors and swizzled tile layouts,
// and cp.async copies. Used by the bf16 flash-attention forward and
// backward in flash_attention.cu; the paged decode (paged_attention.cu)
// uses the cp.async copies only.
//
// Tile layout. A tile of R rows by HD bf16 columns (R a multiple of 8) is
// stored as HD / CB column blocks of CB = min(HD, 64) columns, each block
// [R][CB] row-major, so a row of a block is CB * 2 = 32, 64 or 128 bytes
// (hd 256: four 64-column blocks of 128-byte rows; the columns from block
// 2 on are a tile of hd 128 of their own, which an MN-major descriptor
// may start at).
// Inside a block the 16-byte chunks of row r are permuted by the swizzle of
// that row width (byte-offset bits [4, 4 + b) ^= bits [7, 7 + b), b = 1, 2,
// 3 for 32, 64, 128 bytes: the patterns CU_TENSOR_MAP_SWIZZLE_32B/64B/128B
// and wgmma's layout types 3/2/1). Blocks start 1024-byte aligned, so the
// permutation of a byte offset equals the hardware's of the address.
//
// Descriptors (PTX ISA "matrix descriptor"): bits 0-13 start address >> 4,
// 16-29 leading byte offset >> 4, 32-45 stride byte offset >> 4, 62-63
// layout type. For an operand stored K-major (the reduction dim
// contiguous: q and k in q.k^T) the stride byte offset steps between
// groups of 8 rows (8 * row bytes), the leading offset is unused, and the
// k-th 16-column slice starts 32 * k bytes into its block. For an operand
// stored MN-major (v in p.v, [key][hd], read with tnspB = 1) the stride
// byte offset steps between groups of 8 keys (8 * row bytes), the leading
// byte offset between column blocks (R * row bytes), and the k-th slice of
// 16 keys starts 16 * k rows into each block.
//
// Accumulator layout (m64nN, f32, N / 2 registers per thread): thread t of
// the warpgroup (warp w = t / 32, lane l) holds, for j < N / 8, row
// 16 w + l / 4 at columns 8 j + 2 (l % 4) + {0, 1} in registers 4 j + {0, 1}
// and row 16 w + l / 4 + 8 at the same columns in 4 j + {2, 3}. A register
// A fragment (m64k16) holds the same rows at columns 2 (l % 4) + {0, 1} and
// 8 + 2 (l % 4) + {0, 1}, as bf16 pairs (a0: row, low columns; a1: row + 8;
// a2: row, high columns; a3: row + 8, high columns), so a 16-column slice
// of an accumulator is an A fragment after packing.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

// Bytes of one swizzled row (the column block's width).
template <int HD>
struct TileShape {
  static constexpr int CB = HD < 64 ? HD : 64;   // columns of a block
  static constexpr int ROW = CB * 2;            // bytes of a block's row
  static constexpr int BLOCKS = HD / CB;
  static constexpr int SWZ_BITS = ROW == 128 ? 3 : ROW == 64 ? 2 : 1;
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static_assert(ROW == 32 || ROW == 64 || ROW == 128, "head dim 16, 32, or a multiple of 64 (64, 128, 256)");
};

// Byte offset in a [rows] x HD swizzled tile of the 16-byte chunk holding
// columns 8c .. 8c + 7 of row r.
template <int HD>
__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int c) {
  using S = TileShape<HD>;
  const int blk = (c * 8) / S::CB, cc = (c * 8) % S::CB;
  const uint32_t off = blk * rows * S::ROW + r * S::ROW + cc * 2;
  return off ^ (((off >> 7) & ((1u << S::SWZ_BITS) - 1)) << 4);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint64_t layout) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= layout << 62;
  return d;
}

// K-major operand (rows x HD tile, reduction over HD): slice k of 16 columns.
template <int HD>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows, int k) {
  using S = TileShape<HD>;
  constexpr int KPB = S::CB / 16;  // 16-column slices per block
  const uint32_t start = tile + (k / KPB) * rows * S::ROW + (k % KPB) * 32;
  return make_desc(start, 16, 8 * S::ROW, S::LAYOUT);
}

// MN-major operand (rows = reduction dim, HD = N): slice k of 16 rows.
template <int HD>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows, int k) {
  using S = TileShape<HD>;
  return make_desc(tile + k * 16 * S::ROW, rows * S::ROW, 8 * S::ROW, S::LAYOUT);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulator registers at this point of the program, so the
// compiler moves no read or write of them across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16-byte copy to shared memory; with valid == false the destination is
// filled with zeros and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 8-byte copy to shared memory; with valid == false it writes zeros.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
// 4-byte copy to shared memory (one f32); with valid == false it writes 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (m64 x n64, f32) (+)= A (m64 x k16, bf16, shared) . B (k16 x n64, bf16, shared)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (m64 x n16, f32) += A (m64 x k16, bf16, registers) . B (k16 x n16, bf16, shared,
// stored [k][n]: transposed, tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (m64 x n32, f32) += A (m64 x k16, bf16, registers) . B (k16 x n32, bf16, shared,
// stored [k][n]: transposed, tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (m64 x n64, f32) += A (m64 x k16, bf16, registers) . B (k16 x n64, bf16, shared,
// stored [k][n]: transposed, tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (m64 x n128, f32) += A (m64 x k16, bf16, registers) . B (k16 x n128, bf16, shared,
// stored [k][n]: transposed, tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, desc_b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, desc_b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b);
  else wgmma_rs_n128(d, a, desc_b);
}

}  // namespace hopper
