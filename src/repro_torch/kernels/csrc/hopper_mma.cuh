// Hopper building blocks shared by the bf16 flash attention kernels
// (flash_attention.cu, forward; flash_attention_bwd.cu, backward):
// 128-byte-swizzled shared-memory tiles filled by 16-byte cp.async
// copies, wgmma shared-memory descriptors for K-major and MN-major
// operands, and the wgmma m64n{64,128}k16 bf16 -> f32 products, with A
// from shared memory (SS) or from registers (RS: B MN-major, or K-major
// at n64).  sm_90a only.
//
// Tile layout: a tile holds `rows` rows of DP bf16 as DP / 64 column
// blocks of rows × 128 bytes, each in the 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8)) that wgmma's B128 layout reads;
// every block starts 1024-byte aligned.
//
// Accumulator fragment of wgmma m64nN (per warpgroup thread, warp w,
// lane l): register j holds row 16w + l/4 + 8·((j/2) % 2), column
// 8·(j/4) + 2·(l % 4) + j % 2.  The same registers, rounded to bf16 in
// pairs (pack_bf16x2(d[j], d[j+1]) for even j), are the A fragments of
// a register-A product whose reduction runs over those N columns:
// k-step kk takes a[4kk .. 4kk+3].
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int ch) {
  return (ch >> 3) * (rows * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 reads nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// The copies' writes, seen by wgmma's (async proxy) reads; then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy rows [0, n_rows) of a (ROWS, Dh) slab, row i at src + i·stride,
// into a swizzled tile; rows past n_rows and chunks past Dh are zero.
// `safe` is a valid address for the copies that read nothing.  Each of
// the NT threads copies one 16-byte column chunk of every kRowStep-th
// row, so its chunk, swizzle and shared-memory offset are fixed.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int n_rows,
                                          int d_head,
                                          const __nv_bfloat16* safe) {
  constexpr int kChunks = DP / 8;
  constexpr int kRowStep = NT / kChunks;   // a multiple of 8
  static_assert(ROWS % kRowStep == 0, "whole passes");
  const int ch = threadIdx.x % kChunks;
  const int r0 = threadIdx.x / kChunks;
  const bool ch_ok = ch * 8 < d_head;
  dst += tile_offset(ROWS, r0, ch);
#pragma unroll
  for (int i = 0; i < ROWS / kRowStep; ++i) {
    const int r = r0 + i * kRowStep;
    const bool ok = ch_ok && r < n_rows;
    cp_async16(dst + i * kRowStep * 128, ok ? src + r * stride + ch * 8 : safe,
               ok);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (rows × reduction, the reduction axis contiguous, as
// Q and K lie): 8-row groups 1024 bytes apart; the leading offset is
// unused in the swizzled K-major layout.  k-step kk of 16 columns starts
// 32·(kk % 4) bytes into column block kk / 4 of a `rows`-row tile.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int kk) {
  return smem_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (reduction × N as it lies, e.g. V: keys × Dh): the
// leading offset steps over the 64-column blocks of a `rows`-row tile,
// the stride over 8-row groups; k-step kk of 16 rows starts 16 rows in.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows,
                                                 int kk) {
  return smem_desc(tile + kk * 16 * 128, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from touching accumulators across the async product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// The same for A fragments: their registers are read until the product's
// wait, so they stay live (and unmoved) up to a fence placed after it.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

#define HOPPER_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

// d (64 × 64 f32) (+)= A (64 × 16, smem K-major) · B (64 × 16, smem K-major)ᵀ
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 × 64 f32) += A (64 × 16 bf16, registers) · B (16 × 64, smem MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 128 f32) += A (64 × 16 bf16, registers) · B (16 × 128, smem MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, "
      "p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 64 f32) (+)= A (64 × 16 bf16, registers) · B (64 × 16, smem
// K-major)ᵀ
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[32],
                                                const uint32_t* a,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef HOPPER_D8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

}  // namespace
