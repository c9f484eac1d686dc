// Flash attention forward (causal / sliding window / GQA) for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, called through pl.pallas_call in flash_attention).
//
// What bounds it on the H100: bytes, narrowly.  At the main path's call
// (B 8, S 528, H 40 / KV 8, Dh 128, bf16, causal) the call must move
// 0.104 GB (q and out, K and V once): 0.0310 ms at 3.35 TB/s, against
// 22.9 GFLOP of causal QKᵀ and PV, 0.0231 ms at the bf16 tensor-core
// peak.  Both bounds are only reachable on the tensor cores: the same
// FLOPs on CUDA cores in f32 take at least 0.34 ms.
//
// bf16 design (flash_attention_bf16_kernel), the FA-2/FA-3 structure:
// - one CTA owns 128 query rows of one (batch, head), two warpgroups of
//   64 rows each; Q is loaded once into shared memory;
// - K/V tiles of 64 keys of the head's KV head (GQA: head h reads KV
//   head h / G; the other heads of the group re-read it from L2) stream
//   through a two-stage ring in shared memory, filled by 16-byte
//   cp.async copies issued by all 256 threads while the warpgroups work
//   on the other stage: one __syncthreads per key tile;
// - S = QKᵀ with wgmma m64n64k16 (bf16 -> f32), Q and K read from
//   shared memory K-major as they lie, in the 128-byte swizzle; scores
//   stay in registers, row max and row sum by quad shuffles over the
//   accumulator fragment; online softmax in log2 units, the scale
//   folded into one fma before ex2.approx; p rounded to bf16 (the TPU
//   kernel's "p in the value dtype") straight into the A fragment of
//   O += P·V, a register-A wgmma m64n{64,128}k16 with V read MN-major
//   (trans-b) as it lies;
// - the f32 accumulator is rescaled in registers; the epilogue writes
//   acc / max(l, 1e-30) as bf16;
// - tiles wholly above the diagonal or outside the window are skipped
//   (for the CTA, and for each warpgroup on its own rows); only tiles
//   that straddle the diagonal, the window edge or the ragged key end
//   apply the elementwise mask, as two column limits a row;
// - CTAs run longest causal rows first (reverse q-tile order), so the
//   last wave is short;
// - Dh below 128 is zero-padded inside shared memory to 64 or 128
//   columns (the copies zero-fill the missing chunks), which changes
//   neither QKᵀ nor the kept output columns: any Dh that is a multiple
//   of 8 up to 128 is taken; the wrapper raises for any other.
// The ragged edge (queries past Sq, keys past Sk) is masked in the
// kernel, so the wrapper makes no padding copies.  Copies use cp.async
// rather than TMA: no tensor map has to be encoded on the host
// (cuTensorMapEncodeTiled) for every call.
//
// f32 (flash_attention_f32_kernel) stays on CUDA cores: a tensor-core
// f32 product is TF32 (10-bit mantissa), which would break the 2e-5
// tolerance that the fp32 consistency checks and the cross-framework
// tests hold the kernel to; f32 serves only those checks.  It keeps the
// first design: 32 × 32 tiles staged in f32 shared memory, scalar fmaf.
//
// Numerics follow the TPU kernel: f32 scores and statistics, masked
// scores -1e30 and p of a masked key exactly 0, m starting at -inf, p
// rounded to the value dtype before the PV product, out = acc /
// max(l, 1e-30) in the query dtype.
//
// For training, both kernels also write each row's log-sum-exp (f32,
// (B, H, Sq)) when given a buffer: base 2, over the scaled scores
// (row_lse2), which is what flash_attention_bwd.cu exponentiates with
// ex2.  Serving passes null and pays nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;

constexpr float kLog2e = 1.4426950408889634f;

// The saved row statistic of the backward: log2 of the row's softmax
// denominator over the *scaled* scores, lse2 = log2 Σ_j 2^(s_j·c) with
// c = scale·log2(e), from the running max in those units (m·c) and the
// sum l of 2^(s_j·c − m·c).  A row with no visible key saves +inf, so
// the backward's 2^(s·c − lse2) is 0 there.
__device__ __forceinline__ float row_lse2(float m_c, float l) {
  return l > 0.f ? m_c + log2f(l) : INFINITY;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk,
                                        int causal, int window) {
  return qpos < sq && kpos < sk && (!causal || kpos <= qpos)
         && (window <= 0 || qpos - kpos < window);
}

// ---------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------

constexpr int kThreads32 = 128;
constexpr int kBlockQ32 = 32;
constexpr int kBlockK32 = 32;

__global__ void __launch_bounds__(kThreads32)
flash_attention_f32_kernel(const float* __restrict__ q,  // (B, Sq, H, Dh)
                           const float* __restrict__ k,  // (B, Sk, KV, Dh)
                           const float* __restrict__ v,
                           float* __restrict__ out,      // (B, Sq, H, Dh)
                           float* __restrict__ lse,      // (B, H, Sq) or null
                           int sq, int sk, int n_heads, int n_kv, int d_head,
                           int causal, int window, float scale) {
  const int q0 = blockIdx.x * kBlockQ32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int ldk = d_head + 1;       // padded K rows: no bank conflicts in QK

  extern __shared__ float smem[];
  float* qs = smem;                         // BQ × Dh
  float* acc = qs + kBlockQ32 * d_head;     // BQ × Dh
  float* ks = acc + kBlockQ32 * d_head;     // BK × (Dh + 1)
  float* vs = ks + kBlockK32 * ldk;         // BK × Dh
  float* ps = vs + kBlockK32 * d_head;      // BQ × BK
  float* m_run = ps + kBlockQ32 * kBlockK32;  // BQ
  float* l_run = m_run + kBlockQ32;         // BQ
  float* alpha = l_run + kBlockQ32;         // BQ

  for (int e = threadIdx.x; e < kBlockQ32 * d_head; e += blockDim.x) {
    const int r = e / d_head, d = e % d_head;
    const int qpos = q0 + r;
    qs[e] = qpos < sq
        ? q[((static_cast<int64_t>(b) * sq + qpos) * n_heads + h) * d_head + d]
        : 0.f;
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < kBlockQ32; r += blockDim.x) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  __syncthreads();

  const int n_tiles = (sk + kBlockK32 - 1) / kBlockK32;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK32;
    // tile-level visibility (uniform across the block), as the TPU
    // kernel's pl.when: below-diagonal overlap, and the newest key of
    // the tile inside the oldest query's window
    if (causal && k0 > q0 + kBlockQ32 - 1) continue;
    if (window > 0 && k0 + kBlockK32 - 1 <= q0 - window) continue;

    for (int e = threadIdx.x; e < kBlockK32 * d_head; e += blockDim.x) {
      const int t = e / d_head, d = e % d_head;
      const int kpos = k0 + t;
      float kx = 0.f, vx = 0.f;
      if (kpos < sk) {
        const int64_t off =
            ((static_cast<int64_t>(b) * sk + kpos) * n_kv + kvh) * d_head + d;
        kx = k[off];
        vx = v[off];
      }
      ks[t * ldk + d] = kx;
      vs[e] = vx;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kBlockQ32 * kBlockK32; e += blockDim.x) {
      const int r = e / kBlockK32, t = e % kBlockK32;
      float s = kMasked;
      if (visible(q0 + r, k0 + t, sq, sk, causal, window)) {
        const float* qr = qs + r * d_head;
        const float* kt = ks + t * ldk;
        float dot = 0.f;
        for (int d = 0; d < d_head; ++d) dot = fmaf(qr[d], kt[d], dot);
        s = dot * scale;
      }
      ps[e] = s;
    }
    __syncthreads();

    for (int r = threadIdx.x; r < kBlockQ32; r += blockDim.x) {
      float* pr = ps + r * kBlockK32;
      float m_new = m_run[r];
      for (int t = 0; t < kBlockK32; ++t) m_new = fmaxf(m_new, pr[t]);
      const float a = expf(m_run[r] - m_new);
      float sum = 0.f;
      for (int t = 0; t < kBlockK32; ++t) {
        const float p = visible(q0 + r, k0 + t, sq, sk, causal, window)
                            ? expf(pr[t] - m_new) : 0.f;
        sum += p;
        pr[t] = p;
      }
      m_run[r] = m_new;
      l_run[r] = l_run[r] * a + sum;
      alpha[r] = a;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kBlockQ32 * d_head; e += blockDim.x) {
      const int r = e / d_head, d = e % d_head;
      const float* pr = ps + r * kBlockK32;
      float x = acc[e] * alpha[r];
      for (int t = 0; t < kBlockK32; ++t) {
        if (pr[t] != 0.f) x = fmaf(pr[t], vs[t * d_head + d], x);
      }
      acc[e] = x;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < kBlockQ32 * d_head; e += blockDim.x) {
    const int r = e / d_head, d = e % d_head;
    const int qpos = q0 + r;
    if (qpos < sq) {
      out[((static_cast<int64_t>(b) * sq + qpos) * n_heads + h) * d_head + d] =
          acc[e] / fmaxf(l_run[r], 1e-30f);
    }
  }
  if (lse != nullptr) {
    for (int r = threadIdx.x; r < kBlockQ32; r += blockDim.x) {
      if (q0 + r < sq)
        lse[(static_cast<int64_t>(b) * n_heads + h) * sq + q0 + r] =
            row_lse2(m_run[r] * kLog2e, l_run[r]);
    }
  }
}

size_t smem_f32(int d_head) {
  return sizeof(float) * (2 * kBlockQ32 * d_head + kBlockK32 * (d_head + 1)
                          + kBlockK32 * d_head + kBlockQ32 * kBlockK32
                          + 3 * kBlockQ32);
}

// ---------------------------------------------------------------------
// bf16: wgmma fed by a cp.async K/V ring
// ---------------------------------------------------------------------

constexpr int kWarpgroups = 2;
constexpr int kBQ = 64 * kWarpgroups;   // query rows per CTA
constexpr int kBK = 64;                 // keys per K/V tile
constexpr int kThreadsBF = 128 * kWarpgroups;
constexpr int kStages = 2;
constexpr int kMinBlocks = 2;   // two CTAs an SM: at most 128 registers

// Shared-memory tiles hold `rows` rows of DP bf16 as DP / 64 column
// blocks of rows × 128 bytes, each in the 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8)) that wgmma's B128 layout reads;
// every block starts 1024-byte aligned.
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

// Copy rows [0, n_rows) of a (ROWS, Dh) slab, row i at src + i·stride,
// into a swizzled tile; rows past n_rows and chunks past Dh are zero.
// `safe` is a valid address for the copies that read nothing.  A thread
// copies one 16-byte column chunk of every kRowStep-th row, so its
// chunk, swizzle and shared-memory offset are fixed.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int n_rows,
                                          int d_head,
                                          const __nv_bfloat16* safe) {
  constexpr int kChunks = DP / 8;
  constexpr int kRowStep = kThreadsBF / kChunks;   // a multiple of 8
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
// K-major operand (Q, K): 8-row groups 1024 bytes apart; the leading
// offset is unused in the swizzled K-major layout.  k-step kk of 16
// columns starts 32·(kk % 4) bytes into column block kk / 4.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int kk) {
  return smem_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (V as stored, keys × Dh): the leading offset steps
// over 64-column blocks of Dh, the stride over 8-key groups; k-step kk
// of 16 keys starts 16 rows in.
constexpr uint32_t kVLeading = kBK * 128;
constexpr uint32_t kVStride = 1024;
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, kVLeading, kVStride);
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
// Keeps the compiler from touching accumulators across the async product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 × 64 f32) (+)= A (64 × 16, smem K-major) · B (64 × 16, smem K-major)ᵀ
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
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
      : D8(0), D8(8), D8(16), D8(24)
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
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

constexpr size_t smem_bf16(int dp) {
  return 2 * (static_cast<size_t>(kBQ) * dp + 2 * kStages * kBK * dp) + 1024;
}

// Accumulator fragment of wgmma m64nN (per warpgroup thread, warp w,
// lane l): register j holds row 16w + l/4 + 8·((j/2) % 2), column
// 8·(j/4) + 2·(l % 4) + j % 2.
template <int DP>
__global__ void __launch_bounds__(kThreadsBF, kMinBlocks)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse,
                            int batch, int sq, int sk, int n_heads, int n_kv,
                            int d_head, int causal, int window,
                            float scale_log2, int n_qt) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023)
      & ~1023u;
  const uint32_t s_k = s_q + kBQ * DP * 2;             // kStages × BK × DP
  const uint32_t s_v = s_k + kStages * kBK * DP * 2;   // kStages × BK × DP
  constexpr uint32_t kStageBytes = kBK * DP * 2;

  // longest causal rows first: the q tile varies slowest, last first
  const int heads = n_heads * batch;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int h = static_cast<int>(blockIdx.x) % heads % n_heads;
  const int b = static_cast<int>(blockIdx.x) % heads / n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q_lo = qt * kBQ;
  const int q_hi = min(q_lo + kBQ, sq) - 1;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * d_head;
  const int64_t kv_stride = static_cast<int64_t>(n_kv) * d_head;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * sk * kv_stride
                            + kvh * d_head;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * sk * kv_stride
                            + kvh * d_head;

  // the CTA's key tiles, as the TPU kernel's pl.when: keys up to its
  // newest query, and tiles whose newest key is inside its oldest
  // query's window
  int kt_end = (sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_hi / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / kBK : 0;

  load_tile<DP, kBQ>(s_q, q + (static_cast<int64_t>(b) * sq + q_lo) * q_stride
                     + h * d_head, q_stride, sq - q_lo, d_head, q);
  if (kt_begin < kt_end) {
    const int k0 = kt_begin * kBK;
    load_tile<DP, kBK>(s_k, kb + k0 * kv_stride, kv_stride, sk - k0, d_head,
                       k);
    load_tile<DP, kBK>(s_v, vb + k0 * kv_stride, kv_stride, sk - k0, d_head,
                       v);
  }
  cp_async_commit();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wq_lo = q_lo + 64 * wg;           // this warpgroup's rows
  const int wq_hi = min(wq_lo + 63, sq - 1);  // < wq_lo: no rows
  const int row0 = wq_lo + 16 * warp + lane / 4;   // and row0 + 8

  float o[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const uint32_t stage = ((kt - kt_begin) & 1) * kStageBytes;
    cp_async_wait_all();
    // the copies' writes, seen by wgmma's (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt + 1 < kt_end) {   // the next tile into the stage freed above
      const int k1 = (kt + 1) * kBK;
      const uint32_t next = kStageBytes - stage;
      load_tile<DP, kBK>(s_k + next, kb + k1 * kv_stride, kv_stride, sk - k1,
                         d_head, k);
      load_tile<DP, kBK>(s_v + next, vb + k1 * kv_stride, kv_stride, sk - k1,
                         d_head, v);
    }
    cp_async_commit();

    const int k0 = kt * kBK;
    bool any = wq_lo <= wq_hi;
    if (causal) any = any && k0 <= wq_hi;
    if (window > 0) any = any && k0 + kBK - 1 > wq_lo - window;
    if (!any) continue;   // warpgroup-uniform

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc(s_q + wg * 64 * 128, kBQ, kk),
                   kmajor_desc(s_k + stage, kBK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // only tiles that straddle the diagonal, the window edge or the
    // key end are masked: a thread's columns are 8·(j/4) + j%2 + c0, and
    // a row sees columns lo < col <= hi
    const bool masked = (causal && k0 + kBK - 1 > wq_lo)
                        || (window > 0 && wq_hi - k0 >= window)
                        || k0 + kBK > sk;
    if (masked) {
      const int c0 = 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qpos = row0 + 8 * half;
        const int hi = min(sk - k0 - 1, causal ? qpos - k0 : kBK) - c0;
        const int lo = (window > 0 ? qpos - k0 - window : -kBK) - c0;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = 8 * (j >> 2) + (j & 1);
          if (((j >> 1) & 1) == half && (col > hi || col <= lo))
            s[j] = kMasked;
        }
      }
    }
    // statistics in the raw score domain, exponents in log2 units:
    // p = 2^(s·c − m·c) with c = scale·log2(e)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if ((j >> 1) & 1) mx1 = fmaxf(mx1, s[j]); else mx0 = fmaxf(mx0, s[j]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = ex2((m0 - mx0) * scale_log2);   // m = -inf: 0
    const float a1 = ex2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float ms0 = m0 * scale_log2, ms1 = m1 * scale_log2;

    // p in bf16, laid out as the A fragments of the four k-steps:
    // pa[4kk .. 4kk+3] = rows (r, r+8) × keys 16kk + (0..7, 8..15)
    uint32_t pa[16];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const float mm = ((j >> 1) & 1) ? ms1 : ms0;
      float p0 = ex2(fmaf(s[j], scale_log2, -mm));
      float p1 = ex2(fmaf(s[j + 1], scale_log2, -mm));
      if (masked) {   // exactly 0, even in a row with nothing visible yet
        p0 = s[j] == kMasked ? 0.f : p0;
        p1 = s[j + 1] == kMasked ? 0.f : p1;
      }
      if ((j >> 1) & 1) sum1 += p0 + p1; else sum0 += p0 + p1;
      pa[j / 2] = pack_bf16x2(p0, p1);
    }
    l0 = l0 * a0 + sum0;   // this thread's share; the quad sums at the end
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) o[j] *= ((j >> 1) & 1) ? a1 : a0;

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs(o, pa + 4 * kk, mnmajor_desc(s_v + stage, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {
    const int64_t base = (static_cast<int64_t>(b) * n_heads + h) * sq;
    if (row0 < sq) lse[base + row0] = row_lse2(m0 * scale_log2, l0);
    if (row0 + 8 < sq) lse[base + row0 + 8] = row_lse2(m1 * scale_log2, l1);
  }
#pragma unroll
  for (int j = 0; j < DP / 2; j += 2) {
    const int hi = (j >> 1) & 1;
    const int row = row0 + 8 * hi;
    const int col = 8 * (j >> 2) + 2 * (lane & 3);
    if (row < sq && col < d_head) {
      const float dd = hi ? d1 : d0;
      *reinterpret_cast<__nv_bfloat162*>(
          out + (static_cast<int64_t>(b) * sq + row) * q_stride + h * d_head
          + col) = __floats2bfloat162_rn(o[j] / dd, o[j + 1] / dd);
    }
  }
}

int bf16_padded(int d_head) {
  if (d_head <= 0 || d_head % 8 || d_head > 128) return 0;
  return d_head <= 64 ? 64 : 128;
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int batch, int sq, int sk, int n_heads, int n_kv,
                int d_head, int causal, int window, float scale,
                cudaStream_t stream) {
  auto kernel = flash_attention_bf16_kernel<DP>;
  const size_t smem = smem_bf16(DP);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (sq + kBQ - 1) / kBQ;
  kernel<<<n_qt * n_heads * batch, kThreadsBF, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, batch, sq, sk, n_heads, n_kv, d_head, causal, window,
      scale * kLog2e, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (0: the kernel does not
// take this Dh).  dtype: 0 = float32, 1 = bfloat16.
size_t flash_attention_smem_bytes(int dtype, int d_head) {
  if (dtype == 0) return smem_f32(d_head);
  const int dp = bf16_padded(d_head);
  return dp ? smem_bf16(dp) : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  lse: (B, H, Sq) f32 row statistics
// for the backward (see row_lse2), or null to skip them.  Returns a
// cudaError_t (0 = success).
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, float* lse, int batch,
                           int sq, int sk, int n_heads, int n_kv, int d_head,
                           int causal, int window, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const size_t smem = smem_f32(d_head);
    if (smem > 48 * 1024) {   // above 48 KB only after an explicit opt-in
      cudaError_t err = cudaFuncSetAttribute(
          flash_attention_f32_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((sq + kBlockQ32 - 1) / kBlockQ32, n_heads, batch);
    flash_attention_f32_kernel<<<grid, kThreads32, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk,
        n_heads, n_kv, d_head, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) {
    switch (bf16_padded(d_head)) {
      case 64:
        return launch_bf16<64>(q, k, v, out, lse, batch, sq, sk, n_heads,
                               n_kv, d_head, causal, window, scale, s);
      case 128:
        return launch_bf16<128>(q, k, v, out, lse, batch, sq, sk, n_heads,
                                n_kv, d_head, causal, window, scale, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
