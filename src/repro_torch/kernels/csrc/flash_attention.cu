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
// - Dh is zero-padded inside shared memory to 64, 128 or 256 columns
//   (the copies zero-fill the missing chunks), which changes neither
//   QKᵀ nor the kept output columns: any Dh that is a multiple of 8 up
//   to 256 is taken; the wrapper raises for any other;
// - past 128 columns (gemma3's Dh 256) the O accumulator of a 64-row
//   warpgroup would be 128 f32 registers a thread beside the S tile and
//   the P fragments, and the K/V ring 128 KB beside a 64 KB Q tile.  So
//   each CTA owns one 128-column half of O: it forms the whole S = QKᵀ
//   (Q and K at their full width) but streams and multiplies only its
//   half of V, and the two CTAs of a (q tile, batch, head) sit next to
//   each other in the grid, so the second reads Q and K from L2.  The
//   two compute the same S, P and row statistics by the same
//   instructions, so their halves agree as one CTA's would; QKᵀ is done
//   twice (1.5x the products of one CTA), and the accumulator stays at
//   64 registers a thread, as at Dh 128.  Shared memory: Q 64 KB, the
//   K ring 64 KB, the V ring 32 KB, one CTA an SM.
// The ragged edge (queries past Sq, keys past Sk) is masked in the
// kernel, so the wrapper makes no padding copies.  Copies use cp.async
// rather than TMA: no tensor map has to be encoded on the host
// (cuTensorMapEncodeTiled) for every call.  The tile layout, the copies,
// the wgmma descriptors and products live in hopper_mma.cuh, shared with
// the backward (flash_attention_bwd.cu).
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

#include "hopper_mma.cuh"

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
// Two CTAs an SM (at most 128 registers a thread) where their shared
// memory fits, else one.
constexpr int min_blocks(int dp) { return dp > 128 ? 1 : 2; }
// The columns of O (and of V) one CTA owns: all of them up to 128, one
// 128-column half past that.
__host__ __device__ constexpr int out_cols(int dp) {
  return dp > 128 ? 128 : dp;
}

constexpr size_t smem_bf16(int dp) {
  return 2 * (static_cast<size_t>(kBQ) * dp
              + kStages * kBK * (static_cast<size_t>(dp) + out_cols(dp)))
         + 1024;
}

// Accumulator fragments as hopper_mma.cuh lays them out.  DP: the padded
// width of Q and K; DV = out_cols(DP): the CTA's columns of V and O.
template <int DP>
__global__ void __launch_bounds__(kThreadsBF, min_blocks(DP))
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
  constexpr int DV = out_cols(DP);
  constexpr int kHalves = DP / DV;
  const uint32_t s_k = s_q + kBQ * DP * 2;             // kStages × BK × DP
  const uint32_t s_v = s_k + kStages * kBK * DP * 2;   // kStages × BK × DV
  constexpr uint32_t kStageBytes = kBK * DP * 2;
  constexpr uint32_t kStageBytesV = kBK * DV * 2;

  // longest causal rows first: the q tile varies slowest, last first;
  // the column halves of one (q tile, batch, head) are neighbours
  const int heads = n_heads * batch;
  const int cta = static_cast<int>(blockIdx.x) / kHalves;
  const int half = static_cast<int>(blockIdx.x) % kHalves;
  const int col0 = half * DV;                  // the CTA's first column of O
  const int qt = n_qt - 1 - cta / heads;
  const int h = cta % heads % n_heads;
  const int b = cta % heads / n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q_lo = qt * kBQ;
  const int q_hi = min(q_lo + kBQ, sq) - 1;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * d_head;
  const int64_t kv_stride = static_cast<int64_t>(n_kv) * d_head;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * sk * kv_stride
                            + kvh * d_head;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * sk * kv_stride
                            + kvh * d_head + col0;
  const int v_cols = d_head - col0;   // V's columns in the CTA's half

  // the CTA's key tiles, as the TPU kernel's pl.when: keys up to its
  // newest query, and tiles whose newest key is inside its oldest
  // query's window
  int kt_end = (sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_hi / kBK + 1);
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / kBK : 0;

  load_tile<DP, kBQ, kThreadsBF>(
      s_q, q + (static_cast<int64_t>(b) * sq + q_lo) * q_stride + h * d_head,
      q_stride, sq - q_lo, d_head, q);
  if (kt_begin < kt_end) {
    const int k0 = kt_begin * kBK;
    load_tile<DP, kBK, kThreadsBF>(s_k, kb + k0 * kv_stride, kv_stride,
                                   sk - k0, d_head, k);
    load_tile<DV, kBK, kThreadsBF>(s_v, vb + k0 * kv_stride, kv_stride,
                                   sk - k0, v_cols, v);
  }
  cp_async_commit();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wq_lo = q_lo + 64 * wg;           // this warpgroup's rows
  const int wq_hi = min(wq_lo + 63, sq - 1);  // < wq_lo: no rows
  const int row0 = wq_lo + 16 * warp + lane / 4;   // and row0 + 8

  float o[DV / 2];
#pragma unroll
  for (int j = 0; j < DV / 2; ++j) o[j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const uint32_t stage = ((kt - kt_begin) & 1) * kStageBytes;
    const uint32_t stage_v = ((kt - kt_begin) & 1) * kStageBytesV;
    cp_async_wait_all();
    fence_proxy_async();   // the copies' writes, seen by wgmma's reads
    __syncthreads();
    if (kt + 1 < kt_end) {   // the next tile into the stage freed above
      const int k1 = (kt + 1) * kBK;
      const uint32_t next = kStageBytes - stage;
      load_tile<DP, kBK, kThreadsBF>(s_k + next, kb + k1 * kv_stride,
                                     kv_stride, sk - k1, d_head, k);
      load_tile<DV, kBK, kThreadsBF>(s_v + kStageBytesV - stage_v,
                                     vb + k1 * kv_stride, kv_stride, sk - k1,
                                     v_cols, v);
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
    for (int j = 0; j < DV / 2; ++j) o[j] *= ((j >> 1) & 1) ? a1 : a0;

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs(o, pa + 4 * kk, mnmajor_desc(s_v + stage_v, kBK, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && half == 0 && (lane & 3) == 0) {
    const int64_t base = (static_cast<int64_t>(b) * n_heads + h) * sq;
    if (row0 < sq) lse[base + row0] = row_lse2(m0 * scale_log2, l0);
    if (row0 + 8 < sq) lse[base + row0 + 8] = row_lse2(m1 * scale_log2, l1);
  }
#pragma unroll
  for (int j = 0; j < DV / 2; j += 2) {
    const int hi = (j >> 1) & 1;
    const int row = row0 + 8 * hi;
    const int col = col0 + 8 * (j >> 2) + 2 * (lane & 3);
    if (row < sq && col < d_head) {
      const float dd = hi ? d1 : d0;
      *reinterpret_cast<__nv_bfloat162*>(
          out + (static_cast<int64_t>(b) * sq + row) * q_stride + h * d_head
          + col) = __floats2bfloat162_rn(o[j] / dd, o[j + 1] / dd);
    }
  }
}

int bf16_padded(int d_head) {
  if (d_head <= 0 || d_head % 8 || d_head > 256) return 0;
  return d_head <= 64 ? 64 : d_head <= 128 ? 128 : 256;
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
  kernel<<<n_qt * n_heads * batch * (DP / out_cols(DP)), kThreadsBF, smem,
           stream>>>(
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
      case 256:
        return launch_bf16<256>(q, k, v, out, lse, batch, sq, sk, n_heads,
                                n_kv, d_head, causal, window, scale, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
