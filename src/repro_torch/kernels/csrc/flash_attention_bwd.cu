// Flash attention backward (causal / sliding window / GQA) for sm_90a:
// dQ, dK and dV from q, k, v, the forward's output o, its row
// log-sum-exp and dO.
//
// No TPU kernel is replaced: no Pallas kernel of the JAX package has a
// backward, and JAX trains through the jnp twin of the flash kernel,
// whose gradient XLA derives.  That gradient is the function computed
// here, the FlashAttention-2 recurrence, in f32:
//   D    = rowsum(dO ∘ O)
//   P    = 2^(s·c − lse2)   (c = scale·log2 e; lse2 from the forward)
//   dV  += Pᵀ dO            dP = dO Vᵀ
//   dS   = P ∘ (dP − D)
//   dQ   = dS K · scale     dK = dSᵀ Q · scale
//
// What bounds it on the H100: operations.  At the training path's call
// (B 1, S 4096, H 40 / KV 8, Dh 128, causal) the five products above are
// ~0.43 TFLOP, 0.43 ms at the bf16 tensor-core peak, against ~0.20 GB
// of bytes (0.06 ms).  This first design is simple and right, not fast:
// it runs on the CUDA cores in f32 (0.067 PFLOP/s peak), and computes
// S and dP twice (once for dK / dV, once for dQ), ~0.6 TFLOP: ~9 ms at
// the f32 peak.  wgmma, TMA and tuning are later work.
//
// Deterministic, with no atomics (an executor-equals-oracle check
// compares training runs bit for bit):
// - flash_bwd_delta_kernel: D, one warp a row, a fixed shuffle tree;
// - flash_bwd_dkdv_kernel: one CTA a 64-key tile of one (batch, KV head);
//   it loops over the G = H / KV query heads of the KV head and over the
//   query tiles that see its keys, and accumulates dK and dV in
//   registers in that fixed order;
// - flash_bwd_dq_kernel: one CTA a 64-query tile of one (batch, head),
//   looping over the key tiles its queries see.
// Tiles live in shared memory as f32 rows of Dh padded to 64 or 128
// columns (zero-filled), plus 4 floats so that rows are 16 bytes apart
// modulo 128: every inner product reads float4s along the reduction
// axis without bank conflicts.  Each of the 256 threads owns a 4 × 4
// block of a 64 × 64 score tile (rows tr + 16i, columns tc + 16j) and a
// 4-row × Dh/16-column block of its output tile.  bf16 inputs are
// widened on load; outputs are written in the inputs' dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 64;        // rows of every tile (queries or keys)
constexpr int kPad = 4;        // f32 row padding
constexpr int kLdS = kBT + kPad;

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk,
                                        int causal, int window) {
  return qpos < sq && kpos < sk && (!causal || kpos <= qpos)
         && (window <= 0 || qpos - kpos < window);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [0, kBT) of a slab (row i at src + i·stride) into an f32 tile of
// DP + kPad columns; rows past n_rows and columns past d_head are 0.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t stride, int n_rows,
                                          int d_head) {
  constexpr int kLd = DP + kPad;
  for (int e = threadIdx.x; e < kBT * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    dst[r * kLd + d] =
        (r < n_rows && d < d_head) ? to_f32(src[r * stride + d]) : 0.f;
  }
}

// s[i][j] = A[tr + 16i] · B[tc + 16j] and dp[i][j] = C[tr + 16i] ·
// E[tc + 16j] over DP columns (A, C: query-row tiles; B, E: key-row
// tiles).
template <int DP>
__device__ __forceinline__ void tile_dots(const float* A, const float* B,
                                          const float* C, const float* E,
                                          int tr, int tc, float (&s)[4][4],
                                          float (&dp)[4][4]) {
  constexpr int kLd = DP + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (tr + 16 * i) * kLd + d);
      c[i] = *reinterpret_cast<const float4*>(C + (tr + 16 * i) * kLd + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + (tc + 16 * j) * kLd + d);
      const float4 e =
          *reinterpret_cast<const float4*>(E + (tc + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
        dp[i][j] = fmaf(c[i].x, e.x, dp[i][j]);
        dp[i][j] = fmaf(c[i].y, e.y, dp[i][j]);
        dp[i][j] = fmaf(c[i].z, e.z, dp[i][j]);
        dp[i][j] = fmaf(c[i].w, e.w, dp[i][j]);
      }
    }
  }
}

// P and dS of the thread's 4 × 4 block (query rows q0 + tr + 16i, keys
// k0 + tc + 16j), in place of s and dp.
__device__ __forceinline__ void tile_probs(float (&s)[4][4],
                                           float (&dp)[4][4],
                                           const float* lse_s,
                                           const float* delta_s, int q0,
                                           int k0, int tr, int tc, int sq,
                                           int sk, int causal, int window,
                                           float scale_log2) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const float lse2 = lse_s[r], dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool vis =
          visible(q0 + r, k0 + tc + 16 * j, sq, sk, causal, window);
      const float p = vis ? exp2f(fmaf(s[i][j], scale_log2, -lse2)) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta,   // (B, H, Sq)
                       int batch, int sq, int n_heads, int d_head) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32)
                      + threadIdx.x / 32;          // (b·Sq + q)·H + h
  if (row >= static_cast<int64_t>(batch) * sq * n_heads) return;
  const int lane = threadIdx.x % 32;
  const T* op = o + row * d_head;
  const T* gp = dout + row * d_head;
  float acc = 0.f;
  for (int d = lane; d < d_head; d += 32)
    acc = fmaf(to_f32(op[d]), to_f32(gp[d]), acc);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % n_heads);
    const int64_t bq = row / n_heads;
    const int q = static_cast<int>(bq % sq);
    const int b = static_cast<int>(bq / sq);
    delta[(static_cast<int64_t>(b) * n_heads + h) * sq + q] = acc;
  }
}

// Row statistics of a query tile: lse2 and D of rows q0 .. q0 + kBT of
// (b, h); rows past Sq get +inf / 0 (they are masked anyway).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* lse,
                                               const float* delta,
                                               int64_t base, int q0,
                                               int sq) {
  for (int r = threadIdx.x; r < kBT; r += kThreads) {
    const bool ok = q0 + r < sq;
    lse_s[r] = ok ? lse[base + q0 + r] : INFINITY;
    delta_s[r] = ok ? delta[base + q0 + r] : 0.f;
  }
}

template <int DP>
constexpr size_t smem_dkdv() {
  return sizeof(float) * (4 * kBT * (DP + kPad) + 2 * kBT * kLdS + 2 * kBT);
}
template <int DP>
constexpr size_t smem_dq() {
  return sizeof(float) * (4 * kBT * (DP + kPad) + kBT * kLdS + 2 * kBT);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int batch,
                      int sq, int sk, int n_heads, int n_kv, int d_head,
                      int causal, int window, float scale, float scale_log2) {
  constexpr int kLd = DP + kPad;
  constexpr int kC = DP / 64;              // float4 column chunks a thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kBT * kLd;
  float* qs = vs + kBT * kLd;
  float* gs = qs + kBT * kLd;              // dO
  float* ps = gs + kBT * kLd;              // P  [query][key]
  float* dss = ps + kBT * kLdS;            // dS [query][key]
  float* lse_s = dss + kBT * kLdS;
  float* delta_s = lse_s + kBT;

  // key tile 0 has the most query tiles under a causal mask: it runs first
  const int heads = n_kv * batch;
  const int kt = static_cast<int>(blockIdx.x) / heads;
  const int kvh = static_cast<int>(blockIdx.x) % heads % n_kv;
  const int b = static_cast<int>(blockIdx.x) % heads / n_kv;
  const int k0 = kt * kBT;
  const int group = n_heads / n_kv;
  const int64_t kv_stride = static_cast<int64_t>(n_kv) * d_head;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * d_head;
  const int64_t kv_off = (static_cast<int64_t>(b) * sk + k0) * kv_stride
                         + static_cast<int64_t>(kvh) * d_head;
  load_rows<T, DP>(ks, k + kv_off, kv_stride, sk - k0, d_head);
  load_rows<T, DP>(vs, v + kv_off, kv_stride, sk - k0, d_head);

  // the query tiles that see a key of this tile
  const int k_last = min(k0 + kBT, sk) - 1;
  const int qt_begin = causal ? k0 / kBT : 0;
  const int q_end = window > 0 ? min(sq, k_last + window) : sq;
  const int qt_end = (q_end + kBT - 1) / kBT;

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;   // score block
  const int kg = threadIdx.x / 16, dg = threadIdx.x % 16;   // output block
  float dk_acc[4][4 * kC], dv_acc[4][4 * kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const int64_t stat_base = (static_cast<int64_t>(b) * n_heads + h) * sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBT;
      __syncthreads();   // the previous tile's readers are done
      const int64_t q_off = (static_cast<int64_t>(b) * sq + q0) * q_stride
                            + static_cast<int64_t>(h) * d_head;
      load_rows<T, DP>(qs, q + q_off, q_stride, sq - q0, d_head);
      load_rows<T, DP>(gs, dout + q_off, q_stride, sq - q0, d_head);
      load_row_stats(lse_s, delta_s, lse, delta, stat_base, q0, sq);
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dots<DP>(qs, ks, gs, vs, tr, tc, s, dp);
      tile_probs(s, dp, lse_s, delta_s, q0, k0, tr, tc, sq, sk, causal,
                 window, scale_log2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(tr + 16 * i) * kLdS + tc + 16 * j] = s[i][j];
          dss[(tr + 16 * i) * kLdS + tc + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dV[key][d] += Σ_q P[q][key] dO[q][d];  dK += Σ_q dS[q][key] Q[q][d]
      const int rows = min(kBT, sq - q0);
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + r * kLdS
                                                           + 4 * kg);
        const float4 d4 = *reinterpret_cast<const float4*>(dss + r * kLdS
                                                           + 4 * kg);
        const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dsk[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float4 g4 = *reinterpret_cast<const float4*>(
              gs + r * kLd + 64 * c + 4 * dg);
          const float4 q4 = *reinterpret_cast<const float4*>(
              qs + r * kLd + 64 * c + 4 * dg);
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv_acc[i][4 * c + e] = fmaf(pk[i], gv[e], dv_acc[i][4 * c + e]);
              dk_acc[i][4 * c + e] = fmaf(dsk[i], qv[e], dk_acc[i][4 * c + e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * kg + i;
    if (key >= sk) continue;
    const int64_t off = (static_cast<int64_t>(b) * sk + key) * kv_stride
                        + static_cast<int64_t>(kvh) * d_head;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * c + 4 * dg + e;
        if (d < d_head) {
          dk[off + d] = from_f32<T>(dk_acc[i][4 * c + e] * scale);
          dv[off + d] = from_f32<T>(dv_acc[i][4 * c + e]);
        }
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int batch, int sq, int sk, int n_heads, int n_kv,
                    int d_head, int causal, int window, float scale,
                    float scale_log2, int n_qt) {
  constexpr int kLd = DP + kPad;
  constexpr int kC = DP / 64;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* gs = qs + kBT * kLd;              // dO
  float* ks = gs + kBT * kLd;
  float* vs = ks + kBT * kLd;
  float* dst = vs + kBT * kLd;             // dSᵀ [key][query]
  float* lse_s = dst + kBT * kLdS;
  float* delta_s = lse_s + kBT;

  // longest causal rows first: the q tile varies slowest, last first
  const int heads = n_heads * batch;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int h = static_cast<int>(blockIdx.x) % heads % n_heads;
  const int b = static_cast<int>(blockIdx.x) % heads / n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = qt * kBT;
  const int64_t kv_stride = static_cast<int64_t>(n_kv) * d_head;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * d_head;
  const int64_t q_off = (static_cast<int64_t>(b) * sq + q0) * q_stride
                        + static_cast<int64_t>(h) * d_head;
  load_rows<T, DP>(qs, q + q_off, q_stride, sq - q0, d_head);
  load_rows<T, DP>(gs, dout + q_off, q_stride, sq - q0, d_head);
  load_row_stats(lse_s, delta_s, lse, delta,
                 (static_cast<int64_t>(b) * n_heads + h) * sq, q0, sq);

  // the key tiles its queries see
  const int q_hi = min(q0 + kBT, sq) - 1;
  int kt_end = (sk + kBT - 1) / kBT;
  if (causal) kt_end = min(kt_end, q_hi / kBT + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBT : 0;

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;   // score block
  const int qg = threadIdx.x / 16, dg = threadIdx.x % 16;   // output block
  float dq_acc[4][4 * kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kC; ++j) dq_acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBT;
    __syncthreads();     // the previous tile's readers are done
    const int64_t kv_off = (static_cast<int64_t>(b) * sk + k0) * kv_stride
                           + static_cast<int64_t>(kvh) * d_head;
    load_rows<T, DP>(ks, k + kv_off, kv_stride, sk - k0, d_head);
    load_rows<T, DP>(vs, v + kv_off, kv_stride, sk - k0, d_head);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<DP>(qs, ks, gs, vs, tr, tc, s, dp);
    tile_probs(s, dp, lse_s, delta_s, q0, k0, tr, tc, sq, sk, causal, window,
               scale_log2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[(tc + 16 * j) * kLdS + tr + 16 * i] = dp[i][j];
    __syncthreads();

    // dQ[q][d] += Σ_key dS[q][key] K[key][d]
    const int keys = min(kBT, sk - k0);
#pragma unroll 2
    for (int t = 0; t < keys; ++t) {
      const float4 d4 = *reinterpret_cast<const float4*>(dst + t * kLdS
                                                         + 4 * qg);
      const float dsq[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            ks + t * kLd + 64 * c + 4 * dg);
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dq_acc[i][4 * c + e] = fmaf(dsq[i], kv[e], dq_acc[i][4 * c + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * qg + i;
    if (row >= sq) continue;
    const int64_t off = (static_cast<int64_t>(b) * sq + row) * q_stride
                        + static_cast<int64_t>(h) * d_head;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * c + 4 * dg + e;
        if (d < d_head)
          dq[off + d] = from_f32<T>(dq_acc[i][4 * c + e] * scale);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int batch, int sq, int sk, int n_heads, int n_kv,
           int d_head, int causal, int window, float scale,
           cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(batch) * sq * n_heads;
  const int delta_blocks =
      static_cast<int>((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_delta_kernel<T><<<delta_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), gp, delta, batch, sq, n_heads, d_head);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale_log2 = scale * 1.4426950408889634f;
  auto dkdv = flash_bwd_dkdv_kernel<T, DP>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkdv<DP>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = (sk + kBT - 1) / kBT;
  dkdv<<<n_kt * n_kv * batch, kThreads, smem_dkdv<DP>(), stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      batch, sq, sk, n_heads, n_kv, d_head, causal, window, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dqk = flash_bwd_dq_kernel<T, DP>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dq<DP>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (sq + kBT - 1) / kBT;
  dqk<<<n_qt * n_heads * batch, kThreads, smem_dq<DP>(), stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dq), batch, sq, sk,
      n_heads, n_kv, d_head, causal, window, scale, scale_log2, n_qt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const void* dout, void* dq, void* dk,
                 void* dv, float* delta, int batch, int sq, int sk,
                 int n_heads, int n_kv, int d_head, int causal, int window,
                 float scale, cudaStream_t stream) {
  if (d_head <= 64)
    return launch<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, batch, sq,
                         sk, n_heads, n_kv, d_head, causal, window, scale,
                         stream);
  return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, batch, sq,
                        sk, n_heads, n_kv, d_head, causal, window, scale,
                        stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the dK/dV kernel, the larger of the two
// (0: the backward does not take this Dh).
size_t flash_attention_bwd_smem_bytes(int d_head) {
  if (d_head <= 0 || d_head > 128) return 0;
  return d_head <= 64 ? smem_dkdv<64>() : smem_dkdv<128>();
}

// dtype: 0 = float32, 1 = bfloat16.  q (B, Sq, H, Dh); k, v (B, Sk, KV,
// Dh); o, dout, dq like q; dk, dv like k; lse (B, H, Sq) f32 from the
// forward; delta: (B, H, Sq) f32 scratch.  All contiguous, on one
// device.  Dh up to 128.  Three launches on `stream`; returns a
// cudaError_t (0 = success).
int flash_attention_bwd_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const float* lse,
                               const void* dout, void* dq, void* dk, void* dv,
                               float* delta, int batch, int sq, int sk,
                               int n_heads, int n_kv, int d_head, int causal,
                               int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_head <= 0 || d_head > 128 || n_heads % n_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, o, lse, dout, dq, dk, dv, delta,
                               batch, sq, sk, n_heads, n_kv, d_head, causal,
                               window, scale, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv,
                                       delta, batch, sq, sk, n_heads, n_kv,
                                       d_head, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
