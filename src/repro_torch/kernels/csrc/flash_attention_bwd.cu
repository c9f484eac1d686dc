// Flash attention backward (causal / sliding window / GQA) for sm_90a:
// dQ, dK and dV from q, k, v, the forward's output o, its row
// log-sum-exp and dO.
//
// No TPU kernel is replaced: no Pallas kernel of the JAX package has a
// backward, and JAX trains through the jnp twin of the flash kernel,
// whose gradient XLA derives.  That gradient is the function computed
// here, the FlashAttention-2 recurrence:
//   D    = rowsum(dO ∘ O)
//   P    = 2^(s·c − lse2)   (c = scale·log2 e; lse2 from the forward)
//   dV  += Pᵀ dO            dP = dO Vᵀ
//   dS   = P ∘ (dP − D)
//   dQ   = dS K · scale     dK = dSᵀ Q · scale
//
// What bounds it on the H100: operations.  At the training path's call
// (B 1, S 4096, H 40 / KV 8, Dh 128, causal) the five products above are
// ~0.43 TFLOP, 0.43 ms at the bf16 tensor-core peak, against ~0.20 GB
// of bytes (0.06 ms).  Both kernel designs below compute S and dP twice
// (once for dK / dV, once for dQ): seven products, ~0.61 ms at the peak.
//
// Deterministic, with no atomics (an executor-equals-oracle check
// compares training runs bit for bit):
// - flash_bwd_delta_kernel: D, one warp a row, a fixed shuffle tree;
// - dK / dV: a CTA owns key tiles of one (batch, KV head); it loops over
//   the G = H / KV query heads of the KV head and over the query tiles
//   that see its keys, and accumulates dK and dV in registers in that
//   fixed order;
// - dQ: a CTA owns query tiles of one (batch, head), looping over the
//   key tiles its queries see, longest causal rows first.
//
// bf16 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): the tensor cores,
// in FA-3's transposed form, on the forward's building blocks
// (hopper_mma.cuh):
// - dK / dV: two consumer warpgroups a CTA, each owning 64 keys (128
//   keys a CTA); K and V are loaded once into shared memory as bf16 in
//   the 128-byte swizzle.  The 64-query Q and dO tiles of the walk (each
//   head's tiles last first, so the CTAs of a KV head that run together
//   read the same tiles, which L2 serves once), with their lse2 and D,
//   stream through a two-stage cp.async ring filled by all 256 threads
//   while the warpgroups work on the other stage.  For each tile:
//   Sᵀ = K Qᵀ and dPᵀ = V dOᵀ with wgmma m64n64k16 (both operands
//   K-major as they lie); Pᵀ = 2^(Sᵀ·c − lse2) and dSᵀ = Pᵀ ∘ (dPᵀ − D)
//   in registers (lse2 and D are per query: per accumulator column,
//   read from the ring); Pᵀ and dSᵀ rounded to bf16 straight into A
//   fragments; dV += Pᵀ dO and dK += dSᵀ Q with register-A wgmma
//   m64n{64,128}k16, dO and Q read MN-major as they lie.  dK and dV stay
//   in registers for the whole walk (64 + 64 f32 a thread at Dh 128).
// - dQ: two warpgroups of 64 queries (128 a CTA); each warpgroup's Q and
//   dO rows are read once from global memory straight into A fragments
//   (64 registers at Dh 128), so S = Q Kᵀ and dP = dO Vᵀ are register-A
//   products that read only K and V from shared memory; 64-key K / V
//   tiles through a three-stage ring; dS in registers (lse2 and D per
//   row, in registers), rounded to bf16 into A fragments, dQ += dS K
//   (register A, K read MN-major).  A tile's dQ products are left
//   running under the next tile's S and dP (waited there), so a stage
//   is read while the next computes and the one after loads.
// - Overlap inside a CTA: the two warpgroups take turns issuing their S
//   and dP products (two named barriers), so one warpgroup's softmax
//   runs under the other's products; S and dP are separate commit
//   groups, so P is formed while dP is still in the tensor cores, and
//   dK / dV issues dV's products before it forms dS.  (Leaving dK / dV's
//   products running into the next tile, as dQ does, needs more than
//   255 registers a thread and spilled.)
// - Tiles wholly outside the mask are skipped, by the CTA's walk and by
//   each warpgroup on its own rows; only tiles that straddle the
//   diagonal, the window edge or the ragged end (queries past Sq, keys
//   past Sk) apply the elementwise mask.  Dh is zero-padded inside
//   shared memory to 64 or 128 columns (any multiple of 8 up to 128).
// - P and dS are rounded to bf16 before the products that use them, as
//   the forward rounds p before PV; the plain version does the same.
//
// f32 (flash_bwd_dkdv_f32_kernel, flash_bwd_dq_f32_kernel) stays on the
// CUDA cores, as the forward's f32 path does: a tensor-core f32 product
// is TF32, which would break the 2e-5 tolerance of the fp32 checks that
// are its only users.  Tiles live in shared memory as f32 rows of Dh
// padded to 64 or 128 columns (zero-filled), plus 4 floats so that rows
// are 16 bytes apart modulo 128: every inner product reads float4s along
// the reduction axis without bank conflicts.  Each of the 256 threads
// owns a 4 × 4 block of a 64 × 64 score tile (rows tr + 16i, columns
// tc + 16j) and a 4-row × Dh/16-column block of its output tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk,
                                        int causal, int window) {
  return qpos < sq && kpos < sk && (!causal || kpos <= qpos)
         && (window <= 0 || qpos - kpos < window);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------
// D = rowsum(dO ∘ O), both dtypes
// ---------------------------------------------------------------------

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

// ---------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------

constexpr int kBT = 64;        // rows of every tile (queries or keys)
constexpr int kPad = 4;        // f32 row padding
constexpr int kLdS = kBT + kPad;

// Rows [0, kBT) of a slab (row i at src + i·stride) into an f32 tile of
// DP + kPad columns; rows past n_rows and columns past d_head are 0.
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int n_rows,
                                          int d_head) {
  constexpr int kLd = DP + kPad;
  for (int e = threadIdx.x; e < kBT * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    dst[r * kLd + d] =
        (r < n_rows && d < d_head) ? src[r * stride + d] : 0.f;
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

// Past 128 columns the four f32 tiles of a step (K, V, Q, dO at 64 rows
// of Dh + 4 floats) would need 266 KB at Dh 256.  So the f32 kernels
// take Dh in NH column passes of DP columns each (NH = 2 at Dh 256): a
// CTA owns one DP-column slice of its output (dK and dV, or dQ) and, for
// each tile of its walk, loads the four tiles' other slice, forms the
// partial S and dP, then loads its own slice and adds that slice's
// partials: two partial sums added once, which is the same number in
// both CTAs whichever slice each loads first.  The slice it loaded last
// feeds its own output's products.  At NH = 1 the kernels load K and V
// (dK / dV) or Q and dO (dQ) once, as tiles of the whole Dh.
template <int DP>
constexpr size_t smem_dkdv() {
  return sizeof(float) * (4 * kBT * (DP + kPad) + 2 * kBT * kLdS + 2 * kBT);
}
template <int DP>
constexpr size_t smem_dq() {
  return sizeof(float) * (4 * kBT * (DP + kPad) + kBT * kLdS + 2 * kBT);
}

// s and dp of the thread's 4 × 4 block, one column pass: the first pass
// sets them, a second adds its own partials (formed from zero) to them.
template <int DP>
__device__ __forceinline__ void pass_dots(const float* A, const float* B,
                                          const float* C, const float* E,
                                          int tr, int tc, int pass,
                                          float (&s)[4][4],
                                          float (&dp)[4][4]) {
  if (pass == 0) {
    tile_dots<DP>(A, B, C, E, tr, tc, s, dp);
    return;
  }
  float s2[4][4], dp2[4][4];
  tile_dots<DP>(A, B, C, E, tr, tc, s2, dp2);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] += s2[i][j];
      dp[i][j] += dp2[i][j];
    }
}

template <int DP, int NH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int batch, int sq, int sk, int n_heads, int n_kv,
                          int d_head, int causal, int window, float scale,
                          float scale_log2) {
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

  // key tile 0 has the most query tiles under a causal mask: it runs
  // first; the column slices of one key tile are neighbours
  const int heads = n_kv * batch;
  const int cta = static_cast<int>(blockIdx.x) / NH;
  const int own = static_cast<int>(blockIdx.x) % NH;   // the output slice
  const int kt = cta / heads;
  const int kvh = cta % heads % n_kv;
  const int b = cta % heads / n_kv;
  const int k0 = kt * kBT;
  const int group = n_heads / n_kv;
  const int64_t kv_stride = static_cast<int64_t>(n_kv) * d_head;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * d_head;
  const int64_t kv_off = (static_cast<int64_t>(b) * sk + k0) * kv_stride
                         + static_cast<int64_t>(kvh) * d_head;
  if (NH == 1) {
    load_rows<DP>(ks, k + kv_off, kv_stride, sk - k0, d_head);
    load_rows<DP>(vs, v + kv_off, kv_stride, sk - k0, d_head);
  }

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
      const int64_t q_off = (static_cast<int64_t>(b) * sq + q0) * q_stride
                            + static_cast<int64_t>(h) * d_head;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int pass = 0; pass < NH; ++pass) {
        // the other slice first, the CTA's own last
        const int c = (NH - 1 - pass + own) % NH * DP;
        const int cols = d_head - c;
        __syncthreads();   // the previous readers are done
        if (NH > 1) {
          load_rows<DP>(ks, k + kv_off + c, kv_stride, sk - k0, cols);
          load_rows<DP>(vs, v + kv_off + c, kv_stride, sk - k0, cols);
        }
        load_rows<DP>(qs, q + q_off + c, q_stride, sq - q0, cols);
        load_rows<DP>(gs, dout + q_off + c, q_stride, sq - q0, cols);
        if (pass == 0)
          load_row_stats(lse_s, delta_s, lse, delta, stat_base, q0, sq);
        __syncthreads();
        pass_dots<DP>(qs, ks, gs, vs, tr, tc, pass, s, dp);
      }
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
        const int d = own * DP + 64 * c + 4 * dg + e;
        if (d < d_head) {
          dk[off + d] = dk_acc[i][4 * c + e] * scale;
          dv[off + d] = dv_acc[i][4 * c + e];
        }
      }
  }
}

template <int DP, int NH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int batch, int sq, int sk,
                        int n_heads, int n_kv, int d_head, int causal,
                        int window, float scale, float scale_log2,
                        int n_qt) {
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

  // longest causal rows first: the q tile varies slowest, last first;
  // the column slices of one q tile are neighbours
  const int heads = n_heads * batch;
  const int cta = static_cast<int>(blockIdx.x) / NH;
  const int own = static_cast<int>(blockIdx.x) % NH;   // the output slice
  const int qt = n_qt - 1 - cta / heads;
  const int h = cta % heads % n_heads;
  const int b = cta % heads / n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = qt * kBT;
  const int64_t kv_stride = static_cast<int64_t>(n_kv) * d_head;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * d_head;
  const int64_t q_off = (static_cast<int64_t>(b) * sq + q0) * q_stride
                        + static_cast<int64_t>(h) * d_head;
  if (NH == 1) {
    load_rows<DP>(qs, q + q_off, q_stride, sq - q0, d_head);
    load_rows<DP>(gs, dout + q_off, q_stride, sq - q0, d_head);
  }
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
    const int64_t kv_off = (static_cast<int64_t>(b) * sk + k0) * kv_stride
                           + static_cast<int64_t>(kvh) * d_head;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int pass = 0; pass < NH; ++pass) {
      // the other slice first, the CTA's own last
      const int c = (NH - 1 - pass + own) % NH * DP;
      const int cols = d_head - c;
      __syncthreads();   // the previous readers are done
      if (NH > 1) {
        load_rows<DP>(qs, q + q_off + c, q_stride, sq - q0, cols);
        load_rows<DP>(gs, dout + q_off + c, q_stride, sq - q0, cols);
      }
      load_rows<DP>(ks, k + kv_off + c, kv_stride, sk - k0, cols);
      load_rows<DP>(vs, v + kv_off + c, kv_stride, sk - k0, cols);
      __syncthreads();
      pass_dots<DP>(qs, ks, gs, vs, tr, tc, pass, s, dp);
    }
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
        const int d = own * DP + 64 * c + 4 * dg + e;
        if (d < d_head)
          dq[off + d] = dq_acc[i][4 * c + e] * scale;
      }
  }
}

// ---------------------------------------------------------------------
// bf16: wgmma, Q / dO (dK / dV) or K / V (dQ) through a cp.async ring
// ---------------------------------------------------------------------

constexpr int kWarpgroups = 2;
constexpr int kThreadsMMA = 128 * kWarpgroups;
constexpr int kTile = 64;                    // rows of a warpgroup's tile
constexpr int kStagesKV = 2;

// How a CTA of the bf16 kernels splits its work between its two
// warpgroups, by the padded Dh:
// - up to 128 columns, by rows: each warpgroup owns 64 keys (dK / dV) or
//   64 queries (dQ) and every column of their gradients, so a CTA owns
//   128 rows.  dK / dV waits for a step's products at its end: two ring
//   stages.  dQ keeps Q and dO in registers and leaves a step's dQ
//   products running under the next step's S and dP, so a stage is read
//   while the next computes and the one after loads: three.
// - past 128 (Dh 256), by columns ("split"): both warpgroups share the
//   CTA's 64 rows, each forms the same S and dP over the full width and
//   owns one 128-column half of dK and dV (or of dQ), so the
//   accumulators stay at 64 + 64 (or 64) f32 registers a thread, as at
//   Dh 128; S and dP are formed twice (1.5x the products of one warp-
//   group doing all of it).  The dQ kernel reads Q and dO from shared
//   memory (as register fragments they would be 128 registers a thread
//   at Dh 256) and waits for a step's dQ products at its end: two ring
//   stages.
template <int DP>
struct Geom {
  static constexpr bool kSplit = DP > 128;
  static constexpr int kRows = kSplit ? kTile : kTile * kWarpgroups;
  static constexpr int kCols = kSplit ? DP / 2 : DP;   // a warpgroup's
  static constexpr int kStagesQ = kSplit ? 2 : 3;
};

// dK / dV: K and V (kRows × DP each), a ring of Q and dO tiles (64 × DP)
// with each stage's lse2 and D (2 × 64 f32); dQ: a ring of K and V tiles
// (Q and dO sit in registers, or in split mode in shared memory, 64 × DP
// each).  Plus 1024 bytes of alignment slack.
template <int DP>
constexpr size_t smem_dkdv_mma() {
  return 2 * (2 * static_cast<size_t>(Geom<DP>::kRows) * DP
              + 2 * kStagesKV * kTile * DP)
         + kStagesKV * 2 * kTile * sizeof(float) + 1024;
}
template <int DP>
constexpr size_t smem_dq_mma() {
  return 2 * (2 * static_cast<size_t>(Geom<DP>::kStagesQ) * kTile * DP
              + (Geom<DP>::kSplit ? 2 * kTile * DP : 0)) + 1024;
}

// Warpgroup turns on two named barriers (ids 1 and 2; 0 is
// __syncthreads): a warpgroup issues a step's S and dP products only in
// its turn and passes the turn on once they are issued, so the two
// warpgroups' products alternate on the tensor cores and one
// warpgroup's softmax runs under the other's products.  Warpgroup 1
// passes first, so warpgroup 0 takes the first turn; warpgroup 0 takes
// the last pass after the walk.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(kThreadsMMA)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(2 - wg), "n"(kThreadsMMA)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  // src-size 0 reads nothing and zero-fills the 4 bytes
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// The walk of both kernels, per warpgroup and step: in its turn, the S
// and dP products go out as two commit groups; P is formed as soon as S
// is done, while dP runs on; dK / dV issues dV's products before it
// forms dS.
template <int DP>
__global__ void __launch_bounds__(kThreadsMMA, 1)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int batch, int sq,
                      int sk, int n_heads, int n_kv, int d_head, int causal,
                      int window, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr bool kSplit = Geom<DP>::kSplit;
  constexpr int kRows = Geom<DP>::kRows;
  constexpr int kCols = Geom<DP>::kCols;
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  constexpr uint32_t kStageBytes = kTile * DP * 2;
  const uint32_t s_k = (raw + 1023) & ~1023u;          // kRows × DP
  const uint32_t s_v = s_k + kRows * DP * 2;           // kRows × DP
  const uint32_t s_q = s_v + kRows * DP * 2;           // kStagesKV × 64 × DP
  const uint32_t s_g = s_q + kStagesKV * kStageBytes;  // dO, the same
  const uint32_t s_st = s_g + kStagesKV * kStageBytes;   // (lse2, D) each
  const float* stats = reinterpret_cast<const float*>(smem_raw + (s_st - raw));

  // key block 0 has the most query tiles under a causal mask: it runs first
  const int heads = n_kv * batch;
  const int kb = static_cast<int>(blockIdx.x) / heads;
  const int kvh = static_cast<int>(blockIdx.x) % heads % n_kv;
  const int b = static_cast<int>(blockIdx.x) % heads / n_kv;
  const int k0 = kb * kRows;
  const int group = n_heads / n_kv;
  const int64_t kv_stride = static_cast<int64_t>(n_kv) * d_head;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * d_head;
  const int64_t kv_off = (static_cast<int64_t>(b) * sk + k0) * kv_stride
                         + static_cast<int64_t>(kvh) * d_head;

  // the query tiles that see a key of the block: the walk is every query
  // head of the group and, for each, these tiles, last first (the CTAs
  // of a KV head that run together then read the same Q and dO tiles,
  // which L2 serves once)
  const int k_last = min(k0 + kRows, sk) - 1;
  const int qt_begin = causal ? k0 / kTile : 0;
  const int q_end = window > 0 ? min(sq, k_last + window) : sq;
  const int qt_last = (q_end + kTile - 1) / kTile - 1;
  const int n_q = max(0, qt_last + 1 - qt_begin);
  const int n_steps = group * n_q;

  // step `it` of the walk into ring stage `st`: Q and dO tiles, lse2 and
  // D (zero past Sq: those queries are masked)
  auto load_step = [&](int it, int st) {
    const int h = kvh * group + it / n_q;
    const int q0 = (qt_last - it % n_q) * kTile;
    const int64_t q_off = (static_cast<int64_t>(b) * sq + q0) * q_stride
                          + static_cast<int64_t>(h) * d_head;
    load_tile<DP, kTile, kThreadsMMA>(s_q + st * kStageBytes, q + q_off,
                                      q_stride, sq - q0, d_head, q);
    load_tile<DP, kTile, kThreadsMMA>(s_g + st * kStageBytes, dout + q_off,
                                      q_stride, sq - q0, d_head, dout);
    if (threadIdx.x < 2 * kTile) {
      const int r = threadIdx.x % kTile;
      const bool ok = q0 + r < sq;
      const float* src = threadIdx.x < kTile ? lse : delta;
      cp_async4(s_st + (st * 2 * kTile + threadIdx.x) * 4,
                ok ? src + (static_cast<int64_t>(b) * n_heads + h) * sq
                         + q0 + r
                   : src, ok);
    }
  };

  load_tile<DP, kRows, kThreadsMMA>(s_k, k + kv_off, kv_stride, sk - k0,
                                    d_head, k);
  load_tile<DP, kRows, kThreadsMMA>(s_v, v + kv_off, kv_stride, sk - k0,
                                    d_head, v);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wr = kSplit ? 0 : wg;               // the warpgroup's row tile
  const int col_blk = kSplit ? wg * kCols / 64 : 0;   // its first 64 columns
  const int kw_lo = k0 + kTile * wr;            // this warpgroup's keys
  const int kw_hi = min(kw_lo + kTile - 1, sk - 1);   // < kw_lo: none
  const int key0 = kw_lo + 16 * warp + lane / 4;      // and key0 + 8
  const int c0 = 2 * (lane & 3);   // a thread's accumulator columns: c0 + 8t

  float dv_acc[kCols / 2], dk_acc[kCols / 2];
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) dv_acc[j] = dk_acc[j] = 0.f;

  if (wg == 1) turn_pass(wg);
  for (int it = 0; it < n_steps; ++it) {
    const int st = it & 1;
    cp_async_wait_all();
    fence_proxy_async();   // the copies' writes, seen by wgmma's reads
    __syncthreads();
    if (it + 1 < n_steps) load_step(it + 1, st ^ 1);   // the stage freed
    cp_async_commit();

    const int q0 = (qt_last - it % n_q) * kTile;
    bool any = kw_lo <= kw_hi;
    if (causal) any = any && min(q0 + kTile, sq) - 1 >= kw_lo;
    if (window > 0) any = any && q0 - kw_hi < window;
    if (!any) {   // warpgroup-uniform; the turns go on
      turn_wait(wg);
      turn_pass(wg);
      continue;
    }

    const uint32_t tq = s_q + st * kStageBytes, tg = s_g + st * kStageBytes;
    float s[32], dp[32];   // Sᵀ and dPᵀ: rows keys, columns queries
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc(s_k + wr * kTile * 128, kRows, kk),
                   kmajor_desc(tq, kTile, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc(s_v + wr * kTile * 128, kRows, kk),
                   kmajor_desc(tg, kTile, kk), kk > 0);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();   // S done, dP runs on
    fence_regs(s);

    const bool masked = (causal && kw_lo + kTile - 1 > q0)
                        || (window > 0 && q0 + kTile - 1 - kw_lo >= window)
                        || q0 + kTile > sq || kw_lo + kTile > sk;
    const float* lse_s = stats + st * 2 * kTile;
    const float* d_s = lse_s + kTile;
    // Pᵀ and dSᵀ in bf16 as the A fragments of the four k-steps over the
    // step's queries: accumulator register j = 4t + 2hh + e is key
    // key0 + 8hh, query q0 + 8t + c0 + e, and goes to fragment word j / 2
    uint32_t pa[16], dsa[16];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * t + c0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 4 * t + 2 * hh;
        float p0 = ex2(fmaf(s[j], scale_log2, -l2.x));
        float p1 = ex2(fmaf(s[j + 1], scale_log2, -l2.y));
        if (masked) {   // exactly 0
          const int key = key0 + 8 * hh, qc = q0 + 8 * t + c0;
          p0 = visible(qc, key, sq, sk, causal, window) ? p0 : 0.f;
          p1 = visible(qc + 1, key, sq, sk, causal, window) ? p1 : 0.f;
        }
        s[j] = p0;
        s[j + 1] = p1;
        pa[j / 2] = pack_bf16x2(p0, p1);
      }
    }
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs(dv_acc, pa + 4 * kk,
               mnmajor_desc(tg + col_blk * kTile * 128, kTile, kk));
    wgmma_commit();

    wgmma_wait<1>();   // dP done, dV runs on
    fence_regs(dp);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 d2 = *reinterpret_cast<const float2*>(d_s + 8 * t + c0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 4 * t + 2 * hh;
        dsa[j / 2] = pack_bf16x2(s[j] * (dp[j] - d2.x),
                                 s[j + 1] * (dp[j + 1] - d2.y));
      }
    }
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs(dk_acc, dsa + 4 * kk,
               mnmajor_desc(tq + col_blk * kTile * 128, kTile, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pa);   // read by the register-A products until here
    fence_regs(dsa);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }
  if (wg == 0) turn_wait(wg);

#pragma unroll
  for (int j = 0; j < kCols / 2; j += 2) {
    const int key = key0 + 8 * ((j >> 1) & 1);
    const int col = col_blk * 64 + 8 * (j >> 2) + c0;
    if (key < sk && col < d_head) {
      const int64_t off = (static_cast<int64_t>(b) * sk + key) * kv_stride
                          + static_cast<int64_t>(kvh) * d_head + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(dk_acc[j] * scale, dk_acc[j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dv_acc[j], dv_acc[j + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsMMA, 1)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int batch, int sq,
                    int sk, int n_heads, int n_kv, int d_head, int causal,
                    int window, float scale, float scale_log2, int n_qb) {
  extern __shared__ uint8_t smem_raw[];
  constexpr bool kSplit = Geom<DP>::kSplit;
  constexpr int kRows = Geom<DP>::kRows;
  constexpr int kCols = Geom<DP>::kCols;
  constexpr int kStagesQ = Geom<DP>::kStagesQ;
  constexpr uint32_t kStageBytes = kTile * DP * 2;
  const uint32_t s_k =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023)
      & ~1023u;                                        // kStagesQ × 64 × DP
  const uint32_t s_v = s_k + kStagesQ * kStageBytes;   // the same
  const uint32_t s_q = s_v + kStagesQ * kStageBytes;   // split: 64 × DP
  const uint32_t s_g = s_q + kStageBytes;              // split: dO, the same

  // longest causal rows first: the query block varies slowest, last first
  const int heads = n_heads * batch;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x) / heads;
  const int h = static_cast<int>(blockIdx.x) % heads % n_heads;
  const int b = static_cast<int>(blockIdx.x) % heads / n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q_lo = qb * kRows;
  const int q_hi = min(q_lo + kRows, sq) - 1;
  const int64_t q_stride = static_cast<int64_t>(n_heads) * d_head;
  const int64_t kv_stride = static_cast<int64_t>(n_kv) * d_head;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * sk * kv_stride
                            + kvh * d_head;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * sk * kv_stride
                            + kvh * d_head;

  // the key tiles its queries see
  int kt_end = (sk + kTile - 1) / kTile;
  if (causal) kt_end = min(kt_end, q_hi / kTile + 1);
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / kTile : 0;
  auto load_kv = [&](int kt) {
    const int k1 = kt * kTile;
    const uint32_t st = (kt - kt_begin) % kStagesQ * kStageBytes;
    load_tile<DP, kTile, kThreadsMMA>(s_k + st, kb + k1 * kv_stride,
                                      kv_stride, sk - k1, d_head, k);
    load_tile<DP, kTile, kThreadsMMA>(s_v + st, vb + k1 * kv_stride,
                                      kv_stride, sk - k1, d_head, v);
  };

  if constexpr (kSplit) {   // Q and dO once, with the first K / V tile
    const int64_t q_off = (static_cast<int64_t>(b) * sq + q_lo) * q_stride
                          + static_cast<int64_t>(h) * d_head;
    load_tile<DP, kTile, kThreadsMMA>(s_q, q + q_off, q_stride, sq - q_lo,
                                      d_head, q);
    load_tile<DP, kTile, kThreadsMMA>(s_g, dout + q_off, q_stride,
                                      sq - q_lo, d_head, dout);
  }
  if (kt_begin < kt_end) load_kv(kt_begin);
  cp_async_commit();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wr = kSplit ? 0 : wg;               // the warpgroup's row tile
  const int col_blk = kSplit ? wg * kCols / 64 : 0;   // its first 64 columns
  const int wq_lo = q_lo + kTile * wr;          // this warpgroup's rows
  const int wq_hi = min(wq_lo + kTile - 1, sq - 1);   // < wq_lo: none
  const int row0 = wq_lo + 16 * warp + lane / 4;      // and row0 + 8
  const int c0 = 2 * (lane & 3);
  // the rows' lse2 and D (+inf past Sq: p = 0)
  const int64_t stat = (static_cast<int64_t>(b) * n_heads + h) * sq;
  float lse_r[2], d_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    lse_r[hh] = row < sq ? lse[stat + row] : INFINITY;
    d_r[hh] = row < sq ? delta[stat + row] : 0.f;
  }

  // the warpgroup's Q and dO rows as the A fragments of S = Q Kᵀ and
  // dP = dO Vᵀ, read once from global memory into registers for the
  // whole walk (a quad of lanes reads 16 contiguous bytes): k-step kk,
  // word i is row row0 + 8·(i % 2), columns 16kk + 8·(i / 2) + c0, +1;
  // zero past Sq and Dh
  // (split mode: Q and dO stay in shared memory)
  constexpr int kFrag = kSplit ? 4 : DP / 4;
  uint32_t qa[kFrag], ga[kFrag];
#pragma unroll
  for (int kk = 0; kk < (kSplit ? 0 : DP / 16); ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1);
      const int col = 16 * kk + 8 * (i >> 1) + c0;
      const bool ok = row < sq && col < d_head;
      const int64_t off = (static_cast<int64_t>(b) * sq + row) * q_stride
                          + static_cast<int64_t>(h) * d_head + col;
      qa[4 * kk + i] = ok ? *reinterpret_cast<const uint32_t*>(q + off) : 0u;
      ga[4 * kk + i] =
          ok ? *reinterpret_cast<const uint32_t*>(dout + off) : 0u;
    }

  float dq_acc[kCols / 2];
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) dq_acc[j] = 0.f;
  // dS in bf16 as the A fragments of the four k-steps over a tile's keys:
  // accumulator register j = 4t + 2hh + e is row row0 + 8hh, key
  // k0 + 8t + c0 + e, and goes to fragment word j / 2
  uint32_t dsa[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) dsa[j] = 0u;

  if (wg == 1) turn_pass(wg);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const uint32_t stage = (kt - kt_begin) % kStagesQ * kStageBytes;
    cp_async_wait_all();
    fence_proxy_async();   // the copies' writes, seen by wgmma's reads
    __syncthreads();
    if (kt + 1 < kt_end) load_kv(kt + 1);
    cp_async_commit();

    const int k0 = kt * kTile;
    bool any = wq_lo <= wq_hi;
    if (causal) any = any && k0 <= wq_hi;
    if (window > 0) any = any && k0 + kTile - 1 > wq_lo - window;
    if (!any) {   // warpgroup-uniform; the turns go on
      wgmma_wait_all();
      fence_regs(dsa);
      turn_wait(wg);
      turn_pass(wg);
      continue;
    }

    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    turn_wait(wg);
    wgmma_fence();
    if constexpr (kSplit) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(s, kmajor_desc(s_q, kTile, kk),
                     kmajor_desc(s_k + stage, kTile, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(dp, kmajor_desc(s_g, kTile, kk),
                     kmajor_desc(s_v + stage, kTile, kk), kk > 0);
      wgmma_commit();
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_rs_kmajor(s, qa + 4 * kk, kmajor_desc(s_k + stage, kTile, kk),
                        kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_rs_kmajor(dp, ga + 4 * kk,
                        kmajor_desc(s_v + stage, kTile, kk), kk > 0);
      wgmma_commit();
    }
    turn_pass(wg);
    wgmma_wait<1>();   // the last tile's dQ products and S done
    fence_regs(s);
    fence_regs(dsa);
    fence_regs(dq_acc);

    const bool masked = (causal && k0 + kTile - 1 > wq_lo)
                        || (window > 0 && wq_hi - k0 >= window)
                        || k0 + kTile > sk;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int hh = (j >> 1) & 1;
      float p0 = ex2(fmaf(s[j], scale_log2, -lse_r[hh]));
      float p1 = ex2(fmaf(s[j + 1], scale_log2, -lse_r[hh]));
      if (masked) {   // exactly 0
        const int row = row0 + 8 * hh, kc = k0 + 8 * (j >> 2) + c0;
        p0 = visible(row, kc, sq, sk, causal, window) ? p0 : 0.f;
        p1 = visible(row, kc + 1, sq, sk, causal, window) ? p1 : 0.f;
      }
      s[j] = p0;
      s[j + 1] = p1;
    }
    wgmma_wait_all();   // dP done
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int hh = (j >> 1) & 1;
      dsa[j / 2] = pack_bf16x2(s[j] * (dp[j] - d_r[hh]),
                               s[j + 1] * (dp[j + 1] - d_r[hh]));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs(dq_acc, dsa + 4 * kk,
               mnmajor_desc(s_k + stage + col_blk * kTile * 128, kTile, kk));
    wgmma_commit();   // not waited: runs under the next tile's S and dP
    if constexpr (kSplit) {
      // two stages: the next step's load refills this one
      wgmma_wait_all();
      fence_regs(dsa);
      fence_regs(dq_acc);
    }
  }
  cp_async_wait_all();   // split: Q and dO are in flight with no key tile
  wgmma_wait_all();
  fence_regs(dsa);
  fence_regs(dq_acc);
  if (wg == 0) turn_wait(wg);

#pragma unroll
  for (int j = 0; j < kCols / 2; j += 2) {
    const int row = row0 + 8 * ((j >> 1) & 1);
    const int col = col_blk * 64 + 8 * (j >> 2) + c0;
    if (row < sq && col < d_head) {
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (static_cast<int64_t>(b) * sq + row) * q_stride
          + static_cast<int64_t>(h) * d_head + col) =
          __floats2bfloat162_rn(dq_acc[j] * scale, dq_acc[j + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int batch, int sq, int n_heads, int d_head,
                         cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(batch) * sq * n_heads;
  const int blocks =
      static_cast<int>((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_delta_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, batch,
      sq, n_heads, d_head);
  return cudaGetLastError();
}

template <int DP, int NH>
int launch_f32(const float* q, const float* k, const float* v,
               const float* o, const float* lse, const float* dout,
               float* dq, float* dk, float* dv, float* delta, int batch,
               int sq, int sk, int n_heads, int n_kv, int d_head, int causal,
               int window, float scale, cudaStream_t stream) {
  cudaError_t err = launch_delta<float>(o, dout, delta, batch, sq, n_heads,
                                        d_head, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  auto dkdv = flash_bwd_dkdv_f32_kernel<DP, NH>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkdv<DP>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = (sk + kBT - 1) / kBT;
  dkdv<<<n_kt * n_kv * batch * NH, kThreads, smem_dkdv<DP>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, batch, sq, sk, n_heads, n_kv,
      d_head, causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dqk = flash_bwd_dq_f32_kernel<DP, NH>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dq<DP>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (sq + kBT - 1) / kBT;
  dqk<<<n_qt * n_heads * batch * NH, kThreads, smem_dq<DP>(), stream>>>(
      q, k, v, dout, lse, delta, dq, batch, sq, sk, n_heads, n_kv, d_head,
      causal, window, scale, scale_log2, n_qt);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, const __nv_bfloat16* o,
                const float* lse, const __nv_bfloat16* dout,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                float* delta, int batch, int sq, int sk, int n_heads,
                int n_kv, int d_head, int causal, int window, float scale,
                cudaStream_t stream) {
  cudaError_t err = launch_delta<__nv_bfloat16>(o, dout, delta, batch, sq,
                                                n_heads, d_head, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  auto dkdv = flash_bwd_dkdv_kernel<DP>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkdv_mma<DP>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kb = (sk + Geom<DP>::kRows - 1) / Geom<DP>::kRows;
  dkdv<<<n_kb * n_kv * batch, kThreadsMMA, smem_dkdv_mma<DP>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, batch, sq, sk, n_heads, n_kv,
      d_head, causal, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dqk = flash_bwd_dq_kernel<DP>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dq_mma<DP>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qb = (sq + Geom<DP>::kRows - 1) / Geom<DP>::kRows;
  dqk<<<n_qb * n_heads * batch, kThreadsMMA, smem_dq_mma<DP>(), stream>>>(
      q, k, v, dout, lse, delta, dq, batch, sq, sk, n_heads, n_kv, d_head,
      causal, window, scale, scale_log2, n_qb);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernels' padded Dh (0: not taken): a multiple of 8 up to 256.
int bf16_padded(int d_head) {
  if (d_head <= 0 || d_head % 8 || d_head > 256) return 0;
  return d_head <= 64 ? 64 : d_head <= 128 ? 128 : 256;
}

}  // namespace

extern "C" {

// Dynamic shared memory of the dK/dV kernel, the larger of the two, for
// dtype 0 = float32, 1 = bfloat16 (0: the backward does not take this Dh).
size_t flash_attention_bwd_smem_bytes(int dtype, int d_head) {
  if (dtype == 1) {
    switch (bf16_padded(d_head)) {
      case 64: return smem_dkdv_mma<64>();
      case 128: return smem_dkdv_mma<128>();
      case 256: return smem_dkdv_mma<256>();
    }
    return 0;
  }
  if (dtype != 0 || d_head <= 0 || d_head > 256) return 0;
  return d_head <= 64 ? smem_dkdv<64>() : smem_dkdv<128>();
}

// dtype: 0 = float32, 1 = bfloat16.  q (B, Sq, H, Dh); k, v (B, Sk, KV,
// Dh); o, dout, dq like q; dk, dv like k; lse (B, H, Sq) f32 from the
// forward; delta: (B, H, Sq) f32 scratch.  All contiguous, on one
// device.  float32: Dh up to 256 (past 128 in two column passes);
// bfloat16: Dh a multiple of 8 up to 256, 16-byte aligned tensors.  Three launches on `stream`; returns a
// cudaError_t (0 = success).
int flash_attention_bwd_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const float* lse,
                               const void* dout, void* dq, void* dk, void* dv,
                               float* delta, int batch, int sq, int sk,
                               int n_heads, int n_kv, int d_head, int causal,
                               int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flash_attention_bwd_smem_bytes(dtype, d_head) == 0 || n_heads % n_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* of = static_cast<const float*>(o);
    const float* gf = static_cast<const float*>(dout);
    float* dqf = static_cast<float*>(dq);
    float* dkf = static_cast<float*>(dk);
    float* dvf = static_cast<float*>(dv);
    if (d_head <= 64)
      return launch_f32<64, 1>(qf, kf, vf, of, lse, gf, dqf, dkf, dvf, delta,
                               batch, sq, sk, n_heads, n_kv, d_head, causal,
                               window, scale, s);
    if (d_head <= 128)
      return launch_f32<128, 1>(qf, kf, vf, of, lse, gf, dqf, dkf, dvf,
                                delta, batch, sq, sk, n_heads, n_kv, d_head,
                                causal, window, scale, s);
    return launch_f32<128, 2>(qf, kf, vf, of, lse, gf, dqf, dkf, dvf, delta,
                              batch, sq, sk, n_heads, n_kv, d_head, causal,
                              window, scale, s);
  }
  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(q);
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const bf* ob = static_cast<const bf*>(o);
  const bf* gb = static_cast<const bf*>(dout);
  bf* dqb = static_cast<bf*>(dq);
  bf* dkb = static_cast<bf*>(dk);
  bf* dvb = static_cast<bf*>(dv);
  switch (bf16_padded(d_head)) {
    case 64:
      return launch_bf16<64>(qb, kb, vb, ob, lse, gb, dqb, dkb, dvb, delta,
                             batch, sq, sk, n_heads, n_kv, d_head, causal,
                             window, scale, s);
    case 128:
      return launch_bf16<128>(qb, kb, vb, ob, lse, gb, dqb, dkb, dvb, delta,
                              batch, sq, sk, n_heads, n_kv, d_head, causal,
                              window, scale, s);
  }
  return launch_bf16<256>(qb, kb, vb, ob, lse, gb, dqb, dkb, dvb, delta,
                          batch, sq, sk, n_heads, n_kv, d_head, causal,
                          window, scale, s);
}

}  // extern "C"
