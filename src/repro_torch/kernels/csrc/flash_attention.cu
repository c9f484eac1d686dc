// Flash attention forward (causal / sliding window / GQA) for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, called through pl.pallas_call in flash_attention).
//
// What bounds it on the H100: operations.  At the main path's shapes
// (hundreds of queries per head, Dh 128) attention does ~Sq·Dh/2 flops
// per byte it must read, well above the card's ~295 flop/byte ridge, so
// the bound is the causal FLOPs over the tensor-core rate.  This first
// version keeps the flash structure that makes the bound reachable
// later: one block per (q tile, head, batch) keeps its query tile and
// running (m, l, acc) state on chip and streams K/V tiles of its KV head
// (GQA: head h reads KV head h / G) through shared memory, so nothing of
// size Sq × Sk ever reaches device memory, and tiles wholly masked by
// causality or the window are skipped (about half the causal grid).
// The products themselves run on CUDA cores in f32; wgmma on bf16
// tiles, TMA loads and a K/V ring are later work.  The kernel masks the
// ragged edge itself (queries past Sq, keys past Sk), so the wrapper
// needs no padding copies.
//
// Numerics follow the TPU kernel: f32 scores and statistics, masked
// scores -1e30, m starting at -inf, p rounded to the value dtype before
// the PV product, out = acc / max(l, 1e-30) in the query dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kThreads = 128;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk,
                                        int causal, int window) {
  return qpos < sq && kpos < sk && (!causal || kpos <= qpos)
         && (window <= 0 || qpos - kpos < window);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q,   // (B, Sq, H, Dh)
                       const T* __restrict__ k,   // (B, Sk, KV, Dh)
                       const T* __restrict__ v,
                       T* __restrict__ out,       // (B, Sq, H, Dh)
                       int sq, int sk, int n_heads, int n_kv, int d_head,
                       int causal, int window, float scale) {
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int ldk = d_head + 1;       // padded K rows: no bank conflicts in QK

  extern __shared__ float smem[];
  float* qs = smem;                       // BQ × Dh
  float* acc = qs + kBlockQ * d_head;     // BQ × Dh
  float* ks = acc + kBlockQ * d_head;     // BK × (Dh + 1)
  float* vs = ks + kBlockK * ldk;         // BK × Dh
  float* ps = vs + kBlockK * d_head;      // BQ × BK
  float* m_run = ps + kBlockQ * kBlockK;  // BQ
  float* l_run = m_run + kBlockQ;         // BQ
  float* alpha = l_run + kBlockQ;         // BQ

  for (int e = threadIdx.x; e < kBlockQ * d_head; e += blockDim.x) {
    const int r = e / d_head, d = e % d_head;
    const int qpos = q0 + r;
    qs[e] = qpos < sq
        ? to_f32(q[((static_cast<int64_t>(b) * sq + qpos) * n_heads + h)
                   * d_head + d])
        : 0.f;
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < kBlockQ; r += blockDim.x) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  __syncthreads();

  const int n_tiles = (sk + kBlockK - 1) / kBlockK;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    // tile-level visibility (uniform across the block), as the TPU
    // kernel's pl.when: below-diagonal overlap, and the newest key of
    // the tile inside the oldest query's window
    if (causal && k0 > q0 + kBlockQ - 1) continue;
    if (window > 0 && k0 + kBlockK - 1 <= q0 - window) continue;

    for (int e = threadIdx.x; e < kBlockK * d_head; e += blockDim.x) {
      const int t = e / d_head, d = e % d_head;
      const int kpos = k0 + t;
      float kx = 0.f, vx = 0.f;
      if (kpos < sk) {
        const int64_t off =
            ((static_cast<int64_t>(b) * sk + kpos) * n_kv + kvh) * d_head + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[t * ldk + d] = kx;
      vs[e] = vx;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kBlockQ * kBlockK; e += blockDim.x) {
      const int r = e / kBlockK, t = e % kBlockK;
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

    for (int r = threadIdx.x; r < kBlockQ; r += blockDim.x) {
      float* pr = ps + r * kBlockK;
      float m_new = m_run[r];
      for (int t = 0; t < kBlockK; ++t) m_new = fmaxf(m_new, pr[t]);
      const float a = expf(m_run[r] - m_new);
      float sum = 0.f;
      for (int t = 0; t < kBlockK; ++t) {
        const float p = visible(q0 + r, k0 + t, sq, sk, causal, window)
                            ? expf(pr[t] - m_new) : 0.f;
        sum += p;
        pr[t] = to_f32(from_f32<T>(p));   // p in the value dtype for PV
      }
      m_run[r] = m_new;
      l_run[r] = l_run[r] * a + sum;
      alpha[r] = a;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kBlockQ * d_head; e += blockDim.x) {
      const int r = e / d_head, d = e % d_head;
      const float* pr = ps + r * kBlockK;
      float x = acc[e] * alpha[r];
      for (int t = 0; t < kBlockK; ++t) {
        if (pr[t] != 0.f) x = fmaf(pr[t], vs[t * d_head + d], x);
      }
      acc[e] = x;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < kBlockQ * d_head; e += blockDim.x) {
    const int r = e / d_head, d = e % d_head;
    const int qpos = q0 + r;
    if (qpos < sq) {
      out[((static_cast<int64_t>(b) * sq + qpos) * n_heads + h) * d_head + d] =
          from_f32<T>(acc[e] / fmaxf(l_run[r], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int sk, int n_heads, int n_kv, int d_head, int causal,
           int window, float scale, size_t smem, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T>;
  if (smem > 48 * 1024) {   // above 48 KB only after an explicit opt-in
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, n_heads, n_kv,
      d_head, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the wrapper checks it
// against the card's limit before launching).
size_t flash_attention_smem_bytes(int d_head) {
  return sizeof(float) * (2 * kBlockQ * d_head + kBlockK * (d_head + 1)
                          + kBlockK * d_head + kBlockQ * kBlockK
                          + 3 * kBlockQ);
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, int batch, int sq,
                           int sk, int n_heads, int n_kv, int d_head,
                           int causal, int window, float scale,
                           void* stream) {
  const size_t smem = flash_attention_smem_bytes(d_head);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, batch, sq, sk, n_heads, n_kv, d_head,
                         causal, window, scale, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, batch, sq, sk, n_heads, n_kv,
                                 d_head, causal, window, scale, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
