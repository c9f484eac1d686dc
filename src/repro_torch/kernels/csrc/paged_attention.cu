// Paged attention over a block-paged KV pool, decode (Q = 1) and
// verify (Q > 1), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (_paged_kernel, called through pl.pallas_call in paged_attention).
//
// What bounds it on the H100: bytes.  A decode step reads every live
// page of K and V once and does 4·Q·G·Dh flops per key, two orders of
// magnitude below the ~295 flop/byte where bf16 tensor cores become the
// limit.  The design therefore reads each live page exactly once per
// (row, KV head): one block per (row, KV head) walks the row's own page
// table, stages one K and one V page in shared memory, and scores all
// Q·G query rows of that KV head against it (the TPU kernel's
// row-flattened (Q·G, page) tile), carrying the running (m, l, acc)
// softmax state in shared memory across pages.  Pages that are
// unallocated, past the length, or wholly outside the window are
// skipped by the same test as the TPU kernel, so a short row costs only
// its own pages.  This first version uses CUDA cores; parallelism is
// rows × KV heads blocks, which leaves most SMs idle at small batch
// (split-K over pages and TMA loads are later work).
//
// Numerics follow the TPU kernel: scores and statistics in f32, masked
// scores -1e30, m starting at -inf, p rounded to the value dtype before
// the PV product.  A masked key contributes an exact zero (its product
// is skipped, never 0 * NaN): an unallocated or partly written page may
// hold NaN.
//
// int8 pools (the TPU kernel's quantized branch): the pool element type
// is int8_t and two (P, KV) f32 scale planes ride beside the pools,
// read with the same table entry as the page.  K and V are dequantized
// in f32 (int8 · scale) as they are staged into shared memory, which
// holds f32 for either pool type, so the shared-memory size is the
// same; q is converted to f32, and the value dtype is f32, so p is not
// rounded before the PV product.  The output is in q's dtype.  A dead
// page's payload and scale are never read: the page-level test skips
// it before staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

// T: q and output type; TP: pool element type (T, or int8_t with the
// scale planes k_scale / v_scale, (P, KV) f32; null for float pools).
template <typename T, typename TP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,        // (B, Q, H, Dh)
                       const TP* __restrict__ k_pages, // (P, page, KV, Dh)
                       const TP* __restrict__ v_pages,
                       const float* __restrict__ k_scale,  // (P, KV) or null
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,  // (B, n_pages)
                       const int* __restrict__ lengths, // (B,)
                       T* __restrict__ out,             // (B, Q, H, Dh)
                       int q_len, int n_heads, int n_kv, int d_head,
                       int page, int n_pages, int window, float scale) {
  constexpr bool kInt8 = std::is_same<TP, int8_t>::value;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = n_heads / n_kv;
  const int rows = q_len * group;   // row r: query r / group, head kvh·G + r % G
  const int ldk = d_head + 1;       // padded K rows: no bank conflicts in QK

  extern __shared__ float smem[];
  float* qs = smem;                      // rows × Dh
  float* acc = qs + rows * d_head;       // rows × Dh
  float* ks = acc + rows * d_head;       // page × (Dh + 1)
  float* vs = ks + page * ldk;           // page × Dh
  float* ps = vs + page * d_head;        // rows × page
  float* m_run = ps + rows * page;       // rows
  float* l_run = m_run + rows;           // rows
  float* alpha = l_run + rows;           // rows

  const int length = lengths[b];
  const int min_qpos = length - q_len;

  for (int e = threadIdx.x; e < rows * d_head; e += blockDim.x) {
    const int r = e / d_head, d = e % d_head;
    const int head = kvh * group + r % group;
    qs[e] = to_f32(q[((static_cast<int64_t>(b) * q_len + r / group) * n_heads
                      + head) * d_head + d]);
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  __syncthreads();

  for (int i = 0; i < n_pages; ++i) {
    const int pid = tables[b * n_pages + i];
    // page-level visibility (uniform across the block): the oldest
    // query sees the most of the past, so a page outside its window is
    // outside every query's window
    bool live = pid >= 0 && i * page < length;
    if (window > 0) live = live && (min_qpos - (i * page + page - 1) < window);
    if (!live) continue;

    const int64_t base = static_cast<int64_t>(pid) * page * n_kv * d_head;
    float k_sc = 1.f, v_sc = 1.f;
    if constexpr (kInt8) {
      k_sc = k_scale[static_cast<int64_t>(pid) * n_kv + kvh];
      v_sc = v_scale[static_cast<int64_t>(pid) * n_kv + kvh];
    }
    for (int e = threadIdx.x; e < page * d_head; e += blockDim.x) {
      const int t = e / d_head, d = e % d_head;
      const int64_t off = base + (static_cast<int64_t>(t) * n_kv + kvh) * d_head + d;
      if constexpr (kInt8) {   // dequantize in f32 while staging
        ks[t * ldk + d] = to_f32(k_pages[off]) * k_sc;
        vs[e] = to_f32(v_pages[off]) * v_sc;
      } else {
        ks[t * ldk + d] = to_f32(k_pages[off]);
        vs[e] = to_f32(v_pages[off]);
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < rows * page; e += blockDim.x) {
      const int r = e / page, t = e % page;
      float s = kMasked;
      if (visible(min_qpos + r / group, i * page + t, window)) {
        const float* qr = qs + r * d_head;
        const float* kt = ks + t * ldk;
        float dot = 0.f;
        for (int d = 0; d < d_head; ++d) dot = fmaf(qr[d], kt[d], dot);
        s = dot * scale;
      }
      ps[e] = s;
    }
    __syncthreads();

    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int qpos = min_qpos + r / group;
      float* pr = ps + r * page;
      float m_new = m_run[r];
      for (int t = 0; t < page; ++t) m_new = fmaxf(m_new, pr[t]);
      const float a = expf(m_run[r] - m_new);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = visible(qpos, i * page + t, window)
                            ? expf(pr[t] - m_new) : 0.f;
        sum += p;
        // p in the value dtype for PV: T for float pools, f32 for int8
        pr[t] = kInt8 ? p : to_f32(from_f32<T>(p));
      }
      m_run[r] = m_new;
      l_run[r] = l_run[r] * a + sum;
      alpha[r] = a;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < rows * d_head; e += blockDim.x) {
      const int r = e / d_head, d = e % d_head;
      const float* pr = ps + r * page;
      float x = acc[e] * alpha[r];
      for (int t = 0; t < page; ++t) {
        if (pr[t] != 0.f) x = fmaf(pr[t], vs[t * d_head + d], x);
      }
      acc[e] = x;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < rows * d_head; e += blockDim.x) {
    const int r = e / d_head, d = e % d_head;
    const int head = kvh * group + r % group;
    out[((static_cast<int64_t>(b) * q_len + r / group) * n_heads + head)
        * d_head + d] = from_f32<T>(acc[e] / fmaxf(l_run[r], 1e-30f));
  }
}

template <typename T, typename TP>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* lengths, void* out, int batch, int q_len, int n_heads,
           int n_kv, int d_head, int page, int n_pages, int window,
           float scale, size_t smem, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, TP>;
  if (smem > 48 * 1024) {   // above 48 KB only after an explicit opt-in
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(batch, n_kv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), q_len, n_heads,
      n_kv, d_head, page, n_pages, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the wrapper checks it
// against the card's limit before launching).  Pages are staged in f32
// whatever the pool type, so int8 pools need the same bytes.
size_t paged_attention_smem_bytes(int q_len, int group, int d_head, int page) {
  const size_t rows = static_cast<size_t>(q_len) * group;
  return sizeof(float) * (2 * rows * d_head + page * (d_head + 1)
                          + page * d_head + rows * page + 3 * rows);
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int paged_attention_launch(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* tables,
                           const void* lengths, void* out, int batch,
                           int q_len, int n_heads, int n_kv, int d_head,
                           int page, int n_pages, int window, float scale,
                           void* stream) {
  const size_t smem =
      paged_attention_smem_bytes(q_len, n_heads / n_kv, d_head, page);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, k_pages, v_pages, nullptr, nullptr,
                                tables, lengths, out, batch, q_len, n_heads,
                                n_kv, d_head, page, n_pages, window, scale,
                                smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, tables, lengths, out, batch,
        q_len, n_heads, n_kv, d_head, page, n_pages, window, scale, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 pools with (P, KV) f32 scale planes; dtype (0 = float32,
// 1 = bfloat16) is q's and the output's.  Returns a cudaError_t.
int paged_attention_int8_launch(int dtype, const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scale,
                                const void* v_scale, const void* tables,
                                const void* lengths, void* out, int batch,
                                int q_len, int n_heads, int n_kv, int d_head,
                                int page, int n_pages, int window,
                                float scale, void* stream) {
  const size_t smem =
      paged_attention_smem_bytes(q_len, n_heads / n_kv, d_head, page);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                 tables, lengths, out, batch, q_len, n_heads,
                                 n_kv, d_head, page, n_pages, window, scale,
                                 smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, tables, lengths, out, batch,
        q_len, n_heads, n_kv, d_head, page, n_pages, window, scale, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
