// Paged attention over a block-paged KV pool, decode (Q = 1) and
// verify (Q > 1), float and int8 pools, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (_paged_kernel, called through pl.pallas_call in paged_attention).
//
// What bounds it on the H100: bytes, and at decode sizes latency.  A
// decode step reads every live page of K and V once and does 4·Q·G·Dh
// flops per key, two orders of magnitude below the ~295 flop/byte where
// bf16 tensor cores become the limit.  The main path's call (2 rows ×
// 528 keys, 40 / 8 heads, Dh 128, bf16) moves 4.3 MB, 1.3 µs at
// 3.35 TB/s; the TPU kernel's grid walks a row's pages in order, and a
// copy of that order (one block per (row, KV head), 16 blocks on 132
// SMs, one page after another) spends ~13 µs a page in latency.
//
// Design: flash-decoding (split-K over pages).
// - The grid is (splits, KV heads, batch rows).  Split j walks its own
//   contiguous range of the row's pages and writes an f32 partial
//   (m, l, acc) for each of its Q·G query rows (the TPU kernel's
//   row-flattened (Q·G, page) tile: row r is query r / G of head
//   kvh·G + r % G) to a scratch tensor; paged_attention_merge_kernel
//   merges the splits (rescale by exp(m_j − M), divide by the merged l)
//   into q's dtype.  A split with no live page writes m = −inf, l = 0
//   and gets weight 0 without forming −inf − (−inf).  The host picks
//   the split count from static shapes only (table width, rows, KV
//   heads, SMs): lengths are never read on the host, each split finds
//   its own live pages.
// - Inside a split, live pages stream through a ring of kStages page
//   slots (K and V of one KV head) filled by cp.async copies of kChunk
//   bytes (16, or 8 for a row of 8 mod 16 bytes: int8 at Dh 120, whose
//   rows of one KV head start 8-byte aligned in the pool), kStages − 1
//   pages ahead of the one being scored.  The page id is
//   loaded first and a page is fetched only when it is live, so a dead
//   page (which may hold NaN, or a −1 entry with no address) is never
//   read.  Two __syncthreads per page.
// - Scores: the warps split the page's keys; a key's Dh is split into
//   kChunk-byte chunks across lanes, each chunk scored against 8 query rows
//   at once, the dot products summed with shuffles.  Softmax and P·V:
//   a warp per query row, its lanes owning 4 adjacent Dh columns of the
//   row's f32 accumulator.  No page is staged in f32.
//
// Numerics follow the TPU kernel: scores and statistics in f32, masked
// scores -1e30, m starting at -inf, p rounded to the value dtype before
// the PV product.  A masked key contributes an exact zero (its product
// is skipped, never 0 · NaN): an unallocated or partly written page may
// hold NaN.
//
// int8 pools (the TPU kernel's quantized branch): the pool element type
// is int8_t and two (P, KV) f32 scale planes ride beside the pools,
// read once per (page, KV head) with the same table entry as the page.
// K and V are dequantized in registers in f32 (int8 · scale); q is
// converted to f32, and the value dtype is f32, so p is not rounded.
// The output is in q's dtype.  A dead page's payload and scale are
// never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kRowTile = 8;   // query rows scored together
constexpr unsigned kFull = 0xffffffffu;

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

// The page id of a row's page i if the page is live for the row's
// oldest query (allocated, not past the length, not wholly outside the
// window), else -1: the TPU kernel's page-level test.
__device__ __forceinline__ int live_page(const int* row_table, int i,
                                         int page, int length, int min_qpos,
                                         int window) {
  if (i * page >= length) return -1;
  if (window > 0 && min_qpos - (i * page + page - 1) >= window) return -1;
  return row_table[i];   // -1 when unallocated
}

// kBytes from global src to shared dst: 16 bypass L1 (.cg); 8 must go
// through it (.ca takes 4, 8 or 16)
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
  } else {
    static_assert(kBytes == 8, "16- or 8-byte chunks");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(dst), "l"(src) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A 32-bit word of pool elements as f32, without taking an address:
// 2 bf16 (f32 is bf16 with 16 more mantissa bits) or 4 int8.
__device__ __forceinline__ void unpack(uint32_t w, float* x, __nv_bfloat16) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(uint32_t w, float* x, int8_t) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}
__device__ __forceinline__ void unpack(uint32_t w, float* x, float) {
  x[0] = __uint_as_float(w);
}

// N pool elements at p (16 bytes: a chunk, or 4 columns) as f32
template <typename TP, int N>
__device__ __forceinline__ void load_f32(const uint8_t* p, float (&x)[N]) {
  constexpr int kWords = N * sizeof(TP) / 4;
  constexpr int kPerWord = 4 / sizeof(TP);
  static_assert(kWords == 4 || kWords == 2 || kWords == 1, "16/8/4 bytes");
  uint32_t w[kWords];
  if constexpr (kWords == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (kWords == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) unpack(w[i], x + i * kPerWord, TP());
}

// T: q and output type; TP: pool element type (T, or int8_t with the
// scale planes k_scale / v_scale, (P, KV) f32; null for float pools);
// kChunk: bytes a copy and a scored chunk (16, or 8 where a row is 8
// mod 16 bytes).
template <typename T, typename TP, int kChunk>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,            // (B, Q, H, Dh)
                       const TP* __restrict__ k_pages,     // (P, page, KV, Dh)
                       const TP* __restrict__ v_pages,
                       const float* __restrict__ k_scale,  // (P, KV) or null
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,     // (B, n_pages)
                       const int* __restrict__ lengths,    // (B,)
                       float* __restrict__ part_ml,   // (B, KV, S, Q·G, 2)
                       float* __restrict__ part_acc,  // (B, KV, S, Q·G, Dh)
                       int q_len, int n_heads, int n_kv, int d_head, int page,
                       int n_pages, int pages_per_split, int window,
                       float scale) {
  constexpr bool kInt8 = std::is_same<TP, int8_t>::value;
  constexpr int kElems = kChunk / sizeof(TP);      // pool elements a chunk
  static_assert(kElems % 4 == 0, "a chunk is scored 4 q columns at a time");
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int group = n_heads / n_kv;
  const int rows = q_len * group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_bytes = d_head * static_cast<int>(sizeof(TP));
  const int n_chunks = row_bytes / kChunk;       // chunks a row
  // lanes a key: the largest power of two <= min(chunks, 32)
  int lanes_per_key = 1;
  while (lanes_per_key * 2 <= min(n_chunks, 32)) lanes_per_key *= 2;
  const int keys_per_pass = 32 / lanes_per_key;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                          // kStages × (K, V) pages
  const int slot_bytes = 2 * page * row_bytes;
  float* qs = reinterpret_cast<float*>(ring + kStages * slot_bytes);
  float* acc = qs + rows * d_head;               // rows × Dh
  float* sc = acc + rows * d_head;               // rows × page
  float* m_run = sc + rows * page;               // rows
  float* l_run = m_run + rows;                   // rows

  const int* row_table = tables + static_cast<int64_t>(b) * n_pages;
  const int length = lengths[b];
  const int min_qpos = length - q_len;
  // this split's pages, clipped to the length and the window
  int lo = split * pages_per_split;
  const int hi = min(lo + pages_per_split,
                     min(n_pages, (length + page - 1) / page));
  if (window > 0) lo = max(lo, max(0, min_qpos - window + 1) / page);

  for (int e = threadIdx.x; e < rows * d_head; e += kThreads) {
    const int r = e / d_head, d = e % d_head;
    const int head = kvh * group + r % group;
    qs[e] = to_f32(q[((static_cast<int64_t>(b) * q_len + r / group) * n_heads
                      + head) * d_head + d]);
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  auto fetch = [&](int i) {   // page i into its slot, if live
    if (i < hi) {
      const int pid = live_page(row_table, i, page, length, min_qpos, window);
      if (pid >= 0) {
        const uint32_t slot = ring_s + ((i - lo) % kStages) * slot_bytes;
        const int64_t base = (static_cast<int64_t>(pid) * page * n_kv + kvh)
                             * d_head;
        for (int c = threadIdx.x; c < page * n_chunks; c += kThreads) {
          const int t = c / n_chunks, ch = c % n_chunks;
          const int64_t off = base + static_cast<int64_t>(t) * n_kv * d_head;
          const uint32_t dst = slot + t * row_bytes + ch * kChunk;
          cp_async<kChunk>(dst, reinterpret_cast<const uint8_t*>(
                                    k_pages + off) + ch * kChunk);
          cp_async<kChunk>(dst + page * row_bytes,
                           reinterpret_cast<const uint8_t*>(v_pages + off)
                               + ch * kChunk);
        }
      }
    }
    cp_async_commit();   // one group per page index, empty when dead
  };
  for (int s = 0; s < kStages - 1; ++s) fetch(lo + s);

  for (int i = lo; i < hi; ++i) {
    cp_async_wait<kStages - 2>();   // page i has landed
    __syncthreads();                // ... for every thread; slot of i-1 free
    fetch(i + kStages - 1);
    const int pid = live_page(row_table, i, page, length, min_qpos, window);
    if (pid < 0) continue;          // block-uniform
    const uint8_t* ks = ring + ((i - lo) % kStages) * slot_bytes;
    const uint8_t* vs = ks + page * row_bytes;
    float k_sc = 1.f, v_sc = 1.f;
    if constexpr (kInt8) {
      k_sc = k_scale[static_cast<int64_t>(pid) * n_kv + kvh];
      v_sc = v_scale[static_cast<int64_t>(pid) * n_kv + kvh];
    }
    const int k0 = i * page;

    // scores: the warps split the page's keys, lanes_per_key lanes a
    // key, one kChunk-byte chunk a lane; each K chunk is scored against
    // kRowTile query rows at once and the dot products are summed over
    // the key's lanes with shuffles
    for (int t0 = warp * keys_per_pass; t0 < page;
         t0 += kWarps * keys_per_pass) {
      const int t = t0 + lane / lanes_per_key;
      for (int r0 = 0; r0 < rows; r0 += kRowTile) {
        float dot[kRowTile];
#pragma unroll
        for (int j = 0; j < kRowTile; ++j) dot[j] = 0.f;
        if (t < page) {
          for (int ch = lane % lanes_per_key; ch < n_chunks;
               ch += lanes_per_key) {
            float kx[kElems];
            load_f32<TP>(ks + t * row_bytes + ch * kChunk, kx);
            if constexpr (kInt8) {   // dequantize in f32, as the TPU tile
#pragma unroll
              for (int e = 0; e < kElems; ++e) kx[e] *= k_sc;
            }
#pragma unroll
            for (int j = 0; j < kRowTile; ++j) {
              if (r0 + j < rows) {
                const float4* qc = reinterpret_cast<const float4*>(
                    qs + (r0 + j) * d_head + ch * kElems);
#pragma unroll
                for (int e = 0; e < kElems; e += 4) {
                  const float4 qv = qc[e / 4];
                  dot[j] = fmaf(qv.x, kx[e], dot[j]);
                  dot[j] = fmaf(qv.y, kx[e + 1], dot[j]);
                  dot[j] = fmaf(qv.z, kx[e + 2], dot[j]);
                  dot[j] = fmaf(qv.w, kx[e + 3], dot[j]);
                }
              }
            }
          }
        }
        for (int o = lanes_per_key / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int j = 0; j < kRowTile; ++j)
            dot[j] += __shfl_xor_sync(kFull, dot[j], o);
        }
        if (t < page && lane % lanes_per_key == 0) {
#pragma unroll
          for (int j = 0; j < kRowTile; ++j) {
            const int r = r0 + j;
            if (r < rows)
              sc[r * page + t] = visible(min_qpos + r / group, k0 + t, window)
                                     ? dot[j] * scale : kMasked;
          }
        }
      }
    }
    __syncthreads();

    // each warp takes its rows' softmax over the page and P·V, its lanes
    // owning 4 adjacent Dh columns each
    for (int r = warp; r < rows; r += kWarps) {
      const int qpos = min_qpos + r / group;
      float* pr = sc + r * page;
      const float m_old = m_run[r];
      float m_new = m_old;
      for (int t = lane; t < page; t += 32) m_new = fmaxf(m_new, pr[t]);
      for (int o = 16; o > 0; o >>= 1)
        m_new = fmaxf(m_new, __shfl_xor_sync(kFull, m_new, o));
      const float a = expf(m_old - m_new);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = visible(qpos, k0 + t, window)
                            ? expf(pr[t] - m_new) : 0.f;
        sum += p;
        // p in the value dtype for PV: T for float pools, f32 for int8
        pr[t] = kInt8 ? p : to_f32(from_f32<T>(p));
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      __syncwarp();
      if (lane == 0) {
        m_run[r] = m_new;
        l_run[r] = l_run[r] * a + sum;
      }
      float* ar = acc + r * d_head;
      for (int d = 4 * lane; d < d_head; d += 128) {
        float4 x = *reinterpret_cast<float4*>(ar + d);
        x.x *= a; x.y *= a; x.z *= a; x.w *= a;
#pragma unroll 4
        for (int t = 0; t < page; ++t) {
          const float p = pr[t];
          if (p != 0.f) {   // warp-uniform: never 0 · NaN
            float vx[4];
            load_f32<TP>(vs + t * row_bytes + d * sizeof(TP), vx);
            if constexpr (kInt8) {
#pragma unroll
              for (int e = 0; e < 4; ++e) vx[e] *= v_sc;
            }
            x.x = fmaf(p, vx[0], x.x);
            x.y = fmaf(p, vx[1], x.y);
            x.z = fmaf(p, vx[2], x.z);
            x.w = fmaf(p, vx[3], x.w);
          }
        }
        *reinterpret_cast<float4*>(ar + d) = x;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the last page's rows, and a split with no page

  // partials (a split with no live page: -inf, 0, 0)
  const int64_t part = ((static_cast<int64_t>(b) * n_kv + kvh) * n_splits
                        + split) * rows;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    part_ml[(part + r) * 2] = m_run[r];
    part_ml[(part + r) * 2 + 1] = l_run[r];
  }
  for (int e = threadIdx.x; e < rows * d_head; e += kThreads)
    part_acc[part * d_head + e] = acc[e];
}

// Merge the splits of one query row of a KV head: out = Σ_j acc_j·w_j /
// Σ_j l_j·w_j with w_j = exp(m_j − M), M = max_j m_j; a split with
// m_j = −inf has weight 0, and a row with no live key anywhere gives 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc,
                   T* __restrict__ out,   // (B, Q, H, Dh)
                   int n_splits, int q_len, int n_heads, int n_kv,
                   int d_head) {
  const int r = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv;
  const int rows = q_len * group;
  const int64_t base = (static_cast<int64_t>(b) * n_kv + kvh) * n_splits;
  float m_max = -INFINITY;
  for (int j = 0; j < n_splits; ++j)
    m_max = fmaxf(m_max, part_ml[((base + j) * rows + r) * 2]);
  const int head = kvh * group + r % group;
  T* o = out + ((static_cast<int64_t>(b) * q_len + r / group) * n_heads + head)
               * d_head;
  for (int d = threadIdx.x; d < d_head; d += kThreads) {
    float num = 0.f, den = 0.f;
    if (m_max != -INFINITY) {
      for (int j = 0; j < n_splits; ++j) {
        const float m = part_ml[((base + j) * rows + r) * 2];
        if (m == -INFINITY) continue;
        const float w = expf(m - m_max);
        den = fmaf(part_ml[((base + j) * rows + r) * 2 + 1], w, den);
        num = fmaf(part_acc[((base + j) * rows + r) * d_head + d], w, num);
      }
    }
    o[d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

size_t split_smem(int q_len, int group, int d_head, int page, int pool_bytes) {
  const size_t rows = static_cast<size_t>(q_len) * group;
  return static_cast<size_t>(kStages) * 2 * page * d_head * pool_bytes
         + sizeof(float) * (2 * rows * d_head + rows * page + 2 * rows);
}

template <typename T, typename TP, int kChunk>
int launch_chunked(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* lengths, void* part_ml, void* part_acc, void* out,
           int batch, int q_len, int n_heads, int n_kv, int d_head, int page,
           int n_pages, int n_splits, int pages_per_split, int window,
           float scale, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, TP, kChunk>;
  const size_t smem = split_smem(q_len, n_heads / n_kv, d_head, page,
                                 sizeof(TP));
  if (smem > 48 * 1024) {   // above 48 KB only after an explicit opt-in
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(n_splits, n_kv, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), q_len, n_heads, n_kv, d_head, page,
      n_pages, pages_per_split, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attention_merge_kernel<T><<<dim3(q_len * (n_heads / n_kv), n_kv, batch),
                          kThreads, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), n_splits, q_len, n_heads, n_kv, d_head);
  return static_cast<int>(cudaGetLastError());
}

// rows of a multiple of 16 bytes take 16-byte chunks, rows of 8 mod 16
// bytes (int8 at Dh 120) 8-byte ones; the wrapper refuses any other
template <typename T, typename TP>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* lengths, void* part_ml, void* part_acc, void* out,
           int batch, int q_len, int n_heads, int n_kv, int d_head, int page,
           int n_pages, int n_splits, int pages_per_split, int window,
           float scale, cudaStream_t stream) {
  const int row_bytes = d_head * static_cast<int>(sizeof(TP));
  if (d_head % 4 || row_bytes % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = launch_chunked<T, TP, 16>;
  if constexpr (sizeof(TP) <= 2) {   // an f32 row of Dh % 4 == 0 is 16·n
    if (row_bytes % 16) go = launch_chunked<T, TP, 8>;
  }
  return go(q, k_pages, v_pages, k_scale, v_scale, tables, lengths, part_ml,
            part_acc, out, batch, q_len, n_heads, n_kv, d_head, page,
            n_pages, n_splits, pages_per_split, window, scale, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one split block needs (the wrapper
// checks it against the card's limit before launching); pool_bytes is
// the pool element's size (4 f32, 2 bf16, 1 int8).
size_t paged_attention_smem_bytes(int q_len, int group, int d_head, int page,
                                  int pool_bytes) {
  return split_smem(q_len, group, d_head, page, pool_bytes);
}

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output).  part_ml
// (B, KV, splits, Q·G, 2) and part_acc (B, KV, splits, Q·G, Dh) are f32
// scratch.  Returns a cudaError_t (0 = success).
int paged_attention_launch(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* tables,
                           const void* lengths, void* part_ml, void* part_acc,
                           void* out, int batch, int q_len, int n_heads,
                           int n_kv, int d_head, int page, int n_pages,
                           int n_splits, int pages_per_split, int window,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, k_pages, v_pages, nullptr, nullptr,
                                tables, lengths, part_ml, part_acc, out,
                                batch, q_len, n_heads, n_kv, d_head, page,
                                n_pages, n_splits, pages_per_split, window,
                                scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, tables, lengths, part_ml,
        part_acc, out, batch, q_len, n_heads, n_kv, d_head, page, n_pages,
        n_splits, pages_per_split, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 pools with (P, KV) f32 scale planes; dtype (0 = float32,
// 1 = bfloat16) is q's and the output's.  Returns a cudaError_t.
int paged_attention_int8_launch(int dtype, const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scale,
                                const void* v_scale, const void* tables,
                                const void* lengths, void* part_ml,
                                void* part_acc, void* out, int batch,
                                int q_len, int n_heads, int n_kv, int d_head,
                                int page, int n_pages, int n_splits,
                                int pages_per_split, int window, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                 tables, lengths, part_ml, part_acc, out,
                                 batch, q_len, n_heads, n_kv, d_head, page,
                                 n_pages, n_splits, pages_per_split, window,
                                 scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, tables, lengths, part_ml,
        part_acc, out, batch, q_len, n_heads, n_kv, d_head, page, n_pages,
        n_splits, pages_per_split, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
