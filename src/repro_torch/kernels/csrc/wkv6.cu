// RWKV6 (Finch) WKV recurrence, stepwise, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py (_wkv6_kernel,
// called through pl.pallas_call in wkv6).  For each (row, head), with a
// (Dh x Dh) f32 state S, per-channel decay w_t and bonus u:
//
//   y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
//   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
//
// starting from S_0 = s0 (zero when none is given) and writing the last
// state.  w is read clipped to [1e-8, 1] in f32, as the JAX model does.
//
// What bounds it on the H100: bytes.  Each token and head costs 4·Dh²
// flops against 4·Dh input and Dh output elements, about Dh/2 flops per
// byte in bf16 (32 at Dh 64), far below the ~295 flop/byte where the
// tensor cores become the limit.  The design reads every input element
// once and writes every output element once: the state never leaves
// registers between steps.  One block per (row, head) runs Dh threads;
// thread e owns column e of S (S[:, e], Dh floats in registers).  At
// each step the block stages r_t, k_t and the clipped w_t in shared
// memory (double-buffered, so one barrier a step suffices) while every
// thread already loads step t + 1's elements into registers, then
// thread e computes
//
//   y_t[e] = Σ_d r_t[d] · (S[d, e] + u[d] · k_t[d] · v_t[e])
//   S[d, e] = w_t[d] · S[d, e] + k_t[d] · v_t[e]
//
// in f32.  This is the stepwise form of upstream RWKV-6's CUDA kernel,
// not the TPU kernel's chunked form: it has no exp(±cumulative decay)
// term, so it stays finite at any decay (the chunked form overflows f32
// once the log-decay summed over a chunk passes ~88), and it takes any
// S >= 1 without padding, a 1-token decode step as well as a prefill.
// The chunked tensor-core form (wgmma on the C x C intra-chunk term) is
// later work; this one is latency-bound, one barrier per token.
//
// In-place state: s0 and s_out may be the same buffer (the wrapper
// passes one pointer for both when a state is given).  That is safe
// because thread e reads column e of s0 once, before its first step,
// and writes only column e of s_out, after its last step; no thread
// touches another's column.  s0 and s_out are therefore not restrict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
wkv6_kernel(const T* __restrict__ r,    // (B, S, H, Dh)
            const T* __restrict__ k,
            const T* __restrict__ v,
            const T* __restrict__ w,
            const T* __restrict__ u,    // (H, Dh)
            const float* s0,            // (B, H, Dh, Dh) or null
            T* __restrict__ y,          // (B, S, H, Dh)
            float* s_out,               // (B, H, Dh, Dh), may alias s0
            int seq, int n_heads) {
  const int bh = blockIdx.x;            // b · H + h
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int e = threadIdx.x;

  __shared__ float rs[2][DH];
  __shared__ float ks[2][DH];
  __shared__ float ws[2][DH];
  __shared__ float us[DH];

  us[e] = to_f32(u[h * DH + e]);
  const int64_t state_off = static_cast<int64_t>(bh) * DH * DH + e;
  float S[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d)
    S[d] = s0 != nullptr ? s0[state_off + static_cast<int64_t>(d) * DH] : 0.f;

  const int64_t t_stride = static_cast<int64_t>(n_heads) * DH;
  int64_t off = (static_cast<int64_t>(b) * seq * n_heads + h) * DH + e;
  float rn = to_f32(r[off]), kn = to_f32(k[off]);
  float vn = to_f32(v[off]), wn = to_f32(w[off]);

  for (int t = 0; t < seq; ++t) {
    const int buf = t & 1;
    rs[buf][e] = rn;
    ks[buf][e] = kn;
    ws[buf][e] = fminf(fmaxf(wn, 1e-8f), 1.f);
    const float vt = vn;
    const int64_t out = off;
    __syncthreads();
    if (t + 1 < seq) {               // prefetch step t + 1
      off += t_stride;
      rn = to_f32(r[off]);
      kn = to_f32(k[off]);
      vn = to_f32(v[off]);
      wn = to_f32(w[off]);
    }
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float kv = ks[buf][d] * vt;
      acc = fmaf(rs[buf][d], fmaf(us[d], kv, S[d]), acc);
      S[d] = fmaf(ws[buf][d], S[d], kv);
    }
    y[out] = from_f32<T>(acc);
  }

#pragma unroll
  for (int d = 0; d < DH; ++d)
    s_out[state_off + static_cast<int64_t>(d) * DH] = S[d];
}

template <typename T, int DH>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const float* s0, void* y, float* s_out, int batch,
           int seq, int n_heads, cudaStream_t stream) {
  wkv6_kernel<T, DH><<<batch * n_heads, DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), s0, static_cast<T*>(y), s_out, seq, n_heads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int d_head, const void* r, const void* k, const void* v,
              const void* w, const void* u, const float* s0, void* y,
              float* s_out, int batch, int seq, int n_heads,
              cudaStream_t stream) {
  switch (d_head) {
    case 4: return launch<T, 4>(r, k, v, w, u, s0, y, s_out, batch, seq,
                                n_heads, stream);
    case 8: return launch<T, 8>(r, k, v, w, u, s0, y, s_out, batch, seq,
                                n_heads, stream);
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, s_out, batch, seq,
                                  n_heads, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, s_out, batch, seq,
                                  n_heads, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, s_out, batch, seq,
                                  n_heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u and y); s0 may be null
// (zero start) and may equal s_out (the state advances in place).
// d_head must be 4, 8, 16, 32 or 64 (rwkv6 uses 64).  Returns a
// cudaError_t (0 = success).
int wkv6_launch(int dtype, const void* r, const void* k, const void* v,
                const void* w, const void* u, const void* s0, void* y,
                void* s_out, int batch, int seq, int n_heads, int d_head,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0f = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  if (dtype == 0)
    return launch_dh<float>(d_head, r, k, v, w, u, s0f, y, so, batch, seq,
                            n_heads, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(d_head, r, k, v, w, u, s0f, y, so,
                                    batch, seq, n_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
