// Mamba-1 selective scan (diagonal SSM), stepwise, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (_mamba_kernel, called through pl.pallas_call in mamba_scan).  For each
// row b and channel c, with an (N,) f32 state h, A (Ci, N), D (Ci,):
//
//   h_t = exp(dt_t · A[c]) ⊙ h_{t-1} + (dt_t · u_t) · B_t
//   y_t = h_t · C_t + D[c] · u_t
//
// starting from h_0 = h0 (zero when none is given) and writing the last
// state.  The TPU kernel starts from zero only; the served path needs a
// start state at every call (prefill continues the slot's state, decode
// is one token from it), so this kernel takes one and advances it in
// place.
//
// What bounds it on the H100: bytes.  Each (token, channel) reads u and
// dt and writes y, and does about 6 flops and one exp per state entry
// (N = 16: ~96 flops and 16 exps against 12 bytes in f32), below the
// fp32 ridge of ~20 flop/byte; B_t and C_t are shared by all Ci channels
// of a row and cost almost nothing.  The exps (S·Ci·N) go to the SFUs,
// whose rate may set the pace where the bytes do not.
//
// Design: one block per (row, group of 128 channels), one thread per
// channel, holding its N state values, its row of A and its D in
// registers for the whole sequence: the state never leaves registers
// between tokens and is not padded or tiled.  B_t and C_t, shared by
// every channel of the row, are staged into shared memory (f32) for a
// chunk of 64 tokens behind one barrier per chunk (double-buffered, so
// the barrier that opens chunk k also closes chunk k - 2's reads of the
// same buffer); reading them is a broadcast.  u_t and dt_t load straight
// from global memory, coalesced across the block's channels, 16 tokens
// at a time into registers, and the next 16 tokens' loads are issued
// before this batch's arithmetic, so their latency hides behind 16
// tokens of work.  Channels past Ci are masked (they stage and meet the
// barriers, nothing else).  It takes any S >= 1 unpadded.  Latency-bound
// at small batch: one block per SM at the jamba prefill shape; making it
// fast (more rows of work per SM, a chunked form) is later work.
//
// In-place state: h0 and h_out may be the same buffer (the wrapper
// passes one pointer for both when a state is given).  That is safe
// because thread c reads its own N entries of h0 once, before its first
// step, and writes only those entries of h_out, after its last step.
// h0 and h_out are therefore not restrict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kChunk = 64;      // tokens of B, C staged per barrier
constexpr int kSub = 16;        // tokens of u, dt in registers at once
static_assert(kChunk % kSub == 0, "a chunk holds whole register batches");

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

// u and dt of tokens t0 .. t0 + kSub - 1 of this thread's channel (zero
// past the sequence's end); ``u`` and ``dt`` point at token 0.
template <typename T>
__device__ __forceinline__ void load_batch(const T* __restrict__ u,
                                           const T* __restrict__ dt,
                                           int64_t ci, int t0, int seq,
                                           float (&uo)[kSub],
                                           float (&dto)[kSub]) {
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const bool in = t0 + j < seq;
    const int64_t off = static_cast<int64_t>(t0 + j) * ci;
    uo[j] = in ? to_f32(u[off]) : 0.f;
    dto[j] = in ? to_f32(dt[off]) : 0.f;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ u,       // (B, S, Ci)
                  const T* __restrict__ dt,      // (B, S, Ci)
                  const float* __restrict__ A,   // (Ci, N)
                  const T* __restrict__ bmat,    // (B, S, N)
                  const T* __restrict__ cmat,    // (B, S, N)
                  const float* __restrict__ D,   // (Ci,)
                  const float* h0,               // (B, Ci, N) or null
                  T* __restrict__ y,             // (B, S, Ci)
                  float* h_out,                  // (B, Ci, N), may alias h0
                  int seq, int ci) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < ci;

  __shared__ float bs[2][kChunk * N];
  __shared__ float cs[2][kChunk * N];

  float a[N], h[N];
  float d = 0.f;
  const int64_t h_off = (static_cast<int64_t>(b) * ci + c) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[static_cast<int64_t>(c) * N + n] : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[h_off + n] : 0.f;
  }
  if (live) d = D[c];

  const int64_t tok0 = static_cast<int64_t>(b) * seq;   // row's token 0
  const T* u_c = u + tok0 * ci + c;
  const T* dt_c = dt + tok0 * ci + c;
  T* y_c = y + tok0 * ci + c;
  const T* b_row = bmat + tok0 * N;
  const T* c_row = cmat + tok0 * N;

  float uc[kSub] = {}, dc[kSub] = {}, un[kSub] = {}, dn[kSub] = {};
  if (live) load_batch(u_c, dt_c, ci, 0, seq, uc, dc);

  for (int t0 = 0; t0 < seq; t0 += kSub) {
    // issue the next batch's loads before anything waits
    if (live && t0 + kSub < seq)
      load_batch(u_c, dt_c, ci, t0 + kSub, seq, un, dn);
    const int buf = (t0 / kChunk) & 1;
    if (t0 % kChunk == 0) {
      const int len = min(kChunk, seq - t0) * N;
      const int64_t off = static_cast<int64_t>(t0) * N;
      for (int i = threadIdx.x; i < len; i += kThreads) {
        bs[buf][i] = to_f32(b_row[off + i]);
        cs[buf][i] = to_f32(c_row[off + i]);
      }
      __syncthreads();
    }
    if (live) {
      const int base = (t0 % kChunk) * N;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (t0 + j < seq) {
          const float* bt = &bs[buf][base + j * N];
          const float* ct = &cs[buf][base + j * N];
          const float dtu = dc[j] * uc[j];
          float acc = 0.f;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            h[n] = fmaf(expf(dc[j] * a[n]), h[n], dtu * bt[n]);
            acc = fmaf(h[n], ct[n], acc);
          }
          acc = fmaf(d, uc[j], acc);
          y_c[static_cast<int64_t>(t0 + j) * ci] = from_f32<T>(acc);
        }
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        uc[j] = un[j];
        dc[j] = dn[j];
      }
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[h_off + n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* u, const void* dt, const float* A, const void* bmat,
           const void* cmat, const float* D, const float* h0, void* y,
           float* h_out, int batch, int seq, int ci, cudaStream_t stream) {
  const dim3 grid((ci + kThreads - 1) / kThreads, batch);
  mamba_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(bmat), static_cast<const T*>(cmat), D, h0,
      static_cast<T*>(y), h_out, seq, ci);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int d_state, const void* u, const void* dt, const float* A,
             const void* bmat, const void* cmat, const float* D,
             const float* h0, void* y, float* h_out, int batch, int seq,
             int ci, cudaStream_t stream) {
  switch (d_state) {
    case 4: return launch<T, 4>(u, dt, A, bmat, cmat, D, h0, y, h_out,
                                batch, seq, ci, stream);
    case 8: return launch<T, 8>(u, dt, A, bmat, cmat, D, h0, y, h_out,
                                batch, seq, ci, stream);
    case 16: return launch<T, 16>(u, dt, A, bmat, cmat, D, h0, y, h_out,
                                  batch, seq, ci, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (u, dt, B, C and y); A, D, h0 and
// h_out are float32.  h0 may be null (zero start) and may equal h_out
// (the state advances in place).  d_state must be 4, 8 or 16 (jamba uses
// 16).  Returns a cudaError_t (0 = success).
int mamba_scan_launch(int dtype, const void* u, const void* dt,
                      const void* A, const void* bmat, const void* cmat,
                      const void* D, const void* h0, void* y, void* h_out,
                      int batch, int seq, int ci, int d_state, void* stream) {
  if (batch < 1 || seq < 1 || ci < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(h_out);
  if (dtype == 0)
    return launch_n<float>(d_state, u, dt, af, bmat, cmat, df, h0f, y, ho,
                           batch, seq, ci, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(d_state, u, dt, af, bmat, cmat, df, h0f,
                                   y, ho, batch, seq, ci, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
