// Mamba-1 selective scan backward for sm_90a: the gradients of the scan
// from a zero state, by state checkpoints and recomputation.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/
// mamba_scan.py has no backward, and JAX trains through autograd of its
// jnp twin (src/repro/models/nn.py::selective_scan).  The port's training
// path on the card runs this kernel in its place.  Per row b and channel
// c, with a_t = exp(dt_t A[c]) (N,), h_t = a_t ⊙ h_{t-1} + dt_t u_t B_t,
// y_t = h_t · C_t + D[c] u_t and dh_t = dL/dh_t (the last state carries
// no gradient):
//
//   dh_t  = C_t dy_t + a_{t+1} ⊙ dh_{t+1}
//   du_t  = dt_t Σ_n dh_t ⊙ B_t + D[c] dy_t
//   ddt_t = Σ_n dh_t ⊙ (A[c] ⊙ a_t ⊙ h_{t-1} + u_t B_t)
//   dA[c] = Σ_{b,t} dh_t ⊙ dt_t a_t ⊙ h_{t-1}
//   dB_t  = Σ_c dh_t dt_t u_t,      dC_t = Σ_c h_t dy_t
//   dD[c] = Σ_{b,t} dy_t u_t
//
// (kernels/mamba_scan.py::mamba_scan_bwd_plain is the same arithmetic in
// PyTorch.)  The reverse pass needs h_{t-1}; dividing the recurrence
// backwards (h_{t-1} = (h_t - dt u B) / a_t) blows up where a_t is
// small, so h is checkpointed every kT tokens, (B, S / kT, Ci, N) f32
// (134 MB at the jamba training call (1, 4096, 8192, 16)), and each
// chunk's kT states are recomputed into registers from its checkpoint.
//
// Layout, as the forward kernel's: a channel's N state entries over L =
// N / 4 adjacent lanes, P = 4 entries a lane (its dh, its A, its kT
// recomputed states in registers); a block takes kCh = 64 channels of
// one row.  A chunk's u, dt, dy (the block's channels) and B, C (the
// row's) are staged in shared memory.  du and ddt sum over a channel's
// lanes by shuffles; dB_t and dC_t sum over channels: over a warp's
// channels by a halving transpose-reduction (the 8 values of dB and dC
// a lane holds are summed in 3 exchanges that each halve the values a
// lane keeps, 7 shuffles, so every lane ends with one sum), over the
// block's warps in shared memory, and over the blocks as per-block
// partials; dA and dD sum over rows as per-row partials.  The partials
// are summed in a fixed order by a last launch: no float atomics, so a
// call is deterministic, which the training round's executor-equals-
// oracle check needs.  exp is one ex2.approx of dt · A log2(e), as in the
// forward kernel.
//
// What bounds it on the H100: the exps (the SFU) and the issue of the
// reductions.  Each (token, channel, entry) takes two exps (the chunk's
// recompute and the reverse step), 1.07 G at the training call, 0.26 ms
// at 16 a clock an SM; 0.2 GB of inputs and outputs take 0.06 ms.
// Channels past Ci and tokens past S compute on zeros (dt = u = dy = 0
// leave h and dh unchanged) and store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;          // tokens a chunk: checkpoint interval
constexpr int kCh = 64;         // channels a block
constexpr int kP = 4;           // state entries a lane
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N> struct Geo {
  static constexpr int L = N / kP;                // lanes a channel
  static constexpr int THREADS = kCh * L;
  static constexpr int WARPS = THREADS / 32;
};

template <int N> struct Smem {
  float u[kT][kCh], dt[kT][kCh], dy[kT][kCh];
  float B[kT][N], C[kT][N];
  float du[kT][kCh], ddt[kT][kCh];
  float bc[kT][Geo<N>::WARPS][2 * N];     // a warp's channel sums
};

// Stage a chunk's u, dt (and dy) of the block's channels and B, C of the
// row; zeros past S and past Ci.
template <typename T, int N>
__device__ __forceinline__ void stage(Smem<N>& sm, const T* u, const T* dt,
                                      const T* dy, const T* B, const T* C,
                                      int b, int t0, int seq, int ch0,
                                      int n_ch) {
  for (int i = threadIdx.x; i < kT * kCh; i += Geo<N>::THREADS) {
    const int t = i / kCh, cl = i % kCh;
    const bool ok = t0 + t < seq && ch0 + cl < n_ch;
    const int64_t off =
        (static_cast<int64_t>(b) * seq + t0 + t) * n_ch + ch0 + cl;
    sm.u[t][cl] = ok ? to_f32(u[off]) : 0.f;
    sm.dt[t][cl] = ok ? to_f32(dt[off]) : 0.f;
    if (dy != nullptr) sm.dy[t][cl] = ok ? to_f32(dy[off]) : 0.f;
  }
  for (int i = threadIdx.x; i < kT * N; i += Geo<N>::THREADS) {
    const int t = i / N, n = i % N;
    const bool ok = t0 + t < seq;
    const int64_t off = (static_cast<int64_t>(b) * seq + t0 + t) * N + n;
    sm.B[t][n] = ok ? to_f32(B[off]) : 0.f;
    sm.C[t][n] = ok ? to_f32(C[off]) : 0.f;
  }
}

// h before each chunk, for the reverse pass to recompute from.
template <typename T, int N>
__global__ void __launch_bounds__(Geo<N>::THREADS)
mamba_bwd_ckpt_kernel(const T* __restrict__ u,      // (B, S, Ci)
                      const T* __restrict__ dt,
                      const float* __restrict__ A,  // (Ci, N)
                      const T* __restrict__ Bm,     // (B, S, N)
                      float* __restrict__ ckpt,     // (B, NC, Ci, N)
                      int seq, int n_ch) {
  using G = Geo<N>;
  __shared__ Smem<N> sm;
  const int ch0 = blockIdx.x * kCh, b = blockIdx.y;
  const int cl = threadIdx.x / G::L, n0 = (threadIdx.x % G::L) * kP;
  const int ch = ch0 + cl;
  const bool live = ch < n_ch;
  const int n_chunks = (seq + kT - 1) / kT;
  float a2[kP], h[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    a2[p] = live ? A[static_cast<int64_t>(ch) * N + n0 + p] * kLog2e : 0.f;
    h[p] = 0.f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    if (live)
      *reinterpret_cast<float4*>(
          ckpt + ((static_cast<int64_t>(b) * n_chunks + c) * n_ch + ch) * N +
          n0) = make_float4(h[0], h[1], h[2], h[3]);
    __syncthreads();
    stage<T, N>(sm, u, dt, static_cast<const T*>(nullptr), Bm, Bm, b,
                c * kT, seq, ch0, n_ch);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const float dtv = sm.dt[i][cl], du = dtv * sm.u[i][cl];
#pragma unroll
      for (int p = 0; p < kP; ++p)
        h[p] = fmaf(ex2(dtv * a2[p]), h[p], du * sm.B[i][n0 + p]);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(Geo<N>::THREADS)
mamba_bwd_kernel(const T* __restrict__ u,          // (B, S, Ci)
                 const T* __restrict__ dt,
                 const float* __restrict__ A,      // (Ci, N)
                 const T* __restrict__ Bm,         // (B, S, N)
                 const T* __restrict__ Cm,
                 const float* __restrict__ D,      // (Ci,)
                 const T* __restrict__ dy,         // (B, S, Ci)
                 const float* __restrict__ ckpt,   // (B, NC, Ci, N)
                 T* __restrict__ du_out,           // (B, S, Ci)
                 T* __restrict__ ddt_out,
                 float* __restrict__ part_bc,      // (NBLK, B, S, 2N)
                 float* __restrict__ part_da,      // (B, Ci, N)
                 float* __restrict__ part_dd,      // (B, Ci)
                 int batch, int seq, int n_ch) {
  using G = Geo<N>;
  __shared__ Smem<N> sm;
  const int ch0 = blockIdx.x * kCh, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = threadIdx.x / G::L, q = threadIdx.x % G::L, n0 = q * kP;
  const int ch = ch0 + cl;
  const bool live = ch < n_ch;
  const int n_chunks = (seq + kT - 1) / kT;
  const float dc = live ? D[ch] : 0.f;
  float af[kP], a2[kP], dh[kP], da[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    af[p] = live ? A[static_cast<int64_t>(ch) * N + n0 + p] : 0.f;
    a2[p] = af[p] * kLog2e;
    dh[p] = 0.f;
    da[p] = 0.f;
  }
  float dd = 0.f;
  // the value a lane keeps after the transpose-reduction: index
  // (bit 16 ? 4 : 0) + (bit 8 ? 2 : 0) + (bit 4 ? 1 : 0) of [dB_0..3,
  // dC_0..3] over its n-range
  const int kept = ((lane & 16) ? 4 : 0) + ((lane & 8) ? 2 : 0) +
                   ((lane & 4) ? 1 : 0);
  const bool writer = (lane & 3 & ~(G::L - 1)) == 0;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kT;
    __syncthreads();                    // the last chunk's readers are done
    stage<T, N>(sm, u, dt, dy, Bm, Cm, b, t0, seq, ch0, n_ch);
    float h[kP];
    if (live) {
      const float4 st = *reinterpret_cast<const float4*>(
          ckpt + ((static_cast<int64_t>(b) * n_chunks + c) * n_ch + ch) * N +
          n0);
      h[0] = st.x, h[1] = st.y, h[2] = st.z, h[3] = st.w;
    } else {
      h[0] = h[1] = h[2] = h[3] = 0.f;
    }
    __syncthreads();

    float hist[kT][kP];                 // h_{t0+i-1}
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const float dtv = sm.dt[i][cl], du = dtv * sm.u[i][cl];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        hist[i][p] = h[p];
        h[p] = fmaf(ex2(dtv * a2[p]), h[p], du * sm.B[i][n0 + p]);
      }
    }

#pragma unroll
    for (int i = kT - 1; i >= 0; --i) {
      const float dtv = sm.dt[i][cl], uv = sm.u[i][cl], dyv = sm.dy[i][cl];
      float s_du = 0.f, s_ddt = 0.f, vals[2 * kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float bn = sm.B[i][n0 + p], cn = sm.C[i][n0 + p];
        const float at = ex2(dtv * a2[p]);
        const float ah = at * hist[i][p];
        const float ub = uv * bn;
        dh[p] = fmaf(cn, dyv, dh[p]);
        s_du = fmaf(dh[p], bn, s_du);
        s_ddt = fmaf(dh[p], fmaf(af[p], ah, ub), s_ddt);
        da[p] = fmaf(dh[p], dtv * ah, da[p]);
        vals[p] = dh[p] * (dtv * uv);
        vals[kP + p] = fmaf(dtv, ub, ah) * dyv;     // h_t dy_t
        dh[p] *= at;
      }
      dd = fmaf(dyv, uv, dd);
#pragma unroll
      for (int o = 1; o < G::L; o <<= 1) {          // over the channel's lanes
        s_du += __shfl_xor_sync(0xffffffffu, s_du, o);
        s_ddt += __shfl_xor_sync(0xffffffffu, s_ddt, o);
      }
      if (q == 0) {
        sm.du[i][cl] = fmaf(dtv, s_du, dc * dyv);
        sm.ddt[i][cl] = s_ddt;
      }
      // dB, dC over the warp's channels: halve the values at lane
      // offsets 16, 8, 4, then sum what channel bits remain below 4
#pragma unroll
      for (int m = 2 * kP, o = 16; m > 1; m >>= 1, o >>= 1) {
        const bool up = lane & o;
#pragma unroll
        for (int x = 0; x < m / 2; ++x) {
          const float send = up ? vals[x] : vals[x + m / 2];
          const float keep = up ? vals[x + m / 2] : vals[x];
          vals[x] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
#pragma unroll
      for (int o = 2; o >= G::L; o >>= 1)
        vals[0] += __shfl_xor_sync(0xffffffffu, vals[0], o);
      if (writer)
        sm.bc[i][warp][(kept >> 2) * N + n0 + (kept & 3)] = vals[0];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kT * kCh; i += G::THREADS) {
      const int t = i / kCh, cc = i % kCh;
      if (t0 + t < seq && ch0 + cc < n_ch) {
        const int64_t off =
            (static_cast<int64_t>(b) * seq + t0 + t) * n_ch + ch0 + cc;
        du_out[off] = from_f32<T>(sm.du[t][cc]);
        ddt_out[off] = from_f32<T>(sm.ddt[t][cc]);
      }
    }
    for (int i = threadIdx.x; i < kT * 2 * N; i += G::THREADS) {
      const int t = i / (2 * N), x = i % (2 * N);
      if (t0 + t < seq) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < G::WARPS; ++w) acc += sm.bc[t][w][x];
        part_bc[((static_cast<int64_t>(blockIdx.x) * batch + b) * seq + t0 +
                 t) * 2 * N + x] = acc;
      }
    }
  }
  if (live) {
    *reinterpret_cast<float4*>(
        part_da + (static_cast<int64_t>(b) * n_ch + ch) * N + n0) =
        make_float4(da[0], da[1], da[2], da[3]);
    if (q == 0) part_dd[static_cast<int64_t>(b) * n_ch + ch] = dd;
  }
}

// dB, dC: the channel blocks' partials in block order; dA, dD: the rows'
// partials in row order.
template <typename T, int N>
__global__ void mamba_bwd_finish(const float* __restrict__ part_bc,
                                 const float* __restrict__ part_da,
                                 const float* __restrict__ part_dd,
                                 int n_blk, int batch, int seq, int n_ch,
                                 T* __restrict__ dB, T* __restrict__ dC,
                                 float* __restrict__ dA,
                                 float* __restrict__ dD) {
  const int64_t n_bc = static_cast<int64_t>(batch) * seq * 2 * N;
  const int64_t n_a = static_cast<int64_t>(n_ch) * N;
  const int64_t total = n_bc + n_a + n_ch;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    if (i < n_bc) {
      for (int k = 0; k < n_blk; ++k) acc += part_bc[k * n_bc + i];
      const int64_t bt = i / (2 * N);
      const int x = static_cast<int>(i % (2 * N));
      if (x < N)
        dB[bt * N + x] = from_f32<T>(acc);
      else
        dC[bt * N + x - N] = from_f32<T>(acc);
    } else if (i < n_bc + n_a) {
      const int64_t j = i - n_bc;
      for (int bb = 0; bb < batch; ++bb) acc += part_da[bb * n_a + j];
      dA[j] = acc;
    } else {
      const int64_t j = i - n_bc - n_a;
      for (int bb = 0; bb < batch; ++bb) acc += part_dd[bb * n_ch + j];
      dD[j] = acc;
    }
  }
}

template <int N>
size_t scratch_floats(int batch, int seq, int n_ch) {
  const size_t n_chunks = (seq + kT - 1) / kT;
  const size_t n_blk = (n_ch + kCh - 1) / kCh;
  return static_cast<size_t>(batch) * n_chunks * n_ch * N +
         n_blk * batch * static_cast<size_t>(seq) * 2 * N +
         static_cast<size_t>(batch) * n_ch * N +
         static_cast<size_t>(batch) * n_ch;
}

template <typename T, int N>
int launch(const void* u, const void* dt, const float* A, const void* B,
           const void* C, const float* D, const void* dy, void* du,
           void* ddt, float* dA, void* dB, void* dC, float* dD,
           float* scratch, int batch, int seq, int n_ch,
           cudaStream_t stream) {
  using G = Geo<N>;
  const int n_chunks = (seq + kT - 1) / kT;
  const int n_blk = (n_ch + kCh - 1) / kCh;
  float* ckpt = scratch;
  float* part_bc =
      ckpt + static_cast<int64_t>(batch) * n_chunks * n_ch * N;
  float* part_da =
      part_bc + static_cast<int64_t>(n_blk) * batch * seq * 2 * N;
  float* part_dd = part_da + static_cast<int64_t>(batch) * n_ch * N;
  const T* uu = static_cast<const T*>(u);
  const T* dtt = static_cast<const T*>(dt);
  const T* bb = static_cast<const T*>(B);
  const dim3 grid(n_blk, batch);
  mamba_bwd_ckpt_kernel<T, N><<<grid, G::THREADS, 0, stream>>>(
      uu, dtt, A, bb, ckpt, seq, n_ch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba_bwd_kernel<T, N><<<grid, G::THREADS, 0, stream>>>(
      uu, dtt, A, bb, static_cast<const T*>(C), D,
      static_cast<const T*>(dy), ckpt, static_cast<T*>(du),
      static_cast<T*>(ddt), part_bc, part_da, part_dd, batch, seq, n_ch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total =
      static_cast<int64_t>(batch) * seq * 2 * N +
      static_cast<int64_t>(n_ch) * N + n_ch;
  const int64_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  mamba_bwd_finish<T, N><<<blocks, 256, 0, stream>>>(
      part_bc, part_da, part_dd, n_blk, batch, seq, n_ch,
      static_cast<T*>(dB), static_cast<T*>(dC), dA, dD);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int d_state, const void* u, const void* dt, const float* A,
             const void* B, const void* C, const float* D, const void* dy,
             void* du, void* ddt, float* dA, void* dB, void* dC, float* dD,
             float* scratch, int batch, int seq, int n_ch,
             cudaStream_t stream) {
#define MAMBA_BWD_CASE(N)                                                   \
  case N:                                                                   \
    return launch<T, N>(u, dt, A, B, C, D, dy, du, ddt, dA, dB, dC, dD,     \
                        scratch, batch, seq, n_ch, stream);
  switch (d_state) {
    MAMBA_BWD_CASE(4)
    MAMBA_BWD_CASE(8)
    MAMBA_BWD_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MAMBA_BWD_CASE
}

}  // namespace

extern "C" {

// Floats of f32 scratch a call needs (0: d_state not taken): the state
// checkpoints, then the dB / dC, dA and dD partials.
size_t mamba_scan_bwd_scratch_floats(int batch, int seq, int n_ch,
                                     int d_state) {
  switch (d_state) {
    case 4: return scratch_floats<4>(batch, seq, n_ch);
    case 8: return scratch_floats<8>(batch, seq, n_ch);
    case 16: return scratch_floats<16>(batch, seq, n_ch);
    default: return 0;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (u, dt, B, C, dy and du, ddt, dB, dC;
// A, D, dA and dD are float32); scratch holds
// mamba_scan_bwd_scratch_floats(...) floats.  d_state must be 4, 8 or 16
// (jamba uses 16).  Returns a cudaError_t (0 = success).
int mamba_scan_bwd_launch(int dtype, const void* u, const void* dt,
                          const void* A, const void* B, const void* C,
                          const void* D, const void* dy, void* du,
                          void* ddt, void* dA, void* dB, void* dC, void* dD,
                          void* scratch, int batch, int seq, int n_ch,
                          int d_state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* df = static_cast<const float*>(D);
  float* sc = static_cast<float*>(scratch);
  if (batch < 1 || seq < 1 || n_ch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_n<float>(d_state, u, dt, af, B, C, df, dy, du, ddt,
                           static_cast<float*>(dA), dB, dC,
                           static_cast<float*>(dD), sc, batch, seq, n_ch, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(d_state, u, dt, af, B, C, df, dy, du,
                                   ddt, static_cast<float*>(dA), dB, dC,
                                   static_cast<float*>(dD), sc, batch, seq,
                                   n_ch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
