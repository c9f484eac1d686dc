// RWKV6 WKV backward for sm_90a: the gradients of the WKV recurrence
// from a zero state, by state checkpoints and recomputation.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/wkv6.py
// has no backward, and JAX trains through autograd of its jnp twin
// (src/repro/models/nn.py::wkv6_chunked).  The port's training path on
// the card runs this kernel in its place.  With S_t = diag(w_t) S_{t-1}
// + k_t v_tᵀ, y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ), w clipped to
// [1e-8, 1] as the forward reads it, and G_t = dL/dS_t (G_S = 0):
//
//   G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ
//   dr_t[d] = Σ_e (S_{t-1}[d,e] + u[d] k_t[d] v_t[e]) dy_t[e]
//   dk_t[d] = Σ_e (G_t[d,e] + u[d] r_t[d] dy_t[e]) v_t[e]
//   dv_t[e] = Σ_d (G_t[d,e] + u[d] r_t[d] dy_t[e]) k_t[d]
//   dw_t[d] = Σ_e G_t[d,e] S_{t-1}[d,e]
//   du[d]   = Σ_{b,t} r_t[d] k_t[d] Σ_e v_t[e] dy_t[e]
//
// (kernels/wkv6.py::wkv6_bwd_plain is the same arithmetic in PyTorch.)
// Every element (d, e) of S and G follows its own scalar recurrence, so
// a thread owns two columns e of one row d of both.  dw needs S_{t-1}
// and G_t together while S runs forward and G backward: S is
// checkpointed every kT tokens, and the reverse pass recomputes a
// chunk's kT states into registers from its checkpoint.  Running S
// backwards, S_{t-1} = (S_t - k_t v_tᵀ) / w_t, divides by w; forming dw
// as d(log w) / w from suffix sums is 0 / 0 where a bf16 w underflows
// and loses every digit at strong decay.  Here every product is of w's
// <= 1 and nothing divides, so dw is finite and right at w = 0 too.
//
// Three launches:
// - wkv6_bwd_ckpt_kernel: the forward recurrence, writing S before each
//   chunk: (B, H, ceil(S / kT), Dh, Dh) f32 (128 MB at the rwkv6
//   training call (1, 4096, 32, 64)).
// - wkv6_bwd_kernel: chunks in reverse; a chunk's r, k, w (all rows)
//   and v, dy (the block's columns) are staged in shared memory, its
//   states recomputed, then its tokens walked backwards.  dr, dk and dw
//   sum over e: over a row's threads by shuffles, over the blocks of a
//   head as per-block partials; dv sums over d: over a warp's rows by
//   shuffles, over its warps in shared memory, in a fixed order.
// - wkv6_bwd_finish(_du): the partials summed in a fixed order (column
//   blocks; for du also rows b) and cast to the inputs' dtype.
// No float atomics anywhere: a call is deterministic (bit for bit from
// run to run), which the training round's executor-equals-oracle check
// needs.
//
// Blocks: (column block of EB = min(Dh, 16) columns, row b · head h),
// Dh rows x EB / 2 threads (512 at Dh 64; 128 blocks at the training
// call).  Tokens past S read r = k = v = dy = 0 and w = 1, which leaves
// S and G as they are, and store nothing.
//
// What bounds it on the H100: operations.  Each (token, d, e) takes ~9
// f32 FMAs here (recompute 1, G 1, dr 2, dk 1, dv 1, dw 1, the bonus
// terms), 1.2 G FMA at the training call against 151 MB of inputs and
// outputs (45 us at 3.35 TB/s); the reductions' shuffles cost as much
// again.  The checkpoints and partials add ~0.8 GB of traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;     // tokens a chunk: checkpoint interval, recompute
constexpr int kEC = 2;     // state columns a thread

template <int DH> struct Geo {
  static constexpr int EB = DH < 16 ? DH : 16;     // columns a block
  static constexpr int NEB = DH / EB;              // blocks a (row, head)
  static constexpr int NS = EB / kEC;              // threads a row
  static constexpr int RW = 32 / NS;               // rows a warp
  static constexpr int ROWS = DH < RW ? RW : DH;   // padded to a warp
  static constexpr int THREADS = ROWS * NS;
  static constexpr int WARPS = THREADS / 32;
};

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

__device__ __forceinline__ float clip_w(float w) {
  return fminf(fmaxf(w, 1e-8f), 1.f);
}

// S before each chunk, for the reverse pass to recompute from.
template <typename T, int DH>
__global__ void __launch_bounds__(Geo<DH>::THREADS)
wkv6_bwd_ckpt_kernel(const T* __restrict__ k,     // (B, S, H, Dh)
                     const T* __restrict__ v,
                     const T* __restrict__ w,
                     float* __restrict__ ckpt,    // (B, H, NC, Dh, Dh)
                     int seq, int n_heads) {
  using G = Geo<DH>;
  const int eb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int d = threadIdx.x / G::NS;
  const int e = eb * G::EB + (threadIdx.x % G::NS) * kEC;
  const bool live = d < DH;
  const int n_chunks = (seq + kT - 1) / kT;
  const int64_t t_stride = static_cast<int64_t>(n_heads) * DH;
  const int64_t base = (static_cast<int64_t>(b) * seq * n_heads + h) * DH;
  float s0 = 0.f, s1 = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    if (live)
      *reinterpret_cast<float2*>(
          ckpt + ((static_cast<int64_t>(bh) * n_chunks + c) * DH + d) * DH +
          e) = make_float2(s0, s1);
    const int t0 = c * kT;
    float wt[kT], kt[kT], v0[kT], v1[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) {       // every load of the chunk first
      const bool ok = live && t0 + i < seq;
      const int64_t off = base + static_cast<int64_t>(t0 + i) * t_stride;
      wt[i] = ok ? clip_w(to_f32(w[off + d])) : 1.f;
      kt[i] = ok ? to_f32(k[off + d]) : 0.f;
      v0[i] = ok ? to_f32(v[off + e]) : 0.f;
      v1[i] = ok ? to_f32(v[off + e + 1]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      s0 = fmaf(wt[i], s0, kt[i] * v0[i]);
      s1 = fmaf(wt[i], s1, kt[i] * v1[i]);
    }
  }
}

template <int DH> struct BwdSmem {
  float r[kT][DH], k[kT][DH], w[kT][DH];
  float v[kT][Geo<DH>::EB], dy[kT][Geo<DH>::EB];
  float dv[kT][Geo<DH>::WARPS][Geo<DH>::EB];   // a warp's row sums
};

template <typename T, int DH>
__global__ void __launch_bounds__(Geo<DH>::THREADS)
wkv6_bwd_kernel(const T* __restrict__ r,          // (B, S, H, Dh)
                const T* __restrict__ k,
                const T* __restrict__ v,
                const T* __restrict__ w,
                const T* __restrict__ u,          // (H, Dh)
                const T* __restrict__ dy,         // (B, S, H, Dh)
                const float* __restrict__ ckpt,   // (B, H, NC, Dh, Dh)
                T* __restrict__ dv_out,           // (B, S, H, Dh)
                float* __restrict__ part,         // (3, NEB, B, S, H, Dh)
                float* __restrict__ part_du,      // (NEB, B, H, Dh)
                int batch, int seq, int n_heads) {
  using G = Geo<DH>;
  __shared__ BwdSmem<DH> sm;
  const int eb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = tid / G::NS, j = tid % G::NS;
  const bool live = d < DH;
  const int ds = live ? d : 0;          // padding rows read row 0, own 0
  const int el = j * kEC;               // the block's column
  const int e = eb * G::EB + el;
  const float ud = live ? to_f32(u[h * DH + d]) : 0.f;
  const int n_chunks = (seq + kT - 1) / kT;
  const int64_t t_stride = static_cast<int64_t>(n_heads) * DH;
  const int64_t base = (static_cast<int64_t>(b) * seq * n_heads + h) * DH;
  const int64_t n_el = static_cast<int64_t>(batch) * seq * n_heads * DH;
  float* p_dr = part + (0 * G::NEB + eb) * n_el;
  float* p_dk = part + (1 * G::NEB + eb) * n_el;
  float* p_dw = part + (2 * G::NEB + eb) * n_el;

  float g0 = 0.f, g1 = 0.f, du_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kT;
    __syncthreads();                    // the last chunk's readers are done
    for (int i = tid; i < kT * DH; i += G::THREADS) {
      const int t = i / DH, dd = i % DH;
      const bool ok = t0 + t < seq;
      const int64_t off = base + static_cast<int64_t>(t0 + t) * t_stride + dd;
      sm.r[t][dd] = ok ? to_f32(r[off]) : 0.f;
      sm.k[t][dd] = ok ? to_f32(k[off]) : 0.f;
      sm.w[t][dd] = ok ? clip_w(to_f32(w[off])) : 1.f;
    }
    for (int i = tid; i < kT * G::EB; i += G::THREADS) {
      const int t = i / G::EB, ee = i % G::EB;
      const bool ok = t0 + t < seq;
      const int64_t off = base + static_cast<int64_t>(t0 + t) * t_stride +
                          eb * G::EB + ee;
      sm.v[t][ee] = ok ? to_f32(v[off]) : 0.f;
      sm.dy[t][ee] = ok ? to_f32(dy[off]) : 0.f;
    }
    float s0 = 0.f, s1 = 0.f;
    if (live) {
      const float2 st = *reinterpret_cast<const float2*>(
          ckpt + ((static_cast<int64_t>(bh) * n_chunks + c) * DH + d) * DH +
          e);
      s0 = st.x;
      s1 = st.y;
    }
    __syncthreads();

    // the chunk's states: h0[i], h1[i] = S_{t0+i-1} at this thread's two
    // columns
    float h0[kT], h1[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      h0[i] = s0;
      h1[i] = s1;
      const float wd = sm.w[i][ds];
      const float kd = live ? sm.k[i][ds] : 0.f;
      s0 = fmaf(wd, s0, kd * sm.v[i][el]);
      s1 = fmaf(wd, s1, kd * sm.v[i][el + 1]);
    }

#pragma unroll
    for (int i = kT - 1; i >= 0; --i) {
      const float rd = live ? sm.r[i][ds] : 0.f;
      const float kd = live ? sm.k[i][ds] : 0.f;
      const float wd = sm.w[i][ds];
      const float v0 = sm.v[i][el], v1 = sm.v[i][el + 1];
      const float y0 = sm.dy[i][el], y1 = sm.dy[i][el + 1];
      const float ur = ud * rd, uk = ud * kd;
      const float a0 = fmaf(ur, y0, g0), a1 = fmaf(ur, y1, g1);
      float dk_p = fmaf(a0, v0, a1 * v1);
      float dw_p = fmaf(g0, h0[i], g1 * h1[i]);
      float dr_p = fmaf(fmaf(uk, v0, h0[i]), y0, fmaf(uk, v1, h1[i]) * y1);
      du_acc = fmaf(rd * kd, fmaf(v0, y0, v1 * y1), du_acc);
      float dv0 = a0 * kd, dv1 = a1 * kd;
      g0 = fmaf(wd, g0, rd * y0);       // G_{t-1}
      g1 = fmaf(wd, g1, rd * y1);
#pragma unroll
      for (int o = 1; o < G::NS; o <<= 1) {      // over the row's threads
        dk_p += __shfl_xor_sync(0xffffffffu, dk_p, o);
        dw_p += __shfl_xor_sync(0xffffffffu, dw_p, o);
        dr_p += __shfl_xor_sync(0xffffffffu, dr_p, o);
      }
#pragma unroll
      for (int o = G::NS; o < 32; o <<= 1) {     // over the warp's rows
        dv0 += __shfl_xor_sync(0xffffffffu, dv0, o);
        dv1 += __shfl_xor_sync(0xffffffffu, dv1, o);
      }
      const int t = t0 + i;
      if (live && j == 0 && t < seq) {
        const int64_t idx =
            (static_cast<int64_t>(b * seq + t) * n_heads + h) * DH + d;
        p_dr[idx] = dr_p;
        p_dk[idx] = dk_p;
        p_dw[idx] = dw_p;
      }
      if (lane < G::NS) {
        sm.dv[i][warp][el] = dv0;
        sm.dv[i][warp][el + 1] = dv1;
      }
    }
    __syncthreads();
    for (int i = tid; i < kT * G::EB; i += G::THREADS) {   // dv: the warps
      const int t = i / G::EB, ee = i % G::EB;
      if (t0 + t < seq) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < G::WARPS; ++q) acc += sm.dv[t][q][ee];
        dv_out[base + static_cast<int64_t>(t0 + t) * t_stride + eb * G::EB +
               ee] = from_f32<T>(acc);
      }
    }
  }
#pragma unroll
  for (int o = 1; o < G::NS; o <<= 1)
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, o);
  if (live && j == 0)
    part_du[(static_cast<int64_t>(eb) * batch + b) * n_heads * DH + h * DH +
            d] = du_acc;
}

// dr, dk, dw: the column blocks' partials, summed in block order.
template <typename T>
__global__ void wkv6_bwd_finish(const float* __restrict__ part, int neb,
                                int64_t n_el, T* __restrict__ dr,
                                T* __restrict__ dk, T* __restrict__ dw) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_el; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float a = 0.f, bb = 0.f, cc = 0.f;
    for (int q = 0; q < neb; ++q) {
      a += part[static_cast<int64_t>(q) * n_el + i];
      bb += part[static_cast<int64_t>(neb + q) * n_el + i];
      cc += part[static_cast<int64_t>(2 * neb + q) * n_el + i];
    }
    dr[i] = from_f32<T>(a);
    dk[i] = from_f32<T>(bb);
    dw[i] = from_f32<T>(cc);
  }
}

// du: the partials of every column block and row, in that order.
template <typename T>
__global__ void wkv6_bwd_finish_du(const float* __restrict__ part_du,
                                   int neb, int batch, int n,
                                   T* __restrict__ du) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int q = 0; q < neb; ++q)
    for (int bb = 0; bb < batch; ++bb)
      a += part_du[(static_cast<int64_t>(q) * batch + bb) * n + i];
  du[i] = from_f32<T>(a);
}

template <int DH>
size_t scratch_floats(int batch, int seq, int n_heads) {
  using G = Geo<DH>;
  const size_t n_chunks = (seq + kT - 1) / kT;
  const size_t bh = static_cast<size_t>(batch) * n_heads;
  return bh * n_chunks * DH * DH +
         3 * G::NEB * bh * static_cast<size_t>(seq) * DH +
         G::NEB * bh * DH;
}

template <typename T, int DH>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dy, void* dr, void* dk, void* dv,
           void* dw, void* du, float* scratch, int batch, int seq,
           int n_heads, cudaStream_t stream) {
  using G = Geo<DH>;
  const int n_chunks = (seq + kT - 1) / kT;
  const int64_t bh = static_cast<int64_t>(batch) * n_heads;
  const int64_t n_el = bh * seq * DH;
  float* ckpt = scratch;
  float* part = ckpt + bh * n_chunks * DH * DH;
  float* part_du = part + 3 * G::NEB * n_el;
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* ww = static_cast<const T*>(w);
  const dim3 grid(G::NEB, static_cast<unsigned>(bh));
  wkv6_bwd_ckpt_kernel<T, DH><<<grid, G::THREADS, 0, stream>>>(
      kk, vv, ww, ckpt, seq, n_heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<T, DH><<<grid, G::THREADS, 0, stream>>>(
      static_cast<const T*>(r), kk, vv, ww, static_cast<const T*>(u),
      static_cast<const T*>(dy), ckpt, static_cast<T*>(dv), part, part_du,
      batch, seq, n_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (n_el + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  wkv6_bwd_finish<T><<<blocks, 256, 0, stream>>>(
      part, G::NEB, n_el, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_finish_du<T><<<(n_heads * DH + 255) / 256, 256, 0, stream>>>(
      part_du, G::NEB, batch, n_heads * DH, static_cast<T*>(du));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int d_head, const void* r, const void* k, const void* v,
              const void* w, const void* u, const void* dy, void* dr,
              void* dk, void* dv, void* dw, void* du, float* scratch,
              int batch, int seq, int n_heads, cudaStream_t stream) {
#define WKV6_BWD_CASE(DH)                                                   \
  case DH:                                                                  \
    return launch<T, DH>(r, k, v, w, u, dy, dr, dk, dv, dw, du, scratch,    \
                         batch, seq, n_heads, stream);
  switch (d_head) {
    WKV6_BWD_CASE(4)
    WKV6_BWD_CASE(8)
    WKV6_BWD_CASE(16)
    WKV6_BWD_CASE(32)
    WKV6_BWD_CASE(64)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV6_BWD_CASE
}

}  // namespace

extern "C" {

// Floats of f32 scratch a call needs (0: d_head not taken): the state
// checkpoints, then the dr / dk / dw partials, then du's.
size_t wkv6_bwd_scratch_floats(int batch, int seq, int n_heads,
                               int d_head) {
  switch (d_head) {
    case 4: return scratch_floats<4>(batch, seq, n_heads);
    case 8: return scratch_floats<8>(batch, seq, n_heads);
    case 16: return scratch_floats<16>(batch, seq, n_heads);
    case 32: return scratch_floats<32>(batch, seq, n_heads);
    case 64: return scratch_floats<64>(batch, seq, n_heads);
    default: return 0;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u, dy and every
// gradient); scratch holds wkv6_bwd_scratch_floats(...) floats.  d_head
// must be 4, 8, 16, 32 or 64 (rwkv6 uses 64).  Returns a cudaError_t (0 =
// success).
int wkv6_bwd_launch(int dtype, const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* dy, void* dr,
                    void* dk, void* dv, void* dw, void* du, void* scratch,
                    int batch, int seq, int n_heads, int d_head,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (batch < 1 || seq < 1 || n_heads < 1 || batch * n_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dh<float>(d_head, r, k, v, w, u, dy, dr, dk, dv, dw, du,
                            sc, batch, seq, n_heads, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(d_head, r, k, v, w, u, dy, dr, dk, dv,
                                    dw, du, sc, batch, seq, n_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
