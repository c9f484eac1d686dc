// Mamba-1 selective scan backward for sm_90a: the gradients of the scan
// from a zero state, parallel over the sequence.
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
// PyTorch, mamba_scan_bwd_segmented_plain this kernel's passes.)  The
// reverse pass needs h_{t-1}; dividing the recurrence backwards (h_{t-1}
// = (h_t - dt u B) / a_t) blows up where a_t is small, so h is
// recomputed forward.
//
// Design: split the sequence, find the boundary states, then finish
// every piece at once.  Segments of kSeg = 128 tokens, a CTA per
// (channel block of kCh = 64 channels, segment, row): 4096 CTAs at the
// jamba training call (1, 4096, 8192, 16).  Layout, as the forward
// kernel's: a channel's N state entries over L = N / 4 adjacent lanes,
// 4 entries a lane.  With P_s = Π_{t in s} a_t:
//
// - Pass A (mamba_bwd_local): each segment's P_s, its local end state
//   hloc_s (the walk from h = 0) and its local gradient carry gloc_s =
//   Σ_{t in s} (Π_{τ=t0..t} a_τ) C_t dy_t, in one forward walk.
// - Pass B (mamba_bwd_combine): h_in_s from h_s = P_s h_{s-1} + hloc_s
//   and the carry g_s into each segment from its right, g_{s-1} =
//   gloc_s + P_s g_s, a thread per (row, channel, entry), both walks side
//   by side in a fixed order; (B, S / 128, Ci, N) f32 each, 16.8 MB at
//   the training call.
// - Pass C (mamba_bwd_seg, two CTAs an SM: 101 KB of shared memory and
//   at most 128 registers a thread): walk the segment forward once from
//   h_in, keeping h every kSub = 8 tokens in shared memory (14 x 4 KB;
//   the last one stays in registers); then the 8-token sub-chunks in
//   reverse: recomputed into registers from their checkpoint, keeping
//   a_t and h_{t-1} (one exp a (t, c, n) here, none in the reverse
//   step), and walked back from the carry g.  du and ddt sum over a
//   channel's lanes by shuffles; dB and dC over the warp's channels by a
//   halving transpose-reduction (8 values a lane in 7 shuffles), over
//   the CTA's warps in shared memory, and over channel blocks as
//   per-block partials; dA and dD as per-(row, segment) partials.  A
//   sub-chunk's du, ddt and dB / dC sums are staged in shared memory
//   and stored behind the next sub-chunk's compute.
// - Pass D (mamba_bwd_finish): the partials summed in a fixed order.
// Inputs stream through a three-slot shared-memory ring, two sub-chunks
// ahead: f32 inputs by 16-byte cp.async copies (4-byte where a row is
// not 16-byte aligned), which the compiler cannot delay as it delays
// plain loads into registers to their first use; bf16 inputs are loaded
// and converted by the threads.  No float atomics: a call is
// deterministic, which the training round's executor-equals-oracle
// check needs.  exp is one ex2.approx of dt · A log2(e), as in the
// forward kernel.
//
// What bounds it on the H100: bytes for the work itself, issue and the
// SFU for this design.  u, dt, dy in and du, ddt out are 0.67 GB at the
// training call (0.20 ms at 3.35 TB/s); the exps (1.07 G a pass over
// (t, c, n)) take 0.13 ms at 16 a clock an SM.  This design reads the
// inputs twice (passes A and C; C's reverse re-reads each sub-chunk,
// mostly from L2), takes three exps a (t, c, n) (A, C's checkpoint walk,
// C's recompute), ~30 instructions a (t, c, n) in all, and writes 67 MB
// of dB / dC partials.
// Channels past Ci and tokens past S compute on zeros (dt = u = dy = 0
// leave h and dh unchanged) and store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 128;       // tokens a segment
constexpr int kSub = 8;         // tokens a sub-chunk: checkpoint interval
constexpr int kCh = 64;         // channels a CTA
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

// Sums V values over the lanes whose indices differ in the bits O, O/2,
// ..., OLO (powers of two; none when O < OLO), halving the values a lane
// keeps while more than one remains: the lane with bit O set keeps the
// upper half.  Afterwards a lane keeps Tree<...>::R sums, v[x] holding
// value Tree<...>::base(lane) + x.  A fixed order: bit for bit the same
// from run to run.
template <int V, int O, int OLO>
__device__ __forceinline__ void tree_sum(float* v, int lane) {
  if constexpr (O >= OLO && O > 0) {
    if constexpr (V > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int x = 0; x < V / 2; ++x) {
        const float send = up ? v[x] : v[x + V / 2];
        const float keep = up ? v[x + V / 2] : v[x];
        v[x] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      tree_sum<V / 2, O / 2, OLO>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      tree_sum<1, O / 2, OLO>(v, lane);
    }
  }
}

template <int V, int O, int OLO> struct Tree {
  static constexpr int G = (O >= OLO && O > 0) ? 2 * O / OLO : 1;
  static constexpr int R = V / G > 0 ? V / G : 1;   // sums a lane keeps
  __device__ static __forceinline__ int group(int lane) {
    return (lane / OLO) % G;
  }
  __device__ static __forceinline__ int base(int lane) {
    return group(lane) * V / G;
  }
  // the one lane of its butterfly that stores
  __device__ static __forceinline__ bool holds(int lane) {
    return (group(lane) * V) % G == 0;
  }
};

template <int N> struct Geo {
  static constexpr int L = N / kP;                // lanes a channel
  static constexpr int THREADS = kCh * L;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int NCK = kSeg / kSub - 2;     // checkpoints in smem
  static constexpr int CK = kCh * N;              // floats a checkpoint
  static constexpr int BC = kSub * WARPS * 2 * N; // dB / dC warp sums
  static constexpr int DT = 2 * kSub * kCh;       // du, ddt of a sub-chunk
};

// A ring of kSlots shared-memory slots, each holding ROWS tokens of u,
// dt, dy (the CTA's kCh channels) and B, C as f32:
// [u | dt | dy] (ROWS x kCh each), then [B | C] (ROWS x N each).
// f32 inputs arrive by cp.async copies (16-byte pieces where the rows
// allow, else 4-byte), issued kAheadSt stages before they are read (the
// copies cannot be delayed by the compiler, as plain loads into
// registers can); bf16 inputs are loaded and converted by the threads.
// Zeros past S and past Ci.
constexpr int kSlots = 3, kAheadSt = 2;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  // src-size 0 reads nothing and zero-fills the 4 bytes
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(K) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

template <typename T, int N, int ROWS> struct Ring {
  static constexpr int SLOT = ROWS * (3 * kCh + 2 * N);
  static constexpr int THREADS = Geo<N>::THREADS;
  static constexpr int CH4 = ROWS * kCh / 4;       // 16-byte pieces: u
  static constexpr int BC4 = ROWS * N / 4;         // and B
  static constexpr int NU4 = (CH4 + THREADS - 1) / THREADS;
  static constexpr int NB4 = (BC4 + THREADS - 1) / THREADS;

  // tokens t0 .. t0 + ROWS - 1 of row b into `slot`; dy, C skipped when
  // null (their floats are then left as they are).  `vec`: f32 inputs
  // whose rows are 16-byte aligned (n_ch % 4 == 0), copied in 16-byte
  // pieces; a piece past Ci is whole or absent since ch0 and n_ch are
  // multiples of 4.
  static __device__ __forceinline__ void fill(
      float* slot, const T* u, const T* dt, const T* dy, const T* B,
      const T* C, int b, int t0, int seq, int ch0, int n_ch, bool vec) {
    if constexpr (sizeof(T) == 4) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < NU4; ++j) {
          const int i = threadIdx.x + j * THREADS;
          if (CH4 % THREADS == 0 || i < CH4) {
            const int t = i / (kCh / 4), c4 = (i % (kCh / 4)) * 4;
            const bool ok = t0 + t < seq && ch0 + c4 < n_ch;
            const int64_t off =
                ok ? (static_cast<int64_t>(b) * seq + t0 + t) * n_ch + ch0 + c4
                   : 0;
            cp_async16(slot + 4 * i, u + off, ok);
            cp_async16(slot + ROWS * kCh + 4 * i, dt + off, ok);
            if (dy != nullptr)
              cp_async16(slot + 2 * ROWS * kCh + 4 * i, dy + off, ok);
          }
        }
#pragma unroll
        for (int j = 0; j < NB4; ++j) {
          const int i = threadIdx.x + j * THREADS;
          if (BC4 % THREADS == 0 || i < BC4) {
            const bool ok = t0 + (4 * i) / N < seq;
            const int64_t off =
                ok ? (static_cast<int64_t>(b) * seq + t0) * N + 4 * i : 0;
            cp_async16(slot + 3 * ROWS * kCh + 4 * i, B + off, ok);
            if (C != nullptr)
              cp_async16(slot + 3 * ROWS * kCh + ROWS * N + 4 * i, C + off,
                         ok);
          }
        }
        return;
      }
    }
    for (int i = threadIdx.x; i < ROWS * kCh; i += THREADS) {
      const int t = i / kCh, cl = i % kCh;
      const bool ok = t0 + t < seq && ch0 + cl < n_ch;
      const int64_t off =
          ok ? (static_cast<int64_t>(b) * seq + t0 + t) * n_ch + ch0 + cl : 0;
      put(slot + i, u + off, ok);
      put(slot + ROWS * kCh + i, dt + off, ok);
      if (dy != nullptr) put(slot + 2 * ROWS * kCh + i, dy + off, ok);
    }
    for (int i = threadIdx.x; i < ROWS * N; i += THREADS) {
      const int t = i / N;
      const bool ok = t0 + t < seq;
      const int64_t off =
          ok ? (static_cast<int64_t>(b) * seq + t0) * N + i : 0;
      put(slot + 3 * ROWS * kCh + i, B + off, ok);
      if (C != nullptr) put(slot + 3 * ROWS * kCh + ROWS * N + i, C + off, ok);
    }
  }
  static __device__ __forceinline__ void put(float* dst, const float* src,
                                             bool ok) {
    cp_async4(dst, src, ok);
  }
  static __device__ __forceinline__ void put(float* dst,
                                             const __nv_bfloat16* src,
                                             bool ok) {
    *dst = ok ? __bfloat162float(*src) : 0.f;
  }
};

// ---------------------------------------------------------------------
// Pass A: a segment's P, hloc and gloc.
// ---------------------------------------------------------------------

constexpr int kRowsA = 16;      // tokens a stage of pass A

template <typename T, int N>
__global__ void __launch_bounds__(Geo<N>::THREADS)
mamba_bwd_local(const T* __restrict__ u, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ dy,
                float* __restrict__ hloc,    // (B, NSEG, Ci, N)
                float* __restrict__ pseg,
                float* __restrict__ gloc,
                int seq, int n_ch, bool vec) {
  using G = Geo<N>;
  using R = Ring<T, N, kRowsA>;
  extern __shared__ float4 smem_a[];
  float* ring = reinterpret_cast<float*>(smem_a);
  const int ch0 = blockIdx.x * kCh, sg = blockIdx.y, b = blockIdx.z;
  const int n_seg = gridDim.y;
  const int cl = threadIdx.x / G::L, n0 = (threadIdx.x % G::L) * kP;
  const int ch = ch0 + cl;
  const bool live = ch < n_ch;
  const int s0 = sg * kSeg;
  const int n_st = (min(kSeg, seq - s0) + kRowsA - 1) / kRowsA;
  float a2[kP], h[kP], p[kP], g[kP];
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    a2[q] = live ? A[static_cast<int64_t>(ch) * N + n0 + q] * kLog2e : 0.f;
    h[q] = 0.f, p[q] = 1.f, g[q] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < kAheadSt; ++k) {
    if (k < n_st)
      R::fill(ring + k * R::SLOT, u, dt, dy, Bm, Cm, b, s0 + k * kRowsA,
              seq, ch0, n_ch, vec);
    cp_async_commit();
  }
  for (int k = 0; k < n_st; ++k) {
    cp_async_wait<kAheadSt - 1>();
    __syncthreads();                    // stage k is in; k - 1 is read
    if (k + kAheadSt < n_st)
      R::fill(ring + ((k + kAheadSt) % kSlots) * R::SLOT, u, dt, dy, Bm, Cm,
              b, s0 + (k + kAheadSt) * kRowsA, seq, ch0, n_ch, vec);
    cp_async_commit();
    const float* sl = ring + (k % kSlots) * R::SLOT;
#pragma unroll
    for (int x = 0; x < kRowsA; ++x) {
      const float uv = sl[x * kCh + cl];
      const float dtv = sl[kRowsA * kCh + x * kCh + cl];
      const float dyv = sl[2 * kRowsA * kCh + x * kCh + cl];
      const float4 bb = *reinterpret_cast<const float4*>(
          sl + 3 * kRowsA * kCh + x * N + n0);
      const float4 cc = *reinterpret_cast<const float4*>(
          sl + 3 * kRowsA * kCh + kRowsA * N + x * N + n0);
      const float bn[kP] = {bb.x, bb.y, bb.z, bb.w};
      const float cn[kP] = {cc.x, cc.y, cc.z, cc.w};
      const float du = dtv * uv;
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        const float a = ex2(dtv * a2[q]);
        h[q] = fmaf(a, h[q], du * bn[q]);
        p[q] *= a;
        g[q] = fmaf(p[q], cn[q] * dyv, g[q]);
      }
    }
  }
  if (live) {
    const int64_t o =
        ((static_cast<int64_t>(b) * n_seg + sg) * n_ch + ch) * N + n0;
    *reinterpret_cast<float4*>(hloc + o) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(pseg + o) = make_float4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<float4*>(gloc + o) = make_float4(g[0], g[1], g[2], g[3]);
  }
}

// ---------------------------------------------------------------------
// Pass B: h_in and the carry g of every segment, over hloc / gloc.
// ---------------------------------------------------------------------

constexpr int kAheadB = 16;     // segments whose loads are issued together

template <int N>
__global__ void __launch_bounds__(256)
mamba_bwd_combine(float* __restrict__ hloc, const float* __restrict__ pseg,
                  float* __restrict__ gloc, int batch, int n_seg,
                  int n_ch) {
  const int64_t per_row = static_cast<int64_t>(n_ch) * N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= batch * per_row) return;
  const int64_t b = i / per_row, e = i % per_row;
  const int64_t o = b * n_seg * per_row + e;
  // h forward from zero, the carry backward from zero, side by side
  float h = 0.f, g = 0.f;
  for (int s = 0; s < n_seg; s += kAheadB) {
    float xh[kAheadB], ph[kAheadB], xg[kAheadB], pg[kAheadB];
#pragma unroll
    for (int j = 0; j < kAheadB; ++j) {
      const bool ok = s + j < n_seg;
      const int64_t ah = o + (s + j) * per_row;
      const int64_t ag = o + (n_seg - 1 - s - j) * per_row;
      xh[j] = ok ? hloc[ah] : 0.f;
      ph[j] = ok ? pseg[ah] : 1.f;
      xg[j] = ok ? gloc[ag] : 0.f;
      pg[j] = ok ? pseg[ag] : 1.f;
    }
#pragma unroll
    for (int j = 0; j < kAheadB; ++j) {
      if (s + j < n_seg) {
        hloc[o + (s + j) * per_row] = h;               // h_in of s + j
        gloc[o + (n_seg - 1 - s - j) * per_row] = g;   // its carry
        h = fmaf(ph[j], h, xh[j]);
        g = fmaf(pg[j], g, xg[j]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// Pass C: every segment's gradients from its h_in and carry.
// ---------------------------------------------------------------------

template <typename T, int N> struct SmemC {
  static constexpr int RING = kSlots * Ring<T, N, kSub>::SLOT;
  static constexpr size_t BYTES =
      (RING + Geo<N>::NCK * Geo<N>::CK + 2 * Geo<N>::BC + 2 * Geo<N>::DT) *
      sizeof(float);
};

template <typename T, int N>
__global__ void __launch_bounds__(Geo<N>::THREADS, 2)
mamba_bwd_seg(const T* __restrict__ u, const T* __restrict__ dt,
              const float* __restrict__ A, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const float* __restrict__ D,
              const T* __restrict__ dy,
              const float* __restrict__ h_in,   // (B, NSEG, Ci, N)
              const float* __restrict__ g_in,
              T* __restrict__ du_out,           // (B, S, Ci)
              T* __restrict__ ddt_out,
              float* __restrict__ part_bc,      // (NBLK, B, S, 2N)
              float* __restrict__ part_da,      // (B, NSEG, Ci, N)
              float* __restrict__ part_dd,      // (B, NSEG, Ci)
              int batch, int seq, int n_ch, bool vec) {
  using G = Geo<N>;
  using R = Ring<T, N, kSub>;
  using TreeCh = Tree<2, G::L / 2, 1>;            // du, ddt: the lanes
  using TreeBC = Tree<2 * kP, 16, G::L>;          // dB, dC: the channels
  static_assert(G::NCK >= 0, "a segment holds at least two sub-chunks");
  extern __shared__ float4 smem_c[];
  float* ring = reinterpret_cast<float*>(smem_c);
  float* sck = ring + SmemC<T, N>::RING;          // (NCK, kCh, N)
  float* sbc = sck + G::NCK * G::CK;              // (2, kSub, WARPS, 2N)
  float* sdt = sbc + 2 * G::BC;                   // (2, 2, kSub, kCh)
  const int ch0 = blockIdx.x * kCh, sg = blockIdx.y, b = blockIdx.z;
  const int n_seg = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = threadIdx.x / G::L, n0 = (threadIdx.x % G::L) * kP;
  const int ch = ch0 + cl;
  const bool live = ch < n_ch;
  const int s0 = sg * kSeg;
  const int n_sub = (min(kSeg, seq - s0) + kSub - 1) / kSub;
  const int64_t o = ((static_cast<int64_t>(b) * n_seg + sg) * n_ch + ch) * N + n0;
  float af[kP], a2[kP], h[kP], dh[kP], da[kP];
  {
    const float4 hh = live ? *reinterpret_cast<const float4*>(h_in + o)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 gg = live ? *reinterpret_cast<const float4*>(g_in + o)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    h[0] = hh.x, h[1] = hh.y, h[2] = hh.z, h[3] = hh.w;
    dh[0] = gg.x, dh[1] = gg.y, dh[2] = gg.z, dh[3] = gg.w;
  }
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    af[q] = live ? A[static_cast<int64_t>(ch) * N + n0 + q] : 0.f;
    a2[q] = af[q] * kLog2e;
    da[q] = 0.f;
  }
  const float dc = live ? D[ch] : 0.f;
  float dd = 0.f;
  float h0[kP];
#pragma unroll
  for (int q = 0; q < kP; ++q) h0[q] = h[q];

  // forward: h at the start of sub-chunks 1 .. n_sub - 1 (u, dt, B
  // only), the last one left in h
  const int n_fwd = n_sub - 1;
#pragma unroll
  for (int k = 0; k < kAheadSt; ++k) {
    if (k < n_fwd)
      R::fill(ring + k * R::SLOT, u, dt, nullptr, Bm, nullptr, b,
              s0 + k * kSub, seq, ch0, n_ch, vec);
    cp_async_commit();
  }
  for (int k = 0; k < n_fwd; ++k) {
    cp_async_wait<kAheadSt - 1>();
    __syncthreads();
    if (k + kAheadSt < n_fwd)
      R::fill(ring + ((k + kAheadSt) % kSlots) * R::SLOT, u, dt, nullptr, Bm,
              nullptr, b, s0 + (k + kAheadSt) * kSub, seq, ch0, n_ch, vec);
    cp_async_commit();
    const float* sl = ring + (k % kSlots) * R::SLOT;
#pragma unroll
    for (int x = 0; x < kSub; ++x) {
      const float dtv = sl[kSub * kCh + x * kCh + cl];
      const float du = dtv * sl[x * kCh + cl];
      const float4 bb = *reinterpret_cast<const float4*>(
          sl + 3 * kSub * kCh + x * N + n0);
      const float bn[kP] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int q = 0; q < kP; ++q)
        h[q] = fmaf(ex2(dtv * a2[q]), h[q], du * bn[q]);
    }
    if (k + 1 < n_fwd)
      *reinterpret_cast<float4*>(sck + k * G::CK + cl * N + n0) =
          make_float4(h[0], h[1], h[2], h[3]);
  }
  cp_async_wait<0>();
  __syncthreads();                      // the walk's slots are free

  // reverse: sub-chunks from the last, every input; step j takes
  // sub-chunk n_sub - 1 - j
#pragma unroll
  for (int j = 0; j < kAheadSt; ++j) {
    if (j < n_sub)
      R::fill(ring + j * R::SLOT, u, dt, dy, Bm, Cm, b,
              s0 + (n_sub - 1 - j) * kSub, seq, ch0, n_ch, vec);
    cp_async_commit();
  }
  // step jj's dB, dC (the warps' sums in warp order) and du, ddt, from
  // its staging buffers: run behind the next step's compute (the buffers
  // alternate by step, and step jj + 2 overwrites them only after the
  // barrier that ends step jj + 1)
  auto write_out = [&](int jj) {
    const int t0 = s0 + (n_sub - 1 - jj) * kSub;
    const float* bc = sbc + (jj & 1) * G::BC;
    const float* sd = sdt + (jj & 1) * G::DT;
    for (int i = threadIdx.x; i < kSub * 2 * N; i += G::THREADS) {
      const int x = i / (2 * N), c = i % (2 * N), t = t0 + x;
      if (t < seq) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < G::WARPS; ++w)
          acc += bc[(x * G::WARPS + w) * 2 * N + c];
        part_bc[((static_cast<int64_t>(blockIdx.x) * batch + b) * seq + t) *
                    2 * N + c] = acc;
      }
    }
    for (int i = threadIdx.x; i < 2 * kSub * kCh; i += G::THREADS) {
      const int q = i / (kSub * kCh), x = (i / kCh) % kSub, c = i % kCh;
      const int t = t0 + x;
      if (t < seq && ch0 + c < n_ch) {
        const int64_t off = (static_cast<int64_t>(b) * seq + t) * n_ch + ch0 + c;
        (q ? ddt_out : du_out)[off] = from_f32<T>(sd[i]);
      }
    }
  };
  for (int j = 0; j <= n_sub; ++j) {
    cp_async_wait<kAheadSt - 1>();
    __syncthreads();            // step j's inputs are in; step j - 1 done
    if (j == n_sub) {
      write_out(j - 1);
      break;
    }
    if (j + kAheadSt < n_sub)
      R::fill(ring + ((j + kAheadSt) % kSlots) * R::SLOT, u, dt, dy, Bm, Cm,
              b, s0 + (n_sub - 1 - j - kAheadSt) * kSub, seq, ch0, n_ch, vec);
    cp_async_commit();
    const int k = n_sub - 1 - j;
    const float* sl = ring + (j % kSlots) * R::SLOT;
    float* bc = sbc + (j & 1) * G::BC;
    float* sd = sdt + (j & 1) * G::DT;
    const int t0 = s0 + k * kSub;
    float hv[kP];
    if (k == 0) {
#pragma unroll
      for (int q = 0; q < kP; ++q) hv[q] = h0[q];
    } else if (k == n_sub - 1) {
#pragma unroll
      for (int q = 0; q < kP; ++q) hv[q] = h[q];
    } else {
      const float4 cc = *reinterpret_cast<const float4*>(
          sck + (k - 1) * G::CK + cl * N + n0);
      hv[0] = cc.x, hv[1] = cc.y, hv[2] = cc.z, hv[3] = cc.w;
    }
    // a_t and h_{t-1} of the sub-chunk into registers
    float ha[kSub][kP], hp[kSub][kP];
#pragma unroll
    for (int x = 0; x < kSub; ++x) {
      const float dtv = sl[kSub * kCh + x * kCh + cl];
      const float du = dtv * sl[x * kCh + cl];
      const float4 bb = *reinterpret_cast<const float4*>(
          sl + 3 * kSub * kCh + x * N + n0);
      const float bn[kP] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        ha[x][q] = ex2(dtv * a2[q]);
        hp[x][q] = hv[q];
        hv[q] = fmaf(ha[x][q], hv[q], du * bn[q]);
      }
    }
    // hv is h at the sub-chunk's last token
#pragma unroll
    for (int x = kSub - 1; x >= 0; --x) {
      const float uv = sl[x * kCh + cl];
      const float dtv = sl[kSub * kCh + x * kCh + cl];
      const float dyv = sl[2 * kSub * kCh + x * kCh + cl];
      const float4 bb = *reinterpret_cast<const float4*>(
          sl + 3 * kSub * kCh + x * N + n0);
      const float4 cc = *reinterpret_cast<const float4*>(
          sl + 3 * kSub * kCh + kSub * N + x * N + n0);
      const float bn[kP] = {bb.x, bb.y, bb.z, bb.w};
      const float cn[kP] = {cc.x, cc.y, cc.z, cc.w};
      const float du = dtv * uv;
      float sb = 0.f, sa = 0.f, vals[2 * kP];
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        const float ht = x == kSub - 1 ? hv[q] : hp[x + 1][q];
        dh[q] = fmaf(cn[q], dyv, dh[q]);
        sb = fmaf(dh[q], bn[q], sb);
        const float m = dh[q] * (ha[x][q] * hp[x][q]);
        sa = fmaf(af[q], m, sa);
        da[q] = fmaf(dtv, m, da[q]);
        vals[q] = dh[q] * du;
        vals[kP + q] = ht * dyv;
        dh[q] *= ha[x][q];
      }
      dd = fmaf(dyv, uv, dd);
      // Σ dh B, and ddt's sum Σ dh (A a h_{t-1} + u B), over the lanes
      float s2[2] = {sb, fmaf(uv, sb, sa)};
      tree_sum<2, G::L / 2, 1>(s2, lane);
      if (TreeCh::holds(lane)) {
#pragma unroll
        for (int r = 0; r < TreeCh::R; ++r) {
          const int q = TreeCh::base(lane) + r;       // 0: du, 1: ddt
          sd[(q * kSub + x) * kCh + cl] =
              q == 0 ? fmaf(dtv, s2[r], dc * dyv) : s2[r];
        }
      }
      tree_sum<2 * kP, 16, G::L>(vals, lane);
      if (TreeBC::holds(lane)) {
#pragma unroll
        for (int r = 0; r < TreeBC::R; ++r) {
          const int idx = TreeBC::base(lane) + r;
          bc[(x * G::WARPS + warp) * 2 * N + (idx / kP) * N + n0 +
             idx % kP] = vals[r];
        }
      }
    }
    if (j > 0) write_out(j - 1);
  }
  if (live) {
    *reinterpret_cast<float4*>(part_da + o) =
        make_float4(da[0], da[1], da[2], da[3]);
    if (threadIdx.x % G::L == 0)
      part_dd[(static_cast<int64_t>(b) * n_seg + sg) * n_ch + ch] = dd;
  }
}

// ---------------------------------------------------------------------
// Pass D: dB, dC: the channel blocks' partials in block order; dA, dD:
// the (row, segment) partials in that order.
// ---------------------------------------------------------------------

template <typename T, int N>
__global__ void mamba_bwd_finish(const float* __restrict__ part_bc,
                                 const float* __restrict__ part_da,
                                 const float* __restrict__ part_dd,
                                 int n_blk, int batch, int n_seg, int seq,
                                 int n_ch, T* __restrict__ dB,
                                 T* __restrict__ dC,
                                 float* __restrict__ dA,
                                 float* __restrict__ dD) {
  const int64_t n_bc = static_cast<int64_t>(batch) * seq * 2 * N;
  const int64_t n_a = static_cast<int64_t>(n_ch) * N;
  const int64_t total = n_bc + n_a + n_ch;
  const int n_part = batch * n_seg;
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
      for (int k = 0; k < n_part; ++k) acc += part_da[k * n_a + j];
      dA[j] = acc;
    } else {
      const int64_t j = i - n_bc - n_a;
      for (int k = 0; k < n_part; ++k) acc += part_dd[k * n_ch + j];
      dD[j] = acc;
    }
  }
}

template <int N>
size_t scratch_floats(int batch, int seq, int n_ch) {
  const size_t n_seg = (seq + kSeg - 1) / kSeg;
  const size_t n_blk = (n_ch + kCh - 1) / kCh;
  const size_t bnc = static_cast<size_t>(batch) * n_seg * n_ch;
  return 4 * bnc * N +                          // hloc, P, gloc, dA parts
         bnc +                                  // dD parts
         n_blk * batch * static_cast<size_t>(seq) * 2 * N;
}

template <typename T, int N>
int launch(const void* u, const void* dt, const float* A, const void* B,
           const void* C, const float* D, const void* dy, void* du,
           void* ddt, float* dA, void* dB, void* dC, float* dD,
           float* scratch, int batch, int seq, int n_ch,
           cudaStream_t stream) {
  using G = Geo<N>;
  const int n_seg = (seq + kSeg - 1) / kSeg;
  const int n_blk = (n_ch + kCh - 1) / kCh;
  const int64_t bnc = static_cast<int64_t>(batch) * n_seg * n_ch;
  float* hloc = scratch;
  float* pseg = hloc + bnc * N;
  float* gloc = pseg + bnc * N;
  float* part_da = gloc + bnc * N;
  float* part_dd = part_da + bnc * N;
  float* part_bc = part_dd + bnc;
  const T *uu = static_cast<const T*>(u), *dtt = static_cast<const T*>(dt),
          *bb = static_cast<const T*>(B), *cc = static_cast<const T*>(C),
          *yy = static_cast<const T*>(dy);
  const dim3 grid(n_blk, n_seg, batch);
  // 16-byte copies of f32 rows: aligned pointers and n_ch % 4 == 0
  const bool vec = n_ch % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(dt) |
                    reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(B) |
                    reinterpret_cast<uintptr_t>(C)) % 16 == 0;
  cudaError_t err;
  {
    auto kern = mamba_bwd_local<T, N>;
    const size_t smem = kSlots * Ring<T, N, kRowsA>::SLOT * sizeof(float);
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, G::THREADS, smem, stream>>>(
        uu, dtt, A, bb, cc, yy, hloc, pseg, gloc, seq, n_ch, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    const int64_t n = static_cast<int64_t>(batch) * n_ch * N;
    mamba_bwd_combine<N><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                           stream>>>(hloc, pseg, gloc, batch, n_seg, n_ch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    auto kern = mamba_bwd_seg<T, N>;
    const size_t smem = SmemC<T, N>::BYTES;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, G::THREADS, smem, stream>>>(
        uu, dtt, A, bb, cc, D, yy, hloc, gloc, static_cast<T*>(du),
        static_cast<T*>(ddt), part_bc, part_da, part_dd, batch, seq, n_ch,
        vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t total =
      static_cast<int64_t>(batch) * seq * 2 * N +
      static_cast<int64_t>(n_ch) * N + n_ch;
  const int64_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  mamba_bwd_finish<T, N><<<blocks, 256, 0, stream>>>(
      part_bc, part_da, part_dd, n_blk, batch, n_seg, seq, n_ch,
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

// Floats of f32 scratch a call needs (0: d_state not taken): the
// segments' hloc (then h_in), P and gloc (then the carry), the dA and dD
// partials, then the dB / dC partials.
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
  if (batch < 1 || seq < 1 || n_ch < 1 || batch > 65535 ||
      (seq + kSeg - 1) / kSeg > 65535)
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
