// RWKV6 WKV backward for sm_90a: the gradients of the WKV recurrence
// from a zero state, parallel over the sequence.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/wkv6.py
// has no backward, and JAX trains through autograd of its jnp twin
// (src/repro/models/nn.py::wkv6_chunked).  The port's training path on
// the card runs this kernel in its place.  With S_t = diag(w_t) S_{t-1}
// + k_t v_tᵀ, y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ), w clipped to
// [1e-8, 1] as the forward reads it, and G_t = dL/dS_t (G_S = 0):
//
//   G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ
//   dr_t[d] = Σ_e S_{t-1}[d,e] dy_t[e] + u[d] k_t[d] (v_t · dy_t)
//   dk_t[d] = Σ_e G_t[d,e] v_t[e]      + u[d] r_t[d] (v_t · dy_t)
//   dv_t[e] = Σ_d G_t[d,e] k_t[d]      + (Σ_d r_t[d] u[d] k_t[d]) dy_t[e]
//   dw_t[d] = Σ_e G_t[d,e] S_{t-1}[d,e]
//   du[d]   = Σ_{b,t} r_t[d] k_t[d] (v_t · dy_t)
//
// (kernels/wkv6.py::wkv6_bwd_plain is the same arithmetic in PyTorch,
// wkv6_bwd_chunked_plain this kernel's passes.)  Every element (d, e)
// of S and G follows its own scalar recurrence; dw needs S_{t-1} and
// G_t together while S runs forward and G backward.
//
// Design: split the sequence, find the boundary states, then finish
// every piece at once.  Chunks of kC = 64 tokens, c0 .. c1; with
// P(a, b)[d] = Π_{τ=a..b} w_τ[d] (1 when a > b):
//
// - Pass A (wkv6_bwd_local, all chunks at once): each chunk's decay P_c
//   = P(c0, c1), its local state ΔS_c = Σ_s (k_s ⊙ P(s+1, c1)) v_sᵀ and
//   its mirror ΔG_c = Σ_t (r_t ⊙ P(c0, t-1)) dy_tᵀ: two [Dh x C]·[C x
//   Dh] products on the CUDA cores (f32: a tensor-core f32 product is
//   TF32), a 4 x 8 tile of outputs a thread.  Persistent CTAs (as many
//   as fit the card) walk the (chunk, row · head) items; the next item's
//   inputs are loaded into registers while the current one's products
//   run.
// - Pass B (wkv6_bwd_combine): S_in of every chunk from S_c = diag(P_c)
//   S_{c-1} + ΔS_c and G_out from G_{c-1} = diag(P_c) G_c + ΔG_c walked
//   in reverse, written over ΔS_c / ΔG_c.  A thread per element (d, e)
//   walks a head's chunks in a fixed order, both walks side by side and
//   sixteen chunks' loads issued before their FMAs: only the FMA chains
//   are serial.
// - Pass C (wkv6_bwd_chunk, a CTA per (chunk, row · head), all chunks at
//   once, 512 threads at Dh 64): the CTA holds the whole Dh x Dh state,
//   a 2 x 4 tile a thread.  It walks S forward from S_in, keeping the
//   state at the start of each sub-chunk of kL = 8 tokens in shared
//   memory (6 x 16 KB; the last one stays in registers); then takes the
//   sub-chunks in reverse: their states recomputed into registers from
//   the checkpoint (forming dr on the way), then G walked back from
//   G_out forming dk, dv and dw.  dr, dk and dw sum over e within the
//   warp (a warp holds 4 whole rows) by a halving transpose-reduction: 4
//   values over 16 lanes in 5 shuffles; dv sums over d across the warp's
//   2 row groups by shuffles and across the 16 warps in shared memory,
//   in warp order.  A sub-chunk's gradients are staged in shared memory
//   and stored whole rows at a time, once, in their dtype.  du's partial
//   of each chunk is summed over chunks and rows, in that order, by a
//   last small launch (wkv6_bwd_du).  The chunk's r, k, v, w and dy
//   arrive by cp.async a sub-chunk at a time, two sub-chunks ahead of
//   the forward walk (bf16 through a two-slot ring of raw rows, each
//   thread widening the pieces it copied; f32 straight into place): the
//   walk starts once its first sub-chunk has landed, and no barrier
//   waits on a load with nothing else in flight.
//
// No float atomics anywhere: every sum across threads and blocks runs
// in a fixed order, so a call is deterministic (bit for bit from run to
// run), which the training round's executor-equals-oracle check needs.
//
// Decay safety, as in the forward kernel: every decay factor is a
// product of clipped w over an interval, in [0, 1].  Nothing divides:
// running S backwards, S_{t-1} = (S_t - k_t v_tᵀ) / w_t, or forming dw
// as d(log w) / w from suffix sums is 0 / 0 where a bf16 w underflows
// and loses every digit at strong decay; nothing forms exp(-cumulative
// log decay).  dw is finite and right at w = 0 and w = 1e-8.
//
// Tokens past S read r = k = v = dy = 0 and w = 1, which leaves S and G
// as they are, and store nothing.
//
// What bounds it on the H100: operations.  The plain arithmetic takes
// ~6 f32 FMAs a (token, d, e) (the state's update, G's update, and one
// each of dr, dk, dv and dw), 1.2 G FMA at the training call (1, 4096,
// 32, 64) against 151 MB of inputs and outputs (45 us at 3.35 TB/s).
// This design adds pass A's two products (2 FMAs a (token, d, e)), one
// more walk of S (pass C's checkpoints) and ~4 shuffle-reduction
// instructions a (token, d, e); its scratch is ΔS
// and ΔG (then S_in and G_out), 2 x 33.5 MB at the training call,
// written once and read twice.  Pass C is bound by instruction issue and
// latency at one CTA an SM (its 225 KB of shared memory; its 512 threads
// at ~128 registers fill the register file too), the FMA pipe's issue
// first: fewer shuffles a token (several tokens a reduction tree) did not
// move it.  What would move it further is the tensor cores for dr, dk
// and dv (the chunked form), leaving the stepwise walks to dw alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kC = 64;   // tokens a chunk
constexpr int kL = 8;    // tokens a sub-chunk: checkpoint interval

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

// Four consecutive elements as floats: one 16-byte (f32) or 8-byte
// (bf16) load when `vec` (the tensors' base pointers are aligned; every
// 4-element group of a row is then aligned too), else four loads.
__device__ __forceinline__ float4 ld4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]),
                     to_f32(p[3]));
}

// BYTES (8 or 16) from global to shared memory, asynchronously;
// `valid` false reads nothing and zero-fills.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(K) : "memory");
}

__device__ __forceinline__ float4 clip4(float4 w) {
  return make_float4(clip_w(w.x), clip_w(w.y), clip_w(w.z), clip_w(w.w));
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

// ---------------------------------------------------------------------
// Pass A: a chunk's P_c, ΔS_c and ΔG_c.
// ---------------------------------------------------------------------

template <int DH> struct GeoA {
  static constexpr int TC = DH < 8 ? DH : 8;            // tile: 4 x TC
  static constexpr int TILES = (DH / 4) * (DH / TC);    // a product's
  static constexpr int THREADS = 2 * TILES < 32 ? 32 : 2 * TILES;
  static constexpr int N4 = kC * DH / 4 / THREADS;      // 4-groups a thread
  static constexpr size_t SMEM = 5 * kC * DH * sizeof(float);
};

// Four consecutive inputs as loaded (8 bytes of bf16, 16 of f32), held
// in registers until they are converted and stored.
template <typename T> struct Raw4;
template <> struct Raw4<float> {
  float4 x;
  __device__ __forceinline__ void load(const float* p, bool vec) {
    x = ld4(p, vec);
  }
  __device__ __forceinline__ float4 get() const { return x; }
};
template <> struct Raw4<__nv_bfloat16> {
  __nv_bfloat162 a, b;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, bool vec) {
    if (vec) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    } else {
      a = __halves2bfloat162(p[0], p[1]);
      b = __halves2bfloat162(p[2], p[3]);
    }
  }
  __device__ __forceinline__ float4 get() const {
    const float2 x = __bfloat1622float2(a), y = __bfloat1622float2(b);
    return make_float4(x.x, x.y, y.x, y.y);
  }
};

// A persistent CTA walks items (chunk, row · head) with a stride of the
// grid; the next item's inputs are loaded into registers while the
// current one's products run, so the loads' latency hides under them.
template <typename T, int DH>
__global__ void __launch_bounds__(GeoA<DH>::THREADS)
wkv6_bwd_local(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const T* __restrict__ dy,
               float* __restrict__ dS,     // (BH, NC, Dh, Dh)
               float* __restrict__ dG,     // (BH, NC, Dh, Dh)
               float* __restrict__ pc,     // (BH, NC, Dh)
               int seq, int n_heads, int n_chunks, int n_items, bool vec) {
  using G = GeoA<DH>;
  extern __shared__ float4 smem_a[];
  float* sk = reinterpret_cast<float*>(smem_a);     // k ⊙ P(s+1, c1)
  float* sr = sk + kC * DH;                          // r ⊙ P(c0, t-1)
  float* sv = sr + kC * DH;
  float* sy = sv + kC * DH;
  float* sw = sy + kC * DH;
  const int tid = threadIdx.x;
  const int64_t t_stride = static_cast<int64_t>(n_heads) * DH;
  Raw4<T> x[5][G::N4];
  auto issue = [&](int item) {               // the item's loads
    const int c = item % n_chunks, bh = item / n_chunks;
    const int b = bh / n_heads, h = bh % n_heads, c0 = c * kC;
    const int64_t base = (static_cast<int64_t>(b) * seq * n_heads + h) * DH +
                         static_cast<int64_t>(c0) * t_stride;
#pragma unroll
    for (int j = 0; j < G::N4; ++j) {
      const int i = tid + j * G::THREADS;
      const int t = i / (DH / 4), d4 = (i % (DH / 4)) * 4;
      const int64_t off = c0 + t < seq ? base + t * t_stride + d4 : 0;
      x[0][j].load(k + off, vec);
      x[1][j].load(r + off, vec);
      x[2][j].load(v + off, vec);
      x[3][j].load(dy + off, vec);
      x[4][j].load(w + off, vec);
    }
  };
  if (blockIdx.x < n_items) issue(blockIdx.x);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int c = item % n_chunks, bh = item / n_chunks;
    const int c0 = c * kC;
    __syncthreads();                         // the last item's reads done
#pragma unroll
    for (int j = 0; j < G::N4; ++j) {        // zeros (w = 1) past S
      const int i = tid + j * G::THREADS;
      const bool ok = c0 + i / (DH / 4) < seq;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int a = 0; a < 4; ++a)
        reinterpret_cast<float4*>(sk + a * kC * DH)[i] = ok ? x[a][j].get() : z;
      reinterpret_cast<float4*>(sw)[i] =
          ok ? clip4(x[4][j].get()) : make_float4(1.f, 1.f, 1.f, 1.f);
    }
    __syncthreads();
    if (item + static_cast<int>(gridDim.x) < n_items)
      issue(item + gridDim.x);
    if (tid < DH) {                          // prefix products: r ⊙ P
      float p = 1.f;
#pragma unroll 8
      for (int t = 0; t < kC; ++t) {
        sr[t * DH + tid] *= p;
        p *= sw[t * DH + tid];
      }
      pc[(static_cast<int64_t>(bh) * n_chunks + c) * DH + tid] = p;
    } else if (tid < 2 * DH) {               // suffix products: k ⊙ P
      const int d = tid - DH;
      float p = 1.f;
#pragma unroll 8
      for (int s = kC - 1; s >= 0; --s) {
        sk[s * DH + d] *= p;
        p *= sw[s * DH + d];
      }
    }
    __syncthreads();
    // ΔS = Σ_s (k ⊙ P)_s v_sᵀ on threads [0, TILES), ΔG = Σ_t (r ⊙ P)_t
    // dy_tᵀ on [TILES, 2 TILES): a 4 x TC tile of outputs a thread
    if (tid < 2 * G::TILES) {
      const bool is_g = tid >= G::TILES;
      const int tile = is_g ? tid - G::TILES : tid;
      const int d0 = (tile / (DH / G::TC)) * 4, e0 = (tile % (DH / G::TC)) * G::TC;
      const float* sa = is_g ? sr : sk;
      const float* sb = is_g ? sy : sv;
      float acc[4][G::TC] = {};
      const int n_tok = min(kC, seq - c0);
      for (int s = 0; s < n_tok; ++s) {
        const float4 aa = *reinterpret_cast<const float4*>(sa + s * DH + d0);
        const float ad[4] = {aa.x, aa.y, aa.z, aa.w};
        float be[G::TC];
#pragma unroll
        for (int j = 0; j < G::TC; j += 4) {
          const float4 bb = *reinterpret_cast<const float4*>(sb + s * DH + e0 + j);
          be[j] = bb.x, be[j + 1] = bb.y, be[j + 2] = bb.z, be[j + 3] = bb.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < G::TC; ++j) acc[i][j] = fmaf(ad[i], be[j], acc[i][j]);
      }
      float* out = (is_g ? dG : dS) +
                   (static_cast<int64_t>(bh) * n_chunks + c) * DH * DH;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < G::TC; j += 4)
          *reinterpret_cast<float4*>(out + (d0 + i) * DH + e0 + j) =
              make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
    }
  }
}

// ---------------------------------------------------------------------
// Pass B: S_in and G_out of every chunk, over ΔS and ΔG in place.
// ---------------------------------------------------------------------

constexpr int kCombineThreads = 256;
constexpr int kAhead = 16;   // chunks whose loads are issued together

template <int DH>
__global__ void __launch_bounds__(kCombineThreads)
wkv6_bwd_combine(float* __restrict__ dS, float* __restrict__ dG,
                 const float* __restrict__ pc, int n_chunks) {
  const int el = blockIdx.x * kCombineThreads + threadIdx.x;
  if (el >= DH * DH) return;
  const int bh = blockIdx.y, d = el / DH;
  const int64_t o = static_cast<int64_t>(bh) * n_chunks * DH * DH + el;
  const float* p = pc + static_cast<int64_t>(bh) * n_chunks * DH + d;
  // S forward from zero before chunk 0, G backward from zero after the
  // last chunk, side by side
  float s = 0.f, g = 0.f;
  for (int c = 0; c < n_chunks; c += kAhead) {
    float xs[kAhead], ps[kAhead], xg[kAhead], pg[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const bool ok = c + i < n_chunks;
      const int cs = c + i, cg = n_chunks - 1 - c - i;
      xs[i] = ok ? dS[o + static_cast<int64_t>(cs) * DH * DH] : 0.f;
      ps[i] = ok ? p[cs * DH] : 1.f;
      xg[i] = ok ? dG[o + static_cast<int64_t>(cg) * DH * DH] : 0.f;
      pg[i] = ok ? p[cg * DH] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c + i < n_chunks) {
        const int cs = c + i, cg = n_chunks - 1 - c - i;
        dS[o + static_cast<int64_t>(cs) * DH * DH] = s;    // S_in
        dG[o + static_cast<int64_t>(cg) * DH * DH] = g;    // G_out
        s = fmaf(ps[i], s, xs[i]);
        g = fmaf(pg[i], g, xg[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// Pass C: every chunk's gradients from its S_in and G_out.
// ---------------------------------------------------------------------

template <int DH> struct GeoC {
  static constexpr int NCG = DH / 4;              // column groups (4 cols)
  static constexpr int NRG = DH / 2;              // row groups (2 rows)
  static constexpr int RGW = 32 / NCG;            // row groups a warp
  static constexpr int THREADS = NRG * NCG < 32 ? 32 : NRG * NCG;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int N4 = kC * DH / 4 / THREADS;
  // checkpoints in smem: the states at the starts of sub-chunks 1 ..
  // kC / kL - 2 (the last sub-chunk's start stays in registers)
  static constexpr int NCK = kC / kL - 2;
  // floats: k, w, v, r, dy (kC x Dh each), u, v·dy, Σ r u k,
  // checkpoints, dv's per-warp sums, a sub-chunk's dr, dk, dw
  static constexpr int F_IN = 5 * kC * DH;
  static constexpr int F_CK = NCK * DH * DH;
  static constexpr int F_DV = kL * WARPS * DH;
  static constexpr int F_OUT = 3 * kL * DH;
  static constexpr size_t SMEM =
      (F_IN + DH + 2 * kC + F_CK + F_DV + F_OUT) * sizeof(float);
};

// How pass C's inputs stream in: a sub-chunk of k, w, v, r, dy (in that
// order, as the f32 arrays lie) in pieces of PE elements, 16 bytes (8 at
// bf16 Dh 4), one cp.async each.  bf16 lands raw in a two-slot ring and
// is widened by the thread that copied it; f32 lands in place.
template <typename T, int DH> struct StreamC {
  static constexpr int PE = 16 / int(sizeof(T)) < DH ? 16 / int(sizeof(T))
                                                     : DH;
  static constexpr int PB = PE * int(sizeof(T));
  static constexpr int ROW = DH / PE;                   // pieces a row
  static constexpr int PIECES = 5 * kL * ROW;           // a sub-chunk's
  static constexpr int NP = (PIECES + GeoC<DH>::THREADS - 1) /
                            GeoC<DH>::THREADS;          // a thread's
  static constexpr bool RING = sizeof(T) < 4;
  static constexpr int SLOT = 5 * kL * DH;              // elements a slot
  static constexpr size_t SMEM =
      GeoC<DH>::SMEM + (RING ? 2 * SLOT * sizeof(T) : 0);
};

template <typename T, int DH>
__global__ void __launch_bounds__(GeoC<DH>::THREADS, 1)
wkv6_bwd_chunk(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const T* __restrict__ u, const T* __restrict__ dy,
               const float* __restrict__ s_in,    // (BH, NC, Dh, Dh)
               const float* __restrict__ g_out,   // (BH, NC, Dh, Dh)
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               T* __restrict__ dw,
               float* __restrict__ du_part,       // (NC, B, H, Dh)
               int seq, int n_heads, bool vec) {
  using G = GeoC<DH>;
  using TreeRow2 = Tree<2, G::NCG / 2, 1>;        // dr: over a row's lanes
  using TreeRow4 = Tree<4, G::NCG / 2, 1>;        // dk, dw
  using TreeCol = Tree<4, 16, G::NCG>;            // dv: over the warp's rows
  static_assert(G::NCK >= 0, "a chunk holds at least two sub-chunks");
  extern __shared__ float4 smem_c[];
  float* sk = reinterpret_cast<float*>(smem_c);
  float* sw = sk + kC * DH;
  float* sv = sw + kC * DH;
  float* sr = sv + kC * DH;
  float* sy = sr + kC * DH;
  float* su = sy + kC * DH;
  float* s_vdy = su + DH;
  float* s_ruk = s_vdy + kC;
  float* sck = s_ruk + kC;                        // (NCK, Dh, Dh)
  float* sdv = sck + G::F_CK;                     // (kL, WARPS, Dh)
  float* sout = sdv + G::F_DV;                    // (3, kL, Dh): dr dk dw

  const int c = blockIdx.x, bh = blockIdx.y, n_chunks = gridDim.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int c0 = c * kC, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rg = warp * G::RGW + lane / G::NCG, cg = lane % G::NCG;
  const bool live = rg < G::NRG;
  const int d0 = live ? rg * 2 : 0, e0 = cg * 4;
  const int n_tok = min(kC, seq - c0);
  const int n_sub = (n_tok + kL - 1) / kL;
  const int64_t t_stride = static_cast<int64_t>(n_heads) * DH;
  const int64_t base =
      (static_cast<int64_t>(b) * seq * n_heads + h) * DH +
      static_cast<int64_t>(c0) * t_stride;
  const int64_t st = (static_cast<int64_t>(bh) * n_chunks + c) * DH * DH;

  // sub-chunk j's piece p: array a (k, w, v, r, dy), token x, element d
  using St = StreamC<T, DH>;
  T* ring = reinterpret_cast<T*>(sout + G::F_OUT);
  auto land = [&](int j, int a, int x, int d) -> T* {
    if constexpr (St::RING)
      return ring + (j & 1) * St::SLOT + (a * kL + x) * DH + d;
    else
      return reinterpret_cast<T*>(sk) + a * kC * DH + (j * kL + x) * DH + d;
  };
  // issue sub-chunk j's copies (none past the chunk), one group a call
  auto fill = [&](int j) {
    if (j < n_sub) {
#pragma unroll
      for (int n = 0; n < St::NP; ++n) {
        const int p = tid + n * G::THREADS;
        if (St::PIECES % G::THREADS != 0 && p >= St::PIECES) break;
        const int a = p / (kL * St::ROW), q = p % (kL * St::ROW);
        const int x = q / St::ROW, d = (q % St::ROW) * St::PE;
        const int t = j * kL + x;
        const bool ok = t < n_tok;
        const T* g = a == 0 ? k : a == 1 ? w : a == 2 ? v : a == 3 ? r : dy;
        g += ok ? base + t * t_stride + d : 0;
        T* dst = land(j, a, x, d);
        if (vec) {
          cp_async<St::PB>(dst, g, ok);
        } else {
#pragma unroll
          for (int e = 0; e < St::PE; ++e)
            dst[e] = ok ? g[e] : from_f32<T>(0.f);
        }
      }
    }
    cp_async_commit();
  };
  // sub-chunk j's pieces this thread copied, as f32 in place: w clipped,
  // 1 past S
  auto widen = [&](int j) {
#pragma unroll
    for (int n = 0; n < St::NP; ++n) {
      const int p = tid + n * G::THREADS;
      if (St::PIECES % G::THREADS != 0 && p >= St::PIECES) break;
      const int a = p / (kL * St::ROW), q = p % (kL * St::ROW);
      if (!St::RING && a != 1) continue;
      const int x = q / St::ROW, d = (q % St::ROW) * St::PE;
      const int t = j * kL + x;
      const T* src = land(j, a, x, d);
      float* f = sk + a * kC * DH + t * DH + d;
#pragma unroll
      for (int e = 0; e < St::PE; e += 4) {
        float4 y = ld4(src + e, true);
        if (a == 1)
          y = t < n_tok ? clip4(y) : make_float4(1.f, 1.f, 1.f, 1.f);
        *reinterpret_cast<float4*>(f + e) = y;
      }
    }
  };
  fill(0);
  fill(1);
  if (tid < DH) su[tid] = to_f32(u[h * DH + tid]);
  // this thread's tile of S_in and G_out: rows d0, d0 + 1, cols e0 .. e0+3
  float S[2][4], Gs[2][4], S0[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 a = live ? *reinterpret_cast<const float4*>(
                                s_in + st + (d0 + i) * DH + e0)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 g = live ? *reinterpret_cast<const float4*>(
                                g_out + st + (d0 + i) * DH + e0)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    S0[i][0] = a.x, S0[i][1] = a.y, S0[i][2] = a.z, S0[i][3] = a.w;
    Gs[i][0] = g.x, Gs[i][1] = g.y, Gs[i][2] = g.z, Gs[i][3] = g.w;
  }

  // forward walk, a sub-chunk as it lands: S at the start of sub-chunks
  // 1 .. n_sub - 2 into shared memory, the last one's left in S
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) S[i][j] = S0[i][j];
  for (int j = 0; j < n_sub; ++j) {
    cp_async_wait<1>();                 // sub-chunk j's copies landed
    widen(j);
    fill(j + 2);                        // into the slot just widened
    __syncthreads();
    if (j == n_sub - 1) break;
#pragma unroll
    for (int x = 0; x < kL; ++x) {
      const int t = j * kL + x;
      const float2 kk = *reinterpret_cast<const float2*>(sk + t * DH + d0);
      const float2 ww = *reinterpret_cast<const float2*>(sw + t * DH + d0);
      const float4 vv = *reinterpret_cast<const float4*>(sv + t * DH + e0);
      const float kd[2] = {live ? kk.x : 0.f, live ? kk.y : 0.f};
      const float wd[2] = {ww.x, ww.y};
      const float ve[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          S[i][e] = fmaf(wd[i], S[i][e], kd[i] * ve[e]);
    }
    if (j + 1 < n_sub - 1 && live) {
      float* ck = sck + j * DH * DH;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float4*>(ck + (d0 + i) * DH + e0) =
            make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
    }
  }
  // v_t · dy_t and Σ_d r_t u k_t, a warp per token at a time, lanes over
  // channels in a fixed order
  for (int t = warp; t < n_sub * kL; t += G::WARPS) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int x0 = 0; x0 < DH; x0 += 32) {
      const int x = x0 + lane;
      if (x < DH) {
        a = fmaf(sv[t * DH + x], sy[t * DH + x], a);
        q = fmaf(sr[t * DH + x] * su[x], sk[t * DH + x], q);
      }
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) s_vdy[t] = a, s_ruk[t] = q;
  }
  __syncthreads();

  const int64_t out0 = base;                      // (b, c0, h, 0)
  for (int sc = n_sub - 1; sc >= 0; --sc) {
    const int t0 = sc * kL;
    if (sc == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) S[i][j] = S0[i][j];
    } else if (sc < n_sub - 1) {
      const float* ck = sck + (sc - 1) * DH * DH;
#pragma unroll
      for (int i = 0; i < 2; ++i) {       // padding rows stay at zero
        const float4 a = live ? *reinterpret_cast<const float4*>(
                                    ck + (d0 + i) * DH + e0)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        S[i][0] = a.x, S[i][1] = a.y, S[i][2] = a.z, S[i][3] = a.w;
      }
    }
    // the sub-chunk's states S_{t-1} into registers; dr on the way
    float hist[kL][2][4];
#pragma unroll
    for (int x = 0; x < kL; ++x) {
      const int t = t0 + x;
      const float2 kk = *reinterpret_cast<const float2*>(sk + t * DH + d0);
      const float2 ww = *reinterpret_cast<const float2*>(sw + t * DH + d0);
      const float4 vv = *reinterpret_cast<const float4*>(sv + t * DH + e0);
      const float4 yy = *reinterpret_cast<const float4*>(sy + t * DH + e0);
      const float kd[2] = {live ? kk.x : 0.f, live ? kk.y : 0.f};
      const float wd[2] = {ww.x, ww.y};
      const float ve[4] = {vv.x, vv.y, vv.z, vv.w};
      const float ye[4] = {yy.x, yy.y, yy.z, yy.w};
      float pr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pr[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hist[x][i][j] = S[i][j];
          pr[i] = fmaf(S[i][j], ye[j], pr[i]);
          S[i][j] = fmaf(wd[i], S[i][j], kd[i] * ve[j]);
        }
      }
      tree_sum<2, G::NCG / 2, 1>(pr, lane);
      if (live && TreeRow2::holds(lane)) {
#pragma unroll
        for (int q = 0; q < TreeRow2::R; ++q)
          sout[x * DH + d0 + TreeRow2::base(lane) + q] = pr[q];
      }
    }
    // G back through the sub-chunk: dk, dw, and dv's warp sums
#pragma unroll
    for (int x = kL - 1; x >= 0; --x) {
      const int t = t0 + x;
      const float2 rr = *reinterpret_cast<const float2*>(sr + t * DH + d0);
      const float2 kk = *reinterpret_cast<const float2*>(sk + t * DH + d0);
      const float2 ww = *reinterpret_cast<const float2*>(sw + t * DH + d0);
      const float4 vv = *reinterpret_cast<const float4*>(sv + t * DH + e0);
      const float4 yy = *reinterpret_cast<const float4*>(sy + t * DH + e0);
      const float rd[2] = {live ? rr.x : 0.f, live ? rr.y : 0.f};
      const float kd[2] = {live ? kk.x : 0.f, live ? kk.y : 0.f};
      const float wd[2] = {ww.x, ww.y};
      const float ve[4] = {vv.x, vv.y, vv.z, vv.w};
      const float ye[4] = {yy.x, yy.y, yy.z, yy.w};
      float p4[4] = {0.f, 0.f, 0.f, 0.f};         // dk d0, d0+1; dw d0, d0+1
      float pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = Gs[0][j] * kd[0];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p4[i] = fmaf(Gs[i][j], ve[j], p4[i]);
          p4[2 + i] = fmaf(Gs[i][j], hist[x][i][j], p4[2 + i]);
          if (i) pv[j] = fmaf(Gs[i][j], kd[i], pv[j]);
          Gs[i][j] = fmaf(wd[i], Gs[i][j], rd[i] * ye[j]);
        }
      tree_sum<4, G::NCG / 2, 1>(p4, lane);
      tree_sum<4, 16, G::NCG>(pv, lane);
      if (live && TreeRow4::holds(lane)) {
#pragma unroll
        for (int q = 0; q < TreeRow4::R; ++q) {
          const int idx = TreeRow4::base(lane) + q;   // dk d0, d0+1, dw ..
          sout[(1 + idx / 2) * kL * DH + x * DH + d0 + (idx & 1)] = p4[q];
        }
      }
      if (TreeCol::holds(lane)) {
#pragma unroll
        for (int q = 0; q < TreeCol::R; ++q)
          sdv[(x * G::WARPS + warp) * DH + e0 + TreeCol::base(lane) + q] =
              pv[q];
      }
    }
    __syncthreads();
    // the sub-chunk's gradients, each row of Dh stored whole: dv (the
    // warps' sums in warp order), dr, dk, dw, with the bonus terms
    for (int i = tid; i < 4 * kL * DH; i += G::THREADS) {
      const int q = i / (kL * DH), x = (i / DH) % kL, d = i % DH;
      const int t = t0 + x;
      if (t >= n_tok) continue;
      const int64_t at = out0 + t * t_stride + d;
      if (q == 0) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < G::WARPS; ++w) acc += sdv[(x * G::WARPS + w) * DH + d];
        dv[at] = from_f32<T>(fmaf(s_ruk[t], sy[t * DH + d], acc));
      } else if (q == 1) {
        dr[at] = from_f32<T>(fmaf(su[d] * sk[t * DH + d], s_vdy[t],
                                  sout[x * DH + d]));
      } else if (q == 2) {
        dk[at] = from_f32<T>(fmaf(su[d] * sr[t * DH + d], s_vdy[t],
                                  sout[kL * DH + x * DH + d]));
      } else {
        dw[at] = from_f32<T>(sout[2 * kL * DH + x * DH + d]);
      }
    }
    __syncthreads();
  }
  if (tid < DH) {                          // du's partial over the chunk
    float acc = 0.f;
    for (int t = 0; t < n_tok; ++t)
      acc = fmaf(sr[t * DH + tid] * sk[t * DH + tid], s_vdy[t], acc);
    du_part[(static_cast<int64_t>(c) * gridDim.y + bh) * DH + tid] = acc;
  }
}

// du: the chunks' partials, summed over chunks, then rows, in that order.
template <typename T>
__global__ void wkv6_bwd_du(const float* __restrict__ du_part,
                            int n_chunks, int batch, int hd,
                            T* __restrict__ du) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hd) return;
  float acc = 0.f;
  for (int bb = 0; bb < batch; ++bb)
    for (int c = 0; c < n_chunks; ++c)
      acc += du_part[(static_cast<int64_t>(c) * batch + bb) * hd + i];
  du[i] = from_f32<T>(acc);
}

template <int DH>
size_t scratch_floats(int batch, int seq, int n_heads) {
  const size_t n_chunks = (seq + kC - 1) / kC;
  const size_t bh = static_cast<size_t>(batch) * n_heads;
  return 2 * bh * n_chunks * DH * DH + 2 * bh * n_chunks * DH;
}

template <typename T, int DH>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dy, void* dr, void* dk, void* dv,
           void* dw, void* du, float* scratch, int batch, int seq,
           int n_heads, cudaStream_t stream) {
  const int n_chunks = (seq + kC - 1) / kC;
  const int bh = batch * n_heads;
  float* dS = scratch;
  float* dG = dS + static_cast<int64_t>(bh) * n_chunks * DH * DH;
  float* pc = dG + static_cast<int64_t>(bh) * n_chunks * DH * DH;
  float* du_part = pc + static_cast<int64_t>(bh) * n_chunks * DH;
  const T *rr = static_cast<const T*>(r), *kk = static_cast<const T*>(k),
          *vv = static_cast<const T*>(v), *ww = static_cast<const T*>(w),
          *yy = static_cast<const T*>(dy);
  const uintptr_t any = reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(dy);
  const bool vec = any % (sizeof(T) * 4) == 0;
  const bool vec_c = any % StreamC<T, DH>::PB == 0;   // pass C's pieces
  cudaError_t err;
  const dim3 grid(n_chunks, bh);
  {
    auto kern = wkv6_bwd_local<T, DH>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(GeoA<DH>::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, GeoA<DH>::THREADS, GeoA<DH>::SMEM)) != cudaSuccess)
      return static_cast<int>(err);
    const int n_items = n_chunks * bh;
    const int ctas = std::min(n_items, std::max(1, sms * per_sm));
    kern<<<ctas, GeoA<DH>::THREADS, GeoA<DH>::SMEM, stream>>>(
        rr, kk, vv, ww, yy, dS, dG, pc, seq, n_heads, n_chunks, n_items,
        vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_bwd_combine<DH><<<dim3((DH * DH + kCombineThreads - 1) /
                                  kCombineThreads, bh),
                         kCombineThreads, 0, stream>>>(dS, dG, pc, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    auto kern = wkv6_bwd_chunk<T, DH>;
    constexpr size_t smem = StreamC<T, DH>::SMEM;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, GeoC<DH>::THREADS, smem, stream>>>(
        rr, kk, vv, ww, static_cast<const T*>(u), yy, dS, dG,
        static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<T*>(dw), du_part, seq, n_heads, vec_c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_bwd_du<T><<<(n_heads * DH + 255) / 256, 256, 0, stream>>>(
      du_part, n_chunks, batch, n_heads * DH, static_cast<T*>(du));
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

// Floats of f32 scratch a call needs (0: d_head not taken): ΔS and ΔG
// (then S_in and G_out) of every chunk, the chunks' decays, du's
// partials.
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
