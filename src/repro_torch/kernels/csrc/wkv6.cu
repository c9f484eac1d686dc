// RWKV6 (Finch) WKV recurrence for sm_90a: a chunked bf16 kernel on the
// tensor cores and a stepwise kernel on the CUDA cores.
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
// The wrapper picks the kernel by shape and dtype alone: bf16 with
// S >= 16 and Dh in 16, 32 or 64 runs the chunked kernel, anything else
// (f32, the S = 1 decode step, Dh 4 or 8) the stepwise one.
//
// What bounds it on the H100: bytes, but only on the tensor cores.  The
// stepwise form does 4·Dh² f32 operations a token and head, 4.3 GFLOP
// at the rwkv6 prefill (8, 1024, 32, 64): 64 us at the 67 TFLOP/s CUDA-
// core rate, above the 52.6 us byte bound.  The chunked form moves the
// Dh² products to the tensor cores.
//
// Chunked kernel (wkv6_chunked_kernel, bf16).  Chunks of C = 16 tokens;
// with P(a, b)[d] = Π_{τ=a..b} w_τ[d] (1 when a > b) and c0 .. c1 the
// chunk's tokens:
//
//   y_t  = (r_t ⊙ P(c0, t-1)) · S_in                           inter
//        + Σ_{c0<=s<t} A[t, s] v_s + (r_t · (u ⊙ k_t)) v_t       intra
//   A[t, s] = Σ_d r_t[d] k_s[d] P(s+1, t-1)[d]
//   S_out = diag(P(c0, c1)) S_in + Σ_s (k_s ⊙ P(s+1, c1)) v_sᵀ
//
// Decay safety: every decay factor formed is a product of clipped w over
// an interval, so it lies in [0, 1]: it may underflow to 0 (the right
// limit) but never overflows.  The kernel never divides by a product and
// never forms exp(-cumulative log decay), the factoring that makes the
// TPU kernel overflow f32 once a chunk's summed log-decay passes 88.7.
// A is built in the chunk's two 8-token halves: pairs inside a half
// directly on the CUDA cores by running products (q_s ← q_s ⊙ w_t as t
// advances), and second-half queries against first-half keys on the
// tensor cores as (r_t ⊙ P(c0 + 8, t-1)) · (k_s ⊙ P(s+1, c0 + 7)), both
// factors <= 1.
//
// - One CTA per (row, head) of 4·Dh / 32 warps, specialised: Dh / 16
//   producer warps and Dh / 16 consumer warps, two CTAs an SM.
// - Consumers hold the state: consumer warp w owns rows e of Sᵀ in
//   [16w, 16w + 16) over all Dh columns d, as the f32 accumulator
//   fragments of mma.sync m16n8k16 (bf16 -> f32).  Sᵀ in the C layout is
//   exactly S in the B layout of y = (r ⊙ P) · S, so the state feeds the
//   inter-chunk product from registers without a shuffle, and the state
//   update Sᵀ += Vᵀ · K' accumulates into the same registers.  They sum
//   the producers' parts of A into its fragments, run every product of
//   a chunk on the tensor cores (ldmatrix, .trans for V and K') and
//   store y as bf16.
// - f32 accuracy from bf16 tensor cores: an operand that is not a bf16
//   input (r ⊙ P, S, A, k ⊙ P) is split x = hi + lo into two bf16s and a
//   product is hi·hi + hi·lo + lo·hi (v is an exact bf16 input: hi·v +
//   lo·v).  The result is within ~2^-16 of the f32 product: a single
//   bf16 rounding (2^-8) of S would move y by several times the 2e-2
//   tolerance against the f32 plain version.
// - Producers run up to two 32-token stages ahead: r, k, v and w arrive
//   by 16-byte cp.async copies in a two-slot ring, a stage ahead; a
//   thread per (direction, chunk, channel pair) forms the running
//   products, r ⊙ P and k ⊙ P split into bf16 hi / lo, P(c0, c1) and a
//   copy of v into one of two stage slots; then the warps form their
//   parts of A (each warp 16 channels).  Named barriers hand a slot over
//   (filled: producers arrive, consumers wait; emptied: the reverse).
//   Loads are issued before stores in every producer loop: the compiler
//   cannot tell the slot from the ring, and a store between two tokens'
//   loads serialises them.
// - Tokens past S are zero-filled by the copies (r = k = v = 0) and read
//   as w = 1, so the ragged last chunk needs no padding in memory and a
//   chunk wholly past S is skipped.
//
// Stepwise kernel (wkv6_kernel, f32 and short calls).  One block per
// (row, head) runs Dh threads; thread e owns column e of S (S[:, e], Dh
// floats in registers).  At each step the block stages r_t, k_t and the
// clipped w_t in shared memory (double-buffered, one barrier a step)
// while every thread loads step t + 1's elements, then thread e computes
//
//   y_t[e] = Σ_d r_t[d] · (S[d, e] + u[d] · k_t[d] · v_t[e])
//   S[d, e] = w_t[d] · S[d, e] + k_t[d] · v_t[e]
//
// in f32, exact to the fp32 checks' 2e-5 (a tensor-core f32 product is
// TF32).  A one-token decode step is latency-bound either way and stays
// here.
//
// In-place state: s0 and s_out may be the same buffer (the wrapper
// passes one pointer for both when a state is given).  Both kernels read
// a CTA's own (row, head) block of s0 once, before the first token, and
// write the same elements of s_out after the last; every element is
// read and written by one thread.  s0 and s_out are therefore not
// restrict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// ---------------------------------------------------------------------
// chunked bf16 kernel: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------

constexpr int kChunk = 16;                  // tokens a chunk (one m16 tile)
constexpr int kStage = 32;                  // tokens a cp.async stage
constexpr int kChunks = kStage / kChunk;    // chunks a stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 reads nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.  Plain: the A fragment of a 16x16 row-major tile when
// lane l points at row l % 16, column 8 · (l / 16).  .trans: B fragments
// of a row-major [k][n] tile (two n-tiles of 8), or the A fragment of its
// transpose.  No memory clobber: only the consumers call them, between
// named barriers that are asm volatile too, which keeps them in order.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a · b, m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  return u;
}

// (x0, x1) = hi + lo as two bf16 pairs (lo carries the next 8 bits of
// mantissa)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

template <int DH>
struct __align__(16) ChunkSmem {
  static constexpr int kPitch = DH + 8;     // bf16 rows: 16-byte aligned,
                                            // ldmatrix without conflicts
  // a stage's inputs r, k, v, w (producers only)
  __nv_bfloat16 ring[2][4][kStage][kPitch];
  // what the consumers read of a stage, one slot a stage in flight
  struct Slot {
    __nv_bfloat16 rp[2][kStage][kPitch];    // r ⊙ P(c0, t-1): hi, lo
    __nv_bfloat16 kp[2][kStage][kPitch];    // k ⊙ P(s+1, c1): hi, lo
    __nv_bfloat16 v[kStage][kPitch];
    float a[DH / 16][kChunks][kChunk][kChunk];   // A + bonus, a warp's part
    float ptot[kChunks][DH];                // P(c0, c1)
  } slot[2];
  // producer scratch
  // the factors of A across a chunk's two 8-token halves: row 8 j + i is
  // r ⊙ P(c0 + 8, t-1) at t = c0 + 8 + i, and k ⊙ P(s+1, c0 + 7) at
  // s = c0 + i (chunk j); hi, lo
  __nv_bfloat16 q8[2][kChunks * 8][kPitch];
  __nv_bfloat16 k8[2][kChunks * 8][kPitch];
  float u[DH];
};

struct Inputs {
  const __nv_bfloat16* p[4];                  // r, k, v, w
};

// Named barriers: 0 is __syncthreads; the producers' own; a stage slot
// filled (producers arrive, consumers wait) and emptied (the reverse).
constexpr int kBarProducers = 1;
constexpr int kBarFull = 2;                   // + slot
constexpr int kBarEmpty = 4;                  // + slot

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Issue the copies of r, k, v, w for tokens base .. base + kStage - 1
// of one (row, head) into ring slot `slot`; tokens past S are zeroed.
// Called by the 2·DH producer threads.
template <int DH>
__device__ __forceinline__ void load_stage(ChunkSmem<DH>& sm, int slot,
                                           const Inputs& in, int64_t row0,
                                           int64_t t_stride, int base,
                                           int seq) {
  constexpr int kPieces = DH / 8;             // 16-byte pieces a row
  static_assert(kStage * kPieces == 2 * (2 * DH), "two pieces a thread");
#pragma unroll
  for (int arr = 0; arr < 4; ++arr)
#pragma unroll
    for (int rep = 0; rep < 2; ++rep) {
      const int i = threadIdx.x + rep * 2 * DH;
      const int t = i / kPieces;
      const int c = i % kPieces;
      const bool ok = base + t < seq;
      const __nv_bfloat16* src =
          in.p[arr] + (ok ? row0 + (base + t) * t_stride + 8 * c : 0);
      cp_async16(smem_u32(&sm.ring[slot][arr][t][8 * c]), src, ok);
    }
  cp_async_commit();
}

// 8 bf16 from shared memory (16-byte aligned) as f32
__device__ __forceinline__ void row8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(x[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float clip_decay(float w) {
  return fminf(fmaxf(w, 1e-8f), 1.f);
}

// A[t, s] of both chunks of the stage over producer warp w's channels
// [16 w, 16 w + 16), in 8-token halves of each chunk.
// - Keys and queries in one half, directly: lane l works in chunk l / 16,
//   half (l / 8) % 2, on 8 of the channels (l % 2) for two keys of the
//   half, s0 = (l / 2) % 4 and s1 = 7 - s0 (an even share of the t > s
//   work), carrying q_s = k_s ⊙ P(s+1, t-1) as t advances: a row of r
//   and w read serves two keys.  One shuffle a token completes both
//   keys' sums over the warp's 16 channels (each lane of a pair finishes
//   one key).  The entry (t > s), the bonus r_s · (u ⊙ k_s) (t = s) or 0
//   (t < s) goes to the warp's f32 part of A.
// - Queries of the second half against keys of the first, on the tensor
//   cores: (r_t ⊙ P(c0 + 8, t-1)) · (k_s ⊙ P(s+1, c0 + 7)), both factors
//   <= 1, one m16n8k16 k-step (the warp's 16 channels) for both chunks'
//   8 x 8 blocks (the two off-diagonal 8 x 8 blocks of the product mix
//   the chunks and are dropped).
// w is clipped here; a token past S is a query row nobody reads and
// never a factor of a real one, so its zero-filled w needs no care.
template <int DH>
__device__ __forceinline__ void pair_weights(ChunkSmem<DH>& sm, int slot,
                                             float (&ap)[kChunk][kChunk],
                                             int j0, int warp, int lane) {
  const int j = lane >> 4;
  const int hb = 8 * ((lane >> 3) & 1);     // first token of the half
  const int half = lane & 1;
  const int s0 = hb + ((lane >> 1) & 3);
  const int s1 = 2 * hb + 7 - s0;
  const int tj = j * kChunk;
  const int d0 = 16 * warp + 8 * half;
  float q0[8], q1[8], r0[8], r1[8];
  row8(&sm.ring[slot][1][tj + s0][d0], q0);
  row8(&sm.ring[slot][1][tj + s1][d0], q1);
  row8(&sm.ring[slot][0][tj + s0][d0], r0);
  row8(&sm.ring[slot][0][tj + s1][d0], r1);
  float b0 = 0.f, b1 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    b0 = fmaf(r0[i] * sm.u[d0 + i], q0[i], b0);
    b1 = fmaf(r1[i] * sm.u[d0 + i], q1[i], b1);
  }
  // lane half 0 finishes key s0, half 1 key s1
  const int s = half ? s1 : s0;
  const float bonus = (half ? b1 : b0)
      + __shfl_xor_sync(0xffffffffu, half ? b0 : b1, 1);
  float res[8];                             // stored after the loop
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = hb + i;
    float rt[8], wt[8];
    row8(&sm.ring[slot][0][tj + t][d0], rt);
    row8(&sm.ring[slot][3][tj + t][d0], wt);
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float wc = clip_decay(wt[c]);
      if (t > s0) {
        p0 = fmaf(rt[c], q0[c], p0);
        q0[c] *= wc;
      }
      if (t > s1) {
        p1 = fmaf(rt[c], q1[c], p1);
        q1[c] *= wc;
      }
    }
    const float sum = (half ? p1 : p0)
        + __shfl_xor_sync(0xffffffffu, half ? p0 : p1, 1);
    res[i] = t > s ? sum : (t == s ? bonus : 0.f);
  }
  float* out = &ap[0][s] + j * j0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[(hb + i) * kChunk] = res[i];
    if (hb) out[i * kChunk] = 0.f;          // queries before the key's half
  }

  // the second halves' queries against the first halves' keys
  const int g = lane >> 2, q4 = lane & 3;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  const int krow = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int kcol = ((lane >> 3) & 1) * 8;
  uint32_t ah[4], al[4], bh[4], bl[4];
  ldsm_x4(ah, &sm.q8[0][lrow][16 * warp + lcol]);
  ldsm_x4(al, &sm.q8[1][lrow][16 * warp + lcol]);
  ldsm_x4(bh, &sm.k8[0][krow][16 * warp + kcol]);
  ldsm_x4(bl, &sm.k8[1][krow][16 * warp + kcol]);
  float c0[4] = {}, c1[4] = {};   // chunk 0: rows 0-7 x keys 0-7 of c0
  mma16816(c0, ah, bh[0], bh[1]);   // chunk 1: rows 8-15 x keys 8-15 of c1
  mma16816(c0, ah, bl[0], bl[1]);
  mma16816(c0, al, bh[0], bh[1]);
  mma16816(c1, ah, bh[2], bh[3]);
  mma16816(c1, ah, bl[2], bl[3]);
  mma16816(c1, al, bh[2], bh[3]);
  *reinterpret_cast<float2*>(&ap[8 + g][2 * q4]) = make_float2(c0[0], c0[1]);
  *reinterpret_cast<float2*>(&ap[8 + g][2 * q4] + j0) =
      make_float2(c1[2], c1[3]);
}

// Producers, 2·DH threads (warps [0, DH / 16)): per stage, the copies of
// the next stage, then into the stage's slot (once the consumers have
// emptied it): thread (chunk j, channel d) forms the running products,
// r ⊙ P and k ⊙ P split into bf16 hi / lo, P(c0, c1) and a copy of v;
// the warps form A's parts, summed and split into the slot.
template <int DH>
__device__ __forceinline__ void produce(ChunkSmem<DH>& sm, const Inputs& in,
                                        int64_t row0, int64_t t_stride,
                                        int seq, int n_stages) {
  constexpr int kP = 2 * DH;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  load_stage<DH>(sm, 0, in, row0, t_stride, 0, seq);
  for (int stage = 0; stage < n_stages; ++stage) {
    const int rs = stage & 1;
    const int base = stage * kStage;
    cp_async_wait_all();
    bar_sync(kBarProducers, kP);   // stage landed; last stage's reads done
    if (stage + 1 < n_stages)
      load_stage<DH>(sm, rs ^ 1, in, row0, t_stride, base + kStage, seq);
    if (stage >= 2) bar_sync(kBarEmpty + rs, 4 * DH);
    typename ChunkSmem<DH>::Slot& o = sm.slot[rs];
    {   // running products: thread (direction, chunk j, channels d, d+1)
      const int dir = tid / DH;                // 0: r ⊙ P(c0, t-1), 1: k ⊙ P
      const int j = (tid % DH) / (DH / 2);
      const int d = 2 * (tid % (DH / 2));
      const int t0 = j * kChunk;
      // every load of the 16 tokens first, then the products and stores
      // (no store between two tokens' loads: the compiler cannot tell the
      // slot from the ring)
      uint32_t wr[kChunk], xr[kChunk], vr[kChunk];
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        const int t = dir ? t0 + kChunk - 1 - n : t0 + n;
        wr[n] = *reinterpret_cast<const uint32_t*>(&sm.ring[rs][3][t][d]);
        xr[n] = *reinterpret_cast<const uint32_t*>(
            &sm.ring[rs][dir ? 1 : 0][t][d]);
        vr[n] = dir ? 0u
                    : *reinterpret_cast<const uint32_t*>(&sm.ring[rs][2][t][d]);
      }
      __nv_bfloat16 (*dst)[kStage][ChunkSmem<DH>::kPitch] = dir ? o.kp : o.rp;
      // the second half of the stream restarts at the chunk's middle
      __nv_bfloat16 (*dst8)[kChunks * 8][ChunkSmem<DH>::kPitch] =
          dir ? sm.k8 : sm.q8;
      float2 p = make_float2(1.f, 1.f), p8 = make_float2(1.f, 1.f);
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        const int t = dir ? t0 + kChunk - 1 - n : t0 + n;
        const float2 w2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&wr[n]));
        const bool in = base + t < seq;
        const float wx = in ? clip_decay(w2.x) : 1.f;
        const float wy = in ? clip_decay(w2.y) : 1.f;
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xr[n]));
        uint32_t hi, lo;
        split2(x.x * p.x, x.y * p.y, hi, lo);
        *reinterpret_cast<uint32_t*>(&dst[0][t][d]) = hi;
        *reinterpret_cast<uint32_t*>(&dst[1][t][d]) = lo;
        if (n >= 8) {   // t in the second half (forward), first (backward)
          const int row = 8 * j + n - 8;
          split2(x.x * p8.x, x.y * p8.y, hi, lo);
          *reinterpret_cast<uint32_t*>(&dst8[0][dir ? 15 - n + 8 * j : row][d])
              = hi;
          *reinterpret_cast<uint32_t*>(&dst8[1][dir ? 15 - n + 8 * j : row][d])
              = lo;
          p8.x *= wx;
          p8.y *= wy;
        }
        if (!dir) *reinterpret_cast<uint32_t*>(&o.v[t][d]) = vr[n];
        p.x *= wx;
        p.y *= wy;
      }
      if (!dir) *reinterpret_cast<float2*>(&o.ptot[j][d]) = p;
    }
    bar_sync(kBarProducers, kP);
    pair_weights<DH>(sm, rs, o.a[warp][0], kChunk * kChunk, warp, lane);
    bar_arrive(kBarFull + rs, 4 * DH);
  }
}

template <int DH>
__global__ void __launch_bounds__(4 * DH, 2)
wkv6_chunked_kernel(Inputs in,                        // (B, S, H, Dh) each
                    const __nv_bfloat16* __restrict__ u,   // (H, Dh)
                    const float* s0,                  // (B, H, Dh, Dh) or null
                    __nv_bfloat16* __restrict__ y,    // (B, S, H, Dh)
                    float* s_out,                     // may alias s0
                    int seq, int n_heads) {
  constexpr int kTiles = DH / 8;              // 8-wide d tiles of Sᵀ rows
  static_assert(DH % 16 == 0 && DH <= 64, "Dh 16, 32 or 64");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<DH>& sm = *reinterpret_cast<ChunkSmem<DH>*>(smem_raw);

  const int bh = blockIdx.x;                  // b · H + h
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int tid = threadIdx.x;
  const int64_t t_stride = static_cast<int64_t>(n_heads) * DH;
  const int64_t row0 = (static_cast<int64_t>(b) * seq * n_heads + h) * DH;
  const int n_stages = (seq + kStage - 1) / kStage;
  if (tid < DH) sm.u[tid] = __bfloat162float(u[h * DH + tid]);
  __syncthreads();
  if (tid < 2 * DH) {
    produce<DH>(sm, in, row0, t_stride, seq, n_stages);
    return;
  }

  // consumers, warps [DH / 16, DH / 8): warp w owns rows e of Sᵀ in
  // [16 w', 16 w' + 16), w' = w - DH / 16
  const int lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int e0 = 16 * ((tid - 2 * DH) >> 5);
  const int64_t soff = static_cast<int64_t>(bh) * DH * DH;

  // st[dt][i] = Sᵀ[e0 + g + 8 (i / 2)][8 dt + 2 q4 + i % 2] = S[d][e]
  float st[kTiles][4];
#pragma unroll
  for (int dt = 0; dt < kTiles; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + g + 8 * (i >> 1);
      const int d = 8 * dt + 2 * q4 + (i & 1);
      st[dt][i] = s0 != nullptr ? s0[soff + static_cast<int64_t>(d) * DH + e]
                                : 0.f;
    }

  // ldmatrix addressing of this lane (see ldsm_x4)
  const int lrow = lane & 15;
  const int lcol = (lane >> 4) * 8;
  const int vrow = (lane & 7) + (lane >> 4) * 8;   // Vᵀ as A (.trans)
  const int vcol = ((lane >> 3) & 1) * 8;

  for (int stage = 0; stage < n_stages; ++stage) {
    const int rs = stage & 1;
    const int base = stage * kStage;
    bar_sync(kBarFull + rs, 4 * DH);
    const typename ChunkSmem<DH>::Slot& o = sm.slot[rs];
#pragma unroll 1
    for (int j = 0; j < kChunks && base + j * kChunk < seq; ++j) {
      const int tj = j * kChunk;
      uint32_t shi[kTiles][2], slo[kTiles][2];
#pragma unroll
      for (int dt = 0; dt < kTiles; ++dt) {
        split2(st[dt][0], st[dt][1], shi[dt][0], slo[dt][0]);
        split2(st[dt][2], st[dt][3], shi[dt][1], slo[dt][1]);
      }
      // two accumulators a column tile (hi·hi apart), for shorter chains
      float acc[2][4] = {}, acc2[2][4] = {};
      // inter-chunk: y += (r ⊙ P) · S_in, B = S read from the Sᵀ fragments
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t ah[4], al[4];
        ldsm_x4(ah, &o.rp[0][tj + lrow][16 * kk + lcol]);
        ldsm_x4(al, &o.rp[1][tj + lrow][16 * kk + lcol]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma16816(acc[nt], ah, shi[2 * kk][nt], shi[2 * kk + 1][nt]);
          mma16816(acc2[nt], ah, slo[2 * kk][nt], slo[2 * kk + 1][nt]);
          mma16816(acc2[nt], al, shi[2 * kk][nt], shi[2 * kk + 1][nt]);
        }
      }
      {   // intra-chunk: y += A · V, A the producer warps' parts summed
        uint32_t ah[4], al[4], vb[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {   // rows g, g + 8; columns +0, +8
          const int t = g + 8 * (f & 1);
          const int s = 2 * q4 + 8 * (f >> 1);
          float2 x = make_float2(0.f, 0.f);
#pragma unroll
          for (int w = 0; w < DH / 16; ++w) {
            const float2 pw = *reinterpret_cast<const float2*>(&o.a[w][j][t][s]);
            x.x += pw.x;
            x.y += pw.y;
          }
          split2(x.x, x.y, ah[f], al[f]);
        }
        ldsm_x4_t(vb, &o.v[tj + lrow][e0 + lcol]);
        mma16816(acc[0], ah, vb[0], vb[1]);
        mma16816(acc2[0], al, vb[0], vb[1]);
        mma16816(acc[1], ah, vb[2], vb[3]);
        mma16816(acc2[1], al, vb[2], vb[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int tok = base + tj + g + 8 * half;
          if (tok < seq)
            *reinterpret_cast<__nv_bfloat162*>(
                y + row0 + tok * t_stride + e0 + 8 * nt + 2 * q4) =
                __floats2bfloat162_rn(
                    acc[nt][2 * half] + acc2[nt][2 * half],
                    acc[nt][2 * half + 1] + acc2[nt][2 * half + 1]);
        }
      // state: Sᵀ = Sᵀ diag(P(c0, c1)) + Vᵀ · K'
#pragma unroll
      for (int dt = 0; dt < kTiles; ++dt) {
        const float2 p =
            *reinterpret_cast<const float2*>(&o.ptot[j][8 * dt + 2 * q4]);
        st[dt][0] *= p.x;
        st[dt][1] *= p.y;
        st[dt][2] *= p.x;
        st[dt][3] *= p.y;
      }
      uint32_t va[4];
      ldsm_x4_t(va, &o.v[tj + vrow][e0 + vcol]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t kh[4], kl[4];
        ldsm_x4_t(kh, &o.kp[0][tj + lrow][16 * dp + lcol]);
        ldsm_x4_t(kl, &o.kp[1][tj + lrow][16 * dp + lcol]);
        mma16816(st[2 * dp], va, kh[0], kh[1]);
        mma16816(st[2 * dp], va, kl[0], kl[1]);
        mma16816(st[2 * dp + 1], va, kh[2], kh[3]);
        mma16816(st[2 * dp + 1], va, kl[2], kl[3]);
      }
    }
    if (stage + 2 < n_stages) bar_arrive(kBarEmpty + rs, 4 * DH);
  }

#pragma unroll
  for (int dt = 0; dt < kTiles; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + g + 8 * (i >> 1);
      const int d = 8 * dt + 2 * q4 + (i & 1);
      s_out[soff + static_cast<int64_t>(d) * DH + e] = st[dt][i];
    }
}

template <int DH>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const float* s0, void* y,
                   float* s_out, int batch, int seq, int n_heads,
                   cudaStream_t stream) {
  auto kernel = wkv6_chunked_kernel<DH>;
  const size_t smem = sizeof(ChunkSmem<DH>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Inputs in = {{static_cast<const __nv_bfloat16*>(r),
                      static_cast<const __nv_bfloat16*>(k),
                      static_cast<const __nv_bfloat16*>(v),
                      static_cast<const __nv_bfloat16*>(w)}};
  kernel<<<batch * n_heads, 4 * DH, smem, stream>>>(
      in, static_cast<const __nv_bfloat16*>(u), s0,
      static_cast<__nv_bfloat16*>(y), s_out, seq, n_heads);
  return static_cast<int>(cudaGetLastError());
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

// The chunked kernel (bf16, S >= 16): d_head must be 16, 32 or 64.
// Same arguments and result as wkv6_launch.
int wkv6_chunked_launch(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* y, void* s_out, int batch, int seq,
                        int n_heads, int d_head, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0f = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  if (batch < 1 || seq < 1 || n_heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d_head) {
    case 16: return launch_chunked<16>(r, k, v, w, u, s0f, y, so, batch,
                                       seq, n_heads, s);
    case 32: return launch_chunked<32>(r, k, v, w, u, s0f, y, so, batch,
                                       seq, n_heads, s);
    case 64: return launch_chunked<64>(r, k, v, w, u, s0f, y, so, batch,
                                       seq, n_heads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of dynamic shared memory a block of the chunked kernel uses (0:
// it does not take this d_head).
size_t wkv6_chunked_smem_bytes(int d_head) {
  switch (d_head) {
    case 16: return sizeof(ChunkSmem<16>);
    case 32: return sizeof(ChunkSmem<32>);
    case 64: return sizeof(ChunkSmem<64>);
    default: return 0;
  }
}

}  // extern "C"
