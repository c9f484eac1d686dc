// Mamba-1 selective scan (diagonal SSM) for sm_90a, its state split over
// lanes.
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
// What bounds it on the H100: four limits of about the same size.  At the
// jamba prefill (2, 1024, 8192, 16) in f32 the call must move 201 MB
// (0.061 ms at 3.35 TB/s); its 268 M exps take 0.064 ms on the SFUs (16
// a clock an SM at 1.98 GHz); every (token, channel) needs all N values
// of B_t and C_t delivered to some lane, 128 bytes, one shared-memory
// wavefront, 0.064 ms of them; and its ~60 instructions a lane and token
// take ~0.06 ms to issue.  The design keeps each of them near its floor;
// they overlap only in part.
//
// Design: a channel's N state entries are split over L adjacent lanes of
// a warp, P = N / L entries (and P entries of its row of A) a lane in
// registers for the whole sequence: P = 8, L = 2 at N = 16 (8 at N = 8,
// 4 at N = 4).  A block takes 64 channels of one row (64·L lanes).  Per
// token a lane does P × (ex2, two FMAs) on its entries and y_t's sum over
// N is finished with log2 L __shfl_xor_sync steps.  A is pre-scaled by
// log2(e) once, so exp(dt·A) is one ex2.approx (the SFU op) and one
// multiply.  (Measured on the H100 at the jamba prefill: 4 lanes a
// channel moved more shared-memory bytes for the same exps, 1 lane a
// channel left too few warps to hide the SFU's latency.)
// - Everything a block reads streams through shared memory in stages of
//   64 tokens, double-buffered: u and dt of its 64 channels and B and C
//   of the row arrive by 16-byte cp.async copies issued a stage ahead
//   (plain copies where a row is not 16-byte aligned: odd Ci, N = 4 in
//   bf16).  A lane reads its P entries of B_t and C_t as 16-byte (f32)
//   or 8-byte (bf16) loads; the lanes of a channel read one u_t and dt_t.
// - y_t goes to shared memory (lane t % L of the channel writes it,
//   8 tokens at a time after their arithmetic) and the stage's (64, 64)
//   tile goes out as 16-byte rows after a barrier: one scattered 4-byte
//   store a token and channel cost more than the arithmetic.
// - Start and last state, and A, move as 16-byte vectors, coalesced
//   across the lanes of a channel (when 16-byte aligned; else by
//   scalars).
// - A decode step (S = 1) reads its one token straight from global
//   memory instead: every load in flight at once, no barrier.
// Channels past Ci and tokens past S compute on zeros (u = dt = 0 leaves
// h unchanged) and store nothing, so every lane meets the shuffles and
// barriers; S >= 1 needs no padding.
//
// In-place state: h0 and h_out may be the same buffer (the wrapper
// passes one pointer for both when a state is given).  That is safe
// because a lane reads its own 4 entries of h0 once, before its first
// step, and writes only those entries of h_out, after its last step.
// h0 and h_out are therefore not restrict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 64;         // channels a block
// state entries a lane: 8 (two lanes a channel at N = 16), 4 at N = 4
__host__ __device__ constexpr int per_lane(int n) {
  return n >= 8 ? 8 : 4;
}
constexpr int kStage = 64;      // tokens a stage
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 reads nothing and zero-fills the 16 bytes
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 4 consecutive floats, as one 16-byte access when ``vec``
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ void store4(float* p, float4 x, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = x;
  } else {
    p[0] = x.x;
    p[1] = x.y;
    p[2] = x.z;
    p[3] = x.w;
  }
}

// This lane's 4 entries of B_t or C_t from shared memory, as f32.
__device__ __forceinline__ float4 entries(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 entries(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 4 consecutive entries of B_t or C_t from global memory, as f32: one
// 16-byte (f32) or 8-byte (bf16) load when ``vec``
__device__ __forceinline__ float4 entries_global(const float* p, bool vec) {
  return load4(p, vec);
}
__device__ __forceinline__ float4 entries_global(const __nv_bfloat16* p,
                                                 bool vec) {
  if (vec) return entries(p);
  return make_float4(__bfloat162float(p[0]), __bfloat162float(p[1]),
                     __bfloat162float(p[2]), __bfloat162float(p[3]));
}

template <typename T, int N>
struct __align__(16) ScanSmem {
  T u[2][kStage][kCh];
  T dt[2][kStage][kCh];
  T b[2][kStage][N];
  T c[2][kStage][N];
  T y[kStage][kCh];
};

// Copy `rows` rows of `cols` elements (row r at src + r·stride, columns
// past `cols_ok` and rows past `rows_ok` zero) into dst[rows][cols]:
// 16-byte cp.async pieces when `vec`, else plain element copies.
template <typename T, int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           int64_t stride, int rows_ok,
                                           int cols_ok, bool vec) {
  constexpr int kPiece = 16 / sizeof(T);
  if constexpr (COLS % kPiece == 0) {
    if (vec) {
      constexpr int kPieces = ROWS * COLS / kPiece;
      for (int i = threadIdx.x; i < kPieces; i += NT) {
        const int r = i / (COLS / kPiece);
        const int col = (i % (COLS / kPiece)) * kPiece;
        const bool ok = r < rows_ok && col < cols_ok;
        cp_async16(dst + r * COLS + col, ok ? src + r * stride + col : src,
                   ok);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
    const int r = i / COLS, col = i % COLS;
    dst[i] = r < rows_ok && col < cols_ok ? src[r * stride + col]
                                          : from_f32<T>(0.f);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kCh * N / per_lane(N))
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
  constexpr int P = per_lane(N);                 // entries a lane
  constexpr int L = N / P;                       // lanes a channel
  constexpr int NT = kCh * L;                    // lanes a block
  static_assert(N % P == 0 && 32 % L == 0 && 8 % L == 0,
                "N = 4, 8 or 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem<T, N>& sm = *reinterpret_cast<ScanSmem<T, N>*>(smem_raw);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCh;               // block's first channel
  const int cl = threadIdx.x / L;                // channel in the block
  const int c = c0 + cl;
  const int part = threadIdx.x % L;              // entries P·part .. +P-1
  const bool live = c < ci;
  const int cols_ok = ci - c0;

  const int64_t h_off = (static_cast<int64_t>(b) * ci + c) * N + P * part;
  const int64_t a_off = static_cast<int64_t>(c) * N + P * part;
  const bool h_vec = (reinterpret_cast<uintptr_t>(h0) |
                      reinterpret_cast<uintptr_t>(h_out)) % 16 == 0;
  const bool a_vec = reinterpret_cast<uintptr_t>(A) % 16 == 0;
  float a2[P], h[P];
#pragma unroll
  for (int g = 0; g < P / 4; ++g) {
    const float4 av = live ? load4(A + a_off + 4 * g, a_vec)
                           : make_float4(0, 0, 0, 0);
    const float4 hv = live && h0 != nullptr ? load4(h0 + h_off + 4 * g, h_vec)
                                            : make_float4(0, 0, 0, 0);
    a2[4 * g] = av.x * kLog2e; a2[4 * g + 1] = av.y * kLog2e;
    a2[4 * g + 2] = av.z * kLog2e; a2[4 * g + 3] = av.w * kLog2e;
    h[4 * g] = hv.x; h[4 * g + 1] = hv.y;
    h[4 * g + 2] = hv.z; h[4 * g + 3] = hv.w;
  }
  const float d = live ? D[c] : 0.f;

  const int64_t tok0 = static_cast<int64_t>(b) * seq;   // row's token 0
  const T* u_r = u + tok0 * ci + c0;
  const T* dt_r = dt + tok0 * ci + c0;
  T* y_r = y + tok0 * ci + c0;
  const T* b_r = bmat + tok0 * N;
  const T* c_r = cmat + tok0 * N;
  // 16-byte pieces where every row of the slab starts 16-byte aligned
  const bool uv = (static_cast<int64_t>(ci) * sizeof(T)) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(dt)
        | reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const bool bv = (N * sizeof(T)) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(bmat) |
        reinterpret_cast<uintptr_t>(cmat)) % 16) == 0;

  if (seq == 1) {
    // a decode step: one token, read straight from global memory (every
    // load in flight at once), no staging and no barrier
    const bool ev = ((reinterpret_cast<uintptr_t>(bmat) |
                      reinterpret_cast<uintptr_t>(cmat)) % 16) == 0;
    const float ut = live ? to_f32(u[tok0 * ci + c]) : 0.f;
    const float dtt = live ? to_f32(dt[tok0 * ci + c]) : 0.f;
    float4 bt[P / 4], ct[P / 4];
#pragma unroll
    for (int g = 0; g < P / 4; ++g) {
      bt[g] = entries_global(b_r + P * part + 4 * g, ev);
      ct[g] = entries_global(c_r + P * part + 4 * g, ev);
    }
    const float dtu = dtt * ut;
    float acc = 0.f, acc2 = 0.f;
#pragma unroll
    for (int g = 0; g < P / 4; ++g) {
      float* hg = h + 4 * g;
      const float* ag = a2 + 4 * g;
      hg[0] = fmaf(ex2(dtt * ag[0]), hg[0], dtu * bt[g].x);
      hg[1] = fmaf(ex2(dtt * ag[1]), hg[1], dtu * bt[g].y);
      hg[2] = fmaf(ex2(dtt * ag[2]), hg[2], dtu * bt[g].z);
      hg[3] = fmaf(ex2(dtt * ag[3]), hg[3], dtu * bt[g].w);
      acc = fmaf(hg[0], ct[g].x, acc);
      acc2 = fmaf(hg[1], ct[g].y, acc2);
      acc = fmaf(hg[2], ct[g].z, acc);
      acc2 = fmaf(hg[3], ct[g].w, acc2);
    }
    acc += acc2;
#pragma unroll
    for (int off = 1; off < L; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && part == 0) y[tok0 * ci + c] = from_f32<T>(fmaf(d, ut, acc));
  } else {
    const int n_stages = (seq + kStage - 1) / kStage;
    auto issue = [&](int stage, int buf) {
      const int t0 = stage * kStage;
      const int rows = min(kStage, seq - t0);
      const int64_t o = static_cast<int64_t>(t0);
      stage_rows<T, kStage, kCh, NT>(&sm.u[buf][0][0], u_r + o * ci, ci, rows,
                                     cols_ok, uv);
      stage_rows<T, kStage, kCh, NT>(&sm.dt[buf][0][0], dt_r + o * ci, ci,
                                     rows, cols_ok, uv);
      stage_rows<T, kStage, N, NT>(&sm.b[buf][0][0], b_r + o * N, N, rows, N,
                                   bv);
      stage_rows<T, kStage, N, NT>(&sm.c[buf][0][0], c_r + o * N, N, rows, N,
                                   bv);
      cp_async_commit();
    };

    issue(0, 0);
    for (int stage = 0; stage < n_stages; ++stage) {
      const int buf = stage & 1;
      const int t0 = stage * kStage;
      cp_async_wait_all();
      __syncthreads();   // stage landed; the last stage's reads of y and of
                         // the other buffer are done
      if (stage + 1 < n_stages) issue(stage + 1, buf ^ 1);
      // 8 tokens at a time (a token past the stage's rows is skipped, so a
      // decode step computes one); their y stay in registers until all 8
      // are done, so no shared-memory store sits between one token's loads
      // and the next (the compiler cannot tell the y tile from the inputs)
      const int rows = min(kStage, seq - t0);
      for (int tb = 0; tb < rows; tb += 8) {
        float yv[8] = {};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = tb + k;
          if (t >= rows) break;                    // the same for every lane
          const float ut = to_f32(sm.u[buf][t][cl]);
          const float dtt = to_f32(sm.dt[buf][t][cl]);
          const float dtu = dtt * ut;
          float acc = 0.f, acc2 = 0.f;
#pragma unroll
          for (int g = 0; g < P / 4; ++g) {
            const float4 bt = entries(&sm.b[buf][t][P * part + 4 * g]);
            const float4 ct = entries(&sm.c[buf][t][P * part + 4 * g]);
            float* hg = h + 4 * g;
            const float* ag = a2 + 4 * g;
            hg[0] = fmaf(ex2(dtt * ag[0]), hg[0], dtu * bt.x);
            hg[1] = fmaf(ex2(dtt * ag[1]), hg[1], dtu * bt.y);
            hg[2] = fmaf(ex2(dtt * ag[2]), hg[2], dtu * bt.z);
            hg[3] = fmaf(ex2(dtt * ag[3]), hg[3], dtu * bt.w);
            acc = fmaf(hg[0], ct.x, acc);
            acc2 = fmaf(hg[1], ct.y, acc2);
            acc = fmaf(hg[2], ct.z, acc);
            acc2 = fmaf(hg[3], ct.w, acc2);
          }
          acc += acc2;
#pragma unroll
          for (int off = 1; off < L; off <<= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
          yv[k] = fmaf(d, ut, acc);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (part == k % L && tb + k < rows)
            sm.y[tb + k][cl] = from_f32<T>(yv[k]);
      }
      __syncthreads();   // the stage's y tile is complete
      if (uv) {
        constexpr int kPiece = 16 / sizeof(T);
        for (int i = threadIdx.x; i < kStage * kCh / kPiece; i += NT) {
          const int r = i / (kCh / kPiece);
          const int col = (i % (kCh / kPiece)) * kPiece;
          if (r < rows && col < cols_ok)
            *reinterpret_cast<uint4*>(y_r + (t0 + r) * static_cast<int64_t>(ci)
                                      + col) =
                *reinterpret_cast<const uint4*>(&sm.y[r][col]);
        }
      } else {
        for (int i = threadIdx.x; i < kStage * kCh; i += NT) {
          const int r = i / kCh, col = i % kCh;
          if (r < rows && col < cols_ok)
            y_r[(t0 + r) * static_cast<int64_t>(ci) + col] = sm.y[r][col];
        }
      }
    }

  }

  if (live) {
#pragma unroll
    for (int g = 0; g < P / 4; ++g)
      store4(h_out + h_off + 4 * g,
             make_float4(h[4 * g], h[4 * g + 1], h[4 * g + 2], h[4 * g + 3]),
             h_vec);
  }
}

template <typename T, int N>
int launch(const void* u, const void* dt, const float* A, const void* bmat,
           const void* cmat, const float* D, const float* h0, void* y,
           float* h_out, int batch, int seq, int ci, cudaStream_t stream) {
  auto kernel = mamba_scan_kernel<T, N>;
  const size_t smem = sizeof(ScanSmem<T, N>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ci + kCh - 1) / kCh, batch);
  kernel<<<grid, kCh * N / per_lane(N), smem, stream>>>(
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

// Bytes of dynamic shared memory a block uses (0: the kernel does not take
// this dtype or d_state).  dtype: 0 = float32, 1 = bfloat16.
size_t mamba_scan_smem_bytes(int dtype, int d_state) {
  switch (d_state * 2 + dtype) {
    case 8: return sizeof(ScanSmem<float, 4>);
    case 9: return sizeof(ScanSmem<__nv_bfloat16, 4>);
    case 16: return sizeof(ScanSmem<float, 8>);
    case 17: return sizeof(ScanSmem<__nv_bfloat16, 8>);
    case 32: return sizeof(ScanSmem<float, 16>);
    case 33: return sizeof(ScanSmem<__nv_bfloat16, 16>);
    default: return 0;
  }
}

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
