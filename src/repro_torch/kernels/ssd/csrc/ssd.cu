// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py::_kernel (entry
// ssd_pallas).  For one (batch b, head h) and each chunk of Q positions, with
// cum the inclusive prefix sum of dt * A over the chunk:
//
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//         + exp(cum_i) C_i . S                                          (inter)
//   S'    = exp(cum_Q) S + sum_j exp(cum_Q - cum_j) dt_j B_j^T x_j      (carry)
//
// with x (Q, P), B and C (Q, N) of head h's B/C group h / (H / G) (Mamba-2
// has one group shared by every head, Zamba2-7B two, each shared by 56
// heads), and the state S (N, P) in float32, zero at the first chunk.  The final S is written out:
// the serving path needs it for decode (the Pallas kernel drops it).  The mask
// comes before the exponential: above the diagonal exp(cum_i - cum_j)
// overflows, and inf * 0 would give NaN.  Two instances; the wrapper
// (ops.py::select_instance) picks one from dtype, shape and layout.
//
// Bound.  At Mamba-2's serving shape (B 4, L 1024, H 64, P 64, N 128, Q 256,
// bf16) the function moves 78.6 MB (x and y 33.5 MB each, B, C, dt, the final
// state): 0.0235 ms at 3.35 TB/s; its work, 13.0 GFLOP, takes 0.013 ms at the
// bf16 tensor-core rate.  Zamba2's (N 64): 73.4 MB, 0.0219 ms.  Bound by
// bytes.  Zamba2-7B's cell at its largest (B 8, L 4096, H 112, N 64, G 2):
// 986 MB, 0.294 ms, against 0.185 ms of products.
//
// 1. ssd_tc: bf16 on the tensor cores (P 64, N 64 or 128, Q a multiple of 64
//    up to 256): the three passes of the Mamba-2 SSD algorithm, three kernels
//    launched by one call.  Each CTA has consumer warpgroups that multiply
//    with wgmma m64n64k16 (f32 accumulators) and a producer warp that feeds
//    them with bulk tensor copies (TMA, 128-byte swizzle) on mbarriers; x, B
//    and C are read MN- or K-major as they lie, through wgmma's transpose
//    bits.
//    a. chunk states (states_kernel), CTA (4 heads, chunk, batch): cum and dt
//       per chunk written out (B, H, nc, Q); dS_c = B_c^T (w x_c), w_j =
//       exp(total - cum_j) dt_j, written as (B, nc, H, N, P) float32.
//    b. state passing (pass_kernel), CTA (head, batch): S carried in float32
//       registers over the chunks, S_c = exp(total_{c-1}) S_{c-1} + dS_{c-1};
//       the entering state, as bf16 hi + lo in shared memory, times the
//       chunk's C gives exp(cum_i) C S_c, written (B, nc - 1, H, Q, P) float32 in
//       the chunk scan's accumulator order; the final state.  S itself never
//       goes to device memory but as the final state.
//    c. chunk scan (scan_kernel), CTA (8 heads, chunk and 64-row tile I,
//       batch), 4 x 16 x 8 = 512 CTAs at the serving shape: C_I B_J^T formed
//       once for the CTA's heads (one B/C group: a CTA's heads, 4 in pass a
//       and 8 here, are taken from one group, so they divide H / G); the
//       diagonal tile's decayed
//       scores in registers, the tiles below it as exp(cum_i - cum_e)
//       (C_I B_<I^T)(g x_<I), g_j = exp(cum_e - cum_j) dt_j, e the row
//       before the tile, every factor at most 1; plus pass b's state term.
//    Bytes at Mamba-2's shape, beyond the function's 78.6 MB: dS written and
//    read (33.5 MB each), the state term written and read (50.3 MB each: the
//    first chunk has none), cum and dt (1 MB each, written and read), B and
//    C re-read from L2 by every head group, and x tiles below the diagonal
//    re-read by the later row tiles, from L2 where it holds them.
//    Numerics: products of bf16 inputs (C B^T, the products with x) are
//    exact in their float32 accumulators.  Each float32 operand of a bf16
//    product is rounded: w x (pass a) and g x (pass c) to one bf16 (8
//    significant bits), a relative error of at most 2^-8 per term, of
//    random sign, in sums that the decay keeps to a few terms of |w x| <=
//    dt |x| (dt <= 0.2), far under SSD_TOL bf16 8e-2 on the state and on
//    y; the diagonal scores, C B^T below the diagonal and the entering
//    state to bf16 hi + lo (about 2^-16 relative: their terms are large,
//    |C.B| up to about 40 and |y| up to about 35).  y itself is rounded to
//    bf16 (half an ulp: 0.125 at |y| of 32-64), as in the Pallas kernel's
//    bf16 output.  The state carry is float32 throughout.  Since SSD_TOL
//    is coarse beside these errors, the card's checks also hold this path
//    against ref.ssd_passes(round_operands=True), which rounds each of
//    these operands as it does, at 4 bf16 ulps of each row's scale and at
//    1.25 times the norm of that version's own rounding to bf16
//    (kernels/instances.py).
//
// 2. ssd: the float32-arithmetic instance on the CUDA cores, for float32
//    (whose tolerance, 1e-4, is below what bf16 operands give) and the bf16
//    shapes the first does not take.  One CTA of 256 threads owns one (b, h)
//    and loops over the chunks with S in shared memory; each chunk is cut into
//    64-row tiles: for row tile I the CTA stages C_I, and for every column
//    tile J <= I it stages B_J and x_J, forms the 64 x 64 masked score tile in
//    shared memory and adds scores @ x_J into registers.  The last row tile
//    visits every column tile, so the state update rides on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace ssd {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows and columns of a score tile
constexpr int kLd = kTile + 4;     // leading dimension of the transposed tiles
constexpr int kMaxQ = 256, kMaxN = 128, kMaxP = 64;

struct Args {
  const void* x;       // (B, L, H, P), strides x_sb, x_sl, P, 1
  const float* dt;     // (B, L, H), strides dt_sb, dt_sl, 1
  const float* A;      // (H,)
  const void* Bm;      // (B, L, G, N), strides b_sb, b_sl, b_sg, 1
  const void* Cm;      // (B, L, G, N), strides c_sb, c_sl, c_sg, 1
  void* y;             // (B, L, H, P) contiguous
  float* state;        // (B, H, N, P) contiguous
  int L, H, P, N, Q;
  int hpg;             // heads per B/C group, H / G
  long long x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, c_sb, c_sl, b_sg, c_sg;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Rows [r0, r0 + kTile) of a (Q, K) operand, transposed into dst[k * kLd + r];
// rows past Q are zeros.
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, const T* src, long long sl,
                                        int r0, int Q, int K) {
  for (int idx = threadIdx.x; idx < kTile * K; idx += kThreads) {
    const int r = idx / K, k = idx - r * K;
    dst[k * kLd + r] = (r0 + r < Q) ? to_f32(src[(long long)(r0 + r) * sl + k]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = a.N, P = a.P, Q = a.Q;
  float* sS = smem;                    // N x P state
  float* sCt = sS + N * P;             // N x kLd, C tile transposed
  float* sBt = sCt + N * kLd;          // N x kLd, B tile transposed
  float* sPt = sBt + N * kLd;          // kTile x kLd, score tile transposed
  float* sX = sPt + kTile * kLd;       // kTile x P
  float* cum = sX + kTile * P;         // Q
  float* sdt = cum + kMaxQ;            // Q
  float* sw = sdt + kMaxQ;             // Q: exp(total - cum_j) dt_j

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float Ah = a.A[h];
  const T* xb = static_cast<const T*>(a.x) + b * a.x_sb + (long long)h * P;
  const int g = h / a.hpg;                     // the head's B/C group
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.b_sb + g * a.b_sg;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.c_sb + g * a.c_sg;
  const float* dtb = a.dt + b * a.dt_sb + h;
  T* yb = static_cast<T*>(a.y) + (long long)b * a.L * a.H * P + (long long)h * P;

  // thread blocks: y and scores 4 x 4 of a 64 x 64 tile; state 8 x 4
  const int ti = (tid / 16) * 4, tj = (tid % 16) * 4;
  const int tn = (tid / 16) * 8;
  const bool p_ok = tj < P;

  for (int i = tid; i < N * P; i += kThreads) sS[i] = 0.0f;
  const int n_tiles = (Q + kTile - 1) / kTile;

  for (int l0 = 0; l0 < a.L; l0 += Q) {
    __syncthreads();                                   // previous chunk done
    for (int i = tid; i < Q; i += kThreads) {
      const float d = dtb[(long long)(l0 + i) * a.dt_sl];
      sdt[i] = d;
      cum[i] = d * Ah;
    }
    __syncthreads();
    if (tid < 32) {                                    // inclusive scan, warp 0
      const int seg = (Q + 31) / 32, lo = tid * seg, hi = min(lo + seg, Q);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) { run += cum[i]; cum[i] = run; }
      float pre = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, pre, d);
        if (tid >= d) pre += o;
      }
      pre -= run;                                      // exclusive prefix
      for (int i = lo; i < hi; ++i) cum[i] += pre;
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int j = tid; j < Q; j += kThreads) sw[j] = expf(total - cum[j]) * sdt[j];

    float ds[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) ds[r][c] = 0.0f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();                                 // sCt free
      stage_t<T>(sCt, Cb + (long long)l0 * a.c_sl, a.c_sl, i0, Q, N);
      __syncthreads();

      // inter-chunk term from the carried state
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
      if (p_ok) {
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(sCt + n * kLd + ti);
          const float4 sv = *reinterpret_cast<const float4*>(sS + n * P + tj);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += cr[r] * sc[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ti + r;
          const float e = i < Q ? expf(cum[i]) : 0.0f;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] *= e;
        }
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();                               // sBt, sX, sPt free
        stage_t<T>(sBt, Bb + (long long)l0 * a.b_sl, a.b_sl, j0, Q, N);
        for (int idx = tid; idx < kTile * P; idx += kThreads) {
          const int j = idx / P, p = idx - j * P;
          sX[idx] = (j0 + j < Q)
              ? to_f32(xb[(long long)(l0 + j0 + j) * a.x_sl + p]) : 0.0f;
        }
        __syncthreads();

        // score tile: (C_I . B_J^T) * exp(cum_i - cum_j) * dt_j, causal
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[r][c] = 0.0f;
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(sCt + n * kLd + ti);
          const float4 bv = *reinterpret_cast<const float4*>(sBt + n * kLd + tj);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[r][c] += cr[r] * bc[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ti + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tj + c;
            const bool keep = j <= i && i < Q;         // mask, then exponentiate
            sPt[(tj + c) * kLd + ti + r] =
                keep ? sc[r][c] * expf(cum[i] - cum[j]) * sdt[j] : 0.0f;
          }
        }
        __syncthreads();

        // y_I += scores @ x_J
        if (p_ok) {
          for (int j = 0; j < kTile; ++j) {
            const float4 pv = *reinterpret_cast<const float4*>(sPt + j * kLd + ti);
            const float4 xv = *reinterpret_cast<const float4*>(sX + j * P + tj);
            const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
            const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] += pr[r] * xc[c];
          }
        }
        // the last row tile sees every column tile: accumulate the state update
        if (it == n_tiles - 1 && p_ok && tn < N) {
          const int jn = min(kTile, Q - j0);
          for (int j = 0; j < jn; ++j) {
            const float wj = sw[j0 + j];
            const float4 xv = *reinterpret_cast<const float4*>(sX + j * P + tj);
            const float xc[4] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float bv = (tn + r < N) ? sBt[(tn + r) * kLd + j] : 0.0f;
#pragma unroll
              for (int c = 0; c < 4; ++c) ds[r][c] += bv * xc[c];
            }
          }
        }
      }

      if (p_ok) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ti + r;
          if (i < Q) {
            T* yr = yb + (long long)(l0 + i) * a.H * P + tj;
#pragma unroll
            for (int c = 0; c < 4; ++c) store(yr + c, acc[r][c]);
          }
        }
      }
    }

    __syncthreads();                                   // every read of S done
    const float et = expf(total);
    if (p_ok && tn < N) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (tn + r < N) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float* s = sS + (tn + r) * P + tj + c;
            *s = *s * et + ds[r][c];
          }
        }
      }
    }
  }

  __syncthreads();
  float* st = a.state + ((long long)b * a.H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads) st[i] = sS[i];
}

inline size_t smem_bytes(int N, int P) {
  return sizeof(float) * (size_t)(N * P + 2 * N * kLd + kTile * kLd + kTile * P
                                  + 3 * kMaxQ);
}

template <typename T>
int launch_as(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.N, a.P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<dim3(a.H, B), kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// ------------------------------------------------------------------------
// The bf16 tensor-core path (P 64, N 64 or 128, Q a multiple of 64 up to
// 256): three kernels per call, launched one after the other on the stream.
// ------------------------------------------------------------------------
namespace ssd_tc {

using hopper::desc;

constexpr int kBox = 64 * 128;        // bytes of a 64-row box of 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPairThreads = 2 * 128 + 32;  // passes a, b: two consumer warpgroups + a
                                            //   producer warp
constexpr int kCBTile = 64 * 64 * 4;  // bytes of a float32 64 x 64 score tile
constexpr int kScanThreads = 3 * 128;  // pass c: two consumer warpgroups + a producer
                                       //   warpgroup that gives its registers away

struct Args {
  const float* dt;     // (B, L, H), strides dt_sb, dt_sl, 1
  const float* A;      // (H,)
  __nv_bfloat16* y;    // (B, L, H, P) contiguous
  float* state;        // (B, H, N, P)
  float* cum;          // (B, H, nc, Q): inclusive prefix sum of dt * A per chunk
  float* dtc;          // (B, H, nc, Q): dt, chunk-contiguous
  float* dS;           // (B, nc, H, N, P): the state a chunk adds, B^T (w x)
  float* y_state;      // (B, nc - 1, H, Q / 64, 8, 128, 4): exp(cum_i) C_i S_c of
                       //   chunks 1 .. nc - 1 per 64-row tile, in the chunk
                       //   scan's accumulator order (chunk 0 has no state term)
  int L, H, N, Q, nc;
  int hg, hs;          // heads per CTA of pass a and of pass c; each divides hpg
  int hpg;             // heads per B/C group, H / G
  long long dt_sb, dt_sl;
};


// ---- pass a: chunk states --------------------------------------------------
// CTA (head group, chunk c, batch b): two consumer warpgroups taking
// alternate heads, two stages each.  Per head: cum and dt (written out for
// the other passes) and w_j = exp(total - cum_j) dt_j; x_c scaled by w in
// shared memory and rounded to bf16 (a row of a tile is a row j whatever
// the swizzle does to its chunks); dS_c = B_c^T (w x_c) as (N / 64) m64n64
// products over K = Q, both operands MN-major.
template <int kQT, int kNT>
__global__ void __launch_bounds__(kPairThreads, 1)
states_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
              Args a) {
  constexpr int Q = 64 * kQT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t b_full, x_full[4], x_empty[4];
  __shared__ float s_cum[2][256], s_dt[2][256], s_w[2][256];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sB = smem;                         // [kNT][kQT] boxes: rows j, 64 n
  uint8_t* sX = sB + kNT * kQT * kBox;        // [4][kQT] boxes: rows j, 64 p

  const int c = blockIdx.y, b = blockIdx.z, l0 = c * Q, tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(&b_full, 1);
    for (int s = 0; s < 4; ++s) {
      hopper::mbar_init(&x_full[s], 1);
      hopper::mbar_init(&x_empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {
    if (tid == 256) {
      hopper::mbar_expect_tx(&b_full, kNT * kQT * kBox);
      for (int mt = 0; mt < kNT; ++mt)
        for (int jt = 0; jt < kQT; ++jt)
          hopper::tma_load_4d(sB + (mt * kQT + jt) * kBox, &tb, &b_full, 64 * mt,
                              blockIdx.x * a.hg / a.hpg, l0 + 64 * jt, b);
      for (int hi = 0; hi < a.hg; ++hi) {        // head hi: warpgroup hi % 2, its
        const int k = hi / 2, s = 2 * (hi % 2) + k % 2;     // k-th head, stage s
        const int h = blockIdx.x * a.hg + hi;
        if (k >= 2) hopper::mbar_wait(&x_empty[s], ((k / 2) - 1) & 1);
        hopper::mbar_expect_tx(&x_full[s], kQT * kBox);
        for (int jt = 0; jt < kQT; ++jt)
          hopper::tma_load_4d(sX + (s * kQT + jt) * kBox, &tx, &x_full[s], 0, h,
                              l0 + 64 * jt, b);
      }
    }
    return;
  }

  const int w = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int row = 16 * warp + lane / 4;
  float* cum = s_cum[w];
  float* dtv = s_dt[w];
  float* wv = s_w[w];
  for (int hi = w; hi < a.hg; hi += 2) {
    const int k = hi / 2, s = 2 * w + k % 2, h = blockIdx.x * a.hg + hi;
    const float Ah = a.A[h];
    const float* dtp = a.dt + b * a.dt_sb + h;
    for (int j = t; j < Q; j += 128) {
      const float d = dtp[(long long)(l0 + j) * a.dt_sl];
      dtv[j] = d;
      cum[j] = d * Ah;
    }
    hopper::warpgroup_sync(1 + w);
    if (warp == 0) {                            // inclusive scan over the chunk
      constexpr int seg = Q / 32;
      float run = 0.0f;
#pragma unroll
      for (int i = 0; i < seg; ++i) { run += cum[lane * seg + i]; cum[lane * seg + i] = run; }
      float pre = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, pre, d);
        if (lane >= d) pre += o;
      }
      pre -= run;                               // exclusive prefix of the segment
#pragma unroll
      for (int i = 0; i < seg; ++i) cum[lane * seg + i] += pre;
    }
    hopper::warpgroup_sync(1 + w);
    const float total = cum[Q - 1];
    const long long base = (((long long)b * a.H + h) * a.nc + c) * Q;
    for (int j = t; j < Q; j += 128) {
      a.cum[base + j] = cum[j];
      a.dtc[base + j] = dtv[j];
      wv[j] = expf(total - cum[j]) * dtv[j];
    }
    hopper::warpgroup_sync(1 + w);

    // w x, rounded to bf16, in place
    hopper::mbar_wait(&x_full[s], (k / 2) & 1);
    uint8_t* xs = sX + s * kQT * kBox;
    for (int idx = t; idx < Q * 8; idx += 128) {
      uint4* p = reinterpret_cast<uint4*>(xs + 16 * idx);
      uint4 v = *p;
      const float wj = wv[idx / 8];
      uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[e]));
        u[e] = hopper::pack_bf16(f.x * wj, f.y * wj);
      }
      *p = v;
    }
    hopper::fence_proxy_async();
    hopper::warpgroup_sync(1 + w);

    if (k == 0) hopper::mbar_wait(&b_full, 0);
    float* out = a.dS + (((long long)b * a.nc + c) * a.H + h) * a.N * 64;
#pragma unroll
    for (int mt = 0; mt < kNT; ++mt) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      hopper::fence_regs<32>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < Q / 16; ++ks) {
        const int jt = ks / 4, sub = ks % 4;
        hopper::wgmma_ss_n64<1, 1>(acc, desc<128, true>(sB + (mt * kQT + jt) * kBox + sub * 2048),
                                   desc<128, true>(xs + jt * kBox + sub * 2048), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<32>(acc);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int n = 64 * mt + row + 8 * ((i / 2) % 2), p = 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<float2*>(out + (long long)n * 64 + p) = make_float2(acc[i], acc[i + 1]);
      }
    }
    if (lane == 0) hopper::mbar_arrive(&x_empty[s]);
  }
}

// ---- pass b: state passing ------------------------------------------------
// CTA (head h, batch b), two consumer warpgroups, sequentially over the
// chunks.  The state S (N x P, float32) lives in registers, 4 consecutive
// elements per thread and step:
// S_c = exp(total_{c-1}) S_{c-1} + dS_{c-1}.  For c >= 1 the entering state
// is also written to shared memory as bf16 hi + lo (MN-major tiles, rows n)
// and multiplied by the chunk's C (K-major, by TMA): exp(cum_i) C_i S_c, per
// 64-row tile, goes out in the accumulator order of the chunk scan, which
// adds it.  So the state never leaves the kernel but as the final state.
template <int kQT, int kNT>
__global__ void __launch_bounds__(kPairThreads, 1)
pass_kernel(const __grid_constant__ CUtensorMap tc, Args a) {
  constexpr int Q = 64 * kQT, N = 64 * kNT, NP = N * 64;
  constexpr int kPer = NP / (4 * 256);         // float4 groups of S per thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t c_full, c_empty;
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sC = smem;                          // [kQT][kNT] boxes: rows i, 64 n
  uint8_t* sS = sC + kQT * kNT * kBox;         // [hi, lo][kNT] boxes: rows n, 64 p

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(&c_full, 1);
    hopper::mbar_init(&c_empty, 8);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {
    if (tid == 256) {
      for (int c = 1; c < a.nc; ++c) {
        if (c >= 2) hopper::mbar_wait(&c_empty, (c - 2) & 1);
        hopper::mbar_expect_tx(&c_full, kQT * kNT * kBox);
        for (int mt = 0; mt < kQT; ++mt)
          for (int nt = 0; nt < kNT; ++nt)
            hopper::tma_load_4d(sC + (mt * kNT + nt) * kBox, &tc, &c_full, 64 * nt,
                                h / a.hpg, c * Q + 64 * mt, b);
      }
    }
    return;
  }

  const int w = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int r_lo = 16 * warp + lane / 4;
  const float* cum = a.cum + ((long long)b * a.H + h) * a.nc * Q;
  float4 S[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) S[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int c = 0; c < a.nc; ++c) {
    if (c > 0) {
      hopper::mbar_wait(&c_full, (c - 1) & 1);
      float4* out = reinterpret_cast<float4*>(
          a.y_state + ((((long long)b * (a.nc - 1) + c - 1) * a.H + h) * kQT) * 4096);
#pragma unroll 1
      for (int mt = w; mt < kQT; mt += 2) {     // warpgroup w: tiles w, w + 2, ...
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
        hopper::fence_regs<32>(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kNT * 4; ++ks) {
          const int nt = ks / 4, sub = ks % 4;
          const uint64_t dc = desc<128, false>(sC + (mt * kNT + nt) * kBox + sub * 32);
#pragma unroll
          for (int part = 0; part < 2; ++part)
            hopper::wgmma_ss_n64<0, 1>(acc, dc,
                                       desc<128, true>(sS + (part * kNT + nt) * kBox + sub * 2048), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<32>(acc);
        const float* cm = cum + (long long)c * Q + 64 * mt;
        const float e_lo = expf(cm[r_lo]), e_hi = expf(cm[r_lo + 8]);
#pragma unroll
        for (int q = 0; q < 8; ++q)                // registers 4q, 4q + 1: row r_lo;
          out[(mt * 8 + q) * 128 + t] =          // 4q + 2, 4q + 3: row r_lo + 8
              make_float4(acc[4 * q] * e_lo, acc[4 * q + 1] * e_lo, acc[4 * q + 2] * e_hi,
                          acc[4 * q + 3] * e_hi);
      }
      if (lane == 0) hopper::mbar_arrive(&c_empty);
    }

    // S_{c+1} = exp(total_c) S_c + dS_c, in float32
    const float d = expf(cum[(long long)c * Q + Q - 1]);
    const float4* ds = reinterpret_cast<const float4*>(
        a.dS + (((long long)b * a.nc + c) * a.H + h) * NP);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float4 v = ds[k * 256 + tid];
      S[k] = make_float4(d * S[k].x + v.x, d * S[k].y + v.y, d * S[k].z + v.z, d * S[k].w + v.w);
    }
    if (c + 1 < a.nc) {
      // the entering state of chunk c + 1 as bf16 hi + lo, swizzled as TMA
      // would write it: 16-byte chunk (p / 8) of row n at (p / 8) ^ (n % 8)
      hopper::named_sync(1, 256);                // the products read the old state
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = 4 * (k * 256 + tid), n = e / 64, p = e % 64;
        const int off = (n / 64) * kBox + (n % 64) * 128 + (((p / 8) ^ (n % 8)) * 16) + (p % 8) * 2;
        const float v[4] = {S[k].x, S[k].y, S[k].z, S[k].w};
        uint32_t hi[2], lo[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const __nv_bfloat162 hv = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
          const float2 hf = __bfloat1622float2(hv);
          hi[q] = *reinterpret_cast<const uint32_t*>(&hv);
          lo[q] = hopper::pack_bf16(v[2 * q] - hf.x, v[2 * q + 1] - hf.y);
        }
        *reinterpret_cast<uint2*>(sS + off) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(sS + kNT * kBox + off) = make_uint2(lo[0], lo[1]);
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1, 256);
    }
  }
  float4* st = reinterpret_cast<float4*>(a.state + ((long long)b * a.H + h) * NP);
#pragma unroll
  for (int k = 0; k < kPer; ++k) st[k * 256 + tid] = S[k];
}

// ---- pass c: chunk scan ----------------------------------------------------
// CTA (head group, chunk c and 64-row tile I, batch b), two consumer
// warpgroups taking alternate heads, each with two stages of its own.  Per
// head, with e = 64 I - 1 the row before the tile and cum falling along the
// chunk (dt A < 0):
//
//   y_I = exp(cum_i - cum_e) (C_I B_<I^T) (g x_<I)            below the diagonal
//       + (C_I B_I^T * exp(cum_i - cum_j) dt_j, causal) x_I    on it
//       + exp(cum_i) C_I S_c                                   [from pass b]
//
// with g_j = exp(cum_e - cum_j) dt_j: every factor is at most 1, so nothing
// overflows, and C_I B_J^T does not depend on the head.  The CTA forms it
// once (one B/C group), each warpgroup half of the tiles: below the
// diagonal as bf16 hi + lo A tiles (K-major, swizzled as TMA would), the
// diagonal tile in float32.  Per head, g x is formed in place over the x
// tiles (a row of a tile is a row j whatever the swizzle does to its
// chunks) and rounded to bf16; the products below the diagonal run from
// shared memory while the diagonal's scores are formed in registers, masked
// before the exponential, split into bf16 hi + lo.  y goes out through
// shared memory as 16-byte rows.
template <int kQT, int kNT>
__global__ void __launch_bounds__(kScanThreads, 1)
scan_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc, Args a) {
  constexpr int Q = 64 * kQT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t cb_full, x_full[4], x_empty[4];
  __shared__ __align__(16) float s_cum[4][256], s_dt[4][256];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sC = smem;                          // [kNT] boxes: rows i, 64 n
  uint8_t* sB = sC + kNT * kBox;               // [kQT][kNT] boxes: rows j, 64 n; then
  uint8_t* sOff = sB;                          //   [kQT - 1][hi, lo] A tiles: rows i, 64 j
  uint8_t* sDiag = sB + (kQT - 1) * 2 * kBox;  //   and the float32 diagonal tile
  uint8_t* sX = sB + kQT * kCBTile;            // [4][kQT] boxes: rows j, 64 p

  const int c = blockIdx.y / kQT, it = blockIdx.y % kQT, b = blockIdx.z;
  const int l0 = c * Q, i0 = 64 * it, tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(&cb_full, 1);
    for (int s = 0; s < 4; ++s) {
      hopper::mbar_init(&x_full[s], 1);
      hopper::mbar_init(&x_empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {
    hopper::setmaxnreg_dec<40>();
    if (tid == 256) {
      const int g = blockIdx.x * a.hs / a.hpg;   // the CTA's B/C group
      hopper::mbar_expect_tx(&cb_full, kNT * (it + 2) * kBox);
      for (int nt = 0; nt < kNT; ++nt)
        hopper::tma_load_4d(sC + nt * kBox, &tc, &cb_full, 64 * nt, g, l0 + i0, b);
      for (int J = 0; J <= it; ++J)
        for (int nt = 0; nt < kNT; ++nt)
          hopper::tma_load_4d(sB + (J * kNT + nt) * kBox, &tb, &cb_full, 64 * nt, g,
                              l0 + 64 * J, b);
      const uint32_t vec = (i0 + 64) * sizeof(float);
      for (int hi = 0; hi < a.hs; ++hi) {        // head hi: warpgroup hi % 2, its
        const int k = hi / 2, s = 2 * (hi % 2) + k % 2;     // k-th head, stage s
        const int h = blockIdx.x * a.hs + hi;
        if (k >= 2) hopper::mbar_wait(&x_empty[s], ((k / 2) - 1) & 1);
        hopper::mbar_expect_tx(&x_full[s], (it + 1) * kBox + 2 * vec);
        const long long base = (((long long)b * a.H + h) * a.nc + c) * Q;
        hopper::bulk_load(s_cum[s], a.cum + base, vec, &x_full[s]);
        hopper::bulk_load(s_dt[s], a.dtc + base, vec, &x_full[s]);
        for (int J = 0; J <= it; ++J)
          hopper::tma_load_4d(sX + (s * kQT + J) * kBox, &tx, &x_full[s], 0, h, l0 + 64 * J, b);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  // the warpgroup index through a shuffle: uniform over the warp to the
  // compiler, so the products under it are not serialized
  const int w = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int r_lo = 16 * warp + lane / 4;        // rows r_lo and r_lo + 8 of the tile

  // C_I B_J^T for J <= I, both K-major; warpgroup w forms J = w, w + 2, ...
  {
    float cb[(kQT + 1) / 2][32];
    hopper::mbar_wait(&cb_full, 0);
    hopper::wgmma_fence();
#pragma unroll
    for (int u = 0; u < (kQT + 1) / 2; ++u) {
      const int J = w + 2 * u;
      if (J <= it) {
#pragma unroll
        for (int ks = 0; ks < kNT * 4; ++ks) {
          const int nt = ks / 4, sub = ks % 4;
          hopper::wgmma_ss_n64<0, 0>(cb[u], desc<128, false>(sC + nt * kBox + sub * 32),
                                     desc<128, false>(sB + (J * kNT + nt) * kBox + sub * 32),
                                     ks > 0);
        }
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < (kQT + 1) / 2; ++u) hopper::fence_regs<32>(cb[u]);
    hopper::named_sync(3, 256);                  // every read of the B tiles done
#pragma unroll
    for (int u = 0; u < (kQT + 1) / 2; ++u) {
      const int J = w + 2 * u;
      if (J < it) {                              // bf16 hi + lo, swizzled, rows i
        uint8_t* hi_t = sOff + 2 * J * kBox;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = r_lo + 8 * ((i / 2) % 2), col = 8 * (i / 4) + 2 * (lane % 4);
          const int off = r * 128 + (((col / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
          const __nv_bfloat162 hv = __floats2bfloat162_rn(cb[u][i], cb[u][i + 1]);
          const float2 hf = __bfloat1622float2(hv);
          *reinterpret_cast<__nv_bfloat162*>(hi_t + off) = hv;
          *reinterpret_cast<uint32_t*>(hi_t + kBox + off) =
              hopper::pack_bf16(cb[u][i] - hf.x, cb[u][i + 1] - hf.y);
        }
      } else if (J == it) {                      // float32, fragment order
        float4* dst = reinterpret_cast<float4*>(sDiag);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          dst[q * 128 + t] = make_float4(cb[u][4 * q], cb[u][4 * q + 1], cb[u][4 * q + 2],
                                         cb[u][4 * q + 3]);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_sync(3, 256);
  }

  for (int hi = w; hi < a.hs; hi += 2) {       // this warpgroup's heads
    const int k = hi / 2, s = 2 * w + k % 2;
    const int h = blockIdx.x * a.hs + hi;
    const float* cumv = s_cum[s];
    const float* dtv = s_dt[s];
    uint8_t* xs = sX + s * kQT * kBox;

    // exp(cum_i) C_I S_c from pass b, in this accumulator's order
    float acc_s[32], acc_off[32], acc_d[32];
    if (c > 0) {
      const float4* ys = reinterpret_cast<const float4*>(
          a.y_state + ((((long long)b * (a.nc - 1) + c - 1) * a.H + h) * kQT + it) * 4096);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = ys[q * 128 + t];
        acc_s[4 * q] = v.x; acc_s[4 * q + 1] = v.y; acc_s[4 * q + 2] = v.z; acc_s[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_s[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) { acc_off[i] = 0.0f; acc_d[i] = 0.0f; }
    hopper::fence_regs<32>(acc_off);
    hopper::fence_regs<32>(acc_d);
    hopper::mbar_wait(&x_full[s], (k / 2) & 1);
    const float cum_lo = cumv[i0 + r_lo], cum_hi = cumv[i0 + r_lo + 8];

    // below the diagonal: g x in place, then the products from shared memory
    float rf_lo = 0.0f, rf_hi = 0.0f;
    if (it > 0) {
      const float ce = cumv[i0 - 1];
      rf_lo = expf(cum_lo - ce);
      rf_hi = expf(cum_hi - ce);
      for (int idx = t; idx < i0 * 8; idx += 128) {
        const int j = idx / 8;
        const float g = expf(ce - cumv[j]) * dtv[j];
        uint4* p = reinterpret_cast<uint4*>(xs + 16 * idx);
        uint4 v = *p;
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[e]));
          u[e] = hopper::pack_bf16(f.x * g, f.y * g);
        }
        *p = v;
      }
      hopper::fence_proxy_async();
      hopper::warpgroup_sync(1 + w);
      hopper::wgmma_fence();
#pragma unroll
      for (int J = 0; J < kQT - 1; ++J) {
        if (J < it) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint64_t dx = desc<128, true>(xs + J * kBox + ks * 2048);
            hopper::wgmma_ss_n64<0, 1>(acc_off, desc<128, false>(sOff + 2 * J * kBox + ks * 32),
                                       dx, 1);
            hopper::wgmma_ss_n64<0, 1>(acc_off,
                                       desc<128, false>(sOff + (2 * J + 1) * kBox + ks * 32), dx, 1);
          }
        }
      }
      hopper::wgmma_commit();
    }

    // the diagonal tile: scores in float32, split into bf16 hi + lo A
    // operands from registers.  Warp `warp` holds rows 16 warp .. 16 warp + 15
    // of the tile: an 8-column group past them is masked whole (zeros, no
    // exponential), one before them needs no mask, and the two on the
    // diagonal are masked element by element, before the exponential.
    uint32_t ah[4][4], al[4][4];
    const float4* cbt = reinterpret_cast<const float4*>(sDiag);
    const float2* cum2 = reinterpret_cast<const float2*>(cumv);
    const float2* dt2 = reinterpret_cast<const float2*>(dtv);
#pragma unroll
    for (int g = 0; g < 8; ++g) {               // registers 4 g .. 4 g + 3
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (g <= 2 * warp + 1) {
        const float4 cb4 = cbt[g * 128 + t];
        const float cbv[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
        const int j = i0 + 8 * g + 2 * (lane % 4);          // columns j, j + 1
        const float2 cj = cum2[j / 2], dj = dt2[j / 2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {           // rows r_lo, r_lo + 8 by r / 2
          const int i = i0 + r_lo + 8 * (r / 2), jr = j + r % 2;
          if (g < 2 * warp || jr <= i)
            v[r] = cbv[r] * hopper::exp2_approx(((r / 2 ? cum_hi : cum_lo) -
                                                 (r % 2 ? cj.y : cj.x)) * kLog2e) *
                   (r % 2 ? dj.y : dj.x);
        }
      }
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {          // A register (k-step g / 2, 2 (g % 2) + hl)
        const __nv_bfloat162 hv = __floats2bfloat162_rn(v[2 * hl], v[2 * hl + 1]);
        const float2 hf = __bfloat1622float2(hv);
        ah[g / 2][2 * (g % 2) + hl] = *reinterpret_cast<const uint32_t*>(&hv);
        al[g / 2][2 * (g % 2) + hl] = hopper::pack_bf16(v[2 * hl] - hf.x, v[2 * hl + 1] - hf.y);
      }
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t dx = desc<128, true>(xs + it * kBox + ks * 2048);
      hopper::wgmma_rs_n64<1>(acc_d, ah[ks], dx, 1);
      hopper::wgmma_rs_n64<1>(acc_d, al[ks], dx, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(acc_off);
    hopper::fence_regs<32>(acc_d);
    hopper::fence_regs_u32<16>(&ah[0][0]);
    hopper::fence_regs_u32<16>(&al[0][0]);

    // y in bf16 over the stage's first x tile (16-byte chunks XOR-swizzled
    // by row), then out as 16-byte rows
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float rf = (i / 2) % 2 ? rf_hi : rf_lo;
      const int r = r_lo + 8 * ((i / 2) % 2), col = 8 * (i / 4) + 2 * (lane % 4);
      const int off = r * 128 + (((col / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(xs + off) =
          hopper::pack_bf16(acc_s[i] + fmaf(rf, acc_off[i], acc_d[i]),
                            acc_s[i + 1] + fmaf(rf, acc_off[i + 1], acc_d[i + 1]));
    }
    hopper::warpgroup_sync(1 + w);
    __nv_bfloat16* yb = a.y + ((long long)b * a.L + l0 + i0) * a.H * 64 + (long long)h * 64;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = q * 128 + t, r = idx / 8, ch = idx % 8;
      const uint4 v = *reinterpret_cast<const uint4*>(xs + r * 128 + ((ch ^ (r % 8)) * 16));
      *reinterpret_cast<uint4*>(yb + (long long)r * a.H * 64 + 8 * ch) = v;
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&x_empty[s]);
  }
}

template <int kQT, int kNT>
constexpr int states_smem() { return 1024 + (kNT + 4) * kQT * kBox; }
template <int kQT, int kNT>
constexpr int pass_smem() { return 1024 + (kQT + 2) * kNT * kBox; }
template <int kQT, int kNT>
constexpr int scan_smem() { return 1024 + (kNT + 4 * kQT) * kBox + kQT * kCBTile; }

struct Maps {
  CUtensorMap x, b, c;
};

template <int kQT, int kNT>
int launch_as(const Maps& m, const Args& a, int B, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(states_kernel<kQT, kNT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       states_smem<kQT, kNT>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pass_kernel<kQT, kNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pass_smem<kQT, kNT>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scan_kernel<kQT, kNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             scan_smem<kQT, kNT>());
  if (e != cudaSuccess) return (int)e;
  states_kernel<kQT, kNT><<<dim3(a.H / a.hg, a.nc, B), kPairThreads, states_smem<kQT, kNT>(),
                            st>>>(
      m.x, m.b, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  pass_kernel<kQT, kNT><<<dim3(a.H, B), kPairThreads, pass_smem<kQT, kNT>(), st>>>(m.c, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_kernel<kQT, kNT><<<dim3(a.H / a.hs, a.nc * kQT, B), kScanThreads, scan_smem<kQT, kNT>(),
                          st>>>(m.x, m.b, m.c, a);
  return (int)cudaGetLastError();
}

}  // namespace ssd_tc

// dtype: 0 float32, 1 bfloat16.  strides: x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl,
// c_sb, c_sl, b_sg, c_sg (elements).  dims: B, L, H, P, N, Q, G.  Returns the
// cudaError_t.
extern "C" int launch_ssd(const void* x, const float* dt, const float* A,
                          const void* Bm, const void* Cm, void* y, float* state,
                          const long long* strides, const int* dims, int dtype,
                          void* stream) {
  ssd::Args a;
  a.x = x; a.dt = dt; a.A = A; a.Bm = Bm; a.Cm = Cm; a.y = y; a.state = state;
  a.x_sb = strides[0]; a.x_sl = strides[1]; a.dt_sb = strides[2]; a.dt_sl = strides[3];
  a.b_sb = strides[4]; a.b_sl = strides[5]; a.c_sb = strides[6]; a.c_sl = strides[7];
  a.b_sg = strides[8]; a.c_sg = strides[9];
  const int B = dims[0], G = dims[6];
  a.L = dims[1]; a.H = dims[2]; a.P = dims[3]; a.N = dims[4]; a.Q = dims[5];
  if (a.Q < 1 || a.Q > ssd::kMaxQ || a.N < 1 || a.N > ssd::kMaxN || a.P < 4 ||
      a.P > ssd::kMaxP || a.P % 4 || a.L % a.Q || G < 1 || a.H % G)
    return (int)cudaErrorInvalidValue;
  a.hpg = a.H / G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ssd::launch_as<float>(a, B, st);
  if (dtype == 1) return ssd::launch_as<__nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core path: x, B, C bfloat16 with P 64, N 64 or 128 and Q a
// multiple of 64 up to 256; x, B and C with 16-byte aligned bases and strides
// that are multiples of 8 elements; G groups of B and C, H / G heads each.  Scratch from the caller, float32: cum
// and dtc (B, H, nc, Q), dS (B, nc, H, N, P) and y_state (B, nc - 1, H, Q, P).
// Strides and dims as above.  Three kernels on the stream; returns the first
// cudaError_t.
extern "C" int launch_ssd_wgmma(const void* x, const float* dt, const float* A,
                                const void* Bm, const void* Cm, void* y, float* state,
                                float* cum, float* dtc, float* dS,
                                float* y_state, const long long* strides, const int* dims,
                                void* stream) {
  ssd_tc::Args a;
  a.dt = dt; a.A = A; a.y = static_cast<__nv_bfloat16*>(y); a.state = state;
  a.cum = cum; a.dtc = dtc; a.dS = dS; a.y_state = y_state;
  a.dt_sb = strides[2]; a.dt_sl = strides[3];
  const int B = dims[0], P = dims[3], G = dims[6];
  a.L = dims[1]; a.H = dims[2]; a.N = dims[4]; a.Q = dims[5];
  if (B < 1 || B > 65535 || a.H < 1 || a.H > 65535 || P != 64 || (a.N != 64 && a.N != 128) ||
      a.Q < 64 || a.Q > 256 || a.Q % 64 || a.L % a.Q || G < 1 || a.H % G)
    return (int)cudaErrorInvalidValue;
  a.nc = a.L / a.Q;
  a.hpg = a.H / G;                 // a CTA's heads lie in one group
  a.hg = a.hpg % 4 == 0 ? 4 : a.hpg % 2 == 0 ? 2 : 1;
  a.hs = a.hpg % 8 == 0 ? 8 : a.hg;
  if ((long long)a.nc * (a.Q / 64) > 65535) return (int)cudaErrorInvalidValue;

  ssd_tc::Maps m;
  const uint64_t eb = 2, L = a.L, H = a.H, N = a.N;
  const uint32_t box[4] = {64, 1, 64, 1};
  const uint64_t xd[4] = {64, H, L, (uint64_t)B};
  const uint64_t xs[3] = {64 * eb, strides[1] * eb, strides[0] * eb};
  // the group axis; with one group its stride is never stepped
  const uint64_t bd[4] = {N, (uint64_t)G, L, (uint64_t)B};
  const uint64_t bs[3] = {(G > 1 ? strides[8] : N) * eb, strides[5] * eb, strides[4] * eb};
  const uint64_t cs[3] = {(G > 1 ? strides[9] : N) * eb, strides[7] * eb, strides[6] * eb};
  int err = hopper::tensor_map_bf16(&m.x, x, xd, xs, box, 128);
  if (!err) err = hopper::tensor_map_bf16(&m.b, Bm, bd, bs, box, 128);
  if (!err) err = hopper::tensor_map_bf16(&m.c, Cm, bd, cs, box, 128);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qt = a.Q / 64;
  if (a.N == 128) {
    switch (qt) {
      case 1: return ssd_tc::launch_as<1, 2>(m, a, B, st);
      case 2: return ssd_tc::launch_as<2, 2>(m, a, B, st);
      case 3: return ssd_tc::launch_as<3, 2>(m, a, B, st);
      default: return ssd_tc::launch_as<4, 2>(m, a, B, st);
    }
  }
  switch (qt) {
    case 1: return ssd_tc::launch_as<1, 1>(m, a, B, st);
    case 2: return ssd_tc::launch_as<2, 1>(m, a, B, st);
    case 3: return ssd_tc::launch_as<3, 1>(m, a, B, st);
    default: return ssd_tc::launch_as<4, 1>(m, a, B, st);
  }
}
