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
// with x (Q, P), B and C (Q, N) (one group shared by every head), and the state
// S (N, P) in float32, zero at the first chunk.  Inputs are float32 or
// bfloat16; every product and sum is float32, as in the Pallas kernel.
//
// Design.  The TPU kernel carries S in VMEM scratch along a sequential chunk
// grid axis.  CTAs on Hopper run in no order, so one CTA of 256 threads owns one
// (b, h) and loops over the chunks itself, with S in shared memory.  A Q x Q
// float32 score tile at Q = 256 is 256 KiB, more than the 227 KB a CTA may have,
// so each chunk is cut into 64-row tiles: for row tile I the CTA stages C_I,
// and for every column tile J <= I it stages B_J and x_J, forms the 64 x 64
// masked score tile in shared memory, and adds scores @ x_J into registers (a
// 4 x 4 block of y per thread).  The mask is applied before the exponential:
// above the diagonal exp(cum_i - cum_j) overflows, and inf * 0 would give NaN.
// The last row tile visits every column tile, so the state update rides on it,
// accumulated in registers (8 x 4 per thread) and folded into S when the
// chunk ends, after every row tile has read the old S.  The final S is written
// out: the serving path needs it for decode (the Pallas kernel drops it).
//
// Bound.  At the serving shape (B 4, L 1024, H 64, P 64, N 128, Q 256, bf16)
// the kernel moves about 79 MB (24 us at 3.35 TB/s) and the Pallas kernel's
// work is about 34 GFLOP (35 us at the bf16 tensor-core rate), so it is bound
// by operations.  This first version multiplies on the float32 CUDA cores
// (0.5 ms at 67 TFLOP/s) and skips the tiles above the diagonal; tensor cores
// (mma/wgmma on bf16 tiles) are later work.  C . B^T is the same for every
// head (G = 1) and is recomputed per head, as the Pallas kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssd {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows and columns of a score tile
constexpr int kLd = kTile + 4;     // leading dimension of the transposed tiles
constexpr int kMaxQ = 256, kMaxN = 128, kMaxP = 64;

struct Args {
  const void* x;       // (B, L, H, P), strides x_sb, x_sl, P, 1
  const float* dt;     // (B, L, H), strides dt_sb, dt_sl, 1
  const float* A;      // (H,)
  const void* Bm;      // (B, L, 1, N), strides b_sb, b_sl, -, 1
  const void* Cm;      // (B, L, 1, N), strides c_sb, c_sl, -, 1
  void* y;             // (B, L, H, P) contiguous
  float* state;        // (B, H, N, P) contiguous
  int L, H, P, N, Q;
  long long x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, c_sb, c_sl;
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
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.b_sb;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.c_sb;
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

// dtype: 0 float32, 1 bfloat16.  strides: x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl,
// c_sb, c_sl (elements).  dims: B, L, H, P, N, Q.  Returns the cudaError_t.
extern "C" int launch_ssd(const void* x, const float* dt, const float* A,
                          const void* Bm, const void* Cm, void* y, float* state,
                          const long long* strides, const int* dims, int dtype,
                          void* stream) {
  ssd::Args a;
  a.x = x; a.dt = dt; a.A = A; a.Bm = Bm; a.Cm = Cm; a.y = y; a.state = state;
  a.x_sb = strides[0]; a.x_sl = strides[1]; a.dt_sb = strides[2]; a.dt_sl = strides[3];
  a.b_sb = strides[4]; a.b_sl = strides[5]; a.c_sb = strides[6]; a.c_sl = strides[7];
  const int B = dims[0];
  a.L = dims[1]; a.H = dims[2]; a.P = dims[3]; a.N = dims[4]; a.Q = dims[5];
  if (a.Q < 1 || a.Q > ssd::kMaxQ || a.N < 1 || a.N > ssd::kMaxN || a.P < 4 ||
      a.P > ssd::kMaxP || a.P % 4 || a.L % a.Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ssd::launch_as<float>(a, B, st);
  if (dtype == 1) return ssd::launch_as<__nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
