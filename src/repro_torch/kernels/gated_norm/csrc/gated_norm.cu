// The Mamba-2 mixer's tail for Hopper (sm_90a): the D skip, the SiLU gate
// and the grouped RMSNorm in one pass over a token row.
//
// For a row of C = H P channels in G equal groups of C / G, with y the SSD's
// output, x the SSD's input (head h = c / P), z the gate and D the skip per
// head:
//
//   u[c]   = T(y[c] + D[h] x[c])                  float32 product and sum
//   s[c]   = T(z[c] / (1 + exp(-z[c])))           SiLU
//   v[c]   = T(u[c] s[c])
//   r_g    = T(rsqrt(mean_{c in g} v[c]^2 + eps)) float32 statistics
//   out[c] = T(T(v[c] r_g) scale[c])
//
// T rounds to the operands' type (bfloat16 or float32; the identity for
// float32).  These are the rounding points of the plain version
// (ref.py::gated_norm_tail): PyTorch's elementwise kernels compute each
// operation in float32 and round each result to its tensor's type, so u, s,
// v and the output come out bit for bit as there; the float32 sum of squares
// is taken in another order (warp shuffles, then across warps), which may
// move r_g by a float32 ulp and, rarely, its bf16 rounding by one ulp.
// Product and sum are written __fmul_rn / __fadd_rn so that nvcc contracts
// nothing into an FMA the plain version does not have.
//
// One CTA of 128 threads per (row, group).  Each thread loads its VPT
// 16-byte vectors of y, x and z first (x and z are column ranges of wider
// tensors, read in place: row strides that are multiples of 16 bytes), keeps
// v in registers in the operands' type (exact: v is already rounded to it),
// and the output is written once.  No float32 tensor goes to device memory.
//
// Bytes a row: y, x, z read and the output written once, 8 a channel in
// bf16, plus the scale (C elements, from L2 after the first rows) and D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gated_norm {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// the most vectors a thread takes: a group of up to 128 x 8 vectors (8,192
// bf16 or 4,096 float32 channels; Zamba2-7B's groups are 3,584)
constexpr int kMaxVpt = 8;

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int kVec = 4;                  // elements in 16 bytes
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

// x rounded to T and widened back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Traits<T>::load(Traits<T>::store(x));
}

struct Args {
  const void* y;
  const void* x;
  const void* z;
  const float* d_skip;
  const void* scale;
  void* out;
  long long y_sb, y_sl, x_sb, x_sl, z_sb, z_sl;   // batch and position strides
  int L, C, group, P;
  float inv_n, eps;                                // fl32(1 / group), fl32(eps)
};

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads) tail_kernel(Args a) {
  constexpr int V = Traits<T>::kVec;
  const long long row = blockIdx.x;
  const long long b = row / a.L, l = row - b * a.L;
  const int c0 = blockIdx.y * a.group;             // the group's first channel
  const int nvec = a.group / V;
  const T* y = static_cast<const T*>(a.y) + b * a.y_sb + l * a.y_sl + c0;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + l * a.x_sl + c0;
  const T* z = static_cast<const T*>(a.z) + b * a.z_sb + l * a.z_sl + c0;

  // every load of the thread in flight before the first use
  uint4 yv[VPT], xv[VPT], zv[VPT];
  float d[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
      yv[i] = __ldg(reinterpret_cast<const uint4*>(y) + v);
      xv[i] = __ldg(reinterpret_cast<const uint4*>(x) + v);
      zv[i] = __ldg(reinterpret_cast<const uint4*>(z) + v);
      d[i] = __ldg(a.d_skip + (c0 + v * V) / a.P);  // V divides P: one head a vector
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
      T* yp = reinterpret_cast<T*>(&yv[i]);
      const T* xp = reinterpret_cast<const T*>(&xv[i]);
      const T* zp = reinterpret_cast<const T*>(&zv[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float u = rnd<T>(__fadd_rn(Traits<T>::load(yp[j]),
                                         __fmul_rn(d[i], Traits<T>::load(xp[j]))));
        const float zf = Traits<T>::load(zp[j]);
        const float s = rnd<T>(zf / (1.0f + expf(-zf)));
        const float h = rnd<T>(__fmul_rn(u, s));
        ss = __fadd_rn(ss, __fmul_rn(h, h));
        yp[j] = Traits<T>::store(h);                // v kept in y's registers
      }
    }
  }

  __shared__ float part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = part[0];                            // one order for every thread
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total = __fadd_rn(total, part[w]);
  const float r = rnd<T>(rsqrtf(__fadd_rn(__fmul_rn(total, a.inv_n), a.eps)));

  const T* scale = static_cast<const T*>(a.scale) + c0;
  T* out = static_cast<T*>(a.out) + row * a.C + c0;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
      const uint4 sv = __ldg(reinterpret_cast<const uint4*>(scale) + v);
      uint4 ov;
      const T* hp = reinterpret_cast<const T*>(&yv[i]);
      const T* sp = reinterpret_cast<const T*>(&sv);
      T* op = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int j = 0; j < V; ++j)
        op[j] = Traits<T>::store(__fmul_rn(rnd<T>(__fmul_rn(Traits<T>::load(hp[j]), r)),
                                           Traits<T>::load(sp[j])));
      reinterpret_cast<uint4*>(out)[v] = ov;
    }
  }
}

template <typename T, int VPT>
int launch_vpt(const Args& a, long long rows, int G, cudaStream_t st) {
  tail_kernel<T, VPT><<<dim3((unsigned)rows, (unsigned)G), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_as(const Args& a, long long rows, int G, cudaStream_t st) {
  const int nvec = a.group / Traits<T>::kVec;
  if (nvec <= kThreads) return launch_vpt<T, 1>(a, rows, G, st);
  if (nvec <= 2 * kThreads) return launch_vpt<T, 2>(a, rows, G, st);
  if (nvec <= 4 * kThreads) return launch_vpt<T, 4>(a, rows, G, st);
  if (nvec <= kMaxVpt * kThreads) return launch_vpt<T, kMaxVpt>(a, rows, G, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gated_norm

// y, x and z (B, L, C) with unit channel stride, 16-byte aligned bases and
// batch and position strides that are multiples of 16 bytes; d_skip (H,)
// float32; scale (C,); out (B, L, C) contiguous; every tensor but d_skip of
// one dtype (0 float32, 1 bfloat16).  strides: y_sb, y_sl, x_sb, x_sl, z_sb,
// z_sl in elements; dims: B, L, C, G, P.  One launch on the stream; returns
// its cudaError_t.
extern "C" int launch_gated_norm(const void* y, const void* x, const void* z,
                                 const float* d_skip, const void* scale, void* out,
                                 const long long* strides, const int* dims,
                                 float inv_n, float eps, int dtype, void* stream) {
  gated_norm::Args a;
  a.y = y; a.x = x; a.z = z; a.d_skip = d_skip; a.scale = scale; a.out = out;
  a.y_sb = strides[0]; a.y_sl = strides[1]; a.x_sb = strides[2]; a.x_sl = strides[3];
  a.z_sb = strides[4]; a.z_sl = strides[5];
  const int B = dims[0], G = dims[3];
  a.L = dims[1]; a.C = dims[2]; a.P = dims[4];
  a.inv_n = inv_n; a.eps = eps;
  const int V = dtype == 0 ? 4 : 8;
  if (B < 1 || a.L < 1 || G < 1 || G > 65535 || a.C % G || a.P < 1 || a.P % V ||
      a.C % a.P)
    return (int)cudaErrorInvalidValue;
  a.group = a.C / G;
  const long long rows = (long long)B * a.L;
  if (a.group % V || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gated_norm::launch_as<float>(a, rows, G, st);
  if (dtype == 1) return gated_norm::launch_as<__nv_bfloat16>(a, rows, G, st);
  return (int)cudaErrorInvalidValue;
}
