// AdamW for Hopper (sm_90a): the gradient's global norm and the update of
// every parameter of a model in three launches, whatever its number of
// tensors.
//
// Replaces no TPU kernel: the JAX package's optimizer is jnp
// (src/repro/train/optim.py), which XLA fuses.  The port's plain version
// (ref.py::adamw_tensor) runs some 22 PyTorch passes a parameter, each
// over a float32 temporary, plus three for the norm.
//
// Bound: bytes.  A parameter costs 22 bytes at bf16 weights and gradients:
// the norm reads g (2); the update reads g, p, m, v (2 + 2 + 4 + 4) and
// writes p, m, v (2 + 4 + 4).  Nothing else goes to device memory but one
// float32 partial sum a chunk.
//
// The work table: one row of kFields int64 per tensor (Entry), built on the
// host each step (the gradients are new tensors every step) and copied to
// the device once: the four base pointers, the length, the first chunk
// (chunks of kChunk elements, counted over the tensors in order) and flags
// (the gradient's and the parameter's dtype, float32 or bfloat16, and
// whether the tensor decays).  A CTA walks chunks in a grid-stride loop and
// finds a chunk's tensor by a binary search over the first chunks.
//
//   1. norm:     each chunk's float32 sum of g^2 (per-lane sums, then a
//                fixed warp-shuffle and cross-warp order) into partials[c];
//   2. finalize: one CTA; mode 1 sums each tensor's partials in float64, in
//                a fixed order, into sums[t] (float32); mode 2 takes
//                gnorm = sqrt(sum_t sums[t]) in parameter order (float64)
//                and scale = min(1 / max(gnorm, 1e-12) * clip, 1), the
//                plain version's expression; out = (gnorm, scale).  A mesh
//                runs mode 1, all-reduces the sums, then mode 2.
//   3. update:   per element, the plain version's expression in its order:
//                g = T(g) scale; m = b1 m + (1 - b1) g;
//                v = b2 v + (1 - b2) (g g);
//                s = (m / b1c) / (sqrt(v / b2c) + eps) [+ wd p];
//                p = T(p - lr s)
//                float32 throughout, each operation rounded as PyTorch's
//                elementwise kernels round it (__fmul_rn and its kin: nvcc
//                contracts nothing into an FMA), so given the same scale m,
//                v and p come out bit for bit as the plain version's.
//
// No float atomics: a step repeats bit for bit.  scale, lr and the bias
// corrections are read from device memory, so nothing waits on the host.
// 16-byte loads and stores where the four bases are 16-byte aligned (every
// chunk starts at a multiple of 8 elements), scalar ones where not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace adamw {

constexpr int kThreads = 256;
constexpr int kFinalizeThreads = 1024;
constexpr int kVec = 8;                      // elements a thread takes at once
constexpr long long kChunk = 16384;          // elements a chunk: 8 vectors a thread
constexpr int kFields = 8;                   // int64 fields of an Entry

enum Flags : long long { kGradBf16 = 1, kParamBf16 = 2, kDecay = 4 };

struct Entry {
  const void* g;
  void* p;
  float* m;
  float* v;
  long long n;          // elements
  long long begin;      // the tensor's first chunk
  long long flags;
  long long unused;
};
static_assert(sizeof(Entry) == kFields * 8, "an Entry is one row of the table");

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;         // float32 of the Python scalars
};

__device__ __forceinline__ void load8(const float* x, float (&o)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(x)[0];
  const float4 b = reinterpret_cast<const float4*>(x)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* x, float (&o)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(x);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    o[2 * j] = f.x;
    o[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* x, const float (&o)[kVec]) {
  reinterpret_cast<float4*>(x)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(x)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* x, const float (&o)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
  *reinterpret_cast<uint4*>(x) = u;
}

__device__ __forceinline__ float load1(const float* x) { return *x; }
__device__ __forceinline__ float load1(const __nv_bfloat16* x) { return __bfloat162float(*x); }
__device__ __forceinline__ void store1(float* x, float v) { *x = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* x, float v) { *x = __float2bfloat16_rn(v); }

__device__ __forceinline__ bool aligned16(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// the tensor that holds chunk c: the last entry whose first chunk is at most
// c (a tensor of no chunk shares its first chunk with the next one)
__device__ __forceinline__ int find_tensor(const Entry* __restrict__ e, int T, long long c) {
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (e[mid].begin <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// 1. the norm: one float32 partial sum of squares a chunk
// ---------------------------------------------------------------------------

template <typename G>
__device__ float chunk_sumsq(const G* __restrict__ g, long long start, long long end) {
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  long long tail = start;
  if (aligned16(g)) {
    const long long nvec = (end - start) / kVec;
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      float x[kVec];
      load8(g + start + i * kVec, x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(x[j], x[j]));
    }
    tail = start + nvec * kVec;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    const float x = load1(g + i);
    acc[0] = __fadd_rn(acc[0], __fmul_rn(x, x));
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])),
                   __fadd_rn(__fadd_rn(acc[4], acc[5]), __fadd_rn(acc[6], acc[7])));
}

__global__ void __launch_bounds__(kThreads)
norm_kernel(const Entry* __restrict__ table, int T, long long chunks, float* __restrict__ partials) {
  __shared__ float part[kThreads / 32];
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const Entry e = table[find_tensor(table, T, c)];
    const long long start = (c - e.begin) * kChunk;
    const long long end = min(start + kChunk, e.n);
    float s = (e.flags & kGradBf16)
        ? chunk_sumsq(static_cast<const __nv_bfloat16*>(e.g), start, end)
        : chunk_sumsq(static_cast<const float*>(e.g), start, end);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = part[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) total = __fadd_rn(total, part[w]);
      partials[c] = total;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 2. finalize: per-tensor sums, then the norm and the clip scale
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kFinalizeThreads)
finalize_kernel(const Entry* __restrict__ table, int T, long long chunks,
                const float* __restrict__ partials, float* __restrict__ sums,
                float* __restrict__ out, float clip, int mode) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (mode & 1) {
    for (int t = warp; t < T; t += kFinalizeThreads / 32) {
      const long long b = table[t].begin;
      const long long e = t + 1 < T ? table[t + 1].begin : chunks;
      double s = 0.0;
      for (long long c = b + lane; c < e; c += 32) s += (double)partials[c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sums[t] = (float)s;
    }
    __syncthreads();
  }
  if ((mode & 2) && threadIdx.x == 0) {
    double s = 0.0;
    for (int t = 0; t < T; ++t) s += (double)sums[t];       // parameter order
    const float gnorm = (float)sqrt(s);
    // torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0), where
    // clip / t is reciprocal(t) * clip; NaN passes through as it does there
    const float lo = gnorm < 1e-12f ? 1e-12f : gnorm;
    const float scale = __fmul_rn(__frcp_rn(lo), clip);
    out[0] = gnorm;
    out[1] = scale > 1.f ? 1.f : scale;
  }
}

// ---------------------------------------------------------------------------
// 3. the update
// ---------------------------------------------------------------------------

struct Step {
  float scale, lr, b1c, b2c;
};

// one element: m and v updated in place, the new parameter returned
__device__ __forceinline__ float adamw1(float g, float pf, float& m, float& v, const Step& k,
                                        const Hyper& h, bool decay) {
  g = __fmul_rn(g, k.scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float s = __fdiv_rn(__fdiv_rn(m, k.b1c), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.b2c)), h.eps));
  if (decay) s = __fadd_rn(s, __fmul_rn(h.wd, pf));
  return __fsub_rn(pf, __fmul_rn(k.lr, s));
}

template <typename G, typename P>
__device__ void update_chunk(const Entry& e, long long start, long long end, const Step& k,
                             const Hyper& h) {
  const G* __restrict__ g = static_cast<const G*>(e.g);
  P* __restrict__ p = static_cast<P*>(e.p);
  float* __restrict__ m = e.m;
  float* __restrict__ v = e.v;
  const bool decay = e.flags & kDecay;
  long long tail = start;
  if (aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v)) {
    const long long nvec = (end - start) / kVec;
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      const long long o = start + i * kVec;
      float gx[kVec], px[kVec], mx[kVec], vx[kVec];
      load8(g + o, gx);
      load8(p + o, px);
      load8(m + o, mx);
      load8(v + o, vx);
#pragma unroll
      for (int j = 0; j < kVec; ++j) px[j] = adamw1(gx[j], px[j], mx[j], vx[j], k, h, decay);
      store8(m + o, mx);
      store8(v + o, vx);
      store8(p + o, px);
    }
    tail = start + nvec * kVec;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float mi = m[i], vi = v[i];
    const float pi = adamw1(load1(g + i), load1(p + i), mi, vi, k, h, decay);
    m[i] = mi;
    v[i] = vi;
    store1(p + i, pi);
  }
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const Entry* __restrict__ table, int T, long long chunks,
              const float* __restrict__ scale, const float* __restrict__ lr,
              const float* __restrict__ b1c, const float* __restrict__ b2c, Hyper h) {
  const Step k{*scale, *lr, *b1c, *b2c};
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const Entry e = table[find_tensor(table, T, c)];
    const long long start = (c - e.begin) * kChunk;
    const long long end = min(start + kChunk, e.n);
    switch (e.flags & (kGradBf16 | kParamBf16)) {
      case 0: update_chunk<float, float>(e, start, end, k, h); break;
      case kGradBf16: update_chunk<__nv_bfloat16, float>(e, start, end, k, h); break;
      case kParamBf16: update_chunk<float, __nv_bfloat16>(e, start, end, k, h); break;
      default: update_chunk<__nv_bfloat16, __nv_bfloat16>(e, start, end, k, h); break;
    }
  }
}

// CTAs of kThreads that fill every SM of the current device once, at most
// one a chunk
template <typename K>
int grid_for(K kernel, long long chunks) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(chunks < full ? chunks : full);
}

}  // namespace adamw

// table: T rows of adamw::Entry on the device; chunks: the chunks over all
// rows; partials: chunks float32.  One launch on the stream; returns its
// cudaError_t.
extern "C" int launch_adamw_norm(const long long* table, int T, long long chunks,
                                 float* partials, void* stream) {
  if (T < 1 || chunks < 1) return (int)cudaErrorInvalidValue;
  const int grid = adamw::grid_for(adamw::norm_kernel, chunks);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  adamw::norm_kernel<<<grid, adamw::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const adamw::Entry*>(table), T, chunks, partials);
  return (int)cudaGetLastError();
}

// mode 1: sums (T float32) from the partials; mode 2: out (2 float32:
// gnorm, scale) from the sums; 3 both.
extern "C" int launch_adamw_finalize(const long long* table, int T, long long chunks,
                                     const float* partials, float* sums, float* out,
                                     float clip, int mode, void* stream) {
  if (T < 1 || chunks < 0 || mode < 1 || mode > 3) return (int)cudaErrorInvalidValue;
  adamw::finalize_kernel<<<1, adamw::kFinalizeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const adamw::Entry*>(table), T, chunks, partials, sums, out, clip, mode);
  return (int)cudaGetLastError();
}

// scale, lr, b1c, b2c: one float32 each on the device; b1, 1 - b1, b2,
// 1 - b2, eps, weight_decay: the float32 values of the Python scalars.
extern "C" int launch_adamw_update(const long long* table, int T, long long chunks,
                                   const float* scale, const float* lr, const float* b1c,
                                   const float* b2c, float b1, float omb1, float b2,
                                   float omb2, float eps, float wd, void* stream) {
  if (T < 1 || chunks < 1) return (int)cudaErrorInvalidValue;
  const int grid = adamw::grid_for(adamw::update_kernel, chunks);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const adamw::Hyper h{b1, omb1, b2, omb2, eps, wd};
  adamw::update_kernel<<<grid, adamw::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const adamw::Entry*>(table), T, chunks, scale, lr, b1c, b2c, h);
  return (int)cudaGetLastError();
}
