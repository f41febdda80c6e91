// Device code shared by the generated depthwise causal conv1d kernels (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/conv1d/conv1d.py::_kernel
// (entry causal_conv1d):
//
//   out[b, l, c] = silu(bias[c] + sum_t w[t, c] * x[b, l - W + 1 + t, c])
//
// with zero rows left of the sequence, float32 accumulation, and x, w, bias and
// out in one dtype (float32 or bfloat16).  The generator in ../conv1d.py emits,
// per (mode, W), the kernel body: the tap fetches followed by the W
// multiply-adds; the layout, the loads, the shuffles and the launcher live here.
//
// Bound.  Each output costs W multiply-adds and one SiLU against at least
// 2 x itemsize bytes of compulsory traffic (x read once, out written once), far
// below the card's 67 TFLOP/s : 3.35 TB/s ratio, so the least time is the
// compulsory bytes over 3.35 TB/s.  What separates the modes is how many load
// requests reach L1/L2 for those bytes:
//
//   naive    one load per tap per output (the paper's Original): W requests.
//   shuffle  each lane loads the row of its window's first tap (the schedule's
//            source); the other W - 1 taps arrive by __shfl_down_sync from the
//            lanes that hold them (the schedule's covered taps).  Lanes whose
//            source lane lies past the warp reload from global memory (the
//            paper's corner loads).
//
// Layout.  C is contiguous, so coalescing wants neighbouring lanes on
// neighbouring channels, while a shuffle along the sequence wants neighbouring
// lanes on neighbouring positions.  A warp is therefore kPos = 8 positions x
// kGroups = 4 channel groups, lane = 4 * position + group, and each lane holds
// one 16-byte vector of VEC channels (8 bf16 or 4 float32; smaller when C or an
// address is not aligned).  Each position's row is 64 contiguous bytes, and one
// sequence step is kGroups lanes, so the emulator's position delta d becomes a
// lane delta of kGroups * d.  A CTA is kWarpsC = 4 warps along C by kWarpsL = 2
// along L: 16 positions x 256 contiguous bytes per row.
//
// Ragged edges and the causal halo are masked, not padded: a load whose
// position lies outside [0, L) or whose channels lie past C yields zeros, and a
// lane whose own output lies outside stores nothing.  No lane leaves before a
// full-mask shuffle.  The mask is on the *loaded* position, so a valid lane that
// takes a shuffled value always receives its own in-bounds tap.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rc {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPos = 8;       // sequence positions per warp
constexpr int kGroups = 4;    // lanes per position (channel groups)
constexpr int kWarpsC = 4;    // warps of a CTA along C
constexpr int kWarpsL = 2;    // warps of a CTA along L
constexpr int kThreads = 32 * kWarpsC * kWarpsL;

enum DType { kF32 = 0, kBF16 = 1 };

// VEC elements of T held as raw 32-bit words (a 2-byte pack uses the low half).
template <typename T, int VEC>
struct Pack {
  static constexpr int kBytes = int(sizeof(T)) * VEC;
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  uint32_t w[kWords];
};

template <typename T>
__device__ __forceinline__ float elem(const uint32_t* w, int e);

template <>
__device__ __forceinline__ float elem<float>(const uint32_t* w, int e) {
  return __uint_as_float(w[e]);
}

template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint32_t* w, int e) {
  const uint32_t word = w[e >> 1];
  return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> zero() {
  Pack<T, VEC> r;
#pragma unroll
  for (int i = 0; i < Pack<T, VEC>::kWords; ++i) r.w[i] = 0u;
  return r;
}

// One aligned vector load of VEC elements at p.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  Pack<T, VEC> r;
  constexpr int kBytes = Pack<T, VEC>::kBytes;
  if constexpr (kBytes == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
  } else if constexpr (kBytes == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r.w[0] = v.x; r.w[1] = v.y;
  } else if constexpr (kBytes == 4) {
    r.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    r.w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> shfl_down(const Pack<T, VEC>& v, int lanes) {
  Pack<T, VEC> r;
#pragma unroll
  for (int i = 0; i < Pack<T, VEC>::kWords; ++i)
    r.w[i] = __shfl_down_sync(kFullMask, v.w[i], lanes);
  return r;
}

// The thread's place: output position l of batch row b, channels [c, c+VEC).
struct Site {
  long long base;   // element offset of (b, 0, 0)
  int l, c, p;      // position, first channel, position within the warp
  int L, C;
  bool cvalid;
};

template <int VEC>
__device__ __forceinline__ Site site(int L, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane % kGroups, p = lane / kGroups;
  Site s;
  s.p = p;
  s.c = ((blockIdx.x * kWarpsC + warp % kWarpsC) * kGroups + g) * VEC;
  s.l = (blockIdx.y * kWarpsL + warp / kWarpsC) * kPos + p;
  s.base = (long long)blockIdx.z * L * C;
  s.L = L;
  s.C = C;
  s.cvalid = s.c < C;
  return s;
}

// Tap at offset `off` (<= 0) of the thread's window: x[b, l + off, c..c+VEC],
// zeros outside the sequence or past C.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_tap(const T* __restrict__ x,
                                                 const Site& s, int off) {
  const int pos = s.l + off;
  if (!s.cvalid || pos < 0 || pos >= s.L) return zero<T, VEC>();
  return load<T, VEC>(x + s.base + (long long)pos * s.C + s.c);
}

// A covered tap: taken from the lane `delta` positions later, which loaded it
// as its source tap; lanes whose source lane lies past the warp reload it.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> shfl_or_reload(const Pack<T, VEC>& src,
                                                       int delta,
                                                       const T* __restrict__ x,
                                                       const Site& s, int off) {
  Pack<T, VEC> v = shfl_down<T, VEC>(src, kGroups * delta);
  if (s.p + delta >= kPos) v = load_tap<T, VEC>(x, s, off);
  return v;
}

template <typename T, int VEC>
__device__ __forceinline__ void init(float* acc, const T* __restrict__ bias,
                                     const Site& s) {
  const Pack<T, VEC> bp = s.cvalid ? load<T, VEC>(bias + s.c) : zero<T, VEC>();
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = elem<T>(bp.w, e);
}

// acc += x_tap * w[t]: unfused float32 multiply and add, as the plain version.
template <typename T, int VEC>
__device__ __forceinline__ void tap(float* acc, const Pack<T, VEC>& v,
                                    const T* __restrict__ w, const Site& s, int t) {
  const Pack<T, VEC> wp =
      s.cvalid ? load<T, VEC>(w + (long long)t * s.C + s.c) : zero<T, VEC>();
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    acc[e] = __fadd_rn(acc[e], __fmul_rn(elem<T>(v.w, e), elem<T>(wp.w, e)));
}

template <typename T>
__device__ __forceinline__ uint32_t bits(float f);

template <>
__device__ __forceinline__ uint32_t bits<float>(float f) {
  return __float_as_uint(f);
}

template <>
__device__ __forceinline__ uint32_t bits<__nv_bfloat16>(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <typename T, int VEC>
__device__ __forceinline__ void finish(T* __restrict__ out, float* acc,
                                       const Site& s, int act) {
  if (!s.cvalid || s.l >= s.L) return;
  Pack<T, VEC> r = zero<T, VEC>();
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float a = act ? acc[e] / (1.0f + expf(-acc[e])) : acc[e];
    if constexpr (sizeof(T) == 4) {
      r.w[e] = bits<T>(a);
    } else {
      r.w[e >> 1] |= bits<T>(a) << (16 * (e & 1));
    }
  }
  T* p = out + s.base + (long long)s.l * s.C + s.c;
  constexpr int kBytes = Pack<T, VEC>::kBytes;
  if constexpr (kBytes == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<uint32_t*>(p) = r.w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)r.w[0];
  }
}

// Launch the (T, VEC) instance of `kernel` over (C / (kWarpsC kGroups VEC),
// L / (kWarpsL kPos), B) CTAs; returns the launch's cudaError_t.
template <typename T, int VEC, typename K>
int launch_as(K kernel, const void* x, const void* w, const void* b, void* out,
              int B, int L, int C, int act, cudaStream_t stream) {
  const int per_cta_c = kWarpsC * kGroups * VEC;
  dim3 grid((C + per_cta_c - 1) / per_cta_c,
            (L + kWarpsL * kPos - 1) / (kWarpsL * kPos), B);
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), L, C, act);
  return (int)cudaGetLastError();
}

}  // namespace rc

// Defines extern "C" launch_<NAME>(x, w, b, out, B, L, C, dtype, vec, act,
// stream) over the template kernel NAME<T, VEC>; an unsupported (dtype, vec)
// returns cudaErrorInvalidValue.
#define RC_LAUNCHER(NAME)                                                       \
  extern "C" int launch_##NAME(const void* x, const void* w, const void* b,    \
                               void* out, int B, int L, int C, int dtype,      \
                               int vec, int act, void* stream) {               \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                        \
    if (dtype == rc::kF32) {                                                    \
      switch (vec) {                                                            \
        case 4: return rc::launch_as<float, 4>(NAME<float, 4>, x, w, b, out, B, L, C, act, st); \
        case 2: return rc::launch_as<float, 2>(NAME<float, 2>, x, w, b, out, B, L, C, act, st); \
        case 1: return rc::launch_as<float, 1>(NAME<float, 1>, x, w, b, out, B, L, C, act, st); \
      }                                                                         \
    } else if (dtype == rc::kBF16) {                                            \
      switch (vec) {                                                            \
        case 8: return rc::launch_as<__nv_bfloat16, 8>(NAME<__nv_bfloat16, 8>, x, w, b, out, B, L, C, act, st); \
        case 4: return rc::launch_as<__nv_bfloat16, 4>(NAME<__nv_bfloat16, 4>, x, w, b, out, B, L, C, act, st); \
        case 2: return rc::launch_as<__nv_bfloat16, 2>(NAME<__nv_bfloat16, 2>, x, w, b, out, B, L, C, act, st); \
        case 1: return rc::launch_as<__nv_bfloat16, 1>(NAME<__nv_bfloat16, 1>, x, w, b, out, B, L, C, act, st); \
      }                                                                         \
    }                                                                           \
    return (int)cudaErrorInvalidValue;                                          \
  }
