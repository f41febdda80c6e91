// Device code shared by the generated depthwise causal conv1d kernels (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/conv1d/conv1d.py::_kernel
// (entry causal_conv1d):
//
//   out[b, l, c] = silu(bias[c] + sum_t w[t, c] * x[b, l - W + 1 + t, c])
//
// with zero rows left of the sequence, float32 accumulation, and x, w, bias and
// out in one dtype (float32 or bfloat16).  x may be any (B, L, C) view whose
// channels are contiguous (the model passes a column range of its
// in-projection); its batch and row strides are 64-bit element strides.  out is
// contiguous.  The generator in ../conv1d.py emits, per (mode, W), the kernel
// body: the fetches of one step and the W multiply-adds; the layout,
// the loads, the shuffles, the epilogue and the launcher live here.
//
// Bound.  Each output costs W multiply-adds and one SiLU against at least
// 2 x itemsize bytes of compulsory traffic (x read once, out written once), far
// below the card's 67 TFLOP/s : 3.35 TB/s ratio, so the least time is the
// compulsory bytes over 3.35 TB/s.  One output vector per short-lived thread
// (W + 2 loads, a bias and W weight vectors for one output, a full-precision
// division in the SiLU) put instruction issue and load requests in the way.
// So:
//
//   * a warp marches over S consecutive 8-position segments along L (the TPU's
//     sequential grid axis becomes this loop): it loads the bias and the W
//     weight vectors once, into float registers, and each step fetches only
//     what the step adds, prefetched AHEAD steps before it is used;
//   * the SiLU is acc * 1 / (1 + e^-acc) with the hardware exponential and
//     an approximate reciprocal (__expf, __fdividef), within float32 parity;
//   * as many CTAs as fit on the card at once walk a list of (channel tile,
//     position tile, batch row) items.
//
// Layout.  C is contiguous, so coalescing wants neighbouring lanes on
// neighbouring channels, while a shuffle along the sequence wants neighbouring
// lanes on neighbouring positions.  A warp is therefore kPos = 8 positions x
// kGroups = 4 channel groups, lane = 4 * position + group, and each lane holds
// one 16-byte vector of VEC channels (8 bf16 or 4 float32; smaller when C, a
// stride or an address is not aligned).  Each position's row is 64 contiguous
// bytes, and one sequence step is kGroups lanes, so the emulator's position
// delta d becomes a lane delta of kGroups * d.  A CTA is kWarpsC = 4 warps
// along C by kWarpsL = 2 along L, each warp marching over its own S segments.
//
// The modes differ only in how a tap arrives; the W multiply-adds and the
// epilogue are the same code, so the modes agree bit for bit:
//
//   naive    one load per tap per output (the paper's Original): W requests.
//   shuffle  each lane loads only the row of its window's first tap (the
//            schedule's source), once per segment: segment i's source row is
//            x[l0 + 8i + p - W + 1].  Covered tap d of lane p is the source of
//            lane p + d: by __shfl_down_sync(4d) from the current segment's row
//            when p + d < 8, and otherwise (the corner lanes) from lane
//            p + d - 8 of the next segment's row, prefetched already, by a
//            second full-mask __shfl_up_sync(32 - 4d).  After the first
//            segment, whose source row carries the causal halo, every x row is
//            loaded once per warp; of the march's extra last row only the
//            W - 1 lanes that feed corner taps load.
//
// Ragged edges and the causal halo are masked, not padded: a load whose
// position lies outside [0, L) or whose channels lie past C yields zeros, and a
// lane whose output lies outside stores nothing.  No lane leaves before a
// full-mask shuffle: a march ends early only on a test of the CTA's item, the
// same for all its warps.  The mask is on the *loaded* position, so a valid
// lane that takes a shuffled value always receives its own in-bounds tap.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rc {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPos = 8;       // sequence positions per warp and segment
constexpr int kGroups = 4;    // lanes per position (channel groups)
constexpr int kWarpsC = 4;    // warps of a CTA along C
constexpr int kWarpsL = 2;    // warps of a CTA along L
constexpr int kThreads = 32 * kWarpsC * kWarpsL;

enum DType { kF32 = 0, kBF16 = 1 };

// The launch's arguments.  x's strides are in elements; out is contiguous.
struct Args {
  const void* x;
  long long sb, sl;           // x's batch and row strides
  const void* w;
  const void* b;
  void* out;
  int L, C, act;
  int n_ct, n_lt, n_items;    // CTA tiles along C and L; items in all
};

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

// The lane's place in one item: outputs at positions l + kPos * i of batch row
// b, channels [c, c + VEC), for the march's steps i = 0 .. S - 1.
struct Site {
  long long x0;     // element offset of x[b, l, c]
  long long o0;     // element offset of out[b, l, c]
  long long sl;     // x's row stride
  int l, p, c;      // the first output position, the position within the warp,
                    // the first channel
  int lcta;         // the item's first position (the same for the whole CTA)
  int L, C;
  bool cvalid;
};

template <int VEC, int S>
__device__ __forceinline__ Site site(const Args& a, int item) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane % kGroups, p = lane / kGroups;
  const int ct = item % a.n_ct, rest = item / a.n_ct;
  const int lt = rest % a.n_lt, b = rest / a.n_lt;
  Site s;
  const int c = ((ct * kWarpsC + warp % kWarpsC) * kGroups + g) * VEC;
  s.p = p;
  s.c = c;
  s.lcta = lt * kWarpsL * kPos * S;
  s.l = s.lcta + (warp / kWarpsC) * kPos * S + p;
  s.x0 = (long long)b * a.sb + (long long)s.l * a.sl + c;
  s.o0 = ((long long)b * a.L + s.l) * a.C + c;
  s.sl = a.sl;
  s.L = a.L;
  s.C = a.C;
  s.cvalid = c < a.C;
  return s;
}

// Whether step i of the march lies wholly past the sequence for every warp of
// the CTA (a test of the item alone, so every lane of a warp agrees).
__device__ __forceinline__ bool past_end(const Site& s, int i) {
  return s.lcta + kPos * i >= s.L;
}

// x[b, l + kPos * i + off, c .. c + VEC): zeros outside the sequence or past C.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_tap(const T* __restrict__ x,
                                                 const Site& s, int i, int off) {
  const int pos = s.l + kPos * i + off;
  if (!s.cvalid || pos < 0 || pos >= s.L) return zero<T, VEC>();
  return load<T, VEC>(x + s.x0 + (long long)(kPos * i + off) * s.sl);
}

// Segment i's source row (the tap at offset `off`, the window's first) for the
// shuffle mode's march of S steps.  Row S is the one past the march: only its
// lanes p < W - 1 feed a corner tap, and only they load.
template <typename T, int VEC, int W, int S>
__device__ __forceinline__ Pack<T, VEC> source_row(const T* __restrict__ x,
                                                   const Site& s, int i, int off) {
  if (i == S && s.p >= W - 1) return zero<T, VEC>();
  return load_tap<T, VEC>(x, s, i, off);
}

// A covered tap `delta` positions after the source: lane p takes it from lane
// p + delta of the current segment's source row, by __shfl_down_sync; a corner
// lane (p + delta >= kPos) from lane p + delta - kPos of the next segment's
// source row, by __shfl_up_sync of 32 - kGroups * delta lanes.  Every lane
// issues both full-mask shuffles and keeps one.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> covered(const Pack<T, VEC>& cur,
                                                const Pack<T, VEC>& nxt,
                                                int delta, const Site& s) {
  Pack<T, VEC> r;
  const bool corner = s.p + delta >= kPos;
#pragma unroll
  for (int i = 0; i < Pack<T, VEC>::kWords; ++i) {
    const uint32_t down = __shfl_down_sync(kFullMask, cur.w[i], kGroups * delta);
    const uint32_t up = __shfl_up_sync(kFullMask, nxt.w[i], 32 - kGroups * delta);
    r.w[i] = corner ? up : down;
  }
  return r;
}

// The bias and the W weight vectors of the lane's channels, as float32, loaded
// once per item (zeros past C).
template <typename T, int VEC, int W>
struct Weights {
  float bias[VEC];
  float w[W][VEC];

  __device__ __forceinline__ Weights(const Args& a, const Site& s) {
    const T* wp = static_cast<const T*>(a.w);
    const T* bp = static_cast<const T*>(a.b);
    const Pack<T, VEC> pb = s.cvalid ? load<T, VEC>(bp + s.c) : zero<T, VEC>();
#pragma unroll
    for (int e = 0; e < VEC; ++e) bias[e] = elem<T>(pb.w, e);
#pragma unroll
    for (int t = 0; t < W; ++t) {
      const Pack<T, VEC> pw =
          s.cvalid ? load<T, VEC>(wp + (long long)t * s.C + s.c) : zero<T, VEC>();
#pragma unroll
      for (int e = 0; e < VEC; ++e) w[t][e] = elem<T>(pw.w, e);
    }
  }

  __device__ __forceinline__ void init(float* acc) const {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = bias[e];
  }

  // acc += x_tap * w[t]: unfused float32 multiply and add, as the plain version.
  __device__ __forceinline__ void tap(float* acc, const Pack<T, VEC>& v, int t) const {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] = __fadd_rn(acc[e], __fmul_rn(elem<T>(v.w, e), w[t][e]));
  }
};

// silu(a) = a / (1 + e^-a) with the hardware exponential and reciprocal
// (2 ulp each): within float32 parity of the plain version's F.silu.  For
// a < -87, e^-a passes 2^126 and __fdividef gives 0 where a e^a < 1e-35.
__device__ __forceinline__ float silu(float a) {
  return __fdividef(a, 1.0f + __expf(-a));
}

// The lane's output of step i: the SiLU (if `act`), rounding to T, one store.
template <typename T, int VEC>
__device__ __forceinline__ void finish(const Args& a, float* acc, const Site& s,
                                       int i) {
  if (!s.cvalid || s.l + kPos * i >= s.L) return;
  Pack<T, VEC> r = zero<T, VEC>();
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if (a.act) acc[e] = silu(acc[e]);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) r.w[e] = __float_as_uint(acc[e]);
  } else if constexpr (VEC == 1) {
    r.w[0] = __bfloat16_as_ushort(__float2bfloat16_rn(acc[0]));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(acc[e], acc[e + 1]);
      r.w[e >> 1] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  T* p = static_cast<T*>(a.out) + s.o0 + (long long)kPos * i * s.C;
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

// CTAs of `kernel` that fit on the card at once (resident per SM x SMs).
template <typename K>
int resident_ctas(K kernel) {
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) ||
      cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return -1;
  return per_sm * sms;
}

// Launch the (T, VEC) instance of `kernel` over the items of a march of S
// steps: (C / (kWarpsC kGroups VEC)) x (L / (kWarpsL kPos S)) x B items, with
// `ctas` CTAs walking them (one per item where there are fewer).  Returns the
// launch's cudaError_t.
template <typename T, int VEC, int S, typename K>
int launch_as(K kernel, const void* x, long long sb, long long sl, const void* w,
              const void* b, void* out, int B, int L, int C, int act, int ctas,
              void* stream) {
  Args a;
  a.x = x; a.sb = sb; a.sl = sl; a.w = w; a.b = b; a.out = out;
  a.L = L; a.C = C; a.act = act;
  a.n_ct = (C + kWarpsC * kGroups * VEC - 1) / (kWarpsC * kGroups * VEC);
  a.n_lt = (L + kWarpsL * kPos * S - 1) / (kWarpsL * kPos * S);
  a.n_items = a.n_ct * a.n_lt * B;
  const int grid = ctas < a.n_items ? ctas : a.n_items;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <typename T_, int VEC_>
struct Instance {
  using T = T_;
  static constexpr int VEC = VEC_;
};

// f(Instance<T, VEC>{}) for the (dtype, vec) asked for; `none` when the pair
// has no instance.
template <typename F>
int dispatch(int dtype, int vec, int none, F f) {
  if (dtype == kF32) {
    switch (vec) {
      case 4: return f(Instance<float, 4>{});
      case 2: return f(Instance<float, 2>{});
      case 1: return f(Instance<float, 1>{});
    }
  } else if (dtype == kBF16) {
    switch (vec) {
      case 8: return f(Instance<__nv_bfloat16, 8>{});
      case 4: return f(Instance<__nv_bfloat16, 4>{});
      case 2: return f(Instance<__nv_bfloat16, 2>{});
      case 1: return f(Instance<__nv_bfloat16, 1>{});
    }
  }
  return none;
}

}  // namespace rc

// Defines, over the template kernel NAME<T, VEC> marching S steps,
//   extern "C" launch_<NAME>(x, sb, sl, w, b, out, B, L, C, dtype, vec, act,
//                            ctas, stream): cudaErrorInvalidValue for a
//                            (dtype, vec) without an instance;
//   extern "C" resident_<NAME>(dtype, vec): the CTAs that fit on the card at
//                            once, -1 on error.
#define RC_LAUNCHER(NAME, S)                                                    \
  extern "C" int launch_##NAME(const void* x, long long sb, long long sl,      \
                               const void* w, const void* b, void* out, int B,  \
                               int L, int C, int dtype, int vec, int act,       \
                               int ctas, void* stream) {                        \
    return rc::dispatch(dtype, vec, (int)cudaErrorInvalidValue, [&](auto i) {  \
      using I = decltype(i);                                                    \
      return rc::launch_as<typename I::T, I::VEC, S>(                           \
          NAME<typename I::T, I::VEC>, x, sb, sl, w, b, out, B, L, C, act,      \
          ctas, stream);                                                        \
    });                                                                         \
  }                                                                             \
  extern "C" int resident_##NAME(int dtype, int vec) {                          \
    return rc::dispatch(dtype, vec, -1, [](auto i) {                            \
      using I = decltype(i);                                                    \
      return rc::resident_ctas(NAME<typename I::T, I::VEC>);                    \
    });                                                                         \
  }
