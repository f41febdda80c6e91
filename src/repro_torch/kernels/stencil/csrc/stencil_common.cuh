// Device code shared by every generated stencil kernel (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil/stencil.py::_build_kernel.
// The generator in ../stencil.py emits one kernel per (program, fetch mode)
// whose body is a list of tap fetches followed by the program's expression;
// the index math, the three fetch strategies, the corner-lane reload and the
// launch wrapper live here.
//
// Bound.  Every kernel is memory bound on an H100: it does a few to a few
// hundred float32 operations per output point against at least 8 bytes of
// compulsory traffic (each input array read once, the interior output
// written once), far below the card's 67 TFLOP/s : 3.35 TB/s ratio.  The
// least time is therefore compulsory bytes / 3.35 TB/s.  What separates the
// modes is how many *requests* reach L1/L2 for those bytes:
//
//   naive  one __ldg per unique tap (the paper's Original); neighbouring taps
//          re-request the same lines and rely on L1/L2 to absorb them.
//   paper  per (array, j/k offset) row, each lane loads only the row's source
//          taps; every covered tap arrives by __shfl_down_sync/__shfl_up_sync.
//          The schedule is geometric, and the kernel is built only when its
//          shuffles equal, tap by tap, the pairs and deltas the symbolic
//          emulator detected (cuda_lower.synthesize_cuda).  Lanes whose source
//          lane falls outside the warp reload from global memory (the paper's
//          corner loads).
//   tile   one halo tile per array is staged in shared memory by the whole
//          CTA, and every tap reads it: each element is requested about once
//          per CTA.
//
// Ragged edges are masked, not padded: a thread past the interior clamps the
// address of each load and skips its store.  No thread leaves before a
// full-mask shuffle or a __syncthreads.  A valid lane only ever takes a
// shuffled value from a lane whose load was not clamped, because that load
// reads the valid lane's own in-bounds tap.

#pragma once

#include <cuda_runtime.h>

namespace rs {

constexpr unsigned kFullMask = 0xffffffffu;

// Full extents n* and interior extents m* along (i, j, k); 1 where absent.
struct Dims {
  long long n0, n1, n2;
  long long m0, m1, m2;
  int h0, h1, h2;
};

inline Dims make_dims(const long long* shape, int h0, int h1, int h2) {
  Dims d;
  d.n0 = shape[0]; d.n1 = shape[1]; d.n2 = shape[2];
  d.h0 = h0; d.h1 = h1; d.h2 = h2;
  d.m0 = d.n0 - 2 * h0; d.m1 = d.n1 - 2 * h1; d.m2 = d.n2 - 2 * h2;
  return d;
}

// The thread's output point, in full-array coordinates.  threadIdx.x runs
// along i, so a warp's 32 lanes hold 32 consecutive i of one (j, k) row.
struct Point {
  long long i, j, k;
  int lane;
  bool valid;
};

template <int BX, int BY>
__device__ __forceinline__ Point point(const Dims& d) {
  Point p;
  p.i = (long long)blockIdx.x * BX + threadIdx.x + d.h0;
  p.j = (long long)blockIdx.y * BY + threadIdx.y + d.h1;
  p.k = (long long)blockIdx.z + d.h2;
  p.lane = threadIdx.x & 31;
  p.valid = p.i < d.n0 - d.h0 && p.j < d.n1 - d.h1 && p.k < d.n2 - d.h2;
  return p;
}

// 64-bit linear offset of element (i, j, k), each coordinate clamped to the
// array.  Coordinates are never negative: points start at the halo.
__device__ __forceinline__ long long offset(const Dims& d, long long i,
                                            long long j, long long k) {
  i = i < d.n0 - 1 ? i : d.n0 - 1;
  j = j < d.n1 - 1 ? j : d.n1 - 1;
  k = k < d.n2 - 1 ? k : d.n2 - 1;
  return (k * d.n1 + j) * d.n0 + i;
}

// naive, and the paper mode's source taps: one read-only global load.
__device__ __forceinline__ float load(const float* __restrict__ a,
                                      const Dims& d, const Point& p,
                                      int oi, int oj, int ok) {
  return __ldg(a + offset(d, p.i + oi, p.j + oj, p.k + ok));
}

// paper: the tap at lane offset oi, taken from the lane `delta` away, which
// loaded the same row at oi - delta.  The corner lanes reload.
__device__ __forceinline__ float shuffled(float src, const float* __restrict__ a,
                                          const Dims& d, const Point& p,
                                          int oi, int oj, int ok, int delta) {
  const float v = delta > 0 ? __shfl_down_sync(kFullMask, src, delta)
                            : __shfl_up_sync(kFullMask, src, -delta);
  const int from = p.lane + delta;
  return (from < 0 || from > 31) ? load(a, d, p, oi, oj, ok) : v;
}

// tile: the CTA stages the (ti, tj, tk) box whose corner is (li, lj, lk)
// away from the CTA's first output point.  The leading barrier keeps a
// previous array's tile alive until every thread has read it.
template <int BX, int BY>
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ a,
                                      const Dims& d, int li, int lj, int lk,
                                      int ti, int tj, int tk) {
  const long long i0 = (long long)blockIdx.x * BX + d.h0 + li;
  const long long j0 = (long long)blockIdx.y * BY + d.h1 + lj;
  const long long k0 = (long long)blockIdx.z + d.h2 + lk;
  __syncthreads();
  const int n = ti * tj * tk;
  for (int e = threadIdx.y * BX + threadIdx.x; e < n; e += BX * BY) {
    const int x = e % ti;
    const int y = (e / ti) % tj;
    const int z = e / (ti * tj);
    tile[e] = __ldg(a + offset(d, i0 + x, j0 + y, k0 + z));
  }
  __syncthreads();
}

__device__ __forceinline__ float from_tile(const float* tile, int oi, int oj,
                                           int ok, int li, int lj, int lk,
                                           int ti, int tj) {
  return tile[((ok - lk) * tj + (int)threadIdx.y + oj - lj) * ti
              + (int)threadIdx.x + oi - li];
}

__device__ __forceinline__ void store(float* __restrict__ out, const Dims& d,
                                      const Point& p, float v) {
  if (p.valid)
    out[((p.k - d.h2) * d.m1 + (p.j - d.h1)) * d.m0 + (p.i - d.h0)] = v;
}

// Launch on the caller's stream; returns the launch's cudaError_t so the
// Python wrapper can raise on a refused launch.
template <int BX, int BY, typename Kernel, typename... Args>
inline int launch(Kernel kernel, const Dims& d, void* stream, Args... args) {
  const dim3 grid((unsigned)((d.m0 + BX - 1) / BX),
                  (unsigned)((d.m1 + BY - 1) / BY), (unsigned)d.m2);
  kernel<<<grid, dim3(BX, BY, 1), 0, (cudaStream_t)stream>>>(d, args...);
  return (int)cudaGetLastError();
}

}  // namespace rs
