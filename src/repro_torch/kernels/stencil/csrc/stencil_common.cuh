// Device code shared by every generated stencil kernel (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil/stencil.py::_build_kernel.
// The generator in ../stencil.py emits one kernel per (program, fetch mode):
// a march of R outputs per thread along the outer axis (k in 3-D, j in 2-D;
// 1-D computes one), each step fetching only the taps the thread does not
// hold yet, then the program's expression.  The index math, the three fetch
// strategies, the corner-lane reload, the shared-memory staging and the
// launch wrapper live here.
//
// Bound.  Every kernel is bound by its compulsory traffic (each input array
// read once, the interior output written once) against 3.35 TB/s: it does a
// few to a few hundred float32 operations per output.  With one output per
// thread and a clamped 64-bit index per tap, instruction issue stands in the
// way instead (integer and address instructions are 57-70 % of the SASS,
// and every output fetches every tap anew).  So:
//
//   * each thread computes one 64-bit base offset; each (array, j/k offset)
//     row of a plane gets one pointer, and each tap is row[oi] with oi a
//     compile-time constant (an immediate offset in the SASS);
//   * j and k are clamped once, on the point or the plane, warp-uniformly;
//     i is clamped per tap only in the one warp per row that reaches past the
//     interior (the generator emits the march twice, kEdge false and true,
//     and a branch that ptxas can see is warp-uniform picks one);
//   * along the march axis a thread keeps the taps it already holds in
//     registers: each step fetches only the entering plane's taps.
//
// What bounds the march instead is, for heavy expressions, the expression
// itself: its operations are rounded intrinsics that never fuse.
//
// The modes differ only in how a tap the thread does not hold arrives:
//
//   naive  one __ldg (the paper's Original).
//   paper  per (array, j/k offset) row, each lane loads only the row's source
//          taps; every covered tap arrives by __shfl_down_sync/__shfl_up_sync
//          by the delta the symbolic emulator detected (cuda_lower.
//          synthesize_cuda); lanes whose source lane falls outside the warp
//          reload from global memory (the paper's corner loads).
//   tile   one shared-memory buffer per array, read by every tap: in 3-D a
//          ring of hk - lk + 2 planes, one plane entering per step behind one
//          __syncthreads (fetched into registers a step ahead by a Stager);
//          in 1-D and 2-D the CTA's whole box, staged once.

// Ragged edges are masked, not padded: a step past the interior clamps its
// plane and skips its store.  No thread leaves before a full-mask shuffle or
// a __syncthreads.  Along i, a valid lane only ever takes a shuffled value
// from a lane whose load was not clamped, because that load reads the valid
// lane's own in-bounds tap; this is why i is clamped per tap and never on the
// point (lane 31 past the edge, clamped, would hand lane 30 the wrong column).

#pragma once

#include <cuda_runtime.h>

namespace rs {

constexpr unsigned kFullMask = 0xffffffffu;

// Full extents n* and interior extents m* along (i, j, k); 1 where absent.
// s1, s2 are the strides of j and k; so is the stride of the march axis
// (s2 in 3-D, s1 in 2-D, 0 in 1-D) and os the output's stride along it.
struct Dims {
  long long n0, n1, n2;
  long long m0, m1, m2;
  long long s1, s2, so, os;
  int h0, h1, h2;
};

inline Dims make_dims(const long long* shape, int h0, int h1, int h2, int nd) {
  Dims d;
  d.n0 = shape[0]; d.n1 = shape[1]; d.n2 = shape[2];
  d.h0 = h0; d.h1 = h1; d.h2 = h2;
  d.m0 = d.n0 - 2 * h0; d.m1 = d.n1 - 2 * h1; d.m2 = d.n2 - 2 * h2;
  d.s1 = d.n0;
  d.s2 = d.n0 * d.n1;
  d.so = nd == 3 ? d.s2 : nd == 2 ? d.s1 : 0;
  d.os = nd == 3 ? d.m0 * d.m1 : nd == 2 ? d.m0 : 0;
  return d;
}

// The thread's march.  threadIdx.x runs along i, so a warp's 32 lanes hold
// 32 consecutive i of one row; the thread's outputs are R consecutive points
// along the march axis from its first point.
struct Point {
  long long base;   // offset of the first point, j clamped to the interior (3-D)
  long long out;    // output offset of the first point
  int pmax;         // the last plane of the array, relative to the first point
  int steps;        // outputs stored: 0 when i or j lies past the interior
  int lim;          // n0 - 1 - i: the largest i offset in the array
  int lane;
  bool edge;        // warp-uniform: some lane's taps may reach past n0 - 1
};

template <int BX, int BY, int R, int ND>
__device__ __forceinline__ Point point(const Dims& d) {
  Point p;
  const long long i = (long long)blockIdx.x * BX + threadIdx.x + d.h0;
  const long long warp_i = i - (threadIdx.x & 31);
  // along the march: the first point, the interior's end, the extent
  long long j = 0, first = 0, stop = 1, n_outer = 1;
  bool valid = i < d.n0 - d.h0;
  if (ND == 3) {
    j = (long long)blockIdx.y * BY + threadIdx.y + d.h1;
    valid = valid && j < d.n1 - d.h1;
    first = (long long)blockIdx.z * R + d.h2;
    stop = d.n2 - d.h2; n_outer = d.n2;
    p.out = ((first - d.h2) * d.m1 + (j - d.h1)) * d.m0 + (i - d.h0);
    j = j < d.n1 - d.h1 ? j : d.n1 - d.h1 - 1;
    p.base = first * d.s2 + j * d.s1 + i;
  } else if (ND == 2) {
    first = ((long long)blockIdx.y * BY + threadIdx.y) * R + d.h1;
    stop = d.n1 - d.h1; n_outer = d.n1;
    p.out = (first - d.h1) * d.m0 + (i - d.h0);
    p.base = first * d.s1 + i;
  } else {
    p.out = i - d.h0;
    p.base = i;
  }
  const long long left = ND == 1 ? 1 : stop - first;
  p.steps = !valid || left <= 0 ? 0 : (left < R ? (int)left : R);
  p.pmax = ND == 1 ? 0 : (int)(n_outer - 1 - first);
  p.lim = (int)(d.n0 - 1 - i);
  p.lane = threadIdx.x & 31;
  // From blockIdx alone where a CTA is one warp wide (BX == 32), else through
  // a vote, so that ptxas sees it warp-uniform: a branch it cannot prove
  // uniform makes it guard every shuffle behind it with a fallback for
  // diverged lanes (WARPSYNC.COLLECTIVE), doubling paper's code.
  p.edge = BX == 32 ? (long long)blockIdx.x * BX + d.h0 + 31 + d.h0 > d.n0 - 1
                    : __any_sync(kFullMask, warp_i + 31 + d.h0 > d.n0 - 1);
  return p;
}

// Offset of relative plane P (along the march) from the array's start, the
// plane clamped to the array: only steps that store nothing read a clamped
// plane.
__device__ __forceinline__ long long plane(const Dims& d, const Point& p, int P) {
  return p.base + (long long)(P < p.pmax ? P : p.pmax) * d.so;
}

// The row at j offset oj (3-D) of a plane: tap oi of the thread is row[oi].
__device__ __forceinline__ const float* row(const float* __restrict__ a,
                                            const Dims& d, long long q, int oj) {
  return a + q + oj * d.s1;
}

// naive, and the paper mode's source taps: one read-only global load.  In an
// edge warp the column is clamped to the array.
template <bool kEdge>
__device__ __forceinline__ float load(const float* __restrict__ r, const Point& p,
                                      int oi) {
  return __ldg(r + (kEdge && oi > p.lim ? p.lim : oi));
}

// paper: the tap at lane offset oi, taken from the lane `delta` away, which
// loaded the same row at oi - delta.  The corner lanes reload.
template <bool kEdge>
__device__ __forceinline__ float shuffled(float src, const float* __restrict__ r,
                                          const Point& p, int oi, int delta) {
  const float v = delta > 0 ? __shfl_down_sync(kFullMask, src, delta)
                            : __shfl_up_sync(kFullMask, src, -delta);
  const int from = p.lane + delta;
  return (from < 0 || from > 31) ? load<kEdge>(r, p, oi) : v;
}

// tile: the thread's share of the CTA's TI x TJ box of one array, whose
// corner is (li, lj) away from the CTA's first output point: rows
// threadIdx.y + BY * y and columns threadIdx.x + BX * x (coalesced along i),
// each element's offset computed once and clamped to the array.  fetch()
// loads a plane's share into registers (all loads in flight together) and
// store() writes them to shared memory, so a 3-D march fetches the next
// plane before computing its step and stores it after.
template <int BX, int BY, int R, int ND, int TI, int TJ>
struct Stager {
  static constexpr int NY = (TJ + BY - 1) / BY, NX = (TI + BX - 1) / BX;
  long long off[NY][NX];
  float v[NY][NX];

  __device__ __forceinline__ Stager(const Dims& d, int li, int lj) {
    const long long i0 = (long long)blockIdx.x * BX + d.h0 + li;
    const long long j0 = ND == 3 ? (long long)blockIdx.y * BY + d.h1 + lj
                       : ND == 2 ? (long long)blockIdx.y * BY * R + d.h1 + lj : 0;
#pragma unroll
    for (int y = 0; y < NY; ++y) {
      const long long j = j0 + threadIdx.y + BY * y;
      const long long row = (ND == 1 ? 0 : j < d.n1 - 1 ? j : d.n1 - 1) * d.s1;
#pragma unroll
      for (int x = 0; x < NX; ++x) {
        const long long i = i0 + threadIdx.x + BX * x;
        off[y][x] = row + (i < d.n0 - 1 ? i : d.n0 - 1);
      }
    }
  }

  __device__ __forceinline__ static bool inside(int y, int x) {
    return threadIdx.y + BY * y < TJ && threadIdx.x + BX * x < TI;
  }

  // `plane`: the offset of the plane's start (tile_plane; 0 in 1-D, 2-D)
  __device__ __forceinline__ void fetch(const float* __restrict__ a, long long plane) {
#pragma unroll
    for (int y = 0; y < NY; ++y)
#pragma unroll
      for (int x = 0; x < NX; ++x)
        if (inside(y, x)) v[y][x] = __ldg(a + plane + off[y][x]);
  }

  __device__ __forceinline__ void store(float* buf) const {
#pragma unroll
    for (int y = 0; y < NY; ++y)
#pragma unroll
      for (int x = 0; x < NX; ++x)
        if (inside(y, x))
          buf[(threadIdx.y + BY * y) * TI + threadIdx.x + BX * x] = v[y][x];
  }
};

// tile, 3-D: offset of the CTA's relative plane P, clamped to the array.
template <int R>
__device__ __forceinline__ long long tile_plane(const Dims& d, const Point& p, int P) {
  return ((long long)blockIdx.z * R + d.h2 + (P < p.pmax ? P : p.pmax)) * d.s2;
}

// tile: the thread's row of a box of TI columns, at j offset oj (3-D, `buf`
// the plane's slot of the ring) or relative plane P (2-D); tap oi is row[oi].
template <int TI, int R, int ND>
__device__ __forceinline__ const float* tile_row(const float* buf, int P, int oj,
                                                 int li, int lj) {
  const int y = ND == 3 ? (int)threadIdx.y + oj - lj
              : ND == 2 ? (int)threadIdx.y * R + P - lj : 0;
  return buf + y * TI + (int)threadIdx.x - li;
}

__device__ __forceinline__ void store(float* __restrict__ out, const Dims& d,
                                      const Point& p, int step, float v) {
  if (step < p.steps) out[p.out + step * d.os] = v;
}

// Launch on the caller's stream; returns the launch's cudaError_t so the
// Python wrapper can raise on a refused launch.  A CTA of BX x BY threads
// covers BX x BY x R outputs (3-D), BX x BY*R (2-D) or BX (1-D).
template <int BX, int BY, int R, int ND, typename Kernel, typename... Args>
inline int launch(Kernel kernel, const Dims& d, void* stream, Args... args) {
  const dim3 grid((unsigned)((d.m0 + BX - 1) / BX),
                  ND == 3 ? (unsigned)((d.m1 + BY - 1) / BY)
                          : ND == 2 ? (unsigned)((d.m1 + BY * R - 1) / (BY * R)) : 1u,
                  ND == 3 ? (unsigned)((d.m2 + R - 1) / R) : 1u);
  kernel<<<grid, dim3(BX, BY, 1), 0, (cudaStream_t)stream>>>(d, args...);
  return (int)cudaGetLastError();
}

}  // namespace rs
