// Causal or full GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel (entry
// flash_attention).  With q (B, Sq, H, Dh), k and v (B, Sk, KV, Dh), G = H / KV
// and query head h reading kv head h / G:
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h/G] * scale) v[b, j, h/G]
//
// over the keys j < Sk, and j <= i when causal (the oracle's mask, aligned at
// position 0).  scale is 1/sqrt(Dh) unless the caller gives another (Zamba2's
// shared attention takes (Dh / 2)^-1/2); it is applied in float32 to the
// raw scores, so q is never rescaled in memory.  The running max m,
// normaliser l and accumulator are float32; the output is acc / max(l, 1e-30)
// in the input dtype.  Two instances; the
// wrapper (ops.py::select_instance) picks one from dtype, Dh and layout.
//
// Masks, in both.  Before the exponential, keys j >= Sk are masked always,
// and j > i when causal, with the reference's -1e30 (not -inf).  Ragged Sq
// and Sk are masked, never padded in memory; query rows past Sq are not
// stored.  A row whose keys are all masked in a tile never happens to a row
// below Sq: tile 0 holds key 0, which every row keeps, and the loop starts
// at tile 0.  Only the tiles on the diagonal and those holding keys past Sk
// are masked element by element.
//
// Bound.  At the serving shape (4, 1024, 32, 64) bf16 causal, q, k, v and o
// are 4 x 16.8 MB = 67.1 MB (0.0200 ms at 3.35 TB/s) and the causal work is
// 17.2 GFLOP (0.0174 ms at 989 TFLOP/s, bf16 tensor cores): the function is
// bound by its bytes, and then by the exponentials (one per kept score: the
// special-function units do 16 a clock per SM, about the rate at which the
// tensor cores do the 4 Dh = 256 FLOP of a score at Dh 64).
// At Zamba2-7B's (8, 4096, 32, 224) causal the 1.88 GB of q, k, v and o
// take 0.56 ms and the 1.93 TFLOP of kept products 1.95 ms: bound by the
// products.
//
// 1. flash_tc: bf16 on the tensor cores (Dh 16, 32, 64, 128, 224).  A CTA
//    takes 128 query rows of one (b, h): two consumer warpgroups of 64 rows
//    and a producer warp, which fills a ring of three K/V stages with bulk
//    tensor copies (TMA, swizzled 32/64/128 bytes to the tile's row), signalled
//    on mbarriers, so the copies of later tiles overlap the products of this
//    one.  A row of Dh bf16 is cut into boxes of the widest swizzle span that
//    divides it: Zamba2-7B's Dh 224 (448 bytes, 3.5 spans of 128) takes seven
//    64-byte boxes, so no box reads past the head and the Q tile (56 KB) with
//    three stages of 64-key K and V tiles (28 KB each) fill 225 KB of the
//    227 KB a CTA may hold; P V then runs as seven m64n32 products a k-step,
//    one per box, and O takes 112 registers a thread, so there the producer
//    is a warpgroup that hands its registers to the consumers.  Q K^T is wgmma m64n{64,128}k16 with both operands in shared
//    memory, K read K-major as it lies (key rows, Dh contiguous).  The
//    scores stay in the accumulator's registers: the scale times log2(e)
//    is applied in float32 inside exp2 (q stays an exact bf16 operand), the
//    row max and sum take two __shfl_xor_sync steps across the quad that
//    holds a row, and P is converted to bf16 in place as the A operand of
//    P V from registers.  V is the B operand, read MN-major through wgmma's
//    transpose bit, never transposed in memory.  Each warpgroup runs
//      Q K^T(t); rescale O; P V(t - 1); wait Q K^T(t); softmax(t);
//      wait P V(t - 1); release tile t - 1; P(t) to bf16
//    so the softmax of a tile overlaps the previous tile's P V.  CTAs take
//    the longest causal rows first.  O is normalised, staged as bf16 over
//    the warpgroup's own Q rows and stored as 16-byte rows.
//    Bytes: q, k, v, o once from device memory (67.1 MB at the serving
//    shape); each K/V tile is read once per 128-row query block, from L2.
//    Numerics: the products q.k are exact in their float32 accumulators
//    (bf16 x bf16), summed in float32.  The one operand rounded beyond what
//    the Pallas kernel rounds is P: each p in [0, 1] enters P V as bf16 (8
//    significant bits), a relative error of at most 2^-8 per term; o =
//    sum_j p_j v_j / l with l summed from the float32 p, so the error of o
//    is at most 2^-8 sum_j p_j |v_j| / l <= 2^-8 max |v| (about 0.016 for
//    |v| <= 4), and, the errors of the terms having random signs, about
//    2^-8 / sqrt(3) |o| = 0.2 % of |o| in practice.  The reference test's
//    bf16 tolerance, 6e-2, is not a measure at the scale of o: at the
//    serving shape (standard normal q, k, v) row i averages about i keys
//    and |o| is about 0.05-0.15 for most rows, so 6e-2 would pass a kernel
//    wrong by as much as its outputs.  The card's checks therefore also
//    hold this instance against ref.attention_tiled(round_p=True), which
//    rounds P as it does over the same key tiles, at 4 bf16 ulps of each
//    row's scale and at 1.25 times the norm of that version's own rounding
//    to bf16 (kernels/instances.py).
//
// 2. flash: the float32-arithmetic instance on the CUDA cores, for float32
//    (whose tolerance, 2e-5, is below what TF32 or bf16 tensor cores give)
//    and bf16 with Dh 8.  One CTA of 256 threads per (64-row query tile,
//    b * H + h); the query tile staged once in shared memory as float32,
//    pre-scaled by the scale, and 64-row K/V tiles staged as float32 from
//    tile 0 up to the tile that holds the last query's diagonal.  A thread
//    owns 4 query rows and the key columns tx + 16 c of the 64 x 64 score
//    tile; the row max and sum are reduced over 16 lanes with
//    __shfl_xor_sync; P goes through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace flash {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and key rows of a tile
constexpr int kPLd = kTile + 4;    // row pitch of the P tile
constexpr float kNegInf = -1e30f;  // the reference's mask value

struct Args {
  const void* q;       // (B, Sq, H, Dh), strides q_sb, q_ss, Dh, 1
  const void* k;       // (B, Sk, KV, Dh), strides k_sb, k_ss, Dh, 1
  const void* v;       // (B, Sk, KV, Dh), strides v_sb, v_ss, Dh, 1
  void* o;             // (B, Sq, H, Dh) contiguous
  int Sq, Sk, H, G, causal;
  float scale;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Rows [r0, r0 + kTile) of one head of a (S, ., Dh) operand into dst[r * Ld + d],
// times scale; rows at or past S are zeros.
template <typename T, int Dh, int Ld>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int r0, int S, float scale) {
  for (int idx = threadIdx.x; idx < kTile * Dh; idx += kThreads) {
    const int r = idx / Dh, d = idx - r * Dh;
    dst[r * Ld + d] = (r0 + r < S) ? to_f32(src[(long long)(r0 + r) * ss + d]) * scale : 0.0f;
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  constexpr int kLd = Dh + 4;                 // row pitch of Q, K, V: float4 reads
                                              // of 8 consecutive rows hit 8 banks
  constexpr int kGroups = Dh / 4;             // float4 column groups of a row
  constexpr int kGpt = (kGroups + 15) / 16;   // groups per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sP = sV + kTile * kLd;               // kTile x kPLd

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;     // rows 4 ty .. 4 ty + 3
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / a.H, h = blockIdx.y - b * a.H;
  const int hk = h / a.G;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + (long long)h * Dh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + (long long)hk * Dh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + (long long)hk * Dh;
  T* ob = static_cast<T*>(a.o) + ((long long)b * a.Sq * a.H + h) * Dh;

  stage<T, Dh, kLd>(sQ, qb, a.q_ss, q0, a.Sq, a.scale);

  float m[4], l[4], acc[4][kGpt][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int g = 0; g < kGpt; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][g][e] = 0.0f;
  }

  int n_tiles = (a.Sk + kTile - 1) / kTile;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + kTile, a.Sq) - 1) / kTile + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                           // sK, sV, sP free
    stage<T, Dh, kLd>(sK, kb, a.k_ss, k0, a.Sk, 1.0f);
    stage<T, Dh, kLd>(sV, vb, a.v_ss, k0, a.Sk, 1.0f);
    __syncthreads();

    // scores of rows 4 ty + r against keys tx + 16 c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < Dh; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(sQ + (4 * ty + r) * kLd + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(sK + (tx + 16 * c) * kLd + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float acc_s = s[r][c];
          acc_s = fmaf(qv[r].x, kv[c].x, acc_s);
          acc_s = fmaf(qv[r].y, kv[c].y, acc_s);
          acc_s = fmaf(qv[r].z, kv[c].z, acc_s);
          acc_s = fmaf(qv[r].w, kv[c].w, acc_s);
          s[r][c] = acc_s;
        }
    }

    // mask, then the online softmax; every lane takes part in the shuffles
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 4 * ty + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        if (j >= a.Sk || (a.causal && j > i)) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max16(mx));
      const float corr = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        sP[(4 * ty + r) * kPLd + tx + 16 * c] = p;
        sum += p;
      }
      l[r] = l[r] * corr + row_sum16(sum);
      m[r] = m_new;
#pragma unroll
      for (int g = 0; g < kGpt; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][g][e] *= corr;
    }
    __syncthreads();

    // acc += P @ V on this thread's rows and column groups tx + 16 g
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(sP + (4 * ty + r) * kPLd + j);
#pragma unroll
      for (int g = 0; g < kGpt; ++g) {
        const int grp = tx + 16 * g;
        if (grp < kGroups) {
          float4 vv[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            vv[jj] = *reinterpret_cast<const float4*>(sV + (j + jj) * kLd + 4 * grp);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p[4] = {pv[r].x, pv[r].y, pv[r].z, pv[r].w};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              acc[r][g][0] = fmaf(p[jj], vv[jj].x, acc[r][g][0]);
              acc[r][g][1] = fmaf(p[jj], vv[jj].y, acc[r][g][1]);
              acc[r][g][2] = fmaf(p[jj], vv[jj].z, acc[r][g][2]);
              acc[r][g][3] = fmaf(p[jj], vv[jj].w, acc[r][g][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= a.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + (long long)i * a.H * Dh;
#pragma unroll
    for (int g = 0; g < kGpt; ++g) {
      const int grp = tx + 16 * g;
      if (grp < kGroups) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(orow + 4 * grp + e, acc[r][g][e] / denom);
      }
    }
  }
}

template <int Dh>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(3 * kTile * (Dh + 4) + kTile * kPLd);
}

template <typename T, int Dh>
int launch_as(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<Dh>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kTile - 1) / kTile, B * a.H);
  flash_kernel<T, Dh><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const Args& a, int B, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 8: return launch_as<T, 8>(a, B, stream);
    case 16: return launch_as<T, 16>(a, B, stream);
    case 32: return launch_as<T, 32>(a, B, stream);
    case 64: return launch_as<T, 64>(a, B, stream);
    case 128: return launch_as<T, 128>(a, B, stream);
    case 224: return launch_as<T, 224>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash

// ------------------------------------------------------------------------
// The bf16 tensor-core instance (Dh 16, 32, 64, 128).
// ------------------------------------------------------------------------
namespace flash_tc {

using hopper::desc;

constexpr int kStages = 3;                      // K/V ring
constexpr int kConsumers = 2;                   // warpgroups of 64 query rows
constexpr float kNegInf = -1e30f;               // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* o;    // (B, Sq, H, Dh) contiguous
  int Sq, Sk, H, G, causal, n_qtiles, bh;
  float scale_log2;    // the scores' scale (Dh^-1/2 by default) * log2(e)
};

// A CTA: two consumer warpgroups of 64 query rows each and one producer
// warp; key tiles of kN rows.  Past Dh 128 the producer is a whole
// warpgroup that gives its registers to the consumers (setmaxnreg): a
// consumer holds O (Dh / 2 registers), the scores and P, 160 at Dh 224,
// and 288 threads a CTA would leave it 168 (allocated as 12 warps), which
// spills and serializes the wgmma.
template <int Dh, int kN>
struct Layout {
  static constexpr int rows = 64 * kConsumers;              // query rows of a CTA
  static constexpr bool wide = Dh > 128;                    // a producer warpgroup
  static constexpr int threads = 128 * kConsumers + (wide ? 128 : 32);
  // bytes of a box row: the widest swizzle span (128, 64 or 32) dividing a row
  static constexpr int swz = (Dh * 2) % 128 == 0 ? 128 : (Dh * 2) % 64 == 0 ? 64 : 32;
  static constexpr int boxes = Dh * 2 / swz;                // column boxes of a row
  static constexpr int q_box = rows * swz;                  // bytes of a Q box
  static constexpr int kv_box = kN * swz;                   // bytes of a K or V box
  static constexpr int q_bytes = boxes * q_box;
  static constexpr int kv_bytes = boxes * kv_box;           // one K or V tile
  static constexpr int smem = 1024 + q_bytes + 2 * kStages * kv_bytes;
};

// Tiles of kN keys the query rows [r0, r1) need: up to the diagonal when causal.
__device__ __forceinline__ int tiles_for(int r0, int r1, int Sk, int causal, int kN) {
  if (r0 >= r1) return 0;
  const int all = (Sk + kN - 1) / kN;
  return causal ? min(all, (r1 - 1) / kN + 1) : all;
}

// One consumer warpgroup: its registers and the steps of its loop over key
// tiles.  The loop (in the kernel) overlaps the softmax of tile kt with the
// P V product of tile kt - 1:
//
//   Q K^T(kt) ; rescale O ; P V(kt - 1) ; wait Q K^T(kt) ; softmax(kt) ;
//   wait P V(kt - 1) ; release tile kt - 1 ; P(kt) to bf16
//
// Each wait names a fixed number of products left in flight, so the
// compiler can see which registers are ready and adds no waits of its own.
template <int Dh, int kN>
struct Consumer {
  using L = Layout<Dh, kN>;
  static constexpr int swz = L::swz;
  static constexpr int kS = kN / 2;               // score registers per thread
  static constexpr int kNB = swz / 2;            // N of one p.v product: one box
  static constexpr int kNBlocks = Dh / kNB;       // p.v products per k-step
  static constexpr int kAccO = Dh / 2;            // output registers per thread

  float S[kS], o[kAccO];
  uint32_t pa[kN / 16][4];     // P in bf16: the A operand of P V
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;
  float corr_lo = 1.0f, corr_hi = 1.0f;
  uint8_t *q, *k, *v;          // this warpgroup's Q rows; the K and V rings
  uint64_t *k_full, *v_full, *empty;
  int Sk, causal;
  float c;                     // the scale times log2(e)
  int first_row, row_lo, row_hi, lane;

  __device__ __forceinline__ Consumer(uint8_t* q_, uint8_t* k_, uint8_t* v_, uint64_t* kf,
                                      uint64_t* vf, uint64_t* em, const Params& a,
                                      int first_row_, int r, int lane_)
      : q(q_), k(k_), v(v_), k_full(kf), v_full(vf), empty(em), Sk(a.Sk),
        causal(a.causal), c(a.scale_log2), first_row(first_row_), row_lo(first_row_ + r),
        row_hi(first_row_ + r + 8), lane(lane_) {
#pragma unroll
    for (int i = 0; i < kAccO; ++i) o[i] = 0.0f;
  }

  // S = Q K^T(kt) on the tensor cores, both operands K-major in shared memory
  __device__ __forceinline__ void qk(int kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&k_full[s], (kt / kStages) & 1);
    uint8_t* tile = k + s * L::kv_bytes;
    hopper::fence_regs<kS>(S);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const int bx = kk * 32 / swz, off = kk * 32 % swz;
      const uint64_t dq = desc<swz, false>(q + bx * L::q_box + off);
      const uint64_t dk = desc<swz, false>(tile + bx * L::kv_box + off);
      if constexpr (kN == 128) hopper::wgmma_ss_n128<0, 0>(S, dq, dk, kk > 0);
      else hopper::wgmma_ss_n64<0, 0>(S, dq, dk, kk > 0);
    }
    hopper::wgmma_commit();
  }

  // O += P V(kt), V MN-major in shared memory (read through the transpose bit)
  __device__ __forceinline__ void pv(int kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&v_full[s], (kt / kStages) & 1);
    uint8_t* tile = v + s * L::kv_bytes;
    hopper::fence_regs<kAccO>(o);
    hopper::fence_regs_u32<kN / 4>(&pa[0][0]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks) {
#pragma unroll
      for (int nb = 0; nb < kNBlocks; ++nb) {
        const uint64_t dv = desc<swz, true>(tile + nb * L::kv_box + ks * 16 * swz);
        if constexpr (kNB == 64) hopper::wgmma_rs_n64<1>(o + 32 * nb, pa[ks], dv, 1);
        else if constexpr (kNB == 32) hopper::wgmma_rs_n32<1>(o + 16 * nb, pa[ks], dv, 1);
        else hopper::wgmma_rs_n16<1>(o + 8 * nb, pa[ks], dv, 1);
      }
    }
    hopper::wgmma_commit();
  }

  // Mask (diagonal and ragged tiles only) before the exponential, with the
  // reference's -1e30; the online softmax on raw scores, scaled by the
  // scale times log2(e) in float32 inside exp2.  Leaves p in S (float32) and
  // the factor that O must be rescaled by in corr.
  __device__ __forceinline__ void softmax(int kt) {
    hopper::fence_regs<kS>(S);
    const int k0 = kt * kN;
    if (k0 + kN > Sk || (causal && k0 + kN - 1 > first_row)) {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int j = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int row = (i / 2) % 2 ? row_hi : row_lo;
        if (j >= Sk || (causal && j > row)) S[i] = kNegInf;
      }
    }
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      if ((i / 2) % 2) mx_hi = fmaxf(mx_hi, S[i]); else mx_lo = fmaxf(mx_lo, S[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // a row with every key so far masked keeps p = 0 (never a row below Sq:
    // tile 0 holds key 0, which every row keeps)
    const float mc_lo = mx_lo == kNegInf ? 0.0f : mx_lo * c;
    const float mc_hi = mx_hi == kNegInf ? 0.0f : mx_hi * c;
    corr_lo = hopper::exp2_approx(m_lo * c - mc_lo);
    corr_hi = hopper::exp2_approx(m_hi * c - mc_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const float p = hopper::exp2_approx(fmaf(S[i], c, (i / 2) % 2 ? -mc_hi : -mc_lo));
      S[i] = p;
      if ((i / 2) % 2) sum_hi += p; else sum_lo += p;
    }
    l_lo = l_lo * corr_lo + sum_lo;        // per-thread partial sums; the quad
    l_hi = l_hi * corr_hi + sum_hi;        // adds them up once, at the end
  }

  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int i = 0; i < kAccO; ++i) o[i] *= (i / 2) % 2 ? corr_hi : corr_lo;
  }

  // P to bf16 in place: the A operand of P V, from registers
  __device__ __forceinline__ void pack() {
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[ks][j] = hopper::pack_bf16(S[8 * ks + 2 * j], S[8 * ks + 2 * j + 1]);
  }

  // P V(kt) has completed: its A registers may change and its stage is free
  __device__ __forceinline__ void release(int kt) {
    hopper::fence_regs<kAccO>(o);
    hopper::fence_regs_u32<kN / 4>(&pa[0][0]);
    if (lane == 0) hopper::mbar_arrive(&empty[kt % kStages]);
  }
};

template <int Dh, int kN>
__global__ void __launch_bounds__(Layout<Dh, kN>::threads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, Params a) {
  using L = Layout<Dh, kN>;
  constexpr int swz = L::swz;
  constexpr int kAccO = Dh / 2;               // output registers per thread

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + L::q_bytes;                 // kStages tiles
  uint8_t* sV = sK + kStages * L::kv_bytes;      // kStages tiles

  const int tid = threadIdx.x;
  // CTAs start in the order of their index: the longest causal rows of
  // every (b, h) first, the shortest last, so the last wave is short
  const int bh = (int)blockIdx.x % a.bh, qt = a.n_qtiles - 1 - (int)blockIdx.x / a.bh;
  const int q0 = qt * L::rows;
  const int b = bh / a.H, h = bh - b * a.H;
  const int hk = h / a.G;
  // every warpgroup's last row decides the tiles of the CTA
  const int n_cta = tiles_for(q0, min(q0 + L::rows, a.Sq), a.Sk, a.causal, kN);

  if (tid == 0) {
    hopper::mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kConsumers);   // lane 0 of every consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {
    // ---- producer warp: Q once, then K and V tiles through the ring ----
    if constexpr (L::wide) hopper::setmaxnreg_dec<40>();
    if (tid == 128 * kConsumers) {
      hopper::mbar_expect_tx(&q_full, L::q_bytes);
#pragma unroll
      for (int bx = 0; bx < L::boxes; ++bx)
        hopper::tma_load_4d(sQ + bx * L::q_box, &tq, &q_full, bx * (swz / 2), h, q0, b);
      for (int t = 0; t < n_cta; ++t) {
        const int s = t % kStages;
        if (t >= kStages) hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        hopper::mbar_expect_tx(&k_full[s], L::kv_bytes);
#pragma unroll
        for (int bx = 0; bx < L::boxes; ++bx)
          hopper::tma_load_4d(sK + s * L::kv_bytes + bx * L::kv_box, &tk, &k_full[s],
                              bx * (swz / 2), hk, t * kN, b);
        hopper::mbar_expect_tx(&v_full[s], L::kv_bytes);
#pragma unroll
        for (int bx = 0; bx < L::boxes; ++bx)
          hopper::tma_load_4d(sV + s * L::kv_bytes + bx * L::kv_box, &tv, &v_full[s],
                              bx * (swz / 2), hk, t * kN, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup w: query rows q0 + 64 w .. q0 + 64 w + 63 ----
  if constexpr (L::wide) hopper::setmaxnreg_inc<232>();
  // the warpgroup index through a shuffle: a value the compiler knows to be
  // uniform over the warp, so it does not serialize the products that
  // depend on it
  const int w = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  Consumer<Dh, kN> c(sQ + w * 64 * swz, sK, sV, k_full, v_full, empty, a, q0 + 64 * w,
                         16 * warp + lane / 4, lane);

  // Every warpgroup walks the CTA's n_cta tiles (a tile above a warpgroup's
  // diagonal is masked whole and adds nothing), and they take turns to
  // issue their products (barriers 3 + w): one warpgroup's products run
  // while the other takes its softmax.
  auto turn_wait = [&] { hopper::named_sync(3 + w, 256); };
  auto turn_pass = [&] { hopper::named_arrive(4 - w, 256); };
  if (w == 1) hopper::named_arrive(3, 256);   // warpgroup 0 goes first
  hopper::mbar_wait(&q_full, 0);
  if (n_cta > 0) {
    turn_wait();
    c.qk(0);
    turn_pass();
    hopper::wgmma_wait<0>();
    c.softmax(0);
    c.pack();
    for (int kt = 1; kt < n_cta; ++kt) {
      turn_wait();
      c.qk(kt);
      c.rescale();
      c.pv(kt - 1);
      turn_pass();
      hopper::wgmma_wait<1>();             // Q K^T(kt) done
      c.softmax(kt);
      hopper::wgmma_wait<0>();             // P V(kt - 1) done
      c.release(kt - 1);
      c.pack();
    }
    turn_wait();
    c.rescale();
    c.pv(n_cta - 1);
    turn_pass();
    hopper::wgmma_wait<0>();
    c.release(n_cta - 1);
  }
  if (w == 0) turn_wait();                  // warpgroup 1's last turn
  float l_lo = c.l_lo, l_hi = c.l_hi;
  const int first_row = q0 + 64 * w;

  // normalise, stage this warpgroup's 64 x Dh bf16 tile over its own Q rows
  // (16-byte chunks XOR-swizzled by row against bank conflicts), then store
  // 16-byte vectors of the rows below Sq
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f), inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);
  constexpr int kChunks = swz / 16;                  // 16-byte chunks of a staged row
  auto stage_addr = [&](int r, int col) -> uint8_t* {  // col in bf16 elements
    const int byte = col * 2, bx = byte / swz, in = byte % swz;
    const int chunk = (in / 16) ^ (r % kChunks);
    return sQ + bx * L::q_box + (w * 64 + r) * swz + chunk * 16 + in % 16;
  };
#pragma unroll
  for (int i = 0; i < kAccO; i += 2) {
    const int r = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    const float inv = (i / 2) % 2 ? inv_hi : inv_lo;
    *reinterpret_cast<uint32_t*>(stage_addr(r, col)) = hopper::pack_bf16(c.o[i] * inv, c.o[i + 1] * inv);
  }
  hopper::warpgroup_sync(1 + w);
  constexpr int kRowChunks = Dh / 8;                 // 16-byte chunks of an output row
  for (int idx = t; idx < 64 * kRowChunks; idx += 128) {
    const int r = idx / kRowChunks, ch = idx % kRowChunks;
    const int row = first_row + r;
    if (row < a.Sq) {
      const uint4 val = *reinterpret_cast<const uint4*>(stage_addr(r, 8 * ch));
      *reinterpret_cast<uint4*>(a.o + (((long long)b * a.Sq + row) * a.H + h) * Dh + 8 * ch) = val;
    }
  }
}

template <int Dh, int kN>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st,
           int B, int KV, Params p, cudaStream_t stream) {
  using L = Layout<Dh, kN>;
  CUtensorMap tq, tk, tv;
  const uint64_t eb = 2;
  const uint32_t qbox[4] = {(uint32_t)L::swz / 2, 1, (uint32_t)L::rows, 1};
  const uint32_t kbox[4] = {(uint32_t)L::swz / 2, 1, (uint32_t)kN, 1};
  const uint64_t qd[4] = {(uint64_t)Dh, (uint64_t)p.H, (uint64_t)p.Sq, (uint64_t)B};
  const uint64_t kd[4] = {(uint64_t)Dh, (uint64_t)KV, (uint64_t)p.Sk, (uint64_t)B};
  const uint64_t qs[3] = {Dh * eb, st[1] * eb, st[0] * eb};
  const uint64_t ks[3] = {Dh * eb, st[3] * eb, st[2] * eb};
  const uint64_t vs[3] = {Dh * eb, st[5] * eb, st[4] * eb};
  int err = hopper::tensor_map_bf16(&tq, q, qd, qs, qbox, L::swz);
  if (!err) err = hopper::tensor_map_bf16(&tk, k, kd, ks, kbox, L::swz);
  if (!err) err = hopper::tensor_map_bf16(&tv, v, kd, vs, kbox, L::swz);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel<Dh, kN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::smem);
  if (e != cudaSuccess) return (int)e;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.n_qtiles = (p.Sq + L::rows - 1) / L::rows;
  p.bh = B * p.H;
  flash_wgmma_kernel<Dh, kN><<<p.n_qtiles * p.bh, L::threads, L::smem, stream>>>(
      tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace flash_tc

// dtype: 0 float32, 1 bfloat16.  strides: q_sb, q_ss, k_sb, k_ss, v_sb, v_ss
// (elements).  dims: B, Sq, Sk, H, KV, Dh.  scale: the scores' factor, 0 for
// 1/sqrt(Dh).  Returns the cudaError_t.
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v,
                                      void* o, const long long* strides,
                                      const int* dims, int dtype, int causal,
                                      float scale, void* stream) {
  flash::Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.k_sb = strides[2];
  a.k_ss = strides[3]; a.v_sb = strides[4]; a.v_ss = strides[5];
  const int B = dims[0], KV = dims[4], Dh = dims[5];
  a.Sq = dims[1]; a.Sk = dims[2]; a.H = dims[3];
  a.causal = causal;
  if (B < 1 || a.Sq < 1 || a.Sk < 1 || KV < 1 || a.H % KV || (long long)B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  a.G = a.H / KV;
  a.scale = scale > 0.0f ? scale : 1.0f / sqrtf((float)Dh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return flash::launch_dh<float>(a, B, Dh, st);
  if (dtype == 1) return flash::launch_dh<__nv_bfloat16>(a, B, Dh, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core instance: q, k, v bfloat16 with Dh 16, 32, 64, 128 or
// 224, every stride a multiple of 8 elements and every base 16-byte aligned.
// Arguments as above.  Returns the cudaError_t.
extern "C" int launch_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                            void* o, const long long* strides,
                                            const int* dims, int causal, float scale,
                                            void* stream) {
  const int B = dims[0], KV = dims[4], Dh = dims[5];
  flash_tc::Params p;
  p.o = nullptr;
  p.Sq = dims[1]; p.Sk = dims[2]; p.H = dims[3];
  p.causal = causal;
  if (B < 1 || p.Sq < 1 || p.Sk < 1 || KV < 1 || p.H % KV || (long long)B * p.H > 65535)
    return (int)cudaErrorInvalidValue;
  p.G = p.H / KV;
  p.scale_log2 = scale > 0.0f ? flash_tc::kLog2e * scale : flash_tc::kLog2e / sqrtf((float)Dh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return flash_tc::launch<16, 128>(q, k, v, o, strides, B, KV, p, st);
    case 32: return flash_tc::launch<32, 128>(q, k, v, o, strides, B, KV, p, st);
    case 64: return flash_tc::launch<64, 128>(q, k, v, o, strides, B, KV, p, st);
    case 128: return flash_tc::launch<128, 64>(q, k, v, o, strides, B, KV, p, st);
    case 224: return flash_tc::launch<224, 64>(q, k, v, o, strides, B, KV, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
