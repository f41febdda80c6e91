// Causal or full GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel (entry
// flash_attention).  With q (B, Sq, H, Dh), k and v (B, Sk, KV, Dh), G = H / KV
// and query head h reading kv head h / G:
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(Dh)) v[b, j, h/G]
//
// over the keys j < Sk, and j <= i when causal (the oracle's mask, aligned at
// position 0).  The running max m, normaliser l and accumulator are float32;
// the output is acc / max(l, 1e-30) in the input dtype, float32 or bfloat16.
//
// Design.  The TPU kernel runs a grid of (B, KV, q-block) in order on one core
// and keeps a (128, 512) score tile in VMEM.  A CTA on Hopper has at most
// 227 KB of shared memory and blocks run in no order, so the work is cut finer:
// one CTA of 256 threads per (64-row query tile, b * H + h), which gives
// 16 x 128 = 2048 CTAs at the serving shape (B 4, S 1024, H 32).  The CTA
// stages its query tile once in shared memory as float32, pre-scaled by
// Dh^-1/2, and loops over 64-row key/value tiles from tile 0 up to the tile
// that holds its last query's diagonal, each staged as float32.  A thread owns
// 4 query rows and the key columns tx, tx + 16, tx + 32, tx + 48 of the 64 x 64
// score tile; the row max and row sum are reduced over the 16 lanes that share
// the rows with __shfl_xor_sync.  P goes through shared memory, and each thread
// adds P @ V into its 4 rows and its float4 column groups of the output.
//
// Masks.  Before expf, keys j >= Sk are masked always, and j > i when causal,
// with the reference's -1e30 (not -inf).  Ragged Sq and Sk are masked, never
// padded in memory: staged rows past Sq or Sk are zeros, and query rows past
// Sq are not stored.  With -1e30 a row whose keys are all masked in a tile gets
// p = exp(0) = 1; it never happens to a real row, since tile 0 holds key 0,
// which every row keeps, and the loop always starts at tile 0, so a later
// fully masked tile only meets a finite m and gives p = 0.
//
// Bound.  At the serving shape in bf16, q, k, v and o are 4 x 16.8 MB = 67.1 MB
// (0.0200 ms at 3.35 TB/s) and the causal work is 17.2 GFLOP (0.0174 ms at the
// bf16 tensor-core rate), so the function is bound by its bytes.  This first
// version multiplies on the float32 CUDA cores, the Pallas kernel's own
// arithmetic, and skips the tiles above the diagonal; bf16 tensor cores
// (mma.sync / wgmma, a bf16 P for P @ V) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash

// dtype: 0 float32, 1 bfloat16.  strides: q_sb, q_ss, k_sb, k_ss, v_sb, v_ss
// (elements).  dims: B, Sq, Sk, H, KV, Dh.  Returns the cudaError_t.
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v,
                                      void* o, const long long* strides,
                                      const int* dims, int dtype, int causal,
                                      void* stream) {
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
  a.scale = 1.0f / sqrtf((float)Dh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return flash::launch_dh<float>(a, B, Dh, st);
  if (dtype == 1) return flash::launch_dh<__nv_bfloat16>(a, B, Dh, st);
  return (int)cudaErrorInvalidValue;
}
