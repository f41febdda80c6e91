// Mamba-2 SSD chunked scan, its gradient, for Hopper (sm_90a).
//
// Compiled after ssd.cu in one translation unit (ops.py::build_kernel): it
// launches that file's pass a (ssd_tc::states_kernel) to recompute what the
// forward kept in scratch.  No TPU kernel has a backward: the JAX package
// trains by differentiating the Pallas kernel's jnp oracle, and the port did
// so through kernels/autograd.py::PlainGrad, PyTorch autograd of a float32
// recompute of ref.ssd_chunked, a Python loop over the chunks whose products
// and (B, Q, Q, H) float32 intermediates took 24.5-27 ms a call at Mamba-2's
// training shape on an H100 (700 W).  This backward replaces PlainGrad for
// the bf16 tensor-core instance (ops.py::select_instance): 1.11 ms a call
// there, 6.3 % of the bound below.
//
// For one (batch, head) and chunk c of Q positions, with cum the inclusive
// prefix sum of dt A over the chunk, total its last row, S_c the state
// entering the chunk, G_{c+1} the cotangent of the state leaving it (the
// final state's cotangent, or 0, for the last chunk), decay_ij =
// exp(cum_i - cum_j) for i >= j (else 0), P_ij = C_i . B_j, R_ij = dy_i . x_j:
//
//   G_c   = exp(total_c) G_{c+1} + sum_i exp(cum_i) C_i^T dy_i      (reverse carry)
//   dx_j  = dt_j [ sum_i P_ij decay_ij dy_i + exp(total - cum_j) B_j G_{c+1} ]
//   ddt_j = sum_i P_ij decay_ij R_ij + exp(total - cum_j) (B_j G_{c+1}) . x_j
//           + A rc_j                                                  (direct + via cum)
//   W_ij  = sum_heads R_ij decay_ij dt_j
//   dB_j  = sum_i W_ij C_i + sum_heads exp(total - cum_j) dt_j G_{c+1} x_j
//   dC_i  = sum_j W_ij B_j + sum_heads exp(cum_i) S_c dy_i
//   dcum_k = sum_j P_kj decay_kj R_kj dt_j + exp(cum_k) C_k S_c dy_k
//            - dt_k (ddt_k's direct term) + [k = Q - 1] <G_{c+1}, S_{c+1}>
//   rc_j  = sum_{k >= j} dcum_k (within the chunk),  dA = sum dt_j rc_j
//
// ref.ssd_passes_bwd is the same factoring in plain PyTorch.
//
// Bound.  At Mamba-2's training shape (B 4, L 2048, H 64, P 64, N 128,
// Q 256, bf16) the gradient reads x, dt, A, B, C and dy and writes their
// gradients: 214 MB, 0.064 ms at 3.35 TB/s; its products, two for each of
// the forward's, are 69.8 GFLOP, 0.0706 ms at the bf16 tensor-core rate.
// Bound by operations (portbench/rooflines.py::ssd_bwd_bound_s).
//
// Eight kernels a call, on the stream, one after the other; every product
// runs on the tensor cores with mma.sync m16n8k16 (bf16 in, float32
// accumulators) from tiles staged in shared memory by cp.async, 128-byte
// rows with their 16-byte chunks XOR-swizzled by row, read with ldmatrix;
// x, B and C are read as they lie (strided views of the conv output).
//   a. ssd_tc::states_kernel, the forward's pass a: cum and dt per chunk, and
//      the state each chunk adds, dS_c (B, nc, H, N, P) float32.
//   b. dstate_kernel, CTA (8 heads, chunk, batch): dG_c = C_c^T (exp(cum) dy_c)
//      per head, N x P over K = Q; the next head's dy is in flight meanwhile.
//   c. carry_kernel, CTA (head, batch, 1024 elements of the state), float32
//      registers: S_c forward over the chunks, then G back over them, each
//      written as bf16 hi + lo for the products; <G_{c+1}, S_{c+1}> per
//      chunk and slice.
//   d. state_bwd_kernel, CTA (16 heads, chunk and 64-row tile T, batch), the
//      heads double-buffered: per head B_T G (dx's state term, written
//      float32, and ddt's), x_T G^T and dy_T S_c^T (dB's and dC's state
//      terms, summed over the CTA's heads; U = exp(cum) C . S_c dy).
//   e. scan_bwd_kernel, CTA (16 heads, chunk, batch, 64-row column tile J),
//      the longest (J = 0) launched first, the heads double-buffered:
//      P_JI = B_J C_I^T for I >= J once for the heads (one B/C group); per
//      head R_JI = x_J dy_I^T, the decayed scores and W in registers,
//      dx_J += (P decay)_JI dy_I; ddt's direct term and dx complete, the row
//      sums of P decay R dt per tile J, and W summed over the CTA's heads.
//   f. bc_kernel, CTA (64-row tile, chunk, batch): dB and dC from W summed
//      over the head groups, plus the state terms, in bf16.
//   g. finish_kernel, CTA (head, batch): dcum, its reverse prefix sum per
//      chunk, ddt, and dA's part of the batch row; h. da_kernel sums dA.
// Every sum across CTAs is a second pass in a fixed order, never an atomic:
// two runs give the same gradients bit for bit.  Scratch: about 0.5 GB at
// the training shape (the chunk states and their cotangents twice, dx's
// state term in float32, W by head group), from the caller.
//
// Numerics, the forward's rules.  x, B, C and dy, bf16 tensors of the model,
// go to the tensor cores as they are: C B^T and dy x^T are exact in float32.
// Each float32 operand of a bf16 product is split into bf16 hi + lo (about
// 16 significant bits), as the forward splits its scores and entering
// state: the decayed scores P decay, W, G, S_c and exp(cum) dy.  The only
// operand rounded to one bf16 is the forward's own: w x in pass a, which
// recomputes the chunk states as the forward does (dt and the decays scale
// the backward's products after they are formed).  cum, dt, A and every
// gradient of them stay float32; dx, dB and dC are rounded to bf16 once, at
// the end, as their inputs' dtype.  ref.ssd_passes_bwd(round_operands=True)
// rounds what these kernels round; the card's tests hold them to it.

namespace ssd_bwd {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* x;   // (B, L, H, P), strides x_sb, x_sl, P, 1
  const __nv_bfloat16* Bm;  // (B, L, 1, N), strides b_sb, b_sl, -, 1
  const __nv_bfloat16* Cm;  // (B, L, 1, N), strides c_sb, c_sl, -, 1
  const __nv_bfloat16* dy;  // (B, L, H, P) contiguous
  const float* A;           // (H,)
  const float* d_final;     // (B, H, N, P) or null: the final state's cotangent
  float* cum;               // (B, H, nc, Q), from pass a
  float* dtc;               // (B, H, nc, Q), from pass a
  float* dS;                // (B, nc, H, N, P): the state chunk c adds (pass a)
  float* dG;                // (B, nc, H, N, P): sum_i exp(cum_i) C_i^T dy_i
  __nv_bfloat16* S;         // (B, nc, H, 2, N, P): S_c as bf16 hi, lo
  __nv_bfloat16* G;         // (B, nc, H, 2, N, P): G_{c+1} as bf16 hi, lo
  float* dots;              // (B, H, nc, NP / 1024): <G_{c+1}, S_{c+1}> by slices
  float* dAp;               // (B, H): dA by batch
  float* dxs;               // (B, L, H, P): dt_j exp(total - cum_j) B_j G
  float* ddts;              // (B, H, L): exp(total - cum_j) (B_j G) . x_j
  float* U;                 // (B, H, L): exp(cum_i) C_i . S_c dy_i
  float* ddtd;              // (B, H, L): ddt's direct term
  float* dBs;               // (H / hs, B, L, N): dB's state term by head group
  float* dCs;               // (H / hs, B, L, N): dC's state term by head group
  float* rowT;              // (B, H, nc, Q / 64, Q): sum_{j in tile J} T_ij
  float* W;                 // (H / hs, B, nc, Q / 64, Q / 64, 64, 64): W(I, J)[j][i]
  __nv_bfloat16* dx;        // (B, L, H, P)
  float* ddt;               // (B, L, H)
  float* dA;                // (H,)
  __nv_bfloat16* dB;        // (B, L, N)
  __nv_bfloat16* dC;        // (B, L, N)
  int Bsz, L, H, N, Q, nc;
  int hs_dstate, hs;        // heads per CTA of kernel b, and of kernels d and e
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

// ---------------------------------------------------------------- helpers

// d (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16).  Per thread t of
// the warp, g = t / 4, q = t % 4: a holds (row g, cols 2q, 2q + 1), (row
// g + 8, same), (row g, cols 2q + 8, + 9), (row g + 8, same); b holds (rows
// 2q, 2q + 1, col g) and (rows 2q + 8, + 9, col g); d holds (row g, cols 2q,
// 2q + 1) and (row g + 8, same).  So an accumulator's columns 16 k .. 16 k +
// 15, two n-tiles, are the a fragment of k-step k, with no data movement.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  The transposed form gives each thread the
// transpose's elements.
__device__ __forceinline__ void ldsm(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of bf16 element (r, col) of a tile in shared memory: blocks of
// 64 columns, each `rows` rows of 128 bytes, the 16-byte chunk k of row r
// stored at chunk k ^ (r % 8), so that eight consecutive rows' reads of one
// chunk (an ldmatrix phase) fall on distinct banks.
__device__ __forceinline__ uint32_t swz(int r, int col, int rows) {
  return (uint32_t)((((col >> 6) * rows + r) << 7) + ((((col >> 3) & 7) ^ (r & 7)) << 4) +
                    ((col & 7) << 1));
}

// Lane offsets of ldmatrix reads (lane l, as the mma's fragments want them).
// a fragment (rows m0.., cols k0..) of a tile stored rows m, cols k:
__device__ __forceinline__ uint32_t a_rows(int m0, int k0, int rows, int lane) {
  return swz(m0 + (lane & 15), k0 + ((lane >> 4) << 3), rows);
}
// a fragment of a tile stored rows k, cols m (transposed read):
__device__ __forceinline__ uint32_t a_cols(int m0, int k0, int rows, int lane) {
  return swz(k0 + (lane & 7) + ((lane >> 4) << 3), m0 + (((lane >> 3) & 1) << 3), rows);
}
// b fragments of n-tiles n0, n0 + 8 from a tile stored rows n, cols k
// (registers 0, 1: n-tile n0; 2, 3: n0 + 8):
__device__ __forceinline__ uint32_t b_rows(int n0, int k0, int rows, int lane) {
  return swz(n0 + (lane & 7) + ((lane >> 4) << 3), k0 + (((lane >> 3) & 1) << 3), rows);
}
// the same from a tile stored rows k, cols n (transposed read):
__device__ __forceinline__ uint32_t b_cols(int n0, int k0, int rows, int lane) {
  return swz(k0 + (lane & 7) + (((lane >> 3) & 1) << 3), n0 + ((lane >> 4) << 3), rows);
}

// A float32 pair as bf16 hi + lo pairs.
__device__ __forceinline__ void split(float u, float v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = hopper::pack_bf16(u - f.x, v - f.y);
}

__device__ __forceinline__ float2 bf2(const uint8_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// `rows` rows of `cols` bf16 (a multiple of 64) from src (row stride ld
// elements) into a tile, by cp.async; the caller commits and waits.
__device__ __forceinline__ void stage_bf16(uint8_t* tile, const __nv_bfloat16* src,
                                           long long ld, int rows, int cols) {
  const int chunks = cols >> 3;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, k = idx - r * chunks;
    cp16(tile + swz(r, 8 * k, rows), src + r * ld + 8 * k);
  }
}

// A float32 rows x 64 row-major block as bf16 hi and lo tiles.
__device__ __forceinline__ void stage_split(uint8_t* hi, uint8_t* lo, const float* src, int rows) {
  for (int idx = threadIdx.x; idx < rows * 8; idx += kThreads) {
    const int r = idx >> 3, k = idx & 7;
    const float4 u = *reinterpret_cast<const float4*>(src + r * 64 + 8 * k);
    const float4 v = *reinterpret_cast<const float4*>(src + r * 64 + 8 * k + 4);
    uint4 h, l;
    split(u.x, u.y, h.x, l.x);
    split(u.z, u.w, h.y, l.y);
    split(v.x, v.y, h.z, l.z);
    split(v.z, v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + swz(r, 8 * k, rows)) = h;
    *reinterpret_cast<uint4*>(lo + swz(r, 8 * k, rows)) = l;
  }
}

// Sum over the four lanes of a row (t % 4) or the eight of a column (t / 4).
__device__ __forceinline__ float sum_quad(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float sum_octet(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// ---- b: dG_c = C_c^T (exp(cum) dy_c) per head ------------------------------
// CTA (head group, chunk c, batch b), eight warps over the N x 64 output: warp
// w rows 16 (w % (N / 16)), and all 64 columns (N 128) or half (N 64).  C_c
// (Q x N) is staged once; per head, exp(cum_i) dy_i is formed from device
// memory into bf16 hi and lo tiles (Q x 64); the product runs over K = Q,
// both operands read transposed (C as stored is rows i, cols n).
template <int kQT, int kNT>
__global__ void __launch_bounds__(kThreads, 1) dstate_kernel(Args a) {
  constexpr int Q = 64 * kQT, N = 64 * kNT, RG = N / 16, CS = 8 / RG, NT = 8 / CS;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sC = smem;                   // Q x N
  uint8_t* sVh = sC + Q * N * 2;        // Q x 64
  uint8_t* sVl = sVh + Q * 128;
  const int c = blockIdx.y, b = blockIdx.z, l0 = c * Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int m0 = 16 * (warp % RG), p0 = (64 / CS) * (warp / RG);
  stage_bf16(sC, a.Cm + b * a.c_sb + (long long)l0 * a.c_sl, a.c_sl, Q, N);
  cp_commit();
  const uint32_t uC = hopper::smem_u32(sC), uVh = hopper::smem_u32(sVh),
                 uVl = hopper::smem_u32(sVl);

  // this thread's 16-byte chunks of dy and their rows' cum, a head ahead
  constexpr int kPre = Q * 8 / kThreads;
  uint4 pre[kPre];
  float pcum[kPre];
  auto fetch = [&](int k) {
    const int h = blockIdx.x * a.hs_dstate + k;
    const float* cum = a.cum + (((long long)b * a.H + h) * a.nc + c) * Q;
    const __nv_bfloat16* dyp = a.dy + ((long long)b * a.L + l0) * a.H * 64 + (long long)h * 64;
#pragma unroll
    for (int m = 0; m < kPre; ++m) {
      const int idx = m * kThreads + tid, i = idx >> 3, kc = idx & 7;
      pre[m] = *reinterpret_cast<const uint4*>(dyp + (long long)i * a.H * 64 + 8 * kc);
      pcum[m] = cum[i];
    }
  };
  fetch(0);
  for (int k = 0; k < a.hs_dstate; ++k) {
    const int h = blockIdx.x * a.hs_dstate + k;
    __syncthreads();                                // the last head's products are done
#pragma unroll
    for (int m = 0; m < kPre; ++m) {
      const int idx = m * kThreads + tid, i = idx >> 3, kc = idx & 7;
      const float e = expf(pcum[m]);
      const uint32_t* u = reinterpret_cast<const uint32_t*>(&pre[m]);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[s]));
        split(f.x * e, f.y * e, hi[s], lo[s]);
      }
      *reinterpret_cast<uint4*>(sVh + swz(i, 8 * kc, Q)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sVl + swz(i, 8 * kc, Q)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if (k + 1 < a.hs_dstate) fetch(k + 1);          // in flight during the products
    cp_wait<0>();
    __syncthreads();
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll 4
    for (int ks = 0; ks < Q / 16; ++ks) {
      uint32_t af[4];
      ldsm_t(af, uC + a_cols(m0, 16 * ks, Q, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bh[4], bl[4];
        const uint32_t off = b_cols(p0 + 16 * np, 16 * ks, Q, lane);
        ldsm_t(bh, uVh + off);
        ldsm_t(bl, uVl + off);
        mma(acc[2 * np], af, bh[0], bh[1]);
        mma(acc[2 * np], af, bl[0], bl[1]);
        mma(acc[2 * np + 1], af, bh[2], bh[3]);
        mma(acc[2 * np + 1], af, bl[2], bl[3]);
      }
    }
    float* out = a.dG + (((long long)b * a.nc + c) * a.H + h) * N * 64;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int p = p0 + 8 * n + 2 * q;
      *reinterpret_cast<float2*>(out + (m0 + g) * 64 + p) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * 64 + p) = make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// ---- c: the carries, float32 ------------------------------------------------
// CTA (head h, batch b, a slice of 1024 elements of the N x P state), a
// float4 a thread.  Forward over the chunks: S_{c+1} = exp(total_c) S_c +
// dS_c, with S_c written out as bf16 hi + lo (the operand the state terms
// read).  Back over them: G_c = exp(total_c) G_{c+1} + dG_c, with G_{c+1}
// written as bf16 hi + lo, and the slice's <G_{c+1}, S_{c+1}> (S_nc the
// final state in float32, the others hi + lo) summed in a fixed order.
__device__ __forceinline__ void store_split(__nv_bfloat16* plane, long long plane_elems,
                                            long long e, float4 v) {
  uint2 h, l;
  split(v.x, v.y, h.x, l.x);
  split(v.z, v.w, h.y, l.y);
  *reinterpret_cast<uint2*>(plane + e) = h;
  *reinterpret_cast<uint2*>(plane + plane_elems + e) = l;
}

template <int kNT>
__global__ void __launch_bounds__(kThreads) carry_kernel(Args a) {
  constexpr int NP = 64 * kNT * 64, kSlices = NP / (4 * kThreads);
  __shared__ float red[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, sl = blockIdx.z, tid = threadIdx.x;
  const int e = 4 * (sl * kThreads + tid);         // this thread's four elements
  const float* cum = a.cum + ((long long)b * a.H + h) * a.nc * a.Q;
  auto slot = [&](int c) { return (((long long)b * a.nc + c) * a.H + h); };
  float4 S = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < a.nc; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(a.dS + slot(c) * NP + e);
    store_split(a.S + slot(c) * 2 * NP, NP, e, S);
    const float d = expf(cum[(long long)c * a.Q + a.Q - 1]);
    S = make_float4(d * S.x + v.x, d * S.y + v.y, d * S.z + v.z, d * S.w + v.w);
  }
  float4 G = a.d_final ? *reinterpret_cast<const float4*>(a.d_final + ((long long)b * a.H + h) * NP + e)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = a.nc - 1; c >= 0; --c) {
    float4 sn = S;
    if (c + 1 < a.nc) {
      const __nv_bfloat16* p = a.S + slot(c + 1) * 2 * NP + e;
      const uint2 hi = *reinterpret_cast<const uint2*>(p), lo = *reinterpret_cast<const uint2*>(p + NP);
      const float2 h0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi.x));
      const float2 h1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi.y));
      const float2 l0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo.x));
      const float2 l1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo.y));
      sn = make_float4(h0.x + l0.x, h0.y + l0.y, h1.x + l1.x, h1.y + l1.y);
    }
    float part = sum_octet(sum_quad(G.x * sn.x + G.y * sn.y + G.z * sn.z + G.w * sn.w));
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float t = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w) t += red[w];
      a.dots[(((long long)b * a.H + h) * a.nc + c) * kSlices + sl] = t;
    }
    __syncthreads();
    const float4 v = *reinterpret_cast<const float4*>(a.dG + slot(c) * NP + e);
    store_split(a.G + slot(c) * 2 * NP, NP, e, G);
    const float d = expf(cum[(long long)c * a.Q + a.Q - 1]);
    G = make_float4(d * G.x + v.x, d * G.y + v.y, d * G.z + v.z, d * G.w + v.w);
  }
}

// ---- d: the state terms -----------------------------------------------------
// CTA (head group, chunk c and 64-row tile T, batch b), eight warps: warp w
// rows 16 (w % 4) .. of the tile and a column half w / 4.  B_T and C_T
// staged once; per head, double-buffered by cp.async, G_{c+1} and S_c as
// bf16 hi + lo tiles (N x 64, split by pass c), x_T and dy_T.  Products per head: B_T G (K = N) for dx's state term, written
// float32 scaled by dt_j exp(total - cum_j), and ddt's (. x_j); x_T G^T and
// dy_T S_c^T (K = P) into fresh accumulators, added scaled into dB's and
// dC's state terms for the CTA's heads; U_i = exp(cum_i) C_i . (S_c dy_i).
template <int kQT, int kNT>
__global__ void __launch_bounds__(kThreads, 1) state_bwd_kernel(Args a) {
  constexpr int Q = 64 * kQT, N = 64 * kNT, NN = 4 * kNT;   // NN: n-tiles over N / 2
  // G, S (hi, lo), x_T, dy_T; cum and dt of the tile's rows, the chunk's last
  // four cum (1 KB, so that both stages' tiles start 1 KB aligned)
  constexpr int kStage = 4 * N * 128 + 2 * 8192 + 1024;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sB = smem;                       // 64 x N
  uint8_t* sC = sB + 64 * N * 2;            // 64 x N
  uint8_t* stage = sC + 64 * N * 2;         // [2][kStage]
  float* sRed = reinterpret_cast<float*>(stage + 2 * kStage);   // [ddt, U][column half][64]
  const int grp = blockIdx.x, c = blockIdx.y / kQT, T = blockIdx.y % kQT, b = blockIdx.z;
  const int lT = c * Q + 64 * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wr = warp & 3, ih = warp >> 2;
  const int rr[2] = {16 * wr + g, 16 * wr + g + 8};
  const uint32_t uB = hopper::smem_u32(sB);
  stage_bf16(sB, a.Bm + b * a.b_sb + (long long)lT * a.b_sl, a.b_sl, 64, N);
  stage_bf16(sC, a.Cm + b * a.c_sb + (long long)lT * a.c_sl, a.c_sl, 64, N);
  cp_commit();

  // G_{c+1} and S_c as tiles of 2N rows (hi, then lo), x_T and dy_T
  auto load_head = [&](int k, int s) {
    const int h = grp * a.hs + k;
    uint8_t* st = stage + s * kStage;
    const long long so = (((long long)b * a.nc + c) * a.H + h) * 2 * N * 64;
    stage_bf16(st, a.G + so, 64, 2 * N, 64);
    stage_bf16(st + 2 * N * 128, a.S + so, 64, 2 * N, 64);
    stage_bf16(st + 4 * N * 128, a.x + b * a.x_sb + (long long)lT * a.x_sl + h * 64, a.x_sl, 64, 64);
    stage_bf16(st + 4 * N * 128 + 8192,
               a.dy + ((long long)b * a.L + lT) * a.H * 64 + (long long)h * 64,
               (long long)a.H * 64, 64, 64);
    float* sc = reinterpret_cast<float*>(st + 4 * N * 128 + 2 * 8192);
    const long long co = (((long long)b * a.H + h) * a.nc + c) * Q;
    if (tid < 16) cp16(sc + 4 * tid, a.cum + co + 64 * T + 4 * tid);
    else if (tid < 32) cp16(sc + 64 + 4 * (tid - 16), a.dtc + co + 64 * T + 4 * (tid - 16));
    else if (tid == 32) cp16(sc + 128, a.cum + co + Q - 4);
    cp_commit();
  };

  float dBa[NN][4], dCa[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dBa[n][r] = dCa[n][r] = 0.0f;

  load_head(0, 0);
  for (int k = 0; k < a.hs; ++k) {
    const int h = grp * a.hs + k, s = k & 1;
    if (k + 1 < a.hs) {
      load_head(k + 1, s ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    uint8_t* sGh = stage + s * kStage;
    uint8_t* sX = sGh + 4 * N * 128;
    const uint32_t uGh = hopper::smem_u32(sGh), uGl = uGh + N * 128, uSh = uGl + N * 128,
                   uSl = uSh + N * 128, uX = hopper::smem_u32(sX), uY = uX + 8192;
    __syncthreads();
    const float* cum = reinterpret_cast<const float*>(sX + 2 * 8192);   // the tile's rows
    const float* dtv = cum + 64;
    const float total = cum[128 + 3];
    float dr[2], eb[2], ec[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cr = cum[rr[e]];
      dr[e] = dtv[rr[e]];
      eb[e] = expf(total - cr);
      ec[e] = expf(cr);
    }

    // B_T G: rows j, columns p in [32 ih, 32 ih + 32), K = N
    float bg[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) bg[n][0] = bg[n][1] = bg[n][2] = bg[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t af[4];
      ldsm(af, uB + a_rows(16 * wr, 16 * ks, 64, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bh[4], bl[4];
        const uint32_t off = b_cols(32 * ih + 16 * np, 16 * ks, N, lane);
        ldsm_t(bh, uGh + off);
        ldsm_t(bl, uGl + off);
        mma(bg[2 * np], af, bh[0], bh[1]);
        mma(bg[2 * np], af, bl[0], bl[1]);
        mma(bg[2 * np + 1], af, bh[2], bh[3]);
        mma(bg[2 * np + 1], af, bl[2], bl[3]);
      }
    }
    float part[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int p = 32 * ih + 8 * n + 2 * q;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 xv = bf2(sX + swz(rr[e], p, 64));
        part[e] += bg[n][2 * e] * xv.x + bg[n][2 * e + 1] * xv.y;
        const float f = dr[e] * eb[e];
        *reinterpret_cast<float2*>(a.dxs + ((long long)b * a.L + lT + rr[e]) * a.H * 64 +
                                   (long long)h * 64 + p) =
            make_float2(f * bg[n][2 * e], f * bg[n][2 * e + 1]);
      }
    }

    // x_T G^T and dy_T S_c^T: rows j, columns n in [N/2 ih, N/2 ih + N/2), K = P
    float tx[NN][4], ty[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) tx[n][r] = ty[n][r] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ax[4], ay[4];
      ldsm(ax, uX + a_rows(16 * wr, 16 * ks, 64, lane));
      ldsm(ay, uY + a_rows(16 * wr, 16 * ks, 64, lane));
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        const uint32_t off = b_rows((N / 2) * ih + 16 * np, 16 * ks, N, lane);
        uint32_t gh[4], gl[4], sh[4], sl[4];
        ldsm(gh, uGh + off);
        ldsm(gl, uGl + off);
        ldsm(sh, uSh + off);
        ldsm(sl, uSl + off);
        mma(tx[2 * np], ax, gh[0], gh[1]);
        mma(tx[2 * np], ax, gl[0], gl[1]);
        mma(tx[2 * np + 1], ax, gh[2], gh[3]);
        mma(tx[2 * np + 1], ax, gl[2], gl[3]);
        mma(ty[2 * np], ay, sh[0], sh[1]);
        mma(ty[2 * np], ay, sl[0], sl[1]);
        mma(ty[2 * np + 1], ay, sh[2], sh[3]);
        mma(ty[2 * np + 1], ay, sl[2], sl[3]);
      }
    }
    float up[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = (N / 2) * ih + 8 * n + 2 * q;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 cv = bf2(sC + swz(rr[e], col, 64));
        up[e] += ty[n][2 * e] * cv.x + ty[n][2 * e + 1] * cv.y;
        const float f = dr[e] * eb[e];
        dBa[n][2 * e] += f * tx[n][2 * e];
        dBa[n][2 * e + 1] += f * tx[n][2 * e + 1];
        dCa[n][2 * e] += ec[e] * ty[n][2 * e];
        dCa[n][2 * e + 1] += ec[e] * ty[n][2 * e + 1];
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      part[e] = sum_quad(part[e]);
      up[e] = sum_quad(up[e]);
      if (q == 0) {
        sRed[ih * 64 + rr[e]] = part[e];
        sRed[128 + ih * 64 + rr[e]] = up[e];
      }
    }
    __syncthreads();
    if (tid < 64) {
      const float cr = cum[tid];
      const long long o = ((long long)b * a.H + h) * a.L + lT + tid;
      a.ddts[o] = expf(total - cr) * (sRed[tid] + sRed[64 + tid]);
      a.U[o] = expf(cr) * (sRed[128 + tid] + sRed[192 + tid]);
    }
    __syncthreads();                                // the stage is free for head k + 2
  }
  float* ob = a.dBs + (((long long)grp * a.Bsz + b) * a.L + lT) * N;
  float* oc = a.dCs + (((long long)grp * a.Bsz + b) * a.L + lT) * N;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = (N / 2) * ih + 8 * n + 2 * q;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      *reinterpret_cast<float2*>(ob + rr[e] * N + col) = make_float2(dBa[n][2 * e], dBa[n][2 * e + 1]);
      *reinterpret_cast<float2*>(oc + rr[e] * N + col) = make_float2(dCa[n][2 * e], dCa[n][2 * e + 1]);
    }
  }
}

// ---- e: the chunk scan's gradient --------------------------------------------
// CTA (head group, chunk c, batch b and 64-row column tile J), eight warps:
// warp w rows j 16 (w % 4) .. of tile J, and of every row tile I >= J the
// columns i in [32 (w / 4), + 32).  P_JI = B_J C_I^T (K = N) is formed once
// and kept float32 in shared memory in fragment order, as W summed over the
// heads is.  Per head, double-buffered by cp.async (x_J, dy of rows I >= J,
// cum and dt of the chunk), for each I: R = x_J dy_I^T (K = P); with decay
// masked before the exponential on the diagonal tile and exp(cum_i - cum_e)
// exp(cum_e - cum_j) below it (e the tile's last row, both factors at most
// 1), the scores P decay split into bf16 hi + lo a fragments, dx_J +=
// (P decay) dy_I (K = i), ddt's direct term += sum_i P decay R, the column
// sums over j of P decay R dt (dcum's row term), W += R decay dt.  The two
// warps of a row group hold dx partials over their column halves and
// exchange halves through shared memory; dx_J = dt_j (...) + pass d's state
// term, in bf16.
template <int kQT, int kNT>
__global__ void __launch_bounds__(kThreads, 1) scan_bwd_kernel(Args a) {
  constexpr int Q = 64 * kQT, N = 64 * kNT;
  constexpr int kTileF = 64 * 64 * 4;                  // a float32 64 x 64 tile
  constexpr int kStage = 8192 * (1 + kQT) + 8 * Q;     // x_J, dy, cum, dt
  extern __shared__ __align__(128) uint8_t smem[];
  float4* sP = reinterpret_cast<float4*>(smem);                // [kQT][8][4][32]
  float4* sW = reinterpret_cast<float4*>(smem + kQT * kTileF);  // [kQT][8][4][32]
  uint8_t* stage = smem + 2 * kQT * kTileF;                    // [2][kStage]
  float* sRow = reinterpret_cast<float*>(stage + 2 * kStage);  // [4][Q]
  float* sDd = sRow + 4 * Q;                                   // [2][64]

  const int grp = blockIdx.x, c = blockIdx.y, J = blockIdx.z / a.Bsz, b = blockIdx.z % a.Bsz;
  const int nI = kQT - J, lJ = c * Q + 64 * J;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wr = warp & 3, ih = warp >> 2;
  const int jr[2] = {64 * J + 16 * wr + g, 64 * J + 16 * wr + g + 8};   // rows, in the chunk

  // P_JI for I >= J, from B_J and C_I staged over the stage area
  {
    uint8_t* sBJ = stage;
    uint8_t* sCI = stage + 64 * N * 2;
    stage_bf16(sBJ, a.Bm + b * a.b_sb + (long long)lJ * a.b_sl, a.b_sl, 64, N);
    for (int u = 0; u < nI; ++u)
      stage_bf16(sCI + u * 64 * N * 2, a.Cm + b * a.c_sb + (long long)(lJ + 64 * u) * a.c_sl,
                 a.c_sl, 64, N);
    cp_commit();
    for (int i = tid; i < nI * 1024; i += kThreads) sW[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    cp_wait<0>();
    __syncthreads();
    const uint32_t uBJ = hopper::smem_u32(sBJ);
    for (int u = 0; u < nI; ++u) {
      const uint32_t uCI = hopper::smem_u32(sCI + u * 64 * N * 2);
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t af[4];
        ldsm(af, uBJ + a_rows(16 * wr, 16 * ks, 64, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          ldsm(bb, uCI + b_rows(32 * ih + 16 * np, 16 * ks, 64, lane));
          mma(acc[2 * np], af, bb[0], bb[1]);
          mma(acc[2 * np + 1], af, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
        sP[((u * 8 + warp) * 4 + n) * 32 + lane] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    }
    __syncthreads();                                // the stage area is free again
  }

  auto load_head = [&](int k, int s) {
    const int h = grp * a.hs + k;
    uint8_t* st = stage + s * kStage;
    stage_bf16(st, a.x + b * a.x_sb + (long long)lJ * a.x_sl + h * 64, a.x_sl, 64, 64);
    stage_bf16(st + 8192, a.dy + ((long long)b * a.L + lJ) * a.H * 64 + (long long)h * 64,
               (long long)a.H * 64, 64 * nI, 64);
    const long long co = (((long long)b * a.H + h) * a.nc + c) * Q;
    float* sc = reinterpret_cast<float*>(st + 8192 * (1 + kQT));
    for (int i = tid; i < Q / 4; i += kThreads) {
      cp16(sc + 4 * i, a.cum + co + 4 * i);
      cp16(sc + Q + 4 * i, a.dtc + co + 4 * i);
    }
    cp_commit();
  };

  load_head(0, 0);
  for (int k = 0; k < a.hs; ++k) {
    const int s = k & 1, h = grp * a.hs + k;
    if (k + 1 < a.hs) {
      load_head(k + 1, s ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    uint8_t* sX = stage + s * kStage;
    uint8_t* sY = sX + 8192;
    const float* cum = reinterpret_cast<const float*>(sX + 8192 * (1 + kQT));
    const float* dtv = cum + Q;
    const uint32_t uX = hopper::smem_u32(sX), uY = hopper::smem_u32(sY);
    const float ce = cum[64 * J + 63];
    float cj[2], dj[2], bj[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      cj[e] = cum[jr[e]];
      dj[e] = dtv[jr[e]];
      bj[e] = hopper::exp2_approx((ce - cj[e]) * kLog2e);
    }
    // pass d's state terms of this head, read now and added at the end
    float2 dxs[4][2];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dxs[m][e] = *reinterpret_cast<const float2*>(
            a.dxs + ((long long)b * a.L + c * Q + jr[e]) * a.H * 64 + (long long)h * 64 +
            8 * (4 * ih + m) + 2 * q);
    const float ddts = tid < 64 ? a.ddts[((long long)b * a.H + h) * a.L + lJ + tid] : 0.0f;
    uint32_t xa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) ldsm(xa[ks], uX + a_rows(16 * wr, 16 * ks, 64, lane));
    float dx[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dx[n][0] = dx[n][1] = dx[n][2] = dx[n][3] = 0.0f;
    float dd[2] = {0.0f, 0.0f};

    for (int u = 0; u < nI; ++u) {
      const int i0 = 64 * (J + u) + 32 * ih;       // this warp's first column, in the chunk
      float R[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) R[n][0] = R[n][1] = R[n][2] = R[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          ldsm(bb, uY + b_rows(64 * u + 32 * ih + 16 * np, 16 * ks, 64, lane));
          mma(R[2 * np], xa[ks], bb[0], bb[1]);
          mma(R[2 * np + 1], xa[ks], bb[2], bb[3]);
        }
      uint32_t sh[2][4], sl[2][4];
      float cs[4][2], ci[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 cc = *reinterpret_cast<const float2*>(cum + i0 + 8 * n + 2 * q);
        ci[n][0] = cc.x;
        ci[n][1] = cc.y;
        if (u > 0) {                                // exp(cum_i - cum_e), once a column
          ci[n][0] = hopper::exp2_approx((cc.x - ce) * kLog2e);
          ci[n][1] = hopper::exp2_approx((cc.y - ce) * kLog2e);
        }
      }
      float4* wp = sW + (u * 8 + warp) * 4 * 32 + lane;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float4 pv = sP[((u * 8 + warp) * 4 + n) * 32 + lane];
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
        float sd[4], wa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = r >> 1, col = i0 + 8 * n + 2 * q + (r & 1);
          float dec;
          if (u == 0)                               // the mask first
            dec = col >= jr[e] ? hopper::exp2_approx((ci[n][r & 1] - cj[e]) * kLog2e) : 0.0f;
          else
            dec = ci[n][r & 1] * bj[e];
          sd[r] = pr[r] * dec;
          const float ev = sd[r] * R[n][r];
          dd[e] += ev;
          wa[r] = R[n][r] * dec * dj[e];
          if (e == 0) cs[n][r & 1] = ev * dj[0];
          else cs[n][r & 1] += ev * dj[1];
        }
        float4 wv = wp[n * 32];
        wv.x += wa[0];
        wv.y += wa[1];
        wv.z += wa[2];
        wv.w += wa[3];
        wp[n * 32] = wv;
        split(sd[0], sd[1], sh[n >> 1][(n & 1) * 2], sl[n >> 1][(n & 1) * 2]);
        split(sd[2], sd[3], sh[n >> 1][(n & 1) * 2 + 1], sl[n >> 1][(n & 1) * 2 + 1]);
      }
      // dcum's row term: sums over j, over the warp's rows, then per row group
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = sum_octet(cs[n][e]);
          if (g == 0) sRow[wr * Q + i0 + 8 * n + 2 * q + e] = v;
        }
      // dx_J += (P decay)_JI dy_I, K = the warp's 32 columns i
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          ldsm_t(bb, uY + b_cols(16 * np, 64 * u + 32 * ih + 16 * kk, 64, lane));
          mma(dx[2 * np], sh[kk], bb[0], bb[1]);
          mma(dx[2 * np], sl[kk], bb[0], bb[1]);
          mma(dx[2 * np + 1], sh[kk], bb[2], bb[3]);
          mma(dx[2 * np + 1], sl[kk], bb[2], bb[3]);
        }
    }

#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dd[e] = sum_quad(dd[e]);
      if (q == 0) sDd[ih * 64 + 16 * wr + g + 8 * e] = dd[e];
    }
    __syncthreads();                                // sX, sY read by every warp; sRow whole
    float* ex = reinterpret_cast<float*>(sX);       // [4][2][32][16]: dx halves in transit
    {
      float4* mine = reinterpret_cast<float4*>(ex + ((wr * 2 + (1 - ih)) * 32 + lane) * 16);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int n = 4 * (1 - ih) + m;
        mine[m] = make_float4(dx[n][0], dx[n][1], dx[n][2], dx[n][3]);
      }
    }
    for (int i = 64 * J + tid; i < Q; i += kThreads)
      a.rowT[((((long long)b * a.H + h) * a.nc + c) * kQT + J) * Q + i] =
          sRow[i] + sRow[Q + i] + sRow[2 * Q + i] + sRow[3 * Q + i];
    __syncthreads();
    {
      const float4* other = reinterpret_cast<const float4*>(ex + ((wr * 2 + ih) * 32 + lane) * 16);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int n = 4 * ih + m;
        const float4 o = other[m];
        dx[n][0] += o.x;
        dx[n][1] += o.y;
        dx[n][2] += o.z;
        dx[n][3] += o.w;
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = 4 * ih + m, p = 8 * n + 2 * q;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long o = ((long long)b * a.L + c * Q + jr[e]) * a.H * 64 + (long long)h * 64 + p;
        *reinterpret_cast<uint32_t*>(a.dx + o) = hopper::pack_bf16(
            fmaf(dj[e], dx[n][2 * e], dxs[m][e].x), fmaf(dj[e], dx[n][2 * e + 1], dxs[m][e].y));
      }
    }
    if (tid < 64) {
      const long long o = ((long long)b * a.H + h) * a.L + lJ + tid;
      a.ddtd[o] = sDd[tid] + sDd[64 + tid] + ddts;
    }
    __syncthreads();                                // the stage is free for head k + 2
  }

  for (int u = 0; u < nI; ++u) {
    float* wo = a.W + ((((((long long)grp * a.Bsz + b) * a.nc + c) * kQT + J + u) * kQT + J) * 4096);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 w = sW[((u * 8 + warp) * 4 + n) * 32 + lane];
      float* o = wo + (16 * wr + g) * 64 + 32 * ih + 8 * n + 2 * q;
      *reinterpret_cast<float2*>(o) = make_float2(w.x, w.y);
      *reinterpret_cast<float2*>(o + 8 * 64) = make_float2(w.z, w.w);
    }
  }
}

// ---- f: dB and dC -----------------------------------------------------------
// CTA (64-row tile T, chunk c, batch b), eight warps: warp w rows 16 (w % 4)
// .. of T and the column half w / 4 of N.  dB_T = sum_{I >= T} W(I, T) C_I
// and dC_T = sum_{J <= T} W(T, J)^T B_J, W summed over the head groups in
// float32 and split into bf16 hi + lo a fragments (read transposed for dC);
// then the state terms, summed over the head groups too, and out in bf16.
template <int kNT, bool kTrans>
__device__ __forceinline__ void w_product(float (&acc)[4 * kNT][4], const float* sWt,
                                          uint32_t uM, int wr, int ih, int lane) {
  constexpr int N = 64 * kNT, NN = 4 * kNT, LD = 68;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int m = 16 * wr + g, k0 = 16 * ks + 2 * q;
    float v[4][2];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int mm = m + 8 * (f & 1), kk = k0 + 8 * (f >> 1);
      if (kTrans) {
        v[f][0] = sWt[kk * LD + mm];
        v[f][1] = sWt[(kk + 1) * LD + mm];
      } else {
        const float2 p = *reinterpret_cast<const float2*>(sWt + mm * LD + kk);
        v[f][0] = p.x;
        v[f][1] = p.y;
      }
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) split(v[f][0], v[f][1], ah[f], al[f]);
#pragma unroll
    for (int np = 0; np < NN / 2; ++np) {
      uint32_t bb[4];
      ldsm_t(bb, uM + b_cols((N / 2) * ih + 16 * np, 16 * ks, 64, lane));
      mma(acc[2 * np], ah, bb[0], bb[1]);
      mma(acc[2 * np], al, bb[0], bb[1]);
      mma(acc[2 * np + 1], ah, bb[2], bb[3]);
      mma(acc[2 * np + 1], al, bb[2], bb[3]);
    }
  }
}

template <int kQT, int kNT>
__global__ void __launch_bounds__(kThreads, 1) bc_kernel(Args a) {
  constexpr int Q = 64 * kQT, N = 64 * kNT, NN = 4 * kNT, LD = 68;
  extern __shared__ __align__(128) uint8_t smem[];
  float* sWt = reinterpret_cast<float*>(smem);         // 64 x LD float32
  uint8_t* sM = smem + 64 * LD * 4;                     // 64 x N: C_I or B_J
  const int T = blockIdx.x, c = blockIdx.y, b = blockIdx.z, lT = c * Q + 64 * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wr = warp & 3, ih = warp >> 2;
  const int groups = a.H / a.hs;
  const uint32_t uM = hopper::smem_u32(sM);
  float accB[NN][4], accC[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) accB[n][r] = accC[n][r] = 0.0f;

  for (int u = 0; u < kQT + 1; ++u) {
    // u < kQT - T: dB's tile I = T + u; then dC's tiles J = 0 .. T
    const bool forB = u < kQT - T;
    const int I = forB ? T + u : T, Jt = forB ? T : u - (kQT - T);
    __syncthreads();
    if (forB)
      stage_bf16(sM, a.Cm + b * a.c_sb + (long long)(c * Q + 64 * I) * a.c_sl, a.c_sl, 64, N);
    else
      stage_bf16(sM, a.Bm + b * a.b_sb + (long long)(c * Q + 64 * Jt) * a.b_sl, a.b_sl, 64, N);
    cp_commit();
    for (int idx = tid; idx < 1024; idx += kThreads) {
      const int r = idx >> 4, c4 = idx & 15;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int grp = 0; grp < groups; ++grp) {
        const float4 v = *reinterpret_cast<const float4*>(
            a.W + ((((((long long)grp * a.Bsz + b) * a.nc + c) * kQT + I) * kQT + Jt) * 4096) +
            r * 64 + 4 * c4);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      *reinterpret_cast<float4*>(sWt + r * LD + 4 * c4) = s;
    }
    cp_wait<0>();
    __syncthreads();
    if (forB)
      w_product<kNT, false>(accB, sWt, uM, wr, ih, lane);
    else
      w_product<kNT, true>(accC, sWt, uM, wr, ih, lane);
  }

#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = (N / 2) * ih + 8 * n + 2 * q;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long row = (long long)b * a.L + lT + 16 * wr + g + 8 * e;
      float2 sb = make_float2(accB[n][2 * e], accB[n][2 * e + 1]);
      float2 sc = make_float2(accC[n][2 * e], accC[n][2 * e + 1]);
      for (int grp = 0; grp < groups; ++grp) {
        const long long o = ((long long)grp * a.Bsz * a.L + row) * N + col;
        const float2 vb = *reinterpret_cast<const float2*>(a.dBs + o);
        const float2 vc = *reinterpret_cast<const float2*>(a.dCs + o);
        sb.x += vb.x;
        sb.y += vb.y;
        sc.x += vc.x;
        sc.y += vc.y;
      }
      *reinterpret_cast<uint32_t*>(a.dB + row * N + col) = hopper::pack_bf16(sb.x, sb.y);
      *reinterpret_cast<uint32_t*>(a.dC + row * N + col) = hopper::pack_bf16(sc.x, sc.y);
    }
  }
}

// ---- g: dcum, ddt and dA --------------------------------------------------------
// CTA (head, batch), a thread per position of a chunk, over the chunks in
// order: dcum_k = sum_{J <= k / 64} rowT + U_k - dt_k ddtd_k (+ the dot,
// summed over pass c's slices, at the chunk's last row), its reverse prefix
// sum rc by warp shuffles and the warps' totals in a fixed order; ddt =
// ddtd + A rc; dt rc summed into dA's part of the batch row.  da_kernel sums
// those over the batch, in order.
__global__ void __launch_bounds__(kThreads) finish_kernel(Args a) {
  __shared__ float tot[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = a.Q, qt = a.Q / 64, slices = a.N / 16;
  const float Ah = a.A[h];
  float dA = 0.0f;
  for (int c = 0; c < a.nc; ++c) {
    const long long hc = ((long long)b * a.H + h) * a.nc + c;
    const int l = c * Q + tid;
    float dcum = 0.0f, ddtd = 0.0f, dtk = 0.0f;
    if (tid < Q) {
      for (int J = 0; J <= tid / 64; ++J) dcum += a.rowT[(hc * qt + J) * Q + tid];
      const long long o = ((long long)b * a.H + h) * a.L + l;
      ddtd = a.ddtd[o];
      dtk = a.dtc[hc * Q + tid];
      dcum += a.U[o] - dtk * ddtd;
      if (tid == Q - 1)
        for (int sl = 0; sl < slices; ++sl) dcum += a.dots[hc * slices + sl];
    }
    float v = dcum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, v, d);
      if (lane + d < 32) v += o;
    }
    if (lane == 0) tot[warp] = v;
    __syncthreads();
    for (int w = warp + 1; w < kThreads / 32; ++w) v += tot[w];
    __syncthreads();
    if (tid < Q) {
      a.ddt[((long long)b * a.L + l) * a.H + h] = fmaf(Ah, v, ddtd);
      dA = fmaf(dtk, v, dA);
    }
  }
  dA = sum_octet(sum_quad(dA));
  if (lane == 0) tot[warp] = dA;
  __syncthreads();
  if (tid == 0) {
    float t = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) t += tot[w];
    a.dAp[(long long)b * a.H + h] = t;
  }
}

__global__ void __launch_bounds__(kThreads) da_kernel(Args a) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= a.H) return;
  float t = 0.0f;
  for (int b = 0; b < a.Bsz; ++b) t += a.dAp[(long long)b * a.H + h];
  a.dA[h] = t;
}

// ---- launch -----------------------------------------------------------------------

template <int kQT, int kNT>
constexpr int dstate_smem() { return 64 * kQT * 64 * kNT * 2 + 2 * 64 * kQT * 128; }
template <int kNT>
constexpr int state_smem() {
  return 2 * 64 * 64 * kNT * 2 + 2 * (4 * 64 * kNT * 128 + 2 * 8192 + 1024) + 4 * 128 * 4;
}
template <int kQT, int kNT>
constexpr int scan_smem() {
  return 2 * kQT * 64 * 64 * 4 + 2 * (8192 * (1 + kQT) + 8 * 64 * kQT) + 4 * 64 * kQT * 4 + 2 * 64 * 4;
}
template <int kNT>
constexpr int bc_smem() { return 64 * 68 * 4 + 64 * 64 * kNT * 2; }

// Scratch, in floats, each piece a multiple of 4 (16-byte aligned).
struct Layout {
  long long cum, dtc, dS, dG, S, G, dots, dAp, dxs, ddts, U, ddtd, dBs, dCs, rowT, W, total;
};

inline int heads_per(int H, int most) {
  for (int k = most; k > 1; k /= 2)
    if (H % k == 0) return k;
  return 1;
}

inline Layout layout(int B, int L, int H, int N, int Q) {
  const long long nc = L / Q, qt = Q / 64;
  const long long groups = H / heads_per(H, 16);    // of kernels d and e
  auto up = [](long long n) { return (n + 3) / 4 * 4; };
  Layout s;
  long long at = 0;
  auto take = [&](long long n) { const long long here = at; at += up(n); return here; };
  s.cum = take(B * H * nc * Q);
  s.dtc = take(B * H * nc * Q);
  s.dS = take(B * nc * H * N * 64LL);
  s.dG = take(B * nc * H * N * 64LL);
  s.S = take(B * nc * H * N * 64LL);                  // bf16 hi + lo
  s.G = take(B * nc * H * N * 64LL);
  s.dots = take(B * H * nc * (N / 16));
  s.dAp = take((long long)B * H);
  s.dxs = take((long long)B * L * H * 64);
  s.ddts = take((long long)B * H * L);
  s.U = take((long long)B * H * L);
  s.ddtd = take((long long)B * H * L);
  s.dBs = take(groups * B * L * N);
  s.dCs = take(groups * B * L * N);
  s.rowT = take(B * H * nc * qt * Q);
  s.W = take(groups * B * nc * qt * qt * 4096);
  s.total = at;
  return s;
}

template <int kQT, int kNT>
int launch_as(const ssd_tc::Maps& m, const ssd_tc::Args& fa, const Args& a, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(ssd_tc::states_kernel<kQT, kNT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ssd_tc::states_smem<kQT, kNT>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dstate_kernel<kQT, kNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dstate_smem<kQT, kNT>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(state_bwd_kernel<kQT, kNT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, state_smem<kNT>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scan_bwd_kernel<kQT, kNT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, scan_smem<kQT, kNT>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bc_kernel<kQT, kNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bc_smem<kNT>());
  if (e != cudaSuccess) return (int)e;
  const int B = a.Bsz;
  ssd_tc::states_kernel<kQT, kNT><<<dim3(a.H / fa.hg, a.nc, B), ssd_tc::kPairThreads,
                                    ssd_tc::states_smem<kQT, kNT>(), st>>>(m.x, m.b, fa);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dstate_kernel<kQT, kNT><<<dim3(a.H / a.hs_dstate, a.nc, B), kThreads, dstate_smem<kQT, kNT>(),
                            st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  carry_kernel<kNT><<<dim3(a.H, B, 64 * kNT * 64 / (4 * kThreads)), kThreads, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  state_bwd_kernel<kQT, kNT><<<dim3(a.H / a.hs, a.nc * kQT, B), kThreads, state_smem<kNT>(),
                               st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_bwd_kernel<kQT, kNT><<<dim3(a.H / a.hs, a.nc, kQT * B), kThreads,
                              scan_smem<kQT, kNT>(), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bc_kernel<kQT, kNT><<<dim3(kQT, a.nc, B), kThreads, bc_smem<kNT>(), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  finish_kernel<<<dim3(a.H, B), kThreads, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  da_kernel<<<dim3((a.H + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace ssd_bwd

// Floats of scratch launch_ssd_bwd needs at dims (B, L, H, P, N, Q).
extern "C" long long ssd_bwd_scratch(const int* dims) {
  return ssd_bwd::layout(dims[0], dims[1], dims[2], dims[4], dims[5]).total;
}

// The gradient of the bf16 tensor-core instance (P 64, N 64 or 128, Q a
// multiple of 64 up to 256; x, B, C with 16-byte aligned bases and strides
// that are multiples of 8 elements): dy (B, L, H, P) bf16 contiguous,
// d_final (B, H, N, P) float32 contiguous or null; out dx (B, L, H, P) and
// dB, dC (B, L, N) bf16, ddt (B, L, H) and dA (H,) float32, all contiguous;
// scratch of ssd_bwd_scratch floats.  Strides and dims: launch_ssd's first
// eight and first six (one B/C group).
// Eight kernels on the stream; returns the first cudaError_t.
extern "C" int launch_ssd_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                              const void* Cm, const void* dy, const float* d_final, void* dx,
                              float* ddt, float* dA, void* dB, void* dC, float* scratch,
                              const long long* strides, const int* dims, void* stream) {
  const int B = dims[0], L = dims[1], H = dims[2], P = dims[3], N = dims[4], Q = dims[5];
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || P != 64 || (N != 64 && N != 128) || Q < 64 ||
      Q > 256 || Q % 64 || L % Q || (long long)(Q / 64) * B > 65535)
    return (int)cudaErrorInvalidValue;
  const ssd_bwd::Layout s = ssd_bwd::layout(B, L, H, N, Q);
  ssd_bwd::Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.Bm = static_cast<const __nv_bfloat16*>(Bm);
  a.Cm = static_cast<const __nv_bfloat16*>(Cm);
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.A = A;
  a.d_final = d_final;
  a.cum = scratch + s.cum;
  a.dtc = scratch + s.dtc;
  a.dS = scratch + s.dS;
  a.dG = scratch + s.dG;
  a.S = reinterpret_cast<__nv_bfloat16*>(scratch + s.S);
  a.G = reinterpret_cast<__nv_bfloat16*>(scratch + s.G);
  a.dots = scratch + s.dots;
  a.dAp = scratch + s.dAp;
  a.dxs = scratch + s.dxs;
  a.ddts = scratch + s.ddts;
  a.U = scratch + s.U;
  a.ddtd = scratch + s.ddtd;
  a.dBs = scratch + s.dBs;
  a.dCs = scratch + s.dCs;
  a.rowT = scratch + s.rowT;
  a.W = scratch + s.W;
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.ddt = ddt;
  a.dA = dA;
  a.dB = static_cast<__nv_bfloat16*>(dB);
  a.dC = static_cast<__nv_bfloat16*>(dC);
  a.Bsz = B;
  a.L = L;
  a.H = H;
  a.N = N;
  a.Q = Q;
  a.nc = L / Q;
  a.hs_dstate = ssd_bwd::heads_per(H, 8);
  a.hs = ssd_bwd::heads_per(H, 16);
  a.x_sb = strides[0];
  a.x_sl = strides[1];
  a.b_sb = strides[4];
  a.b_sl = strides[5];
  a.c_sb = strides[6];
  a.c_sl = strides[7];

  // the forward's pass a, writing cum, dt and dS into this scratch
  ssd_tc::Args fa;
  fa.dt = dt;
  fa.A = A;
  fa.y = nullptr;
  fa.state = nullptr;
  fa.cum = a.cum;
  fa.dtc = a.dtc;
  fa.dS = a.dS;
  fa.y_state = nullptr;
  fa.L = L;
  fa.H = H;
  fa.N = N;
  fa.Q = Q;
  fa.nc = a.nc;
  fa.hg = H % 4 == 0 ? 4 : H % 2 == 0 ? 2 : 1;
  fa.hs = 1;
  fa.hpg = H;                    // one B/C group
  fa.dt_sb = strides[2];
  fa.dt_sl = strides[3];
  ssd_tc::Maps m;
  const uint64_t eb = 2, uL = L, uH = H, uN = N;
  const uint32_t box[4] = {64, 1, 64, 1};
  const uint64_t xd[4] = {64, uH, uL, (uint64_t)B};
  const uint64_t xs[3] = {64 * eb, strides[1] * eb, strides[0] * eb};
  const uint64_t bd[4] = {uN, 1, uL, (uint64_t)B};
  const uint64_t bs[3] = {uN * eb, strides[5] * eb, strides[4] * eb};
  int err = hopper::tensor_map_bf16(&m.x, x, xd, xs, box, 128);
  if (!err) err = hopper::tensor_map_bf16(&m.b, Bm, bd, bs, box, 128);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qt = Q / 64;
  if (N == 128) {
    switch (qt) {
      case 1: return ssd_bwd::launch_as<1, 2>(m, fa, a, st);
      case 2: return ssd_bwd::launch_as<2, 2>(m, fa, a, st);
      case 3: return ssd_bwd::launch_as<3, 2>(m, fa, a, st);
      default: return ssd_bwd::launch_as<4, 2>(m, fa, a, st);
    }
  }
  switch (qt) {
    case 1: return ssd_bwd::launch_as<1, 1>(m, fa, a, st);
    case 2: return ssd_bwd::launch_as<2, 1>(m, fa, a, st);
    case 3: return ssd_bwd::launch_as<3, 1>(m, fa, a, st);
    default: return ssd_bwd::launch_as<4, 1>(m, fa, a, st);
  }
}
