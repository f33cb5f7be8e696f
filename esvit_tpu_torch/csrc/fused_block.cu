// The whole Swin block, forward and backward, sm_90a.
//
// Replaces the Pallas TPU kernels of esvit_tpu/ops/fused_block.py:
// _fwd_kernel (launched by _run, kind "fwd") and _bwd_kernel (kind "bwd"),
// reached through fused_swin_block.
//
// The forward: one thread block owns one window of N <= 64 tokens (rows of
// x, in the unpadded window-major order of ops/window.py) and runs, all
// heads:
//   y   = round(LN1(x)) * pad                 fp32 LN, E[x^2] - mu^2 variance
//   q,k,v = round(round(y Wq) + round(bq))    (bf16 operands, fp32 sums)
//   s   = round(q round(scale)) k^T + bias[h] - 100 [region_i != region_j]
//   p   = softmax(s) in fp32, one max per (window, head, row); the keys the
//         16-row tiling adds get -1e9
//   a   = round(round(p) v)
//   x2  = round(x + round(round(round(a Wp) + round(bp)) * keep1[image]))
//   y2  = round(LN2(x2));  h = round(round(y2 W1) + round(b1))
//   g   = round(gelu_erf(h) in fp32)
//   out = round(x2 + round(round(round(g W2) + round(b2)) * keep2[image]))
// exactly where the TPU kernel rounds (fused_block.py:395-443). Without
// keep scales the residuals are x + o (no scaling).
//
// Products. For bf16 inputs every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulation). Each warp owns a tile of
// 16*MT rows by 8*NT columns (mma_block), so a weight fragment fetched from
// L2 feeds MT row tiles. Operands in shared memory come in with ldmatrix
// (.trans where the operand is stored transposed); weights and the
// workspace rows come from global memory with 32-bit loads. A window's rows
// sit unpadded in device memory; in shared memory each bf16 tile has Rp =
// ceil16(N) rows, and every writer zeroes rows N..Rp, so the rows the
// 16-row tiles add contribute exactly 0 where a product contracts over
// tokens. That takes the place of the TPU kernel's 8-row window padding.
// For fp32 inputs (the parity checks) the same tiles run on the CUDA cores
// with bounds-checked scalar loads.
//
// What bounds the forward on Hopper: a window is ~0.23 GFLOP at C=384 on
// 3.5 MB of bf16 weights that every window reads again from L2, and the
// block's shared memory (up to ~160 KB at C=384) allows one or two blocks
// per SM, so eight or sixteen warps run the block's long chain of small
// phases (products, epilogues, LayerNorms, softmax), each ended by a
// barrier: the kernel is bound by latency at low occupancy, not by HBM, L2
// or the tensor cores. Measured on an H100: a build that skipped every
// weight load was only ~7% faster, and staging the weights through a
// cp.async ring gained nothing.
//
// The backward recomputes the forward from the block input (the TPU
// kernel's rematerialisation), but not as one kernel per window: what is
// per token runs on token tiles and only attention stays per window (the
// section "The backward" below). It writes dx and stores the per-row
// operands of the weight gradients (y, dq|dk|dv, a, do1, y2, do2, g, dh)
// to a workspace in the input dtype, plus per-tile fp32 partials of every
// bias and LayerNorm gradient and per-block partials of dbias. A last
// kernel forms each weight gradient as a sum over all rows: each block owns
// one output tile and one fixed run of rows; the runs' partials, like the
// per-tile ones, are summed in a fixed order by sum_rows_kernel. No
// atomics: every gradient is bit-identical run to run. The TPU kernel gets
// the same from its sequential grid (fused_block.py:501-508).
//
// Left behind from the TPU kernel, as Mosaic workarounds: the 8-row Np
// padding, G_step/TW_mm/HG tiling and its VMEM model, lane-split head
// groups, the selector-matmul drop-path rows, iota masks, the tiled bias,
// the A&S erf (CUDA has erff) and the probability cache.
//
// C interface (bound with ctypes): a host array of pointers in the order of
// the Ptr enum below (the wrapper builds it from the same list of names),
// the dims, and the stream. Every entry point returns cudaGetLastError()
// after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "window_attention_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMc = 128;            // MLP hidden-dimension chunk
constexpr int kMaxN = 64;           // tokens per window
constexpr int kMaxC = 384;          // channels (a LayerNorm row in registers)
// The element and column loops over global memory visit kRB rows (or
// elements) at a time and issue the batch's loads before any of its
// stores, which the compiler may not move the next loads past.
constexpr int kRB = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kDeadKey = -1e9f;   // keys the 16-row tiling adds
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// Pointer table: the wrapper passes them in this order. WQKV_F holds the
// q/k/v weights [out][in] with the outputs head-major (head h's q, k and v
// rows are rows h*3hd .. h*3hd+3hd); WQKV_B holds them [in][out] as
// [Wq | Wk | Wv] (the backward's dqkv column order). QKV (rows, 3C) and DA
// (rows, C) are the backward's scratch in the compute dtype.
enum Ptr {
  X, OUT, G1, BE1, BQKV, BP, G2, BE2, B1, B2, BIAS, PAD, KEEP1, KEEP2, REGION,
  WQKV_F, WP_F, W1_F, W2_F,          // [out][in] (torch Linear layout)
  WQKV_B, WP_B, W1_B, W2_B,          // [in][out] (the JAX layout)
  DOUT, DX, DX32, WS, VPART, BPART, WPART, TMP, QKV, DA,
  D_WQKV, D_WP, D_W1, D_W2, D_VEC, D_BIAS, kNumPtrs
};
// Dims: windows, tokens, channels, heads, MLP hidden, window types, row
// chunks of the weight-gradient kernel; the backward's plan: rows of a
// token tile, and the attention tiles' warps per block and windows per
// warp (forward recompute, backward).
enum Dim { D_B, D_N, D_C, D_H, D_M, D_NW, D_CHUNKS, D_ROWS, D_FWARPS, D_FRUN, D_BWARPS,
           D_BRUN, kNumDims };

// The table travels by value as a kernel argument.
struct Table {
  void* p[kNumPtrs];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Round an fp32 value to T and back: the casts to the compute dtype.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float gelu(float h) {
  return h * 0.5f * (1.f + erff(h * kInvSqrt2));
}

__device__ __forceinline__ float dgelu(float h) {
  return 0.5f * (1.f + erff(h * kInvSqrt2)) + h * expf(-0.5f * h * h) * kInvSqrt2Pi;
}

// ---------------------------------------------------------------------------
// Operands of the products. Element (r, k) of an operand lies at
//   SRow: p[r * ld + k], shared memory;
//   SCol: p[k * ld + r], shared memory (a transposed view);
//   GRow: p[r * ld + k], global memory.
// r indexes output rows (A) or output columns (B), k the contracted
// dimension. nr and nk bound the fp32 path, which reads 0 outside them. The
// bf16 path reads whole 16x16 tiles and relies on the tiles' zeroed pad
// rows instead; for GRow it clamps r to nr - 1 (rows past the window only
// feed output rows that are dropped).
// ---------------------------------------------------------------------------

template <typename T> struct SRow { const T* p; int ld, nr, nk; };
template <typename T> struct SCol { const T* p; int ld, nr, nk; };
template <typename T> struct GRow { const T* p; int ld, nr, nk; };

template <typename T>
__device__ __forceinline__ float el(const SRow<T>& o, int r, int k) {
  return (r < o.nr && k < o.nk) ? to_f(o.p[r * o.ld + k]) : 0.f;
}
template <typename T>
__device__ __forceinline__ float el(const SCol<T>& o, int r, int k) {
  return (r < o.nr && k < o.nk) ? to_f(o.p[k * o.ld + r]) : 0.f;
}
template <typename T>
__device__ __forceinline__ float el(const GRow<T>& o, int r, int k) {
  return (r < o.nr && k < o.nk) ? to_f(o.p[(size_t)r * o.ld + k]) : 0.f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16x16 at m0, k0) in the m16n8k16 layout: lane g = lane/4,
// t = lane%4 holds rows g and g+8, columns 2t, 2t+1 and 2t+8, 2t+9.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const SRow<bf16>& o, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, o.p + (m0 + (l & 15)) * o.ld + k0 + ((l >> 4) << 3));
}
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const SCol<bf16>& o, int m0, int k0) {
  const int l = threadIdx.x & 31, j = l >> 3;
  ldsm_x4_t(a, o.p + (k0 + (l & 7) + ((j >> 1) << 3)) * o.ld + m0 + ((j & 1) << 3));
}
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const GRow<bf16>& o, int m0, int k0) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  const bf16* p0 = o.p + (size_t)min(m0 + g, o.nr - 1) * o.ld + k0 + 2 * t;
  const bf16* p1 = o.p + (size_t)min(m0 + g + 8, o.nr - 1) * o.ld + k0 + 2 * t;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// B fragment (columns n0..n0+7, k0..k0+15): lane holds column g, k 2t, 2t+1
// (b[0]) and 2t+8, 2t+9 (b[1]).
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const SRow<bf16>& o, int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x2(b, o.p + (n0 + (l & 7)) * o.ld + k0 + (((l >> 3) & 1) << 3));
}
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const SCol<bf16>& o, int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x2_t(b, o.p + (k0 + (l & 7) + (((l >> 3) & 1) << 3)) * o.ld + n0);
}
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const GRow<bf16>& o, int n0, int k0) {
  const int l = threadIdx.x & 31;
  const bf16* p = o.p + (size_t)min(n0 + (l >> 2), o.nr - 1) * o.ld + k0 + 2 * (l & 3);
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] += A[m0+16i : +16, :K] . B[n0+8j : +8, :K]^T for i < mt (<= MT),
// j < NT, in the m16n8 accumulator layout (rows g, g+8; columns 2t, 2t+1).
// K is a multiple of 16.
template <int MT, int NT, template <class> class OA, template <class> class OB>
__device__ __forceinline__ void mma_block(float (&acc)[MT][NT][4], const OA<bf16>& A, int m0,
                                          int mt, const OB<bf16>& B, int n0, int K) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) frag_b(b[j], B, n0 + 8 * j, k0);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < mt) frag_a(a[i], A, m0 + 16 * i, k0);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < mt)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
  }
}

// mma_block with the B fragments of kPf k16 steps loaded before their
// mmas: the token kernels' weights come from L2 with 32-bit loads, and one
// step's loads alone leave a warp waiting on each. The same sums in the
// same order as mma_block.
constexpr int kPf = 4;
template <int MT, int NT, template <class> class OA>
__device__ __forceinline__ void mma_block_pf(float (&acc)[MT][NT][4], const OA<bf16>& A, int m0,
                                             int mt, const GRow<bf16>& B, int n0, int K) {
  for (int k0 = 0; k0 < K; k0 += 16 * kPf) {
    uint32_t b[kPf][NT][2];
#pragma unroll
    for (int st = 0; st < kPf; ++st)
      if (k0 + 16 * st < K)
#pragma unroll
        for (int j = 0; j < NT; ++j) frag_b(b[st][j], B, n0 + 8 * j, k0 + 16 * st);
#pragma unroll
    for (int st = 0; st < kPf; ++st) {
      if (k0 + 16 * st >= K) continue;
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (i < mt) frag_a(a[i], A, m0 + 16 * i, k0 + 16 * st);
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (i < mt)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[st][j]);
    }
  }
}
template <int MT, int NT, template <class> class OA>
__device__ __forceinline__ void mma_block_pf(float (&acc)[MT][NT][4], const OA<float>& A, int m0,
                                             int mt, const GRow<float>& B, int n0, int K) {
  mma_block(acc, A, m0, mt, B, n0, K);
}

// The same tile in fp32 on the CUDA cores, with the same ownership.
template <int MT, int NT, template <class> class OA, template <class> class OB>
__device__ __forceinline__ void mma_block(float (&acc)[MT][NT][4], const OA<float>& A, int m0,
                                          int mt, const OB<float>& B, int n0, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    float b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b[j][0] = el(B, n0 + 8 * j + 2 * t, k);
      b[j][1] = el(B, n0 + 8 * j + 2 * t + 1, k);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mt) continue;
      const float a0 = el(A, m0 + 16 * i + g, k), a1 = el(A, m0 + 16 * i + g + 8, k);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[i][j][0] = fmaf(a0, b[j][0], acc[i][j][0]);
        acc[i][j][1] = fmaf(a0, b[j][1], acc[i][j][1]);
        acc[i][j][2] = fmaf(a1, b[j][0], acc[i][j][2]);
        acc[i][j][3] = fmaf(a1, b[j][1], acc[i][j][3]);
      }
    }
  }
}

// Split an (M, Nc) output into warp tiles of 16*MT x 8*NT, dealt to the
// block's warps in turn. body(acc, m0, mt, n0) accumulates a tile of mt
// row tiles; epi(r, c, v0, v1) gets its values in column pairs (c even;
// v0 at column c, v1 at c + 1), so that stores and bias loads move two
// values at a time. M is a multiple of 16, Nc of 8*NT.
template <int MT, int NT, typename Body, typename Epi>
__device__ __forceinline__ void for_tiles(int M, int Nc, Body body, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tm = (M + 16 * MT - 1) / (16 * MT), tn = Nc / (8 * NT);
  for (int tile = warp; tile < tm * tn; tile += kWarps) {
    const int m0 = (tile / tn) * 16 * MT, n0 = (tile % tn) * 8 * NT;
    const int mt = min(MT, (M - m0) / 16);
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    body(acc, m0, mt, n0);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mt) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = m0 + 16 * i + g, c = n0 + 8 * j + 2 * t;
        epi(r, c, acc[i][j][0], acc[i][j][1]);
        epi(r + 8, c, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

// Two adjacent values of T at p (p 2-element aligned: every row stride and
// column offset the kernels use is even).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// Two read-only fp32 values (a bias, through the read-only path, so the
// compiler may load them ahead of the epilogue's stores).
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void add2(float* p, float a, float b) {
  float2 v = *reinterpret_cast<float2*>(p);
  v.x += a;
  v.y += b;
  *reinterpret_cast<float2*>(p) = v;
}

struct Geo {
  int B_, N, C, nH, hd, M, nW, Rp, chunks;
  int R;                        // backward: rows of a token tile
  int fwarps, frun, bwarps, brun;  // backward: the attention tiles' plans
  int S;     // workspace row stride: 8C + 2M
  int V;     // per-window vector partials: 9C + M
  float scale, eps;
};

// Workspace columns and vector-partial offsets.
__host__ __device__ inline int ws_y(const Geo&) { return 0; }
__host__ __device__ inline int ws_dqkv(const Geo& g) { return g.C; }
__host__ __device__ inline int ws_a(const Geo& g) { return 4 * g.C; }
__host__ __device__ inline int ws_do1(const Geo& g) { return 5 * g.C; }
__host__ __device__ inline int ws_y2(const Geo& g) { return 6 * g.C; }
__host__ __device__ inline int ws_do2(const Geo& g) { return 7 * g.C; }
__host__ __device__ inline int ws_g(const Geo& g) { return 8 * g.C; }
__host__ __device__ inline int ws_dh(const Geo& g) { return 8 * g.C + g.M; }
enum VecSlot { V_DG1 = 0, V_DBE1 = 1, V_DBQKV = 2, V_DBP = 5, V_DG2 = 6, V_DBE2 = 7, V_DB2 = 8,
               V_DB1 = 9 };   // times C; db1 (M values) is last

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// The forward's shared memory: c0 holds y or y2; o holds a (T) in the
// attention phase and the fp32 (N x ldO) fc2 accumulator later; the head
// buffers (q, k, v, scores s, p) and the MLP chunk buffer h share one
// region. Tiles of T have `rows` rows: Rp for bf16 (the tensor-core path
// reads whole 16-row tiles), N for fp32.
struct Layout {
  int rows, ldC, ldH, ldS, ldP, ldM, ldO;
  size_t c0, o, q, k, v, s, p, h, stats, reg, bytes;
};

__host__ __device__ inline Layout make_layout(int N, int C, int hd, int Rp, int es) {
  Layout L;
  const int pad = 16 / es;   // 16 bytes: aligned, conflict-free ldmatrix rows
  L.rows = es == 2 ? Rp : N;
  L.ldC = C + pad;
  L.ldH = hd + pad;
  L.ldS = Rp + 4;
  L.ldP = Rp + pad;
  L.ldM = kMc + pad;
  L.ldO = C + 4;
  const size_t R = L.rows;
  const size_t cT = align16(R * L.ldC * es), cO = align16((size_t)N * L.ldO * 4);
  const size_t hT = align16(R * L.ldH * es), sF = align16((size_t)N * L.ldS * 4);
  const size_t pT = align16(R * L.ldP * es), mT = align16(R * L.ldM * es);
  L.c0 = 0;
  L.o = cT;
  const size_t heads = L.o + (cT > cO ? cT : cO);
  L.q = heads;
  L.k = L.q + hT;
  L.v = L.k + hT;
  L.s = L.v + hT;
  L.p = L.s + sF;
  L.h = heads;
  const size_t end_attn = L.p + pT, end_mlp = L.h + mT;
  L.stats = end_attn > end_mlp ? end_attn : end_mlp;
  L.reg = L.stats + 4 * kMaxN * sizeof(float);
  L.bytes = L.reg + kMaxN * sizeof(int);
  return L;
}

// Row statistics slots in shared memory (a token tile uses the first two,
// for its LayerNorm's mean and 1/std).
enum Stat { MU1 = 0, RS1 = 1, MU2 = 2, RS2 = 3 };

template <typename T> struct Block {
  void* const* P;
  Geo g;
  Layout L;
  char* smem;
  int w, img;
  size_t row0;   // first row of the window
  const int* region;
  const float* pad;
  const float* keep1;
  const float* keep2;

  template <typename U> __device__ U* at(size_t off) const {
    return reinterpret_cast<U*>(smem + off);
  }
  template <typename U> __device__ U* ptr(int i) const { return static_cast<U*>(P[i]); }
  __device__ float* stat(int s) const { return at<float>(L.stats) + s * kMaxN; }
  // A shared-memory tile of T at `off` with row stride ld, as an operand
  // (nr rows, nk columns).
  __device__ SRow<T> tile(size_t off, int ld, int nr, int nk) const {
    return SRow<T>{at<T>(off), ld, nr, nk};
  }
  __device__ SCol<T> tile_t(size_t off, int ld, int nr, int nk) const {
    return SCol<T>{at<T>(off), ld, nr, nk};
  }
};

// Store (v0, v1) at row r, columns c, c + 1 of a shared-memory tile of T;
// rows N..L.rows get 0.
template <typename T>
__device__ __forceinline__ bool put2(const Block<T>& b, T* dst, int ld, int r, int c, float v0,
                                     float v1) {
  if (r < b.g.N) {
    store2(dst + r * ld + c, v0, v1);
    return true;
  }
  if (r < b.L.rows) store2(dst + r * ld + c, 0.f, 0.f);
  return false;
}

// Zero rows N..L.rows of a shared-memory tile of T (its first `cols`
// columns).
template <typename T> __device__ void zero_pad_rows(const Block<T>& b, T* dst, int ld, int cols) {
  const int n = (b.L.rows - b.g.N) * cols;
  for (int e = threadIdx.x; e < n; e += kThreads)
    dst[(b.g.N + e / cols) * ld + e % cols] = from_f<T>(0.f);
}

// LayerNorm of the window's rows (warp per row, the row read once into
// registers) from src (row stride C) into dst (stride ldC, the compute
// dtype), times the pad multiplier; mean and 1/std go to the stats slots.
template <typename T>
__device__ void layer_norm(const Block<T>& b, const T* src, const float* gam,
                           const float* bet, const float* pad, T* dst, int smu, int srs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, C = b.g.C;
  for (int r = warp; r < b.g.N; r += kWarps) {
    const T* x = src + (size_t)r * C;
    float v[kMaxC / 32];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxC / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? to_f(x[c]) : 0.f;
      if (c < C) {
        s += v[i];
        ss += v[i] * v[i];
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / C;
    const float rs = rsqrtf(ss / C - mu * mu + b.g.eps);
    const float pm = pad != nullptr ? pad[r] : 1.f;
#pragma unroll
    for (int i = 0; i < kMaxC / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < C)
        dst[r * b.L.ldC + c] = from_f<T>(rnd<T>((v[i] - mu) * rs * gam[c] + bet[c]) * pm);
    }
    if (lane == 0) {
      b.stat(smu)[r] = mu;
      b.stat(srs)[r] = rs;
    }
  }
  zero_pad_rows(b, dst, b.L.ldC, C);
}

// q (as round(q * round(scale))), k, v of head h from y in c0: one product
// of 3*hd columns (head h's rows of the head-major WQKV_F).
template <typename T> __device__ void head_qkv(const Block<T>& b, int h) {
  const Geo& g = b.g;
  const Layout& L = b.L;
  const SRow<T> Y = b.tile(L.c0, L.ldC, g.N, g.C);
  const GRow<T> W{b.template ptr<T>(WQKV_F) + (size_t)h * 3 * g.hd * g.C, g.C, 3 * g.hd, g.C};
  const float qscale = rnd<T>(g.scale);
  const float* bqkv = b.template ptr<float>(BQKV);
  T* dst[3] = {b.template at<T>(L.q), b.template at<T>(L.k), b.template at<T>(L.v)};
  for_tiles<2, 3>(
      g.Rp, 3 * g.hd,
      [&](auto& acc, int m0, int mt, int n0) { mma_block(acc, Y, m0, mt, W, n0, g.C); },
      [&](int r, int c, float v0, float v1) {
        const int part = c / g.hd, cc = c - part * g.hd;
        const float2 bb = load2(bqkv + part * g.C + h * g.hd + cc);
        float a0 = rnd<T>(rnd<T>(v0) + rnd<T>(bb.x)), a1 = rnd<T>(rnd<T>(v1) + rnd<T>(bb.y));
        if (part == 0) {
          a0 = rnd<T>(a0 * qscale);
          a1 = rnd<T>(a1 * qscale);
        }
        put2(b, dst[part], L.ldH, r, cc, a0, a1);
      });
}

// Scores and fp32 softmax of head h: p32 into s, round(p) into p (rows
// N..Rp of p zeroed).
template <typename T> __device__ void head_softmax(const Block<T>& b, int h) {
  const Geo& g = b.g;
  const Layout& L = b.L;
  const int N = g.N;
  float* sS = b.template at<float>(L.s);
  const int* sreg = b.template at<int>(L.reg);
  const float* bias = b.template ptr<float>(BIAS) + (size_t)h * N * N;
  const SRow<T> Q = b.tile(L.q, L.ldH, N, g.hd);
  const SRow<T> K = b.tile(L.k, L.ldH, N, g.hd);
  for_tiles<2, 2>(
      g.Rp, g.Rp,
      [&](auto& acc, int m0, int mt, int n0) { mma_block(acc, Q, m0, mt, K, n0, g.hd); },
      [&](int r, int c, float v0, float v1) {
        if (r >= N) return;
        float s0 = kDeadKey, s1 = kDeadKey;
        if (c < N) {
          s0 = v0 + bias[r * N + c];
          if (b.region != nullptr && sreg[r] != sreg[c]) s0 += -100.f;
        }
        if (c + 1 < N) {
          s1 = v1 + bias[r * N + c + 1];
          if (b.region != nullptr && sreg[r] != sreg[c + 1]) s1 += -100.f;
        }
        store2(sS + r * L.ldS + c, s0, s1);
      });
  T* sP = b.template at<T>(L.p);
  zero_pad_rows(b, sP, L.ldP, g.Rp);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < N; r += kWarps) {
    float s[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = lane + 32 * t;
      s[t] = c < g.Rp ? sS[r * L.ldS + c] : -INFINITY;
    }
    const float m = warp_max(fmaxf(s[0], s[1]));
    float e[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) e[t] = (lane + 32 * t < g.Rp) ? expf(s[t] - m) : 0.f;
    const float inv = 1.f / warp_sum(e[0] + e[1]);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = lane + 32 * t;
      if (c < g.Rp) {
        const float p = e[t] * inv;
        sS[r * L.ldS + c] = p;
        sP[r * L.ldP + c] = from_f<T>(p);
      }
    }
  }
}

// The forward up to x2 (written to x2_out) and y2 (into c0). Leaves LN2's
// mean and 1/std in the stats.
template <typename T> __device__ void forward_to_y2(const Block<T>& b, T* x2_out) {
  const Geo& g = b.g;
  const Layout& L = b.L;
  const int N = g.N, C = g.C;
  T* sY = b.template at<T>(L.c0);
  T* sA = b.template at<T>(L.o);
  const T* x = b.template ptr<T>(X) + b.row0 * C;

  layer_norm(b, x, b.template ptr<float>(G1), b.template ptr<float>(BE1), b.pad, sY, MU1, RS1);
  __syncthreads();

  for (int h = 0; h < g.nH; ++h) {
    head_qkv(b, h);
    __syncthreads();
    head_softmax(b, h);
    __syncthreads();
    const SRow<T> Pm = b.tile(L.p, L.ldP, N, N);
    const SCol<T> V = b.tile_t(L.v, L.ldH, g.hd, N);
    for_tiles<1, 2>(
        g.Rp, g.hd,
        [&](auto& acc, int m0, int mt, int n0) { mma_block(acc, Pm, m0, mt, V, n0, g.Rp); },
        [&](int r, int c, float v0, float v1) { put2(b, sA + h * g.hd, L.ldC, r, c, v0, v1); });
    __syncthreads();
  }

  // proj, drop-path residual: x2 = x + round(o1 * keep1)
  const SRow<T> A = b.tile(L.o, L.ldC, N, C);
  const GRow<T> Wp{b.template ptr<T>(WP_F), C, C, C};
  const float* bp = b.template ptr<float>(BP);
  const float d1 = b.keep1 != nullptr ? b.keep1[b.img] : 1.f;
  for_tiles<2, 4>(
      g.Rp, C,
      [&](auto& acc, int m0, int mt, int n0) { mma_block(acc, A, m0, mt, Wp, n0, C); },
      [&](int r, int c, float v0, float v1) {
        if (r >= N) return;
        const float2 bb = load2(bp + c);
        float o0 = rnd<T>(rnd<T>(v0) + rnd<T>(bb.x)), o1 = rnd<T>(rnd<T>(v1) + rnd<T>(bb.y));
        if (b.keep1 != nullptr) {
          o0 = rnd<T>(o0 * d1);
          o1 = rnd<T>(o1 * d1);
        }
        const float2 xv = load2(x + (size_t)r * C + c);
        store2(x2_out + (size_t)r * C + c, xv.x + o0, xv.y + o1);
      });
  __syncthreads();
  layer_norm(b, x2_out, b.template ptr<float>(G2), b.template ptr<float>(BE2), nullptr, sY, MU2,
             RS2);
  __syncthreads();
}

// h = round(round(y2 W1[chunk]) + round(b1)) into sH (the MLP chunk at m0);
// with apply_gelu, round(gelu(h)) instead.
template <typename T>
__device__ void mlp_hidden(const Block<T>& b, int m0, T* sH, bool apply_gelu) {
  const Geo& g = b.g;
  const Layout& L = b.L;
  const SRow<T> Y2 = b.tile(L.c0, L.ldC, g.N, g.C);
  const GRow<T> W1{b.template ptr<T>(W1_F) + (size_t)m0 * g.C, g.C, kMc, g.C};
  const float* b1 = b.template ptr<float>(B1) + m0;
  for_tiles<2, 4>(
      g.Rp, kMc,
      [&](auto& acc, int mm, int mt, int n0) { mma_block(acc, Y2, mm, mt, W1, n0, g.C); },
      [&](int r, int c, float v0, float v1) {
        const float2 bb = load2(b1 + c);
        float h0 = rnd<T>(v0) + rnd<T>(bb.x), h1 = rnd<T>(v1) + rnd<T>(bb.y);
        if (apply_gelu) {
          h0 = gelu(rnd<T>(h0));
          h1 = gelu(rnd<T>(h1));
        }
        put2(b, sH, L.ldM, r, c, h0, h1);
      });
}

template <typename T> __device__ Block<T> make_block(void* const* P, const Geo& g, char* smem) {
  Block<T> b;
  b.P = P;
  b.g = g;
  b.L = make_layout(g.N, g.C, g.hd, g.Rp, sizeof(T));
  b.smem = smem;
  b.w = blockIdx.x;
  b.img = b.w / g.nW;
  b.row0 = (size_t)b.w * g.N;
  const int wt = b.w % g.nW;
  b.region = static_cast<const int*>(P[REGION]);
  b.pad = P[PAD] != nullptr ? static_cast<const float*>(P[PAD]) + (size_t)wt * g.N : nullptr;
  b.keep1 = static_cast<const float*>(P[KEEP1]);
  b.keep2 = static_cast<const float*>(P[KEEP2]);
  if (b.region != nullptr) {
    int* sreg = b.template at<int>(b.L.reg);
    for (int j = threadIdx.x; j < g.N; j += kThreads) sreg[j] = b.region[(size_t)wt * g.N + j];
  }
  return b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_block_fwd_kernel(Table tab, Geo g) {
  extern __shared__ __align__(16) char smem[];
  const Block<T> b = make_block<T>(tab.p, g, smem);
  const Layout& L = b.L;
  const int N = g.N, C = g.C;
  T* out = b.template ptr<T>(OUT) + b.row0 * C;
  forward_to_y2(b, out);

  float* sO = b.template at<float>(L.o);
  T* sH = b.template at<T>(L.h);
  for (int e = threadIdx.x; e < N * L.ldO; e += kThreads) sO[e] = 0.f;
  __syncthreads();
  const T* w2 = b.template ptr<T>(W2_F);
  for (int m0 = 0; m0 < g.M; m0 += kMc) {
    mlp_hidden(b, m0, sH, true);
    __syncthreads();
    const SRow<T> G = b.tile(L.h, L.ldM, N, kMc);
    const GRow<T> W2{w2 + m0, g.M, C, kMc};
    for_tiles<2, 4>(
        g.Rp, C,
        [&](auto& acc, int m, int mt, int n0) { mma_block(acc, G, m, mt, W2, n0, kMc); },
        [&](int r, int c, float v0, float v1) {
          if (r < N) add2(sO + r * L.ldO + c, v0, v1);
        });
    __syncthreads();
  }
  const float* b2 = b.template ptr<float>(B2);
  const float d2 = b.keep2 != nullptr ? b.keep2[b.img] : 1.f;
  for (int e0 = threadIdx.x; e0 < N * C; e0 += kRB * kThreads) {
    float xv[kRB];
#pragma unroll
    for (int u = 0; u < kRB; ++u) {
      const int e = e0 + u * kThreads;
      xv[u] = e < N * C ? to_f(out[e]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRB; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= N * C) continue;
      const int r = e / C, c = e - r * C;
      float o2 = rnd<T>(rnd<T>(sO[r * L.ldO + c]) + rnd<T>(b2[c]));
      if (b.keep2 != nullptr) o2 = rnd<T>(o2 * d2);
      out[e] = from_f<T>(xv[u] + o2);
    }
  }
}

// ---------------------------------------------------------------------------
// The backward: what is per token runs on token tiles, and only attention
// stays per window. Five kernels in a row, then the weight gradients:
//   T1 (token tiles): y = round(LN1(x)) * pad to the workspace, qkv =
//      round(round(y Wqkv) + round(bqkv)) to QKV ([q | k | v], head-major
//      columns within each);
//   A1 (windows): a = round(round(p) v), the forward tile of
//      window_attention_tile.cuh on QKV with TableBias (the table plus the
//      -100 region mask), into the workspace's a column;
//   T2 (token tiles): x2 = x + round(round(round(a Wp) + round(bp)) keep1)
//      (kept in DX until T3), y2 = round(LN2(x2)), do2 = round(do keep2),
//      then per MLP chunk h, dh = round(round(do2 W2^T) gelu'(h)), g =
//      round(gelu(h)) and dy2 += dh W1^T; the LN2 backward gives dx2 =
//      do + dLN2 (fp32, DX32) and do1 = dx2 keep1; da = round(do1 Wp^T)
//      to DA;
//   A2 (windows): dq, dk, dv from QKV and DA on the backward tile of
//      window_attention_tile.cuh, into the workspace's dqkv columns, and
//      the dbias partials, summed in a fixed order into D_BIAS;
//   T3 (token tiles): dy = dq Wq^T + dk Wk^T + dv Wv^T (one product over
//      the 3C columns), the LN1 backward with the pad rows' dy masked, dx
//      = round(dx2 + dLN1);
// each token tile writes one row of fixed-order vector partials (VPART:
// the bias and LayerNorm gradients). A token tile of R rows (64, or 32 at
// C=384; the wrapper's plan) crosses window and image boundaries: a row's
// image is row / (nW N) and its pad multiplier pad[row % (nW N)].
//
// Why: a per-window row kernel (the earlier design) ran every C-wide product at the
// window's 49 rows (64 padded), fetched each weight fragment from L2 again
// for every window, and chained ~100 barriers through one ~190 KB block
// per SM. Token tiles give each weight fragment up to 64 rows, take less
// shared memory (up to three blocks per SM), and leave the window-local
// part, softmax(q k^T + bias) v and its backward, to the warp-level tiles.
// The intermediates (qkv, a, da, dqkv, x2, dx2) go through device memory,
// ~0.85 GB of traffic per call at Swin-T's 224 px stage 0.
// ---------------------------------------------------------------------------

// A token tile's shared memory: y (or y2, x2) in T at stride ldC (T1,
// T2), two MLP chunk tiles h and dh at ldM (T2), the fp32 dy accumulator
// at ldO (T2, T3), the staged A operand `a` of the products whose rows
// come from device memory (a, do2, do1 in T2; a third of dq | dk | dv in
// T3) at ldC, T2's output gradient `d` at ldC, T1's qkv output `o` at
// ld3, and two fp32 statistics per row
// (the LayerNorm's mean and 1/std). y, h and dh are adjacent: T2 reuses
// them for its column partials once the MLP is done. Results leave shared
// memory by tok_store's 16-byte rows, not from the products' epilogues.
struct TokLayout {
  int ldC, ldM, ldO, ld3;
  size_t y, h, dh, dy, a, d, o, stats, bytes;
};

__host__ __device__ inline TokLayout tok_layout(int kernel, int R, int C, int es) {
  TokLayout L;
  const int pad = 16 / es;
  L.ldC = C + pad;
  L.ldM = kMc + pad;
  L.ldO = C + 4;
  L.ld3 = 3 * C + pad;
  size_t off = 0;
  L.y = off;
  if (kernel != 3) off += align16((size_t)R * L.ldC * es);
  L.h = off;
  if (kernel == 2) off += align16((size_t)R * L.ldM * es);
  L.dh = off;
  if (kernel == 2) off += align16((size_t)R * L.ldM * es);
  L.dy = off;
  if (kernel != 1) off += align16((size_t)R * L.ldO * 4);
  L.a = off;
  if (kernel != 1) off += align16((size_t)R * L.ldC * es);
  L.d = off;
  if (kernel == 2) off += align16((size_t)R * L.ldC * es);
  L.o = off;
  if (kernel == 1) off += align16((size_t)R * L.ld3 * es);
  L.stats = off;
  L.bytes = off + (size_t)2 * R * sizeof(float);
  return L;
}

template <typename T> struct Tok {
  void* const* P;
  Geo g;
  TokLayout L;
  char* smem;
  size_t row0;  // first row of the tile
  int n, Rp;    // rows, and rows rounded up to 16
  int per_img;  // rows of one image: nW N

  template <typename U> __device__ U* at(size_t off) const {
    return reinterpret_cast<U*>(smem + off);
  }
  template <typename U> __device__ U* ptr(int i) const { return static_cast<U*>(P[i]); }
  __device__ T* ws_row(int r) const { return ptr<T>(WS) + (row0 + r) * (size_t)g.S; }
  __device__ float* stat(int s) const { return at<float>(L.stats) + s * g.R; }
  __device__ float pad(int r) const {
    const float* p = ptr<float>(PAD);
    return p != nullptr ? p[(row0 + r) % per_img] : 1.f;
  }
  __device__ float keep(int which, int r) const {
    const float* k = ptr<float>(which);
    return k != nullptr ? k[(row0 + r) / per_img] : 1.f;
  }
};

template <typename T> __device__ Tok<T> make_tok(void* const* P, const Geo& g, int kernel,
                                                 char* smem) {
  Tok<T> b;
  b.P = P;
  b.g = g;
  b.L = tok_layout(kernel, g.R, g.C, sizeof(T));
  b.smem = smem;
  // The count from plain ints: written as min(g.R, g.B_ * g.N - (int)row0)
  // with a size_t row0, ptxas (CUDA 12.9, -O3) folded the subtraction and
  // the min of T2 alone into one VIADDMNMX that dropped the negation,
  // min(row0 + rows, R), so T2's ragged last tile took R rows; the PTX
  // (sub.s32, min.s32) was right, and so was ptxas -O0.
  const int row0 = blockIdx.x * g.R, left = g.B_ * g.N - row0;
  b.row0 = (size_t)row0;
  b.n = left < g.R ? left : g.R;
  b.Rp = (b.n + 15) / 16 * 16;
  b.per_img = g.nW * g.N;
  return b;
}

// LayerNorm statistics of the tile's rows of src (row stride ld_src; warp
// per row, the row read once into registers) into the MU/RS slots; with
// dst, round(LN(x)) (times the pad multiplier if use_pad) at stride ldC,
// rows n..Rp zeroed (dst may be src: a warp reads its row before writing
// it). The arithmetic of layer_norm above.
template <typename T>
__device__ void tok_layer_norm(const Tok<T>& b, const T* src, int ld_src, const float* gam,
                               const float* bet, bool use_pad, T* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, C = b.g.C;
  for (int r = warp; r < b.n; r += kWarps) {
    const T* x = src + (size_t)r * ld_src;
    float v[kMaxC / 32];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxC / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? to_f(x[c]) : 0.f;
      if (c < C) {
        s += v[i];
        ss += v[i] * v[i];
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / C;
    const float rs = rsqrtf(ss / C - mu * mu + b.g.eps);
    if (dst != nullptr) {
      const float pm = use_pad ? b.pad(r) : 1.f;
#pragma unroll
      for (int i = 0; i < kMaxC / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < C)
          dst[r * b.L.ldC + c] = from_f<T>(rnd<T>((v[i] - mu) * rs * gam[c] + bet[c]) * pm);
      }
    }
    if (lane == 0) {
      b.stat(MU1)[r] = mu;
      b.stat(RS1)[r] = rs;
    }
  }
  if (dst != nullptr)
    for (int e = threadIdx.x; e < (b.Rp - b.n) * C; e += kThreads)
      dst[(b.n + e / C) * b.L.ldC + e % C] = from_f<T>(0.f);
}

// Row-parallel element loops: a warp per row, each lane on the column
// pairs c = 64 i + 2 lane (i < kPairs), the row read once into registers.
// Column sums (the bias and LayerNorm gradients) accumulate per lane over
// the warp's rows and go to `part` ([kWarps][ld] fp32, shared); then
// warp_partials_sum adds the warps in order. Fixed order: bit-identical.
constexpr int kPairs = kMaxC / 64;

__device__ __forceinline__ float2 add_f2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// out[c] = sum over warps w (in order) of part[w * ld + c], c < ncol.
__device__ void warp_partials_sum(const float* part, int ld, int ncol, float* out) {
  for (int c = threadIdx.x; c < ncol; c += kThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += part[w * ld + c];
    out[c] = acc;
  }
}

// The LayerNorm backward of one row held in registers: x (the LN input)
// and dy (fp32, already times the pad multiplier) at the lane's column
// pairs, the row's mean and 1/std; returns dLN in dy's place and adds
// dy * xhat and dy into dg and dbe.
__device__ __forceinline__ void ln_bwd_row(float2 (&x)[kPairs], float2 (&dy)[kPairs],
                                           const float* gam, int C, float mu, float rs,
                                           float2 (&dg)[kPairs], float2 (&dbe)[kPairs]) {
  const int lane = threadIdx.x & 31;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int c = 64 * i + 2 * lane;
    if (c >= C) continue;
    const float2 gg = load2(gam + c);
    x[i] = make_float2((x[i].x - mu) * rs, (x[i].y - mu) * rs);  // xhat
    s1 += dy[i].x * gg.x + dy[i].y * gg.y;
    s2 += dy[i].x * gg.x * x[i].x + dy[i].y * gg.y * x[i].y;
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int c = 64 * i + 2 * lane;
    if (c >= C) continue;
    const float2 gg = load2(gam + c);
    dg[i] = add_f2(dg[i], make_float2(dy[i].x * x[i].x, dy[i].y * x[i].y));
    dbe[i] = add_f2(dbe[i], dy[i]);
    dy[i] = make_float2(rs * (dy[i].x * gg.x - m1 - x[i].x * m2),
                        rs * (dy[i].y * gg.y - m1 - x[i].y * m2));
  }
}

// Stores a lane's column-pair sums into its warp's row of `part`.
__device__ __forceinline__ void put_partial(float* part, int ld, int C, const float2 (&v)[kPairs]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int c = 64 * i + 2 * lane;
    if (c < C) store2(part + warp * ld + c, v[i].x, v[i].y);
  }
}

// Starts copying the tile's rows (`cols` columns of src, row 0 at src,
// stride ld_src) into a shared tile of stride ld with 16-byte cp.async;
// tok_wait() waits for this thread's copies (a barrier then publishes
// them).
template <typename T>
__device__ void tok_stage(const Tok<T>& b, const T* src, size_t ld_src, int cols, T* dst,
                          int ld) {
  constexpr int kPer = 16 / sizeof(T);
  const int cpr = cols / kPer;
  for (int e = threadIdx.x; e < b.n * cpr; e += kThreads) {
    const int r = e / cpr, c = (e - r * cpr) * kPer;
    wtile::cp_async16(dst + r * ld + c, src + r * ld_src + c);
  }
}

__device__ __forceinline__ void tok_wait() {
  wtile::cp_async_commit();
  wtile::cp_async_wait<0>();
}

// Copies the tile's rows of a shared tile (`cols` columns, stride ld) to
// dst (row 0 of the tile, stride ld_dst), 16 bytes a thread at a time.
template <typename T>
__device__ void tok_store(const Tok<T>& b, const T* src, int ld, int cols, T* dst,
                          size_t ld_dst) {
  constexpr int kPer = 16 / sizeof(T);
  const int cpr = cols / kPer;
  for (int e = threadIdx.x; e < b.n * cpr; e += kThreads) {
    const int r = e / cpr, c = (e - r * cpr) * kPer;
    *reinterpret_cast<uint4*>(dst + r * ld_dst + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// The token kernels ask for two blocks per SM (at most 128 registers a
// thread): their shared memory allows two or more in bf16.

// T1: y and qkv.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) fused_bwd_t1_kernel(Table tab, Geo g) {
  extern __shared__ __align__(16) char smem[];
  const Tok<T> b = make_tok<T>(tab.p, g, 1, smem);
  const int C = g.C, hd = g.hd;
  T* sY = b.template at<T>(b.L.y);
  tok_layer_norm(b, b.template ptr<T>(X) + b.row0 * C, C, b.template ptr<float>(G1),
                 b.template ptr<float>(BE1), true, sY);
  __syncthreads();
  tok_store(b, sY, b.L.ldC, C, b.ws_row(0) + ws_y(g), g.S);
  const SRow<T> Y{sY, b.L.ldC, b.n, C};
  const GRow<T> W{b.template ptr<T>(WQKV_F), C, 3 * C, C};
  const float* bqkv = b.template ptr<float>(BQKV);
  T* sO = b.template at<T>(b.L.o);
  for_tiles<4, 2>(
      b.Rp, 3 * C,
      [&](auto& acc, int m0, int mt, int n0) { mma_block_pf(acc, Y, m0, mt, W, n0, C); },
      [&](int r, int c, float v0, float v1) {
        if (r >= b.n) return;
        // WQKV_F's rows are head-major: row c is head h's q, k or v column cc
        const int h = c / (3 * hd), rem = c - h * 3 * hd, part = rem / hd;
        const int col = part * C + h * hd + (rem - part * hd);
        const float2 bb = ldg2(bqkv + col);
        store2(sO + r * b.L.ld3 + col, rnd<T>(rnd<T>(v0) + rnd<T>(bb.x)),
               rnd<T>(rnd<T>(v1) + rnd<T>(bb.y)));
      });
  __syncthreads();
  tok_store(b, sO, b.L.ld3, 3 * C, b.template ptr<T>(QKV) + b.row0 * 3 * C, (size_t)3 * C);
}

// T2: the proj residual, LN2, the MLP backward, the LN2 backward and da.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) fused_bwd_t2_kernel(Table tab, Geo g) {
  extern __shared__ __align__(16) char smem[];
  const Tok<T> b = make_tok<T>(tab.p, g, 2, smem);
  const TokLayout& L = b.L;
  const int C = g.C, n = b.n;
  const T* x = b.template ptr<T>(X) + b.row0 * C;
  T* x2 = b.template ptr<T>(DX) + b.row0 * C;  // x2 until T3 writes dx
  const T* dout = b.template ptr<T>(DOUT) + b.row0 * C;
  float* vp = b.template ptr<float>(VPART) + (size_t)blockIdx.x * g.V;
  T* sY = b.template at<T>(L.y);
  T* sH = b.template at<T>(L.h);
  T* sDH = b.template at<T>(L.dh);
  float* sDY = b.template at<float>(L.dy);
  T* sA = b.template at<T>(L.a);  // a, then do2, then do1
  T* sD = b.template at<T>(L.d);  // the output gradient
  const SRow<T> A{sA, L.ldC, n, C};

  // x2 = x + round(round(round(a Wp) + round(bp)) * keep1), into DX and
  // sY; x comes in through sDY's room
  T* sX = reinterpret_cast<T*>(sDY);
  tok_stage(b, b.ws_row(0) + ws_a(g), g.S, C, sA, L.ldC);
  tok_stage(b, x, C, C, sX, L.ldC);
  tok_stage(b, dout, C, C, sD, L.ldC);
  tok_wait();
  __syncthreads();
  {
    const GRow<T> Wp{b.template ptr<T>(WP_F), C, C, C};
    const float* bp = b.template ptr<float>(BP);
    const bool k1 = b.template ptr<float>(KEEP1) != nullptr;
    for_tiles<4, 2>(
        b.Rp, C,
        [&](auto& acc, int m0, int mt, int n0) { mma_block_pf(acc, A, m0, mt, Wp, n0, C); },
        [&](int r, int c, float v0, float v1) {
          if (r >= n) return;
          const float2 bb = ldg2(bp + c);
          float o0 = rnd<T>(rnd<T>(v0) + rnd<T>(bb.x)), o1 = rnd<T>(rnd<T>(v1) + rnd<T>(bb.y));
          if (k1) {
            const float d1 = b.keep(KEEP1, r);
            o0 = rnd<T>(o0 * d1);
            o1 = rnd<T>(o1 * d1);
          }
          const float2 xv = load2(sX + r * L.ldC + c);
          store2(sY + r * L.ldC + c, xv.x + o0, xv.y + o1);
        });
  }
  __syncthreads();
  tok_store(b, sY, L.ldC, C, x2, (size_t)C);
  __syncthreads();  // x2 is out before LN2 overwrites it
  // y2 = round(LN2(x2)) in place
  tok_layer_norm(b, sY, L.ldC, b.template ptr<float>(G2), b.template ptr<float>(BE2), false,
                 sY);

  // do2 = round(do * keep2) into the workspace and sA; db2 = sum(do *
  // keep2), through sDY's room
  {
    float2 db2[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) db2[i] = make_float2(0.f, 0.f);
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < n; r += kWarps) {
      const float k2 = b.keep(KEEP2, r);
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int c = 64 * i + 2 * lane;
        if (c >= C) continue;
        float2 v = load2(sD + r * L.ldC + c);
        v = make_float2(v.x * k2, v.y * k2);
        db2[i] = add_f2(db2[i], v);
        store2(sA + r * L.ldC + c, v.x, v.y);
      }
    }
    put_partial(sDY, C, C, db2);
  }
  __syncthreads();
  warp_partials_sum(sDY, C, C, vp + V_DB2 * C);
  tok_store(b, sA, L.ldC, C, b.ws_row(0) + ws_do2(g), g.S);
  tok_store(b, sY, L.ldC, C, b.ws_row(0) + ws_y2(g), g.S);
  __syncthreads();
  for (int e = threadIdx.x; e < g.R * L.ldO; e += kThreads) sDY[e] = 0.f;
  __syncthreads();

  const SRow<T> Y2{sY, L.ldC, n, C};
  for (int m0 = 0; m0 < g.M; m0 += kMc) {
    // h = round(y2 W1[chunk]) + round(b1)
    const GRow<T> W1{b.template ptr<T>(W1_F) + (size_t)m0 * C, C, kMc, C};
    const float* b1 = b.template ptr<float>(B1) + m0;
    for_tiles<4, 2>(
        b.Rp, kMc,
        [&](auto& acc, int mm, int mt, int n0) { mma_block_pf(acc, Y2, mm, mt, W1, n0, C); },
        [&](int r, int c, float v0, float v1) {
          const float2 bb = ldg2(b1 + c);
          store2(sH + r * L.ldM + c, r < n ? rnd<T>(v0) + rnd<T>(bb.x) : 0.f,
                 r < n ? rnd<T>(v1) + rnd<T>(bb.y) : 0.f);
        });
    __syncthreads();
    // dh = round(round(do2 W2[chunk]^T) gelu'(h)); g = round(gelu(h)), over h
    const GRow<T> W2b{b.template ptr<T>(W2_B) + (size_t)m0 * C, C, kMc, C};
    for_tiles<4, 2>(
        b.Rp, kMc,
        [&](auto& acc, int mm, int mt, int n0) { mma_block_pf(acc, A, mm, mt, W2b, n0, C); },
        [&](int r, int c, float v0, float v1) {
          if (r >= n) {
            store2(sDH + r * L.ldM + c, 0.f, 0.f);
            return;
          }
          const float2 hv = load2(sH + r * L.ldM + c);
          store2(sDH + r * L.ldM + c, rnd<T>(rnd<T>(v0) * dgelu(hv.x)),
                 rnd<T>(rnd<T>(v1) * dgelu(hv.y)));
          store2(sH + r * L.ldM + c, gelu(hv.x), gelu(hv.y));  // g over h
        });
    __syncthreads();
    tok_store(b, sDH, L.ldM, kMc, b.ws_row(0) + ws_dh(g) + m0, g.S);
    tok_store(b, sH, L.ldM, kMc, b.ws_row(0) + ws_g(g) + m0, g.S);
    for (int c = threadIdx.x; c < kMc; c += kThreads) {
      float acc = 0.f;
      for (int r = 0; r < n; ++r) acc += to_f(sDH[r * L.ldM + c]);
      vp[V_DB1 * C + m0 + c] = acc;
    }
    // dy2 += dh W1[chunk]^T
    const SRow<T> DH{sDH, L.ldM, n, kMc};
    const GRow<T> W1b{b.template ptr<T>(W1_B) + m0, g.M, C, kMc};
    for_tiles<4, 2>(
        b.Rp, C,
        [&](auto& acc, int mm, int mt, int n0) { mma_block_pf(acc, DH, mm, mt, W1b, n0, kMc); },
        [&](int r, int c, float v0, float v1) {
          if (r < n) add2(sDY + r * L.ldO + c, v0, v1);
        });
    __syncthreads();
  }

  // LN2 backward; dx2 = do + dLN2; do1 = dx2 * keep1; dg2, dbe2, dbp
  // partials through the room of y2, h and dh (spent); x2 back in sY
  tok_stage(b, x2, C, C, sY, L.ldC);
  tok_wait();
  __syncthreads();
  {
    const float* g2 = b.template ptr<float>(G2);
    float* dx32 = b.template ptr<float>(DX32) + b.row0 * C;
    float2 dg[kPairs], dbe[kPairs], dbp[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) dg[i] = dbe[i] = dbp[i] = make_float2(0.f, 0.f);
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < n; r += kWarps) {
      float2 xv[kPairs], dy[kPairs], dov[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int c = 64 * i + 2 * lane;
        xv[i] = dy[i] = dov[i] = make_float2(0.f, 0.f);
        if (c >= C) continue;
        xv[i] = load2(sY + r * L.ldC + c);
        dov[i] = load2(sD + r * L.ldC + c);
        dy[i] = load2(sDY + r * L.ldO + c);
      }
      ln_bwd_row(xv, dy, g2, C, b.stat(MU1)[r], b.stat(RS1)[r], dg, dbe);
      const float k1 = b.keep(KEEP1, r);
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int c = 64 * i + 2 * lane;
        if (c >= C) continue;
        const float2 dx2 = add_f2(dov[i], dy[i]);
        store2(dx32 + (size_t)r * C + c, dx2.x, dx2.y);
        const float2 do1 = make_float2(dx2.x * k1, dx2.y * k1);
        dbp[i] = add_f2(dbp[i], do1);
        store2(sA + r * L.ldC + c, do1.x, do1.y);
      }
    }
    __syncthreads();  // every warp is done with y2, h and dh
    float* part = b.template at<float>(L.y);
    put_partial(part, 3 * C, C, dg);
    put_partial(part + C, 3 * C, C, dbe);
    put_partial(part + 2 * C, 3 * C, C, dbp);
    __syncthreads();
    warp_partials_sum(part, 3 * C, C, vp + V_DG2 * C);
    warp_partials_sum(part + C, 3 * C, C, vp + V_DBE2 * C);
    warp_partials_sum(part + 2 * C, 3 * C, C, vp + V_DBP * C);
    tok_store(b, sA, L.ldC, C, b.ws_row(0) + ws_do1(g), g.S);
  }
  __syncthreads();

  // da = round(do1 Wp^T), through sY's room (spent)
  const GRow<T> WpB{b.template ptr<T>(WP_B), C, C, C};
  for_tiles<4, 2>(
      b.Rp, C,
      [&](auto& acc, int m0, int mt, int n0) { mma_block_pf(acc, A, m0, mt, WpB, n0, C); },
      [&](int r, int c, float v0, float v1) {
        if (r < n) store2(sY + r * L.ldC + c, v0, v1);
      });
  __syncthreads();
  tok_store(b, sY, L.ldC, C, b.template ptr<T>(DA) + b.row0 * C, (size_t)C);
}

// T3: dy, the LN1 backward, dx and the q/k/v bias gradients.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) fused_bwd_t3_kernel(Table tab, Geo g) {
  extern __shared__ __align__(16) char smem[];
  const Tok<T> b = make_tok<T>(tab.p, g, 3, smem);
  const TokLayout& L = b.L;
  const int C = g.C, n = b.n;
  const T* x = b.template ptr<T>(X) + b.row0 * C;
  float* vp = b.template ptr<float>(VPART) + (size_t)blockIdx.x * g.V;
  float* sDY = b.template at<float>(L.dy);

  // dy = [dq | dk | dv] [Wq | Wk | Wv]^T, a third at a time through sA;
  // dbq | dbk | dbv, the tile's column sums of the rounded dq | dk | dv
  T* sA = b.template at<T>(L.a);
  const SRow<T> A{sA, L.ldC, n, C};
  for (int part = 0; part < 3; ++part) {
    tok_stage(b, b.ws_row(0) + ws_dqkv(g) + part * C, g.S, C, sA, L.ldC);
    tok_wait();
    __syncthreads();
    const GRow<T> W{b.template ptr<T>(WQKV_B) + part * C, 3 * C, C, C};
    for_tiles<4, 2>(
        b.Rp, C,
        [&](auto& acc, int m0, int mt, int n0) { mma_block_pf(acc, A, m0, mt, W, n0, C); },
        [&](int r, int c, float v0, float v1) {
          if (r >= n) return;
          if (part == 0)
            store2(sDY + r * L.ldO + c, v0, v1);
          else
            add2(sDY + r * L.ldO + c, v0, v1);
        });
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc = 0.f;
      for (int r = 0; r < n; ++r) acc += to_f(sA[r * L.ldC + c]);
      vp[(V_DBQKV + part) * C + c] = acc;
    }
    __syncthreads();
  }
  const float* g1 = b.template ptr<float>(G1);
  tok_layer_norm(b, x, C, g1, b.template ptr<float>(BE1), true, static_cast<T*>(nullptr));
  __syncthreads();

  // dx = round(dx2 + dLN1(dy * pad)); dg1, dbe1 partials through sDY's room
  const float* dx32 = b.template ptr<float>(DX32) + b.row0 * C;
  T* dx = b.template ptr<T>(DX) + b.row0 * C;
  const int lane = threadIdx.x & 31;
  {
    float2 dg[kPairs], dbe[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) dg[i] = dbe[i] = make_float2(0.f, 0.f);
    for (int r = threadIdx.x >> 5; r < n; r += kWarps) {
      const float pm = b.pad(r);
      float2 xv[kPairs], dy[kPairs], d32[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int c = 64 * i + 2 * lane;
        xv[i] = dy[i] = d32[i] = make_float2(0.f, 0.f);
        if (c >= C) continue;
        xv[i] = load2(x + (size_t)r * C + c);
        d32[i] = load2(dx32 + (size_t)r * C + c);
        const float2 d = load2(sDY + r * L.ldO + c);
        dy[i] = make_float2(d.x * pm, d.y * pm);
      }
      ln_bwd_row(xv, dy, g1, C, b.stat(MU1)[r], b.stat(RS1)[r], dg, dbe);
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int c = 64 * i + 2 * lane;
        if (c < C) store2(dx + (size_t)r * C + c, d32[i].x + dy[i].x, d32[i].y + dy[i].y);
      }
    }
    __syncthreads();  // every warp is done with sDY
    put_partial(sDY, 2 * C, C, dg);
    put_partial(sDY + C, 2 * C, C, dbe);
    __syncthreads();
    warp_partials_sum(sDY, 2 * C, C, vp + V_DG1 * C);
    warp_partials_sum(sDY + C, 2 * C, C, vp + V_DBE1 * C);
    __syncthreads();
  }
}

// Weight gradient partial: partial[chunk][i][j] = sum over the chunk's rows
// r of ws[r][offA + i] * ws[r][offB + j], for the 64x64 tile (blockIdx.x,
// blockIdx.y). Rows go through shared memory kR at a time; each warp owns
// a 32x16 piece of the tile. The fp32 path; bf16 takes wgrad_tc_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* ws, int S, int rows, int offA, int Ka, int offB, int Kb,
             int chunk_rows, float* partial) {
  constexpr int kT = 64, kR = 64, kLd = kT + 16 / (int)sizeof(T);
  constexpr int kVec = 16 / (int)sizeof(T);     // elements per 16-byte load
  __shared__ __align__(16) T sa[kR * kLd];
  __shared__ __align__(16) T sb[kR * kLd];
  const int i0 = blockIdx.x * kT, j0 = blockIdx.y * kT, chunk = blockIdx.z;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(rows, r_begin + chunk_rows);
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 1) * 32, n0 = (warp >> 1) * 16;
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const SCol<T> A{sa, kLd, kT, kR}, B{sb, kLd, kT, kR};
  for (int r0 = r_begin; r0 < r_end; r0 += kR) {
    for (int e = threadIdx.x; e < kR * kT / kVec; e += kThreads) {
      const int rr = e / (kT / kVec), ii = (e - rr * (kT / kVec)) * kVec, r = r0 + rr;
      const T* row = ws + (size_t)r * S;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (r < r_end && i0 + ii < Ka) va = *reinterpret_cast<const uint4*>(row + offA + i0 + ii);
      if (r < r_end && j0 + ii < Kb) vb = *reinterpret_cast<const uint4*>(row + offB + j0 + ii);
      *reinterpret_cast<uint4*>(sa + rr * kLd + ii) = va;
      *reinterpret_cast<uint4*>(sb + rr * kLd + ii) = vb;
    }
    __syncthreads();
    mma_block(acc, A, m0, 2, B, n0, kR);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + m0 + 16 * mi + g + (e >= 2 ? 8 : 0);
        const int jj = j0 + n0 + 8 * j + 2 * t + (e & 1);
        if (i < Ka && jj < Kb) partial[((size_t)chunk * Ka + i) * Kb + jj] = acc[mi][j][e];
      }
}

// The bf16 weight-gradient partial on the tensor cores, 128 x 128 tiles:
// the same partial[chunk][i][j] as wgrad_kernel. The chunk's rows come in
// kWR at a time through a kWStages-deep cp.async ring (16-byte copies,
// zero-filled past the chunk's rows and the operands' columns), so the
// next rows' loads are in flight while the current ones multiply; each
// warp owns a 64 x 32 piece (4 x 4 mma tiles: every fragment it loads
// feeds four mmas). One barrier per kWR rows.
constexpr int kWT = 128, kWR = 32, kWStages = 3, kWLd = kWT + 8;
constexpr size_t kWgradSmem = (size_t)2 * kWStages * kWR * kWLd * sizeof(bf16);

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
wgrad_tc_kernel(const bf16* ws, int S, int rows, int offA, int Ka, int offB, int Kb,
                int chunk_rows, float* partial) {
  extern __shared__ __align__(16) char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + kWStages * kWR * kWLd;
  const int i0 = blockIdx.x * kWT, j0 = blockIdx.y * kWT, chunk = blockIdx.z;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(rows, r_begin + chunk_rows);
  const int steps = r_end > r_begin ? (r_end - r_begin + kWR - 1) / kWR : 0;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 1) * 64, n0 = (warp >> 1) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const auto load = [&](int step, int stage) {
    const int r0 = r_begin + step * kWR;
    for (int e = threadIdx.x; e < kWR * (kWT / 8); e += kThreads) {
      const int rr = e / (kWT / 8), cc = (e - rr * (kWT / 8)) * 8, r = r0 + rr;
      const bf16* row = ws + (size_t)min(r, rows - 1) * S;
      const bool in = r < r_end;
      cp_async16_zfill(sa + (stage * kWR + rr) * kWLd + cc, row + offA + min(i0 + cc, Ka - 8),
                       in && i0 + cc < Ka ? 16 : 0);
      cp_async16_zfill(sb + (stage * kWR + rr) * kWLd + cc, row + offB + min(j0 + cc, Kb - 8),
                       in && j0 + cc < Kb ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kWStages - 1; ++st) {
    if (st < steps) load(st, st);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int step = 0; step < steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kWStages - 2) : "memory");
    __syncthreads();  // this step's rows are in; every warp is done with step - 1's
    const int next = step + kWStages - 1;
    if (next < steps) load(next, next % kWStages);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int stage = step % kWStages;
    const SCol<bf16> A{sa + stage * kWR * kWLd, kWLd, kWT, kWR};
    const SCol<bf16> B{sb + stage * kWR * kWLd, kWLd, kWT, kWR};
    mma_block(acc, A, m0, 4, B, n0, kWR);
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + m0 + 16 * mi + g + 8 * half;
        const int jj = j0 + n0 + 8 * j + 2 * t;   // even, and Kb is even
        if (i < Ka && jj < Kb)
          store2(partial + ((size_t)chunk * Ka + i) * Kb + jj, acc[mi][j][2 * half],
                 acc[mi][j][2 * half + 1]);
      }
}

// out[G][j] = sum over i in group G (rows [G*group, min(n, (G+1)*group)))
// of in[i][j], in row order.
__global__ void sum_rows_kernel(const float* in, int n, int J, int group, float* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= J) return;
  const int G = blockIdx.y;
  const int end = min(n, (G + 1) * group);
  float acc = 0.f;
  for (int i = G * group; i < end; ++i) acc += in[(size_t)i * J + j];
  out[(size_t)G * J + j] = acc;
}

constexpr int kGroup = 64;

// out[j] = sum_i in[i][j], i < n, in a fixed order: groups of kGroup rows
// into tmp, then the groups in order.
cudaError_t sum_rows(const float* in, int n, int J, float* out, float* tmp, cudaStream_t s) {
  const dim3 block(256);
  if (n <= kGroup) {
    sum_rows_kernel<<<dim3((J + 255) / 256, 1), block, 0, s>>>(in, n, J, n, out);
    return cudaGetLastError();
  }
  const int G = (n + kGroup - 1) / kGroup;
  sum_rows_kernel<<<dim3((J + 255) / 256, G), block, 0, s>>>(in, n, J, kGroup, tmp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_rows_kernel<<<dim3((J + 255) / 256, 1), block, 0, s>>>(tmp, G, J, G, out);
  return cudaGetLastError();
}

Geo make_geo(const int* dims, float scale, float eps) {
  Geo g;
  g.B_ = dims[D_B];
  g.N = dims[D_N];
  g.C = dims[D_C];
  g.nH = dims[D_H];
  g.hd = g.C / g.nH;
  g.M = dims[D_M];
  g.nW = dims[D_NW];
  g.chunks = dims[D_CHUNKS];
  g.R = dims[D_ROWS];
  g.fwarps = dims[D_FWARPS];
  g.frun = dims[D_FRUN];
  g.bwarps = dims[D_BWARPS];
  g.brun = dims[D_BRUN];
  g.Rp = (g.N + 15) / 16 * 16;
  g.S = 8 * g.C + 2 * g.M;
  g.V = 9 * g.C + g.M;
  g.scale = scale;
  g.eps = eps;
  return g;
}

template <typename Kernel>
cudaError_t launch_rows(Kernel kernel, const Table& tab, const Geo& g, size_t smem,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<g.B_, kThreads, smem, s>>>(tab, g);
  return cudaGetLastError();
}

template <typename T> int run_fwd(const Table& tab, const Geo& g, cudaStream_t s) {
  const Layout L = make_layout(g.N, g.C, g.hd, g.Rp, sizeof(T));
  return (int)launch_rows(fused_block_fwd_kernel<T>, tab, g, L.bytes, s);
}

template <typename Kernel>
cudaError_t launch_tok(Kernel kernel, const Table& tab, const Geo& g, int which, int es,
                       cudaStream_t s) {
  const size_t smem = tok_layout(which, g.R, g.C, es).bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = g.B_ * g.N;
  kernel<<<(rows + g.R - 1) / g.R, kThreads, smem, s>>>(tab, g);
  return cudaGetLastError();
}

// The attention halves' bias policy: the window-attention kernel's
// (wtile::TableBias), under a name of its own so that a profile files the
// tile kernels it instantiates (A1, A2 and their dbias sum) under the
// fused block and not under row 3 / 4 (esvit_tpu_torch/utils/profile.py).
struct FusedBlockBias : wtile::TableBias {};

// The attention tiles' geometry on QKV: q, k, v at columns 0, C, 2C of a
// 3C-wide row, heads hd wide.
wtile::Geometry attn_geometry(const Geo& g, int run) {
  wtile::Geometry tg{};
  tg.B_ = g.B_;
  tg.N = g.N;
  tg.hd = g.hd;
  tg.nH = g.nH;
  tg.types = g.nW;
  tg.ld_in = 3 * g.C;
  tg.ld_out = g.S;
  tg.ld_do = g.C;
  tg.ld_dx = g.S;
  tg.run = run;
  tg.scale = g.scale;
  return tg;
}

template <typename T> int run_bwd(const Table& tab, const Geo& g, cudaStream_t s) {
  void* const* table = tab.p;
  if (g.R < 16 || g.R > kMaxN || g.R % 16) return (int)cudaErrorInvalidValue;
  T* ws = static_cast<T*>(table[WS]);
  const T* qkv = static_cast<const T*>(table[QKV]);
  FusedBlockBias bias;
  bias.table = static_cast<const float*>(table[BIAS]);
  bias.region = static_cast<const int*>(table[REGION]);
  cudaError_t err = launch_tok(fused_bwd_t1_kernel<T>, tab, g, 1, sizeof(T), s);
  if (err != cudaSuccess) return (int)err;
  const wtile::Operands<T> fwd{qkv, qkv + g.C, qkv + 2 * g.C, ws + ws_a(g)};
  int rc = wtile::launch<T>(fwd, bias, attn_geometry(g, g.frun), g.fwarps, s);
  if (rc != 0) return rc;
  err = launch_tok(fused_bwd_t2_kernel<T>, tab, g, 2, sizeof(T), s);
  if (err != cudaSuccess) return (int)err;
  const wtile::BwdOperands<T> bwd{qkv, qkv + g.C, qkv + 2 * g.C,
                                  static_cast<const T*>(table[DA]), ws + ws_dqkv(g),
                                  ws + ws_dqkv(g) + g.C, ws + ws_dqkv(g) + 2 * g.C,
                                  static_cast<float*>(table[BPART])};
  rc = wtile::backward<T>(bwd, bias, attn_geometry(g, g.brun), g.bwarps,
                          static_cast<float*>(table[D_BIAS]), s);
  if (rc != 0) return rc;
  err = launch_tok(fused_bwd_t3_kernel<T>, tab, g, 3, sizeof(T), s);
  if (err != cudaSuccess) return (int)err;

  const int rows = g.B_ * g.N, C = g.C, M = g.M;
  const int chunk_rows = ((rows + g.chunks - 1) / g.chunks + 63) / 64 * 64;
  float* wpart = static_cast<float*>(table[WPART]);
  float* tmp = static_cast<float*>(table[TMP]);
  struct Job { int offA, Ka, offB, Kb; void* out; };
  const Job jobs[4] = {{ws_y(g), C, ws_dqkv(g), 3 * C, table[D_WQKV]},
                       {ws_a(g), C, ws_do1(g), C, table[D_WP]},
                       {ws_y2(g), C, ws_dh(g), M, table[D_W1]},
                       {ws_g(g), M, ws_do2(g), C, table[D_W2]}};
  if (sizeof(T) == 2) {
    err = cudaFuncSetAttribute(wgrad_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kWgradSmem);
    if (err != cudaSuccess) return (int)err;
  }
  for (const Job& j : jobs) {
    if constexpr (sizeof(T) == 2) {
      const dim3 grid((j.Ka + kWT - 1) / kWT, (j.Kb + kWT - 1) / kWT, g.chunks);
      wgrad_tc_kernel<<<grid, kThreads, kWgradSmem, s>>>(ws, g.S, rows, j.offA, j.Ka, j.offB,
                                                         j.Kb, chunk_rows, wpart);
    } else {
      const dim3 grid((j.Ka + 63) / 64, (j.Kb + 63) / 64, g.chunks);
      wgrad_kernel<T><<<grid, kThreads, 0, s>>>(ws, g.S, rows, j.offA, j.Ka, j.offB, j.Kb,
                                               chunk_rows, wpart);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = sum_rows(wpart, g.chunks, j.Ka * j.Kb, static_cast<float*>(j.out), tmp, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (rows + g.R - 1) / g.R;
  err = sum_rows(static_cast<const float*>(table[VPART]), tiles, g.V,
                 static_cast<float*>(table[D_VEC]), tmp, s);
  return (int)err;
}

}  // namespace

extern "C" {

// Shared-memory bytes one row-kernel block takes (elem_size 2 or 4).
long long esvit_fused_block_smem_bytes(int N, int C, int nH, int elem_size) {
  return (long long)make_layout(N, C, C / nH, (N + 15) / 16 * 16, elem_size).bytes;
}

// table: kNumPtrs pointers in Ptr order (null where unused); dims:
// kNumDims ints in Dim order. dtype: 0 = float32, 1 = bfloat16.
int esvit_fused_block_fwd(void* const* table, const int* dims, float scale, float eps,
                          int dtype, void* stream) {
  const Geo g = make_geo(dims, scale, eps);
  Table tab;
  for (int i = 0; i < kNumPtrs; ++i) tab.p[i] = table[i];
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run_fwd<bf16>(tab, g, s);
  return run_fwd<float>(tab, g, s);
}

int esvit_fused_block_bwd(void* const* table, const int* dims, float scale, float eps,
                          int dtype, void* stream) {
  const Geo g = make_geo(dims, scale, eps);
  Table tab;
  for (int i = 0; i < kNumPtrs; ++i) tab.p[i] = table[i];
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run_bwd<bf16>(tab, g, s);
  return run_bwd<float>(tab, g, s);
}

int esvit_fused_block_num_ptrs() { return kNumPtrs; }

// Shared-memory bytes of the backward's largest token-tile block (T1, T2,
// T3) at `rows` rows per tile (elem_size 2 or 4).
long long esvit_fused_block_bwd_smem_bytes(int C, int rows, int elem_size) {
  size_t most = 0;
  for (int k = 1; k <= 3; ++k) {
    const size_t b = tok_layout(k, rows, C, elem_size).bytes;
    most = b > most ? b : most;
  }
  return (long long)most;
}


}  // extern "C"
