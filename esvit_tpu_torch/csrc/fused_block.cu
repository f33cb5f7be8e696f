// The whole Swin block, forward and backward, sm_90a.
//
// Replaces the Pallas TPU kernels of esvit_tpu/ops/fused_block.py:
// _fwd_kernel (launched by _run, kind "fwd") and _bwd_kernel (kind "bwd"),
// reached through fused_swin_block.
//
// The forward computes, for the rows of x (tokens in the unpadded
// window-major order of ops/window.py, windows of N <= 256 tokens: the
// window-attention tiles take N <= 64 on the small tile and 64 < N <= 256,
// Swin at W=14, on the large one):
//   y   = round(LN1(x)) * pad                 fp32 LN, E[x^2] - mu^2 variance
//   q,k,v = round(round(y Wq) + round(bq))    (bf16 operands, fp32 sums)
//   s   = round(q round(scale)) k^T + bias[h] - 100 [region_i != region_j]
//   p   = softmax(s) in fp32, one max per (window, head, row)
//   a   = round(round(p) v)
//   x2  = round(x + round(round(round(a Wp) + round(bp)) * keep1[image]))
//   y2  = round(LN2(x2));  h = round(round(y2 W1) + round(b1))
//   g   = round(gelu_erf(h) in fp32)
//   out = round(x2 + round(round(round(g W2) + round(b2)) * keep2[image]))
// exactly where the TPU kernel rounds (fused_block.py:395-443). Without
// keep scales the residuals are x + o (no scaling).
//
// What bounds the forward on Hopper: its four products are token-parallel
// GEMMs (up to 200,704 rows, K and N from C to 4C, ~1.3 TFLOP per Swin-T
// step: 1.3 ms of the tensor cores' peak); only softmax(q k^T + bias) v
// is per window, at ~33 FLOP/byte. The TPU kernel's shape (one grid step per
// window group, everything in VMEM) does not carry over: a thread block per
// window of 49 rows ran every C-wide product on 64 padded rows, fetched
// each weight fragment from L2 again per window, and chained ~50
// barrier-separated phases at one or two blocks per SM (the design this
// one replaced: 4% of the bf16 tensor-core peak). So the forward is five
// kernels, each on what it needs (the section "The forward" below): four
// token-tile GEMMs F1-F4 of 128 rows, whose products run on wgmma (two
// warpgroups of 64 rows, B and F4's A from a cp.async ring of
// 128-byte-swizzled tiles), with the LayerNorms as prologues and the
// roundings, drop-path residuals and GELU as epilogues; and attention on
// the window-attention forward tile (A1), as the backward recomputes it.
// The intermediates (qkv, a, x2, g: 18 C bytes a row in bf16) go through
// device memory, ~0.85 GB per call at Swin-T's 224 px stage 0, ~0.25 ms
// at 3.35 TB/s. Measured, neither bound is reached: the epilogues (F3's
// erf-GELU, the rows' stores) and, at C >= 384, one block per SM running
// its phases in turn hold the kernels (the section's notes). For fp32
// inputs (the parity checks) the token kernels run register-tiled FMAs
// on the CUDA cores (no TF32) on tiles of 32 rows.
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
// atomics: every output is bit-identical run to run. The TPU kernel gets
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

#include <algorithm>
#include <type_traits>

#include "fused_block_attention.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMc = 128;            // the backward's MLP hidden-dimension chunk
constexpr int kMaxTileRows = 64;    // rows of a backward token tile
constexpr int kMaxC = 512;          // channels (a LayerNorm row in registers)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// Pointer table: the wrapper passes them in this order. WQKV_F holds the
// q/k/v weights [out][in] with the outputs as [q | k | v] (QKV's columns);
// WQKV_B holds them [in][out] as [Wq | Wk | Wv] (the backward's dqkv
// column order). QKV (rows, 3C: [q |
// k | v]) is scratch of both passes, DA (rows, C) the backward's; FA
// (rows, C), FX2 (rows, C) and FG (rows, M) hold the forward's a, x2 and
// g; all in the compute dtype.
enum Ptr {
  X, OUT, G1, BE1, BQKV, BP, G2, BE2, B1, B2, BIAS, PAD, KEEP1, KEEP2, REGION,
  WQKV_F, WP_F, W1_F, W2_F,          // [out][in] (torch Linear layout)
  WQKV_B, WP_B, W1_B, W2_B,          // [in][out] (the JAX layout)
  DOUT, DX, DX32, WS, VPART, BPART, WPART, TMP, QKV, DA,
  D_WQKV, D_WP, D_W1, D_W2, D_VEC, D_BIAS, FA, FX2, FG, kNumPtrs
};
// Dims: windows, tokens, channels, heads, MLP hidden, window types, row
// chunks of the weight-gradient kernel; the plan: rows of a backward token
// tile, and the attention tiles' warps per block and windows per warp
// (the forward tile, as A1 of either pass; the backward tile).
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

// B fragment (columns n0..n0+7, k0..k0+15): lane holds column g, k 2t, 2t+1
// (b[0]) and 2t+8, 2t+9 (b[1]).
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
  int B_, N, C, nH, hd, M, nW, chunks;
  int R;                        // backward: rows of a token tile
  int fwarps, frun, bwarps, brun;  // the attention tiles' plans
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

// Row statistics slots in shared memory (a token tile uses the first two,
// for its LayerNorm's mean and 1/std).
enum Stat { MU1 = 0, RS1 = 1, MU2 = 2, RS2 = 3 };

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
// the bias and LayerNorm gradients). A token tile of R rows (the wrapper's
// plan, ops/fused_block.py token_rows: 64 up to C = 96, else 32, 16 for
// fp32 above C = 256) crosses window and image boundaries: a row's image
// is row / (nW N) and its pad multiplier pad[row % (nW N)].
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
  const int C = g.C;
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
        const float2 bb = ldg2(bqkv + c);
        store2(sO + r * b.L.ld3 + c, rnd<T>(rnd<T>(v0) + rnd<T>(bb.x)),
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
    // do is read where it is added, not held through ln_bwd_row: at
    // C = 512 the three accumulators and the row's x and dy are already
    // 80 floats a lane, under the 128 registers of two blocks per SM
    for (int r = threadIdx.x >> 5; r < n; r += kWarps) {
      float2 xv[kPairs], dy[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int c = 64 * i + 2 * lane;
        xv[i] = dy[i] = make_float2(0.f, 0.f);
        if (c >= C) continue;
        xv[i] = load2(sY + r * L.ldC + c);
        dy[i] = load2(sDY + r * L.ldO + c);
      }
      ln_bwd_row(xv, dy, g2, C, b.stat(MU1)[r], b.stat(RS1)[r], dg, dbe);
      const float k1 = b.keep(KEEP1, r);
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int c = 64 * i + 2 * lane;
        if (c >= C) continue;
        const float2 dx2 = add_f2(load2(sD + r * L.ldC + c), dy[i]);
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
      float2 xv[kPairs], dy[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int c = 64 * i + 2 * lane;
        xv[i] = dy[i] = make_float2(0.f, 0.f);
        if (c >= C) continue;
        xv[i] = load2(x + (size_t)r * C + c);
        const float2 d = load2(sDY + r * L.ldO + c);
        dy[i] = make_float2(d.x * pm, d.y * pm);
      }
      ln_bwd_row(xv, dy, g1, C, b.stat(MU1)[r], b.stat(RS1)[r], dg, dbe);
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {   // dx2 read where it is added, as T2's do
        const int c = 64 * i + 2 * lane;
        if (c >= C) continue;
        const float2 d32 = load2(dx32 + (size_t)r * C + c);
        store2(dx + (size_t)r * C + c, d32.x + dy[i].x, d32.y + dy[i].y);
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

// ---------------------------------------------------------------------------
// The forward: four token-tile kernels around the attention tile.
//   F1 (token tiles): y = round(LN1(x)) * pad into shared memory (the
//      prologue), qkv = round(round(y Wqkv) + round(bqkv)) to QKV ([q | k
//      | v]);
//   A1 (windows): a = round(round(p) v), the forward tile of
//      window_attention_tile.cuh on QKV with FusedBlockBias, to FA (the
//      backward's A1, which recomputes the same a);
//   F2 (token tiles): x2 = x + round(round(round(a Wp) + round(bp)) keep1),
//      to FX2;
//   F3 (token tiles): y2 = round(LN2(x2)) into shared memory, g =
//      round(gelu(round(round(y2 W1) + round(b1)))) to FG;
//   F4 (token tiles): out = x2 + round(round(round(g W2) + round(b2))
//      keep2), the product over M streamed.
// A token tile's rows cross window and image boundaries: a row's image is
// row / (nW N), its pad multiplier pad[row % (nW N)].
//
// bf16 (the step's route): a tile of kFwdRows = 128 rows, two warpgroups
// of 64, each computing its rows of an output tile of WN columns (96, 64
// or 32, the largest dividing C and M) with wgmma m64nWNk16 (bf16 in,
// fp32 accumulators). A is resident in shared memory for F1-F3 (the whole
// C-wide rows, staged by cp.async; F1 and F3 then normalise them in
// place) and streamed for F4; the weights' [WN x 64] tiles (and F4's
// [128 x 64] A tiles) come through a kFwdStages-deep cp.async ring, a
// tile ahead of the products, one barrier per 64 columns of K, one batch
// of products left running across it (three stages: the one in use, the
// one in flight and the one the running batch reads). K runs in whole 64-column atoms,
// zero past K (C = 96 does a third more products than it needs). Every
// operand tile is 128-byte swizzled (row r's 16-byte chunk c at chunk c ^
// (r % 8)), the layout a wgmma descriptor names. A column tile's bias
// comes in with its first weight tile; the epilogue rounds where the TPU
// kernel does, through a staging tile per warpgroup (F2 and F4 first take
// the residual rows into it by cp.async), then stores 16-byte rows. When a stage has fewer row tiles
// than kFwdBlocksPerSm blocks per SM, its column tiles are split over
// gridDim.y. What bounds it (PERF.md's findings on the block-fused
// forward): at C = 96, F3's erf-GELU epilogue (instruction issue) and the
// output rows' writes, each after the products of its column tile; at C =
// 384 and 512 (Swin-B's stage 2, WN = 64), one 8-warp block per SM (the 96
// / 128 KB resident A tile) running prologue, products and epilogues in
// turn. fp32 (the parity checks): tiles of kFwdRows32 = 32 rows, A in
// shared memory (F4's from global memory), the products as for_tiles'
// register-tiled FMAs on the CUDA cores (no TF32), B from global memory.
// Every output is written once by one thread: bit-identical on repeat.
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;       // rows of a bf16 token tile (two warpgroups of 64)
constexpr int kFwdRows32 = 32;      // rows of an fp32 token tile
constexpr int kFwdStages = 3;       // tiles in the cp.async ring
constexpr int kFwdAhead = kFwdStages - 2;   // tiles loaded ahead of the products

// The wgmma tile's width: the largest of 96, 64, 32 that divides C and M
// (every N and K of the four products is C, 3C or M).
__host__ __device__ inline int fwd_wn(int C, int M) {
  if (C % 96 == 0 && M % 96 == 0) return 96;
  if (C % 64 == 0 && M % 64 == 0) return 64;
  return 32;
}

// A bf16 forward block's shared memory, in bytes from a 1024-aligned base:
// the resident A tile (F1-F3: ceil(K / 64) atoms of 128 rows x 128 bytes);
// the ring (stages of [F4: A's 128 x 64 atom,] the weights' WN x 64 atom);
// the bias of kFwdStages column tiles (WN fp32 each); the epilogue's
// staging tile (128 x ldo: F2, F4's residual rows in, the results out),
// which holds F1's and F3's LayerNorm gamma and beta (C fp32 each) during
// the prologue.
struct FwdSmem {
  size_t ring, stage, b, bias, gb, out, bytes;
  int ldo;
};

__host__ __device__ inline FwdSmem fwd_smem(int S, int C, int K, int WN) {
  FwdSmem L;
  const size_t atom_a = (size_t)kFwdRows * 128, atom_b = (size_t)WN * 128;
  L.ring = S == 4 ? 0 : (size_t)((K + 63) / 64) * atom_a;
  L.b = S == 4 ? atom_a : 0;
  L.stage = L.b + atom_b;
  L.bias = L.ring + kFwdStages * L.stage;
  L.out = L.bias + (size_t)kFwdStages * WN * sizeof(float);
  L.gb = L.out;   // the prologue is done before the first epilogue
  L.ldo = WN + 8;
  L.bytes = L.out + (size_t)kFwdRows * L.ldo * sizeof(bf16) + 1024;   // + the base's alignment
  return L;
}

// A forward stage's product: out[r][c] = epilogue(sum over k < K of A[r][k]
// W[c][k]) for c < N; A's and out's rows have strides K and N.
struct FwdOp {
  const void* a;
  const void* w;
  void* out;
  int K, N;
};

__device__ inline FwdOp fwd_op(int stage, void* const* P, const Geo& g) {
  switch (stage) {
    case 1: return FwdOp{P[X], P[WQKV_F], P[QKV], g.C, 3 * g.C};
    case 2: return FwdOp{P[FA], P[WP_F], P[FX2], g.C, g.C};
    case 3: return FwdOp{P[FX2], P[W1_F], P[FG], g.C, g.M};
    default: return FwdOp{P[FG], P[W2_F], P[OUT], g.M, g.C};
  }
}

// Stage S's epilogue: the values stored at (row, col(c)) and (row, col(c)
// + 1) for the products v0, v1 at row `row` (of all B_ N rows), columns
// c, c + 1 (c even), in fp32 (the store rounds to T).
template <typename T, int S> struct FwdEpi {
  const float* bias;
  const float* keep;   // F2, F4: the per-image drop-path scales, or null
  const T* res;        // F2: x, F4: x2 (row stride C)
  int C, per_img;

  __device__ __forceinline__ float row_keep(size_t row) const {
    return keep != nullptr ? keep[row / per_img] : 1.f;
  }

  // The arithmetic, given the bias pair b, the row's drop-path scale d and
  // the residual pair x (F2, F4).
  __device__ __forceinline__ float2 value(float v0, float v1, float2 b, float d, float2 x) const {
    float o0 = rnd<T>(rnd<T>(v0) + rnd<T>(b.x)), o1 = rnd<T>(rnd<T>(v1) + rnd<T>(b.y));
    if constexpr (S == 1) {
      return make_float2(o0, o1);
    } else if constexpr (S == 3) {
      return make_float2(gelu(o0), gelu(o1));
    } else {
      if (keep != nullptr) {
        o0 = rnd<T>(o0 * d);
        o1 = rnd<T>(o1 * d);
      }
      return make_float2(x.x + o0, x.y + o1);
    }
  }

  // The same, reading the bias, scale and residual from memory.
  __device__ __forceinline__ float2 operator()(size_t row, int c, float v0, float v1) const {
    const float2 x = S == 2 || S == 4 ? load2(res + row * C + c) : make_float2(0.f, 0.f);
    return value(v0, v1, ldg2(bias + c), row_keep(row), x);
  }
};

template <typename T, int S> __device__ FwdEpi<T, S> fwd_epi(void* const* P, const Geo& g) {
  FwdEpi<T, S> e;
  e.bias = static_cast<const float*>(P[S == 1 ? BQKV : S == 2 ? BP : S == 3 ? B1 : B2]);
  e.keep = static_cast<const float*>(S == 2 ? P[KEEP1] : S == 4 ? P[KEEP2] : nullptr);
  e.res = static_cast<const T*>(S == 2 ? P[X] : S == 4 ? P[FX2] : nullptr);
  e.C = g.C;
  e.per_img = g.nW * g.N;
  return e;
}

// Byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled
// tile (rows of 128 bytes, 1024-aligned): chunk c ^ (r % 8) of the row.
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// The wgmma descriptor of a K-major, 128-byte-swizzled operand at shared
// address `addr`: the start address / 16; leading byte offset 16 (unused
// by this layout); stride byte offset 1024 (8 rows of 128 bytes);
// layout type 1 (128-byte swizzle) in bits 62-63. A k16 step is +32 bytes
// of start address, +2 in the descriptor.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy, which wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving uses of the accumulators across the
// wgmma issue and wait.
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// A barrier of one warpgroup (128 threads; ids 1, 2: 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// D = A B^T + (scale_d ? D : 0) on one warpgroup: A the 64 x 16 K-major
// tile at descriptor a, B the WN x 16 K-major tile at b. D[i] of thread t (warp w = t / 32 % 4,
// lane l) is row 16 w + l / 4 + 8 (i / 2 % 2), column 8 (i / 4) + 2 (l %
// 4) + i % 2: the m16n8 accumulator layout, WN / 8 times.
template <int WN> struct Wgmma;
template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

__device__ __forceinline__ float2 bf2f(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ uint32_t f2bf(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The LayerNorm prologue of F1 (LN1, times the pad multiplier) and F3
// (LN2), in place: the tile's rows of x, staged in the resident A tile
// (rows n.. and the columns past C zero), become y = round(LN(x)) * pad
// (rows n.. stay zero); gamma and beta are staged in shared memory. Two
// threads a row, each on half of its 16-byte chunks (every lane busy at
// any C), read twice: the sums, then the normalised values in place. The
// variance is E[x^2] - mu^2 in fp32, as the backward's tok_layer_norm.
__device__ void fwd_ln_tc(unsigned char* sA, const float* gam, const float* bet, int n, int C,
                          const float* pad, size_t row0, int per_img, float eps) {
  const int r = threadIdx.x >> 1, nq = C / 16, q0 = (threadIdx.x & 1) * nq;
  const auto chunk = [&](int q) {
    return reinterpret_cast<uint4*>(sA + (size_t)(q >> 3) * kFwdRows * 128 + swz(r, q & 7));
  };
  float s = 0.f, ss = 0.f;
#pragma unroll 4
  for (int q = q0; q < q0 + nq; ++q) {
    const uint4 v = *chunk(q);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = bf2f(w[j]);
      s += f.x + f.y;
      ss += f.x * f.x + f.y * f.y;
    }
  }
  s += __shfl_xor_sync(kFull, s, 1);
  ss += __shfl_xor_sync(kFull, ss, 1);
  const float mu = s / C;
  const float rs = rsqrtf(ss / C - mu * mu + eps);
  const float pm = r >= n ? 0.f : pad != nullptr ? pad[(row0 + r) % per_img] : 1.f;
#pragma unroll 4
  for (int q = q0; q < q0 + nq; ++q) {
    uint4* p = chunk(q);
    const uint4 v = *p;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const float4 g0 = reinterpret_cast<const float4*>(gam)[2 * q];
    const float4 g1 = reinterpret_cast<const float4*>(gam)[2 * q + 1];
    const float4 b0 = reinterpret_cast<const float4*>(bet)[2 * q];
    const float4 b1 = reinterpret_cast<const float4*>(bet)[2 * q + 1];
    const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = bf2f(w[j]);
      o[j] = f2bf(rnd<bf16>((f.x - mu) * rs * gg[2 * j] + bb[2 * j]) * pm,
                  rnd<bf16>((f.y - mu) * rs * gg[2 * j + 1] + bb[2 * j + 1]) * pm);
    }
    *p = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Stage S of the bf16 forward: the tile of kFwdRows rows at blockIdx.x,
// its output column tiles nt = blockIdx.y, blockIdx.y + gridDim.y, ...
template <int WN, int S>
__global__ void __launch_bounds__(kThreads, 2) fused_block_fwd_tc_kernel(Table tab, Geo g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  constexpr bool kStreamA = S == 4;
  const FwdOp op = fwd_op(S, tab.p, g);
  const FwdSmem L = fwd_smem(S, g.C, op.K, WN);
  const FwdEpi<bf16, S> epi = fwd_epi<bf16, S>(tab.p, g);
  // the count from plain ints (make_tok says why)
  const int row0 = blockIdx.x * kFwdRows, left = g.B_ * g.N - row0;
  const int n = left < kFwdRows ? left : kFwdRows;
  const int tid = threadIdx.x, wg = tid >> 7;
  const bf16* A = static_cast<const bf16*>(op.a) + (size_t)row0 * op.K;
  const bf16* W = static_cast<const bf16*>(op.w);
  // K in whole 64-column atoms: the columns past K are zero in A and W
  const int atoms = (op.K + 63) / 64, ny = gridDim.y;
  const int n_tiles = (op.N / WN - (int)blockIdx.y + ny - 1) / ny, tiles = n_tiles * atoms;

  float* s_bias = reinterpret_cast<float*>(smem + L.bias);

  // tile t of the ring: output columns WN (blockIdx.y + ny (t / atoms)).., K
  // columns 64 (t % atoms).. (16-byte chunks past K zero-filled); with the
  // block's i-th column tile's first (i = t / atoms), that tile's bias,
  // into slot i % kFwdStages: the block's column tile kFwdStages before it
  // was stored before this load is issued
  const auto load = [&](int t) {
    const int i = t / atoms, nt = (int)blockIdx.y + ny * i, k0 = 64 * (t % atoms);
    unsigned char* st = smem + L.ring + (size_t)(t % kFwdStages) * L.stage;
    if (k0 == 0 && tid < WN / 4)
      wtile::cp_async16(s_bias + (i % kFwdStages) * WN + 4 * tid, epi.bias + nt * WN + 4 * tid);
    if constexpr (kStreamA) {
      for (int e = tid; e < kFwdRows * 8; e += kThreads) {
        const int r = e >> 3, c = e & 7;
        cp_async16_zfill(st + swz(r, c), A + (size_t)min(r, n - 1) * op.K + k0 + 8 * c,
                         r < n ? 16 : 0);
      }
    }
    for (int e = tid; e < WN * 8; e += kThreads) {
      const int r = e >> 3, c = e & 7, k = min(k0 + 8 * c, op.K - 8);
      cp_async16_zfill(st + L.b + swz(r, c), W + (size_t)(nt * WN + r) * op.K + k,
                       k0 + 8 * c < op.K ? 16 : 0);
    }
  };

  // F1, F3: the LayerNorm's gamma and beta
  float* s_gb = reinterpret_cast<float*>(smem + L.gb);
  if constexpr (S == 1 || S == 3) {
    const float* gb[2] = {static_cast<const float*>(tab.p[S == 1 ? G1 : G2]),
                          static_cast<const float*>(tab.p[S == 1 ? BE1 : BE2])};
    for (int e = tid; e < g.C / 2; e += kThreads) {   // 4 floats a copy, C / 4 each
      const int which = e / (g.C / 4), c = 4 * (e - which * (g.C / 4));
      wtile::cp_async16(s_gb + which * g.C + c, gb[which] + c);
    }
  }
  if constexpr (!kStreamA) {   // A's rows into the resident tile (rows n.., columns K.. zero)
    const int kq = 8 * atoms;
    for (int e = tid; e < kFwdRows * kq; e += kThreads) {
      const int r = e / kq, q = e - r * kq;
      cp_async16_zfill(smem + (size_t)(q >> 3) * kFwdRows * 128 + swz(r, q & 7),
                       A + (size_t)min(r, n - 1) * op.K + 8 * min(q, op.K / 8 - 1),
                       r < n && 8 * q < op.K ? 16 : 0);
    }
  }
  wtile::cp_async_commit();
#pragma unroll
  for (int t = 0; t < kFwdAhead; ++t) {
    if (t < tiles) load(t);
    wtile::cp_async_commit();
  }
  if constexpr (S == 1 || S == 3) {   // x's rows are in: the LayerNorm in place
    wtile::cp_async_wait<kFwdAhead>();
    __syncthreads();
    fwd_ln_tc(smem, s_gb, s_gb + g.C, n, g.C,
              static_cast<const float*>(S == 1 ? tab.p[PAD] : nullptr), (size_t)row0,
              g.nW * g.N, g.eps);
  }

  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  const uint32_t base = smem_addr(smem);
  const int w4 = (tid >> 5) & 3, lane = tid & 31;
  bf16* sO = reinterpret_cast<bf16*>(smem + L.out) + (size_t)wg * 64 * L.ldo;
  bf16* out = static_cast<bf16*>(op.out);
  constexpr int kq = WN / 8;   // 16-byte chunks of a staging row
  // the drop-path scales of this thread's two rows in the epilogue
  float keep_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = 64 * wg + 16 * w4 + (lane >> 2) + 8 * h;
    keep_r[h] = rr < n ? epi.row_keep((size_t)(row0 + rr)) : 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    // tile t is in; each warpgroup has waited for its products of tile t -
    // 2 (below), so after the barrier tile t - 2's stage may be refilled
    wtile::cp_async_wait<kFwdAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    const int ka = t % atoms, nt = (int)blockIdx.y + ny * (t / atoms);
    if constexpr (S == 2 || S == 4)
      if (ka == 0)   // a column tile starts: its residual rows into the staging tile
        for (int e = tid & 127; e < 64 * kq; e += 128) {
          const int r = e / kq, q = e - r * kq, rr = 64 * wg + r;
          cp_async16_zfill(sO + r * L.ldo + 8 * q,
                           epi.res + (size_t)(row0 + min(rr, n - 1)) * g.C + nt * WN + 8 * q,
                           rr < n ? 16 : 0);
        }
    if (t + kFwdAhead < tiles) load(t + kFwdAhead);
    wtile::cp_async_commit();
    const uint32_t st = base + (uint32_t)(L.ring + (size_t)(t % kFwdStages) * L.stage);
    const uint32_t a0 = kStreamA ? st : base + (uint32_t)ka * kFwdRows * 128;
    const uint64_t da = wgmma_desc(a0 + wg * 64 * 128), db = wgmma_desc(st + (uint32_t)L.b);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // a column tile's first product starts the sums
      Wgmma<WN>::mma(acc, da + 2 * kk, db + 2 * kk, ka > 0 || kk > 0);
    wgmma_commit();
    if (ka != atoms - 1) {
      wgmma_wait<1>();   // tile t - 1's products are done; tile t's run on
      fence_acc(acc);
      continue;
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // epilogue: the warpgroup's 64 rows x WN columns through its staging
    // tile (F2, F4: over the residual rows, which each thread reads before
    // it writes), then out in 16-byte rows
    constexpr bool kResidual = S == 2 || S == 4;
    const float* sb = s_bias + (t / atoms % kFwdStages) * WN + 2 * (lane & 3);
    if constexpr (kResidual) {
      wtile::cp_async_wait<0>();
      wg_barrier(1 + wg);
    }
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* o = sO + (16 * w4 + (lane >> 2) + 8 * h) * L.ldo + 8 * j + 2 * (lane & 3);
        const float2 v =
            epi.value(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                      *reinterpret_cast<const float2*>(sb + 8 * j), keep_r[h],
                      kResidual ? load2(o) : make_float2(0.f, 0.f));
        store2(o, v.x, v.y);
      }
    wg_barrier(1 + wg);
    for (int e = tid & 127; e < 64 * kq; e += 128) {
      const int r = e / kq, q = e - r * kq, rr = 64 * wg + r;
      if (rr < n)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + rr) * op.N + nt * WN + 8 * q) =
            *reinterpret_cast<const uint4*>(sO + r * L.ldo + 8 * q);
    }
  }
}

// The fp32 LayerNorm prologue: y = LN(x) * pad of n rows of x (stride C)
// into dst (stride ld), rows n..Rp zeroed; a warp per row.
__device__ void fwd_ln_f32(float* dst, int ld, const float* x, int n, int Rp, int C,
                           const float* gam, const float* bet, const float* pad, size_t row0,
                           int per_img, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < Rp; r += kWarps) {
    float v[kMaxC / 32];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxC / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C && r < n ? x[(size_t)r * C + c] : 0.f;
      s += v[i];
      ss += v[i] * v[i];
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / C;
    const float rs = rsqrtf(ss / C - mu * mu + eps);
    const float pm = r >= n ? 0.f : pad != nullptr ? pad[(row0 + r) % per_img] : 1.f;
#pragma unroll
    for (int i = 0; i < kMaxC / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < C) dst[r * ld + c] = ((v[i] - mu) * rs * gam[c] + bet[c]) * pm;
    }
  }
}

__host__ __device__ inline size_t fwd_smem_f32(int C) {
  return (size_t)kFwdRows32 * (C + 4) * sizeof(float);
}

// Stage S of the fp32 forward on the tile of kFwdRows32 rows at blockIdx.x.
template <int S>
__global__ void __launch_bounds__(kThreads) fused_block_fwd_f32_kernel(Table tab, Geo g) {
  extern __shared__ __align__(16) char smem[];
  const FwdOp op = fwd_op(S, tab.p, g);
  const FwdEpi<float, S> epi = fwd_epi<float, S>(tab.p, g);
  const int row0 = blockIdx.x * kFwdRows32, left = g.B_ * g.N - row0;
  const int n = left < kFwdRows32 ? left : kFwdRows32, Rp = (n + 15) / 16 * 16;
  const float* A = static_cast<const float*>(op.a) + (size_t)row0 * op.K;
  float* sA = reinterpret_cast<float*>(smem);
  const int ld = g.C + 4;
  if constexpr (S == 1)
    fwd_ln_f32(sA, ld, A, n, Rp, g.C, static_cast<const float*>(tab.p[G1]),
               static_cast<const float*>(tab.p[BE1]), static_cast<const float*>(tab.p[PAD]),
               (size_t)row0, g.nW * g.N, g.eps);
  if constexpr (S == 3)
    fwd_ln_f32(sA, ld, A, n, Rp, g.C, static_cast<const float*>(tab.p[G2]),
               static_cast<const float*>(tab.p[BE2]), nullptr, (size_t)row0, g.nW * g.N, g.eps);
  if constexpr (S == 2)
    for (int e = threadIdx.x; e < Rp * op.K; e += kThreads) {
      const int r = e / op.K, c = e - r * op.K;
      sA[r * ld + c] = r < n ? A[(size_t)r * op.K + c] : 0.f;
    }
  __syncthreads();
  const GRow<float> Wt{static_cast<const float*>(op.w), op.K, op.N, op.K};
  float* out = static_cast<float*>(op.out);
  const auto store = [&](int r, int c, float v0, float v1) {
    if (r >= n) return;
    const float2 v = epi((size_t)(row0 + r), c, v0, v1);
    store2(out + (size_t)(row0 + r) * op.N + c, v.x, v.y);
  };
  if constexpr (S == 4) {
    const GRow<float> Ag{A, op.K, n, op.K};
    for_tiles<2, 4>(
        Rp, op.N, [&](auto& acc, int m0, int mt, int n0) { mma_block(acc, Ag, m0, mt, Wt, n0, op.K); },
        store);
  } else {
    const SRow<float> As{sA, ld, n, op.K};
    for_tiles<2, 4>(
        Rp, op.N, [&](auto& acc, int m0, int mt, int n0) { mma_block(acc, As, m0, mt, Wt, n0, op.K); },
        store);
  }
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
  g.S = 8 * g.C + 2 * g.M;
  g.V = 9 * g.C + g.M;
  g.scale = scale;
  g.eps = eps;
  return g;
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

// The attention tiles' geometry on QKV: q, k, v at columns 0, C, 2C of a
// 3C-wide row, heads hd wide; the output a at row stride ld_out (the
// forward's FA: C; the backward's workspace: S).
wtile::Geometry attn_geometry(const Geo& g, int run, int ld_out) {
  wtile::Geometry tg{};
  tg.B_ = g.B_;
  tg.N = g.N;
  tg.hd = g.hd;
  tg.nH = g.nH;
  tg.types = g.nW;
  tg.ld_in = 3 * g.C;
  tg.ld_out = ld_out;
  tg.ld_do = g.C;
  tg.ld_dx = g.S;
  tg.run = run;
  tg.scale = g.scale;
  return tg;
}

template <typename T> int run_bwd(const Table& tab, const Geo& g, cudaStream_t s) {
  void* const* table = tab.p;
  if (g.R < 16 || g.R > kMaxTileRows || g.R % 16 || g.C % 32 || g.C > kMaxC)
    return (int)cudaErrorInvalidValue;
  T* ws = static_cast<T*>(table[WS]);
  const T* qkv = static_cast<const T*>(table[QKV]);
  FusedBlockBias bias;
  bias.table = static_cast<const float*>(table[BIAS]);
  bias.region = static_cast<const int*>(table[REGION]);
  cudaError_t err = launch_tok(fused_bwd_t1_kernel<T>, tab, g, 1, sizeof(T), s);
  if (err != cudaSuccess) return (int)err;
  const wtile::Operands<T> fwd{qkv, qkv + g.C, qkv + 2 * g.C, ws + ws_a(g)};
  int rc = wtile::launch<T>(fwd, bias, attn_geometry(g, g.frun, g.S), g.fwarps, s);
  if (rc != 0) return rc;
  err = launch_tok(fused_bwd_t2_kernel<T>, tab, g, 2, sizeof(T), s);
  if (err != cudaSuccess) return (int)err;
  const wtile::BwdOperands<T> bwd{qkv, qkv + g.C, qkv + 2 * g.C,
                                  static_cast<const T*>(table[DA]), ws + ws_dqkv(g),
                                  ws + ws_dqkv(g) + g.C, ws + ws_dqkv(g) + 2 * g.C,
                                  static_cast<float*>(table[BPART])};
  rc = wtile::backward<T>(bwd, bias, attn_geometry(g, g.brun, g.S), g.bwarps,
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

// A bf16 stage's grid: the row tiles, and its output column tiles split
// over gridDim.y blocks when there are too few row tiles to give every SM
// kFwdBlocksPerSm blocks (the LayerNorm prologue then runs once per block).
constexpr int kFwdBlocksPerSm = 3;

template <int WN, int S>
cudaError_t launch_fwd_tc(const Table& tab, const Geo& g, int sms, cudaStream_t s) {
  const size_t smem = fwd_smem(S, g.C, S == 4 ? g.M : g.C, WN).bytes;
  auto kernel = fused_block_fwd_tc_kernel<WN, S>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int bx = (g.B_ * g.N + kFwdRows - 1) / kFwdRows;
  const int n_tiles = (S == 1 ? 3 * g.C : S == 3 ? g.M : g.C) / WN;
  const int by = std::min(n_tiles, std::max(1, (kFwdBlocksPerSm * sms + bx - 1) / bx));
  kernel<<<dim3(bx, by), kThreads, smem, s>>>(tab, g);
  return cudaGetLastError();
}

template <int S> cudaError_t launch_fwd_f32(const Table& tab, const Geo& g, cudaStream_t s) {
  const size_t smem = fwd_smem_f32(g.C);
  auto kernel = fused_block_fwd_f32_kernel<S>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(g.B_ * g.N + kFwdRows32 - 1) / kFwdRows32, kThreads, smem, s>>>(tab, g);
  return cudaGetLastError();
}

// A1 of the forward: a = attention of QKV's q, k, v into FA.
template <typename T> int fwd_attention(const Table& tab, const Geo& g, cudaStream_t s) {
  const T* qkv = static_cast<const T*>(tab.p[QKV]);
  FusedBlockBias bias;
  bias.table = static_cast<const float*>(tab.p[BIAS]);
  bias.region = static_cast<const int*>(tab.p[REGION]);
  const wtile::Operands<T> op{qkv, qkv + g.C, qkv + 2 * g.C, static_cast<T*>(tab.p[FA])};
  return wtile::launch<T>(op, bias, attn_geometry(g, g.frun, g.C), g.fwarps, s);
}

// F1, A1, F2, F3, F4 in a row.
template <typename T, typename Stage>
int run_fwd_stages(const Table& tab, const Geo& g, cudaStream_t s, Stage stage) {
  cudaError_t err = stage(std::integral_constant<int, 1>{});
  if (err != cudaSuccess) return (int)err;
  const int rc = fwd_attention<T>(tab, g, s);
  if (rc != 0) return rc;
  err = stage(std::integral_constant<int, 2>{});
  if (err != cudaSuccess) return (int)err;
  err = stage(std::integral_constant<int, 3>{});
  if (err != cudaSuccess) return (int)err;
  return (int)stage(std::integral_constant<int, 4>{});
}

template <int WN> int run_fwd_tc(const Table& tab, const Geo& g, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return run_fwd_stages<bf16>(
      tab, g, s, [&](auto S) { return launch_fwd_tc<WN, decltype(S)::value>(tab, g, sms, s); });
}

int run_fwd(const Table& tab, const Geo& g, int dtype, cudaStream_t s) {
  if (g.C % 32 || g.C > kMaxC || g.M % 32 || g.hd % 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run_fwd_stages<float>(tab, g, s, [&](auto S) { return launch_fwd_f32<decltype(S)::value>(tab, g, s); });
  switch (fwd_wn(g.C, g.M)) {
    case 96: return run_fwd_tc<96>(tab, g, s);
    case 64: return run_fwd_tc<64>(tab, g, s);
    default: return run_fwd_tc<32>(tab, g, s);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of the forward's largest token-tile block (F1-F4)
// at width C and MLP width M (elem_size 2 or 4).
long long esvit_fused_block_fwd_smem_bytes(int C, int M, int elem_size) {
  if (elem_size == 4) return (long long)fwd_smem_f32(C);
  const int wn = fwd_wn(C, M);
  size_t most = 0;
  for (int S = 1; S <= 4; ++S) {
    const size_t b = fwd_smem(S, C, S == 4 ? M : C, wn).bytes;
    most = b > most ? b : most;
  }
  return (long long)most;
}

// table: kNumPtrs pointers in Ptr order (null where unused); dims:
// kNumDims ints in Dim order. dtype: 0 = float32, 1 = bfloat16.
int esvit_fused_block_fwd(void* const* table, const int* dims, float scale, float eps,
                          int dtype, void* stream) {
  const Geo g = make_geo(dims, scale, eps);
  Table tab;
  for (int i = 0; i < kNumPtrs; ++i) tab.p[i] = table[i];
  auto s = static_cast<cudaStream_t>(stream);
  return run_fwd(tab, g, dtype, s);
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
