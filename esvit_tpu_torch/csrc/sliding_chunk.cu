// Mode-0 2-D sliding-chunk attention for ViL, forward and backward, sm_90a.
//
// Replaces the Pallas TPU kernels of esvit_tpu/ops/sliding_chunk_fused.py:
// _fwd_kernel (launched by _run, kind "fwd") and _bwd_kernel (kind "bwd"),
// reached through sliding_chunk_attention.
//
// q (pre-scaled), k, v are (BH, nx, ny, M) token grids cut into W x W
// chunks (mx x my of them, the last ones spatially padded); kg, vg are
// (BH, nglo, M) global keys and values. A query in chunk (ci, cj) attends
// to the real tokens of the in-grid chunks (ci+di, cj+dj), |di|, |dj| <= 1,
// and to the nglo global keys, in one softmax:
//   s  = q k^T in fp32                 (bf16 operands, fp32 sums)
//   m  = max over [global | neighbourhood];  e = exp(s - m)
//   p  = e * (1 / sum e)               in fp32
//   o  = round(round(p) v)             (fp32 accumulation)
// exactly where the TPU kernel rounds (sliding_chunk_fused.py:88-129).
// Keys of out-of-grid chunks and spatially padded keys are absent: they
// get probability exactly 0, as the TPU kernel's -1e9 and the einsum
// path's -inf give. Padded query rows are never computed.
//
// Backward (sliding_chunk_fused.py:132-177), with p rebuilt from the
// forward's per-row max m and 1/sum:
//   dv = round(p)^T do,  dp = do v^T,  r = rowsum(p * dp) (fp32 p, dp),
//   ds = round(p * (dp - r)),  dq = ds k,  dk = ds^T q,
//   dkg = dsg^T q,  dvg = round(pg)^T do.
// The TPU kernel accumulates dk/dv into revisited output blocks along its
// sequential grid. Here blocks run in any order, so the backward is three
// kernels with no atomics, and every gradient is bit-identical run to run:
//   1. per query chunk: r (stored), dq, and this chunk's fp32 partials of
//      dkg and dvg;
//   2. per key chunk c: dk and dv of c's keys, gathered from the <= 9 query
//      chunks whose neighbourhood holds c (the neighbourhood relation is
//      symmetric);
//   3. dkg, dvg: the partials summed over query chunks in a fixed order.
//
// Design for the card instead of the TPU's: one thread block owns one
// (bh, chunk) and stages only the real neighbour chunks (one set at a
// time) and the global rows in shared memory, so no score work is spent
// on the TPU band's 3-chunk-row padding (~2.7x at 224 px stage 0) or its
// 8-row slot padding.
//
// bf16 (the ViL-T step's dtype) runs on the tensor cores, with the
// mma.sync m16n8k16 primitives of window_attention_tile.cuh. A block has
// ceil(W^2 / 16) warps, each owning 16 rows of the block's chunk (4 at
// W=7), whose A fragments (Q, or K and V in the key-side kernel) it loads
// once with ldmatrix and keeps in registers. The other side's sets come in
// as bf16 tiles by 16-byte cp.async through a ring of kStages slots, so the
// next set is in flight while the block computes on this one; a tile is
// round16(W^2) rows (the globals' 16) at the header's padded row stride
// (round16(M) + 8, conflict-free for ldmatrix), absent rows and the head
// columns [M, round16(M)) zero-filled. Per kernel:
//   forward: pass 1 over the sets computes S = Q K^T and keeps each row's
//     running max and sum in registers (per lane, then combined across the
//     quad by shuffles in a fixed order): no score buffer. Pass 2
//     recomputes S, forms p = exp(s - m) / sum in the fragments, rounds it
//     to bf16 straight into A fragments and accumulates O += P V (V by
//     ldmatrix.trans). Shared memory: the Q tile and the ring, ~36 KB at
//     W=7, M=48 (the CUDA-core kernel's fp32 score buffer took ~117 KB).
//   bwd_q: pass 1 computes S and dP = dO V^T per set and gives r; pass 2
//     computes them again, forms ds in the fragments and accumulates
//     dq += ds K (K by ldmatrix.trans). For the globals each warp
//     transposes its ds and round(p) blocks (movmatrix) into A operands
//     of dsg^T Q and round(pg)^T dO; the warps' shares are summed in warp
//     order into the chunk's partials.
//   bwd_k: per key chunk, for each of the <= 9 query chunks that see it:
//     S^T = K Q^T and dP^T = V dO^T, then p^T and ds^T in the fragments
//     (the query's m, 1/sum and r staged beside its Q and dO), and
//     dv += round(p^T) dO, dk += ds^T Q: FlashAttention-2's dk/dv loop
//     over a fixed neighbour list.
// The kernels are templated on KD = round16(M) / 16, so fragments and
// accumulators are sized to the head dim; a set's all-padding key tile
// (keys 56-63 at W=7) takes no products. exp(s - m) is 2^(s log2e -
// m log2e), one fma and one ex2, as in the window tile. Absent keys,
// padded query rows and out-of-grid chunks are guarded explicitly
// (p = 0), so no inf * 0 reaches a sum. Every sum runs in a fixed order
// (mma, per-lane loops, xor shuffles, warp order), so all six results are
// bit-identical on repeat.
//
// fp32 (no path trains ViL in fp32; TF32 stays off) keeps the first
// CUDA-core kernels: 256 threads as a 16 x 16 grid of 4 x 4 register
// tiles, fed by 16-byte shared-memory loads from transposed (d-major) fp32
// copies, and the forward's fp32 scores of the chunk against its whole
// neighbourhood in shared memory (W^2 x (9 W^2 + nglo)).
//
// What bounds it on Hopper: at W=7, M=48 a query chunk does ~2 MFLOP of
// products over ~90 KB of bf16 operands (its neighbourhood's K and V,
// mostly from L2: each input is read by about 9 neighbouring blocks), so
// the roofline bound is HBM bytes (each input read once), but the tiles
// are far from it. Each block is a chain of ldmatrix, mma and the
// softmax's scalar work (masks, exponentials, packing) over 2 x 10 sets
// with a barrier per set, hidden only by the other blocks on its SM:
// registers hold 4 forward, 4 bwd_q and 3 bwd_k blocks (kFwdBlocks..:
// ptxas spills a little at M=48-64 under these caps and still runs
// faster), shared memory 5-6. By design every score is computed twice
// (forward) or three times (backward), and at W=7 a quarter of the m16
// rows are padding (49 of 64).
//
// Left behind from the TPU kernel, as Mosaic workarounds: the chunk-major
// padded rows (Np = 56 slots), the 3-chunk-row key band with its iota
// masks, and the 8 padded global rows.
//
// C interface (bound with ctypes): pointers and the stream are void*,
// every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "window_attention_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kGrid = 16;      // threads as a kGrid x kGrid map of 4x4 tiles
constexpr int kParts = 4;      // softmax: threads per query row
constexpr int kMaxSets = 10;   // the globals + 9 neighbour chunks

struct Geo {
  int BH, nx, ny, W, M, nglo;
  int W2;  // keys (and queries) of a chunk
  int R;   // rows of a chunk tile: max(ceil4(W2), 8)
  int G;   // score columns of the globals: ceil4(nglo)
  int mx, my;
};

__host__ __device__ inline int ceil4(int x) { return (x + 3) & ~3; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A key (or query) set: the global rows (chunk < 0) or the tokens of
// chunk (ci, cj) of the grid.
struct Set {
  int ci, cj;  // ci < 0: the globals
};

// Token row of element j of a set in its tensor ((BH*nglo) rows for the
// globals, (BH*nx*ny) for a chunk), or -1 where the position is absent;
// (jx, jy) = (j / W, j % W), its place in a chunk.
__device__ __forceinline__ long plan_row(const Geo& g, int bh, Set s, int j, int jx, int jy) {
  if (s.ci < 0) return j < g.nglo ? (long)bh * g.nglo + j : -1;
  const int x = s.ci * g.W + jx, y = s.cj * g.W + jy;
  return j < g.W2 && x < g.nx && y < g.ny ? ((long)bh * g.nx + x) * g.ny + y : -1;
}

__device__ __forceinline__ long set_row(const Geo& g, int bh, Set s, int j) {
  return plan_row(g, bh, s, j, j / g.W, j % g.W);
}

__device__ __forceinline__ int set_keys(const Geo& g, Set s) {
  return s.ci < 0 ? g.G : ceil4(g.W2);
}

// The key sets of query chunk (ci, cj): the globals (if any), then the
// in-grid neighbours in the reference's order. Returns their count. The
// same list, from (gi, gj)'s side, is the query chunks that see key chunk
// (gi, gj) (with_globals = false).
__device__ int neighbour_sets(const Geo& g, int ci, int cj, bool with_globals,
                              Set* sets) {
  int n = 0;
  if (with_globals && g.nglo > 0) sets[n++] = Set{-1, 0};
  for (int di = -1; di <= 1; ++di)
    for (int dj = -1; dj <= 1; ++dj) {
      const int a = ci + di, b = cj + dj;
      if (a >= 0 && a < g.mx && b >= 0 && b < g.my) sets[n++] = Set{a, b};
    }
  return n;
}

// Rows of a set travel from device memory to shared memory in two steps,
// so that the next set's loads are in flight while the block computes on
// the current one: stage_load starts all of a set's 16-byte loads into
// registers (at most kLoads per thread; R <= 64 rows of M <= 64 values),
// stage_store writes them to shared memory, zeros where a row is
// absent: transposed dstT[d * R + j] (d-major, for the score tiles)
// and/or row-major dstR[j * M + d]. Consecutive threads take consecutive
// rows, so the transposed stores are free of bank conflicts.
struct Staged {
  static constexpr int V = 4;  // values per load
  static constexpr int kLoads = (64 * 64 / V + kThreads - 1) / kThreads;
  uint4 buf[kLoads];
};

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}


__device__ __forceinline__ void stage_load(const Geo& g, int bh, Set s,
                                           const float* __restrict__ src, Staged& st) {
  constexpr int V = Staged::V;
  const int R = g.R, n = R * (g.M / V);
#pragma unroll
  for (int it = 0; it < Staged::kLoads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    st.buf[it] = make_uint4(0u, 0u, 0u, 0u);
    if (e < n) {
      const int j = e % R, d0 = (e / R) * V;
      const long row = set_row(g, bh, s, j);
      if (row >= 0) st.buf[it] = __ldg(reinterpret_cast<const uint4*>(src + row * g.M + d0));
    }
  }
}

__device__ __forceinline__ void stage_store(const Geo& g, const Staged& st, float* dstT,
                                            float* dstR) {
  constexpr int V = Staged::V;
  const int R = g.R, n = R * (g.M / V);
#pragma unroll
  for (int it = 0; it < Staged::kLoads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (e >= n) continue;
    const int j = e % R, d0 = (e / R) * V;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const float x = __uint_as_float(word(st.buf[it], t));
      if (dstT) dstT[(d0 + t) * R + j] = x;
      if (dstR) dstR[j * g.M + d0 + t] = x;
    }
  }
}

// valid[j] = row j of the set is present.
__device__ __forceinline__ void stage_valid(const Geo& g, int bh, Set s, int* valid) {
  for (int j = threadIdx.x; j < g.R; j += blockDim.x) valid[j] = set_row(g, bh, s, j) >= 0;
}

// A query set's per-row softmax max, 1/sum (from the forward) and, in the
// backward's second kernel, r; zeros for absent rows. Thread i < R holds
// row i.
struct RowStats {
  float m, l, r;
};

__device__ __forceinline__ RowStats load_row_stats(const Geo& g, int bh, Set s,
                                                   const float* __restrict__ stats,
                                                   const float* __restrict__ rsum) {
  RowStats v{0.f, 0.f, 0.f};
  const int i = threadIdx.x;
  const long row = i < g.R ? set_row(g, bh, s, i) : -1;
  if (row >= 0) {
    v.m = stats[2 * row];
    v.l = stats[2 * row + 1];
    if (rsum) v.r = rsum[row];
  }
  return v;
}

__device__ __forceinline__ void store_row_stats(const Geo& g, const RowStats& v, float* sM,
                                                float* sL, float* sR) {
  const int i = threadIdx.x;
  if (i < g.R) {
    sM[i] = v.m;
    sL[i] = v.l;
    if (sR) sR[i] = v.r;
  }
}

// acc[r][c] += sum_d A[d][ra + r] * B[d][cb + c] over d < M, from two
// d-major tiles of row stride R: one 4x4 register tile.
__device__ __forceinline__ void tile_dd(float (&acc)[4][4], const float* A, int ra,
                                        const float* B, int cb, int R, int M) {
  for (int d = 0; d < M; ++d) {
    const float4 a = ld4(A + d * R + ra), b = ld4(B + d * R + cb);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(comp(a, r), comp(b, c), acc[r][c]);
  }
}

// acc[r][c] += sum_t A[t][ra + r] * B[t][cb + c] over t < n, A of row
// stride lda, B of row stride ldb.
__device__ __forceinline__ void tile_tt(float (&acc)[4][4], const float* A, int lda, int ra,
                                        const float* B, int ldb, int cb, int n) {
  for (int t = 0; t < n; ++t) {
    const float4 a = ld4(A + t * lda + ra), b = ld4(B + t * ldb + cb);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(comp(a, r), comp(b, c), acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// ---------------------------------------------------------------------------
// Shared-memory layouts (floats; the int arrays last). The host sizes the
// launch from the same functions.

__host__ __device__ inline int fwd_cols(const Geo& g) { return g.G + 9 * g.R; }

__host__ __device__ inline size_t fwd_floats(const Geo& g) {
  return (size_t)2 * g.M * g.R + (size_t)fwd_cols(g) * g.R + (size_t)kParts * g.R;
}
__host__ __device__ inline size_t bwd_q_floats(const Geo& g) {
  return (size_t)5 * g.M * g.R + (size_t)g.R * g.R + (size_t)g.G * g.R +
         (size_t)kGrid * g.R + 3 * (size_t)g.R;
}
__host__ __device__ inline size_t bwd_k_floats(const Geo& g) {
  return (size_t)6 * g.M * g.R + 2 * (size_t)g.R * g.R + 3 * (size_t)g.R;
}
__host__ inline size_t smem_bytes(size_t floats, const Geo& g) {
  return floats * sizeof(float) + 2 * (size_t)g.R * sizeof(int);
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernels.
//
// Forward: block (query chunk, bh). Writes o and the per-row (m, 1/sum).

__global__ void __launch_bounds__(kThreads)
sliding_chunk_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ kg,
                         const float* __restrict__ vg, float* __restrict__ out,
                         float* __restrict__ stats, Geo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const Set self{chunk / g.my, chunk % g.my};
  const int R = g.R, M = g.M, ncols = fwd_cols(g);
  float* sQT = smem;                    // M x R, d-major
  float* sKV = sQT + M * R;             // K^T (M x R) or V (R x M)
  float* sS = sKV + M * R;              // ncols x R: score column c of row i at c*R+i
  float* sRed = sS + (size_t)ncols * R; // kParts x R
  int* sQv = reinterpret_cast<int*>(sRed + kParts * R);
  int* sKv = sQv + R;

  Set sets[kMaxSets];
  int col0[kMaxSets];
  const int nsets = neighbour_sets(g, self.ci, self.cj, true, sets);
  for (int s = 0, c = 0; s < nsets; ++s) {
    col0[s] = c;
    c += sets[s].ci < 0 ? g.G : R;
  }

  auto keys = [&](int s) { return sets[s].ci < 0 ? kg : k; };
  auto vals = [&](int s) { return sets[s].ci < 0 ? vg : v; };
  Staged st;
  stage_load(g, bh, self, q, st);
  stage_store(g, st, sQT, nullptr);
  stage_valid(g, bh, self, sQv);
  const int a = threadIdx.x / kGrid, b = threadIdx.x % kGrid;

  // Scores of every (query, key) pair, absent keys -inf. The next set's
  // loads are in flight while a set's tile is computed.
  stage_load(g, bh, sets[0], keys(0), st);
  for (int s = 0; s < nsets; ++s) {
    __syncthreads();
    stage_store(g, st, sKV, nullptr);
    stage_valid(g, bh, sets[s], sKv);
    __syncthreads();
    if (s + 1 < nsets) stage_load(g, bh, sets[s + 1], keys(s + 1), st);
    if (4 * a < R && 4 * b < set_keys(g, sets[s])) {
      float acc[4][4];
      zero(acc);
      tile_dd(acc, sQT, 4 * a, sKV, 4 * b, R, M);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = sKv[4 * b + c];
        st4(sS + (size_t)(col0[s] + 4 * b + c) * R + 4 * a,
            ok ? acc[0][c] : -INFINITY, ok ? acc[1][c] : -INFINITY,
            ok ? acc[2][c] : -INFINITY, ok ? acc[3][c] : -INFINITY);
      }
    }
  }
  stage_load(g, bh, sets[0], vals(0), st);  // in flight through the softmax
  __syncthreads();

  // Softmax per row: kParts threads per row, each a fixed set of columns,
  // combined in part order.
  const int i = threadIdx.x % 64, part = threadIdx.x / 64;
  auto each_col = [&](auto&& f) {
    for (int s = 0; s < nsets; ++s) {
      const int nk = set_keys(g, sets[s]);
      for (int j = part; j < nk; j += kParts) f((size_t)(col0[s] + j) * R + i);
    }
  };
  float mx_part = -INFINITY;
  if (i < R) each_col([&](size_t at) { mx_part = fmaxf(mx_part, sS[at]); });
  if (i < R) sRed[part * R + i] = mx_part;
  __syncthreads();
  float m = -INFINITY;
  if (i < R)
    for (int p = 0; p < kParts; ++p) m = fmaxf(m, sRed[p * R + i]);
  __syncthreads();
  float l_part = 0.f;
  if (i < R) each_col([&](size_t at) { l_part += expf(sS[at] - m); });
  if (i < R) sRed[part * R + i] = l_part;
  __syncthreads();
  if (i < R) {
    float l = 0.f;
    for (int p = 0; p < kParts; ++p) l += sRed[p * R + i];
    const float linv = 1.f / l;
    each_col([&](size_t at) { sS[at] = expf(sS[at] - m) * linv; });
    const long row = set_row(g, bh, self, i);
    if (part == 0 && row >= 0) {
      stats[2 * row] = m;
      stats[2 * row + 1] = linv;
    }
  }

  // o = round(p) v, the globals first, then the neighbour chunks.
  float acc[4][4];
  zero(acc);
  const bool active = 4 * a < R && 4 * b < M;
  for (int s = 0; s < nsets; ++s) {
    __syncthreads();
    stage_store(g, st, nullptr, sKV);
    __syncthreads();
    if (s + 1 < nsets) stage_load(g, bh, sets[s + 1], vals(s + 1), st);
    if (active)
      tile_tt(acc, sS + (size_t)col0[s] * R, R, 4 * a, sKV, M, 4 * b,
              set_keys(g, sets[s]));
  }
  if (active)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long row = set_row(g, bh, self, 4 * a + r);
      if (row < 0) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) out[row * M + 4 * b + c] = acc[r][c];
    }
}

// p32, rebuilt from the forward's row max and 1/sum.
__device__ __forceinline__ float prob(float s, float m, float linv) {
  return expf(s - m) * linv;
}

// ---------------------------------------------------------------------------
// Backward 1: block (query chunk, bh). Writes r, dq and this chunk's
// partials of dkg (partial[0]) and dvg (partial[1]).

__global__ void __launch_bounds__(kThreads)
sliding_chunk_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ kg,
                           const float* __restrict__ vg, const float* __restrict__ dout,
                           const float* __restrict__ stats, float* __restrict__ dq,
                           float* __restrict__ rsum, float* __restrict__ partial, Geo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const Set self{chunk / g.my, chunk % g.my};
  const int R = g.R, M = g.M;
  float* sQT = smem;           // M x R
  float* sDOT = sQT + M * R;   // M x R
  float* sKT = sDOT + M * R;   // M x R
  float* sVT = sKT + M * R;    // M x R
  float* sK = sVT + M * R;     // R x M
  float* sDS = sK + M * R;     // R x R: ds of key j, query i at j*R+i
  float* sPB = sDS + R * R;    // G x R: round(p) of global j, query i
  float* sRp = sPB + g.G * R;  // kGrid x R: partial row sums of p*dp
  float* sM = sRp + kGrid * R;
  float* sL = sM + R;
  float* sR = sL + R;
  int* sQv = reinterpret_cast<int*>(sR + R);
  int* sKv = sQv + R;

  Set sets[kMaxSets];
  const int nsets = neighbour_sets(g, self.ci, self.cj, true, sets);
  auto keys = [&](int s) { return sets[s].ci < 0 ? kg : k; };
  auto vals = [&](int s) { return sets[s].ci < 0 ? vg : v; };
  Staged sk, sv;
  stage_load(g, bh, self, q, sk);
  stage_load(g, bh, self, dout, sv);
  store_row_stats(g, load_row_stats(g, bh, self, stats, nullptr), sM, sL, nullptr);
  stage_store(g, sk, sQT, nullptr);
  stage_store(g, sv, sDOT, nullptr);
  stage_valid(g, bh, self, sQv);
  const int a = threadIdx.x / kGrid, b = threadIdx.x % kGrid;

  // Pass 1: r = rowsum(p * dp) over every key of the row.
  float racc[4] = {0.f, 0.f, 0.f, 0.f};
  stage_load(g, bh, sets[0], keys(0), sk);
  stage_load(g, bh, sets[0], vals(0), sv);
  for (int s = 0; s < nsets; ++s) {
    __syncthreads();
    stage_store(g, sk, sKT, nullptr);
    stage_store(g, sv, sVT, nullptr);
    stage_valid(g, bh, sets[s], sKv);
    __syncthreads();
    if (s + 1 < nsets) {
      stage_load(g, bh, sets[s + 1], keys(s + 1), sk);
      stage_load(g, bh, sets[s + 1], vals(s + 1), sv);
    }
    if (4 * a < R && 4 * b < set_keys(g, sets[s])) {
      float sc[4][4], dp[4][4];
      zero(sc);
      zero(dp);
      tile_dd(sc, sQT, 4 * a, sKT, 4 * b, R, M);
      tile_dd(dp, sDOT, 4 * a, sVT, 4 * b, R, M);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (sKv[4 * b + c])
            racc[r] += prob(sc[r][c], sM[4 * a + r], sL[4 * a + r]) * dp[r][c];
    }
  }
  stage_load(g, bh, sets[0], keys(0), sk);  // pass 2's first set
  stage_load(g, bh, sets[0], vals(0), sv);
  if (4 * a < R)
#pragma unroll
    for (int r = 0; r < 4; ++r) sRp[b * R + 4 * a + r] = racc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    float r = 0.f;
    for (int t = 0; t < kGrid; ++t) r += sRp[t * R + i];
    sR[i] = r;
    const long row = set_row(g, bh, self, i);
    if (row >= 0) rsum[row] = r;
  }

  // Pass 2: ds, then dq = ds k and the globals' partials.
  float acc[4][4];
  zero(acc);
  for (int s = 0; s < nsets; ++s) {
    const bool glo = sets[s].ci < 0;
    const int nk = set_keys(g, sets[s]);
    __syncthreads();
    stage_store(g, sk, sKT, sK);
    stage_store(g, sv, sVT, nullptr);
    stage_valid(g, bh, sets[s], sKv);
    __syncthreads();
    if (s + 1 < nsets) {
      stage_load(g, bh, sets[s + 1], keys(s + 1), sk);
      stage_load(g, bh, sets[s + 1], vals(s + 1), sv);
    }
    if (4 * a < R && 4 * b < nk) {
      float sc[4][4], dp[4][4];
      zero(sc);
      zero(dp);
      tile_dd(sc, sQT, 4 * a, sKT, 4 * b, R, M);
      tile_dd(dp, sDOT, 4 * a, sVT, 4 * b, R, M);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = sKv[4 * b + c];
        float ds[4], pb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * a + r;
          const float p = ok ? prob(sc[r][c], sM[i], sL[i]) : 0.f;
          ds[r] = p * (dp[r][c] - sR[i]);
          pb[r] = p;
        }
        st4(sDS + (4 * b + c) * R + 4 * a, ds[0], ds[1], ds[2], ds[3]);
        if (glo) st4(sPB + (4 * b + c) * R + 4 * a, pb[0], pb[1], pb[2], pb[3]);
      }
    }
    __syncthreads();
    if (4 * a < R && 4 * b < M) tile_tt(acc, sDS, R, 4 * a, sK, M, 4 * b, nk);
    if (glo) {
      // dkg[j][d] = sum_i ds[i][j] q[i][d];  dvg[j][d] = sum_i round(p) do.
      const size_t per = (size_t)g.nglo * M;
      float* pk = partial + ((size_t)bh * gridDim.x + chunk) * per;
      float* pv = pk + (size_t)g.BH * gridDim.x * per;
      for (int e = threadIdx.x; e < g.nglo * M; e += blockDim.x) {
        const int j = e / M, d = e - j * M;
        float sk = 0.f, sv = 0.f;
        for (int i = 0; i < R; ++i) {
          sk = fmaf(sDS[j * R + i], sQT[d * R + i], sk);
          sv = fmaf(sPB[j * R + i], sDOT[d * R + i], sv);
        }
        pk[e] = sk;
        pv[e] = sv;
      }
    }
  }
  if (4 * a < R && 4 * b < M)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long row = set_row(g, bh, self, 4 * a + r);
      if (row < 0) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) dq[row * M + 4 * b + c] = acc[r][c];
    }
}

// ---------------------------------------------------------------------------
// Backward 2: block (key chunk, bh). dk, dv of the chunk's keys, gathered
// from the query chunks that see it.

__global__ void __launch_bounds__(kThreads)
sliding_chunk_bwd_k_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ stats, const float* __restrict__ rsum,
                           float* __restrict__ dk, float* __restrict__ dv, Geo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const Set self{chunk / g.my, chunk % g.my};
  const int R = g.R, M = g.M;
  float* sKT = smem;           // M x R, this chunk's keys
  float* sVT = sKT + M * R;
  float* sQT = sVT + M * R;    // M x R, the query chunk
  float* sDOT = sQT + M * R;
  float* sQ = sDOT + M * R;    // R x M
  float* sDO = sQ + M * R;     // R x M
  float* sPB = sDO + M * R;    // R x R: round(p) of query i, key j at i*R+j
  float* sDS = sPB + R * R;    // R x R
  float* sM = sDS + R * R;
  float* sL = sM + R;
  float* sR = sL + R;
  int* sQv = reinterpret_cast<int*>(sR + R);
  int* sKv = sQv + R;

  Set sets[kMaxSets];
  const int nsets = neighbour_sets(g, self.ci, self.cj, false, sets);
  Staged sa, sb;
  stage_load(g, bh, self, k, sa);
  stage_load(g, bh, self, v, sb);
  stage_store(g, sa, sKT, nullptr);
  stage_store(g, sb, sVT, nullptr);
  stage_valid(g, bh, self, sKv);
  const int a = threadIdx.x / kGrid, b = threadIdx.x % kGrid;
  float ak[4][4], av[4][4];
  zero(ak);
  zero(av);
  stage_load(g, bh, sets[0], q, sa);
  stage_load(g, bh, sets[0], dout, sb);
  RowStats rs = load_row_stats(g, bh, sets[0], stats, rsum);
  for (int s = 0; s < nsets; ++s) {
    __syncthreads();
    stage_store(g, sa, sQT, sQ);
    stage_store(g, sb, sDOT, sDO);
    stage_valid(g, bh, sets[s], sQv);
    store_row_stats(g, rs, sM, sL, sR);
    __syncthreads();
    if (s + 1 < nsets) {
      stage_load(g, bh, sets[s + 1], q, sa);
      stage_load(g, bh, sets[s + 1], dout, sb);
      rs = load_row_stats(g, bh, sets[s + 1], stats, rsum);
    }
    // Tile (a: keys, b: queries) of s^T and dp^T.
    if (4 * a < R && 4 * b < R) {
      float sc[4][4], dp[4][4];
      zero(sc);
      zero(dp);
      tile_dd(sc, sKT, 4 * a, sQT, 4 * b, R, M);
      tile_dd(dp, sVT, 4 * a, sDOT, 4 * b, R, M);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * b + c;
        float ds[4], pb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool ok = sKv[4 * a + r] && sQv[i];
          const float p = ok ? prob(sc[r][c], sM[i], sL[i]) : 0.f;
          ds[r] = p * (dp[r][c] - sR[i]);
          pb[r] = p;
        }
        st4(sPB + i * R + 4 * a, pb[0], pb[1], pb[2], pb[3]);
        st4(sDS + i * R + 4 * a, ds[0], ds[1], ds[2], ds[3]);
      }
    }
    __syncthreads();
    if (4 * a < R && 4 * b < M) {
      tile_tt(av, sPB, R, 4 * a, sDO, M, 4 * b, R);
      tile_tt(ak, sDS, R, 4 * a, sQ, M, 4 * b, R);
    }
  }
  if (4 * a < R && 4 * b < M)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long row = set_row(g, bh, self, 4 * a + r);
      if (row < 0) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dk[row * M + 4 * b + c] = ak[r][c];
        dv[row * M + 4 * b + c] = av[r][c];
      }
    }
}

// Backward 3: dkg, dvg = the per-chunk partials summed in chunk order.
template <typename T>
__global__ void glo_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dkg,
                                  T* __restrict__ dvg, int BH, int chunks, int per) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * BH * per) return;
  const int which = idx / (BH * per), rest = idx - which * BH * per;
  const int bh = rest / per, e = rest - bh * per;
  const float* p = partial + ((size_t)which * BH + bh) * chunks * per + e;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += p[(size_t)c * per];
  (which == 0 ? dkg : dvg)[(size_t)bh * per + e] = from_f<T>(acc);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (the header's mma.sync primitives).

namespace tc {

constexpr int kStages = 2;         // ring slots (a set in flight, a set in use)
constexpr int kThreadsMax = 128;   // four m16 row tiles: W^2 <= 64
// Blocks per SM each kernel's registers are held to (__launch_bounds__).
constexpr int kFwdBlocks = 4, kBwdQBlocks = 4, kBwdKBlocks = 3;
constexpr size_t kMaskBytes = 128; // kMaxSets + 1 row masks (uint64)
// The last k16 pair of an odd head-dim step count reads 16 bytes past a
// tile's last row (unused columns): room for that past the last region.
constexpr size_t kSlack = 128;

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// A chunk tile: round16(W^2) rows (the globals' tile uses its first 16)
// of round16(M) columns at the header's padded bf16 row stride.
__host__ __device__ inline int tile_rows(const Geo& g) { return round16(g.W2); }
__host__ __device__ inline int tile_ld(const Geo& g) { return wtile::Layout<bf16>::ld(g.M); }
__host__ __device__ inline int warps(const Geo& g) { return tile_rows(g) / 16; }
__host__ __device__ inline size_t tile_bytes(const Geo& g) {
  return wtile::round_up_bytes((size_t)tile_rows(g) * tile_ld(g) * sizeof(bf16));
}
// bwd_k's per-query-row m, 1/sum and r of a staged query set.
__host__ __device__ inline size_t stat_bytes(const Geo& g) {
  return wtile::round_up_bytes((size_t)3 * tile_rows(g) * sizeof(float));
}
// bwd_q's per-warp shares of the chunk's dkg and dvg partials.
__host__ __device__ inline size_t part_bytes(const Geo& g) {
  return wtile::round_up_bytes((size_t)warps(g) * 2 * g.nglo * g.M * sizeof(float));
}

// Shared memory of each kernel (ops/sliding_chunk.py kernel_smem_bytes
// mirrors it): the row masks, then
//   forward: Q, then kStages slots of [K | V];
//   bwd_q:   Q, dO, kStages slots of [K | V], the global partials' shares;
//   bwd_k:   K, V (the key chunk), kStages slots of [Q | dO | stats].
__host__ __device__ inline size_t fwd_bytes(const Geo& g) {
  return kMaskBytes + (1 + 2 * kStages) * tile_bytes(g) + kSlack;
}
__host__ __device__ inline size_t bwd_q_bytes(const Geo& g) {
  return kMaskBytes + (2 + 2 * kStages) * tile_bytes(g) + part_bytes(g) + kSlack;
}
__host__ __device__ inline size_t bwd_k_bytes(const Geo& g) {
  return kMaskBytes + 2 * tile_bytes(g) + kStages * (2 * tile_bytes(g) + stat_bytes(g)) + kSlack;
}

// Bit j: row j of the set is present (the globals: j < nglo; a chunk: its
// in-grid real tokens), as set_row says.
__device__ inline uint64_t set_mask(const Geo& g, Set s) {
  if (s.ci < 0) return (1ull << g.nglo) - 1ull;
  const int rx = min(g.W, g.nx - s.ci * g.W), ry = min(g.W, g.ny - s.cj * g.W);
  uint64_t m = 0;
  for (int j = 0; j < g.W2; ++j)
    if (j / g.W < rx && j % g.W < ry) m |= 1ull << j;
  return m;
}

__device__ __forceinline__ bool bit(uint64_t mask, int j) { return (mask >> j) & 1ull; }

// A thread's share of copying a tile, the same for every set: slots
// threadIdx.x + i blockDim.x < rows x round16(M) / 8 of (row j, 16-byte
// unit u), at most kCopies a thread (blockDim.x = 2 rows), each packed as
// j | u << 8 | (j / W) << 12 | (j % W) << 16 (all 0xffffffff when unused),
// so no set divides by W again.
constexpr int kCopies = 4;
struct CopyPlan {
  uint32_t slot[kCopies];
};

__device__ __forceinline__ CopyPlan copy_plan(const Geo& g) {
  const int units = round16(g.M) / 8, n = tile_rows(g) * units;
  CopyPlan plan;
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int e = threadIdx.x + i * blockDim.x, j = e / units, u = e - j * units;
    plan.slot[i] = e < n ? (uint32_t)(j | u << 8 | (j / g.W) << 12 | (j % g.W) << 16) : ~0u;
  }
  return plan;
}

// Starts the copy of rows [0, n) of set s of src into the tile dst (the
// whole block, by the plan): 16-byte cp.async for the present rows' head
// columns, zeros for absent rows and for columns [M, round16(M)).
__device__ __forceinline__ void stage_set(const Geo& g, const CopyPlan& plan, int bh, Set s,
                                          int n, const bf16* __restrict__ src, bf16* dst) {
  const int real = g.M / 8, ld = tile_ld(g);
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const uint32_t p = plan.slot[i];
    const int j = p & 0xff, u = (p >> 8) & 0xf;
    if (p == ~0u || j >= n) continue;
    bf16* d = dst + j * ld + 8 * u;
    const long row = u < real ? plan_row(g, bh, s, j, (p >> 12) & 0xf, (p >> 16) & 0xf) : -1;
    if (row >= 0)
      wtile::cp_async16(d, src + row * g.M + 8 * u);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(wtile::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Starts the copy of a query set's per-row m, 1/sum and r into dst[0..R),
// dst[R..2R), dst[2R..3R) (R = tile_rows), zeros for absent rows: thread
// j < R takes row j (at jx, jy in its chunk).
__device__ __forceinline__ void stage_stats(const Geo& g, int bh, Set s, int jx, int jy,
                                            const float* __restrict__ stats,
                                            const float* __restrict__ rsum, float* dst) {
  const int R = tile_rows(g), j = threadIdx.x;
  if (j >= R) return;
  const long row = plan_row(g, bh, s, j, jx, jy);
  const float* src[3] = {stats + 2 * row, stats + 2 * row + 1, rsum + row};
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    if (row < 0)
      dst[w * R + j] = 0.f;
    else
      cp_async4(dst + w * R + j, src[w]);
  }
}

// The 8 x 8 b16 block of a fragment register, transposed across the warp.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The helpers and kernels below are templated on KD = round16(M) / 16, the
// head dim's k16 steps, so fragments and accumulators are sized to the
// head dim and every loop over it is unrolled.

// A fragments of the 16 rows at row0 of a tile, KD k16 steps of the head dim.
template <int KD>
__device__ __forceinline__ void load_a(uint32_t (&a)[KD][4], const bf16* tile, int ld, int row0,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    wtile::ldsm_x4(a[kk], tile + (row0 + (lane & 15)) * ld + 16 * kk + ((lane >> 4) << 3));
}

// acc[j] = A . B^T over the head dim for the n8 column tiles nt0 + j, j < n
// (the rest zero): B's rows 8 (nt0 + j).. of a tile stored [row][dim] (the
// S = Q K^T shape), one ldmatrix x4 per two k16 steps (the last one
// half-used when KD is odd: its upper columns are padding or the next
// row's, unused).
template <int N, int KD>
__device__ __forceinline__ void a_by_rows(float (&acc)[N][4], const uint32_t (&a)[KD][4],
                                          const bf16* tile, int ld, int nt0, int n, int lane) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    if (j >= n) continue;
    const bf16* brow = tile + (8 * (nt0 + j) + (lane & 7)) * ld + ((lane >> 3) << 3);
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
      uint32_t b[4];
      wtile::ldsm_x4(b, brow + 16 * kk);
      wtile::mma_bf16(acc[j], a[kk], {b[0], b[1]});
      if (kk + 1 < KD) wtile::mma_bf16(acc[j], a[kk + 1], {b[2], b[3]});
    }
  }
}

// out[dt] += A . B for one k16 step over rows row0.. of a tile stored
// [row][dim] (the P V shape: B by ldmatrix.trans), 2 KD n8 column tiles.
template <int KD>
__device__ __forceinline__ void frag_by_rows(float (&out)[2 * KD][4], const uint32_t (&a)[4],
                                             const bf16* tile, int ld, int row0, int lane) {
  const bf16* brow = tile + (row0 + (lane & 15)) * ld + ((lane >> 4) << 3);
#pragma unroll
  for (int dt = 0; dt < 2 * KD; dt += 2) {
    uint32_t b[4];
    wtile::ldsm_x4_t(b, brow + 8 * dt);
    wtile::mma_bf16(out[dt], a, {b[0], b[1]});
    wtile::mma_bf16(out[dt + 1], a, {b[2], b[3]});
  }
}

// The bf16 A fragment of a k16 step from the accumulators of its two n8
// column tiles (x[0]: columns 0-7, x[1]: 8-15).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = wtile::pack_bf16(x[0][0], x[0][1]);
  a[1] = wtile::pack_bf16(x[0][2], x[0][3]);
  a[2] = wtile::pack_bf16(x[1][0], x[1][1]);
  a[3] = wtile::pack_bf16(x[1][2], x[1][3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int dt = 0; dt < N; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
}

// Stores rows gq and gq + 8 of an (m16, head dim) accumulator tile whose
// token rows are row[0], row[1] (< 0: absent), rounded to bf16.
template <int KD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const long (&row)[2],
                                           const float (&o)[2 * KD][4], int M, int lane) {
  const int tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] < 0) continue;
    bf16* out = dst + row[h] * M;
#pragma unroll
    for (int dt = 0; dt < 2 * KD; ++dt) {
      const int c = 8 * dt + 2 * tq;
      if (c < M)
        *reinterpret_cast<uint32_t*>(out + c) = wtile::pack_bf16(o[dt][2 * h], o[dt][2 * h + 1]);
    }
  }
}

// One warp's share of a global partial: part[j][d] = sum over the warp's
// 16 query rows i of f[i][j] x[i][d] for j < nglo, where f holds the bf16
// fragments of the globals' k16 step (globals 0-7 in f[0], f[1]; 8-15 are
// padding) and x the tile rows at row0. movmatrix turns f's two 8 x 8
// blocks into the A operand (globals x queries); x comes by ldmatrix.trans.
template <int KD>
__device__ __forceinline__ void glo_share(float* part, const uint32_t (&f)[4], const bf16* x,
                                          int ld, int row0, const Geo& g, int lane) {
  const uint32_t a[4] = {transpose8x8(f[0]), 0u, transpose8x8(f[1]), 0u};
  float acc[2 * KD][4];
  zero(acc);
  frag_by_rows<KD>(acc, a, x, ld, row0, lane);
  const int gq = lane >> 2, tq = lane & 3;
  if (gq >= g.nglo) return;
#pragma unroll
  for (int dt = 0; dt < 2 * KD; ++dt) {
    const int c = 8 * dt + 2 * tq;
    if (c < g.M) {
      part[gq * g.M + c] = acc[dt][0];
      part[gq * g.M + c + 1] = acc[dt][1];
    }
  }
}

// exp(s - m) as 2^(s log2e - m log2e), one fma and one ex2 (the window
// tile's form); moff = -m log2e.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp_off(float s, float moff) {
  return exp2f(fmaf(s, kLog2e, moff));
}

// p of a score in fp32 from its row's -m log2e and 1/sum; 0 where the pair
// is absent (never exp(s - 0) * 0 of a padded row).
__device__ __forceinline__ float prob_or_0(bool ok, float s, float moff, float linv) {
  return ok ? exp_off(s, moff) * linv : 0.f;
}

// The running (max, sum) of a row merged with another's: the sums scaled
// to the larger max; a max of -inf has a sum of 0.
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = (m == -INFINITY ? 0.f : l * exp_off(m, -mn * kLog2e)) +
      (mo == -INFINITY ? 0.f : lo * exp_off(mo, -mn * kLog2e));
  m = mn;
}

// The ring: item t goes to slot t % kStages. ring_next waits for item t,
// meets the block, starts fetching item t + kStages - 1 (fetch commits
// one cp.async group per item, empty past the last) and returns t's slot.
template <class Fetch>
__device__ __forceinline__ int ring_next(int t, Fetch&& fetch) {
  wtile::cp_async_wait<kStages - 2>();
  __syncthreads();
  fetch(t + kStages - 1);
  return t % kStages;
}

// Key tiles of a set: n8 column tiles holding a present key (nn) and k16
// steps (kp); the globals' tile has nglo <= 8 keys.
__device__ __forceinline__ int key_tiles8(const Geo& g, Set s) {
  return s.ci < 0 ? 1 : (g.W2 + 7) / 8;
}
__device__ __forceinline__ int key_steps16(const Geo& g, Set s) {
  return s.ci < 0 ? 1 : (g.W2 + 15) / 16;
}

// ---------------------------------------------------------------------------
// Forward: block (query chunk, bh). Writes o and the per-row (m, 1/sum).

template <int KD>
__global__ void __launch_bounds__(kThreadsMax, kFwdBlocks)
sliding_chunk_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ kg,
                            const bf16* __restrict__ vg, bf16* __restrict__ out,
                            float* __restrict__ stats, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const Set self{chunk / g.my, chunk % g.my};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int R = tile_rows(g), ld = tile_ld(g);
  const size_t T = tile_bytes(g) / sizeof(bf16);
  uint64_t* sMask = reinterpret_cast<uint64_t*>(smem);
  bf16* sQ = reinterpret_cast<bf16*>(smem + kMaskBytes);
  bf16* ring = sQ + T;  // kStages slots of [K | V]

  Set sets[kMaxSets];
  const int nsets = neighbour_sets(g, self.ci, self.cj, true, sets);
  if (threadIdx.x < nsets) sMask[threadIdx.x] = set_mask(g, sets[threadIdx.x]);
  const CopyPlan plan = copy_plan(g);
  stage_set(g, plan, bh, self, R, q, sQ);
  wtile::cp_async_commit();
  // Item t < nsets: set t's keys (pass 1); nsets + s: set s's keys and
  // values (pass 2).
  auto fetch = [&](int t) {
    if (t < 2 * nsets) {
      const int s = t < nsets ? t : t - nsets;
      const bool glo = sets[s].ci < 0;
      bf16* slot = ring + (size_t)(t % kStages) * 2 * T;
      stage_set(g, plan, bh, sets[s], glo ? 16 : R, glo ? kg : k, slot);
      if (t >= nsets) stage_set(g, plan, bh, sets[s], glo ? 16 : R, glo ? vg : v, slot + T);
    }
    wtile::cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  wtile::cp_async_wait<kStages - 1>();  // Q
  __syncthreads();
  uint32_t qa[KD][4];
  load_a(qa, sQ, ld, 16 * warp, lane);

  // Pass 1: each lane's running max and sum of rows gq, gq + 8 over its
  // columns, set by set; then the quad's, merged in xor order. A lane's
  // key columns are 8 nt + 2 tq + e: its mask bits, shifted by 2 tq.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < nsets; ++t) {
    const bf16* sk = ring + (size_t)ring_next(t, fetch) * 2 * T;
    const uint64_t mask = sMask[t] >> (2 * tq);
    const int nn = key_tiles8(g, sets[t]);
    float s[8][4];
    a_by_rows(s, qa, sk, ld, 0, nn, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (nt < nn && bit(mask, 8 * nt + (e & 1))) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float moff = -fmaxf(m[h], mx[h]) * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (nt < nn && bit(mask, 8 * nt + e)) sum += exp_off(s[nt][2 * h + e], moff);
      merge(m[h], l[h], mx[h], 0.f);
      l[h] += sum;
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      merge(m[h], l[h], __shfl_xor_sync(wtile::kFull, m[h], o),
            __shfl_xor_sync(wtile::kFull, l[h], o));
  const float linv[2] = {1.f / l[0], 1.f / l[1]};
  const float moff[2] = {-m[0] * kLog2e, -m[1] * kLog2e};

  // Pass 2: p = exp(s - m) / sum, rounded into A fragments; O += P V.
  float o[2 * KD][4];
  zero(o);
  for (int t = nsets; t < 2 * nsets; ++t) {
    const bf16* sk = ring + (size_t)ring_next(t, fetch) * 2 * T;
    const bf16* sv = sk + T;
    const uint64_t mask = sMask[t - nsets] >> (2 * tq);
    const int nn = key_tiles8(g, sets[t - nsets]), kp = key_steps16(g, sets[t - nsets]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= kp) continue;
      float x[2][4];
      a_by_rows(x, qa, sk, ld, 2 * kk, min(2, nn - 2 * kk), lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[j][e] = prob_or_0(bit(mask, 16 * kk + 8 * j + (e & 1)), x[j][e], moff[e >> 1],
                              linv[e >> 1]);
      uint32_t pa[4];
      pack_a(pa, x);
      frag_by_rows<KD>(o, pa, sv, ld, 16 * kk, lane);
    }
  }
  const long row[2] = {set_row(g, bh, self, 16 * warp + gq),
                       set_row(g, bh, self, 16 * warp + gq + 8)};
  store_rows<KD>(out, row, o, g.M, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (tq == 0 && row[h] >= 0) {
      stats[2 * row[h]] = m[h];
      stats[2 * row[h] + 1] = linv[h];
    }
}

// ---------------------------------------------------------------------------
// Backward 1: block (query chunk, bh). Writes r, dq and this chunk's
// partials of dkg (partial[0]) and dvg (partial[1]).

template <int KD>
__global__ void __launch_bounds__(kThreadsMax, kBwdQBlocks)
sliding_chunk_bwd_q_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ kg,
                              const bf16* __restrict__ vg, const bf16* __restrict__ dout,
                              const float* __restrict__ stats, bf16* __restrict__ dq,
                              float* __restrict__ rsum, float* __restrict__ partial, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const Set self{chunk / g.my, chunk % g.my};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int R = tile_rows(g), ld = tile_ld(g);
  const size_t T = tile_bytes(g) / sizeof(bf16);
  const int per = g.nglo * g.M;
  uint64_t* sMask = reinterpret_cast<uint64_t*>(smem);
  bf16* sQ = reinterpret_cast<bf16*>(smem + kMaskBytes);
  bf16* sDO = sQ + T;
  bf16* ring = sDO + T;  // kStages slots of [K | V]
  float* sPart = reinterpret_cast<float*>(ring + (size_t)kStages * 2 * T);  // [warp][2][per]

  Set sets[kMaxSets];
  const int nsets = neighbour_sets(g, self.ci, self.cj, true, sets);
  if (threadIdx.x < nsets) sMask[threadIdx.x] = set_mask(g, sets[threadIdx.x]);
  const CopyPlan plan = copy_plan(g);
  stage_set(g, plan, bh, self, R, q, sQ);
  stage_set(g, plan, bh, self, R, dout, sDO);
  wtile::cp_async_commit();
  // Item t: set t % nsets's keys and values (pass 1, then pass 2).
  auto fetch = [&](int t) {
    if (t < 2 * nsets) {
      const int s = t % nsets;
      const bool glo = sets[s].ci < 0;
      bf16* slot = ring + (size_t)(t % kStages) * 2 * T;
      stage_set(g, plan, bh, sets[s], glo ? 16 : R, glo ? kg : k, slot);
      stage_set(g, plan, bh, sets[s], glo ? 16 : R, glo ? vg : v, slot + T);
    }
    wtile::cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  wtile::cp_async_wait<kStages - 1>();  // Q, dO
  __syncthreads();
  uint32_t qa[KD][4], da[KD][4];
  load_a(qa, sQ, ld, 16 * warp, lane);
  load_a(da, sDO, ld, 16 * warp, lane);
  const long row[2] = {set_row(g, bh, self, 16 * warp + gq),
                       set_row(g, bh, self, 16 * warp + gq + 8)};
  float moff[2], linv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    moff[h] = row[h] >= 0 ? -stats[2 * row[h]] * kLog2e : 0.f;
    linv[h] = row[h] >= 0 ? stats[2 * row[h] + 1] : 0.f;
  }

  // S and dP of k16 step kk of a set's keys, then p (into s).
  auto step = [&](float (&s)[2][4], float (&dp)[2][4], const bf16* sk, int set, int kk) {
    const uint64_t mask = sMask[set] >> (2 * tq);
    const int n = min(2, key_tiles8(g, sets[set]) - 2 * kk);
    a_by_rows(s, qa, sk, ld, 2 * kk, n, lane);
    a_by_rows(dp, da, sk + T, ld, 2 * kk, n, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = prob_or_0(row[e >> 1] >= 0 && bit(mask, 16 * kk + 8 * j + (e & 1)), s[j][e],
                            moff[e >> 1], linv[e >> 1]);
  };

  // Pass 1: r = rowsum(p * dp), per lane over the sets, then the quad's.
  float r[2] = {0.f, 0.f};
  for (int t = 0; t < nsets; ++t) {
    const bf16* sk = ring + (size_t)ring_next(t, fetch) * 2 * T;
    const int kp = key_steps16(g, sets[t]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= kp) continue;
      float s[2][4], dp[2][4];
      step(s, dp, sk, t, kk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e >> 1] += s[j][e] * dp[j][e];
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) r[h] += __shfl_xor_sync(wtile::kFull, r[h], o);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (tq == 0 && row[h] >= 0) rsum[row[h]] = r[h];

  // Pass 2: ds = round(p (dp - r)); dq += ds K; the globals' shares.
  float acc[2 * KD][4];
  zero(acc);
  float* share = sPart + (size_t)warp * 2 * per;
  for (int t = nsets; t < 2 * nsets; ++t) {
    const bf16* sk = ring + (size_t)ring_next(t, fetch) * 2 * T;
    const bool glo = sets[t - nsets].ci < 0;
    const int kp = key_steps16(g, sets[t - nsets]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= kp) continue;
      float s[2][4], dp[2][4];
      step(s, dp, sk, t - nsets, kk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - r[e >> 1]);
      uint32_t dsa[4];
      pack_a(dsa, dp);
      frag_by_rows<KD>(acc, dsa, sk, ld, 16 * kk, lane);
      if (glo) {
        uint32_t pa[4];
        pack_a(pa, s);
        glo_share<KD>(share, dsa, sQ, ld, 16 * warp, g, lane);
        glo_share<KD>(share + per, pa, sDO, ld, 16 * warp, g, lane);
      }
    }
  }
  store_rows<KD>(dq, row, acc, g.M, lane);
  if (g.nglo == 0) return;
  __syncthreads();
  // The chunk's partials: the warps' shares summed in warp order.
  const int nw = blockDim.x >> 5, chunks = gridDim.x;
  for (int e = threadIdx.x; e < 2 * per; e += blockDim.x) {
    const int which = e / per, i = e - which * per;
    float sum = 0.f;
    for (int w = 0; w < nw; ++w) sum += sPart[(size_t)w * 2 * per + e];
    partial[(((size_t)which * g.BH + bh) * chunks + chunk) * per + i] = sum;
  }
}

// ---------------------------------------------------------------------------
// Backward 2: block (key chunk, bh). dk, dv of the chunk's keys, gathered
// from the query chunks that see it.

template <int KD>
__global__ void __launch_bounds__(kThreadsMax, kBwdKBlocks)
sliding_chunk_bwd_k_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ stats, const float* __restrict__ rsum,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const Set self{chunk / g.my, chunk % g.my};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int R = tile_rows(g), ld = tile_ld(g);
  const int nq = (g.W2 + 7) / 8;  // n8 tiles of a query set holding a present query
  const size_t T = tile_bytes(g) / sizeof(bf16);
  const size_t slot_bytes = 2 * tile_bytes(g) + stat_bytes(g);
  uint64_t* sMask = reinterpret_cast<uint64_t*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + kMaskBytes);
  bf16* sV = sK + T;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + T);  // [Q | dO | stats]

  Set sets[kMaxSets];
  const int nsets = neighbour_sets(g, self.ci, self.cj, false, sets);
  if (threadIdx.x < nsets) sMask[threadIdx.x] = set_mask(g, sets[threadIdx.x]);
  const CopyPlan plan = copy_plan(g);
  const int sjx = threadIdx.x / g.W, sjy = threadIdx.x % g.W;  // this thread's stats row
  stage_set(g, plan, bh, self, R, k, sK);
  stage_set(g, plan, bh, self, R, v, sV);
  wtile::cp_async_commit();
  // Item t: query set t's Q, dO and row statistics.
  auto fetch = [&](int t) {
    if (t < nsets) {
      bf16* sq = reinterpret_cast<bf16*>(ring + (t % kStages) * slot_bytes);
      stage_set(g, plan, bh, sets[t], R, q, sq);
      stage_set(g, plan, bh, sets[t], R, dout, sq + T);
      stage_stats(g, bh, sets[t], sjx, sjy, stats, rsum, reinterpret_cast<float*>(sq + 2 * T));
    }
    wtile::cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  wtile::cp_async_wait<kStages - 1>();  // K, V
  __syncthreads();
  uint32_t ka[KD][4], va[KD][4];
  load_a(ka, sK, ld, 16 * warp, lane);
  load_a(va, sV, ld, 16 * warp, lane);
  const long row[2] = {set_row(g, bh, self, 16 * warp + gq),
                       set_row(g, bh, self, 16 * warp + gq + 8)};

  float adk[2 * KD][4], adv[2 * KD][4];
  zero(adk);
  zero(adv);
  for (int t = 0; t < nsets; ++t) {
    const bf16* sq = reinterpret_cast<const bf16*>(ring + ring_next(t, fetch) * slot_bytes);
    const bf16* sdo = sq + T;
    const float* st = reinterpret_cast<const float*>(sq + 2 * T) + 2 * tq;
    const uint64_t mask = sMask[t] >> (2 * tq);
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      if (16 * kq >= R) continue;
      // S^T and dP^T of the warp's 16 keys by 16 queries of the set; a
      // lane's query columns are 16 kq + 8 j + 2 tq + e.
      float s[2][4], dp[2][4];
      const int n = min(2, nq - 2 * kq);
      a_by_rows(s, ka, sq, ld, 2 * kq, n, lane);
      a_by_rows(dp, va, sdo, ld, 2 * kq, n, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 16 * kq + 8 * j + (e & 1);
          const float p = prob_or_0(row[e >> 1] >= 0 && bit(mask, c), s[j][e],
                                    -st[c] * kLog2e, st[R + c]);
          dp[j][e] = p * (dp[j][e] - st[2 * R + c]);
          s[j][e] = p;
        }
      uint32_t pa[4], dsa[4];
      pack_a(pa, s);
      pack_a(dsa, dp);
      frag_by_rows<KD>(adv, pa, sdo, ld, 16 * kq, lane);
      frag_by_rows<KD>(adk, dsa, sq, ld, 16 * kq, lane);
    }
  }
  store_rows<KD>(dk, row, adk, g.M, lane);
  store_rows<KD>(dv, row, adv, g.M, lane);
}

}  // namespace tc

Geo make_geo(int BH, int nx, int ny, int W, int M, int nglo) {
  Geo g;
  g.BH = BH;
  g.nx = nx;
  g.ny = ny;
  g.W = W;
  g.M = M;
  g.nglo = nglo;
  g.W2 = W * W;
  g.R = ceil4(g.W2) > 8 ? ceil4(g.W2) : 8;
  g.G = ceil4(nglo);
  g.mx = (nx + W - 1) / W;
  g.my = (ny + W - 1) / W;
  return g;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Dynamic shared memory of kernel `which` (0 forward, 1 bwd_q, 2 bwd_k) in
// the dtype's design: bf16 the tensor-core layouts, fp32 the CUDA-core ones.
size_t kernel_smem(const Geo& g, bool bf16_path, int which) {
  if (bf16_path)
    return which == 0 ? tc::fwd_bytes(g) : which == 1 ? tc::bwd_q_bytes(g) : tc::bwd_k_bytes(g);
  return smem_bytes(which == 0 ? fwd_floats(g) : which == 1 ? bwd_q_floats(g) : bwd_k_floats(g),
                    g);
}

// One launch of `kernel` on grid (chunks, BH): threads, its shared memory.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Geo& g, int threads, size_t smem, cudaStream_t st,
           Args... args) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(g.mx * g.my, g.BH), threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T> const T* in(const void* p) { return static_cast<const T*>(p); }
template <typename T> T* out(void* p) { return static_cast<T*>(p); }

// f(std::integral_constant<int, KD>) for the tensor-core kernels' KD =
// round16(M) / 16 (M <= 64).
template <class F>
int with_kd(const Geo& g, F&& f) {
  switch (tc::round16(g.M) / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: return f(std::integral_constant<int, 4>{});
  }
}

int launch_fwd(const void* q, const void* k, const void* v, const void* kg, const void* vg,
               void* o, float* stats, const Geo& g, bool bf16_path, cudaStream_t st) {
  const size_t smem = kernel_smem(g, bf16_path, 0);
  if (bf16_path)
    return with_kd(g, [&](auto kd) {
      return launch(tc::sliding_chunk_fwd_tc_kernel<decltype(kd)::value>, g,
                    32 * tc::warps(g), smem, st, in<bf16>(q), in<bf16>(k), in<bf16>(v),
                    in<bf16>(kg), in<bf16>(vg), out<bf16>(o), stats, g);
    });
  return launch(sliding_chunk_fwd_kernel, g, kThreads, smem, st, in<float>(q),
                in<float>(k), in<float>(v), in<float>(kg), in<float>(vg), out<float>(o), stats,
                g);
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* kg, const void* vg,
               const void* dout, const float* stats, void* dq, void* dk, void* dv,
               void* dkg, void* dvg, float* rsum, float* partial, const Geo& g,
               cudaStream_t st) {
  constexpr bool tc_path = sizeof(T) == 2;
  const int threads = tc_path ? 32 * tc::warps(g) : kThreads;
  int err;
  if constexpr (tc_path)
    err = with_kd(g, [&](auto kd) {
      return launch(tc::sliding_chunk_bwd_q_tc_kernel<decltype(kd)::value>, g, threads,
                    kernel_smem(g, true, 1), st, in<T>(q), in<T>(k), in<T>(v), in<T>(kg),
                    in<T>(vg), in<T>(dout), stats, out<T>(dq), rsum, partial, g);
    });
  else
    err = launch(sliding_chunk_bwd_q_kernel, g, threads, kernel_smem(g, false, 1), st,
                 in<T>(q), in<T>(k), in<T>(v), in<T>(kg), in<T>(vg), in<T>(dout), stats,
                 out<T>(dq), rsum, partial, g);
  if (err != 0) return err;
  if constexpr (tc_path)
    err = with_kd(g, [&](auto kd) {
      return launch(tc::sliding_chunk_bwd_k_tc_kernel<decltype(kd)::value>, g, threads,
                    kernel_smem(g, true, 2), st, in<T>(q), in<T>(k), in<T>(v), in<T>(dout),
                    stats, (const float*)rsum, out<T>(dk), out<T>(dv), g);
    });
  else
    err = launch(sliding_chunk_bwd_k_kernel, g, threads, kernel_smem(g, false, 2), st,
                 in<T>(q), in<T>(k), in<T>(v), in<T>(dout), stats, (const float*)rsum,
                 out<T>(dk), out<T>(dv), g);
  if (err != 0 || g.nglo == 0) return err;
  const int per = g.nglo * g.M, total = 2 * g.BH * per;
  glo_reduce_kernel<T><<<(total + 255) / 256, 256, 0, st>>>(
      partial, out<T>(dkg), out<T>(dvg), g.BH, g.mx * g.my, per);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one kernel at this shape, in bytes: dtype 0 =
// float32, 1 = bfloat16; which 0 = forward, 1 = bwd_q, 2 = bwd_k
// (ops/sliding_chunk.py kernel_smem_bytes mirrors it).
size_t esvit_sliding_chunk_kernel_smem_bytes(int W, int M, int nglo, int dtype, int which) {
  return kernel_smem(make_geo(1, W, W, W, M, nglo), dtype == 1, which);
}

// The largest dynamic shared memory any of the kernels takes at this
// shape in either dtype, in bytes (the wrapper's shape rule is held
// against it).
size_t esvit_sliding_chunk_smem_bytes(int W, int M, int nglo) {
  size_t most = 0;
  for (int dtype = 0; dtype < 2; ++dtype)
    for (int which = 0; which < 3; ++which) {
      const size_t n = esvit_sliding_chunk_kernel_smem_bytes(W, M, nglo, dtype, which);
      if (n > most) most = n;
    }
  return most;
}

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out (BH, nx, ny, M), kg/vg
// (BH, nglo, M) (unread when nglo == 0), stats (BH, nx, ny, 2) fp32.
int esvit_sliding_chunk_fwd(const void* q, const void* k, const void* v, const void* kg,
                            const void* vg, void* out, void* stats, int BH, int nx, int ny,
                            int W, int M, int nglo, int dtype, void* stream) {
  const Geo g = make_geo(BH, nx, ny, W, M, nglo);
  return launch_fwd(q, k, v, kg, vg, out, static_cast<float*>(stats), g, dtype == 1,
                    static_cast<cudaStream_t>(stream));
}

// rsum: (BH, nx, ny) fp32 scratch; partial: (2, BH, mx*my, nglo, M) fp32
// scratch; dkg/dvg (BH, nglo, M).
int esvit_sliding_chunk_bwd(const void* q, const void* k, const void* v, const void* kg,
                            const void* vg, const void* dout, const void* stats, void* dq,
                            void* dk, void* dv, void* dkg, void* dvg, void* rsum,
                            void* partial, int BH, int nx, int ny, int W, int M, int nglo,
                            int dtype, void* stream) {
  const Geo g = make_geo(BH, nx, ny, W, M, nglo);
  const auto* st = static_cast<const float*>(stats);
  auto* rs = static_cast<float*>(rsum);
  auto* pp = static_cast<float*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<bf16>(q, k, v, kg, vg, dout, st, dq, dk, dv, dkg, dvg, rs, pp, g, s);
  return launch_bwd<float>(q, k, v, kg, vg, dout, st, dq, dk, dv, dkg, dvg, rs, pp, g, s);
}

}  // extern "C"
