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
// (bh, chunk) and stages only the real neighbour chunks (one at a time)
// and the global rows in shared memory, so no score work is spent on the
// TPU band's 3-chunk-row padding (~2.7x at 224 px stage 0) or its 8-row
// slot padding. A set's rows come in as 16-byte loads, all in flight at
// once, into registers while the block computes on the previous set, and
// are then written to shared memory as fp32. Every product runs on the
// CUDA cores: 256 threads map to a 16 x 16 grid of 4 x 4 register tiles,
// fed by 16-byte shared-memory loads from transposed (d-major) copies, so
// each pair of loads feeds 16 FMAs. The forward keeps the chunk's fp32
// scores against its whole neighbourhood in shared memory
// (W^2 x (9 W^2 + nglo)), so the softmax takes one max and one sum as the
// TPU kernel does.
//
// What bounds it on Hopper: at W=7, M=48 a query chunk does ~2 MFLOP of
// products over ~90 KB of operands (its neighbourhood's K and V), so the
// work is compute and shared-memory traffic, not HBM: each input is read
// from device memory about 9 times (once per neighbouring block), mostly
// from L2. The roofline bound is HBM bytes (each input read once); this
// first version is bound by latency and the CUDA cores' instruction rate
// at one to three blocks per SM (the forward's fp32 score buffer takes
// ~117 KB at W=7). Tensor-core (mma) tiles and bf16 staging are later
// work.
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Round an fp32 value to T and back: the casts to the input dtype.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
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
// globals, (BH*nx*ny) for a chunk), or -1 where the position is absent.
__device__ __forceinline__ long set_row(const Geo& g, int bh, Set s, int j) {
  if (s.ci < 0) return j < g.nglo ? (long)bh * g.nglo + j : -1;
  if (j >= g.W2) return -1;
  const int x = s.ci * g.W + j / g.W, y = s.cj * g.W + j % g.W;
  if (x >= g.nx || y >= g.ny) return -1;
  return ((long)bh * g.nx + x) * g.ny + y;
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
// stage_store converts them to fp32 and writes them, zeros where a row is
// absent: transposed dstT[d * R + j] (d-major, for the score tiles)
// and/or row-major dstR[j * M + d]. Consecutive threads take consecutive
// rows, so the transposed stores are free of bank conflicts.
template <typename T> struct Staged {
  static constexpr int V = 16 / sizeof(T);  // values per load
  static constexpr int kLoads = (64 * 64 / V + kThreads - 1) / kThreads;
  uint4 buf[kLoads];
};

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// Value t of a 16-byte load as fp32.
template <typename T> __device__ __forceinline__ float unpack(const uint4& v, int t);
template <> __device__ __forceinline__ float unpack<float>(const uint4& v, int t) {
  return __uint_as_float(word(v, t));
}
template <> __device__ __forceinline__ float unpack<bf16>(const uint4& v, int t) {
  const uint32_t w = word(v, t >> 1);
  return __uint_as_float((t & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <typename T>
__device__ __forceinline__ void stage_load(const Geo& g, int bh, Set s,
                                           const T* __restrict__ src, Staged<T>& st) {
  constexpr int V = Staged<T>::V;
  const int R = g.R, n = R * (g.M / V);
#pragma unroll
  for (int it = 0; it < Staged<T>::kLoads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    st.buf[it] = make_uint4(0u, 0u, 0u, 0u);
    if (e < n) {
      const int j = e % R, d0 = (e / R) * V;
      const long row = set_row(g, bh, s, j);
      if (row >= 0) st.buf[it] = __ldg(reinterpret_cast<const uint4*>(src + row * g.M + d0));
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_store(const Geo& g, const Staged<T>& st, float* dstT,
                                            float* dstR) {
  constexpr int V = Staged<T>::V;
  const int R = g.R, n = R * (g.M / V);
#pragma unroll
  for (int it = 0; it < Staged<T>::kLoads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (e >= n) continue;
    const int j = e % R, d0 = (e / R) * V;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const float x = unpack<T>(st.buf[it], t);
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
// Forward: block (query chunk, bh). Writes o and the per-row (m, 1/sum).

template <typename T>
__global__ void __launch_bounds__(kThreads)
sliding_chunk_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ kg,
                         const T* __restrict__ vg, T* __restrict__ out,
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
  Staged<T> st;
  stage_load<T>(g, bh, self, q, st);
  stage_store<T>(g, st, sQT, nullptr);
  stage_valid(g, bh, self, sQv);
  const int a = threadIdx.x / kGrid, b = threadIdx.x % kGrid;

  // Scores of every (query, key) pair, absent keys -inf. The next set's
  // loads are in flight while a set's tile is computed.
  stage_load<T>(g, bh, sets[0], keys(0), st);
  for (int s = 0; s < nsets; ++s) {
    __syncthreads();
    stage_store<T>(g, st, sKV, nullptr);
    stage_valid(g, bh, sets[s], sKv);
    __syncthreads();
    if (s + 1 < nsets) stage_load<T>(g, bh, sets[s + 1], keys(s + 1), st);
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
  stage_load<T>(g, bh, sets[0], vals(0), st);  // in flight through the softmax
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
    each_col([&](size_t at) { sS[at] = rnd<T>(expf(sS[at] - m) * linv); });
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
    stage_store<T>(g, st, nullptr, sKV);
    __syncthreads();
    if (s + 1 < nsets) stage_load<T>(g, bh, sets[s + 1], vals(s + 1), st);
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
      for (int c = 0; c < 4; ++c) out[row * M + 4 * b + c] = from_f<T>(acc[r][c]);
    }
}

// p32, rebuilt from the forward's row max and 1/sum.
__device__ __forceinline__ float prob(float s, float m, float linv) {
  return expf(s - m) * linv;
}

// ---------------------------------------------------------------------------
// Backward 1: block (query chunk, bh). Writes r, dq and this chunk's
// partials of dkg (partial[0]) and dvg (partial[1]).

template <typename T>
__global__ void __launch_bounds__(kThreads)
sliding_chunk_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ kg,
                           const T* __restrict__ vg, const T* __restrict__ dout,
                           const float* __restrict__ stats, T* __restrict__ dq,
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
  Staged<T> sk, sv;
  stage_load<T>(g, bh, self, q, sk);
  stage_load<T>(g, bh, self, dout, sv);
  store_row_stats(g, load_row_stats(g, bh, self, stats, nullptr), sM, sL, nullptr);
  stage_store<T>(g, sk, sQT, nullptr);
  stage_store<T>(g, sv, sDOT, nullptr);
  stage_valid(g, bh, self, sQv);
  const int a = threadIdx.x / kGrid, b = threadIdx.x % kGrid;

  // Pass 1: r = rowsum(p * dp) over every key of the row.
  float racc[4] = {0.f, 0.f, 0.f, 0.f};
  stage_load<T>(g, bh, sets[0], keys(0), sk);
  stage_load<T>(g, bh, sets[0], vals(0), sv);
  for (int s = 0; s < nsets; ++s) {
    __syncthreads();
    stage_store<T>(g, sk, sKT, nullptr);
    stage_store<T>(g, sv, sVT, nullptr);
    stage_valid(g, bh, sets[s], sKv);
    __syncthreads();
    if (s + 1 < nsets) {
      stage_load<T>(g, bh, sets[s + 1], keys(s + 1), sk);
      stage_load<T>(g, bh, sets[s + 1], vals(s + 1), sv);
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
  stage_load<T>(g, bh, sets[0], keys(0), sk);  // pass 2's first set
  stage_load<T>(g, bh, sets[0], vals(0), sv);
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
    stage_store<T>(g, sk, sKT, sK);
    stage_store<T>(g, sv, sVT, nullptr);
    stage_valid(g, bh, sets[s], sKv);
    __syncthreads();
    if (s + 1 < nsets) {
      stage_load<T>(g, bh, sets[s + 1], keys(s + 1), sk);
      stage_load<T>(g, bh, sets[s + 1], vals(s + 1), sv);
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
          ds[r] = rnd<T>(p * (dp[r][c] - sR[i]));
          pb[r] = rnd<T>(p);
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
      for (int c = 0; c < 4; ++c) dq[row * M + 4 * b + c] = from_f<T>(acc[r][c]);
    }
}

// ---------------------------------------------------------------------------
// Backward 2: block (key chunk, bh). dk, dv of the chunk's keys, gathered
// from the query chunks that see it.

template <typename T>
__global__ void __launch_bounds__(kThreads)
sliding_chunk_bwd_k_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ stats, const float* __restrict__ rsum,
                           T* __restrict__ dk, T* __restrict__ dv, Geo g) {
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
  Staged<T> sa, sb;
  stage_load<T>(g, bh, self, k, sa);
  stage_load<T>(g, bh, self, v, sb);
  stage_store<T>(g, sa, sKT, nullptr);
  stage_store<T>(g, sb, sVT, nullptr);
  stage_valid(g, bh, self, sKv);
  const int a = threadIdx.x / kGrid, b = threadIdx.x % kGrid;
  float ak[4][4], av[4][4];
  zero(ak);
  zero(av);
  stage_load<T>(g, bh, sets[0], q, sa);
  stage_load<T>(g, bh, sets[0], dout, sb);
  RowStats rs = load_row_stats(g, bh, sets[0], stats, rsum);
  for (int s = 0; s < nsets; ++s) {
    __syncthreads();
    stage_store<T>(g, sa, sQT, sQ);
    stage_store<T>(g, sb, sDOT, sDO);
    stage_valid(g, bh, sets[s], sQv);
    store_row_stats(g, rs, sM, sL, sR);
    __syncthreads();
    if (s + 1 < nsets) {
      stage_load<T>(g, bh, sets[s + 1], q, sa);
      stage_load<T>(g, bh, sets[s + 1], dout, sb);
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
          ds[r] = rnd<T>(p * (dp[r][c] - sR[i]));
          pb[r] = rnd<T>(p);
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
        dk[row * M + 4 * b + c] = from_f<T>(ak[r][c]);
        dv[row * M + 4 * b + c] = from_f<T>(av[r][c]);
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

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* kg,
               const void* vg, void* out, float* stats, const Geo& g, cudaStream_t st) {
  const size_t smem = smem_bytes(fwd_floats(g), g);
  auto kernel = sliding_chunk_fwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(g.mx * g.my, g.BH), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kg), static_cast<const T*>(vg), static_cast<T*>(out), stats, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* kg, const void* vg,
               const void* dout, const float* stats, void* dq, void* dk, void* dv,
               void* dkg, void* dvg, float* rsum, float* partial, const Geo& g,
               cudaStream_t st) {
  const dim3 grid(g.mx * g.my, g.BH);
  const size_t smem_q = smem_bytes(bwd_q_floats(g), g);
  auto kq = sliding_chunk_bwd_q_kernel<T>;
  cudaError_t err = allow_smem(kq, smem_q);
  if (err != cudaSuccess) return (int)err;
  kq<<<grid, kThreads, smem_q, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kg), static_cast<const T*>(vg), static_cast<const T*>(dout),
      stats, static_cast<T*>(dq), rsum, partial, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_k = smem_bytes(bwd_k_floats(g), g);
  auto kk = sliding_chunk_bwd_k_kernel<T>;
  err = allow_smem(kk, smem_k);
  if (err != cudaSuccess) return (int)err;
  kk<<<grid, kThreads, smem_k, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), stats, rsum, static_cast<T*>(dk), static_cast<T*>(dv), g);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.nglo == 0) return (int)err;
  const int per = g.nglo * g.M, total = 2 * g.BH * per;
  glo_reduce_kernel<T><<<(total + 255) / 256, 256, 0, st>>>(
      partial, static_cast<T*>(dkg), static_cast<T*>(dvg), g.BH, g.mx * g.my, per);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest dynamic shared memory any of the kernels takes at this
// shape, in bytes (the wrapper's shape rule is held against it).
size_t esvit_sliding_chunk_smem_bytes(int W, int M, int nglo) {
  const Geo g = make_geo(1, W, W, W, M, nglo);
  size_t most = smem_bytes(fwd_floats(g), g);
  const size_t q = smem_bytes(bwd_q_floats(g), g), k = smem_bytes(bwd_k_floats(g), g);
  if (q > most) most = q;
  if (k > most) most = k;
  return most;
}

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out (BH, nx, ny, M), kg/vg
// (BH, nglo, M) (unread when nglo == 0), stats (BH, nx, ny, 2) fp32.
int esvit_sliding_chunk_fwd(const void* q, const void* k, const void* v, const void* kg,
                            const void* vg, void* out, void* stats, int BH, int nx, int ny,
                            int W, int M, int nglo, int dtype, void* stream) {
  const Geo g = make_geo(BH, nx, ny, W, M, nglo);
  auto* st = static_cast<float*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd<bf16>(q, k, v, kg, vg, out, st, g, s);
  return launch_fwd<float>(q, k, v, kg, vg, out, st, g, s);
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
