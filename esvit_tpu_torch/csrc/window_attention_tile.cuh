// The tile machinery shared by the two window-attention forward kernels,
// sm_90a: the packed forward (window_attention.cu) and the qkv-layout
// forward (pallas_window_attention.cu).
//
// Both compute, per window w and head h (N <= 256 tokens, head dim hd <=
// 64), o = softmax(q k^T * scale + bias[w % types, h]) v, and differ only
// in a small policy (a struct the kernel is templated on): where q, k and
// v sit in a row (Operands), how q is scaled and p is rounded in bf16
// (kRoundQ, kSplitP), and where the bias comes from (stage_bias).
//
// What bounds them on Hopper: one (window, head) is 4 N^2 hd ~ 0.31 MFLOP
// on ~9.4 KB of bf16 operands at Swin's N=49, hd=32, about 33 FLOP/byte,
// far below the card's bf16 ridge (~295): neither wgmma's full rate nor a
// deep pipeline is the point. Products run as FMA chains that read two
// shared values per FMA are bound by shared-memory throughput and latency, not
// by bytes, so the design keeps the products in tensor-core fragments and
// registers and keeps as many warps resident as it can:
//   - one warp owns one (window, head) at a time and walks a run of
//     windows of one (head, window type); the block's warps share that
//     type's (N, N) fp32 bias slice, staged once per block;
//   - q, k and v come in with 16-byte cp.async (a plain element copy when
//     a row or a head is not 16-byte aligned) into one buffer per warp;
//     the many warps an SM holds hide the loads (the kernel's loop says
//     why not two buffers);
//   - bf16: the products run on the tensor cores as mma.sync m16n8k16
//     (bf16 in, fp32 accumulate). The 49 query rows are four m16 tiles and
//     the keys eight n8 tiles (padding rows are read clamped to row N-1 by
//     ldmatrix, never stored; padding key columns get -inf), the softmax
//     runs in the accumulator fragments (a row lives in a quad of four
//     lanes: two __shfl_xor steps for the max and for the sum), and P.V
//     takes p straight from the accumulators as its A fragments, V through
//     ldmatrix.trans. mma.sync and not wgmma: a window is one m64 tile,
//     so wgmma would need a warpgroup (four warps) per window and a
//     shared-memory round trip for P; at ~33 FLOP/byte the tensor cores are
//     idle most of the time either way, and what bounds the tile is the
//     latency of its softmax and fragment loads, hidden by more warps;
//   - fp32 (no TF32: single-pass TF32 rounds to ~1e-3, above the 2e-5
//     gate): register-tiled FMAs on the CUDA cores with the same column
//     ownership, all query rows at once. A 128-bit shared load costs four
//     shared-memory cycles however many lanes share its address, so what
//     bounds the products is shared loads per FMA: each lane holds an
//     8 x 16 block of S built from float4 reads of q and k (448 FMAs per 22
//     loads), writes its p over the spent q and k tiles, and forms an 8 x 8
//     block of the output from float4 reads of p and v (256 FMAs per 16).
// No atomics: every output element is written once by one lane, so the
// result is bit-identical on repeat. Windows of 64 < N <= 256 tokens (Swin
// at W=14) take the large-window tile at the end of this file, with the
// same policies and roundings.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace wtile {

using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallMaxN = 64;   // the small tiles' windows; above: the large tile
constexpr int kLargeMaxN = 256;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The head dim padded to the mma's k16 (zero-filled in shared memory).
__host__ __device__ inline int head_pad(int hd) { return round_up(hd, 16); }

// Stride of the staged (N, N) fp32 bias: a multiple of 4 floats that is an
// odd number of 16-byte units, so the 8 rows a warp reads at once fall in
// distinct banks.
__host__ __device__ inline int bias_ld(int N) {
  const int r = round_up(N, 4);
  return ((r / 4) & 1) ? r : r + 4;
}

// Per-dtype staging layout of one warp's tiles, in elements: q at 0 and k
// at N * ld (N rows each), v at v_offset (v_rows rows), all at row stride
// `ld`, an odd number of 16-byte units (conflict-free ldmatrix rows and
// float4 columns).
template <typename T> struct Layout;
template <> struct Layout<bf16> {
  __host__ __device__ static int ld(int hd) { return head_pad(hd) + 8; }
  __host__ __device__ static int v_rows(int N) { return N; }
  __host__ __device__ static size_t v_offset(int N, int hd) { return (size_t)2 * N * ld(hd); }
};
template <> struct Layout<float> {
  __host__ __device__ static int ld(int hd) { return head_pad(hd) + 4; }
  // P.V reads keys in fours: up to three zero rows past N.
  __host__ __device__ static int v_rows(int N) { return round_up(N, 4); }
  // The (N, p_ld) fp32 p tile overwrites q and k once S is built.
  __host__ __device__ static int p_ld(int N) { return 8 * ((N + 7) / 8) + 4; }
  __host__ __device__ static size_t v_offset(int N, int hd) {
    const size_t qk = (size_t)2 * N * ld(hd), p = (size_t)N * p_ld(N);
    return qk > p ? qk : p;
  }
};

__host__ __device__ inline size_t round_up_bytes(size_t x) { return (x + 127) / 128 * 128; }

__host__ __device__ inline size_t bias_bytes(int N) {
  return round_up_bytes((size_t)N * bias_ld(N) * sizeof(float));
}

template <typename T>
__host__ __device__ inline size_t warp_bytes(int N, int hd) {
  using L = Layout<T>;
  return round_up_bytes((L::v_offset(N, hd) + (size_t)L::v_rows(N) * L::ld(hd)) * sizeof(T));
}

// Dynamic shared memory of a block of `warps` warps (ops/window_attention.py
// tile_smem_bytes mirrors it).
template <typename T>
__host__ __device__ inline size_t smem_bytes(int N, int hd, int warps) {
  return bias_bytes(N) + (size_t)warps * warp_bytes<T>(N, hd);
}

struct Geometry {
  int B_;      // windows, batch-major, window type minor
  int N;       // tokens per window (<= 256; above 64 the large tile)
  int hd;      // head dim (<= 64)
  int nH;      // heads
  int types;   // window types: window w takes the bias slice of w % types
  int ld_in;   // row stride of q, k, v, in elements
  int ld_out;  // row stride of the output, in elements (C)
  int run;     // windows per warp (the large tile: per block)
  float scale;
  int vec;     // 1: q, k, v rows and heads are 16-byte aligned (cp.async)
  int ld_do;   // backward: row stride of the output gradient, in elements
  int ld_dx;   // backward: row stride of dq, dk and dv, in elements
};

// Row r of head h: q[r * ld_in + h * hd], the same for k and v;
// out[r * ld_out + h * hd].
template <typename T> struct Operands {
  const T* q;
  const T* k;
  const T* v;
  T* out;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values rounded to bf16 in one register, `lo` in the low half
// (the lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// dst[i * bs + j] = src[i * N + j] + (region ids of i and j differ ? -100 :
// 0), the whole block, in the order the plain version adds them (the mask
// joins the bias before the scores do).
__device__ inline void stage_bias(float* dst, int bs, const float* __restrict__ src,
                                  const int* __restrict__ region, int N) {
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < N; i += warps) {
    const int ri = region != nullptr ? region[i] : 0;
    for (int j = lane; j < N; j += 32) {
      float b = src[(size_t)i * N + j];
      if (region != nullptr) b += (ri != region[j]) ? -100.f : 0.f;
      dst[i * bs + j] = b;
    }
  }
}

// The composite bias of (query row i, key column j) as the softmax reads
// it. StagedRows: the block's staged slice (stage_bias, row stride bs).
// GlobalRows, the large tile's: the (N, N) fp32 slice in device memory
// (L2-resident: every window of a (type, head) reads it again) plus -100
// where the staged region ids differ, the same two fp32 values added in the
// same order as stage_bias.
struct StagedRows {
  const float* s;
  int bs;
  // columns c and c + 1 of row i (c even, bs even: 8-byte aligned)
  __device__ __forceinline__ float2 pair(int i, int c) const {
    return *reinterpret_cast<const float2*>(s + i * bs + c);
  }
};

struct GlobalRows {
  const float* src;  // (N, N)
  const int* ids;    // (N,) region ids in shared memory, or null
  int N;
  __device__ __forceinline__ float at(int i, int j) const {
    float b = __ldg(src + (size_t)i * N + j);
    if (ids != nullptr) b += (ids[i] != ids[j]) ? -100.f : 0.f;
    return b;
  }
  // columns c and c + 1 of row i (c even): one 8-byte read where N is
  // even and the slice 8-byte aligned
  __device__ __forceinline__ float2 pair(int i, int c) const {
    if ((N & 1) == 0 && c + 1 < N && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
      float2 b = __ldg(reinterpret_cast<const float2*>(src + (size_t)i * N + c));
      if (ids != nullptr) {
        const int r = ids[i];
        b.x += (r != ids[c]) ? -100.f : 0.f;
        b.y += (r != ids[c + 1]) ? -100.f : 0.f;
      }
      return b;
    }
    return make_float2(c < N ? at(i, c) : 0.f, c + 1 < N ? at(i, c + 1) : 0.f);
  }
};

// The packed kernel's policy (window_attention.cu; the fused block's
// attention halves use it too): qs = bf16(q * bf16(scale)) and p rounded to
// bf16 in bf16, and the bias slice of (window type t, head h) the (nH, N,
// N) table plus -100 where the type's region ids differ.
struct TableBias {
  static constexpr bool kRoundQ = true;
  static constexpr bool kSplitP = false;
  // Whether a caller takes the large-window tile (N > 64): rows 3-4 (the
  // packed pair) and the fused block's policy, derived from this one, do.
  // A policy that does not never instantiates the large kernels.
  static constexpr bool kLarge = true;
  const float* table;  // (nH, N, N)
  const int* region;   // (types, N) or null

  __device__ void stage_bias(float* dst, int bs, const Geometry& g, int t, int h) const {
    wtile::stage_bias(dst, bs, table + (size_t)h * g.N * g.N,
                      region != nullptr ? region + (size_t)t * g.N : nullptr, g.N);
  }

  // The large tile's bias of (t, h): the block copies type t's region ids
  // into `ids` (the caller syncs before the first read).
  __device__ GlobalRows rows(const Geometry& g, int t, int h, int* ids) const {
    if (region != nullptr)
      for (int j = threadIdx.x; j < g.N; j += blockDim.x) ids[j] = region[(size_t)t * g.N + j];
    return GlobalRows{table + (size_t)h * g.N * g.N, region != nullptr ? ids : nullptr, g.N};
  }
};

// Zeroes what the loads never write and the products read in one tile:
// head columns [hd, head_pad(hd)) of rows [0, rows) and every column of
// rows [N, rows).
template <typename T>
__device__ void zero_pads(T* tile, int rows, int ld, int N, int hd, int lane) {
  const int hdp = head_pad(hd), wc = hdp - hd;
  if (wc > 0)
    for (int e = lane; e < N * wc; e += 32) {
      const int r = e / wc;
      tile[(size_t)r * ld + hd + (e - r * wc)] = T(0.f);
    }
  for (int e = lane; e < (rows - N) * hdp; e += 32) {
    const int r = e / hdp;
    tile[(size_t)(N + r) * ld + (e - r * hdp)] = T(0.f);
  }
}

// One warp stages window w, head h: q, k, v rows [0, N), columns [0, hd),
// into the tiles at dst[0], dst[1], dst[2] (row stride ld).
template <typename T>
__device__ __forceinline__ void stage_window(const Operands<T>& op, const Geometry& g, int w,
                                             int h, T* const (&dst)[3], int ld, int lane) {
  const size_t row0 = (size_t)w * g.N, col0 = (size_t)h * g.hd;
  const T* src[3] = {op.q, op.k, op.v};
  if (g.vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int cpr = g.hd / kPer, per = g.N * cpr;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      for (int e = lane; e < per; e += 32) {
        const int r = e / cpr, c = (e - r * cpr) * kPer;
        cp_async16(dst[m] + (size_t)r * ld + c, src[m] + (row0 + r) * g.ld_in + col0 + c);
      }
  } else {
    const int per = g.N * g.hd;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      for (int e = lane; e < per; e += 32) {
        const int r = e / g.hd, c = e - r * g.hd;
        dst[m][(size_t)r * ld + c] = src[m][(row0 + r) * g.ld_in + col0 + c];
      }
  }
}

// A row's softmax constants: p = 2^(s log2e + off) * inv (the large
// tile's backward: p = 2^((s - off) log2e) * inv, off the max).
struct RowStats {
  float off0, off1;  // -max log2e of rows g and g + 8 (the backward: max)
  float inv0, inv1;  // 1 / sum of the exponentials
};

// The softmax of one m16 tile of scores in the accumulator layout: lane
// (g = lane / 4, t = lane % 4) holds s[nt][e] at row m0 + g and s[nt][2 + e]
// at row m0 + g + 8, column 8 nt + 2 t + e, for NT key tiles of 8. Adds the
// bias (after the scale, if kPostScale), masks columns >= N with -inf and
// leaves p in s (0 in the masked columns and in the tiles past the keys).
// A row's max and sum are fp32, over its quad. Padded rows read the bias
// of row N - 1.
template <bool kPostScale, int NT, class Bias>
__device__ __forceinline__ RowStats softmax_frag(float (&s)[NT][4], int m0, const Bias& bias,
                                                 int N, float scale, int lane) {
  const int gq = lane >> 2, tq = lane & 3, nn = (N + 7) / 8;
  const int i0 = min(m0 + gq, N - 1), i1 = min(m0 + gq + 8, N - 1);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nn) continue;
    const int c = 8 * nt + 2 * tq;
    const float2 x0 = bias.pair(i0, c);
    const float2 x1 = bias.pair(i1, c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = -INFINITY, b = -INFINITY;
      if (c + e < N) {
        a = kPostScale ? s[nt][e] * scale : s[nt][e];
        b = kPostScale ? s[nt][2 + e] * scale : s[nt][2 + e];
        a += e ? x0.y : x0.x;
        b += e ? x1.y : x1.x;
      }
      s[nt][e] = a;
      s[nt][2 + e] = b;
      mx0 = fmaxf(mx0, a);
      mx1 = fmaxf(mx1, b);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
  }
  // e^(s - mx) as 2^(s log2e - mx log2e): one fma and one ex2 per score.
  constexpr float kLog2e = 1.4426950408889634f;
  const float o0 = -mx0 * kLog2e, o1 = -mx1 * kLog2e;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nn) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = exp2f(fmaf(s[nt][e], kLog2e, o0));
      s[nt][2 + e] = exp2f(fmaf(s[nt][2 + e], kLog2e, o1));
      sum0 += s[nt][e];
      sum1 += s[nt][2 + e];
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(kFull, sum0, o);
    sum1 += __shfl_xor_sync(kFull, sum1, o);
  }
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nn) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] *= inv0;
      s[nt][2 + e] *= inv1;
    }
  }
  return RowStats{o0, o1, inv0, inv1};
}

// bf16: S = Q K^T and O = P V on the tensor cores for the m16 tile of query
// rows at m0, over NT key tiles of 8. Policy::kRoundQ: the A operand is
// bf16(q * bf16(scale)) and p is rounded to bf16 (the packed kernel's
// roundings); otherwise the fp32 score is scaled after the product and p =
// bf16(p) + bf16(p - bf16(p)) takes two mmas (Policy::kSplitP), carrying p
// to ~2^-17.
template <class Policy, int NT, class Bias>
__device__ __forceinline__ void attend_tile(const bf16* sq, const bf16* sk, const bf16* sv,
                                            int ld, const Bias& bias, const Geometry& g, int w,
                                            int h, int m0, bf16* __restrict__ out, float*,
                                            int lane) {
  const int N = g.N, hd = g.hd, gq = lane >> 2, tq = lane & 3;
  const int kd = head_pad(hd) / 16, nd = head_pad(hd) / 8;
  const int nn = (N + 7) / 8, kp = (N + 15) / 16;
  const float qscale = __bfloat162float(__float2bfloat16(g.scale));
  const size_t col0 = (size_t)h * hd;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= kd) continue;
    ldsm_x4(qa[kk], sq + min(m0 + (lane & 15), N - 1) * ld + 16 * kk + ((lane >> 4) << 3));
    if (Policy::kRoundQ)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[kk][r] = pack_bf16(bf16_lo(qa[kk][r]) * qscale, bf16_hi(qa[kk][r]) * qscale);
  }
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    if (nt >= nn) continue;
    // One x4 load brings the B fragments of two k16 steps: lanes 8j..8j+7
    // address keys 8 nt.. at head columns 8j.. (the last half-used when
    // kd is odd: its columns are zero-filled or the next tile's, unused).
    const bf16* krow = sk + min(8 * nt + (lane & 7), N - 1) * ld + ((lane >> 3) << 3);
#pragma unroll
    for (int kk = 0; kk < 4; kk += 2) {
      if (kk >= kd) continue;
      uint32_t b[4];
      ldsm_x4(b, krow + 16 * kk);
      mma_bf16(s[nt], qa[kk], {b[0], b[1]});
      if (kk + 1 < kd) mma_bf16(s[nt], qa[kk + 1], {b[2], b[3]});
    }
  }
  softmax_frag<!Policy::kRoundQ>(s, m0, bias, N, g.scale, lane);

  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (kk >= kp) continue;
    // A fragment of keys 16 kk..16 kk + 15: the accumulators of key
    // tiles 2 kk (a0, a1) and 2 kk + 1 (a2, a3).
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = s[2 * kk + (r >> 1)][2 * (r & 1)];
      const float y = s[2 * kk + (r >> 1)][2 * (r & 1) + 1];
      pa[r] = pack_bf16(x, y);
      if (Policy::kSplitP) pl[r] = pack_bf16(x - bf16_lo(pa[r]), y - bf16_hi(pa[r]));
    }
    // One x4.trans load brings the B fragments of two n8 output tiles:
    // lanes 0-15 address keys 16 kk.. at columns 8 dt.., lanes 16-31 the
    // same keys at columns 8 dt + 8.. (nd is even: head_pad is 16-aligned).
    const bf16* vrow = sv + min(16 * kk + (lane & 15), N - 1) * ld + ((lane >> 4) << 3);
#pragma unroll
    for (int dt = 0; dt < 8; dt += 2) {
      if (dt >= nd) continue;
      uint32_t b[4];
      ldsm_x4_t(b, vrow + 8 * dt);
      mma_bf16(o[dt], pa, {b[0], b[1]});
      mma_bf16(o[dt + 1], pa, {b[2], b[3]});
      if (Policy::kSplitP) {
        mma_bf16(o[dt], pl, {b[0], b[1]});
        mma_bf16(o[dt + 1], pl, {b[2], b[3]});
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gq + 8 * half;
    if (r >= N) continue;
    bf16* orow = out + ((size_t)w * N + r) * g.ld_out + col0;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      if (dt >= nd) continue;
      const int c = 8 * dt + 2 * tq;
      const float a = o[dt][2 * half], b = o[dt][2 * half + 1];
      if (c + 1 < hd && (reinterpret_cast<uintptr_t>(orow + c) & 3) == 0) {
        *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(a, b);
      } else {
        if (c < hd) orow[c] = __float2bfloat16(a);
        if (c + 1 < hd) orow[c + 1] = __float2bfloat16(b);
      }
    }
  }
}

// bf16, the small tile: the window's m16 tiles in turn, on the staged bias.
template <class Policy>
__device__ void attend(const bf16* sq, const bf16* sk, const bf16* sv, int ld,
                       const float* sbias, int bs, float*, const Geometry& g, int w, int h,
                       bf16* __restrict__ out, int lane) {
  const StagedRows bias{sbias, bs};
  for (int m0 = 0; m0 < g.N; m0 += 16)
    attend_tile<Policy, 8>(sq, sk, sv, ld, bias, g, w, h, m0, out, nullptr, lane);
}

// fp32: the same column ownership on the CUDA cores (no TF32), all query
// rows at once. Lane (g, t) builds S at rows g + 8 r (r < 8), columns
// 8 nt + 2 t + {0, 1}, from float4 reads of q * scale and k (each k read
// feeds eight rows: 22 shared loads per 112 x 4 FMAs), sums each score in
// index order, writes its p over the q and k tiles (sp, row stride
// Layout<float>::p_ld) and builds O at the same rows, columns
// 16 c + 4 t + {0..3}, from float4 reads of p and v. Both policies scale q
// first in fp32 and keep p in fp32, as their plain versions do.
template <class Policy>
__device__ void attend(const float* sq, const float* sk, const float* sv, int ld,
                       const float* sbias, int bs, float* sp, const Geometry& g, int w, int h,
                       float* __restrict__ out, int lane) {
  const int N = g.N, hd = g.hd, gq = lane >> 2, tq = lane & 3;
  const int hdp = head_pad(hd), nc = hdp / 16, nn = (N + 7) / 8, n4 = round_up(N, 4);
  const int pld = Layout<float>::p_ld(N);
  const size_t col0 = (size_t)h * hd;
  // s[u]: rows 16 u + g and 16 u + g + 8, in the accumulator layout
  float s[4][8][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[u][nt][e] = 0.f;
  for (int d = 0; d < hdp; d += 4) {
    float4 q[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 x = ld4(sq + min(gq + 8 * r, N - 1) * ld + d);
      q[r] = make_float4(x.x * g.scale, x.y * g.scale, x.z * g.scale, x.w * g.scale);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= nn) continue;
      const int c = 8 * nt + 2 * tq;
      const float4 k0 = ld4(sk + min(c, N - 1) * ld + d);
      const float4 k1 = ld4(sk + min(c + 1, N - 1) * ld + d);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s[u][nt][0] = dot4(q[2 * u], k0, s[u][nt][0]);
        s[u][nt][1] = dot4(q[2 * u], k1, s[u][nt][1]);
        s[u][nt][2] = dot4(q[2 * u + 1], k0, s[u][nt][2]);
        s[u][nt][3] = dot4(q[2 * u + 1], k1, s[u][nt][3]);
      }
    }
  }
  __syncwarp();  // every lane is done with q and k: p overwrites them
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (16 * u >= N) continue;
    softmax_frag<false>(s[u], 16 * u, StagedRows{sbias, bs}, N, g.scale, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * u + gq + 8 * half;
      if (row >= N) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        if (nt < nn)
          *reinterpret_cast<float2*>(sp + row * pld + 8 * nt + 2 * tq) =
              make_float2(s[u][nt][2 * half], s[u][nt][2 * half + 1]);
    }
  }
  __syncwarp();

  float o[4][8][4];  // [column group c][row r][column 4 t + e]
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][r][e] = 0.f;
  for (int j = 0; j < n4; j += 4) {
    float4 p[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) p[r] = ld4(sp + min(gq + 8 * r, N - 1) * pld + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* vr = sv + (j + jj) * ld + 4 * tq;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nc) continue;
        const float4 v = ld4(vr + 16 * c);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float a = comp(p[r], jj);
          o[c][r][0] = fmaf(a, v.x, o[c][r][0]);
          o[c][r][1] = fmaf(a, v.y, o[c][r][1]);
          o[c][r][2] = fmaf(a, v.z, o[c][r][2]);
          o[c][r][3] = fmaf(a, v.w, o[c][r][3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = gq + 8 * r;
    if (row >= N) continue;
    float* orow = out + ((size_t)w * N + row) * g.ld_out + col0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= nc) continue;
      const int col = 16 * c + 4 * tq;
      if (col + 3 < hd && (reinterpret_cast<uintptr_t>(orow + col) & 15) == 0) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(o[c][r][0], o[c][r][1], o[c][r][2], o[c][r][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < hd) orow[col + e] = o[c][r][e];
      }
    }
  }
}

// Block (x, y = h * types + t) runs windows w = i * types + t of head h for
// i in [x * warps * run, (x + 1) * warps * run), `run` consecutive i per
// warp; tests/test_torch_window_attention_tiles.py mirrors the map. The block
// stages the bias slice of (t, h) once; each warp then stages and computes
// its windows one at a time. One staging buffer per warp and not two (the
// next window's loads in flight behind the current one's math): the
// products, not the loads, bound the tiles, and the smaller buffer doubles
// the warps an SM holds, which hides more latency than the overlap did.
template <typename T, class Policy>
__global__ void __launch_bounds__(kMaxWarps * 32)
window_attention_tile_kernel(Operands<T> op, Policy pol, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = g.N, bs = bias_ld(N);
  const int t = blockIdx.y % g.types, h = blockIdx.y / g.types;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sbias = reinterpret_cast<float*>(smem);
  pol.stage_bias(sbias, bs, g, t, h);

  const int ld = Layout<T>::ld(g.hd);
  T* tiles = reinterpret_cast<T*>(smem + bias_bytes(N) + (size_t)warp * warp_bytes<T>(N, g.hd));
  T* const tile[3] = {tiles, tiles + (size_t)N * ld, tiles + Layout<T>::v_offset(N, g.hd)};
  zero_pads(tile[2], Layout<T>::v_rows(N), ld, N, g.hd, lane);
  __syncthreads();

  const int per_type = g.B_ / g.types;
  const int i0 = (blockIdx.x * (blockDim.x >> 5) + warp) * g.run;
  const int i1 = min(i0 + g.run, per_type);
  for (int i = i0; i < i1; ++i) {
    const int w = i * g.types + t;
    // q and k's head-padding columns, each window: the fp32 p tile
    // overwrites them (a no-op when hd is a multiple of 16)
    zero_pads(tile[0], N, ld, N, g.hd, lane);
    zero_pads(tile[1], N, ld, N, g.hd, lane);
    stage_window(op, g, w, h, tile, ld, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    attend<Policy>(tile[0], tile[1], tile[2], ld, sbias, bs, reinterpret_cast<float*>(tiles), g,
                   w, h, op.out, lane);
    __syncwarp();
  }
}

// Launches the tile kernel: `warps` warps per block, g.run windows per warp
// (both chosen by the Python wrapper, ops/window_attention.py tile_plan).
template <typename T, class Policy>
int launch_large(Operands<T> op, const Policy& pol, const Geometry& g, int warps,
                 cudaStream_t stream);

template <typename T, class Policy>
int launch(Operands<T> op, const Policy& pol, Geometry g, int warps, cudaStream_t stream) {
  if (g.run < 1 || g.types < 1 || g.B_ % g.types || g.N < 1 || g.N > kLargeMaxN || g.hd < 1 ||
      g.hd > 64)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  g.vec = aligned(op.q) && aligned(op.k) && aligned(op.v) &&
          (g.ld_in * sizeof(T)) % 16 == 0 && (g.hd * sizeof(T)) % 16 == 0;
  if (g.N > kSmallMaxN) {
    if constexpr (Policy::kLarge) return launch_large<T>(op, pol, g, warps, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(g.N, g.hd, warps);
  auto kernel = window_attention_tile_kernel<T, Policy>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int chunk = warps * g.run, per_type = g.B_ / g.types;
  const dim3 grid((per_type + chunk - 1) / chunk, g.nH * g.types);
  kernel<<<grid, warps * 32, smem, stream>>>(op, pol, g);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The backward tile: the window-attention backward (row 4) and the
// attention half of the block-fused backward, bf16 and fp32, with the
// packed kernel's roundings (window_attention.cu's header states them):
//   dv = round(round(p)^T do),  dp = do v^T (fp32),
//   ds = p (dp - rowsum(p dp)),  dq = round(round(ds) k * scale),
//   dk = round(round(ds)^T qs),  dbias = sum over windows of ds (fp32).
//
// What bounds it is what bounds the forward tile (a (window, head) is
// ~0.6 MFLOP on ~16 KB of bf16 operands): the latency of its chains of
// fragment loads, mmas and softmax steps, not bytes or the tensor cores.
// So a (window, head) is split over a group of four warps, each taking one
// m16 tile in each pass, which cuts a window's latency by four and lets
// the tiles, staged once, serve four warps. Groups walk runs of windows of
// one (head, window type); a block's groups share that type's bias slice.
// q, k, v and do come in with cp.async, a tile per warp. Two passes; in
// bf16 every product is an mma.sync m16n8k16 whose A operand is either a
// staged tile (ldmatrix) or an accumulator fragment (p and ds never leave
// the registers):
//   pass 1, warp q on query rows 16 q..: S = qs k^T and its softmax (as the
//     forward), dP = do v^T, rowsum(p dp) and ds in the fragments; ds adds
//     into the group's dbias accumulator; dq = round(ds) k. Each row's
//     softmax constants and rowsum go to shared memory (64 x 3 floats);
//   the group meets (a named barrier);
//   pass 2, warp q on key rows 16 q..: S^T = k qs^T and dP^T = v do^T, p^T
//     and ds^T from the saved constants (the same formula as pass 1, so
//     the same p to the last fp32 rounding the product's sum order
//     allows); dv = round(p^T) do and dk = round(ds^T) qs.
// Padded query rows are read clamped to N - 1 and never stored; in pass
// 2 their columns get p = ds = 0, so they add nothing to dv and dk.
//
// fp32 (no TF32) runs the same passes, layouts and dbias order with
// register-tiled FMAs on the CUDA cores in place of the mmas: S and dP in
// the accumulator layout, a lane's two query rows by 16 key columns from
// float4 reads; a product whose A operand is a fragment (dq, dv, dk) goes
// through a 16-row fp32 scratch per warp, each lane then building two rows
// by 16 columns of the output from float4 reads of the scratch and of the
// B tile, as the forward's fp32 P.V does. Two rows a lane give about 7
// FMAs per shared load at N = 49 (the forward tile's eight give 20).
//
// dbias without atomics: a group's accumulator (N, N) fp32 in shared
// memory; warp q adds the ds of its rows only, so no two warps touch an
// element; at the end the block sums its groups' accumulators in group
// order and writes one partial; dbias_reduce_kernel sums a head's partials
// in block order. Bit-identical on repeat.
// ---------------------------------------------------------------------------

template <typename T> struct BwdOperands {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;   // row stride ld_do
  T* dq;           // dq, dk, dv: row stride ld_dx
  T* dk;
  T* dv;
  float* partial;  // dbias partials: bwd_parts of them per head
};

constexpr int kGroupWarps = 4;       // warps per (window, head)
constexpr int kStatFloats = 3 * 64;  // per group: off, inv, rowsum of each query row

template <typename T>
__host__ __device__ inline size_t bwd_tiles_bytes(int N, int hd) {
  return round_up_bytes((size_t)4 * N * Layout<T>::ld(hd) * sizeof(T));
}

// fp32 only: per warp a 16-row scratch for a fragment A operand, at the
// stride of the forward's p tile.
template <typename T> __host__ __device__ inline size_t bwd_scratch_bytes(int N) {
  return sizeof(T) == 2 ? 0 : (size_t)kGroupWarps * 16 * Layout<float>::p_ld(N) * sizeof(float);
}

template <typename T>
__host__ __device__ inline size_t bwd_group_bytes(int N, int hd) {
  return bwd_tiles_bytes<T>(N, hd) + kStatFloats * sizeof(float) + bias_bytes(N) +
         bwd_scratch_bytes<T>(N);
}

// Dynamic shared memory of a backward block of `warps` warps (ops/
// window_attention.py tile_smem_bytes(..., backward=True) mirrors it): the
// bias slice, then per group of four warps its q, k, v, do tiles, its row
// constants, its (N, N) fp32 dbias accumulator (the bias slice's layout)
// and, in fp32, its warps' scratch.
template <typename T>
__host__ __device__ inline size_t bwd_smem_bytes(int N, int hd, int warps) {
  return bias_bytes(N) + (size_t)(warps / kGroupWarps) * bwd_group_bytes<T>(N, hd);
}

// One warp copies rows [0, N), columns [0, hd) of one operand's window w,
// head h into a tile of row stride ld.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* src, int ld_src, size_t row0, size_t col0,
                                           T* dst, int ld, int N, int hd, int vec, int lane) {
  constexpr int kPer = 16 / sizeof(T);
  if (vec) {
    const int cpr = hd / kPer, per = N * cpr;
    for (int e = lane; e < per; e += 32) {
      const int r = e / cpr, c = (e - r * cpr) * kPer;
      cp_async16(dst + (size_t)r * ld + c, src + (row0 + r) * ld_src + col0 + c);
    }
  } else {
    for (int e = lane; e < N * hd; e += 32) {
      const int r = e / hd, c = e - r * hd;
      dst[(size_t)r * ld + c] = src[(row0 + r) * ld_src + col0 + c];
    }
  }
}

// Scales the bf16 pairs of a fragment: bf16(x * qscale), the qs operand.
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float qscale) {
  return pack_bf16(bf16_lo(x) * qscale, bf16_hi(x) * qscale);
}

// The A fragments of 16 rows at m0 (rows clamped to N - 1) over kd k16
// steps of the head dim, by ldmatrix x4; with kScale each bf16 pair
// becomes bf16(x * qscale).
template <bool kScale>
__device__ __forceinline__ void load_rows(uint32_t (&a)[4][4], const bf16* sa, int m0, int ld,
                                          int N, int kd, float qscale, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= kd) continue;
    ldsm_x4(a[kk], sa + min(m0 + (lane & 15), N - 1) * ld + 16 * kk + ((lane >> 4) << 3));
    if (kScale)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][r] = scale_pair(a[kk][r], qscale);
  }
}

// acc = A . B[keys n0..n0 + 7]^T over the head dim, B stored [row][dim]
// (rows clamped to N - 1) by ldmatrix x4, two k16 steps a load; with
// kScaleB the B fragments become bf16(x * qscale).
template <bool kScaleB>
__device__ __forceinline__ void dot_tile(float (&acc)[4], const uint32_t (&a)[4][4],
                                         const bf16* sb, int n0, int ld, int N, int kd,
                                         float qscale, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.f;
  const bf16* brow = sb + min(n0 + (lane & 7), N - 1) * ld + ((lane >> 3) << 3);
#pragma unroll
  for (int kk = 0; kk < 4; kk += 2) {
    if (kk >= kd) continue;
    uint32_t b[4];
    ldsm_x4(b, brow + 16 * kk);
    if (kScaleB)
#pragma unroll
      for (int r = 0; r < 4; ++r) b[r] = scale_pair(b[r], qscale);
    mma_bf16(acc, a[kk], {b[0], b[1]});
    if (kk + 1 < kd) mma_bf16(acc, a[kk + 1], {b[2], b[3]});
  }
}

// acc[nt] = A[16 rows at m0] . B[keys 8 nt..]^T over the head dim for nt <
// nn (0 past them), A and B tiles stored [row][dim] (the S = Q K^T shape).
// With kScaleA / kScaleB the A / B fragments become bf16(x * qscale).
template <bool kScaleA, bool kScaleB, int NT>
__device__ __forceinline__ void rows_by_rows(float (&acc)[NT][4], const bf16* sa, int m0,
                                             const bf16* sb, int ld, int N, int kd, int nn,
                                             float qscale, int lane) {
  uint32_t a[4][4];
  load_rows<kScaleA>(a, sa, m0, ld, N, kd, qscale, lane);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      continue;
    }
    dot_tile<kScaleB>(acc[nt], a, sb, 8 * nt, ld, N, kd, qscale, lane);
  }
}

// out = bf16(f) . B over kp k16 steps of the fragments' columns, B stored
// [k][dim] (the P V shape; B by ldmatrix x4.trans, rows clamped to N - 1).
// With kScaleB the B fragments become bf16(x * qscale).
template <bool kScaleB, int NT>
__device__ __forceinline__ void frags_by_rows(float (&out)[8][4], const float (&f)[NT][4],
                                              const bf16* sb, int ld, int N, int kp, int nd,
                                              float qscale, float* /*scratch*/, int lane) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[dt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (kk >= kp) continue;
    uint32_t a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = pack_bf16(f[2 * kk + (r >> 1)][2 * (r & 1)], f[2 * kk + (r >> 1)][2 * (r & 1) + 1]);
    const bf16* brow = sb + min(16 * kk + (lane & 15), N - 1) * ld + ((lane >> 4) << 3);
#pragma unroll
    for (int dt = 0; dt < 8; dt += 2) {
      if (dt >= nd) continue;
      uint32_t b[4];
      ldsm_x4_t(b, brow + 8 * dt);
      if (kScaleB)
#pragma unroll
        for (int r = 0; r < 4; ++r) b[r] = scale_pair(b[r], qscale);
      mma_bf16(out[dt], a, {b[0], b[1]});
      mma_bf16(out[dt + 1], a, {b[2], b[3]});
    }
  }
}

// Stores rows m0 + g (+ 8) < N of an (m16, head dim) accumulator tile,
// times `mul`, rounded to bf16, at dst[row * ld + col0 + column].
__device__ __forceinline__ void store_rows(bf16* dst, size_t ld, size_t row0, size_t col0,
                                           const float (&o)[8][4], int m0, int N, int hd,
                                           int nd, float mul, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gq + 8 * half;
    if (r >= N) continue;
    bf16* row = dst + (row0 + r) * ld + col0;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      if (dt >= nd) continue;
      const int c = 8 * dt + 2 * tq;
      const float a = o[dt][2 * half] * mul, b = o[dt][2 * half + 1] * mul;
      if (c + 1 < hd && (reinterpret_cast<uintptr_t>(row + c) & 3) == 0) {
        *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(a, b);
      } else {
        if (c < hd) row[c] = __float2bfloat16(a);
        if (c + 1 < hd) row[c + 1] = __float2bfloat16(b);
      }
    }
  }
}

// fp32 acc[nt] = A[16 rows at arow] . B[keys 8 nt..]^T over the head dim,
// in the accumulator layout (lane (g, t): rows m0 + g and m0 + g + 8,
// columns 8 nt + 2 t + {0, 1}; rows clamped to N - 1), each score summed
// in head-dim order, so S^T (pass 2) equals S (pass 1) bit for bit. With
// kScaleA / kScaleB the A / B values become x * qscale, in fp32.
template <bool kScaleA, bool kScaleB, int NT>
__device__ __forceinline__ void rows_by_rows(float (&acc)[NT][4], const float* sa, int m0,
                                             const float* sb, int ld, int N, int kd, int nn,
                                             float qscale, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const float* a0 = sa + min(m0 + gq, N - 1) * ld;
  const float* a1 = sa + min(m0 + gq + 8, N - 1) * ld;
  for (int d = 0; d < 16 * kd; d += 4) {
    float4 x0 = ld4(a0 + d), x1 = ld4(a1 + d);
    if (kScaleA) {
      x0 = make_float4(x0.x * qscale, x0.y * qscale, x0.z * qscale, x0.w * qscale);
      x1 = make_float4(x1.x * qscale, x1.y * qscale, x1.z * qscale, x1.w * qscale);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= nn) continue;
      const int c = 8 * nt + 2 * tq;
      float4 k0 = ld4(sb + min(c, N - 1) * ld + d), k1 = ld4(sb + min(c + 1, N - 1) * ld + d);
      if (kScaleB) {
        k0 = make_float4(k0.x * qscale, k0.y * qscale, k0.z * qscale, k0.w * qscale);
        k1 = make_float4(k1.x * qscale, k1.y * qscale, k1.z * qscale, k1.w * qscale);
      }
      acc[nt][0] = dot4(x0, k0, acc[nt][0]);
      acc[nt][1] = dot4(x0, k1, acc[nt][1]);
      acc[nt][2] = dot4(x1, k0, acc[nt][2]);
      acc[nt][3] = dot4(x1, k1, acc[nt][3]);
    }
  }
}

// fp32 acc = A[16 rows at m0] . B[keys n0..n0 + 7]^T in the accumulator
// layout, one key tile of rows_by_rows (the same sum order).
template <bool kScaleA, bool kScaleB>
__device__ __forceinline__ void dot_tile(float (&acc)[4], const float* sa, int m0,
                                         const float* sb, int n0, int ld, int N, int kd,
                                         float qscale, int lane) {
  const int gq = lane >> 2, tq = lane & 3, c = n0 + 2 * tq;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.f;
  const float* a0 = sa + min(m0 + gq, N - 1) * ld;
  const float* a1 = sa + min(m0 + gq + 8, N - 1) * ld;
  const float* b0 = sb + min(c, N - 1) * ld;
  const float* b1 = sb + min(c + 1, N - 1) * ld;
  for (int d = 0; d < 16 * kd; d += 4) {
    float4 x0 = ld4(a0 + d), x1 = ld4(a1 + d), k0 = ld4(b0 + d), k1 = ld4(b1 + d);
    if (kScaleA) {
      x0 = make_float4(x0.x * qscale, x0.y * qscale, x0.z * qscale, x0.w * qscale);
      x1 = make_float4(x1.x * qscale, x1.y * qscale, x1.z * qscale, x1.w * qscale);
    }
    if (kScaleB) {
      k0 = make_float4(k0.x * qscale, k0.y * qscale, k0.z * qscale, k0.w * qscale);
      k1 = make_float4(k1.x * qscale, k1.y * qscale, k1.z * qscale, k1.w * qscale);
    }
    acc[0] = dot4(x0, k0, acc[0]);
    acc[1] = dot4(x0, k1, acc[1]);
    acc[2] = dot4(x1, k0, acc[2]);
    acc[3] = dot4(x1, k1, acc[3]);
  }
}

// fp32 out = f . B over the fragments' key columns [0, N), B stored
// [k][dim] (rows clamped to N - 1; f is 0 past N). f goes through the
// warp's 16-row scratch; lane (g, t) then builds out[2 c + half][e] at row
// m0 + g + 8 half, column 16 c + 4 t + e (c < nd / 2), from float4 reads.
// With kScaleB the B values become x * qscale.
template <bool kScaleB, int NT>
__device__ __forceinline__ void frags_by_rows(float (&out)[8][4], const float (&f)[NT][4],
                                              const float* sb, int ld, int N, int kp, int nd,
                                              float qscale, float* scratch, int lane) {
  const int gq = lane >> 2, tq = lane & 3, nn = (N + 7) / 8, nc = nd / 2;
  const int sld = Layout<float>::p_ld(N), n4 = round_up(N, 4);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nn) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(scratch + (gq + 8 * half) * sld + 8 * nt + 2 * tq) =
          make_float2(f[nt][2 * half], f[nt][2 * half + 1]);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[c][e] = 0.f;
  for (int j = 0; j < n4; j += 4) {
    const float4 p0 = ld4(scratch + gq * sld + j), p1 = ld4(scratch + (gq + 8) * sld + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* br = sb + min(j + jj, N - 1) * ld + 4 * tq;
      const float a0 = comp(p0, jj), a1 = comp(p1, jj);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nc) continue;
        float4 v = ld4(br + 16 * c);
        if (kScaleB) v = make_float4(v.x * qscale, v.y * qscale, v.z * qscale, v.w * qscale);
        out[2 * c][0] = fmaf(a0, v.x, out[2 * c][0]);
        out[2 * c][1] = fmaf(a0, v.y, out[2 * c][1]);
        out[2 * c][2] = fmaf(a0, v.z, out[2 * c][2]);
        out[2 * c][3] = fmaf(a0, v.w, out[2 * c][3]);
        out[2 * c + 1][0] = fmaf(a1, v.x, out[2 * c + 1][0]);
        out[2 * c + 1][1] = fmaf(a1, v.y, out[2 * c + 1][1]);
        out[2 * c + 1][2] = fmaf(a1, v.z, out[2 * c + 1][2]);
        out[2 * c + 1][3] = fmaf(a1, v.w, out[2 * c + 1][3]);
      }
    }
  }
  __syncwarp();  // the scratch is free for the next product
}

// Stores rows m0 + g (+ 8) < N of an fp32 frags_by_rows result, times
// `mul`, at dst[row * ld + col0 + column].
__device__ __forceinline__ void store_rows(float* dst, size_t ld, size_t row0, size_t col0,
                                           const float (&o)[8][4], int m0, int N, int hd,
                                           int nd, float mul, int lane) {
  const int gq = lane >> 2, tq = lane & 3, nc = nd / 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gq + 8 * half;
    if (r >= N) continue;
    float* row = dst + (row0 + r) * ld + col0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= nc) continue;
      const int col = 16 * c + 4 * tq;
      const float* v = o[2 * c + half];
      if (col + 3 < hd && (reinterpret_cast<uintptr_t>(row + col) & 15) == 0) {
        *reinterpret_cast<float4*>(row + col) =
            make_float4(v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < hd) row[col + e] = v[e] * mul;
      }
    }
  }
}

// The A operand's scale: bf16(scale) in bf16 (qs = bf16(q * bf16(scale))),
// scale itself in fp32.
template <typename T> __device__ __forceinline__ float operand_scale(float scale) {
  return sizeof(T) == 2 ? __bfloat162float(__float2bfloat16(scale)) : scale;
}

// Pass 1 of (window w, head h) for the query tile at m0: S, p, dP, ds; ds
// into the group's dbias accumulator `sacc` (rows m0..m0 + 15, owned by
// this warp); the rows' softmax constants into `stats`; dq. `scratch`:
// the warp's (fp32 only).
template <typename T>
__device__ void bwd_pass1(const T* sq, const T* sk, const T* sv, const T* sdo, int ld,
                          const float* sbias, int bs, float* stats, float* sacc, float* scratch,
                          const Geometry& g, int w, int h, int m0, const BwdOperands<T>& op,
                          int lane) {
  const int N = g.N, hd = g.hd, gq = lane >> 2, tq = lane & 3;
  const int kd = head_pad(hd) / 16, nd = head_pad(hd) / 8;
  const int nn = (N + 7) / 8, kp = (N + 15) / 16;
  const float qscale = operand_scale<T>(g.scale);
  float s[8][4], dp[8][4];
  rows_by_rows<true, false>(s, sq, m0, sk, ld, N, kd, nn, qscale, lane);
  const RowStats st = softmax_frag<false>(s, m0, StagedRows{sbias, bs}, N, g.scale, lane);
  rows_by_rows<false, false>(dp, sdo, m0, sv, ld, N, kd, nn, qscale, lane);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nn) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rs0 += s[nt][e] * dp[nt][e];
      rs1 += s[nt][2 + e] * dp[nt][2 + e];
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    rs0 += __shfl_xor_sync(kFull, rs0, o);
    rs1 += __shfl_xor_sync(kFull, rs1, o);
  }
  // ds in dp's registers; the valid ones into the dbias accumulator
  const int r0 = m0 + gq, r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nn) continue;
    const int c = 8 * nt + 2 * tq;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dp[nt][e] = s[nt][e] * (dp[nt][e] - rs0);
      dp[nt][2 + e] = s[nt][2 + e] * (dp[nt][2 + e] - rs1);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= N || c >= N) continue;
      float* a = sacc + r * bs + c;
      a[0] += dp[nt][2 * half];
      if (c + 1 < N) a[1] += dp[nt][2 * half + 1];
    }
  }
  if (tq == 0) {
    stats[r0] = st.off0;
    stats[64 + r0] = st.inv0;
    stats[128 + r0] = rs0;
    if (r1 < 64) {
      stats[r1] = st.off1;
      stats[64 + r1] = st.inv1;
      stats[128 + r1] = rs1;
    }
  }
  // dq = round(round(ds) k * scale)
  float o[8][4];
  frags_by_rows<false>(o, dp, sk, ld, N, kp, nd, qscale, scratch, lane);
  store_rows(op.dq, g.ld_dx, (size_t)w * N, (size_t)h * hd, o, m0, N, hd, nd, g.scale, lane);
}

// Pass 2 of (window w, head h) for the key tile at j0, from every query
// row's constants: S^T and dP^T, p^T and ds^T (column 8 nt + 2 tq + e of a
// fragment is query i; padded queries get p = ds = 0), dv and dk.
template <typename T>
__device__ void bwd_pass2(const T* sq, const T* sk, const T* sv, const T* sdo, int ld,
                          const float* sbias, int bs, const float* stats, float* scratch,
                          const Geometry& g, int w, int h, int j0, const BwdOperands<T>& op,
                          int lane) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int N = g.N, hd = g.hd, gq = lane >> 2, tq = lane & 3;
  const int kd = head_pad(hd) / 16, nd = head_pad(hd) / 8;
  const int nn = (N + 7) / 8, kp = (N + 15) / 16;
  const float qscale = operand_scale<T>(g.scale);
  const size_t row0 = (size_t)w * N, col0 = (size_t)h * hd;
  float p[8][4], ds[8][4];
  rows_by_rows<false, true>(p, sk, j0, sq, ld, N, kd, nn, qscale, lane);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nn) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 8 * nt + 2 * tq + e;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = j0 + gq + 8 * half;
        float x = 0.f;
        if (i < N && j < N) {
          x = p[nt][2 * half + e] + sbias[i * bs + j];
          x = exp2f(fmaf(x, kLog2e, stats[i])) * stats[64 + i];
        }
        p[nt][2 * half + e] = x;
      }
    }
  }
  float o[8][4];
  frags_by_rows<false>(o, p, sdo, ld, N, kp, nd, qscale, scratch, lane);  // dv = round(p^T) do
  store_rows(op.dv, g.ld_dx, row0, col0, o, j0, N, hd, nd, 1.f, lane);
  rows_by_rows<false, false>(ds, sv, j0, sdo, ld, N, kd, nn, qscale, lane);  // dP^T
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nn) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 8 * nt + 2 * tq + e;
      const float rs = i < N ? stats[128 + i] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        ds[nt][2 * half + e] = i < N ? p[nt][2 * half + e] * (ds[nt][2 * half + e] - rs) : 0.f;
    }
  }
  frags_by_rows<true>(o, ds, sq, ld, N, kp, nd, qscale, scratch, lane);  // dk = round(ds^T) qs
  store_rows(op.dk, g.ld_dx, row0, col0, o, j0, N, hd, nd, 1.f, lane);
}

// The four warps of group `grp` meet (a named barrier; 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(kGroupWarps * 32) : "memory");
}

// Block (x, y = h * types + t), of blockDim.x / 128 groups of four warps:
// group k of block x runs windows w = i * types + t of head h for i in
// [(x * groups + k) * run, + run), one at a time. Warp q of the group
// stages the window's q, k, v or do tile, then takes query tile 16 q in
// pass 1 and key tile 16 q in pass 2 (N <= 64: four tiles). The group's
// dbias accumulator collects its windows' ds (warp q owns rows 16 q..); at
// the end the block sums its groups' accumulators in group order into
// partial[h][t * chunks + x].
template <typename T, class Policy>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
window_attention_bwd_tile_kernel(BwdOperands<T> op, Policy pol, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = g.N, bs = bias_ld(N), groups = blockDim.x / (kGroupWarps * 32);
  const int t = blockIdx.y % g.types, h = blockIdx.y / g.types;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / kGroupWarps, q = warp % kGroupWarps;
  float* sbias = reinterpret_cast<float*>(smem);
  pol.stage_bias(sbias, bs, g, t, h);

  const int ld = Layout<T>::ld(g.hd);
  unsigned char* mine = smem + bias_bytes(N) + (size_t)grp * bwd_group_bytes<T>(N, g.hd);
  T* tiles = reinterpret_cast<T*>(mine);
  float* stats = reinterpret_cast<float*>(mine + bwd_tiles_bytes<T>(N, g.hd));
  float* sacc = stats + kStatFloats;
  float* scratch = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sacc) +
                                            bias_bytes(N)) +
                   (size_t)q * 16 * Layout<float>::p_ld(N);
  T* const tile[4] = {tiles, tiles + (size_t)N * ld, tiles + (size_t)2 * N * ld,
                         tiles + (size_t)3 * N * ld};
  zero_pads(tile[q], N, ld, N, g.hd, lane);
  for (int e = lane; e < 16 * bs; e += 32)
    if (16 * q + e / bs < N) sacc[16 * q * bs + e] = 0.f;
  __syncthreads();

  const T* const src[4] = {op.q, op.k, op.v, op.dout};
  const int ld_src = q == 3 ? g.ld_do : g.ld_in;
  const int per_type = g.B_ / g.types;
  const int i0 = (blockIdx.x * groups + grp) * g.run;
  const int i1 = min(i0 + g.run, per_type);
  const size_t col0 = (size_t)g.hd * h;
  for (int i = i0; i < i1; ++i) {
    const int w = i * g.types + t;
    stage_tile(src[q], ld_src, (size_t)w * N, col0, tile[q], ld, N, g.hd, g.vec, lane);
    cp_async_commit();
    cp_async_wait<0>();
    group_sync(grp);  // the window is staged
    if (16 * q < N)
      bwd_pass1(tile[0], tile[1], tile[2], tile[3], ld, sbias, bs, stats, sacc, scratch, g, w,
                h, 16 * q, op, lane);
    group_sync(grp);  // every query row's constants are in
    if (16 * q < N)
      bwd_pass2(tile[0], tile[1], tile[2], tile[3], ld, sbias, bs, stats, scratch, g, w, h,
                16 * q, op, lane);
    group_sync(grp);  // the tiles are free
  }
  __syncthreads();

  // The block's partial: its groups' accumulators summed in group order.
  float* out = op.partial +
               (((size_t)h * g.types + t) * gridDim.x + blockIdx.x) * (size_t)N * N;
  const size_t gb = bwd_group_bytes<T>(N, g.hd) / sizeof(float);
  const float* acc0 = reinterpret_cast<const float*>(smem + bias_bytes(N) +
                                                     bwd_tiles_bytes<T>(N, g.hd)) + kStatFloats;
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int r = e / N, c = e - r * N;
    float sum = 0.f;
    for (int k = 0; k < groups; ++k) sum += acc0[k * gb + r * bs + c];
    out[e] = sum;
  }
}

// Launches the backward tile kernel: `warps` warps per block (a multiple
// of four), g.run windows per group of four (ops/window_attention.py
// tile_plan(..., backward=True)).
template <typename T, class Policy>
int launch_bwd_large(BwdOperands<T> op, const Policy& pol, const Geometry& g, int warps,
                     cudaStream_t stream);

template <typename T, class Policy>
int launch_bwd(BwdOperands<T> op, const Policy& pol, Geometry g, int warps,
               cudaStream_t stream) {
  if (g.run < 1 || g.types < 1 || g.B_ % g.types || g.N < 1 || g.N > kLargeMaxN || g.hd < 1 ||
      g.hd > 64)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  constexpr int kPer = 16 / sizeof(T);
  g.vec = aligned(op.q) && aligned(op.k) && aligned(op.v) && aligned(op.dout) &&
          g.ld_in % kPer == 0 && g.ld_do % kPer == 0 && g.hd % kPer == 0;
  if (g.N > kSmallMaxN) {
    if constexpr (Policy::kLarge) return launch_bwd_large<T>(op, pol, g, warps, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (warps < kGroupWarps || warps > kMaxWarps || warps % kGroupWarps)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes<T>(g.N, g.hd, warps);
  auto kernel = window_attention_bwd_tile_kernel<T, Policy>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int chunk = warps / kGroupWarps * g.run, per_type = g.B_ / g.types;
  const dim3 grid((per_type + chunk - 1) / chunk, g.nH * g.types);
  kernel<<<grid, warps * 32, smem, stream>>>(op, pol, g);
  return (int)cudaGetLastError();
}

// dbias[h, e] = sum over parts c (in order) of partial[h, c, e]. Templated
// on the caller's bias policy only so that a profile tells the callers'
// launches apart (esvit_tpu_torch/utils/profile.py).
template <class Policy>
__global__ void dbias_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                                    int nH, int parts, int NN) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nH * NN) return;
  const int h = idx / NN, e = idx - h * NN;
  const float* p = partial + (size_t)h * parts * NN + e;
  float acc = 0.f;
  for (int c = 0; c < parts; ++c) acc += p[(size_t)c * NN];
  dbias[idx] = acc;
}

template <class Policy>
int launch_dbias_reduce(const float* partial, float* dbias, int nH, int parts, int N,
                        cudaStream_t stream) {
  const int NN = N * N, total = nH * NN;
  dbias_reduce_kernel<Policy><<<(total + 255) / 256, 256, 0, stream>>>(partial, dbias, nH, parts, NN);
  return (int)cudaGetLastError();
}

// The backward of both dtypes: the tile kernel, then the fixed-order sum
// of the dbias partials. `warps` and g.run from ops/window_attention.py
// tile_plan(..., backward=True); the partials hold (nH, parts, N, N)
// floats, one per block: parts = types * chunks, chunks = ceil(B_ / types
// / (warps / 4 * run)), for the large tile ceil(B_ / types / run).
__host__ __device__ inline int bwd_parts(const Geometry& g, int warps) {
  const int per_block = g.N > kSmallMaxN ? g.run : warps / kGroupWarps * g.run;
  return g.types * ((g.B_ / g.types + per_block - 1) / per_block);
}

template <typename T, class Policy>
int backward(const BwdOperands<T>& op, const Policy& pol, const Geometry& g, int warps,
             float* dbias, cudaStream_t stream) {
  const int rc = launch_bwd<T>(op, pol, g, warps, stream);
  if (rc != 0) return rc;
  return launch_dbias_reduce<Policy>(op.partial, dbias, g.nH, bwd_parts(g, warps), g.N, stream);
}

// ---------------------------------------------------------------------------
// The large-window tile: 64 < N <= 256 tokens (Swin at W=14: N = 196 full
// windows, the augmented 145 = 144 + 1 virtual), both passes, bf16 and
// fp32. It replaces the N = 196 range of esvit_tpu/ops/fused_block.py
// _fwd_kernel / _bwd_kernel (attention halves A1 and A2 of
// csrc/fused_block.cu), of esvit_tpu/ops/packed_window_attention.py
// _fwd_kernel / _bwd_kernel (csrc/window_attention.cu) and of
// esvit_tpu/ops/pallas_window_attention.py _attention_kernel
// (csrc/pallas_window_attention.cu), with the small tile's policies and
// roundings.
//
// What bounds it: a (window, head) is 4 N^2 hd = 4.9 MFLOP on ~38 KB of
// bf16 operands at N = 196, hd = 32, ~130 FLOP/byte, under the bf16 ridge
// (~295): the operands' bytes bound it on paper, and what keeps it there
// is latency: chains of fragment loads, mmas, bias reads and softmax
// steps, hidden only by many resident warps. A tile that holds a whole
// 256-key score row in registers (128 fp32 a lane) builds at ~255
// registers and spills, so an SM holds 8 warps; a bias read from device
// memory per score puts an L2 round trip in every chain. The design:
//   - a block of up to 16 warps per run of windows of one (head, window
//     type): the block stages each window's q, k, v (and do) once in
//     shared memory with cp.async, and its warps take the window's m16
//     query tiles (the backward's pass 2: key tiles) in turn, warp k the
//     tiles k, k + warps, ...; the plan gives a block at most as many
//     warps as a window has tiles;
//   - a warp sweeps its tile's keys in blocks of 64 (kLargeKeys): one
//     m16 x 64 block of scores, 32 fp32 a lane, lives at a time, and the
//     build stays under 128 registers (__launch_bounds__(512, 1)), so an
//     SM holds 16 warps by registers. The kernels are templated on KD,
//     the head dim's k16 steps (2: hd <= 32, Swin's; 4: hd <= 64), which
//     sizes the fragments and accumulators, and on whether the block
//     stages the bias slice (below);
//   - the softmax keeps one max per (window, head) row: a sweep carries
//     the running max over the key blocks (the quad's max of each block)
//     and each lane's share of the row's sum, rescaled by 2^((old - new)
//     log2e) when the max grows. Where a policy rounds the normalised p
//     (TableBias and the fused block's FusedBlockBias: p rounded to bf16
//     before P.V), a first sweep forms the row's max and sum and a second
//     forms p = 2^(s log2e + off) inv, the formula of the small tile, and
//     P.V; where it does not (DenseBias in bf16: e split into bf16 hi +
//     lo; every fp32 path: p in fp32), one sweep rescales the output
//     accumulator with the sum and divides by the sum at the end. The
//     key tiles past N get -inf (p exactly 0);
//   - the composite bias slice of the block's (type, head), the (N, N)
//     fp32 slice plus -100 where the region ids differ, is staged once
//     per block in shared memory (stage_bias, as the small tile does)
//     wherever the block still fits with it (bf16 at N = 196: 154 KB
//     beside 47 KB of tiles forward, 63 KB backward), and serves every
//     window of the run; elsewhere (fp32 at N = 196, any N = 256) each
//     score reads the slice from device memory plus the staged region ids
//     (GlobalRows), the same composite in the same order. One (N, N)
//     operand serves the three callers: the packed table, the qkv-layout
//     dense bias and the augmented window's slice, whose virtual column
//     holds a logsumexp of the pad columns that no 729-entry table has;
//   - fp32 (no TF32): the products as register-tiled FMAs in the
//     accumulator layout, each score summed in head-dim order; a product
//     whose A operand is a fragment goes through a 16 x 64 scratch per
//     warp (acc_block), as the small backward's fp32 path;
//   - the backward (TableBias only): the block rounds each staged q tile
//     to qs = bf16(q * bf16(scale)) in place (fp32: q * scale), the one
//     form every product reads. Pass 1 on the query tiles sweeps the
//     key blocks once for the row's max, sum and rowsum(p dP) together
//     (the rowsum's terms rescaled with the sum: rowsum = (sum of e dP) /
//     sum), then once more forming p, dP and ds = p (dP - rowsum) a key
//     tile at a time, ds into the dbias partial and dq accumulated; the
//     rows' constants go to shared memory. Pass 2 on the key tiles sweeps
//     the query blocks: S^T, p^T from the constants, dv, dP^T a tile at a
//     time into ds^T, dk, both accumulated. Nine products of 2 N^2 hd a
//     (window, head): S three times, dP twice, dq, dv, dP^T, dk;
//   - dbias without atomics: each block owns one (N, N) fp32 partial in
//     device memory; its first window stores ds, later ones add, and each
//     element has one owning lane (the lane that holds it in pass 1, the
//     same for every window of the run), so the run is summed in window
//     order; dbias_reduce_kernel then sums a head's partials in block
//     order. Bit-identical on repeat.
// Launch plans (warps per block, windows per block): ops/window_attention.py
// tile_plan. A policy with kLarge instantiates these kernels; the packed
// pair's and the fused block's are compiled in sources of their own
// (window_attention_large*.cu, fused_block_large*.cu), so that their
// builds run beside the rest of window_attention.cu's and fused_block.cu's.
// ---------------------------------------------------------------------------

constexpr int kLargeKeys = 64;              // keys (pass 2: queries) per block of a sweep
constexpr int kLargeNT = kLargeKeys / 8;    // its n8 tiles
constexpr int kLargeMaxWarps = 16;
constexpr int kScratchLd = kLargeKeys + 4;  // the fp32 scratch's row stride
constexpr size_t kBlockSmemMax = 232448;    // an H100 block's dynamic shared memory

template <typename T>
__host__ __device__ inline size_t large_tiles_bytes(int N, int hd, int tiles) {
  return round_up_bytes((size_t)tiles * N * Layout<T>::ld(hd) * sizeof(T));
}
__host__ __device__ inline size_t large_ids_bytes(int N) {
  return round_up_bytes((size_t)N * sizeof(int));
}
__host__ __device__ inline size_t large_stats_bytes(int N) {
  return round_up_bytes((size_t)3 * N * sizeof(float));
}
// fp32 only: per warp a 16-row scratch of one key block.
template <typename T> __host__ __device__ inline size_t large_scratch_bytes(int warps) {
  return sizeof(T) == 2 ? 0 : (size_t)warps * 16 * kScratchLd * sizeof(float);
}

// A large-tile block of `warps` warps without the bias slice: the forward's
// q, k, v tiles (N rows at Layout<T>::ld(hd)) or the backward's q, k, v, do
// tiles and row constants (3 N floats), the region ids and the fp32
// scratch.
template <typename T>
__host__ __device__ inline size_t large_base_bytes(int N, int hd, int warps, bool backward) {
  return large_tiles_bytes<T>(N, hd, backward ? 4 : 3) + (backward ? large_stats_bytes(N) : 0) +
         large_ids_bytes(N) + large_scratch_bytes<T>(warps);
}

// Whether the block stages the composite bias slice: wherever it still fits.
template <typename T>
__host__ __device__ inline bool large_bias_staged(int N, int hd, int warps, bool backward) {
  return large_base_bytes<T>(N, hd, warps, backward) + bias_bytes(N) <= kBlockSmemMax;
}

// Dynamic shared memory of a large-tile block (ops/window_attention.py
// tile_smem_bytes mirrors it), in this order: the tiles, the staged bias
// slice (where it fits), the row constants (backward), the region ids, the
// scratch. Something always follows the tiles, so the ldmatrix x4 that
// half-reads past the last tile's last row (kd odd) stays inside the
// block's memory.
template <typename T>
__host__ __device__ inline size_t large_block_bytes(int N, int hd, int warps, bool backward) {
  const size_t base = large_base_bytes<T>(N, hd, warps, backward);
  return large_bias_staged<T>(N, hd, warps, backward) ? base + bias_bytes(N) : base;
}
template <typename T> __host__ __device__ inline size_t large_smem_bytes(int N, int hd, int warps) {
  return large_block_bytes<T>(N, hd, warps, false);
}
template <typename T>
__host__ __device__ inline size_t large_bwd_smem_bytes(int N, int hd, int warps) {
  return large_block_bytes<T>(N, hd, warps, true);
}

struct LargeSmem {
  unsigned char* tiles;
  float* bias;  // the staged slice, or null
  float* stats;
  int* ids;
  float* scratch;
};

template <typename T>
__device__ inline LargeSmem large_smem(unsigned char* smem, int N, int hd, int warps,
                                       bool backward) {
  LargeSmem s;
  s.tiles = smem;
  unsigned char* p = smem + large_tiles_bytes<T>(N, hd, backward ? 4 : 3);
  s.bias = nullptr;
  if (large_bias_staged<T>(N, hd, warps, backward)) {
    s.bias = reinterpret_cast<float*>(p);
    p += bias_bytes(N);
  }
  s.stats = reinterpret_cast<float*>(p);
  if (backward) p += large_stats_bytes(N);
  s.ids = reinterpret_cast<int*>(p);
  p += large_ids_bytes(N);
  s.scratch = reinterpret_cast<float*>(p);
  return s;
}

// The composite bias as the large tile reads it: the staged slice (row
// stride bs) where the block holds one (kStaged, a template parameter of
// the kernels, so no read branches), else the slice in device memory plus
// the region ids' -100 (GlobalRows).
template <bool kStaged> struct LargeRows;
template <> struct LargeRows<true> {
  const float* s;
  int bs;
  __device__ __forceinline__ float at(int i, int j) const { return s[i * bs + j]; }
  __device__ __forceinline__ float2 pair(int i, int c) const {
    return *reinterpret_cast<const float2*>(s + i * bs + c);
  }
};
template <> struct LargeRows<false> {
  GlobalRows gl;
  __device__ __forceinline__ float at(int i, int j) const { return gl.at(i, j); }
  __device__ __forceinline__ float2 pair(int i, int c) const { return gl.pair(i, c); }
};

// The block's bias of (t, h). Where the block holds a slice, it stages
// the composite into `sbias`: the (N, N) fp32 slice by 16-byte cp.async
// where its rows are 16-byte aligned (else element copies), then -100
// added where the region ids differ, the two values and the order of
// stage_bias. The policy's rows (GlobalRows) otherwise; either way the
// block copies the region ids into `ids`. The caller syncs before the
// first read.
template <bool kStaged, class Policy>
__device__ inline LargeRows<kStaged> large_rows(const Policy& pol, const Geometry& g, int t,
                                                int h, float* sbias, int* ids) {
  const GlobalRows gl = pol.rows(g, t, h, ids);
  if constexpr (!kStaged) {
    return LargeRows<false>{gl};
  } else {
    const int N = g.N, bs = bias_ld(N);
    if (N % 4 == 0 && (reinterpret_cast<uintptr_t>(gl.src) & 15) == 0) {
      const int cpr = N / 4;
      for (int e = threadIdx.x; e < N * cpr; e += blockDim.x) {
        const int r = e / cpr, c = (e - r * cpr) * 4;
        cp_async16(sbias + r * bs + c, gl.src + (size_t)r * N + c);
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {
#pragma unroll 4
      for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
        const int r = e / N;
        sbias[r * bs + e - r * N] = __ldg(gl.src + e);
      }
    }
    __syncthreads();  // the slice and the ids are in
    if (gl.ids != nullptr)
      for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
        const int r = e / N, c = e - r * N;
        sbias[r * bs + c] += (gl.ids[r] != gl.ids[c]) ? -100.f : 0.f;
      }
    return LargeRows<true>{sbias, bs};
  }
}

// The block zeroes head columns [hd, head_pad(hd)) of `rows` tile rows:
// the loads never write them and the products read them.
template <typename T>
__device__ void zero_cols(T* tiles, int rows, int ld, int hd) {
  const int wc = head_pad(hd) - hd;
  if (wc == 0) return;
  for (int e = threadIdx.x; e < rows * wc; e += blockDim.x) {
    const int r = e / wc;
    tiles[(size_t)r * ld + hd + (e - r * wc)] = T(0.f);
  }
}

// The block stages rows [0, N), columns [0, hd) of window w (rows from
// row0), head h (columns from col0) of kM operands into tiles of row
// stride ld: 16-byte cp.async when vec, else element copies.
template <typename T, int kM>
__device__ __forceinline__ void stage_block(const T* const (&src)[kM], const int (&ld_src)[kM],
                                            size_t row0, size_t col0, T* const (&dst)[kM],
                                            int ld, int N, int hd, int vec) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    if (vec) {
      const int cpr = hd / kPer;
      for (int e = threadIdx.x; e < N * cpr; e += blockDim.x) {
        const int r = e / cpr, c = (e - r * cpr) * kPer;
        cp_async16(dst[m] + (size_t)r * ld + c, src[m] + (row0 + r) * ld_src[m] + col0 + c);
      }
    } else {
      for (int e = threadIdx.x; e < N * hd; e += blockDim.x) {
        const int r = e / hd, c = e - r * hd;
        dst[m][(size_t)r * ld + c] = src[m][(row0 + r) * ld_src[m] + col0 + c];
      }
    }
  }
}

// The A operand of a 16-row product at m0 (rows clamped to N - 1): bf16
// keeps its fragments over KD k16 steps in registers (with kScale each
// pair becomes bf16(x * qscale)); fp32 reads its rows from shared memory
// (x * qscale with kScale). The B operands are never scaled: the
// backward stages qs = round(q * scale) in place (scale_tile).
template <typename T, int KD, bool kScale> struct LargeA;
template <int KD, bool kScale> struct LargeA<bf16, KD, kScale> {
  uint32_t a[KD][4];
  __device__ __forceinline__ void load(const bf16* sa, int m0, int ld, int N, int kd,
                                       float qscale, int lane) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk >= kd) continue;
      ldsm_x4(a[kk], sa + min(m0 + (lane & 15), N - 1) * ld + 16 * kk + ((lane >> 4) << 3));
      if (kScale)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[kk][r] = scale_pair(a[kk][r], qscale);
    }
  }
  // acc = A . B[rows n0..n0 + 7]^T over the head dim (B rows clamped to
  // N - 1), two k16 steps an ldmatrix x4.
  __device__ __forceinline__ void dot(float (&acc)[4], const bf16* sb, int n0, int ld, int N,
                                      int kd, int lane) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = 0.f;
    const bf16* brow = sb + min(n0 + (lane & 7), N - 1) * ld + ((lane >> 3) << 3);
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
      if (kk >= kd) continue;
      uint32_t b[4];
      ldsm_x4(b, brow + 16 * kk);
      mma_bf16(acc, a[kk], {b[0], b[1]});
      if (kk + 1 < kd) mma_bf16(acc, a[kk + 1], {b[2], b[3]});
    }
  }
};
template <int KD, bool kScale> struct LargeA<float, KD, kScale> {
  const float* sa;
  int m0;
  float qscale;
  __device__ __forceinline__ void load(const float* p, int m, int, int, int, float sc, int) {
    sa = p;
    m0 = m;
    qscale = sc;
  }
  __device__ __forceinline__ void dot(float (&acc)[4], const float* sb, int n0, int ld, int N,
                                      int kd, int lane) const {
    dot_tile<kScale, false>(acc, sa, m0, sb, n0, ld, N, kd, qscale, lane);
  }
};

// s[nt] = A . B[rows key0 + 8 nt..]^T for the block's key tiles below N
// (0 past them).
template <int KD, bool kScaleA>
__device__ __forceinline__ void scores_block(float (&s)[kLargeNT][4],
                                             const LargeA<bf16, KD, kScaleA>& a, const bf16* sb,
                                             int key0, int ld, int N, int kd, int lane) {
#pragma unroll
  for (int nt = 0; nt < kLargeNT; ++nt) {
    if (key0 + 8 * nt >= N) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      continue;
    }
    a.dot(s[nt], sb, key0 + 8 * nt, ld, N, kd, lane);
  }
}

// fp32: lane (g, t) builds rows m0 + g and m0 + g + 8 by the block's 16
// columns key0 + 8 nt + 2 t + {0, 1} from float4 reads (B rows clamped to
// N - 1), each score summed in head-dim order (rows_by_rows' order, so
// S^T in pass 2 equals S in pass 1 bit for bit).
template <int KD, bool kScaleA>
__device__ __forceinline__ void scores_block(float (&s)[kLargeNT][4],
                                             const LargeA<float, KD, kScaleA>& a, const float* sb,
                                             int key0, int ld, int N, int kd, int lane) {
  const float qscale = a.qscale;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kLargeNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const float* a0 = a.sa + min(a.m0 + gq, N - 1) * ld;
  const float* a1 = a.sa + min(a.m0 + gq + 8, N - 1) * ld;
  for (int d = 0; d < 16 * kd; d += 4) {
    float4 x0 = ld4(a0 + d), x1 = ld4(a1 + d);
    if (kScaleA) {
      x0 = make_float4(x0.x * qscale, x0.y * qscale, x0.z * qscale, x0.w * qscale);
      x1 = make_float4(x1.x * qscale, x1.y * qscale, x1.z * qscale, x1.w * qscale);
    }
#pragma unroll
    for (int nt = 0; nt < kLargeNT; ++nt) {
      if (key0 + 8 * nt >= N) continue;
      const int c = key0 + 8 * nt + 2 * tq;
      const float4 k0 = ld4(sb + min(c, N - 1) * ld + d);
      const float4 k1 = ld4(sb + min(c + 1, N - 1) * ld + d);
      s[nt][0] = dot4(x0, k0, s[nt][0]);
      s[nt][1] = dot4(x0, k1, s[nt][1]);
      s[nt][2] = dot4(x1, k0, s[nt][2]);
      s[nt][3] = dot4(x1, k1, s[nt][3]);
    }
  }
}

// Adds the composite bias to a block of scores (row m0 + g (+ 8), key
// key0 + 8 nt + 2 t + e; padded rows read the bias of row N - 1), after
// the scale if kPostScale, and puts -inf at the keys >= N: softmax_frag's
// arithmetic.
template <bool kPostScale, class Bias>
__device__ __forceinline__ void bias_block(float (&s)[kLargeNT][4], int m0, int key0,
                                           const Bias& bias, int N, float scale, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const int i0 = min(m0 + gq, N - 1), i1 = min(m0 + gq + 8, N - 1);
#pragma unroll
  for (int nt = 0; nt < kLargeNT; ++nt) {
    const int c = key0 + 8 * nt + 2 * tq;
    if (key0 + 8 * nt >= N) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = -INFINITY;
      continue;
    }
    const float2 x0 = bias.pair(i0, c);
    const float2 x1 = bias.pair(i1, c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = -INFINITY, b = -INFINITY;
      if (c + e < N) {
        a = kPostScale ? s[nt][e] * scale : s[nt][e];
        b = kPostScale ? s[nt][2 + e] * scale : s[nt][2 + e];
        a += e ? x0.y : x0.x;
        b += e ? x1.y : x1.x;
      }
      s[nt][e] = a;
      s[nt][2 + e] = b;
    }
  }
}

// A lane's two rows (g and g + 8 of its m16 tile) over a sweep so far: the
// running max, common to the quad, and the lane's share of the sum of
// e^(s - max).
struct RowRun {
  float m0, m1, l0, l1;
};

// Folds a block of biased scores into the run: the block's max over the
// quad joins the running max, the lane's sum is rescaled by 2^((old - new)
// log2e) where the max grew, and e = 2^(s log2e - max log2e) replaces s (0
// at -inf) and joins the sum. Returns the two rows' rescale factors.
// kExact (the backward): e = 2^((s - max) log2e), the difference rounded
// first, so e is exactly 1 at the row's max. One fma forms s log2e - max
// log2e from the rounded max log2e, off by up to half its ulp (~2e-6 at a
// score of 24), so e at the max misses 1 by ~1e-6; where p saturates at 1
// (a lifted bias column), ds = p (dP - rowsum(p dP)) at that column is
// then rounding noise of dP's size instead of cancelling to the tiny
// true value, as plain autograd's softmax backward does.
template <bool kExact = false>
__device__ __forceinline__ float2 online_block(float (&s)[kLargeNT][4], RowRun& r, int lane) {
  constexpr float kLog2e = 1.4426950408889634f;
  float b0 = -INFINITY, b1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kLargeNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b0 = fmaxf(b0, s[nt][e]);
      b1 = fmaxf(b1, s[nt][2 + e]);
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    b0 = fmaxf(b0, __shfl_xor_sync(kFull, b0, o));
    b1 = fmaxf(b1, __shfl_xor_sync(kFull, b1, o));
  }
  const float n0 = fmaxf(r.m0, b0), n1 = fmaxf(r.m1, b1);
  const float a0 = n0 == r.m0 ? 1.f : exp2f((r.m0 - n0) * kLog2e);
  const float a1 = n1 == r.m1 ? 1.f : exp2f((r.m1 - n1) * kLog2e);
  const float o0 = n0 == -INFINITY ? 0.f : kExact ? n0 : -n0 * kLog2e;
  const float o1 = n1 == -INFINITY ? 0.f : kExact ? n1 : -n1 * kLog2e;
  float x0 = 0.f, x1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kLargeNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (kExact) {
        s[nt][e] = exp2f((s[nt][e] - o0) * kLog2e);
        s[nt][2 + e] = exp2f((s[nt][2 + e] - o1) * kLog2e);
      } else {
        s[nt][e] = exp2f(fmaf(s[nt][e], kLog2e, o0));
        s[nt][2 + e] = exp2f(fmaf(s[nt][2 + e], kLog2e, o1));
      }
      x0 += s[nt][e];
      x1 += s[nt][2 + e];
    }
  r.l0 = r.l0 * a0 + x0;
  r.l1 = r.l1 * a1 + x1;
  r.m0 = n0;
  r.m1 = n1;
  return make_float2(a0, a1);
}

// The run's row constants: off = -max log2e (kExact: the max) and inv =
// 1 / sum, the lanes' sums added over the quad.
template <bool kExact = false>
__device__ __forceinline__ RowStats run_stats(RowRun r) {
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    r.l0 += __shfl_xor_sync(kFull, r.l0, o);
    r.l1 += __shfl_xor_sync(kFull, r.l1, o);
  }
  if (kExact) return RowStats{r.m0, r.m1, 1.f / r.l0, 1.f / r.l1};
  return RowStats{-r.m0 * kLog2e, -r.m1 * kLog2e, 1.f / r.l0, 1.f / r.l1};
}

// p = 2^(s log2e + off) inv over a block of biased scores (0 at -inf);
// kExact: 2^((s - off) log2e) inv, off the max (online_block).
template <bool kExact = false>
__device__ __forceinline__ void p_block(float (&s)[kLargeNT][4], const RowStats& st) {
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int nt = 0; nt < kLargeNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (kExact) {
        s[nt][e] = exp2f((s[nt][e] - st.off0) * kLog2e) * st.inv0;
        s[nt][2 + e] = exp2f((s[nt][2 + e] - st.off1) * kLog2e) * st.inv1;
      } else {
        s[nt][e] = exp2f(fmaf(s[nt][e], kLog2e, st.off0)) * st.inv0;
        s[nt][2 + e] = exp2f(fmaf(s[nt][2 + e], kLog2e, st.off1)) * st.inv1;
      }
    }
}

// bf16: out += bf16(f) . B over the block's keys key0.. below N, B stored
// [key][dim] (ldmatrix x4.trans, rows clamped to N - 1; f is 0 past N).
// kSplit: f = bf16(f) + bf16(f - bf16(f)), two mmas. Accumulator layout:
// out[dt][e], row
// g (e < 2) or g + 8, column 8 dt + 2 t + e % 2.
template <bool kSplit, int ND>
__device__ __forceinline__ void acc_block(float (&out)[ND][4], const float (&f)[kLargeNT][4],
                                          const bf16* sb, int key0, int ld, int N, int nd,
                                          float*, int lane) {
#pragma unroll
  for (int kk = 0; kk < kLargeNT / 2; ++kk) {
    if (key0 + 16 * kk >= N) continue;
    uint32_t a[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = f[2 * kk + (r >> 1)][2 * (r & 1)];
      const float y = f[2 * kk + (r >> 1)][2 * (r & 1) + 1];
      a[r] = pack_bf16(x, y);
      if (kSplit) al[r] = pack_bf16(x - bf16_lo(a[r]), y - bf16_hi(a[r]));
    }
    const bf16* brow = sb + min(key0 + 16 * kk + (lane & 15), N - 1) * ld + ((lane >> 4) << 3);
#pragma unroll
    for (int dt = 0; dt < ND; dt += 2) {
      if (dt >= nd) continue;
      uint32_t b[4];
      ldsm_x4_t(b, brow + 8 * dt);
      mma_bf16(out[dt], a, {b[0], b[1]});
      mma_bf16(out[dt + 1], a, {b[2], b[3]});
      if (kSplit) {
        mma_bf16(out[dt], al, {b[0], b[1]});
        mma_bf16(out[dt + 1], al, {b[2], b[3]});
      }
    }
  }
}

// fp32: out += f . B over the block's keys key0.. below N, B stored
// [key][dim] (rows clamped to N - 1; f is 0 past N). f goes through the
// warp's 16 x 64 scratch; lane (g, t) then adds into out[2 c + half][e] at
// row g + 8 half, column 16 c + 4 t + e (c < nd / 2), from float4 reads.
template <bool kSplit, int ND>
__device__ __forceinline__ void acc_block(float (&out)[ND][4], const float (&f)[kLargeNT][4],
                                          const float* sb, int key0, int ld, int N, int nd,
                                          float* scratch, int lane) {
  const int gq = lane >> 2, tq = lane & 3, nc = nd / 2;
  const int n4 = round_up(min(kLargeKeys, N - key0), 4);
#pragma unroll
  for (int nt = 0; nt < kLargeNT; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(scratch + (gq + 8 * half) * kScratchLd + 8 * nt + 2 * tq) =
          make_float2(f[nt][2 * half], f[nt][2 * half + 1]);
  __syncwarp();
  for (int j = 0; j < n4; j += 4) {
    const float4 p0 = ld4(scratch + gq * kScratchLd + j);
    const float4 p1 = ld4(scratch + (gq + 8) * kScratchLd + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* br = sb + min(key0 + j + jj, N - 1) * ld + 4 * tq;
      const float a0 = comp(p0, jj), a1 = comp(p1, jj);
#pragma unroll
      for (int c = 0; c < ND / 2; ++c) {
        if (c >= nc) continue;
        const float4 v = ld4(br + 16 * c);
        out[2 * c][0] = fmaf(a0, v.x, out[2 * c][0]);
        out[2 * c][1] = fmaf(a0, v.y, out[2 * c][1]);
        out[2 * c][2] = fmaf(a0, v.z, out[2 * c][2]);
        out[2 * c][3] = fmaf(a0, v.w, out[2 * c][3]);
        out[2 * c + 1][0] = fmaf(a1, v.x, out[2 * c + 1][0]);
        out[2 * c + 1][1] = fmaf(a1, v.y, out[2 * c + 1][1]);
        out[2 * c + 1][2] = fmaf(a1, v.z, out[2 * c + 1][2]);
        out[2 * c + 1][3] = fmaf(a1, v.w, out[2 * c + 1][3]);
      }
    }
  }
  __syncwarp();  // the scratch is free for the next block
}

// Multiplies the accumulator's rows g and g + 8 by (x, y): bf16's
// fragment layout, then fp32's (acc_block's).
template <int ND>
__device__ __forceinline__ void scale_rows(float (&o)[ND][4], float2 a, const bf16*) {
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    o[dt][0] *= a.x;
    o[dt][1] *= a.x;
    o[dt][2] *= a.y;
    o[dt][3] *= a.y;
  }
}
template <int ND>
__device__ __forceinline__ void scale_rows(float (&o)[ND][4], float2 a, const float*) {
#pragma unroll
  for (int dt = 0; dt < ND; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] *= (dt & 1) ? a.y : a.x;
}

// Stores rows m0 + g (+ 8) < N of an (m16, head dim) accumulator, times
// `mul`, at dst[row * ld + col0 + column]: bf16 rounded from the fragment
// layout, fp32 from acc_block's.
template <int ND>
__device__ __forceinline__ void store_tile(bf16* dst, size_t ld, size_t row0, size_t col0,
                                           const float (&o)[ND][4], int m0, int N, int hd,
                                           int nd, float mul, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gq + 8 * half;
    if (r >= N) continue;
    bf16* row = dst + (row0 + r) * ld + col0;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      if (dt >= nd) continue;
      const int c = 8 * dt + 2 * tq;
      const float a = o[dt][2 * half] * mul, b = o[dt][2 * half + 1] * mul;
      if (c + 1 < hd && (reinterpret_cast<uintptr_t>(row + c) & 3) == 0) {
        *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(a, b);
      } else {
        if (c < hd) row[c] = __float2bfloat16(a);
        if (c + 1 < hd) row[c + 1] = __float2bfloat16(b);
      }
    }
  }
}
template <int ND>
__device__ __forceinline__ void store_tile(float* dst, size_t ld, size_t row0, size_t col0,
                                           const float (&o)[ND][4], int m0, int N, int hd,
                                           int nd, float mul, int lane) {
  const int gq = lane >> 2, tq = lane & 3, nc = nd / 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + gq + 8 * half;
    if (r >= N) continue;
    float* row = dst + (row0 + r) * ld + col0;
#pragma unroll
    for (int c = 0; c < ND / 2; ++c) {
      if (c >= nc) continue;
      const int col = 16 * c + 4 * tq;
      const float* v = o[2 * c + half];
      if (col + 3 < hd && (reinterpret_cast<uintptr_t>(row + col) & 15) == 0) {
        *reinterpret_cast<float4*>(row + col) =
            make_float4(v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < hd) row[col + e] = v[e] * mul;
      }
    }
  }
}

// The forward of one m16 query tile at m0. bf16: the A operand is
// bf16(q * bf16(scale)) with Policy::kRoundQ, else q unscaled and the fp32
// score scaled after the product; fp32: q * scale in fp32 (both policies,
// as their plain versions). A policy that rounds the normalised p
// (kRoundQ and not kSplitP) takes two sweeps: the rows' max and sum, then
// p and O. Otherwise one sweep: O accumulates e (bf16: split into hi +
// lo; fp32: e itself), rescaled as the max grows, and is divided by the
// sum at the end.
template <class Policy, int KD, typename T, class Bias>
__device__ __forceinline__ void large_fwd_tile(const T* sq, const T* sk, const T* sv, int ld,
                                               const Bias& bias, const Geometry& g, int w, int h,
                                               int m0, T* __restrict__ out, float* scratch,
                                               int lane) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr bool kTwoSweeps = kBf16 && !Policy::kSplitP;
  constexpr bool kPostScale = kBf16 && !Policy::kRoundQ;
  const int N = g.N, hd = g.hd, kd = head_pad(hd) / 16, nd = head_pad(hd) / 8;
  const float qscale = kBf16 ? __bfloat162float(__float2bfloat16(g.scale)) : g.scale;
  LargeA<T, KD, !kPostScale> qa;
  qa.load(sq, m0, ld, N, kd, qscale, lane);
  float o[2 * KD][4];
#pragma unroll
  for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  RowRun run{-INFINITY, -INFINITY, 0.f, 0.f};
  for (int key0 = 0; key0 < N; key0 += kLargeKeys) {
    float s[kLargeNT][4];
    scores_block(s, qa, sk, key0, ld, N, kd, lane);
    bias_block<kPostScale>(s, m0, key0, bias, N, g.scale, lane);
    const float2 a = online_block(s, run, lane);
    if (!kTwoSweeps) {
      scale_rows(o, a, sq);
      acc_block<kBf16 && Policy::kSplitP>(o, s, sv, key0, ld, N, nd, scratch, lane);
    }
  }
  const RowStats st = run_stats(run);
  if (kTwoSweeps) {
    for (int key0 = 0; key0 < N; key0 += kLargeKeys) {
      float s[kLargeNT][4];
      scores_block(s, qa, sk, key0, ld, N, kd, lane);
      bias_block<kPostScale>(s, m0, key0, bias, N, g.scale, lane);
      p_block(s, st);
      acc_block<false>(o, s, sv, key0, ld, N, nd, scratch, lane);
    }
  } else {
    scale_rows(o, make_float2(st.inv0, st.inv1), sq);
  }
  store_tile(out, g.ld_out, (size_t)w * N, (size_t)h * hd, o, m0, N, hd, nd, 1.f, lane);
}

// Block (x, y = h * types + t) runs windows w = i * types + t of head h for
// i in [x * run, (x + 1) * run), one at a time; warp k takes query tiles
// 16 k, 16 (k + warps), ... of each.
template <typename T, class Policy, int KD, bool kStaged>
__global__ void __launch_bounds__(kLargeMaxWarps * 32, 1)
window_attention_large_kernel(Operands<T> op, Policy pol, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = g.N, ld = Layout<T>::ld(g.hd);
  const int t = blockIdx.y % g.types, h = blockIdx.y / g.types;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const LargeSmem sm = large_smem<T>(smem, N, g.hd, warps, false);
  T* tiles = reinterpret_cast<T*>(sm.tiles);
  T* const tile[3] = {tiles, tiles + (size_t)N * ld, tiles + (size_t)2 * N * ld};
  float* scratch = sm.scratch + (size_t)warp * 16 * kScratchLd;
  const LargeRows<kStaged> bias = large_rows<kStaged>(pol, g, t, h, sm.bias, sm.ids);
  zero_cols(tiles, 3 * N, ld, g.hd);
  __syncthreads();

  const T* const src[3] = {op.q, op.k, op.v};
  const int ld_src[3] = {g.ld_in, g.ld_in, g.ld_in};
  const int per_type = g.B_ / g.types;
  const int i0 = blockIdx.x * g.run, i1 = min(i0 + g.run, per_type);
  for (int i = i0; i < i1; ++i) {
    const int w = i * g.types + t;
    stage_block(src, ld_src, (size_t)w * N, (size_t)h * g.hd, tile, ld, N, g.hd, g.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the window is staged
    for (int m0 = 16 * warp; m0 < N; m0 += 16 * warps)
      large_fwd_tile<Policy, KD>(tile[0], tile[1], tile[2], ld, bias, g, w, h, m0, op.out,
                                 scratch, lane);
    __syncthreads();  // the tiles are free
  }
}

// The instantiation a launch takes: KD = 2 k16 steps up to hd = 32, else 4;
// kStaged where the block holds the bias slice.
template <typename K>
K large_instance(int hd, bool staged, K kd2_staged, K kd2, K kd4_staged, K kd4) {
  if (head_pad(hd) <= 32) return staged ? kd2_staged : kd2;
  return staged ? kd4_staged : kd4;
}

template <typename T, class Policy>
int launch_large(Operands<T> op, const Policy& pol, const Geometry& g, int warps,
                 cudaStream_t stream) {
  if (warps < 1 || warps > kLargeMaxWarps) return (int)cudaErrorInvalidValue;
  const size_t smem = large_smem_bytes<T>(g.N, g.hd, warps);
  auto kernel = large_instance(g.hd, large_bias_staged<T>(g.N, g.hd, warps, false),
                               window_attention_large_kernel<T, Policy, 2, true>,
                               window_attention_large_kernel<T, Policy, 2, false>,
                               window_attention_large_kernel<T, Policy, 4, true>,
                               window_attention_large_kernel<T, Policy, 4, false>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_type = g.B_ / g.types;
  const dim3 grid((per_type + g.run - 1) / g.run, g.nH * g.types);
  kernel<<<grid, warps * 32, smem, stream>>>(op, pol, g);
  return (int)cudaGetLastError();
}

// The block rounds a staged q tile to qs in place: bf16(q * bf16(scale))
// (scale_pair's rounding) in bf16, q * scale in fp32. Every product of the
// backward that reads q reads qs.
__device__ inline void scale_tile(bf16* t, int N, int ld, int hd, float qscale) {
  for (int e = threadIdx.x; e < N * hd; e += blockDim.x) {
    bf16* x = t + (size_t)(e / hd) * ld + e % hd;
    *x = __float2bfloat16(__bfloat162float(*x) * qscale);
  }
}
__device__ inline void scale_tile(float* t, int N, int ld, int hd, float qscale) {
  for (int e = threadIdx.x; e < N * hd; e += blockDim.x) t[(size_t)(e / hd) * ld + e % hd] *= qscale;
}

// Pass 1 of (window w, head h) for the query tile at m0. Sweep 1: S, its
// running max and sum, and dP = do v^T a key tile at a time, whose terms e
// dP are summed and rescaled with the sum, so rowsum(p dP) = (sum of e dP)
// / sum; e = 2^((s - max) log2e) (online_block<true>: exactly 1 at the
// max, so where p saturates at 1, rowsum(p dP) is that column's dP and its
// ds cancels to 0 as autograd's does). The rows' constants (max, inv,
// rowsum) go to `stats` (3 N floats). Sweep 2: S and p, dP again a tile
// at a time into ds = p (dP - rowsum), ds into the block's dbias partial
// (stored by the run's first window, added after), dq = round(round(ds) k
// * scale) accumulated.
template <int KD, typename T, class Bias>
__device__ void large_pass1(const T* sq, const T* sk, const T* sv, const T* sdo, int ld,
                            const Bias& bias, float* stats, float* part, bool first,
                            float* scratch, const Geometry& g, int w, int h, int m0,
                            const BwdOperands<T>& op, int lane) {
  const int N = g.N, hd = g.hd, gq = lane >> 2, tq = lane & 3;
  const int kd = head_pad(hd) / 16, nd = head_pad(hd) / 8;
  LargeA<T, KD, false> qa, da;
  RowRun run{-INFINITY, -INFINITY, 0.f, 0.f};
  float d0 = 0.f, d1 = 0.f;
  for (int key0 = 0; key0 < N; key0 += kLargeKeys) {
    float s[kLargeNT][4];
    qa.load(sq, m0, ld, N, kd, 0.f, lane);
    scores_block(s, qa, sk, key0, ld, N, kd, lane);
    bias_block<false>(s, m0, key0, bias, N, g.scale, lane);
    const float2 a = online_block<true>(s, run, lane);
    da.load(sdo, m0, ld, N, kd, 0.f, lane);
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kLargeNT; ++nt) {
      if (key0 + 8 * nt >= N) continue;
      float dp[4];
      da.dot(dp, sv, key0 + 8 * nt, ld, N, kd, lane);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x0 += s[nt][e] * dp[e];
        x1 += s[nt][2 + e] * dp[2 + e];
      }
    }
    d0 = d0 * a.x + x0;
    d1 = d1 * a.y + x1;
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    d0 += __shfl_xor_sync(kFull, d0, o);
    d1 += __shfl_xor_sync(kFull, d1, o);
  }
  const RowStats st = run_stats<true>(run);
  const float rs0 = d0 * st.inv0, rs1 = d1 * st.inv1;
  const int r0 = m0 + gq, r1 = r0 + 8;
  if (tq == 0) {
    if (r0 < N) {
      stats[r0] = st.off0;
      stats[N + r0] = st.inv0;
      stats[2 * N + r0] = rs0;
    }
    if (r1 < N) {
      stats[r1] = st.off1;
      stats[N + r1] = st.inv1;
      stats[2 * N + r1] = rs1;
    }
  }
  float o[2 * KD][4];
#pragma unroll
  for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  for (int key0 = 0; key0 < N; key0 += kLargeKeys) {
    float s[kLargeNT][4];
    qa.load(sq, m0, ld, N, kd, 0.f, lane);
    scores_block(s, qa, sk, key0, ld, N, kd, lane);
    bias_block<false>(s, m0, key0, bias, N, g.scale, lane);
    p_block<true>(s, st);
    da.load(sdo, m0, ld, N, kd, 0.f, lane);
#pragma unroll
    for (int nt = 0; nt < kLargeNT; ++nt) {
      if (key0 + 8 * nt >= N) continue;
      float dp[4];
      da.dot(dp, sv, key0 + 8 * nt, ld, N, kd, lane);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = s[nt][e] * (dp[e] - rs0);
        s[nt][2 + e] = s[nt][2 + e] * (dp[2 + e] - rs1);
      }
      const int c = key0 + 8 * nt + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= N || c >= N) continue;
        float* x = part + (size_t)r * N + c;
        const float u = s[nt][2 * half], v = s[nt][2 * half + 1];
        if (first) {
          x[0] = u;
          if (c + 1 < N) x[1] = v;
        } else {
          x[0] += u;
          if (c + 1 < N) x[1] += v;
        }
      }
    }
    acc_block<false>(o, s, sk, key0, ld, N, nd, scratch, lane);  // dq
  }
  store_tile(op.dq, g.ld_dx, (size_t)w * N, (size_t)h * hd, o, m0, N, hd, nd, g.scale, lane);
}

// Pass 2 of (window w, head h) for the key tile at j0, over the query
// blocks, from every query row's constants: S^T = k qs^T and p^T =
// 2^((s - max) log2e) inv as pass 1 forms p (column 8 nt + 2 tq + e of a
// fragment is query i; padded queries get p = ds = 0), dv = round(round(
// p)^T do) accumulated, dP^T = v do^T a query tile at a time into ds^T,
// dk = round(round(ds)^T qs) accumulated.
template <int KD, typename T, class Bias>
__device__ void large_pass2(const T* sq, const T* sk, const T* sv, const T* sdo, int ld,
                            const Bias& bias, const float* stats, float* scratch,
                            const Geometry& g, int w, int h, int j0, const BwdOperands<T>& op,
                            int lane) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int N = g.N, hd = g.hd, gq = lane >> 2, tq = lane & 3;
  const int kd = head_pad(hd) / 16, nd = head_pad(hd) / 8;
  const size_t row0 = (size_t)w * N, col0 = (size_t)h * hd;
  LargeA<T, KD, false> ka, va;
  float dv[2 * KD][4], dk[2 * KD][4];
#pragma unroll
  for (int dt = 0; dt < 2 * KD; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[dt][e] = dk[dt][e] = 0.f;
  for (int i0 = 0; i0 < N; i0 += kLargeKeys) {
    float p[kLargeNT][4];
    ka.load(sk, j0, ld, N, kd, 0.f, lane);
    scores_block(p, ka, sq, i0, ld, N, kd, lane);  // S^T = k qs^T
#pragma unroll
    for (int nt = 0; nt < kLargeNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + 8 * nt + 2 * tq + e;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = j0 + gq + 8 * half;
          float x = 0.f;
          if (i < N && j < N) {
            x = p[nt][2 * half + e] + bias.at(i, j);
            x = exp2f((x - stats[i]) * kLog2e) * stats[N + i];
          }
          p[nt][2 * half + e] = x;
        }
      }
    acc_block<false>(dv, p, sdo, i0, ld, N, nd, scratch, lane);
    va.load(sv, j0, ld, N, kd, 0.f, lane);
#pragma unroll
    for (int nt = 0; nt < kLargeNT; ++nt) {
      if (i0 + 8 * nt >= N) continue;
      float dp[4];
      va.dot(dp, sdo, i0 + 8 * nt, ld, N, kd, lane);  // dP^T
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + 8 * nt + 2 * tq + e;
        const float rs = i < N ? stats[2 * N + i] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          p[nt][2 * half + e] = i < N ? p[nt][2 * half + e] * (dp[2 * half + e] - rs) : 0.f;
      }
    }
    acc_block<false>(dk, p, sq, i0, ld, N, nd, scratch, lane);
  }
  store_tile(op.dv, g.ld_dx, row0, col0, dv, j0, N, hd, nd, 1.f, lane);
  store_tile(op.dk, g.ld_dx, row0, col0, dk, j0, N, hd, nd, 1.f, lane);
}

// Block (x, y = h * types + t) runs windows w = i * types + t of head h for
// i in [x * run, (x + 1) * run), one at a time: the block stages q, k, v
// and do, its warps take the query tiles in pass 1 and the key tiles in
// pass 2 (warp k: tiles k, k + warps, ...), and the block's dbias partial
// is partial[h][t * chunks + x].
template <typename T, class Policy, int KD, bool kStaged>
__global__ void __launch_bounds__(kLargeMaxWarps * 32, 1)
window_attention_large_bwd_kernel(BwdOperands<T> op, Policy pol, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = g.N, ld = Layout<T>::ld(g.hd);
  const int t = blockIdx.y % g.types, h = blockIdx.y / g.types;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const LargeSmem sm = large_smem<T>(smem, N, g.hd, warps, true);
  T* tiles = reinterpret_cast<T*>(sm.tiles);
  T* const tile[4] = {tiles, tiles + (size_t)N * ld, tiles + (size_t)2 * N * ld,
                      tiles + (size_t)3 * N * ld};
  float* scratch = sm.scratch + (size_t)warp * 16 * kScratchLd;
  const LargeRows<kStaged> bias = large_rows<kStaged>(pol, g, t, h, sm.bias, sm.ids);
  zero_cols(tiles, 4 * N, ld, g.hd);
  __syncthreads();

  float* part = op.partial + (((size_t)h * g.types + t) * gridDim.x + blockIdx.x) * (size_t)N * N;
  const T* const src[4] = {op.q, op.k, op.v, op.dout};
  const int ld_src[4] = {g.ld_in, g.ld_in, g.ld_in, g.ld_do};
  const int per_type = g.B_ / g.types;
  const int i0 = blockIdx.x * g.run, i1 = min(i0 + g.run, per_type);
  for (int i = i0; i < i1; ++i) {
    const int w = i * g.types + t;
    stage_block(src, ld_src, (size_t)w * N, (size_t)h * g.hd, tile, ld, N, g.hd, g.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the window is staged
    scale_tile(tile[0], N, ld, g.hd, operand_scale<T>(g.scale));
    __syncthreads();  // q is qs
    for (int m0 = 16 * warp; m0 < N; m0 += 16 * warps)
      large_pass1<KD>(tile[0], tile[1], tile[2], tile[3], ld, bias, sm.stats, part, i == i0,
                      scratch, g, w, h, m0, op, lane);
    __syncthreads();  // every query row's constants are in
    for (int j0 = 16 * warp; j0 < N; j0 += 16 * warps)
      large_pass2<KD>(tile[0], tile[1], tile[2], tile[3], ld, bias, sm.stats, scratch, g, w, h,
                      j0, op, lane);
    __syncthreads();  // the tiles and constants are free
  }
}

template <typename T, class Policy>
int launch_bwd_large(BwdOperands<T> op, const Policy& pol, const Geometry& g, int warps,
                     cudaStream_t stream) {
  if (warps < 1 || warps > kLargeMaxWarps) return (int)cudaErrorInvalidValue;
  const size_t smem = large_bwd_smem_bytes<T>(g.N, g.hd, warps);
  auto kernel = large_instance(g.hd, large_bias_staged<T>(g.N, g.hd, warps, true),
                               window_attention_large_bwd_kernel<T, Policy, 2, true>,
                               window_attention_large_bwd_kernel<T, Policy, 2, false>,
                               window_attention_large_bwd_kernel<T, Policy, 4, true>,
                               window_attention_large_bwd_kernel<T, Policy, 4, false>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_type = g.B_ / g.types;
  const dim3 grid((per_type + g.run - 1) / g.run, g.nH * g.types);
  kernel<<<grid, warps * 32, smem, stream>>>(op, pol, g);
  return (int)cudaGetLastError();
}

// The forward tile's and the backward tile's dynamic shared memory at any
// N, small or large (what the exported counts report).
template <typename T> __host__ __device__ inline size_t fwd_smem(int N, int hd, int warps) {
  return N > kSmallMaxN ? large_smem_bytes<T>(N, hd, warps) : smem_bytes<T>(N, hd, warps);
}
template <typename T> __host__ __device__ inline size_t bwd_smem(int N, int hd, int warps) {
  return N > kSmallMaxN ? large_bwd_smem_bytes<T>(N, hd, warps) : bwd_smem_bytes<T>(N, hd, warps);
}

}  // namespace wtile
