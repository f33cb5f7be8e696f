// The tile machinery shared by the two window-attention forward kernels,
// sm_90a: the packed forward (window_attention.cu) and the qkv-layout
// forward (pallas_window_attention.cu).
//
// Both compute, per window w and head h (N <= 64 tokens, head dim hd <=
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
// result is bit-identical on repeat.

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
  int N;       // tokens per window (<= 64)
  int hd;      // head dim (<= 64)
  int nH;      // heads
  int types;   // window types: window w takes the bias slice of w % types
  int ld_in;   // row stride of q, k, v, in elements
  int ld_out;  // row stride of the output, in elements (C)
  int run;     // windows per warp
  float scale;
  int vec;     // 1: q, k, v rows and heads are 16-byte aligned (cp.async)
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

// The softmax of one m16 tile of scores in the accumulator layout: lane
// (g = lane / 4, t = lane % 4) holds s[nt][e] at row m0 + g and s[nt][2 + e]
// at row m0 + g + 8, column 8 nt + 2 t + e. Adds the bias (after the scale,
// if kPostScale), masks columns >= N with -inf and leaves p in s (0 in the
// masked columns and in the tiles past the keys). A row's max and sum are
// fp32, over its quad.
template <bool kPostScale>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], int m0, const float* sbias,
                                             int bs, int N, float scale, int lane) {
  const int gq = lane >> 2, tq = lane & 3, nn = (N + 7) / 8;
  const float* b0 = sbias + min(m0 + gq, N - 1) * bs;
  const float* b1 = sbias + min(m0 + gq + 8, N - 1) * bs;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nn) continue;
    const int c = 8 * nt + 2 * tq;  // even, and bs is even: 8-byte aligned
    const float2 x0 = *reinterpret_cast<const float2*>(b0 + c);
    const float2 x1 = *reinterpret_cast<const float2*>(b1 + c);
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
  for (int nt = 0; nt < 8; ++nt) {
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
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= nn) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] *= inv0;
      s[nt][2 + e] *= inv1;
    }
  }
}

// bf16: S = Q K^T and O = P V on the tensor cores, one m16 tile of query
// rows at a time. Policy::kRoundQ: the A operand is bf16(q * bf16(scale))
// and p is rounded to bf16 (the packed kernel's roundings); otherwise the
// fp32 score is scaled after the product and p = bf16(p) + bf16(p - bf16(p))
// takes two mmas (Policy::kSplitP), carrying p to ~2^-17.
template <class Policy>
__device__ void attend(const bf16* sq, const bf16* sk, const bf16* sv, int ld,
                       const float* sbias, int bs, float*, const Geometry& g, int w, int h,
                       bf16* __restrict__ out, int lane) {
  const int N = g.N, hd = g.hd, gq = lane >> 2, tq = lane & 3;
  const int kd = head_pad(hd) / 16, nd = head_pad(hd) / 8;
  const int nn = (N + 7) / 8, kp = (N + 15) / 16;
  const float qscale = __bfloat162float(__float2bfloat16(g.scale));
  const size_t col0 = (size_t)h * hd;
  for (int m0 = 0; m0 < N; m0 += 16) {
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
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
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
    softmax_tile<!Policy::kRoundQ>(s, m0, sbias, bs, N, g.scale, lane);

    float o[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
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
    softmax_tile<false>(s[u], 16 * u, sbias, bs, N, g.scale, lane);
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
int launch(Operands<T> op, const Policy& pol, Geometry g, int warps, cudaStream_t stream) {
  if (warps < 1 || warps > kMaxWarps || g.run < 1 || g.types < 1 || g.B_ % g.types)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  g.vec = aligned(op.q) && aligned(op.k) && aligned(op.v) &&
          (g.ld_in * sizeof(T)) % 16 == 0 && (g.hd * sizeof(T)) % 16 == 0;
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

}  // namespace wtile
