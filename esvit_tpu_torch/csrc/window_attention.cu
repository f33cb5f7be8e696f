// Windowed multi-head attention for Swin, forward and backward, sm_90a.
//
// Replaces the Pallas TPU kernels of esvit_tpu/ops/packed_window_attention.py:
// _fwd_kernel (launched by _call, kind "fwd") and _bwd_kernel (kind "bwd"),
// reached through packed_window_attention.
//
// Per window w (batch-major, window type w % nW) and head h, with N tokens
// and head dim hd:
//   qs = round(q * round(scale))      (the input dtype, as the TPU kernel)
//   s  = qs . k^T (fp32) + bias[h] - 100 * [region_i != region_j]
//   p  = softmax(s) in fp32, one max per (window, head) row
//   o  = round(round(p) . v)           (fp32 accumulation)
// Backward recomputes s and p (flash-style, like the TPU kernel), then
//   dv = round(p)^T . do,  dp = do . v^T,  ds = p * (dp - rowsum(p * dp)),
//   dq = round(ds) . k * scale,  dk = round(ds)^T . qs,
//   dbias[h] = sum over windows of ds (fp32).
//
// The forward runs on the tile machinery of window_attention_tile.cuh (what
// bounds it, the layout, the fp32 and bf16 paths). This file's policy: the
// bf16 A operand is qs = bf16(q * bf16(scale)), formed from the staged q
// after ldmatrix; p is rounded to bf16 as P.V's A operand (the round(p)
// above); the output is rounded once; the bias slice of (window type, head)
// is the (nH, N, N) table plus -100 where the type's region ids differ,
// staged once per block.
//
// The backward runs on the CUDA cores: at Swin's N=49, hd=32 a (window, head) is
// ~0.15 MFLOP on 12 KB of bf16 operands, multiplied out of shared memory (stride hd+1 keeps the column reads free of bank
// conflicts), so it is bound by shared-memory bandwidth, not by HBM; each
// operand is read from device memory once and the (N, N) scores never
// leave the SM.
//
// The TPU kernel's carry of dbias across its sequential grid has no
// counterpart here (blocks run in any order), and fp32 atomics would sum
// in a different order on every run. So each backward block owns one head
// and a fixed run of windows, accumulates its ds in shared memory with a
// fixed thread-to-element map, and writes one (N, N) partial; a second
// kernel sums the partials in chunk order. dbias is bit-identical run to
// run.
//
// The TPU-only machinery of the Pallas kernel (zero-expanded head packing,
// block-diagonal window packing with the -1e9 cross-window mask, 0/1
// selector matmuls, iota masks, 8-row padding, TW/HG tiling) has no
// counterpart here.
//
// C interface (bound with ctypes): pointers and the stream are void*, every
// entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "window_attention_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int B_;      // windows
  int N;       // tokens per window (<= 64)
  int C;       // channels (row stride of q/k/v/o)
  int nH;      // heads
  int hd;      // head dim, C / nH
  int nW;      // window types (rows of region); 1 when unshifted
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an fp32 value to T and back: the casts to the input dtype.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared-memory layout shared by both kernels: operand tiles (N, hd) at
// stride hd+1, then (N, N) fp32 tiles, then the window's region ids.
__host__ __device__ inline size_t tile_floats(int N, int hd) {
  return (size_t)N * (hd + 1);
}

// Loads this (window, head)'s q (as qs), k, v and, if given, do into
// shared memory as fp32, and the window type's region ids.
template <typename T>
__device__ void load_window(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const int* __restrict__ region, const Geometry& g,
                            int w, int h, float qscale, float* sq, float* sk,
                            float* sv, float* sdo, int* sreg) {
  const int ld = g.hd + 1;
  const size_t row0 = (size_t)w * g.N;
  for (int e = threadIdx.x; e < g.N * g.hd; e += blockDim.x) {
    const int i = e / g.hd, d = e - i * g.hd;
    const size_t off = (row0 + i) * g.C + (size_t)h * g.hd + d;
    sq[i * ld + d] = round_to<T>(to_f(q[off]) * qscale);
    sk[i * ld + d] = to_f(k[off]);
    sv[i * ld + d] = to_f(v[off]);
    if (dout != nullptr) sdo[i * ld + d] = to_f(dout[off]);
  }
  if (region != nullptr) {
    const int* r = region + (size_t)(w % g.nW) * g.N;
    for (int j = threadIdx.x; j < g.N; j += blockDim.x) sreg[j] = r[j];
  }
}

// One warp computes row i of p = softmax(qs k^T + bias + mask) in fp32.
// Lane owns columns j = lane and lane + 32 (N <= 64).
__device__ void softmax_row(const float* sq, const float* sk, const float* bias_h,
                            const int* sreg, bool masked, const Geometry& g,
                            int i, int lane, float p[2]) {
  const int ld = g.hd + 1;
  float s[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = lane + 32 * t;
    float val = -INFINITY;
    if (j < g.N) {
      float acc = 0.f;
      for (int d = 0; d < g.hd; ++d) acc = fmaf(sq[i * ld + d], sk[j * ld + d], acc);
      val = acc + bias_h[i * g.N + j];
      if (masked && sreg[i] != sreg[j]) val += -100.f;
    }
    s[t] = val;
  }
  const float m = warp_max(fmaxf(s[0], s[1]));
  float e[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) e[t] = (lane + 32 * t < g.N) ? expf(s[t] - m) : 0.f;
  const float inv = 1.f / warp_sum(e[0] + e[1]);
  p[0] = e[0] * inv;
  p[1] = e[1] * inv;
}

// Block (chunk c, head h) runs windows [c*run, min((c+1)*run, B_)) and
// writes its (N, N) dbias partial to partial[h][c].
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ bias,
                            const int* __restrict__ region, const T* __restrict__ dout,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                            float* __restrict__ partial, Geometry g, int run) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, h = blockIdx.y;
  const int N = g.N, ld = g.hd + 1;
  float* sq = smem;
  float* sk = sq + tile_floats(N, g.hd);
  float* sv = sk + tile_floats(N, g.hd);
  float* sdo = sv + tile_floats(N, g.hd);
  float* sp = sdo + tile_floats(N, g.hd);   // p, then ds, of the current window
  float* sacc = sp + (size_t)N * N;         // this block's dbias partial
  int* sreg = reinterpret_cast<int*>(sacc + (size_t)N * N);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* bias_h = bias + (size_t)h * N * N;
  const float qscale = round_to<T>(g.scale);
  const bool masked = region != nullptr;

  for (int e = threadIdx.x; e < N * N; e += blockDim.x) sacc[e] = 0.f;

  const int w_end = min((c + 1) * run, g.B_);
  for (int w = c * run; w < w_end; ++w) {
    load_window<T>(q, k, v, dout, region, g, w, h, qscale, sq, sk, sv, sdo, sreg);
    __syncthreads();

    // p in fp32 (recomputed, as the TPU kernel does).
    for (int i = warp; i < N; i += kWarps) {
      float p[2];
      softmax_row(sq, sk, bias_h, sreg, masked, g, i, lane, p);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (j < N) sp[i * N + j] = p[t];
      }
    }
    __syncthreads();

    const size_t row0 = (size_t)w * N;
    const size_t col0 = (size_t)h * g.hd;
    // dv[j, d] = sum_i round(p[i, j]) * do[i, d]
    for (int e = threadIdx.x; e < N * g.hd; e += blockDim.x) {
      const int j = e / g.hd, d = e - j * g.hd;
      float acc = 0.f;
      for (int i = 0; i < N; ++i)
        acc = fmaf(round_to<T>(sp[i * N + j]), sdo[i * ld + d], acc);
      dv[(row0 + j) * g.C + col0 + d] = from_f<T>(acc);
    }
    __syncthreads();

    // ds = p * (dp - rowsum(p * dp)), dp = do . v^T; overwrites p.
    for (int i = warp; i < N; i += kWarps) {
      float p[2], dp[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        p[t] = 0.f;
        dp[t] = 0.f;
        if (j < N) {
          float acc = 0.f;
          for (int d = 0; d < g.hd; ++d) acc = fmaf(sdo[i * ld + d], sv[j * ld + d], acc);
          dp[t] = acc;
          p[t] = sp[i * N + j];
        }
      }
      const float rs = warp_sum(p[0] * dp[0] + p[1] * dp[1]);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (j < N) {
          const float ds = p[t] * (dp[t] - rs);
          sp[i * N + j] = ds;
          sacc[i * N + j] += ds;
        }
      }
    }
    __syncthreads();

    // dq[i, d] = scale * sum_j round(ds[i, j]) k[j, d]
    // dk[j, d] = sum_i round(ds[i, j]) qs[i, d]
    for (int e = threadIdx.x; e < N * g.hd; e += blockDim.x) {
      const int r = e / g.hd, d = e - r * g.hd;
      float aq = 0.f, ak = 0.f;
      for (int t = 0; t < N; ++t) {
        aq = fmaf(round_to<T>(sp[r * N + t]), sk[t * ld + d], aq);
        ak = fmaf(round_to<T>(sp[t * N + r]), sq[t * ld + d], ak);
      }
      dq[(row0 + r) * g.C + col0 + d] = from_f<T>(aq * g.scale);
      dk[(row0 + r) * g.C + col0 + d] = from_f<T>(ak);
    }
    __syncthreads();
  }

  float* out = partial + ((size_t)h * gridDim.x + c) * N * N;
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) out[e] = sacc[e];
}

// dbias[h, e] = sum over chunks c (in order) of partial[h, c, e].
__global__ void dbias_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dbias, int nH, int chunks,
                                    int NN) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nH * NN) return;
  const int h = idx / NN, e = idx - h * NN;
  const float* p = partial + (size_t)h * chunks * NN + e;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += p[(size_t)c * NN];
  dbias[idx] = acc;
}

size_t bwd_smem_bytes(int N, int hd) {
  return (4 * tile_floats(N, hd) + 2 * (size_t)N * N) * sizeof(float) + N * sizeof(int);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The forward's policy (window_attention_tile.cuh): the packed kernel's
// roundings and the table + region-mask bias.
struct TableBias {
  static constexpr bool kRoundQ = true;
  static constexpr bool kSplitP = false;
  const float* table;  // (nH, N, N)
  const int* region;   // (types, N) or null

  __device__ void stage_bias(float* dst, int bs, const wtile::Geometry& g, int t, int h) const {
    wtile::stage_bias(dst, bs, table + (size_t)h * g.N * g.N,
                      region != nullptr ? region + (size_t)t * g.N : nullptr, g.N);
  }
};

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias,
               const int* region, void* out, const Geometry& g, int warps, int run,
               cudaStream_t stream) {
  const wtile::Operands<T> op{static_cast<const T*>(q), static_cast<const T*>(k),
                              static_cast<const T*>(v), static_cast<T*>(out)};
  wtile::Geometry tg{};
  tg.B_ = g.B_;
  tg.N = g.N;
  tg.hd = g.hd;
  tg.nH = g.nH;
  tg.types = g.nW;
  tg.ld_in = g.C;
  tg.ld_out = g.C;
  tg.run = run;
  tg.scale = g.scale;
  return wtile::launch<T>(op, TableBias{bias, region}, tg, warps, stream);
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const float* bias,
               const int* region, const void* dout, void* dq, void* dk, void* dv,
               float* partial, float* dbias, const Geometry& g, int run,
               cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(g.N, g.hd);
  auto kernel = window_attention_bwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (g.B_ + run - 1) / run;
  dim3 grid(chunks, g.nH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, region, static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), partial, g, run);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NN = g.N * g.N;
  const int total = g.nH * NN;
  dbias_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partial, dbias, g.nH,
                                                              chunks, NN);
  return (int)cudaGetLastError();
}

Geometry make_geometry(int B_, int N, int C, int nH, int nW, float scale) {
  Geometry g;
  g.B_ = B_;
  g.N = N;
  g.C = C;
  g.nH = nH;
  g.hd = C / nH;
  g.nW = nW;
  g.scale = scale;
  return g;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. region may be null (unshifted); nW is
// then 1. `warps` per block and `run` windows per warp:
// ops/window_attention.py tile_plan.
int esvit_window_attention_fwd(const void* q, const void* k, const void* v,
                               const void* bias, const void* region, void* out,
                               int B_, int N, int C, int nH, int nW, float scale,
                               int dtype, int warps, int run, void* stream) {
  const Geometry g = make_geometry(B_, N, C, nH, nW, scale);
  const auto* b = static_cast<const float*>(bias);
  const auto* r = static_cast<const int*>(region);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(q, k, v, b, r, out, g, warps, run, s);
  return launch_fwd<float>(q, k, v, b, r, out, g, warps, run, s);
}

// Dynamic shared memory of a forward block (the tile kernels of both
// window-attention forwards), to hold ops/window_attention.py
// tile_smem_bytes to.
long long esvit_window_attention_tile_smem_bytes(int N, int hd, int itemsize, int warps) {
  if (itemsize == 2) return (long long)wtile::smem_bytes<__nv_bfloat16>(N, hd, warps);
  return (long long)wtile::smem_bytes<float>(N, hd, warps);
}

// partial: (nH, ceil(B_/run), N, N) fp32 scratch; dbias: (nH, N, N) fp32.
int esvit_window_attention_bwd(const void* q, const void* k, const void* v,
                               const void* bias, const void* region, const void* dout,
                               void* dq, void* dk, void* dv, void* partial, void* dbias,
                               int B_, int N, int C, int nH, int nW, float scale,
                               int dtype, int run, void* stream) {
  const Geometry g = make_geometry(B_, N, C, nH, nW, scale);
  const auto* b = static_cast<const float*>(bias);
  const auto* r = static_cast<const int*>(region);
  auto* pp = static_cast<float*>(partial);
  auto* db = static_cast<float*>(dbias);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, b, r, dout, dq, dk, dv, pp, db, g, run, s);
  return launch_bwd<float>(q, k, v, b, r, dout, dq, dk, dv, pp, db, g, run, s);
}

}  // extern "C"
