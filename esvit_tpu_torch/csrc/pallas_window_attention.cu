// Forward-only windowed multi-head attention over the (B_, N, 3C) qkv layout,
// sm_90a.
//
// Replaces the Pallas TPU kernel of esvit_tpu/ops/pallas_window_attention.py:
// _attention_kernel (launched by _forward, via fused_window_attention). The
// TPU kernel has no backward: its custom_vjp differentiates the plain
// reference, and so does the wrapper (ops/pallas_window_attention.py).
//
// Per window w (batch-major, window type w % nWm) and head h, with N tokens
// and head dim hd, q/k/v read straight out of the qkv rows
// (q at column h*hd, k at C + h*hd, v at 2C + h*hd):
//   q = float(q_in) * scale           (upcast first, then scaled in fp32)
//   s = q . float(k)^T (fp32) + bias[w % nWm, h]
//   p = softmax(s) in fp32, one max per (window, head) row, e / sum
//   o = p . float(v) in fp32, one cast to the input dtype
// The bias is the dense (nWm, nH, N, N) fp32 operand: the rel-pos table with
// the shift mask (-100) already added in. Nothing is rounded to the input
// dtype before the output; the packed kernel pair (window_attention.cu)
// rounds q*scale and p, and so is a different function in bf16.
//
// What bounds it on Hopper: at Swin's N=49, hd=32 a (window, head) pair is
// ~0.3 MFLOP on 19 KB of fp32 operands (9 KB bf16), read once from device
// memory. The evals run it in fp32, where the tensor cores do not apply
// without TF32 rounding, so the products run on the CUDA cores out of
// shared memory (stride hd+1 keeps the column reads free of bank
// conflicts). Each warp keeps one query row's probabilities in registers
// (lane j holds columns j and j+32) and forms that row's output by
// broadcasting p_j with a shuffle while lane d accumulates column d: the
// (N, N) scores never leave the registers. Several windows per block and
// mma tiles for bf16 are later work.
//
// The TPU-only machinery of the Pallas kernel (the XLA-side head
// split/transpose copy, block-diagonal window packing with the -1e9
// cross-window bias, the 8-row sublane block rule) has no counterpart here:
// one block owns one (window, head).
//
// C interface (bound with ctypes): pointers and the stream are void*; the
// entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int B_;      // windows
  int N;       // tokens per window (<= 64)
  int C;       // channels; qkv rows hold 3C, output rows C
  int nH;      // heads
  int hd;      // head dim, C / nH (<= 64)
  int nWm;     // bias window types; window w uses bias w % nWm
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Lane d accumulates o[d] += p_j * v[j, d] (and d + 32) over j in [j0, j1),
// p_j broadcast from lane j - j0 of the warp's register `p`.
__device__ __forceinline__ void accumulate_pv(float p, int j0, int j1, const float* sv,
                                              int ld, int hd, int lane, float& o0,
                                              float& o1) {
  for (int j = j0; j < j1; ++j) {
    const float pj = __shfl_sync(kFull, p, j - j0);
    if (lane < hd) o0 = fmaf(pj, sv[j * ld + lane], o0);
    if (lane + 32 < hd) o1 = fmaf(pj, sv[j * ld + lane + 32], o1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pallas_window_attention_fwd_kernel(const T* __restrict__ qkv,
                                   const float* __restrict__ bias,
                                   T* __restrict__ out, Geometry g) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, h = blockIdx.y;
  const int N = g.N, hd = g.hd, ld = hd + 1;
  float* sq = smem;
  float* sk = sq + (size_t)N * ld;
  float* sv = sk + (size_t)N * ld;

  const size_t row0 = (size_t)w * N;
  const size_t stride = 3 * (size_t)g.C;
  for (int e = threadIdx.x; e < N * hd; e += blockDim.x) {
    const int i = e / hd, d = e - i * hd;
    const T* r = qkv + (row0 + i) * stride + (size_t)h * hd + d;
    sq[i * ld + d] = to_f(r[0]) * g.scale;
    sk[i * ld + d] = to_f(r[g.C]);
    sv[i * ld + d] = to_f(r[2 * g.C]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* bias_h = bias + ((size_t)(w % g.nWm) * g.nH + h) * N * N;
  for (int i = warp; i < N; i += kWarps) {
    float s[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      float val = -INFINITY;
      if (j < N) {
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(sq[i * ld + d], sk[j * ld + d], acc);
        val = acc + bias_h[i * N + j];
      }
      s[t] = val;
    }
    const float m = warp_max(fmaxf(s[0], s[1]));
    float e[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) e[t] = (lane + 32 * t < N) ? expf(s[t] - m) : 0.f;
    const float sum = warp_sum(e[0] + e[1]);
    const float p0 = e[0] / sum, p1 = e[1] / sum;

    float o0 = 0.f, o1 = 0.f;
    accumulate_pv(p0, 0, min(N, 32), sv, ld, hd, lane, o0, o1);
    accumulate_pv(p1, 32, N, sv, ld, hd, lane, o0, o1);
    T* o = out + (row0 + i) * g.C + (size_t)h * hd;
    if (lane < hd) o[lane] = from_f<T>(o0);
    if (lane + 32 < hd) o[lane + 32] = from_f<T>(o1);
  }
}

size_t smem_bytes(int N, int hd) { return 3 * (size_t)N * (hd + 1) * sizeof(float); }

template <typename T>
int launch(const void* qkv, const float* bias, void* out, const Geometry& g,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(g.N, g.hd);
  auto kernel = pallas_window_attention_fwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(g.B_, g.nH);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv), bias,
                                           static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B_, N, 3C) and out (B_, N, C) in `dtype` (0 = float32, 1 = bfloat16);
// bias (nWm, nH, N, N) float32. All contiguous.
int esvit_pallas_window_attention_fwd(const void* qkv, const void* bias, void* out,
                                      int B_, int N, int C, int nH, int nWm,
                                      float scale, int dtype, void* stream) {
  Geometry g;
  g.B_ = B_;
  g.N = N;
  g.C = C;
  g.nH = nH;
  g.hd = C / nH;
  g.nWm = nWm;
  g.scale = scale;
  const auto* b = static_cast<const float*>(bias);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(qkv, b, out, g, s);
  return launch<float>(qkv, b, out, g, s);
}

}  // extern "C"
