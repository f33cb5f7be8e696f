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
//   s = (float(q) * scale) . float(k)^T (fp32) + bias[w % nWm, h]
//   p = softmax(s) in fp32, one max per (window, head) row, e / sum
//   o = p . float(v) in fp32, one cast to the input dtype
// The bias is the dense (nWm, nH, N, N) fp32 operand: the rel-pos table with
// the shift mask (-100) already added in. Nothing is rounded to the input
// dtype before the output; the packed forward (window_attention.cu) rounds
// q*scale and p, and so is a different function in bf16.
//
// The tiles, what bounds them and how they are laid out on Hopper:
// window_attention_tile.cuh. This file's policy:
//   - bf16 on the tensor cores: the mma takes the unscaled bf16 q and the
//     fp32 score is multiplied by `scale` after the product (it differs from
//     (q*scale).k only by fp32 rounding), and p is carried as
//     bf16(p) + bf16(p - bf16(p)) through two mmas, ~2^-17 relative, so the
//     result before the one cast to bf16 is within fp32 noise of the plain
//     version;
//   - fp32 on the CUDA cores, q scaled first as the plain version does;
//   - the bias slice of (window type, head) comes from the dense operand
//     (staged per block by the small tile, N <= 64; read from device
//     memory by the large tile, 64 < N <= 256: Swin at W=14).
//
// The TPU-only machinery of the Pallas kernel (the XLA-side head
// split/transpose copy, block-diagonal window packing with the -1e9
// cross-window bias, the 8-row sublane block rule) has no counterpart here.
//
// C interface (bound with ctypes): pointers and the stream are void*; the
// entry point returns cudaGetLastError() after its launch.

#include "window_attention_tile.cuh"

namespace {

struct DenseBias {
  static constexpr bool kRoundQ = false;
  static constexpr bool kSplitP = true;
  static constexpr bool kLarge = true;
  const float* bias;  // (nWm, nH, N, N)

  __device__ void stage_bias(float* dst, int bs, const wtile::Geometry& g, int t, int h) const {
    wtile::stage_bias(dst, bs, bias + ((size_t)t * g.nH + h) * g.N * g.N, nullptr, g.N);
  }

  // The large tile's bias of (t, h): the slice itself (the mask is in it).
  __device__ wtile::GlobalRows rows(const wtile::Geometry& g, int t, int h, int*) const {
    return wtile::GlobalRows{bias + ((size_t)t * g.nH + h) * g.N * g.N, nullptr, g.N};
  }
};

template <typename T>
int launch(const void* qkv, const float* bias, void* out, int B_, int N, int C, int nH,
           int nWm, float scale, int warps, int run, cudaStream_t stream) {
  const T* x = static_cast<const T*>(qkv);
  const wtile::Operands<T> op{x, x + C, x + 2 * C, static_cast<T*>(out)};
  wtile::Geometry g{};
  g.B_ = B_;
  g.N = N;
  g.hd = C / nH;
  g.nH = nH;
  g.types = nWm;
  g.ld_in = 3 * C;
  g.ld_out = C;
  g.run = run;
  g.scale = scale;
  return wtile::launch<T>(op, DenseBias{bias}, g, warps, stream);
}

}  // namespace

extern "C" {

// qkv (B_, N, 3C) and out (B_, N, C) in `dtype` (0 = float32, 1 = bfloat16);
// bias (nWm, nH, N, N) float32. All contiguous. `warps` per block and `run`
// windows per warp: ops/window_attention.py tile_plan.
int esvit_pallas_window_attention_fwd(const void* qkv, const void* bias, void* out,
                                      int B_, int N, int C, int nH, int nWm,
                                      float scale, int dtype, int warps, int run,
                                      void* stream) {
  const auto* b = static_cast<const float*>(bias);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qkv, b, out, B_, N, C, nH, nWm, scale, warps, run, s);
  return launch<float>(qkv, b, out, B_, N, C, nH, nWm, scale, warps, run, s);
}

}  // extern "C"
