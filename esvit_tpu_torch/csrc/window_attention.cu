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
// The backward runs on the tile machinery's backward (what bounds it, the
// two passes, the fp32 path): a group of four warps per (window, head),
// bf16 on the tensor cores with p and ds kept in mma fragments, fp32 as
// register-tiled FMAs.
//
// The TPU kernel's carry of dbias across its sequential grid has no
// counterpart here (blocks run in any order), and fp32 atomics would sum
// in a different order on every run. So each backward block owns one
// (head, window type) and a fixed run of windows, accumulates its ds in
// shared memory in a fixed element and warp order, and writes one (N, N)
// partial; a second kernel sums a head's partials in block order. dbias is
// bit-identical run to run.
//
// Windows of 64 < N <= 256 tokens (Swin at W=14: N = 196) run on the
// tile header's large-window tile with the same policy and roundings: a
// block of warps per run of windows of one (head, window type), the bias
// read per score from the table, one dbias partial per block in device
// memory, summed in block order as above. Its launches for this policy
// are instantiated in window_attention_large.cu (forward) and
// window_attention_large_bwd_{bf16,fp32}.cu (backward), which
// ops/cuda_build.py compiles beside this file; declared below so that this
// file does not instantiate them again.
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

extern template int wtile::launch_large<float, wtile::TableBias>(
    wtile::Operands<float>, const wtile::TableBias&, const wtile::Geometry&, int, cudaStream_t);
extern template int wtile::launch_large<__nv_bfloat16, wtile::TableBias>(
    wtile::Operands<__nv_bfloat16>, const wtile::TableBias&, const wtile::Geometry&, int,
    cudaStream_t);
extern template int wtile::launch_bwd_large<float, wtile::TableBias>(
    wtile::BwdOperands<float>, const wtile::TableBias&, const wtile::Geometry&, int,
    cudaStream_t);
extern template int wtile::launch_bwd_large<__nv_bfloat16, wtile::TableBias>(
    wtile::BwdOperands<__nv_bfloat16>, const wtile::TableBias&, const wtile::Geometry&, int,
    cudaStream_t);

namespace {

struct Geometry {
  int B_;      // windows
  int N;       // tokens per window (<= 64 the small tiles, <= 256 the large one)
  int C;       // channels (row stride of q/k/v/o)
  int nH;      // heads
  int hd;      // head dim, C / nH
  int nW;      // window types (rows of region); 1 when unshifted
  float scale;
};

using wtile::TableBias;

wtile::Geometry tile_geometry(const Geometry& g, int run) {
  wtile::Geometry tg{};
  tg.B_ = g.B_;
  tg.N = g.N;
  tg.hd = g.hd;
  tg.nH = g.nH;
  tg.types = g.nW;
  tg.ld_in = g.C;
  tg.ld_out = g.C;
  tg.ld_do = g.C;
  tg.ld_dx = g.C;
  tg.run = run;
  tg.scale = g.scale;
  return tg;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias,
               const int* region, void* out, const Geometry& g, int warps, int run,
               cudaStream_t stream) {
  const wtile::Operands<T> op{static_cast<const T*>(q), static_cast<const T*>(k),
                              static_cast<const T*>(v), static_cast<T*>(out)};
  return wtile::launch<T>(op, TableBias{bias, region}, tile_geometry(g, run), warps, stream);
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const float* bias,
               const int* region, const void* dout, void* dq, void* dk, void* dv,
               float* partial, float* dbias, const Geometry& g, int warps, int run,
               cudaStream_t stream) {
  const wtile::BwdOperands<T> op{
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), partial};
  return wtile::backward<T>(op, TableBias{bias, region}, tile_geometry(g, run), warps, dbias,
                            stream);
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
// window-attention forwards and of the fused block's attention halves;
// the large tile above N = 64), to hold ops/window_attention.py
// tile_smem_bytes to.
long long esvit_window_attention_tile_smem_bytes(int N, int hd, int itemsize, int warps) {
  if (itemsize == 2) return (long long)wtile::fwd_smem<__nv_bfloat16>(N, hd, warps);
  return (long long)wtile::fwd_smem<float>(N, hd, warps);
}

// Dynamic shared memory of a backward block of `warps` warps, to hold
// ops/window_attention.py tile_smem_bytes(..., backward=True) to.
long long esvit_window_attention_bwd_smem_bytes(int N, int hd, int itemsize, int warps) {
  if (itemsize == 2) return (long long)wtile::bwd_smem<__nv_bfloat16>(N, hd, warps);
  return (long long)wtile::bwd_smem<float>(N, hd, warps);
}

// partial: (nH, nW * chunks, N, N) fp32 scratch (wtile::backward says
// which chunks); dbias: (nH, N, N) fp32. `warps` and `run`:
// ops/window_attention.py tile_plan(..., backward=True).
int esvit_window_attention_bwd(const void* q, const void* k, const void* v,
                               const void* bias, const void* region, const void* dout,
                               void* dq, void* dk, void* dv, void* partial, void* dbias,
                               int B_, int N, int C, int nH, int nW, float scale,
                               int dtype, int warps, int run, void* stream) {
  const Geometry g = make_geometry(B_, N, C, nH, nW, scale);
  const auto* b = static_cast<const float*>(bias);
  const auto* r = static_cast<const int*>(region);
  auto* pp = static_cast<float*>(partial);
  auto* db = static_cast<float*>(dbias);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, b, r, dout, dq, dk, dv, pp, db, g, warps, run,
                                     s);
  return launch_bwd<float>(q, k, v, b, r, dout, dq, dk, dv, pp, db, g, warps, run, s);
}

}  // extern "C"
