// The packed window-attention pair's launches on the large-window tile
// (window_attention_tile.cuh: 64 < N <= 256 tokens, Swin at W=14), the
// N = 196 range of esvit_tpu/ops/packed_window_attention.py _fwd_kernel /
// _bwd_kernel. Instantiated in sources of their own, one nvcc each
// (ops/cuda_build.py compiles every csrc/window_attention_*.cu beside
// window_attention.cu and links them into one library; window_attention.cu
// declares them extern): here the backward tile in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "window_attention_tile.cuh"

template int wtile::launch_bwd_large<__nv_bfloat16, wtile::TableBias>(
    wtile::BwdOperands<__nv_bfloat16>, const wtile::TableBias&, const wtile::Geometry&, int,
    cudaStream_t);
