// The block-fused kernels' attention halves on the large-window tile
// (window_attention_tile.cuh: 64 < N <= 256 tokens, Swin at W=14), the
// N = 196 range of esvit_tpu/ops/fused_block.py _fwd_kernel / _bwd_kernel's
// attention. Their launches for the fused block's policy are instantiated
// in sources of their own, one nvcc each (ops/cuda_build.py compiles every
// csrc/fused_block_*.cu beside fused_block.cu and links them into one
// library): here A2's backward tile in fp32.

#include "fused_block_attention.cuh"

template int wtile::launch_bwd_large<float, FusedBlockBias>(
    wtile::BwdOperands<float>, const FusedBlockBias&, const wtile::Geometry&, int,
    cudaStream_t);
