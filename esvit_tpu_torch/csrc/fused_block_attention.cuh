// The block-fused kernels' attention halves (A1 of both passes, A2 of the
// backward) on the tiles of window_attention_tile.cuh: their bias policy,
// shared by fused_block.cu and fused_block_large.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "window_attention_tile.cuh"

// The window-attention kernel's policy (wtile::TableBias, the large-window
// tile included: N > 64, Swin at W=14), under a name of its own so that a
// profile files the tile kernels it instantiates (A1, A2 and their dbias
// sum) under the fused block and not under row 3 / 4
// (esvit_tpu_torch/utils/profile.py).
struct FusedBlockBias : wtile::TableBias {};

// The large-window tile's launches of this policy are instantiated in
// fused_block_large.cu (forward) and fused_block_large_bwd_{bf16,fp32}.cu
// (backward), which ops/cuda_build.py compiles beside fused_block.cu;
// declared here so that no other source instantiates them.
extern template int wtile::launch_large<float, FusedBlockBias>(
    wtile::Operands<float>, const FusedBlockBias&, const wtile::Geometry&, int, cudaStream_t);
extern template int wtile::launch_large<__nv_bfloat16, FusedBlockBias>(
    wtile::Operands<__nv_bfloat16>, const FusedBlockBias&, const wtile::Geometry&, int,
    cudaStream_t);
extern template int wtile::launch_bwd_large<float, FusedBlockBias>(
    wtile::BwdOperands<float>, const FusedBlockBias&, const wtile::Geometry&, int,
    cudaStream_t);
extern template int wtile::launch_bwd_large<__nv_bfloat16, FusedBlockBias>(
    wtile::BwdOperands<__nv_bfloat16>, const FusedBlockBias&, const wtile::Geometry&, int,
    cudaStream_t);
