"""esvit_tpu_torch.utils.profile files each kernel of a traced step under
one group by its demangled name. The block-fused forward's token-tile
GEMMs (F1-F4: fused_block_fwd_tc_kernel, fused_block_fwd_f32_kernel) are
the fused block's, not cuBLAS's. Both passes' attention halves are the
window-attention tile kernels instantiated with the fused block's bias
policy (csrc/fused_block.cu FusedBlockBias): they belong to the fused
block, not to the window-attention kernels (rows 3 and 4). The
sliding-chunk pair's tensor-core kernels (csrc/sliding_chunk.cu tc::) and
the globals' reduce file under "sliding chunk". cuDNN's convolutions
(CvT's), a weight-gradient kernel and an implicit GEMM among them, file
under "convolutions", not under the fused block or cuBLAS."""

import pytest

from esvit_tpu_torch.utils.profile import _kernel_group
from tests.torch_threads import one_intra_op_thread  # noqa: F401

FUSED = "fused block (this repo's CUDA)"
WINDOW = "window attention (this repo's CUDA)"
SLIDING = "sliding chunk (this repo's CUDA)"
CONV = "convolutions (cuDNN)"


@pytest.mark.parametrize("name,group", [
    ("void wtile::window_attention_tile_kernel<__nv_bfloat16, "
     "(anonymous namespace)::FusedBlockBias>(wtile::Operands<__nv_bfloat16>, "
     "(anonymous namespace)::FusedBlockBias, wtile::Geometry)", FUSED),
    ("void wtile::window_attention_bwd_tile_kernel<float, "
     "(anonymous namespace)::FusedBlockBias>(wtile::BwdOperands<float>, "
     "(anonymous namespace)::FusedBlockBias, wtile::Geometry)", FUSED),
    ("void wtile::dbias_reduce_kernel<(anonymous namespace)::FusedBlockBias>"
     "(float const*, float*, int, int, int)", FUSED),
    ("void (anonymous namespace)::fused_bwd_t2_kernel<__nv_bfloat16>"
     "((anonymous namespace)::Table, (anonymous namespace)::Geo)", FUSED),
    ("(anonymous namespace)::wgrad_tc_kernel(__nv_bfloat16 const*, int)", FUSED),
    ("void cudnn::cnn::wgrad_alg0_engine<float, 128, 6, 7, 3, 3, 5, false, "
     "512>(int, int, int, float const*, int, float*, float const*, "
     "kernel_grad_params, unsigned long long, int, float, int, int, int, "
     "int)", CONV),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_execute_kernel__5x_cudnn", CONV),
    ("void (anonymous namespace)::fused_block_fwd_tc_kernel<96, 1>("
     "(anonymous namespace)::Table, (anonymous namespace)::Geo)", FUSED),
    ("void (anonymous namespace)::fused_block_fwd_tc_kernel<96, 3>("
     "(anonymous namespace)::Table, (anonymous namespace)::Geo)", FUSED),
    ("void (anonymous namespace)::fused_block_fwd_tc_kernel<64, 4>("
     "(anonymous namespace)::Table, (anonymous namespace)::Geo)", FUSED),
    ("void (anonymous namespace)::fused_block_fwd_f32_kernel<2>("
     "(anonymous namespace)::Table, (anonymous namespace)::Geo)", FUSED),
    ("void wtile::window_attention_bwd_tile_kernel<__nv_bfloat16, "
     "wtile::TableBias>(wtile::BwdOperands<__nv_bfloat16>, wtile::TableBias, "
     "wtile::Geometry)", WINDOW),
    ("void wtile::dbias_reduce_kernel<wtile::TableBias>(float const*, float*, "
     "int, int, int)", WINDOW),
    ("void wtile::window_attention_tile_kernel<float, (anonymous namespace)::"
     "DenseBias>(wtile::Operands<float>, (anonymous namespace)::DenseBias, "
     "wtile::Geometry)", WINDOW),
    ("void (anonymous namespace)::sliding_chunk_fwd_kernel<float>()",
     SLIDING),
    ("void (anonymous namespace)::tc::sliding_chunk_fwd_tc_kernel<3>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, "
     "(anonymous namespace)::Geo)", SLIDING),
    ("void (anonymous namespace)::tc::sliding_chunk_bwd_q_tc_kernel<2>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "float const*, __nv_bfloat16*, float*, float*, "
     "(anonymous namespace)::Geo)", SLIDING),
    ("void (anonymous namespace)::tc::sliding_chunk_bwd_k_tc_kernel<3>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, "
     "__nv_bfloat16*, (anonymous namespace)::Geo)", SLIDING),
    ("void (anonymous namespace)::glo_reduce_kernel<__nv_bfloat16>(float "
     "const*, __nv_bfloat16*, __nv_bfloat16*, int, int, int)", SLIDING),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "GEMM (cuBLAS)"),
])
def test_kernel_group(name, group):
    assert _kernel_group(name) == group
