"""Forward-only window attention over the qkv layout: the CUDA kernel and
its plain twin.

Replaces esvit_tpu/ops/pallas_window_attention.py ``_attention_kernel``
(via ``fused_window_attention``) with ``csrc/pallas_window_attention.cu``,
the tile kernels of ``csrc/window_attention_tile.cuh`` (bf16 on the
tensor cores, fp32 as register-tiled FMAs; windows of 64 < N <= 256, Swin
at W=14, on the large-window tile) reading q, k and v straight out of the
``(B_, N, 3C)`` qkv rows, launched as :func:`window_attention.tile_plan`
says. The sources note what bounds it on Hopper.

Layouts are the JAX ones: qkv ``(B_, N, 3C)`` (windows batch-major, window
type minor), bias ``(nWm, nH, N, N)`` fp32 with the shift mask (-100)
already added in, window b using bias ``b % nWm``; the output is
``(B_, N, C)``. Its roundings are the TPU kernel's, not the packed pair's
(ops/window_attention.py): q is upcast before the fp32 scale, the
probabilities stay fp32 through P·V, and the output is cast once.

There is no backward kernel, as there is none on the TPU: the backward
recomputes :func:`pallas_window_attention_plain` under autograd, as JAX's
custom_vjp does (``_bwd``). :func:`fused_window_attention` launches the
kernel for CUDA tensors and uses the plain version only for tensors on the
CPU. ``launches["fwd"]`` counts kernel launches, one per forward call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from esvit_tpu_torch.ops import cuda_build
from esvit_tpu_torch.ops.window_attention import (_LARGE_MAX_N, _SMALL_MAX_N,
                                                  _sm_count, large_tile_fits,
                                                  tile_plan)

launches = {"fwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supports(N: int, C: int, nH: int) -> bool:
    """Whether the kernel takes a window of N tokens at width C with nH
    heads, by shape alone: a head dim of 1..64 and N <= 64 (the small
    tile), or 64 < N <= 256 where the large tile's block fits the card
    (every head dim up to 64 at Swin's N = 196)."""
    if not (nH > 0 and C % nH == 0 and 0 < C // nH <= 64 and N > 0):
        return False
    if N <= _SMALL_MAX_N:
        return True
    return N <= _LARGE_MAX_N and large_tile_fits(N, C // nH, backward=False)


def pallas_window_attention_plain(qkv, bias, num_heads: int,
                                  scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, JAX's ``_reference_attention``
    with its roundings: fp32 scores of the upcast q times the scale, one
    fp32 softmax per row, fp32 P·V, one cast to the input dtype."""
    B_, N, C3 = qkv.shape
    C = C3 // 3
    nH = num_heads
    hd = C // nH
    q, k, v = qkv.reshape(B_, N, 3, nH, hd).unbind(2)
    attn = torch.einsum("bnhd,bmhd->bhnm", q.float() * scale, k.float())
    nWm = bias.shape[0]
    attn = (attn.reshape(B_ // nWm, nWm, nH, N, N)
            + bias.float()[None]).reshape(B_, nH, N, N)
    probs = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v.float())
    return out.reshape(B_, N, C).to(qkv.dtype)


def fused_window_attention(qkv, bias, num_heads: int,
                           scale: float) -> torch.Tensor:
    """qkv (B_, N, 3C), bias (nWm, nH, N, N) fp32 -> (B_, N, C),
    differentiable in qkv and bias. nWm must divide B_."""
    if qkv.device.type == "cpu":
        return pallas_window_attention_plain(qkv, bias, num_heads, scale)
    return _PallasWindowAttention.apply(qkv, bias, num_heads, scale)


def _check(qkv, bias, nH):
    dev = qkv.device
    if dev.type != "cuda":
        raise ValueError(f"pallas_window_attention kernel needs CUDA tensors, "
                         f"got {dev}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv dtype {qkv.dtype} not in {list(_DTYPES)}")
    if qkv.dim() != 3 or qkv.shape[2] % 3 or not qkv.is_contiguous():
        raise ValueError(f"qkv must be contiguous (B_, N, 3C), got "
                         f"{tuple(qkv.shape)}")
    B_, N, C3 = qkv.shape
    if not supports(N, C3 // 3, nH):
        raise ValueError(f"unsupported shape N={N} C={C3 // 3} nH={nH} "
                         "(N <= 256 and head dim <= 64)")
    nWm = bias.shape[0] if bias.dim() == 4 else 0
    if (bias.dtype != torch.float32 or bias.dim() != 4
            or tuple(bias.shape[1:]) != (nH, N, N) or not bias.is_contiguous()
            or bias.device != dev or B_ % nWm):
        raise ValueError(f"bias must be contiguous fp32 (nWm, {nH}, {N}, {N}) "
                         f"on {dev} with nWm dividing {B_}, got {bias.dtype} "
                         f"{tuple(bias.shape)}")


def _fwd(qkv, bias, nH, scale):
    _check(qkv, bias, nH)
    lib = _lib()
    B_, N, C3 = qkv.shape
    C, nWm = C3 // 3, bias.shape[0]
    out = torch.empty((B_, N, C), dtype=qkv.dtype, device=qkv.device)
    plan = tile_plan(B_, N, C // nH, nH, nWm, qkv.element_size(),
                     _sm_count(qkv.device.index))
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.esvit_pallas_window_attention_fwd(
            ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(bias.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), B_, N, C, nH, nWm,
            ctypes.c_float(scale), _DTYPES[qkv.dtype], plan.warps, plan.run,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"pallas_window_attention kernel failed: CUDA error {rc}")
    launches["fwd"] += 1
    return out


@functools.cache
def _lib():
    """The loaded kernel, with the argtypes/restype of its C entry point
    declared (pointers as void*, so ctypes never truncates them)."""
    lib = cuda_build.load("pallas_window_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.esvit_pallas_window_attention_fwd.argtypes = [P] * 3 + [I] * 5 + [F] + [I] * 3 + [P]
    lib.esvit_pallas_window_attention_fwd.restype = I
    return lib


class _PallasWindowAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, qkv, bias, nH, scale):
        ctx.save_for_backward(qkv, bias)
        ctx.geometry = (nH, scale)
        return _fwd(qkv, bias, nH, scale)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        nH, scale = ctx.geometry
        with torch.enable_grad():
            q = qkv.detach().requires_grad_()
            b = bias.detach().requires_grad_()
            out = pallas_window_attention_plain(q, b, nH, scale)
            dqkv, dbias = torch.autograd.grad(out, (q, b), g)
        return dqkv, dbias, None, None
