"""Windowed multi-head attention: the CUDA kernel pair and its plain twin.

Replaces esvit_tpu/ops/packed_window_attention.py ``_fwd_kernel`` and
``_bwd_kernel`` (via ``packed_window_attention``) with
``csrc/window_attention.cu``: one thread block per (window, head) in the
forward; in the backward one block per (head, run of windows), whose
dbias partials a second kernel sums in a fixed order, so dbias is
deterministic. The source notes what bounds the kernels on Hopper.

Layouts are the JAX ones: q2/k2/v2 ``(B_*N, C)`` window-major rows
(windows batch-major, window type minor), bias ``(nH, N, N)`` fp32,
region ``(nW, N)`` int32 shift-region ids or None (unshifted).

:func:`window_attention` launches the kernels for CUDA tensors and uses
:func:`window_attention_plain` only for tensors on the CPU. ``launches``
counts kernel launches: one per forward call, one per backward call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from esvit_tpu_torch.ops import cuda_build

launches = {"fwd": 0, "bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Backward blocks each own one head and `run` windows; about this many
# blocks per call keep the card's 132 SMs busy.
_TARGET_BWD_BLOCKS = 1024


def window_attention_plain(q2, k2, v2, bias, region, N: int, nH: int,
                           scale: float, return_probs: bool = False):
    """The kernels' function in plain PyTorch (einsum, fp32 softmax,
    autograd), with the same roundings: q*scale and the probabilities are
    rounded to the input dtype, products accumulate in fp32.

    bias is the (nH, N, N) table, shifted by ``region``'s -100 mask when
    that is given, or a dense (nWm, nH, N, N) bias that already holds the
    mask (``region`` None). With ``return_probs`` also returns the fp32
    probabilities (B_, nH, N, N)."""
    dtype = q2.dtype
    C = q2.shape[-1]
    B_ = q2.shape[0] // N
    hd = C // nH
    q = q2.reshape(B_, N, nH, hd)
    k = k2.reshape(B_, N, nH, hd)
    v = v2.reshape(B_, N, nH, hd)
    qs = q * torch.tensor(scale, dtype=dtype)
    attn = torch.einsum("bnhd,bmhd->bhnm", qs.float(), k.float())
    full = bias.float() if bias.dim() == 4 else bias.float()[None]
    if region is not None:
        differ = region[:, :, None] != region[:, None, :]       # (nW, N, N)
        full = full + torch.where(differ, -100.0, 0.0)[:, None]
    nWm = full.shape[0]
    attn = (attn.reshape(B_ // nWm, nWm, nH, N, N) + full).reshape(B_, nH, N, N)
    probs = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.to(dtype).float(), v.float())
    out = out.to(dtype).reshape(B_ * N, C)
    return (out, probs) if return_probs else out


def window_attention(q2, k2, v2, bias, region, N: int, nH: int,
                     scale: float) -> torch.Tensor:
    """Windowed attention, differentiable in q2, k2, v2 and bias."""
    if q2.device.type == "cpu":
        return window_attention_plain(q2, k2, v2, bias, region, N, nH, scale)
    return _WindowAttention.apply(q2, k2, v2, bias, region, N, nH, scale)


def _check(q2, k2, v2, bias, region, N, nH):
    dev = q2.device
    if dev.type != "cuda":
        raise ValueError(f"window_attention kernel needs CUDA tensors, got {dev}")
    if q2.dtype not in _DTYPES:
        raise TypeError(f"q2 dtype {q2.dtype} not in {list(_DTYPES)}")
    rows, C = q2.shape
    for name, t in (("k2", k2), ("v2", v2)):
        if t.shape != q2.shape or t.dtype != q2.dtype or t.device != dev:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does "
                             f"not match q2 {tuple(q2.shape)} {q2.dtype} {dev}")
    if not (q2.is_contiguous() and k2.is_contiguous() and v2.is_contiguous()):
        raise ValueError("q2, k2, v2 must be contiguous")
    if rows % N or C % nH or not 0 < N <= 64 or C // nH > 64:
        raise ValueError(f"unsupported shape rows={rows} C={C} N={N} nH={nH} "
                         "(N <= 64 and head dim <= 64)")
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (nH, N, N)
            or not bias.is_contiguous() or bias.device != dev):
        raise ValueError(f"bias must be contiguous fp32 ({nH}, {N}, {N}) on "
                         f"{dev}, got {bias.dtype} {tuple(bias.shape)}")
    if region is not None:
        nW = region.shape[0]
        if (region.dtype != torch.int32 or tuple(region.shape) != (nW, N)
                or not region.is_contiguous() or region.device != dev
                or (rows // N) % nW):
            raise ValueError(f"region must be contiguous int32 (nW, {N}) on "
                             f"{dev} with nW dividing the window count")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"window_attention {what} kernel failed: CUDA error {rc}")


def _fwd(q2, k2, v2, bias, region, N, nH, scale):
    _check(q2, k2, v2, bias, region, N, nH)
    lib = _lib()
    out = torch.empty_like(q2)
    rows, C = q2.shape
    nW = region.shape[0] if region is not None else 1
    with torch.cuda.device(q2.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.esvit_window_attention_fwd(
            _ptr(q2), _ptr(k2), _ptr(v2), _ptr(bias), _ptr(region), _ptr(out),
            rows // N, N, C, nH, nW, ctypes.c_float(scale), _DTYPES[q2.dtype],
            ctypes.c_void_p(stream))
    _raise_on(rc, "forward")
    launches["fwd"] += 1
    return out


def _bwd(q2, k2, v2, bias, region, do, N, nH, scale):
    _check(q2, k2, v2, bias, region, N, nH)
    if do.shape != q2.shape or do.dtype != q2.dtype or not do.is_contiguous():
        raise ValueError("the output gradient must match q2 and be contiguous")
    lib = _lib()
    rows, C = q2.shape
    B_ = rows // N
    nW = region.shape[0] if region is not None else 1
    run = max(1, B_ * nH // _TARGET_BWD_BLOCKS)
    chunks = -(-B_ // run)
    dq, dk, dv = torch.empty_like(q2), torch.empty_like(k2), torch.empty_like(v2)
    partial = torch.empty((nH, chunks, N, N), dtype=torch.float32,
                          device=q2.device)
    dbias = torch.empty((nH, N, N), dtype=torch.float32, device=q2.device)
    with torch.cuda.device(q2.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.esvit_window_attention_bwd(
            _ptr(q2), _ptr(k2), _ptr(v2), _ptr(bias), _ptr(region), _ptr(do),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(partial), _ptr(dbias),
            B_, N, C, nH, nW, ctypes.c_float(scale), _DTYPES[q2.dtype], run,
            ctypes.c_void_p(stream))
    _raise_on(rc, "backward")
    launches["bwd"] += 1
    return dq, dk, dv, dbias


@functools.cache
def _lib():
    """The loaded kernels, with the argtypes/restype of the C entry points
    declared (pointers as void*, so ctypes never truncates them)."""
    lib = cuda_build.load("window_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.esvit_window_attention_fwd.argtypes = [P] * 6 + [I] * 5 + [F, I, P]
    lib.esvit_window_attention_fwd.restype = I
    lib.esvit_window_attention_bwd.argtypes = [P] * 11 + [I] * 5 + [F, I, I, P]
    lib.esvit_window_attention_bwd.restype = I
    return lib


class _WindowAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q2, k2, v2, bias, region, N, nH, scale):
        ctx.save_for_backward(q2, k2, v2, bias, region)
        ctx.geometry = (N, nH, scale)
        return _fwd(q2, k2, v2, bias, region, N, nH, scale)

    @staticmethod
    def backward(ctx, g):
        q2, k2, v2, bias, region = ctx.saved_tensors
        N, nH, scale = ctx.geometry
        do = g.to(q2.dtype).contiguous()
        dq, dk, dv, dbias = _bwd(q2, k2, v2, bias, region, do, N, nH, scale)
        return dq, dk, dv, dbias, None, None, None, None

