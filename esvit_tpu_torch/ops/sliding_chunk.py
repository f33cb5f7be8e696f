"""Mode-0 2-D sliding-chunk attention: the CUDA kernel pair and its plain
twin.

Replaces esvit_tpu/ops/sliding_chunk_fused.py ``_fwd_kernel`` and
``_bwd_kernel`` (via ``sliding_chunk_attention``) with
``csrc/sliding_chunk.cu``: one thread block per (bh, query chunk) in the
forward, which stages only the real neighbour chunks and the global rows;
in the backward one kernel per query chunk (r, dq and the globals'
partials), one per key chunk (dk and dv, gathered from the query chunks
that see it) and a fixed-order sum of the partials, so every gradient is
deterministic. The source notes what bounds the kernels on Hopper.

Layouts are the JAX function's: q (pre-scaled), k, v ``(BH, nx, ny, M)``
token grids; k_glo, v_glo ``(BH, nglo, M)`` global keys and values
(nglo may be 0). Each query of W x W chunk (ci, cj) attends to the real
tokens of the in-grid chunks around it (3 x 3) and to the global keys, in
one fp32 softmax (layers/longformer2d.py:194-301 with mode 0, exact 0, no
RPE).

:func:`sliding_chunk_attention` launches the kernels for CUDA tensors and
uses :func:`sliding_chunk_attention_plain` only for tensors on the CPU.
``launches`` counts one per forward call and one per backward call.

The plain twin is the stacked-neighbourhood form of Vision Longformer's
local attention (a port of esvit_tpu/ops/slidingchunk.py, mode 0; ref
layers/slidingchunk_2d.py): each query chunk attends to its 3x3 chunk
neighbourhood, gathered as 9 rolled copies of the chunked keys in the
reference's concat order (-1,-1), (-1,0), ..., (1,1). Rolling wraps at the
grid's edges; :func:`invalid_mask_zero` (blockwise zero padding,
``exact=0``) then masks the wrapped chunks and the spatially padded
positions, so the valid keys are exactly the in-grid neighbours' real
tokens. Other modes and ``exact=+-1`` are not ported (ROADMAP queue 1
item 9b).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from esvit_tpu_torch.ops import cuda_build
from esvit_tpu_torch.ops.window import device_table

launches = {"fwd": 0, "bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GLO = 8


def supports(W: int, M: int, nglo: int, *, mode: int = 0, exact: int = 0,
             rpe: bool = False, add_pooled: bool = False,
             only_glo: bool = False, attn_dropping: bool = False) -> bool:
    """Whether the kernel pair computes this attention: the canonical EsViT
    ViL configuration (esvit_tpu sliding_chunk_fused.supports) at a shape
    its tiles take: W^2 <= 64, head dim a multiple of 8 up to 64, at most
    8 global keys. Shapes alone decide, never the device or dtype."""
    return (mode == 0 and exact == 0 and not rpe and not add_pooled
            and not only_glo and not attn_dropping
            and 0 <= nglo <= _MAX_GLO and 0 < W * W <= 64
            and 0 < M <= 64 and M % 8 == 0)


def _to_chunks(t, W, padx, pady):
    """(BH, nx, ny, M) -> (BH, M, mx, my, W2), zero-padded."""
    BH, nx, ny, M = t.shape
    t = F.pad(t.permute(0, 3, 1, 2), (0, pady, 0, padx))
    mx, my = (nx + padx) // W, (ny + pady) // W
    return t.reshape(BH, M, mx, W, my, W).permute(0, 1, 2, 4, 3, 5).reshape(
        BH, M, mx, my, W * W)


# Roll shifts applied to k/v, in the reference's concat order
# (slidingchunk_2d.py:34-76): shift (1, 1) brings neighbour (-1, -1).
_ALL_SHIFTS = [(1, 1), (1, 0), (1, -1), (0, 1), (0, 0), (0, -1),
               (-1, 1), (-1, 0), (-1, -1)]


def _stack_neighbors(t: torch.Tensor) -> torch.Tensor:
    """(BH, M, mx, my, W2) -> (BH, M, 9, mx, my, W2) of rolled copies."""
    return torch.stack(
        [torch.roll(t, s, dims=(2, 3)) if s != (0, 0) else t
         for s in _ALL_SHIFTS], dim=2)


def slidingchunk_qk(q_img: torch.Tensor, k_img: torch.Tensor) -> torch.Tensor:
    """(BH,M,mx,my,W2) x2 -> attn (BH,mx,my,W2,9*W2) in fp32."""
    kn = _stack_neighbors(k_img)
    attn = torch.einsum("bcmnl,bcjmnt->bmnljt", q_img.float(), kn.float())
    return attn.reshape(*attn.shape[:4], -1)


def slidingchunk_av(attn: torch.Tensor, v_img: torch.Tensor) -> torch.Tensor:
    """attn (BH,mx,my,W2,9*W2) x v (BH,M,mx,my,W2) -> (BH,M,mx,my,W2),
    summed in fp32."""
    BH, mx, my, W2, _ = attn.shape
    a = attn.reshape(BH, mx, my, W2, 9, W2)
    vn = _stack_neighbors(v_img)
    return torch.einsum("bmnljt,bcjmnt->bcmnl", a.float(), vn.float())


@functools.lru_cache(maxsize=None)
def invalid_mask_zero(nx: int, ny: int, padx: int, pady: int, w: int
                      ) -> np.ndarray:
    """(nx*ny, 9w^2) bool over nx x ny chunks: out-of-grid neighbours and
    spatially padded positions (ref slidingchunk_2d.py:267-287)."""
    w2 = w * w
    i = np.arange(nx * ny)[:, None]
    j = np.arange(9 * w2)[None]
    gx = i // ny + (j // w2) // 3 - 1          # absolute key chunk row
    gy = i % ny + (j // w2) % 3 - 1
    tx, ty = (j % w2) // w, (j % w2) % w       # key within its chunk
    bad_x = (gx < 0) | (gx >= nx) | (gx * w + tx >= nx * w - padx)
    bad_y = (gy < 0) | (gy >= ny) | (gy * w + ty >= ny * w - pady)
    return bad_x | bad_y


def apply_invalid_mask(attn: torch.Tensor, nx: int, ny: int, padx: int,
                       pady: int, w: int) -> torch.Tensor:
    """-inf where :func:`invalid_mask_zero` is set; attn (BH, nx, ny, W2,
    9*W2) over nx x ny chunks."""
    mask = device_table(invalid_mask_zero, (nx, ny, padx, pady, w),
                        attn.device).reshape(1, nx, ny, 1, -1)
    return attn.masked_fill(mask, float("-inf"))


def sliding_chunk_attention_plain(q, k, v, k_glo, v_glo, *, nx: int, ny: int,
                                  W: int) -> torch.Tensor:
    """The kernels' function in plain PyTorch (the stacked-neighbourhood
    einsums above, autograd), with the same roundings:
    fp32 scores and softmax over [global | neighbourhood], probabilities
    rounded to the input dtype, both value products summed in fp32 and
    rounded once."""
    dtype = q.dtype
    BH, _, _, M = q.shape
    nglo = k_glo.shape[1]
    padx, pady = (W - nx % W) % W, (W - ny % W) % W
    mx, my = (nx + padx) // W, (ny + pady) // W
    qc, kc, vc = (_to_chunks(t, W, padx, pady) for t in (q, k, v))
    local = apply_invalid_mask(slidingchunk_qk(qc, kc), mx, my, padx, pady,
                               W)
    glo = torch.einsum("bcmnl,btc->bmnlt", qc.float(), k_glo.float())
    probs = torch.softmax(torch.cat([glo, local], dim=-1), dim=-1).to(dtype)
    out = slidingchunk_av(probs[..., nglo:], vc) + torch.einsum(
        "bmnlt,btc->bcmnl", probs[..., :nglo].float(), v_glo.float())
    out = out.reshape(BH, M, mx, my, W, W).permute(0, 2, 4, 3, 5, 1)
    return out.reshape(BH, mx * W, my * W, M)[:, :nx, :ny].to(dtype)


def sliding_chunk_attention(q, k, v, k_glo, v_glo, *, nx: int, ny: int,
                            W: int) -> torch.Tensor:
    """Sliding-chunk attention, differentiable in all five tensors."""
    if q.device.type == "cpu":
        return sliding_chunk_attention_plain(q, k, v, k_glo, v_glo, nx=nx,
                                             ny=ny, W=W)
    return _SlidingChunk.apply(q, k, v, k_glo, v_glo, nx, ny, W)


def _check(q, k, v, k_glo, v_glo, nx, ny, W):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"sliding_chunk kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    BH, M = q.shape[0], q.shape[-1]
    nglo = k_glo.shape[1]
    if q.ndim != 4 or tuple(q.shape[1:3]) != (nx, ny):
        raise ValueError(f"q {tuple(q.shape)} is not (BH, {nx}, {ny}, M)")
    if not supports(W, M, nglo):
        raise ValueError(f"unsupported shape W={W} M={M} nglo={nglo} "
                         "(W^2 <= 64, M a multiple of 8 up to 64, nglo <= 8)")
    for name, t, shape in (("k", k, q.shape), ("v", v, q.shape),
                           ("k_glo", k_glo, (BH, nglo, M)),
                           ("v_glo", v_glo, (BH, nglo, M))):
        if tuple(t.shape) != tuple(shape) or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} "
                             f"does not match {tuple(shape)} {q.dtype} {dev}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v, k_glo, v_glo)):
        raise ValueError("q, k, v, k_glo, v_glo must be contiguous and "
                         "16-byte aligned (the kernels load 16 bytes at once)")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t.numel() else 0)


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"sliding_chunk {what} kernel failed: CUDA error {rc}")


def _fwd(q, k, v, k_glo, v_glo, nx, ny, W):
    """(out, stats): stats (BH, nx, ny, 2) fp32 holds each row's softmax
    max and 1/sum, which the backward rebuilds p from."""
    _check(q, k, v, k_glo, v_glo, nx, ny, W)
    lib = _lib()
    BH, M = q.shape[0], q.shape[-1]
    out = torch.empty_like(q)
    stats = torch.empty((BH, nx, ny, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.esvit_sliding_chunk_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(k_glo), _ptr(v_glo), _ptr(out),
            _ptr(stats), BH, nx, ny, W, M, k_glo.shape[1], _DTYPES[q.dtype],
            ctypes.c_void_p(stream))
    _raise_on(rc, "forward")
    launches["fwd"] += 1
    return out, stats


def _bwd(q, k, v, k_glo, v_glo, stats, do, nx, ny, W):
    _check(q, k, v, k_glo, v_glo, nx, ny, W)
    if (do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous()
            or do.data_ptr() % 16):
        raise ValueError("the output gradient must match q and be "
                         "contiguous and 16-byte aligned")
    lib = _lib()
    BH, M = q.shape[0], q.shape[-1]
    nglo = k_glo.shape[1]
    chunks = -(-nx // W) * -(-ny // W)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dkg, dvg = torch.empty_like(k_glo), torch.empty_like(v_glo)
    rsum = torch.empty((BH, nx, ny), dtype=torch.float32, device=q.device)
    partial = torch.empty((2, BH, chunks, nglo, M), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.esvit_sliding_chunk_bwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(k_glo), _ptr(v_glo), _ptr(do),
            _ptr(stats), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dkg), _ptr(dvg),
            _ptr(rsum), _ptr(partial), BH, nx, ny, W, M, nglo,
            _DTYPES[q.dtype], ctypes.c_void_p(stream))
    _raise_on(rc, "backward")
    launches["bwd"] += 1
    return dq, dk, dv, dkg, dvg


@functools.cache
def _lib():
    """The loaded kernels, with the argtypes/restype of the C entry points
    declared (pointers as void*, so ctypes never truncates them)."""
    lib = cuda_build.load("sliding_chunk")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.esvit_sliding_chunk_fwd.argtypes = [P] * 7 + [I] * 7 + [P]
    lib.esvit_sliding_chunk_fwd.restype = I
    lib.esvit_sliding_chunk_bwd.argtypes = [P] * 14 + [I] * 7 + [P]
    lib.esvit_sliding_chunk_bwd.restype = I
    lib.esvit_sliding_chunk_smem_bytes.argtypes = [I, I, I]
    lib.esvit_sliding_chunk_smem_bytes.restype = ctypes.c_size_t
    return lib


class _SlidingChunk(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, k_glo, v_glo, nx, ny, W):
        out, stats = _fwd(q, k, v, k_glo, v_glo, nx, ny, W)
        ctx.save_for_backward(q, k, v, k_glo, v_glo, stats)
        ctx.geometry = (nx, ny, W)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, k_glo, v_glo, stats = ctx.saved_tensors
        do = g.to(q.dtype).contiguous()
        grads = _bwd(q, k, v, k_glo, v_glo, stats, do, *ctx.geometry)
        return (*grads, None, None, None)
