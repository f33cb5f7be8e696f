"""The whole Swin block in one kernel: the CUDA pair and its plain twin.

Replaces esvit_tpu/ops/fused_block.py ``_fwd_kernel`` and ``_bwd_kernel``
(via ``fused_swin_block``) with ``csrc/fused_block.cu``: LN1 -> q/k/v ->
window attention (rel-pos bias, -100 shift mask, pad-row multiplier) ->
proj -> drop-path residual -> LN2 -> fc1 -> erf-GELU -> fc2 -> drop-path
residual, one thread block per window. The backward recomputes the
forward from the block input (the only tensor saved), writes dx and a
workspace of per-row operands, and a second kernel sums every weight
gradient over all rows in a fixed order: all 17 parameter gradients are
bit-identical run to run.

Layouts: x ``(B, nW*N, C)`` in the port's unpadded window-major order
(ops/window.py); ``params`` holds the reference's names and layouts
(g1, be1, wq, bq, wk, bk, wv, bv, bias ``(nH, N, N)`` fp32, wp, bp, g2, be2,
w1 ``(C, M)``, b1, w2 ``(M, C)``, b2; weights ``(in, out)``, fp32 masters
cast to x's dtype); keep1/keep2 ``(B,)`` fp32 per-image drop-path scales
in {0, 1/keep} or None; region ``(nW, N)`` int32 or None; pad an
``(nW*N,)`` fp32 row multiplier or None.

:func:`fused_swin_block` launches the kernels for CUDA tensors and uses
:func:`fused_swin_block_plain` only for tensors on the CPU. ``launches``
counts one per forward call and one per backward call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from esvit_tpu_torch.ops import cuda_build

launches = {"fwd": 0, "bwd": 0}

PARAM_NAMES = ("g1", "be1", "wq", "bq", "wk", "bk", "wv", "bv", "bias",
               "wp", "bp", "g2", "be2", "w1", "b1", "w2", "b2")
# The kernels' pointer table, in the order of the Ptr enum of the source.
_PTRS = ("X", "OUT", "G1", "BE1", "BQKV", "BP", "G2", "BE2", "B1", "B2",
         "BIAS", "PAD", "KEEP1", "KEEP2", "REGION",
         "WQKV_F", "WP_F", "W1_F", "W2_F", "WQKV_B", "WP_B", "W1_B", "W2_B",
         "DOUT", "DX", "DX32", "WS", "VPART", "BPART", "WPART", "TMP",
         "D_WQKV", "D_WP", "D_W1", "D_W2", "D_VEC", "D_BIAS")
# The weight copies each kernel reads: the backward recomputes the forward
# up to y2 (q/k/v, proj, fc1) and runs every product's transpose.
_FWD_WEIGHTS = ("WQKV_F", "WP_F", "W1_F", "W2_F")
_BWD_WEIGHTS = ("WQKV_F", "WP_F", "W1_F",
                "WQKV_B", "WP_B", "W1_B", "W2_B")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 384                  # kMaxC in the source
_MLP_CHUNK = 128              # kMc in the source
_SUM_GROUP = 64               # kGroup in the source
# Weight-gradient row chunks: about this many rows each, at most this many
# chunks, and partials of at most this many floats.
_CHUNK_ROWS = 256
_MAX_CHUNKS = 128
_MAX_PARTIAL = 1 << 24


def _ln(x, g, b, eps):
    """fp32 LayerNorm with the kernels' variance E[x^2] - mu^2."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return (xf - mu) * torch.rsqrt(var + eps) * g + b


def fused_swin_block_plain(x, params, keep1, keep2, *, N: int, nH: int,
                           nW: int, scale: float, region=None, pad=None,
                           eps: float = 1e-6) -> torch.Tensor:
    """The kernels' function in plain PyTorch with autograd, rounding to
    x's dtype where the TPU kernel does (fused_block.py:235-238, :416-419,
    :426, :440): bf16 operands with fp32 sums, the bias added in bf16,
    fp32 softmax and erf-GELU on the rounded h."""
    B, L, C = x.shape
    dt = x.dtype
    p = params
    hd = C // nH

    def mm(a, w):
        return torch.matmul(a.float(), w.to(dt).float())

    def proj(a, w, b):
        return mm(a, w).to(dt) + b.to(dt)

    def residual(x, o, keep):
        if keep is None:
            return x + o
        return x + (o.float() * keep[:, None, None]).to(dt)

    y = _ln(x, p["g1"], p["be1"], eps).to(dt)
    if pad is not None:
        y = y * pad.to(dt)[None, :, None]
    q, k, v = (proj(y, p[w], p[b]).reshape(B, nW, N, nH, hd)
               for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    qs = q * torch.tensor(scale, dtype=dt)
    s = torch.einsum("bwnhd,bwmhd->bwhnm", qs.float(), k.float())
    full = p["bias"].float()[None]                         # (1, nH, N, N)
    if region is not None:
        differ = region[:, :, None] != region[:, None, :]  # (nW, N, N)
        full = full + torch.where(differ, -100.0, 0.0)[:, None]
    probs = torch.softmax(s + full, dim=-1)
    a = torch.einsum("bwhnm,bwmhd->bwnhd", probs.to(dt).float(), v.float())
    a = a.to(dt).reshape(B, L, C)
    x2 = residual(x, proj(a, p["wp"], p["bp"]), keep1)
    y2 = _ln(x2, p["g2"], p["be2"], eps).to(dt)
    h = proj(y2, p["w1"], p["b1"]).float()
    g = (h * 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))).to(dt)
    return residual(x2, proj(g, p["w2"], p["b2"]), keep2)


def fused_swin_block(x, params, keep1, keep2, *, N: int, nH: int, nW: int,
                     scale: float, region=None, pad=None,
                     eps: float = 1e-6) -> torch.Tensor:
    """One Swin block; differentiable in x and every params entry."""
    if x.device.type == "cpu":
        return fused_swin_block_plain(x, params, keep1, keep2, N=N, nH=nH,
                                      nW=nW, scale=scale, region=region,
                                      pad=pad, eps=eps)
    ps = [params[n] for n in PARAM_NAMES]
    return _FusedBlock.apply(x, keep1, keep2, region, pad,
                             (N, nH, nW, scale, eps), *ps)


def supports(N: int, C: int, nH: int, M: int) -> bool:
    """Whether the kernels take this block shape, by shape alone (the same
    answer on every device): N <= 64, a head dim that is a multiple of 16
    and at most 64, C a multiple of 32 and at most 384, M of 128; and, so
    that an fp32 block fits the card's 227 KB of shared memory (bf16 needs
    less), two of the three bounds C <= 192, N <= 49, head dim <= 32.
    chip_smoke.py holds that rule against the kernels' own layout over
    every shape the other bounds admit."""
    if not 0 < N <= 64 or C % nH or C % 32 or C > _MAX_C or M % _MLP_CHUNK:
        return False
    hd = C // nH
    if hd % 16 or hd > 64:
        return False
    return (C <= 192) + (N <= 49) + (hd <= 32) >= 2


def _chunks(rows: int, C: int, M: int) -> int:
    cap = max(1, _MAX_PARTIAL // max(3 * C * C, C * M))
    return max(1, min(-(-rows // _CHUNK_ROWS), _MAX_CHUNKS, cap))


def _check(x, ps, keep1, keep2, region, pad, N, nH, nW):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_block kernel needs CUDA tensors, got {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    B, L, C = x.shape
    M = ps["w1"].shape[1]
    if L != nW * N or not supports(N, C, nH, M):
        raise ValueError(f"unsupported block shape L={L} N={N} nW={nW} C={C} "
                         f"nH={nH} M={M}")
    want = {"g1": (C,), "be1": (C,), "wq": (C, C), "bq": (C,), "wk": (C, C),
            "bk": (C,), "wv": (C, C), "bv": (C,), "bias": (nH, N, N),
            "wp": (C, C), "bp": (C,), "g2": (C,), "be2": (C,), "w1": (C, M),
            "b1": (M,), "w2": (M, C), "b2": (C,)}
    for n, shape in want.items():
        t = ps[n]
        if tuple(t.shape) != shape or t.device != dev or not t.is_floating_point():
            raise ValueError(f"param {n}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {shape} on {dev}")
    for n, t, shape, dtype in (("keep1", keep1, (B,), torch.float32),
                               ("keep2", keep2, (B,), torch.float32),
                               ("region", region, (nW, N), torch.int32),
                               ("pad", pad, (nW * N,), torch.float32)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype
                              or t.device != dev):
            raise ValueError(f"{n} must be {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _operands(x, ps, nH, weights):
    """Kernel operands: fp32 vectors and bias, and the weight copies named
    in ``weights`` in x's dtype (``*_F`` [out][in] for the forward
    products, ``*_B`` [in][out] for the backward's), all contiguous. The
    q/k/v weights' outputs are head-major (head h's q, k and v columns side
    by side), so one product per head makes all three."""
    dt = x.dtype
    C = x.shape[-1]
    f32 = {n: ps[n].float().contiguous()
           for n in ("g1", "be1", "bp", "g2", "be2", "b1", "b2", "bias")}
    ops = dict(
        G1=f32["g1"], BE1=f32["be1"], BP=f32["bp"], G2=f32["g2"],
        BE2=f32["be2"], B1=f32["b1"], B2=f32["b2"], BIAS=f32["bias"],
        BQKV=torch.cat([ps["bq"], ps["bk"], ps["bv"]]).float().contiguous())
    cast = {}                                   # [in][out] in x's dtype
    for name in weights:
        w, layout = name.split("_")
        if w not in cast:
            cast[w] = (torch.stack([ps["wq"], ps["wk"], ps["wv"]], dim=1)
                       .to(dt).reshape(C, 3, nH, C // nH).transpose(1, 2)
                       .reshape(C, 3 * C) if w == "WQKV"
                       else ps[w.lower()].to(dt))
        ops[name] = (cast[w].t() if layout == "F" else cast[w]).contiguous()
    return ops


def _call(entry, x, tensors, geometry, chunks):
    N, nH, nW, scale, eps = geometry
    B, L, C = x.shape
    M = tensors["W1_F"].shape[0]
    ptrs = [tensors[n].data_ptr() if tensors.get(n) is not None else None
            for n in _PTRS]
    if any(p is not None and p % 16 for p in ptrs):
        raise ValueError("fused_block kernel operands must be 16-byte aligned "
                         "(the kernels load 4 and 16 bytes at a time)")
    table = (ctypes.c_void_p * len(_PTRS))(*ptrs)
    dims = (ctypes.c_int * 7)(B * nW, N, C, nH, M, nW, chunks)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(table, dims, ctypes.c_float(scale), ctypes.c_float(eps),
                   _DTYPES[x.dtype], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_block kernel failed: CUDA error {rc}")


def _fwd(x, ps, keep1, keep2, region, pad, geometry):
    N, nH, nW = geometry[:3]
    _check(x, ps, keep1, keep2, region, pad, N, nH, nW)
    x = x.contiguous()
    out = torch.empty_like(x)
    tensors = dict(_operands(x, ps, nH, _FWD_WEIGHTS), X=x, OUT=out,
                   KEEP1=keep1, KEEP2=keep2, REGION=region, PAD=pad)
    _call(_lib().esvit_fused_block_fwd, x, tensors, geometry, 1)
    launches["fwd"] += 1
    return out


def _bwd(x, ps, keep1, keep2, region, pad, do, geometry):
    """dx and the 17 parameter gradients (fp32, the params' layouts)."""
    N, nH, nW = geometry[:3]
    _check(x, ps, keep1, keep2, region, pad, N, nH, nW)
    x, do = x.contiguous(), do.to(x.dtype).contiguous()
    B, L, C = x.shape
    M = ps["w1"].shape[1]
    B_, rows = B * nW, B * L
    V = 9 * C + M
    chunks = _chunks(rows, C, M)
    dev, f32 = x.device, torch.float32

    def groups(n):
        return -(-n // _SUM_GROUP) if n > _SUM_GROUP else 0

    tmp = max(groups(B_) * max(V, nH * N * N),
              groups(chunks) * max(3 * C * C, C * M), 1)
    out = dict(
        D_WQKV=torch.empty(C, 3 * C, dtype=f32, device=dev),
        D_WP=torch.empty(C, C, dtype=f32, device=dev),
        D_W1=torch.empty(C, M, dtype=f32, device=dev),
        D_W2=torch.empty(M, C, dtype=f32, device=dev),
        D_VEC=torch.empty(V, dtype=f32, device=dev),
        D_BIAS=torch.empty(nH, N, N, dtype=f32, device=dev))
    dx = torch.empty_like(x)
    tensors = dict(
        _operands(x, ps, nH, _BWD_WEIGHTS), **out, X=x, KEEP1=keep1,
        KEEP2=keep2, REGION=region, PAD=pad, DOUT=do, DX=dx,
        DX32=torch.empty(rows, C, dtype=f32, device=dev),
        WS=torch.empty(rows, 8 * C + 2 * M, dtype=x.dtype, device=dev),
        VPART=torch.empty(B_, V, dtype=f32, device=dev),
        BPART=torch.empty(B_, nH * N * N, dtype=f32, device=dev),
        WPART=torch.empty(chunks * max(3 * C * C, C * M), dtype=f32,
                          device=dev),
        TMP=torch.empty(tmp, dtype=f32, device=dev))
    _call(_lib().esvit_fused_block_bwd, x, tensors, geometry, chunks)
    launches["bwd"] += 1
    vec = out["D_VEC"]
    dwqkv = out["D_WQKV"]
    grads = dict(
        g1=vec[:C], be1=vec[C:2 * C], bq=vec[2 * C:3 * C],
        bk=vec[3 * C:4 * C], bv=vec[4 * C:5 * C], bp=vec[5 * C:6 * C],
        g2=vec[6 * C:7 * C], be2=vec[7 * C:8 * C], b2=vec[8 * C:9 * C],
        b1=vec[9 * C:], wq=dwqkv[:, :C], wk=dwqkv[:, C:2 * C],
        wv=dwqkv[:, 2 * C:], wp=out["D_WP"], w1=out["D_W1"],
        w2=out["D_W2"], bias=out["D_BIAS"])
    return dx, grads


@functools.cache
def _lib():
    """The loaded kernels, with the argtypes/restype of the C entry points
    declared (pointers as void*, so ctypes never truncates them)."""
    lib = cuda_build.load("fused_block")
    if lib.esvit_fused_block_num_ptrs() != len(_PTRS):
        raise RuntimeError("fused_block.cu and ops/fused_block.py disagree "
                           "on the pointer table")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.esvit_fused_block_fwd, lib.esvit_fused_block_bwd):
        fn.argtypes = [P, P, F, F, I, P]
        fn.restype = I
    lib.esvit_fused_block_smem_bytes.argtypes = [I, I, I, I]
    lib.esvit_fused_block_smem_bytes.restype = ctypes.c_longlong
    return lib


class _FusedBlock(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, keep1, keep2, region, pad, geometry, *ps):
        params = dict(zip(PARAM_NAMES, ps))
        ctx.save_for_backward(x)
        ctx.params = params
        ctx.extra = (keep1, keep2, region, pad, geometry)
        ctx.param_dtypes = [p.dtype for p in ps]
        return _fwd(x, params, keep1, keep2, region, pad, geometry)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep1, keep2, region, pad, geometry = ctx.extra
        dx, grads = _bwd(x, ctx.params, keep1, keep2, region, pad, g,
                         geometry)
        dps = [grads[n].to(dt) for n, dt in zip(PARAM_NAMES,
                                                ctx.param_dtypes)]
        return (dx, None, None, None, None, None, *dps)

