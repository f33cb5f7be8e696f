"""The whole Swin block: the CUDA kernels and their plain twin.

Replaces esvit_tpu/ops/fused_block.py ``_fwd_kernel`` and ``_bwd_kernel``
(via ``fused_swin_block``) with ``csrc/fused_block.cu``: LN1 -> q/k/v ->
window attention (rel-pos bias, -100 shift mask, pad-row multiplier) ->
proj -> drop-path residual -> LN2 -> fc1 -> erf-GELU -> fc2 -> drop-path
residual. The forward is five kernels: four token-tile GEMMs of
:func:`fwd_token_rows` rows on the tensor cores (F1: LN1 and q/k/v; F2:
proj and its residual; F3: LN2, fc1 and GELU; F4: fc2 and its residual)
and attention per window on the tiles of ``csrc/window_attention_tile.cuh``
(A1; windows of 64 < N <= 256, Swin at W=14, on the header's
large-window tile). The backward recomputes the forward from the block
input (the only
tensor saved) in five kernels: what is per token on tiles of
:func:`token_rows` rows (T1: LN1 and q/k/v; T2: proj, LN2, the MLP and LN2
backward; T3: the q/k/v transposes and the LN1 backward), and only
attention per window (A1: the forward tile; A2: its backward). It writes
dx and a workspace of per-row operands, and a last kernel sums every
weight gradient over all rows in a fixed order: all 17 parameter
gradients are bit-identical run to run. :func:`fused_block_fwd_staged`
and :func:`fused_block_bwd_staged` are the two passes' plain twins stage
by stage, with the kernels' roundings.

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
from esvit_tpu_torch.ops import window_attention as wa

launches = {"fwd": 0, "bwd": 0}

PARAM_NAMES = ("g1", "be1", "wq", "bq", "wk", "bk", "wv", "bv", "bias",
               "wp", "bp", "g2", "be2", "w1", "b1", "w2", "b2")
# The kernels' pointer table, in the order of the Ptr enum of the source.
_PTRS = ("X", "OUT", "G1", "BE1", "BQKV", "BP", "G2", "BE2", "B1", "B2",
         "BIAS", "PAD", "KEEP1", "KEEP2", "REGION",
         "WQKV_F", "WP_F", "W1_F", "W2_F", "WQKV_B", "WP_B", "W1_B", "W2_B",
         "DOUT", "DX", "DX32", "WS", "VPART", "BPART", "WPART", "TMP", "QKV",
         "DA", "D_WQKV", "D_WP", "D_W1", "D_W2", "D_VEC", "D_BIAS", "FA",
         "FX2", "FG")
# The weight copies each pass reads: the forward's four products; the
# backward recomputes the forward up to y2 (q/k/v, proj, fc1) and runs
# every product's transpose.
_FWD_WEIGHTS = ("WQKV_F", "WP_F", "W1_F", "W2_F")
_BWD_WEIGHTS = ("WQKV_F", "WP_F", "W1_F",
                "WQKV_B", "WP_B", "W1_B", "W2_B")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 512                  # kMaxC in the source
_MLP_CHUNK = 128              # kMc in the source
_FWD_ROWS = 128               # kFwdRows: a bf16 forward token tile
_FWD_ROWS_FP32 = 32           # kFwdRows32: an fp32 forward token tile
_SUM_GROUP = 64               # kGroup in the source
# Weight-gradient row chunks: about this many rows each, at most this many
# chunks, and partials of at most this many floats.
_CHUNK_ROWS = 256
_MAX_CHUNKS = 128
_MAX_PARTIAL = 1 << 24
# The backward's token tiles: rows per tile (csrc tok_layout): 64 up to
# this width, 32 above it (a 64-row T2 block at C=128 takes 121 KB of
# shared memory, one block per SM), 16 for fp32 above 256 (a 32-row fp32
# T2 block at C=384 would not fit the 227 KB a block may have). At C=512
# the bf16 T2 block of 32 rows takes 179 KB and the fp32 one of 16 rows
# 146 KB; neither may shrink further, since T2 sums its three vector
# partials (8 warps x 3C fp32) in the room of its y, h and dh tiles.
_TOKEN_ROWS = 64
_TOKEN_ROWS_WIDE = 32
_TOKEN_ROWS_MAX_C = 96
_TOKEN_ROWS_FP32_WIDE = 16


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


def _ln_stats(x, eps):
    """fp32 LayerNorm mean and 1/std, the kernels' E[x^2] - mu^2 variance."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    return mu, torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mu * mu + eps)


def _ln_bwd(x, dy, g, eps):
    """LayerNorm backward of fp32 dy: (dLN, dg, dbe), sums over rows."""
    mu, rs = _ln_stats(x, eps)
    xh = (x.float() - mu) * rs
    m1 = (dy * g).mean(-1, keepdim=True)
    m2 = (dy * g * xh).mean(-1, keepdim=True)
    return (rs * (dy * g - m1 - xh * m2), (dy * xh).sum(0), dy.sum(0))


def _gelu(h):
    return h * 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))


def _dgelu(h):
    return (0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
            + h * torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi))


def _mm(a, w, dt):
    return torch.matmul(a.float(), w.to(dt).float())


def _proj(a, w, b, dt):
    return _mm(a, w, dt).to(dt) + b.to(dt)


def _per_row(t, rows, L, by_image):
    """A per-image (``by_image``) or per-position vector as a (rows, 1)
    fp32 column for rows of images of L tokens; 1.0 for None."""
    if t is None:
        return 1.0
    r = torch.arange(rows, device=t.device)
    return t.float()[r // L if by_image else r % L][:, None]


def stage_t1(x, p, pad, L, eps):
    """T1 on (rows, C) rows of images of L tokens: y = round(LN1(x)) * pad
    and qkv = [q | k | v], each round(round(y W) + round(b))."""
    dt = x.dtype
    y = _ln(x, p["g1"], p["be1"], eps).to(dt)
    if pad is not None:
        y = y * _per_row(pad, x.shape[0], L, False).to(dt)
    qkv = torch.cat([_proj(y, p[w], p[b], dt) for w, b in
                     (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))], dim=-1)
    return y, qkv


def _proj_residual(x, a, w, b, keep, L):
    """x + round(round(round(a W) + round(b)) * keep) on (rows, C) rows of
    images of L tokens (x + round(round(a W) + round(b)) for keep None)."""
    dt = x.dtype
    o = _proj(a, w, b, dt)
    if keep is None:
        return x + o
    return x + (o.float() * _per_row(keep, x.shape[0], L, True)).to(dt)


def _fc1(x2, p, eps):
    """y2 = round(LN2(x2)) and h = round(round(y2 W1) + round(b1)), in fp32."""
    dt = x2.dtype
    y2 = _ln(x2, p["g2"], p["be2"], eps).to(dt)
    return y2, _proj(y2, p["w1"], p["b1"], dt).float()


def stage_f2(x, a, p, keep1, L):
    """F2 on (rows, C) rows of images of L tokens: x2 = x +
    round(round(round(a Wp) + round(bp)) * keep1)."""
    return _proj_residual(x, a, p["wp"], p["bp"], keep1, L)


def stage_f3(x2, p, eps):
    """F3 on (rows, C) rows: g = round(gelu(round(round(round(LN2(x2)) W1)
    + round(b1))))."""
    return _gelu(_fc1(x2, p, eps)[1]).to(x2.dtype)


def stage_f4(x2, g, p, keep2, L):
    """F4 on (rows, C) rows: out = x2 + round(round(round(g W2) +
    round(b2)) * keep2)."""
    return _proj_residual(x2, g, p["w2"], p["b2"], keep2, L)


def fused_block_fwd_staged(x, params, keep1, keep2, *, N: int, nH: int,
                           nW: int, scale: float, region=None, pad=None,
                           eps: float = 1e-6):
    """The forward kernels' function in plain PyTorch, stage by stage,
    rounding to x's dtype where they do (csrc/fused_block.cu): F1 (qkv),
    A1 (a), F2 (x2), F3 (g), F4 (out). Returns a dict of the stage outputs
    as (rows, width) tensors (qkv as [q | k | v]) and ``out`` in x's
    shape."""
    B, L, C = x.shape
    p = params
    xr = x.reshape(B * L, C)
    _, qkv = stage_t1(xr, p, pad, L, eps)
    q, k, v = qkv.split(C, dim=-1)
    a = wa.window_attention_plain(q, k, v, p["bias"].float(), region, N, nH,
                                  scale)
    x2 = stage_f2(xr, a, p, keep1, L)
    g = stage_f3(x2, p, eps)
    out = stage_f4(x2, g, p, keep2, L)
    return dict(qkv=qkv, a=a, x2=x2, g=g, out=out.reshape(B, L, C))


def stage_t2(x, a, do, p, keep1, keep2, L, eps):
    """T2 on (rows, C) rows: x2, y2, do2, g, dh, dx2 (fp32), do1, da and
    the fp32 vector gradients db1, db2, dg2, dbe2, dbp."""
    dt = x.dtype
    rows = x.shape[0]
    k1 = _per_row(keep1, rows, L, True)
    x2 = stage_f2(x, a, p, keep1, L)
    y2, h = _fc1(x2, p, eps)
    do2f = do.float() * _per_row(keep2, rows, L, True)
    do2 = do2f.to(dt)
    dh = (_mm(do2, p["w2"].t(), dt).to(dt).float() * _dgelu(h)).to(dt)
    dy2 = _mm(dh, p["w1"].t(), dt)
    dln2, dg2, dbe2 = _ln_bwd(x2, dy2, p["g2"].float(), eps)
    dx2 = do.float() + dln2
    do1f = dx2 * k1
    do1 = do1f.to(dt)
    return dict(x2=x2, y2=y2, do2=do2, g=_gelu(h).to(dt), dh=dh, dx2=dx2,
                do1=do1, da=_mm(do1, p["wp"].t(), dt).to(dt),
                db1=dh.float().sum(0), db2=do2f.sum(0), dg2=dg2, dbe2=dbe2,
                dbp=do1f.sum(0))


def stage_t3(x, dqkv, dx2, p, pad, L, eps):
    """T3 on (rows, C) rows: dx = round(dx2 + dLN1(dy * pad)), dy = dqkv
    [Wq | Wk | Wv]^T, and the fp32 vector gradients dg1, dbe1, dbqkv."""
    dt = x.dtype
    wqkv = torch.cat([p["wq"], p["wk"], p["wv"]], dim=1)
    dy = _mm(dqkv, wqkv.t(), dt) * _per_row(pad, x.shape[0], L, False)
    dln1, dg1, dbe1 = _ln_bwd(x, dy, p["g1"].float(), eps)
    return dict(dx=(dx2 + dln1).to(dt), dg1=dg1, dbe1=dbe1,
                dbqkv=dqkv.float().sum(0))


def fused_block_bwd_staged(x, params, keep1, keep2, do, *, N: int, nH: int,
                           nW: int, scale: float, region=None, pad=None,
                           eps: float = 1e-6):
    """The backward kernels' function in plain PyTorch, stage by stage,
    rounding to x's dtype where they do (csrc/fused_block.cu): T1 (y,
    qkv), A1 (a), T2 (x2, y2, do2, g, dh, dx2, do1, da), A2 (dqkv, dbias),
    T3 (dx), then the weight gradients. Returns a dict of every stage's
    outputs as (rows, width) tensors (qkv as [q | k | v], dqkv as [dq | dk
    | dv]), dx in x's shape, and ``grads``, the 17 parameter gradients in
    fp32 as :func:`_bwd` returns them."""
    B, L, C = x.shape
    p = params
    xr, dor = x.reshape(B * L, C), do.to(x.dtype).reshape(B * L, C)
    y, qkv = stage_t1(xr, p, pad, L, eps)
    q2, k2, v2 = qkv.split(C, dim=-1)
    a = wa.window_attention_plain(q2, k2, v2, p["bias"].float(), region, N,
                                  nH, scale)
    t2 = stage_t2(xr, a, dor, p, keep1, keep2, L, eps)
    dq, dk, dv, dbias = wa.window_attention_bwd_plain(
        q2, k2, v2, t2["da"], p["bias"].float(), region, N, nH, scale)
    dqkv = torch.cat([dq, dk, dv], dim=-1)
    t3 = stage_t3(xr, dqkv, t2["dx2"], p, pad, L, eps)
    dbqkv = t3["dbqkv"]
    dwqkv = y.float().t() @ dqkv.float()
    grads = dict(
        g1=t3["dg1"], be1=t3["dbe1"], wq=dwqkv[:, :C], bq=dbqkv[:C],
        wk=dwqkv[:, C:2 * C], bk=dbqkv[C:2 * C], wv=dwqkv[:, 2 * C:],
        bv=dbqkv[2 * C:], bias=dbias, wp=a.float().t() @ t2["do1"].float(),
        bp=t2["dbp"], g2=t2["dg2"], be2=t2["dbe2"],
        w1=t2["y2"].float().t() @ t2["dh"].float(), b1=t2["db1"],
        w2=t2["g"].float().t() @ t2["do2"].float(), b2=t2["db2"])
    return dict(y=y, qkv=qkv, a=a, **t2, dqkv=dqkv,
                dx=t3["dx"].reshape(B, L, C), grads=grads)


def bwd_stage_errors(x, params, keep1, keep2, do, *, N: int, nH: int,
                     nW: int, scale: float, region=None, pad=None,
                     eps: float = 1e-6) -> dict:
    """Each backward stage kernel against its plain twin on the kernel's
    own inputs for that stage (the scratch :func:`_bwd_buffers` returns):
    T1 (y, qkv), A1 (a), T2 (y2, do2, g, dh, dx2, do1, da), A2 (dq|dk|dv,
    dbias), T3 (dx). Returns each output's max-abs difference over the
    plain one's max-abs; raises if a kernel output is not finite. CUDA
    tensors (the kernels run)."""
    B, L, C = x.shape
    M = params["w1"].shape[1]
    dx, grads, sc = _bwd_buffers(x, params, keep1, keep2, region, pad, do,
                                 (N, nH, nW, scale, eps))
    ws = sc["WS"]
    col = dict(y=(0, C), dqkv=(C, 4 * C), a=(4 * C, 5 * C),
               do1=(5 * C, 6 * C), y2=(6 * C, 7 * C), do2=(7 * C, 8 * C),
               g=(8 * C, 8 * C + M), dh=(8 * C + M, 8 * C + 2 * M))
    got = {n: ws[:, a:b] for n, (a, b) in col.items()}
    got.update(qkv=sc["QKV"], da=sc["DA"], dx2=sc["DX32"],
               dx=dx.reshape(-1, C), dbias=grads["bias"])
    xr, dor = x.reshape(-1, C), do.to(x.dtype).reshape(-1, C)
    want = {}
    want["y"], want["qkv"] = stage_t1(xr, params, pad, L, eps)
    q2, k2, v2 = (t.contiguous() for t in got["qkv"].split(C, dim=-1))
    bias = params["bias"].float()
    want["a"] = wa.window_attention_plain(q2, k2, v2, bias, region, N, nH,
                                          scale)
    t2 = stage_t2(xr, got["a"], dor, params, keep1, keep2, L, eps)
    want.update({n: t2[n] for n in ("y2", "do2", "g", "dh", "dx2", "do1",
                                    "da")})
    dq, dk, dv, want["dbias"] = wa.window_attention_bwd_plain(
        q2, k2, v2, got["da"].contiguous(), bias, region, N, nH, scale)
    want["dqkv"] = torch.cat([dq, dk, dv], dim=-1)
    want["dx"] = stage_t3(xr, got["dqkv"], got["dx2"], params, pad, L,
                          eps)["dx"]
    return _stage_errors(got, want, "backward")


def attention_bwd_io(x, params, keep1, keep2, do, *, N: int, nH: int,
                     nW: int, scale: float, region=None, pad=None,
                     eps: float = 1e-6):
    """A2, the backward's attention half, as the kernels ran it (the
    scratch :func:`_bwd_buffers` returns): its inputs q2, k2, v2 (the
    backward's QKV) and da (DA), and its outputs dq, dk, dv (the
    workspace's columns) and dbias. CUDA tensors (the kernels run)."""
    C = x.shape[-1]
    _, grads, sc = _bwd_buffers(x, params, keep1, keep2, region, pad, do,
                                (N, nH, nW, scale, eps))
    q2, k2, v2 = (t.contiguous() for t in sc["QKV"].split(C, dim=-1))
    dq, dk, dv = (t.contiguous()
                  for t in sc["WS"][:, C:4 * C].split(C, dim=-1))
    return (q2, k2, v2, sc["DA"]), (dq, dk, dv, grads["bias"])


def _stage_errors(got, want, what):
    """Each stage output's max-abs difference from its twin over the
    twin's max-abs; raises if a kernel output is not finite."""
    errs = {}
    for name, w in want.items():
        g = got[name].float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what} stage output {name} not finite")
        errs[name] = ((g - w.float()).abs().max().item()
                      / max(w.float().abs().max().item(), 1e-6))
    return errs


def fwd_stage_errors(x, params, keep1, keep2, *, N: int, nH: int, nW: int,
                     scale: float, region=None, pad=None,
                     eps: float = 1e-6) -> dict:
    """Each forward stage kernel against its plain twin on the kernel's
    own inputs for that stage (the scratch :func:`_fwd_buffers` returns):
    F1 (qkv), A1 (a), F2 (x2), F3 (g), F4 (out). Returns each output's
    max-abs difference over the plain one's max-abs; raises if a kernel
    output is not finite. CUDA tensors (the kernels run)."""
    B, L, C = x.shape
    out, sc = _fwd_buffers(x, params, keep1, keep2, region, pad,
                           (N, nH, nW, scale, eps))
    got = dict(qkv=sc["QKV"], a=sc["FA"], x2=sc["FX2"], g=sc["FG"],
               out=out.reshape(-1, C))
    xr = x.reshape(-1, C)
    want = {"qkv": stage_t1(xr, params, pad, L, eps)[1]}
    q, k, v = (t.contiguous() for t in got["qkv"].split(C, dim=-1))
    want["a"] = wa.window_attention_plain(q, k, v, params["bias"].float(),
                                          region, N, nH, scale)
    want["x2"] = stage_f2(xr, got["a"], params, keep1, L)
    want["g"] = stage_f3(got["x2"], params, eps)
    want["out"] = stage_f4(got["x2"], got["g"], params, keep2, L)
    return _stage_errors(got, want, "forward")


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
    answer on every device): a head dim that is a multiple of 16 and at
    most 64, and N <= 64 (the small window-attention tiles, A1 and A2) or
    64 < N <= 256 where the large tile's backward block fits the card
    (Swin's head dim 32 at every N up to 256); C a multiple of 32 and at
    most 512 (a LayerNorm row in registers: Swin-S / Swin-B's stage 2 at
    C=512 is the widest, and their stage 3 at C=768 / 1024 takes the
    window-attention route) and M a multiple of 128 (the backward's MLP
    chunk). The token tiles' shared memory depends on C alone, and
    chip_smoke.py holds both passes against the card at every admitted
    width."""
    if N <= 0 or C % nH or C % 32 or C > _MAX_C or M % _MLP_CHUNK:
        return False
    hd = C // nH
    if hd % 16 or hd > 64:
        return False
    return N <= wa._SMALL_MAX_N or (N <= wa._LARGE_MAX_N
                                    and wa.large_tile_fits(N, hd, True))


def fwd_token_rows(itemsize: int = 2) -> int:
    """Rows of one forward token tile (F1-F4): 128 in bf16 (two wgmma
    warpgroups of 64 rows), 32 in fp32. The last tile is ragged; tiles
    cross window and image boundaries."""
    return _FWD_ROWS if itemsize == 2 else _FWD_ROWS_FP32


def token_rows(C: int, itemsize: int = 2) -> int:
    """Rows of one backward token tile (T1, T2, T3): 64 up to C=96, else
    32 (16 for fp32 above C=256), so that two bf16 T2 blocks share an SM
    up to C=256 and every block fits up to C=512 (one T1 or T2 block per
    SM above C=384)."""
    if C <= _TOKEN_ROWS_MAX_C:
        return _TOKEN_ROWS
    if itemsize == 4 and C > 256:
        return _TOKEN_ROWS_FP32_WIDE
    return _TOKEN_ROWS_WIDE


def _chunks(rows: int, C: int, M: int) -> int:
    """Row chunks of the weight-gradient partials: one per ~_CHUNK_ROWS
    rows, at most _MAX_CHUNKS, and few enough that the largest product's
    partials (q/k/v: 3 C^2, fc1 / fc2: C M floats a chunk) stay within
    _MAX_PARTIAL floats (16 chunks, 64 MB, at C=512, M=2048)."""
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


def _operands(x, ps, weights):
    """Kernel operands: fp32 vectors and bias, and the weight copies named
    in ``weights`` in x's dtype (``*_F`` [out][in] for the forward
    products, ``*_B`` [in][out] for the backward's), all contiguous. The
    q/k/v weight is [wq | wk | wv]: the column order of QKV and of the
    backward's dq | dk | dv."""
    dt = x.dtype
    f32 = {n: ps[n].float().contiguous()
           for n in ("g1", "be1", "bp", "g2", "be2", "b1", "b2", "bias")}
    ops = dict(
        G1=f32["g1"], BE1=f32["be1"], BP=f32["bp"], G2=f32["g2"],
        BE2=f32["be2"], B1=f32["b1"], B2=f32["b2"], BIAS=f32["bias"],
        BQKV=torch.cat([ps["bq"], ps["bk"], ps["bv"]]).float().contiguous())
    for name in weights:                    # ps holds [in][out]
        w, layout = name.split("_")
        srcs = ([ps["wq"], ps["wk"], ps["wv"]] if w == "WQKV"
                else [ps[w.lower()]])
        K, N = srcs[0].shape[0], sum(t.shape[1] for t in srcs)
        out = torch.empty((N, K) if layout == "F" else (K, N), dtype=dt,
                          device=x.device)
        col = 0
        for t in srcs:                      # one cast (and transpose) each
            n = t.shape[1]
            if layout == "F":
                out[col:col + n].copy_(t.t())
            else:
                out[:, col:col + n].copy_(t)
            col += n
        ops[name] = out
    return ops


def _call(entry, x, tensors, geometry, chunks, plan=(0, 0, 0, 0, 0)):
    N, nH, nW, scale, eps = geometry
    B, L, C = x.shape
    M = tensors["W1_F"].shape[0]
    ptrs = [tensors[n].data_ptr() if tensors.get(n) is not None else None
            for n in _PTRS]
    if any(p is not None and p % 16 for p in ptrs):
        raise ValueError("fused_block kernel operands must be 16-byte aligned "
                         "(the kernels load 4 and 16 bytes at a time)")
    table = (ctypes.c_void_p * len(_PTRS))(*ptrs)
    dims = (ctypes.c_int * 12)(B * nW, N, C, nH, M, nW, chunks, *plan)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(table, dims, ctypes.c_float(scale), ctypes.c_float(eps),
                   _DTYPES[x.dtype], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_block kernel failed: CUDA error {rc}")


def _fwd(x, ps, keep1, keep2, region, pad, geometry):
    return _fwd_buffers(x, ps, keep1, keep2, region, pad, geometry)[0]


def _fwd_buffers(x, ps, keep1, keep2, region, pad, geometry):
    """:func:`_fwd`'s output, and the forward's scratch as its kernels left
    it: QKV ([q | k | v]), FA (a), FX2 (x2) and FG (g), (rows, width)."""
    N, nH, nW = geometry[:3]
    _check(x, ps, keep1, keep2, region, pad, N, nH, nW)
    x = x.contiguous()
    B, L, C = x.shape
    M = ps["w1"].shape[1]
    rows = B * L
    fplan = wa.tile_plan(B * nW, N, C // nH, nH, nW, x.element_size(),
                         wa._sm_count(x.device.index))
    out = torch.empty_like(x)
    scratch = {name: torch.empty(rows, width, dtype=x.dtype, device=x.device)
               for name, width in (("QKV", 3 * C), ("FA", C), ("FX2", C),
                                   ("FG", M))}
    tensors = dict(_operands(x, ps, _FWD_WEIGHTS), **scratch, X=x,
                   OUT=out, KEEP1=keep1, KEEP2=keep2, REGION=region, PAD=pad)
    _call(_lib().esvit_fused_block_fwd, x, tensors, geometry, 1,
          (0, fplan.warps, fplan.run, 0, 0))
    launches["fwd"] += 1
    return out, scratch


def _bwd(x, ps, keep1, keep2, region, pad, do, geometry):
    """dx and the 17 parameter gradients (fp32, the params' layouts)."""
    dx, grads, _ = _bwd_buffers(x, ps, keep1, keep2, region, pad, do, geometry)
    return dx, grads


def _bwd_buffers(x, ps, keep1, keep2, region, pad, do, geometry):
    """:func:`_bwd`, and the backward's scratch as its kernels left it:
    QKV, DA, DX32 and the workspace WS (columns y | dq dk dv | a | do1 | y2
    | do2 | g | dh)."""
    N, nH, nW = geometry[:3]
    _check(x, ps, keep1, keep2, region, pad, N, nH, nW)
    x, do = x.contiguous(), do.to(x.dtype).contiguous()
    B, L, C = x.shape
    M = ps["w1"].shape[1]
    B_, rows = B * nW, B * L
    V = 9 * C + M
    chunks = _chunks(rows, C, M)
    R = token_rows(C, x.element_size())
    tiles = -(-rows // R)
    sms = wa._sm_count(x.device.index)
    fplan = wa.tile_plan(B_, N, C // nH, nH, nW, x.element_size(), sms)
    bplan = wa.tile_plan(B_, N, C // nH, nH, nW, x.element_size(), sms,
                         backward=True)
    dev, f32 = x.device, torch.float32

    def groups(n):
        return -(-n // _SUM_GROUP) if n > _SUM_GROUP else 0

    tmp = max(groups(tiles) * V, groups(chunks) * max(3 * C * C, C * M), 1)
    out = dict(
        D_WQKV=torch.empty(C, 3 * C, dtype=f32, device=dev),
        D_WP=torch.empty(C, C, dtype=f32, device=dev),
        D_W1=torch.empty(C, M, dtype=f32, device=dev),
        D_W2=torch.empty(M, C, dtype=f32, device=dev),
        D_VEC=torch.empty(V, dtype=f32, device=dev),
        D_BIAS=torch.empty(nH, N, N, dtype=f32, device=dev))
    dx = torch.empty_like(x)
    scratch = dict(
        QKV=torch.empty(rows, 3 * C, dtype=x.dtype, device=dev),
        DA=torch.empty(rows, C, dtype=x.dtype, device=dev),
        DX32=torch.empty(rows, C, dtype=f32, device=dev),
        WS=torch.empty(rows, 8 * C + 2 * M, dtype=x.dtype, device=dev))
    tensors = dict(
        _operands(x, ps, _BWD_WEIGHTS), **out, **scratch, X=x,
        KEEP1=keep1, KEEP2=keep2, REGION=region, PAD=pad, DOUT=do, DX=dx,
        VPART=torch.empty(tiles, V, dtype=f32, device=dev),
        BPART=torch.empty(nH * wa.bwd_partials(bplan, nW) * N * N, dtype=f32,
                          device=dev),
        WPART=torch.empty(chunks * max(3 * C * C, C * M), dtype=f32,
                          device=dev),
        TMP=torch.empty(tmp, dtype=f32, device=dev))
    _call(_lib().esvit_fused_block_bwd, x, tensors, geometry, chunks,
          (R, fplan.warps, fplan.run, bplan.warps, bplan.run))
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
    return dx, grads, scratch


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
    for fn in (lib.esvit_fused_block_fwd_smem_bytes,
               lib.esvit_fused_block_bwd_smem_bytes):
        fn.argtypes = [I, I, I]
        fn.restype = ctypes.c_longlong
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

