"""Mode-0 2-D sliding-chunk attention: the CUDA kernel pair and its plain
twin.

Replaces esvit_tpu/ops/sliding_chunk_fused.py ``_fwd_kernel`` and
``_bwd_kernel`` (via ``sliding_chunk_attention``) with
``csrc/sliding_chunk.cu``: one thread block per (bh, query chunk) in the
forward, which stages only the real neighbour chunks and the global rows;
in the backward one kernel per query chunk (r, dq and the globals'
partials), one per key chunk (dk and dv, gathered from the query chunks
that see it) and a fixed-order sum of the partials, so every gradient is
deterministic. bf16 runs on tensor-core tiles (two passes over the sets,
no score buffer); fp32 on the first CUDA-core kernels. The source notes
what bounds the kernels on Hopper.

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

Beside it, the staged twins (:func:`sliding_chunk_fwd_staged`,
:func:`sliding_chunk_bwd_q_staged`, :func:`sliding_chunk_bwd_k_staged`,
:func:`glo_reduce_staged`) compute what each kernel computes, set by set
in the kernels' order and with their roundings; :func:`stage_errors`
holds each kernel to its twin on the card. Nothing on the main path uses
them.
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


# The kernels' ring depth (csrc/sliding_chunk.cu tc::kStages).
_STAGES = 2


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_smem_bytes(W: int, M: int, nglo: int, itemsize: int) -> dict:
    """Dynamic shared memory of each kernel, in bytes, as
    csrc/sliding_chunk.cu ``kernel_smem`` counts it. bf16 (itemsize 2): the
    row masks (128 bytes), bf16 tiles of round16(W^2) rows at row stride
    round16(M) + 8, each region 128-byte aligned, and 128 bytes of slack:
    the forward holds Q and _STAGES ring slots of [K | V]; bwd_q Q, dO,
    the slots and each warp's share of the globals' partials; bwd_k K, V
    and slots of [Q | dO | m, 1/sum, r]. fp32 (itemsize 4): the CUDA-core
    kernels' fp32 tiles of R = max(ceil4(W^2), 8) rows (the forward's
    chunk-wide score buffer among them) and two int arrays of R."""
    W2 = W * W
    if itemsize == 2:
        rows = _round_up(W2, 16)
        tile = _round_up(rows * (_round_up(M, 16) + 8) * 2, 128)
        stat = _round_up(3 * rows * 4, 128)
        part = _round_up(rows // 16 * 2 * nglo * M * 4, 128)
        head = 128 + 128  # the masks and the slack
        return {"fwd": head + (1 + 2 * _STAGES) * tile,
                "bwd_q": head + (2 + 2 * _STAGES) * tile + part,
                "bwd_k": head + 2 * tile + _STAGES * (2 * tile + stat)}
    R, G = max(_round_up(W2, 4), 8), _round_up(nglo, 4)
    floats = {"fwd": 2 * M * R + (G + 9 * R) * R + 4 * R,
              "bwd_q": 5 * M * R + R * R + G * R + 16 * R + 3 * R,
              "bwd_k": 6 * M * R + 2 * R * R + 3 * R}
    return {k: 4 * n + 8 * R for k, n in floats.items()}


# The 3 x 3 neighbourhood offsets in the kernels' order (row-major).
_OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


def neighbour_sets(mx: int, my: int, ci: int, cj: int,
                   with_globals: bool) -> list:
    """The sets a block of chunk (ci, cj) walks, in order (csrc
    ``neighbour_sets``): ``None`` for the global keys (with_globals: the
    forward and bwd_q when nglo > 0), then the in-grid chunks (ci + di,
    cj + dj). The relation is symmetric, so from a key chunk's side the
    same list (without the globals) is the query chunks that see it
    (bwd_k's gather)."""
    sets = [None] if with_globals else []
    return sets + [(ci + di, cj + dj) for di, dj in _OFFSETS
                   if 0 <= ci + di < mx and 0 <= cj + dj < my]


def _to_chunks(t, W, padx, pady):
    """(BH, nx, ny, M) -> (BH, M, mx, my, W2), zero-padded."""
    BH, nx, ny, M = t.shape
    t = F.pad(t.permute(0, 3, 1, 2), (0, pady, 0, padx))
    mx, my = (nx + padx) // W, (ny + pady) // W
    return t.reshape(BH, M, mx, W, my, W).permute(0, 1, 2, 4, 3, 5).reshape(
        BH, M, mx, my, W * W)


def _untile(t: torch.Tensor, nx: int, ny: int, W: int) -> torch.Tensor:
    """(BH, mx, my, W2, C) chunks, channels last -> the (BH, nx, ny, C)
    grid, the padding dropped."""
    BH, mx, my, _, C = t.shape
    t = t.reshape(BH, mx, my, W, W, C).transpose(2, 3)
    return t.reshape(BH, mx * W, my * W, C)[:, :nx, :ny]


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
    return _untile(out.permute(0, 2, 3, 4, 1), nx, ny, W).to(dtype)


# ---------------------------------------------------------------------------
# The staged twins: each kernel's function, set by set in its order, with
# its roundings, on chunk tiles (BH, mx, my, W^2, ...) whose absent rows
# are zero. A set no block visits (a neighbour outside the grid) is all
# absent here and changes nothing: it adds exact zeros and leaves the
# running max and sum as they were. Sums inside a set (the products, a
# row's exponentials) run in torch's order, not the kernel's fragment
# order, and the bf16 kernels take exp(s - m) as 2^(s log2e - m log2e):
# twin and kernel agree to fp32 rounding before the casts.


def _tiles(t: torch.Tensor, W: int) -> torch.Tensor:
    """(BH, nx, ny, C) -> (BH, mx, my, W^2, C): :func:`_to_chunks`'s
    chunks, channels last."""
    nx, ny = t.shape[1:3]
    return _to_chunks(t, W, (-nx) % W, (-ny) % W).permute(0, 2, 3, 4, 1)


def _shifted(t: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """u[:, i, j] = t[:, i + di, j + dj] over the chunk grid (dims 1, 2),
    zeros outside it."""
    mx, my = t.shape[1:3]
    t = F.pad(t, [0, 0] * (t.ndim - 3) + [1, 1, 1, 1])
    return t[:, 1 + di:1 + di + mx, 1 + dj:1 + dj + my]


def _present(nx: int, ny: int, W: int, device) -> torch.Tensor:
    """(1, mx, my, W^2) float: 1 where a chunk slot holds a real token."""
    return _tiles(torch.ones(1, nx, ny, 1, device=device), W)[..., 0]


def _key_sets(t_kv, glo_kv, present, with_globals):
    """The key sets of every query chunk at once, in the kernels' order:
    (keys, values, present) with keys and values (BH, mx, my | 1, 1, n, M)
    fp32 and present broadcasting against the scores' (.., queries, n)
    as (.., 1, n) bools."""
    sets = []
    if with_globals:
        k, v = (t.float()[:, None, None] for t in glo_kv)
        ok = torch.ones(1, 1, 1, 1, k.shape[-2], dtype=torch.bool,
                        device=k.device)
        sets.append((k, v, ok))
    for di, dj in _OFFSETS:
        k, v = (_shifted(t, di, dj) for t in t_kv)
        sets.append((k, v, _shifted(present, di, dj)[..., None, :] > 0))
    return sets


def _probs(s, ok, m, linv):
    """p = exp(s - m) / sum in fp32 where the pair is present, exactly 0
    elsewhere; m and linv broadcast against s."""
    return torch.where(ok, torch.exp(s - m) * linv, torch.zeros_like(s))


def sliding_chunk_fwd_staged(q, k, v, k_glo, v_glo, *, nx: int, ny: int,
                             W: int):
    """The forward kernel's function: pass 1 over the sets keeps each
    row's running max m and sum l (l = l exp(m_old - m) + the set's sum of
    exp(s - m)); pass 2 recomputes the scores, rounds p = exp(s - m) / l
    to the input dtype and sums p v over the sets in fp32, rounded once.
    Returns (out, stats) as :func:`_fwd` does: stats (BH, nx, ny, 2) holds
    (m, 1/l)."""
    dt = q.dtype
    nglo = k_glo.shape[1]
    qc, kc, vc = (_tiles(t, W).float() for t in (q, k, v))
    sets = _key_sets((kc, vc), (k_glo, v_glo), _present(nx, ny, W, q.device),
                     nglo > 0)
    m = torch.full(qc.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    for keys, _, ok in sets:
        s = (qc @ keys.transpose(-1, -2)).masked_fill(~ok, float("-inf"))
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.where(m == float("-inf"), torch.zeros_like(m),
                            torch.exp(m - mn))
        l = l * alpha + _probs(s, ok, mn[..., None], 1.0).sum(-1)
        m = mn
    linv = 1.0 / l
    o = torch.zeros_like(qc)
    for keys, vals, ok in sets:
        p = _probs(qc @ keys.transpose(-1, -2), ok, m[..., None],
                   linv[..., None])
        o = o + p.to(dt).float() @ vals
    return (_untile(o.to(dt), nx, ny, W),
            _untile(torch.stack([m, linv], -1), nx, ny, W))


def sliding_chunk_bwd_q_staged(q, k, v, k_glo, v_glo, do, stats, *, nx: int,
                               ny: int, W: int):
    """bwd_q's function, per query chunk, p rebuilt from stats (m, 1/l):
    pass 1 r = rowsum(p dp) over the sets (dp = do v^T); pass 2 ds =
    round(p (dp - r)), dq = sum over the sets of ds k (fp32, rounded once),
    and from the globals' set the chunk's partials dsg^T q and round(pg)^T
    do (fp32). Returns (r (BH, nx, ny) fp32, dq, partial (2, BH, mx*my,
    nglo, M) fp32), as the kernel leaves them."""
    dt = q.dtype
    BH, M = q.shape[0], q.shape[-1]
    nglo = k_glo.shape[1]
    present = _present(nx, ny, W, q.device)
    qc, kc, vc, doc = (_tiles(t, W).float() for t in (q, k, v, do))
    st = _tiles(stats, W)
    m, linv = st[..., 0:1], st[..., 1:2]
    row_ok = present[..., None] > 0
    sets = _key_sets((kc, vc), (k_glo, v_glo), present, nglo > 0)

    def p_dp(keys, vals, ok):
        p = _probs(qc @ keys.transpose(-1, -2), row_ok & ok, m, linv)
        return p, doc @ vals.transpose(-1, -2)

    r = torch.zeros(qc.shape[:-1], device=q.device)
    for keys, vals, ok in sets:
        p, dp = p_dp(keys, vals, ok)
        r = r + (p * dp).sum(-1)
    dq = torch.zeros_like(qc)
    mx, my = qc.shape[1:3]
    partial = torch.zeros(2, BH, mx, my, nglo, M, device=q.device)
    for i, (keys, vals, ok) in enumerate(sets):
        p, dp = p_dp(keys, vals, ok)
        ds = (p * (dp - r[..., None])).to(dt).float()
        dq = dq + ds @ keys
        if i == 0 and nglo > 0:
            partial[0] = ds.transpose(-1, -2) @ qc
            partial[1] = p.to(dt).float().transpose(-1, -2) @ doc
    return (_untile(r[..., None], nx, ny, W)[..., 0],
            _untile(dq.to(dt), nx, ny, W),
            partial.reshape(2, BH, mx * my, nglo, M))


def sliding_chunk_bwd_k_staged(q, k, v, do, stats, rsum, *, nx: int, ny: int,
                               W: int):
    """bwd_k's gather, per key chunk, over the query chunks that see it in
    the kernels' order: p^T from the query rows' (m, 1/l), ds^T =
    round(p^T (dp^T - r)), dv = sum of round(p^T) do and dk = sum of ds^T q
    (fp32, rounded once). Returns (dk, dv)."""
    dt = q.dtype
    present = _present(nx, ny, W, q.device)
    qc, kc, vc, doc = (_tiles(t, W).float() for t in (q, k, v, do))
    st = torch.cat([_tiles(stats, W), _tiles(rsum[..., None], W)], -1)
    key_ok = present[..., None] > 0
    dk, dv = torch.zeros_like(kc), torch.zeros_like(vc)
    for di, dj in _OFFSETS:
        qn, don, sn = (_shifted(t, di, dj) for t in (qc, doc, st))
        ok = key_ok & (_shifted(present, di, dj)[..., None, :] > 0)
        m, linv, r = (sn[..., None, :, i] for i in range(3))
        p = _probs(kc @ qn.transpose(-1, -2), ok, m, linv)
        ds = (p * (vc @ don.transpose(-1, -2) - r)).to(dt).float()
        dv = dv + p.to(dt).float() @ don
        dk = dk + ds @ qn
    return _untile(dk.to(dt), nx, ny, W), _untile(dv.to(dt), nx, ny, W)


def glo_reduce_staged(partial, dtype):
    """dkg, dvg: the chunks' partials summed in chunk order (fp32), rounded
    to dtype."""
    acc = torch.zeros_like(partial[:, :, 0])
    for c in range(partial.shape[2]):
        acc = acc + partial[:, :, c]
    return acc[0].to(dtype), acc[1].to(dtype)


def sliding_chunk_bwd_staged(q, k, v, k_glo, v_glo, do, stats, *, nx: int,
                             ny: int, W: int):
    """The backward's five gradients through the three kernels' twins:
    (dq, dk, dv, dkg, dvg)."""
    kw = dict(nx=nx, ny=ny, W=W)
    r, dq, partial = sliding_chunk_bwd_q_staged(q, k, v, k_glo, v_glo, do,
                                                stats, **kw)
    dk, dv = sliding_chunk_bwd_k_staged(q, k, v, do, stats, r, **kw)
    return (dq, dk, dv, *glo_reduce_staged(partial, q.dtype))


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
    """(dq, dk, dv, dkg, dvg)."""
    return _bwd_buffers(q, k, v, k_glo, v_glo, stats, do, nx, ny, W)[0]


def _bwd_buffers(q, k, v, k_glo, v_glo, stats, do, nx, ny, W):
    """:func:`_bwd`'s gradients, and the scratch as the kernels left it:
    rsum (BH, nx, ny), bwd_q's r, and partial (2, BH, mx*my, nglo, M), its
    per-chunk dkg and dvg."""
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
    return (dq, dk, dv, dkg, dvg), dict(rsum=rsum, partial=partial)


def stage_errors(q, k, v, k_glo, v_glo, do, *, nx: int, ny: int,
                 W: int) -> dict:
    """Each kernel against its staged twin on the kernel's own inputs: the
    forward (out, and its stats m and 1/l), bwd_q (r, dq and the partials,
    from the forward kernel's stats), bwd_k (dk, dv, from those stats and
    bwd_q's r) and the reduce (dkg, dvg, from bwd_q's partials). Returns
    {"<kernel> <output>": max-abs difference over the twin's max-abs};
    raises if a kernel output is not finite. CUDA tensors (the kernels
    run)."""
    kw = dict(nx=nx, ny=ny, W=W)
    out, stats = _fwd(q, k, v, k_glo, v_glo, nx, ny, W)
    (dq, dk, dv, dkg, dvg), scratch = _bwd_buffers(q, k, v, k_glo, v_glo,
                                                   stats, do, nx, ny, W)
    want_out, want_stats = sliding_chunk_fwd_staged(q, k, v, k_glo, v_glo,
                                                    **kw)
    r, want_dq, want_part = sliding_chunk_bwd_q_staged(
        q, k, v, k_glo, v_glo, do, stats, **kw)
    want_dk, want_dv = sliding_chunk_bwd_k_staged(q, k, v, do, stats,
                                                  scratch["rsum"], **kw)
    pairs = {"fwd out": (out, want_out),
             "fwd m": (stats[..., 0], want_stats[..., 0]),
             "fwd 1/l": (stats[..., 1], want_stats[..., 1]),
             "bwd_q r": (scratch["rsum"], r), "bwd_q dq": (dq, want_dq),
             "bwd_k dk": (dk, want_dk), "bwd_k dv": (dv, want_dv)}
    if k_glo.shape[1]:
        want_dkg, want_dvg = glo_reduce_staged(scratch["partial"], q.dtype)
        pairs.update({"bwd_q partial": (scratch["partial"], want_part),
                      "glo_reduce dkg": (dkg, want_dkg),
                      "glo_reduce dvg": (dvg, want_dvg)})
    errs = {}
    for name, (got, want) in pairs.items():
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"sliding chunk {name} not finite")
        errs[name] = ((got - want).abs().max().item()
                      / max(want.abs().max().item(), 1e-6))
    return errs


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
    lib.esvit_sliding_chunk_kernel_smem_bytes.argtypes = [I] * 5
    lib.esvit_sliding_chunk_kernel_smem_bytes.restype = ctypes.c_size_t
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
